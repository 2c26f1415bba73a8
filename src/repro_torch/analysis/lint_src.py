"""Source-level lint of ``src/repro_torch``: AST rules for the lock/serving
layering contracts, ``repro.analysis.lint_src``'s four rules with PyTorch's
host syncs added to the lease-window rule.

These are contracts the type system can't see and the runtime only
violates probabilistically, so they're enforced statically:

* ``shard-map-outside-dist`` — ``jax.shard_map`` /
  ``jax.experimental.shard_map`` may only appear in ``dist/sharding.py``.
  Everything else goes through the ``MeshRules`` wrappers so sharding
  decisions stay in one reviewable place.
* ``host-sync-in-lease-window`` — in ``serving/engine.py``, no host
  synchronization inside a ``try:`` body whose ``finally:`` releases a
  lease (``done_read_batch`` / ``done_read`` / ``release_read``):
  PyTorch's ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()`` and
  ``torch.cuda.synchronize()`` (any call named ``synchronize``), and the
  reference's ``.block_until_ready()``, ``jax.device_get`` and
  ``np.asarray``.  A sync inside the window stalls every writer queued
  behind the lease for the full device round-trip; the engine's contract
  is dispatch-only while held, sync after release.
* ``obs-in-lease-window`` — inside a lease window (same ``try``/``finally``
  shape as above) the only observability calls allowed are the O(1)
  emits: ``_TR.emit`` / ``_TR.emit_span`` / ``_TR.span`` on the tracer
  and ``add`` / ``observe`` / ``set`` / ``inc`` on metric cells.
  Aggregating reads — ``snapshot()``, ``quantile()``, ``asdict()``,
  ``format_timeline`` / ``derive_requests`` / ``to_chrome`` — iterate
  every thread's cells or the whole ring and have no place on the hot
  path while writers queue behind the lease.
* ``scheduler-state-mutation`` — engine code may *call* scheduler methods
  but never assign through ``...scheduler.<attr>``; slot/queue state is
  owned by ``serving/scheduler.py`` so the admission invariants checked
  there can't be bypassed.  Rebinding the scheduler itself
  (``self.scheduler = ...`` in ``__init__``) is allowed.

Findings can be waived per-line via ``analysis/lint_allowlist.txt``
(``rule path-substring message-substring``, whitespace separated).
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple

__all__ = ["Finding", "lint_file", "lint_tree", "load_allowlist",
           "apply_allowlist", "SRC_ROOT"]

SRC_ROOT = os.path.normpath(
    os.path.join(os.path.dirname(__file__), os.pardir))


@dataclass
class Finding:
    """One lint finding (``repro.analysis.lint_hlo.Finding``'s fields)."""
    rule: str
    where: str
    message: str

    def __str__(self) -> str:
        return f"{self.rule}: [{self.where}] {self.message}"


_SHARD_MAP_OK = {os.path.join("dist", "sharding.py")}
_LEASE_RELEASES = {"done_read_batch", "done_read", "release_read"}
# host syncs by call name: PyTorch's (``.item()``, ``.cpu()``,
# ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize()``) and the
# reference's; ``np.asarray`` is matched on its own
_HOST_SYNCS = {"item", "cpu", "tolist", "numpy", "synchronize",
               "block_until_ready", "device_get"}

# obs-in-lease-window: what an obs handle may do while a lease is held
_OBS_TRACER_NAMES = {"_TR", "TRACER"}
_OBS_TRACER_OK = {"emit", "emit_span", "span"}
_OBS_METRIC_OK = {"counter", "gauge", "histogram",
                  "add", "observe", "set", "inc"}
_OBS_AGGREGATORS = {"format_timeline", "derive_requests", "to_chrome"}


def _attr_chain(node: ast.AST) -> List[str]:
    """['self', 'scheduler', 'submit'] for ``self.scheduler.submit``."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return parts[::-1]


def _call_name(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _is_np_asarray(call: ast.Call) -> bool:
    f = call.func
    return (isinstance(f, ast.Attribute) and f.attr == "asarray"
            and isinstance(f.value, ast.Name) and f.value.id == "np")


def _releases_lease(stmts: Sequence[ast.stmt]) -> bool:
    for s in stmts:
        for n in ast.walk(s):
            if isinstance(n, ast.Call) and _call_name(n) in _LEASE_RELEASES:
                return True
    return False


def _shard_map_findings(relpath: str, tree: ast.AST) -> List[Finding]:
    if relpath in _SHARD_MAP_OK:
        return []
    out = []
    for n in ast.walk(tree):
        hit = None
        if isinstance(n, ast.ImportFrom):
            if "shard_map" in (n.module or "") or any(
                    a.name == "shard_map" for a in n.names):
                hit = f"import of shard_map ({n.module or ''})"
        elif isinstance(n, ast.Import):
            if any("shard_map" in a.name for a in n.names):
                hit = f"import of {n.names[0].name}"
        elif isinstance(n, ast.Attribute) and n.attr == "shard_map":
            hit = ".".join(_attr_chain(n))
        if hit:
            out.append(Finding(
                "shard-map-outside-dist", f"{relpath}:{n.lineno}",
                f"{hit} — sharding entry points live in dist/sharding.py "
                f"only"))
    return out


def _lease_window_findings(relpath: str, tree: ast.AST) -> List[Finding]:
    out = []
    for t in ast.walk(tree):
        if not (isinstance(t, ast.Try) and t.finalbody
                and _releases_lease(t.finalbody)):
            continue
        for s in t.body:
            for n in ast.walk(s):
                if not isinstance(n, ast.Call):
                    continue
                name = _call_name(n)
                if name in _HOST_SYNCS or _is_np_asarray(n):
                    label = "np.asarray" if _is_np_asarray(n) else name
                    out.append(Finding(
                        "host-sync-in-lease-window",
                        f"{relpath}:{n.lineno}",
                        f"{label} while a lease is held (released in the "
                        f"finally at line {t.finalbody[0].lineno}) — sync "
                        f"after release, dispatch-only inside the window"))
    return out


def _deep_chain(node: ast.AST) -> List[str]:
    """Attr chain that walks *through* intermediate calls:
    ``self.metrics.histogram("x").quantile`` ->
    ``['self', 'metrics', 'histogram', 'quantile']``."""
    parts: List[str] = []
    while True:
        if isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Name):
            parts.append(node.id)
            break
        else:
            break
    return parts[::-1]


def _obs_lease_window_findings(relpath: str, tree: ast.AST) -> List[Finding]:
    out = []
    for t in ast.walk(tree):
        if not (isinstance(t, ast.Try) and t.finalbody
                and _releases_lease(t.finalbody)):
            continue
        for s in t.body:
            for n in ast.walk(s):
                if not isinstance(n, ast.Call):
                    continue
                name = _call_name(n)
                chain = _deep_chain(n.func)
                root = chain[0] if chain else ""
                bad = None
                if root in _OBS_TRACER_NAMES and name not in _OBS_TRACER_OK:
                    bad = f"{root}.{name}"
                elif "metrics" in chain[:-1] and name not in _OBS_METRIC_OK:
                    bad = ".".join(chain)
                elif isinstance(n.func, ast.Name) and name in _OBS_AGGREGATORS:
                    bad = name
                if bad:
                    out.append(Finding(
                        "obs-in-lease-window", f"{relpath}:{n.lineno}",
                        f"{bad}() while a lease is held (released in the "
                        f"finally at line {t.finalbody[0].lineno}) — only "
                        f"O(1) emits (emit/emit_span/span, "
                        f"add/observe/set/inc) are allowed inside a lease "
                        f"window; aggregating reads sync every thread's "
                        f"cells"))
    return out


def _scheduler_mutation_findings(relpath: str, tree: ast.AST) -> List[Finding]:
    out = []

    def targets(node: ast.stmt) -> Iterable[ast.expr]:
        if isinstance(node, ast.Assign):
            return node.targets
        if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            return [node.target]
        if isinstance(node, ast.Delete):
            return node.targets
        return []

    for n in ast.walk(tree):
        for tgt in targets(n):
            base = tgt
            while isinstance(base, (ast.Subscript, ast.Attribute)):
                # terminal `self.scheduler = ...` rebinding is allowed;
                # anything *through* .scheduler. is not
                if isinstance(base, ast.Attribute) and base.attr == "scheduler" \
                        and base is not tgt:
                    out.append(Finding(
                        "scheduler-state-mutation",
                        f"{relpath}:{n.lineno}",
                        f"assignment through "
                        f"{'.'.join(_attr_chain(tgt)) or 'scheduler'} — "
                        f"scheduler state is mutated only by its own "
                        f"methods"))
                    break
                base = base.value
    return out


def lint_file(relpath: str, source: str) -> List[Finding]:
    try:
        tree = ast.parse(source, filename=relpath)
    except SyntaxError as e:
        return [Finding("syntax-error", f"{relpath}:{e.lineno}", str(e.msg))]
    out = _shard_map_findings(relpath, tree)
    out += _obs_lease_window_findings(relpath, tree)
    if relpath == os.path.join("serving", "engine.py"):
        out += _lease_window_findings(relpath, tree)
        out += _scheduler_mutation_findings(relpath, tree)
    seen = set()
    uniq = []
    for f in out:
        if (f.rule, f.where) not in seen:
            seen.add((f.rule, f.where))
            uniq.append(f)
    return uniq


def lint_tree(root: str = SRC_ROOT) -> List[Finding]:
    """Lint every .py under ``src/repro_torch`` (root defaults to the
    installed package directory)."""
    findings: List[Finding] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in {"__pycache__", ".git"})
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root)
            with open(path, "r", encoding="utf-8") as fh:
                findings += lint_file(rel, fh.read())
    return findings


# ---------------------------------------------------------------------------
# allowlist: "rule path-substring message-substring" per line (whitespace
# separated; path may be "file.py:123"; message-substring is the rest of
# the line), # comments
# ---------------------------------------------------------------------------


def load_allowlist(path: str) -> List[Tuple[str, str, str]]:
    entries: List[Tuple[str, str, str]] = []
    if not os.path.exists(path):
        return entries
    with open(path, "r", encoding="utf-8") as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(None, 2)
            while len(parts) < 3:
                parts.append("")
            entries.append((parts[0], parts[1], parts[2]))
    return entries


def apply_allowlist(findings: Iterable[Finding],
                    entries: Sequence[Tuple[str, str, str]]) -> List[Finding]:
    def waived(f: Finding) -> bool:
        return any(f.rule == rule
                   and (not psub or psub in f.where)
                   and (not msub or msub in f.message)
                   for rule, psub, msub in entries)
    return [f for f in findings if not waived(f)]
