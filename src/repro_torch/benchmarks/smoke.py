"""Shared pass/fail plumbing for the port's benchmark gates.

``repro_torch.benchmarks.device_bravo``, ``.registry``, ``.hotswap``,
``.slo``, ``.obs``, ``.scheduler``, ``.prefill`` and ``.quant`` exit nonzero
on any mismatch; the check/timeit helpers, the spread of repeated readings
and the serving benchmarks' dense token oracle live here once so the gate
semantics cannot drift between them.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable, Iterable, List, Optional

FAILURES: List[str] = []


def check(ok: bool, what: str) -> None:
    status = "ok" if ok else "MISMATCH"
    print(f"[{status}] {what}", flush=True)
    if not ok:
        FAILURES.append(what)


def timeit(fn: Callable[[], object], iters: int) -> float:
    """Mean wall-clock seconds per call (fn must block on completion: a
    call on the card synchronizes it before returning)."""
    fn()                                 # warmup
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def device_ms(dev, fn: Callable[[], object], iters: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``iters`` calls after one
    warm-up: CUDA events around the calls on the card, the host clock on
    the CPU."""
    import torch

    if dev.type != "cuda":
        return timeit(fn, iters) * 1e3
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def spread(readings: Iterable[float]) -> dict:
    """Repeated readings of one metric (one a window): their median, the
    number gates read, beside the least and the largest."""
    xs = list(readings)
    return {"median": statistics.median(xs), "min": min(xs),
            "max": max(xs), "readings": xs}


# ---------------------------------------------------------------------------
# The card's side of the gates: synchronization, the sync gate, in-place
# ---------------------------------------------------------------------------


def eager_steps(eng):
    """Put the bare steps on an engine in place of its graphed ones
    (``steps.jit_step``): the eager arm of a comparison run in turns.
    Scheduler mode: the paged decode and prefill steps and the
    copy-on-write page copy.  Handler mode: the prefill and decode of every
    handler thread at every batch size made from then on (call it before
    ``start()``), with the same per-thread cache trees.  -> ``eng``."""
    from ..serving.engine import copy_page
    from ..serving.steps import make_decode_step, make_paged_prefill_step

    eng._graph_handlers = False
    if eng.scheduler is not None:
        eng._decode_paged = make_decode_step(eng.cfg, paged=True)
        eng._prefill_paged = make_paged_prefill_step(eng.cfg)
        eng._copy_page_step = copy_page
    return eng


def sync(dev) -> None:
    """Wait for the card (a no-op on the CPU)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def allocated(dev) -> Optional[int]:
    """``torch.cuda.memory_allocated`` on the card, None on the CPU."""
    import torch

    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None


def sync_gate(dev, fn: Callable[[], object]) -> str:
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("error")``, which
    raises on any host-device synchronization (a copy either way, a read
    of a device value): the analogue of ``jax.transfer_guard("disallow")``.
    -> "passed", "tripped", or "inactive" on the CPU, where host and
    device are one and nothing can be gated."""
    import torch

    if dev.type != "cuda":
        return "inactive"
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        print(f"  sync gate tripped: {e}", flush=True)
        return "tripped"
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(dev)
    return "passed"


def in_place(dev, table_of: Callable[[], object], pair: Callable[[], None],
             pairs: int = 100) -> dict:
    """The torch form of ``repro``'s aliasing proof: the table tensor keeps
    its storage across ``pairs`` acquire/release pairs, and on the card
    ``torch.cuda.memory_allocated()`` does not grow over them."""
    import torch

    pair()                                          # warm-up
    sync(dev)
    ptr = table_of().data_ptr()
    before = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None
    for _ in range(pairs):
        pair()
    sync(dev)
    growth = (torch.cuda.memory_allocated(dev) - before
              if before is not None else None)
    same = table_of().data_ptr() == ptr
    check(same, f"table storage unchanged over {pairs} pairs")
    if growth is not None:
        check(growth <= 0, f"device memory did not grow over {pairs} pairs "
                           f"({growth} B)")
    return {"pairs": pairs, "table_ptr_unchanged": same,
            "memory_growth_bytes": growth,
            "memory_check": "active" if growth is not None else "inactive"}


# ---------------------------------------------------------------------------
# The serving benchmarks' token oracle
# ---------------------------------------------------------------------------


def dense_reference(cfg, params, prompt, max_new: int, dev,
                    max_seq: int = 64, logits: Optional[list] = None,
                    forced: Optional[List[int]] = None) -> List[int]:
    """Greedy tokens of one request through the dense (non-paged) decode
    step: the prompt fed token by token into a bf16 cache, then
    ``max_new`` generated tokens.  ``logits``: a list that receives each
    generated step's float32 logits, (V,) on the host.  ``forced``: the
    generated tokens to feed back in place of the loop's own (teacher
    forcing), so ``logits`` holds each step's logits given that prefix."""
    import torch

    from ..models import model as M
    from ..serving.steps import make_decode_step

    decode = make_decode_step(cfg)
    caches = M.init_caches(cfg, 1, max_seq, dtype=torch.bfloat16,
                           device=dev)
    toks = torch.as_tensor(prompt, dtype=torch.int32).to(dev)[None]
    s = toks.shape[1]
    out: List[int] = []
    cur = toks[:, :1]
    for step in range(s - 1 + max_new):
        clen = torch.full((1,), step + 1, dtype=torch.int32, device=dev)
        nxt, lg, caches = decode(params, caches, cur, clen)
        if step + 1 < s:
            cur = toks[:, step + 1:step + 2]
        else:
            out.append(int(nxt[0, 0]))
            cur = nxt if forced is None else torch.full(
                (1, 1), forced[len(out) - 1], dtype=torch.int32, device=dev)
            if logits is not None:
                logits.append(lg[0].float().cpu())
    return out


def deficit_rel(lg, tok) -> float:
    """How far ``tok``'s logit stands below the best of ``lg``, relative
    to the largest |logit|."""
    return float((lg.max() - lg[tok]) / lg.abs().max())


def teacher_forced(cfg, params, prompt, got, dev, max_seq: int = 64) -> dict:
    """The dense loop (caches of ``max_seq`` positions) fed the engine's
    tokens ``got``: at how many steps the engine's token is not the loop's
    best given the same prefix, and its largest :func:`deficit_rel` over
    all steps."""
    logits: list = []
    best = dense_reference(cfg, params, prompt, len(got), dev,
                           max_seq=max_seq, logits=logits, forced=got)
    return {"flips": sum(a != b for a, b in zip(got, best)),
            "max_deficit_rel": max((deficit_rel(lg, t)
                                    for lg, t in zip(logits, got)),
                                   default=0.0)}


def hold_tokens(cfg, params, dev, prompts, got, max_new: int,
                near_tie_rel: Optional[float] = None,
                max_seq: int = 64) -> dict:
    """Hold request i's tokens ``got[i]`` (``max_new`` of them, for
    ``prompts[i]``) to the dense reference through
    :func:`teacher_forced`: with no flip at any step the free-running
    dense loop gives exactly ``got[i]``.  ``near_tie_rel=None`` demands
    that (``ok``); otherwise every step's token must stand within
    ``near_tie_rel * max |logit|`` of the dense step's best (R12: bf16
    rounds the paged engine and the dense loop apart at full width).
    ``max_seq``: the dense loop's cache positions, at least the longest
    prompt plus ``max_new``.  A (prompt, tokens) pair that repeats is
    forced once."""
    seen: dict = {}
    tf = []
    for p, g in zip(prompts, got):
        key = (tuple(int(t) for t in p), tuple(int(t) for t in g))
        if key not in seen:
            seen[key] = teacher_forced(cfg, params, p, g, dev,
                                       max_seq=max_seq)
        tf.append(seen[key])
    whole = len(got) == len(prompts) and all(len(g) == max_new
                                             for g in got)
    exact = whole and not any(t["flips"] for t in tf)
    worst = max((t["max_deficit_rel"] for t in tf), default=0.0)
    ok = exact if near_tie_rel is None else whole and worst <= near_tie_rel
    return {"ok": ok, "exact": exact,
            "oracle": ("dense reference" if near_tie_rel is None else
                       f"dense reference's best within {near_tie_rel}"),
            "flips": [t["flips"] for t in tf], "max_deficit_rel": worst}
