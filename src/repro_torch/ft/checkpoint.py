"""Sharded, manifest-based checkpointing with atomic commit and async save,
over trees of tensors.

The port of ``repro.ft.checkpoint``, with its on-disk format, so that a
checkpoint written by either package loads in the other:

  <dir>/step_000123.tmp/...          while writing
  <dir>/step_000123/                 after atomic rename (commit point)
      manifest.json                  leaf shapes, dtypes, CRCs, shards
      shard_00000.npz                leaf arrays (flattened tree order)

* Leaf order is JAX's: a dict flattens by sorted key, a list or tuple in
  order, ``None`` holds no leaf (:func:`tree_flatten`).  The port's dicts
  keep insertion order, so flattening them as they stand would misnumber
  the leaves of a tree written by ``repro``.
* Each leaf's ``crc32`` covers its contiguous bytes.  A bfloat16 leaf is
  stored as ``repro`` stores it (numpy has no bfloat16: 2-byte void
  elements in the ``.npy``, ``"bfloat16"`` in the manifest) and read back
  through a 16-bit integer view, so the bytes and their CRC agree.
* The manifest's ``treedef`` field describes the tree for a reader; no
  loader parses it (``repro`` writes JAX's string there, the port its own).
* Async: ``CheckpointManager.save_async`` snapshots to host memory, then
  writes on a background thread; its state is guarded by a BRAVO rwlock.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.factory import LockEnv
from ..dist.sharding import spec_leaves, unshard_tree

BF16 = "bfloat16"


class CheckpointCorrupt(IOError):
    """A checkpoint failed per-tensor CRC (or structural) verification.

    Carries ``leaf`` (flat-tree index) and ``shard`` (file name) so a
    hot-swap caller can log WHICH tensor the stream corrupted.  Raised
    during streaming, before the full tree is materialised: a bad shard is
    rejected before any epoch swap begins."""

    def __init__(self, message: str, *, leaf: Optional[int] = None,
                 shard: Optional[str] = None):
        super().__init__(message)
        self.leaf = leaf
        self.shard = shard


# ---------------------------------------------------------------------------
# Trees, flattened as JAX flattens them
# ---------------------------------------------------------------------------


# The walks are module functions: a recursive closure refers to itself
# through its cell, a cycle that would keep the leaves it saw (whole
# parameter and gradient trees) allocated until the garbage collector ran.


def _walk(node, leaves: List[Any]):
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", keys, [_walk(node[k], leaves) for k in keys])
    if isinstance(node, (list, tuple)):
        return (type(node), None, [_walk(v, leaves) for v in node])
    if node is None:
        return ("none", None, [])
    leaves.append(node)
    return ("leaf", None, [])


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """-> (leaves, treedef): dicts by sorted key, lists and tuples in
    order, ``None`` as an empty node, anything else a leaf."""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def _build(node, it):
    kind, keys, kids = node
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(keys, kids)}
    if kind == "none":
        return None
    if kind == "leaf":
        return next(it)
    return kind(_build(c, it) for c in kids)


def tree_unflatten(treedef: Any, leaves: List[Any]) -> Any:
    return _build(treedef, iter(leaves))


def _describe(treedef: Any) -> str:
    kind, keys, kids = treedef
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {_describe(c)}"
                               for k, c in zip(keys, kids)) + "}"
    if kind == "leaf":
        return "*"
    if kind == "none":
        return "None"
    inner = ", ".join(_describe(c) for c in kids)
    return f"[{inner}]" if kind is list else f"({inner})"


# ---------------------------------------------------------------------------
# Leaves <-> host arrays
# ---------------------------------------------------------------------------


def _host(leaf: Any) -> Tuple[np.ndarray, str]:
    """-> (the array written to the shard, the manifest's dtype string)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), BF16
        a = t.numpy()
        return a, str(a.dtype)
    a = np.asarray(leaf)
    if a.dtype.name == BF16:               # ml_dtypes' numpy bfloat16
        return np.ascontiguousarray(a).view("V2"), BF16
    return a, str(a.dtype)


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == BF16:
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# Save / stream / load
# ---------------------------------------------------------------------------


def save_checkpoint(directory: str | Path, step: int, tree: Any,
                    max_shard_bytes: int = 1 << 28, specs: Any = None,
                    mesh=None) -> Path:
    """Write ``tree`` (tensors on any device, or numpy arrays) as step
    ``step``; leaves move to the host one at a time, so the host holds at
    most one shard.

    With ``specs`` and ``mesh``, ``tree`` holds this rank's blocks (a
    sharded train step's): every rank gathers each leaf whole in turn
    (``dist.sharding.unshard_tree``) and rank 0 alone writes, so the files
    are those of the whole tree, in ``repro``'s format.  Every rank must
    call it, and returns once the checkpoint is committed."""
    d = Path(directory)
    tmp = d / f"step_{step:09d}.tmp"
    final = d / f"step_{step:09d}"
    leaves, treedef = tree_flatten(tree)
    if mesh is not None:
        wholes = (unshard_tree(x, s, mesh)
                  for x, s in zip(leaves, spec_leaves(specs)))
        if dist.get_rank() == 0:
            _write(tmp, final, step, wholes, treedef, max_shard_bytes)
        else:
            for _ in wholes:
                pass
        dist.barrier()
        return final
    _write(tmp, final, step, leaves, treedef, max_shard_bytes)
    return final


def _write(tmp: Path, final: Path, step: int, leaves, treedef,
           max_shard_bytes: int) -> None:
    tmp.mkdir(parents=True, exist_ok=True)
    manifest: Dict[str, Any] = {
        "step": step,
        "treedef": _describe(treedef),
        "leaves": [],
        "shards": [],
    }
    shard: Dict[str, np.ndarray] = {}
    shard_bytes = 0
    shard_id = 0

    def flush():
        nonlocal shard, shard_bytes, shard_id
        if not shard:
            return
        fn = f"shard_{shard_id:05d}.npz"
        np.savez(tmp / fn, **shard)
        manifest["shards"].append(fn)
        shard = {}
        shard_bytes = 0
        shard_id += 1

    for i, leaf in enumerate(leaves):
        a, dtype = _host(leaf)
        manifest["leaves"].append({
            "index": i, "shape": list(a.shape), "dtype": dtype,
            "crc32": _crc(a), "shard": shard_id,
        })
        shard[f"leaf_{i}"] = a
        shard_bytes += a.nbytes
        if shard_bytes >= max_shard_bytes:
            flush()
    flush()
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    os.replace(tmp, final)          # atomic commit


def read_manifest(directory: str | Path, step: int) -> Dict[str, Any]:
    d = Path(directory) / f"step_{step:09d}"
    return json.loads((d / "manifest.json").read_text())


def iter_checkpoint(directory: str | Path, step: int,
                    verify: bool = True):
    """Stream a checkpoint one tensor at a time: yields ``(index, tensor)``
    (a CPU tensor in the saved dtype) in flat-tree order, CRC-verifying
    each leaf AS IT IS READ.

    This is the hot-swap staging primitive: a corrupted shard raises
    :class:`CheckpointCorrupt` at the first bad tensor, before anything
    downstream (lock, drain, epoch bump) has happened.  Memory high-water
    is one shard, not the whole tree."""
    d = Path(directory) / f"step_{step:09d}"
    manifest = read_manifest(directory, step)
    by_shard: Dict[int, List[int]] = {}
    for meta in manifest["leaves"]:
        by_shard.setdefault(meta["shard"], []).append(meta["index"])
    for sid in sorted(by_shard):
        fn = manifest["shards"][sid]
        with np.load(d / fn) as z:
            for i in by_shard[sid]:
                try:
                    a = z[f"leaf_{i}"]
                except KeyError:
                    raise CheckpointCorrupt(
                        f"leaf {i} missing from {fn}", leaf=i, shard=fn)
                meta = manifest["leaves"][i]
                if verify:
                    crc = _crc(a)
                    if crc != meta["crc32"]:
                        raise CheckpointCorrupt(
                            f"checksum mismatch on leaf {i} "
                            f"(manifest {meta['crc32']:#010x}, "
                            f"stream {crc:#010x})", leaf=i, shard=fn)
                yield i, _tensor(a, meta["dtype"])


def load_checkpoint(directory: str | Path, step: int, like: Any,
                    verify: bool = True,
                    device: Optional[torch.device] = None) -> Any:
    """The checkpoint as a tree shaped like ``like``.  Leaves are CPU
    tensors in the saved dtypes; with ``device``, each verified leaf moves
    to ``device`` in the dtype of its ``like`` leaf as it streams (the
    serving engine's staging), so the host holds at most one shard."""
    manifest = read_manifest(directory, step)
    leaves, treedef = tree_flatten(like)
    if len(leaves) != len(manifest["leaves"]):
        raise CheckpointCorrupt(
            f"tree mismatch: {len(leaves)} vs {len(manifest['leaves'])}")
    out: List[Optional[torch.Tensor]] = [None] * len(leaves)
    for i, t in iter_checkpoint(directory, step, verify=verify):
        out[i] = t if device is None else t.to(device=device,
                                               dtype=leaves[i].dtype)
    return tree_unflatten(treedef, out)


def latest_step(directory: str | Path) -> Optional[int]:
    d = Path(directory)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.iterdir()
             if p.is_dir() and p.name.startswith("step_")
             and not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def _snapshot(tree: Any) -> Any:
    """A host copy of ``tree`` that later in-place updates cannot touch."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [
        x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor)
        else np.array(x) for x in leaves])


class CheckpointManager:
    """Async double-buffered saver; rwlock-guarded status."""

    def __init__(self, directory: str | Path, *, keep: int = 3,
                 env: Optional[LockEnv] = None,
                 lock_name: str = "bravo-pthread"):
        self.dir = Path(directory)
        self.keep = keep
        self.env = env or LockEnv()
        self.lock = self.env.make(lock_name)
        self._last_committed: Optional[int] = None
        self._in_flight: Optional[int] = None
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # readers (hot path: called by train loop / heartbeats every step)
    def status(self) -> Tuple[Optional[int], Optional[int]]:
        tok = self.lock.acquire_read()
        try:
            return self._last_committed, self._in_flight
        finally:
            self.lock.release_read(tok)

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()
        host_tree = _snapshot(tree)               # device -> host snapshot
        tok = self.lock.acquire_write()
        try:
            self._in_flight = step
        finally:
            self.lock.release_write(tok)

        def run():
            try:
                save_checkpoint(self.dir, step, host_tree)
                self._gc()
                tok = self.lock.acquire_write()
                try:
                    self._last_committed = step
                    self._in_flight = None
                finally:
                    self.lock.release_write(tok)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self) -> None:
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.dir.iterdir()
            if p.is_dir() and p.name.startswith("step_")
            and not p.name.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)
