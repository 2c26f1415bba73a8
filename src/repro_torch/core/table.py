"""The global visible-readers table (paper §3).

One table is shared by *all* locks and threads in an address space.  Slots
hold either 0 (null) or the identity of a reader-writer lock (a small int
handed out by :func:`next_lock_id`; real systems store the lock address —
ints keep CAS trivial in both memory backends).

The hash mixes the lock identity with the calling thread's identity
(paper Listing 1 line 13) via a splitmix64-style finalizer.  Three
implementations exist, all bit-exact: the scalar :func:`mix_hash` here (the
host lock fast path), the vectorized :func:`mix_hash_vec` (numpy uint64,
used by ``device_bravo.slots_for``), and the uint32 limb-pair variant in
``repro_torch.kernels.hash`` that runs *inside* the fused device programs.
"""

from __future__ import annotations

import itertools
import threading
from typing import List

from .atomics import AtomicArray, Cell, Mem

__all__ = ["VisibleReadersTable", "next_lock_id", "mix_hash",
           "mix_hash_vec"]

_lock_ids = itertools.count(1)
_lock_id_guard = threading.Lock()

# 64-byte cache lines, 8-byte slots -> 8 slots per line.  Near-collisions
# (same line, different slot) cause false sharing, exactly as in the paper.
SLOTS_PER_LINE = 8
DEFAULT_TABLE_SIZE = 4096


def next_lock_id() -> int:
    with _lock_id_guard:
        return next(_lock_ids)


def mix_hash(lock_id: int, thread_id: int) -> int:
    """splitmix64 finalizer over (lock, thread) — deterministic, as in the
    paper (threads repeatedly locking one lock reuse their slot -> temporal
    locality)."""
    x = (lock_id * 0x9E3779B97F4A7C15 + thread_id * 0xBF58476D1CE4E5B9) \
        & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 31
    return x


def mix_hash_vec(lock_id: int, thread_ids) -> "np.ndarray":
    """Vectorized :func:`mix_hash` over a thread-id vector — no Python
    loop.  Delegates to the numpy uint64 oracle in ``repro_torch.kernels.hash``
    (which also houses the uint32 limb variant the device kernels use)."""
    from ..kernels.hash import mix_hash_u64
    return mix_hash_u64(lock_id, thread_ids)


class VisibleReadersTable:
    """Fixed-size global table of visible fast-path readers."""

    def __init__(self, mem: Mem, size: int = DEFAULT_TABLE_SIZE,
                 name: str = "VisibleReaders"):
        assert size > 0 and (size & (size - 1)) == 0, "power-of-two size"
        self.mem = mem
        self.size = size
        self.arr: AtomicArray = mem.alloc_array(
            name, size, init=0, entries_per_line=SLOTS_PER_LINE)

    def slot_for(self, lock_id: int, thread_id: int) -> Cell:
        return self.arr.cell(mix_hash(lock_id, thread_id) & (self.size - 1))

    def scan(self, lock_id: int) -> List[int]:
        """Indices of every slot currently publishing ``lock_id``."""
        return self.arr.scan(lock_id)

    def cell(self, i: int) -> Cell:
        return self.arr.cell(i)

    def footprint_bytes(self) -> int:
        return self.size * 8
