"""BRAVO — Biased Locking for Reader-Writer Locks (paper Listing 1).

``BRAVO(underlying)`` adds exactly two fields to the lock instance —
``RBias`` and ``InhibitUntil`` — plus access to the global
:class:`~repro_torch.core.table.VisibleReadersTable` shared by every lock and
thread in the address space.

Reader fast path (constant time):
  1. If ``RBias`` is set, hash (thread, lock) into the table and
     ``CAS(slot, null, lock)``.
  2. On success, issue a store-load fence and *re-check* ``RBias``; if still
     set, read permission is held without touching the underlying lock.
  3. Otherwise undo the slot and fall through to the slow path.

Reader slow path: acquire read on the underlying lock; while holding it
(writers excluded — safe), re-arm ``RBias`` if ``now() >= InhibitUntil``.

Writer path: acquire write on the underlying lock; if ``RBias``: clear it,
then scan the whole table and wait for every slot publishing this lock to
drain (revocation).  The revocation duration ``d`` inhibits re-arming for
``max(d, ewma(d)) * N`` (default N=9, see :func:`adaptive_inhibit`),
bounding worst-case writer slowdown to ~1/(N+1) ≈ 10% (*primum non
nocere*, paper §3) while smoothing over one-off scan outliers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

from ..obs import TRACER as _TR
from .atomics import Mem
from .rwlocks import RWLock
from .table import VisibleReadersTable, next_lock_id

__all__ = ["BRAVO", "BravoStats", "DEFAULT_N", "adaptive_inhibit"]

DEFAULT_N = 9  # slow-down guard (paper Listing 1 line 8)


def adaptive_inhibit(prev_ewma: int, d: int, n: int) -> Tuple[int, int]:
    """Per-lock adaptive inhibit window: -> (new_ewma, window).

    The paper sets InhibitUntil from the *last* revocation alone
    (``now + d*N``); a single unlucky scan then mis-sizes the window for
    every future rearm of that lock.  Instead each lock tracks a smoothed
    revocation cost (EWMA, alpha=1/4) and the window is
    ``max(d, ewma) * N`` — measured revocation latency times the
    slow-down multiplier, never shorter than the paper's bound for the
    revocation just paid.  This ONE policy is shared by the host
    :class:`BRAVO`, the device :class:`~.device_bravo.DeviceLeaseTable`
    and the per-lock vectors of :class:`~.registry.BravoRegistry`, so host
    and device rearm decisions match.
    """
    ewma = d if prev_ewma == 0 else (3 * prev_ewma + d) // 4
    return ewma, max(d, ewma) * n


@dataclass
class BravoStats:
    fast_acquires: int = 0
    slow_acquires: int = 0
    cas_failures: int = 0       # slot collisions (birthday-paradox odds)
    recheck_failures: int = 0   # lost the race against a revoking writer
    bias_sets: int = 0
    revocations: int = 0
    revocation_ns: int = 0
    extra: dict = field(default_factory=dict)

    @property
    def fastpath_rate(self) -> float:
        tot = self.fast_acquires + self.slow_acquires
        return self.fast_acquires / tot if tot else 0.0


class BRAVO(RWLock):
    """The BRAVO transformation over any :class:`RWLock`."""

    def __init__(self, underlying: RWLock, table: VisibleReadersTable,
                 mem: Mem, n: int = DEFAULT_N, collect_stats: bool = True):
        self.u = underlying
        self.table = table
        self.mem = mem
        self.n = n
        self.name = f"bravo-{underlying.name}"
        self.lock_id = next_lock_id()
        # RBias + InhibitUntil share one line, separate from the underlying
        # lock's state (the paper co-locates them in the instance padding).
        hdr = mem.alloc_array(f"bravo{self.lock_id}.hdr", 2,
                              entries_per_line=8)
        self.rbias = hdr.cell(0)
        self.inhibit_until = hdr.cell(1)
        # smoothed per-lock revocation cost (policy state, not lock state:
        # only the writer — who holds write exclusion — ever touches it)
        self.revoke_ewma_ns = 0
        self.stats = BravoStats() if collect_stats else None

    # ------------------------------------------------------------- readers
    def acquire_read(self):
        mem = self.mem
        st = self.stats
        if self.rbias.load():
            slot = self.table.slot_for(self.lock_id, mem.thread_id())
            if slot.cas(0, self.lock_id):
                # store-load fence required on TSO; subsumed by CAS
                mem.fence()
                if self.rbias.load():      # recheck (Listing 1 line 18)
                    if st:
                        st.fast_acquires += 1
                    if _TR.enabled:
                        _TR.emit("lock", "fast", lock=self.name)
                    return ("fast", slot)
                slot.store(0)              # raced with a revoking writer
                if st:
                    st.recheck_failures += 1
            elif st:
                st.cas_failures += 1
        # slow path
        tok = self.u.acquire_read()
        if st:
            st.slow_acquires += 1
        if _TR.enabled:
            _TR.emit("lock", "slow", lock=self.name)
        if self.rbias.load() == 0 and mem.now() >= self.inhibit_until.load():
            # safe: we hold read permission, so no writer is active
            self.rbias.store(1)
            if st:
                st.bias_sets += 1
        return ("slow", tok)

    def release_read(self, tok) -> None:
        # the token is mandatory: it records which path (fast slot vs
        # underlying lock) the acquire took — there is no tokenless release
        kind, x = tok
        if kind == "fast":
            x.store(0)
        else:
            self.u.release_read(x)

    # ------------------------------------------------------------- writers
    def acquire_write(self):
        mem = self.mem
        tok = self.u.acquire_write()
        if self.rbias.load():
            # revoke bias (store-load fence required on TSO)
            self.rbias.store(0)
            mem.fence()
            if _TR.enabled:
                _TR.emit("lock", "revoke_begin", lock=self.name)
            start = mem.now()
            lid = self.lock_id
            for i in self.table.scan(lid):
                # wait for each conflicting fast-path reader to depart
                mem.wait_while(self.table.cell(i), lambda v, L=lid: v == L)
            now = mem.now()
            if _TR.enabled:
                _TR.emit("lock", "revoke_drain", lock=self.name,
                         cost_ns=now - start)
            # primum non nocere: bound revocation-induced slow-down with
            # the per-lock adaptive window (same policy as the device side)
            self.revoke_ewma_ns, window = adaptive_inhibit(
                self.revoke_ewma_ns, now - start, self.n)
            self.inhibit_until.store(now + window)
            if self.stats:
                self.stats.revocations += 1
                self.stats.revocation_ns += now - start
        return tok

    def release_write(self, tok) -> None:
        # mandatory for the same reason as release_read: the underlying
        # lock (e.g. cohort-rw) may need its token back
        self.u.release_write(tok)

    def footprint_bytes(self) -> int:
        return self.u.footprint_bytes() + 12  # +RBias (4B) +InhibitUntil (8B)
