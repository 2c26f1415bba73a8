"""Multi-lock BRAVO registry: many locks, one visible-readers table.

The port of ``repro.core.registry``.  Up to ``MAX_LOCKS`` independent BRAVO
locks share the one 16 KiB table; each lock adds a bias lane in the
device-resident ``rbias`` vector and a value in the device mirror
``lock_vals``, plus host-side policy vectors (inhibit deadline, revocation
cost, drain gate) driven by the host monotonic clock.

Every lease operation is ONE launch of a hand-written CUDA kernel on the
table tensor, updated in place (``kernels.table_publish``): an acquire (K1)
hashes each reader to its slot, gathers its lock's value and bias lane and
publishes, all in the kernel; a release (K2) clears the slots the acquire
won.  Writers drain with the poll kernels (K3 per lock, K4 for many).  The
reader fast path moves no bytes between host and device: reader ids and
lock lanes stay on the device, the grant mask is never read on the host,
and ``rearm`` of an armed lock dispatches nothing.  Bias-lane and
lock-value updates are ``fill_`` launches on a one-element view, with the
value as a kernel argument.

All dispatches happen under ``self._mu`` on PyTorch's current stream of
the registry's device, so the device runs them in the order the host
issued them: a drain poll never reads a table that a later publish has
already changed.  Callers must not switch streams around these calls.

The semantics (lane recycling with fresh values, TWA-style writer parking,
bounded drains with :class:`~.errors.DrainTimeout`, the stuck-lane scrub and
the generation bump) are ``repro``'s, unchanged; see that module's
docstring.  ``configure_mesh`` / ``make_sharded_revoke`` wait for the
multi-device slice.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve
from ..kernels import ops as K
from ..kernels import table_publish as TP
from ..obs import TRACER as _TR
from ..obs.metrics import MetricsRegistry
from .bravo import DEFAULT_N, adaptive_inhibit
from .device_bravo import (TABLE_SLOTS, _drain, _release_ids32_all_impl,
                           _release_ids32_impl)
from .errors import DrainTimeout, ProtocolError
from .table import next_lock_id

__all__ = ["BravoRegistry", "RegistryHandle", "MAX_LOCKS", "PARK_SLOTS"]

MAX_LOCKS = 128   # bias lanes per registry by default (K4 polls any number)
PARK_SLOTS = 16   # TWA-style waiting array: parking slots shared by lanes


def _set_lane(vec: torch.Tensor, idx: int, value: int) -> None:
    """``vec[idx] = value`` in place, with no host-to-device copy."""
    vec.narrow(0, idx, 1).fill_(value)


class BravoRegistry:
    """Up to ``max_locks`` BRAVO locks multiplexed over one device table.

    Thread-safe: the mutex orders the host-side bookkeeping and every
    dispatch; each operation is one kernel launch (see module docstring).
    ``device`` defaults to the CUDA card and raises if there is none."""

    def __init__(self, slots: int = TABLE_SLOTS,
                 max_locks: int = MAX_LOCKS, n: int = DEFAULT_N,
                 metrics: Optional[MetricsRegistry] = None,
                 device: DeviceLike = None):
        if slots % (K.LANES * 8) != 0:
            raise ProtocolError(
                f"table slots {slots} must be a multiple of {K.LANES * 8}")
        self.device = resolve(device)
        self.max_locks = max_locks
        self.n = n
        dev = self.device
        self.table = torch.zeros((slots // K.LANES, K.LANES),
                                 dtype=torch.int32, device=dev)
        self.rbias = torch.zeros(max_locks, dtype=torch.int32, device=dev)
        self.lock_vals = torch.zeros(max_locks, dtype=torch.int32,
                                     device=dev)
        self._mu = threading.Lock()
        # per-lock policy vectors (host clock drives the rearm policy)
        self.inhibit_until_ns = np.zeros(max_locks, np.int64)
        self.revoke_ewma_ns = np.zeros(max_locks, np.int64)
        self.revocations = np.zeros(max_locks, np.int64)
        self._armed = np.zeros(max_locks, bool)      # host shadow of rbias
        self._revoking = np.zeros(max_locks, np.int32)   # PER-LOCK drain gate
        self._vals = np.zeros(max_locks, np.int64)   # 0 = lane unallocated
        self._used = np.zeros(max_locks, bool)       # lane ever allocated
        self._free = list(range(max_locks - 1, -1, -1))
        # TWA-style waiting array: writers queueing behind an in-flight
        # drain park here (slot = lane % PARK_SLOTS) instead of spinning
        self._park = [threading.Condition(self._mu)
                      for _ in range(PARK_SLOTS)]
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c_publishes = self.metrics.counter("registry.publishes")
        self._c_allocs = self.metrics.counter("registry.allocs")
        self._c_recycles = self.metrics.counter("registry.recycles")
        self._c_parks = self.metrics.counter("registry.parks")
        self._c_drain_timeouts = self.metrics.counter(
            "registry.drain_timeouts")
        self._c_lane_scrubs = self.metrics.counter("registry.lane_scrubs")
        self._h_revocation = self.metrics.histogram("registry.revocation_ns")
        self._h_drain_wait = self.metrics.histogram("registry.drain_wait_ns")
        # device-resident slow-path pressure counter: denied publishes are
        # folded on the device (only while tracing) and read only in stats()
        self._dev_denied = torch.zeros((), dtype=torch.int32, device=dev)

    @property
    def publishes(self) -> int:
        return self._c_publishes.value

    @property
    def allocs(self) -> int:
        return self._c_allocs.value

    @property
    def recycles(self) -> int:
        return self._c_recycles.value

    @property
    def parks(self) -> int:
        return self._c_parks.value

    @property
    def drain_timeouts(self) -> int:
        return self._c_drain_timeouts.value

    @property
    def lane_scrubs(self) -> int:
        return self._c_lane_scrubs.value

    # ------------------------------------------------------- lock lifecycle
    def alloc(self, name: Optional[str] = None) -> "RegistryHandle":
        """Allocate a lock: a free bias lane + a fresh lock value, armed."""
        with self._mu:
            if not self._free:
                raise ProtocolError(
                    f"registry full: all {self.max_locks} bias lanes are "
                    f"allocated (free() a handle before alloc())")
            idx = self._free.pop()
            val = next_lock_id()
            self._c_allocs.add(1)
            self._c_recycles.add(int(self._used[idx]))
            if _TR.enabled:
                _TR.emit("lock", "alloc", lane=idx, lock_id=val,
                         recycled=bool(self._used[idx]))
            self._used[idx] = True
            self._vals[idx] = val
            self._armed[idx] = True
            self._revoking[idx] = 0
            self.inhibit_until_ns[idx] = 0
            self.revoke_ewma_ns[idx] = 0
            self.revocations[idx] = 0
            _set_lane(self.rbias, idx, 1)
            _set_lane(self.lock_vals, idx, val)
        return RegistryHandle(self, idx, val, name=name)

    def _park_until_idle(self, idx: int, deadline: float, who: str) -> None:
        """Park (TWA waiting array) until lane ``idx``'s drain gate closes.
        Caller holds ``self._mu``.  Raises :class:`DrainTimeout` at
        ``deadline``."""
        park = self._park[idx % PARK_SLOTS]
        t0 = None
        try:
            while self._revoking[idx]:
                if t0 is None:
                    t0 = time.monotonic_ns()
                    if _TR.enabled:
                        _TR.emit("lock", "park", lane=idx, who=who)
                self._c_parks.add(1)
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not park.wait(timeout=remaining):
                    if not self._revoking[idx]:
                        return        # gate closed exactly at the deadline
                    raise DrainTimeout(
                        f"{who}: revocation drain still in flight on lane "
                        f"{idx} (lock value {int(self._vals[idx])}) after "
                        f"parking past the deadline",
                        lock_id=int(self._vals[idx]), idx=idx)
        finally:
            if t0 is not None:
                self._h_drain_wait.observe(time.monotonic_ns() - t0)
                if _TR.enabled:
                    _TR.emit_span("lock", "unpark", t0, lane=idx, who=who)

    def _wake_parked(self, idx: int) -> None:
        self._park[idx % PARK_SLOTS].notify_all()

    def free(self, h: "RegistryHandle", wait_s: float = 5.0) -> None:
        """Recycle ``h``'s bias lane: scrub every slot still publishing its
        value; the lane's next tenant publishes a different value.  Waits
        (parked, up to ``wait_s``) for an in-flight drain on this lock."""
        deadline = time.monotonic() + wait_s
        with self._mu:
            if h.closed:
                return
            self._park_until_idle(h.idx, deadline, f"free({h.name})")
            h.closed = True
            idx = h.idx
            if _TR.enabled:
                _TR.emit("lock", "free", lane=idx, lock_id=h.lock_id)
            _set_lane(self.rbias, idx, 0)
            _set_lane(self.lock_vals, idx, 0)
            self._scrub(h.lock_id)
            self._vals[idx] = 0
            self._armed[idx] = False
            self._free.append(idx)

    def _scrub(self, val: int) -> None:
        """Clear every slot still publishing ``val``, in place."""
        self.table.masked_fill_(self.table == val, 0)

    @staticmethod
    def _check_open(h: "RegistryHandle") -> None:
        # a freed handle's lane may already belong to a NEW lock
        if h.closed:
            raise ProtocolError(
                f"{h.name}: handle used after free() (lane {h.idx}, dead "
                f"lock value {h.lock_id}); the lane may already belong to "
                f"a new lock")

    def _fold_denied(self, granted: torch.Tensor) -> None:
        self._dev_denied += granted.numel() - granted.sum(dtype=torch.int32)

    # -------------------------------------------------------------- readers
    def acquire(self, h: "RegistryHandle",
                reader_ids: torch.Tensor) -> torch.Tensor:
        """Publish leases for device-resident int32 ``reader_ids`` under
        ``h``'s lock; returns the device grant mask without synchronizing."""
        with self._mu:
            self._check_open(h)
            granted = TP.acquire_hashed(self.table, self.rbias,
                                        self.lock_vals, h._idx, reader_ids)
            self._c_publishes.add(1)
            if _TR.enabled:
                _TR.emit("lock", "publish", lock=h.name,
                         batch=int(reader_ids.numel()))
                self._fold_denied(granted)
        return granted

    def release(self, h: "RegistryHandle", reader_ids: torch.Tensor,
                granted: Optional[torch.Tensor] = None) -> None:
        """Clear leases; pass acquire's ``granted`` mask so denied readers
        never clear the slot they collided into."""
        with self._mu:
            self._check_open(h)
            if granted is None:
                _release_ids32_all_impl(self.table, reader_ids,
                                        self.lock_vals, h._idx)
            else:
                _release_ids32_impl(self.table, reader_ids, self.lock_vals,
                                    h._idx, granted)

    def acquire_by_index(self, lock_idx: torch.Tensor,
                         reader_ids: torch.Tensor) -> torch.Tensor:
        """One launch for a request batch SPANNING locks: each request names
        its lock by bias-lane index (device int32).  Lock values are
        gathered in the kernel from the device mirror."""
        with self._mu:
            granted = TP.acquire_hashed(self.table, self.rbias,
                                        self.lock_vals, lock_idx, reader_ids)
            self._c_publishes.add(1)
            if _TR.enabled:
                _TR.emit("lock", "publish", lock="by_index",
                         batch=int(reader_ids.numel()))
                self._fold_denied(granted)
        return granted

    def release_by_index(self, lock_idx: torch.Tensor,
                         reader_ids: torch.Tensor,
                         granted: torch.Tensor) -> None:
        with self._mu:
            _release_ids32_impl(self.table, reader_ids, self.lock_vals,
                                lock_idx, granted)

    # ------------------------------------------------------------ the writer
    def revoke(self, h: "RegistryHandle", *, n: Optional[int] = None,
               wait_poll_s: float = 0.0005, max_wait_s: float = 5.0,
               pipeline_depth: int = 2) -> int:
        """Clear ``h``'s bias lane (only!), drain its leases with K3 polls,
        and set its inhibit deadline from its measured revocation cost.
        Other locks' biases, drains and rearms are untouched throughout."""
        n = self.n if n is None else n
        idx = h.idx
        deadline = time.monotonic() + max_wait_s
        with self._mu:
            self._check_open(h)
            # a second writer (epoch swap racing pool compaction) parks on
            # the first writer's drain instead of polling the table
            self._park_until_idle(idx, deadline, f"revoke({h.name})")
            _set_lane(self.rbias, idx, 0)
            self._armed[idx] = False
            self._revoking[idx] += 1
            self.revocations[idx] += 1
            if _TR.enabled:
                _TR.emit("lock", "revoke_begin", lock=h.name, lane=idx)

        def poll_live(lid: int) -> torch.Tensor:
            # dispatch under the mutex: the poll is ordered on the stream
            # before any later publish or release on the table
            with self._mu:
                return K.revocation_poll(self.table, lid)

        try:
            start = time.monotonic_ns()
            try:
                scans = _drain(poll_live, h.lock_id,
                               wait_poll_s=wait_poll_s,
                               max_wait_s=max_wait_s,
                               pipeline_depth=pipeline_depth)
            except DrainTimeout as e:
                now = time.monotonic_ns()
                self._h_revocation.observe(now - start)
                if _TR.enabled:
                    _TR.emit("lock", "revoke_timeout", lock=h.name,
                             lane=idx, cost_ns=now - start)
                with self._mu:
                    self._c_drain_timeouts.add(1)
                    self._scrub_stuck_lane(h)
                    ewma, window = adaptive_inhibit(
                        int(self.revoke_ewma_ns[idx]), now - start, n)
                    self.revoke_ewma_ns[idx] = ewma
                    self.inhibit_until_ns[idx] = now + window
                e.idx = idx
                raise
            now = time.monotonic_ns()
            self._h_revocation.observe(now - start)
            if _TR.enabled:
                _TR.emit_span("lock", "revoke_drain", start, lock=h.name,
                              lane=idx, scans=scans)
            with self._mu:
                ewma, window = adaptive_inhibit(
                    int(self.revoke_ewma_ns[idx]), now - start, n)
                self.revoke_ewma_ns[idx] = ewma
                self.inhibit_until_ns[idx] = now + window
        finally:
            with self._mu:
                self._revoking[idx] -= 1
                if not self._revoking[idx]:
                    self._wake_parked(idx)
        return scans

    def _scrub_stuck_lane(self, h: "RegistryHandle") -> None:
        """Fence off a wedged reader after a drain deadline (mutex held):
        scrub every slot still publishing ``h``'s value and REGENERATE the
        lane's lock value; the handle's ``gen`` bumps with it, so the
        reader's eventual release is skipped by its owner.  The caller's
        raise stands: the reader may still be in its critical section."""
        idx = h.idx
        self._scrub(h.lock_id)
        new_val = next_lock_id()
        self._vals[idx] = new_val
        _set_lane(self.lock_vals, idx, new_val)
        h.lock_id = new_val
        h.gen += 1
        self._c_lane_scrubs.add(1)
        if _TR.enabled:
            _TR.emit("lock", "lane_scrub", lock=h.name, lane=idx)
            _TR.emit("lock", "gen_bump", lock=h.name, lane=idx, gen=h.gen)

    def rearm(self, h: "RegistryHandle") -> bool:
        """Re-arm ``h``'s bias iff ITS drain count is zero and ITS inhibit
        window has passed.  An armed lock returns without any dispatch."""
        idx = h.idx
        with self._mu:
            self._check_open(h)
            if self._armed[idx]:
                return True
            if self._revoking[idx]:
                return False              # never re-bias under OUR drain
            if time.monotonic_ns() >= int(self.inhibit_until_ns[idx]):
                _set_lane(self.rbias, idx, 1)
                self._armed[idx] = True
                if _TR.enabled:
                    _TR.emit("lock", "rearm", lock=h.name, lane=idx)
                return True
        return False

    # ---------------------------------------------------------------- stats
    def held(self, h: "RegistryHandle") -> int:
        """Hold count for one lock (K3; synchronizing, off the hot path)."""
        with self._mu:
            cnt = K.revocation_poll(self.table, h.lock_id)
        return int(cnt)

    def held_multi(self, handles) -> np.ndarray:
        """Exact per-lock hold counts in ONE table pass (K4; synchronizing)."""
        vals = torch.tensor([h.lock_id for h in handles], dtype=torch.int32,
                            device=self.device)
        with self._mu:
            cnt = K.revocation_poll_multi(self.table, vals)
        return cnt.cpu().numpy()

    def stats(self) -> dict:
        """Synchronizing summary; call off the hot path."""
        with self._mu:
            live = int((self._vals != 0).sum())
            return {"max_locks": self.max_locks,
                    "live_locks": live,
                    "allocs": self.allocs,
                    "recycles": self.recycles,
                    "publishes": self.publishes,
                    "revocations": int(self.revocations.sum()),
                    "parks": self.parks,
                    "drain_timeouts": self.drain_timeouts,
                    "lane_scrubs": self.lane_scrubs,
                    "armed": int(self._armed.sum()),
                    "rbias_armed": int(self.rbias.sum()),
                    "denied_publishes": int(self._dev_denied)}


class RegistryHandle:
    """One lock's view of a :class:`BravoRegistry` (acquire / release /
    revoke / rearm, plus ``lock_id`` and ``gen``).  Caches its bias lane as
    a one-element device tensor, so the steady state transfers nothing."""

    def __init__(self, registry: BravoRegistry, idx: int, lock_id: int,
                 name: Optional[str] = None):
        self.registry = registry
        self.idx = idx                 # bias lane in rbias[...]
        self.lock_id = lock_id         # value published into table slots
        self.name = name or f"reglock{idx}"
        self.closed = False
        self.gen = 0                   # bumps on stuck-lane value scrub
        self._idx = torch.full((1,), idx, dtype=torch.int32,
                               device=registry.device)

    def acquire(self, reader_ids: torch.Tensor) -> torch.Tensor:
        return self.registry.acquire(self, reader_ids)

    def release(self, reader_ids: torch.Tensor,
                granted: Optional[torch.Tensor] = None) -> None:
        self.registry.release(self, reader_ids, granted=granted)

    def revoke(self, **kw) -> int:
        return self.registry.revoke(self, **kw)

    def rearm(self) -> bool:
        return self.registry.rearm(self)

    def held(self) -> int:
        return self.registry.held(self)

    def free(self) -> None:
        self.registry.free(self)
