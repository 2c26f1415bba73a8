"""Device-side BRAVO: the visible-readers table on the card, the single-lock
lease table of the paper's design, and the helpers the registry shares.

The port of ``repro.core.device_bravo``.  One (rows, 128) int32 table of
``TABLE_SLOTS`` slots holds the leases; one scalar ``rbias`` per table is
the bias of every lock that publishes into it (the registry,
:mod:`.registry`, gives each lock its own bias lane instead).

Batched lease API (the zero-sync fast path).  A batch acquire is ONE
launch of the K2 kernel on the table tensor, updated in place
(``kernels.table_publish.publish_hashed``): the splitmix64 slot hash, the
publish and the recheck of ``rbias`` with its undo all run in the kernel,
as ``repro``'s ``_acquire_impl`` ran them in one fused program.  A release
is one K2 launch too (``release_hashed``), and denied readers clear
nothing.  With device-resident reader ids and the handle's cached lock
value, an acquire/release pair moves no bytes between host and device.

``acquire``/``release``/``revoke``/``rearm`` keep the functional
:class:`DeviceLeaseState` protocol (state in, state out).  Where ``repro``
consumed the table buffer by donation, these update the state's table
tensor in place: always continue from the returned state.  Host reader ids
(numpy, lists) are uploaded, and must lie in ``[0, 2**32)``: the kernels
hash the 32-bit reader id zero-extended, which equals ``repro``'s 64-bit
limb hash on that range.  :class:`DeviceLeaseTable` and
:class:`LeaseHandle` wrap the protocol for concurrent host threads.

Drain: ``repro`` kept up to ``pipeline_depth`` polls in flight, each count
prefetched with ``copy_to_host_async``.  Here each poll's count (K3) is
copied with ``non_blocking=True`` into pinned host memory and a CUDA event
marks the copy's completion, so the writer waits on at most one event per
decision instead of one synchronize per poll.

``make_distributed_revoke`` (the collective over a mesh of cards) waits for
a multi-card slice; ROADMAP.md lists it.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve
from ..kernels import ops as K
from ..kernels import table_publish as TP
from ..obs import TRACER as _TR
from .bravo import DEFAULT_N, adaptive_inhibit
from .errors import DrainTimeout
from .table import mix_hash_vec, next_lock_id

TABLE_SLOTS = 4096


@dataclasses.dataclass
class DeviceLeaseState:
    """Functional state: pass it through acquire/release/revoke.

    ``table`` is updated in place by acquire/release; always continue from
    the returned state."""
    table: torch.Tensor       # (rows, 128) int32
    rbias: torch.Tensor       # () int32
    inhibit_until_ns: int     # host clock (ns)
    revoke_ewma_ns: int = 0   # smoothed revocation cost (adaptive_inhibit)


def init_state(slots: int = TABLE_SLOTS,
               device: DeviceLike = None) -> DeviceLeaseState:
    """An empty, biased table on ``device`` (default: the CUDA card)."""
    dev = resolve(device)
    return DeviceLeaseState(
        table=torch.zeros((slots // K.LANES, K.LANES), dtype=torch.int32,
                          device=dev),
        rbias=torch.ones((), dtype=torch.int32, device=dev),
        inhibit_until_ns=0,
    )


def slots_for(lock_id: int, reader_ids,
              slots: int = TABLE_SLOTS) -> np.ndarray:
    """Host-side slot computation (vectorized; no Python loop)."""
    h = mix_hash_vec(lock_id, np.asarray(reader_ids, np.uint64))
    return (h & np.uint64(slots - 1)).astype(np.int32)


def _lock_val(lock_id: int, device: torch.device) -> torch.Tensor:
    """The lock as the kernels take it: its value in a (1,) int32 device
    tensor, filled on the device.  The kernels split it into the hash's
    64-bit word themselves (``repro``'s ``_lock_limbs`` uploaded the two
    limbs instead).  Table values are int32, so the id must be one."""
    if not 0 < lock_id < 2**31:
        raise ValueError(f"lock id {lock_id} is not a positive int32")
    return torch.full((1,), lock_id, dtype=torch.int32, device=device)


def _reader_ids(reader_ids, device: torch.device) -> torch.Tensor:
    """Reader ids as the kernels take them: an int32 device tensor whose
    bits are the uint32 id.  A device tensor is used as it is."""
    if isinstance(reader_ids, torch.Tensor):
        return reader_ids
    ids = np.asarray(reader_ids)
    if ids.size and (ids.min() < 0 or ids.max() >= 2**32):
        raise ValueError("host reader ids must lie in [0, 2**32)")
    return torch.as_tensor(ids.astype(np.uint32).view(np.int32),
                           device=device)


# ---------------------------------------------------------------------------
# The lease programs: one K2 launch each, nothing moved between host and
# device
# ---------------------------------------------------------------------------


def _release_ids32_impl(table: torch.Tensor, reader_ids: torch.Tensor,
                        lock_vals: torch.Tensor,
                        lock_idx: Optional[torch.Tensor],
                        granted: torch.Tensor) -> torch.Tensor:
    """Clear the leases of int32 ``reader_ids`` under the lock in lane(s)
    ``lock_idx`` (``None``: the one lock of ``lock_vals``).  Releasing a
    lease one never held must not wipe another reader's slot: denied
    readers (``granted`` False) clear nothing."""
    return TP.release_hashed(table, lock_vals, lock_idx, reader_ids, granted)


def _release_ids32_all_impl(table: torch.Tensor, reader_ids: torch.Tensor,
                            lock_vals: torch.Tensor,
                            lock_idx: Optional[torch.Tensor]) -> torch.Tensor:
    """Unmasked release (the caller held every lease)."""
    return TP.release_hashed(table, lock_vals, lock_idx, reader_ids)


# ---------------------------------------------------------------------------
# Functional protocol (Listing 1, batched)
# ---------------------------------------------------------------------------


def acquire(state: DeviceLeaseState, lock_id: int,
            reader_ids) -> Tuple[DeviceLeaseState, torch.Tensor]:
    """Fast-path batch acquire: publish leases for ``reader_ids``.

    One K2 launch: hashing, publish, rbias recheck and the undo all run in
    the kernel; nothing blocks on the host.  Returns the device-resident
    granted mask; readers whose CAS failed, or all of them when rbias is
    clear, take the slow path (Listing 1's control flow, batched)."""
    dev = state.table.device
    granted = TP.publish_hashed(state.table, state.rbias,
                                _lock_val(lock_id, dev), None,
                                _reader_ids(reader_ids, dev))
    return dataclasses.replace(state), granted


def release(state: DeviceLeaseState, lock_id: int, reader_ids,
            granted: Optional[torch.Tensor] = None) -> DeviceLeaseState:
    """Clear the leases for ``reader_ids``.  Pass the ``granted`` mask from
    acquire when the grant may have been partial: readers that were denied
    must not clear the (other reader's) slot they collided into."""
    dev = state.table.device
    val, rids = _lock_val(lock_id, dev), _reader_ids(reader_ids, dev)
    if granted is None:
        _release_ids32_all_impl(state.table, rids, val, None)
    else:
        _release_ids32_impl(state.table, rids, val, None, granted)
    return dataclasses.replace(state)


def _prefetch(cnt: torch.Tensor) -> Tuple[torch.Tensor,
                                          Optional[torch.cuda.Event]]:
    """Start the count's copy to the host; -> (host tensor, its event)."""
    if cnt.device.type != "cuda":
        return cnt, None
    host = torch.empty(cnt.shape, dtype=cnt.dtype, pin_memory=True)
    host.copy_(cnt, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(cnt.device))
    return host, ev


def _fetch(pending: Tuple[torch.Tensor, Optional[torch.cuda.Event]]) -> int:
    host, ev = pending
    if ev is not None:
        ev.synchronize()
    return int(host)


def _drain(dispatch_poll: Callable[[int], torch.Tensor], lock_id: int, *,
           wait_poll_s: float, max_wait_s: float,
           pipeline_depth: int) -> int:
    """Poll the table until no slot publishes ``lock_id``.

    Keeps up to ``pipeline_depth`` polls in flight with their counts on
    their way to the host.  ``dispatch_poll(lock_id)`` must enqueue one poll
    of the *current* table and return the device count; concurrent callers
    dispatch under their own mutex, so each poll is ordered on the one
    stream before any later publish or release.  Returns the number of
    polls dispatched; raises :class:`DrainTimeout` past ``max_wait_s``."""
    inflight: collections.deque = collections.deque()
    scans = 0
    start = time.monotonic()
    deadline = start + max_wait_s
    while True:
        while len(inflight) < pipeline_depth:
            inflight.append(_prefetch(dispatch_poll(lock_id)))
            scans += 1
        if _fetch(inflight.popleft()) == 0:
            return scans
        if time.monotonic() > deadline:
            held = int(dispatch_poll(lock_id))
            waited = time.monotonic() - start
            raise DrainTimeout(
                f"lease revocation stuck after {waited:.3f}s / {scans} "
                f"scans: >={held} lease(s) still publish lock {lock_id}",
                lock_id=int(lock_id), held=held, waited_s=waited)
        time.sleep(wait_poll_s)


def revoke(state: DeviceLeaseState, lock_id: int, *,
           n: int = DEFAULT_N,
           wait_poll_s: float = 0.0005,
           max_wait_s: float = 5.0,
           pipeline_depth: int = 2,
           table_source: Optional[Callable[[], torch.Tensor]] = None,
           ) -> Tuple[DeviceLeaseState, int]:
    """Writer-side revocation: clear rbias, poll, wait for leases to drain.

    Returns (state', poll count) and sets InhibitUntil per the primum-non-
    nocere policy.  ``table_source`` lets a live caller expose the freshest
    table to the poll loop; the default polls the table in ``state``."""
    state = dataclasses.replace(state, rbias=torch.zeros_like(state.rbias))
    get_table = table_source or (lambda: state.table)
    start = time.monotonic_ns()
    scans = _drain(lambda lid: K.revocation_poll(get_table(), lid), lock_id,
                   wait_poll_s=wait_poll_s, max_wait_s=max_wait_s,
                   pipeline_depth=pipeline_depth)
    now = time.monotonic_ns()
    ewma, window = adaptive_inhibit(state.revoke_ewma_ns, now - start, n)
    return dataclasses.replace(
        state, inhibit_until_ns=now + window, revoke_ewma_ns=ewma), scans


def rearm(state: DeviceLeaseState) -> DeviceLeaseState:
    """Slow-path re-arm (only while holding the underlying write exclusion,
    mirroring Listing 1 lines 25-26)."""
    if time.monotonic_ns() >= state.inhibit_until_ns:
        return dataclasses.replace(state, rbias=torch.ones_like(state.rbias))
    return state


# ---------------------------------------------------------------------------
# Concurrent wrapper: one shared table, many host threads
# ---------------------------------------------------------------------------


class DeviceLeaseTable:
    """Thread-safe owner of one device lease table with ONE scalar bias.

    The mutex orders the host-side state and every launch on PyTorch's
    current stream; each operation is one kernel launch.  Grant counts
    accumulate on the device (an in-place add) and are read only by
    :meth:`stats`.  ``device`` defaults to the CUDA card."""

    def __init__(self, slots: int = TABLE_SLOTS, device: DeviceLike = None):
        self.state = init_state(slots, device)
        self.device = self.state.table.device
        self._mu = threading.Lock()
        self._grants = torch.zeros((), dtype=torch.int32, device=self.device)
        self._armed = True        # host shadow of rbias: rearm() no-ops
        self._revoking = 0        # writers mid-drain: rearm() must wait
        self.publishes = 0        # batches dispatched (host counter)
        self.revocations = 0

    def handle(self, lock_id: Optional[int] = None) -> "LeaseHandle":
        return LeaseHandle(self, lock_id or next_lock_id())

    # -- readers ------------------------------------------------------------
    def acquire(self, lock_val: torch.Tensor,
                reader_ids: torch.Tensor) -> torch.Tensor:
        """Publish leases for device-resident int32 ``reader_ids`` under the
        lock whose value is the one-element ``lock_val``; returns the
        granted mask without synchronizing."""
        with self._mu:
            granted = TP.publish_hashed(self.state.table, self.state.rbias,
                                        lock_val, None, reader_ids)
            self._grants += granted.sum(dtype=torch.int32)
            self.publishes += 1
        return granted

    def release(self, lock_val: torch.Tensor, reader_ids: torch.Tensor,
                granted: Optional[torch.Tensor] = None) -> None:
        """Clear leases; pass acquire's ``granted`` mask so readers that
        were *denied* never clear the slot they collided into."""
        with self._mu:
            if granted is None:
                _release_ids32_all_impl(self.state.table, reader_ids,
                                        lock_val, None)
            else:
                _release_ids32_impl(self.state.table, reader_ids, lock_val,
                                    None, granted)

    # -- the writer ---------------------------------------------------------
    def revoke(self, lock_id: int, *, n: int = DEFAULT_N,
               wait_poll_s: float = 0.0005, max_wait_s: float = 5.0,
               pipeline_depth: int = 2) -> int:
        with self._mu:
            self.state.rbias.fill_(0)
            self._armed = False
            self._revoking += 1     # gate rearm() for the whole drain
            self.revocations += 1
        if _TR.enabled:
            _TR.emit("lock", "revoke_begin", lock=f"lease{lock_id}")

        def poll_live(lid: int) -> torch.Tensor:
            # dispatch under the mutex: the poll is ordered on the stream
            # before any later publish or release on the table
            with self._mu:
                return K.revocation_poll(self.state.table, lid)

        try:
            start = time.monotonic_ns()
            scans = _drain(poll_live, lock_id, wait_poll_s=wait_poll_s,
                           max_wait_s=max_wait_s,
                           pipeline_depth=pipeline_depth)
            now = time.monotonic_ns()
            if _TR.enabled:
                _TR.emit_span("lock", "revoke_drain", start,
                              lock=f"lease{lock_id}", scans=scans)
            with self._mu:
                ewma, window = adaptive_inhibit(
                    self.state.revoke_ewma_ns, now - start, n)
                self.state = dataclasses.replace(
                    self.state, inhibit_until_ns=now + window,
                    revoke_ewma_ns=ewma)
        finally:
            with self._mu:
                self._revoking -= 1
        return scans

    def rearm(self) -> bool:
        # rbias is one scalar shared by every handle on this table, so the
        # gate below is necessarily GLOBAL: any in-flight drain blocks every
        # handle's rearm (the shared-bias flap).  The per-lock fix is
        # ``registry.BravoRegistry``, whose rbias is a vector and whose
        # rearm gates on that lock's drain alone.
        with self._mu:
            if self._armed:
                return True               # no dispatch on the hot path
            if self._revoking:
                return False              # never re-bias under a drain
            if time.monotonic_ns() >= self.state.inhibit_until_ns:
                self.state.rbias.fill_(1)
                self._armed = True
                return True
        return False

    def stats(self) -> dict:
        """The only host-synchronizing read; call off the hot path."""
        with self._mu:
            return {"publishes": self.publishes,
                    "grants": int(self._grants),
                    "revocations": self.revocations,
                    "rbias": int(self.state.rbias)}


class LeaseHandle:
    """One lock's view of a :class:`DeviceLeaseTable`: caches the lock's
    device-resident value, so the steady state transfers nothing."""

    def __init__(self, table: DeviceLeaseTable, lock_id: int):
        self.table = table
        self.lock_id = lock_id
        self._val = _lock_val(lock_id, table.device)

    def acquire(self, reader_ids: torch.Tensor) -> torch.Tensor:
        return self.table.acquire(self._val, reader_ids)

    def release(self, reader_ids: torch.Tensor,
                granted: Optional[torch.Tensor] = None) -> None:
        self.table.release(self._val, reader_ids, granted=granted)

    def revoke(self, **kw) -> int:
        return self.table.revoke(self.lock_id, **kw)

    def rearm(self) -> bool:
        return self.table.rearm()
