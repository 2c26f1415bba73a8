"""Device-side BRAVO helpers shared by the registry: the table geometry, the
lease release and the pipelined drain.

In ``repro`` this module also holds the single-lock ``DeviceLeaseTable`` /
``LeaseHandle``, the functional ``DeviceLeaseState`` protocol and
``make_distributed_revoke``.  The port's serving path goes through
:class:`~.registry.BravoRegistry` alone, so only what the registry uses is
here; the rest is listed in ROADMAP.md.

Release: the splitmix64 slot hash and the lock-value gather run inside the
K2 launch (``kernels.table_publish.release_hashed``), so a release is one
kernel on the table tensor, updated in place, with nothing moved between
host and device.

Drain: ``repro`` kept up to ``pipeline_depth`` polls in flight, each count
prefetched with ``copy_to_host_async``.  Here each poll's count is copied
with ``non_blocking=True`` into pinned host memory and a CUDA event marks
the copy's completion, so the writer waits on at most one event per
decision instead of one synchronize per poll.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Optional, Tuple

import torch

from ..kernels import table_publish as TP
from .errors import DrainTimeout

TABLE_SLOTS = 4096


def _release_ids32_impl(table: torch.Tensor, reader_ids: torch.Tensor,
                        lock_vals: torch.Tensor, lock_idx: torch.Tensor,
                        granted: torch.Tensor) -> torch.Tensor:
    """Clear the leases of int32 ``reader_ids`` under the lock in lane(s)
    ``lock_idx``.  Releasing a lease one never held must not wipe another
    reader's slot: denied readers (``granted`` False) clear nothing."""
    return TP.release_hashed(table, lock_vals, lock_idx, reader_ids, granted)


def _release_ids32_all_impl(table: torch.Tensor, reader_ids: torch.Tensor,
                            lock_vals: torch.Tensor,
                            lock_idx: torch.Tensor) -> torch.Tensor:
    """Unmasked release (the caller held every lease)."""
    return TP.release_hashed(table, lock_vals, lock_idx, reader_ids)


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
