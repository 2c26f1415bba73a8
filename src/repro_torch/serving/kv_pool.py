"""Device-resident paged-KV pool with registry reader locks.

The port of ``repro.serving.kv_pool`` for the engine's handler mode: the
owner vector, first-fit allocation and reclamation under the stripe locks,
and the leased batch read.  The map is a device ``(n_pages,) int32`` owner
vector (``owner[p] >= 0`` private page of request ``owner[p]``, ``-1`` free,
``<= -2`` shared with refcount ``-1 - owner[p]``), mutated in place by
plain tensor programs; pages are striped over ``stripes`` locks of a
:class:`~repro_torch.core.registry.BravoRegistry`, so an allocate or a
reclaim revokes only its request's stripe.

The prefix cache (its index, the ``match`` / ``acquire_prefix`` /
``insert_prefix`` / ``release_refs`` programs, the orphan plan and scrub)
and the quantized pool's per-page scale epoch come with the scheduler slice
(ROADMAP.md).  Until then no page is cached, so ``repro``'s cache-aware
first fit reduces to a plain first fit over the free pages.

Writers must hold external write exclusion (the engine's host rwlock).
Every writer splits into a dispatch half (``*_async``: enqueues work,
never synchronizes) and a materialize half that the caller runs after
dropping that lock.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import torch

from ..core.errors import ProtocolError
from ..core.registry import BravoRegistry
from ..device import DeviceLike, resolve
from ..obs import TRACER as _TR
from ..obs.metrics import MetricsRegistry

__all__ = ["KVPool", "FREE"]

FREE = -1


def _refcount(owner: torch.Tensor) -> torch.Tensor:
    return torch.clamp(-1 - owner, min=0)


def _alloc_impl(owner: torch.Tensor, rid: int, n: int):
    """First fit of ``n`` free pages to ``rid``, all or nothing, IN PLACE
    on ``owner``.  -> (take mask, enough) on the device, unsynchronized."""
    free = owner == FREE
    enough = free.sum() >= n
    take = free & (torch.cumsum(free.int(), 0) <= n) & enough
    owner.masked_fill_(take, rid)
    return take, enough


def _reclaim_impl(owner: torch.Tensor, rid: int) -> torch.Tensor:
    """Free ``rid``'s PRIVATE pages in place; -> device count."""
    mine = owner == rid
    owner.masked_fill_(mine, FREE)
    return mine.sum(dtype=torch.int32)


class KVPool:
    """Fixed pool of KV pages, map on device, reads under registry leases.

    ``registry`` may be shared (the engine passes the one registry whose
    table also serves the model-epoch lock); a private one is built if
    omitted, on ``device`` (default: the CUDA card, raising if none)."""

    def __init__(self, n_pages: int, registry: Optional[BravoRegistry] = None,
                 stripes: int = 4,
                 metrics: Optional[MetricsRegistry] = None,
                 device: DeviceLike = None):
        if stripes < 1:
            raise ProtocolError(
                f"KVPool needs at least one lock stripe, got {stripes}")
        if registry is None:
            registry = BravoRegistry(device=device)
        elif device is not None and resolve(device) != registry.device:
            raise ProtocolError(
                f"KVPool on {device} but its registry is on "
                f"{registry.device}")
        self.registry = registry
        self.device = dev = registry.device
        self.n_pages = n_pages
        self.stripes = stripes
        self.locks = [self.registry.alloc(name=f"kvstripe{s}")
                      for s in range(stripes)]
        # device mirror of stripe -> bias lane, for on-device gathers
        self._stripe_idx = torch.tensor([h.idx for h in self.locks],
                                        dtype=torch.int32, device=dev)
        self.owner = torch.full((n_pages,), FREE, dtype=torch.int32,
                                device=dev)
        self._mu = threading.Lock()   # orders the owner updates
        self.metrics = (metrics if metrics is not None
                        else self.registry.metrics)
        self._c_lookups = self.metrics.counter("pool.lookups")
        self._c_allocates = self.metrics.counter("pool.allocates")
        self._c_reclaims = self.metrics.counter("pool.reclaims")

    @property
    def lookups(self) -> int:
        return self._c_lookups.value

    @property
    def allocates(self) -> int:
        return self._c_allocates.value

    @property
    def reclaims(self) -> int:
        return self._c_reclaims.value

    def _stripe(self, rid: int):
        return self.locks[rid % self.stripes]

    # -------------------------------------------------------------- readers
    def lookup(self, rid: int) -> List[int]:
        """PRIVATE pages owned by ``rid``, read under the stripe's lease
        (control plane: the host-int rid costs one tiny upload)."""
        h = self._stripe(rid)
        h.rearm()
        ids = torch.tensor([rid], dtype=torch.int32, device=self.device)
        granted = h.acquire(ids)
        try:
            with self._mu:
                mask = self.owner == rid
                self._c_lookups.add(1)
            return torch.nonzero(mask).flatten().tolist()
        finally:
            h.release(ids, granted=granted)

    def read_batch(self, rids: torch.Tensor):
        """Begin a leased batch read: ONE lease publish (K1) for the whole
        device-resident int32 rid vector, its stripe lanes gathered on the
        device, plus one (B, n_pages) ownership mask; no host sync.
        Returns ``(token, mask)``; the leases stay published until
        :meth:`done_read_batch`, so a writer on any involved stripe drains
        until the read ends."""
        for h in self.locks:
            h.rearm()                 # host-clock check; dispatch only
        #                               when a stripe's window has passed
        lidx = self._stripe_idx[torch.remainder(rids, self.stripes).long()]
        granted = self.registry.acquire_by_index(lidx, rids)
        try:
            with self._mu:
                mask = self.owner[None, :] == rids[:, None]
                self._c_lookups.add(1)
        except BaseException:         # never leak published leases
            self.registry.release_by_index(lidx, rids, granted)
            raise
        return (lidx, rids, granted), mask

    def done_read_batch(self, token) -> None:
        lidx, rids, granted = token
        self.registry.release_by_index(lidx, rids, granted)

    def lookup_batch(self, rids: torch.Tensor) -> torch.Tensor:
        """Point-in-time batch read (mask only; leases released before
        returning)."""
        token, mask = self.read_batch(rids)
        self.done_read_batch(token)
        return mask

    # -------------------------------------------------------------- writers
    def allocate_async(self, rid: int, n: int, **revoke_kw):
        """Dispatch-only first-fit allocate: revoke the rid's stripe bias,
        drain its readers (K3 polls), enqueue the owner update.  Returns device
        ``(take mask, enough)`` for :meth:`materialize_alloc`."""
        self._stripe(rid).revoke(**revoke_kw)
        with self._mu:
            take, ok = _alloc_impl(self.owner, rid, n)
            self._c_allocates.add(1)
        if _TR.enabled:
            _TR.emit("pool", "alloc", rid=rid, n=n)
        return take, ok

    @staticmethod
    def materialize_alloc(take: torch.Tensor, ok: torch.Tensor) -> List[int]:
        """Synchronizing half of :meth:`allocate_async` (all-or-nothing;
        [] when the pool was short)."""
        if not bool(ok):
            return []
        return torch.nonzero(take).flatten().tolist()

    def allocate(self, rid: int, n: int, **revoke_kw) -> List[int]:
        """First-fit allocate ``n`` pages to ``rid``; revokes ONLY this
        rid's stripe bias."""
        return self.materialize_alloc(*self.allocate_async(rid, n,
                                                           **revoke_kw))

    def reclaim_async(self, rid: int, **revoke_kw) -> torch.Tensor:
        """Dispatch-only reclaim of ``rid``'s PRIVATE pages; returns the
        device count (``int()`` it after dropping any write lock)."""
        self._stripe(rid).revoke(**revoke_kw)
        with self._mu:
            cnt = _reclaim_impl(self.owner, rid)
            self._c_reclaims.add(1)
        if _TR.enabled:
            _TR.emit("pool", "reclaim", rid=rid)
        return cnt

    def reclaim(self, rid: int, **revoke_kw) -> int:
        return int(self.reclaim_async(rid, **revoke_kw))

    # ---------------------------------------------------------------- misc
    def free_pages(self) -> List[int]:
        """Free page indices (synchronizing; off the hot path)."""
        with self._mu:
            mask = self.owner == FREE
        return torch.nonzero(mask).flatten().tolist()

    def free_count(self) -> int:
        with self._mu:
            cnt = (self.owner == FREE).sum()
        return int(cnt)

    def stats(self) -> dict:
        with self._mu:
            vals = torch.stack([(self.owner == FREE).sum(),
                                (self.owner <= -2).sum(),
                                _refcount(self.owner).sum()])
        free, shared, refs = vals.tolist()
        return {"n_pages": self.n_pages, "stripes": self.stripes,
                "free": free, "lookups": self.lookups,
                "allocates": self.allocates, "reclaims": self.reclaims,
                "shared_pages": shared, "refcount_total": refs}
