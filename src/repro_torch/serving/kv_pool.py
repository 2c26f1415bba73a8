"""Device-resident paged-KV pool with registry reader locks and a
device-side prefix-cache page index.

The port of ``repro.serving.kv_pool``.  The map is a device ``(n_pages,)
int32`` owner vector, mutated in place by plain tensor programs; pages are
striped over ``stripes`` locks of a
:class:`~repro_torch.core.registry.BravoRegistry`, so an allocate or a
reclaim revokes only its request's stripe, and a batch read is one lease
publish for a device-resident rid vector.

Refcounts live IN the owner vector:

    ``owner[p] >= 0``   private page of request rid ``owner[p]``
    ``owner[p] == -1``  free (refcount 0) — and still CACHED if a prefix
                        entry points at it: free pages double as the cache
    ``owner[p] <= -2``  shared, refcount ``-1 - owner[p]``

The prefix index is a set-associative device hash map (``map_slots``
power-of-two slots in ``min(4, map_slots)``-way sets): per slot the full
64-bit chained splitmix64 key of a prompt prefix (two int32 limbs, from
:func:`page_keys`), the page it describes, the valid tokens in that page
and an insert-time age stamp.  A lookup probes every way of its key's set;
an insert takes the first vacant way or evicts the OLDEST entry of a full
set (the entry only: the victim page's owner state is untouched).

Invariants the programs keep, as in ``repro``:

* a live map entry's page has not been reallocated since insert —
  allocation drops the entries of every page it takes, so a hit can trust
  the page CONTENT;
* at most one live entry points at any page;
* a shared page is freed only at refcount zero, and the orphan scrub treats
  any ``refcount > 0`` page as live whatever the live rids are;
* allocation prefers free pages with NO cache entry (cache-aware first
  fit), so cached pages go only under page pressure.

Writers must hold external write exclusion (the engine's host rwlock).
Every writer splits into a dispatch half (``*_async``: enqueues work, never
synchronizes) and a materialize half that the caller runs after dropping
that lock.  Where ``repro`` donated the owner and map buffers into jitted
programs, the programs here update the pool's tensors in place.  The
refcount programs (acquire, insert, release) skip the stripe revocation, as
in ``repro``: refcounts never change a live rid's page mask or any page a
leased reader can address.

The quantized pool's ``scale_gen`` epoch is kept (allocation bumps it for
every page it takes).  The quantized store's contents (int8 pages and their
scales) live in the engine's page store, beside the bf16 one's; the pool's
map is the same for both, and ``page_keys(quant_tag=)`` keeps their prefix
keys apart.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.errors import ProtocolError
from ..core.registry import BravoRegistry
from ..device import DeviceLike, resolve
from ..kernels.hash import _K1, _K2, _K3
from ..obs import TRACER as _TR
from ..obs.metrics import MetricsRegistry

__all__ = ["KVPool", "FREE", "page_keys", "PREFIX_SEED"]

FREE = -1

# chain seed for the prefix keys (any odd 64-bit constant; distinct from a
# token value so an empty chain never collides with a real one)
PREFIX_SEED = 0xB5297A4D3F84D5A9
_MASK64 = (1 << 64) - 1
_INT32_MAX = 2 ** 31 - 1


def _mix(state: int, token: int) -> int:
    """``kernels.hash``'s splitmix64 of ``(state, token)`` on plain Python
    ints (the per-token chain runs on the engine's scheduler thread)."""
    x = (state * _K1 + token * _K2) & _MASK64
    x ^= x >> 30
    x = (x * _K2) & _MASK64
    x ^= x >> 27
    x = (x * _K3) & _MASK64
    return x ^ (x >> 31)


def page_keys(tokens: np.ndarray, page_size: int, pad_to: int = 0,
              quant_tag: int = 0) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]:
    """Chained splitmix64 prefix keys for a prompt, bit-exact with
    ``repro.serving.kv_pool.page_keys``.

    ``keys[i]`` hashes tokens ``[0, (i+1) * page_size)`` — the whole
    prefix, because a page's KV content depends on everything before it.  A
    non-aligned prompt also emits one partial-tail key over the full prompt.
    Returns int32 ``(hi, lo)`` limb vectors plus per-key valid-token counts
    (``page_size`` for full pages, the tail remainder for the tail key, 0
    for padding), padded to ``pad_to`` entries.  A nonzero ``quant_tag`` is
    mixed into the chain seed, so keys of another page layout never alias."""
    toks = [int(t) for t in np.asarray(tokens)]
    n = len(toks)
    state = _mix(PREFIX_SEED, quant_tag) if quant_tag else PREFIX_SEED
    keys: List[int] = []
    lens: List[int] = []
    for i, t in enumerate(toks):
        state = _mix(state, t)
        if (i + 1) % page_size == 0:
            keys.append(state)
            lens.append(page_size)
    if n % page_size:
        keys.append(state)
        lens.append(n % page_size)
    m = max(pad_to, len(keys))
    kh = np.zeros((m,), np.int32)
    kl = np.zeros((m,), np.int32)
    ln = np.zeros((m,), np.int32)
    for i, (k, l) in enumerate(zip(keys, lens)):
        kh[i] = np.int32(np.uint32(k >> 32))
        kl[i] = np.int32(np.uint32(k & 0xFFFFFFFF))
        ln[i] = l
    return kh, kl, ln


# ---------------------------------------------------------------------------
# Device programs: plain tensor code, in place on the pool's tensors, no
# host synchronization
# ---------------------------------------------------------------------------


def _refcount(owner: torch.Tensor) -> torch.Tensor:
    """Refcount view of the owner encoding (0 for private and free)."""
    return torch.clamp(-1 - owner, min=0)


def _scatter(dst: torch.Tensor, idx: torch.Tensor, val, *,
             add: bool = False) -> None:
    """``dst[idx] = val`` (or ``+=``, duplicates accumulating) IN PLACE,
    where an ``idx`` of ``len(dst)`` is dropped, as JAX's ``mode="drop"``:
    the store goes through a copy with one spare element at the end."""
    ext = torch.cat([dst, dst.new_zeros(1)])
    val = torch.as_tensor(val, dtype=dst.dtype, device=dst.device)
    ext.index_put_((idx.long(),), val.expand(idx.shape), accumulate=add)
    dst.copy_(ext[:-1])


def _alloc_impl(owner, map_pg, scale_gen, rid: int, n: int):
    """Cache-aware first fit of ``n`` pages to ``rid``, all or nothing, IN
    PLACE: free pages WITHOUT a prefix entry first, cached-free pages only
    when the plain ones run out; taking a cached page drops its entry, and
    every taken page bumps its ``scale_gen``.  -> (take mask, enough) on
    the device, unsynchronized."""
    n_pages = owner.shape[0]
    free = owner == FREE
    cached = torch.zeros(n_pages, dtype=torch.bool, device=owner.device)
    _scatter(cached, torch.where(map_pg >= 0, map_pg, n_pages), True)
    plain = free & ~cached
    n_plain = plain.sum()
    rank = torch.where(plain, torch.cumsum(plain, 0),
                       n_plain + torch.cumsum(free & cached, 0))
    enough = free.sum() >= n
    take = free & (rank <= n) & enough
    stale = (map_pg >= 0) & take[map_pg.clamp(min=0).long()]
    owner.masked_fill_(take, rid)
    map_pg.masked_fill_(stale, -1)
    scale_gen.add_(take.to(scale_gen.dtype))
    return take, enough


def _reclaim_impl(owner, rid: int) -> torch.Tensor:
    """Free ``rid``'s PRIVATE pages in place; -> device count.  Shared
    pages the request holds refs on go through ``release_refs``."""
    mine = owner == rid
    owner.masked_fill_(mine, FREE)
    return mine.sum(dtype=torch.int32)


def _match_impl(owner, map_kh, map_kl, map_pg, map_ln, kh, kl, ln, *,
                ways: int):
    """Prefix lookup: per-key probe of every way in the key's set, reduced
    to the longest PREFIX run (a hole in the chain invalidates everything
    after it).  -> (per-key page or -1, run length, per-key refcount-0
    flags, full-set conflict count)."""
    n_sets = map_pg.shape[0] // ways
    m = kh.shape[0]
    dev = owner.device
    slots = ((kl & (n_sets - 1)).long()[:, None] * ways
             + torch.arange(ways, device=dev)[None, :])          # (m, ways)
    pg_w = map_pg[slots]
    occ = pg_w >= 0
    key_eq = ((map_kh[slots] == kh[:, None]) & (map_kl[slots] == kl[:, None])
              & (map_ln[slots] == ln[:, None]))
    hit_w = occ & key_eq & (ln[:, None] > 0)
    hit = hit_w.any(dim=1)
    first_way = hit_w.to(torch.int32).argmax(dim=1)
    pg = torch.where(hit, pg_w[torch.arange(m, device=dev), first_way], -1)
    run = torch.cumprod(hit.to(torch.int32), 0) > 0
    pages = torch.where(run, pg, -1)
    free_hit = run & (owner[pg.clamp(min=0).long()] == FREE)
    coll = (ln > 0) & ~hit & (occ & ~key_eq).all(dim=1)
    return pages, run.sum(), free_hit, coll.sum()


def _acquire_prefix_impl(owner, map_kh, map_kl, map_pg, map_ln,
                         kh, kl, ln, take, *, ways: int):
    """Ref acquisition on a prefix hit, IN PLACE on ``owner``: re-derive
    the hit run (so the refs land exactly on what was matched) and bump the
    refcount of every hit ``take`` selects.  -> (taken pages, -1 elsewhere;
    how many came off the free list)."""
    n_pages = owner.shape[0]
    pages, _, _, _ = _match_impl(owner, map_kh, map_kl, map_pg, map_ln,
                                 kh, kl, ln, ways=ways)
    use = (pages >= 0) & take
    revived = (use & (owner[pages.clamp(min=0).long()] == FREE)).sum()
    _scatter(owner, torch.where(use, pages, n_pages), -1, add=True)
    return torch.where(use, pages, -1), revived


def _insert_prefix_impl(owner, map_kh, map_kl, map_pg, map_ln, map_age,
                        kh, kl, ln, lane_pg, rid: int, stamp: int, *,
                        ways: int):
    """Publish a request's written prompt pages into the index, IN PLACE:
    key ``i`` maps to ``lane_pg[i]``, which converts from ``rid``-private to
    shared refcount 1.  A key already present in its set is skipped;
    otherwise the first VACANT way, or — set full — the OLDEST way is
    evicted.  Among same-set candidates in one batch the first wins.
    -> the converted mask."""
    n_pages = owner.shape[0]
    map_slots = map_pg.shape[0]
    n_sets = map_slots // ways
    dev = owner.device
    set_i = (kl & (n_sets - 1)).long()
    m = kh.shape[0]
    idx = torch.arange(m, device=dev)
    valid = ((ln > 0) & (lane_pg >= 0)
             & (owner[lane_pg.clamp(min=0).long()] == rid))
    dup_earlier = ((set_i[None, :] == set_i[:, None])
                   & (idx[None, :] < idx[:, None]) & valid[None, :])
    first = ~dup_earlier.any(dim=1)
    slots = set_i[:, None] * ways + torch.arange(ways, device=dev)[None, :]
    occ = map_pg[slots] >= 0
    key_eq = ((map_kh[slots] == kh[:, None]) & (map_kl[slots] == kl[:, None])
              & (map_ln[slots] == ln[:, None]))
    present = (occ & key_eq).any(dim=1)
    vac = ~occ
    age_w = torch.where(occ, map_age[slots], _INT32_MAX)
    way = torch.where(vac.any(dim=1), vac.to(torch.int32).argmax(dim=1),
                      age_w.argmin(dim=1))
    ins = valid & first & ~present
    tgt_slot = torch.where(ins, set_i * ways + way, map_slots)
    for vec, val in ((map_kh, kh), (map_kl, kl), (map_pg, lane_pg),
                     (map_ln, ln)):
        _scatter(vec, tgt_slot, val)
    _scatter(map_age, tgt_slot, stamp)
    _scatter(owner, torch.where(ins, lane_pg.long(), n_pages), -2)
    return ins


def _release_refs_impl(owner, pages) -> torch.Tensor:
    """Drop one ref per listed page (-1 entries ignored), IN PLACE.  A
    double release never pushes a shared page past FREE; a page reaching
    refcount 0 becomes free and stays CACHED.  -> device count freed."""
    n_pages = owner.shape[0]
    delta = torch.zeros_like(owner)
    _scatter(delta, torch.where(pages >= 0, pages, n_pages).long(), 1,
             add=True)
    shared = owner <= -2
    new = torch.where(shared, torch.clamp(owner + delta, max=FREE), owner)
    freed = (shared & (new == FREE)).sum(dtype=torch.int32)
    owner.copy_(new)
    return freed


def _is_live(owner, live) -> torch.Tensor:
    """Pages that are free, refcount-held or owned by a rid in ``live``."""
    return ((owner[:, None] == live[None, :]).any(dim=1)
            | (owner == FREE) | (_refcount(owner) > 0))


def _orphan_plan_impl(owner, live, *, stripes: int):
    """Per-stripe orphan-page counts + total (orphan: owned by a rid that
    is not in ``live``)."""
    orphan = ~_is_live(owner, live)
    stripe_of = torch.where(owner >= 0, owner % stripes, 0)
    per = (orphan[:, None] & (stripe_of[:, None] == torch.arange(
        stripes, device=owner.device)[None, :])).sum(dim=0)
    return per, orphan.sum()


def _scrub_impl(owner, live) -> torch.Tensor:
    """Free every orphan page IN PLACE, rechecking ``live`` on the device,
    so a plan made before the write lock can never free a page that became
    live since.  -> device count freed."""
    orphan = ~_is_live(owner, live)
    owner.masked_fill_(orphan, FREE)
    return orphan.sum(dtype=torch.int32)


class KVPool:
    """Fixed pool of KV pages, map on device, reads under registry leases.

    ``registry`` may be shared (the engine passes the one registry whose
    table also serves the model-epoch lock); a private one is built if
    omitted, on ``device`` (default: the CUDA card, raising if none).
    ``map_slots`` sizes the prefix index (a power of two; default 4x the
    page count rounded up, one 4-way set per page)."""

    def __init__(self, n_pages: int, registry: Optional[BravoRegistry] = None,
                 stripes: int = 4, map_slots: int = 0,
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
        if map_slots <= 0:
            map_slots = 1
            while map_slots < 4 * n_pages:
                map_slots *= 2
        if map_slots & (map_slots - 1) != 0:
            raise ProtocolError(
                f"map_slots {map_slots} must be a power of two (the "
                f"prefix index masks hashes with map_slots - 1)")
        self.map_slots = map_slots
        self.ways = min(4, map_slots)

        def vec(fill):
            return torch.full((map_slots,), fill, dtype=torch.int32,
                              device=dev)

        self._map_kh, self._map_kl = vec(0), vec(0)
        self._map_pg, self._map_ln, self._map_age = vec(-1), vec(0), vec(0)
        self._age_clock = 0           # monotonic insert stamp (host int)
        # per-page scale-metadata epoch, bumped when a page is (re)allocated
        self.scale_gen = torch.zeros((n_pages,), dtype=torch.int32,
                                     device=dev)
        self._mu = threading.Lock()   # orders the owner/map updates
        # bumped by every owner/map mutation: lets the engine cache a slot's
        # admission peek while the pool is unchanged
        self.version = 0
        self.metrics = (metrics if metrics is not None
                        else self.registry.metrics)
        self._c_lookups = self.metrics.counter("pool.lookups")
        self._c_allocates = self.metrics.counter("pool.allocates")
        self._c_reclaims = self.metrics.counter("pool.reclaims")
        self._c_prefix_lookups = self.metrics.counter("pool.prefix_lookups")
        self._c_prefix_hits = self.metrics.counter("pool.prefix_hits")
        self._c_prefix_inserts = self.metrics.counter("pool.prefix_inserts")
        # keys whose set is full of other keys' entries: would-be hits that
        # a lookup could not even have made
        self._c_prefix_collisions = self.metrics.counter(
            "pool.prefix_collision")
        # device-resident dedup-hit accumulator: folded on every traced
        # prefix acquisition, harvested only in stats()
        self._dev_hits = torch.zeros((), dtype=torch.int32, device=dev)

    @property
    def lookups(self) -> int:
        return self._c_lookups.value

    @property
    def allocates(self) -> int:
        return self._c_allocates.value

    @property
    def reclaims(self) -> int:
        return self._c_reclaims.value

    @property
    def prefix_lookups(self) -> int:
        return self._c_prefix_lookups.value

    @property
    def prefix_hits(self) -> int:
        return self._c_prefix_hits.value

    @property
    def prefix_inserts(self) -> int:
        return self._c_prefix_inserts.value

    @property
    def prefix_collisions(self) -> int:
        return self._c_prefix_collisions.value

    def _stripe(self, rid: int):
        return self.locks[rid % self.stripes]

    def _ivec(self, x) -> torch.Tensor:
        """A host vector (numpy, list) as an int32 tensor on the device."""
        return torch.as_tensor(np.asarray(x, np.int32), device=self.device)

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
        """Dispatch-only cache-aware first-fit allocate: revoke the rid's
        stripe bias, drain its readers (K3 polls), enqueue the owner and map
        update.  Returns device ``(take mask, enough)`` for
        :meth:`materialize_alloc`."""
        self._stripe(rid).revoke(**revoke_kw)
        with self._mu:
            take, ok = _alloc_impl(self.owner, self._map_pg, self.scale_gen,
                                   rid, n)
            self._c_allocates.add(1)
            self.version += 1
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
            self.version += 1
        if _TR.enabled:
            _TR.emit("pool", "reclaim", rid=rid)
        return cnt

    def reclaim(self, rid: int, **revoke_kw) -> int:
        return int(self.reclaim_async(rid, **revoke_kw))

    # ------------------------------------------------------- prefix caching
    def match_prefix(self, kh, kl, ln):
        """Peek the prefix index (no refs taken): -> (per-key page list,
        usable run length, per-key refcount-0 flags — a hit on such a key
        consumes a free page when acquired).  SYNCHRONIZES; admission-
        control plane only.  Key vectors come from :func:`page_keys`."""
        with self._mu:
            pages, n_run, free_hit, n_coll = _match_impl(
                self.owner, self._map_kh, self._map_kl, self._map_pg,
                self._map_ln, self._ivec(kh), self._ivec(kl),
                self._ivec(ln), ways=self.ways)
            self._c_prefix_lookups.add(1)
        n = int(n_run)                # sync OUTSIDE the mutex
        if n > 0:
            self._c_prefix_hits.add(1)
        c = int(n_coll)
        if c > 0:
            self._c_prefix_collisions.add(c)
        if _TR.enabled:
            _TR.emit("pool", "dedup_hit" if n > 0 else "dedup_miss", run=n,
                     collisions=c)
        return pages.tolist(), n, free_hit.tolist()

    def acquire_prefix_async(self, kh, kl, ln, take):
        """Dispatch-only ref acquisition on the hit run's pages selected by
        the bool ``take`` mask (the caller's share-by-ref prefix plus the
        one copy-on-write source, which it releases again after copying).
        No stripe revocation."""
        take = torch.as_tensor(np.asarray(take, bool), device=self.device)
        with self._mu:
            pages, revived = _acquire_prefix_impl(
                self.owner, self._map_kh, self._map_kl, self._map_pg,
                self._map_ln, self._ivec(kh), self._ivec(kl),
                self._ivec(ln), take, ways=self.ways)
            self.version += 1
            if _TR.enabled:
                # device-resident fold of the hit pages: nothing crosses
                # the host boundary on this path
                self._dev_hits += (pages >= 0).sum(dtype=torch.int32)
        if _TR.enabled:
            _TR.emit("pool", "ref_acquire")
        return pages, revived

    @staticmethod
    def materialize_prefix(pages, revived) -> Tuple[List[int], int]:
        return pages.tolist(), int(revived)

    def acquire_prefix(self, kh, kl, ln, take) -> Tuple[List[int], int]:
        return self.materialize_prefix(*self.acquire_prefix_async(
            kh, kl, ln, take))

    def insert_prefix_async(self, rid: int, kh, kl, ln, lane_pages):
        """Dispatch-only index publish for a request whose prompt pages are
        fully written: each key's page converts from ``rid``-private to
        shared refcount 1 where the insert lands.  Returns the converted
        mask (device)."""
        with self._mu:
            self._age_clock += 1
            ins = _insert_prefix_impl(
                self.owner, self._map_kh, self._map_kl, self._map_pg,
                self._map_ln, self._map_age, self._ivec(kh), self._ivec(kl),
                self._ivec(ln), self._ivec(lane_pages), rid,
                self._age_clock, ways=self.ways)
            self._c_prefix_inserts.add(1)
            self.version += 1
        if _TR.enabled:
            _TR.emit("pool", "prefix_insert", rid=rid)
        return ins

    def insert_prefix(self, rid: int, kh, kl, ln, lane_pages) -> List[bool]:
        return self.insert_prefix_async(rid, kh, kl, ln, lane_pages).tolist()

    def release_refs_async(self, pages) -> torch.Tensor:
        """Dispatch-only ref release for a (-1-padded) page vector; a page
        reaching refcount 0 becomes free-but-cached.  Returns the device
        count of pages freed."""
        with self._mu:
            freed = _release_refs_impl(self.owner, self._ivec(pages))
            self.version += 1
        if _TR.enabled:
            _TR.emit("pool", "ref_release")
        return freed

    def release_refs(self, pages) -> int:
        return int(self.release_refs_async(pages))

    # ---------------------------------------------------------- compaction
    def orphan_plan(self, live: torch.Tensor):
        """Count orphan pages (owner not in the int32 ``live`` rid vector,
        not free, not refcount-held): -> (per-stripe counts as numpy, total
        int).  SYNCHRONIZES — call it before taking any write lock; the
        scrub rechecks on the device, so a stale plan only ever skips or
        over-revokes stripes, never frees a live page."""
        with self._mu:
            per, total = _orphan_plan_impl(self.owner, live,
                                           stripes=self.stripes)
        return per.cpu().numpy(), int(total)

    def scrub_orphans_async(self, live: torch.Tensor,
                            stripe_mask=None, **revoke_kw) -> torch.Tensor:
        """Dispatch-only orphan scrub: revoke (and drain) only the stripes
        the plan flagged, then enqueue the owner update.  A page with
        ``refcount > 0`` is never scrubbed.  Returns the device count of
        pages freed."""
        for s, h in enumerate(self.locks):
            if stripe_mask is None or stripe_mask[s]:
                h.revoke(**revoke_kw)
        with self._mu:
            cnt = _scrub_impl(self.owner, live)
            self._c_reclaims.add(1)
            self.version += 1
        if _TR.enabled:
            _TR.emit("pool", "orphan_scrub")
        return cnt

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
            vals = torch.stack([(self.owner <= -2).sum(),
                                _refcount(self.owner).sum(),
                                (self._map_pg >= 0).sum(),
                                self._dev_hits.long()])
        shared, refs, entries, hits = vals.tolist()
        return {"n_pages": self.n_pages, "stripes": self.stripes,
                "free": self.free_count(), "lookups": self.lookups,
                "allocates": self.allocates, "reclaims": self.reclaims,
                "shared_pages": shared, "refcount_total": refs,
                "cached_entries": entries, "map_slots": self.map_slots,
                "map_ways": self.ways,
                "prefix_lookups": self.prefix_lookups,
                "prefix_hits": self.prefix_hits,
                "prefix_inserts": self.prefix_inserts,
                "prefix_collisions": self.prefix_collisions,
                # harvest of the device-resident fold (counts only while
                # tracing was enabled; zero otherwise)
                "dedup_pages_hit": hits}
