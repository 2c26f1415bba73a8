"""Plain PyTorch versions of the table kernels K1-K4, of the paged
attention kernels K5/K6 and their quantized variants K7/K8, and of the
legacy table kernels K9 (the revocation scan) and K10 (the sequential
publish).

They define what each CUDA kernel computes: the CPU tests hold them against
``repro``'s Pallas kernels in interpret mode, ``chip_smoke.py`` holds each
CUDA kernel against them on the card, and the wrappers in ``ops`` run them
for tensors that lie on the CPU.  Each is a pure function of its inputs (it
returns a new table); the wrappers copy the result into the caller's table.

Semantics follow the Pallas kernels, not ``repro.kernels.ref``: a slot
outside ``[0, n_slots)`` matches no table entry (it reads as free and
stores nothing), where ``repro.kernels.ref`` indexes with ``-1`` and so
reaches the LAST slot.  The release path relies on this: it masks denied
readers to slot -1 so that they clear nothing.
"""

from __future__ import annotations

import math

import torch

from .hash import hash_slots


def _first_of_slot(slots: torch.Tensor, attempt: torch.Tensor) -> torch.Tensor:
    """True where no earlier ATTEMPTING request names the same slot."""
    m = slots.shape[0]
    idx = torch.arange(m, device=slots.device)
    dup = ((slots[None, :] == slots[:, None]) & (idx[None, :] < idx[:, None])
           & attempt[None, :])
    return ~dup.any(dim=1)


def _gather_slots(flat: torch.Tensor, slots: torch.Tensor):
    """-> (in-table mask, current occupancy, 0 outside the table)."""
    n = flat.shape[0]
    valid = (slots >= 0) & (slots < n)
    cur = torch.where(valid, flat[slots.clamp(0, n - 1).long()], 0)
    return valid, cur


def _store(flat: torch.Tensor, slots: torch.Tensor, ids: torch.Tensor,
           where: torch.Tensor) -> torch.Tensor:
    """New flat table with ``ids`` stored at the selected slots (callers
    guarantee the selected slots are distinct and in the table)."""
    n = flat.shape[0]
    ext = torch.cat([flat, flat.new_zeros(1)])
    tgt = torch.where(where, slots, n).long()
    ext.index_put_((tgt,), ids.to(flat.dtype))
    return ext[:n]


def publish_multi_ref(table2d: torch.Tensor, rbias_vec: torch.Tensor,
                      slots: torch.Tensor, lock_idx: torch.Tensor,
                      ids: torch.Tensor):
    """K1.  Request ``i`` attempts its CAS ``table[slot]: 0 -> id`` only if
    ``rbias_vec[lock_idx[i]] != 0`` (a lane outside the vector is clear);
    among attempting requests for one slot the lowest index wins; an
    occupied slot loses.  -> (new table, granted bool (M,))."""
    flat = table2d.reshape(-1)
    n_locks = rbias_vec.shape[0]
    lane_ok = (lock_idx >= 0) & (lock_idx < n_locks)
    biased = lane_ok & (rbias_vec[lock_idx.clamp(0, n_locks - 1).long()] != 0)
    first = _first_of_slot(slots, biased)
    valid, cur = _gather_slots(flat, slots)
    granted = first & (cur == 0) & biased
    new = _store(flat, slots, ids, granted & valid)
    return new.reshape(table2d.shape), granted


def publish_ref(table2d: torch.Tensor, rbias: torch.Tensor,
                slots: torch.Tensor, ids: torch.Tensor, *,
                unconditional: bool = False, check_rbias: bool = True):
    """K2.  The first request per slot (over ALL requests) wins; unless
    ``unconditional`` only into a free slot; with ``check_rbias`` only while
    the scalar ``rbias != 0``.  -> (new table, granted bool (M,))."""
    flat = table2d.reshape(-1)
    win = _first_of_slot(slots, torch.ones_like(slots, dtype=torch.bool))
    valid, cur = _gather_slots(flat, slots)
    if not unconditional:
        win = win & (cur == 0)
    if check_rbias:
        win = win & (rbias.reshape(()) != 0)
    new = _store(flat, slots, ids, win & valid)
    return new.reshape(table2d.shape), win


def clear_ref(table2d: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """K2 as the release: store 0 into each slot; slot -1 is a no-op."""
    ones = torch.ones((), dtype=torch.int32, device=table2d.device)
    return publish_ref(table2d, ones, slots, torch.zeros_like(slots),
                       unconditional=True, check_rbias=False)[0]


def scan_ref(table2d: torch.Tensor, lock_id):
    """K9.  -> (int8 mask (rows, 128), 1 where a slot equals ``lock_id``;
    the exact count of such slots, a 0-d int32)."""
    m = table2d == int(lock_id)
    return m.to(torch.int8), m.sum(dtype=torch.int32)


def publish_seq_ref(table2d: torch.Tensor, slots: torch.Tensor,
                    ids: torch.Tensor, *, unconditional: bool = False):
    """K10, the TPU kernel's ``fori_loop``: on a copy of the table, request
    ``i`` in order reads ``cur = t[slot]``, takes ``ok = cur == 0`` (True
    when ``unconditional``), stores ``id`` where ``ok`` and sets
    ``granted[i] = ok``.  So a later request sees every earlier store: with
    ``unconditional`` the last of duplicate slots wins, and a conditional
    publish of id 0 leaves the slot free for the next.  A slot outside the
    table reads as free and stores nothing.  -> (NEW table, granted bool
    (M,)).  The loop stays on the tensors' device and never synchronizes:
    the store target of a slot outside the table is one extra element that
    only ever receives its own 0."""
    flat = table2d.reshape(-1)
    n = flat.shape[0]
    ext = torch.cat([flat, flat.new_zeros(1)])
    s = slots.long()
    valid = (s >= 0) & (s < n)
    tgt = torch.where(valid, s, n)
    vals = ids.to(flat.dtype)
    granted = torch.ones(slots.shape[0], dtype=torch.bool,
                         device=flat.device)
    for i in range(slots.shape[0]):
        t = tgt[i:i + 1]
        cur = ext[t]
        if unconditional:
            ext[t] = torch.where(valid[i:i + 1], vals[i:i + 1], cur)
        else:
            ok = cur == 0
            ext[t] = torch.where(ok & valid[i:i + 1], vals[i:i + 1], cur)
            granted[i:i + 1] = ok
    return ext[:n].reshape(table2d.shape), granted


def clear_seq_ref(table2d: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """K10 as the legacy release: store 0 into each slot, in order, on a
    copy.  -> NEW table."""
    return publish_seq_ref(table2d, slots, torch.zeros_like(slots),
                           unconditional=True)[0]


def poll_ref(table2d: torch.Tensor, lock_id) -> torch.Tensor:
    """K3.  EXACT count of slots equal to ``lock_id`` (a 0-d int32)."""
    return (table2d == int(lock_id)).sum(dtype=torch.int32)


def multi_count_ref(table2d: torch.Tensor,
                    lock_ids: torch.Tensor) -> torch.Tensor:
    """K4.  -> (K,) int32 exact hold counts, one per entry of ``lock_ids``."""
    flat = table2d.reshape(-1)
    return (flat[:, None] == lock_ids[None, :].to(flat.dtype)).sum(
        dim=0, dtype=torch.int32)


# ---------------------------------------------------------------------------
# The registry's hashed entries: slot = splitmix64(lock value, reader) and
# id = lock value, with the lock value gathered from ``lock_vals[lock_idx]``
# (K1 and K2 fold both into the launch on the card)
# ---------------------------------------------------------------------------


def hashed_requests(table2d, lock_vals, lock_idx, reader_ids):
    """-> (lanes, lock values, slots) of the hashed entries' requests; a
    lane outside ``lock_vals`` gets slot -1.  ``reader_ids``: int32 (the
    bits of uint32 ids) or int64 (the bits of uint64 ids)."""
    n_slots = table2d.numel()
    n_locks = lock_vals.shape[0]
    lidx = lock_idx.expand(reader_ids.shape)
    lane_ok = (lidx >= 0) & (lidx < n_locks)
    vals = lock_vals[lidx.clamp(0, n_locks - 1).long()]
    zero = torch.zeros_like(vals)
    hi = (reader_ids >> 32 if reader_ids.dtype == torch.int64
          else torch.zeros_like(reader_ids))          # int64: uint64 bits
    slots = hash_slots(zero, vals, hi, reader_ids, n_slots)
    return lidx, vals, torch.where(lane_ok, slots, -1)


def acquire_hashed_ref(table2d: torch.Tensor, rbias_vec: torch.Tensor,
                       lock_vals: torch.Tensor, lock_idx: torch.Tensor,
                       reader_ids: torch.Tensor):
    """K1 for int32 ``reader_ids`` under the locks in lanes ``lock_idx``
    ((M,) or one lane for all).  -> (new table, granted bool (M,))."""
    lidx, vals, slots = hashed_requests(table2d, lock_vals, lock_idx,
                                        reader_ids)
    return publish_multi_ref(table2d, rbias_vec, slots, lidx, vals)


def publish_hashed_ref(table2d: torch.Tensor, rbias: torch.Tensor,
                       lock_vals: torch.Tensor, lock_idx: torch.Tensor,
                       reader_ids: torch.Tensor):
    """K2 as the single-lock lease acquire: each reader publishes the value
    of the lock in its lane into its hashed slot under the scalar
    ``rbias``.  -> (new table, granted bool (M,))."""
    _, vals, slots = hashed_requests(table2d, lock_vals, lock_idx,
                                     reader_ids)
    return publish_ref(table2d, rbias, slots, vals)


def release_hashed_ref(table2d: torch.Tensor, lock_vals: torch.Tensor,
                       lock_idx: torch.Tensor, reader_ids: torch.Tensor,
                       mask=None) -> torch.Tensor:
    """K2 as the release of the leases ``acquire_hashed_ref`` published;
    readers where ``mask`` is False clear nothing.  -> new table."""
    _, _, slots = hashed_requests(table2d, lock_vals, lock_idx, reader_ids)
    if mask is not None:
        slots = torch.where(mask, slots, -1)
    return clear_ref(table2d, slots)


# ---------------------------------------------------------------------------
# Paged attention over the KV pool's page store (K5 decode, K6 chunk prefill;
# K7, K8 the same over the quantized store)
# ---------------------------------------------------------------------------


def paged_chunk_attn_ref(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, page_idx: torch.Tensor,
                         cache_len: torch.Tensor,
                         new_lens: torch.Tensor) -> torch.Tensor:
    """K6.  q: (B, S, H, hd) right-aligned chunks; k/v_pages: (n_pages, ps,
    KVH, hd); page_idx: (B, P) int32; cache_len: (B,) valid length AFTER
    the chunk; new_lens: (B,) valid trailing columns.  -> (B, S, H, hd) in
    q's dtype, computed in float32.

    Column ``j`` of row ``b`` sits at position ``cache_len - S + j`` and is
    a query only if ``j >= S - new_lens`` and that position is >= 0.  KV
    position ``t`` counts if ``t < cache_len``, ``t <= q_pos`` and its lane
    ``page_idx[b, t // ps]`` names a page of the store (a -1 lane is
    masked).  Query heads are grouped by KV head (GQA); a row with no valid
    position emits zeros (the denominator is floored at 1e-20, as in the
    Pallas kernel).  Vectorised through a dense (B, P * ps, KVH, hd)
    gather, which the CUDA kernel never builds."""
    return _chunk_attn(q, k_pages, v_pages, None, page_idx, cache_len,
                       new_lens)


def paged_chunk_attn_quant_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, k_scale: torch.Tensor,
                               v_scale: torch.Tensor, page_idx: torch.Tensor,
                               cache_len: torch.Tensor,
                               new_lens: torch.Tensor) -> torch.Tensor:
    """K8: :func:`paged_chunk_attn_ref` over int8 k/v_pages with (n_pages,
    KVH) float32 scales, each page dequantized as ``repro`` does it (cast
    to float32, then one multiply by its scale per KV head)."""
    return _chunk_attn(q, k_pages, v_pages, (k_scale, v_scale), page_idx,
                       cache_len, new_lens)


def _chunk_attn(q, k_pages, v_pages, scales, page_idx, cache_len, new_lens):
    b, s, h, hd = q.shape
    n_pages, ps, kvh, _ = k_pages.shape
    n_lanes = page_idx.shape[1]
    g = h // kvh
    lane_ok = (page_idx >= 0) & (page_idx < n_pages)
    idx = torch.where(lane_ok, page_idx, 0).long()

    def gathered(pages, scale):
        x = pages[idx].float()                      # (B, P, ps, KVH, hd)
        if scale is not None:
            x = x * scale[idx][:, :, None, :, None]
        return x.reshape(b, n_lanes * ps, kvh, hd)

    k_scale, v_scale = scales or (None, None)
    k, v = gathered(k_pages, k_scale), gathered(v_pages, v_scale)
    t = torch.arange(n_lanes * ps, device=q.device)
    col = torch.arange(s, device=q.device)
    clen = cache_len.long()
    q_pos = clen[:, None] - s + col[None, :]                       # (B, S)
    valid_q = (col[None, :] >= s - new_lens.long()[:, None]) & (q_pos >= 0)
    valid = ((t[None, None, :] < clen[:, None, None])
             & lane_ok.repeat_interleave(ps, dim=1)[:, None, :]
             & (t[None, None, :] <= q_pos[:, :, None])
             & valid_q[:, :, None])[:, :, None, None, :]     # (B,S,1,1,T)
    qh = q.float().reshape(b, s, kvh, g, hd)
    sc = torch.einsum("bskgd,btkd->bskgt", qh, k) / math.sqrt(hd)
    sc = torch.where(valid, sc, -math.inf)
    m = sc.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(valid, torch.exp(sc - m_safe), 0.0)
    den = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-20)
    o = torch.einsum("bskgt,btkd->bskgd", p, v) / den
    return o.reshape(b, s, h, hd).to(q.dtype)


def paged_attn_ref(q: torch.Tensor, k_pages: torch.Tensor,
                   v_pages: torch.Tensor, page_idx: torch.Tensor,
                   cache_len: torch.Tensor) -> torch.Tensor:
    """K5.  q: (B, H, hd) one decode token per request; pages as K6;
    cache_len: (B,) valid lengths.  -> (B, H, hd) in q's dtype.  It is K6
    with one column that is always real: positions ``t < cache_len`` whose
    lane holds a page, zeros where there are none (``cache_len == 0``)."""
    ones = torch.ones_like(cache_len)
    return paged_chunk_attn_ref(q[:, None], k_pages, v_pages, page_idx,
                                cache_len, ones)[:, 0]


def paged_attn_split_ref(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, page_idx: torch.Tensor,
                         cache_len: torch.Tensor, n_split: int,
                         pages_per_split: int, k_scale=None,
                         v_scale=None) -> torch.Tensor:
    """K5 (K7 with int8 pages and their scales) as the CUDA kernel computes
    it, in two passes; for tests only.  Pass 1: split ``s`` takes page lanes
    ``[s * pages_per_split, (s + 1) * pages_per_split)`` and gives, per
    query head, its own softmax state: the max score ``m`` (-inf when it
    holds no valid position), ``l = sum exp(score - m)`` and ``acc = sum
    exp(score - m) * v`` (0 when empty).  Pass 2 merges them: ``M = max
    m``, each split weighted by ``exp(m - M)`` (0 for an empty split, so
    -inf - (-inf) is never formed), ``out = sum w acc / max(sum w l,
    1e-20)``; a row whose splits are all empty is exactly zero."""
    b, h, hd = q.shape
    n_pages, ps, kvh, _ = k_pages.shape
    g = h // kvh
    lanes = page_idx.shape[1]
    span = n_split * pages_per_split
    if span < lanes:
        raise ValueError(f"{n_split} splits of {pages_per_split} lanes do "
                         f"not cover {lanes} lanes")
    pi = torch.full((b, span), -1, dtype=page_idx.dtype, device=q.device)
    pi[:, :lanes] = page_idx
    lane_ok = (pi >= 0) & (pi < n_pages)
    idx = torch.where(lane_ok, pi, 0).long()

    def gathered(pages, scale):
        x = pages[idx].float()                     # (B, span, ps, KVH, hd)
        if scale is not None:
            x = x * scale[idx][:, :, None, :, None]
        return x.reshape(b, n_split, pages_per_split * ps, kvh, hd)

    k, v = gathered(k_pages, k_scale), gathered(v_pages, v_scale)
    t = torch.arange(span * ps, device=q.device)
    n_pos = torch.clamp(cache_len.long(), max=lanes * ps)
    valid = ((t[None, :] < n_pos[:, None])
             & lane_ok.repeat_interleave(ps, dim=1))            # (B, T)
    valid = valid.reshape(b, 1, 1, n_split, -1)
    qh = q.float().reshape(b, kvh, g, hd)
    sc = torch.einsum("bkgd,bntkd->bkgnt", qh, k) / math.sqrt(hd)
    sc = torch.where(valid, sc, -math.inf)
    m = sc.amax(dim=-1)                                         # (B,K,g,n)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(valid, torch.exp(sc - m_safe[..., None]), 0.0)
    l_s = p.sum(dim=-1)
    acc = torch.einsum("bkgnt,bntkd->bkgnd", p, v)
    top = m.amax(dim=-1, keepdim=True)
    top = torch.where(torch.isfinite(top), top, 0.0)
    w = torch.where(torch.isfinite(m), torch.exp(m - top), 0.0)
    den = torch.clamp((w * l_s).sum(dim=-1), min=1e-20)
    o = (w[..., None] * acc).sum(dim=-2) / den[..., None]
    return o.reshape(b, h, hd).to(q.dtype)


def paged_attn_quant_ref(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, k_scale: torch.Tensor,
                         v_scale: torch.Tensor, page_idx: torch.Tensor,
                         cache_len: torch.Tensor) -> torch.Tensor:
    """K7: :func:`paged_attn_ref` over int8 k/v_pages with (n_pages, KVH)
    float32 scales, dequantized as in :func:`paged_chunk_attn_quant_ref`."""
    ones = torch.ones_like(cache_len)
    return paged_chunk_attn_quant_ref(q[:, None], k_pages, v_pages, k_scale,
                                      v_scale, page_idx, cache_len,
                                      ones)[:, 0]
