"""Plain PyTorch versions of the table kernels K1-K4.

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
    lane outside ``lock_vals`` gets slot -1."""
    n_slots = table2d.numel()
    n_locks = lock_vals.shape[0]
    lidx = lock_idx.expand(reader_ids.shape)
    lane_ok = (lidx >= 0) & (lidx < n_locks)
    vals = lock_vals[lidx.clamp(0, n_locks - 1).long()]
    zero = torch.zeros_like(vals)
    slots = hash_slots(zero, vals, torch.zeros_like(reader_ids), reader_ids,
                       n_slots)
    return lidx, vals, torch.where(lane_ok, slots, -1)


def acquire_hashed_ref(table2d: torch.Tensor, rbias_vec: torch.Tensor,
                       lock_vals: torch.Tensor, lock_idx: torch.Tensor,
                       reader_ids: torch.Tensor):
    """K1 for int32 ``reader_ids`` under the locks in lanes ``lock_idx``
    ((M,) or one lane for all).  -> (new table, granted bool (M,))."""
    lidx, vals, slots = hashed_requests(table2d, lock_vals, lock_idx,
                                        reader_ids)
    return publish_multi_ref(table2d, rbias_vec, slots, lidx, vals)


def release_hashed_ref(table2d: torch.Tensor, lock_vals: torch.Tensor,
                       lock_idx: torch.Tensor, reader_ids: torch.Tensor,
                       mask=None) -> torch.Tensor:
    """K2 as the release of the leases ``acquire_hashed_ref`` published;
    readers where ``mask`` is False clear nothing.  -> new table."""
    _, _, slots = hashed_requests(table2d, lock_vals, lock_idx, reader_ids)
    if mask is not None:
        slots = torch.where(mask, slots, -1)
    return clear_ref(table2d, slots)
