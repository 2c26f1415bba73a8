"""Wrappers for the table scan kernels K3 and K4 (``csrc/table_kernels.cu``).

K3 (``revocation_poll``) replaces ``repro.kernels.table_scan._poll_kernel``
and returns the EXACT count of slots publishing a lock.  The TPU kernel
stopped scanning at the first matching block, because its grid ran in order,
and so returned only a lower bound once the count was non-zero.  Its
contract (exact when zero, a lower bound >= 1 otherwise) is met by the exact
count.  K4 (``revocation_poll_multi``) replaces ``_multi_poll_kernel``:
exact counts for up to 128 lock values in one pass.

CPU tensors take the plain versions in ``ref``; CUDA tensors launch the
kernel or raise.  Each launch adds one to the kernel's counter.
"""

from __future__ import annotations

import torch

from . import _build
from . import ref as R
from .table_publish import check_table, check_vec, on_cpu, table_lib

MAX_LOCKS = 128   # K4 keeps one shared-memory counter per lock value

REVOCATION_POLL = _build.LaunchCounter("revocation_poll")              # K3
REVOCATION_POLL_MULTI = _build.LaunchCounter("revocation_poll_multi")  # K4


def revocation_poll(table2d: torch.Tensor, lock_id: int) -> torch.Tensor:
    """K3: -> 0-d int32 tensor on the table's device, the exact number of
    slots equal to ``lock_id`` (a host int: it travels as a kernel argument,
    so a poll uploads nothing)."""
    n_slots = check_table(table2d)
    lock_id = int(lock_id)
    if on_cpu(table2d):
        return R.poll_ref(table2d, lock_id)
    count = torch.empty((), dtype=torch.int32, device=table2d.device)
    lib = table_lib()
    _build.check(lib, lib.bravo_poll(
        _build.ptr(table2d), n_slots, lock_id, _build.ptr(count),
        _build.stream_ptr(table2d.device)), "revocation_poll")
    REVOCATION_POLL.add()
    return count


def revocation_poll_multi(table2d: torch.Tensor,
                          lock_ids: torch.Tensor) -> torch.Tensor:
    """K4: -> (K,) int32 exact hold counts, one per entry of the int32
    ``lock_ids`` (K <= 128), in one pass over the table."""
    n_slots = check_table(table2d)
    check_vec(lock_ids, "lock_ids")
    k = lock_ids.shape[0]
    if on_cpu(table2d, lock_ids):
        return R.multi_count_ref(table2d, lock_ids)
    if k > MAX_LOCKS:
        raise ValueError(f"{k} lock values in one poll; the kernel takes at "
                         f"most {MAX_LOCKS}")
    counts = torch.empty(k, dtype=torch.int32, device=table2d.device)
    if k:
        lib = table_lib()
        _build.check(lib, lib.bravo_multi_poll(
            _build.ptr(table2d), n_slots, _build.ptr(lock_ids), k,
            _build.ptr(counts), _build.stream_ptr(table2d.device)),
            "revocation_poll_multi")
        REVOCATION_POLL_MULTI.add()
    return counts
