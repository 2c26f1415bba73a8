"""Wrappers for the table scan kernels K3, K4 and K9
(``csrc/table_kernels.cu``).

K3 (``revocation_poll``) replaces ``repro.kernels.table_scan._poll_kernel``
and returns the EXACT count of slots publishing a lock.  The TPU kernel
stopped scanning at the first matching block, because its grid ran in order,
and so returned only a lower bound once the count was non-zero.  Its
contract (exact when zero, a lower bound >= 1 otherwise) is met by the exact
count.  K4 (``revocation_poll_multi``) replaces ``_multi_poll_kernel``:
exact counts for any number of lock values (duplicates and every int32
value included) in one launch.  K9 (``revocation_scan``) replaces
``_scan_kernel``: the int8 match mask and the exact count, which the TPU
kernel also returned exactly.

CPU tensors take the plain versions in ``ref``; CUDA tensors launch the
kernel or raise.  Each launch adds one to the kernel's counter; the
``_launch_*`` functions launch K3, K4 or K9 of a given build
(``table_publish.parent_lib`` for the parent designs) and count nothing.
``empty_launch`` launches a kernel that does nothing, the floor the table
kernels are timed against; ``load_floor_launch`` and ``chain_floor_launch``
launch one warp that does one load and one store a thread, or two
dependent loads and a store, the floors under K1/K2's round trips.  They
port no TPU kernel and count nothing.
"""

from __future__ import annotations

import torch

from . import _build
from . import ref as R
from .table_publish import check_table, check_vec, on_cpu, table_lib

BLOCK_ROWS = 8    # the TPU kernels' row block: tables come in whole blocks

REVOCATION_POLL = _build.LaunchCounter("revocation_poll")              # K3
REVOCATION_POLL_MULTI = _build.LaunchCounter("revocation_poll_multi")  # K4
REVOCATION_SCAN = _build.LaunchCounter("revocation_scan")              # K9


def revocation_scan(table2d: torch.Tensor, lock_id: int):
    """K9: -> (int8 (rows, 128) mask of the slots equal to ``lock_id``,
    0-d int32 exact count), both on the table's device.  The table must
    hold whole blocks of 8 rows, as ``repro``'s ``_scan_call`` asserts."""
    check_table(table2d)
    if table2d.shape[0] % BLOCK_ROWS:
        raise ValueError(f"table of {table2d.shape[0]} rows: the scan takes "
                         f"a multiple of {BLOCK_ROWS}")
    lock_id = int(lock_id)
    if on_cpu(table2d):
        return R.scan_ref(table2d, lock_id)
    mask = torch.empty(table2d.shape, dtype=torch.int8, device=table2d.device)
    count = torch.empty((), dtype=torch.int32, device=table2d.device)
    _launch_scan(table_lib(), table2d, lock_id, mask, count)
    REVOCATION_SCAN.add()
    return mask, count


def _launch_scan(lib, table2d, lock_id: int, mask, count) -> None:
    """K9 of build ``lib``; ``mask`` must be 4-byte aligned (a fresh
    tensor is): the kernel stores it a word per four slots."""
    _build.check(lib, lib.bravo_scan(
        _build.ptr(table2d), table2d.numel(), lock_id, _build.ptr(mask),
        _build.ptr(count), _build.stream_ptr(table2d.device)),
        "revocation_scan")


def revocation_poll(table2d: torch.Tensor, lock_id: int) -> torch.Tensor:
    """K3: -> 0-d int32 tensor on the table's device, the exact number of
    slots equal to ``lock_id`` (a host int: it travels as a kernel argument,
    so a poll uploads nothing)."""
    check_table(table2d)
    lock_id = int(lock_id)
    if on_cpu(table2d):
        return R.poll_ref(table2d, lock_id)
    count = torch.empty((), dtype=torch.int32, device=table2d.device)
    _launch_poll(table_lib(), table2d, lock_id, count)
    REVOCATION_POLL.add()
    return count


def _launch_poll(lib, table2d, lock_id: int, count) -> None:
    _build.check(lib, lib.bravo_poll(
        _build.ptr(table2d), table2d.numel(), lock_id, _build.ptr(count),
        _build.stream_ptr(table2d.device)), "revocation_poll")


def revocation_poll_multi(table2d: torch.Tensor,
                          lock_ids: torch.Tensor) -> torch.Tensor:
    """K4: -> (K,) int32 exact hold counts, one per entry of the int32
    ``lock_ids`` (any K; each duplicate gets its value's full count; 0
    counts the free slots), in one launch.  K = 0 launches nothing."""
    check_table(table2d)
    check_vec(lock_ids, "lock_ids")
    if on_cpu(table2d, lock_ids):
        return R.multi_count_ref(table2d, lock_ids)
    counts = torch.empty(lock_ids.shape[0], dtype=torch.int32,
                         device=table2d.device)
    if lock_ids.shape[0]:
        _launch_multi_poll(table_lib(), table2d, lock_ids, counts)
        REVOCATION_POLL_MULTI.add()
    return counts


def _launch_multi_poll(lib, table2d, lock_ids, counts) -> None:
    """K4 of build ``lib`` (one CTA a lock value); the parent build refuses
    K > 128."""
    _build.check(lib, lib.bravo_multi_poll(
        _build.ptr(table2d), table2d.numel(), _build.ptr(lock_ids),
        lock_ids.shape[0], _build.ptr(counts),
        _build.stream_ptr(table2d.device)), "revocation_poll_multi")


def empty_launch(device: torch.device) -> None:
    """Launch a kernel that does nothing (one CTA, as K3/K4/K9 launch) on
    ``device``'s current stream: the launch floor the table kernels are
    timed against.  Nothing to do on the CPU."""
    if device.type == "cpu":
        return
    lib = table_lib()
    _build.check(lib, lib.bravo_empty(_build.stream_ptr(device)),
                 "empty_launch")


FLOOR_THREADS = 32   # the load and chain floors run one warp


def load_floor_launch(src: torch.Tensor, out: torch.Tensor) -> None:
    """One warp: ``out[t] = src[t]`` for t < 32 (int32 CUDA tensors of at
    least 32 entries), one global load and one store a thread."""
    for t, name in ((src, "src"), (out, "out")):
        check_vec(t, name)
        if t.shape[0] < FLOOR_THREADS or t.device.type != "cuda":
            raise ValueError(f"{name}: need an int32 CUDA vector of at "
                             f"least {FLOOR_THREADS} entries")
    lib = table_lib()
    _build.check(lib, lib.bravo_load_floor(
        _build.ptr(src), _build.ptr(out), _build.stream_ptr(src.device)),
        "load_floor_launch")


def chain_floor_launch(idx: torch.Tensor, vals: torch.Tensor,
                       out: torch.Tensor) -> None:
    """One warp: ``out[t] = vals[idx[t]]`` for t < 32, two dependent global
    loads and a store a thread.  The caller's ``idx`` must index ``vals``
    (the launch checks nothing on the card)."""
    for t, name in ((idx, "idx"), (vals, "vals"), (out, "out")):
        check_vec(t, name)
        if t.shape[0] < FLOOR_THREADS or t.device.type != "cuda":
            raise ValueError(f"{name}: need an int32 CUDA vector of at "
                             f"least {FLOOR_THREADS} entries")
    lib = table_lib()
    _build.check(lib, lib.bravo_chain_floor(
        _build.ptr(idx), _build.ptr(vals), _build.ptr(out),
        _build.stream_ptr(idx.device)), "chain_floor_launch")
