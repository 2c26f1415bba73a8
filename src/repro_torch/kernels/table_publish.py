"""Wrappers for the table publish kernels K1, K2 and K10
(``csrc/table_kernels.cu``).

K1 (``fused_publish_multi``, ``acquire_hashed``) replaces
``repro.kernels.table_publish._fused_publish_multi_kernel``; K2
(``fused_publish``, ``publish_hashed``, ``release_hashed``) replaces
``_fused_publish_kernel``.  The hashed entries are the lease paths of the
registry and of the single-lock lease table: they compute the splitmix64
slot and gather the lock value inside the same launch.

Where the JAX kernels aliased the table into their output
(``input_output_aliases``) and the callers donated it, these update the
caller's table tensor IN PLACE and return that same tensor.  K10
(``publish``, ``clear``) replaces the legacy ``_publish_kernel``, which had
no alias and copied its table on every call: it returns a NEW table.

A wrapper given CPU tensors runs the plain version from ``ref`` (and copies
its result into the table); given CUDA tensors it launches the kernel or
raises.  Each launch adds one to the kernel's :class:`LaunchCounter`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from . import ref as R

LANES = 128
MAX_REQUESTS = 1024   # one thread per request, one CTA
# K10 stages the table in one CTA's shared memory: 227 KiB less the 8 KiB
# of its request chunk
MAX_SEQ_SLOTS = (232448 - 8192) // 4
SOURCE = "table_kernels.cu"

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "bravo_publish_multi": [_P, _I, _P, _I, _P, _P, _P, _P, _I, _P],
    "bravo_acquire_hashed": [_P, _I, _P, _P, _I, _P, _I, _P, _P, _I, _P],
    "bravo_publish": [_P, _I, _P, _I, _I, _P, _P, _P, _I, _P],
    "bravo_publish_hashed": [_P, _I, _P, _P, _I, _P, _I, _P, _P, _I, _P],
    "bravo_release_hashed": [_P, _I, _P, _I, _P, _I, _P, _P, _I, _P],
    "bravo_poll": [_P, _I, _I, _P, _P],
    "bravo_multi_poll": [_P, _I, _P, _I, _P, _P],
    "bravo_scan": [_P, _I, _I, _P, _P, _P],
    "bravo_publish_seq": [_P, _I, _P, _P, _P, _P, _I, _I, _P],
}

FUSED_PUBLISH_MULTI = _build.LaunchCounter("fused_publish_multi")   # K1
FUSED_PUBLISH = _build.LaunchCounter("fused_publish")               # K2
PUBLISH = _build.LaunchCounter("publish")                           # K10


def table_lib() -> ctypes.CDLL:
    """The compiled ``table_kernels.cu`` (built at first use)."""
    return _build.load(SOURCE, SIGNATURES)


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on the CPU, False if every one lies on one
    CUDA device; raises on a mix."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(
            f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cpu"


def check_vec(t: torch.Tensor, name: str, n=None, dtype=torch.int32) -> None:
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous 1-D {dtype} tensor, got "
                         f"{t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")
    if n is not None and t.shape[0] != n:
        raise ValueError(f"{name}: need length {n}, got {t.shape[0]}")


def check_table(table2d: torch.Tensor) -> int:
    """Validate a (rows, 128) int32 table; -> number of slots."""
    if (table2d.dtype != torch.int32 or table2d.dim() != 2
            or table2d.shape[1] != LANES or not table2d.is_contiguous()):
        raise ValueError(f"table: need a contiguous (rows, {LANES}) int32 "
                         f"tensor, got {table2d.dtype} {tuple(table2d.shape)}")
    return table2d.numel()


def _check_batch(m: int) -> None:
    if m > MAX_REQUESTS:
        raise ValueError(f"{m} requests in one batch; the kernel takes at "
                         f"most {MAX_REQUESTS}")


def _check_pow2(n_slots: int) -> None:
    if n_slots & (n_slots - 1):
        raise ValueError(f"hashed entries need a power-of-two table, got "
                         f"{n_slots} slots")


def _lane_stride(lock_idx: torch.Tensor, m: int) -> int:
    """Lane vector of one entry (shared by all requests) or of M entries."""
    check_vec(lock_idx.reshape(-1), "lock_idx")
    n = lock_idx.numel()
    if n == 1:
        return 0
    if n == m:
        return 1
    raise ValueError(f"lock_idx: need 1 or {m} entries, got {n}")


def _lanes(lock_idx, table2d: torch.Tensor, m: int):
    """-> (the kernel's lane stride, the plain version's lanes).  ``None``
    means lane 0 for every request (the one lock of ``lock_vals``); the
    kernel then reads no lane vector."""
    if lock_idx is None:
        return 0, torch.zeros((), dtype=torch.int32, device=table2d.device)
    stride = _lane_stride(lock_idx, m)
    return stride, lock_idx.reshape(-1) if stride else lock_idx.reshape(())


def fused_publish_multi(table2d: torch.Tensor, rbias_vec: torch.Tensor,
                        slots: torch.Tensor, lock_idx: torch.Tensor,
                        ids: torch.Tensor):
    """K1: multi-lock batched CAS(0 -> id), each request gated by its own
    lock's bias lane ``rbias_vec[lock_idx[i]]``.  -> (table, updated in
    place; granted bool (M,))."""
    m = slots.shape[0]
    check_table(table2d)
    for t, name in ((rbias_vec, "rbias_vec"), (slots, "slots"),
                    (lock_idx, "lock_idx"), (ids, "ids")):
        check_vec(t, name, None if t is rbias_vec else m)
    if on_cpu(table2d, rbias_vec, slots, lock_idx, ids):
        new, granted = R.publish_multi_ref(table2d, rbias_vec, slots,
                                           lock_idx, ids)
        table2d.copy_(new)
        return table2d, granted
    _check_batch(m)
    granted = torch.empty(m, dtype=torch.bool, device=table2d.device)
    if m:
        lib = table_lib()
        _build.check(lib, lib.bravo_publish_multi(
            _build.ptr(table2d), table2d.numel(), _build.ptr(rbias_vec),
            rbias_vec.shape[0], _build.ptr(slots), _build.ptr(lock_idx),
            _build.ptr(ids), _build.ptr(granted), m,
            _build.stream_ptr(table2d.device)), "fused_publish_multi")
        FUSED_PUBLISH_MULTI.add()
    return table2d, granted


def acquire_hashed(table2d: torch.Tensor, rbias_vec: torch.Tensor,
                   lock_vals: torch.Tensor, lock_idx: torch.Tensor,
                   reader_ids: torch.Tensor) -> torch.Tensor:
    """K1 on the registry's lease path: request ``i`` publishes lock value
    ``v = lock_vals[lane]`` (``lane = lock_idx[i]``, or ``lock_idx[0]`` for
    every request) into slot ``splitmix64(v, reader_ids[i]) % n_slots``
    under ``rbias_vec[lane]``.  Hash, gather and publish are one launch.
    Updates ``table2d`` in place; -> granted bool (M,)."""
    m = reader_ids.shape[0]
    n_slots = check_table(table2d)
    _check_pow2(n_slots)
    check_vec(rbias_vec, "rbias_vec")
    check_vec(lock_vals, "lock_vals", rbias_vec.shape[0])
    check_vec(reader_ids, "reader_ids")
    stride, lanes = _lanes(lock_idx, table2d, m)
    if on_cpu(table2d, rbias_vec, lock_vals, lanes, reader_ids):
        new, granted = R.acquire_hashed_ref(table2d, rbias_vec, lock_vals,
                                            lanes, reader_ids)
        table2d.copy_(new)
        return granted
    _check_batch(m)
    granted = torch.empty(m, dtype=torch.bool, device=table2d.device)
    if m:
        lib = table_lib()
        _build.check(lib, lib.bravo_acquire_hashed(
            _build.ptr(table2d), n_slots, _build.ptr(rbias_vec),
            _build.ptr(lock_vals), lock_vals.shape[0], _build.ptr(lock_idx),
            stride, _build.ptr(reader_ids), _build.ptr(granted), m,
            _build.stream_ptr(table2d.device)), "acquire_hashed")
        FUSED_PUBLISH_MULTI.add()
    return granted


def fused_publish(table2d: torch.Tensor, rbias: torch.Tensor,
                  slots: torch.Tensor, ids: torch.Tensor, *,
                  unconditional: bool = False, check_rbias: bool = True):
    """K2: batched CAS(0 -> id) against one scalar bias ``rbias`` (checked
    in kernel when ``check_rbias``); ``unconditional`` stores whatever the
    occupancy (ids = 0 is the release).  The first request per slot wins;
    slot -1 matches nothing.  -> (table, updated in place; granted (M,))."""
    m = slots.shape[0]
    check_table(table2d)
    check_vec(rbias.reshape(-1), "rbias", 1)
    check_vec(slots, "slots")
    check_vec(ids, "ids", m)
    if on_cpu(table2d, rbias, slots, ids):
        new, granted = R.publish_ref(table2d, rbias, slots, ids,
                                     unconditional=unconditional,
                                     check_rbias=check_rbias)
        table2d.copy_(new)
        return table2d, granted
    _check_batch(m)
    granted = torch.empty(m, dtype=torch.bool, device=table2d.device)
    if m:
        lib = table_lib()
        _build.check(lib, lib.bravo_publish(
            _build.ptr(table2d), table2d.numel(), _build.ptr(rbias),
            int(check_rbias), int(unconditional), _build.ptr(slots),
            _build.ptr(ids), _build.ptr(granted), m,
            _build.stream_ptr(table2d.device)), "fused_publish")
        FUSED_PUBLISH.add()
    return table2d, granted


def publish_hashed(table2d: torch.Tensor, rbias: torch.Tensor,
                   lock_vals: torch.Tensor, lock_idx: Optional[torch.Tensor],
                   reader_ids: torch.Tensor) -> torch.Tensor:
    """K2 on the single-lock lease table's path: request ``i`` publishes
    the lock value ``v = lock_vals[lane]`` (``lane = lock_idx[i]``, or
    ``lock_idx[0]`` for every request, or 0 when ``lock_idx`` is None)
    into slot ``splitmix64(v,
    reader_ids[i]) % n_slots``, first request per slot, only into a free
    slot and only while the scalar ``rbias != 0`` (the recheck and undo of
    one launch).  Updates ``table2d`` in place; -> granted bool (M,)."""
    m = reader_ids.shape[0]
    n_slots = check_table(table2d)
    _check_pow2(n_slots)
    check_vec(rbias.reshape(-1), "rbias", 1)
    check_vec(lock_vals, "lock_vals")
    check_vec(reader_ids, "reader_ids")
    stride, lanes = _lanes(lock_idx, table2d, m)
    if on_cpu(table2d, rbias, lock_vals, lanes, reader_ids):
        new, granted = R.publish_hashed_ref(table2d, rbias, lock_vals, lanes,
                                            reader_ids)
        table2d.copy_(new)
        return granted
    _check_batch(m)
    granted = torch.empty(m, dtype=torch.bool, device=table2d.device)
    if m:
        lib = table_lib()
        _build.check(lib, lib.bravo_publish_hashed(
            _build.ptr(table2d), n_slots, _build.ptr(rbias),
            _build.ptr(lock_vals), lock_vals.shape[0], _build.ptr(lock_idx),
            stride, _build.ptr(reader_ids), _build.ptr(granted), m,
            _build.stream_ptr(table2d.device)), "publish_hashed")
        FUSED_PUBLISH.add()
    return granted


def release_hashed(table2d: torch.Tensor, lock_vals: torch.Tensor,
                   lock_idx: Optional[torch.Tensor], reader_ids: torch.Tensor,
                   mask=None) -> torch.Tensor:
    """K2 on the lease paths: clear the slots that :func:`acquire_hashed`
    or :func:`publish_hashed` published for these readers (``lock_idx`` as
    there).  A reader whose
    ``mask`` entry is False (its acquire was denied) clears nothing: the
    slot it hashes to may hold another reader's lease.  Updates
    ``table2d`` in place and returns it."""
    m = reader_ids.shape[0]
    n_slots = check_table(table2d)
    _check_pow2(n_slots)
    check_vec(lock_vals, "lock_vals")
    check_vec(reader_ids, "reader_ids")
    stride, lanes = _lanes(lock_idx, table2d, m)
    ts = [table2d, lock_vals, lanes, reader_ids]
    if mask is not None:
        check_vec(mask, "mask", m, dtype=torch.bool)
        ts.append(mask)
    if on_cpu(*ts):
        table2d.copy_(R.release_hashed_ref(table2d, lock_vals, lanes,
                                           reader_ids, mask))
        return table2d
    _check_batch(m)
    if m:
        lib = table_lib()
        _build.check(lib, lib.bravo_release_hashed(
            _build.ptr(table2d), n_slots, _build.ptr(lock_vals),
            lock_vals.shape[0], _build.ptr(lock_idx), stride,
            _build.ptr(reader_ids), _build.ptr(mask), m,
            _build.stream_ptr(table2d.device)), "release_hashed")
        FUSED_PUBLISH.add()
    return table2d


def publish(table2d: torch.Tensor, slots: torch.Tensor, ids: torch.Tensor, *,
            unconditional: bool = False):
    """K10: the requests one at a time, in order, on a copy of the table:
    request ``i`` stores ``ids[i]`` if its slot is free (always, when
    ``unconditional``) and is granted if it stored.  So a later request
    sees every earlier store: duplicate unconditional stores keep the LAST
    id, and a conditional publish of id 0 leaves its slot free.  A slot
    outside the table reads as free and stores nothing.  -> (NEW table,
    granted bool (M,)); the input table is not changed."""
    m = slots.shape[0]
    n_slots = check_table(table2d)
    check_vec(slots, "slots")
    check_vec(ids, "ids", m)
    if on_cpu(table2d, slots, ids):
        return R.publish_seq_ref(table2d, slots, ids,
                                 unconditional=unconditional)
    if n_slots > MAX_SEQ_SLOTS:
        raise ValueError(f"a table of {n_slots} slots does not fit one "
                         f"CTA's shared memory; the kernel takes at most "
                         f"{MAX_SEQ_SLOTS}")
    out = torch.empty_like(table2d)
    granted = torch.empty(m, dtype=torch.bool, device=table2d.device)
    lib = table_lib()
    _build.check(lib, lib.bravo_publish_seq(
        _build.ptr(table2d), n_slots, _build.ptr(out), _build.ptr(slots),
        _build.ptr(ids), _build.ptr(granted), m, int(unconditional),
        _build.stream_ptr(table2d.device)), "publish")
    PUBLISH.add()
    return out, granted


def clear(table2d: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """K10 as the legacy release: store 0 into each slot.  -> NEW table."""
    return publish(table2d, slots, torch.zeros_like(slots),
                   unconditional=True)[0]
