"""Wrappers for the paged decode attention kernels K5 and K7
(``csrc/paged_attn.cu``).

K5 (``paged_attention``) replaces ``repro.kernels.paged_attn.
_make_paged_attn_kernel(lanes_per_step, quantized=False)``: one query token
per request attends to the KV pool's page store through the request's
page-index vector, never through a dense cache.  K7
(``paged_attention_quant``) replaces the same kernel built with
``quantized=True`` (``_paged_attn_quant_call``): K5 over int8 pages with one
float32 scale per (page, KV head), dequantized in the kernel.  The CUDA
kernel splits the page lanes over the grid (:func:`decode_splits`, from
host shapes alone) and walks each split in tiles of 32 to 128 positions,
streamed through shared memory with 16-byte asynchronous copies; a second
pass merges the splits' partial softmax states.  Both passes count as one
launch.  Any head_dim up to :data:`MAX_HEAD_DIM` runs, padded to the next
width the kernels are built for (16, 32, 64, 128, 256).  The Pallas
kernel's tuning knob, ``lanes_per_step`` (the KV one grid step takes), has
its counterpart in the autotune table's ``min_split_positions``: the least
positions a split of the grid takes (:func:`decode_plan`).

A CPU tensor takes the plain version (``ref.paged_attn_ref``,
``ref.paged_attn_quant_ref``); a CUDA tensor launches the kernel or raises.
Each launch adds one to :data:`PAGED_ATTENTION` or
:data:`PAGED_ATTENTION_QUANT`.  The kernel goes to PyTorch's current
stream, so a drain poll enqueued after a step runs after that step's
attention.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from . import ref as R
from .table_publish import on_cpu

SOURCE = "paged_attn.cu"
MAX_HEAD_DIM = 256   # the widest instantiation; a smaller hd is padded
DECODE_HEADS = 4  # decode kernel: query heads of one CTA
MAX_SPLIT_PAGES = 512        # page lanes of one decode split
# a split is worth a CTA from this many positions: splitting rows of 256
# into splits of 128 or 64 gained at most 5% (decode_sweep on an H100, 8
# rows) and cost 16-40% (16 rows)
MIN_SPLIT_POSITIONS = 256
# the autotune knob ``min_split_positions`` (``kernels/autotune.py``): 0 is
# MIN_SPLIT_POSITIONS; ``repro``'s counterpart is ``lanes_per_step``, the
# KV one grid step takes
SPLIT_POSITION_CANDIDATES = (0, 128, 512, 1024)

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "bravo_paged_attn": [_P] * 8 + [_I] * 11 + [_P],
    "bravo_paged_chunk_attn": [_P] * 9 + [_I] * 13 + [_P],
    "bravo_paged_attn_quant": [_P] * 10 + [_I] * 10 + [_P],
    "bravo_paged_attn_residency": [_I] * 8 + [_P],
    "bravo_paged_chunk_attn_quant": [_P] * 11 + [_I] * 12 + [_P],
    "bravo_paged_chunk_attn_residency": [_I] * 4 + [_P] * 2,
}
# the build whose chunk entry points run the parent chunk design (timing
# only; nothing on the serving path loads it)
PARENT_DEFINES = ("BRAVO_CHUNK_PARENT=1",)

PAGED_ATTENTION = _build.LaunchCounter("paged_attention")       # K5
PAGED_ATTENTION_QUANT = _build.LaunchCounter("paged_attention_quant")  # K7

_Q_TYPES = (torch.float32, torch.bfloat16)
_KV_TYPES = (torch.bfloat16, torch.float32)


def paged_lib() -> ctypes.CDLL:
    """The compiled ``paged_attn.cu`` (built at first use)."""
    return _build.load(SOURCE, SIGNATURES)


def parent_lib() -> ctypes.CDLL:
    """``paged_attn.cu`` built with ``PARENT_DEFINES``: its chunk entry
    points run the parent chunk design (one CTA per request, block of
    columns and KV head, no split), for timing beside the kernel."""
    return _build.load(SOURCE, SIGNATURES, PARENT_DEFINES)


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_args(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
               page_idx: torch.Tensor, cache_len: torch.Tensor,
               new_lens: Optional[torch.Tensor] = None,
               k_scale: Optional[torch.Tensor] = None,
               v_scale: Optional[torch.Tensor] = None) -> bool:
    """Validate the operands of K5 (q (B, H, hd)) or K6 (q (B, S, H, hd),
    with ``new_lens``), and of K7/K8, which add the int8 pages' (n_pages,
    KVH) float32 ``k_scale`` and ``v_scale``; -> True if they lie on the
    CPU.  Raises on a wrong type, shape, layout or a mix of devices, and on
    int8 pages without scales or scales without int8 pages."""
    quant = k_scale is not None or v_scale is not None
    ts = [q, k_pages, v_pages, page_idx, cache_len]
    for t in (new_lens, k_scale, v_scale):
        if t is not None:
            ts.append(t)
    cpu = on_cpu(*ts)
    _need(q.dim() == (3 if new_lens is None else 4),
          f"q: need {'(B, H, hd)' if new_lens is None else '(B, S, H, hd)'}, "
          f"got {tuple(q.shape)}")
    _need(q.dtype in _Q_TYPES, f"q: need float32 or bfloat16, got {q.dtype}")
    _need(k_pages.dim() == 4 and k_pages.shape == v_pages.shape,
          f"k/v_pages: need two (n_pages, ps, KVH, hd) tensors, got "
          f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    if quant:
        _need(k_pages.dtype == torch.int8 and v_pages.dtype == torch.int8,
              f"k/v_pages: scales go with int8 pages, got {k_pages.dtype} "
              f"and {v_pages.dtype}")
        want = (k_pages.shape[0], k_pages.shape[2])
        for t, name in ((k_scale, "k_scale"), (v_scale, "v_scale")):
            _need(t is not None and t.dtype == torch.float32
                  and tuple(t.shape) == want,
                  f"{name}: need {want} float32, got "
                  f"{None if t is None else (t.dtype, tuple(t.shape))}")
    else:
        _need(k_pages.dtype in _KV_TYPES and v_pages.dtype == k_pages.dtype,
              f"k/v_pages: need bfloat16 or float32, one type (int8 pages "
              f"need their scales), got {k_pages.dtype} and "
              f"{v_pages.dtype}")
    b, h, hd = q.shape[0], q.shape[-2], q.shape[-1]
    kvh = k_pages.shape[2]
    _need(k_pages.shape[3] == hd and kvh > 0 and h % kvh == 0,
          f"heads: q has {h} x {hd}, pages {kvh} x {k_pages.shape[3]}; need "
          f"the same head_dim and H a multiple of KVH")
    _need(page_idx.dtype == torch.int32 and page_idx.dim() == 2
          and page_idx.shape[0] == b,
          f"page_idx: need ({b}, P) int32, got {page_idx.dtype} "
          f"{tuple(page_idx.shape)}")
    for t, name in ((cache_len, "cache_len"), (new_lens, "new_lens")):
        if t is not None:
            _need(t.dtype == torch.int32 and tuple(t.shape) == (b,),
                  f"{name}: need ({b},) int32, got {t.dtype} "
                  f"{tuple(t.shape)}")
    for t in ts:
        _need(t.is_contiguous(), "paged attention takes contiguous tensors")
    if not cpu:
        _need(0 < hd <= MAX_HEAD_DIM, f"head_dim {hd}: the kernels take "
              f"head_dim 1 to {MAX_HEAD_DIM}")
    return cpu


def decode_splits(b: int, h: int, kvh: int, lanes: int, ps: int,
                  n_sm: int, resident: int,
                  min_positions: int = 0) -> Tuple[int, int]:
    """K5/K7's KV split, from host shapes alone (never from ``cache_len``'s
    values, so a call moves nothing between host and device): -> (number
    of splits, page lanes per split).  The grid has ``b * kvh * groups``
    CTAs a split (``groups``: the query heads of a KV head in fours); the
    splits fill one wave of ``resident`` CTAs on
    each of ``n_sm`` SMs, as long as each split keeps
    ``min_positions`` positions (the autotune knob; 0, or a value outside
    :data:`SPLIT_POSITION_CANDIDATES`, is ``MIN_SPLIT_POSITIONS``), and a
    split never holds more than ``MAX_SPLIT_PAGES`` lanes.  One split runs
    no second pass."""
    if lanes <= 0:
        return 1, 0
    if not min_positions or min_positions not in SPLIT_POSITION_CANDIDATES:
        min_positions = MIN_SPLIT_POSITIONS
    groups = -(-(h // kvh) // DECODE_HEADS)
    wave = max(1, resident * n_sm // max(1, b * kvh * groups))
    most = lanes * ps // min_positions
    n = max(1, min(wave, most, lanes), -(-lanes // MAX_SPLIT_PAGES))
    pps = -(-lanes // n)
    return -(-lanes // pps), pps


_RESIDENT = {}


def decode_residency(q: torch.Tensor, k_pages: torch.Tensor, lanes: int,
                     pps: int, lib: Optional[ctypes.CDLL] = None) -> int:
    """CTAs of the decode kernel for these operands (q and page types, head
    shape, ``lanes`` page lanes, ``pps`` of them a split) that one SM holds
    at once, from the CUDA occupancy calculator: a host query, cached.
    ``lib``: a build of ``paged_attn.cu`` other than :func:`paged_lib`'s
    (the timing sweep's variants)."""
    if lib is None:
        lib = paged_lib()
    h, hd = q.shape[-2], q.shape[-1]
    ps, kvh = k_pages.shape[1], k_pages.shape[2]
    kv = 2 if k_pages.dtype == torch.int8 else _codes(q, k_pages)[1]
    key = (lib, q.device.index, _q_bf16(q), kv, h, kvh, hd, ps, lanes, pps)
    if key not in _RESIDENT:
        out = ctypes.c_int(0)
        _build.check(lib, lib.bravo_paged_attn_residency(
            _q_bf16(q), kv, h, kvh, hd, ps, lanes, pps, ctypes.byref(out)),
            "paged_attention residency")
        _RESIDENT[key] = out.value
    return _RESIDENT[key]


def _q_bf16(q: torch.Tensor) -> int:
    return int(q.dtype == torch.bfloat16)


def _codes(q: torch.Tensor, k_pages: torch.Tensor):
    return _q_bf16(q), int(k_pages.dtype == torch.bfloat16)


def decode_plan(q: torch.Tensor, k_pages: torch.Tensor, lanes: int,
                lib: Optional[ctypes.CDLL] = None,
                knob: Optional[int] = None) -> Tuple[int, int]:
    """The split :func:`paged_attention` and :func:`paged_attention_quant`
    launch on these CUDA operands with ``lanes`` page lanes: -> (number of
    splits, page lanes a split).  The residency is taken at the largest
    split the call can have; a smaller split needs less shared memory, so
    at least as many CTAs fit.  ``knob``: ``min_split_positions``; None
    reads the autotune table (``ops.tuned``) for this card and kernel."""
    from .ops import tuned   # ops imports this module

    b, h = q.shape[0], q.shape[-2]
    ps, kvh = k_pages.shape[1], k_pages.shape[2]
    if knob is None:
        kernel = ("paged_attn_quant" if k_pages.dtype == torch.int8
                  else "paged_attn")
        knob = tuned(kernel, "min_split_positions", q.device.index or 0)
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    resident = decode_residency(q, k_pages, lanes,
                                min(lanes, MAX_SPLIT_PAGES), lib)
    return decode_splits(b, h, kvh, lanes, ps, n_sm, resident, knob)


def _decode(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
            scales, page_idx: torch.Tensor, cache_len: torch.Tensor,
            n_split: Optional[int] = None,
            lib: Optional[ctypes.CDLL] = None) -> torch.Tensor:
    """Launch K5 (``scales`` empty) or K7 (``scales`` = (k_scale,
    v_scale)) on CUDA tensors, counting nothing: the split's partials go to
    two ``torch.empty`` buffers; ``n_split`` overrides
    :func:`decode_splits` (lanes split evenly), ``lib`` the build (as in
    :func:`decode_residency`).  The wrappers call it; the card checks and
    the timing sweep call it to force a split or a build."""
    if lib is None:
        lib = paged_lib()
    b, h, hd = q.shape
    n_pages, ps, kvh, _ = k_pages.shape
    lanes = page_idx.shape[1]
    if n_split is None:
        n_split, pps = decode_plan(q, k_pages, lanes, lib)
    else:
        pps = -(-lanes // n_split) if lanes else 0
        n_split = -(-lanes // pps) if lanes else 1
        _need(pps <= MAX_SPLIT_PAGES,
              f"a split of {pps} page lanes > {MAX_SPLIT_PAGES}")
    out = torch.empty_like(q)
    part = ml = None
    if n_split > 1:
        part = torch.empty((b, h, n_split, hd), dtype=torch.float32,
                           device=q.device)
        ml = torch.empty((b, h, n_split, 2), dtype=torch.float32,
                         device=q.device)
    if b and h:
        entry = "bravo_paged_attn_quant" if scales else "bravo_paged_attn"
        codes = (_q_bf16(q),) if scales else _codes(q, k_pages)
        _build.check(lib, getattr(lib, entry)(
            _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
            *map(_build.ptr, scales), _build.ptr(page_idx),
            _build.ptr(cache_len), _build.ptr(out), _build.ptr(part),
            _build.ptr(ml), b, h, kvh, hd, ps, lanes, n_pages, n_split, pps,
            *codes, _build.stream_ptr(q.device)), entry)
    return out


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_idx: torch.Tensor,
                    cache_len: torch.Tensor) -> torch.Tensor:
    """K5: q (B, H, hd) against k/v_pages (n_pages, ps, KVH, hd) by
    page_idx (B, P) int32 (-1 = unused lane) up to cache_len (B,) int32.
    -> (B, H, hd) in q's dtype; a row with no valid position is zero."""
    if check_args(q, k_pages, v_pages, page_idx, cache_len):
        return R.paged_attn_ref(q, k_pages, v_pages, page_idx, cache_len)
    out = _decode(q, k_pages, v_pages, (), page_idx, cache_len)
    if q.shape[0] and q.shape[1]:
        PAGED_ATTENTION.add()
    return out


def paged_attention_quant(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, page_idx: torch.Tensor,
                          cache_len: torch.Tensor) -> torch.Tensor:
    """K7: K5 over int8 k/v_pages (n_pages, ps, KVH, hd) with float32
    k/v_scale (n_pages, KVH).  -> (B, H, hd) in q's dtype."""
    if check_args(q, k_pages, v_pages, page_idx, cache_len, None, k_scale,
                  v_scale):
        return R.paged_attn_quant_ref(q, k_pages, v_pages, k_scale, v_scale,
                                      page_idx, cache_len)
    out = _decode(q, k_pages, v_pages, (k_scale, v_scale), page_idx,
                  cache_len)
    if q.shape[0] and q.shape[1]:
        PAGED_ATTENTION_QUANT.add()
    return out
