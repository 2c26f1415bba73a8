"""Wrappers for the chunk-prefill attention kernels K6 and K8
(``csrc/paged_attn.cu``).

K6 (``paged_chunk_attention``) replaces ``repro.kernels.paged_chunk_attn.
_make_chunk_attn_kernel(False)``: right-aligned prompt chunks attend
causally to the already-paged prefix and to their own K/V, read from the
page store in place; padding columns come out zero.  K8
(``paged_chunk_attention_quant``) replaces ``_make_chunk_attn_kernel(True)``
(``_chunk_attn_quant_call``): K6 over int8 pages with float32 per-(page, KV
head) scales, dequantized in the kernel.  The Pallas kernel's q-block height
(its tuning knob ``block_q``) is not part of the result (every query row is
computed on its own); its counterpart is the autotune table's ``pairs``.
The CUDA kernel takes a block of (column, query head) pairs of one KV head
a CTA (:func:`chunk_pairs`), computes on the tensor cores, splits the page
lanes over the grid (:func:`chunk_splits`, from host shapes alone) and
merges the splits' partial softmax states in a second pass; both passes
count as one launch.

A CPU tensor takes the plain version (``ref.paged_chunk_attn_ref``,
``ref.paged_chunk_attn_quant_ref``); a CUDA tensor launches the kernel or
raises.  Each launch adds one to :data:`PAGED_CHUNK_ATTENTION` or
:data:`PAGED_CHUNK_ATTENTION_QUANT`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from . import ref as R
from .paged_attn import _codes, _need, _q_bf16, check_args, paged_lib

PAGED_CHUNK_ATTENTION = _build.LaunchCounter("paged_chunk_attention")  # K6
PAGED_CHUNK_ATTENTION_QUANT = _build.LaunchCounter(
    "paged_chunk_attention_quant")                                     # K8

CHUNK_PAIRS = 64    # (column, query head) pairs of one CTA: 4 warps x 16
WIDE_PAIRS = 128    # at PAIRS_HD: 8 warps, two warpgroups on one tile
SMALL_PAIRS = 16    # at PAIRS_HD, short rows on a short grid: 4 warps
#                     along each tile's positions
PAIRS_HD = (33, 64)  # the head_dims padded to 64, which have both layouts
# a split is worth a CTA from this many positions (eight tiles of 64): at
# 2 rows x 32 columns on 4096 positions of lanes, 8 splits of 512 ran 4%
# faster than 12 of ~340 and 30% faster than 16 of 256 (chunk_sweep on an
# H100, bf16 and int8 pages)
MIN_CHUNK_SPLIT_POSITIONS = 512
# the autotune knob ``pairs`` (``kernels/autotune.py``): 0 is chunk_pairs'
# own choice; SMALL_PAIRS and WIDE_PAIRS are built only for PAIRS_HD, and
# CHUNK_PAIRS only outside it
PAIRS_CANDIDATES = (0, SMALL_PAIRS, CHUNK_PAIRS, WIDE_PAIRS)


def pair_blocks(s: int, h: int, kvh: int, pairs: int = CHUNK_PAIRS) -> int:
    """CTAs a KV head's chunk takes: its ``s * (h // kvh)`` (column, query
    head) pairs in blocks of ``pairs``."""
    return -(-s * (h // kvh) // pairs)


def chunk_pairs(b: int, s: int, h: int, kvh: int, hd: int, lanes: int,
                ps: int, n_sm: int, knob: int = 0) -> int:
    """(column, query head) pairs of one CTA, from host shapes alone.
    :data:`CHUNK_PAIRS` outside :data:`PAIRS_HD`.  Within it
    :data:`WIDE_PAIRS`, whose two warpgroups share each staged K/V tile
    (half the tiles :data:`CHUNK_PAIRS` would stage), unless the rows are
    too short to split (fewer than two splits of
    ``MIN_CHUNK_SPLIT_POSITIONS``) and the grid would leave SMs idle: then
    :data:`SMALL_PAIRS`, whose four warps each take a quarter of every
    tile, so that a tile's products spread over an SM's four schedulers and
    over eight times the SMs (the engine's prefill tick).  ``knob`` (the
    autotune table's ``pairs``) overrides that choice where the kernel is
    built for it; 0, a value outside :data:`PAIRS_CANDIDATES` or a layout
    not built at this ``hd`` leaves it."""
    lo, hi = PAIRS_HD
    if not lo <= hd <= hi:
        return CHUNK_PAIRS
    if knob in (SMALL_PAIRS, WIDE_PAIRS):
        return knob
    short = lanes * ps < 2 * MIN_CHUNK_SPLIT_POSITIONS
    if short and b * kvh * pair_blocks(s, h, kvh, WIDE_PAIRS) < n_sm:
        return SMALL_PAIRS
    return WIDE_PAIRS


def chunk_splits(b: int, s: int, h: int, kvh: int, lanes: int, ps: int,
                 n_sm: int, resident: int,
                 pairs: int = CHUNK_PAIRS) -> Tuple[int, int]:
    """K6/K8's KV split, from host shapes alone (never from ``cache_len``'s
    values, so a call moves nothing between host and device): -> (number
    of splits, page lanes per split).  One split's grid is ``b * kvh *
    pair_blocks`` CTAs of ``pairs`` pairs; the splits fill one wave of
    ``resident`` CTAs on each of ``n_sm`` SMs, as long as each split keeps
    ``MIN_CHUNK_SPLIT_POSITIONS`` positions.  One split runs no second
    pass."""
    if lanes <= 0:
        return 1, 0
    ctas = b * kvh * pair_blocks(s, h, kvh, pairs)
    wave = max(1, resident * n_sm // max(1, ctas))
    most = lanes * ps // MIN_CHUNK_SPLIT_POSITIONS
    n = max(1, min(wave, most, lanes))
    pps = -(-lanes // n)
    return -(-lanes // pps), pps


_RESIDENT = {}


def chunk_residency(q: torch.Tensor, k_pages: torch.Tensor, pairs: int,
                    lib: Optional[ctypes.CDLL] = None) -> Tuple[int, int]:
    """(CTAs of the chunk kernel one SM holds at once, shared memory bytes
    a CTA) for these operands' q type, page type and head_dim and
    ``pairs`` pairs a CTA, from the CUDA occupancy calculator: a host
    query, cached."""
    if lib is None:
        lib = paged_lib()
    kv = 2 if k_pages.dtype == torch.int8 else _codes(q, k_pages)[1]
    hd = q.shape[-1]
    key = (lib, q.device.index, _q_bf16(q), kv, hd, pairs)
    if key not in _RESIDENT:
        n, smem = ctypes.c_int(0), ctypes.c_int(0)
        _build.check(lib, lib.bravo_paged_chunk_attn_residency(
            _q_bf16(q), kv, hd, pairs, ctypes.byref(n), ctypes.byref(smem)),
            "paged_chunk_attention residency")
        _RESIDENT[key] = (n.value, smem.value)
    return _RESIDENT[key]


def _tuned_pairs(q: torch.Tensor, k_pages: torch.Tensor) -> int:
    """The autotune table's ``pairs`` for this card and kernel (K6 or K8)."""
    from .ops import tuned   # ops imports this module

    kernel = ("paged_chunk_attn_quant" if k_pages.dtype == torch.int8
              else "paged_chunk_attn")
    return tuned(kernel, "pairs", q.device.index or 0)


def chunk_plan(q: torch.Tensor, k_pages: torch.Tensor, lanes: int,
               lib: Optional[ctypes.CDLL] = None,
               knob: Optional[int] = None) -> Tuple[int, int, int]:
    """The layout and split :func:`paged_chunk_attention` and
    :func:`paged_chunk_attention_quant` launch on these CUDA operands with
    ``lanes`` page lanes: -> (pairs a CTA, number of splits, page lanes a
    split).  ``knob``: ``pairs``; None reads the autotune table
    (``ops.tuned``) for this card and kernel."""
    b, s, h, hd = q.shape
    ps, kvh = k_pages.shape[1], k_pages.shape[2]
    if knob is None:
        knob = _tuned_pairs(q, k_pages)
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    pairs = chunk_pairs(b, s, h, kvh, hd, lanes, ps, n_sm, knob)
    resident, _ = chunk_residency(q, k_pages, pairs, lib)
    return (pairs,) + chunk_splits(b, s, h, kvh, lanes, ps, n_sm, resident,
                                   pairs)


def _chunk(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
           scales, page_idx: torch.Tensor, cache_len: torch.Tensor,
           new_lens: torch.Tensor, n_split: Optional[int] = None,
           lib: Optional[ctypes.CDLL] = None,
           pairs: Optional[int] = None) -> torch.Tensor:
    """Launch K6 (``scales`` empty) or K8 (``scales`` = (k_scale,
    v_scale)) on CUDA tensors, counting nothing: the split's partials go to
    two ``torch.empty`` buffers; ``n_split`` overrides :func:`chunk_splits`
    (lanes split evenly) and ``pairs`` :func:`chunk_pairs`, ``lib`` the
    build (``paged_attn.parent_lib()`` runs the parent design, which takes
    neither: give it ``n_split=1``).  The wrappers call it; the card checks
    and timings call it to force a split, a layout or a build."""
    if lib is None:
        lib = paged_lib()
    b, s, h, hd = q.shape
    n_pages, ps, kvh, _ = k_pages.shape
    lanes = page_idx.shape[1]
    if n_split is None:
        plan, n_split, pps = chunk_plan(q, k_pages, lanes, lib)
        pairs = pairs or plan
    else:
        _need(n_split >= 1, f"n_split {n_split} < 1")
        pps = -(-lanes // n_split) if lanes else 0
        n_split = -(-lanes // pps) if lanes else 1
        if pairs is None:
            n_sm = torch.cuda.get_device_properties(
                q.device).multi_processor_count
            pairs = chunk_pairs(b, s, h, kvh, hd, lanes, ps, n_sm,
                                _tuned_pairs(q, k_pages))
    out = torch.empty_like(q)
    part = ml = None
    if n_split > 1:
        part = torch.empty((b, s, h, n_split, hd), dtype=torch.float32,
                           device=q.device)
        ml = torch.empty((b, s, h, n_split, 2), dtype=torch.float32,
                         device=q.device)
    if b and s and h:
        entry = ("bravo_paged_chunk_attn_quant" if scales
                 else "bravo_paged_chunk_attn")
        codes = (_q_bf16(q),) if scales else _codes(q, k_pages)
        _build.check(lib, getattr(lib, entry)(
            _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
            *map(_build.ptr, scales), _build.ptr(page_idx),
            _build.ptr(cache_len), _build.ptr(new_lens), _build.ptr(out),
            _build.ptr(part), _build.ptr(ml), b, s, h, kvh, hd, ps, lanes,
            n_pages, n_split, pps, pairs, *codes,
            _build.stream_ptr(q.device)), entry)
    return out


def paged_chunk_attention(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_idx: torch.Tensor,
                          cache_len: torch.Tensor,
                          new_lens: torch.Tensor) -> torch.Tensor:
    """K6: q (B, S, H, hd) right-aligned chunks against k/v_pages (n_pages,
    ps, KVH, hd) by page_idx (B, P) int32; cache_len (B,) int32 is the length
    AFTER the chunk, new_lens (B,) int32 the valid trailing columns.
    -> (B, S, H, hd) in q's dtype, padding columns zero."""
    if check_args(q, k_pages, v_pages, page_idx, cache_len, new_lens):
        return R.paged_chunk_attn_ref(q, k_pages, v_pages, page_idx,
                                      cache_len, new_lens)
    out = _chunk(q, k_pages, v_pages, (), page_idx, cache_len, new_lens)
    if q.shape[0] and q.shape[1] and q.shape[2]:
        PAGED_CHUNK_ATTENTION.add()
    return out


def paged_chunk_attention_quant(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, k_scale: torch.Tensor,
                                v_scale: torch.Tensor, page_idx: torch.Tensor,
                                cache_len: torch.Tensor,
                                new_lens: torch.Tensor) -> torch.Tensor:
    """K8: K6 over int8 k/v_pages (n_pages, ps, KVH, hd) with float32
    k/v_scale (n_pages, KVH).  -> (B, S, H, hd) in q's dtype, padding
    columns zero."""
    if check_args(q, k_pages, v_pages, page_idx, cache_len, new_lens,
                  k_scale, v_scale):
        return R.paged_chunk_attn_quant_ref(q, k_pages, v_pages, k_scale,
                                            v_scale, page_idx, cache_len,
                                            new_lens)
    out = _chunk(q, k_pages, v_pages, (k_scale, v_scale), page_idx,
                 cache_len, new_lens)
    if q.shape[0] and q.shape[1] and q.shape[2]:
        PAGED_CHUNK_ATTENTION_QUANT.add()
    return out
