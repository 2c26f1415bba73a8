"""Wrappers for the paged decode attention kernels K5 and K7
(``csrc/paged_attn.cu``).

K5 (``paged_attention``) replaces ``repro.kernels.paged_attn.
_make_paged_attn_kernel(lanes_per_step, quantized=False)``: one query token
per request attends to the KV pool's page store through the request's
page-index vector, never through a dense cache.  K7
(``paged_attention_quant``) replaces the same kernel built with
``quantized=True`` (``_paged_attn_quant_call``): K5 over int8 pages with one
float32 scale per (page, KV head), dequantized in the kernel.  The Pallas
kernel's ``lanes_per_step`` knob (how many page DMAs a TPU grid step keeps
in flight) has no counterpart: the CUDA kernel walks positions in tiles of
32 and every query row is computed on its own.

A CPU tensor takes the plain version (``ref.paged_attn_ref``,
``ref.paged_attn_quant_ref``); a CUDA tensor launches the kernel or raises.
Each launch adds one to :data:`PAGED_ATTENTION` or
:data:`PAGED_ATTENTION_QUANT`.  The kernel goes to PyTorch's current
stream, so a drain poll enqueued after a step runs after that step's
attention.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from . import ref as R
from .table_publish import on_cpu

SOURCE = "paged_attn.cu"
MAX_HD = 128      # a lane holds hd / 32 accumulator entries, at most 4
MAX_WARPS = 16    # warps of one CTA: (query heads per KV head) * columns

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "bravo_paged_attn": [_P] * 6 + [_I] * 9 + [_P],
    "bravo_paged_chunk_attn": [_P] * 7 + [_I] * 11 + [_P],
    "bravo_paged_attn_quant": [_P] * 8 + [_I] * 8 + [_P],
    "bravo_paged_chunk_attn_quant": [_P] * 9 + [_I] * 10 + [_P],
}

PAGED_ATTENTION = _build.LaunchCounter("paged_attention")       # K5
PAGED_ATTENTION_QUANT = _build.LaunchCounter("paged_attention_quant")  # K7

_Q_TYPES = (torch.float32, torch.bfloat16)
_KV_TYPES = (torch.bfloat16, torch.float32)


def paged_lib() -> ctypes.CDLL:
    """The compiled ``paged_attn.cu`` (built at first use)."""
    return _build.load(SOURCE, SIGNATURES)


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
        _need(hd <= MAX_HD, f"head_dim {hd} > {MAX_HD}, the kernel's limit")
        _need(h // kvh <= MAX_WARPS,
              f"{h // kvh} query heads per KV head > {MAX_WARPS}")
    return cpu


def _q_bf16(q: torch.Tensor) -> int:
    return int(q.dtype == torch.bfloat16)


def _codes(q: torch.Tensor, k_pages: torch.Tensor):
    return _q_bf16(q), int(k_pages.dtype == torch.bfloat16)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_idx: torch.Tensor,
                    cache_len: torch.Tensor) -> torch.Tensor:
    """K5: q (B, H, hd) against k/v_pages (n_pages, ps, KVH, hd) by
    page_idx (B, P) int32 (-1 = unused lane) up to cache_len (B,) int32.
    -> (B, H, hd) in q's dtype; a row with no valid position is zero."""
    if check_args(q, k_pages, v_pages, page_idx, cache_len):
        return R.paged_attn_ref(q, k_pages, v_pages, page_idx, cache_len)
    b, h, hd = q.shape
    n_pages, ps, kvh, _ = k_pages.shape
    out = torch.empty_like(q)
    if b and h:
        lib = paged_lib()
        _build.check(lib, lib.bravo_paged_attn(
            _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
            _build.ptr(page_idx), _build.ptr(cache_len), _build.ptr(out),
            b, h, kvh, hd, ps, page_idx.shape[1], n_pages, *_codes(q, k_pages),
            _build.stream_ptr(q.device)), "paged_attention")
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
    b, h, hd = q.shape
    n_pages, ps, kvh, _ = k_pages.shape
    out = torch.empty_like(q)
    if b and h:
        lib = paged_lib()
        _build.check(lib, lib.bravo_paged_attn_quant(
            _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
            _build.ptr(k_scale), _build.ptr(v_scale), _build.ptr(page_idx),
            _build.ptr(cache_len), _build.ptr(out), b, h, kvh, hd, ps,
            page_idx.shape[1], n_pages, _q_bf16(q),
            _build.stream_ptr(q.device)), "paged_attention_quant")
        PAGED_ATTENTION_QUANT.add()
    return out
