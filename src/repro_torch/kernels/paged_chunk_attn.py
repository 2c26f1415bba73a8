"""Wrappers for the chunk-prefill attention kernels K6 and K8
(``csrc/paged_attn.cu``).

K6 (``paged_chunk_attention``) replaces ``repro.kernels.paged_chunk_attn.
_make_chunk_attn_kernel(False)``: right-aligned prompt chunks attend
causally to the already-paged prefix and to their own K/V, read from the
page store in place; padding columns come out zero.  K8
(``paged_chunk_attention_quant``) replaces ``_make_chunk_attn_kernel(True)``
(``_chunk_attn_quant_call``): K6 over int8 pages with float32 per-(page, KV
head) scales, dequantized in the kernel.  The Pallas kernel's
q-block height is not part of the result (every query row is computed on its
own); the CUDA kernel takes as many chunk columns per CTA as fit in 16 warps
at one warp per (column, query head).

A CPU tensor takes the plain version (``ref.paged_chunk_attn_ref``,
``ref.paged_chunk_attn_quant_ref``); a CUDA tensor launches the kernel or
raises.  Each launch adds one to :data:`PAGED_CHUNK_ATTENTION` or
:data:`PAGED_CHUNK_ATTENTION_QUANT`.
"""

from __future__ import annotations

import torch

from . import _build
from . import ref as R
from .paged_attn import MAX_WARPS, _codes, _q_bf16, check_args, paged_lib

PAGED_CHUNK_ATTENTION = _build.LaunchCounter("paged_chunk_attention")  # K6
PAGED_CHUNK_ATTENTION_QUANT = _build.LaunchCounter(
    "paged_chunk_attention_quant")                                     # K8


def _cols_per_cta(s: int, h: int, kvh: int) -> int:
    """Chunk columns per CTA: as many as fit in 16 warps at one warp per
    (column, query head)."""
    return max(1, min(s, MAX_WARPS // (h // kvh)))


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
    b, s, h, hd = q.shape
    n_pages, ps, kvh, _ = k_pages.shape
    qb = _cols_per_cta(s, h, kvh)
    out = torch.empty_like(q)
    if b and s and h:
        lib = paged_lib()
        _build.check(lib, lib.bravo_paged_chunk_attn(
            _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
            _build.ptr(page_idx), _build.ptr(cache_len), _build.ptr(new_lens),
            _build.ptr(out), b, s, h, kvh, hd, ps, page_idx.shape[1], n_pages,
            qb, *_codes(q, k_pages), _build.stream_ptr(q.device)),
            "paged_chunk_attention")
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
    b, s, h, hd = q.shape
    n_pages, ps, kvh, _ = k_pages.shape
    out = torch.empty_like(q)
    if b and s and h:
        lib = paged_lib()
        _build.check(lib, lib.bravo_paged_chunk_attn_quant(
            _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
            _build.ptr(k_scale), _build.ptr(v_scale), _build.ptr(page_idx),
            _build.ptr(cache_len), _build.ptr(new_lens), _build.ptr(out), b,
            s, h, kvh, hd, ps, page_idx.shape[1], n_pages,
            _cols_per_cta(s, h, kvh), _q_bf16(q),
            _build.stream_ptr(q.device)), "paged_chunk_attention_quant")
        PAGED_CHUNK_ATTENTION_QUANT.add()
    return out
