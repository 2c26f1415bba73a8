"""Int8 page quantization for the quantized page store of the KV pool.

The port of ``repro.kernels.quant``.  Pool pages store K/V as **int8 with
one float32 scale per (page, KV head)**, symmetric absmax quantization:
``scale = max(amax, 1e-6) / 127`` and ``q = clip(round(x / scale), -127,
127)``.  The paged attention kernels K7/K8 dequantize inside the kernel
while they stage a tile, so the serving path never holds a float copy of
the pool.

Page byte layout:

* content: ``(page_size, KVH, hd) int8`` per page per layer, half the
  bytes of the bf16 store;
* scale: ``(KVH,) float32`` per page per layer, a leaf of the page store
  beside the content (``{"k", "v", "k_scale", "v_scale"}``), so the engine's
  copy-on-write page copy moves content and scale together.

Write path: :func:`requant_scatter` merges a step's fresh K/V into the
touched pages: dequantize each touched page, zero every slot at and after
``cache_len`` (a reallocated page's scale depends only on its own tokens,
never on stale bytes of its previous owner), scatter the new rows,
re-quantize, write back.  Only pages holding a NEW token are touched, so a
shared prefix page is never rewritten.

Everything here is plain PyTorch and bit-exact with ``repro``: the same op
order (cast to float32, then one broadcast multiply), float32 division
(correctly rounded on both sides) and round half to even.  Where ``repro``
drops out-of-range writes with ``mode="drop"``, the port aims them at the
store's sink page (``models.transformer.with_sink``) and at one extra lane
of its staging buffer, so nothing synchronizes with the host.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["QUANT_EPS", "quantize_pages", "dequantize_pages",
           "requant_scatter", "quant_layout_tag"]

# floor for the absmax so an all-zero page still gets a well-defined,
# deterministic scale (dequantizes to exact zeros either way)
QUANT_EPS = 1e-6


def quantize_pages(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 quantization over the (slot, hd) axes.

    x: ``(..., page_size, KVH, hd)`` float -> ``(int8 same shape, float32
    scales (..., KVH))``.  The group max maps to exactly +-127, so a
    quantize -> dequantize -> quantize round trip is bit-stable."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-3, -1))
    # a tensor divisor: on CUDA, PyTorch turns division by a Python scalar
    # into a multiply by its reciprocal, which rounds differently
    scale = torch.clamp(amax, min=QUANT_EPS) / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / scale[..., None, :, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_pages(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_pages`: ``q (..., ps, KVH, hd) int8``
    with ``scale (..., KVH)`` -> float32, cast then one broadcast multiply
    (the op order of the kernels and the plain versions)."""
    return q.float() * scale[..., None, :, None]


def requant_scatter(kq: torch.Tensor, vq: torch.Tensor, ks: torch.Tensor,
                    vs: torch.Tensor, k_new: torch.Tensor,
                    v_new: torch.Tensor, pages: torch.Tensor,
                    cache_len: torch.Tensor,
                    new_lens: Optional[torch.Tensor] = None):
    """Merge a step's fresh K/V into one layer of the quantized page store,
    IN PLACE.

    kq/vq: ``(n_pages, ps, KVH, hd) int8`` and ks/vs: ``(n_pages, KVH)``
    float32, each with a sink page behind it (``init_paged_caches``);
    k_new/v_new: ``(B, S, KVH, hd)`` right-aligned chunks (row i's last
    ``new_lens[i]`` columns are real); pages: ``(B, n_lanes)`` int32;
    cache_len: ``(B,)`` valid length AFTER the chunk.  -> (kq, vq, ks, vs),
    the same tensors.

    The touched window of a row is ``n_touch`` lanes from the first lane
    holding a new token; shared prefix pages lie below it and are never
    read or written.  A lane outside the row's pages (-1, past
    ``cache_len`` or past the lanes) writes to the sink page; a column
    that is padding, or whose position lies outside the window, writes to
    the staging buffer's extra lane, which is never written back."""
    from ..models.transformer import with_sink

    n_pages, ps = kq.shape[0], kq.shape[1]
    b, s = k_new.shape[:2]
    dev = k_new.device
    n_lanes = pages.shape[1]
    clen = cache_len.long()
    nl = (new_lens.long() if new_lens is not None
          else torch.full((b,), s, dtype=torch.long, device=dev))
    n_touch = min((s + ps - 2) // ps + 1, n_lanes)

    lo = torch.clamp(torch.div(clen - nl, ps, rounding_mode="floor"), 0,
                     n_lanes - 1)                                   # (B,)
    lanes = lo[:, None] + torch.arange(n_touch, device=dev)[None, :]
    lane_ok = (lanes < n_lanes) & (lanes * ps < clen[:, None])
    pg = torch.gather(pages.long(), 1, torch.clamp(lanes, 0, n_lanes - 1))
    pg = torch.where(lane_ok & (pg >= 0), pg, n_pages)            # -> sink
    safe = torch.clamp(pg, 0, n_pages - 1)

    def staged(q, sc):
        # (B, n_touch + 1, ps, KVH, hd): the last lane takes dropped rows
        buf = dequantize_pages(q[safe], sc[safe])
        pos = lanes[:, :, None] * ps + torch.arange(ps, device=dev)
        keep = (pos < clen[:, None, None])[..., None, None]
        buf = torch.where(keep, buf, 0.0)
        return torch.cat([buf, torch.zeros_like(buf[:, :1])], dim=1)

    kbuf, vbuf = staged(kq, ks), staged(vq, vs)
    cols = torch.arange(s, device=dev)
    t_new = clen[:, None] - s + cols[None, :]                      # (B, S)
    ok = (t_new >= 0) & (cols[None, :] >= s - nl[:, None])
    rel = torch.div(t_new, ps, rounding_mode="floor") - lo[:, None]
    rel = torch.where(ok & (rel < n_touch), rel, n_touch)  # -> extra lane
    off = torch.where(ok, torch.remainder(t_new, ps), 0)
    bidx = torch.arange(b, device=dev)[:, None].expand(b, s)
    kbuf[bidx, rel, off] = k_new.float()
    vbuf[bidx, rel, off] = v_new.float()

    for q, sc, buf in ((kq, ks, kbuf), (vq, vs, vbuf)):
        q2, s2 = quantize_pages(buf[:, :n_touch])
        with_sink(q)[pg] = q2
        with_sink(sc)[pg] = s2
    return kq, vq, ks, vs


def quant_layout_tag(page_size: int, kvh: int, hd: int) -> int:
    """Deterministic tag for the quantized page byte layout, mixed into
    the prefix-cache key chain (``kv_pool.page_keys``) so a quantized
    page's key never aliases an entry of another layout.  0 is reserved
    for the unquantized store."""
    return (1 << 48) | (page_size << 32) | (kvh << 16) | hd
