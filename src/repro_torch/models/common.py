"""Shared model building blocks in plain PyTorch: the config dataclass,
norms, RoPE, blockwise attention and parameter init.

Each function mirrors its ``repro.models.common`` counterpart operation by
operation, including JAX's dtype promotion (a bf16 activation times a
float32 weight computes in float32), so the two agree to rounding.
Parameters are nested dicts of tensors whose layer stacks carry a leading
``L`` dimension, as in ``repro``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

Params = dict


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | vlm (others: later slices)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    act: str = "silu"             # silu | gelu | relu
    glu: bool = True              # gated MLP (SwiGLU / GeGLU)
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    use_rope: bool = True
    causal: bool = True
    tie_embeddings: bool = False
    # --- frontend stubs ---
    frontend: str = ""            # "" | "vision_stub"
    frontend_tokens: int = 0      # prompt prefix length fed as embeddings
    # --- numerics ---
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    # --- attention impl ---
    attn_block_q: int = 512
    attn_block_kv: int = 1024

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the promoted dtype of the two, as ``jnp.matmul``."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + scale)).to(x.dtype)


def act_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., :, None, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Blockwise ("flash") attention, O(block_q * block_kv) memory per head
# ---------------------------------------------------------------------------


def _pad_to(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    pad = size - x.shape[dim]
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, block_q: int = 512, block_kv: int = 1024,
                    q_offset: int = 0) -> torch.Tensor:
    """Online-softmax blockwise attention, as ``repro``'s.

    q: (B, Sq, H, hd); k/v: (B, Skv, KVH, hd) with H % KVH == 0.
    ``q_offset`` is the absolute position of q[0].  -> (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    _, Skv, KVH, _ = k.shape
    g = H // KVH
    scale = 1.0 / math.sqrt(hd)
    block_q = min(block_q, Sq)
    block_kv = min(block_kv, Skv)
    nq = (Sq + block_q - 1) // block_q
    nkv = (Skv + block_kv - 1) // block_kv
    q = _pad_to(q, 1, nq * block_q)
    k = _pad_to(k, 1, nkv * block_kv)
    v = _pad_to(v, 1, nkv * block_kv)
    dev = q.device
    outs = []
    for qi in range(nq):
        qb = q[:, qi * block_q:(qi + 1) * block_q]               # (B,bq,H,hd)
        qp = q_offset + qi * block_q + torch.arange(block_q, device=dev)
        m = torch.full((B, H, block_q), -math.inf, device=dev)
        den = torch.zeros((B, H, block_q), device=dev)
        acc = torch.zeros((B, H, block_q, hd), device=dev)
        for ki in range(nkv):
            sl = slice(ki * block_kv, (ki + 1) * block_kv)
            kig = k[:, sl].repeat_interleave(g, dim=2)
            vig = v[:, sl].repeat_interleave(g, dim=2)
            kp = ki * block_kv + torch.arange(block_kv, device=dev)
            s = torch.einsum("bqhd,bkhd->bhqk", qb.float(),
                             kig.float()) * scale
            mask = (kp < Skv)[None, None, None, :]
            if causal:
                mask = mask & (kp[None, None, None, :]
                               <= qp[None, None, :, None])
            s = torch.where(mask, s, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(mask, p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            den = den * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vig.float())
            m = m_new
        out = acc / torch.clamp(den, min=1e-20)[..., None]
        outs.append(out.transpose(1, 2).to(q.dtype))             # (B,bq,H,hd)
    return torch.cat(outs, dim=1)[:, :Sq]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """Single-token attention against a cache.

    q: (B, 1, H, hd); caches: (B, S, KVH, hd); cache_len: (B,) valid
    lengths (the new token's K/V already written at cache_len - 1)."""
    B, S, KVH, hd = k_cache.shape
    H = q.shape[2]
    g = H // KVH
    scale = 1.0 / math.sqrt(hd)
    qh = q[:, 0].reshape(B, KVH, g, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qh.float(), k_cache.float()) * scale
    pos = torch.arange(S, device=q.device)
    mask = (pos[None, :] < cache_len[:, None])[:, None, None, :]
    s = torch.where(mask, s, -math.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape: Tuple[int, ...], dtype,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """Normal(0, 1/fan_in) in float32, cast to ``dtype``, drawn from
    ``gen`` on the generator's device."""
    fan_in = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 \
        else shape[-1]
    std = 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * std).to(dtype)
