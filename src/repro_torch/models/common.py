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
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
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
    # --- MoE ---
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1            # every k-th layer is MoE (llama4: 2)
    moe_shared_expert: bool = False
    moe_d_ff: int = 0             # 0 -> d_ff
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_kind: str = ""            # "rwkv6" | "mamba2"
    ssm_state: int = 0            # mamba2 d_state / rwkv head size
    ssm_expand: int = 2           # mamba2 expansion
    hybrid_attn_every: int = 0    # zamba2: shared attn block every k layers
    # --- frontend stubs ---
    frontend: str = ""            # "" | "vision_stub" | "audio_stub"
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

    def num_params(self) -> int:
        """Parameter count, from the shapes ``init_params`` makes on the
        meta device (nothing is allocated or drawn)."""
        from . import model as _model
        return int(sum(x.numel() for x in _model.leaves(
            _model.init_params(0, self, device="meta"))))

    def num_active_params(self) -> int:
        """Active parameters per token (MoE: only routed-to experts)."""
        total = self.num_params()
        if not self.moe_experts:
            return total
        # subtract inactive expert params
        d_ff = self.moe_d_ff or self.d_ff
        n_mats = 3 if self.glu else 2
        per_expert = n_mats * self.d_model * d_ff
        n_moe_layers = len([i for i in range(self.n_layers)
                            if (i % self.moe_every) == self.moe_every - 1])
        inactive = n_moe_layers * (self.moe_experts - self.moe_top_k) \
            * per_expert
        return int(total - inactive)


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
    ``q_offset`` (>= 0) is the absolute position of q[0].  -> (B, Sq, H,
    hd).

    The same values as ``repro``'s, with less work where it is exact to
    leave it out.  Key 0 lies in each row's first block and every query
    sees it, so every running max is finite from the first block on:
    ``repro``'s guards against an all-masked row never fire, and its
    first block's correction multiplies zeros.  A causal block whose keys
    all follow its queries adds 0 to each sum and multiplies them by
    exp(0) = 1, so it is skipped; a block that masks nothing takes no
    ``where``; a masked score's exp is already 0; one query head a KV
    head repeats nothing.  Autograd launches every operation left, so on
    the card these decide a training step's host time."""
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
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
    kps = [ki * block_kv + torch.arange(block_kv, device=dev)
           for ki in range(nkv)]
    outs = []
    for qi in range(nq):
        qb = q[:, qi * block_q:(qi + 1) * block_q]               # (B,bq,H,hd)
        q_lo = q_offset + qi * block_q
        qp = q_lo + torch.arange(block_q, device=dev)
        m = den = acc = None
        for ki in range(nkv):
            k_lo, k_hi = ki * block_kv, (ki + 1) * block_kv - 1
            if causal and ki and k_lo > q_lo + block_q - 1:
                continue
            sl = slice(k_lo, k_hi + 1)
            kig, vig = k[:, sl], v[:, sl]
            if g > 1:
                kig = kig.repeat_interleave(g, dim=2)
                vig = vig.repeat_interleave(g, dim=2)
            kp = kps[ki]
            s = torch.einsum("bqhd,bkhd->bhqk", qb.float(),
                             kig.float()) * scale
            mask = None
            if k_hi >= Skv:
                mask = (kp < Skv)[None, None, None, :]
            if causal and k_hi > q_lo:
                below = kp[None, None, None, :] <= qp[None, None, :, None]
                mask = below if mask is None else mask & below
            if mask is not None:
                s = torch.where(mask, s, -math.inf)
            m_new = s.amax(dim=-1) if m is None \
                else torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            pv = torch.einsum("bhqk,bkhd->bhqd", p, vig.float())
            if m is None:
                den, acc = p.sum(dim=-1), pv
            else:
                corr = torch.exp(m - m_new)
                den = den * corr + p.sum(dim=-1)
                acc = acc * corr[..., None] + pv
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


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, cache_len: torch.Tensor,
                             offset: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """:func:`decode_attention` over one slice of a cache's sequence, left
    unnormalised so that the slices combine: the slice holds positions
    ``offset .. offset + S - 1`` of the whole cache.

    q: (B, 1, H, hd); caches: (B, S, KVH, hd); cache_len: (B,) valid
    lengths of the WHOLE cache.  -> float32 ``(o, m, l)``: per query head
    (B, KVH, g, ...) the row max ``m`` of the scaled scores over the
    slice's valid positions, ``l`` the sum of their ``exp(s - m)`` and
    ``o`` the sum of ``exp(s - m) v``.  A row with no valid position in
    the slice gives ``m = -inf`` and exactly zero ``l`` and ``o``.  The
    softmax over the whole cache is ``sum_i exp(m_i - M) o_i / sum_i
    exp(m_i - M) l_i`` with ``M = max_i m_i``."""
    B, S, KVH, hd = k_cache.shape
    H = q.shape[2]
    g = H // KVH
    scale = 1.0 / math.sqrt(hd)
    qh = q[:, 0].reshape(B, KVH, g, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qh.float(), k_cache.float()) * scale
    pos = offset + torch.arange(S, device=q.device)
    mask = (pos[None, :] < cache_len[:, None])[:, None, None, :]
    s = torch.where(mask, s, -math.inf)
    m = s.amax(dim=-1)
    # an empty row's max is -inf: subtract 0 there, so exp(-inf) = 0
    p = torch.exp(s - torch.where(m == -math.inf, 0.0, m)[..., None])
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o, m, p.sum(dim=-1)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


class ShapeOnly:
    """The generator of a parameter tree on the meta device: the init
    functions read its ``device`` and :func:`dense_init` draws nothing."""
    device = torch.device("meta")


def dense_init(gen: torch.Generator, shape: Tuple[int, ...], dtype,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """Normal(0, 1/fan_in) in float32, cast to ``dtype``, drawn from
    ``gen`` on the generator's device.  A ``dtype`` other than float32 is
    drawn one trailing matrix at a time, so the float32 draw of a large
    expert stack never exists whole."""
    fan_in = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 \
        else shape[-1]
    std = 1.0 / math.sqrt(fan_in)
    dev = gen.device
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    if dtype == torch.float32 or len(shape) <= 2:
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return (x * std).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=dev)
    for m in out.view(-1, *shape[-2:]):
        m.copy_(torch.randn(shape[-2:], generator=gen, dtype=torch.float32,
                            device=dev) * std)
    return out
