"""Decoder transformer blocks in plain PyTorch: GQA attention and the
(gated) MLP, for dense layers.

The port of ``repro.models.transformer``'s dense branches: attention with
no cache (prefill, through :func:`~.common.flash_attention`) and with a
per-request cache (decode, through :func:`~.common.decode_attention`).  The
paged branches (decode and chunk prefill over the KV pool's page store, the
Pallas kernels K5/K6) and the MoE layer come with later slices.  Where JAX
returned a new cache, the decode branch writes the new K/V into the
caller's cache tensors in place and returns them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .common import (ModelConfig, Params, act_fn, apply_rope, decode_attention,
                     dense_init, flash_attention, matmul, rms_norm)


def init_attn(gen: torch.Generator, cfg: ModelConfig, n: int) -> Params:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    dt = cfg.param_dtype
    return {
        "wq": dense_init(gen, (n, d, qd), dt, fan_in=d),
        "wk": dense_init(gen, (n, d, kvd), dt, fan_in=d),
        "wv": dense_init(gen, (n, d, kvd), dt, fan_in=d),
        "wo": dense_init(gen, (n, qd, d), dt, fan_in=qd),
        "ln": torch.zeros((n, d), dtype=dt, device=gen.device),
    }


def init_mlp(gen: torch.Generator, cfg: ModelConfig, n: int,
             d_ff: Optional[int] = None) -> Params:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    dt = cfg.param_dtype
    p = {
        "wi": dense_init(gen, (n, d, ff), dt, fan_in=d),
        "wo": dense_init(gen, (n, ff, d), dt, fan_in=ff),
        "ln": torch.zeros((n, d), dtype=dt, device=gen.device),
    }
    if cfg.glu:
        p["wg"] = dense_init(gen, (n, d, ff), dt, fan_in=d)
    return p


def attn_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 positions: torch.Tensor,
                 cache: Optional[Dict[str, torch.Tensor]] = None,
                 cache_len: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d).  Without ``cache``: causal attention over the S
    positions; returns the new K/V as the cache.  With ``cache`` (decode,
    S == 1, per-request ``cache_len`` of shape (B,)): writes the new K/V at
    ``cache_len - 1`` of each row IN PLACE and attends to the first
    ``cache_len`` positions; returns the same cache tensors."""
    B, S, _ = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = matmul(h, p["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
    k = matmul(h, p["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = matmul(h, p["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if cache is None:
        o = flash_attention(q, k, v, causal=cfg.causal,
                            block_q=cfg.attn_block_q,
                            block_kv=cfg.attn_block_kv)
        new_cache = {"k": k, "v": v}
    else:
        if cache_len is None or cache_len.dim() != 1:
            raise ValueError("decode needs a per-request (B,) cache_len")
        kc, vc = cache["k"], cache["v"]
        rows = torch.arange(B, device=x.device)
        pos = (cache_len - 1).long()
        kc[rows, pos] = k[:, 0].to(kc.dtype)
        vc[rows, pos] = v[:, 0].to(vc.dtype)
        o = decode_attention(q, kc, vc, cache_len)
        new_cache = cache
    out = matmul(o.reshape(B, S, cfg.q_dim), p["wo"])
    return out.to(x.dtype), new_cache


def mlp_forward(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    a = act_fn(cfg.act)(matmul(h, p["wi"]))
    if cfg.glu:
        a = a * matmul(h, p["wg"])
    return matmul(a, p["wo"]).to(x.dtype)


def block_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  positions, cache=None, cache_len=None):
    """One dense block -> (x', aux loss, cache'); a dense block has no
    auxiliary loss, so it is the float 0.0."""
    a, new_cache = attn_forward(p["attn"], x, cfg, positions=positions,
                                cache=cache, cache_len=cache_len)
    x = x + a
    return x + mlp_forward(p["mlp"], x, cfg), 0.0, new_cache
