"""Decoder transformer blocks in plain PyTorch: GQA attention, the
(gated) MLP and the mixture-of-experts layer.

The port of ``repro.models.transformer`` on one device: attention with no
cache (prefill, through :func:`~.common.flash_attention`), with a
per-request cache (decode, through :func:`~.common.decode_attention`) and
over the KV pool's page store (the scheduler's data plane, through the
kernels K5 and K6, or K7 and K8 over the quantized page store); the MoE
layer's two bodies at one model shard, where ``repro``'s all-to-alls and
reductions over the mesh are the identity.  Where JAX returned a new
cache, the cached branches write the new K/V into the caller's cache
tensors in place and return them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..kernels import ops as K
from ..kernels.quant import requant_scatter
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


def init_moe(gen: torch.Generator, cfg: ModelConfig, n: int) -> Params:
    d, e = cfg.d_model, cfg.moe_experts
    ff = cfg.moe_d_ff or cfg.d_ff
    dt = cfg.param_dtype
    p = {
        "router": dense_init(gen, (n, d, e), dt, fan_in=d),
        "wi": dense_init(gen, (n, e, d, ff), dt, fan_in=d),
        "wo": dense_init(gen, (n, e, ff, d), dt, fan_in=ff),
        "ln": torch.zeros((n, d), dtype=dt, device=gen.device),
    }
    if cfg.glu:
        p["wg"] = dense_init(gen, (n, e, d, ff), dt, fan_in=d)
    if cfg.moe_shared_expert:
        p["shared"] = init_mlp(gen, cfg, n, d_ff=ff)
    return p


def with_sink(pages: torch.Tensor) -> torch.Tensor:
    """The view of one layer's page store ``(n_pages, ps, KVH, hd)`` (or
    of its scales, ``(n_pages, KVH)``) that also reaches the sink page
    ``n_pages`` behind it.

    ``repro`` drops the K/V of invalid chunk columns with a scatter in
    ``mode="drop"`` aimed at page ``n_pages``.  PyTorch's indexed store
    raises on an index out of range, and selecting the valid columns with
    a boolean mask calls ``nonzero``, which waits for the device.  So the
    store from :func:`~.model.init_paged_caches` keeps one sink page per
    layer past the pages it shows, which the pool never allocates and no
    attention reads: invalid columns are written there, and the decode
    tick never synchronizes with the host."""
    n_pages = pages.shape[0]
    shape = (n_pages + 1,) + tuple(pages.shape[1:])
    need = (pages.storage_offset() + (n_pages + 1) * pages[0].numel()) \
        * pages.element_size()
    if not pages.is_contiguous() \
            or pages.untyped_storage().nbytes() < need:
        raise ValueError("paged attention needs a page store with a sink "
                         "page: make it with models.model.init_paged_caches")
    return pages.as_strided(shape, pages.stride(), pages.storage_offset())


def _paged_attn_quant(q, k, v, cache, pages, cache_len, new_lens):
    """The quantized data plane: merge the chunk's K/V into the touched
    int8 pages in place (``requant_scatter``: dequantize, scatter,
    re-quantize; shared prefix pages lie below the touched window and are
    never rewritten), then attend by page index with the dequantization in
    the kernel — K7 for one decode token, K8 for a chunk."""
    B, S = q.shape[:2]
    kc, vc, ksc, vsc = requant_scatter(
        cache["k"], cache["v"], cache["k_scale"], cache["v_scale"], k, v,
        pages, cache_len, new_lens)
    if S == 1 and new_lens is None:
        return K.paged_attention_quant(q[:, 0].contiguous(), kc, vc, ksc, vsc,
                                       pages, cache_len)[:, None]
    nl = new_lens if new_lens is not None \
        else torch.full((B,), S, dtype=torch.int32, device=q.device)
    return K.paged_chunk_attention_quant(q.contiguous(), kc, vc, ksc, vsc,
                                         pages, cache_len, nl)


def _paged_attn(q, k, v, cache, pages, cache_len, new_lens):
    """The paged data plane: scatter the chunk's K/V into the page store in
    place (invalid columns to the sink page), then attend by page index —
    S == 1 with no ``new_lens`` through K5, anything else through K6."""
    B, S = q.shape[:2]
    kc, vc = cache["k"], cache["v"]
    n_pages, ps = kc.shape[0], kc.shape[1]
    n_lanes = pages.shape[1]
    dev = q.device
    cols = torch.arange(S, device=dev)
    t_new = cache_len.long()[:, None] - S + cols[None, :]           # (B, S)
    valid = t_new >= 0
    if new_lens is not None:       # right-aligned chunk: leading pad columns
        valid &= cols[None, :] >= S - new_lens.long()[:, None]
    col = torch.clamp(t_new, 0, n_lanes * ps - 1)
    page = torch.gather(pages.long(), 1, col // ps)
    page = torch.where(valid & (page >= 0), page, n_pages)          # sink
    off = col % ps
    with_sink(kc)[page, off] = k.to(kc.dtype)
    with_sink(vc)[page, off] = v.to(vc.dtype)
    if S == 1 and new_lens is None:
        return K.paged_attention(q[:, 0].contiguous(), kc, vc, pages,
                                 cache_len)[:, None]
    nl = new_lens if new_lens is not None \
        else torch.full((B,), S, dtype=torch.int32, device=dev)
    return K.paged_chunk_attention(q.contiguous(), kc, vc, pages, cache_len,
                                   nl)


def attn_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 positions: torch.Tensor,
                 cache: Optional[Dict[str, torch.Tensor]] = None,
                 cache_len: Optional[torch.Tensor] = None,
                 pages: Optional[torch.Tensor] = None,
                 new_lens: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d).  Without ``cache``: causal attention over the S
    positions; returns the new K/V as the cache.  With ``cache`` (decode,
    S == 1, per-request ``cache_len`` of shape (B,)): writes the new K/V at
    ``cache_len - 1`` of each row IN PLACE and attends to the first
    ``cache_len`` positions; returns the same cache tensors.

    Paged mode (``pages`` given): ``cache`` is one layer of the KV pool's
    page store ``{"k"/"v": (n_pages, page_size, KVH, hd)}`` shared by every
    request, ``pages`` each request's (B, P) int32 page-index vector, and
    position ``t`` lives at ``pages[b, t // page_size]`` offset ``t %
    page_size``.  Column ``j`` sits at position ``cache_len - S + j``
    (right-aligned, with ``new_lens`` valid trailing columns per row).  The
    chunk's K/V go into the pages in place, then attention reads by page
    index (K5 for one decode token, K6 for a chunk).  A store that also
    holds ``k_scale``/``v_scale`` is the quantized store (int8 pages with
    per-(page, KV head) scales): writes go through ``requant_scatter`` and
    attention through K7/K8."""
    B, S, _ = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q = matmul(h, p["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
    k = matmul(h, p["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = matmul(h, p["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if pages is not None:
        if cache_len is None or cache_len.dim() != 1:
            raise ValueError("paged attention needs a per-request (B,) "
                             "cache_len")
        paged = _paged_attn_quant if "k_scale" in cache else _paged_attn
        o = paged(q, k, v, cache, pages, cache_len, new_lens)
        new_cache = cache
    elif cache is None:
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


# ---------------------------------------------------------------------------
# Mixture-of-Experts at one model shard
# ---------------------------------------------------------------------------


def _route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """-> (probs (T, E) float32, top-k probs, top-k experts (T, k)).
    ``lax.top_k`` breaks ties toward the lower expert index; a stable
    descending sort does the same, where ``torch.topk`` promises no
    order."""
    probs = torch.softmax(matmul(x, router).float(), dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe_top_k
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    if k > 1:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return probs, top_p, top_e


def _aux_loss(probs: torch.Tensor, top_e: torch.Tensor, E: int):
    """The switch-style load-balance loss."""
    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(top_e[:, 0], E).float().mean(dim=0)
    return E * (me * ce).sum()


def _expert_mm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("ecd,edf->ecf", a, w, preferred_element_type=float32)``:
    the products summed and returned in float32.  Operands narrower than
    float32 are widened, which is exact, one expert at a time, so no
    float32 copy of a bf16 expert stack exists whole."""
    if a.dtype == w.dtype == torch.float32:
        return torch.bmm(a, w)
    return torch.stack([a[e].float() @ w[e].float()
                        for e in range(a.shape[0])])


def _moe_local(x: torch.Tensor, router, wi, wg, wo, cfg: ModelConfig):
    """``repro``'s dispatch body at one model shard.

    x: (T, d).  Each (token, choice) pair takes the next place of its
    expert's capacity bucket, ``cap = ceil(T * k * capacity_factor / E)``,
    counted by a cumulative sum over the flat ``(T * k,)`` order; a pair
    past ``cap`` is dropped (it adds zeros at place 0, which leaves the
    place's token exact).  The experts run on their buckets; the outputs
    come back weighted by the routing probabilities."""
    T, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    cap = max(1, math.ceil(T * k * cfg.capacity_factor / E))
    probs, top_p, top_e = _route(x, router, cfg)
    flat_e = top_e.reshape(-1)                             # (T*k,)
    flat_p = top_p.reshape(-1)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(k)
    onehot = torch.nn.functional.one_hot(flat_e, E)        # (T*k, E)
    pos = torch.cumsum(onehot, dim=0) - 1
    pos = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    keep = pos < cap
    safe_pos = torch.where(keep, pos, 0)
    send = torch.zeros((E, cap, d), dtype=torch.float32, device=x.device)
    send.index_put_((flat_e, safe_pos),
                    torch.where(keep[:, None], x[flat_t], 0).float(),
                    accumulate=True)
    recv = send.to(x.dtype)
    a = act_fn(cfg.act)(_expert_mm_f32(recv, wi))
    if cfg.glu:
        a = a * _expert_mm_f32(recv, wg)
    out = matmul(a.to(x.dtype), wo)                        # (E, cap, d)
    gathered = torch.where(keep[:, None], out[flat_e, safe_pos], 0)
    y = (gathered.float() * flat_p[:, None].float()).reshape(T, k, d)
    y = y.sum(dim=1).to(x.dtype)
    return y, _aux_loss(probs, top_e, E)


def _moe_local_tp(x: torch.Tensor, router, wi, wg, wo, cfg: ModelConfig):
    """``repro``'s dropless decode body at one model shard: every expert
    runs on every token, each output weighted by the token's renormalised
    top-k probability for that expert (0 where not chosen)."""
    E = cfg.moe_experts
    probs, top_p, top_e = _route(x, router, cfg)
    eix = torch.arange(E, device=x.device)
    sel = top_e[:, None, :] == eix[None, :, None]          # (T, E, k)
    w = torch.where(sel, top_p[:, None, :], 0.0).sum(dim=-1)   # (T, E)
    a = act_fn(cfg.act)(matmul(x[None], wi))               # (E, T, ff)
    if cfg.glu:
        a = a * matmul(x[None], wg)
    out = matmul(a.to(x.dtype), wo)                        # (E, T, d)
    y = torch.einsum("etd,te->td", out.float(), w.float())
    return y.to(x.dtype), _aux_loss(probs, top_e, E)


def moe_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                decode_tp: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (B, S, d), aux-loss scalar.  ``decode_tp``: the
    dropless decode body, else the capacity dispatch body; the always-on
    shared expert (llama4) is added to either."""
    B, S, d = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps).reshape(B * S, d)
    body = _moe_local_tp if decode_tp else _moe_local
    y, aux = body(h, p["router"], p["wi"], p.get("wg"), p["wo"], cfg)
    y = y.reshape(B, S, d).to(x.dtype)
    if "shared" in p:
        sh = p["shared"]
        hs = rms_norm(x, sh["ln"], cfg.norm_eps)
        a = act_fn(cfg.act)(matmul(hs, sh["wi"]))
        if cfg.glu:
            a = a * matmul(hs, sh["wg"])
        y = y + matmul(a, sh["wo"]).to(x.dtype)
    return y, aux


# ---------------------------------------------------------------------------
# Transformer block
# ---------------------------------------------------------------------------


def block_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  positions, is_moe: bool = False, cache=None,
                  cache_len=None, pages=None, new_lens=None):
    """One block -> (x', aux loss, cache').  A dense block has no
    auxiliary loss, so it is the float 0.0; an MoE block (``is_moe``)
    decodes through the dropless body whenever ``cache_len`` is given, as
    ``repro``'s MoE stack chooses."""
    a, new_cache = attn_forward(p["attn"], x, cfg, positions=positions,
                                cache=cache, cache_len=cache_len,
                                pages=pages, new_lens=new_lens)
    x = x + a
    if is_moe:
        m, aux = moe_forward(p["moe"], x, cfg,
                             decode_tp=cache_len is not None)
    else:
        m, aux = mlp_forward(p["mlp"], x, cfg), 0.0
    return x + m, aux, new_cache
