"""Decoder transformer blocks in plain PyTorch: GQA attention, the
(gated) MLP and the mixture-of-experts layer.

The port of ``repro.models.transformer``: attention with no cache
(prefill, through :func:`~.common.flash_attention`), with a per-request
cache (decode, through :func:`~.common.decode_attention`) and over the KV
pool's page store (the scheduler's data plane, through the kernels K5 and
K6, or K7 and K8 over the quantized page store); the MoE layer's dispatch
and decode bodies.  Where JAX returned a new cache, the cached branches
write the new K/V into the caller's cache tensors in place and return
them.

On a mesh of ranks (``launch.mesh``; ``mesh=None`` is the one-device path,
unchanged) each of ``repro``'s ``shard_map`` sites runs per rank with
explicit collectives (``dist.sharding.shard_map_compat``): the four paged
wrappers run their kernel on the rank's rows when the data axes divide
the batch, and the MoE layer dispatches its tokens to expert shards over
"model" with two all-to-alls (capacity counted on each shard's own
tokens) or, decoding, reduces the expert shards' partial outputs.

Given their layer's spec tree (``specs``, from ``dist.sharding.
param_specs``), :func:`attn_forward` and :func:`mlp_forward` compute on
tensor-parallel blocks, as XLA's partitioner computes ``repro``'s layer
under those specs: column-parallel ``wq``/``wk``/``wv``/``wi``/``wg``
give this rank's heads and d_ff columns, and the row-parallel ``wo`` is
followed by a ``psum`` over "model".  Where ``wk``/``wv`` are replicated
(GQA or MQA with ``shard_kv_heads=False``), each local query head reads
the K/V head of its GLOBAL index.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..dist.sharding import (P, all_gather, all_to_all, axis_index,
                             axis_size, mesh_view, pmax, pmean, psum,
                             shard_map_compat, spec_axes)
from ..kernels import ops as K
from ..kernels.quant import requant_scatter
from .common import (ModelConfig, Params, act_fn, apply_rope, decode_attention,
                     decode_attention_partial, dense_init, flash_attention,
                     matmul, rms_norm)


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


def _data_split(mesh, data_axes, b: int):
    """The live data axes when they split a batch of ``b`` rows over more
    than one rank, else None (the unsharded call)."""
    if mesh is None:
        return None
    view = mesh_view(mesh)
    bax = tuple(a for a in data_axes if a in view.axis_names)
    nb = 1
    for a in bax:
        nb *= view.shape[a]
    return bax if nb > 1 and b % nb == 0 else None


def _paged_attention_sharded(q, k_pages, v_pages, pages, cache_len,
                             mesh, data_axes):
    """Decode attention over the page store (K5), wired for meshes: when
    the data axes are live and divide the batch, requests shard over them
    and each rank streams only ITS requests' pages through the kernel; the
    page store replicates (it is the pool)."""
    bax = _data_split(mesh, data_axes, q.shape[0])
    if bax is not None:
        def body(q_, pg_, cl_, kp_, vp_):
            return K.paged_attention(q_, kp_, vp_, pg_, cl_)

        return shard_map_compat(body, mesh,
                         in_specs=(P(bax), P(bax), P(bax), P(), P()),
                         out_specs=P(bax))(
                             q, pages, cache_len, k_pages, v_pages)
    return K.paged_attention(q, k_pages, v_pages, pages, cache_len)


def _paged_chunk_attention(q, k_pages, v_pages, pages, cache_len, new_lens,
                           mesh, data_axes):
    """Chunk-prefill attention over the page store (K6), sharded like
    :func:`_paged_attention_sharded`: each rank streams only its rows'
    pages."""
    bax = _data_split(mesh, data_axes, q.shape[0])
    if bax is not None:
        def body(q_, pg_, cl_, nl_, kp_, vp_):
            return K.paged_chunk_attention(q_, kp_, vp_, pg_, cl_, nl_)

        return shard_map_compat(body, mesh,
                         in_specs=(P(bax), P(bax), P(bax), P(bax), P(),
                                   P()),
                         out_specs=P(bax))(
                             q, pages, cache_len, new_lens, k_pages, v_pages)
    return K.paged_chunk_attention(q, k_pages, v_pages, pages, cache_len,
                                   new_lens)


def _paged_attention_quant_sharded(q, k_pages, v_pages, k_scale, v_scale,
                                   pages, cache_len, mesh, data_axes):
    """Quantized-pool decode attention (K7), sharded like
    :func:`_paged_attention_sharded`; the per-page scales replicate with
    the page store (they are pool metadata)."""
    bax = _data_split(mesh, data_axes, q.shape[0])
    if bax is not None:
        def body(q_, pg_, cl_, kp_, vp_, ks_, vs_):
            return K.paged_attention_quant(q_, kp_, vp_, ks_, vs_, pg_, cl_)

        return shard_map_compat(body, mesh,
                         in_specs=(P(bax), P(bax), P(bax), P(), P(), P(),
                                   P()),
                         out_specs=P(bax))(
                             q, pages, cache_len, k_pages, v_pages, k_scale,
                             v_scale)
    return K.paged_attention_quant(q, k_pages, v_pages, k_scale, v_scale,
                                   pages, cache_len)


def _paged_chunk_attention_quant(q, k_pages, v_pages, k_scale, v_scale,
                                 pages, cache_len, new_lens, mesh,
                                 data_axes):
    """Quantized-pool chunk-prefill attention (K8), sharded like
    :func:`_paged_chunk_attention`; scales replicate with the store."""
    bax = _data_split(mesh, data_axes, q.shape[0])
    if bax is not None:
        def body(q_, pg_, cl_, nl_, kp_, vp_, ks_, vs_):
            return K.paged_chunk_attention_quant(q_, kp_, vp_, ks_, vs_, pg_,
                                                 cl_, nl_)

        return shard_map_compat(body, mesh,
                         in_specs=(P(bax), P(bax), P(bax), P(bax), P(), P(),
                                   P(), P()),
                         out_specs=P(bax))(
                             q, pages, cache_len, new_lens, k_pages, v_pages,
                             k_scale, v_scale)
    return K.paged_chunk_attention_quant(q, k_pages, v_pages, k_scale,
                                         v_scale, pages, cache_len, new_lens)


def _paged_attn_quant(q, k, v, cache, pages, cache_len, new_lens,
                      mesh=None, data_axes=()):
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
        return _paged_attention_quant_sharded(
            q[:, 0].contiguous(), kc, vc, ksc, vsc, pages, cache_len, mesh,
            data_axes)[:, None]
    nl = new_lens if new_lens is not None \
        else torch.full((B,), S, dtype=torch.int32, device=q.device)
    return _paged_chunk_attention_quant(q.contiguous(), kc, vc, ksc, vsc,
                                        pages, cache_len, nl, mesh, data_axes)


def _paged_attn(q, k, v, cache, pages, cache_len, new_lens, mesh=None,
                data_axes=()):
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
        return _paged_attention_sharded(q[:, 0].contiguous(), kc, vc, pages,
                                        cache_len, mesh, data_axes)[:, None]
    nl = new_lens if new_lens is not None \
        else torch.full((B,), S, dtype=torch.int32, device=dev)
    return _paged_chunk_attention(q.contiguous(), kc, vc, pages, cache_len,
                                  nl, mesh, data_axes)


def _over_model(spec) -> bool:
    """Whether a leaf's spec shards it over "model"."""
    return spec is not None and "model" in spec_axes(spec)


def _local_kv(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
              h_loc: int):
    """The replicated K/V heads that this rank's ``h_loc`` query heads
    read: query head ``i`` is global head ``c * h_loc + i`` (``c`` the
    rank's "model" coordinate) and reads K/V head ``(c * h_loc + i) //
    g``, ``g = n_heads // n_kv_heads``.  -> (k, v) with the heads in the
    grouping :func:`~.common.flash_attention` applies to ``h_loc`` query
    heads: a contiguous run of K/V heads where the local heads cover whole
    groups or lie in one group, else one K/V head a query head."""
    g = cfg.n_heads // cfg.n_kv_heads
    first = axis_index("model") * h_loc
    if h_loc % g == 0 or g % h_loc == 0:
        n = max(h_loc // g, 1)
        lo = first // g
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    idx = (first + torch.arange(h_loc, device=k.device)) // g
    return k.index_select(2, idx), v.index_select(2, idx)


def _seq_axes(cache_spec) -> Tuple[str, ...]:
    """The mesh axes of a layer's cache spec ``(B, S, KVH, hd)`` that
    split its sequence, outermost first."""
    e = tuple(cache_spec)[1]
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


def _seq_slice(axes: Tuple[str, ...]) -> Tuple[int, int]:
    """-> (this rank's slice of a sequence split over ``axes``, the number
    of slices), in ``dist.sharding.shard_block``'s order."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * axis_size(a) + axis_index(a)
        n *= axis_size(a)
    return idx, n


def _narrow_seq(x: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
    idx, n = _seq_slice(axes)
    size = x.shape[1] // n
    return x.narrow(1, idx * size, size)


def _cache_block(x: torch.Tensor, cache_spec, kv_tp: bool) -> torch.Tensor:
    """The new K (or V) ``(B, S, heads, hd)`` of a sharded prefill as this
    rank's cache block under ``cache_spec``: its slice of the sequence,
    every K/V head.  Heads replicated over "model": a local slice.  Heads
    split over "model" (``kv_tp``): the slice over the sequence axes
    outside "model" is local, then an all-to-all over "model" trades the
    rank's heads of every model slice for every rank's heads of its
    own."""
    axes = _seq_axes(cache_spec)
    if not kv_tp:
        return _narrow_seq(x, axes).contiguous()
    if "model" not in axes:
        return _narrow_seq(all_gather(x, "model", dim=2), axes).contiguous()
    x = _narrow_seq(x, axes[:-1])               # "model" is innermost
    B, S, h, hd = x.shape
    n = axis_size("model")
    x = x.reshape(B, n, S // n, h, hd).transpose(0, 1).contiguous()
    x = all_to_all(x, "model")                  # (source rank, B, S/n, h, hd)
    return x.permute(1, 2, 0, 3, 4).reshape(B, S // n, n * h, hd)


def _write_token(c: torch.Tensor, new: torch.Tensor, cache_len, lo: int,
                 whole: int) -> None:
    """Write the new token's K (or V) ``(B, KVH, hd)`` into this rank's
    slice ``c`` ``(B, S_loc, KVH, hd)`` of a cache of ``whole`` positions
    whose slice starts at position ``lo``, in place and with no host
    sync: only the slice that holds the position writes it (the other
    slices write back what they hold).  A scalar ``cache_len`` writes at
    ``cache_len - 1`` clamped into the cache, as ``lax.
    dynamic_update_slice`` clamps it; a per-request (B,) one row by row
    at ``cache_len - 1``, a negative position counted from the end and
    one past the cache dropped, as ``repro``'s indexed set does."""
    n_loc = c.shape[1]
    new = new.to(c.dtype)
    if cache_len.dim() == 0:
        pos = torch.clamp(cache_len.long() - 1, 0, whole - 1)
        loc = torch.clamp(pos - lo, 0, n_loc - 1).reshape(1)
        own = (pos >= lo) & (pos < lo + n_loc)
        c.index_copy_(1, loc, torch.where(own, new[:, None],
                                          c.index_select(1, loc)))
        return
    pos = cache_len.long() - 1
    pos = torch.where(pos < 0, pos + whole, pos)
    own = ((pos >= lo) & (pos < lo + n_loc))[:, None, None]
    loc = torch.clamp(pos - lo, 0, n_loc - 1)
    rows = torch.arange(c.shape[0], device=c.device)
    c[rows, loc] = torch.where(own, new, c[rows, loc])


def _decode_sharded(q, k, v, cache, cache_len, cache_spec, cfg: ModelConfig,
                    tp: bool, kv_tp: bool) -> torch.Tensor:
    """One decode token against this rank's cache block ``(B, S_loc, KVH,
    hd)`` (its rows, its slice of the sequence, every K/V head), q/k/v
    this rank's heads.  The query heads (and, ``kv_tp``, the new K/V
    heads) are gathered over "model"; the slice that holds the new
    position writes its K/V (:func:`_write_token`); each rank attends over
    its slice (:func:`~.common.decode_attention_partial`) and the
    partials combine over the sequence axes with a ``pmax`` of the row
    maxes and a ``psum`` of the rescaled sums and outputs.  A cache whose
    sequence is not split attends through ``decode_attention`` as the
    unsharded step does.  -> the attention output of this rank's heads
    ``(B, 1, h_loc, hd)``."""
    h_loc = q.shape[2]
    if tp:
        q = all_gather(q, "model", dim=2)
    if kv_tp:
        k = all_gather(k, "model", dim=2)
        v = all_gather(v, "model", dim=2)
    kc, vc = cache["k"], cache["v"]
    B, n_loc = kc.shape[:2]
    axes = _seq_axes(cache_spec)
    idx, n = _seq_slice(axes)
    lo = idx * n_loc
    for c, new in ((kc, k), (vc, v)):
        _write_token(c, new[:, 0], cache_len, lo, n * n_loc)
    lens = cache_len.reshape(1).expand(B) if cache_len.dim() == 0 \
        else cache_len
    if n == 1:
        o = decode_attention(q, kc, vc, lens)
    else:
        o, m, l = decode_attention_partial(q, kc, vc, lens, lo)
        top = pmax(m, axes)
        w = torch.where(m == -math.inf, 0.0, torch.exp(m - top))
        s = psum(torch.cat([o * w[..., None], (l * w)[..., None]], dim=-1),
                 axes)
        o = (s[..., :-1] / s[..., -1:]).reshape(B, 1, -1, cfg.hd).to(q.dtype)
    if tp:
        o = o.narrow(2, axis_index("model") * h_loc, h_loc)
    return o


def attn_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 positions: torch.Tensor,
                 cache: Optional[Dict[str, torch.Tensor]] = None,
                 cache_len: Optional[torch.Tensor] = None,
                 pages: Optional[torch.Tensor] = None,
                 new_lens: Optional[torch.Tensor] = None,
                 mesh=None, data_axes: Tuple[str, ...] = (),
                 specs: Optional[Dict] = None, cache_spec=None,
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d).  Without ``cache``: causal attention over the S
    positions; returns the new K/V as the cache.  With ``cache`` (decode,
    S == 1): writes the new K/V at ``cache_len - 1`` IN PLACE and attends
    to the first ``cache_len`` positions; returns the same cache tensors.
    ``cache_len`` is per request, shape (B,), or a scalar shared by every
    row (``repro``'s uniform-length branch, the dry-run serve-step
    contract: one write at ``cache_len - 1``, clamped into the cache as
    ``lax.dynamic_update_slice`` clamps it).

    ``specs`` (the layer's attention specs; inside a bound mesh): ``p``
    holds this rank's tensor-parallel blocks (module docstring), and the
    output is the ``psum`` over "model" of the local heads' share when
    ``wq`` is sharded over it.  ``cache_spec`` (with ``specs``: the spec
    of the layer's K/V cache ``(B, S, KVH, hd)`` from ``dist.sharding.
    cache_specs``) shards the cache: without ``cache``, the new K/V come
    back as this rank's blocks under it (:func:`_cache_block`); with
    ``cache``, the cache tensors are this rank's blocks, its rows and its
    slice of the sequence with every K/V head, and the decode step runs
    on them (:func:`_decode_sharded`).

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
    attention through K7/K8.  With ``mesh``, the paged attention runs on
    each rank's rows of the batch when ``data_axes`` divide it."""
    B, S, _ = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    heads = p["wq"].shape[-1] // cfg.hd           # this rank's, if sharded
    q = matmul(h, p["wq"]).reshape(B, S, heads, cfg.hd)
    kv_heads = p["wk"].shape[-1] // cfg.hd
    k = matmul(h, p["wk"]).reshape(B, S, kv_heads, cfg.hd)
    v = matmul(h, p["wv"]).reshape(B, S, kv_heads, cfg.hd)
    tp = specs is not None and _over_model(specs["wq"])
    kv_tp = specs is not None and _over_model(specs["wk"])
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    k_all, v_all = k, v
    if tp and not kv_tp:
        k, v = _local_kv(k, v, cfg, heads)
    if cache is not None and cache_spec is not None:
        if pages is not None:
            raise ValueError("a sharded cache is a dense cache, not pages")
        o = _decode_sharded(q, k_all, v_all, cache, cache_len, cache_spec,
                            cfg, tp, kv_tp)
        new_cache = cache
    elif pages is not None:
        if cache_len is None or cache_len.dim() != 1:
            raise ValueError("paged attention needs a per-request (B,) "
                             "cache_len")
        paged = _paged_attn_quant if "k_scale" in cache else _paged_attn
        o = paged(q, k, v, cache, pages, cache_len, new_lens, mesh,
                  data_axes)
        new_cache = cache
    elif cache is None:
        o = flash_attention(q, k, v, causal=cfg.causal,
                            block_q=cfg.attn_block_q,
                            block_kv=cfg.attn_block_kv)
        if cache_spec is None:
            new_cache = {"k": k_all, "v": v_all}
        else:
            new_cache = {"k": _cache_block(k_all, cache_spec, kv_tp),
                         "v": _cache_block(v_all, cache_spec, kv_tp)}
    elif cache_len is None or cache_len.dim() > 1:
        raise ValueError("decode needs a per-request (B,) or a scalar "
                         "cache_len")
    elif cache_len.dim() == 0:
        kc, vc = cache["k"], cache["v"]
        pos = torch.clamp(cache_len.long() - 1, 0, kc.shape[1] - 1)
        kc.index_copy_(1, pos.reshape(1), k[:, :1].to(kc.dtype))
        vc.index_copy_(1, pos.reshape(1), v[:, :1].to(vc.dtype))
        o = decode_attention(q, kc, vc, cache_len.reshape(1).expand(B))
        new_cache = cache
    else:
        kc, vc = cache["k"], cache["v"]
        rows = torch.arange(B, device=x.device)
        pos = (cache_len - 1).long()
        kc[rows, pos] = k[:, 0].to(kc.dtype)
        vc[rows, pos] = v[:, 0].to(vc.dtype)
        o = decode_attention(q, kc, vc, cache_len)
        new_cache = cache
    out = matmul(o.reshape(B, S, heads * cfg.hd), p["wo"])
    if tp:
        out = psum(out, "model")
    return out.to(x.dtype), new_cache


def mlp_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                specs: Optional[Dict] = None) -> torch.Tensor:
    """The (gated) MLP.  ``specs`` (the layer's MLP specs, inside a bound
    mesh): ``p`` holds this rank's blocks, and with ``wi`` sharded over
    "model" the output is the ``psum`` of the local d_ff columns'
    share."""
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    a = act_fn(cfg.act)(matmul(h, p["wi"]))
    if cfg.glu:
        a = a * matmul(h, p["wg"])
    out = matmul(a, p["wo"])
    if specs is not None and _over_model(specs["wi"]):
        out = psum(out, "model")
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Mixture-of-Experts with explicit expert parallelism over a mesh
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


def _moe_local(x: torch.Tensor, router, wi, wg, wo, cfg: ModelConfig,
               model_axis: Optional[str] = None, n_model: int = 1,
               weight_resident_axes: Tuple[str, ...] = ()):
    """``repro``'s dispatch body, on one device or on one rank's shard.

    x: (T, d) local tokens.  Each (token, choice) pair takes the next place
    of its expert's capacity bucket, ``cap = ceil(T * k * capacity_factor
    / E)`` on the LOCAL T, counted by a cumulative sum over the flat
    ``(T * k,)`` order; a pair past ``cap`` is dropped (it adds zeros at
    place 0, which leaves the place's token exact).  The experts run on
    their buckets; the outputs come back weighted by the routing
    probabilities.

    With ``model_axis`` (inside ``shard_map_compat``) the experts are
    sharded over it (``E / n_model`` a rank): the (E, cap, d) send buffer
    goes out by an all-to-all, the rank's experts run on every source's
    buckets, and a second all-to-all brings the outputs back.
    ``weight_resident_axes``: the experts' d_ff is also sharded over those
    axes, so the received buckets are all-gathered over them, the partial
    outputs summed, and each rank keeps its own rows.  Training
    differentiates through all of it: the collectives' backwards
    (``dist.sharding``) send each bucket's cotangent back through both
    all-to-alls, the all-gather's as a ``psum_scatter`` and the partial
    sum's as a ``psum``, with the capacity still counted on the local
    tokens."""
    T, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    e_loc = E // n_model
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
    if model_axis is not None:
        # rank i receives, from every peer j, j's buckets for i's experts:
        # (n_model, e_loc, cap, d), axis 0 the source
        recv = all_to_all(recv, model_axis)
        recv = recv.reshape(n_model, e_loc, cap, d).transpose(0, 1)
        recv = recv.reshape(e_loc, n_model * cap, d)
        rows0 = recv.shape[1]
        for ax in weight_resident_axes:
            recv = all_gather(recv, ax, dim=1)
    a = act_fn(cfg.act)(_expert_mm_f32(recv, wi))
    if cfg.glu:
        a = a * _expert_mm_f32(recv, wg)
    out = matmul(a.to(x.dtype), wo)                        # (E_loc, rows, d)
    if model_axis is not None:
        if weight_resident_axes:
            # complete the d_ff contraction across the ff shards, then keep
            # this rank's rows (the last-gathered axis is outermost)
            out = psum(out, weight_resident_axes)
            didx = 0
            for ax in reversed(weight_resident_axes):
                didx = didx * axis_size(ax) + axis_index(ax)
            out = out.narrow(1, didx * rows0, rows0)
        out = out.reshape(e_loc, n_model, cap, d).transpose(0, 1)
        out = all_to_all(out.reshape(E, cap, d).contiguous(), model_axis)
    gathered = torch.where(keep[:, None], out[flat_e, safe_pos], 0)
    y = (gathered.float() * flat_p[:, None].float()).reshape(T, k, d)
    y = y.sum(dim=1).to(x.dtype)
    return y, _aux_loss(probs, top_e, E)


def _moe_local_tp(x: torch.Tensor, router, wi, wg, wo, cfg: ModelConfig,
                  data_axes: Optional[Tuple[str, ...]] = None):
    """``repro``'s dropless decode body: every expert runs on every token,
    each output weighted by the token's renormalised top-k probability for
    that expert (0 where not chosen).

    With ``data_axes`` (inside ``shard_map_compat``; ``None`` is one
    device) the rank holds its experts over "model" with their d_ff
    sharded over "data": the tokens are all-gathered over the data axes,
    each rank's partial output summed over ("model", *data_axes), and the
    rank keeps its own tokens."""
    T_loc = x.shape[0]
    E = cfg.moe_experts
    xg = x
    for ax in data_axes or ():
        xg = all_gather(xg, ax, dim=0)
    probs, top_p, top_e = _route(xg, router, cfg)
    e_loc = wi.shape[0]
    base = 0 if data_axes is None else axis_index("model") * e_loc
    eix = base + torch.arange(e_loc, device=x.device)
    sel = top_e[:, None, :] == eix[None, :, None]          # (T, E_loc, k)
    w = torch.where(sel, top_p[:, None, :], 0.0).sum(dim=-1)   # (T, E_loc)
    a = act_fn(cfg.act)(matmul(xg[None], wi))              # (E_loc, T, ff)
    if cfg.glu:
        a = a * matmul(xg[None], wg)
    out = matmul(a.to(x.dtype), wo)                        # (E_loc, T, d)
    y = torch.einsum("etd,te->td", out.float(), w.float())
    if data_axes is not None:
        y = psum(y, ("model",) + tuple(data_axes))
        if data_axes:
            didx = 0
            for ax in reversed(data_axes):
                didx = didx * axis_size(ax) + axis_index(ax)
            y = y.narrow(0, didx * T_loc, T_loc)
    return y.to(x.dtype), _aux_loss(probs, top_e, E)


def _moe_sharded(p: Params, h: torch.Tensor, cfg: ModelConfig, mesh,
                 data_axes: Tuple[str, ...], split_tokens_over_model: bool,
                 decode_tp: bool, weight_resident: bool):
    """``repro``'s three ``shard_map`` layouts of the MoE bodies."""
    model_axis = "model"
    view = mesh_view(mesh)
    n_model = view.shape[model_axis]
    token_axes = data_axes + ((model_axis,) if split_tokens_over_model
                              else ())
    mesh_axes = tuple(view.axis_names)

    if decode_tp:
        # the experts' d_ff is split over "data" alone, and the body sums
        # over every data axis: another live one would count each partial
        # once a rank along it (ROADMAP R15), so it is refused
        doubled = [a for a in data_axes
                   if a != "data" and view.shape.get(a, 1) > 1]
        if doubled:
            raise NotImplementedError(
                f"moe_forward(decode_tp=True) over data axes {doubled} "
                "besides 'data': the dropless body would sum their "
                "replicas' partial outputs")

        def body(h_loc, router, wi, wg, wo):
            y, aux = _moe_local_tp(h_loc, router, wi, wg, wo, cfg,
                                   data_axes)
            return y, pmean(aux, mesh_axes)
        in_specs = (P(data_axes or None, None), P(),
                    P(model_axis, None, "data"), P(model_axis, None, "data"),
                    P(model_axis, "data", None))
        out_specs = (P(data_axes or None, None), P())
    elif weight_resident:
        wr_axes = tuple(a for a in data_axes if a in view.axis_names)

        def body(h_loc, router, wi, wg, wo):
            y, aux = _moe_local(h_loc, router, wi, wg, wo, cfg, model_axis,
                                n_model, weight_resident_axes=wr_axes)
            return y, pmean(aux, mesh_axes)
        in_specs = (P(token_axes, None), P(),
                    P(model_axis, None, wr_axes or None),
                    P(model_axis, None, wr_axes or None),
                    P(model_axis, wr_axes or None, None))
        out_specs = (P(token_axes, None), P())
    else:
        def body(h_loc, router, wi, wg, wo):
            y, aux = _moe_local(h_loc, router, wi, wg, wo, cfg, model_axis,
                                n_model)
            return y, pmean(aux, mesh_axes)
        in_specs = (P(token_axes, None), P(), P(model_axis, None, None),
                    P(model_axis, None, None), P(model_axis, None, None))
        out_specs = (P(token_axes, None), P())

    # the token rows split over these axes' ranks, as ``repro``'s
    # shard_map splits them: rows they do not divide are refused
    row_axes = data_axes if decode_tp else token_axes
    n_rows = math.prod(view.shape.get(a, 1) for a in row_axes)
    if h.shape[0] % n_rows:
        raise ValueError(
            f"moe_forward: {n_rows} ranks over {row_axes} do not evenly "
            f"divide {h.shape[0]} token rows (ROADMAP R17)")
    return shard_map_compat(body, mesh, in_specs, out_specs)(
        h, p["router"], p["wi"], p.get("wg"), p["wo"])


def moe_forward(p: Params, x: torch.Tensor, cfg: ModelConfig, mesh=None,
                data_axes: Tuple[str, ...] = (),
                split_tokens_over_model: bool = True,
                decode_tp: bool = False,
                weight_resident: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (B, S, d), aux-loss scalar.  ``decode_tp``: the
    dropless decode body, else the capacity dispatch body; the always-on
    shared expert (llama4) is added to either, outside the sharded part.

    With ``mesh`` the bodies run per rank as ``repro``'s ``shard_map``
    lays them out: tokens over ``data_axes`` (and "model" when
    ``split_tokens_over_model``), experts over "model", and with
    ``weight_resident`` (or ``decode_tp``) the experts' d_ff over the data
    axes; the aux loss is the mean of the ranks'.  With gradients on (the
    expert-parallel train step, ``repro``'s training layouts: tokens split
    over "model", weights resident where the rules say so) the backward
    runs through the same collectives and ``shard_map_compat``.
    ``decode_tp`` on a mesh where a data axis other than "data" is above 1
    raises ``NotImplementedError`` (ROADMAP R15); token rows (B * S) that
    the ranks they split over do not divide raise ``ValueError``, as
    ``repro``'s ``shard_map`` does (ROADMAP R17).  ``mesh=None`` is one
    device, where the flags change nothing."""
    B, S, d = x.shape
    h = rms_norm(x, p["ln"], cfg.norm_eps).reshape(B * S, d)
    if mesh is None:
        body = _moe_local_tp if decode_tp else _moe_local
        y, aux = body(h, p["router"], p["wi"], p.get("wg"), p["wo"], cfg)
    else:
        y, aux = _moe_sharded(p, h, cfg, mesh, tuple(data_axes),
                              split_tokens_over_model, decode_tp,
                              weight_resident)
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
                  cache_len=None, pages=None, new_lens=None, mesh=None,
                  data_axes: Tuple[str, ...] = (),
                  split_tokens_over_model: bool = True,
                  moe_weight_resident: bool = False, specs=None,
                  cache_spec=None):
    """One block -> (x', aux loss, cache').  A dense block has no
    auxiliary loss, so it is the float 0.0; an MoE block (``is_moe``)
    decodes through the dropless body whenever ``cache_len`` is given, as
    ``repro``'s MoE stack chooses.  ``mesh`` and the flags after it: see
    :func:`attn_forward` and :func:`moe_forward`; ``specs``, the layer's
    spec tree of a dense block's tensor-parallel blocks, and
    ``cache_spec``, its K/V cache's spec (:func:`attn_forward`)."""
    a, new_cache = attn_forward(p["attn"], x, cfg, positions=positions,
                                cache=cache, cache_len=cache_len,
                                pages=pages, new_lens=new_lens, mesh=mesh,
                                data_axes=tuple(data_axes or ()),
                                specs=None if specs is None
                                else specs["attn"], cache_spec=cache_spec)
    x = x + a
    if is_moe:
        m, aux = moe_forward(p["moe"], x, cfg, mesh, tuple(data_axes or ()),
                             split_tokens_over_model,
                             decode_tp=cache_len is not None,
                             weight_resident=moe_weight_resident)
    else:
        m, aux = mlp_forward(p["mlp"], x, cfg,
                             None if specs is None else specs["mlp"]), 0.0
    return x + m, aux, new_cache
