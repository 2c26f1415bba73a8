"""Model assembly in plain PyTorch: parameter init, the forward pass, the
training loss and decode caches for every family (``dense``, ``vlm``,
``moe``, ``ssm`` = RWKV-6, ``hybrid`` = Zamba2, and the encoder-only
``audio``, which has no decode cache).

The port of ``repro.models.model``.  Parameters keep ``repro``'s pytree
layout (nested dicts; layer stacks with a leading ``L`` dim, interleaved
stacks with leading ``(periods, k)`` dims), so :func:`from_jax_params`
carries a JAX parameter tree across leaf by leaf, and each layer stack is
a Python loop where ``repro`` used ``lax.scan``.  The paged page store
(:func:`init_paged_caches`) is the scheduler's data plane and holds dense
attention only, as in ``repro``.

With ``mesh=`` (a mesh of ranks from ``launch.mesh``) and ``rules=``
(``dist.sharding.MeshRules``), :func:`forward` and :func:`loss_fn` run
``repro``'s meshed program: every rank computes the dense parts whole, and
the ``shard_map`` sites (the paged attention of the dense stack, the MoE
layers, with ``repro``'s flags) run per rank with explicit collectives;
``mesh=None`` is the one-device path, unchanged.

Training recomputes as ``repro`` does: a stack given a ``remat_policy``
(``training.train_step.remat_policy_by_name``: a callable ``policy(fn,
*args)`` that returns ``fn(*args)`` and chooses what autograd keeps)
wraps each block that builds no cache in it; the MoE and hybrid stacks
recompute their blocks fully whatever the policy names, as ``repro``'s
``jax.checkpoint(blk)`` with no policy does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve
from ..dist.sharding import MeshRules, mesh_view
from .common import (ModelConfig, Params, ShapeOnly, dense_init, matmul,
                     rms_norm)
from .ssm import CHUNK, init_mamba2, init_rwkv6, mamba2_block, rwkv6_block
from .transformer import (attn_forward, block_forward, init_attn, init_mlp,
                          init_moe, mlp_forward)

ZAMBA_LORA_RANK = 64
_PAGED_FAMILIES = ("dense", "vlm")


def _periods(tree: Params, k: int) -> Params:
    """Each leaf's leading dim ``n * k`` as ``(n, k)``."""
    return {name: _periods(x, k) if isinstance(x, dict)
            else x.reshape((x.shape[0] // k, k) + tuple(x.shape[1:]))
            for name, x in tree.items()}


def _unbind(tree) -> list:
    """The trees of every leaf's ``[i]`` for each ``i`` of the leading dim,
    as views.  Autograd sends their gradients back through one stack per
    leaf, where indexing layer by layer would add a zero tensor of the
    whole leaf for every layer."""
    first = next(iter(leaves(tree)))
    per = [{} for _ in range(first.shape[0])]
    for name, x in tree.items():
        parts = _unbind(x) if isinstance(x, dict) else x.unbind(0)
        for d, part in zip(per, parts):
            d[name] = part
    return per


def full_remat(fn, *args):
    """``fn(*args)``, every activation recomputed in the backward pass.
    The blocks draw no random numbers, so no RNG state is kept for the
    recomputation (reading the card's would refuse a CUDA graph
    capture)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _block(blk, x, remat_policy, lc):
    """One block, under ``remat_policy`` when it builds no cache."""
    if remat_policy is not None and lc is None:
        return remat_policy(blk, x)
    return blk(x)


def _index(tree, i):
    """The tree of every leaf's ``[i]`` (None stays None)."""
    if tree is None:
        return None
    return {name: _index(x, i) if isinstance(x, dict) else x[i]
            for name, x in tree.items()}


def _stack(trees):
    """Stack a list of equal trees leaf by leaf along a new dim 0."""
    first = trees[0]
    return {name: _stack([t[name] for t in trees])
            if isinstance(first[name], dict)
            else torch.stack([t[name] for t in trees])
            for name in first}


def leaves(tree):
    """The tensors of a parameter or cache tree, depth first."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from leaves(v)
        else:
            yield v


def init_params(gen: Union[torch.Generator, int], cfg: ModelConfig,
                device: DeviceLike = None) -> Params:
    """Random parameters with ``repro.models.model.init_params``'s
    distributions and layout: Normal(0, 1/fan_in) matrices, zero norm
    scales.

    ``gen`` is a ``torch.Generator`` (the parameters land on its device) or
    an int seed for a new generator on ``device`` (default: the CUDA card,
    raising if there is none).  ``device="meta"`` makes the tree's shapes
    and dtypes only.  The numbers differ from JAX's for the same seed; use
    :func:`from_jax_params` to reproduce a JAX tree.  ``audio`` has no
    token embedding: its inputs are frame embeddings."""
    if not isinstance(gen, torch.Generator):
        dev = resolve(device)
        if dev.type == "meta":
            gen = ShapeOnly()
        else:
            g = torch.Generator(device=dev)
            g.manual_seed(int(gen))
            gen = g
    dt = cfg.param_dtype
    L, d = cfg.n_layers, cfg.d_model
    p: Params = {"final_ln": torch.zeros((d,), dtype=dt, device=gen.device)}
    if cfg.family != "audio":
        p["embed"] = dense_init(gen, (cfg.vocab, d), dt, fan_in=d)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (d, cfg.vocab), dt, fan_in=d)
    if cfg.family in ("dense", "audio", "vlm"):
        p["layers"] = {"attn": init_attn(gen, cfg, L),
                       "mlp": init_mlp(gen, cfg, L)}
    elif cfg.family == "moe":
        k = cfg.moe_every
        n = L // k
        layers: Params = {"moe": init_moe(gen, cfg, n),
                          "attn": _periods(init_attn(gen, cfg, L), k)}
        if k > 1:
            layers["mlp"] = _periods(init_mlp(gen, cfg, n * (k - 1)), k - 1)
        p["layers"] = layers
    elif cfg.family == "ssm":
        p["layers"] = {"rwkv": init_rwkv6(gen, cfg, L)}
    elif cfg.family == "hybrid":
        k = cfg.hybrid_attn_every
        n = L // k
        p["layers"] = {
            "mamba": _periods(init_mamba2(gen, cfg, L), k),
            # one shared transformer block, reused at every site with
            # per-site LoRA specialization (zamba2)
            "shared_attn": init_attn(gen, cfg, 1),
            "shared_mlp": init_mlp(gen, cfg, 1),
            "lora_a": dense_init(gen, (n, d, ZAMBA_LORA_RANK), dt),
            "lora_b": dense_init(gen, (n, ZAMBA_LORA_RANK, cfg.q_dim), dt,
                                 fan_in=ZAMBA_LORA_RANK),
        }
    else:
        raise ValueError(cfg.family)
    return p


def _to_torch(x: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":        # ml_dtypes' numpy bfloat16
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def from_jax_params(np_params: Dict[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None) -> Params:
    """A ``repro`` parameter tree (leaves as numpy arrays, or anything
    ``np.asarray`` takes) -> the same tree of tensors on ``device``."""
    dev = resolve(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _to_torch(node, dev)

    return walk(np_params)


def _data_axes(rules: Optional[MeshRules], mesh) -> Tuple[str, ...]:
    if mesh is None:
        return ()
    return (rules or MeshRules()).batch_axes(mesh_view(mesh))


def embed_inputs(p: Params, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor],
                 rules: Optional[MeshRules] = None,
                 mesh=None) -> torch.Tensor:
    """[frontend embeddings | token embeddings] in the compute dtype, scaled
    by sqrt(d_model) rounded to that dtype.  ``audio``: the whole input is
    the frame embeddings ``batch["embeds"]`` (the stub frontend), not
    scaled.  ``rules``/``mesh``: ``repro``'s layout hint here is the
    identity (``dist.sharding.constrain``)."""
    cd = cfg.compute_dtype
    if cfg.family == "audio":
        return batch["embeds"].to(cd)
    tok = p["embed"][batch["tokens"].long()].to(cd)
    if cfg.frontend_tokens and "embeds" in batch:
        x = torch.cat([batch["embeds"].to(cd), tok], dim=1)
    else:
        x = tok
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32)
    return x * scale.to(cd).item()


def lm_logits(p: Params, cfg: ModelConfig, x: torch.Tensor,
              rules: Optional[MeshRules] = None, mesh=None) -> torch.Tensor:
    x = rms_norm(x, p["final_ln"], cfg.norm_eps)
    head = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return matmul(x, head.to(x.dtype))


def dense_stack(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                positions, caches=None, cache_len=None, make_caches=True,
                pages=None, new_lens=None, remat_policy=None, mesh=None,
                rules=None):
    """Dense / audio / vlm stack: one block a layer.  -> (x, aux,
    caches).  With ``mesh``, paged attention shards its rows over the
    rules' data axes."""
    data_axes = _data_axes(rules, mesh)
    ks, vs = [], []
    for i, lp in enumerate(_unbind(p["layers"])):
        lc = _index(caches, i)

        def blk(x, lp=lp, lc=lc):
            return block_forward(lp, x, cfg, positions=positions, cache=lc,
                                 cache_len=cache_len, pages=pages,
                                 new_lens=new_lens, mesh=mesh,
                                 data_axes=data_axes)
        x, _, nc = _block(blk, x, remat_policy, lc)
        if caches is None and make_caches:
            ks.append(nc["k"])
            vs.append(nc["v"])
    if caches is not None:
        return x, 0.0, caches
    new = {"k": torch.stack(ks), "v": torch.stack(vs)} if make_caches \
        else None
    return x, 0.0, new


def moe_stack(p: Params, x: torch.Tensor, cfg: ModelConfig, *, positions,
              caches=None, cache_len=None, make_caches=True,
              remat_policy=None, mesh=None, rules=None, **_):
    """MoE stack: periods of ``moe_every`` layers; the last layer of each
    period is MoE, the first k-1 are dense.  Decode (``cache_len`` given)
    runs the MoE layers' dropless body.  Any ``remat_policy`` recomputes
    each block fully.  With ``mesh``, the MoE layers run expert-parallel
    with ``repro``'s flags: tokens split over "model" when the rules say
    so and no cache is given, the experts' d_ff resident over the data
    axes likewise."""
    k = cfg.moe_every
    rules = rules or MeshRules()
    data_axes = _data_axes(rules, mesh)
    split_tok = rules.split_moe_tokens and cache_len is None
    resident = rules.moe_weight_resident and cache_len is None
    remat = full_remat if remat_policy is not None else None
    aux = 0.0
    periods = []
    for i, lp in enumerate(_unbind(p["layers"])):
        attn = _unbind(lp["attn"])
        mlp = _unbind(lp["mlp"]) if k > 1 else None
        ncs = []
        for j in range(k):
            is_moe = j == k - 1
            sub = {"attn": attn[j]}
            if is_moe:
                sub["moe"] = lp["moe"]
            else:
                sub["mlp"] = mlp[j]
            cj = None if caches is None else _index(_index(caches, i), j)

            def blk(x, sub=sub, is_moe=is_moe, cj=cj):
                return block_forward(sub, x, cfg, positions=positions,
                                     is_moe=is_moe, cache=cj,
                                     cache_len=cache_len, mesh=mesh,
                                     data_axes=data_axes,
                                     split_tokens_over_model=split_tok,
                                     moe_weight_resident=resident)
            x, a, nc = _block(blk, x, remat, cj)
            aux = aux + a
            ncs.append(nc)
        if caches is None and make_caches:
            periods.append(_stack(ncs))
    if caches is not None:
        return x, aux, caches
    return x, aux, _stack(periods) if make_caches else None


def ssm_stack(p: Params, x: torch.Tensor, cfg: ModelConfig, *, caches=None,
              chunk: int = CHUNK, make_caches=True, remat_policy=None, **_):
    """RWKV-6 stack.  The blocks return new recurrent state, as
    ``repro``'s do, so the caches come back as new tensors."""
    ncs = []
    for i, lp in enumerate(_unbind(p["layers"]["rwkv"])):
        lc = _index(caches, i)

        def blk(x, lp=lp, lc=lc):
            return rwkv6_block(lp, x, cfg, cache=lc, chunk=chunk)
        x, nc = _block(blk, x, remat_policy, lc)
        ncs.append(nc)
    keep = make_caches or caches is not None
    return x, 0.0, _stack(ncs) if keep else None


def hybrid_stack(p: Params, x: torch.Tensor, cfg: ModelConfig, *, positions,
                 caches=None, cache_len=None, chunk: int = CHUNK,
                 make_caches=True, remat_policy=None, **_):
    """zamba2: periods of ``hybrid_attn_every`` mamba2 blocks followed by
    the shared attention + MLP block, whose q projection takes the site's
    LoRA delta, recomputed at every call from the parameters given.  The
    mamba state comes back as new tensors; a decode step writes the
    attention K/V into ``caches["attn"]`` in place.  Any ``remat_policy``
    recomputes each period fully."""
    k = cfg.hybrid_attn_every
    layers = p["layers"]
    shared_attn = _index(layers["shared_attn"], 0)
    shared_mlp = _index(layers["shared_mlp"], 0)
    remat = full_remat if remat_policy is not None else None
    mambas, attns = [], []
    periods = _unbind({"mamba": layers["mamba"], "lora_a": layers["lora_a"],
                       "lora_b": layers["lora_b"]})
    for i, lp in enumerate(periods):
        lc = _index(caches, i)

        def blk(x, lp=lp, lc=lc):
            ncs = []
            for j, mp in enumerate(_unbind(lp["mamba"])):
                mc = None if lc is None else _index(lc["mamba"], j)
                x, nc = mamba2_block(mp, x, cfg, cache=mc, chunk=chunk)
                ncs.append(nc)
            ap = {**shared_attn,
                  "wq": shared_attn["wq"] + matmul(lp["lora_a"],
                                                   lp["lora_b"])}
            a, nc_a = attn_forward(ap, x, cfg, positions=positions,
                                   cache=None if lc is None else lc["attn"],
                                   cache_len=cache_len)
            x = x + a
            x = x + mlp_forward(shared_mlp, x, cfg)
            return x, _stack(ncs), nc_a
        x, nc_m, nc_a = _block(blk, x, remat, lc)
        mambas.append(nc_m)
        attns.append(nc_a)
    if caches is not None:
        return x, 0.0, {"mamba": _stack(mambas), "attn": caches["attn"]}
    if not make_caches:
        return x, 0.0, None
    return x, 0.0, {"mamba": _stack(mambas), "attn": _stack(attns)}


_STACKS = {"dense": dense_stack, "audio": dense_stack, "vlm": dense_stack,
           "moe": moe_stack, "ssm": ssm_stack, "hybrid": hybrid_stack}


def forward(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            caches: Optional[Dict[str, Any]] = None,
            cache_len: Optional[torch.Tensor] = None,
            make_caches: bool = True,
            pages: Optional[torch.Tensor] = None,
            new_lens: Optional[torch.Tensor] = None,
            remat_policy=None, mesh=None,
            rules: Optional[MeshRules] = None,
            ) -> Tuple[torch.Tensor, Any, Any]:
    """Full forward pass -> (logits, aux loss, caches).

    Without ``caches``: positions 0..S-1; returns the family's new caches
    in :func:`init_caches`'s layout with a sequence dim of S (dense: the
    stacked K/V ``(L, B, S, KVH, hd)``) unless ``make_caches`` is False.
    With ``caches`` from :func:`init_caches` and a per-request
    ``cache_len`` (B,): one decode step at position ``cache_len - 1``,
    whose K/V is written into ``caches`` in place; recurrent state (RWKV,
    Mamba) comes back as new tensors, as ``repro`` returns it.

    ``pages`` switches attention to the paged data plane (``dense`` and
    ``vlm`` only, as in ``repro``): ``caches`` is the pool's page store
    from :func:`init_paged_caches` and ``pages`` the batch's (B, P) int32
    page-index matrix.  Column ``j`` sits at position ``cache_len - S + j``
    (right-aligned chunks; ``new_lens`` marks each row's valid tail;
    padding columns take position 0).  ``remat_policy``, ``mesh`` and
    ``rules`` (default ``MeshRules()``): see the module docstring."""
    if pages is not None and cfg.family not in _PAGED_FAMILIES:
        raise ValueError(f"paged decode supports dense attention caches "
                         f"only (family={cfg.family})")
    if pages is not None and caches is None:
        raise ValueError("paged forward needs the page store as caches")
    x = embed_inputs(p, cfg, batch, rules, mesh)
    S = x.shape[1]
    if cache_len is None:
        positions = torch.arange(S, device=x.device)[None]
    else:
        positions = torch.clamp(
            cache_len[:, None] - S + torch.arange(S, device=x.device)[None],
            min=0)
    x, aux, new_caches = _STACKS[cfg.family](
        p, x, cfg, positions=positions, caches=caches, cache_len=cache_len,
        make_caches=make_caches, pages=pages, new_lens=new_lens,
        remat_policy=remat_policy, mesh=mesh, rules=rules)
    return lm_logits(p, cfg, x, rules, mesh), aux, new_caches


def loss_fn(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            mesh=None, rules: Optional[MeshRules] = None,
            remat_policy=None, aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss -> (total, {"loss", "aux", "nll_mean"}): the
    mean over labelled positions (``batch["mask"]``, default all) of the
    float32 log-sum-exp minus the gold logit, plus ``aux_weight`` times
    the MoE load-balance loss.  Positions of a frontend prefix that the
    labels do not cover carry no loss."""
    logits, aux, _ = forward(p, cfg, batch, remat_policy=remat_policy,
                             make_caches=False, mesh=mesh, rules=rules)
    labels = batch["labels"].long()
    logits32 = logits.float()
    if logits32.shape[1] != labels.shape[1]:
        logits32 = logits32[:, -labels.shape[1]:]
    lse = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, labels[..., None])[..., 0]
    nll = lse - gold
    mask = batch.get("mask")
    mask = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
    loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    # a float (no MoE block) made on the device, not copied there, so a
    # CUDA graph can hold the step
    aux = aux.float() if isinstance(aux, torch.Tensor) else \
        torch.full((), aux, dtype=torch.float32, device=loss.device)
    total = loss + aux_weight * aux
    return total, {"loss": loss, "aux": aux, "nll_mean": loss}


def init_caches(cfg: ModelConfig, batch_size: int, max_seq: int,
                dtype=torch.bfloat16, device: DeviceLike = None) -> Any:
    """Zero decode caches in ``repro``'s layouts on ``device`` (default:
    the CUDA card, raising if there is none): K/V ``(L, B, S, KVH, hd)``
    (``moe``: ``(L/k, k, ...)``); RWKV token shifts ``(L, B, d)`` and
    float32 states ``(L, B, d/64, 64, 64)``; Mamba conv windows ``(n, k,
    B, MAMBA_CONV - 1, di + 2 ds)`` and float32 states ``(n, k, B, nh, ds,
    64)`` beside the shared attention's K/V ``(n, B, S, KVH, hd)``.
    ``audio`` has no decode cache and raises ``ValueError``, as in
    ``repro``."""
    B, S = batch_size, max_seq
    kvh, hd = cfg.n_kv_heads, cfg.hd
    dev = resolve(device)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    def kv(*lead):
        return {"k": zeros(lead + (B, S, kvh, hd)),
                "v": zeros(lead + (B, S, kvh, hd))}

    if cfg.family in ("dense", "vlm"):
        return kv(cfg.n_layers)
    if cfg.family == "moe":
        k = cfg.moe_every
        return kv(cfg.n_layers // k, k)
    if cfg.family == "ssm":
        H = cfg.d_model // 64
        L = cfg.n_layers
        return {"shift1": zeros((L, B, cfg.d_model)),
                "shift2": zeros((L, B, cfg.d_model)),
                "state": zeros((L, B, H, 64, 64), torch.float32)}
    if cfg.family == "hybrid":
        from .ssm import MAMBA_CONV
        k = cfg.hybrid_attn_every
        n = cfg.n_layers // k
        di = cfg.ssm_expand * cfg.d_model
        ds = cfg.ssm_state
        nh = di // 64
        return {"mamba": {
                    "conv": zeros((n, k, B, MAMBA_CONV - 1, di + 2 * ds)),
                    "state": zeros((n, k, B, nh, ds, 64), torch.float32)},
                "attn": kv(n)}
    raise ValueError(f"{cfg.family} has no decode cache")


def init_paged_caches(cfg: ModelConfig, n_pages: int, page_size: int,
                      dtype=torch.bfloat16, quantized: bool = False,
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Zero page STORE for the paged data plane: one pool of ``n_pages`` KV
    pages shared by every request, ``{"k"/"v": (L, n_pages, page_size,
    KVH, hd)}`` on ``device`` (default: the CUDA card, raising if there is
    none).  The (request -> pages) map lives in ``serving.kv_pool.KVPool``;
    requests address the store through their (B, P) page-index vectors.

    ``quantized=True`` stores the pages int8 with float32 per-(page, KV
    head) scales (``kernels.quant`` layout) as sibling leaves ``k_scale``
    / ``v_scale`` of shape (L, n_pages, KVH); ``dtype`` is then unused.
    The layer loop slices them alongside the content, and the engine's
    copy-on-write page copy moves content and scale as one unit.

    Each layer of every leaf keeps one more page behind the ``n_pages`` it
    shows, the sink that takes the writes of invalid chunk columns and
    lanes (``transformer.with_sink``); the views returned hide it.  Only
    the dense-attention families (``dense``, ``vlm``) page, as in
    ``repro``; any other raises ``ValueError``."""
    if cfg.family not in _PAGED_FAMILIES:
        raise ValueError(f"paged caches need dense attention "
                         f"(family={cfg.family})")
    kvh = cfg.n_kv_heads
    shape = (cfg.n_layers, n_pages + 1, page_size, kvh, cfg.hd)
    dev = resolve(device)
    if quantized:
        shapes = {"k": (shape, torch.int8), "v": (shape, torch.int8),
                  "k_scale": (shape[:2] + (kvh,), torch.float32),
                  "v_scale": (shape[:2] + (kvh,), torch.float32)}
    else:
        shapes = {"k": (shape, dtype), "v": (shape, dtype)}
    return {name: torch.zeros(sh, dtype=dt, device=dev)[:, :n_pages]
            for name, (sh, dt) in shapes.items()}
