"""Model assembly in plain PyTorch: parameter init, the forward pass and
decode caches for the dense families (``dense``, ``vlm``).

The port of ``repro.models.model`` for those families.  Parameters keep
``repro``'s pytree layout (nested dicts; layer stacks with a leading ``L``
dim), so :func:`from_jax_params` carries a JAX parameter tree across leaf
by leaf, and the layer stack is a Python loop where ``repro`` used
``lax.scan``.  The paged page store (:func:`init_paged_caches`) is the
scheduler's data plane; its quantized layout and the MoE, SSM, hybrid and
audio families come with later slices.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve
from .common import ModelConfig, Params, dense_init, matmul, rms_norm
from .transformer import block_forward, init_attn, init_mlp

_FAMILIES = ("dense", "vlm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md); the "
            f"port runs {_FAMILIES}")


def init_params(gen: Union[torch.Generator, int], cfg: ModelConfig,
                device: DeviceLike = None) -> Params:
    """Random parameters with ``repro.models.model.init_params``'s
    distributions: Normal(0, 1/fan_in) matrices, zero norm scales.

    ``gen`` is a ``torch.Generator`` (the parameters land on its device) or
    an int seed for a new generator on ``device`` (default: the CUDA card,
    raising if there is none).  The numbers differ from JAX's for the same
    seed; use :func:`from_jax_params` to reproduce a JAX tree."""
    _check_family(cfg)
    if not isinstance(gen, torch.Generator):
        g = torch.Generator(device=resolve(device))
        g.manual_seed(int(gen))
        gen = g
    dt = cfg.param_dtype
    L, d = cfg.n_layers, cfg.d_model
    p: Params = {"final_ln": torch.zeros((d,), dtype=dt, device=gen.device),
                 "embed": dense_init(gen, (cfg.vocab, d), dt, fan_in=d)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (d, cfg.vocab), dt, fan_in=d)
    p["layers"] = {"attn": init_attn(gen, cfg, L),
                   "mlp": init_mlp(gen, cfg, L)}
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
    _check_family(cfg)
    dev = resolve(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _to_torch(node, dev)

    return walk(np_params)


def embed_inputs(p: Params, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[frontend embeddings | token embeddings] in the compute dtype, scaled
    by sqrt(d_model) rounded to that dtype."""
    cd = cfg.compute_dtype
    tok = p["embed"][batch["tokens"].long()].to(cd)
    if cfg.frontend_tokens and "embeds" in batch:
        x = torch.cat([batch["embeds"].to(cd), tok], dim=1)
    else:
        x = tok
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32)
    return x * scale.to(cd).item()


def lm_logits(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, p["final_ln"], cfg.norm_eps)
    head = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return matmul(x, head.to(x.dtype))


def forward(p: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            caches: Optional[Dict[str, torch.Tensor]] = None,
            cache_len: Optional[torch.Tensor] = None,
            make_caches: bool = True,
            pages: Optional[torch.Tensor] = None,
            new_lens: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, Any, Any]:
    """Full forward pass -> (logits, aux loss, caches).

    Without ``caches``: positions 0..S-1; returns the stacked new K/V
    (``(L, B, S, KVH, hd)`` each) unless ``make_caches`` is False.  With
    ``caches`` from :func:`init_caches` and a per-request ``cache_len``
    (B,): one decode step at position ``cache_len - 1``, whose K/V is
    written into ``caches`` in place.

    ``pages`` switches attention to the paged data plane: ``caches`` is
    the pool's page store from :func:`init_paged_caches` and ``pages`` the
    batch's (B, P) int32 page-index matrix.  Column ``j`` sits at position
    ``cache_len - S + j`` (right-aligned chunks; ``new_lens`` marks each
    row's valid tail; padding columns take position 0)."""
    _check_family(cfg)
    if pages is not None and caches is None:
        raise ValueError("paged forward needs the page store as caches")
    x = embed_inputs(p, cfg, batch)
    S = x.shape[1]
    if cache_len is None:
        positions = torch.arange(S, device=x.device)[None]
    else:
        positions = torch.clamp(
            cache_len[:, None] - S + torch.arange(S, device=x.device)[None],
            min=0)
    layers = p["layers"]
    ks, vs = [], []
    aux = 0.0
    for i in range(cfg.n_layers):
        lp = {name: {k: w[i] for k, w in sub.items()}
              for name, sub in layers.items()}
        lc = None if caches is None else {k: c[i] for k, c in caches.items()}
        x, a, nc = block_forward(lp, x, cfg, positions=positions, cache=lc,
                                 cache_len=cache_len, pages=pages,
                                 new_lens=new_lens)
        aux = aux + a
        if caches is None and make_caches:
            ks.append(nc["k"])
            vs.append(nc["v"])
    logits = lm_logits(p, cfg, x)
    if caches is not None:
        new_caches = caches
    elif make_caches:
        new_caches = {"k": torch.stack(ks), "v": torch.stack(vs)}
    else:
        new_caches = None
    return logits, aux, new_caches


def init_caches(cfg: ModelConfig, batch_size: int, max_seq: int,
                dtype=torch.bfloat16,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Zero decode caches ``{"k"/"v": (L, B, S, KVH, hd)}`` on ``device``
    (default: the CUDA card, raising if there is none)."""
    _check_family(cfg)
    shape = (cfg.n_layers, batch_size, max_seq, cfg.n_kv_heads, cfg.hd)
    dev = resolve(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


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
    lanes (``transformer.with_sink``); the views returned hide it."""
    _check_family(cfg)
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
