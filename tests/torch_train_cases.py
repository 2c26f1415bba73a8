"""Shared cases for the training tests (tests/test_torch_train_*.py): the
same parameters in both packages (``repro``'s init, carried across with
``from_jax_params``), seeded numpy batches for every family, and the
comparison helpers."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh

from repro import configs as JC
from repro.dist.sharding import MeshRules
from repro.models import model as JM
from repro_torch import configs as TC
from repro_torch.ft.checkpoint import tree_flatten
from repro_torch.models import model as TM

MESH = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
RULES = MeshRules()


@functools.lru_cache(maxsize=None)
def models(arch, compute="float32", param=None, seed=0):
    """(jax cfg, torch cfg, jax params, torch params) of ``arch``'s smoke
    config at ``compute`` dtype (and ``param`` dtype, default the
    config's), from ``repro``'s init at PRNGKey(seed)."""
    jkw = {"compute_dtype": getattr(jnp, compute)}
    tkw = {"compute_dtype": getattr(torch, compute)}
    if param is not None:
        jkw["param_dtype"] = getattr(jnp, param)
        tkw["param_dtype"] = getattr(torch, param)
    cj = dataclasses.replace(JC.get_smoke(arch), **jkw)
    ct = dataclasses.replace(TC.get_smoke(arch), **tkw)
    jp = jax.jit(JM.init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), cj)
    tp = TM.from_jax_params(jax.tree.map(np.asarray, jp), ct, device="cpu")
    return cj, ct, jp, tp


def batch(cfg, seed, B=4, S=16, mask=False):
    """A numpy batch for ``cfg``'s family: frame embeddings (audio), image
    embeddings and text tokens (vlm), or tokens; labels over all S
    positions; with ``mask``, a random 0/1 float32 mask over them."""
    rng = np.random.default_rng(seed)
    b = {}
    if cfg.family == "audio":
        b["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    elif cfg.frontend_tokens:
        F = cfg.frontend_tokens
        b["tokens"] = rng.integers(0, cfg.vocab, (B, S - F)).astype(np.int32)
        b["embeds"] = rng.normal(size=(B, F, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    b["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if mask:
        b["mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return b


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def pairs(jtree, ttree):
    """(path, jax leaf, port leaf) for every leaf, in ``jax.tree.leaves``
    order, which the port's ``tree_flatten`` shares."""
    jl = jax.tree_util.tree_leaves_with_path(jtree)
    tl = tree_flatten(ttree)[0]
    assert len(jl) == len(tl)
    for (path, j), t in zip(jl, tl):
        yield jax.tree_util.keystr(path), j, t


def rel_err(got, want):
    """max |got - want| over max |want| (0 when both are all zero)."""
    got, want = np32(got), np32(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    return float(err / scale) if scale else float(err)
