"""AdamW with cosine or WSD (warmup-stable-decay, MiniCPM) schedules, over
trees of tensors.

The port of ``repro.training.optimizer``, arithmetic for arithmetic: the
global-norm clip over every leaf, the bias corrections, weight decay
inside the update, and the update math in bf16 when the state is bf16
(``state_dtype``), each constant rounded to that dtype first as JAX
rounds a weakly typed Python float.  The results come back in each
leaf's own dtype.  ``torch.optim.AdamW`` is not used: its decay and clip
differ from ``repro``'s.  The state tree is ``{"m", "v", "step"}``, so
``ft.checkpoint`` saves and loads it in ``repro``'s format.

Given a sharded train step's specs, :func:`adamw_update` (and ``_``, in
place) updates this rank's blocks: the parameters and gradients laid out
by ``param_specs``, the moments by ``zero1_specs``.  The clip's
norm sums each leaf's squares over its block, then sums that over the
axes the leaf is sharded on (one ``psum``), so every element counts once:
a block replicated over an axis is not counted again along it.  Where a
moment's spec adds "data" to a leaf whose parameter spec lacks it
(ZeRO-1), the rank updates that moment block and the matching slice of
the parameter, then all-gathers the new slice over "data" back to the
parameter's block.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Optional, Tuple

import torch

from ..dist.sharding import (P, block_shape, bound, psum, shard_block,
                             spec_axes, spec_leaves, unshard_tree)
from ..ft.checkpoint import tree_flatten, tree_unflatten


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"          # "cosine" | "wsd" | "const"
    wsd_decay_frac: float = 0.1       # MiniCPM: last 10% decays
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: Any = torch.float32  # bf16 for the 400B config


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), float32."""
    s = torch.as_tensor(step).float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "cosine":
        t = torch.clamp((s - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        mult = 0.5 * (1 + torch.cos(math.pi * t))
    elif cfg.schedule == "wsd":
        decay_start = cfg.total_steps * (1.0 - cfg.wsd_decay_frac)
        t = torch.clamp((s - decay_start)
                        / max(cfg.total_steps - decay_start, 1), 0.0, 1.0)
        mult = torch.exp(-4.0 * t)    # ~exponential anneal (MiniCPM WSD)
    else:
        mult = 1.0
    return cfg.lr * warm * mult


def adamw_init(params: Any, cfg: OptimizerConfig) -> Any:
    """Zero first and second moments in ``state_dtype`` beside each leaf,
    and the step count, an int32 scalar on the parameters' device."""
    leaves, treedef = tree_flatten(params)

    def zeros():
        return tree_unflatten(treedef, [
            torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)
            for p in leaves])

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves[0].device)}


def squares(grads: Any) -> list:
    """Each leaf's float32 sum of squared gradients, in leaf order.
    ``torch.sum`` keeps a float32 sum over 2.6e8 elements accurate
    (vector_norm's CPU kernel drifted by 5e-5 there)."""
    return [torch.sum(torch.square(g.float())) for g in tree_flatten(grads)[0]]


def _adamw(params: Any, grads: Any, state: Any, cfg: OptimizerConfig,
           sq: Optional[list] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, Iterator[tuple]]:
    """-> (the new step count, the global gradient norm, an iterator of
    ``(p, m, v, new p, new m, new v)`` a leaf).  Everything the iterator
    reads besides its own leaf is computed before it starts, so a caller
    may write each leaf's new values in place as they come.  ``sq``: each
    leaf's sum of squares for the global-norm clip (default
    :func:`squares` of ``grads``; a sharded step passes the sums of the
    whole leaves)."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    ps = tree_flatten(params)[0]
    gs = tree_flatten(grads)[0]
    ms = tree_flatten(state["m"])[0]
    vs = tree_flatten(state["v"])[0]
    # global-norm clip
    gnorm = torch.sqrt(sum(squares(grads) if sq is None else sq))
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    sd = cfg.state_dtype
    # bf16 state runs the update math in bf16, as repro's does
    cd = torch.float32 if sd == torch.float32 else torch.bfloat16

    def c(x):
        """A Python constant as JAX takes it beside a ``cd`` array, filled
        on the device (a copy from the host would refuse a CUDA graph)."""
        return torch.full((), x, dtype=cd, device=step.device)

    b1, b2, eps, wd = c(cfg.b1), c(cfg.b2), c(cfg.eps), c(cfg.weight_decay)
    b1c, b2c = c(1 - cfg.b1), c(1 - cfg.b2)
    s32 = step.float()
    bc1 = (1 - cfg.b1 ** s32).to(cd)
    bc2 = (1 - cfg.b2 ** s32).to(cd)
    lr_c, scale_c = lr.to(cd), scale.to(cd)

    def leaves():
        for p, g, m, v in zip(ps, gs, ms, vs):
            g = g.to(cd) * scale_c
            m32 = m.to(cd) * b1 + b1c * g
            v32 = v.to(cd) * b2 + b2c * torch.square(g)
            mh = m32 / bc1
            vh = v32 / bc2
            delta = mh / (torch.sqrt(vh) + eps) + wd * p.to(cd)
            yield (p, m, v, (p.to(cd) - lr_c * delta).to(p.dtype),
                   m32.to(sd), v32.to(sd))

    return step, gnorm, leaves()


def _update(params, grads, state, cfg, specs, mesh):
    if specs is None:
        return _adamw(params, grads, state, cfg)
    return _sharded(params, grads, state, cfg, specs[0], specs[1]["m"],
                    mesh)


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: Any, cfg: OptimizerConfig,
                 specs=None, mesh=None) -> Tuple[Any, Any, torch.Tensor]:
    """-> (new params, new state, the global gradient norm).  Leaves are
    taken in ``repro``'s order (dicts by sorted key), which orders the
    norm's sum as ``jax.tree.leaves`` does.  ``specs`` (the pair
    ``training.train_step.train_specs`` returns) and ``mesh``: the trees
    are this rank's blocks, updated as the module docstring says; the
    norm is the same on every rank."""
    step, gnorm, leaves = _update(params, grads, state, cfg, specs, mesh)
    newp, newm, newv = [], [], []
    for *_, p1, m1, v1 in leaves:
        newp.append(p1)
        newm.append(m1)
        newv.append(v1)
    treedef = tree_flatten(params)[1]
    return (tree_unflatten(treedef, newp),
            {"m": tree_unflatten(treedef, newm),
             "v": tree_unflatten(treedef, newv), "step": step},
            gnorm)


@torch.no_grad()
def adamw_update_(params: Any, grads: Any, state: Any, cfg: OptimizerConfig,
                  specs=None, mesh=None) -> torch.Tensor:
    """:func:`adamw_update` written into ``params`` and ``state`` in place,
    leaf by leaf (no second tree exists at once), as a donated step does.
    -> the global gradient norm."""
    step, gnorm, leaves = _update(params, grads, state, cfg, specs, mesh)
    for p, m, v, p1, m1, v1 in leaves:
        p.copy_(p1)
        m.copy_(m1)
        v.copy_(v1)
    state["step"].copy_(step)
    return gnorm


def sharded_adamw_init(params_shape: Any, mspecs: Any, mesh,
                       cfg: OptimizerConfig, device) -> Any:
    """Zero moments as this rank's blocks under ``mspecs`` (the
    ``zero1_specs`` of ``params_shape``, a tree of whole shapes, e.g.
    meta tensors), and the replicated step count; no whole moment
    exists."""
    leaves, treedef = tree_flatten(params_shape)

    def zeros():
        return tree_unflatten(treedef, [
            torch.zeros(block_shape(p.shape, s, mesh), dtype=cfg.state_dtype,
                        device=device)
            for p, s in zip(leaves, spec_leaves(mspecs))])

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _zero1(pspec: P, mspec: P) -> P:
    """The entries a moment's spec adds to its parameter's (ZeRO-1)."""
    return P(*[m if p is None else None
               for p, m in zip(tuple(pspec), tuple(mspec))])


def _sharded(params, grads, state, cfg, pspecs, mspecs, mesh):
    """-> (step, gnorm, iterator of (p, m, v, new p block, new m, new v))
    on blocks; see the module docstring."""
    ps, treedef = tree_flatten(params)
    gs = tree_flatten(grads)[0]
    pl, ml = spec_leaves(pspecs), spec_leaves(mspecs)
    sq = squares(gs)
    groups = {}
    for i, s in enumerate(pl):
        groups.setdefault(spec_axes(s), []).append(i)
    extra = [_zero1(a, b) for a, b in zip(pl, ml)]
    with bound(mesh):
        for axes, idx in groups.items():
            if axes:
                summed = psum(torch.stack([sq[i] for i in idx]), axes)
                for j, i in enumerate(idx):
                    sq[i] = summed[j]
        step, gnorm, leaves = _adamw(
            [shard_block(p, e, mesh) for p, e in zip(ps, extra)],
            [shard_block(g, e, mesh) for g, e in zip(gs, extra)],
            state, cfg, sq=sq)

    def blocks():
        for (p_sl, m, v, p1, m1, v1), e, p in zip(leaves, extra, ps):
            yield p, m, v, unshard_tree(p1, e, mesh), m1, v1

    return step, gnorm, blocks()

