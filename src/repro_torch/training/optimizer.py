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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Tuple

import torch

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


def _adamw(params: Any, grads: Any, state: Any, cfg: OptimizerConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, Iterator[tuple]]:
    """-> (the new step count, the global gradient norm, an iterator of
    ``(p, m, v, new p, new m, new v)`` a leaf).  Everything the iterator
    reads besides its own leaf is computed before it starts, so a caller
    may write each leaf's new values in place as they come."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    ps = tree_flatten(params)[0]
    gs = tree_flatten(grads)[0]
    ms = tree_flatten(state["m"])[0]
    vs = tree_flatten(state["v"])[0]
    # global-norm clip; torch.sum keeps a float32 sum over 2.6e8 elements
    # accurate (vector_norm's CPU kernel drifted by 5e-5 there)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in gs))
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


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: Any,
                 cfg: OptimizerConfig) -> Tuple[Any, Any, torch.Tensor]:
    """-> (new params, new state, the global gradient norm).  Leaves are
    taken in ``repro``'s order (dicts by sorted key), which orders the
    norm's sum as ``jax.tree.leaves`` does."""
    step, gnorm, leaves = _adamw(params, grads, state, cfg)
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
def adamw_update_(params: Any, grads: Any, state: Any,
                  cfg: OptimizerConfig) -> torch.Tensor:
    """:func:`adamw_update` written into ``params`` and ``state`` in place,
    leaf by leaf (no second tree exists at once), as a donated step does.
    -> the global gradient norm."""
    step, gnorm, leaves = _adamw(params, grads, state, cfg)
    for p, m, v, p1, m1, v1 in leaves:
        p.copy_(p1)
        m.copy_(m1)
        v.copy_(v1)
    state["step"].copy_(step)
    return gnorm
