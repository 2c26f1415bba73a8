"""The train step: loss -> gradients -> AdamW, with configurable
recomputation and microbatch gradient accumulation.

The port of ``repro.training.train_step`` on one card: gradients come from
``torch.autograd`` over the parameter leaves.  :func:`make_train_step`
runs eagerly; :func:`jit_train_step` is the same step as one CUDA graph
that updates the trees in place, where ``repro``'s call sites ``jax.jit``
it.  ``repro`` takes a mesh and sharding rules; on one card there is
nothing to shard, so the port's takes neither.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ft.checkpoint import tree_flatten, tree_unflatten
from ..models import model as M
from ..models.common import ModelConfig
from ..serving.steps import jit_step
from .optimizer import OptimizerConfig, adamw_update, adamw_update_

_aten = torch.ops.aten
# the outputs of the weight and attention products, as JAX's dots_saveable
# and dots_with_no_batch_dims_saveable name them
DOTS = (_aten.mm.default, _aten.addmm.default, _aten.bmm.default)
DOTS_NO_BATCH = (_aten.mm.default, _aten.addmm.default)


def _saving(ops, fn, *args):
    ctx = functools.partial(create_selective_checkpoint_contexts, list(ops))
    return checkpoint(fn, *args, use_reentrant=False, context_fn=ctx,
                      preserve_rng_state=False)   # as ``M.full_remat``


def remat_policy_by_name(name: str) -> Optional[Callable]:
    """The recomputation policy ``repro``'s name stands for, as a callable
    ``policy(fn, *args)`` that returns ``fn(*args)``: ``none`` keeps every
    activation (None), ``full`` recomputes everything, ``dots`` keeps the
    outputs of ``mm``/``addmm``/``bmm`` and recomputes the rest,
    ``dots_no_batch`` keeps only ``mm``/``addmm``."""
    return {
        "none": None,
        "full": M.full_remat,
        "dots": functools.partial(_saving, DOTS),
        "dots_no_batch": functools.partial(_saving, DOTS_NO_BATCH),
    }[name]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    remat: str = "full"
    microbatches: int = 1
    aux_weight: float = 0.01
    accum_dtype: str = "float32"   # bf16 for the 400B config (memory fit)


def _on(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """The batch's arrays (tensors or numpy) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _device(params) -> torch.device:
    return tree_flatten(params)[0][0].device


def _make_compute_grads(cfg: ModelConfig, tcfg: TrainConfig):
    """-> ``compute_grads(params, batch) -> (loss, grads)``: autograd over
    the leaves, microbatches accumulated in ``accum_dtype`` in ``repro``'s
    order; ``batch`` lies on the parameters' device."""
    policy = remat_policy_by_name(tcfg.remat)

    def grad_fn(leaves, treedef, batch):
        ps = [p.detach().requires_grad_(True) for p in leaves]
        total, _ = M.loss_fn(tree_unflatten(treedef, ps), cfg, batch,
                             remat_policy=policy,
                             aux_weight=tcfg.aux_weight)
        gs = torch.autograd.grad(total, ps, allow_unused=True)
        return total.detach(), [torch.zeros_like(p) if g is None else g
                                for p, g in zip(ps, gs)]

    def compute_grads(params, batch):
        leaves, treedef = tree_flatten(params)
        if tcfg.microbatches <= 1:
            l, g = grad_fn(leaves, treedef, batch)
            return l, tree_unflatten(treedef, g)
        n = tcfg.microbatches
        acc_dt = getattr(torch, tcfg.accum_dtype)
        acc = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
               for p in leaves]
        ltot = torch.zeros((), device=leaves[0].device)
        for i in range(n):
            mb = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            l, g = grad_fn(leaves, treedef, mb)
            for a, x in zip(acc, g):
                a.add_(x.to(acc_dt))
            ltot = ltot + l
            del g
        return ltot / n, tree_unflatten(treedef, [a.div_(n) for a in acc])

    return compute_grads


def make_train_step(cfg: ModelConfig, opt: OptimizerConfig,
                    tcfg: TrainConfig = TrainConfig()):
    """Returns ``train_step(params, opt_state, batch) -> (params', state',
    metrics)``.  ``batch`` holds ``labels`` and ``tokens`` (or the audio
    family's ``embeds``), as tensors or numpy arrays; they move to the
    parameters' device.  ``metrics["loss"]`` is the total loss (with the
    auxiliary term), averaged over microbatches, as in ``repro``.  The
    step is pure and eager: the trees it is given stay as they were."""
    compute_grads = _make_compute_grads(cfg, tcfg)

    def train_step(params, opt_state, batch):
        l, grads = compute_grads(params, _on(batch, _device(params)))
        new_params, new_state, gnorm = adamw_update(params, grads, opt_state,
                                                    opt)
        metrics = {"loss": l, "grad_norm": gnorm, "step": new_state["step"]}
        return new_params, new_state, metrics

    return train_step


def jit_train_step(cfg: ModelConfig, opt: OptimizerConfig,
                   tcfg: TrainConfig = TrainConfig()):
    """:func:`make_train_step`'s step as ``repro``'s call sites run it,
    under ``jax.jit`` with the trees donated: on the card one CUDA graph
    (``serving.steps.jit_step``) that writes the new parameters and
    optimizer state into the trees it is given, leaf by leaf
    (``optimizer.adamw_update_``), and returns those same trees.

    So a caller rebinds its names to the results, ``params, state, m =
    step(params, state, batch)``, and reads no tree it passed in as the
    tree before the step.  Passing the same trees back keeps the graph's
    key (the trees by identity, the batch by shape and dtype): the first
    call with new trees (a restore) runs eagerly, the second captures,
    later calls replay.  The batch moves to the parameters' device before
    the graph copies it in.  The same values as :func:`make_train_step`;
    on CPU tensors the step runs eagerly, in place.  ``.graph`` is the
    :class:`~repro_torch.serving.steps.GraphedStep` (its ``stats``,
    ``reset()``)."""
    compute_grads = _make_compute_grads(cfg, tcfg)

    def train_step_(params, opt_state, batch):
        l, grads = compute_grads(params, batch)
        gnorm = adamw_update_(params, grads, opt_state, opt)
        return params, opt_state, {"loss": l, "grad_norm": gnorm,
                                   "step": opt_state["step"]}

    graph = jit_step(train_step_, donate_argnums=(0, 1))

    @functools.wraps(train_step_)
    def train_step(params, opt_state, batch):
        return graph(params, opt_state, _on(batch, _device(params)))

    train_step.graph = graph
    return train_step
