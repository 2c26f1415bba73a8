"""The train step: loss -> gradients -> AdamW, with configurable
recomputation and microbatch gradient accumulation.

The port of ``repro.training.train_step``: gradients come from
``torch.autograd`` over the parameter leaves.  :func:`make_train_step`
runs eagerly; :func:`jit_train_step` is the same step as one CUDA graph
that updates the trees in place, where ``repro``'s call sites ``jax.jit``
it.

Both take ``repro``'s ``mesh`` and ``rules``.  With a mesh of ranks
(``launch.mesh``), the step is data-parallel: each rank takes its rows of
each microbatch over the rules' data axes (``dist.sharding.batch_spec``),
computes its share of the loss and its gradients with the one-device
model, and the shares sum over the data axes (one ``all_reduce`` per
axis), so every rank applies ``repro``'s update: the microbatch's mean
NLL over its labelled positions, and its MoE layers' capacity counted on
each data shard's tokens with the mean of the shards' aux losses, as
``repro``'s ``shard_map`` counts and averages them.  Over a "model" axis
larger than one the ranks replicate the dense work; an MoE config there
is refused, since ``repro`` splits its tokens over "model" too
(expert-parallel training waits for gradients through the all-to-alls,
ROADMAP.md).  Executing ``param_specs``/``zero1_specs`` as sharded
storage (tensor parallel, FSDP, ZeRO-1) is ROADMAP work too.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..dist.sharding import (MeshRules, batch_spec, bound, data_shards,
                             local_batch, mesh_view, psum)
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


def _data_parallel(cfg: ModelConfig, mesh, rules: Optional[MeshRules]):
    """-> (rules, data axes) of a meshed step; refuses what it cannot
    hold to ``repro``'s value (see the module docstring)."""
    rules = rules if rules is not None else MeshRules()
    view = mesh_view(mesh)
    if cfg.family == "moe" and view.shape.get("model", 1) > 1:
        raise ValueError("a meshed train step of an MoE config runs on a "
                         "\"model\" axis of 1: expert-parallel training "
                         "waits for gradients through the all-to-alls")
    return rules, rules.batch_axes(view)


def _positions(batch: Dict[str, Any]):
    """What ``loss_fn`` divides a batch's summed NLL by: its labelled
    positions, at least 1."""
    mask = batch.get("mask")
    if mask is None:
        return float(max(batch["labels"].numel(), 1))
    return torch.clamp(mask.float().sum(), min=1.0)


def _make_compute_grads(cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                        rules: Optional[MeshRules] = None):
    """-> ``compute_grads(params, batch) -> (loss, grads)``: autograd over
    the leaves, microbatches accumulated in ``accum_dtype`` in ``repro``'s
    order; ``batch`` lies on the parameters' device.

    With ``mesh``, each microbatch of the global batch splits over the
    rules' data axes (when its rows divide).  A rank's rows give its share
    of the microbatch's loss: their labelled positions' share of the mean
    NLL, plus 1/D of the auxiliary term (``repro``'s MoE takes the mean of
    its shards' aux losses).  The shares' gradients and losses then sum
    over the data axes, one ``all_reduce`` per axis, so every rank holds
    ``repro``'s value."""
    policy = remat_policy_by_name(tcfg.remat)
    if mesh is not None:
        rules, axes = _data_parallel(cfg, mesh, rules)
        n_data = data_shards(rules, mesh)

    def split(batch) -> bool:
        return mesh is not None and batch_spec(
            rules, mesh, tuple(batch["labels"].shape))[0] is not None

    def grad_fn(leaves, treedef, batch):
        ps = [p.detach().requires_grad_(True) for p in leaves]
        local = local_batch(batch, rules, mesh) if split(batch) else batch
        total, m = M.loss_fn(tree_unflatten(treedef, ps), cfg, local,
                             remat_policy=policy,
                             aux_weight=tcfg.aux_weight)
        if local is not batch:
            total = m["loss"] * (_positions(local) / _positions(batch)) \
                + (total - m["loss"]) / n_data
        gs = torch.autograd.grad(total, ps, allow_unused=True)
        return total.detach(), [torch.zeros_like(p) if g is None else g
                                for p, g in zip(ps, gs)]

    def reduced(batch, l, g):
        """Sum the ranks' shares over the data axes."""
        if not split(batch):
            return l, g
        with bound(mesh):
            return psum(l, axes), [psum(x, axes) for x in g]

    def compute_grads(params, batch):
        leaves, treedef = tree_flatten(params)
        if tcfg.microbatches <= 1:
            l, g = reduced(batch, *grad_fn(leaves, treedef, batch))
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
        l, acc = reduced(mb, ltot, acc)
        return l / n, tree_unflatten(treedef, [a.div_(n) for a in acc])

    return compute_grads


def make_train_step(cfg: ModelConfig, opt: OptimizerConfig, mesh=None,
                    rules: Optional[MeshRules] = None,
                    tcfg: TrainConfig = TrainConfig()):
    """Returns ``train_step(params, opt_state, batch) -> (params', state',
    metrics)``.  ``batch`` holds ``labels`` and ``tokens`` (or the audio
    family's ``embeds``), as tensors or numpy arrays; they move to the
    parameters' device.  ``metrics["loss"]`` is the total loss (with the
    auxiliary term), averaged over microbatches, as in ``repro``.  The
    step is pure and eager: the trees it is given stay as they were.
    ``mesh``/``rules``: data parallel over the rules' data axes, every
    rank given the global batch and the same trees (module docstring)."""
    compute_grads = _make_compute_grads(cfg, tcfg, mesh, rules)

    def train_step(params, opt_state, batch):
        l, grads = compute_grads(params, _on(batch, _device(params)))
        new_params, new_state, gnorm = adamw_update(params, grads, opt_state,
                                                    opt)
        metrics = {"loss": l, "grad_norm": gnorm, "step": new_state["step"]}
        return new_params, new_state, metrics

    return train_step


def jit_train_step(cfg: ModelConfig, opt: OptimizerConfig, mesh=None,
                   rules: Optional[MeshRules] = None,
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
    ``reset()``).  ``mesh``/``rules`` as :func:`make_train_step`'s; the
    graph then holds the gradients' all-reduces, which the first, eager
    call warms up."""
    compute_grads = _make_compute_grads(cfg, tcfg, mesh, rules)

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
