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
larger than one the ranks replicate the dense work.

An MoE config on a "model" axis larger than one trains expert-parallel,
as ``repro`` does: every rank runs ``loss_fn`` with the mesh on the whole
microbatch, so the dense parts run whole on every rank and each MoE layer
dispatches its rank's tokens (over the data axes and "model") to the
experts over "model" through the all-to-alls.  The gradients come back
through the collectives' backwards (``dist.sharding.shard_map_compat``):
a leaf every rank computed whole is reduced over no axis, the experts'
blocks are assembled over "model" (and their d_ff blocks over the data
axes where the weights are resident), the router's per-rank parts summed
over every axis.  So every rank holds ``repro``'s gradient at the same
mesh shape, with capacity and the aux loss counted per shard, and applies
the same update.

``sharded=True`` (a dense, vlm or audio config whose rules use flash
attention without ``residual_seq``) executes the layout
``launch/dryrun.py`` gives ``repro``'s jitted step: parameters by
``param_specs``, the AdamW moments by ``zero1_specs`` with the step count
replicated, the batch by its batch spec (:func:`train_specs`).  The step
takes and returns this rank's blocks, and the collectives XLA's
partitioner inserts for those specs run explicitly: each layer's blocks
are gathered over ``rules.fsdp`` inside its recomputed block, attention
and the MLP run tensor-parallel over "model", the embedding and the
cross-entropy over vocab shards (``models.model``).  Each rank's loss is
its rows' share, divided by the number of ranks that compute the same
rows, so the ranks' losses sum to ``repro``'s; with every collective's
backward its transpose, each block's gradient then comes back through
the gathers' reduce-scatters, and is summed (``psum``) over the mesh axes
its spec does not name, the ranks that hold copies of the block.  The
update is ``optimizer.adamw_update`` given the specs.  Other families and
layouts raise ``NotImplementedError`` naming what is missing; none falls
back to whole weights.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..dist.sharding import (MeshRules, P, batch_spec, bound, data_shards,
                             local_batch, mesh_view, param_specs, psum,
                             spec_axes, spec_leaves, zero1_specs)
from ..ft.checkpoint import tree_flatten, tree_unflatten
from ..models import model as M
from ..models.common import ModelConfig
from ..serving.steps import jit_mesh_step
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


def _layout(cfg: ModelConfig, mesh, rules: Optional[MeshRules]):
    """-> (rules, data axes, expert-parallel) of a meshed step (see the
    module docstring)."""
    rules = rules if rules is not None else MeshRules()
    view = mesh_view(mesh)
    ep = cfg.family == "moe" and view.shape.get("model", 1) > 1
    return rules, rules.batch_axes(view), ep


def _positions(batch: Dict[str, Any]) -> torch.Tensor:
    """What ``loss_fn`` divides a batch's summed NLL by: its labelled
    positions, at least 1, as a float32 tensor on the labels' device."""
    mask = batch.get("mask")
    if mask is None:
        labels = batch["labels"]
        return torch.full((), float(max(labels.numel(), 1)),
                          device=labels.device)
    return torch.clamp(mask.float().sum(), min=1.0)


def _share(total, m, local, batch, n: int):
    """A rank's share of ``batch``'s loss from ``loss_fn`` on its rows
    ``local``: their labelled positions' share of the mean NLL, plus 1/n
    of the auxiliary term (``repro``'s MoE takes the mean of its shards'
    aux losses), over ``n`` ranks splitting the rows."""
    return m["loss"] * (_positions(local) / _positions(batch)) \
        + (total - m["loss"]) / n


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
    ``repro``'s value.  Expert-parallel (an MoE config on a "model" axis
    above 1): ``loss_fn`` runs with the mesh on the whole microbatch and
    its gradients come back whole through the collectives' backwards, so
    nothing is split or summed here."""
    policy = remat_policy_by_name(tcfg.remat)
    ep = False
    if mesh is not None:
        rules, axes, ep = _layout(cfg, mesh, rules)
        n_data = data_shards(rules, mesh)

    def split(batch) -> bool:
        return mesh is not None and not ep and batch_spec(
            rules, mesh, tuple(batch["labels"].shape))[0] is not None

    def grad_fn(leaves, treedef, batch):
        ps = [p.detach().requires_grad_(True) for p in leaves]
        local = local_batch(batch, rules, mesh) if split(batch) else batch
        total, m = M.loss_fn(tree_unflatten(treedef, ps), cfg, local,
                             remat_policy=policy,
                             aux_weight=tcfg.aux_weight,
                             mesh=mesh if ep else None,
                             rules=rules if ep else None)
        if local is not batch:
            total = _share(total, m, local, batch, n_data)
        gs = torch.autograd.grad(total, ps, allow_unused=True)
        return total.detach(), [torch.zeros_like(p) if g is None else g
                                for p, g in zip(ps, gs)]

    def reduced(batch, l, g):
        """Sum the ranks' shares over the data axes."""
        if not split(batch):
            return l, g
        with bound(mesh):
            return psum(l, axes), [psum(x, axes) for x in g]

    return _accumulated(tcfg, grad_fn, reduced)


def _accumulated(tcfg: TrainConfig, grad_fn, reduced):
    """-> ``compute_grads(params, batch)``: ``grad_fn(leaves, treedef,
    microbatch) -> (loss, gradients)`` over ``tcfg.microbatches``
    microbatches, accumulated in ``accum_dtype`` in ``repro``'s order,
    then ``reduced(microbatch, loss, gradients)`` across ranks, then the
    mean."""

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


def train_specs(cfg: ModelConfig, rules: MeshRules, mesh):
    """-> (parameter specs, optimizer-state specs) of the sharded step,
    derived as ``repro``'s ``launch/dryrun.py`` derives them: the params
    by ``param_specs``, ``{"m", "v"}`` by ``zero1_specs`` and ``"step"``
    replicated.  Raises ``NotImplementedError`` naming each layout of
    ``cfg``/``rules`` the step does not execute yet."""
    pshape = M.init_params(0, cfg, device="meta")
    pspecs = param_specs(pshape, rules, mesh)
    M.refuse_layouts("sharded=True", cfg, rules, mesh, pspecs)
    mspecs = zero1_specs(pspecs, pshape, mesh)
    return pspecs, {"m": mspecs, "v": mspecs, "step": P()}


def _make_sharded_grads(cfg: ModelConfig, tcfg: TrainConfig, mesh,
                        rules: MeshRules, pspecs):
    """-> ``compute_grads(blocks, batch) -> (loss, gradient blocks)`` of
    the sharded step (module docstring); ``batch`` is the global batch on
    the blocks' device, each microbatch split over the batch spec's
    axes."""
    policy = remat_policy_by_name(tcfg.remat)
    view = mesh_view(mesh)
    world = math.prod(view.sizes)
    rest = [tuple(a for a in view.axis_names if a not in spec_axes(s))
            for s in spec_leaves(pspecs)]

    def split(mb):
        """The mesh axes that split the microbatch's rows."""
        return spec_axes(P(batch_spec(rules, mesh,
                                      tuple(mb["labels"].shape))[0]))

    def grad_fn(leaves, treedef, mb):
        ps = [p.detach().requires_grad_(True) for p in leaves]
        n = math.prod(view.shape[a] for a in split(mb))
        copies = world // n
        local = local_batch(mb, rules, mesh)
        total, m = M.loss_fn(tree_unflatten(treedef, ps), cfg, local,
                             mesh=mesh, rules=rules, remat_policy=policy,
                             aux_weight=tcfg.aux_weight, specs=pspecs)
        total = _share(total, m, local, mb, n)
        gs = torch.autograd.grad(total / copies if copies > 1 else total,
                                 ps, allow_unused=True)
        return total.detach(), [torch.zeros_like(p) if g is None else g
                                for p, g in zip(ps, gs)]

    def reduced(mb, l, g):
        """The rows' shares summed over the axes that split them; each
        gradient block over the axes its spec does not name."""
        axes = split(mb)
        with bound(mesh):
            return (psum(l, axes) if axes else l,
                    [psum(x, r) if r else x for x, r in zip(g, rest)])

    return _accumulated(tcfg, grad_fn, reduced)


def _grads(cfg, tcfg, mesh, rules, sharded: bool):
    """-> (the sharded step's specs or None, its ``compute_grads``)."""
    if not sharded:
        return None, _make_compute_grads(cfg, tcfg, mesh, rules)
    rules = rules if rules is not None else MeshRules()
    specs = train_specs(cfg, rules, mesh)
    return specs, _make_sharded_grads(cfg, tcfg, mesh, rules, specs[0])


def make_train_step(cfg: ModelConfig, opt: OptimizerConfig, mesh=None,
                    rules: Optional[MeshRules] = None,
                    tcfg: TrainConfig = TrainConfig(),
                    sharded: bool = False):
    """Returns ``train_step(params, opt_state, batch) -> (params', state',
    metrics)``.  ``batch`` holds ``labels`` and ``tokens`` (or the audio
    family's ``embeds``), as tensors or numpy arrays; they move to the
    parameters' device.  ``metrics["loss"]`` is the total loss (with the
    auxiliary term), averaged over microbatches, as in ``repro``.  The
    step is pure and eager: the trees it is given stay as they were.
    ``mesh``/``rules``: data parallel over the rules' data axes, every
    rank given the global batch and the same trees (module docstring).
    ``sharded=True`` (a ``DeviceMesh``): the trees are this rank's blocks
    under :func:`train_specs`, and so are the new ones."""
    specs, compute_grads = _grads(cfg, tcfg, mesh, rules, sharded)

    def train_step(params, opt_state, batch):
        l, grads = compute_grads(params, _on(batch, _device(params)))
        new_params, new_state, gnorm = adamw_update(
            params, grads, opt_state, opt, specs, mesh)
        metrics = {"loss": l, "grad_norm": gnorm, "step": new_state["step"]}
        return new_params, new_state, metrics

    return train_step


def jit_train_step(cfg: ModelConfig, opt: OptimizerConfig, mesh=None,
                   rules: Optional[MeshRules] = None,
                   tcfg: TrainConfig = TrainConfig(),
                   sharded: bool = False):
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
    graph then holds the gradients' all-reduces (and, expert-parallel,
    the MoE layers' all-to-alls and their backwards), which the first,
    eager call warms up.  On a mesh of more than one rank the ranks agree
    each call's warm-up, capture or replay over a gloo group made here
    (``serving.steps.GraphedStep.decide``), so every rank must make the
    step and call it alike.  ``sharded=True``: on this rank's blocks, as
    :func:`make_train_step`'s, updated in place (the ZeRO-1 slices'
    all-gathers inside the graph)."""
    specs, compute_grads = _grads(cfg, tcfg, mesh, rules, sharded)

    def train_step_(params, opt_state, batch):
        l, grads = compute_grads(params, batch)
        gnorm = adamw_update_(params, grads, opt_state, opt, specs, mesh)
        return params, opt_state, {"loss": l, "grad_norm": gnorm,
                                   "step": opt_state["step"]}

    graph = jit_mesh_step(train_step_, mesh, donate_argnums=(0, 1))

    @functools.wraps(train_step_)
    def train_step(params, opt_state, batch):
        return graph(params, opt_state, _on(batch, _device(params)))

    train_step.graph = graph
    return train_step
