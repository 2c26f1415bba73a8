"""Mesh-rule sharding over ``torch.distributed``: one compact per-arch
record drives every placement, and ``shard_map`` sites run as per-rank
code with explicit collectives.

The port of ``repro.dist.sharding``.  The spec functions are pure
functions of a mesh's axis names and sizes, so they take a
``torch.distributed.device_mesh.DeviceMesh`` or a shape-only
:class:`ShapeMesh` (no ranks needed) and return the same entries as
``repro``'s on a JAX mesh of the same shape:

``MeshRules``
    Frozen per-architecture knob record, copied from ``repro``.

``P``
    The ``PartitionSpec`` stand-in: a tuple whose entries are an axis
    name, a tuple of axis names (outermost first) or ``None``.

``logical_to_spec`` / ``param_specs`` / ``zero1_specs`` / ``cache_specs``
/ ``batch_spec`` / ``_divisible``
    ``repro``'s spec derivation, entry for entry.

``constrain`` / ``constrain_layer_params``
    In ``repro`` these are layout hints to XLA's partitioner and change no
    value.  ``constrain`` is the identity here: the sharded train step
    computes each activation in the layout its spec names already.
    ``constrain_layer_params`` given one layer's spec tree is the FSDP
    gather point of a sharded step (``training.train_step``'s
    ``sharded=True``): the layer's blocks gathered over ``rules.fsdp`` just
    before use, the "model" dims left local; without specs (whole leaves)
    it is the identity.

``spec_axes`` / ``block_shape`` / ``gather_leaf`` / ``unshard_tree``
    Which mesh axes a leaf's spec shards it over (the rest replicate it),
    a block's shape, the differentiable gather of a block over some of its
    axes (its backward the reduce-scatter ``jax.grad`` applies to the same
    gather), and the whole leaves of a tree of blocks.

Collectives (``psum``, ``pmax``, ``pmean``, ``hierarchical_psum``,
``all_gather``, ``all_to_all``, ``axis_index``, ``axis_size``) name a mesh
axis, as JAX's do inside ``shard_map``; they run on that axis's process
group of the mesh that :func:`shard_map_compat` bound for the calling
thread.  Each issues its collective even on an axis of size 1, so a world
of one rank runs the same calls as a larger one.  ``psum``,
``all_gather`` and ``all_to_all`` are differentiable where autograd
records them (a ``torch.autograd.Function`` each, whose backward is the
transpose ``jax.grad`` applies: ``psum``, ``psum_scatter``, the same
all-to-all); with no gradient to record they are the bare calls.

:func:`shard_map_compat` stands in for ``repro``'s of that name (JAX's
``shard_map``): every rank holds the global inputs, takes its block of
each along the named dims, runs the body, and rebuilds each sharded
output with ``all_gather`` over the dims' groups (a ``P()`` output is the
rank's own and must agree across ranks); its backward is the transpose of
``repro``'s ``shard_map_compat(check_vma=False)`` under ``jax.grad``, so
every rank ends with the whole gradient of the global inputs.  Every rank
must issue the same collectives in the same order, as SPMD programs do;
the backward passes, which run the same graph on every rank, do too.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = [
    "MeshRules", "P", "ShapeMesh", "mesh_view", "logical_to_spec",
    "param_specs", "cache_specs", "zero1_specs", "batch_spec", "constrain",
    "constrain_layer_params", "axis_size", "axis_index", "psum", "pmax",
    "pmean", "hierarchical_psum", "all_gather", "all_to_all",
    "shard_map_compat", "shard_block", "mesh_coords", "spec_axes",
    "block_shape", "gather_leaf", "fsdp_axes", "unshard_tree",
    "layer_specs", "spec_leaves",
]


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class P(tuple):
    """``PartitionSpec`` stand-in: ``P("data", None)``, ``P(("pod",
    "data"), None)``; ``P()`` replicates.  Entries normalize as JAX's do:
    a one-axis tuple to its name, an empty one to ``None``, a list to a
    tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class ShapeMesh:
    """A mesh's axis names and sizes, with no ranks behind it: what the
    spec functions read (``repro``'s tests build a 512-device fake mesh
    for the same purpose)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def empty(self) -> bool:
        return not self.sizes


Mesh = Union[DeviceMesh, ShapeMesh]


def mesh_view(mesh: Optional[Mesh]) -> Optional[ShapeMesh]:
    """The :class:`ShapeMesh` of a ``DeviceMesh`` (a ShapeMesh or None
    passes through)."""
    if mesh is None or isinstance(mesh, ShapeMesh):
        return mesh
    return ShapeMesh(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Per-architecture sharding knobs (see the configs for rationale)."""

    batch: Tuple[str, ...] = ("pod", "data")  # logical "batch" axes, in order
    fsdp: Optional[str] = "data"     # weight-storage shard axis; None = off
    tp_weights: bool = True          # TP-shard weight matrices over "model"
    shard_heads: bool = True         # head-sharded attention activations
    shard_kv_heads: bool = False     # TP-shard wk/wv (GQA K/V is small)
    attn_impl: str = "flash"         # "flash" | "seqshard" (heads % TP != 0)
    residual_seq: bool = False       # residual stream stays (B, S/model, d)
    split_moe_tokens: bool = True    # MoE dispatch splits tokens over model
    moe_weight_resident: bool = True  # expert d_ff sharded over data axes

    def batch_axes(self, mesh: Mesh) -> Tuple[str, ...]:
        """The data-parallel axes actually present in ``mesh``."""
        return tuple(a for a in self.batch if a in mesh.axis_names)


# ---------------------------------------------------------------------------
# Axis resolution + divisibility guard
# ---------------------------------------------------------------------------


def _axis_size(mesh: ShapeMesh, names) -> int:
    if names is None:
        return 1
    if isinstance(names, str):
        names = (names,)
    n = 1
    for a in names:
        n *= mesh.shape[a]
    return n


def _resolve(rules: MeshRules, mesh: ShapeMesh, name):
    names = mesh.axis_names
    if name is None:
        return None
    if isinstance(name, (tuple, list)):
        got = tuple(a for a in name if a in names)
        return got if got else None
    if name == "batch":
        got = rules.batch_axes(mesh)
        return got if got else None
    if name == "fsdp":
        return rules.fsdp if rules.fsdp in names else None
    if name == "seq_model":
        return "model" if (rules.residual_seq and "model" in names) else None
    return name if name in names else None


def logical_to_spec(rules: MeshRules, mesh: Mesh,
                    axes: Sequence[Any]) -> P:
    """Map logical axis names to a spec, dropping missing axes."""
    mesh = mesh_view(mesh)
    return P(*[_resolve(rules, mesh, a) for a in axes])


def _divisible(spec: P, shape: Sequence[int], mesh: Mesh) -> P:
    """Replicate (None out) any spec dim the mesh axes don't divide."""
    mesh = mesh_view(mesh)
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    out = []
    for dim, s in zip(shape, entries):
        n = _axis_size(mesh, s)
        out.append(s if (s is not None and n > 0 and dim % n == 0) else None)
    return P(*out)


# ---------------------------------------------------------------------------
# Activation constraints and the per-layer FSDP gather (module docstring)
# ---------------------------------------------------------------------------


def constrain(x: torch.Tensor, rules: MeshRules, mesh: Optional[Mesh],
              *axes) -> torch.Tensor:
    """``repro``'s ``with_sharding_constraint`` over logical axes: a
    layout hint that changes no value, so the identity here."""
    return x


def fsdp_axes(rules: Optional[MeshRules], mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axis that a sharded step gathers its weights' blocks over
    (``rules.fsdp``), as a tuple, empty when the mesh lacks it."""
    fsdp = _resolve(rules or MeshRules(), mesh_view(mesh), "fsdp")
    return (fsdp,) if fsdp else ()


def constrain_layer_params(lp: Any, rules: MeshRules, mesh: Optional[Mesh],
                           specs: Any = None) -> Any:
    """One layer's weights as its block computes with them.  ``repro``
    re-asserts the layer's storage sharding inside the scan, so that XLA
    gathers one layer at a time over ``rules.fsdp``.  Given the layer's
    ``specs`` (a sharded step's blocks, on a ``DeviceMesh``), each block is
    gathered here over ``rules.fsdp`` (:func:`gather_leaf`, differentiable:
    its backward reduce-scatters the gradient), and the dims over "model"
    stay local.  Without specs (whole leaves) or with no FSDP axis on the
    mesh, the identity."""
    if specs is None or mesh is None or isinstance(mesh, ShapeMesh):
        return lp
    fsdp = fsdp_axes(rules, mesh)
    if not fsdp:
        return lp

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        return gather_leaf(node, spec, fsdp)

    with bound(mesh):
        return walk(lp, specs)


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

# Per-layer vectors / scalars: always replicated.
_REPLICATED = frozenset({
    "ln", "final_ln", "ln1", "ln2", "ln_x", "out_ln",
    "maa_x", "maa_wkvrg", "decay_base", "cm_mk", "cm_mr",
    "a_log", "dt_bias", "d_skip", "bonus", "router",
})
# Column-parallel (in, out): model on the output dim, fsdp on the input dim.
_COL_PARALLEL = frozenset({
    "wq", "wk", "wv", "wi", "wg", "wr", "lm_head",
    "maa_w1", "decay_w1", "cm_k", "cm_r", "in_proj",
})
# Row-parallel (in, out): model on the input dim, fsdp on the output dim.
_ROW_PARALLEL = frozenset({
    "wo", "cm_v", "out_proj", "maa_w2", "decay_w2",
})


def _core_spec(path: Tuple[str, ...], key: str, ndim: int,
               rules: MeshRules, mesh: ShapeMesh, decode: bool):
    """Trailing-dim spec entries for one leaf; leading stack dims -> None."""
    names = mesh.axis_names
    model = "model" if (rules.tp_weights and "model" in names) else None
    fsdp = None if decode else _resolve(rules, mesh, "fsdp")

    in_moe = "moe" in path and "shared" not in path
    if in_moe and key in ("wi", "wg", "wo"):
        # Expert-parallel weights (E, d_in, d_out): E over "model"; with
        # weight-resident EP the ff dim additionally shards over the data
        # axes (training) / exactly "data" (the decode shard_map contract).
        ep = "model" if "model" in names else None
        if decode:
            wr = "data" if "data" in names else None
        else:
            wr = (rules.batch_axes(mesh) or None) \
                if rules.moe_weight_resident else None
        core = (ep, wr, None) if key == "wo" else (ep, None, wr)
        return (None,) * (ndim - 3) + core

    if key in _REPLICATED:
        return (None,) * ndim
    if key == "embed":
        # (vocab, d): the TP head reads it transposed -> vocab over model
        # (kept even under tp_weights=False: "except the vocab", minicpm).
        m = "model" if "model" in names else None
        return (None,) * (ndim - 2) + (m, fsdp)
    if key == "lora_a":
        return (None,) * (ndim - 2) + (fsdp, None)
    if key == "lora_b":
        return (None,) * (ndim - 2) + (None, model)
    if key in ("wk", "wv") and any(a in ("attn", "shared_attn")
                                   for a in path):
        # GQA/MQA K/V projections are small; TP-shard only when the rules
        # say the kv heads split cleanly.
        m = model if rules.shard_kv_heads else None
        return (None,) * (ndim - 2) + (fsdp, m)
    if key in _COL_PARALLEL:
        return (None,) * (ndim - 2) + (fsdp, model)
    if key in _ROW_PARALLEL:
        return (None,) * (ndim - 2) + (model, fsdp)
    # Unknown leaf: stacked weights (>=3 dims) get the generic column
    # layout on their trailing matmul dims; vectors replicate.
    if ndim >= 3:
        return (None,) * (ndim - 2) + (fsdp, model)
    return (None,) * ndim


def _spec_tree(tree: Any, rules: MeshRules, mesh: ShapeMesh, decode: bool,
               path: Tuple[str, ...] = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _spec_tree(v, rules, mesh, decode, path + (k,))
                for k, v in tree.items()}
    shape = tuple(tree.shape)
    key = path[-1] if path else ""
    core = _core_spec(path, key, len(shape), rules, mesh, decode)
    return _divisible(P(*core), shape, mesh)


def param_specs(pshape: Any, rules: MeshRules, mesh: Mesh,
                decode: bool = False) -> Any:
    """Spec tree for a parameter (shape) tree: any tree of objects with a
    ``.shape``, e.g. ``models.model.init_params(0, cfg, device="meta")``.

    ``decode=True`` derives the serving layout: FSDP off (weights resident),
    MoE experts pinned to the decode shard_map contract."""
    return _spec_tree(pshape, rules, mesh_view(mesh), decode)


# ---------------------------------------------------------------------------
# Optimizer-state and cache specs
# ---------------------------------------------------------------------------


def zero1_specs(pspecs: Any, pshape: Any, mesh: Mesh) -> Any:
    """ZeRO-1 moment specs: add a "data" shard where params carry none."""
    mesh = mesh_view(mesh)
    if "data" not in mesh.axis_names:
        return pspecs
    nd = mesh.shape["data"]

    def one(spec: P, leaf) -> P:
        shape = tuple(leaf.shape)
        entries = list(tuple(spec)) + [None] * (len(shape) - len(tuple(spec)))
        used = set()
        for e in entries:
            for a in (e if isinstance(e, tuple) else (e,)):
                if a:
                    used.add(a)
        if "data" in used:
            return P(*entries)
        for i, (dim, e) in enumerate(zip(shape, entries)):
            if e is None and dim >= nd and dim % nd == 0:
                entries[i] = "data"
                break
        return P(*entries)

    def walk(spec, leaf):
        if isinstance(spec, dict):
            return {k: walk(spec[k], leaf[k]) for k in spec}
        return one(spec, leaf)

    return walk(pspecs, pshape)


# Decode-cache leaves: core (unstacked) rank, and — for attention KV —
# the sequence dim's position within the core.  Batch is core dim 0.
_CACHE_CORE = {
    "k": (4, 1),        # (B, S, KVH, hd)
    "v": (4, 1),
    "shift1": (2, None),  # (B, d)
    "shift2": (2, None),
    "state": (4, None),   # (B, H, K, V) / (B, nh, ds, hd)
    "conv": (3, None),    # (B, conv-1, d_inner)
}


def cache_specs(cshape: Any, rules: MeshRules, mesh: Mesh,
                seq_axes: Sequence[str] = ()) -> Any:
    """Specs for decode caches: batch over the data axes, the (large) KV
    sequence dim over ``seq_axes`` (e.g. ``("model",)``; ``("data",
    "model")`` for B==1 long-context decode)."""
    mesh = mesh_view(mesh)
    bax = rules.batch_axes(mesh) or None
    seq = tuple(a for a in seq_axes if a in mesh.axis_names)

    def one(path: Tuple[str, ...], leaf) -> P:
        shape = tuple(leaf.shape)
        key = path[-1] if path else ""
        core_ndim, seq_at = _CACHE_CORE.get(key, (None, None))
        if core_ndim is None or len(shape) < core_ndim:
            return P(*([None] * len(shape)))
        entries = [None] * len(shape)
        b_at = len(shape) - core_ndim
        entries[b_at] = bax
        if seq_at is not None:
            # never double-book an axis already used for the batch dim
            sq = tuple(a for a in seq if a not in (bax or ()))
            entries[b_at + seq_at] = sq or None
        return _divisible(P(*entries), shape, mesh)

    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return one(path, node)

    return walk(cshape)


def batch_spec(rules: MeshRules, mesh: Mesh, shape: Sequence[int]) -> P:
    """Spec for a (B, ...) input leaf: batch axes on dim 0, rest replicated."""
    mesh = mesh_view(mesh)
    bax = rules.batch_axes(mesh) or None
    return _divisible(P(bax, *([None] * (len(shape) - 1))), tuple(shape),
                      mesh)


# ---------------------------------------------------------------------------
# Collectives over the mesh bound by shard_map_compat
# ---------------------------------------------------------------------------

_BOUND = threading.local()
# collectives issued, by kind: what the card's smoke run reads to show that
# a meshed path ran its NCCL calls
_COUNTS: Dict[str, int] = {}
_COUNTS_MU = threading.Lock()


def _count(kind: str) -> None:
    with _COUNTS_MU:
        _COUNTS[kind] = _COUNTS.get(kind, 0) + 1


def collective_counts() -> Dict[str, int]:
    with _COUNTS_MU:
        return dict(_COUNTS)


def reset_collective_counts() -> None:
    with _COUNTS_MU:
        _COUNTS.clear()


@contextlib.contextmanager
def bound(mesh: DeviceMesh):
    """Bind ``mesh`` for the collectives this thread issues (what
    :func:`shard_map_compat` does around its body)."""
    prev = getattr(_BOUND, "mesh", None)
    _BOUND.mesh = mesh
    try:
        yield mesh
    finally:
        _BOUND.mesh = prev


def _mesh() -> DeviceMesh:
    mesh = getattr(_BOUND, "mesh", None)
    if mesh is None:
        raise RuntimeError("a collective over a mesh axis runs inside "
                           "shard_map_compat (or dist.sharding.bound)")
    return mesh


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(name: str) -> int:
    """Size of a mesh axis, inside shard_map_compat."""
    return int(_mesh().shape[_mesh().mesh_dim_names.index(name)])


def axis_index(name: str) -> int:
    """This rank's coordinate on mesh axis ``name``, inside
    shard_map_compat."""
    return int(_mesh().get_local_rank(name))


def _reduce_on(mesh: DeviceMesh, x: torch.Tensor, axes,
               op) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    for a in reversed(_axes(axes)):
        dist.all_reduce(out, op=op, group=mesh.get_group(a))
        _count("all_reduce")
    return out


def _gather_on(mesh: DeviceMesh, x: torch.Tensor, axis: str,
               dim: int) -> torch.Tensor:
    g = mesh.get_group(axis)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
    dist.all_gather(parts, x.contiguous(), group=g)
    _count("all_gather")
    return torch.cat(parts, dim=dim)


def _scatter_sum_on(mesh: DeviceMesh, x: torch.Tensor, axis: str,
                    dim: int) -> torch.Tensor:
    """``psum_scatter``: the sum over ``axis`` of ``x``, this rank's block
    of it along ``dim`` (the transpose of the tiled all-gather)."""
    g = mesh.get_group(axis)
    n = dist.get_world_size(g)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src, group=g)
    _count("reduce_scatter")
    return out.movedim(0, dim)


def _a2a_on(mesh: DeviceMesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=mesh.get_group(axis))
    _count("all_to_all")
    return out


def _grad(x) -> bool:
    """Whether autograd records a collective on ``x``: only then does it
    go through its ``autograd.Function``."""
    return torch.is_grad_enabled() and isinstance(x, torch.Tensor) \
        and x.requires_grad


class _Psum(torch.autograd.Function):
    """``psum``; its transpose is ``psum`` again (JAX treats psum as psum
    followed by a broadcast, so the cotangents of every rank sum)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _reduce_on(mesh, x, axes, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _reduce_on(ctx.mesh, g, ctx.axes, dist.ReduceOp.SUM), \
            None, None


class _AllGather(torch.autograd.Function):
    """Tiled ``all_gather``; its transpose is ``psum_scatter`` along the
    same dim: each rank's block of the sum of every rank's cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather_on(mesh, x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum_on(ctx.mesh, g, ctx.axis, ctx.dim), \
            None, None, None


class _AllToAll(torch.autograd.Function):
    """Tiled ``all_to_all`` along dim 0; its own transpose (split and
    concatenation dims swapped, both 0 here)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _a2a_on(mesh, x, axis)

    @staticmethod
    def backward(ctx, g):
        return _a2a_on(ctx.mesh, g, ctx.axis), None, None


def _reduce(x: torch.Tensor, axes, op) -> torch.Tensor:
    return _reduce_on(_mesh(), x, axes, op)


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """Sum over one axis or a tuple of axes, one ``all_reduce`` per axis,
    innermost first (exact for integers; float sums round per stage).
    Differentiable: the backward sums the cotangents over the same axes."""
    if _grad(x):
        return _Psum.apply(x, _mesh(), _axes(axes))
    return _reduce(x, axes, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axes) -> torch.Tensor:
    """Max over the axes; not differentiated (no caller trains through
    it)."""
    return _reduce(x.detach(), axes, dist.ReduceOp.MAX)


def pmean(x: torch.Tensor, axes) -> torch.Tensor:
    n = 1
    for a in _axes(axes):
        n *= axis_size(a)
    return psum(x, axes) / n


def hierarchical_psum(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """Topology-aware all-reduce: one ``all_reduce`` per mesh axis,
    innermost (fastest interconnect) first, each on that axis's group.

    ``axes`` is ordered outermost-first, matching mesh axis order — e.g.
    ``("pod", "data")`` reduces within each pod over "data", then
    combines the per-pod partials over "pod", one partial per pod on the
    slow fabric.  Inside ``shard_map_compat`` only."""
    for a in reversed(tuple(axes)):
        x = psum(x, a)
    return x


def all_gather(x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
    """Tiled all-gather: the blocks of every rank on ``axis``,
    concatenated along ``dim`` in coordinate order.  Differentiable: the
    backward is ``psum_scatter`` (``dist.reduce_scatter_tensor``) along
    ``dim``."""
    if _grad(x):
        return _AllGather.apply(x, _mesh(), axis, dim)
    return _gather_on(_mesh(), x, axis, dim)


def all_to_all(x: torch.Tensor, axis: str, split_axis: int = 0,
               concat_axis: int = 0) -> torch.Tensor:
    """Tiled all-to-all over ``axis``: block ``j`` of ``x`` along
    ``split_axis`` goes to coordinate ``j``; the blocks received are
    concatenated along ``concat_axis`` in source order.  Differentiable:
    the backward is the same all-to-all of the cotangent."""
    if split_axis != 0 or concat_axis != 0:
        raise NotImplementedError("all_to_all splits and concatenates "
                                  "along dim 0")
    if _grad(x):
        return _AllToAll.apply(x, _mesh(), axis)
    return _a2a_on(_mesh(), x, axis)


# ---------------------------------------------------------------------------
# shard_map_compat: per-rank blocks of global inputs, rebuilt by all_gather
# ---------------------------------------------------------------------------


def mesh_coords(mesh: DeviceMesh) -> Dict[str, int]:
    """This rank's coordinate on every axis of ``mesh``."""
    return {a: int(mesh.get_local_rank(a)) for a in mesh.mesh_dim_names}


def shard_block(x, spec: P, mesh: DeviceMesh, coords=None):
    """This rank's block of the global ``x`` under ``spec``: dim ``i`` with
    axes ``(a1, a2, ...)`` (outermost first) splits into ``n_a1 * n_a2 *
    ...`` equal blocks, the rank taking block ``(c_a1 * n_a2 + c_a2) ...``,
    as a JAX mesh lays them out.  ``None`` passes through."""
    if x is None:
        return None
    view = mesh_view(mesh)
    coords = mesh_coords(mesh) if coords is None else coords
    for i, e in enumerate(tuple(spec)):
        if e is None:
            continue
        idx, n = 0, 1
        for a in _axes(e):
            idx = idx * view.shape[a] + coords[a]
            n *= view.shape[a]
        if x.shape[i] % n:
            raise ValueError(f"dim {i} of {tuple(x.shape)} does not divide "
                             f"over {n} shards of {e}")
        size = x.shape[i] // n
        x = x.narrow(i, idx * size, size)
    return x


def _unshard_on(mesh: DeviceMesh, y: torch.Tensor, spec: P) -> torch.Tensor:
    for i, e in enumerate(tuple(spec)):
        if e is None:
            continue
        for a in reversed(_axes(e)):
            y = _gather_on(mesh, y, a, i)
    return y


def _unmentioned(mesh: DeviceMesh, spec: P) -> Tuple[str, ...]:
    """The mesh axes ``spec`` names nowhere: a block is replicated along
    them."""
    named = {a for e in tuple(spec) if e is not None for a in _axes(e)}
    return tuple(a for a in mesh.mesh_dim_names if a not in named)


class _Block(torch.autograd.Function):
    """A rank's block of a global input (:func:`shard_block`).  The
    transpose ``jax.grad`` applies to a ``shard_map`` input with
    ``check_vma=False``: the block's cotangent summed over the axes the
    spec leaves out (every rank along them read the same block), then the
    blocks assembled into the global cotangent, here on every rank (an
    all-gather per named axis), since every rank holds the global value."""

    @staticmethod
    def forward(ctx, x, spec, mesh, coords):
        ctx.spec, ctx.mesh = spec, mesh
        return shard_block(x, spec, mesh, coords)

    @staticmethod
    def backward(ctx, g):
        rest = _unmentioned(ctx.mesh, ctx.spec)
        if rest:
            g = _reduce_on(ctx.mesh, g, rest, dist.ReduceOp.SUM)
        return _unshard_on(ctx.mesh, g, ctx.spec), None, None, None


class _Unshard(torch.autograd.Function):
    """A ``shard_map`` output rebuilt to the global value by all-gather
    (``P()``: the rank's own, the same on every rank).  Its transpose with
    ``check_vma=False``: the rank's block of the global cotangent divided
    by the size of the axes the spec leaves out, whose ranks each return
    a copy (``repro``'s aux loss, a ``pmean`` to ``P()``, gets 1/n a
    rank)."""

    @staticmethod
    def forward(ctx, y, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return _unshard_on(mesh, y, spec)

    @staticmethod
    def backward(ctx, g):
        n = math.prod(int(ctx.mesh.shape[ctx.mesh.mesh_dim_names.index(a)])
                      for a in _unmentioned(ctx.mesh, ctx.spec))
        g = shard_block(g, ctx.spec, ctx.mesh)
        return (g / n if n != 1 else g), None, None


def _block(x, spec: P, mesh: DeviceMesh, coords):
    if _grad(x):
        return _Block.apply(x, spec, mesh, coords)
    return shard_block(x, spec, mesh, coords)


def _unshard(y: torch.Tensor, spec: P, mesh: DeviceMesh) -> torch.Tensor:
    if _grad(y):
        return _Unshard.apply(y, spec, mesh)
    return _unshard_on(mesh, y, spec)


def shard_map_compat(f, mesh: DeviceMesh, in_specs, out_specs):
    """``f`` run on each rank's blocks of the global inputs, collectives
    bound to ``mesh``; outputs rebuilt to global by ``all_gather`` per
    ``out_specs`` (a spec, or a tuple of specs for a tuple of outputs).

    Differentiable as ``jax.grad`` differentiates ``repro``'s
    ``shard_map_compat(check_vma=False)``: an input's cotangent is summed
    over the axes its spec leaves out and assembled from the ranks'
    blocks, an output's block of the global cotangent is divided by the
    size of the axes its spec leaves out, and the collectives inside run
    their transposes (``psum`` -> ``psum``, ``all_gather`` ->
    ``psum_scatter``, ``all_to_all`` -> ``all_to_all``).  Every rank then
    holds the whole gradient of the global inputs."""

    def run(*args):
        coords = mesh_coords(mesh)
        local = [_block(a, s, mesh, coords)
                 for a, s in zip(args, in_specs)]
        with bound(mesh):
            out = f(*local)
            if isinstance(out_specs, P):
                return _unshard(out, out_specs, mesh)
            return tuple(_unshard(o, s, mesh)
                         for o, s in zip(out, out_specs))

    return run


# ---------------------------------------------------------------------------
# Sharded storage: blocks of whole trees and back
# ---------------------------------------------------------------------------


def spec_axes(spec: P) -> Tuple[str, ...]:
    """The mesh axes ``spec`` shards its leaf over, in dim order; a leaf
    is replicated over every other axis of the mesh."""
    return tuple(a for e in tuple(spec) if e is not None for a in _axes(e))


def spec_leaves(specs: Any) -> list:
    """The specs of a spec tree in leaf order (dicts by sorted key, as
    ``ft.checkpoint.tree_flatten`` orders leaves; a spec is a tuple, which
    that would open)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    return [specs]


def block_shape(shape: Sequence[int], spec: P, mesh: Mesh) -> Tuple[int, ...]:
    """The shape of each rank's block of a leaf of ``shape``."""
    view = mesh_view(mesh)
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return tuple(d // _axis_size(view, e) for d, e in zip(shape, entries))


def gather_leaf(x: torch.Tensor, spec: P, axes) -> torch.Tensor:
    """This rank's block of a leaf gathered over ``axes``, one tiled
    all-gather per axis along its dim, inside a bound mesh.  Differentiable: the backward is the
    reduce-scatter that ``jax.grad`` applies to the same gather, so the
    gradient comes back as this rank's block, summed over the gathering
    ranks.  A dim is gathered when ``axes`` holds every axis of its
    entry."""
    for i, e in enumerate(tuple(spec)):
        if e is None or not set(_axes(e)) <= set(axes):
            continue
        for a in reversed(_axes(e)):
            x = all_gather(x, a, dim=i)
    return x


@torch.no_grad()
def unshard_tree(tree: Any, specs: Any, mesh: DeviceMesh) -> Any:
    """The whole leaves of a tree of blocks, rebuilt on every rank by
    all-gathers over the axes each spec names (every rank must call it,
    leaf by leaf in the same order); ``ft.elastic.reshard_tree`` cuts the
    blocks of a whole tree."""
    if isinstance(tree, dict):
        return {k: unshard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return _unshard_on(mesh, tree, specs)


def layer_specs(stacked: Any) -> Any:
    """The specs of one layer of a layer stack: each stacked leaf's spec
    without its leading (replicated) layer entry."""
    if isinstance(stacked, dict):
        return {k: layer_specs(v) for k, v in stacked.items()}
    return P(*tuple(stacked)[1:])


def local_batch(batch: Dict[str, Any], rules: MeshRules,
                mesh: DeviceMesh) -> Dict[str, Any]:
    """This rank's rows of each (B, ...) leaf under :func:`batch_spec`."""
    return {k: shard_block(v, batch_spec(rules, mesh, tuple(v.shape)), mesh)
            for k, v in batch.items()}


def data_shards(rules: MeshRules, mesh: Mesh) -> int:
    """How many ways the data axes split a batch."""
    view = mesh_view(mesh)
    return math.prod(view.shape[a] for a in rules.batch_axes(view))
