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
    value.  The port executes the dense parts of a meshed model replicated
    on every rank, so both are the identity here.  Executing
    ``param_specs``/``zero1_specs`` as tensor-parallel, FSDP or ZeRO-1
    storage is ROADMAP work.

Collectives (``psum``, ``pmax``, ``pmean``, ``hierarchical_psum``,
``all_gather``, ``all_to_all``, ``axis_index``, ``axis_size``) name a mesh
axis, as JAX's do inside ``shard_map``; they run on that axis's process
group of the mesh that :func:`shard_map_compat` bound for the calling
thread.  Each issues its collective even on an axis of size 1, so a world
of one rank runs the same calls as a larger one.

:func:`shard_map_compat` stands in for ``repro``'s of that name (JAX's
``shard_map``): every rank holds the global inputs, takes its block of
each along the named dims, runs the body, and rebuilds each sharded
output with ``all_gather`` over the dims' groups (a ``P()`` output is the
rank's own and must agree across ranks).  Every rank must issue the same
collectives in the same order, as SPMD programs do.
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
    "shard_map_compat", "shard_block", "mesh_coords",
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
# Activation constraints: the identity (see the module docstring)
# ---------------------------------------------------------------------------


def constrain(x: torch.Tensor, rules: MeshRules, mesh: Optional[Mesh],
              *axes) -> torch.Tensor:
    """``repro``'s ``with_sharding_constraint`` over logical axes: a
    layout hint that changes no value, so the identity here."""
    return x


def constrain_layer_params(lp: Any, rules: MeshRules,
                           mesh: Optional[Mesh]) -> Any:
    """``repro``'s re-assertion of one layer's storage sharding inside a
    scan: the identity here, as :func:`constrain` is."""
    return lp


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


def _reduce(x: torch.Tensor, axes, op) -> torch.Tensor:
    mesh = _mesh()
    out = x.clone()
    for a in reversed(_axes(axes)):
        dist.all_reduce(out, op=op, group=mesh.get_group(a))
        _count("all_reduce")
    return out


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    """Sum over one axis or a tuple of axes, one ``all_reduce`` per axis,
    innermost first (exact for integers; float sums round per stage)."""
    return _reduce(x, axes, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axes) -> torch.Tensor:
    return _reduce(x, axes, dist.ReduceOp.MAX)


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
    concatenated along ``dim`` in coordinate order."""
    g = _mesh().get_group(axis)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(g))]
    dist.all_gather(parts, x.contiguous(), group=g)
    _count("all_gather")
    return torch.cat(parts, dim=dim)


def all_to_all(x: torch.Tensor, axis: str, split_axis: int = 0,
               concat_axis: int = 0) -> torch.Tensor:
    """Tiled all-to-all over ``axis``: block ``j`` of ``x`` along
    ``split_axis`` goes to coordinate ``j``; the blocks received are
    concatenated along ``concat_axis`` in source order."""
    if split_axis != 0 or concat_axis != 0:
        raise NotImplementedError("all_to_all splits and concatenates "
                                  "along dim 0")
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=_mesh().get_group(axis))
    _count("all_to_all")
    return out


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


def _unshard(y: torch.Tensor, spec: P) -> torch.Tensor:
    for i, e in enumerate(tuple(spec)):
        if e is None:
            continue
        for a in reversed(_axes(e)):
            y = all_gather(y, a, dim=i)
    return y


def shard_map_compat(f, mesh: DeviceMesh, in_specs, out_specs):
    """``f`` run on each rank's blocks of the global inputs, collectives
    bound to ``mesh``; outputs rebuilt to global by ``all_gather`` per
    ``out_specs`` (a spec, or a tuple of specs for a tuple of outputs)."""

    def run(*args):
        coords = mesh_coords(mesh)
        local = [shard_block(a, s, mesh, coords)
                 for a, s in zip(args, in_specs)]
        with bound(mesh):
            out = f(*local)
            if isinstance(out_specs, P):
                return _unshard(out, out_specs)
            return tuple(_unshard(o, s) for o, s in zip(out, out_specs))

    return run


def local_batch(batch: Dict[str, Any], rules: MeshRules,
                mesh: DeviceMesh) -> Dict[str, Any]:
    """This rank's rows of each (B, ...) leaf under :func:`batch_spec`."""
    return {k: shard_block(v, batch_spec(rules, mesh, tuple(v.shape)), mesh)
            for k, v in batch.items()}


def data_shards(rules: MeshRules, mesh: Mesh) -> int:
    """How many ways the data axes split a batch."""
    view = mesh_view(mesh)
    return math.prod(view.shape[a] for a in rules.batch_axes(view))
