"""Serving steps in plain PyTorch, and :func:`jit_step`, which makes one
program of a step as ``repro``'s ``jax.jit`` does.

* prefill: full forward over the prompt -> last-position logits and the
  populated caches.
* decode: one new token per request against a per-request cache
  (``models.model.init_caches``), greedy.
* sharded (``sharded=True``, :func:`serve_specs`): ``repro``'s dry-run
  prefill and decode steps per rank over ``torch.distributed``, each
  rank taking and returning only its blocks (FSDP prefill, tensor-
  parallel decode over a cache whose sequence is split over "model").
* paged variants (the scheduler's data plane): the KV cache is the pool's
  page store (``models.model.init_paged_caches``), addressed by each
  request's (B, P) page-index vector; decode attends through the kernel
  K5, chunked prefill writes right-aligned chunks into the pages and
  attends through K6.

The step functions run eagerly; where ``repro`` donated the page store they
update it in place.  :func:`jit_step` wraps a step as ``repro``'s
``jit_step`` does: on CUDA tensors the step becomes a CUDA graph, run
eagerly on the first call with new arguments, captured on the second (the
counterpart of a compile) and replayed from then on; on CPU tensors it
runs eagerly, as ``repro``'s drops donation on the CPU backend.

Each maker takes ``repro``'s ``mesh`` and ``rules`` (``launch.mesh``,
``dist.sharding.MeshRules``); ``mesh=None`` is the one-device step.  A
meshed step's collectives (NCCL on the card) enter the graph when it is
captured; the first, eager call of a new key runs them first, which is
the warm-up NCCL needs before a capture.  On a mesh of more than one rank
the step is given a host group (``jit_step(..., group=)``, gloo) over
which the ranks agree every call's warm-up, capture or replay, so that
they take each call the same way: one rank's miss makes every rank miss,
and a capture starts on every rank together, after a barrier, with no
collective in flight.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..dist.sharding import (MeshRules, P, all_gather, axis_index, batch_spec,
                             bound, cache_specs, mesh_view, param_specs,
                             spec_axes)
from ..kernels import _build
from ..kernels import ops as K
from ..models import model as M
from ..models.common import ModelConfig


# ---------------------------------------------------------------------------
# jit_step: a CUDA graph of the step
# ---------------------------------------------------------------------------
#
# How the arguments are treated, as ``jax.jit`` treats them: argument 0 (the
# parameter tree) and the donated arguments (the page store) are used where
# they are and keyed by identity, so the graph reads and writes them in
# place; every other tensor argument is keyed by its abstract value (shape,
# dtype, device) and copied into the graph's own input buffer before each
# replay.  A leaf that is not a tensor is keyed by its value.  The functions
# below hold that logic and take tensors only, so the CPU tests reach them.


def flatten(tree) -> Tuple[list, Any]:
    """-> (leaves, structure) of a tree of dicts, lists and tuples; the
    structure is hashable and :func:`unflatten` inverts this."""
    if isinstance(tree, dict):
        parts = [flatten(v) for v in tree.values()]
        return ([x for p in parts for x in p[0]],
                ("dict", tuple(tree), tuple(p[1] for p in parts)))
    if isinstance(tree, (list, tuple)):
        parts = [flatten(v) for v in tree]
        return ([x for p in parts for x in p[0]],
                (type(tree).__name__, tuple(p[1] for p in parts)))
    return [tree], None


def unflatten(structure, leaves: Sequence):
    """The tree of :func:`flatten`'s ``structure`` over ``leaves``."""
    return _build_tree(structure, iter(leaves))


def _build_tree(node, it):
    if node is None:
        return next(it)
    if node[0] == "dict":
        return {k: _build_tree(c, it) for k, c in zip(node[1], node[2])}
    kids = [_build_tree(c, it) for c in node[1]]
    return kids if node[0] == "list" else tuple(kids)


def _by_identity(i: int, donate_argnums: Sequence[int]) -> bool:
    return i == 0 or i in donate_argnums


def _identity(x):
    if isinstance(x, torch.Tensor):
        return (id(x), x.data_ptr(), tuple(x.shape), x.stride(), x.dtype,
                x.device)
    return ("value", x)


def _abstract(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    return ("value", x)


def step_key(args: Sequence, donate_argnums: Sequence[int] = ()) -> tuple:
    """The graph a call with ``args`` replays: the parameter tree and the
    donated arguments by the identity of every leaf, the other arguments
    by abstract value."""
    key = []
    for i, a in enumerate(args):
        leaves, structure = flatten(a)
        f = _identity if _by_identity(i, donate_argnums) else _abstract
        key.append((structure, tuple(map(f, leaves))))
    return tuple(key)


def step_device(args: Sequence) -> torch.device:
    """The one device of every tensor in ``args``; raises on a mix."""
    devs = {x.device for a in args for x in flatten(a)[0]
            if isinstance(x, torch.Tensor)}
    if len(devs) != 1:
        raise ValueError(f"a step's tensors must lie on one device, got "
                         f"{sorted(map(str, devs))}")
    return devs.pop()


def copied_leaves(args: Sequence,
                  donate_argnums: Sequence[int] = ()) -> List[torch.Tensor]:
    """The tensors copied into the graph's input buffers before a replay,
    in the buffers' order."""
    return [x for i, a in enumerate(args)
            if not _by_identity(i, donate_argnums)
            for x in flatten(a)[0] if isinstance(x, torch.Tensor)]


def bind_inputs(args: Sequence, donate_argnums: Sequence[int] = ()
                ) -> Tuple[tuple, List[torch.Tensor]]:
    """-> (the arguments a graph is captured on, its input buffers): each
    copied tensor replaced by a new buffer holding its values, everything
    else passed as it is."""
    bufs: List[torch.Tensor] = []
    bound = []
    for i, a in enumerate(args):
        if _by_identity(i, donate_argnums):
            bound.append(a)
            continue
        leaves, structure = flatten(a)
        new = []
        for x in leaves:
            if isinstance(x, torch.Tensor):
                x = x.clone(memory_format=torch.contiguous_format)
                bufs.append(x)
            new.append(x)
        bound.append(unflatten(structure, new))
    return tuple(bound), bufs


def output_plan(out, args: Sequence, donate_argnums: Sequence[int] = ()):
    """How a call returns the result ``out`` of the captured call on
    ``args``: a subtree that is a donated argument, or one of its leaves,
    comes back as the caller's own object (``("arg", i)``, ``("leaf", i,
    j)``); any other tensor is copied out of the graph's pool at every call
    (``("fresh", tensor)``); anything else is returned as it is."""
    donated = {}
    for i in donate_argnums:
        donated[id(args[i])] = ("arg", i)
        for j, x in enumerate(flatten(args[i])[0]):
            donated.setdefault(id(x), ("leaf", i, j))
    return _plan(out, donated)


def _plan(node, donated):
    if id(node) in donated:
        return donated[id(node)]
    if isinstance(node, dict):
        return ("dict", {k: _plan(v, donated) for k, v in node.items()})
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, [_plan(v, donated) for v in node])
    if isinstance(node, torch.Tensor):
        return ("fresh", node)
    return ("const", node)


def materialize(plan, args: Sequence):
    """The result :func:`output_plan`'s ``plan`` stands for, on this call's
    ``args``: fresh tensors, and the caller's donated objects."""
    kind = plan[0]
    if kind == "arg":
        return args[plan[1]]
    if kind == "leaf":
        return flatten(args[plan[1]])[0][plan[2]]
    if kind == "fresh":
        return plan[1].clone()
    if kind == "const":
        return plan[1]
    if kind == "dict":
        return {k: materialize(v, args) for k, v in plan[1].items()}
    kids = [materialize(v, args) for v in plan[1]]
    return kids if kind == "list" else tuple(kids)


def add_launches(launches: Dict[str, int]) -> None:
    """Add a replay's kernel launches (counter name -> n, as
    :func:`~repro_torch.kernels._build.recording_launches` recorded them
    at the capture) to the launch counters."""
    for name, n in launches.items():
        K.COUNTERS[name].add(n)


# ``torch.cuda.graph`` captures on one side stream shared by the whole
# process, so two threads may not capture at once: captures take this lock
_CAPTURE_LOCK = threading.Lock()


def capture_graph(fn: Callable, args: Sequence):
    """Capture ``fn(*args)`` as a CUDA graph on the current device ->
    (graph, its results, the kernel launches it recorded).  Other threads
    may run CUDA work meanwhile (``capture_error_mode="thread_local"``:
    CUDA refuses an unsafe call on the capturing thread only; work that
    other threads put on the capturing stream, as autograd's device thread
    does in a backward pass, is captured).  One capture runs at a time in
    the process.  ``torch.cuda.graph`` empties the allocator's cache
    first, which is also what frees the pools of the graphs dropped since:
    the allocator frees a dropped graph's pool in ``empty_cache`` or after
    an allocation fails outside a capture, not otherwise."""
    graph = torch.cuda.CUDAGraph()
    with _CAPTURE_LOCK, _build.recording_launches() as launches:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = fn(*args)
    return graph, out, dict(launches)


def _on_device(dev: torch.device):
    """``dev`` as the thread's current CUDA device for the block (a device
    with no index: the thread's own, as it stands)."""
    if dev.index is None:
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


@dataclasses.dataclass
class StepStats:
    """A graphed step's calls by kind: eager warm-ups (the first call with
    a key), captures (the second, which then replays) and replays; the
    calls each warm-up and capture came on (1 = the step's first call),
    and each capture's host ms."""
    warmups: int = 0
    captures: int = 0
    replays: int = 0
    warmup_at: List[int] = dataclasses.field(default_factory=list)
    capture_at: List[int] = dataclasses.field(default_factory=list)
    capture_ms: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Captured:
    key: tuple
    graph: "torch.cuda.CUDAGraph"
    args: tuple                  # holds every tensor captured by identity
    bufs: List[torch.Tensor]
    plan: Any
    launches: Dict[str, int]


def agree(flags: Sequence[bool], group) -> Tuple[bool, ...]:
    """Each flag true on every rank of ``group`` (one MIN all-reduce of
    the flags on the host); ``group=None`` is one rank: the flags as
    given."""
    if group is None:
        return tuple(bool(f) for f in flags)
    t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return tuple(bool(v) for v in t.tolist())


class GraphedStep:
    """A step function as one CUDA graph; see :func:`jit_step`."""

    def __init__(self, fn: Callable, donate_argnums: Sequence[int] = (),
                 group=None):
        functools.update_wrapper(self, fn)
        self.fn = fn
        self.donate_argnums = tuple(donate_argnums)
        self.group = group
        self.stats = StepStats()
        self._captured: Optional[_Captured] = None
        self._warm: Optional[tuple] = None      # key of the last warm-up
        self._mu = threading.Lock()

    def decide(self, key: tuple) -> str:
        """How the call with ``key`` runs: ``"replay"`` (the graph's key),
        ``"capture"`` (the last warm-up's key) or ``"warmup"`` (a new
        key), and the state moved on to match.  A miss drops the graph:
        its pool and its references to the old parameters go with it.
        With a ``group``, every rank's call reaches the same decision: it
        replays only if every rank's graph has its key, and captures only
        if every rank warmed its key up on the call before; otherwise
        every rank warms up (its own key).  Runs on any device, so the
        CPU tests drive it."""
        c = self._captured
        hit, warm = agree((c is not None and c.key == key,
                           self._warm == key), self.group)
        if hit:
            return "replay"
        self._captured = None
        if not warm:
            self._warm = key
            return "warmup"
        self._warm = None
        return "capture"

    def __call__(self, *args):
        dev = step_device(args)
        if dev.type != "cuda":
            return self.fn(*args)
        # CUDA's current device is the calling thread's own: the capture's
        # stream, the replay's and the barrier's sync are the step's
        # device's, whichever card the thread last set
        with _on_device(dev):
            return self._graphed(args)

    def _graphed(self, args):
        key = step_key(args, self.donate_argnums)
        with self._mu:
            kind = self.decide(key)
            if kind == "warmup":
                st = self.stats
                st.warmups += 1
                st.warmup_at.append(st.warmups + st.replays)
                return self.fn(*args)
            c = self._capture(key, args) if kind == "capture" \
                else self._captured
            for buf, x in zip(c.bufs, copied_leaves(args,
                                                    self.donate_argnums)):
                buf.copy_(x)
            c.graph.replay()
            add_launches(c.launches)
            self.stats.replays += 1
            return materialize(c.plan, args)

    def _capture(self, key: tuple, args: tuple) -> _Captured:
        """Capture the step on buffers of its own (it runs nothing and
        counts nothing; the caller replays it).  With a ``group``, every
        rank first finishes its device work and meets the others at a
        barrier, so no collective is in flight when a capture begins."""
        t0 = time.perf_counter()
        if self.group is not None:
            torch.cuda.synchronize(step_device(args))
            dist.barrier(group=self.group)
        bound, bufs = bind_inputs(args, self.donate_argnums)
        graph, static, launches = capture_graph(self.fn, bound)
        self._captured = _Captured(key, graph, bound, bufs,
                                   output_plan(static, bound,
                                               self.donate_argnums),
                                   launches)
        st = self.stats
        st.captures += 1
        st.capture_at.append(st.warmups + st.replays + 1)
        st.capture_ms.append((time.perf_counter() - t0) * 1e3)
        return self._captured

    def reset(self) -> None:
        """Drop the graph (its pool and its references to the tensors it
        was captured on)."""
        with self._mu:
            self._captured = self._warm = None


def jit_step(fn: Callable, donate_argnums: Sequence[int] = (),
             group=None) -> GraphedStep:
    """``repro``'s ``jit_step`` for the port: ``fn`` with the same signature
    and results, as one CUDA graph on CUDA tensors.

    The parameter tree (argument 0) and the arguments at
    ``donate_argnums`` (the page store) are keyed by identity and used in
    place; every other tensor argument is keyed by shape, dtype and device
    and copied into the graph's input buffer before each replay.  A call
    whose key differs from the graph's (a new shape, a new store, a
    hot-swapped parameter tree) drops the graph.  The first call with a
    key runs ``fn`` eagerly: the warm-up, which loads the kernel
    libraries, cuBLAS's handle and the kernels' plans, and whose results
    are the call's.  The second call with it captures ``fn``
    (``capture_error_mode="thread_local"``: other threads may run CUDA
    work meanwhile; one capture at a time in the process) and replays the
    graph, as every later call with that key does, on the current
    stream.  So a key seen once is never
    captured, and each call runs the step once.  A capture or replay error
    raises.  Results are fresh tensors, except a donated argument, which
    comes back as the caller's own object.  The eager warm-up counts its
    kernel launches as any eager step does; the capture counts none, and
    each replay adds what the capture recorded, so
    ``kernels.ops.launch_counts`` goes on counting device launches.  On
    CPU tensors ``fn`` runs eagerly.  ``group``: a host process group
    (gloo) of the ranks of a meshed step, over which every call's
    decision is agreed (:meth:`GraphedStep.decide`); every rank must then
    call the step as often as the others."""
    return GraphedStep(fn, donate_argnums, group)


def jit_mesh_step(step: Callable, mesh=None,
                  donate_argnums: Sequence[int] = ()) -> GraphedStep:
    """:func:`jit_step` of a step on ``mesh``: on a mesh of more than one
    rank, the ranks agree each call's warm-up, capture or replay over a
    gloo group made here (:meth:`GraphedStep.decide`), so every rank must
    make the step and call it alike.  The train step
    (``training.train_step.jit_train_step``) and the sharded serving
    steps (the decode step with its cache donated, ``donate_argnums=(1,)``,
    as ``repro``'s dry run donates it) run through it."""
    group = None
    if mesh is not None and math.prod(mesh_view(mesh).sizes) > 1:
        group = dist.new_group(backend="gloo")
    return jit_step(step, donate_argnums=donate_argnums, group=group)


def in_place(step: Callable, arg: int, out: int) -> Callable:
    """``step`` with result ``out`` written into argument ``arg`` (a tree of
    the same structure, shapes and dtypes) and that argument returned in
    its place: a step whose new state comes back as new tensors made to
    update donated state, as a graph needs.  A leaf the step already
    wrote in place (the same tensor) is not copied."""
    def run(*args):
        res = list(step(*args))
        dst, dst_s = flatten(args[arg])
        src, src_s = flatten(res[out])
        if dst_s != src_s:
            raise ValueError("in_place: the step's result and the donated "
                             "argument differ in structure")
        for d, x in zip(dst, src):
            if d is not x:
                if d.dtype != x.dtype or d.shape != x.shape:
                    raise ValueError(
                        f"in_place: a result leaf {tuple(x.shape)} "
                        f"{x.dtype} does not fit its donated leaf "
                        f"{tuple(d.shape)} {d.dtype}")
                d.copy_(x)
        res[out] = args[arg]
        return tuple(res)
    return functools.wraps(step)(run)


# ---------------------------------------------------------------------------
# The dense prefill and decode steps, whole or sharded
# ---------------------------------------------------------------------------


def serve_specs(cfg: ModelConfig, rules, mesh, kind: str, batch: int,
                seq: int) -> Dict[str, Any]:
    """The specs of a sharded serving step of ``kind`` (``"prefill"`` or
    ``"decode"``) at a global ``batch`` of rows and ``seq`` positions (the
    prompt's length, or the decode cache's), derived as ``repro``'s
    ``launch/dryrun.py`` derives them (the serving counterpart of
    ``training.train_step.train_specs``):

    * ``"params"``: ``param_specs`` (prefill: FSDP over ``rules.fsdp``,
      tensor parallel over "model"; decode: ``decode=True``, FSDP off);
    * ``"caches"``: ``cache_specs`` with the sequence over ``("data",
      "model")`` at ``batch == 1`` and over ``("model",)`` otherwise (the
      decode step's input, and the prefill's output; None for the
      encoder-only ``audio`` family, whose prefill makes no cache);
    * prefill: ``"batch"``, each input's spec by name (``"tokens"``, and
      the vlm's and audio's ``"embeds"``), its rows over the data axes as
      ``dryrun.batch_shardings`` lays them out;
    * decode: ``"token"``, the (B, 1) tokens' rows over the data axes,
      and ``"cache_len"``, the replicated scalar ``P()`` (a per-request
      (B,) ``cache_len`` takes the token's rows).

    Raises ``NotImplementedError`` naming each layout the steps do not
    execute yet (``models.model.refuse_layouts``), and for an ``audio``
    decode ``repro``'s ``ValueError``."""
    if kind not in ("prefill", "decode"):
        raise ValueError(f"kind must be 'prefill' or 'decode', got {kind!r}")
    if kind == "decode" and cfg.family == "audio":
        raise ValueError("encoder-only arch has no decode step")
    decode = kind == "decode"
    pspecs = param_specs(M.init_params(0, cfg, device="meta"), rules, mesh,
                         decode=decode)
    M.refuse_layouts("sharded=True", cfg, rules, mesh, pspecs)
    cspecs = None
    if cfg.family != "audio":
        seq_axes = ("data", "model") if batch == 1 else ("model",)
        cspecs = cache_specs(M.init_caches(cfg, batch, seq, device="meta"),
                             rules, mesh, seq_axes=seq_axes)
    out = {"params": pspecs, "caches": cspecs}
    rows = batch_spec(rules, mesh, (batch, 1))
    if decode:
        out.update(token=rows, cache_len=P())
        return out
    names = ("embeds",) if cfg.family == "audio" else \
        ("tokens", "embeds") if cfg.frontend_tokens else ("tokens",)
    out["batch"] = {n: P(*tuple(rows), None) if n == "embeds" else rows
                    for n in names}
    return out


def _vocab_sharded(cfg: ModelConfig, pspecs) -> bool:
    """Whether the head's logits come out as vocab shards over "model"."""
    vocab = tuple(pspecs["embed"])[0] if cfg.tie_embeddings \
        else tuple(pspecs["lm_head"])[1]
    return "model" in spec_axes(P(vocab))


def sharded_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Greedy argmax over the vocab shards of ``logits`` ``(B, V_loc)``
    (this rank's columns, in "model" coordinate order), inside a bound
    mesh: each rank's max and its global index, all-gathered over
    "model" as (value, index) pairs in float32 (exact for a vocab under
    2**24), and the first global index among equal maxima wins, as
    ``jnp.argmax`` picks.  -> (B,) int32, the same on every rank."""
    v_loc = logits.shape[-1]
    idx = torch.argmax(logits, dim=-1)
    val = torch.gather(logits, -1, idx[:, None])[:, 0].float()
    glob = (idx + axis_index("model") * v_loc).float()
    pairs = all_gather(torch.stack([val, glob], dim=-1)[None], "model",
                       dim=0)                              # (n, B, 2)
    first = torch.argmax(pairs[..., 0], dim=0)             # first max rank
    return torch.gather(pairs[..., 1], 0, first[None])[0].to(torch.int32)


def make_prefill_step(cfg: ModelConfig, mesh=None, rules=None,
                      sharded: bool = False,
                      shape: Optional[Tuple[int, int]] = None):
    """prefill(params, batch) -> (last-position logits (B, V), caches).

    The head runs on the last position only (``M.forward(...,
    last_only=True)``): ``repro`` keeps ``logits[:, -1]`` of the whole
    sequence's, the same logits up to the product's rounding order, and
    at 32k positions the whole sequence's would not fit a card.

    ``sharded=True`` (a ``DeviceMesh``, ``shape`` the global ``(batch,
    prompt length)``): the step of :func:`serve_specs`' ``"prefill"``
    specs, per rank.  ``params`` are this rank's blocks (each layer's
    gathered over ``rules.fsdp`` as it runs and freed after, with no
    autograd), ``batch`` this rank's rows; -> this rank's rows of the
    logits over the whole vocab (all-gathered over "model") and its
    cache blocks in the ``"caches"`` specs (the sequence over "model",
    every K/V head: the decode step's input as it is; None for
    ``audio``)."""
    if sharded:
        return _sharded_prefill(cfg, mesh, rules, shape)

    def prefill(params, batch):
        logits, _, caches = M.forward(params, cfg, batch, mesh=mesh,
                                      rules=rules, last_only=True)
        return logits[:, -1], caches
    return prefill


def _specs_at(cfg, mesh, rules, kind, shape):
    if shape is None:
        raise ValueError("a sharded step needs its global shape=(batch, "
                         "seq): its specs depend on what divides them")
    rules = rules if rules is not None else MeshRules()
    return rules, serve_specs(cfg, rules, mesh, kind, *shape)


def _sharded_prefill(cfg, mesh, rules, shape):
    rules, specs = _specs_at(cfg, mesh, rules, "prefill", shape)
    pspecs, cspecs = specs["params"], specs["caches"]
    gather = _vocab_sharded(cfg, pspecs)

    @torch.no_grad()
    def prefill(params, batch):
        with bound(mesh):
            logits, _, caches = M.forward(
                params, cfg, batch, mesh=mesh, rules=rules, specs=pspecs,
                cspecs=cspecs, make_caches=cspecs is not None,
                last_only=True)
            logits = logits[:, -1]
            if gather:
                logits = all_gather(logits, "model", dim=-1)
        return logits, caches
    prefill.specs = specs
    return prefill


def make_decode_step(cfg: ModelConfig, mesh=None, rules=None,
                     sample: str = "greedy", paged: bool = False,
                     sharded: bool = False,
                     shape: Optional[Tuple[int, int]] = None):
    """decode_step(params, caches, token, cache_len[, pages]) ->
    (next_token (B, 1) int32, logits (B, V), caches).

    Callers pass ``cache_len = old_len + 1``: the new token's K/V is written
    at ``cache_len - 1`` (in place) and attention covers ``cache_len``
    positions.  ``paged=True`` takes the page store from
    ``models.model.init_paged_caches`` as ``caches`` and the batch's (B, P)
    page-index matrix as ``pages`` (-1 = unused lane; a row with
    ``cache_len == 0`` is inactive, writes nothing and emits token 0).
    An encoder-only config (``audio``) has no decode step and raises
    ``ValueError``, as in ``repro``.

    ``sharded=True`` (a ``DeviceMesh``, ``shape`` the global ``(batch,
    cache length)``): the step of :func:`serve_specs`' ``"decode"``
    specs, per rank: ``params`` this rank's blocks (tensor parallel, no
    FSDP), ``caches`` its cache blocks (its rows, its slice of the
    sequence, every K/V head; written in place by the slice that holds
    the new position), ``token`` and a per-request ``cache_len`` its
    rows, a scalar ``cache_len`` the same on every rank.  -> the next
    token of its rows (:func:`sharded_argmax`), its logits rows over the
    whole vocab (all-gathered over "model") and its cache blocks."""
    if sample != "greedy":
        raise ValueError(sample)
    if cfg.family == "audio":
        raise ValueError("encoder-only arch has no decode step")
    if sharded:
        if paged:
            raise ValueError("the sharded decode step takes a dense cache")
        return _sharded_decode(cfg, mesh, rules, shape)

    def _sample(logits):
        logits = logits[:, -1]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt[:, None], logits

    if paged:
        def decode(params, caches, token, cache_len, pages):
            logits, _, caches = M.forward(params, cfg, {"tokens": token},
                                          caches=caches, cache_len=cache_len,
                                          pages=pages, mesh=mesh,
                                          rules=rules)
            nxt, logits = _sample(logits)
            return nxt, logits, caches
        return decode

    def decode(params, caches, token, cache_len):
        logits, _, caches = M.forward(params, cfg, {"tokens": token},
                                      caches=caches, cache_len=cache_len,
                                      mesh=mesh, rules=rules)
        nxt, logits = _sample(logits)
        return nxt, logits, caches

    return decode


def _sharded_decode(cfg, mesh, rules, shape):
    rules, specs = _specs_at(cfg, mesh, rules, "decode", shape)
    pspecs, cspecs = specs["params"], specs["caches"]
    gather = _vocab_sharded(cfg, pspecs)

    @torch.no_grad()
    def decode(params, caches, token, cache_len):
        with bound(mesh):
            logits, _, caches = M.forward(
                params, cfg, {"tokens": token}, caches=caches,
                cache_len=cache_len, mesh=mesh, rules=rules, specs=pspecs,
                cspecs=cspecs)
            logits = logits[:, -1]
            if gather:
                nxt = sharded_argmax(logits)
                logits = all_gather(logits, "model", dim=-1)
            else:
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt[:, None], logits, caches
    decode.specs = specs
    return decode


def make_paged_prefill_step(cfg: ModelConfig, mesh=None, rules=None):
    """prefill_chunk(params, caches, tokens, cache_len, chunk_lens, pages)
    -> (next_token (R,) int32, caches).

    One continuous-batching prefill tick: ``tokens`` is an (R, C) batch of
    RIGHT-ALIGNED prompt chunks (row i's last ``chunk_lens[i]`` columns are
    real), ``cache_len`` each row's valid length AFTER this chunk, and
    ``pages`` the rows' page-index vectors.  The chunk's K/V go into the
    page store and attend causally to everything already paged.
    ``next_token`` (argmax at the last column) is the request's first
    generated token when this was its final chunk; rows mid-prompt and
    padding rows (``chunk_lens == 0``) return a token the scheduler
    ignores."""

    def prefill(params, caches, tokens, cache_len, chunk_lens, pages):
        logits, _, caches = M.forward(params, cfg, {"tokens": tokens},
                                      caches=caches, cache_len=cache_len,
                                      pages=pages, new_lens=chunk_lens,
                                      mesh=mesh, rules=rules)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt, caches

    return prefill
