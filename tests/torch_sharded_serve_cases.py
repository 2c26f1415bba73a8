"""Shared machinery of the sharded serving tests
(tests/test_torch_mesh_sharded_serve_{prefill,decode}.py): the cases,
``repro``'s side and the port's rank functions.

``repro``'s side (:data:`ORACLE`, run by ``torch_mesh_cases.jax_oracle``
on 8 fake XLA devices) executes the prefill and decode steps as
``launch/dryrun.py`` builds them: ``jax.jit(make_prefill_step(...),
in_shardings=(params by param_specs, the batch by dryrun's
batch_shardings))`` and ``jax.jit(make_decode_step(...),
in_shardings=(params by param_specs(decode=True), caches by cache_specs
with the sequence over ("data", "model") at B = 1 and over ("model",)
otherwise, tokens over the batch axes, a replicated scalar cache_len),
out_shardings=(tokens, None, caches), donate_argnums=(1,))``.  It returns
the whole logits and tokens, and each cache leaf's ``addressable_shards``
by device id (the prefill's caches placed in ``cache_specs``' layout
first).  The port's side runs ``make_prefill_step``/``make_decode_step``
with ``sharded=True`` on gloo worlds of the same shape
(``torch_mesh_cases.run_ranks``), rank ``r`` at device ``r``'s
coordinates, eager and through ``jit_mesh_step`` on the CPU stand-in
graph (``torch_mesh_cases.fake_graphs``: warm-up, capture, replays).

float32 smoke configs (``smoke_f32``) with ``repro``'s parameters
(``from_jax_params``).  The decode caches are bf16, the dry run's cache
dtype, filled with seeded values; the prefill's are the compute dtype's.
"""

import numpy as np
import torch

import torch_mesh_cases as C

B, PROMPT, CACHE = 4, 16, 32
DM = ("data", "model")
PDM = ("pod", "data", "model")
LLAMA_SHAPES = (((2, 1), DM), ((1, 2), DM), ((2, 2), DM), ((2, 2, 2), PDM))
# (arch, mesh shape, axis names, batch, per-request cache_len)
PREFILL_CASES = [("llama3.2-1b", s, n, B, False) for s, n in LLAMA_SHAPES] + [
    ("llama3.2-1b", (2, 2), DM, 1, False)] + [
    (a, (2, 2), DM, B, False) for a in ("granite-20b", "phi-3-vision-4.2b",
                                        "hubert-xlarge")]
DECODE_CASES = [("llama3.2-1b", s, n, B, False) for s, n in LLAMA_SHAPES] + [
    ("llama3.2-1b", (2, 2), DM, 1, False),
    ("llama3.2-1b", (2, 2), DM, B, True)] + [
    (a, (2, 2), DM, B, False) for a in ("granite-20b", "phi-3-vision-4.2b")]
# the decode steps' scalar cache_len: two with every valid position in
# the first slice of the sequence (the other slices hold none), then the
# cache's last two positions; per request, each row its own, crossing the
# slices' boundary
DECODE_LENS = (3, 4, CACHE - 1, CACHE)
ROW_LENS = np.array([[2, CACHE - 4, CACHE // 2 - 1, CACHE // 2],
                     [3, CACHE - 3, CACHE // 2, CACHE // 2 + 1],
                     [4, CACHE - 2, CACHE // 2 + 1, 5],
                     [5, CACHE - 1, 1, CACHE]], np.int32)


def case_id(case) -> str:
    arch, shape, _, b, rows = case
    return (f"{arch.split('-')[0]}-{'x'.join(map(str, shape))}"
            f"{'-b1' if b == 1 else ''}{'-rows' if rows else ''}")


def prefill_batch(cfg, b, seed=41):
    """A (b, PROMPT) prompt batch: tokens (the vlm's last PROMPT - F
    beside F patch embeddings), or the audio family's frame
    embeddings."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"embeds": rng.normal(size=(b, PROMPT, cfg.d_model)).astype(
            np.float32)}
    if cfg.frontend_tokens:
        F = cfg.frontend_tokens
        return {"tokens": rng.integers(0, cfg.vocab, (b, PROMPT - F)).astype(
                    np.int32),
                "embeds": rng.normal(size=(b, F, cfg.d_model)).astype(
                    np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab, (b, PROMPT)).astype(
        np.int32)}


def decode_inputs(cfg, b, per_row, seed=43):
    """A seeded cache ``(L, b, CACHE, KVH, hd)`` (float32 values that both
    sides round to bf16), each step's input tokens (b, 1) and its
    cache_len: scalar ``DECODE_LENS`` or per request ``ROW_LENS``."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, b, CACHE, cfg.n_kv_heads, cfg.hd)
    lens = [ROW_LENS[i, :b].copy() for i in range(len(ROW_LENS))] \
        if per_row else [np.int32(n) for n in DECODE_LENS]
    return {"cache": {k: rng.normal(size=shape).astype(np.float32)
                      for k in ("k", "v")},
            "tokens": [rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32)
                       for _ in lens],
            "lens": lens}


ORACLE = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
devs = np.array(jax.devices())           # 8 fake devices, before dryrun
from repro import configs
from repro.dist.sharding import _divisible, cache_specs, param_specs
from repro.launch.dryrun import batch_shardings, ns, tree_ns
from repro.models import model as JM
from repro.serving.steps import make_decode_step, make_prefill_step
sys.path.insert(0, INPUTS["tests"])
import torch_sharded_serve_cases as SV

def shards(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(shards(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: {s.device.id: np.asarray(s.data).astype(np.float32)
                          for s in tree.addressable_shards}}

OUT["params"], OUT["cases"] = {}, {}
for case in INPUTS["cases"]:
    arch, shape, names, B, per_row = case
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              compute_dtype=jnp.float32,
                              param_dtype=jnp.float32)
    rules = configs.get(arch)[1]
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    OUT["params"][arch] = jax.tree.map(np.asarray, params)
    mesh = Mesh(devs[:int(np.prod(shape))].reshape(shape), names)
    pshape = jax.eval_shape(lambda: params)
    seq_axes = ("data", "model") if B == 1 else ("model",)
    key = SV.case_id(case)
    if INPUTS["kind"] == "prefill":
        batch = {k: jnp.asarray(v) for k, v in INPUTS["batches"][key].items()}
        pshard = tree_ns(mesh, param_specs(pshape, rules, mesh))
        bshard = batch_shardings(cfg, batch, rules, mesh)
        jitted = jax.jit(make_prefill_step(cfg, mesh, rules),
                         in_shardings=(pshard, bshard))
        with mesh:
            logits, caches = jitted(jax.device_put(params, pshard), batch)
        rec = {"logits": np.asarray(logits)}
        if cfg.family != "audio":
            cspecs = cache_specs(jax.eval_shape(lambda: caches), rules,
                                 mesh, seq_axes=seq_axes)
            rec["caches"] = shards(jax.device_put(caches,
                                                  tree_ns(mesh, cspecs)))
        OUT["cases"][key] = rec
        continue
    inp = INPUTS["decode"][key]
    cache = {k: jnp.asarray(v).astype(jnp.bfloat16)
             for k, v in inp["cache"].items()}
    pshard = tree_ns(mesh, param_specs(pshape, rules, mesh, decode=True))
    cshard = tree_ns(mesh, cache_specs(jax.eval_shape(lambda: cache), rules,
                                       mesh, seq_axes=seq_axes))
    bax = rules.batch_axes(mesh) or None
    tshard = ns(mesh, _divisible(P(bax, None), (B, 1), mesh))
    lshard = ns(mesh, _divisible(P(bax), (B,), mesh) if per_row else P())
    jitted = jax.jit(make_decode_step(cfg, mesh, rules),
                     in_shardings=(pshard, cshard, tshard, lshard),
                     out_shardings=(tshard, None, cshard),
                     donate_argnums=(1,))
    p = jax.device_put(params, pshard)
    caches = jax.device_put(cache, cshard)
    steps = []
    for tok, n in zip(inp["tokens"], inp["lens"]):
        with mesh:
            nxt, logits, caches = jitted(p, caches, jnp.asarray(tok),
                                         jnp.asarray(n))
        steps.append({"token": np.asarray(nxt), "logits": np.asarray(logits),
                      "caches": shards(caches)})
    OUT["cases"][key] = steps
"""


def oracle_inputs(cases, kind):
    import os
    out = {"tests": os.path.dirname(os.path.abspath(__file__)),
           "cases": list(cases), "kind": kind}
    if kind == "prefill":
        out["batches"] = {case_id(c): prefill_batch(C.smoke_f32(c[0]), c[3])
                          for c in cases}
    else:
        out["decode"] = {case_id(c): decode_inputs(C.smoke_f32(c[0]), c[3],
                                                   c[4]) for c in cases}
    return out


def _setup(arch, shape, names, params_np):
    from repro_torch import configs as TC
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as TM

    cfg, rules = C.smoke_f32(arch), TC.get(arch)[1]
    mesh = make_mesh(shape, names, device="cpu")
    return cfg, rules, mesh, TM.from_jax_params(params_np, cfg, device="cpu")


def _rows(x, spec, mesh):
    """This rank's rows of a (B, ...) tensor under a spec's dim-0 entry."""
    from repro_torch.dist import sharding as DS

    return DS.shard_block(x, DS.P(tuple(spec)[0]), mesh)


def _graph_stats(step):
    st = step.stats
    return (st.warmups, st.captures, st.replays)


def rank_sharded_prefill(rank, world, case, params_np, batch_np):
    """``make_prefill_step(..., sharded=True)`` on this rank's blocks and
    rows, eager, then through ``jit_mesh_step`` on the stand-in graph
    three times (warm-up, capture and replay, replay).  -> the logits
    rows, the cache blocks, their shapes, the collectives by kind and the
    graph's results and stats."""
    from repro_torch.dist import sharding as DS
    from repro_torch.ft.elastic import reshard_tree
    from repro_torch.serving import steps as ST

    arch, shape, names, b, _ = case
    cfg, rules, mesh, params = _setup(arch, shape, names, params_np)
    step = ST.make_prefill_step(cfg, mesh, rules, sharded=True,
                                shape=(b, PROMPT))
    specs = step.specs
    blocks = reshard_tree(params, params, rules, mesh, device="cpu")
    local = {k: DS.shard_block(torch.from_numpy(v), specs["batch"][k], mesh)
             for k, v in batch_np.items()}
    DS.reset_collective_counts()
    logits, caches = step(blocks, local)
    out = {"coords": DS.mesh_coords(mesh), "logits": logits.numpy().copy(),
           "counts": DS.collective_counts(),
           "stored": {n: tuple(x.shape) for n, x in _shapes(blocks)}}
    if caches is not None:
        out["caches"] = C._flat(caches)
        out["cache_shapes"] = {k: tuple(v.shape) for k, v in caches.items()}
    C.fake_graphs()
    jstep = ST.jit_mesh_step(
        ST.make_prefill_step(cfg, mesh, rules, sharded=True,
                             shape=(b, PROMPT)), mesh)
    runs = [jstep(blocks, local) for _ in range(3)]
    out["jit"] = {"logits": [r[0].numpy().copy() for r in runs],
                  "caches": [None if r[1] is None else C._flat(r[1])
                             for r in runs],
                  "stats": _graph_stats(jstep)}
    return out


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _shapes(v, f"{prefix}{k}.")
        return out
    return [(prefix[:-1], tree)]


def rank_sharded_decode(rank, world, case, params_np, inputs):
    """``make_decode_step(..., sharded=True)`` on this rank's blocks:
    every step of ``inputs`` eager, then through ``jit_mesh_step`` with
    the cache donated on the stand-in graph, from the same blocks made
    anew.  -> per step the tokens and logits rows, the cache blocks, the
    (layer, row, position) entries of the blocks the step changed, and
    whether the step returned the cache tensors it was given; the
    collectives by kind, the shapes stored, the graph's stats."""
    from repro_torch.dist import sharding as DS
    from repro_torch.ft.elastic import reshard_tree
    from repro_torch.serving import steps as ST

    arch, shape, names, b, per_row = case
    cfg, rules, mesh, params = _setup(arch, shape, names, params_np)
    make = lambda: ST.make_decode_step(cfg, mesh, rules, sharded=True,  # noqa
                                       shape=(b, CACHE))
    step = make()
    specs = step.specs
    blocks = reshard_tree(params, params, rules, mesh, decode=True,
                          device="cpu")

    def cache_blocks():
        return {k: DS.shard_block(torch.from_numpy(v).to(torch.bfloat16),
                                  specs["caches"][k], mesh).clone()
                for k, v in inputs["cache"].items()}

    def args(i):
        tok = _rows(torch.from_numpy(inputs["tokens"][i]), specs["token"],
                    mesh)
        n = torch.from_numpy(np.asarray(inputs["lens"][i]))
        return tok, (_rows(n, specs["token"], mesh) if per_row else n)

    out = {"coords": DS.mesh_coords(mesh),
           "cache_spec": [list(e) if isinstance(e, tuple) else e
                          for e in tuple(specs["caches"]["k"])],
           "stored": {n: tuple(x.shape) for n, x in _shapes(blocks)}}
    caches = cache_blocks()
    out["cache_shapes"] = {k: tuple(v.shape) for k, v in caches.items()}
    DS.reset_collective_counts()
    eager = []
    for i in range(len(inputs["lens"])):
        before = {k: v.clone() for k, v in caches.items()}
        nxt, logits, new = step(blocks, caches, *args(i))
        changed = sorted({tuple(int(t) for t in ix) for k in caches
                          for ix in torch.nonzero(
                              (new[k].float() != before[k].float()).any(-1)
                              .any(-1))})
        eager.append({"token": nxt.numpy().copy(),
                      "logits": logits.numpy().copy(),
                      "caches": {k: v.float().numpy().copy()
                                 for k, v in new.items()},
                      "changed": changed,
                      "in_place": all(new[k] is caches[k] for k in caches),
                      "finite": bool(torch.isfinite(logits).all())})
    out["counts"] = DS.collective_counts()
    out["eager"] = eager
    C.fake_graphs()
    jstep = ST.jit_mesh_step(make(), mesh, donate_argnums=(1,))
    caches = cache_blocks()
    graph = []
    for i in range(len(inputs["lens"])):
        nxt, logits, new = jstep(blocks, caches, *args(i))
        graph.append({"token": nxt.numpy().copy(),
                      "logits": logits.numpy().copy(),
                      "caches": {k: v.float().numpy().copy()
                                 for k, v in new.items()},
                      "in_place": all(new[k] is caches[k] for k in caches)})
    out["graph"] = graph
    out["graph_stats"] = _graph_stats(jstep)
    return out


def rank_cases(rank, world, fn_name, items):
    """``fn_name(rank, world, *args)`` for each ``args`` of ``items`` in
    turn on this world (the cases of one world size share a spawn)."""
    fn = globals()[fn_name]
    return [fn(rank, world, *args) for args in items]


def run_cases(kind, cases, oracle, inputs):
    """Every case of ``cases`` on the port's side, one spawn a world
    size; ``inputs(case)`` the case's batch or decode inputs.  -> {case:
    the ranks' records}."""
    fn = {"prefill": "rank_sharded_prefill",
          "decode": "rank_sharded_decode"}[kind]
    by_world = {}
    for case in cases:
        by_world.setdefault(int(np.prod(case[1])), []).append(case)
    out = {}
    for world, group in by_world.items():
        items = [(case, oracle["params"][case[0]], inputs(case))
                 for case in group]
        res = C.run_ranks("torch_sharded_serve_cases:rank_cases", world, fn,
                          items)
        for i, case in enumerate(group):
            out[case] = [r[i] for r in res]
    return out


# ---------------------------------------------------------------------------
# The checks, each over every rank of a case.  ``ranks``: the ranks'
# records; ``orc``: the oracle's record of the case.
#
# Tolerances: tokens exactly; logits within ``REL`` of the largest of
# ``repro``'s (the sharded products and the sliced softmax sum in another
# order); a bf16 cache block within one bf16 rounding of ``repro``'s
# shard, element by element (a written K/V is a float32 value rounded to
# bf16 on both sides, and float32 values a few ulps apart can round to
# neighbouring bf16 values); a float32 cache block (the prefill's at
# float32 compute) within ``REL`` of the largest, since one float32
# rounding is below the products' summation-order error.
# ---------------------------------------------------------------------------

REL = 1e-5


def close_rel(got, want, rel, what):
    want = np.asarray(want)
    assert np.shape(got) == want.shape, (what, np.shape(got), want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, (what, err, scale)


def within_bf16_rounding(got, want, what):
    """Each element of ``got`` equal to ``want``'s or one bf16 step from
    it (both hold bf16 values as float32)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    mag = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    step = np.exp2(np.floor(np.log2(mag)) - 7)
    bad = np.abs(got - want) > step
    assert not bad.any(), (what, int(bad.sum()),
                           float(np.abs(got - want).max()))


def row_block(whole, ranks_rec, case):
    """The rank's rows of a whole (B, ...) output, under the batch
    axes' split of the case's mesh."""
    from repro_torch import configs as TC
    from repro_torch.dist import sharding as DS

    arch, shape, names, b, _ = case
    mesh = DS.ShapeMesh(names, shape)
    spec = DS.batch_spec(TC.get(arch)[1], mesh, (b, 1))
    return DS.shard_block(torch.from_numpy(np.asarray(whole)),
                          DS.P(tuple(spec)[0]), mesh,
                          ranks_rec["coords"]).numpy()


def seq_slice(rec, case):
    """(first position, positions) of the rank's slice of the cache's
    sequence, from its cache spec and coordinates."""
    _, shape, names, _, _ = case
    e = rec["cache_spec"][2]
    axes = () if e is None else (e,) if isinstance(e, str) else tuple(e)
    idx, n = 0, 1
    for a in axes:
        size = shape[names.index(a)]
        idx, n = idx * size + rec["coords"][a], n * size
    return idx * (CACHE // n), CACHE // n


def expected_writes(rec, case, n, lens_rows):
    """The (layer, local row, local position) entries a decode step with
    cache_len ``n`` (scalar or this rank's rows) writes into this rank's
    block: the position ``n - 1`` (clamped into the cache) where this
    rank's slice holds it, in every layer and row."""
    lo, size = seq_slice(rec, case)
    L, rows = rec["cache_shapes"]["k"][:2]
    out = set()
    for r in range(rows):
        pos = int(lens_rows[r] if np.ndim(n) else n) - 1
        pos = min(max(pos, 0), CACHE - 1)
        if lo <= pos < lo + size:
            out.update((layer, r, pos - lo) for layer in range(L))
    return sorted(out)
