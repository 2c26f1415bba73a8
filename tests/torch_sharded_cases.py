"""Shared machinery of the sharded-train tests
(tests/test_torch_mesh_sharded_*.py): the cases, ``repro``'s side and the
port's rank functions.

``repro``'s side (:data:`ORACLE`, run by ``torch_mesh_cases.jax_oracle``
on 8 fake XLA devices) executes the train step as ``launch/dryrun.py``
builds it: ``jax.jit(make_train_step(...), in_shardings=(params by
param_specs, {"m", "v"} by zero1_specs and "step" replicated, the batch by
dryrun's ``batch_shardings``), out_shardings=...)``, and returns each
output leaf's ``addressable_shards`` by device id.  The port's side runs
``make_train_step``/``jit_train_step`` with ``sharded=True`` in gloo
worlds of the same shape (``torch_mesh_cases.run_ranks``), rank ``r`` at
device ``r``'s coordinates.  float32 smoke configs (``smoke_f32``),
``remat="full"``, ``MICRO`` microbatches, tests/test_torch_train_b.py's
optimizer (``TRAIN_OPT``).
"""

import numpy as np
import torch

import torch_mesh_cases as C

MICRO = 2
B, S = 8, 16
# (arch, mesh shape, axis names): llama3.2-1b at every shape, the other
# families of the slice at (data, model) = (2, 2)
DM = ("data", "model")
LLAMA_SHAPES = (((2, 1), DM), ((1, 2), DM), ((2, 2), DM),
                ((2, 2, 2), ("pod", "data", "model")))
CASES = [("llama3.2-1b", s, n) for s, n in LLAMA_SHAPES] + [
    (a, (2, 2), DM) for a in ("granite-20b", "phi-3-vision-4.2b",
                              "hubert-xlarge")]
REFUSED = ("gemma-2b", "minicpm-2b", "phi3.5-moe-42b-a6.6b")


def case_id(case) -> str:
    arch, shape, _ = case
    return f"{arch.split('-')[0]}-{'x'.join(map(str, shape))}"


def batch(cfg, seed=21):
    """A (B, S) batch of the family's inputs: tokens (the vlm's last S -
    F beside F patch embeddings), or the audio family's frame embeddings
    with a random 0/1 loss mask."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.family == "audio":
        return {"embeds": rng.normal(size=(B, S, cfg.d_model)).astype(
                    np.float32),
                "labels": labels,
                "mask": (rng.random((B, S)) < 0.3).astype(np.float32)}
    if cfg.frontend_tokens:
        F = cfg.frontend_tokens
        return {"tokens": rng.integers(0, cfg.vocab, (B, S - F)).astype(
                    np.int32),
                "embeds": rng.normal(size=(B, F, cfg.d_model)).astype(
                    np.float32),
                "labels": labels}
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": labels}


ORACLE = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
devs = np.array(jax.devices())           # 8 fake devices, before dryrun
from repro import configs
from repro.dist.sharding import param_specs, zero1_specs
from repro.launch.dryrun import batch_shardings, tree_ns
from repro.models import model as JM
from repro.training import optimizer as JO
from repro.training import train_step as JT
sys.path.insert(0, INPUTS["tests"])
import torch_mesh_cases as C
import torch_sharded_cases as SC

def shards(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(shards(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: {s.device.id: np.asarray(s.data)
                          for s in tree.addressable_shards}}

opt = JO.OptimizerConfig(**C.TRAIN_OPT)
tcfg = JT.TrainConfig(remat="full", microbatches=SC.MICRO)
OUT["params"], OUT["steps"] = {}, {}
for arch, shape, names in INPUTS["cases"]:
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              compute_dtype=jnp.float32,
                              param_dtype=jnp.float32)
    rules = configs.get(arch)[1]
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    OUT["params"][arch] = jax.tree.map(np.asarray, params)
    batch = {k: jnp.asarray(v) for k, v in INPUTS["batches"][arch].items()}
    mesh = Mesh(devs[:int(np.prod(shape))].reshape(shape), names)
    pshape = jax.eval_shape(lambda: params)
    pspecs = param_specs(pshape, rules, mesh)
    mspecs = zero1_specs(pspecs, pshape, mesh)
    ospecs = {"m": mspecs, "v": mspecs, "step": P()}
    pshard, oshard = tree_ns(mesh, pspecs), tree_ns(mesh, ospecs)
    bshard = batch_shardings(cfg, batch, rules, mesh)
    step = JT.make_train_step(cfg, opt, mesh, rules, tcfg)
    jitted = jax.jit(step, in_shardings=(pshard, oshard, bshard),
                     out_shardings=(pshard, oshard, None))
    with mesh:
        p1, s1, m = jitted(jax.device_put(params, pshard),
                           jax.device_put(JO.adamw_init(params, opt),
                                          oshard), batch)
    OUT["steps"][(arch, shape)] = {
        "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
        "step": int(s1["step"]), "params": shards(p1),
        "m": shards(s1["m"]), "v": shards(s1["v"]),
        "step_shards": shards(s1["step"]),
        "m_whole": C._flat_np(s1["m"])}
OUT["lr"] = float(JO.lr_schedule(opt, jnp.asarray(1)))
"""


def oracle_inputs(cases):
    import os
    return {"tests": os.path.dirname(os.path.abspath(__file__)),
            "cases": list(cases),
            "batches": {a: batch(C.smoke_f32(a)) for a, _, _ in cases}}


def _tensors(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def rank_sharded_train(rank, world, arch, shape, names, params_np, batch_np,
                       unsharded=True):
    """One step of ``make_train_step(..., sharded=True)`` and one of
    ``jit_train_step(..., sharded=True)`` (eager on CPU tensors, in
    place) from the same blocks; -> each step's loss, grad norm, step
    count, parameter and moment blocks and collectives by kind, the
    shapes the rank stores after the step, the whole parameters and
    moments gathered back (``unshard_tree``), and on rank 0 (with
    ``unsharded``) the port's unsharded step on the same batch."""
    from repro_torch import configs as TC
    from repro_torch.dist import sharding as DS
    from repro_torch.ft.elastic import reshard_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as TM
    from repro_torch.training import optimizer as TO
    from repro_torch.training import train_step as TT

    cfg, rules = C.smoke_f32(arch), TC.get(arch)[1]
    mesh = make_mesh(shape, names, device="cpu")
    params = TM.from_jax_params(params_np, cfg, device="cpu")
    opt = TO.OptimizerConfig(**C.TRAIN_OPT)
    tcfg = TT.TrainConfig(remat="full", microbatches=MICRO)
    pspecs, ospecs = TT.train_specs(cfg, rules, mesh)
    pshape = TM.init_params(0, cfg, device="meta")
    b = _tensors(batch_np)
    out = {"coords": DS.mesh_coords(mesh), "before": C._flat(params)}
    for kind, make in (("eager", TT.make_train_step),
                       ("jit", TT.jit_train_step)):
        blocks = reshard_tree(params, params, rules, mesh, device="cpu")
        state = TO.sharded_adamw_init(pshape, ospecs["m"], mesh, opt, "cpu")
        step = make(cfg, opt, mesh, rules, tcfg, sharded=True)
        DS.reset_collective_counts()
        p1, s1, m = step(blocks, state, b)
        out[kind] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "step": int(s1["step"]), "params": C._flat(p1),
                     "m": C._flat(s1["m"]), "v": C._flat(s1["v"]),
                     "counts": DS.collective_counts(),
                     "in_place": all(x is y for x, y in zip(
                         TM.leaves(p1), TM.leaves(blocks)))}
    out["stored"] = {k: {n: tuple(a.shape) for n, a in out["eager"][k].items()}
                     for k in ("params", "m", "v")}
    out["whole"] = {"params": C._flat(DS.unshard_tree(p1, pspecs, mesh)),
                    "m": C._flat(DS.unshard_tree(s1["m"], ospecs["m"],
                                                 mesh))}
    if rank == 0 and unsharded:
        p2, s2, m2 = TT.make_train_step(cfg, opt, tcfg=tcfg)(
            params, TO.adamw_init(params, opt), b)
        out["unsharded"] = {"loss": float(m2["loss"]),
                            "grad_norm": float(m2["grad_norm"]),
                            "params": C._flat(p2), "m": C._flat(s2["m"])}
    return out


def expected_blocks(arch, shape, names):
    """{"params"/"m": {dotted name: block shape}} from the port's specs on
    a shape-only mesh."""
    from repro_torch import configs as TC
    from repro_torch.dist import sharding as DS
    from repro_torch.models import model as TM
    from repro_torch.training import train_step as TT

    cfg = C.smoke_f32(arch)
    mesh = DS.ShapeMesh(names, shape)
    pspecs, ospecs = TT.train_specs(cfg, TC.get(arch)[1], mesh)
    pshape = {n: tuple(x.shape) for n, x in _flat_specs(
        TM.init_params(0, cfg, device="meta")).items()}
    out = {}
    for kind, specs in (("params", pspecs), ("m", ospecs["m"])):
        flat = _flat_specs(specs)
        out[kind] = {n: DS.block_shape(pshape[n], flat[n], mesh)
                     for n in pshape}
    return out


def _flat_specs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_specs(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def port_specs(arch, shape, names):
    """The port's (param specs, moment specs) of a case, flat by dotted
    name, on a shape-only mesh."""
    from repro_torch import configs as TC
    from repro_torch.dist import sharding as DS
    from repro_torch.training import train_step as TT

    pspecs, ospecs = TT.train_specs(C.smoke_f32(arch), TC.get(arch)[1],
                                    DS.ShapeMesh(names, shape))
    return _flat_specs(pspecs), _flat_specs(ospecs["m"])


def block(whole, spec, shape, names, coords):
    """The block of ``whole`` at ``coords`` under ``spec``."""
    from repro_torch.dist import sharding as DS

    return DS.shard_block(torch.from_numpy(np.asarray(whole)), spec,
                          DS.ShapeMesh(names, shape), coords).numpy()


def close_rel(got, want, rel, what):
    """Every element within ``rel`` of the largest of ``want``."""
    want = np.asarray(want)
    assert np.shape(got) == want.shape, (what, np.shape(got), want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, (what, err, scale)


def update_within_bound(got, want, before, m, lr, what):
    """tests/test_torch_mesh_train.py's bound on a first AdamW update:
    ``lr * (1e-3 + 2e-5 * max|g| / (|g| + eps))``, ``g`` the clipped
    gradient from the first moment (R14)."""
    g = np.abs(m) / 0.1
    bound = lr * (1e-3 + 2e-5 * g.max() / (g + 1e-8))
    d = np.abs((np.asarray(got) - before) - (np.asarray(want) - before))
    assert (d <= bound).all(), (what, float(d.max()))


# ---------------------------------------------------------------------------
# The checks, each over every rank of a case.  ``ranks``: the ranks'
# records; ``orc``: the oracle's output.
#
# Tolerances: the loss and the gradient norm within ``REL`` of ``repro``'s,
# the step count exactly; each moment block within ``REL`` of the largest
# element of ``repro``'s shard (about 1e-6 here: the sharded products sum
# in another order); each parameter block's update within R14's bound of
# ``repro``'s (``update_within_bound``).  The first AdamW step divides each
# first moment by the root of its second, so an element whose gradient is
# near 0 moves by about ``lr`` whichever way its rounding falls: a
# relative tolerance on the parameters cannot hold that (they differ by up
# to 1e-4 of the largest element here).
# ---------------------------------------------------------------------------

REL = 1e-5
KINDS = ("eager", "jit")


def check_loss_and_norm(case, ranks, orc):
    want = orc["steps"][case[:2]]
    for r in ranks:
        for kind in KINDS:
            got = r[kind]
            for k in ("loss", "grad_norm"):
                assert abs(got[k] - want[k]) <= REL * abs(want[k]), \
                    (kind, k, got[k], want[k])
            assert got["step"] == want["step"] == 1
    for by_dev in want["step_shards"].values():
        assert all(int(x) == 1 for x in by_dev.values())


def check_moments(case, ranks, orc):
    want = orc["steps"][case[:2]]
    for rank, r in enumerate(ranks):
        for kind in KINDS:
            for t in ("m", "v"):
                assert sorted(r[kind][t]) == sorted(want[t])
                for path, by_dev in want[t].items():
                    close_rel(r[kind][t][path], by_dev[rank], REL,
                              (kind, t, path, rank))


def check_param_updates(case, ranks, orc):
    arch, shape, names = case
    want = orc["steps"][case[:2]]
    before = C._flat_np(orc["params"][arch])
    pspecs, _ = port_specs(*case)
    for rank, r in enumerate(ranks):
        for kind in KINDS:
            got = r[kind]["params"]
            assert sorted(got) == sorted(want["params"])
            for path, by_dev in want["params"].items():
                cut = [block(x, pspecs[path], shape, names, r["coords"])
                       for x in (before[path], want["m_whole"][path])]
                assert got[path].shape == by_dev[rank].shape, path
                update_within_bound(got[path], by_dev[rank], *cut,
                                    orc["lr"], (kind, path, rank))


def check_stored_blocks(case, ranks):
    """After the step each rank holds only its blocks: every parameter
    and moment has its spec's block shape, none its whole shape."""
    want = expected_blocks(*case)
    for r in ranks:
        assert r["stored"]["params"] == want["params"]
        assert r["stored"]["m"] == r["stored"]["v"] == want["m"]


def check_gathered_equals_unsharded(ranks):
    """``unshard_tree`` of the blocks against the port's own unsharded
    step on the same batch: the loss and norm within ``REL``, the
    moments within ``REL`` of the largest, the updates within R14's
    bound."""
    import torch_mesh_cases as MC

    ref = ranks[0]["unsharded"]
    lr = MC.TRAIN_OPT["lr"]
    for r in ranks:
        for k in ("loss", "grad_norm"):
            assert abs(r["eager"][k] - ref[k]) <= REL * abs(ref[k]), k
        for path, m in ref["m"].items():
            close_rel(r["whole"]["m"][path], m, REL, path)
        for path, p in ref["params"].items():
            before = ranks[0]["before"][path]
            update_within_bound(r["whole"]["params"][path], p, before,
                                ref["m"][path], lr, path)


def check_replicas_bit_equal(case, ranks):
    """Ranks at the same coordinates on every axis a leaf's spec names
    hold bit-equal blocks of it (parameters and moments), and the same
    loss and norm."""
    from repro_torch.dist.sharding import spec_axes

    pspecs, mspecs = port_specs(*case)
    for kind in KINDS:
        for t, specs in (("params", pspecs), ("m", mspecs), ("v", mspecs)):
            for path, spec in specs.items():
                seen = {}
                for r in ranks:
                    key = tuple(r["coords"][a] for a in spec_axes(spec))
                    x = r[kind][t][path]
                    if key in seen:
                        np.testing.assert_array_equal(x, seen[key],
                                                      err_msg=path)
                    seen[key] = x
        for k in ("loss", "grad_norm"):
            assert len({r[kind][k] for r in ranks}) == 1, (kind, k)


def check_jit_in_place(ranks):
    """``jit_train_step`` writes the blocks it was given (on the CPU, its
    step runs eagerly) and equals ``make_train_step`` bit for bit, and
    both issue the all-gathers, reduce-scatters and all-reduces."""
    for r in ranks:
        assert r["jit"]["in_place"] and not r["eager"]["in_place"]
        for t in ("params", "m", "v"):
            for path, x in r["eager"][t].items():
                np.testing.assert_array_equal(r["jit"][t][path], x,
                                              err_msg=path)
        for kind in KINDS:
            counts = r[kind]["counts"]
            assert all(counts.get(k, 0) > 0 for k in (
                "all_gather", "reduce_scatter", "all_reduce")), counts


# ---------------------------------------------------------------------------
# Checkpoint and elastic restart (tests/test_torch_mesh_sharded_ckpt.py)
# ---------------------------------------------------------------------------

CKPT_ARCH = "llama3.2-1b"


def _ckpt_setup():
    from repro_torch.models import model as TM
    from repro_torch.training import optimizer as TO
    from repro_torch.training import train_step as TT

    cfg = C.smoke_f32(CKPT_ARCH)
    return (cfg, TO.OptimizerConfig(**C.TRAIN_OPT),
            TT.TrainConfig(remat="full", microbatches=MICRO),
            TM.init_params(0, cfg, device="meta"))


def ckpt_batches():
    cfg = C.smoke_f32(CKPT_ARCH)
    return [batch(cfg, seed=s) for s in (31, 32)]


def rank_ckpt_save(rank, world, shape, names, directory):
    """Step 1 of the sharded step from seeded blocks on ``shape``, its
    state saved sharded (``save_checkpoint`` with specs: rank 0 writes the
    gathered leaves) to ``directory/sharded`` and, gathered here, whole
    to ``directory/whole`` by rank 0's plain ``save_checkpoint``; then
    the uninterrupted step 2.  -> both steps' losses and norms."""
    import os

    from repro_torch import configs as TC
    from repro_torch.dist import sharding as DS
    from repro_torch.ft.checkpoint import save_checkpoint
    from repro_torch.ft.elastic import reshard_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as TM
    from repro_torch.training import optimizer as TO
    from repro_torch.training import train_step as TT

    cfg, opt, tcfg, pshape = _ckpt_setup()
    rules = TC.get(CKPT_ARCH)[1]
    mesh = make_mesh(shape, names, device="cpu")
    pspecs, ospecs = TT.train_specs(cfg, rules, mesh)
    whole = TM.init_params(0, cfg, device="cpu")
    params = reshard_tree(whole, whole, rules, mesh, device="cpu")
    state = TO.sharded_adamw_init(pshape, ospecs["m"], mesh, opt, "cpu")
    step = TT.make_train_step(cfg, opt, mesh, rules, tcfg, sharded=True)
    b1, b2 = (_tensors(b) for b in ckpt_batches())
    params, state, m1 = step(params, state, b1)
    tree = {"params": params, "opt": state}
    specs = {"params": pspecs, "opt": ospecs}
    save_checkpoint(os.path.join(directory, "sharded"), 1, tree,
                    specs=specs, mesh=mesh)
    whole = DS.unshard_tree(tree, specs, mesh)
    if rank == 0:
        save_checkpoint(os.path.join(directory, "whole"), 1, whole)
    _, _, m2 = step(params, state, b2)
    return {k: [float(m1[k]), float(m2[k])] for k in ("loss", "grad_norm")}


def rank_ckpt_restore(rank, world, shape, names, directory):
    """The sharded checkpoint loaded and placed on ``shape``
    (``reshard_tree`` for the parameters, ``reshard_opt_state`` for the
    AdamW state), then step 2.  -> its loss and norm, and the shapes the
    rank holds."""
    import os

    from repro_torch import configs as TC
    from repro_torch.ft.checkpoint import load_checkpoint
    from repro_torch.ft.elastic import reshard_opt_state, reshard_tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import train_step as TT

    cfg, opt, tcfg, pshape = _ckpt_setup()
    rules = TC.get(CKPT_ARCH)[1]
    mesh = make_mesh(shape, names, device="cpu")
    like = {"params": pshape, "opt": {"m": pshape, "v": pshape,
                                      "step": torch.zeros(())}}
    host = load_checkpoint(os.path.join(directory, "sharded"), 1, like)
    params = reshard_tree(host["params"], pshape, rules, mesh, device="cpu")
    state = reshard_opt_state(host["opt"], pshape, rules, mesh,
                              device="cpu")
    step = TT.make_train_step(cfg, opt, mesh, rules, tcfg, sharded=True)
    _, _, m = step(params, state, _tensors(ckpt_batches()[1]))
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "stored": {n: tuple(a.shape) for n, a in C._flat(params).items()}}
