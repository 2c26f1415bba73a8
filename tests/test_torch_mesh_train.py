"""Gradients across ranks: the port's differentiable collectives and the
expert-parallel train step on gloo worlds, against ``jax.grad`` through
``repro``'s ``shard_map_compat`` on fake devices at the same mesh shape.

* Each collective (``psum``, ``all_gather`` along dims 0 and 1,
  ``all_to_all``) and ``shard_map_compat``'s own blocks (an input sharded
  over one axis of three, a replicated input, a ``P()`` output from
  ``pmean``) in a small function on the ``(2, 2, 2)`` ("pod", "data",
  "model") mesh: the output, and the gradients of ``sum(y * c)`` (plus
  ``AUX_CT`` times the ``P()`` output) with respect to the sharded and
  the replicated input, within ``REL`` of the largest element.
* ``make_train_step`` of the phi3.5-moe and llama4 smoke configs
  (float32 parameters, ``remat="full"``) at (data, model) = (1, 2), (2,
  2) and ("pod", "data", "model") = (2, 2, 2), on one 4 x 8 batch: the
  port's loss and every gradient leaf against ``jax.value_and_grad`` of
  ``repro``'s ``loss_fn`` with the mesh (the loss within
  ``STEP_LOSS_REL``, each leaf within ``GRAD_OF_MAX`` of its largest
  element), one step's updates within tests/test_torch_mesh_engine.py's
  bound of ``repro``'s jitted step, and every rank's new parameters bit
  for bit the same.  Capacity and the aux loss are counted per shard, so
  the reference is ``repro`` at the same mesh shape, never the one-device
  gradient.
"""

import numpy as np
import pytest

import torch_mesh_cases as C

REL = 1e-5
STEP_LOSS_REL = 1e-5
GRAD_OF_MAX = 1e-4
GRAD_REL = 2e-5
UPDATE_OF_LR = 1e-3

ORACLE = """
import dataclasses, sys, types
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro import configs
from repro.dist.sharding import shard_map_compat
from repro.models import model as JM
from repro.training import optimizer as JO
from repro.training import train_step as JT
sys.path.insert(0, INPUTS["tests"])
import torch_mesh_cases as C

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}

devs = np.array(jax.devices())
lax = types.SimpleNamespace(
    psum=jax.lax.psum, pmean=jax.lax.pmean,
    all_gather=lambda x, a, d: jax.lax.all_gather(x, a, axis=d, tiled=True),
    all_to_all=lambda x, a: jax.lax.all_to_all(x, a, 0, 0, tiled=True))
sm = lambda f, mesh, i, o: shard_map_compat(f, mesh=mesh, in_specs=i,
                                            out_specs=o)
shape, names = C.GRAD_MESH
mesh = Mesh(devs[:8].reshape(shape), names)
OUT["grads"] = {}
for name, _ in C.GRAD_CASES:
    f = C.grad_case(name, lax, sm, P, mesh)
    ct = jnp.asarray(INPUTS["cts"][name])

    def loss(x, w, f=f, ct=ct):
        y = f(x, w)
        y, aux = y if isinstance(y, tuple) else (y, None)
        l = (y * ct).sum()
        return l if aux is None else l + C.AUX_CT * aux
    x, w = (jnp.asarray(INPUTS["grads"][name][k]) for k in ("x", "w"))
    with mesh:
        y = jax.jit(f)(x, w)
        gx, gw = jax.jit(jax.grad(loss, argnums=(0, 1)))(x, w)
    y = y[0] if isinstance(y, tuple) else y
    OUT["grads"][name] = {"y": np.asarray(y), "gx": np.asarray(gx),
                          "gw": np.asarray(gw)}

batch = {k: jnp.asarray(v) for k, v in INPUTS["batch"].items()}
opt = JO.OptimizerConfig(**C.TRAIN_OPT)
tcfg = JT.TrainConfig(remat="full", aux_weight=C.EP_AUX_WEIGHT)
policy = JT.remat_policy_by_name("full")
OUT["params"], OUT["ep"] = {}, {}
for arch in C.MOE_ARCHS:
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              compute_dtype=jnp.float32,
                              param_dtype=jnp.float32)
    rules = configs.get(arch)[1]
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    OUT["params"][arch] = jax.tree.map(np.asarray, params)
    for world, (shape, names) in C.EP_MESHES.items():
        mesh = Mesh(devs[:world].reshape(shape), names)

        def loss(p):
            return JM.loss_fn(p, cfg, batch, mesh=mesh, rules=rules,
                              remat_policy=policy,
                              aux_weight=C.EP_AUX_WEIGHT)[0]
        step = JT.make_train_step(cfg, opt, mesh, rules, tcfg)
        with mesh:
            l, g = jax.jit(jax.value_and_grad(loss))(params)
            p1, s1, m = jax.jit(step)(params, JO.adamw_init(params, opt),
                                      batch)
        OUT["ep"][(world, arch)] = {
            "loss": float(l), "grads": flat(g), "step_loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]), "params": flat(p1),
            "m": flat(s1["m"])}
    OUT["lr"] = float(JO.lr_schedule(opt, jnp.asarray(1)))
"""

EP_CASES = [(w, a) for w in C.EP_MESHES for a in C.MOE_ARCHS]
EP_IDS = [f"{'x'.join(map(str, C.EP_MESHES[w][0]))}-{a.split('-')[0]}"
          for w, a in EP_CASES]


@pytest.fixture(scope="module")
def cts():
    rng = np.random.default_rng(12)
    out = {}
    for name, shape in C.GRAD_CASES:      # y has x's shape in each case
        out[name] = rng.normal(size=shape).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def oracle(cts):
    return C.jax_oracle(ORACLE, {
        "tests": C.os.path.dirname(C.os.path.abspath(C.__file__)),
        "grads": C.grad_inputs(), "cts": cts, "batch": C.ep_batch()})


@pytest.fixture(scope="module")
def grad_ranks(oracle, cts):
    shape, _ = C.GRAD_MESH
    return C.run_ranks("rank_collective_grads", int(np.prod(shape)),
                       C.grad_inputs(), cts)


@pytest.fixture(scope="module")
def ep_ranks(oracle):
    return {w: C.run_ranks("rank_ep_train", w, oracle["params"],
                           C.ep_batch()) for w in C.EP_MESHES}


def _close(got, want, rel, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, (what, err, scale)


@pytest.mark.parametrize("name", [n for n, _ in C.GRAD_CASES])
def test_collective_output_matches_jax(name, oracle, grad_ranks):
    for r in grad_ranks:
        _close(r[name]["y"], oracle["grads"][name]["y"], REL, name)


@pytest.mark.parametrize("name", [n for n, _ in C.GRAD_CASES])
def test_collective_gradient_matches_jax_grad(name, oracle, grad_ranks):
    want = oracle["grads"][name]
    for r in grad_ranks:
        _close(r[name]["gx"], want["gx"], REL, (name, "x"))
        _close(r[name]["gw"], want["gw"], REL, (name, "w"))


def test_collective_backwards_ran_their_transposes(grad_ranks):
    """The backwards issued ``psum_scatter`` (the all-gathers'
    transposes) besides the forward kinds."""
    for r in grad_ranks:
        assert set(r["counts"]) == {"all_reduce", "all_gather",
                                    "all_to_all", "reduce_scatter"}


@pytest.mark.parametrize("world,arch", EP_CASES, ids=EP_IDS)
def test_ep_loss_matches_repro(world, arch, oracle, ep_ranks):
    want = oracle["ep"][(world, arch)]
    for r in ep_ranks[world]:
        got = r[arch]
        for k in ("loss", "step_loss", "grad_norm"):
            assert abs(got[k] - want[k]) <= STEP_LOSS_REL * abs(want[k]), \
                (k, got[k], want[k])


@pytest.mark.parametrize("world,arch", EP_CASES, ids=EP_IDS)
def test_ep_gradients_match_repro(world, arch, oracle, ep_ranks):
    want = oracle["ep"][(world, arch)]["grads"]
    for r in ep_ranks[world]:
        got = r[arch]["grads"]
        assert sorted(got) == sorted(want)
        for path, w in want.items():
            _close(got[path], w, GRAD_OF_MAX, path)


@pytest.mark.parametrize("world,arch", EP_CASES, ids=EP_IDS)
def test_ep_updates_within_bound(world, arch, oracle, ep_ranks):
    want = oracle["ep"][(world, arch)]
    before = C._flat_np(oracle["params"][arch])
    lr = oracle["lr"]
    got = ep_ranks[world][0][arch]["params"]
    assert sorted(got) == sorted(want["params"])
    for path, w1 in want["params"].items():
        w0 = before[path]
        g = np.abs(want["m"][path]) / 0.1          # repro's clipped gradient
        bound = lr * (UPDATE_OF_LR + GRAD_REL * g.max() / (g + 1e-8))
        d = np.abs((got[path] - w0) - (w1 - w0))
        assert (d <= bound).all(), (path, float(d.max()))


@pytest.mark.parametrize("world,arch", EP_CASES, ids=EP_IDS)
def test_ep_step_is_the_same_on_every_rank(world, arch, ep_ranks):
    first = ep_ranks[world][0][arch]
    for r in ep_ranks[world][1:]:
        assert r[arch]["loss"] == first["loss"]
        for path, x in r[arch]["params"].items():
            np.testing.assert_array_equal(x, first["params"][path],
                                          err_msg=path)


@pytest.mark.parametrize("world", list(C.EP_MESHES))
def test_ep_step_dispatches_through_the_all_to_alls(world, ep_ranks):
    """Forward and backward: two all-to-alls a MoE layer each way."""
    for r in ep_ranks[world]:
        for arch in C.MOE_ARCHS:
            assert r[arch]["counts"].get("all_to_all", 0) >= 4, \
                r[arch]["counts"]
