"""The meshed serving engine and train step: the port on a gloo world of 8
ranks against ``repro`` on 8 fake devices, at the llama3.2-1b smoke config
in float32 with ``repro``'s parameters (PRNGKey 0).

* The scheduler twin's ``mesh2d`` section at ``(2, 2, 2)`` ("pod",
  "data", "model"): the data axes (4) divide ``max_slots``, so the paged
  steps run each rank's rows; the tokens hold to the dense decode loop
  (the twin's own gate) and equal ``repro``'s meshed engine's on the same
  trace, with identity weight swaps running.
* The meshed scheduler engine on a queueing trace with a shared prefix:
  every rank's tokens equal ``repro``'s meshed engine's, and every page is
  free after ``stop()``.
* ``make_train_step`` on the ``(4, 2)`` ("data", "model") mesh, batch 8 x
  32 in 2 microbatches, with no mask and with a mask that leaves one
  rank's rows unlabelled (tests/test_sharding.py's mini dry-run, run on
  values; ``lr=1e-3`` with no warm-up, as tests/test_torch_train_b.py
  runs it): the loss and gradient norm within 1e-5 relative of
  ``repro``'s jitted, sharded step, each parameter's update within R14's
  bound (``lr * (1e-3 + 2e-5 max|g| / (|g| + eps))``, that file's) and
  every rank's new parameters bit for bit the same.
"""

import numpy as np
import pytest

import torch_mesh_cases as C

STEP_LOSS_REL = 1e-5
GRAD_REL = 2e-5
UPDATE_OF_LR = 1e-3
WORLD = 8

ORACLE = """
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import configs
from repro.dist.sharding import MeshRules, param_specs
from repro.models import model as JM
from repro.serving import engine as JE
from repro.serving import scheduler as JS
from repro.training import optimizer as JO
from repro.training import train_step as JT

def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}

cfg = dataclasses.replace(configs.get_smoke("llama3.2-1b"),
                          compute_dtype=jnp.float32)
params = JM.init_params(jax.random.PRNGKey(0), cfg)
OUT["params"] = jax.tree.map(np.asarray, params)
devs = np.array(jax.devices())
mesh = Mesh(devs[:8].reshape(2, 2, 2), ("pod", "data", "model"))

def serve(prompts, **start_kw):
    eng = JE.ServingEngine(cfg, params, mesh=mesh, rules=MeshRules(),
                           n_pages=128,
                           scheduler=JS.SchedulerConfig(**INPUTS["sched"]))
    reqs = [JE.Request(rid=i, prompt=p, max_new=INPUTS["tokens"])
            for i, p in enumerate(prompts)]
    eng.start(**start_kw)
    for r in reqs:
        eng.submit(r)
    for r in reqs:
        assert r.done.wait(timeout=600)
    eng.stop()
    return [list(map(int, r.out)) for r in reqs]

OUT["mesh2d"] = serve(INPUTS["mesh2d"], swap_period_s=0.1,
                      perturb=lambda p: p)
OUT["trace"] = serve(INPUTS["trace"])

shape, names = INPUTS["train_mesh"]
tmesh = Mesh(devs[:8].reshape(shape), names)
rules = MeshRules()
pshape = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), cfg))
pspecs = param_specs(pshape, rules, tmesh)
tn = lambda t: jax.tree.map(lambda s: NamedSharding(tmesh, s), t,
                            is_leaf=lambda x: isinstance(x, P))
opt = JO.OptimizerConfig(**INPUTS["opt"])
ospec = {"m": pspecs, "v": pspecs, "step": P()}
step = JT.make_train_step(cfg, opt, tmesh, rules,
                          JT.TrainConfig(remat="full",
                                         microbatches=INPUTS["micro"]))
OUT["train"] = {"before": flat(params),
                "lr": float(JO.lr_schedule(opt, jnp.asarray(1)))}
for kind, b in INPUTS["batches"].items():
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    bshard = {k: NamedSharding(tmesh, P(("data",), None)) for k in batch}
    j = jax.jit(step, in_shardings=(tn(pspecs), tn(ospec), bshard),
                out_shardings=(tn(pspecs), tn(ospec), None))
    with tmesh:
        p1, s1, m = j(params, JO.adamw_init(params, opt), batch)
    OUT["train"][kind] = {"loss": float(m["loss"]),
                          "grad_norm": float(m["grad_norm"]),
                          "params": flat(p1), "m": flat(s1["m"])}
"""


@pytest.fixture(scope="module")
def oracle():
    return C.jax_oracle(ORACLE, {
        "sched": C.ENGINE_SCHED, "tokens": C.ENGINE_TOKENS,
        "mesh2d": [np.arange(1, 7, dtype=np.int32) + i for i in range(4)],
        "trace": C.engine_trace(), "train_mesh": C.TRAIN_MESH,
        "batches": C.train_batches(), "micro": C.TRAIN_MICRO,
        "opt": C.TRAIN_OPT})


@pytest.fixture(scope="module")
def ranks(oracle):
    return C.run_ranks("rank_engine", WORLD, oracle["params"])


def test_mesh2d_section_passes_on_the_2x2x2_mesh(ranks):
    for r in ranks:
        rec = r["mesh2d"]
        assert r["failures"] == []
        assert rec["mesh"] == {"pod": 2, "data": 2, "model": 2}
        assert rec["ranks"] == WORLD
        assert rec["batch_sharded"] and rec["match"]


def test_mesh2d_tokens_equal_repros_meshed_engine(oracle, ranks):
    for r in ranks:
        assert r["mesh2d"]["tokens"] == oracle["mesh2d"]


def test_meshed_engine_trace_equals_repros(oracle, ranks):
    for r in ranks:
        assert r["trace"] == oracle["trace"]
        assert r["free_after"] == 128


@pytest.mark.parametrize("kind", ["plain", "masked"])
def test_meshed_train_step_loss_matches_repro(kind, oracle, ranks):
    want = oracle["train"][kind]
    for r in ranks:
        got = r["train"][kind]
        assert abs(got["loss"] - want["loss"]) <= \
            STEP_LOSS_REL * abs(want["loss"])
        assert abs(got["grad_norm"] - want["grad_norm"]) <= \
            STEP_LOSS_REL * want["grad_norm"]


@pytest.mark.parametrize("kind", ["plain", "masked"])
def test_meshed_train_step_updates_within_bound(kind, oracle, ranks):
    want = oracle["train"][kind]
    lr = oracle["train"]["lr"]
    got = ranks[0]["train"][kind]["params"]
    assert sorted(got) == sorted(want["params"])
    for path, w1 in want["params"].items():
        w0 = oracle["train"]["before"][path]
        g = np.abs(want["m"][path]) / 0.1          # repro's clipped gradient
        bound = lr * (UPDATE_OF_LR + GRAD_REL * g.max() / (g + 1e-8))
        d = np.abs((got[path] - w0) - (w1 - w0))
        assert (d <= bound).all(), (path, float(d.max()))


@pytest.mark.parametrize("kind", ["plain", "masked"])
def test_meshed_train_step_is_the_same_on_every_rank(kind, ranks):
    first = ranks[0]["train"][kind]["params"]
    for r in ranks[1:]:
        for path, x in r["train"][kind]["params"].items():
            np.testing.assert_array_equal(x, first[path], err_msg=path)

