"""Shared machinery of tests/test_torch_mesh_handler.py and
tests/test_torch_mesh_controller.py: the meshed engine's handler mode and
latency controller on gloo worlds of 4 ranks (``torch_mesh_cases.run_ranks``)
against ``repro``'s engine on 4 of 8 fake XLA devices
(``torch_mesh_cases.jax_oracle``).

Both sides serve the same float32 smoke parameters: the port's
``init_params`` from a seed, handed to ``repro`` as numpy arrays, so the
oracle and the ranks run at the same time (:func:`in_parallel`).  Rank
functions import neither JAX nor ``repro``.
"""

import threading
import time

import numpy as np

import torch_mesh_cases as C

WORLD = 4
# handler mode: the families that serve only in handler mode and a dense
# config, each under its own config's rules (llama4's: seqshard attention)
HANDLER_ARCHS = ("phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b",
                 "rwkv6-7b", "zamba2-2.7b", "llama3.2-1b")
HANDLER_MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
SLOTS = 4
# two batches of SLOTS rows: the data axis (2 or 1) divides each, and so
# do the ranks over which the prefill's B * S token rows split (S = 8)
LENS = (8, 5, 7, 6, 4, 8, 3, 6)
MAX_NEW = 4
MAX_SEQ = 16
SWAP_ARCHS = ("phi3.5-moe-42b-a6.6b", "rwkv6-7b")   # perturbing swaps
SWAPS = 2
R17_ARCH, R17_ROWS = "phi3.5-moe-42b-a6.6b", 3
# the controller: llama3.2-1b's meshed scheduler engine at (2, 2)
CTRL_ARCH = "llama3.2-1b"
CTRL_SCHED = dict(max_slots=4, page_size=8, max_seq=64, prefill_chunk=8,
                  prefill_rows=2, token_budget=16)
# targets every step and first token crosses: the controller shrinks as
# soon as its windows hold min_samples readings
CTRL = dict(step_p99_target_ms=1e-6, ttft_p99_target_ms=1e-6,
            period_s=0.005, window_s=5.0, min_samples=3, cooldown=1)
CTRL_TOKENS = 6
CTRL_REQUESTS = 12


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def params_np(arch, seed=0):
    """The port's float32 smoke parameters of ``arch`` as numpy arrays."""
    from repro_torch.models import model as TM
    return _numpy(TM.init_params(seed, C.smoke_f32(arch), device="cpu"))


def prompts(vocab, lens=LENS, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, n).astype(np.int32) for n in lens]


def ctrl_prompts(vocab=512, seed=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, int(n)).astype(np.int32)
            for n in rng.integers(3, 20, CTRL_REQUESTS)]


def in_parallel(*calls):
    """Run each ``(fn, args)`` in a thread of its own; -> their results in
    order (the first error raised)."""
    out, errs = [None] * len(calls), []

    def run(i, fn, args):
        try:
            out[i] = fn(*args)
        except BaseException as e:       # re-raised in the caller
            errs.append(e)
    ts = [threading.Thread(target=run, args=(i, fn, args))
          for i, (fn, args) in enumerate(calls)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]
    return out


# ---------------------------------------------------------------------------
# repro's side
# ---------------------------------------------------------------------------

ORACLE_PRELUDE = """
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro import configs
from repro.serving import engine as JE

def jcfg(arch):
    return dataclasses.replace(configs.get_smoke(arch),
                               param_dtype=jnp.float32,
                               compute_dtype=jnp.float32)

def jparams(arch):
    return jax.tree.map(jnp.asarray, INPUTS["params"][arch])

def jmesh(shape):
    return Mesh(np.array(jax.devices()[:4]).reshape(shape),
                ("data", "model"))
"""

HANDLER_ORACLE = ORACLE_PRELUDE + """
def serve(arch, shape, lens):
    cfg, mesh = jcfg(arch), jmesh(shape)
    eng = JE.ServingEngine(cfg, jparams(arch), mesh=mesh,
                           rules=configs.get(arch)[1], handlers=1,
                           max_seq=INPUTS["max_seq"],
                           slots_per_handler=INPUTS["slots"])
    reqs = [JE.Request(rid=i, prompt=p, max_new=INPUTS["max_new"])
            for i, p in enumerate(INPUTS["prompts"][arch][:lens])]
    for r in reqs:
        eng.submit(r)
    with mesh:
        eng.start()
        return eng, reqs

for arch in INPUTS["archs"]:
    for name, shape in INPUTS["meshes"].items():
        eng, reqs = serve(arch, shape, None)
        for r in reqs:
            assert r.done.wait(timeout=600)
        eng.stop()
        OUT[(arch, name)] = [list(map(int, r.out)) for r in reqs]

eng, reqs = serve(INPUTS["r17"], (2, 2), INPUTS["r17_rows"])
deadline = time.monotonic() + 120
err = None
while err is None and time.monotonic() < deadline:
    try:
        eng.check_health()
        time.sleep(0.05)
    except JE.EngineFailure as e:
        err = e
try:
    eng.stop()
except JE.EngineFailure as e:
    err = e
OUT["r17"] = None if err is None else [
    (type(x).__name__, str(x)) for _, x, _ in err.failures]
OUT["r17_done"] = [r.done.is_set() for r in reqs]
"""

CTRL_ORACLE = ORACLE_PRELUDE + """
from repro.dist.sharding import MeshRules
from repro.serving import scheduler as JS

cfg = jcfg(INPUTS["arch"])
mesh = jmesh((2, 2))
sc = JS.SchedulerConfig(**INPUTS["sched"],
                        controller=JS.ControllerConfig(**INPUTS["ctrl"]))
eng = JE.ServingEngine(cfg, jparams(INPUTS["arch"]), mesh=mesh,
                       rules=MeshRules(), n_pages=128, scheduler=sc)
reqs = [JE.Request(rid=i, prompt=p, max_new=INPUTS["tokens"])
        for i, p in enumerate(INPUTS["prompts"])]
with mesh:
    eng.start()
    for r in reqs:
        eng.submit(r)
    for r in reqs:
        assert r.done.wait(timeout=600)
    eng.stop()
OUT["tokens"] = [list(map(int, r.out)) for r in reqs]
"""


def handler_oracle(params):
    return C.jax_oracle("import time\n" + HANDLER_ORACLE, {
        "params": params, "archs": HANDLER_ARCHS, "meshes": HANDLER_MESHES,
        "prompts": {a: prompts(C.smoke_f32(a).vocab) for a in HANDLER_ARCHS},
        "max_seq": MAX_SEQ, "slots": SLOTS, "max_new": MAX_NEW,
        "r17": R17_ARCH, "r17_rows": R17_ROWS})


def ctrl_oracle(params):
    return C.jax_oracle(CTRL_ORACLE, {
        "params": {CTRL_ARCH: params}, "arch": CTRL_ARCH,
        "sched": CTRL_SCHED, "ctrl": CTRL, "tokens": CTRL_TOKENS,
        "prompts": ctrl_prompts()})


# ---------------------------------------------------------------------------
# The port's side: rank functions
# ---------------------------------------------------------------------------


def _engine(arch, params, shape, **kw):
    from repro_torch import configs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as TM
    from repro_torch.serving.engine import ServingEngine

    cfg = C.smoke_f32(arch)
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    return ServingEngine(cfg, TM.from_jax_params(params, cfg, device="cpu"),
                         mesh=mesh, rules=configs.get(arch)[1],
                         max_seq=MAX_SEQ, slots_per_handler=SLOTS,
                         device="cpu", **kw)


def _requests(arch, n=None):
    from repro_torch.serving.engine import Request
    ps = prompts(C.smoke_f32(arch).vocab)[:n]
    return [Request(rid=i, prompt=p, max_new=MAX_NEW)
            for i, p in enumerate(ps)]


def _serve(eng, reqs, **start_kw):
    for r in reqs:
        eng.submit(r)
    eng.start(**start_kw)
    for r in reqs:
        assert r.done.wait(timeout=120), f"request {r.rid} timed out"
    eng.stop()
    return [list(map(int, r.out)) for r in reqs]


def rank_handler(rank, world, shape, params):
    """Handler mode on this world's ``shape``: every arch's requests
    served by 1 and 2 handler threads, then by 2 with identity swaps; the
    R17 batch; then, with the graphs on the CPU stand-in, perturbing
    swaps on each rank's own period.  -> the tokens, the R17 failures,
    the swaps' turns and the steps' stats."""
    from repro_torch.serving.engine import EngineFailure

    out = {"tokens": {}, "identity": {}, "swaps": {}}
    for arch in HANDLER_ARCHS:
        for n in (1, 2):
            eng = _engine(arch, params[arch], shape, handlers=n)
            out["tokens"][(arch, n)] = _serve(eng, _requests(arch))
        eng = _engine(arch, params[arch], shape, handlers=2)
        out["identity"][arch] = {
            "tokens": _serve(eng, _requests(arch),
                             swap_period_s=0.01 + 0.005 * rank,
                             perturb=lambda p: p),
            "landed": eng.swap_at, "swaps": eng.stats.weight_swaps}
    if tuple(shape) == (2, 2):
        eng = _engine(R17_ARCH, params[R17_ARCH], shape, handlers=1)
        reqs = _requests(R17_ARCH, R17_ROWS)
        for r in reqs:
            eng.submit(r)
        eng.start()
        deadline = time.monotonic() + 60
        while not eng._failures and time.monotonic() < deadline:
            time.sleep(0.02)
        try:
            eng.stop()
            out["r17"] = None
        except EngineFailure as e:
            out["r17"] = [(type(x).__name__, str(x))
                          for _, x, _ in e.failures]
        out["r17_done"] = [r.done.is_set() for r in reqs]
    C.fake_graphs()
    for arch in SWAP_ARCHS:
        out["swaps"][arch] = _perturbing_swaps(arch, params[arch], shape,
                                               rank)
    return out


def _perturbing_swaps(arch, params, shape, rank):
    """Two waves of the requests on two handler threads: under the first,
    this rank's own thread stages ``SWAPS`` perturbing swaps at its own
    random moments; the second, once they have landed, runs on the
    settled tree (so its steps capture and replay)."""
    from repro_torch.serving.engine import _perturb

    eng = _engine(arch, params, shape, handlers=2)
    rng = np.random.default_rng(rank)
    first = _requests(arch)
    for r in first:
        eng.submit(r)
    eng.start()
    for _ in range(SWAPS):
        time.sleep(float(rng.uniform(0.005, 0.03)))
        assert eng.hot_swap(_perturb(eng.store.params))
    second = _requests(arch)
    for r in second:
        r.rid += len(first)
        eng.submit(r)
    for r in first + second:
        assert r.done.wait(timeout=120), f"request {r.rid} timed out"
    eng.stop()
    return {"tokens": [list(map(int, r.out)) for r in first + second],
            "landed": eng.swap_at, "swaps": eng.stats.weight_swaps,
            "graphs": eng.handler_step_stats()}


def rank_controller(rank, world, params):
    """llama3.2-1b's meshed scheduler engine at (2, 2) with the latency
    controller, its steps on the graph stand-in: half the requests queued
    before ``start()``, the rest submitted after, each rank at its own
    pace.  -> the tokens, the decision log, the requests finished."""
    from repro_torch.dist.sharding import MeshRules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as TM
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.scheduler import (ControllerConfig,
                                               SchedulerConfig)

    C.fake_graphs()
    cfg = C.smoke_f32(CTRL_ARCH)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    sc = SchedulerConfig(**CTRL_SCHED, controller=ControllerConfig(**CTRL))
    eng = ServingEngine(cfg, TM.from_jax_params(params, cfg, device="cpu"),
                        n_pages=128, device="cpu", mesh=mesh,
                        rules=MeshRules(), scheduler=sc)
    reqs = [Request(rid=i, prompt=p, max_new=CTRL_TOKENS)
            for i, p in enumerate(ctrl_prompts())]
    half = len(reqs) // 2
    for r in reqs[:half]:
        eng.submit(r)
    eng.start()
    rng = np.random.default_rng(rank)
    for r in reqs[half:]:
        time.sleep(float(rng.uniform(0.0, 0.03)))
        eng.submit(r)
    done = [r.done.wait(timeout=120) for r in reqs]
    eng.stop()
    return {"tokens": [list(map(int, r.out)) for r in reqs],
            "done": done, "log": list(eng.ctrl_log),
            "slot_cap": eng.scheduler.stats().get("slot_cap"),
            "free_after": eng.kv_pool.free_count()}


def run_handler_worlds(params):
    """The oracle and one gloo world of each mesh shape, all at once."""
    calls = [(handler_oracle, (params,))] + [
        (C.run_ranks, ("torch_mesh_handler_cases:rank_handler", WORLD,
                       shape, params)) for shape in HANDLER_MESHES.values()]
    oracle, *worlds = in_parallel(*calls)
    return oracle, dict(zip(HANDLER_MESHES, worlds))


def run_controller_world(params):
    return in_parallel(
        (ctrl_oracle, (params,)),
        (C.run_ranks, ("torch_mesh_handler_cases:rank_controller", WORLD,
                       params)))


def lock_id_counters():
    """The two packages' process-wide lock-id counters (see
    tests/test_torch_figures.py)."""
    from repro.core import table as RT
    from repro_torch.core import table as TT
    return RT, TT

