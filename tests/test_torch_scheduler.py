"""The port's ServingEngine in scheduler mode (continuous batching over the
paged pool, on the CPU through the kernels' plain versions) against
``repro``'s, on the smoke config with the same float32 parameters: the same
request traces give identical tokens, and the engines agree on what the
prefix cache, the eviction and the admission did.  After ``stop()`` every
page is free, no refcount is left and no lease is held."""

import dataclasses
import itertools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as JC
from repro.core import registry as JRG
from repro.dist.sharding import MeshRules
from repro.models import model as JM
from repro.serving import engine as JE
from repro.serving import scheduler as JS
from repro_torch import configs as TC
from repro_torch.core import registry as TRG
from repro_torch.models import model as TM
from repro_torch.serving import engine as TE
from repro_torch.serving import scheduler as TS


@pytest.fixture(scope="module")
def models():
    cj = dataclasses.replace(JC.get_smoke("llama3.2-1b"),
                             compute_dtype=jnp.float32)
    ct = dataclasses.replace(TC.get_smoke("llama3.2-1b"),
                             compute_dtype=torch.float32)
    jp = JM.init_params(jax.random.PRNGKey(0), cj)
    tp = TM.from_jax_params(jax.tree.map(np.asarray, jp), ct, device="cpu")
    return cj, ct, jp, tp


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _engines(models, sc, n_pages, monkeypatch):
    cj, ct, jp, tp = models
    monkeypatch.setattr(JRG, "next_lock_id", itertools.count(900).__next__)
    monkeypatch.setattr(TRG, "next_lock_id", itertools.count(900).__next__)
    jeng = JE.ServingEngine(cj, jp, mesh=_mesh(), rules=MeshRules(),
                            n_pages=n_pages,
                            scheduler=JS.SchedulerConfig(**sc))
    teng = TE.ServingEngine(ct, tp, n_pages=n_pages,
                            scheduler=TS.SchedulerConfig(**sc), device="cpu")
    return jeng, teng


def _serve(eng, mod, prompts, max_new, warm=0, **start_kw):
    """Serve ``prompts``: the first ``warm`` one by one (each finishes, so
    its prefix is in the cache), the rest together.  -> token lists."""
    reqs = [mod.Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    eng.start(**start_kw)
    if "swap_period_s" in start_kw:
        # the updater swaps once before the traffic and goes on swapping
        # during it: a short run could otherwise finish before any swap
        deadline = time.monotonic() + 60
        while eng.stats.weight_swaps < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
    for r in reqs[:warm]:
        eng.submit(r)
        assert r.done.wait(timeout=600), "request timed out"
    for r in reqs[warm:]:
        eng.submit(r)
    for r in reqs:
        assert r.done.wait(timeout=600), "request timed out"
    eng.stop()
    return [list(map(int, r.out)) for r in reqs]


def _drained(eng, n_pages):
    pool = eng.kv_pool
    assert pool.free_count() == n_pages
    st = pool.stats()
    assert st["refcount_total"] == 0 and st["shared_pages"] == 0
    held = eng.registry.held_multi([eng.store.leases] + pool.locks)
    assert not np.asarray(held).any(), held


SC = dict(max_slots=4, page_size=4, max_seq=32, prefill_chunk=8,
          prefill_rows=2, token_budget=16)
BASE = np.arange(1, 15, dtype=np.int32)
DIV = BASE.copy()
DIV[6] = 99


def _chunked(models, monkeypatch):
    sc = dict(SC, max_slots=2, prefill_chunk=4, prefill_rows=1,
              token_budget=4)
    jeng, teng = _engines(models, sc, 32, monkeypatch)
    prompts = [np.arange(1, 14, dtype=np.int32)]         # 13 > chunk of 4
    want = _serve(jeng, JE, prompts, 4)
    got = _serve(teng, TE, prompts, 4)
    assert teng.stats.prefills == jeng.stats.prefills >= 4
    return jeng, teng, want, got, 32


def _eviction(models, monkeypatch):
    sc = dict(SC, max_slots=3)
    jeng, teng = _engines(models, sc, 8, monkeypatch)
    prompts = [np.arange(1, 6, dtype=np.int32) + 3 * i for i in range(3)]
    # all submitted before the loop starts: both schedules are the same
    outs = []
    for eng, mod in ((jeng, JE), (teng, TE)):
        reqs = [mod.Request(rid=i, prompt=p, max_new=8)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.start()
        for r in reqs:
            assert r.done.wait(timeout=600), "request timed out"
        eng.stop()
        outs.append([list(map(int, r.out)) for r in reqs])
    assert teng.scheduler.evictions == jeng.scheduler.evictions >= 1
    return jeng, teng, outs[0], outs[1], 8


def _prefix_cow(models, monkeypatch):
    sc = dict(SC, max_slots=2, prefill_chunk=4, token_budget=8)
    jeng, teng = _engines(models, sc, 64, monkeypatch)
    prompts = [BASE, BASE, DIV]
    want = _serve(jeng, JE, prompts, 4, warm=1)
    got = _serve(teng, TE, prompts, 4, warm=1)
    ts, js = teng.lock_stats()["engine"], jeng.lock_stats()["engine"]
    for k in ("pages_saved", "cow_copies", "cached_tokens",
              "pages_charged"):
        assert ts[k] == js[k], k
    assert ts["pages_saved"] >= 4 and ts["cow_copies"] >= 1
    assert ts["cached_tokens"] >= 13 + 4
    assert teng.kv_pool.prefix_hits == jeng.kv_pool.prefix_hits >= 2
    return jeng, teng, want, got, 64


def _hot_swap(models, monkeypatch):
    jeng, teng = _engines(models, SC, 64, monkeypatch)
    prompts = [np.arange(1, 6, dtype=np.int32) + i for i in range(3)]
    want = _serve(jeng, JE, prompts, 4, swap_period_s=0.05,
                  perturb=lambda p: p)
    got = _serve(teng, TE, prompts, 4, swap_period_s=0.05,
                 perturb=lambda p: p)
    assert teng.stats.weight_swaps >= 1
    # a model-epoch revocation clears only the model lock's bias lane
    for eng in (jeng, teng):
        reg = eng.registry
        armed = [bool(reg._armed[h.idx]) for h in eng.kv_pool.locks]
        for _ in range(3):
            eng.store.swap(eng.store.params)
        assert [bool(reg._armed[h.idx]) for h in eng.kv_pool.locks] == armed
        assert not reg._armed[eng.store.leases.idx]
    return jeng, teng, want, got, 64


def _partial_admission(models, monkeypatch):
    """A stale free-page estimate admits three slots into a pool with room
    for one: the later two are un-admitted in order, then served."""
    jeng, teng = _engines(models, SC, 2, monkeypatch)
    outs = []
    for eng, mod in ((jeng, JS), (teng, TS)):
        eng._free_est = 16
        slots = [mod.SlotState(rid=i, prefix=np.arange(1, 6, dtype=np.int32),
                               max_new=2) for i in range(3)]
        for st in slots:
            eng.scheduler.submit(st)
        eng._admit()
        assert list(eng.scheduler.running.values()) == [slots[0]]
        assert slots[0].pages == [0, 1]
        assert [s.rid for s in eng.scheduler.waiting] == [1, 2]
        assert all(s.phase is mod.Phase.WAITING and s.row == -1
                   and not s.pages for s in slots[1:])
        eng.start()
        for _ in range(6000):
            if eng.scheduler.finished == 3:
                break
            eng._stop.wait(0.01)
        eng.stop()
        assert eng.scheduler.finished == 3
        outs.append([list(map(int, s.out)) for s in slots])
    return jeng, teng, outs[0], outs[1], 2


SCENARIOS = {"chunked_prefill": _chunked, "eviction": _eviction,
             "prefix_cow": _prefix_cow, "hot_swap": _hot_swap,
             "partial_admission": _partial_admission}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scheduler_engine_matches_jax_engine(models, monkeypatch, name):
    jeng, teng, want, got, n_pages = SCENARIOS[name](models, monkeypatch)
    assert got == want, (got, want)
    assert all(len(o) > 0 for o in got)
    for eng in (jeng, teng):
        _drained(eng, n_pages)
    assert teng.scheduler.stats() == jeng.scheduler.stats()


def test_scheduler_mode_refuses_what_is_not_ported(models):
    """What scheduler mode once refused, the latency-feedback controller,
    now serves: the engine builds with one, its sensors fill as it serves,
    and ``_ctrl_tick`` runs at the top of each tick.  What it refuses
    still: a request past ``max_seq`` and prompt tokens outside the
    vocabulary."""
    _, ct, _, tp = models
    ceng = TE.ServingEngine(ct, tp, device="cpu", n_pages=32,
                            scheduler=TS.SchedulerConfig(
                                page_size=4, max_seq=32,
                                controller=TS.ControllerConfig(
                                    ttft_p99_target_ms=1e6)))
    ticks = []
    tick = ceng._ctrl_tick
    ceng._ctrl_tick = lambda: (ticks.append(1), tick())
    ceng.start()
    r = TE.Request(rid=0, prompt=np.arange(1, 9, dtype=np.int32), max_new=4)
    ceng.submit(r)
    assert r.done.wait(timeout=600)
    ceng.stop()
    assert len(r.out) == 4 and ticks
    assert ceng._w_ttft.count() == 1 and ceng._controller.shrinks == 0
    # the quantized page store is ported: four leaves, int8 pages
    qeng = TE.ServingEngine(ct, tp, device="cpu", n_pages=16,
                            scheduler=TS.SchedulerConfig(), quant_kv=True)
    assert set(qeng._pages_kv) == {"k", "v", "k_scale", "v_scale"}
    assert qeng._pages_kv["k"].dtype == qeng._pages_kv["v"].dtype \
        == torch.int8
    eng = TE.ServingEngine(ct, tp, device="cpu", n_pages=16,
                           scheduler=TS.SchedulerConfig(max_seq=16))
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(TE.Request(rid=0, prompt=np.arange(1, 12), max_new=8))
    with pytest.raises(ValueError, match="vocab|tokens"):
        eng.submit(TE.Request(rid=1, prompt=np.asarray([1, ct.vocab]),
                              max_new=2))


def test_chip_smoke_scheduler_vs_greedy_gates(models):
    """``chip_smoke.scheduler_vs_greedy`` takes its share from the run
    without swaps, whose weights are the greedy loop's, and holds the run
    under swaps teacher-forced: it refuses a share read from a swapped
    run, and a swapped run's token that is far from the loop's best."""
    import importlib.util
    import pathlib

    from repro_torch.benchmarks import smoke as SM

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    _, ct, _, tp = models
    cpu = torch.device("cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, ct.vocab, n).astype(np.int32).tolist()
               for n in (9, 17)]
    outs = [SM.dense_reference(ct, tp, p, 4, cpu, max_seq=32)
            for p in prompts]
    still = {"weight_swaps": 0, "prompts": prompts, "outputs": outs}
    swapped = {**still, "weight_swaps": 3}
    got = cs.scheduler_vs_greedy(ct, tp, cpu, still, swapped)
    assert got["equal_share"] == 1.0
    assert got["under_swaps"]["teacher_forced"]["exact"]
    with pytest.raises(AssertionError, match="without swaps"):
        cs.scheduler_vs_greedy(ct, tp, cpu, swapped, swapped)
    # a token the loop ranks far below its best, at the swapped run's
    # second step: its share drops, and the teacher-forced gate refuses it
    logits = []
    SM.dense_reference(ct, tp, prompts[0], 4, cpu, max_seq=32,
                       logits=logits)
    worst = int(np.argmin(logits[1]))
    bad = {**swapped, "outputs": [outs[0][:1] + [worst] + outs[0][2:],
                                  outs[1]]}
    with pytest.raises(AssertionError, match="under swaps"):
        cs.scheduler_vs_greedy(ct, tp, cpu, still, bad)
