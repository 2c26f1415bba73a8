"""The port's latency-feedback admission in the scheduler engine against
``repro``'s: fed the same windowed step and TTFT samples on the same
clock, both engines' ``_ctrl_tick`` make the same decisions, set the same
scheduler limits and the same gauges, and emit the same decision events.
A controller-configured port engine serves requests with ``repro``'s
tokens while its sensors fill."""

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
from repro.obs import TRACER as JTR
from repro.serving import engine as JE
from repro.serving import scheduler as JS
from repro_torch import configs as TC
from repro_torch.core import registry as TRG
from repro_torch.models import model as TM
from repro_torch.obs import TRACER as TTR
from repro_torch.serving import engine as TE
from repro_torch.serving import scheduler as TS

CC = dict(step_p99_target_ms=5.0, ttft_p99_target_ms=40.0, period_s=0.05,
          window_s=1.0, slices=8, min_samples=2, min_slots=1, decrease=0.5,
          recover_after=2, cooldown=2, probe_after=6, watermark_step=0.05,
          watermark_max=0.5)
SC = dict(max_slots=8, page_size=4, max_seq=32, prefill_chunk=8,
          prefill_rows=2, token_budget=16, admit_free_frac=0.1)


@pytest.fixture(scope="module")
def models():
    cj = dataclasses.replace(JC.get_smoke("llama3.2-1b"),
                             compute_dtype=jnp.float32)
    ct = dataclasses.replace(TC.get_smoke("llama3.2-1b"),
                             compute_dtype=torch.float32)
    jp = JM.init_params(jax.random.PRNGKey(0), cj)
    tp = TM.from_jax_params(jax.tree.map(np.asarray, jp), ct, device="cpu")
    return cj, ct, jp, tp


def _engines(models, monkeypatch, **sc):
    cj, ct, jp, tp = models
    monkeypatch.setattr(JRG, "next_lock_id", itertools.count(700).__next__)
    monkeypatch.setattr(TRG, "next_lock_id", itertools.count(700).__next__)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    kw = dict(SC, **sc)
    jeng = JE.ServingEngine(cj, jp, mesh=mesh, rules=MeshRules(), n_pages=64,
                            scheduler=JS.SchedulerConfig(
                                controller=JS.ControllerConfig(**CC), **kw))
    teng = TE.ServingEngine(ct, tp, n_pages=64, device="cpu",
                            scheduler=TS.SchedulerConfig(
                                controller=TS.ControllerConfig(**CC), **kw))
    return jeng, teng


def _state(eng):
    st = eng.scheduler.stats()
    return (st["slot_cap"], st["admit_free_frac"],
            eng.metrics.gauge("sched.slot_cap").value,
            eng.metrics.gauge("sched.admit_free_frac").value)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controllers_make_the_same_decisions(models, monkeypatch, seed):
    jeng, teng = _engines(models, monkeypatch)
    assert _state(teng) == _state(jeng) == (8, 0.1, 8, 0.1)
    clock = [10 ** 12]
    monkeypatch.setattr(time, "monotonic_ns", lambda: clock[0])
    rng = np.random.default_rng(seed)
    # a burst past the knee, a quiet stretch, a second burst, quiet again
    load = np.concatenate([np.full(12, 4.0), np.full(30, 0.5),
                           np.full(10, 3.0), np.full(30, 0.4)])
    states, events = [], []
    for tr in (JTR, TTR):
        tr.clear()
        tr.enable()
    try:
        for k, scale in enumerate(load):
            steps = rng.lognormal(np.log(2e6 * scale), 0.3, 4)
            ttfts = rng.lognormal(np.log(12e6 * scale), 0.4, 2)
            for eng in (jeng, teng):
                for v in steps:
                    eng._w_step.observe(float(v))
                for v in ttfts:
                    eng._w_ttft.observe(float(v))
                eng._ctrl_tick()
            states.append((_state(jeng), _state(teng)))
            clock[0] += int(0.05e9)
        for tr in (JTR, TTR):
            events.append([(e.name, e.args) for e in tr.snapshot()
                           if e.cat == "sched"])
    finally:
        JTR.disable()
        TTR.disable()
    assert all(j == t for j, t in states), states
    assert events[0] == events[1]
    kinds = [n for n, _ in events[1]]
    assert "ctrl_shrink" in kinds and "ctrl_grow" in kinds
    assert kinds.count("ctrl_state") == len(load)
    assert teng._controller.shrinks == jeng._controller.shrinks >= 2


def test_controller_engine_serves_repro_tokens(models, monkeypatch):
    """Requests one at a time through both controller engines: the same
    tokens, the step and TTFT windows filled, the gauges set."""
    jeng, teng = _engines(models, monkeypatch)
    prompts = [np.arange(1, 7, dtype=np.int32) + 3 * i for i in range(3)]
    outs = []
    for eng, mod in ((jeng, JE), (teng, TE)):
        eng.start()
        got = []
        for i, p in enumerate(prompts):
            r = mod.Request(rid=i, prompt=p, max_new=6)
            eng.submit(r)
            assert r.done.wait(timeout=600)
            got.append(list(map(int, r.out)))
        eng.stop()
        outs.append(got)
    assert outs[1] == outs[0]
    assert teng._w_ttft.count() == 3
    assert teng._w_step.count() > 0
    assert teng.metrics.gauge("sched.slot_cap").value >= 1
