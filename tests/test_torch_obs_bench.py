"""The port's ``obs`` benchmark twin on the CPU at the smoke config, with
parameters converted from ``repro``'s: the emit site's cost gates, the
tracing-cost gate over repeated untraced/traced pairs, the hot-swap
timeline's Chrome export and lifecycles, and the traced registry pair's
denied counter hold; the untraced run's tokens equal ``repro``'s dense
decode loop.  The direct p50 delta's sanity band is wall-clock noise on a
loaded host, the card's to judge, and stays out of these tests."""

import itertools
import json

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.models import model as JM
from repro_torch import configs as TC
from repro_torch.benchmarks import obs as OBS
from repro_torch.benchmarks import smoke as SM
from repro_torch.core import table as TT
from repro_torch.core.registry import BravoRegistry
from repro_torch.kernels.ref import hashed_requests
from repro_torch.models import model as TM
from test_torch_scheduler_bench import repro_dense_tokens

CPU = torch.device("cpu")
WALL_CLOCK_GATES = ("traced p50 within the CPU-noise sanity band",)


@pytest.fixture(scope="module")
def models():
    cj = JC.get_smoke("llama3.2-1b")
    ct = TC.get_smoke("llama3.2-1b")
    jp = JM.init_params(jax.random.PRNGKey(0), cj)
    tp = TM.from_jax_params(jax.tree.map(np.asarray, jp), ct, device="cpu")
    return cj, ct, jp, tp


@pytest.fixture(autouse=True)
def _fresh_lock_ids(monkeypatch):
    """The traced registry pair's lock takes the next number of a
    process-wide counter, and its 16 readers' slots hash that number: start
    the counter at 1 so that the pair's slots do not depend on how many
    locks ran earlier in this process."""
    monkeypatch.setattr(TT, "_lock_ids", itertools.count(1))


def _deterministic(failures):
    return [f for f in failures if not f.startswith(WALL_CLOCK_GATES)]


@pytest.mark.parametrize("near_tie_rel", [None, 0.05])
def test_obs_twin_gates_hold(models, near_tie_rel):
    _, ct, _, tp = models
    rec = OBS.run(ct, tp, "cpu", smoke=True, windows=2,
                  near_tie_rel=near_tie_rel)
    assert _deterministic(rec["failures"]) == []
    ec = rec["emit_cost"]
    assert ec["disabled_site_ns"] < 250 and ec["enabled_emit_ns"] < 10_000
    so = rec["step_overhead"]
    assert so["windows"] == 2 and so["overhead_pct"] < 2.0
    for key in ("untraced_p50_us", "traced_p50_us", "events_per_step",
                "direct_p50_delta_pct"):
        assert len(so[key]["readings"]) == 2
        assert so[key]["min"] <= so[key]["median"] <= so[key]["max"]
    assert so["events_per_step"]["min"] > 0
    assert so["traced_equals_untraced"] and so["tokens_exact"]
    ch = rec["chrome_hotswap"]
    assert ch["dropped"] == 0 and ch["swap_landed"] and ch["tokens"]["ok"]
    assert ch["validate_errors"] == [] and ch["json_round_trip"]
    assert ch["complete_lifecycles"] == ch["requests"] == 3
    assert {"req", "lock", "engine"} <= set(ch["categories"])
    zs = rec["zero_sync"]
    assert zs["traced_sync_gate"] == "inactive"
    assert zs["denied_publishes"] == 0 and zs["publishes"] >= 1


def test_untraced_tokens_equal_repros_dense_loop(models):
    cj, ct, jp, tp = models
    SM.FAILURES.clear()
    rec = OBS.bench_step_overhead(ct, tp, CPU, 4, 3, emit_ns=1000.0)
    assert _deterministic(SM.FAILURES) == []
    SM.FAILURES.clear()
    assert rec["base_tokens"] == [repro_dense_tokens(cj, jp, p, 4)
                                  for p in OBS._prompts(3)]


def test_zero_sync_leaves_the_global_tracer_off():
    SM.FAILURES.clear()
    rec = OBS.bench_zero_sync(CPU)
    assert SM.FAILURES == [] and rec["publishes"] == 1
    assert not OBS.TRACER.enabled


@pytest.mark.parametrize("lock_id", [1, 39])
def test_zero_sync_denies_exactly_the_slot_collisions(monkeypatch, lock_id):
    """A denied publish is BRAVO's collision path: two readers whose ids
    hash to one slot under the lock's number, the second taking the slow
    path.  Lock number 39 is the first under which two of the pair's 16
    reader ids share a slot; number 1 gives 16 distinct slots."""
    monkeypatch.setattr(TT, "_lock_ids", itertools.count(lock_id))
    SM.FAILURES.clear()
    rec = OBS.bench_zero_sync(CPU)
    reg = BravoRegistry(device=CPU)
    monkeypatch.setattr(TT, "_lock_ids", itertools.count(lock_id))
    h = reg.alloc("collisions")
    _, _, slots = hashed_requests(reg.table, reg.lock_vals,
                                  torch.tensor(h.idx),
                                  torch.arange(16, dtype=torch.int32))
    collisions = 16 - len(set(slots.flatten().tolist()))
    assert collisions == (lock_id == 39)
    assert rec["denied_publishes"] == collisions and rec["publishes"] == 1
    SM.FAILURES.clear()


def test_cli_smoke_on_the_cpu(tmp_path):
    out = tmp_path / "obs.json"
    rc = OBS.main(["--smoke", "--device", "cpu", "--windows", "2",
                   "--out", str(out)])
    rec = json.loads(out.read_text())
    assert _deterministic(rec["failures"]) == []
    assert rc == (1 if rec["failures"] else 0)
    assert rec["device"] == "cpu" and rec["mode"] == "smoke"
