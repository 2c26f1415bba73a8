"""The port's ``hotswap`` and ``slo`` benchmark twins on the CPU at the
smoke config and the smoke trace: their deterministic gates hold (zero
dropped requests, tokens equal to the dense reference, the staged swap
lands and the corrupt copy is rejected with its leaf's index, the wedged
reader's lane is scrubbed, the SLO report folds, the Chrome export
validates with its counter tracks).  Their timing gates (the controller
acting on a burst, the closed loop's p99 TTFT band) are the card's to
judge and stay out of these tests; with repeated replays the band is
judged on the medians, which these tests recompute from the replays."""

import statistics

import pytest
import torch

from repro_torch import configs
from repro_torch.benchmarks import hotswap as HS
from repro_torch.benchmarks import slo as SLO
from repro_torch.benchmarks import smoke as SM
from repro_torch.models import model as M

TIMING_GATES = ("controller acted on the burst",)


@pytest.fixture(scope="module")
def model():
    cfg = configs.get_smoke("llama3.2-1b")
    return cfg, M.init_params(0, cfg, device="cpu")


def test_hotswap_twin_gates_hold(model):
    cfg, params = model
    rec = HS.run(cfg, params, "cpu", smoke=True)
    assert rec["failures"] == []
    st = rec["staged_swap"]
    assert st["landed"] and st["rejected"] and st["rejected_leaf"] == 0
    assert st["epoch_unchanged_after_reject"] and st["tokens_exact"]
    # the swap began with the feeder's requests unfinished on the engine
    assert st["decoded_since_stage"] and st["unfinished_at_swap"] >= 1
    assert st["requests"] >= 4
    assert st["checkpoint_bytes"] > sum(
        x.numel() * x.element_size() for x in
        (params["embed"], params["final_ln"]))
    bd = rec["bounded_drain"]
    assert bd["drain_timeouts"] >= 1 and bd["lane_scrubs"] >= 1
    assert bd["dropped"] == 0 and bd["tokens_exact"]
    assert rec["swaps_under_traffic"]["swaps"] == 2


def test_staged_swap_keeps_the_checkpoint_where_asked(model, tmp_path):
    cfg, params = model
    SM.FAILURES.clear()
    st = HS.bench_staged_swap(cfg, params, torch.device("cpu"), 4,
                              str(tmp_path))
    assert SM.FAILURES == [] and st["landed"] and st["rejected"]
    # the corrupted copy is gone, the checkpoint kept for later use
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_000000001"]


@pytest.mark.parametrize("near_tie_rel", [None, 0.05])
def test_slo_twin_deterministic_gates_hold(model, near_tie_rel):
    cfg, params = model
    SM.FAILURES.clear()
    rec = SLO.bench_closed_loop(
        cfg, params, "cpu", smoke=True, gate_band=False,
        near_tie_rel=near_tie_rel)
    failures = [f for f in SM.FAILURES if not f.startswith(TIMING_GATES)]
    SM.FAILURES.clear()
    assert failures == []
    assert rec["static"]["dropped"] == rec["closed_loop"]["dropped"] == 0
    assert rec["static"]["requests"] == rec["trace"]["requests"] >= 8
    assert all(s["equal"] for s in rec["sampled_tokens"])
    assert all(s["teacher_forced"]["flips"] == 0
               for s in rec["sampled_tokens"])
    wit = rec["prefix_witness"]
    assert wit["float32_equal"] and wit["float32_pages_saved"] > 0
    assert wit["alone_equals_replays"]
    assert rec["chrome"]["validate_errors"] == []
    assert rec["chrome"]["counter_events"] >= 1
    assert rec["controller"]["state_samples"] >= 1
    assert set(rec["per_class"]) <= {"interactive", "batch"}
    assert rec["trace"]["vocab"] == cfg.vocab


def test_slo_band_reads_the_medians_of_repeated_replays(model):
    cfg, params = model
    SM.FAILURES.clear()
    rec = SLO.bench_closed_loop(cfg, params, "cpu", smoke=True,
                                gate_band=False, windows=2)
    failures = [f for f in SM.FAILURES if not f.startswith(TIMING_GATES)]
    SM.FAILURES.clear()
    assert failures == []
    reps = rec["replays"]
    # the arms in turns on one calibration, every replay recorded
    assert rec["windows"] == 2
    assert [(r["arm"], r["window"]) for r in reps] == [
        ("static", 0), ("closed_loop", 0), ("static", 1),
        ("closed_loop", 1)]
    assert all(r["dropped"] == 0 for r in reps)
    for arm in ("static", "closed_loop"):
        for key in ("p99_ttft_ms", "goodput_tok_per_s", "wall_s"):
            xs = [r[key] for r in reps if r["arm"] == arm]
            sp = rec["spread"][arm][key]
            assert sp["readings"] == xs
            assert sp["median"] == statistics.median(xs) == rec[arm][key]
            assert (sp["min"], sp["max"]) == (min(xs), max(xs))
    for r in reps:
        if r["arm"] == "closed_loop":
            over = r["shrinks_over_target"]
            assert over["step"] + over["ttft"] >= 0 and r["shrinks"] >= 0
            assert r["final_slot_cap"] >= 1
    band = rec["band"]
    assert band["static_p99_ttft_ms"] == rec["static"]["p99_ttft_ms"]
    assert band["closed_goodput_tok_per_s"] \
        == rec["closed_loop"]["goodput_tok_per_s"]
    assert rec["band_held"] == SLO.band_held(
        band["static_p99_ttft_ms"], band["closed_p99_ttft_ms"],
        band["static_goodput_tok_per_s"], band["closed_goodput_tok_per_s"])
    assert len(rec["sampled_tokens"]) == 4
    assert all(s["equal"] for s in rec["sampled_tokens"])


@pytest.mark.parametrize("sp99, cp99, sgp, cgp, held", [
    (100.0, 110.0, 10.0, 1.0, True),     # within 10%: goodput not asked
    (100.0, 110.1, 10.0, 9.9, False),    # past 10% with less goodput
    (100.0, 150.0, 10.0, 10.0, True),    # within 50% and goodput no worse
    (100.0, 150.1, 10.0, 20.0, False),   # past 50%: goodput cannot save it
])
def test_slo_band_thresholds_are_the_references(sp99, cp99, sgp, cgp, held):
    assert SLO.band_held(sp99, cp99, sgp, cgp) is held


def test_overload_speed_takes_the_least_speed_that_queues(model,
                                                          monkeypatch):
    """``overload_speed`` replays the static arm at 2x, 4x, ... and stops
    at the first speed whose wall is at least ``OVERLOAD_RATIO`` times the
    span of the compressed arrivals; each replay sees that speed."""
    cfg, params = model
    _, trace = SLO._trace(cfg, smoke=True)
    last = max(t.at_s for t in trace.requests)
    seen = []
    walls = {}

    def fake_run(cfg_, params_, dev, trace_, controller, *, label, speed):
        assert controller is None
        seen.append(speed)
        return {"wall_s": walls[speed]}

    monkeypatch.setattr(SLO, "_run", fake_run)
    speeds = SLO.OVERLOAD_SPEEDS
    # each speed's wall just short of the ratio, the third's just over it
    for i, s in enumerate(speeds):
        walls[s] = SLO.OVERLOAD_RATIO * last / s * (1.01 if i == 2
                                                    else 0.99)
    speed, probes = SLO.overload_speed(cfg, params, "cpu", smoke=True)
    assert speed == speeds[2] and seen == list(speeds[:3])
    assert [p["speed"] for p in probes] == seen
    assert all(abs(p["ratio"] - walls[p["speed"]] / (last / p["speed"]))
               < 1e-12 for p in probes)
    seen.clear()
    walls.update({s: 0.0 for s in speeds})
    assert SLO.overload_speed(cfg, params, "cpu", smoke=True)[0] is None
    assert seen == list(speeds)


def test_benchmarks_refuse_to_run_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (HS.run, SLO.run):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()


def test_versus_dense_measures_the_flip():
    logits = [torch.zeros(8), torch.zeros(8), torch.zeros(8)]
    logits[1][3], logits[1][5] = 10.0, 9.8
    rec = SLO._versus_dense([1, 5, 7], [1, 3, 2], logits)
    assert rec["first_difference"] == 1 and not rec["equal"]
    assert abs(rec["deficit_rel"] - 0.02) < 1e-6
    assert SLO._versus_dense([1, 3], [1, 3], logits)["first_difference"] \
        is None


def test_dense_reference_teacher_forcing(model):
    cfg, params = model
    dev = torch.device("cpu")
    prompt = [3, 1, 4, 1, 5]
    free, forced_free = [], []
    want = SM.dense_reference(cfg, params, prompt, 4, dev, logits=free)
    # fed its own tokens, the loop is the free-running loop
    assert SM.dense_reference(cfg, params, prompt, 4, dev,
                              logits=forced_free, forced=want) == want
    assert all(torch.equal(a, b) for a, b in zip(free, forced_free))
    # fed another first token, the next step sees that token
    other = [(want[0] + 1) % cfg.vocab] + want[1:]
    forced = []
    SM.dense_reference(cfg, params, prompt, 4, dev, logits=forced,
                       forced=other)
    assert torch.equal(forced[0], free[0])
    assert not torch.equal(forced[1], free[1])


def test_hotswap_near_tie_mode_gates_hold(model):
    # the mode chip_smoke.py runs at full width: tokens against a fresh
    # engine without swaps exactly, and teacher-forced against the dense
    # reference within the near-tie
    cfg, params = model
    rec = HS.run(cfg, params, "cpu", smoke=True, near_tie_rel=0.05)
    assert rec["failures"] == []
    for section in ("swaps_under_traffic", "staged_swap", "bounded_drain"):
        toks = rec[section]["tokens"]
        assert toks["ok"] and toks["equal_to_no_swap"]
        assert toks["max_deficit_rel"] <= 0.05
