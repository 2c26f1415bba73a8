"""Closed-loop SLO benchmark: static admission against the latency-feedback
controller on one seeded burst trace.

The port of ``benchmarks/slo.py``.  The same seeded burst trace
(``repro_torch.serving.loadgen``) is replayed twice against
identically-sized engines:

* **static**: fixed admission limits (``max_slots``, watermark).  Bursts
  pile every arrival into the active batch; post-admission first-token
  latency inflates with the batch.
* **closed_loop**: a :class:`~repro_torch.serving.scheduler.\
LatencyFeedbackController` watches windowed step-latency and TTFT p99
  and modulates the admission watermark and slot cap (multiplicative
  decrease past the knee, additive recovery, hysteresis).

The knee targets are *calibrated on the device in use*: requests run
alone, back to back, measure the uncontended decode p50 and TTFT, and the
controller's targets are set fixed factors above them.

Gates (each exits nonzero when lost):

* zero dropped requests and exact token counts in BOTH runs; sampled
  requests match the dense (non-paged) reference token for token (with
  ``near_tie_rel``: match each other exactly, and stand at every step
  within a near-tie of the dense loop's best logit given the engine's own
  prefix); a sampled request served at float32 compute, its prompt pages
  taken from the prefix cache, equals the dense loop at float32 compute;
* the controller acted (>= 1 ``sched.ctrl_*`` decision event) and the
  closed loop held p99 TTFT no worse than static (band) or beat it on
  goodput (``gate_band=False`` records the band without gating it); with
  ``--windows N`` each arm is replayed N times in turns and the band reads
  the medians;
* the closed run's Chrome export validates, including the Perfetto
  counter tracks (``ph: "C"``) for watermark, active slots and p99;
* the SLO report folds (per-tenant and per-class attainment) and the
  prefix-cache collision rate is recorded beside ``pages_saved``.

    PYTHONPATH=src python -m repro_torch.benchmarks.slo [--smoke]
        [--device cpu] [--windows N] [--out PATH]

Runs on the CUDA card unless ``--device cpu``, on the llama3.2-1b smoke
config with parameters from seed 0; :func:`bench_closed_loop` takes any
configuration and parameters (``chip_smoke.py`` passes full width).
Writes its JSON record only to ``--out``.

The trace's prompt tokens are drawn below the model's vocabulary, since
the engine refuses tokens outside it.  At the smoke config (vocabulary
512) the trace therefore differs from the reference benchmark's, whose
tokens run up to 999 and which its embedding gather clamps.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..device import resolve
from ..obs import TRACER
from ..obs.chrome import to_chrome, validate
from ..serving.engine import EngineConfig, Request, ServingEngine
from ..serving.loadgen import (LoadgenConfig, fold_report, generate_trace,
                               replay)
from ..serving.scheduler import ControllerConfig, SchedulerConfig
from .smoke import (FAILURES, check, deficit_rel, dense_reference, spread,
                    teacher_forced)

MAX_SLOTS = 8
KNEE_FACTOR = 4.0       # controller TTFT target = uncontended TTFT x this
# the overload arm: the trace's arrivals compressed by the least of these
# speeds at which a static replay's wall is OVERLOAD_RATIO times the span
# of its arrivals (the engine queues)
OVERLOAD_SPEEDS = (2.0, 4.0, 8.0, 16.0, 32.0, 64.0)
OVERLOAD_RATIO = 1.5


def _engine(cfg, params, dev, controller=None, n_pages=128,
            prefix_cache=True, mesh=None, rules=None):
    sc = SchedulerConfig(max_slots=MAX_SLOTS, page_size=8, max_seq=64,
                         prefill_chunk=8, prefill_rows=2, token_budget=16,
                         controller=controller, prefix_cache=prefix_cache)
    ecfg = EngineConfig(idle_poll_s=0.01)
    return ServingEngine(cfg, params, n_pages=n_pages, scheduler=sc,
                         engine_cfg=ecfg, device=dev, mesh=mesh,
                         rules=rules)


def calibrate_targets_ms(cfg, params, dev, mesh=None, rules=None):
    """Uncontended decode p50 and TTFT on this device (requests run back
    to back, alone on the engine): the knee references the controller's
    targets are set against.  The first requests absorb the warm-up; the
    histogram's low quantile then isolates the clean uncontended TTFT.
    ``mesh``/``rules``: the engine's (on a mesh of more than one rank,
    every rank calibrates alike and reads its own clock)."""
    eng = _engine(cfg, params, dev, mesh=mesh, rules=rules)
    eng.start()
    oks = []
    for rid in range(4):
        r = Request(rid=rid, prompt=np.arange(1, 9, dtype=np.int32) + rid,
                    max_new=8)
        eng.submit(r)
        oks.append(r.done.wait(timeout=600)
                   and r.out is not None and len(r.out) == 8)
    h_step = eng.metrics.histogram("engine.step_ns")
    h_ttft = eng.metrics.histogram("engine.ttft_ns")
    step_p50_ns = h_step.quantile(0.50) if h_step.count else 0.0
    ttft_lo_ns = h_ttft.quantile(0.01) if h_ttft.count else 0.0
    eng.stop()
    check(all(oks), "calibration requests complete")
    check(step_p50_ns > 0 and ttft_lo_ns > 0,
          "calibration measured decode p50 and uncontended TTFT")
    return step_p50_ns / 1e6, ttft_lo_ns / 1e6


def controller_config(step_p50_ms: float, ttft_ms: float
                      ) -> ControllerConfig:
    """The closed loop's controller on :func:`calibrate_targets_ms`'s
    readings.  The TTFT sensor (target a fixed factor over the
    uncontended first token) drives the loop when batched decode costs
    about what a batch of one does; the step sensor rides along as the
    safety net."""
    return ControllerConfig(
        step_p99_target_ms=round(step_p50_ms * 3.0, 3),
        ttft_p99_target_ms=round(max(ttft_ms * KNEE_FACTOR, 20.0), 3),
        period_s=0.05, window_s=1.0, slices=8,
        min_samples=2, min_slots=1, decrease=0.5,
        recover_after=2, cooldown=2, probe_after=6,
        watermark_step=0.05, watermark_max=0.5)


def trace_config(smoke: bool) -> LoadgenConfig:
    return LoadgenConfig(
        duration_s=2.5 if smoke else 8.0,
        base_rps=8.0 if smoke else 6.0,
        burst_factor=5.0,
        burst_period_s=1.25 if smoke else 2.5,
        burst_duty=0.3,
        seed=7,
    )


def _run(cfg, params, dev, trace, controller, *, label: str,
         speed: float = 1.0, mesh=None, rules=None):
    """Replay the trace against a fresh engine (``speed`` > 1 compresses
    its arrivals; ``mesh``/``rules``: the engine's); fold the SLO
    report."""
    TRACER.clear()
    TRACER.enable()
    try:
        eng = _engine(cfg, params, dev, controller=controller, mesh=mesh,
                      rules=rules)
        eng.start()
        t0 = time.monotonic()
        reqs = replay(eng, trace, speed=speed, timeout_s=600.0)
        wall_s = time.monotonic() - t0
        eng.stop()
        events = TRACER.snapshot()
    finally:
        TRACER.disable()
    dropped = sum(1 for r in reqs
                  if r.out is None or len(r.out) != r.max_new)
    tokens = sum(len(r.out) for r in reqs if r.out is not None)
    report = fold_report(trace, events=events,
                         pool_stats=eng.kv_pool.stats(),
                         pages_saved=eng.stats.pages_saved)
    check(dropped == 0,
          f"{label}: zero dropped/truncated requests (got {dropped})")
    return {"reqs": reqs, "events": events, "report": report,
            "wall_s": wall_s, "dropped": dropped, "tokens": tokens,
            "engine": eng}


def _summary(run, label: str) -> dict:
    o = run["report"].overall
    return {
        "requests": o["requests"],
        "dropped": run["dropped"],
        "preemptions": o["preemptions"],
        "p50_ttft_ms": o["ttft_p50_ms"],
        "p99_ttft_ms": o["ttft_p99_ms"],
        "p99_tpot_ms": o["tpot_p99_ms"],
        "attainment": o["attainment"],
        "goodput_tok_per_s": run["tokens"] / max(run["wall_s"], 1e-9),
        "wall_s": run["wall_s"],
        "label": label,
    }


def _versus_dense(got, want, logits) -> dict:
    """Where ``got`` first leaves the dense tokens ``want``, how far the
    dense step's logit of ``got``'s token stands below its best, relative
    to the step's largest |logit| (``deficit_rel``)."""
    same = [a == b for a, b in zip(got, want)]
    rec = {"equal": got == want, "tokens": got, "dense": want,
           "first_difference": None if all(same) else same.index(False)}
    k = rec["first_difference"]
    if k is not None:
        rec["deficit_rel"] = deficit_rel(logits[k], got[k])
    return rec


def _serve(eng, trs) -> list:
    """Serve the trace requests ``trs`` one after another on ``eng``."""
    eng.start()
    outs = []
    for tr in trs:
        r = Request(rid=tr.rid, prompt=tr.prompt, max_new=tr.max_new)
        eng.submit(r)
        ok = r.done.wait(timeout=600)
        outs.append(list(map(int, r.out)) if ok and r.out is not None
                    else [])
    eng.stop()
    return outs


def prefix_witness(cfg, params, dev, trace, tr, replayed) -> dict:
    """Two readings that take the prefix cache and bf16 rounding apart for
    the sampled request ``tr`` (``replayed``: its tokens in the replays).

    * ``alone``: its prompt served alone with the prefix cache off, in
      bf16 as in the replays (recorded beside the replays' tokens).
    * ``float32``: at float32 compute, served after the trace request
      that shares its system prompt, so its prompt pages come from the
      prefix cache, against the dense loop at float32 compute: gated
      equal, and the cache gated to have served pages when the two share
      a full page."""
    alone = _serve(_engine(cfg, params, dev, prefix_cache=False), [tr])[0]
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    sharer = next((t for t in trace.requests
                   if t.sys_id == tr.sys_id and t is not tr), None)
    eng32 = _engine(cfg32, params, dev)
    got32 = _serve(eng32, [t for t in (sharer, tr) if t is not None])[-1]
    want32 = dense_reference(cfg32, params, tr.prompt, tr.max_new, dev)
    saved = eng32.stats.pages_saved
    page = eng32.sched_cfg.page_size
    check(got32 == want32, f"rid {tr.rid} at float32 compute through the "
                           f"prefix cache == dense reference at float32")
    if sharer is not None and len(tr.prompt) > page \
            and trace.cfg.system_prompt_len >= page:
        check(saved > 0, f"rid {tr.rid} at float32 took its prompt pages "
                         f"from the prefix cache ({saved} pages saved)")
    return {"alone_no_prefix_cache": alone,
            "alone_equals_replays": alone == replayed,
            "float32": got32, "float32_dense": want32,
            "float32_equal": got32 == want32,
            "float32_pages_saved": saved,
            "sharer_rid": None if sharer is None else sharer.rid}


def _replay_record(run, arm: str, window: int, cc=None) -> dict:
    """One replay's readings: p99 TTFT, goodput, wall and, for the closed
    loop, its shrinks and which sensor stood over its target at each."""
    rec = {"arm": arm, "window": window, **_summary(run, arm)}
    if cc is not None:
        ev = run["events"]
        shrinks = [e for e in ev if e.cat == "sched"
                   and e.name == "ctrl_shrink"]
        rec["shrinks"] = len(shrinks)
        rec["grows"] = sum(1 for e in ev if e.cat == "sched"
                           and e.name == "ctrl_grow")
        rec["shrinks_over_target"] = {
            "step": sum(e.args["p99_step_us"] > cc.step_p99_target_ms * 1e3
                        for e in shrinks),
            "ttft": sum(e.args["p99_ttft_us"] > cc.ttft_p99_target_ms * 1e3
                        for e in shrinks)}
        rec["final_slot_cap"] = run["engine"].scheduler.stats().get(
            "slot_cap")
    return rec


def band_held(sp99: float, cp99: float, sgp: float, cgp: float) -> bool:
    """The reference's closed-loop claim: p99 TTFT within 10% of the
    static replay's, or within 50% with goodput no worse."""
    return (cp99 <= sp99 * 1.10) or (cp99 <= sp99 * 1.5 and cgp >= sgp)


def _trace(cfg, smoke: bool):
    """The seeded trace of :func:`trace_config`, its prompt tokens drawn
    from the model's vocabulary (the trace's default of 1000 exceeds the
    smoke config's 512; the reference's JAX gather clamps such tokens, the
    port's embedding refuses them)."""
    tcfg = trace_config(smoke)
    tcfg = dataclasses.replace(tcfg, vocab=min(tcfg.vocab, cfg.vocab))
    return tcfg, generate_trace(tcfg)


def overload_speed(cfg, params, dev, smoke: bool) -> tuple:
    """The least of ``OVERLOAD_SPEEDS`` at which the static engine cannot
    keep up with the trace's compressed arrivals: one static replay at
    each, in order, until the replay's wall is at least ``OVERLOAD_RATIO``
    times the span of its arrivals (the last arrival's time over the
    speed).  -> (speed, or None if none overloads; the probe replays'
    readings ``{speed, span_s, wall_s, ratio}``)."""
    _, trace = _trace(cfg, smoke)
    last = max(t.at_s for t in trace.requests)
    probes = []
    for speed in OVERLOAD_SPEEDS:
        run = _run(cfg, params, dev, trace, None, label="overload probe",
                   speed=speed)
        span = last / speed
        probes.append({"speed": speed, "span_s": span,
                       "wall_s": run["wall_s"],
                       "ratio": run["wall_s"] / span})
        if run["wall_s"] >= OVERLOAD_RATIO * span:
            return speed, probes
    return None, probes


def bench_closed_loop(cfg, params, dev, smoke: bool, *,
                      gate_band: bool = True,
                      near_tie_rel: float = None,
                      windows: int = 1, speed: float = 1.0) -> dict:
    """The calibrated static vs closed-loop replay of the seeded trace of
    :func:`trace_config` (its arrivals compressed by ``speed``; see
    :func:`overload_speed`), ``windows`` replays of each arm in turns
    (static, closed, static, closed, ...) on one calibration.  The band is
    judged on the medians of the replays' p99 TTFT and goodput; each
    replay's readings are recorded (``replays``), with the least and the
    largest beside each median (``spread``).

    ``near_tie_rel``: where the paged engine and the dense loop round bf16
    differently (a full-width model computes a prompt's K/V in chunks on
    one side and token by token on the other), a greedy step whose top
    two logits lie closer than the rounding can flip, and the flipped
    token changes the rest of its request.  The sampled requests' tokens
    are then held to the same tokens in every replay exactly, and, by
    teacher forcing (the dense loop fed the engine's tokens), at every
    step to within ``near_tie_rel * max |logit|`` of the dense step's
    best logit.  None holds them to the dense reference exactly.  Either
    way :func:`prefix_witness` serves the first sampled request again
    without the prefix cache and at float32 compute."""
    step_p50_ms, ttft_ms = calibrate_targets_ms(cfg, params, dev)
    cc = controller_config(step_p50_ms, ttft_ms)

    tcfg, trace = _trace(cfg, smoke)
    check(len(trace.requests) >= 8,
          f"trace has enough load ({len(trace.requests)} requests)")

    statics, closeds = [], []
    for _ in range(windows):
        statics.append(_run(cfg, params, dev, trace, None, label="static",
                            speed=speed))
        closeds.append(_run(cfg, params, dev, trace, cc,
                            label="closed_loop", speed=speed))
    replays = []
    for w, (st, cl) in enumerate(zip(statics, closeds)):
        replays += [_replay_record(st, "static", w),
                    _replay_record(cl, "closed_loop", w, cc)]

    # --- tokens against the dense (non-paged) reference ----------------
    n_ref = 1 if smoke else 2
    sample = sorted(trace.requests, key=lambda t: len(t.prompt))[:n_ref]
    sampled = []
    witness = None
    for tr in sample:
        logits = []
        want = dense_reference(cfg, params, tr.prompt, tr.max_new, dev,
                               logits=logits)
        outs = {}
        forced = {}                     # teacher forcing once per token list
        for w in range(windows):
            for run, label in ((statics[w], "static"),
                               (closeds[w], "closed_loop")):
                got = list(map(
                    int, run["reqs"][trace.requests.index(tr)].out))
                outs.setdefault(label, got)
                rec = _versus_dense(got, want, logits)
                key = tuple(got)
                if key not in forced:
                    forced[key] = teacher_forced(cfg, params, tr.prompt,
                                                 got, dev)
                rec["teacher_forced"] = forced[key]
                if near_tie_rel is None:
                    check(got == want,
                          f"{label}: rid {tr.rid} tokens == dense "
                          f"reference")
                else:
                    worst = rec["teacher_forced"]["max_deficit_rel"]
                    check(worst <= near_tie_rel,
                          f"{label}: rid {tr.rid} tokens, teacher-forced, "
                          f"within a near-tie of the dense reference's "
                          f"best at every step (worst {worst:.4f} of the "
                          f"largest logit, limit {near_tie_rel})")
                    check(got == outs["static"],
                          f"rid {tr.rid}: {label} tokens (window {w}) == "
                          f"the first static replay's")
                sampled.append({"rid": tr.rid, "run": label, "window": w,
                                **rec})
        if witness is None:
            witness = {"rid": tr.rid, **prefix_witness(
                cfg, params, dev, trace, tr, outs["static"])}

    # --- controller activity + chrome export ---------------------------
    for w, closed in enumerate(closeds):
        ev = closed["events"]
        decisions = [e for e in ev if e.cat == "sched"
                     and e.name in ("ctrl_shrink", "ctrl_grow")]
        trace_json = to_chrome(ev)
        errors = validate(trace_json)
        counters = [r for r in trace_json["traceEvents"]
                    if r.get("ph") == "C"]
        check(len(decisions) >= 1,
              f"controller acted on the burst (window {w}: "
              f"{len(decisions)} decision events)")
        check(len(counters) >= 1,
              f"Perfetto counter track present ({len(counters)} C events)")
        check(not errors,
              f"closed-loop chrome trace validates (errors: {errors[:3]})")

    # --- the closed-loop claim, on the medians of the replays -----------
    spreads = {arm: {k: spread(r[k] for r in replays if r["arm"] == arm)
                     for k in ("p50_ttft_ms", "p99_ttft_ms", "p99_tpot_ms",
                               "attainment", "goodput_tok_per_s",
                               "wall_s")}
               for arm in ("static", "closed_loop")}
    sp99 = spreads["static"]["p99_ttft_ms"]["median"]
    cp99 = spreads["closed_loop"]["p99_ttft_ms"]["median"]
    sgp = spreads["static"]["goodput_tok_per_s"]["median"]
    cgp = spreads["closed_loop"]["goodput_tok_per_s"]["median"]
    win = band_held(sp99, cp99, sgp, cgp)
    band = (f"closed loop holds p99 TTFT (median of {windows}: static "
            f"{sp99:.1f} ms vs closed {cp99:.1f} ms) or wins on goodput "
            f"({sgp:.1f} vs {cgp:.1f} tok/s)")
    if gate_band:
        check(win, band)
    else:
        print(f"[{'held' if win else 'missed'}, recorded] {band}",
              flush=True)

    def medians(arm, runs):
        rec = _summary(runs[0], arm)
        rec.update({k: v["median"] for k, v in spreads[arm].items()})
        rec["dropped"] = sum(r["dropped"] for r in runs)
        return rec

    # the last closed replay's state, pool and export stand for the arm
    closed = closeds[-1]
    states = [e for e in closed["events"]
              if e.cat == "sched" and e.name == "ctrl_state"]
    pool = closed["report"].pool
    sched_stats = closed["engine"].scheduler.stats()
    closed_reps = [r for r in replays if r["arm"] == "closed_loop"]
    return {
        "trace": {"requests": len(trace.requests),
                  "vocab": tcfg.vocab,
                  "duration_s": tcfg.duration_s,
                  "base_rps": tcfg.base_rps,
                  "burst_factor": tcfg.burst_factor,
                  "seed": tcfg.seed, "speed": speed,
                  "arrival_span_s": max(t.at_s for t in trace.requests)
                  / speed},
        "windows": windows,
        "calibrated_step_p50_ms": step_p50_ms,
        "calibrated_ttft_ms": ttft_ms,
        "calibrated_step_target_ms": cc.step_p99_target_ms,
        "calibrated_ttft_target_ms": cc.ttft_p99_target_ms,
        "static": medians("static", statics),
        "closed_loop": medians("closed_loop", closeds),
        "spread": spreads,
        "replays": replays,
        "band": {"static_p99_ttft_ms": sp99, "closed_p99_ttft_ms": cp99,
                 "static_goodput_tok_per_s": sgp,
                 "closed_goodput_tok_per_s": cgp},
        "band_held": win,
        "band_gated": gate_band,
        "sampled_tokens": sampled,
        "prefix_witness": witness,
        "controller": {"decision_events": sum(r["shrinks"] + r["grows"]
                                              for r in closed_reps),
                       "shrinks": sum(r["shrinks"] for r in closed_reps),
                       "grows": sum(r["grows"] for r in closed_reps),
                       "shrinks_over_target": {
                           s: sum(r["shrinks_over_target"][s]
                                  for r in closed_reps)
                           for s in ("step", "ttft")},
                       "state_samples": len(states),
                       "final_slot_cap": sched_stats.get("slot_cap"),
                       "final_free_frac": sched_stats.get(
                           "admit_free_frac")},
        "per_class": closed["report"].to_dict()["per_class"],
        "pool": pool,
        "chrome": {"events": len(trace_json["traceEvents"]),
                   "counter_events": len(counters),
                   "validate_errors": errors[:5]},
    }


def run(cfg=None, params=None, device=None, *, smoke: bool = False,
        windows: int = 1) -> dict:
    """The benchmark on ``device`` (default: the CUDA card) with the model
    ``cfg``/``params`` (default: the llama3.2-1b smoke config, parameters
    from seed 0), ``windows`` replays of each arm; -> the record, whose
    ``failures`` lists every check that did not hold."""
    from .. import configs
    from ..models import model as M

    dev = resolve(device)
    if cfg is None:
        cfg = configs.get_smoke("llama3.2-1b")
        params = M.init_params(0, cfg, device=dev)
    FAILURES.clear()
    rec = {
        "bench": "slo",
        "mode": "smoke" if smoke else "full",
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "torch": torch.__version__,
        "model": cfg.name,
        "closed_loop_vs_static": bench_closed_loop(cfg, params, dev, smoke,
                                                   windows=windows),
    }
    rec["failures"] = list(FAILURES)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="fast mode: shorter trace")
    ap.add_argument("--windows", type=int, default=1,
                    help="replays of each arm, run in turns")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="output JSON path")
    args = ap.parse_args(argv)
    rec = run(device=args.device, smoke=args.smoke, windows=args.windows)
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1))
        print(f"wrote {args.out}", flush=True)
    body = rec["closed_loop_vs_static"]
    print(json.dumps({k: body[k] for k in
                      ("static", "closed_loop", "band", "controller",
                       "pool")},
                     indent=1))
    if rec["failures"]:
        print(f"FAILED: {rec['failures']}", file=sys.stderr)
        return 1
    print("slo bench OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
