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
  goodput (``gate_band=False`` records the band without gating it);
* the closed run's Chrome export validates, including the Perfetto
  counter tracks (``ph: "C"``) for watermark, active slots and p99;
* the SLO report folds (per-tenant and per-class attainment) and the
  prefix-cache collision rate is recorded beside ``pages_saved``.

    PYTHONPATH=src python -m repro_torch.benchmarks.slo [--smoke]
        [--device cpu] [--out PATH]

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
from .smoke import (FAILURES, check, deficit_rel, dense_reference,
                    teacher_forced)

MAX_SLOTS = 8
KNEE_FACTOR = 4.0       # controller TTFT target = uncontended TTFT x this


def _engine(cfg, params, dev, controller=None, n_pages=128,
            prefix_cache=True):
    sc = SchedulerConfig(max_slots=MAX_SLOTS, page_size=8, max_seq=64,
                         prefill_chunk=8, prefill_rows=2, token_budget=16,
                         controller=controller, prefix_cache=prefix_cache)
    ecfg = EngineConfig(idle_poll_s=0.01)
    return ServingEngine(cfg, params, n_pages=n_pages, scheduler=sc,
                         engine_cfg=ecfg, device=dev)


def calibrate_targets_ms(cfg, params, dev):
    """Uncontended decode p50 and TTFT on this device (requests run back
    to back, alone on the engine): the knee references the controller's
    targets are set against.  The first requests absorb the warm-up; the
    histogram's low quantile then isolates the clean uncontended TTFT."""
    eng = _engine(cfg, params, dev)
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


def trace_config(smoke: bool) -> LoadgenConfig:
    return LoadgenConfig(
        duration_s=2.5 if smoke else 8.0,
        base_rps=8.0 if smoke else 6.0,
        burst_factor=5.0,
        burst_period_s=1.25 if smoke else 2.5,
        burst_duty=0.3,
        seed=7,
    )


def _run(cfg, params, dev, trace, controller, *, label: str):
    """Replay the trace against a fresh engine; fold the SLO report."""
    TRACER.clear()
    TRACER.enable()
    try:
        eng = _engine(cfg, params, dev, controller=controller)
        eng.start()
        t0 = time.monotonic()
        reqs = replay(eng, trace, timeout_s=600.0)
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


def bench_closed_loop(cfg, params, dev, smoke: bool, *,
                      gate_band: bool = True,
                      near_tie_rel: float = None) -> dict:
    """The calibrated static vs closed-loop replay of the seeded trace of
    :func:`trace_config`.

    ``near_tie_rel``: where the paged engine and the dense loop round bf16
    differently (a full-width model computes a prompt's K/V in chunks on
    one side and token by token on the other), a greedy step whose top
    two logits lie closer than the rounding can flip, and the flipped
    token changes the rest of its request.  The sampled requests' tokens
    are then held to the same tokens in both replays exactly, and, by
    teacher forcing (the dense loop fed the engine's tokens), at every
    step to within ``near_tie_rel * max |logit|`` of the dense step's
    best logit.  None holds them to the dense reference exactly.  Either
    way :func:`prefix_witness` serves the first sampled request again
    without the prefix cache and at float32 compute."""
    step_p50_ms, ttft_ms = calibrate_targets_ms(cfg, params, dev)
    # The TTFT sensor (target a fixed factor over the uncontended first
    # token) drives the loop when batched decode costs about what a batch
    # of one does; the step sensor rides along as the safety net.
    cc = ControllerConfig(
        step_p99_target_ms=round(step_p50_ms * 3.0, 3),
        ttft_p99_target_ms=round(max(ttft_ms * KNEE_FACTOR, 20.0), 3),
        period_s=0.05, window_s=1.0, slices=8,
        min_samples=2, min_slots=1, decrease=0.5,
        recover_after=2, cooldown=2, probe_after=6,
        watermark_step=0.05, watermark_max=0.5)

    # prompt tokens come from the model's vocabulary (the trace's default
    # of 1000 exceeds the smoke config's 512; the reference's JAX gather
    # clamps such tokens, the port's embedding refuses them)
    tcfg = trace_config(smoke)
    tcfg = dataclasses.replace(tcfg, vocab=min(tcfg.vocab, cfg.vocab))
    trace = generate_trace(tcfg)
    check(len(trace.requests) >= 8,
          f"trace has enough load ({len(trace.requests)} requests)")

    static = _run(cfg, params, dev, trace, None, label="static")
    closed = _run(cfg, params, dev, trace, cc, label="closed_loop")

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
        for run, label in ((static, "static"), (closed, "closed_loop")):
            got = outs[label] = list(map(
                int, run["reqs"][trace.requests.index(tr)].out))
            rec = _versus_dense(got, want, logits)
            rec["teacher_forced"] = teacher_forced(cfg, params, tr.prompt,
                                                   got, dev)
            if near_tie_rel is None:
                check(got == want,
                      f"{label}: rid {tr.rid} tokens == dense reference")
            else:
                worst = rec["teacher_forced"]["max_deficit_rel"]
                check(worst <= near_tie_rel,
                      f"{label}: rid {tr.rid} tokens, teacher-forced, "
                      f"within a near-tie of the dense reference's best at "
                      f"every step (worst {worst:.4f} of the largest "
                      f"logit, limit {near_tie_rel})")
            sampled.append({"rid": tr.rid, "run": label, **rec})
        if near_tie_rel is not None:
            check(outs["static"] == outs["closed_loop"],
                  f"rid {tr.rid}: static tokens == closed-loop tokens")
        if witness is None:
            witness = {"rid": tr.rid, **prefix_witness(
                cfg, params, dev, trace, tr, outs["static"])}

    # --- controller activity + chrome export ---------------------------
    ev = closed["events"]
    decisions = [e for e in ev if e.cat == "sched"
                 and e.name in ("ctrl_shrink", "ctrl_grow")]
    states = [e for e in ev if e.cat == "sched" and e.name == "ctrl_state"]
    trace_json = to_chrome(ev)
    errors = validate(trace_json)
    counters = [r for r in trace_json["traceEvents"] if r.get("ph") == "C"]
    check(len(decisions) >= 1,
          f"controller acted on the burst "
          f"(got {len(decisions)} decision events)")
    check(len(counters) >= 1,
          f"Perfetto counter track present ({len(counters)} C events)")
    check(not errors,
          f"closed-loop chrome trace validates (errors: {errors[:3]})")

    # --- the closed-loop claim -----------------------------------------
    sp99 = static["report"].overall["ttft_p99_ms"]
    cp99 = closed["report"].overall["ttft_p99_ms"]
    sgp = static["tokens"] / max(static["wall_s"], 1e-9)
    cgp = closed["tokens"] / max(closed["wall_s"], 1e-9)
    win = (cp99 <= sp99 * 1.10) or (cp99 <= sp99 * 1.5 and cgp >= sgp)
    band = (f"closed loop holds p99 TTFT (static {sp99:.1f} ms vs "
            f"closed {cp99:.1f} ms) or wins on goodput "
            f"({sgp:.1f} vs {cgp:.1f} tok/s)")
    if gate_band:
        check(win, band)
    else:
        print(f"[{'held' if win else 'missed'}, recorded] {band}",
              flush=True)

    pool = closed["report"].pool
    sched_stats = closed["engine"].scheduler.stats()
    kinds = [e.name for e in decisions]
    # which sensor stood over its target at each shrink
    over = {"step": 0, "ttft": 0}
    for e in decisions:
        if e.name == "ctrl_shrink":
            over["step"] += e.args["p99_step_us"] > cc.step_p99_target_ms * 1e3
            over["ttft"] += e.args["p99_ttft_us"] > cc.ttft_p99_target_ms * 1e3
    return {
        "trace": {"requests": len(trace.requests),
                  "vocab": tcfg.vocab,
                  "duration_s": tcfg.duration_s,
                  "base_rps": tcfg.base_rps,
                  "burst_factor": tcfg.burst_factor,
                  "seed": tcfg.seed},
        "calibrated_step_p50_ms": step_p50_ms,
        "calibrated_ttft_ms": ttft_ms,
        "calibrated_step_target_ms": cc.step_p99_target_ms,
        "calibrated_ttft_target_ms": cc.ttft_p99_target_ms,
        "static": _summary(static, "static"),
        "closed_loop": _summary(closed, "closed_loop"),
        "band_held": win,
        "band_gated": gate_band,
        "sampled_tokens": sampled,
        "prefix_witness": witness,
        "controller": {"decision_events": len(decisions),
                       "shrinks": kinds.count("ctrl_shrink"),
                       "grows": kinds.count("ctrl_grow"),
                       "shrinks_over_target": over,
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


def run(cfg=None, params=None, device=None, *, smoke: bool = False) -> dict:
    """The benchmark on ``device`` (default: the CUDA card) with the model
    ``cfg``/``params`` (default: the llama3.2-1b smoke config, parameters
    from seed 0); -> the record, whose ``failures`` lists every check that
    did not hold."""
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
        "closed_loop_vs_static": bench_closed_loop(cfg, params, dev, smoke),
    }
    rec["failures"] = list(FAILURES)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="fast mode: shorter trace")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="output JSON path")
    args = ap.parse_args(argv)
    rec = run(device=args.device, smoke=args.smoke)
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1))
        print(f"wrote {args.out}", flush=True)
    body = rec["closed_loop_vs_static"]
    print(json.dumps({k: body[k] for k in
                      ("static", "closed_loop", "controller", "pool")},
                     indent=1))
    if rec["failures"]:
        print(f"FAILED: {rec['failures']}", file=sys.stderr)
        return 1
    print("slo bench OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
