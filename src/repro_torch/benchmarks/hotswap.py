"""Hot-swap serving benchmark: weight hot-swap as a serving operation.

The port of ``benchmarks/hotswap.py``: checkpoint staging with per-tensor
checksums, bounded-drain revocation, writer parking, and graceful
degradation when a drain cannot complete.  Sections (each exits nonzero on
a lost guarantee):

* ``swaps_under_traffic``: repeated identity hot-swaps while the scheduler
  engine decodes a sustained batch: ZERO dropped requests, tokens equal to
  the dense reference, swap latency p50/p99 and decode-tick p50/p99 over
  the swap windows; on the card ``memory_allocated`` before and after the
  swaps and the graphed decode step's captures.
* ``staged_swap``: a checkpoint saved, then, while a feeder keeps the
  engine's slots busy with decode traffic, streamed into a shadow params
  tree on the engine's device (``stage_checkpoint``, per-tensor CRC
  verified during the stream) and swapped in (``hot_swap`` of that tree,
  which is what ``hot_swap(checkpoint=...)`` runs), with the save, the
  staging and the swap timed apart; a copy of it with one corrupted
  manifest CRC, passed as ``hot_swap(checkpoint=...)``, must be rejected
  at staging, typed with the leaf's index, before any lock is taken or
  epoch bumped.
* ``bounded_drain``: a wedged reader (device lease published, never
  released) forces the bounded drain to its deadline: the engine degrades
  (stops admitting, keeps decoding on the old epoch), the stuck lane is
  scrubbed, the retried swap lands, and every request still completes.

Tokens: every request's tokens equal the dense (non-paged) reference's.
With ``near_tie_rel`` (a full-width model in bf16, where the paged engine
and the dense loop round apart and a near-tie can flip a greedy token):
every request's tokens equal those a fresh engine gives its prompt with
no swap (an identity swap changes no token), and those stand, teacher-
forced, within ``near_tie_rel * max |logit|`` of the dense loop's best
at every step.

    PYTHONPATH=src python -m repro_torch.benchmarks.hotswap [--smoke]
        [--tokens 8] [--device cpu] [--out PATH]

Runs on the CUDA card unless ``--device cpu``, on the llama3.2-1b smoke
config with parameters from seed 0; the section functions take any
configuration and parameters (``chip_smoke.py`` passes full width).
Writes its JSON record only to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..device import resolve
from ..ft.checkpoint import (CheckpointCorrupt, read_manifest,
                             save_checkpoint)
from ..ft.faults import corrupt_copy
from ..serving.engine import EngineConfig, Request, ServingEngine
from ..serving.scheduler import SchedulerConfig
from .smoke import (FAILURES, allocated, check, dense_reference,
                    hold_tokens, sync)

N_PAGES = 128


def _engine(cfg, params, dev, n_pages=N_PAGES, drain_max_wait_s=5.0):
    sc = SchedulerConfig(max_slots=4, page_size=8, max_seq=64,
                         prefill_chunk=8, prefill_rows=2, token_budget=16)
    ecfg = EngineConfig(idle_poll_s=0.01, drain_max_wait_s=drain_max_wait_s,
                        swap_retries=4, swap_backoff_s=0.02)
    return ServingEngine(cfg, params, n_pages=n_pages, scheduler=sc,
                         engine_cfg=ecfg, device=dev)


def _prompts(n):
    return [np.arange(1, 8, dtype=np.int32) + i for i in range(n)]


def _serve_with(eng, prompts, max_new, mid=None):
    """Submit, run ``mid()`` on this thread mid-decode, wait, stop.
    Returns (outputs, dropped, mid's result): a request is DROPPED if it
    never completed or came back short, the number the gate pins to 0."""
    eng.start()
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    mid_result = mid() if mid is not None else None
    done = [r.done.wait(timeout=600) for r in reqs]
    eng.stop()
    dropped = sum(1 for r, ok in zip(reqs, done)
                  if not ok or r.out is None or len(r.out) != max_new)
    return [list(map(int, r.out)) if r.out is not None else []
            for r in reqs], dropped, mid_result


def _table_live(eng) -> int:
    """Live slots of the shared table: one read, after ``stop()``."""
    return int((eng.registry.table != 0).sum().item())


def _hold_tokens(cfg, params, dev, prompts, max_new, got,
                 near_tie_rel) -> dict:
    """Hold ``got`` (request i's tokens, for prompt ``i % len(prompts)``)
    to the dense reference as the module docstring says; -> the record,
    whose ``ok`` is the verdict and ``oracle`` names what was compared."""
    n = len(prompts)
    if near_tie_rel is None:
        want = [dense_reference(cfg, params, p, max_new, dev)
                for p in prompts]
        ok = all(g == want[i % n] for i, g in enumerate(got))
        return {"ok": ok, "oracle": "dense reference", "tokens_exact": ok}
    base, dropped, _ = _serve_with(_engine(cfg, params, dev), prompts,
                                   max_new)
    same = dropped == 0 and all(g == base[i % n]
                                for i, g in enumerate(got))
    held = hold_tokens(cfg, params, dev, prompts, base, max_new,
                       near_tie_rel)
    return {"ok": same and held["ok"],
            "oracle": f"no-swap engine, within {near_tie_rel} of the "
                      f"dense reference's best",
            "tokens_exact": same and held["exact"],
            "equal_to_no_swap": same,
            "flips": held["flips"],
            "max_deficit_rel": held["max_deficit_rel"]}


# ---------------------------------------------------------------------------
# Sections
# ---------------------------------------------------------------------------


def bench_swaps_under_traffic(cfg, params, dev, max_new: int, n_req: int,
                              n_swaps: int, near_tie_rel=None) -> dict:
    prompts = _prompts(n_req)
    eng = _engine(cfg, params, dev)

    mem = {}

    def swapper():
        lats = []
        landed = 0
        mem["allocated_before_swaps"] = allocated(dev)
        for _ in range(n_swaps):
            time.sleep(0.03)
            t0 = time.perf_counter()
            landed += bool(eng.hot_swap(params))     # identity weights
            lats.append(time.perf_counter() - t0)
        sync(dev)
        mem["allocated_after_swaps"] = allocated(dev)
        return landed, np.asarray(lats)

    got, dropped, (landed, lats) = _serve_with(eng, prompts, max_new,
                                               mid=swapper)
    toks = _hold_tokens(cfg, params, dev, prompts, max_new, got,
                        near_tie_rel)
    check(dropped == 0, f"0 dropped requests under swaps (got {dropped})")
    check(toks["ok"], f"tokens under hot-swaps == {toks['oracle']}")
    check(landed == n_swaps, f"all {n_swaps} swaps landed (got {landed})")
    st = eng.lock_stats()
    h_step = eng.metrics.histogram("engine.step_ns")
    rec = {"requests": n_req, "swaps": landed, "dropped": dropped,
           "tokens_exact": toks["tokens_exact"], "tokens": toks,
           "swap_p50_ms": float(np.percentile(lats, 50)) * 1e3,
           "swap_p99_ms": float(np.percentile(lats, 99)) * 1e3,
           "weight_swaps": st["engine"]["weight_swaps"],
           "drain_timeouts": st["device_leases"]["drain_timeouts"],
           "decode_captures": eng._decode_paged.stats.captures, **mem}
    if h_step.count:
        rec["decode_p50_us"] = h_step.quantile(0.50) / 1e3
        rec["decode_p99_us"] = h_step.quantile(0.99) / 1e3
    return rec


def _feed(eng, prompts, max_new, depth, stop, reqs) -> None:
    """Keep ``depth`` requests unfinished on ``eng`` until ``stop`` is
    set, cycling through ``prompts``; every request goes into ``reqs``."""
    while not stop.is_set():
        if sum(not r.done.is_set() for r in reqs) < depth:
            r = Request(rid=len(reqs), prompt=prompts[len(reqs) %
                                                      len(prompts)],
                        max_new=max_new)
            reqs.append(r)
            eng.submit(r)
        else:
            stop.wait(0.002)


def _wait_until(cond, timeout_s: float) -> bool:
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.002)
    return True


def bench_staged_swap(cfg, params, dev, max_new: int,
                      directory: Optional[str] = None,
                      near_tie_rel=None) -> dict:
    """``directory``: where the checkpoint is written (step 1) and kept,
    with the corrupted copy (step 2, manifest only) removed again; default
    a temporary directory, deleted at the end.  The staging, the swap and
    the rejected staging all run while a feeder keeps every slot of the
    engine busy; the swap starts only once a decode tick has run since
    the staging began, and records how many requests were unfinished and
    how many slots were decoding as it began."""
    prompts = _prompts(4)
    eng = _engine(cfg, params, dev)
    depth = eng.sched_cfg.max_slots
    out: dict = {}
    tmp = None
    if directory is None:
        directory = tmp = tempfile.mkdtemp(prefix="bravo_hotswap_")
    Path(directory).mkdir(parents=True, exist_ok=True)
    out["disk_free_bytes_before"] = shutil.disk_usage(directory).free
    reqs: list = []
    stop = threading.Event()
    feeder = threading.Thread(target=_feed, name="feeder", daemon=True,
                              args=(eng, prompts, max_new, depth, stop,
                                    reqs))
    try:
        sync(dev)
        t0 = time.perf_counter()
        path = save_checkpoint(directory, 1, params)
        out["save_s"] = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
        out["checkpoint_bytes"] = nbytes
        out["shards"] = len(read_manifest(directory, 1)["shards"])
        out["save_mb_per_s"] = nbytes / 1e6 / out["save_s"]

        eng.start()
        feeder.start()
        steps0 = eng.stats.decode_steps
        t = time.perf_counter()
        tree = eng.stage_checkpoint(directory, 1)
        sync(dev)
        out["stage_s"] = time.perf_counter() - t
        out["stage_mb_per_s"] = nbytes / 1e6 / out["stage_s"]
        out["decode_ticks_during_stage"] = eng.stats.decode_steps - steps0
        out["decoded_since_stage"] = _wait_until(
            lambda: eng.stats.decode_steps > steps0, 60.0)
        out["unfinished_at_swap"] = sum(not r.done.is_set()
                                        for r in list(reqs))
        out["decoding_slots_at_swap"] = eng.scheduler.stats()["running"]
        steps1 = eng.stats.decode_steps
        t = time.perf_counter()
        out["landed"] = eng.hot_swap(tree)
        out["swap_land_s"] = time.perf_counter() - t
        out["decode_ticks_during_swap"] = eng.stats.decode_steps - steps1
        out["epoch_after_swap"] = eng.store.epoch
        del tree
        # a copy of the checkpoint with one corrupted manifest CRC: its
        # staging must be rejected before any lock or epoch moves
        corrupt_copy(directory, 1, 2, leaf=0)
        epoch = eng.store.epoch
        try:
            eng.hot_swap(checkpoint=(directory, 2))
            out["rejected"] = False
        except CheckpointCorrupt as e:
            out["rejected"] = True
            out["rejected_leaf"] = e.leaf
        out["epoch_unchanged_after_reject"] = eng.store.epoch == epoch
    finally:
        stop.set()
        if feeder.is_alive():
            feeder.join()
        done = [r.done.wait(timeout=600) for r in reqs]
        eng.stop()
        shutil.rmtree(tmp or Path(directory) / f"step_{2:09d}",
                      ignore_errors=True)
    dropped = sum(1 for r, ok in zip(reqs, done)
                  if not ok or r.out is None or len(r.out) != max_new)
    got = [list(map(int, r.out)) if r.out is not None else []
           for r in reqs]
    toks = _hold_tokens(cfg, params, dev, prompts, max_new, got,
                        near_tie_rel)
    out["requests"] = len(reqs)
    out["decode_captures"] = eng._decode_paged.stats.captures
    check(out.get("decoded_since_stage", False)
          and out.get("unfinished_at_swap", 0) >= 1,
          f"the swap met decode traffic ({out.get('unfinished_at_swap')} "
          f"requests unfinished, {out.get('decoding_slots_at_swap')} slots "
          f"decoding)")
    check(out.get("landed", False), "checkpoint-staged hot-swap landed")
    check(out.get("rejected", False),
          "corrupted checkpoint rejected at staging (CheckpointCorrupt)")
    check(out.get("rejected_leaf") == 0,
          f"the rejection names the corrupted leaf (0, got "
          f"{out.get('rejected_leaf')})")
    check(out.get("epoch_unchanged_after_reject", False),
          "rejected staging never bumped the epoch")
    check(dropped == 0 and toks["ok"],
          f"staged swaps dropped nothing, tokens == {toks['oracle']} "
          f"({len(reqs)} requests)")
    return {**out, "dropped": dropped,
            "tokens_exact": toks["tokens_exact"], "tokens": toks}


def bench_bounded_drain(cfg, params, dev, max_new: int,
                        near_tie_rel=None) -> dict:
    prompts = _prompts(2)
    eng = _engine(cfg, params, dev, drain_max_wait_s=0.2)
    out: dict = {}

    def mid():
        # wedged reader: device lease published, holder gone, no release
        eng.store.leases.rearm()
        granted = eng.store.leases.acquire(
            torch.tensor([881], dtype=torch.int32, device=dev))
        assert int(granted[0]) == 1
        t0 = time.perf_counter()
        out["landed"] = eng.hot_swap(params)
        out["degraded_swap_s"] = time.perf_counter() - t0

    got, dropped, _ = _serve_with(eng, prompts, max_new, mid=mid)
    toks = _hold_tokens(cfg, params, dev, prompts, max_new, got,
                        near_tie_rel)
    st = eng.lock_stats()
    check(out.get("landed", False),
          "swap landed after DrainTimeout + stuck-lane scrub")
    check(st["device_leases"]["drain_timeouts"] >= 1,
          "bounded drain hit its deadline (typed DrainTimeout)")
    check(st["device_leases"]["lane_scrubs"] >= 1,
          "stuck lane was scrubbed + value regenerated")
    check(dropped == 0, f"0 dropped requests through degradation "
                        f"(got {dropped})")
    check(toks["ok"], f"tokens through degradation == {toks['oracle']}")
    check(eng.kv_pool.free_count() == N_PAGES, "all pages reclaimed")
    table_live = _table_live(eng)
    check(table_live == 0, f"no stale table lanes (got {table_live})")
    return {**out, "dropped": dropped,
            "tokens_exact": toks["tokens_exact"], "tokens": toks,
            "drain_max_wait_s": eng.ecfg.drain_max_wait_s,
            "drain_timeouts": st["device_leases"]["drain_timeouts"],
            "lane_scrubs": st["device_leases"]["lane_scrubs"],
            "swap_retries": st["engine"]["swap_retries"]}


def run(cfg=None, params=None, device=None, *, smoke: bool = False,
        tokens: int = 8, directory: Optional[str] = None,
        near_tie_rel: Optional[float] = None) -> dict:
    """Every section on ``device`` (default: the CUDA card) with the
    model ``cfg``/``params`` (default: the llama3.2-1b smoke config,
    parameters from seed 0); -> the record, whose ``failures`` lists every
    check that did not hold.  ``directory``: as for
    :func:`bench_staged_swap`; ``near_tie_rel``: as in the module
    docstring."""
    from .. import configs
    from ..models import model as M

    dev = resolve(device)
    if cfg is None:
        cfg = configs.get_smoke("llama3.2-1b")
        params = M.init_params(0, cfg, device=dev)
    max_new = tokens if not smoke else 4
    FAILURES.clear()
    rec = {
        "bench": "hotswap",
        "mode": "smoke" if smoke else "full",
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "torch": torch.__version__,
        "model": cfg.name,
        "swaps_under_traffic": bench_swaps_under_traffic(
            cfg, params, dev, max_new, n_req=3 if smoke else 8,
            n_swaps=2 if smoke else 8, near_tie_rel=near_tie_rel),
        "staged_swap": bench_staged_swap(cfg, params, dev, max_new,
                                         directory, near_tie_rel),
        "bounded_drain": bench_bounded_drain(cfg, params, dev, max_new,
                                             near_tie_rel),
    }
    rec["failures"] = list(FAILURES)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="fast mode: fewer requests and swaps")
    ap.add_argument("--tokens", type=int, default=8,
                    help="generated tokens per request")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="output JSON path")
    args = ap.parse_args(argv)
    rec = run(device=args.device, smoke=args.smoke, tokens=args.tokens)
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1))
        print(f"wrote {args.out}", flush=True)
    print(json.dumps({k: rec[k] for k in ("swaps_under_traffic",
                                          "bounded_drain")}, indent=1))
    if rec["failures"]:
        print(f"FAILED: {rec['failures']}", file=sys.stderr)
        return 1
    print("hotswap bench OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
