"""Scheduler + paged-attention benchmark.

The port of ``benchmarks/scheduler.py``.  Sections (all but throughput
exit nonzero on a mismatch or a lost guarantee):

* ``correctness``: the decode kernel K5 (``ops.paged_attention``) against
  its plain version ``ref.paged_attn_ref`` at the reference's shape
  (exact on the CPU, where the wrapper runs that plain version; 1e-5
  absolute on the card, ROADMAP R3), against full-softmax attention over
  the densely gathered pages (1e-5), and the inactive row exactly 0.
* ``equivalence``: a scheduler-driven ``ServingEngine`` run (paged data
  plane, chunked prefill) against the dense-cache decode loop, token for
  token, and every page reclaimed.
* ``transfers``: the step's lease batch (KV stripe leases and the
  model-epoch lease, acquire and release) under the sync gate
  (``smoke.sync_gate``, the counterpart of ``jax.transfer_guard
  ("disallow")``); in place of the reference's lint of the decode step's
  compiled HLO, one paged decode step under the same gate.  Both read
  "inactive" on the CPU.
* ``mesh2d``: the scheduler engine on ``repro``'s 2D dry-run topology's
  axes (``"pod", "data", "model"``), token for token against the dense
  decode loop while the updater hot-swaps the weights (identity swaps).
  The mesh is ``(1, 1, 1)`` in smoke mode and on a world of fewer than 8
  ranks (a world of one rank starts here when none runs: NCCL on the
  card, gloo on the CPU), and ``(2, 2, 2)`` on a world of 8 ranks, where
  the data axes' product (4) divides ``max_slots`` and the paged steps
  shard their rows; every rank then runs this section with the same
  requests.  That world runs on the CPU over gloo: on CUDA the engine
  refuses a mesh of more than one rank (ROADMAP R16).
* ``throughput`` (full mode): the handler engine and the scheduler engine
  at ``max_slots`` 1, 2, 4 and 8 (the admission sweep), on its graphed
  steps and on the bare ones, each run ``windows`` times in turns;
  tokens/s and the decode p50/p99 as median, least and largest.

Tokens: with ``near_tie_rel`` (a full-width model in bf16, ROADMAP R12)
the engine's tokens stand, teacher-forced, within ``near_tie_rel * max
|logit|`` of the dense loop's best at every step instead of equal to it.

    PYTHONPATH=src python -m repro_torch.benchmarks.scheduler [--smoke]
        [--tokens 8] [--device cpu] [--windows N] [--out PATH]

Runs on the CUDA card unless ``--device cpu``, on the llama3.2-1b smoke
config with parameters from seed 0; :func:`run` takes any configuration
and parameters (``chip_smoke.py`` passes full width).  Writes its JSON
record only to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..device import resolve
from ..kernels import ops as K
from ..kernels import ref as R
from ..models.common import decode_attention
from ..serving.engine import Request, ServingEngine
from ..serving.scheduler import SchedulerConfig
from .smoke import (FAILURES, check, eager_steps, hold_tokens, spread, sync,
                    sync_gate, timeit)

N_PAGES = 128
SWEEP_SLOTS = (1, 2, 4, 8)


def _sched(max_slots=4):
    return SchedulerConfig(max_slots=max_slots, page_size=8, max_seq=64,
                           prefill_chunk=8, prefill_rows=2, token_budget=16)


def _run_engine(eng, prompts, max_new):
    """Submit every prompt at once (starting the engine unless it runs);
    -> (outputs, wall s, dropped)."""
    if not eng._threads:
        eng.start()
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = [r.done.wait(timeout=600) for r in reqs]
    wall = time.perf_counter() - t0
    eng.stop()
    dropped = sum(1 for r, ok in zip(reqs, done)
                  if not ok or r.out is None or len(r.out) != max_new)
    return ([list(map(int, r.out)) if r.out is not None else []
             for r in reqs], wall, dropped)


# ---------------------------------------------------------------------------
# Sections
# ---------------------------------------------------------------------------


def correctness_case():
    """The reference's K5 case (numpy seed 0): float32 q and pages, six
    rows of 1-5 pages with random lengths, row 2 inactive.  -> numpy (q,
    k_pages, v_pages, page_idx, cache_len)."""
    rng = np.random.default_rng(0)
    b, h, kvh, hd, n_pages, ps, lanes = 6, 8, 2, 16, 64, 8, 5
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    kp = rng.normal(size=(n_pages, ps, kvh, hd)).astype(np.float32)
    vp = rng.normal(size=(n_pages, ps, kvh, hd)).astype(np.float32)
    page_idx = np.full((b, lanes), -1, np.int32)
    cache_len = np.zeros((b,), np.int32)
    perm = rng.permutation(n_pages)
    off = 0
    for i in range(b):
        npg = int(rng.integers(1, lanes + 1))
        page_idx[i, :npg] = perm[off:off + npg]
        off += npg
        cache_len[i] = int(rng.integers(1, npg * ps + 1))
    cache_len[2] = 0
    return q, kp, vp, page_idx, cache_len


def bench_correctness(dev) -> dict:
    """K5 against its plain version and dense attention, at the
    reference's shape and inputs."""
    q, kp, vp, page_idx, cache_len = correctness_case()
    b, h, hd = q.shape
    n_pages, ps, kvh, _ = kp.shape
    lanes = page_idx.shape[1]
    t = [torch.as_tensor(x).to(dev) for x in (q, kp, vp, page_idx,
                                              cache_len)]
    out_k = K.paged_attention(*t).cpu()
    out_r = R.paged_attn_ref(*t).cpu()
    # the CPU wrapper IS the plain version; the card's kernel is held to
    # it at float32 tolerance (ROADMAP R3)
    tol = 0.0 if dev.type == "cpu" else 1e-5
    err_ref = float((out_k - out_r).abs().max())
    check(err_ref <= tol, f"paged_attention == paged_attn_ref (max abs "
                          f"{err_ref:.2e}, limit {tol:g})")
    inactive_zero = bool((out_k[2] == 0).all())
    check(inactive_zero, "inactive slot (cache_len 0) emits zeros")

    kd = np.zeros((b, lanes * ps, kvh, hd), np.float32)
    vd = np.zeros((b, lanes * ps, kvh, hd), np.float32)
    for i in range(b):
        for p in range(lanes):
            if page_idx[i, p] >= 0:
                kd[i, p * ps:(p + 1) * ps] = kp[page_idx[i, p]]
                vd[i, p * ps:(p + 1) * ps] = vp[page_idx[i, p]]
    live = torch.as_tensor(cache_len > 0)
    dense = decode_attention(torch.as_tensor(q)[:, None],
                             torch.as_tensor(kd), torch.as_tensor(vd),
                             torch.as_tensor(np.maximum(cache_len, 1)))[:, 0]
    err_dense = float((out_k[live] - dense[live]).abs().max())
    check(err_dense <= 1e-5, f"paged_attention ~= dense full-softmax "
                             f"attention (max abs {err_dense:.2e})")
    return {"shape": {"b": b, "h": h, "kvh": kvh, "hd": hd,
                      "n_pages": n_pages, "page_size": ps, "lanes": lanes},
            "max_abs_err_vs_ref": err_ref, "tolerance_vs_ref": tol,
            "max_abs_err_vs_dense": err_dense,
            "inactive_row_zero": inactive_zero}


def bench_equivalence(cfg, params, dev, max_new: int,
                      near_tie_rel: Optional[float] = None) -> dict:
    """Scheduler-driven paged decode == the dense decode loop."""
    prompts = [np.arange(1, 7, dtype=np.int32) + 2 * i for i in range(3)]
    eng = ServingEngine(cfg, params, n_pages=N_PAGES, scheduler=_sched(),
                        device=dev)
    got, _, dropped = _run_engine(eng, prompts, max_new)
    toks = hold_tokens(cfg, params, dev, prompts, got, max_new,
                       near_tie_rel)
    check(dropped == 0 and toks["ok"],
          f"scheduler paged decode == {toks['oracle']} (token-for-token)")
    free = eng.kv_pool.free_count()
    check(free == N_PAGES, f"all pages reclaimed ({free}/{N_PAGES})")
    return {"requests": len(prompts), "max_new": max_new,
            "match": toks["exact"], "tokens": got, "hold": toks,
            "free_after": free}


def bench_transfers(cfg, params, dev) -> dict:
    """The step's lease batch, both directions, and one paged decode step
    dispatched inside it, each under the sync gate."""
    sc = SchedulerConfig(max_slots=4, page_size=8, max_seq=64)
    eng = ServingEngine(cfg, params, n_pages=N_PAGES, scheduler=sc,
                        device=dev)
    rid_dev = torch.arange(sc.max_slots, dtype=torch.int32, device=dev)

    def lease_roundtrip():
        ptok, _ = eng.pages.read_batch(rid_dev)
        try:
            rtok, _, _ = eng.store.read_batch(rid_dev)
            eng.store.done_read_batch(rtok, rid_dev)
        finally:
            eng.pages.done_read_batch(ptok)

    lease_roundtrip()                      # warm-up, rearm
    lease_gate = sync_gate(dev, lease_roundtrip)

    cur = torch.zeros((sc.max_slots, 1), dtype=torch.int32, device=dev)
    clen = torch.ones((sc.max_slots,), dtype=torch.int32, device=dev)
    ptbl = torch.full((sc.max_slots, sc.lanes), -1, dtype=torch.int32,
                      device=dev)

    def decode_step():
        eng._decode_paged(eng.store.params, eng._pages_kv, cur, clen, ptbl)

    decode_step()                          # warm-up
    decode_step()                          # on the card: the capture
    step_gate = sync_gate(dev, decode_step)  # on the card: a replay
    for gate, what in ((lease_gate, "step lease batch"),
                       (step_gate, "lease-held paged decode step")):
        if gate != "inactive":
            check(gate == "passed", f"{what} runs under the sync gate "
                                    f"(no host-device sync)")

    def timed_pair():
        lease_roundtrip()
        sync(dev)

    pair_s = timeit(timed_pair, 8)
    return {"lease_sync_gate": lease_gate,
            "decode_step_sync_gate": step_gate,
            "lease_roundtrip_us": pair_s * 1e6}


def mesh2d(smoke: bool, dev):
    """``repro``'s ``mesh2d``: (1, 1, 1) in smoke mode or on fewer than 8
    ranks, else (2, 2, 2) over the first 8 (the world must hold exactly
    8 then)."""
    import torch.distributed as dist

    from ..launch.mesh import make_mesh
    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = (1, 1, 1) if smoke or world < 8 else (2, 2, 2)
    return make_mesh(shape, ("pod", "data", "model"), device=dev)


def bench_mesh2d(cfg, params, dev, smoke: bool, max_new: int,
                 near_tie_rel: Optional[float] = None) -> dict:
    """Scheduler-driven decode on the 2D dry-run topology's axis layout."""
    import math

    from ..dist.sharding import MeshRules
    from ..launch.mesh import local_world

    with local_world(dev):
        mesh = mesh2d(smoke, dev)
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        prompts = [np.arange(1, 7, dtype=np.int32) + i for i in range(4)]
        sc = _sched()
        eng = ServingEngine(cfg, params, n_pages=N_PAGES, scheduler=sc,
                            device=dev, mesh=mesh, rules=MeshRules())
        eng.start(swap_period_s=0.1, perturb=lambda p: p)
        got, wall, dropped = _run_engine(eng, prompts, max_new)
        toks = hold_tokens(cfg, params, dev, prompts, got, max_new,
                           near_tie_rel)
        check(dropped == 0 and toks["ok"],
              f"2D-mesh scheduler run matches {toks['oracle']} (mesh "
              f"{shape})")
        st = eng.lock_stats()
        nb = shape["pod"] * shape["data"]
        return {"mesh": shape, "ranks": math.prod(mesh.shape),
                "match": toks["exact"], "hold": toks, "tokens": got,
                "batch_sharded": nb > 1 and sc.max_slots % nb == 0,
                "weight_swaps": st["engine"]["weight_swaps"],
                "decode_steps": st["engine"]["decode_steps"],
                "wall_s": wall}


def _latency_us(eng) -> dict:
    # the engine keeps its warm-up steps out (obs_warmup_steps)
    h = eng.metrics.histogram("engine.step_ns")
    if not h.count:
        return {}
    return {"decode_p50_us": h.quantile(0.50) / 1e3,
            "decode_p99_us": h.quantile(0.99) / 1e3}


def bench_throughput(cfg, params, dev, max_new: int,
                     windows: int = 1) -> dict:
    """Tokens/s and per-token latency: the handler engine and the
    admission sweep, one of each a window, in turns.  Each sweep point
    runs the engine's path (``max_slots=N``: on the card the steps are
    CUDA graphs) and its eager arm (``eager max_slots=N``: the bare steps,
    ``smoke.eager_steps``) in turns, the order flipped every window."""
    prompts = [np.arange(1, 9, dtype=np.int32) + i for i in range(8)]
    runs = {"legacy_engine": [],
            **{f"{arm}max_slots={s}": [] for s in SWEEP_SLOTS
               for arm in ("", "eager ")}}
    for w in range(windows):
        eng = ServingEngine(cfg, params, handlers=2, max_seq=64,
                            slots_per_handler=4, n_pages=N_PAGES,
                            device=dev)
        outs, wall, dropped = _run_engine(eng, prompts, max_new)
        runs["legacy_engine"].append(
            {"tokens_per_s": sum(map(len, outs)) / wall, "wall_s": wall,
             "dropped": dropped})
        for slots in SWEEP_SLOTS:
            arms = ("", "eager ") if w % 2 == 0 else ("eager ", "")
            for arm in arms:
                eng = ServingEngine(cfg, params, n_pages=N_PAGES,
                                    scheduler=_sched(slots), device=dev)
                if arm:
                    eager_steps(eng)
                outs, wall, dropped = _run_engine(eng, prompts, max_new)
                runs[f"{arm}max_slots={slots}"].append(
                    {"tokens_per_s": sum(map(len, outs)) / wall,
                     "wall_s": wall, "dropped": dropped,
                     "evictions": eng.scheduler.evictions,
                     "pages_charged": eng.stats.pages_charged,
                     "pages_saved": eng.stats.pages_saved,
                     **_latency_us(eng)})
    out = {"windows": windows}
    for name, rs in runs.items():
        dropped = sum(r["dropped"] for r in rs)
        check(dropped == 0, f"throughput {name}: 0 dropped (got {dropped})")
        out[name] = {k: spread(r[k] for r in rs) for k in rs[0]
                     if k != "dropped"}
        out[name]["dropped"] = dropped
    return out


def run(cfg=None, params=None, device=None, *, smoke: bool = False,
        windows: int = 1, tokens: int = 8,
        near_tie_rel: Optional[float] = None, mesh: bool = True) -> dict:
    """Every section on ``device`` (default: the CUDA card) with the model
    ``cfg``/``params`` (default: the llama3.2-1b smoke config, parameters
    from seed 0); throughput (full mode) over ``windows`` rounds; -> the
    record, whose ``failures`` lists every check that did not hold.
    ``mesh=False`` leaves ``mesh2d`` to the caller (``chip_smoke.py``
    runs it in its last phase, apart from the CUDA graphs of the rest)."""
    from .. import configs
    from ..models import model as M

    dev = resolve(device)
    if cfg is None:
        cfg = configs.get_smoke("llama3.2-1b")
        params = M.init_params(0, cfg, device=dev)
    FAILURES.clear()
    rec = {
        "bench": "scheduler",
        "mode": "smoke" if smoke else "full",
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "torch": torch.__version__,
        "model": cfg.name,
        "correctness": bench_correctness(dev),
        "equivalence": bench_equivalence(cfg, params, dev, tokens,
                                         near_tie_rel),
        "transfers": bench_transfers(cfg, params, dev),
    }
    rec["mesh2d"] = bench_mesh2d(cfg, params, dev, smoke, tokens,
                                 near_tie_rel) if mesh else \
        {"run": "by the caller"}
    if not smoke:
        rec["throughput"] = bench_throughput(cfg, params, dev, tokens,
                                             windows)
    rec["failures"] = list(FAILURES)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="fast mode: no throughput sweep")
    ap.add_argument("--tokens", type=int, default=8,
                    help="generated tokens per request")
    ap.add_argument("--windows", type=int, default=1,
                    help="rounds of the throughput sweep, run in turns")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="output JSON path")
    args = ap.parse_args(argv)
    rec = run(device=args.device, smoke=args.smoke, windows=args.windows,
              tokens=args.tokens)
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1))
        print(f"wrote {args.out}", flush=True)
    print(json.dumps({k: rec[k] for k in ("correctness", "transfers",
                                          "mesh2d")}, indent=1))
    if rec["failures"]:
        print(f"FAILED: {rec['failures']}", file=sys.stderr)
        return 1
    print("scheduler bench OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
