"""Streaming chunk-prefill and prefix-cache benchmark.

The port of ``benchmarks/prefill.py``.  Sections (all but timing exit
nonzero on a mismatch or a lost guarantee):

* ``correctness``: the chunk-prefill kernel K6
  (``ops.paged_chunk_attention``) against its plain version
  ``ref.paged_chunk_attn_ref`` (exact on the CPU, where the wrapper runs
  that plain version; 1e-5 absolute on the card, ROADMAP R3), against the
  dense gather ``ref.paged_chunk_dense_ref`` (1e-5), and the fully padded
  row exactly 0.
* ``materialization``: the counterpart of the reference's HLO shape lint.
  A ``TorchDispatchMode`` records the shape of every tensor an op returns.
  Around K6 on CUDA tensors it must find no dense ``(B, lanes * ps, KVH,
  hd)`` KV buffer; around the plain version, a dense gather by design, it
  must find one (the sanity check that the recorder sees such a buffer).
  On the card the rise of ``torch.cuda.max_memory_allocated`` during K6 is
  recorded beside the dense buffer's bytes.  The streamed check reads
  "inactive" on the CPU, where K6 is the plain version.
* ``transfers``: K6 on device-resident operands under the sync gate
  (``smoke.sync_gate``; inactive on the CPU).
* ``dedup``: the prefix hit-rate sweep, the same scheduler workload at 0,
  50 and 90% shared prompts with the prefix cache on, and at 90% with it
  off.  Page allocations fall >= 2x at 90%, the hit rate rises with the
  shared share, and refcounts and free pages balance after every drain.
* ``timing`` (full mode): K6 against the dense gather at three chunk
  widths, ``windows`` readings in turns, medians (CUDA events on the
  card).

    PYTHONPATH=src python -m repro_torch.benchmarks.prefill [--smoke]
        [--tokens 4] [--device cpu] [--windows N] [--out PATH]

Runs on the CUDA card unless ``--device cpu``, on the llama3.2-1b smoke
config with parameters from seed 0; :func:`run` takes any configuration
and parameters (``chip_smoke.py`` passes full width).  Writes its JSON
record only to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..device import resolve
from ..kernels import ops as K
from ..kernels import ref as R
from ..serving.engine import Request, ServingEngine
from ..serving.scheduler import SchedulerConfig
from .smoke import FAILURES, check, device_ms, spread, sync, sync_gate

TIMING_SHAPES = ((8, 16), (32, 16), (64, 32))     # (chunk width, lanes)


def chunk_case(rng, dev, b=4, s=8, h=8, kvh=2, hd=16, n_pages=64, ps=4,
               lanes=8):
    """The reference's ``_chunk_case``: float32 q and pages, every row but
    the last one with a random chunk at the end of a random length; the
    last row fully padded.  -> (q, k_pages, v_pages, page_idx, cache_len,
    new_lens) on ``dev``."""
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    kp = rng.normal(size=(n_pages, ps, kvh, hd)).astype(np.float32)
    vp = rng.normal(size=(n_pages, ps, kvh, hd)).astype(np.float32)
    page_idx = np.full((b, lanes), -1, np.int32)
    cache_len = np.zeros((b,), np.int32)
    new_lens = np.zeros((b,), np.int32)
    perm = rng.permutation(n_pages)
    off = 0
    for i in range(b - 1):                 # the last row stays fully padded
        nl = int(rng.integers(1, s + 1))
        clen = int(rng.integers(nl, lanes * ps + 1))
        npg = -(-clen // ps)
        page_idx[i, :npg] = perm[off:off + npg]
        off += npg
        cache_len[i] = clen
        new_lens[i] = nl
    return tuple(torch.as_tensor(x).to(dev)
                 for x in (q, kp, vp, page_idx, cache_len, new_lens))


class ShapeRecorder(TorchDispatchMode):
    """Records the shape of every tensor an op returns while active."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.shapes.update(tuple(t.shape) for t in tree_leaves(out)
                           if isinstance(t, torch.Tensor))
        return out


def recorded_shapes(fn) -> set:
    with ShapeRecorder() as rec:
        fn()
    return rec.shapes


# ---------------------------------------------------------------------------
# Sections
# ---------------------------------------------------------------------------


def bench_correctness(dev) -> dict:
    case = chunk_case(np.random.default_rng(0), dev)
    out_k = K.paged_chunk_attention(*case).cpu()
    out_r = R.paged_chunk_attn_ref(*case).cpu()
    dense = R.paged_chunk_dense_ref(*case).cpu()
    tol = 0.0 if dev.type == "cpu" else 1e-5
    err_ref = float((out_k - out_r).abs().max())
    err_dense = float((out_k - dense).abs().max())
    check(err_ref <= tol, f"paged_chunk_attention == paged_chunk_attn_ref "
                          f"(max abs {err_ref:.2e}, limit {tol:g})")
    check(err_dense <= 1e-5, f"paged_chunk_attention ~= dense gather "
                             f"formulation (max abs {err_dense:.2e})")
    padded_zero = bool((out_k[-1] == 0).all())
    check(padded_zero, "fully padded row emits zeros")
    return {"max_abs_err_vs_ref": err_ref, "tolerance_vs_ref": tol,
            "max_abs_err_vs_dense": err_dense,
            "padded_row_zero": padded_zero}


def bench_materialization(dev) -> dict:
    case = chunk_case(np.random.default_rng(1), dev)
    q, kp, _, pi, _, _ = case
    b, lanes = pi.shape
    _, ps, kvh, hd = kp.shape
    dense_kv = (b, lanes * ps, kvh, hd)
    in_plain = dense_kv in recorded_shapes(
        lambda: R.paged_chunk_attn_ref(*case))
    check(in_plain, f"dense path materializes a {dense_kv} KV buffer "
                    f"(sanity)")
    dense_bytes = 2 * int(np.prod(dense_kv)) * kp.element_size()
    rec = {"dense_buffer": "x".join(map(str, dense_kv)),
           "dense_kv_bytes": dense_bytes,
           "plain_materializes_dense_kv": in_plain}
    if dev.type != "cuda":
        rec["streamed_check"] = "inactive"
        return rec
    K.paged_chunk_attention(*case)                 # warm-up: build, plan
    sync(dev)
    shapes = recorded_shapes(lambda: K.paged_chunk_attention(*case))
    sync(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    K.paged_chunk_attention(*case)
    sync(dev)
    rise = torch.cuda.max_memory_allocated(dev) - before
    streamed = dense_kv in shapes
    check(not streamed, f"streamed path runs WITHOUT any {dense_kv} buffer "
                        f"(recorded shapes: {sorted(shapes)})")
    rec.update(streamed_check="active",
               streamed_materializes_dense_kv=streamed,
               streamed_shapes=sorted(shapes),
               streamed_peak_rise_bytes=rise)
    return rec


def bench_transfers(dev) -> dict:
    case = chunk_case(np.random.default_rng(2), dev)

    def step():
        K.paged_chunk_attention(*case)

    step()                                 # warm-up
    gate = sync_gate(dev, step)
    if gate != "inactive":
        check(gate == "passed", "streamed chunk attention runs under the "
                                "sync gate (no host-device sync)")
    return {"chunk_attn_sync_gate": gate}


def _run_workload(cfg, params, dev, shared_frac: float, n_reqs: int,
                  max_new: int, prefix_cache: bool) -> dict:
    """One scheduler run: ``shared_frac`` of the requests use one common
    prompt (system-prompt-heavy traffic), the rest are unique.  The first
    shared request runs alone to warm the cache (its pages stay cached
    and free after drain), then everything else arrives at once."""
    sc = SchedulerConfig(max_slots=4, page_size=4, max_seq=32,
                         prefill_chunk=8, prefill_rows=2, token_budget=16,
                         prefix_cache=prefix_cache)
    eng = ServingEngine(cfg, params, n_pages=256, scheduler=sc, device=dev)
    eng.start()
    # a long common prefix (the system-prompt shape): 26 tokens = 6 full
    # pages + a partial tail the sharers copy on write
    base = np.arange(1, 27, dtype=np.int32)
    n_shared = round(shared_frac * n_reqs)
    reqs = []
    for i in range(n_reqs):
        if i < n_shared:
            prompt = base
        else:
            prompt = (base + 29 * (i + 1)) % 199 + 1   # unique content
        reqs.append(Request(rid=i, prompt=prompt, max_new=max_new))
    done = []
    if n_shared:
        eng.submit(reqs[0])
        done.append(reqs[0].done.wait(timeout=600))
    for r in reqs[1 if n_shared else 0:]:
        eng.submit(r)
    done += [r.done.wait(timeout=600) for r in reqs[1 if n_shared else 0:]]
    eng.stop()
    dropped = sum(1 for r, ok in zip(reqs, done)
                  if not ok or r.out is None or len(r.out) != max_new)
    check(dropped == 0, f"dedup run ({shared_frac:.0%} shared, cache "
                        f"{'on' if prefix_cache else 'off'}): 0 dropped")
    st = eng.lock_stats()
    pool = st["kv_pool"]
    lookups = max(pool.get("prefix_lookups", 0), 1)
    return {"prefix_cache": prefix_cache,
            "pages_charged": st["engine"]["pages_charged"],
            "pages_saved": st["engine"]["pages_saved"],
            "cow_copies": st["engine"]["cow_copies"],
            "cached_tokens": st["engine"]["cached_tokens"],
            "prefix_lookups": pool.get("prefix_lookups", 0),
            "prefix_hits": pool.get("prefix_hits", 0),
            "hit_rate": pool.get("prefix_hits", 0) / lookups,
            "refcount_total_after_drain": pool["refcount_total"],
            "free_after_drain": pool["free"],
            "n_pages": pool["n_pages"]}


def bench_dedup(cfg, params, dev, max_new: int) -> dict:
    """Prefix hit-rate sweep at 0 / 50 / 90% shared prompts; the gates
    ride on the 90% point."""
    n_reqs = 10
    sweep = {}
    for frac in (0.0, 0.5, 0.9):
        on = _run_workload(cfg, params, dev, frac, n_reqs, max_new,
                           prefix_cache=True)
        check(on["refcount_total_after_drain"] == 0,
              f"refcounts balance to zero after drain ({frac:.0%} shared)")
        check(on["free_after_drain"] == on["n_pages"],
              f"all pages returned after drain ({frac:.0%} shared)")
        sweep[f"shared={frac:.0%}"] = on
    off = _run_workload(cfg, params, dev, 0.9, n_reqs, max_new,
                        prefix_cache=False)
    sweep["shared=90%_cache_off"] = off
    on90 = sweep["shared=90%"]
    ratio = off["pages_charged"] / max(on90["pages_charged"], 1)
    check(ratio >= 2.0,
          f"page allocations reduced >= 2x at 90% shared traffic "
          f"({off['pages_charged']} -> {on90['pages_charged']}, "
          f"{ratio:.2f}x)")
    check(on90["hit_rate"] > sweep["shared=0%"]["hit_rate"],
          "hit rate rises with shared traffic")
    sweep["alloc_reduction_90pct"] = ratio
    return sweep


def bench_timing(dev, windows: int = 1, iters: int = 20) -> dict:
    """K6 against the dense gather at three chunk widths: per window one
    reading of each, in turns (ms a call, the mean of ``iters``)."""
    rng = np.random.default_rng(3)
    out = {"windows": windows, "iters": iters,
           "clock": "cuda events" if dev.type == "cuda" else "host"}
    for s, lanes in TIMING_SHAPES:
        case = chunk_case(rng, dev, b=8, s=s, h=8, kvh=2, hd=32,
                          n_pages=8 * lanes + 8, ps=8, lanes=lanes)
        streamed, dense = [], []
        for _ in range(windows):
            streamed.append(device_ms(
                dev, lambda: K.paged_chunk_attention(*case), iters))
            dense.append(device_ms(
                dev, lambda: R.paged_chunk_dense_ref(*case), iters))
        out[f"S={s},lanes={lanes}"] = {"streamed_ms": spread(streamed),
                                       "dense_ms": spread(dense)}
    return out


def run(cfg=None, params=None, device=None, *, smoke: bool = False,
        windows: int = 1, tokens: int = 4) -> dict:
    """Every section on ``device`` (default: the CUDA card) with the model
    ``cfg``/``params`` (default: the llama3.2-1b smoke config, parameters
    from seed 0); timing (full mode) over ``windows`` readings; -> the
    record, whose ``failures`` lists every check that did not hold."""
    from .. import configs
    from ..models import model as M

    dev = resolve(device)
    if cfg is None:
        cfg = configs.get_smoke("llama3.2-1b")
        params = M.init_params(0, cfg, device=dev)
    FAILURES.clear()
    rec = {
        "bench": "prefill",
        "mode": "smoke" if smoke else "full",
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "torch": torch.__version__,
        "model": cfg.name,
        "correctness": bench_correctness(dev),
        "materialization": bench_materialization(dev),
        "transfers": bench_transfers(dev),
        "dedup": bench_dedup(cfg, params, dev, tokens),
    }
    if not smoke:
        rec["timing"] = bench_timing(dev, windows)
    rec["failures"] = list(FAILURES)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="fast mode: no timing sweep")
    ap.add_argument("--tokens", type=int, default=4,
                    help="generated tokens per request in the dedup sweep")
    ap.add_argument("--windows", type=int, default=1,
                    help="timing readings of each shape, in turns")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="output JSON path")
    args = ap.parse_args(argv)
    rec = run(device=args.device, smoke=args.smoke, windows=args.windows,
              tokens=args.tokens)
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1))
        print(f"wrote {args.out}", flush=True)
    print(json.dumps({k: rec[k] for k in ("materialization", "dedup")},
                     indent=1))
    if rec["failures"]:
        print(f"FAILED: {rec['failures']}", file=sys.stderr)
        return 1
    print("prefill bench OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
