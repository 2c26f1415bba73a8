"""Quantized paged-KV benchmark: what the int8 page store buys and costs.

The port of ``benchmarks/quant.py``.  Four sections, each a gate (nonzero
exit on loss) but latency, which is recorded:

* ``bytes``: the economics.  K+V bytes a (page, layer) of the int8 store
  against the bf16 store must be >= 2x smaller (float32 and the per-page
  scale overhead reported beside), and the users a GB of device memory
  holds at the serving geometry; for the llama3.2-1b smoke config and its
  full published width.
* ``error``: the quantized decode kernel K7 (``ops.paged_attention_quant``)
  against the quantized plain version ``ref.paged_attn_quant_ref`` (< 1e-5)
  and inside the documented attention-output bound of the float32 plain
  version on the pages before quantization (< 0.05 at unit-variance
  inputs); the per-element round trip <= scale/2.
* ``latency``: K5 against K7 and K6 against K8 at the reference's shapes,
  ``windows`` readings of each in turns, medians (CUDA events on the
  card, ms a call).
* ``zipf``: the ``slo`` benchmark's seeded Zipf trace replayed through the
  pool's prefix index (match, allocate, insert, release: the engine's
  admission order) must show a collision rate < 0.05.

    PYTHONPATH=src python -m repro_torch.benchmarks.quant [--smoke]
        [--device cpu] [--windows N] [--out PATH]

Runs on the CUDA card unless ``--device cpu``.  Writes its JSON record
only to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from .. import configs
from ..device import resolve
from ..kernels import ops as K
from ..kernels import ref as R
from ..kernels.quant import dequantize_pages, quantize_pages
from ..models import model as M
from ..serving.kv_pool import KVPool, page_keys
from ..serving.loadgen import generate_trace
from .slo import trace_config
from .smoke import FAILURES, check, device_ms, spread

# the slo benchmark's serving geometry: the bytes and zipf sections
# measure the same pool the SLO engine runs
N_PAGES, PAGE_SIZE, MAX_SEQ, LANES = 128, 8, 64, 8
ERR_BOUND = 0.05      # gated attention-output envelope, unit-variance in


# ---------------------------------------------------------------------------
# Bytes: page layout economics
# ---------------------------------------------------------------------------


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def bench_bytes(cfg, dev) -> dict:
    nl = cfg.n_layers
    store16 = M.init_paged_caches(cfg, N_PAGES, PAGE_SIZE, device=dev)
    store8 = M.init_paged_caches(cfg, N_PAGES, PAGE_SIZE, quantized=True,
                                 device=dev)
    kv16 = sum(_nbytes(store16[n]) for n in ("k", "v"))
    kv8 = sum(_nbytes(store8[n]) for n in ("k", "v"))
    scales = sum(_nbytes(store8[n]) for n in ("k_scale", "v_scale"))
    # per (page, layer): K+V content plus, for the int8 store, its scales
    page16 = kv16 // (N_PAGES * nl)
    page8 = kv8 // (N_PAGES * nl)
    page8_scaled = (kv8 + scales) // (N_PAGES * nl)
    ratio = page16 / page8
    check(ratio >= 2.0,
          f"{cfg.name}: int8 KV bytes/page >= 2x smaller than bf16 "
          f"({page16} -> {page8}, ratio {ratio:.2f})")
    # users per GB at the serving geometry (whole store and scales)
    per_user_pages = -(-MAX_SEQ // PAGE_SIZE)
    user16 = per_user_pages * nl * page16
    user8 = per_user_pages * nl * page8_scaled
    gb = 1 << 30
    return {
        "model": cfg.name, "page_size": PAGE_SIZE,
        "kv_heads": cfg.n_kv_heads, "head_dim": cfg.hd, "layers": nl,
        "bf16_bytes_per_page_layer": page16,
        "int8_bytes_per_page_layer": page8,
        "int8_scale_bytes_per_page_layer": page8_scaled - page8,
        "fp32_bytes_per_page_layer": page16 * 2,
        "page_bytes_ratio_vs_bf16": ratio,
        "page_bytes_ratio_vs_fp32": page16 * 2 / page8,
        "store_bytes_ratio_incl_scales": kv16 / (kv8 + scales),
        "users_per_gb_hbm_bf16": gb // user16,
        "users_per_gb_hbm_int8": gb // user8,
        "users_per_hbm_byte_gain": user16 / user8,
    }


# ---------------------------------------------------------------------------
# Error: the quantized kernel inside the documented bound
# ---------------------------------------------------------------------------


def decode_case(seed, dev, b=8, h=4, kvh=2, hd=32, ps=PAGE_SIZE,
                lanes=LANES, n_pages=64):
    """The reference's ``_decode_case``: float32 q and pages, every row a
    random number of pages with a partial last one.  -> (q, k, v,
    page_idx, cache_len) on ``dev``."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((b, h, hd)).astype(np.float32)
    k = r.standard_normal((n_pages, ps, kvh, hd)).astype(np.float32)
    v = r.standard_normal((n_pages, ps, kvh, hd)).astype(np.float32)
    pi = np.full((b, lanes), -1, np.int32)
    cl = np.zeros((b,), np.int32)
    perm = r.permutation(n_pages)
    off = 0
    for i in range(b):
        used = int(r.integers(1, lanes + 1))
        pi[i, :used] = perm[off:off + used]
        off += used
        cl[i] = int(r.integers((used - 1) * ps + 1, used * ps + 1))
    return tuple(torch.as_tensor(x).to(dev) for x in (q, k, v, pi, cl))


def bench_error(dev) -> dict:
    worst_vs_fp32 = worst_vs_qref = 0.0
    for seed in (0, 1):
        q, k, v, pi, cl = decode_case(seed, dev)
        kq, ks = quantize_pages(k)
        vq, vs = quantize_pages(v)
        out = K.paged_attention_quant(q, kq, vq, ks, vs, pi, cl)
        qref = R.paged_attn_quant_ref(q, kq, vq, ks, vs, pi, cl)
        ref32 = R.paged_attn_ref(q, k, v, pi, cl)
        worst_vs_qref = max(worst_vs_qref, float((out - qref).abs().max()))
        worst_vs_fp32 = max(worst_vs_fp32, float((out - ref32).abs().max()))
    # per-element round trip: <= scale/2 by construction
    r = np.random.default_rng(2)
    x = torch.as_tensor(r.standard_normal((32, PAGE_SIZE, 2, 32))
                        .astype(np.float32)).to(dev)
    xq, xs = quantize_pages(x)
    rt = float((dequantize_pages(xq, xs) - x).abs().max())
    rt_bound = float(xs.max()) / 2
    check(worst_vs_qref < 1e-5,
          f"quant kernel == quant oracle to float tolerance "
          f"({worst_vs_qref:.2e})")
    check(worst_vs_fp32 < ERR_BOUND,
          f"quant attention within {ERR_BOUND} of fp32 oracle "
          f"({worst_vs_fp32:.4f})")
    check(rt <= rt_bound + 1e-7,
          f"round-trip error <= scale/2 ({rt:.4f} vs {rt_bound:.4f})")
    return {"max_err_vs_quant_oracle": worst_vs_qref,
            "max_err_vs_fp32_oracle": worst_vs_fp32,
            "err_bound": ERR_BOUND,
            "round_trip_max_err": rt, "round_trip_bound": rt_bound,
            "error_within_bound": worst_vs_fp32 < ERR_BOUND}


# ---------------------------------------------------------------------------
# Latency: quantized vs float32 kernel step time
# ---------------------------------------------------------------------------


def bench_latency(dev, smoke: bool, windows: int = 1) -> dict:
    """K5, K7, K6, K8 at the reference's shapes: per window one reading of
    each, in turns (ms a call, the mean of ``iters`` calls)."""
    iters = 3 if smoke else 100
    q, k, v, pi, cl = decode_case(3, dev)
    kq, ks = quantize_pages(k)
    vq, vs = quantize_pages(v)
    r = np.random.default_rng(4)
    qc = torch.as_tensor(r.standard_normal((4, 8, 4, 32))
                         .astype(np.float32)).to(dev)
    nl = torch.clamp(cl[:4], max=8)
    calls = {
        "decode_fp32_ms": lambda: K.paged_attention(q, k, v, pi, cl),
        "decode_quant_ms": lambda: K.paged_attention_quant(
            q, kq, vq, ks, vs, pi, cl),
        "chunk_fp32_ms": lambda: K.paged_chunk_attention(
            qc, k, v, pi[:4], cl[:4], nl),
        "chunk_quant_ms": lambda: K.paged_chunk_attention_quant(
            qc, kq, vq, ks, vs, pi[:4], cl[:4], nl),
    }
    readings = {name: [] for name in calls}
    for _ in range(windows):
        for name, fn in calls.items():
            readings[name].append(device_ms(dev, fn, iters))
    out = {"windows": windows, "iters": iters,
           "clock": "cuda events" if dev.type == "cuda" else "host",
           **{name: spread(xs) for name, xs in readings.items()}}
    for kind in ("decode", "chunk"):
        out[f"{kind}_quant_speedup"] = (out[f"{kind}_fp32_ms"]["median"]
                                        / out[f"{kind}_quant_ms"]["median"])
    return out


# ---------------------------------------------------------------------------
# Zipf: the prefix-index collision gate on the slo key stream
# ---------------------------------------------------------------------------


def bench_zipf_collisions(dev, smoke: bool) -> dict:
    # the slo benchmark's trace (its keys: the reference's vocabulary)
    trace = generate_trace(trace_config(smoke))
    pool = KVPool(N_PAGES, device=dev)
    inserted = 0
    for tr in trace.requests:
        kh, kl, ln = page_keys(tr.prompt, PAGE_SIZE, pad_to=LANES)
        _, n_run, _ = pool.match_prefix(kh, kl, ln)
        # publish the tail the hit run does not cover (admission order:
        # hit lanes ride by reference, fresh lanes allocate and insert)
        n_keys = int(np.sum(ln > 0))
        fresh = list(range(n_run, n_keys))
        pages = pool.allocate(tr.rid, len(fresh)) if fresh else []
        if fresh and not pages:
            continue                     # pool exhausted even after evicting
        lane_pg = np.full((LANES,), -1, np.int32)
        for lane, pg in zip(fresh, pages):
            lane_pg[lane] = pg
        ins = pool.insert_prefix(tr.rid, kh, kl, ln, lane_pg)
        shared = np.asarray([lane_pg[i] for i in range(n_keys)
                             if ins[i]], np.int32)
        inserted += len(shared)
        if len(shared):                  # request done: refs drop to 0,
            pool.release_refs(shared)    # entries stay cached in the map
        pool.reclaim(tr.rid)             # pages not converted go free
    lookups = pool.prefix_lookups
    colls = pool.prefix_collisions
    rate = colls / max(lookups, 1)
    check(lookups >= len(trace.requests),
          f"zipf replay exercised the index ({lookups} lookups)")
    check(rate < 0.05,
          f"set-associative prefix index collision rate < 0.05 on the "
          f"slo zipf trace (got {rate:.4f}; direct-mapped measured 0.47)")
    return {"requests": len(trace.requests),
            "prefix_lookups": lookups, "prefix_hits": pool.prefix_hits,
            "prefix_collisions": colls, "collision_rate": rate,
            "collision_rate_ok": rate < 0.05, "map_ways": pool.ways,
            "inserted_pages": inserted}


def run(cfg=None, params=None, device=None, *, smoke: bool = False,
        windows: int = 1) -> dict:
    """Every section on ``device`` (default: the CUDA card); latency over
    ``windows`` readings; -> the record, whose ``failures`` lists every
    check that did not hold.  No model runs, so ``params`` is not read
    (the serving twins share one signature): ``bytes`` sizes the page
    stores of the llama3.2-1b smoke config and of ``cfg`` (default:
    llama3.2-1b at its published width), keyed by their names."""
    dev = resolve(device)
    if cfg is None:
        cfg = configs.get("llama3.2-1b")[0]
    FAILURES.clear()
    rec = {
        "bench": "quant",
        "mode": "smoke" if smoke else "full",
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "torch": torch.__version__,
        "bytes": {c.name: bench_bytes(c, dev)
                  for c in (configs.get_smoke("llama3.2-1b"), cfg)},
        "error": bench_error(dev),
        "latency": bench_latency(dev, smoke, windows),
        "zipf": bench_zipf_collisions(dev, smoke),
    }
    rec["failures"] = list(FAILURES)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="fast mode: fewer repeats, shorter trace")
    ap.add_argument("--windows", type=int, default=1,
                    help="latency readings of each kernel, in turns")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="output JSON path")
    args = ap.parse_args(argv)
    rec = run(device=args.device, smoke=args.smoke, windows=args.windows)
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1))
        print(f"wrote {args.out}", flush=True)
    print(json.dumps({k: rec[k] for k in ("bytes", "error", "latency",
                                          "zipf")}, indent=1))
    if rec["failures"]:
        print(f"FAILED: {rec['failures']}", file=sys.stderr)
        return 1
    print("quant bench OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
