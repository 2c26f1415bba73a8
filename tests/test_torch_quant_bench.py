"""The port's ``quant`` benchmark twin on the CPU: its gates hold (int8
pages >= 2x smaller than bf16, K7's plain version inside the error bound,
the round trip within scale/2, the prefix index's collision rate), its
page economics equal those of ``repro``'s page stores at the smoke config
and at full width, and its Zipf replay counts equal the same replay through
``repro``'s ``KVPool``."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.kernels.quant import dequantize_pages as j_dequantize
from repro.kernels.quant import quantize_pages as j_quantize
from repro.models import model as JM
from repro.serving.kv_pool import KVPool as JKVPool
from repro.serving.kv_pool import page_keys as j_page_keys
from repro.serving.loadgen import generate_trace as j_generate_trace
from repro_torch import configs as TC
from repro_torch.benchmarks import quant as QB
from repro_torch.benchmarks import slo as SLO
from repro_torch.benchmarks import smoke as SM

CPU = torch.device("cpu")


def _repro_bytes(cfg):
    """The reference benchmark's ``bench_bytes`` numbers from ``repro``'s
    page stores."""
    n, ps, nl = QB.N_PAGES, QB.PAGE_SIZE, cfg.n_layers
    s16 = JM.init_paged_caches(cfg, n, ps)
    s8 = JM.init_paged_caches(cfg, n, ps, quantized=True)
    kv16 = sum(int(s16[k].nbytes) for k in ("k", "v"))
    kv8 = sum(int(s8[k].nbytes) for k in ("k", "v"))
    scales = sum(int(s8[k].nbytes) for k in ("k_scale", "v_scale"))
    page16, page8 = kv16 // (n * nl), kv8 // (n * nl)
    page8_scaled = (kv8 + scales) // (n * nl)
    user_pages = -(-QB.MAX_SEQ // ps)
    return {"bf16_bytes_per_page_layer": page16,
            "int8_bytes_per_page_layer": page8,
            "int8_scale_bytes_per_page_layer": page8_scaled - page8,
            "users_per_gb_hbm_bf16": (1 << 30) // (user_pages * nl * page16),
            "users_per_gb_hbm_int8": (1 << 30) // (user_pages * nl
                                                   * page8_scaled)}


@pytest.mark.parametrize("full_width", [False, True],
                         ids=["smoke", "full_width"])
def test_bytes_equal_repros_page_stores(full_width):
    name = "llama3.2-1b"
    tcfg = TC.get(name)[0] if full_width else TC.get_smoke(name)
    jcfg = JC.get(name)[0] if full_width else JC.get_smoke(name)
    SM.FAILURES.clear()
    rec = QB.bench_bytes(tcfg, CPU)
    assert SM.FAILURES == []
    assert rec["page_bytes_ratio_vs_bf16"] >= 2.0
    want = _repro_bytes(jcfg)
    assert {k: rec[k] for k in want} == want


def test_error_gates_hold_and_round_trip_matches_repro():
    SM.FAILURES.clear()
    rec = QB.bench_error(CPU)
    assert SM.FAILURES == []
    assert rec["max_err_vs_quant_oracle"] == 0.0
    assert rec["max_err_vs_fp32_oracle"] < QB.ERR_BOUND
    x = np.random.default_rng(2).standard_normal(
        (32, QB.PAGE_SIZE, 2, 32)).astype(np.float32)
    xq, xs = j_quantize(jnp.asarray(x))
    rt = float(jnp.max(jnp.abs(j_dequantize(xq, xs) - x)))
    assert rec["round_trip_max_err"] == pytest.approx(rt, abs=1e-7)
    assert rec["round_trip_bound"] == pytest.approx(float(jnp.max(xs)) / 2,
                                                    abs=1e-7)


def test_latency_records_every_window():
    rec = QB.bench_latency(CPU, smoke=True, windows=2)
    assert rec["windows"] == 2 and rec["clock"] == "host"
    for name in ("decode_fp32_ms", "decode_quant_ms", "chunk_fp32_ms",
                 "chunk_quant_ms"):
        assert len(rec[name]["readings"]) == 2 and rec[name]["min"] > 0


def _repro_zipf(smoke):
    """The reference benchmark's Zipf replay through ``repro``'s pool."""
    trace = j_generate_trace(SLO.trace_config(smoke))
    pool = JKVPool(QB.N_PAGES)
    inserted = 0
    for tr in trace.requests:
        kh, kl, ln = j_page_keys(tr.prompt, QB.PAGE_SIZE, pad_to=QB.LANES)
        _, n_run, _ = pool.match_prefix(kh, kl, ln)
        n_keys = int(np.sum(ln > 0))
        fresh = list(range(n_run, n_keys))
        pages = pool.allocate(tr.rid, len(fresh)) if fresh else []
        if fresh and not pages:
            continue
        lane_pg = np.full((QB.LANES,), -1, np.int32)
        for lane, pg in zip(fresh, pages):
            lane_pg[lane] = pg
        ins = pool.insert_prefix(tr.rid, kh, kl, ln, lane_pg)
        shared = np.asarray([lane_pg[i] for i in range(n_keys) if ins[i]],
                            np.int32)
        inserted += len(shared)
        if len(shared):
            pool.release_refs(shared)
        pool.reclaim(tr.rid)
    return {"requests": len(trace.requests),
            "prefix_lookups": pool.prefix_lookups,
            "prefix_hits": pool.prefix_hits,
            "prefix_collisions": pool.prefix_collisions,
            "inserted_pages": inserted}


def test_zipf_replay_counts_equal_repros_pool():
    SM.FAILURES.clear()
    rec = QB.bench_zipf_collisions(CPU, smoke=True)
    assert SM.FAILURES == []
    assert rec["collision_rate"] < 0.05
    want = _repro_zipf(smoke=True)
    assert {k: rec[k] for k in want} == want


def test_cli_smoke_on_the_cpu(tmp_path):
    out = tmp_path / "quant.json"
    assert QB.main(["--smoke", "--device", "cpu", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["failures"] == [] and rec["device"] == "cpu"
    assert set(rec["bytes"]) == {"llama3.2-smoke", "llama3.2-1b"}
