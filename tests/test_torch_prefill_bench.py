"""The port's ``prefill`` benchmark twin on the CPU at the smoke config,
with parameters converted from ``repro``'s: K6's plain version against the
dense gather and ``repro``'s oracles, the shape recorder that stands in for
the reference's HLO lint (it finds the dense KV buffer in the plain path),
and the prefix dedup sweep, whose counts equal ``repro``'s engine's on the
same workload."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro import configs as JC
from repro.dist.sharding import MeshRules
from repro.kernels import ref as JR
from repro.models import model as JM
from repro.serving import engine as JE
from repro.serving import scheduler as JS
from repro_torch import configs as TC
from repro_torch.benchmarks import prefill as PB
from repro_torch.benchmarks import smoke as SM
from repro_torch.models import model as TM

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def models():
    cj = dataclasses.replace(JC.get_smoke("llama3.2-1b"),
                             compute_dtype=jnp.float32)
    ct = dataclasses.replace(TC.get_smoke("llama3.2-1b"),
                             compute_dtype=torch.float32)
    jp = JM.init_params(jax.random.PRNGKey(0), cj)
    tp = TM.from_jax_params(jax.tree.map(np.asarray, jp), ct, device="cpu")
    return cj, ct, jp, tp


def test_correctness_gates_hold():
    SM.FAILURES.clear()
    rec = PB.bench_correctness(CPU)
    assert SM.FAILURES == []
    assert rec["max_abs_err_vs_ref"] == 0.0 and rec["padded_row_zero"]
    assert rec["max_abs_err_vs_dense"] <= 1e-5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_and_dense_versions_match_repros(seed):
    case = PB.chunk_case(np.random.default_rng(seed), CPU)
    jcase = [jnp.asarray(x.numpy()) for x in case]
    for port, ref in ((PB.R.paged_chunk_attn_ref, JR.paged_chunk_attn_ref),
                      (PB.R.paged_chunk_dense_ref,
                       JR.paged_chunk_dense_ref)):
        np.testing.assert_allclose(port(*case).numpy(),
                                   np.asarray(jax.jit(ref)(*jcase)),
                                   atol=1e-5, rtol=0)


def test_shape_recorder_finds_the_dense_buffer_in_the_plain_path():
    SM.FAILURES.clear()
    rec = PB.bench_materialization(CPU)
    assert SM.FAILURES == []
    assert rec["plain_materializes_dense_kv"]
    assert rec["streamed_check"] == "inactive"
    assert rec["dense_buffer"] == "4x32x2x16"
    # the recorder sees what an op returns, and nothing else
    shapes = PB.recorded_shapes(lambda: torch.zeros(3, 5).sum(dim=0))
    assert shapes == {(3, 5), (5,)}


def test_transfers_gate_is_inactive_on_the_cpu():
    assert PB.bench_transfers(CPU) == {"chunk_attn_sync_gate": "inactive"}


def _repro_workload(cj, jp, frac, n_reqs, max_new, prefix_cache):
    """The reference benchmark's ``_run_workload`` through ``repro``'s
    engine: the first shared request alone, then the rest at once."""
    sc = JS.SchedulerConfig(max_slots=4, page_size=4, max_seq=32,
                            prefill_chunk=8, prefill_rows=2,
                            token_budget=16, prefix_cache=prefix_cache)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    eng = JE.ServingEngine(cj, jp, mesh=mesh, rules=MeshRules(),
                           n_pages=256, scheduler=sc)
    eng.start()
    base = np.arange(1, 27, dtype=np.int32)
    n_shared = round(frac * n_reqs)
    reqs = [JE.Request(rid=i, prompt=base if i < n_shared
                       else (base + 29 * (i + 1)) % 199 + 1,
                       max_new=max_new) for i in range(n_reqs)]
    if n_shared:
        eng.submit(reqs[0])
        assert reqs[0].done.wait(timeout=600)
    for r in reqs[1 if n_shared else 0:]:
        eng.submit(r)
    for r in reqs:
        assert r.done.wait(timeout=600)
    eng.stop()
    st = eng.lock_stats()
    pool = st["kv_pool"]
    return {"pages_charged": st["engine"]["pages_charged"],
            "pages_saved": st["engine"]["pages_saved"],
            "cow_copies": st["engine"]["cow_copies"],
            "cached_tokens": st["engine"]["cached_tokens"],
            "prefix_hits": pool.get("prefix_hits", 0),
            "prefix_lookups": pool.get("prefix_lookups", 0),
            "refcount_total_after_drain": pool["refcount_total"],
            "free_after_drain": pool["free"]}


def test_dedup_sweep_counts_equal_repros_engine(models):
    cj, ct, jp, tp = models
    SM.FAILURES.clear()
    sweep = PB.bench_dedup(ct, tp, CPU, 4)
    assert SM.FAILURES == []
    assert sweep["alloc_reduction_90pct"] >= 2.0
    points = {"shared=0%": (0.0, True), "shared=50%": (0.5, True),
              "shared=90%": (0.9, True), "shared=90%_cache_off": (0.9, False)}
    for name, (frac, cache) in points.items():
        want = _repro_workload(cj, jp, frac, 10, 4, cache)
        got = {k: sweep[name][k] for k in want}
        assert got == want, name


def test_timing_records_every_window():
    rec = PB.bench_timing(CPU, windows=2, iters=2)
    assert rec["windows"] == 2 and rec["clock"] == "host"
    for s, lanes in PB.TIMING_SHAPES:
        row = rec[f"S={s},lanes={lanes}"]
        assert len(row["streamed_ms"]["readings"]) == 2
        assert len(row["dense_ms"]["readings"]) == 2


def test_cli_smoke_on_the_cpu(tmp_path):
    out = tmp_path / "prefill.json"
    assert PB.main(["--smoke", "--device", "cpu", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["failures"] == [] and rec["device"] == "cpu"
    assert "timing" not in rec
