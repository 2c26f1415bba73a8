"""The port's ``scheduler`` benchmark twin on the CPU at the smoke config,
with parameters converted from ``repro``'s: its gates hold (K5's plain
version against dense attention, the scheduler engine's tokens against the
dense loop, every page reclaimed, the sync gates recorded as inactive, the
2D-mesh section recorded as not ported), the throughput sweep records its
windows, and the engine's tokens equal ``repro``'s dense decode loop on the
same prompts."""

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
from repro.serving.steps import make_decode_step
from repro_torch import configs as TC
from repro_torch.benchmarks import scheduler as SB
from repro_torch.benchmarks import smoke as SM
from repro_torch.models import model as TM

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def models():
    # float32 compute on both sides: greedy tokens compared across the two
    # packages must not hang on bf16 rounding
    cj = dataclasses.replace(JC.get_smoke("llama3.2-1b"),
                             compute_dtype=jnp.float32)
    ct = dataclasses.replace(TC.get_smoke("llama3.2-1b"),
                             compute_dtype=torch.float32)
    jp = JM.init_params(jax.random.PRNGKey(0), cj)
    tp = TM.from_jax_params(jax.tree.map(np.asarray, jp), ct, device="cpu")
    return cj, ct, jp, tp


def repro_dense_tokens(cfg, params, prompt, max_new):
    """``repro``'s dense-cache greedy loop (the reference benchmarks'
    ``_dense_reference``)."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    decode = jax.jit(make_decode_step(cfg, mesh, MeshRules()))
    caches = JM.init_caches(cfg, 1, 64, dtype=jnp.bfloat16)
    out = []
    cur = jnp.asarray(prompt[:1][None])
    for step in range(len(prompt) - 1 + max_new):
        clen = jnp.full((1,), step + 1, jnp.int32)
        nxt, _, caches = decode(params, caches, cur, clen)
        if step + 1 < len(prompt):
            cur = jnp.asarray(prompt[step + 1:step + 2][None])
        else:
            cur = nxt
            out.append(int(np.asarray(nxt)[0, 0]))
    return out


def test_correctness_gates_and_reference_oracle():
    SM.FAILURES.clear()
    rec = SB.bench_correctness(CPU)
    assert SM.FAILURES == []
    assert rec["max_abs_err_vs_ref"] == 0.0 and rec["inactive_row_zero"]
    assert rec["max_abs_err_vs_dense"] <= 1e-5
    # the plain version on the reference's case against repro's oracle
    case = SB.correctness_case()
    want = np.asarray(jax.jit(JR.paged_attn_ref)(*map(jnp.asarray, case)))
    got = SB.R.paged_attn_ref(*map(torch.as_tensor, case)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_equivalence_tokens_equal_repros_dense_loop(models):
    cj, ct, jp, tp = models
    SM.FAILURES.clear()
    rec = SB.bench_equivalence(ct, tp, CPU, 8)
    assert SM.FAILURES == []
    assert rec["match"] and rec["free_after"] == SB.N_PAGES
    prompts = [np.arange(1, 7, dtype=np.int32) + 2 * i for i in range(3)]
    assert rec["tokens"] == [repro_dense_tokens(cj, jp, p, 8)
                             for p in prompts]


def test_transfers_and_mesh2d_sections():
    cfg = TC.get_smoke("llama3.2-1b")
    params = TM.init_params(0, cfg, device=CPU)
    SM.FAILURES.clear()
    rec = SB.bench_transfers(cfg, params, CPU)
    assert SM.FAILURES == []
    assert rec["lease_sync_gate"] == rec["decode_step_sync_gate"] \
        == "inactive"
    assert rec["lease_roundtrip_us"] > 0
    assert SB.bench_mesh2d() == {"ported": False, "waits_for": "M12"}


def test_throughput_sweep_records_every_window(models):
    _, ct, _, tp = models
    SM.FAILURES.clear()
    rec = SB.bench_throughput(ct, tp, CPU, 4, windows=2)
    assert SM.FAILURES == []
    # each sweep point on the engine's (graphed) steps and on the bare ones
    arms = [f"{arm}max_slots={s}" for s in SB.SWEEP_SLOTS
            for arm in ("", "eager ")]
    assert set(rec) == {"windows", "legacy_engine", *arms}
    for name in ("legacy_engine", "max_slots=1", "max_slots=8",
                 "eager max_slots=1", "eager max_slots=8"):
        tps = rec[name]["tokens_per_s"]
        assert len(tps["readings"]) == 2 and rec[name]["dropped"] == 0
        assert tps["min"] <= tps["median"] <= tps["max"]
    for name in arms:
        sweep = rec[name]
        assert sweep["decode_p50_us"]["median"] > 0
        # 8 prompts of 8 tokens in pages of 8: two pages each, no sharing
        assert sweep["pages_charged"]["readings"] == [16, 16]


def test_near_tie_mode_holds_tokens_by_teacher_forcing(models):
    _, ct, _, tp = models
    SM.FAILURES.clear()
    rec = SB.bench_equivalence(ct, tp, CPU, 4, near_tie_rel=0.05)
    assert SM.FAILURES == []
    assert rec["hold"]["ok"] and rec["hold"]["max_deficit_rel"] <= 0.05


def test_cli_smoke_on_the_cpu(tmp_path):
    out = tmp_path / "scheduler.json"
    assert SB.main(["--smoke", "--device", "cpu", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["failures"] == [] and rec["device"] == "cpu"
    assert rec["mode"] == "smoke" and "throughput" not in rec
