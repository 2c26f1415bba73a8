"""The port's training slice end to end on the CPU: a seeded run through
``data.make_batches`` -> ``train_step`` -> ``CheckpointManager`` in both
packages, the twins of ``repro``'s training, fault-tolerance and data
tests (tests/test_system.py, tests/test_ft.py, tests/test_models.py), the
gradient compression and elastic helpers against ``repro``'s, and the two
training examples at tiny sizes.

Parameters for the cross-package run come from ``repro``'s init through
``from_jax_params``; float32 compute.  Tolerances: each step's loss within
1e-5 relative of ``repro``'s (the parameters drift apart by float32
rounding, a few ulps a step; observed at most 2.1e-7 over six steps); the int8
compression bit for bit (the same float32 operations, round half to even
on both sides); the data pipeline equal (a verbatim copy); restarts on
the CPU bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro.data import make_batches as j_make_batches
from repro.ft import checkpoint as JCk
from repro.ft.compression import compress_grads_int8 as j_compress
from repro.ft.elastic import remicrobatch as j_remicrobatch
from repro.training import optimizer as JO
from repro.training import train_step as JT
from repro_torch import configs as TC
from repro_torch.core.factory import LockEnv
from repro_torch.data import DataConfig, ShardIndex, make_batches
from repro_torch.ft.checkpoint import (CheckpointManager, latest_step,
                                       load_checkpoint, save_checkpoint,
                                       tree_flatten)
from repro_torch.ft.compression import (compress_grads_int8,
                                        decompress_grads_int8)
from repro_torch.ft.elastic import remicrobatch, reshard_tree
from repro_torch.models import model as TM
from repro_torch.training.optimizer import (OptimizerConfig, adamw_init,
                                            lr_schedule)
from repro_torch.training.train_step import TrainConfig, make_train_step

from torch_train_cases import MESH, RULES, jax_batch, models

LOSS_REL = 1e-5


# ---------------------------------------------------------------------------
# The slice across both packages
# ---------------------------------------------------------------------------


def _jax_run(jp, js, step, data, start, n, mgr=None, save_at=None):
    it = j_make_batches(data, start_step=start)
    losses = []
    with MESH:
        for s in range(start, start + n):
            jp, js, m = step(jp, js, jax_batch(next(it)))
            losses.append(float(m["loss"]))
            if mgr is not None and s + 1 == save_at:
                mgr.save_async(s + 1, {"params": jp, "state": js})
    return jp, js, losses


def _port_run(tp, ts, step, data, start, n, mgr=None, save_at=None):
    it = make_batches(data, start_step=start)
    losses = []
    for s in range(start, start + n):
        tp, ts, m = step(tp, ts, next(it))
        losses.append(float(m["loss"]))
        if mgr is not None and s + 1 == save_at:
            mgr.save_async(s + 1, {"params": tp, "state": ts})
    return tp, ts, losses


def test_seeded_run_matches_repro_through_pipeline_and_checkpoints(tmp_path):
    """Six steps of the smoke llama in each package from the same
    parameters and data, each saving step 3 with its async manager; then
    each package restores step 3 (the port from ``repro``'s checkpoint
    too) and runs steps 4-6 again: every loss trajectory equals
    ``repro``'s straight run within 1e-5."""
    cj, ct, jp, tp = models("llama3.2-1b")
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=6)
    jo, to = JO.OptimizerConfig(**kw), OptimizerConfig(**kw)
    data = DataConfig(vocab=ct.vocab, seq_len=16, global_batch=4)
    with MESH:
        jstep = jax.jit(JT.make_train_step(cj, jo, MESH, RULES,
                                           JT.TrainConfig(remat="none")))
    tstep = make_train_step(ct, to, TrainConfig(remat="none"))
    jmgr = JCk.CheckpointManager(tmp_path / "jax", keep=2)
    tmgr = CheckpointManager(tmp_path / "torch", keep=2)
    _, _, want = _jax_run(jp, JO.adamw_init(jp, jo), jstep, data, 0, 6,
                          jmgr, 3)
    _, _, got = _port_run(tp, adamw_init(tp, to), tstep, data, 0, 6,
                          tmgr, 3)
    jmgr.wait()
    tmgr.wait()
    np.testing.assert_allclose(got, want, rtol=LOSS_REL)
    assert want[-1] < want[0]

    like = {"params": tp, "state": adamw_init(tp, to)}
    for d in ("jax", "torch"):
        assert latest_step(tmp_path / d) == 3
        restored = reshard_tree(load_checkpoint(tmp_path / d, 3, like),
                                like, device="cpu")
        assert int(restored["state"]["step"]) == 3
        _, _, tail = _port_run(restored["params"], restored["state"], tstep,
                               data, 3, 3)
        np.testing.assert_allclose(tail, want[3:], rtol=LOSS_REL)
    restored = JCk.load_checkpoint(tmp_path / "torch", 3, {
        "params": jp, "state": JO.adamw_init(jp, jo)})
    _, _, tail = _jax_run(jax.tree.map(jnp.asarray, restored["params"]),
                          jax.tree.map(jnp.asarray, restored["state"]),
                          jstep, data, 3, 3)
    np.testing.assert_allclose(tail, want[3:], rtol=LOSS_REL)


# ---------------------------------------------------------------------------
# Twins of repro's system, ft and model tests
# ---------------------------------------------------------------------------


def test_training_reduces_loss_on_learnable_data():
    """tests/test_system.py's quickstart contract on the port: the smoke
    llama trains on the synthetic corpus and the loss drops by 0.5."""
    cfg = TC.get_smoke("llama3.2-1b")
    params = TM.init_params(0, cfg, device="cpu")
    opt = OptimizerConfig(lr=3e-3, warmup_steps=10, total_steps=60,
                          schedule="cosine")
    state = adamw_init(params, opt)
    step = make_train_step(cfg, opt, TrainConfig(remat="none"))
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=16)
    it = make_batches(data)
    losses = []
    for _ in range(60):
        params, state, m = step(params, state, next(it))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_wsd_schedule_shape():
    opt = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          schedule="wsd", wsd_decay_frac=0.2)
    lrs = [float(lr_schedule(opt, torch.tensor(s))) for s in
           (0, 5, 10, 50, 79, 80, 90, 100)]
    assert lrs[0] == 0.0
    assert abs(lrs[2] - 1.0) < 1e-6          # warmup done
    assert abs(lrs[3] - 1.0) < 1e-6          # stable phase
    assert abs(lrs[4] - 1.0) < 0.05          # just before decay
    assert lrs[6] < 0.8                      # decaying
    assert lrs[7] < 0.05                     # fully decayed


def _tiny_setup():
    cfg = TC.get_smoke("llama3.2-1b")
    params = TM.init_params(0, cfg, device="cpu")
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0)
    state = adamw_init(params, opt)
    step = make_train_step(cfg, opt, TrainConfig(remat="none"))
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8)
    return params, state, step, data


def test_checkpoint_restart_bit_exact(tmp_path):
    """Train 6 steps straight == train 3, checkpoint, restore, train 3."""
    params, state, step, data = _tiny_setup()
    pA, _, _ = _port_run(params, state, step, data, 0, 6)
    pB, sB, _ = _port_run(params, state, step, data, 0, 3)
    save_checkpoint(tmp_path, 3, {"params": pB, "state": sB})
    assert latest_step(tmp_path) == 3
    like = {"params": pB, "state": sB}
    restored = reshard_tree(load_checkpoint(tmp_path, 3, like), like,
                            device="cpu")
    pC, _, _ = _port_run(restored["params"], restored["state"], step, data,
                         3, 3)
    for a, c in zip(tree_flatten(pA)[0], tree_flatten(pC)[0]):
        assert torch.equal(a, c)


def test_elastic_reshard_roundtrip(tmp_path):
    """A saved tree comes back through ``reshard_tree`` with the values
    and, leaf for leaf, the dtypes of the tree it is placed like (a bf16
    leaf included)."""
    params = TM.init_params(0, TC.get_smoke("llama3.2-1b"), device="cpu")
    params["final_ln"] = params["final_ln"].to(torch.bfloat16)
    save_checkpoint(tmp_path, 7, params)
    placed = reshard_tree(load_checkpoint(tmp_path, 7, params), params,
                          device="cpu")
    for a, b in zip(tree_flatten(params)[0], tree_flatten(placed)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="tree mismatch"):
        reshard_tree({"w": np.zeros(3)}, params, device="cpu")


def test_remicrobatch_elastic_dp_change():
    assert remicrobatch(256, 32, 4096, 4096) >= 1
    m16 = remicrobatch(256, 16, 4096, 4096)
    m32 = remicrobatch(256, 32, 4096, 4096)
    assert m16 >= m32                     # narrower DP -> more microbatches
    assert 256 % m16 == 0 and (256 // m16) % 16 == 0
    for gb, dp, tt, sl in [(256, 16, 4096, 4096), (16, 1, 4096, 32),
                           (96, 3, 512, 128), (8, 8, 1, 4096),
                           (8, 2, 8192, 4096), (1000, 10, 300, 7)]:
        assert remicrobatch(gb, dp, tt, sl) == j_remicrobatch(gb, dp, tt, sl)


def test_int8_error_feedback_unbiased():
    """Accumulated dequantization error stays bounded (error feedback),
    and every step's payload, scale and residual equal ``repro``'s."""
    rng = np.random.default_rng(0)
    g_np = rng.normal(size=(512,)).astype(np.float32)
    g_true = torch.from_numpy(g_np)
    err = torch.zeros_like(g_true)
    jerr = jnp.zeros(g_np.shape, jnp.float32)
    total_sent = torch.zeros_like(g_true)
    total_true = torch.zeros_like(g_true)
    for step in range(50):
        g = g_true * (1.0 + 0.1 * np.sin(step))
        q, scale, err = compress_grads_int8(g, err)
        jq, jscale, jerr = j_compress(jnp.asarray(g.numpy()), jerr)
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(scale) == float(jscale)
        np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
        total_sent = total_sent + decompress_grads_int8(q, scale, 1)
        total_true = total_true + g
    # with feedback, cumulative transmitted ~= cumulative true gradient
    rel = float(torch.linalg.norm(total_sent - total_true)
                / torch.linalg.norm(total_true))
    assert rel < 0.01, rel


def test_data_pipeline_determinism_and_rebalance():
    data = DataConfig(vocab=128, seq_len=8, global_batch=4)
    a = [next(make_batches(data, start_step=s))["tokens"] for s in (0, 1)]
    b0 = list(zip(range(2), make_batches(data, start_step=0)))
    for (s, bb), aa in zip(b0, a):
        np.testing.assert_array_equal(bb["tokens"], aa)
    # learnable structure present: token[t] follows f(token[t-1]) often
    t = a[0]
    follow = (t[:, :-1] * 31 + 7) % data.vocab
    frac = np.mean(follow == t[:, 1:])
    assert frac > 0.3
    # the same batches as repro's pipeline, loader by loader
    from repro.data import DataConfig as JDataConfig
    jdata = JDataConfig(vocab=128, seq_len=8, global_batch=4)
    for loader in range(2):
        mine = make_batches(data, loader=loader, n_loaders=2, start_step=3)
        theirs = j_make_batches(jdata, loader=loader, n_loaders=2,
                                start_step=3)
        for _ in range(3):
            x, y = next(mine), next(theirs)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(x[k], y[k])
    # the writer path: a rebalance under the BRAVO lock moves shards
    idx = ShardIndex(data.n_shards, 4, LockEnv().make("bravo-ba"))
    before = idx.shards_of(3).copy()
    idx.rebalance(3)
    assert idx.epoch == 1 and len(idx.shards_of(3)) == 0
    assert len(before) == data.n_shards // 4
    assert sum(len(idx.shards_of(i)) for i in range(3)) == data.n_shards


def test_full_configs_match_published_sizes():
    """tests/test_models.py's published-size check for hubert-xlarge on
    the port's copy: the count from the meta-device init equals
    ``repro``'s and lies in its range (0.8-1.3 B)."""
    cfg, shapes = TC.get("hubert-xlarge")
    n = cfg.num_params()
    assert 0.8e9 <= n <= 1.3e9
    assert n == JC.get("hubert-xlarge")[0].num_params()
    assert cfg.num_active_params() == n
    assert shapes == ("train_4k", "prefill_32k")


# ---------------------------------------------------------------------------
# The examples
# ---------------------------------------------------------------------------


def test_quickstart_example_trains_and_resumes(tmp_path, capsys):
    from repro_torch.examples import quickstart

    args = ["--device", "cpu", "--ckpt-every", "4", "--layers", "1",
            "--d-model", "32", "--seq", "16", "--batch", "2",
            "--ckpt-dir", str(tmp_path)]
    first = quickstart.main(["--steps", "8"] + args)
    assert np.isfinite(first)
    assert latest_step(tmp_path) == 8
    second = quickstart.main(["--steps", "12"] + args)
    out = capsys.readouterr().out
    assert "resuming from checkpoint step 8" in out
    assert np.isfinite(second) and latest_step(tmp_path) == 12


def test_elastic_restart_example_continues(tmp_path):
    from repro_torch.examples import elastic_restart

    out = elastic_restart.main(["--device", "cpu", "--ckpt-dir",
                                str(tmp_path / "ckpt")])
    assert out["stragglers"] == [3]
    assert out["resumed_from"] == 20 and out["index_epoch"] == 1
    assert len(out["run1"]) == 25 and len(out["run2"]) == 15
    assert np.isfinite(out["run1"] + out["run2"]).all()
    # the restart picks up near where the committed step left off, and
    # the loss keeps falling
    assert abs(out["run2"][0] - out["run1"][20]) < 0.2
    assert out["run2"][-1] < out["run1"][0] - 0.3


@pytest.mark.parametrize("name", ["quickstart", "elastic_restart"])
def test_examples_raise_without_cuda(monkeypatch, tmp_path, name):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reshard_tree({}, {})
