"""The port's checkpoint format against ``repro``'s: a checkpoint written by
either package loads in the other bit for bit (float32, int32 and bfloat16
leaves, a nested tree whose insertion order differs from sorted order),
both write the same manifest entries and shard bytes, and the same
corrupted leaf raises ``CheckpointCorrupt`` with the same index in both.
The serving engine's staging never bumps the epoch on a corrupt
checkpoint and lands a good one."""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ft import checkpoint as JCK
from repro_torch.ft import checkpoint as TCK


def _trees():
    """The same tree for both packages, built in insertion order that is
    NOT sorted order (``z`` before ``a``, ``w2`` before ``b``)."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    i32 = rng.integers(-9, 9, (4,)).astype(np.int32)
    bf = rng.standard_normal((2, 7)).astype(np.float32)
    big = rng.standard_normal((64, 33)).astype(np.float32)
    jt = {"z": {"w2": jnp.asarray(f32), "b": jnp.asarray(i32)},
          "a": jnp.asarray(bf, dtype=jnp.bfloat16),
          "m": [jnp.asarray(big), None, jnp.asarray(f32[0])]}
    tt = {"z": {"w2": torch.from_numpy(f32), "b": torch.from_numpy(i32)},
          "a": torch.from_numpy(bf).to(torch.bfloat16),
          "m": [torch.from_numpy(big), None, torch.from_numpy(f32[0])]}
    return jt, tt


def _bytes(x) -> bytes:
    """A leaf's raw bytes, whatever the package (bf16 through 16 bits)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _save_both(tmp_path, max_shard_bytes=1 << 28):
    jt, tt = _trees()
    JCK.save_checkpoint(tmp_path / "jax", 3, jax.tree.map(np.asarray, jt),
                        max_shard_bytes=max_shard_bytes)
    TCK.save_checkpoint(tmp_path / "torch", 3, tt,
                        max_shard_bytes=max_shard_bytes)
    return jt, tt


def test_flatten_orders_leaves_as_jax_does():
    jt, tt = _trees()
    jl = jax.tree_util.tree_leaves(jt)
    tl, treedef = TCK.tree_flatten(tt)
    assert [_bytes(a) for a in tl] == [_bytes(a) for a in jl]
    back = TCK.tree_unflatten(treedef, tl)
    assert list(back) == sorted(tt) and back["m"][1] is None


@pytest.mark.parametrize("max_shard_bytes", [1 << 28, 64])
def test_manifests_and_shards_agree(tmp_path, max_shard_bytes):
    _save_both(tmp_path, max_shard_bytes)
    mj = json.loads((tmp_path / "jax/step_000000003/manifest.json")
                    .read_text())
    mt = json.loads((tmp_path / "torch/step_000000003/manifest.json")
                    .read_text())
    assert mt["leaves"] == mj["leaves"] and mt["shards"] == mj["shards"]
    assert "bfloat16" in [leaf["dtype"] for leaf in mt["leaves"]]
    assert (len(mt["shards"]) == 1) == (max_shard_bytes > 1 << 20)
    for fn in mj["shards"]:
        with np.load(tmp_path / "jax/step_000000003" / fn) as zj, \
                np.load(tmp_path / "torch/step_000000003" / fn) as zt:
            assert sorted(zj.files) == sorted(zt.files)
            for k in zj.files:
                assert zj[k].tobytes() == zt[k].tobytes()
                assert zj[k].dtype.itemsize == zt[k].dtype.itemsize


def test_repro_checkpoint_loads_in_the_port_bit_for_bit(tmp_path):
    jt, tt = _save_both(tmp_path)
    got = TCK.load_checkpoint(tmp_path / "jax", 3, like=tt)
    gl, _ = TCK.tree_flatten(got)
    wl, _ = TCK.tree_flatten(tt)
    assert [g.dtype for g in gl] == [w.dtype for w in wl]
    assert [_bytes(g) for g in gl] == [_bytes(w) for w in wl]
    assert list(got["z"]) == ["b", "w2"] and got["m"][1] is None


def test_port_checkpoint_loads_in_repro_bit_for_bit(tmp_path):
    jt, tt = _save_both(tmp_path)
    got = JCK.load_checkpoint(tmp_path / "torch", 3,
                              like=jax.tree.map(np.asarray, jt))
    gl = jax.tree_util.tree_leaves(got)
    wl = jax.tree_util.tree_leaves(jt)
    assert [_bytes(g) for g in gl] == [_bytes(w) for w in wl]
    assert [g.shape for g in gl] == [w.shape for w in wl]


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("leaf", [0, 2, 4])
def test_corrupt_leaf_raises_with_the_same_index(tmp_path, writer, leaf):
    jt, tt = _save_both(tmp_path, max_shard_bytes=64)
    mf = tmp_path / writer / "step_000000003/manifest.json"
    manifest = json.loads(mf.read_text())
    manifest["leaves"][leaf]["crc32"] ^= 0x5A5A5A5A
    mf.write_text(json.dumps(manifest))
    with pytest.raises(JCK.CheckpointCorrupt) as ej:
        JCK.load_checkpoint(tmp_path / writer, 3,
                            like=jax.tree.map(np.asarray, jt))
    with pytest.raises(TCK.CheckpointCorrupt) as et:
        TCK.load_checkpoint(tmp_path / writer, 3, like=tt)
    assert et.value.leaf == ej.value.leaf == leaf
    assert et.value.shard == ej.value.shard
    # streamed: the leaves before the bad one came through, none after
    seen = []
    with pytest.raises(TCK.CheckpointCorrupt):
        for i, _ in TCK.iter_checkpoint(tmp_path / writer, 3):
            seen.append(i)
    assert seen == list(range(leaf))


def test_tree_mismatch_and_latest_step(tmp_path):
    _, tt = _save_both(tmp_path)
    with pytest.raises(TCK.CheckpointCorrupt, match="tree mismatch"):
        TCK.load_checkpoint(tmp_path / "torch", 3, like={"x": tt["a"]})
    assert TCK.latest_step(tmp_path / "torch") == \
        JCK.latest_step(tmp_path / "torch") == 3
    assert TCK.latest_step(tmp_path / "nothing") is None


def test_manager_saves_async_snapshots_and_keeps_the_newest(tmp_path):
    t = {"w": torch.arange(6, dtype=torch.float32), "s": torch.ones(2)}
    mgr = TCK.CheckpointManager(tmp_path, keep=2)
    for step in range(4):
        mgr.save_async(step, t)
        t["w"].add_(1.0)          # in place, after the snapshot was taken
        mgr.wait()
    assert mgr.status() == (3, None)
    assert sorted(p.name for p in pathlib.Path(tmp_path).iterdir()) == \
        ["step_000000002", "step_000000003"]
    got = TCK.load_checkpoint(tmp_path, 3, like=t)
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.float32) + 3)


def test_staging_rejects_a_corrupt_checkpoint_before_any_epoch_bump(
        tmp_path):
    from repro_torch import configs
    from repro_torch.ft.faults import corrupt_copy
    from repro_torch.models import model as M
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    cfg = configs.get_smoke("llama3.2-1b")
    params = M.init_params(0, cfg, device="cpu")
    eng = ServingEngine(cfg, params, n_pages=16, device="cpu",
                        scheduler=SchedulerConfig(page_size=4, max_seq=16))
    TCK.save_checkpoint(tmp_path, 1, params)
    n_leaves = len(TCK.read_manifest(tmp_path, 1)["leaves"])
    corrupt_copy(tmp_path, 1, 2, leaf=n_leaves - 1)
    revocations = eng.registry.stats()["revocations"]
    with pytest.raises(TCK.CheckpointCorrupt) as e:
        eng.hot_swap(checkpoint=(tmp_path, 2))
    assert e.value.leaf == n_leaves - 1
    assert eng.store.epoch == 0 and eng.store.params is params
    assert eng.registry.stats()["revocations"] == revocations
    assert eng.stats.weight_swaps == 0
    # the good checkpoint lands, leaf for leaf equal, on the engine's device
    assert eng.hot_swap(checkpoint=(tmp_path, 1))
    assert eng.store.epoch == 1 and eng.stats.weight_swaps == 1
    got, _ = TCK.tree_flatten(eng.store.params)
    want, _ = TCK.tree_flatten(params)
    assert all(torch.equal(g, w) and g.dtype == w.dtype
               for g, w in zip(got, want))
