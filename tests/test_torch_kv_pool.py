"""The port's KVPool against ``repro.serving.kv_pool.KVPool``: the same
allocate / reclaim / lookup / batch-read sequence gives the same pages, the
same owner vector and the same masks, and leaves no lease behind."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import registry as JR
from repro.serving import kv_pool as JP
from repro_torch.core import registry as TR
from repro_torch.serving import kv_pool as TP


@pytest.mark.parametrize("seed", range(3))
def test_pool_sequence_matches_jax(seed, monkeypatch):
    monkeypatch.setattr(JR, "next_lock_id", itertools.count(500).__next__)
    monkeypatch.setattr(TR, "next_lock_id", itertools.count(500).__next__)
    jp = JP.KVPool(64, stripes=4)
    tp = TP.KVPool(64, stripes=4, device="cpu")
    rng = np.random.default_rng(seed)
    live = []
    for step in range(24):
        if live and rng.random() < 0.35:
            rid = live.pop(int(rng.integers(len(live))))
            assert tp.reclaim(rid) == jp.reclaim(rid)
        else:
            rid = int(rng.integers(0, 1000))
            n = int(rng.integers(1, 20))
            got = tp.allocate(rid, n)
            assert got == [int(p) for p in jp.allocate(rid, n)]
            if got:
                live.append(rid)
        np.testing.assert_array_equal(tp.owner.numpy(), np.asarray(jp.owner))
        if live:
            rid = live[-1]
            assert tp.lookup(rid) == [int(p) for p in jp.lookup(rid)]
            rids = np.asarray(live[:4], np.int32)
            np.testing.assert_array_equal(
                tp.lookup_batch(torch.from_numpy(rids)).numpy(),
                np.asarray(jp.lookup_batch(jnp.asarray(rids))))
    assert tp.free_count() == jp.free_count()
    assert tp.free_pages() == [int(p) for p in jp.free_pages()]
    js, ts = jp.stats(), tp.stats()
    for k in ts:
        assert ts[k] == js[k], k
    np.testing.assert_array_equal(tp.registry.held_multi(tp.locks),
                                  jp.registry.held_multi(jp.locks))
    assert not tp.registry.table.any()


def test_read_batch_holds_its_leases_until_done():
    pool = TP.KVPool(32, stripes=2, device="cpu")
    pages = pool.allocate(7, 3)
    rids = torch.tensor([7, 8], dtype=torch.int32)
    token, mask = pool.read_batch(rids)
    assert mask[0].nonzero().flatten().tolist() == pages
    assert not mask[1].any()
    # a stripe revoked by the allocation may still be inside its inhibit
    # window: its reader is denied (the slow path), so count grants only
    granted = token[2]
    assert granted[1]                    # stripe 0 was never revoked
    assert pool.registry.held_multi(pool.locks).sum() == int(granted.sum())
    pool.done_read_batch(token)
    assert pool.registry.held_multi(pool.locks).sum() == 0
