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


# ---------------------------------------------------------------------------
# The prefix cache: page keys, the set-associative index, the refcount
# programs, the orphan plan and scrub
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ps,quant_tag", [(4, 0), (16, 0), (8, 12345)])
def test_page_keys_bit_exact(ps, quant_tag):
    rng = np.random.default_rng(ps + quant_tag)
    for n in (0, 1, ps - 1, ps, ps + 1, 5 * ps + 3):
        toks = rng.integers(0, 2 ** 31 - 1, n).astype(np.int32)
        for pad in (0, 8):
            want = JP.page_keys(toks, ps, pad_to=pad, quant_tag=quant_tag)
            got = TP.page_keys(toks, ps, pad_to=pad, quant_tag=quant_tag)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    assert TP.PREFIX_SEED == JP.PREFIX_SEED


def _pools(monkeypatch, n_pages, map_slots, stripes=2):
    monkeypatch.setattr(JR, "next_lock_id", itertools.count(700).__next__)
    monkeypatch.setattr(TR, "next_lock_id", itertools.count(700).__next__)
    jp = JP.KVPool(n_pages, stripes=stripes, map_slots=map_slots)
    tp = TP.KVPool(n_pages, stripes=stripes, map_slots=map_slots,
                   device="cpu")
    return jp, tp


def _same_state(jp, tp):
    """Owner vector, the five map vectors and scale_gen, exactly."""
    for name in ("owner", "_map_kh", "_map_kl", "_map_pg", "_map_ln",
                 "_map_age", "scale_gen"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)),
                                      err_msg=name)
    assert tp.version == jp.version


def _both(jp, tp, op, *args):
    """Run one pool operation on both pools and check the results and the
    state they leave are equal; -> the result."""
    got, want = getattr(tp, op)(*args), getattr(jp, op)(*args)
    if isinstance(want, tuple):
        want = tuple([int(x) for x in w] if isinstance(w, list) else w
                     for w in want)
    elif isinstance(want, list):
        want = [bool(x) if isinstance(x, (bool, np.bool_)) else int(x)
                for x in want]
    assert got == want, (op, got, want)
    _same_state(jp, tp)
    return got


def _prompt(rng, length):
    return rng.integers(1, 4, size=length).astype(np.int32)


@pytest.mark.parametrize("seed,map_slots", [(0, 8), (1, 8), (2, 2), (3, 1),
                                            (4, 64)])
def test_prefix_programs_match_jax(seed, map_slots, monkeypatch):
    """The engine's admission sequence (match -> acquire -> allocate ->
    COW release -> insert -> teardown by release + reclaim) through both
    pools: the same pages, run lengths, revived counts, insert masks, owner
    and map vectors at every step, and the same stats at the end.  Tiny
    maps force set conflicts and the oldest-way eviction."""
    ps, lanes, n_pages = 4, 4, 24
    jp, tp = _pools(monkeypatch, n_pages, map_slots)
    rng = np.random.default_rng(seed)
    live = []
    for rid in range(10):
        if live and rng.random() < 0.4:
            r, refs = live.pop(int(rng.integers(len(live))))
            _both(jp, tp, "release_refs", np.asarray(refs + [-1], np.int32))
            _both(jp, tp, "reclaim", r)
        toks = _prompt(rng, int(rng.integers(1, 15)))
        kh, kl, ln = TP.page_keys(toks, ps, pad_to=lanes)
        pages, run, _ = _both(jp, tp, "match_prefix", kh, kl, ln)
        cov = min(int(np.sum(ln[:run])), len(toks) - 1)
        k_ref, cow = cov // ps, cov % ps > 0
        take = np.zeros(lanes, bool)
        take[:k_ref + int(cow)] = True
        hit, _ = _both(jp, tp, "acquire_prefix", kh, kl, ln, take)
        got = _both(jp, tp, "allocate", rid, -(-(len(toks) + 1) // ps) - k_ref)
        refs = [p for p in hit[:k_ref] if p >= 0]
        if not got:
            held = refs + ([hit[k_ref]] if cow else [])
            if held:
                _both(jp, tp, "release_refs", np.asarray(held, np.int32))
            continue
        if cow:
            _both(jp, tp, "release_refs", np.asarray([hit[k_ref]], np.int32))
        n_keys = int(np.sum(ln > 0))
        lane_pg = np.full(lanes, -1, np.int32)
        lane_pg[:n_keys] = (refs + got)[:n_keys]
        ins = _both(jp, tp, "insert_prefix", rid, kh, kl, ln, lane_pg)
        live.append((rid, refs + [int(lane_pg[i]) for i in range(n_keys)
                                  if ins[i]]))
    for r, refs in live:
        _both(jp, tp, "release_refs", np.asarray(refs + [-1], np.int32))
        _both(jp, tp, "reclaim", r)
    assert tp.stats() == jp.stats()
    assert tp.free_count() == n_pages
    assert not tp.registry.table.any()


def test_forced_set_conflict_evicts_oldest(monkeypatch):
    """map_slots=1: every key shares one 1-way set, so the second insert
    evicts the first entry; the victim page keeps its inserter's ref."""
    jp, tp = _pools(monkeypatch, 8, 1, stripes=1)
    a = TP.page_keys(np.asarray([1, 2, 3, 4], np.int32), 4, pad_to=2)
    b = TP.page_keys(np.asarray([9, 8, 7, 6], np.int32), 4, pad_to=2)
    pa = _both(jp, tp, "allocate", 0, 1)
    assert _both(jp, tp, "insert_prefix", 0, *a,
                 np.asarray(pa + [-1], np.int32))[0]
    pb = _both(jp, tp, "allocate", 1, 1)
    assert _both(jp, tp, "insert_prefix", 1, *b,
                 np.asarray(pb + [-1], np.int32))[0]
    assert _both(jp, tp, "match_prefix", *a)[1] == 0
    assert _both(jp, tp, "match_prefix", *b)[1] == 1
    assert tp.prefix_collisions == jp.prefix_collisions >= 1
    assert int(tp.owner[pa[0]]) == -2
    assert _both(jp, tp, "release_refs", np.asarray(pa, np.int32)) == 1


def test_orphan_plan_and_scrub_match_jax(monkeypatch):
    jp, tp = _pools(monkeypatch, 32, 0, stripes=4)
    for rid, n in ((3, 4), (8, 2), (5, 3), (6, 1)):
        _both(jp, tp, "allocate", rid, n)
    keys = TP.page_keys(np.arange(1, 9, dtype=np.int32), 4, pad_to=2)
    lane = np.asarray(_both(jp, tp, "lookup", 5)[:2], np.int32)
    _both(jp, tp, "insert_prefix", 5, *keys, lane)      # rid 5: shared pages
    live = np.asarray([8, 6], np.int32)
    jper, jtot = jp.orphan_plan(jnp.asarray(live))
    tper, ttot = tp.orphan_plan(torch.from_numpy(live))
    np.testing.assert_array_equal(tper, np.asarray(jper))
    assert ttot == jtot == 5                           # 4 of rid 3, 1 of 5
    jc = jp.scrub_orphans_async(jnp.asarray(live), np.asarray(jper) > 0)
    tc = tp.scrub_orphans_async(torch.from_numpy(live), tper > 0)
    assert int(tc) == int(jc) == 5
    _same_state(jp, tp)
    assert tp.stats() == jp.stats()
