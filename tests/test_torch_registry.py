"""The same sequence of registry operations through ``repro``'s
BravoRegistry and the port's (on the CPU, through the kernels' plain
versions): after every step the table, the bias lanes, the lock values and
the hold counts must be exactly equal."""

import itertools
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import registry as JR
from repro.core.errors import DrainTimeout as JDrainTimeout
from repro_torch.core import registry as TR
from repro_torch.core.errors import DrainTimeout as TDrainTimeout


@pytest.fixture
def pair(monkeypatch):
    """Two registries whose lock values line up: each package has its own
    ``next_lock_id`` counter, so both get a fresh counter from one base."""
    monkeypatch.setattr(JR, "next_lock_id", itertools.count(1000).__next__)
    monkeypatch.setattr(TR, "next_lock_id", itertools.count(1000).__next__)
    return JR.BravoRegistry(), TR.BravoRegistry(device="cpu")


def _same(jr, tr, jhs, ths):
    np.testing.assert_array_equal(np.asarray(jr.table), tr.table.numpy())
    np.testing.assert_array_equal(np.asarray(jr.rbias), tr.rbias.numpy())
    np.testing.assert_array_equal(np.asarray(jr.lock_vals),
                                  tr.lock_vals.numpy())
    np.testing.assert_array_equal(jr.held_multi(jhs), tr.held_multi(ths))
    assert [h.lock_id for h in jhs] == [h.lock_id for h in ths]
    assert [h.gen for h in jhs] == [h.gen for h in ths]
    np.testing.assert_array_equal(jr._armed, tr._armed)


def _rearm(h, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not h.rearm():
        assert time.monotonic() < deadline, "rearm never passed its window"
        time.sleep(0.001)


def test_registry_sequence_matches_jax(pair):
    jr, tr = pair
    jh = [jr.alloc(name=n) for n in "abc"]
    th = [tr.alloc(name=n) for n in "abc"]
    _same(jr, tr, jh, th)

    # a batch spanning lanes, with duplicate readers (collisions)
    rng = np.random.default_rng(0)
    rids = rng.integers(0, 5000, 24).astype(np.int32)
    rids[12:] = rids[:12]
    lidx = np.asarray([h.idx for h in jh], np.int32)[rng.integers(0, 3, 24)]
    jg = jr.acquire_by_index(jnp.asarray(lidx), jnp.asarray(rids))
    tg = tr.acquire_by_index(torch.from_numpy(lidx), torch.from_numpy(rids))
    np.testing.assert_array_equal(np.asarray(jg), tg.numpy())
    _same(jr, tr, jh, th)

    # one lock's own acquire on top, then both releases
    ids = np.arange(40, 48, dtype=np.int32)
    jg2 = jh[0].acquire(jnp.asarray(ids))
    tg2 = th[0].acquire(torch.from_numpy(ids))
    np.testing.assert_array_equal(np.asarray(jg2), tg2.numpy())
    _same(jr, tr, jh, th)
    jr.release_by_index(jnp.asarray(lidx), jnp.asarray(rids), jg)
    tr.release_by_index(torch.from_numpy(lidx), torch.from_numpy(rids), tg)
    _same(jr, tr, jh, th)
    jh[0].release(jnp.asarray(ids), granted=jg2)
    th[0].release(torch.from_numpy(ids), granted=tg2)
    _same(jr, tr, jh, th)
    assert not tr.table.any()

    # revoke with no readers: only b's lane clears; then rearm it (n=0:
    # no inhibit window, so the rearm does not wait on the revoke's cost)
    assert jh[1].revoke(n=0) >= 1 and th[1].revoke(n=0) >= 1
    _same(jr, tr, jh, th)
    assert tr.rbias[th[1].idx] == 0 and tr.rbias[th[0].idx] == 1
    # a publish under the revoked lock is denied, the others land
    jg3 = jr.acquire_by_index(jnp.asarray(lidx), jnp.asarray(rids))
    tg3 = tr.acquire_by_index(torch.from_numpy(lidx), torch.from_numpy(rids))
    np.testing.assert_array_equal(np.asarray(jg3), tg3.numpy())
    _same(jr, tr, jh, th)
    jr.release_by_index(jnp.asarray(lidx), jnp.asarray(rids), jg3)
    tr.release_by_index(torch.from_numpy(lidx), torch.from_numpy(rids), tg3)
    _rearm(jh[1])
    _rearm(th[1])
    _same(jr, tr, jh, th)

    # a held lease wedges c's drain: DrainTimeout, stuck-lane scrub, gen bump
    held = np.asarray([7, 8, 9], np.int32)
    jh[2].acquire(jnp.asarray(held))
    th[2].acquire(torch.from_numpy(held))
    _same(jr, tr, jh, th)
    old = th[2].lock_id
    with pytest.raises(JDrainTimeout):
        jh[2].revoke(max_wait_s=0.05)
    with pytest.raises(TDrainTimeout) as ei:
        th[2].revoke(max_wait_s=0.05)
    assert ei.value.idx == th[2].idx
    _same(jr, tr, jh, th)
    assert th[2].lock_id != old and th[2].gen == 1
    assert int((tr.table == old).sum()) == 0
    assert tr.stats()["drain_timeouts"] == jr.stats()["drain_timeouts"] == 1
    assert tr.stats()["lane_scrubs"] == jr.stats()["lane_scrubs"] == 1

    # recycle a lane: the next tenant publishes a fresh value
    jr.free(jh[0])
    tr.free(th[0])
    jh[0] = jr.alloc(name="a2")
    th[0] = tr.alloc(name="a2")
    _same(jr, tr, jh, th)
    for k in ("live_locks", "allocs", "recycles", "publishes", "revocations",
              "armed", "rbias_armed"):
        assert tr.stats()[k] == jr.stats()[k], k


def test_registry_rejects_use_after_free():
    from repro_torch.core.errors import ProtocolError

    reg = TR.BravoRegistry(device="cpu")
    h = reg.alloc()
    h.free()
    with pytest.raises(ProtocolError):
        h.acquire(torch.zeros(1, dtype=torch.int32))


def test_concurrent_acquire_release_keep_the_table_clean():
    """Several threads publish and clear leases on two locks while a writer
    revokes one of them: no lease leaks, and every drain ends."""
    import threading

    reg = TR.BravoRegistry(device="cpu")
    hs = [reg.alloc(), reg.alloc()]
    errs = []

    def reader(base):
        try:
            for i in range(40):
                h = hs[i % 2]
                ids = torch.arange(base, base + 4, dtype=torch.int32)
                h.rearm()
                g = h.acquire(ids)
                h.release(ids, granted=g)
        except Exception as e:       # surfaced by the assert below
            errs.append(e)

    def writer():
        try:
            for _ in range(10):
                hs[0].revoke(max_wait_s=5.0)
        except Exception as e:
            errs.append(e)

    ts = [threading.Thread(target=reader, args=(100 * k,)) for k in range(4)]
    ts.append(threading.Thread(target=writer))
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs, errs
    assert not reg.table.any()
    np.testing.assert_array_equal(reg.held_multi(hs), [0, 0])
