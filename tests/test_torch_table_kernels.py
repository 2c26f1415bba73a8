"""The plain versions of the table kernels K1-K4 (what the CUDA kernels
compute, and what the wrappers run for CPU tensors) against ``repro``'s
Pallas kernels in interpret mode, on seeded sweeps with duplicate slots,
occupied slots, cleared bias lanes and -1 slots.  Tables, grant masks and
counts must be exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import registry as JR
from repro.kernels import ops as JK
from repro.kernels import ref as JREF
from repro_torch.kernels import ops as TK
from repro_torch.kernels import table_publish as TP

SEEDS = range(7)
# seed 6: a batch of 3000, three chunks of the kernels' 1024 requests a
# pass (the plain versions take it whole, as repro's fused kernels do)
BATCH = {0: 1, 1: 4, 2: 16, 3: 64, 4: 256, 5: 33, 6: 3000}


def _case(seed: int):
    """A table with ~7% occupancy, 128 bias lanes (30% cleared), and M
    requests whose slots collide with each other and with occupied slots,
    with some -1 slots."""
    rng = np.random.default_rng(seed)
    m = BATCH[seed]
    table = np.zeros((32, 128), np.int32)
    occ = rng.choice(4096, 300, replace=False)
    table.reshape(-1)[occ] = rng.integers(1, 50, 300)
    rbias = (rng.random(128) < 0.7).astype(np.int32)
    pool = np.concatenate([occ[:5], rng.choice(4096, max(2, m // 4)), [-1]])
    slots = rng.choice(pool, m).astype(np.int32)
    lock_idx = rng.integers(0, 128, m).astype(np.int32)
    ids = rng.integers(1, 1000, m).astype(np.int32)
    return table, rbias, slots, lock_idx, ids


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _eq(jax_arr, torch_t):
    np.testing.assert_array_equal(np.asarray(jax_arr), torch_t.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_publish_multi_matches_jax_kernel(seed):
    table, rbias, slots, lidx, ids = _case(seed)
    jt, jg = JK.fused_publish_multi(jnp.asarray(table), jnp.asarray(rbias),
                                    jnp.asarray(slots), jnp.asarray(lidx),
                                    jnp.asarray(ids))
    tt = _t(table)
    out, tg = TK.fused_publish_multi(tt, _t(rbias), _t(slots), _t(lidx),
                                     _t(ids))
    assert out is tt                       # updated in place
    _eq(jt, tt)
    _eq(jg, tg)


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_publish_matches_jax_kernel(seed):
    table, _, slots, _, ids = _case(seed)
    for rbias in (0, 1):
        jt, jg = JK.fused_publish(jnp.asarray(table),
                                  jnp.asarray(rbias, jnp.int32),
                                  jnp.asarray(slots), jnp.asarray(ids))
        tt = _t(table)
        out, tg = TK.fused_publish(tt, torch.tensor(rbias, dtype=torch.int32),
                                   _t(slots), _t(ids))
        assert out is tt
        _eq(jt, tt)
        _eq(jg, tg)


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_clear_matches_jax_kernel(seed):
    table, _, slots, _, _ = _case(seed)
    jt = JK.fused_clear(jnp.asarray(table), jnp.asarray(slots))
    tt = _t(table)
    assert TK.fused_clear(tt, _t(slots)) is tt
    _eq(jt, tt)


def test_clear_slot_minus_one_is_a_noop():
    """``repro.kernels.ref.clear_ref`` indexes with -1 and so clears the
    LAST slot; the Pallas kernel (and the port) clear nothing there."""
    table = np.arange(1, 4097, dtype=np.int32).reshape(32, 128)
    slots = np.asarray([-1, 5], np.int32)
    ref_wraps = np.asarray(JREF.clear_ref(jnp.asarray(table),
                                          jnp.asarray(slots)))
    assert ref_wraps.reshape(-1)[4095] == 0
    kern = np.asarray(JK.fused_clear(jnp.asarray(table), jnp.asarray(slots)))
    port = TK.fused_clear(_t(table), _t(slots)).numpy()
    np.testing.assert_array_equal(port, kern)
    assert port.reshape(-1)[4095] == 4096 and port.reshape(-1)[5] == 0


@pytest.mark.parametrize("seed", SEEDS)
def test_revocation_poll_matches(seed):
    """Exact count against numpy; zero vs non-zero against the Pallas poll
    (which stops at its first matching block, so it only bounds the count
    from below)."""
    table, _, _, _, _ = _case(seed)
    for lock in (0, 1, int(table.max()), 10_000):
        want = int((table == lock).sum())
        got = int(TK.revocation_poll(_t(table), lock))
        assert got == want
        jax_cnt = int(JK.revocation_poll(jnp.asarray(table), lock))
        assert (jax_cnt == 0) == (got == 0)
        assert 1 <= jax_cnt <= got or got == 0


def test_revocation_poll_is_exact_on_a_full_table():
    table = np.full((32, 128), 7, np.int32)
    assert int(TK.revocation_poll(_t(table), 7)) == 4096
    assert 1 <= int(JK.revocation_poll(jnp.asarray(table), 7)) < 4096


@pytest.mark.parametrize("seed", SEEDS)
def test_revocation_poll_multi_matches_jax_kernel(seed):
    table, _, _, _, _ = _case(seed)
    rng = np.random.default_rng(seed)
    for k in (1, 5, 128):
        locks = rng.integers(0, 60, k).astype(np.int32)
        want = JK.revocation_poll_multi(jnp.asarray(table),
                                        jnp.asarray(locks))
        _eq(want, TK.revocation_poll_multi(_t(table), _t(locks)))


@pytest.mark.parametrize("seed", SEEDS)
def test_hashed_lease_path_matches_jax_registry_programs(seed):
    """The registry's lease path (hash + lock-value gather + K1, and the
    masked release through K2) against ``repro.core.registry``'s fused
    acquire/release programs."""
    table, rbias, _, _, _ = _case(seed)
    rng = np.random.default_rng(seed)
    m = BATCH[seed]
    vals = np.zeros(128, np.int32)
    vals[:8] = rng.integers(1, 2**31 - 1, 8)
    lidx = rng.integers(0, 8, m).astype(np.int32)
    rids = rng.integers(0, 2**31 - 1, m).astype(np.int32)
    rids[m // 2:] = rids[:m - m // 2]           # duplicate readers collide
    jt, jg = JR._acquire_by_index_impl(jnp.asarray(table), jnp.asarray(rbias),
                                       jnp.asarray(vals), jnp.asarray(lidx),
                                       jnp.asarray(rids))
    tt = _t(table)
    tg = TP.acquire_hashed(tt, _t(rbias), _t(vals), _t(lidx), _t(rids))
    _eq(jt, tt)
    _eq(jg, tg)
    jt2 = JR._release_by_index_impl(jt, jnp.asarray(vals), jnp.asarray(lidx),
                                    jnp.asarray(rids), jg)
    TP.release_hashed(tt, _t(vals), _t(lidx), _t(rids), tg)
    _eq(jt2, tt)
    np.testing.assert_array_equal(tt.numpy(), table)   # back where it was


def test_wrappers_reject_what_the_kernels_do_not_take():
    table = torch.zeros((32, 128), dtype=torch.int32)
    s = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        TK.fused_publish_multi(table, torch.ones(128, dtype=torch.int32),
                               s.long(), s, s)
    with pytest.raises(ValueError):
        TK.fused_publish_multi(table.reshape(64, 64),
                               torch.ones(128, dtype=torch.int32), s, s, s)
    with pytest.raises(ValueError):
        TK.fused_clear(table, torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        TK.revocation_poll_multi(table, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        TP.acquire_hashed(table, torch.ones(128, dtype=torch.int32),
                          torch.ones(128, dtype=torch.int32),
                          torch.zeros(3, dtype=torch.int32), s)
