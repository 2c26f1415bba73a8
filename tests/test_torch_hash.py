"""The port's splitmix64 slot hash (wrapping int64 in PyTorch) is bit-exact
with the host oracle and with ``repro``'s uint32-limb device hash."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.table import mix_hash
from repro.kernels import hash as JH
from repro_torch.kernels import hash as TH


def _limbs(x: np.ndarray):
    x = x.astype(np.uint64)
    return ((x >> np.uint64(32)).astype(np.uint32),
            (x & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _tids(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**63, size=64, dtype=np.uint64)


@pytest.mark.parametrize("lock", [1, 42, 2**40 + 17])
def test_hash_vec_matches_host(lock):
    """The vectors of tests/test_kernels.py::test_hash_vec_matches_host."""
    tids = _tids(7)
    want = np.array([mix_hash(lock, int(t)) for t in tids], np.uint64)
    np.testing.assert_array_equal(TH.mix_hash_u64(lock, tids), want)
    lh, ll = TH.split64(lock)
    th, tl = _limbs(tids)
    got = TH.mix_hash_i64(TH._u64(torch.tensor(lh), torch.tensor(ll)),
                          TH._u64(torch.from_numpy(th.astype(np.int64)),
                                  torch.from_numpy(tl.astype(np.int64))))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    s = TH.hash_slots(torch.tensor(lh), torch.tensor(ll),
                      torch.from_numpy(th.view(np.int32)),
                      torch.from_numpy(tl.view(np.int32)), 4096)
    np.testing.assert_array_equal(s.numpy(),
                                  (want & np.uint64(4095)).astype(np.int32))


@pytest.mark.parametrize("seed", range(4))
def test_hash_slots_matches_jax_limbs(seed):
    """Random 64-bit lock ids and reader ids through both packages'
    ``hash_slots``: equal slot vectors, for several table sizes."""
    rng = np.random.default_rng(100 + seed)
    locks = rng.integers(0, 2**64, size=8, dtype=np.uint64)
    tids = rng.integers(0, 2**64, size=128, dtype=np.uint64)
    th, tl = _limbs(tids)
    for lock in locks:
        lh, ll = JH.split64(int(lock))
        for n_slots in (1, 128, 4096, 2**20):
            want = np.asarray(JH.hash_slots(
                jnp.asarray(lh, jnp.uint32), jnp.asarray(ll, jnp.uint32),
                jnp.asarray(th), jnp.asarray(tl), n_slots))
            got = TH.hash_slots(torch.tensor(lh), torch.tensor(ll),
                                torch.from_numpy(th.view(np.int32)),
                                torch.from_numpy(tl.view(np.int32)), n_slots)
            np.testing.assert_array_equal(got.numpy(), want)


def test_hash_slots_rejects_non_power_of_two():
    one = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        TH.hash_slots(one, one, one, one, 4095)
