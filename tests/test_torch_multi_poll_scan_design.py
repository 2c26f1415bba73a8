"""The K4 multi-lock drain count and the K9 match scan
(``csrc/table_kernels.cu`` ``poll_kernel`` in its multi and mask modes),
transcribed in numpy, against ``repro``'s Pallas kernels
``_multi_poll_call`` and ``_scan_call`` in interpret mode and the port's
plain versions.

K4 runs one CTA a lock value, at any K, in one launch: CTA j is K3's
kernel on value j (K3's layouts: each thread's 16-byte groups of four
slots, a sum per warp, then across warps) and writes only ``counts[j]``.
Every CTA reads the whole table.  K9 stores each group's four mask bytes
as one little-endian word and counts as K3.

Inputs come from a numpy seed: ``chip_smoke._poll_tables`` and
``_multi_locks``, the tables and lock vectors the card checks, with
duplicates, values in no slot, 0, -1, ``INT32_MIN`` and ``INT32_MAX``.
Everything is exact.
"""

import importlib.util
import itertools
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import registry as JR
from repro.kernels.table_scan import _multi_poll_call, _scan_call
from repro_torch.core import registry as TR
from repro_torch.kernels import ref as R
from repro_torch.kernels import table_scan as TS

WARP = 32
ROOT = pathlib.Path(__file__).resolve().parent.parent
SOURCE = (ROOT / "src/repro_torch/csrc/table_kernels.cu").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


SMALL_TABLE = _constant("kSmallTable")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


CS = _chip_smoke()


# ---------------------------------------------------------------------------
# The launch: warps and trips of one CTA
# ---------------------------------------------------------------------------


def layout(n_slots):
    """K3's layouts, which K4 and K9 take: (warps, 16-byte loads a thread
    a trip), 8 x 4 up to 4096 slots, 32 x 1 past it."""
    return (8, 4) if n_slots <= SMALL_TABLE else (32, 1)


def warp_steps(n_slots, warps, loads):
    """The slots each warp instruction of one CTA's scan covers: -> (steps,
    32) slot indices and the warp of each step.  Tables are whole rows of
    128 slots, so a warp's 32 groups are all in the table or all past it."""
    threads = warps * WARP
    n_groups = n_slots // 4
    lane = np.arange(WARP)
    rows, owner = [], []
    for w in range(warps):
        for base in range(w * WARP, n_groups, threads * loads):
            for q in range(loads):
                g = base + q * threads + lane
                if g[0] >= n_groups:
                    continue
                assert g[-1] < n_groups              # the warp is whole
                for c in range(4):
                    rows.append(4 * g + c)
                    owner.append(w)
    return np.array(rows), np.array(owner)


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------


def multi_poll(table, locks):
    """CTA j of K CTAs is K3's kernel on value ``locks[j]`` (loaded by
    every thread): each thread's compares, per warp a sum, then the warps'
    sums, stored to ``counts[j]`` alone.  Every CTA reads the whole table.
    -> (counts, number of stores to each entry of counts)."""
    flat = table.reshape(-1)
    warps, loads = layout(flat.size)
    steps, owner = warp_steps(flat.size, warps, loads)
    # every slot read once by one warp step of each CTA
    np.testing.assert_array_equal(np.sort(steps.reshape(-1)),
                                  np.arange(flat.size))
    locks = np.asarray(locks)
    hits = flat[steps][:, :, None] == locks[None, None, :]   # step, lane, j
    warp_sums = np.zeros((warps, locks.size), np.int64)
    np.add.at(warp_sums, owner, hits.sum(axis=1))
    counts = np.full(locks.size, -1, np.int64)
    stores = np.zeros(locks.size, np.int64)
    for block, total in enumerate(warp_sums.sum(axis=0)):   # blockIdx.x
        counts[block] = total
        stores[block] += 1
    return counts, stores


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------


def scan(table, lock):
    """K9: each group's mask as one word (slot 4g + i in byte i), stored
    at word g; the count sums the words' set bits per thread, per warp,
    then across warps (K3's layout)."""
    groups = table.reshape(-1, 4)
    hits = (groups == lock).astype(np.uint32)
    words = hits[:, 0] | hits[:, 1] << 8 | hits[:, 2] << 16 | hits[:, 3] << 24
    mask = words.astype("<u4").view(np.uint8).view(np.int8)
    popc = np.array([bin(int(w)).count("1") for w in words])
    return mask.reshape(table.shape), int(popc.sum())


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

JAX_ROWS = (8, 32)               # up to 4096 slots: also against Pallas
NUMPY_ROWS = (512,)              # 65,536 slots: numpy alone


def _tables(rows):
    return CS._poll_tables(np.random.default_rng(rows), rows)


def _locks(k, values, seed=0):
    return CS._multi_locks(np.random.default_rng(seed), k,
                           np.unique(values))


def _want(table, locks):
    got = R.multi_count_ref(torch.from_numpy(table.reshape(-1, 128)),
                            torch.from_numpy(np.asarray(locks, np.int32)))
    return got.numpy()


def _pallas(table, locks):
    return np.asarray(_multi_poll_call(
        jnp.asarray(table.reshape(-1, 128)),
        jnp.asarray(np.asarray(locks, np.int32)), interpret=True))


@pytest.mark.parametrize("k", [1, 5, 8, 16, 128, 129, 1000])
@pytest.mark.parametrize("rows", JAX_ROWS + NUMPY_ROWS)
def test_k4_matches_pallas_and_ref(rows, k):
    for t, (values, _) in enumerate(_tables(rows)):
        locks = _locks(k, values, seed=t)
        want = _want(values, locks)
        np.testing.assert_array_equal(multi_poll(values, locks)[0], want)
        if rows in JAX_ROWS:
            np.testing.assert_array_equal(_pallas(values, locks), want)


@pytest.mark.parametrize("k", [1, 5, 129, 1024, 1025, 3000, 5000])
def test_k4_one_cta_a_value_at_any_k(k):
    """Any K runs K CTAs in one launch, each storing its own count once;
    a duplicate, in whatever CTA, gets its value's full count."""
    values, _ = _tables(32)[2]
    locks = _locks(k, values, seed=k)
    got, stores = multi_poll(values, locks)
    np.testing.assert_array_equal(got, _want(values, locks))
    np.testing.assert_array_equal(stores, np.ones(k, np.int64))
    if k >= 2:
        assert got[-1] == got[0]       # locks[-1] repeats locks[0]


@pytest.mark.parametrize("rows", (1, 2) + CS.TABLE_ROWS[:3])
def test_k4_warps_cover_the_table_once(rows):
    """In each of K3's two layouts, which K4 and K9 take, every slot is
    read by exactly one warp step, and every warp step is whole (tables of
    128 and 256 slots leave warps idle)."""
    n = rows * 128
    for warps, loads in ((8, 4), (32, 1)):
        steps, _ = warp_steps(n, warps, loads)
        np.testing.assert_array_equal(np.sort(steps.reshape(-1)),
                                      np.arange(n))


def test_k4_launch_matches_the_source():
    """The entry launches K3's kernel in its multi mode, one CTA a lock
    value, and nothing for K = 0; the small layout covers the small table
    in one trip."""
    entry = SOURCE[SOURCE.index("int bravo_multi_poll("):]
    entry = entry[entry.index("#else"):entry.index("#endif")]
    assert "if (k <= 0) return" in entry
    assert "poll<Poll::kMulti>(table, n_slots, 0, lock_ids, k," in entry
    warps, loads = layout(SMALL_TABLE)
    assert warps * WARP * loads * 4 == SMALL_TABLE


def test_k4_wrapper_takes_any_k_on_the_cpu():
    """No lock limit is left in the wrapper (the parent kernel took at most
    128); on the CPU it runs the plain version, K = 0 included."""
    assert not hasattr(TS, "MAX_LOCKS")
    values, _ = _tables(32)[2]
    t = torch.from_numpy(values.reshape(32, 128))
    for k in (0, 129, 1000):
        locks = _locks(k, values) if k else np.zeros(0, np.int32)
        got = TS.revocation_poll_multi(t, torch.from_numpy(locks))
        assert got.dtype == torch.int32 and got.shape == (k,)
        np.testing.assert_array_equal(got.numpy(), _want(values, locks))


@settings(max_examples=50, deadline=None)
@given(st.data())
def test_k4_property_any_k_and_values(data):
    """Property: the plain version's counts for random tables over a small
    value set that includes the edge values, and random lock vectors over
    it and values in no slot."""
    rows = data.draw(st.sampled_from([1, 2, 8]))
    pool = list(CS.EDGE_VALUES) + [1, 2, 3, 77]
    table = np.array(data.draw(st.lists(
        st.sampled_from(pool), min_size=rows * 128, max_size=rows * 128)),
        np.int32).reshape(rows, 128)
    k = data.draw(st.integers(1, 300))
    locks = np.array(data.draw(st.lists(st.sampled_from(pool + [5, -9]),
                                        min_size=k, max_size=k)), np.int32)
    np.testing.assert_array_equal(multi_poll(table, locks)[0],
                                  _want(table, locks))


@pytest.fixture
def registries(monkeypatch):
    """``repro``'s registry and the port's, 200 lanes each, with lock
    values from one fresh counter base."""
    monkeypatch.setattr(JR, "next_lock_id", itertools.count(5000).__next__)
    monkeypatch.setattr(TR, "next_lock_id", itertools.count(5000).__next__)
    return (JR.BravoRegistry(max_locks=200),
            TR.BravoRegistry(max_locks=200, device="cpu"))


def test_f4_held_multi_over_200_locks_matches_repro(registries):
    """F4: 200 locks, every seventh held by 30 readers, and ``held_multi``
    over all 200 plus three duplicates: equal counts in both packages,
    equal to the plain version over the port's table."""
    jr, tr = registries
    jhs = [jr.alloc() for _ in range(200)]
    ths = [tr.alloc() for _ in range(200)]
    rng = np.random.default_rng(21)
    for i in range(0, 200, 7):
        rids = rng.integers(0, 2**31 - 1, 30).astype(np.int32)
        jr.acquire(jhs[i], jnp.asarray(rids))
        tr.acquire(ths[i], torch.from_numpy(rids))
    dup = [0, 7, 199]
    got = tr.held_multi(ths + [ths[i] for i in dup])
    want = jr.held_multi(jhs + [jhs[i] for i in dup])
    np.testing.assert_array_equal(got, want)
    vals = np.array([h.lock_id for h in ths] + [ths[i].lock_id for i in dup],
                    np.int32)
    np.testing.assert_array_equal(got, _want(tr.table.numpy(), vals))
    np.testing.assert_array_equal(got,
                                  multi_poll(tr.table.numpy(), vals)[0])
    assert got[200:].tolist() == got[dup].tolist() and got.sum() > 0


@pytest.mark.parametrize("rows", JAX_ROWS + NUMPY_ROWS)
def test_k9_mask_words_and_count(rows):
    for values, locks in _tables(rows):
        for lock in locks:
            want_m, want_c = R.scan_ref(torch.from_numpy(values.reshape(
                rows, 128)), lock)
            mask, count = scan(values.reshape(rows, 128), lock)
            np.testing.assert_array_equal(mask, want_m.numpy())
            assert count == int(want_c)
            if rows in JAX_ROWS:
                jm, jc = _scan_call(jnp.asarray(values.reshape(rows, 128)),
                                    jnp.asarray(lock, jnp.int32),
                                    interpret=True)
                np.testing.assert_array_equal(np.asarray(jm), mask)
                assert int(jc) == count
