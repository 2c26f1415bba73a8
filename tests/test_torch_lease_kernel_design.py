"""The decision order of the K1/K2 lease kernels (``csrc/table_kernels.cu``
``lease_kernel``), transcribed in numpy, against ``repro``'s Pallas kernels
``_fused_publish_multi_call`` (K1) and ``_fused_publish_call`` (K2) in
interpret mode and against the port's plain versions.

The transcription follows the kernel step by step: one thread per request
in chunks of 1024; within a warp, ``__match_any_sync`` over the slots
masked by the ballot of attempting lanes names each slot's first lane;
across warps, each warp's first lanes' slots go to one list (rows padded
with the row's first slot) that the later warps scan; a chunk scans the
lists of the chunks before it.  Only a request first for its slot over the
batch uses that slot's occupancy, and only it stores there.  The kernel's
warps read and store in no fixed order, so the transcription runs each
chunk's warps in a given order on a LIVE table (each warp reads, then
stores) and the tests hold every order to one answer: the table as it was
before the batch decides every request.  The hashed release, which stores
0 and grants nothing, checks no collision at all; the tests hold that to
the full order too.

Inputs come from a numpy seed at batches around a warp and a chunk, with
collisions placed across warp and chunk boundaries, denied requests on
later winners' slots, and slots outside the table.  Everything is exact.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import table_publish as JTP
from repro_torch.kernels import ref as R
from repro_torch.kernels import table_publish as TP
from repro_torch.kernels import table_scan as TS

WARP = 32
CHUNK = 1024
MS = (31, 32, 33, 64, 1023, 1024, 1025)
ROOT = pathlib.Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# The transcription
# ---------------------------------------------------------------------------


def mix_hash(lock, reader):
    """splitmix64 over (lock value as uint32, reader id as uint64), as the
    kernel computes it in native uint64."""
    with np.errstate(over="ignore"):
        x = (np.asarray(lock).astype(np.uint32).astype(np.uint64)
             * np.uint64(0x9E3779B97F4A7C15)
             + np.asarray(reader).astype(np.uint64)
             * np.uint64(0xBF58476D1CE4E5B9))
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return x


def hashed_slots(n_slots, lock_vals, lanes, readers):
    """-> (slots, lock values) of the hashed entries: slot -1 for a lane
    outside ``lock_vals``; ``readers`` int32 (bits of uint32 ids) or int64
    (bits of uint64 ids)."""
    lanes = np.asarray(lanes)
    ok = (lanes >= 0) & (lanes < len(lock_vals))
    vals = np.where(ok, lock_vals[np.clip(lanes, 0, len(lock_vals) - 1)], 0)
    readers = np.asarray(readers)
    r64 = (readers.astype(np.uint32).astype(np.uint64)
           if readers.dtype == np.int32 else readers.astype(np.uint64))
    h = mix_hash(vals, r64) & np.uint64(n_slots - 1)
    return np.where(ok, h.astype(np.int64), -1).astype(np.int32), vals


def warp_first(slot, attempt):
    """One warp: the match mask of each lane's slot, masked by the ballot
    of attempting lanes; -> True where the lane is the lowest attempting
    lane of its slot."""
    ballot = sum(1 << j for j in range(WARP) if attempt[j])
    first = np.zeros(WARP, bool)
    for lane in range(WARP):
        same = sum(1 << j for j in range(WARP) if slot[j] == slot[lane])
        below = (1 << lane) - 1
        first[lane] = attempt[lane] and (same & ballot & below) == 0
    return first


def warp_rows(slot, attempt, n_warps):
    """The shared list: per warp, its first lanes' slots padded with the
    first of them to 32 entries, and their count."""
    rows, counts = [], []
    for w in range(n_warps):
        s, a = slot[w * WARP:(w + 1) * WARP], attempt[w * WARP:(w + 1) * WARP]
        lead = warp_first(s, a)
        row = list(s[lead])
        counts.append(len(row))
        rows.append(row + [row[0] if row else 0] * (WARP - len(row)))
    return rows, counts


def listed(slot, rows, counts, n_warps):
    return any(counts[w] and slot in rows[w] for w in range(n_warps))


def lease_kernel(table, slot, ids, attempt, *, conditional, bias_ok=True,
                 any_order=False, granted_out=True, order="forward",
                 seed=0):
    """The kernel's decisions on a flat table: -> (new table, granted).
    ``order``: the order the warps of a chunk read and store in
    ("forward", "reverse" or "random")."""
    t = np.array(table, copy=True)
    n_slots, m = t.size, len(slot)
    threads = -(-m // WARP) * WARP if m < CHUNK else CHUNK
    n_warps = threads // WARP
    granted = np.zeros(m, bool)
    rng = np.random.default_rng(seed)

    def chunk(base):
        i = base + np.arange(threads)
        active = i < m
        j = np.where(active, i, 0)
        return i, active, np.where(active, slot[j], -1), active & attempt[j]

    for base in range(0, m, CHUNK):
        i, active, s, att = chunk(base)
        first = att.copy()
        if not any_order:
            for b2 in range(0, base, CHUNK):
                _, _, es, ea = chunk(b2)
                rows, counts = warp_rows(es, ea, n_warps)
                first &= np.array([not listed(x, rows, counts, n_warps)
                                   for x in s])
            lead = np.concatenate([warp_first(s[w * WARP:(w + 1) * WARP],
                                              att[w * WARP:(w + 1) * WARP])
                                   for w in range(n_warps)])
            first &= lead
            if n_warps > 1:
                rows, counts = warp_rows(s, att, n_warps)
                first &= np.array([not listed(x, rows, counts, k // WARP)
                                   for k, x in enumerate(s)])
        win = first & bias_ok
        warps = list(range(n_warps))
        if order == "reverse":
            warps.reverse()
        elif order == "random":
            rng.shuffle(warps)
        for w in warps:
            lanes = slice(w * WARP, (w + 1) * WARP)
            ws, ww = s[lanes], win[lanes].copy()
            inside = (ws >= 0) & (ws < n_slots)
            if conditional:                    # every read, then the stores
                cur = np.where(inside, t[np.clip(ws, 0, n_slots - 1)], 0)
                ww &= cur == 0
            for k in np.flatnonzero(ww & inside & active[lanes]):
                t[ws[k]] = ids[i[lanes][k]]
            live = active[lanes]
            granted[i[lanes][live]] = ww[live]
    return t, (granted if granted_out else None)


def k1(table, rbias, slots, lanes, ids, **kw):
    lanes = np.asarray(lanes)
    ok = (lanes >= 0) & (lanes < len(rbias))
    attempt = ok & (rbias[np.clip(lanes, 0, len(rbias) - 1)] != 0)
    return lease_kernel(table, slots, ids, attempt, conditional=True, **kw)


def k2(table, rbias, slots, ids, *, unconditional=False, check_rbias=True,
       **kw):
    return lease_kernel(table, slots, ids, np.ones(len(slots), bool),
                        conditional=not unconditional,
                        bias_ok=not check_rbias or rbias != 0, **kw)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def placed_case(seed, m, rows=32, n_locks=128):
    """A table (~7% occupied), ``n_locks`` bias lanes (lane 0 set, lane 1
    cleared, the rest 70% set) and M requests with these placed where M
    reaches them: two biased requests for one free slot in one warp (4,
    29), in different warps (3, 40), in different chunks (1000, 1030); an
    earlier denied request on a later winner's slot across warps (5, 37)
    and across chunks (1023, 1024); biased requests for slots -1 (7) and
    n_slots + 3 (9); lanes -1 (11) and n_locks (13).  The pairs share
    reader ids and lane 1 carries lane 0's lock value, so the hashed
    entries collide at the same places."""
    rng = np.random.default_rng(seed)
    n_slots = rows * 128
    table = np.zeros(n_slots, np.int32)
    occ = rng.choice(n_slots, n_slots // 14, replace=False)
    table[occ] = rng.integers(1, 50, occ.size)
    free = np.flatnonzero(table == 0)
    rbias = (rng.random(n_locks) < 0.7).astype(np.int32)
    rbias[:2] = (1, 0)
    pool = np.concatenate([occ[:8], rng.choice(n_slots, max(2, m // 2))])
    slots = rng.choice(pool, m).astype(np.int32)
    lanes = rng.integers(0, n_locks, m).astype(np.int32)
    ids = rng.integers(1, 1000, m).astype(np.int32)
    vals = rng.integers(1, 2**31 - 1, n_locks).astype(np.int32)
    vals[1] = vals[0]
    readers = rng.integers(0, 2**31 - 1, m).astype(np.int32)
    mask = rng.random(m) < 0.8
    spots = rng.choice(free, 5, replace=False)
    for (a, b, lane_a), slot in zip(((4, 29, 0), (3, 40, 0), (1000, 1030, 0),
                                     (5, 37, 1), (1023, 1024, 1)), spots):
        if b < m:
            slots[a] = slots[b] = slot
            lanes[a], lanes[b] = lane_a, 0
            readers[a] = readers[b]
    for i, slot, lane in ((7, -1, 0), (9, n_slots + 3, 0), (11, -1, -1),
                          (13, 5, n_locks)):
        if i < m:
            slots[i], lanes[i] = slot, lane
    return dict(table=table, rbias=rbias, slots=slots, lanes=lanes, ids=ids,
                vals=vals, readers=readers, mask=mask)


def _jax_k1(c, slots, ids):
    rows = c["table"].size // 128
    t, g = JTP._fused_publish_multi_call(
        jnp.asarray(c["table"].reshape(rows, 128)), jnp.asarray(c["rbias"]),
        jnp.asarray(slots), jnp.asarray(c["lanes"]), jnp.asarray(ids),
        interpret=True)
    return np.asarray(t).reshape(-1), np.asarray(g)


def _jax_k2(c, rbias, slots, ids, **kw):
    rows = c["table"].size // 128
    t, g = JTP._fused_publish_call(
        jnp.asarray(c["table"].reshape(rows, 128)),
        jnp.asarray(rbias, jnp.int32), jnp.asarray(slots), jnp.asarray(ids),
        interpret=True, **kw)
    return np.asarray(t).reshape(-1), np.asarray(g)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _eq(got, want):
    """Tables, and grants where both sides have them, exactly equal."""
    for g, w in zip(got, want):
        if g is not None and w is not None:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", MS)
def test_k1_decisions_match_pallas_and_ref(m):
    """K1, explicit slots and the registry's hashed acquire: the
    transcription against ``_fused_publish_multi_call`` and the port's
    ``publish_multi_ref`` / ``acquire_hashed_ref``."""
    c = placed_case(m, m)
    table = c["table"]
    got = k1(table, c["rbias"], c["slots"], c["lanes"], c["ids"])
    _eq(got, _jax_k1(c, c["slots"], c["ids"]))
    want = R.publish_multi_ref(_t(table).reshape(-1, 128), _t(c["rbias"]),
                               _t(c["slots"]), _t(c["lanes"]), _t(c["ids"]))
    _eq(got, (want[0].reshape(-1).numpy(), want[1].numpy()))
    hs, hv = hashed_slots(table.size, c["vals"], c["lanes"], c["readers"])
    got = k1(table, c["rbias"], hs, c["lanes"], hv)
    _eq(got, _jax_k1(c, hs, hv))
    want = R.acquire_hashed_ref(_t(table).reshape(-1, 128), _t(c["rbias"]),
                                _t(c["vals"]), _t(c["lanes"]),
                                _t(c["readers"]))
    _eq(got, (want[0].reshape(-1).numpy(), want[1].numpy()))
    assert got[1].any() and not got[1].all()


@pytest.mark.parametrize("m", MS)
def test_k2_decisions_match_pallas_and_ref(m):
    """K2: the conditional publish under a set and a cleared bias, the
    clear, the single-lock hashed acquire on 64-bit reader ids and the
    masked release, against ``_fused_publish_call`` and the port's plain
    versions."""
    c = placed_case(m + 100, m)
    table, slots, ids = c["table"], c["slots"], c["ids"]
    t2 = _t(table).reshape(-1, 128)
    for rb in (0, 1):
        got = k2(table, rb, slots, ids)
        _eq(got, _jax_k2(c, rb, slots, ids))
        want = R.publish_ref(t2, torch.tensor(rb, dtype=torch.int32),
                             _t(slots), _t(ids))
        _eq(got, (want[0].reshape(-1).numpy(), want[1].numpy()))
    zeros = np.zeros_like(ids)
    got = k2(table, 1, slots, zeros, unconditional=True, check_rbias=False)
    _eq(got, _jax_k2(c, 1, slots, zeros, unconditional=True,
                     check_rbias=False))
    _eq(got, (R.clear_ref(t2, _t(slots)).reshape(-1).numpy(), None))
    # the single-lock lease table's acquire: 64-bit host reader ids
    r64 = c["readers"].astype(np.int64) * (2**31 + 7) + 2**32
    hs, hv = hashed_slots(table.size, c["vals"], c["lanes"], r64)
    got = k2(table, 1, hs, hv)
    _eq(got, _jax_k2(c, 1, hs, hv))
    want = R.publish_hashed_ref(t2, torch.tensor(1, dtype=torch.int32),
                                _t(c["vals"]), _t(c["lanes"]), _t(r64))
    _eq(got, (want[0].reshape(-1).numpy(), want[1].numpy()))
    # the release: denied readers masked to slot -1, id 0
    hs, _ = hashed_slots(table.size, c["vals"], c["lanes"], c["readers"])
    ms = np.where(c["mask"], hs, -1).astype(np.int32)
    got = k2(table, 1, ms, zeros, unconditional=True, check_rbias=False,
             granted_out=False)
    _eq(got, _jax_k2(c, 1, ms, zeros, unconditional=True, check_rbias=False))
    want = R.release_hashed_ref(t2, _t(c["vals"]), _t(c["lanes"]),
                                _t(c["readers"]), _t(c["mask"]))
    _eq(got, (want.reshape(-1).numpy(), None))


@pytest.mark.parametrize("m", MS)
def test_warp_order_and_the_release_shortcut_change_nothing(m):
    """The warps of a chunk read and store in any order on the live table
    and every order gives one answer; the release skipping its collision
    checks stores what the full order stores."""
    c = placed_case(m + 200, m)
    table = c["table"]
    hs, hv = hashed_slots(table.size, c["vals"], c["lanes"], c["readers"])
    runs = [
        lambda **kw: k1(table, c["rbias"], c["slots"], c["lanes"], c["ids"],
                        **kw),
        lambda **kw: k1(table, c["rbias"], hs, c["lanes"], hv, **kw),
        lambda **kw: k2(table, 1, c["slots"], c["ids"], **kw),
        lambda **kw: k2(table, 1, c["slots"], c["ids"], unconditional=True,
                        check_rbias=False, **kw),
    ]
    for run in runs:
        want = run()
        for order, seed in (("reverse", 0), ("random", 1), ("random", 2)):
            _eq(run(order=order, seed=seed), want)
    ms = np.where(c["mask"], hs, -1).astype(np.int32)
    zeros = np.zeros_like(c["ids"])
    full = k2(table, 1, ms, zeros, unconditional=True, check_rbias=False)
    for order in ("forward", "reverse"):
        short = lease_kernel(table, ms, zeros, np.ones(m, bool),
                             conditional=False, any_order=True,
                             granted_out=False, order=order)
        np.testing.assert_array_equal(short[0], full[0])


@pytest.mark.parametrize("m,rows,n_locks", [(33, 512, 129), (1025, 512, 128),
                                            (1025, 32, 129), (64, 512, 200)])
def test_large_tables_and_lane_counts(m, rows, n_locks):
    """A table of 65,536 slots and lane counts past 128 (the registry's
    most): K1 and the K2 release against Pallas and the port's plain
    versions."""
    c = placed_case(m + rows + n_locks, m, rows=rows, n_locks=n_locks)
    table = c["table"]
    hs, hv = hashed_slots(table.size, c["vals"], c["lanes"], c["readers"])
    got = k1(table, c["rbias"], hs, c["lanes"], hv)
    _eq(got, _jax_k1(c, hs, hv))
    want = R.acquire_hashed_ref(_t(table).reshape(rows, 128), _t(c["rbias"]),
                                _t(c["vals"]), _t(c["lanes"]),
                                _t(c["readers"]))
    _eq(got, (want[0].reshape(-1).numpy(), want[1].numpy()))
    got = k1(table, c["rbias"], c["slots"], c["lanes"], c["ids"])
    _eq(got, _jax_k1(c, c["slots"], c["ids"]))
    ms = np.where(c["mask"], hs, -1).astype(np.int32)
    zeros = np.zeros_like(c["ids"])
    got = k2(table, 1, ms, zeros, unconditional=True, check_rbias=False)
    _eq(got, _jax_k2(c, 1, ms, zeros, unconditional=True, check_rbias=False))
    want = R.release_hashed_ref(_t(table).reshape(rows, 128), _t(c["vals"]),
                                _t(c["lanes"]), _t(c["readers"]),
                                _t(c["mask"]))
    _eq(got, (want.reshape(-1).numpy(), None))


def test_hash_transcription_matches_the_port():
    """The kernel's native uint64 splitmix64 against the port's slot hash
    (``ref.hashed_requests``), 32- and 64-bit reader ids."""
    rng = np.random.default_rng(5)
    vals = rng.integers(-2**31, 2**31 - 1, 16).astype(np.int32)
    lanes = rng.integers(-1, 17, 300).astype(np.int32)
    for readers in (rng.integers(-2**31, 2**31 - 1, 300).astype(np.int32),
                    rng.integers(-2**63, 2**63 - 1, 300, dtype=np.int64)):
        got, _ = hashed_slots(4096, vals, lanes, readers)
        _, _, want = R.hashed_requests(torch.zeros(32, 128, dtype=torch.int32),
                                       _t(vals), _t(lanes), _t(readers))
        np.testing.assert_array_equal(got, want.numpy())


def test_chip_smoke_builds_match_the_wrappers_switches():
    """``chip_smoke.py`` builds the table kernels' source twice, with the
    switches the wrappers load each build with, so that each is built
    once: the shipped design and the parent K1/K2 design (timing only)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    table = cs.SOURCES["table"]
    assert cs.BUILDS["table"] == (table, ())
    assert cs.BUILDS["table_parent"] == (table, TP.PARENT_DEFINES)
    assert [k for k, (src, _) in cs.BUILDS.items() if src == table] == [
        "table", "table_parent"]


def test_floor_launches_refuse_what_they_do_not_take():
    """The timing floors run on the card only, one warp of int32."""
    x = torch.zeros(32, dtype=torch.int32)
    with pytest.raises(ValueError):
        TS.load_floor_launch(x, x.clone())
    with pytest.raises(ValueError):
        TS.chain_floor_launch(x, x.clone(), x.clone())
