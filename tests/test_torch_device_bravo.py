"""The single-lock lease table and the legacy table kernels of the port
against ``repro`` (on the CPU, through the kernels' plain versions).

* K9's plain version (``revocation_scan``) against ``repro``'s Pallas
  ``_scan_call`` in interpret mode;
* K10's plain version (``publish``/``clear``) against
  ``repro.kernels.ref.publish_ref``/``clear_ref`` where those are defined,
  and against a numpy transcription of the Pallas ``_publish_kernel`` body
  (dead under the installed jax, ROADMAP R1) where ``publish_ref`` differs:
  duplicate unconditional stores and id 0; slot -1 is the port's own
  choice (R9), pinned here;
* the hashed K2 acquire against ``repro``'s fused acquire program;
* the functional ``DeviceLeaseState`` protocol, ``DeviceLeaseTable`` and
  ``LeaseHandle`` against ``repro.core.device_bravo``.

Every result is an integer: all comparisons are exact."""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_bravo as JDB
from repro.kernels import ops as JK
from repro.kernels import ref as JREF
from repro.kernels.table_scan import _scan_call
from repro_torch.core import device_bravo as TDB
from repro_torch.kernels import ops as TK
from repro_torch.kernels import table_publish as TP

LANES = 128


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _eq(jax_arr, torch_t):
    np.testing.assert_array_equal(np.asarray(jax_arr), torch_t.numpy())


# ---------------------------------------------------------------------------
# K9: the revocation scan
# ---------------------------------------------------------------------------


def _scan_table(rows: int, case: str):
    rng = np.random.default_rng(rows)
    if case == "all":
        return np.full((rows, LANES), 9, np.int32), 9
    table = rng.integers(1, 50, (rows, LANES)).astype(np.int32)
    if case == "none":
        return table, 77
    table.reshape(-1)[rng.choice(rows * LANES, 37, replace=False)] = 77
    return table, 77


@pytest.mark.parametrize("case", ["none", "some", "all"])
@pytest.mark.parametrize("rows", [8, 32, 64])
def test_scan_plain_matches_jax_kernel(rows, case):
    table, lock = _scan_table(rows, case)
    jm, jc = _scan_call(jnp.asarray(table), jnp.asarray(lock, jnp.int32),
                        interpret=True)
    tm, tc = TK.revocation_scan(_t(table), lock)
    assert tm.dtype == torch.int8 and tc.dtype == torch.int32
    _eq(jm, tm)
    assert int(jc) == int(tc)


def test_scan_takes_whole_row_blocks_only():
    with pytest.raises(ValueError, match="multiple of 8"):
        TK.revocation_scan(torch.zeros(4, LANES, dtype=torch.int32), 1)


# ---------------------------------------------------------------------------
# K10: the sequential publish
# ---------------------------------------------------------------------------


def _publish_kernel_np(table, slots, ids, unconditional):
    """``repro.kernels.table_publish._publish_kernel``'s body, line for
    line, in numpy: copy the table, then the ``fori_loop`` over requests."""
    out = table.copy()
    granted = np.zeros(len(slots), np.int8)
    for i in range(len(slots)):
        slot = int(slots[i])
        row, col = slot // LANES, slot % LANES
        cur = out[row, col]
        val = ids[i]
        ok = True if unconditional else cur == 0
        out[row, col] = val if ok else cur
        granted[i] = ok
    return out, granted.astype(bool)


def _seq_case(seed: int):
    """~7% occupancy, M in-range requests colliding with each other and
    with occupied slots, non-zero ids."""
    rng = np.random.default_rng(seed)
    m = [1, 4, 16, 64, 200, 33][seed]
    table = np.zeros((32, LANES), np.int32)
    occ = rng.choice(4096, 300, replace=False)
    table.reshape(-1)[occ] = rng.integers(1, 50, 300)
    pool = np.concatenate([occ[:5], rng.choice(4096, max(2, m // 4))])
    slots = rng.choice(pool, m).astype(np.int32)
    ids = rng.integers(1, 1000, m).astype(np.int32)
    return table, slots, ids


@pytest.mark.parametrize("seed", range(6))
def test_publish_plain_matches_jax_ref(seed):
    table, slots, ids = _seq_case(seed)
    jt, jg = JREF.publish_ref(jnp.asarray(table), jnp.asarray(slots),
                              jnp.asarray(ids))
    tt = _t(table)
    out, tg = TK.publish(tt, _t(slots), _t(ids))
    _eq(jt, out)
    _eq(jg, tg)
    np.testing.assert_array_equal(tt.numpy(), table)   # a NEW table
    # the legacy release: unconditional zeros (duplicates store one value)
    _eq(JREF.clear_ref(jt, jnp.asarray(slots)), TK.clear(out, _t(slots)))


@pytest.mark.parametrize("unconditional", [False, True])
@pytest.mark.parametrize("case", ["duplicates", "zero_ids", "random"])
def test_publish_plain_matches_kernel_body(case, unconditional):
    """Where ``publish_ref`` is not the kernel: duplicate slots with
    different ids (unconditional: the last one stays) and id 0 (a
    conditional publish of 0 leaves the slot free for a later request)."""
    rng = np.random.default_rng(7)
    table = np.zeros((8, LANES), np.int32)
    table.reshape(-1)[[3, 9]] = [4, 6]
    if case == "duplicates":
        slots = np.array([5, 5, 5, 3, 3, 9], np.int32)
        ids = np.array([11, 12, 13, 14, 15, 16], np.int32)
    elif case == "zero_ids":
        slots = np.array([5, 5, 5, 3, 7, 7], np.int32)
        ids = np.array([0, 0, 21, 0, 0, 22], np.int32)
    else:
        slots = rng.integers(0, 16, 40).astype(np.int32)
        ids = rng.integers(0, 3, 40).astype(np.int32)
    want_t, want_g = _publish_kernel_np(table, slots, ids, unconditional)
    got_t, got_g = TP.publish(_t(table), _t(slots), _t(ids),
                              unconditional=unconditional)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_array_equal(got_g.numpy(), want_g)


@pytest.mark.parametrize("unconditional", [False, True])
def test_publish_slot_outside_the_table_reads_free_and_stores_nothing(
        unconditional):
    """R9: the port's choice for a slot outside ``[0, n_slots)``, as K1/K2
    do it.  ``repro``'s ``publish_ref`` wraps -1 to the LAST slot (and the
    Pallas body would index row -1); the port leaves the table alone and
    grants the request (the slot reads as free)."""
    table = np.zeros((8, LANES), np.int32)
    table.reshape(-1)[-1] = 5
    slots = np.array([-1, 1024, 2, -1], np.int32)
    ids = np.array([7, 8, 9, 10], np.int32)
    got_t, got_g = TP.publish(_t(table), _t(slots), _t(ids),
                              unconditional=unconditional)
    want = table.copy()
    want.reshape(-1)[2] = 9
    np.testing.assert_array_equal(got_t.numpy(), want)
    assert got_g.tolist() == [True] * 4
    # the R9 divergence: repro's publish_ref reads (conditional: the slot
    # is taken, so no grant) or writes (unconditional) the last slot
    jt, jg = JREF.publish_ref(jnp.asarray(table), jnp.asarray(slots),
                              jnp.asarray(ids), unconditional=unconditional)
    assert not (np.array_equal(np.asarray(jt), want)
                and np.array_equal(np.asarray(jg), got_g.numpy()))


def test_publish_wrappers_reject_what_the_kernel_does_not_take():
    t = torch.zeros(8, LANES, dtype=torch.int32)
    s = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="ids"):
        TK.publish(t, s, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="slots"):
        TK.clear(t, s.long())
    with pytest.raises(ValueError, match="table"):
        TK.publish(t.reshape(-1), s, s)


# ---------------------------------------------------------------------------
# K2 as the single-lock acquire
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_hashed_acquire_matches_jax_fused_program(seed):
    """``publish_hashed`` (hash + publish + rbias recheck in one K2 launch)
    against ``repro``'s fused acquire program, on occupied tables with
    duplicate readers, under a set and a clear bias."""
    rng = np.random.default_rng(seed)
    m = [1, 4, 16, 64, 256, 33][seed]
    table = np.zeros((32, LANES), np.int32)
    table.reshape(-1)[rng.choice(4096, 300, replace=False)] = 5
    rids = rng.integers(0, 2**31 - 1, m).astype(np.int32)
    rids[m // 2:] = rids[:m - m // 2]
    lock = int(rng.integers(1, 2**31 - 1))
    for rbias in (0, 1):
        lh, ll = JDB._lock_limbs(lock)
        jt, _, jg = JDB._programs().acquire_ids32(
            jnp.asarray(table), jnp.zeros((), jnp.int32),
            jnp.asarray(rbias, jnp.int32), jnp.asarray(rids), lh, ll,
            jnp.asarray(lock, jnp.int32))
        tt = _t(table)
        tg = TP.publish_hashed(tt, torch.tensor(rbias, dtype=torch.int32),
                               torch.tensor([lock], dtype=torch.int32), None,
                               _t(rids))
        _eq(jt, tt)
        _eq(jg, tg)


# ---------------------------------------------------------------------------
# The functional protocol, the lease table and its handles
# ---------------------------------------------------------------------------


def _held(jax_table, torch_table, lock) -> bool:
    """Zero or not, the same on both sides; -> held."""
    j = int(JK.revocation_poll(jax_table, lock))
    t = int(TK.revocation_poll(torch_table, lock))
    assert (j == 0) == (t == 0), (j, t)
    return t > 0


def test_functional_protocol_matches_jax():
    readers = np.arange(8)
    js, ts = JDB.init_state(), TDB.init_state(device="cpu")

    def same(jg=None, tg=None):
        _eq(js.table, ts.table)
        assert int(js.rbias) == int(ts.rbias)
        if jg is not None:
            _eq(jg, tg)

    js, jg = JDB.acquire(js, lock_id=7, reader_ids=readers)
    ts, tg = TDB.acquire(ts, lock_id=7, reader_ids=readers)
    same(jg, tg)
    assert tg.all() and _held(js.table, ts.table, 7)
    # the same readers again collide with themselves: all denied
    js, jg = JDB.acquire(js, 7, readers)
    ts, tg = TDB.acquire(ts, 7, readers)
    same(jg, tg)
    assert not tg.any()
    js, ts = JDB.release(js, 7, readers), TDB.release(ts, 7, readers)
    same()
    assert not _held(js.table, ts.table, 7)
    # the writer: rbias cleared, leases drained, inhibit set
    js, jscans = JDB.revoke(js, 7)
    ts, tscans = TDB.revoke(ts, 7)
    same()
    assert int(ts.rbias) == 0 and tscans == jscans >= 1
    assert ts.inhibit_until_ns > 0
    js, jg = JDB.acquire(js, 7, readers)       # bias off: no fast path
    ts, tg = TDB.acquire(ts, 7, readers)
    same(jg, tg)
    assert not tg.any() and not _held(js.table, ts.table, 7)
    js.inhibit_until_ns = ts.inhibit_until_ns = 0
    js, ts = JDB.rearm(js), TDB.rearm(ts)
    same()
    assert int(ts.rbias) == 1


def test_denied_reader_release_keeps_winner_lease():
    """A reader whose publish was DENIED must not clear the winner's slot
    on release: the grant mask gates the clear (table API and functional
    API, each against ``repro``'s)."""
    jtbl, ttbl = JDB.DeviceLeaseTable(), TDB.DeviceLeaseTable(device="cpu")
    jh, th = jtbl.handle(lock_id=41), ttbl.handle(lock_id=41)
    jr, tr = jnp.asarray([3, 4, 5], jnp.int32), torch.tensor(
        [3, 4, 5], dtype=torch.int32)
    jg1, tg1 = jh.acquire(jr), th.acquire(tr)
    jg2, tg2 = jh.acquire(jr), th.acquire(tr)
    _eq(jg1, tg1)
    _eq(jg2, tg2)
    assert tg1.all() and not tg2.any()
    jh.release(jr, granted=jg2)
    th.release(tr, granted=tg2)
    _eq(jtbl.state.table, ttbl.state.table)
    assert _held(jtbl.state.table, ttbl.state.table, 41)
    jh.release(jr, granted=jg1)
    th.release(tr, granted=tg1)
    assert not _held(jtbl.state.table, ttbl.state.table, 41)

    readers = np.arange(10, 14)
    js, ts = JDB.init_state(), TDB.init_state(device="cpu")
    js, jf1 = JDB.acquire(js, 9, readers)
    ts, tf1 = TDB.acquire(ts, 9, readers)
    js, jf2 = JDB.acquire(js, 9, readers)
    ts, tf2 = TDB.acquire(ts, 9, readers)
    js = JDB.release(js, 9, readers, granted=jf2)
    ts = TDB.release(ts, 9, readers, granted=tf2)
    _eq(js.table, ts.table)
    assert _held(js.table, ts.table, 9)
    js = JDB.release(js, 9, readers, granted=jf1)
    ts = TDB.release(ts, 9, readers, granted=tf1)
    assert not _held(js.table, ts.table, 9)


def test_lease_table_matches_jax():
    """Two handles with explicit lock ids on one table: grant masks,
    tables and ``stats()`` equal after every step, through a revocation
    that switches off BOTH handles' fast path (one scalar bias)."""
    jtbl, ttbl = JDB.DeviceLeaseTable(), TDB.DeviceLeaseTable(device="cpu")
    jh = [jtbl.handle(lock_id=v) for v in (101, 202)]
    th = [ttbl.handle(lock_id=v) for v in (101, 202)]
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 1 << 20, 24).astype(np.int32)
               for _ in range(2)]
    batches[1][:6] = batches[0][:6]

    def step(k, rids):
        jg = jh[k].acquire(jnp.asarray(rids))
        tg = th[k].acquire(_t(rids))
        _eq(jg, tg)
        _eq(jtbl.state.table, ttbl.state.table)
        return jg, tg

    g0, g1 = step(0, batches[0]), step(1, batches[1])
    assert g0[1].all()
    assert jtbl.stats() == ttbl.stats()
    for k, (jg, tg) in enumerate((g0, g1)):
        jh[k].release(jnp.asarray(batches[k]), granted=jg)
        th[k].release(_t(batches[k]), granted=tg)
        _eq(jtbl.state.table, ttbl.state.table)
    assert not ttbl.state.table.any()
    # a huge inhibit multiplier keeps the window open for the whole test
    assert jh[0].revoke(n=10**6) == th[0].revoke(n=10**6)
    assert jtbl.stats() == ttbl.stats()
    assert ttbl.stats()["rbias"] == 0
    for k in (0, 1):                       # the shared bias is off for both
        assert not th[k].rearm()
        jg, tg = step(k, batches[k])
        assert not tg.any()
    jtbl.state.inhibit_until_ns = 0
    ttbl.state.inhibit_until_ns = 0
    assert jh[1].rearm() and th[1].rearm()
    assert jtbl.stats() == ttbl.stats()
    g0 = step(0, batches[0])
    assert g0[1].all()
    assert jtbl.stats() == ttbl.stats()


@pytest.mark.parametrize("impl", ["repro", "port"])
def test_shared_bias_gate_blocks_every_rearm_during_a_drain(impl):
    """While one lock's drain runs, ``rearm`` on ANY handle of the table
    returns False: the one scalar bias cannot be re-armed under a drain."""
    if impl == "repro":
        tbl, rids = JDB.DeviceLeaseTable(), jnp.asarray([1, 2, 3], jnp.int32)
    else:
        tbl = TDB.DeviceLeaseTable(device="cpu")
        rids = torch.tensor([1, 2, 3], dtype=torch.int32)
    ha, hb = tbl.handle(lock_id=301), tbl.handle(lock_id=302)
    held = ha.acquire(rids)
    done = {}
    writer = threading.Thread(
        target=lambda: done.setdefault("scans", ha.revoke(
            max_wait_s=60.0, wait_poll_s=0.001)))
    writer.start()
    deadline = time.monotonic() + 30
    while not tbl._revoking:
        assert time.monotonic() < deadline, "the drain never started"
        time.sleep(0.001)
    assert not hb.rearm() and not ha.rearm()
    ha.release(rids, granted=held)          # the reader leaves: drain ends
    writer.join(timeout=60)
    assert not writer.is_alive() and done["scans"] >= 1
    tbl.state.inhibit_until_ns = 0
    assert hb.rearm() and ha.rearm()


def test_host_reader_ids_must_fit_32_bits():
    """Host reader ids at and past 2**32 hash over all 64 bits, to the
    slots ``repro``'s host limbs give (the port refused them before); a
    negative id and a lock id past int32 are refused."""
    readers = np.array([2**32, 2**40 + 7, 2**63 - 1, 5], np.uint64)
    js, ts = JDB.init_state(), TDB.init_state(device="cpu")
    js, jg = JDB.acquire(js, 7, readers)
    ts, tg = TDB.acquire(ts, 7, readers)
    _eq(js.table, ts.table)
    _eq(jg, tg)
    assert tg.all()
    flat = ts.table.reshape(-1).numpy()
    assert (flat[JDB.slots_for(7, readers)] == 7).all()
    js = JDB.release(js, 7, readers, granted=jg)
    ts = TDB.release(ts, 7, readers, granted=tg)
    _eq(js.table, ts.table)
    assert not ts.table.any()
    with pytest.raises(ValueError, match="2\\*\\*64"):
        TDB.acquire(ts, 7, np.array([-1]))
    with pytest.raises(ValueError, match="int32"):
        TDB.acquire(ts, 2**31, np.arange(4))
