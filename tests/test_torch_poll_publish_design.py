"""The decision orders of the K3 drain poll and the K10 sequential publish
(``csrc/table_kernels.cu`` ``poll_kernel`` and ``publish_seq_kernel``),
transcribed in numpy, against ``repro``'s Pallas kernels and the port's
plain versions.

K10's transcription follows the kernel step by step: the launch
(``seq_grid``: one thread per request in chunks of the block, the table
cut into one slice a CTA, each slice copied before that CTA's barrier;
every CTA makes every decision and stores those in its slice); within a warp, ``__match_any_sync``
over the slots masked by the ballot of the listing lanes (conditional: a
nonzero id in the table; unconditional: any request in the table) names
the requests with an earlier listing request (conditional) or a later one
(unconditional); across warps, each warp's entries go to one list (rows
padded with the row's first slot) that the later (or earlier) warps scan;
a chunk scans the lists of the chunks before (or after) it.  It asserts
that at most one request stores each slot.  The kernel's closed form is
also written directly and held to the sequential loop by a property test.
R1 leaves ``_publish_call`` dead under the installed jax, so K10 is held to
``ref.publish_seq_ref`` and to the numpy transcription of the Pallas
``_publish_kernel`` body in ``test_torch_device_bravo.py`` (on slots inside
the table, where that body is defined).

K3's transcription reads 16-byte groups of four slots, each thread's
groups a trip, per-thread partials, warp sums, then one sum across warps,
for each layout the launcher ships; it is held to ``ref.poll_ref``, to
``repro``'s ``_scan_call`` count (exact) and to ``_poll_call`` (zero
against non-zero), both in Pallas interpret mode.

Inputs come from a numpy seed: ``chip_smoke._seq_placed_case``'s placed
collisions at the batches and table sizes the card checks.  Everything is
exact.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.table_scan import _poll_call, _scan_call
from repro_torch.kernels import ref as R
from repro_torch.kernels import table_publish as TP
from test_torch_device_bravo import _publish_kernel_np

WARP = 32
CHUNK = 1024
SMALL_TABLE = 4096          # slots: the table every caller uses
COPY_GROUPS = 4             # K10: 16-byte groups a thread copies
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


CS = _chip_smoke()


# ---------------------------------------------------------------------------
# K10: the transcription and the closed form
# ---------------------------------------------------------------------------


def seq_grid(m, n_slots):
    """The launch: one thread per request of a chunk (M rounded up to a
    warp, at least one warp, at most 1024), the table cut into slices of
    four groups of four slots a thread, one slice a CTA.  -> (threads,
    slice in groups, CTAs)."""
    threads = -(-m // WARP) * WARP if m < CHUNK else CHUNK
    threads = max(threads, WARP)
    slice_ = threads * COPY_GROUPS
    return threads, slice_, max(1, -(-(n_slots // 4) // slice_))


def list_rows(slot, flag, n_warps):
    """``list_row`` of every warp: the slots of its flagged lanes in lane
    order, padded to 32 with the first of them (lane 0's slot when none)."""
    rows, counts = [], []
    for w in range(n_warps):
        s, f = slot[w * WARP:(w + 1) * WARP], flag[w * WARP:(w + 1) * WARP]
        row = [int(x) for x in s[f]]
        counts.append(len(row))
        rows.append(row + [row[0] if row else int(s[0])] * (WARP - len(row)))
    return rows, counts


def listed(slot, rows, counts, lo, hi):
    """Whether a list of the warps in [lo, hi) holds ``slot``."""
    return any(counts[w] and slot in rows[w] for w in range(lo, hi))


def warps_holding(n, n_warps):
    return min(n_warps, -(-n // WARP))


def publish_seq_kernel(table, slots, ids, unconditional):
    """The kernel's decisions, which every CTA makes alike: -> (new table,
    granted).  Each CTA copies its slice before its barrier and stores the
    decisions whose slot lies in it; the slices cover the table once."""
    flat = table.reshape(-1)
    n_slots, m = flat.size, len(slots)
    chunk, slice_, blocks = seq_grid(m, n_slots)
    n_warps = chunk // WARP
    groups = np.arange(n_slots // 4)
    assert np.array_equal(np.bincount(groups // slice_, minlength=blocks),
                          [min(slice_, n_slots // 4 - b * slice_)
                           for b in range(blocks)])
    out = np.zeros_like(flat)
    for b in range(blocks):            # each CTA's copy of its slice
        g = groups[b * slice_:(b + 1) * slice_]
        out[4 * g[0]:4 * g[-1] + 4] = flat[4 * g[0]:4 * g[-1] + 4]
    granted = np.zeros(m, bool)
    lane = np.arange(WARP)
    other = (lane[None, :] > lane[:, None] if unconditional
             else lane[None, :] < lane[:, None])
    stores = []

    def requests(base):
        i = base + np.arange(chunk)
        active = i < m
        j = np.where(active, i, 0)
        s, d = slots[j], ids[j]
        inside = active & (s >= 0) & (s < n_slots)
        return i, active, s, d, inside, inside & (unconditional | (d != 0))

    for base in range(0, m, chunk):
        i, active, s, d, inside, lists = requests(base)
        t0 = np.where(inside & (not unconditional),
                      flat[np.clip(s, 0, n_slots - 1)], 0)
        decide = inside.copy()
        for w in range(n_warps):        # match & ballot within each warp
            ws = slice(w * WARP, (w + 1) * WARP)
            same = (s[ws][:, None] == s[ws][None, :]) & lists[ws][None, :]
            decide[ws] &= ~(same & other).any(axis=1)
        lead = lists & decide
        lo, hi = (base + chunk, m) if unconditional else (0, base)
        for b2 in range(lo, hi, chunk):  # the other chunks' lists
            _, _, s2, _, _, l2 = requests(b2)
            rows, counts = list_rows(s2, l2, n_warps)
            nh = warps_holding(m - b2, n_warps)
            for t in np.flatnonzero(decide):
                decide[t] = not listed(s[t], rows, counts, 0, nh)
        rows, counts = list_rows(s, lead, n_warps)   # this chunk's lists
        nh = warps_holding(m - base, n_warps)
        for t in np.flatnonzero(decide):
            w = t // WARP
            decide[t] = not (listed(s[t], rows, counts, w + 1, nh)
                             if unconditional
                             else listed(s[t], rows, counts, 0, w))
        for t in np.flatnonzero(active):
            if decide[t] and (unconditional or (d[t] != 0 and t0[t] == 0)):
                stores.append((int(s[t]), int(d[t])))
            granted[i[t]] = (not inside[t] or unconditional
                             or (decide[t] and t0[t] == 0))
    # after each CTA's barrier, by the CTA whose slice holds the slot, in
    # no fixed order: at most one store a slot
    assert len({slot for slot, _ in stores}) == len(stores)
    for b in range(blocks):
        for slot, v in stores:
            if slot // 4 // slice_ == b:
                out[slot] = v
    return out.reshape(table.shape), granted


def closed_form(table, slots, ids, unconditional):
    """K10's outcome slot by slot: conditional, a request is granted iff
    its slot held 0 and no earlier request for it had a nonzero id, and the
    slot ends as the first nonzero id; unconditional, all are granted and
    the slot ends as the last id.  Slots outside the table: granted, no
    store."""
    flat = table.reshape(-1)
    out, n = flat.copy(), flat.size
    granted = np.ones(len(slots), bool)
    for slot in np.unique(slots[(slots >= 0) & (slots < n)]):
        idx = np.flatnonzero(slots == slot)
        if unconditional:
            out[slot] = ids[idx[-1]]
            continue
        nonzero = idx[ids[idx] != 0]
        first = nonzero[0] if nonzero.size else len(slots)
        granted[idx] = (flat[slot] == 0) & (idx <= first)
        if flat[slot] == 0 and nonzero.size:
            out[slot] = ids[first]
    return out.reshape(table.shape), granted


def _plain(table, slots, ids, unconditional):
    t, g = R.publish_seq_ref(*(torch.from_numpy(np.array(x, copy=True))
                               for x in (table, slots, ids)),
                             unconditional=unconditional)
    return t.numpy(), g.numpy()


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("unconditional", [False, True])
@pytest.mark.parametrize("m", CS.SEQ_MS)
def test_k10_decisions_match_the_loop(m, unconditional):
    """The transcription against the plain version on ``chip_smoke``'s
    placed cases at every table size it checks, and against the Pallas
    body's transcription with the slots outside the table folded into
    it."""
    rng = np.random.default_rng(m)
    for rows in CS.TABLE_ROWS:
        table, slots, ids = CS._seq_placed_case(rng, m, rows)
        got = publish_seq_kernel(table, slots, ids, unconditional)
        _same(got, _plain(table, slots, ids, unconditional))
        _same(closed_form(table, slots, ids, unconditional), got)
        inside = (slots % table.size).astype(np.int32)
        _same(publish_seq_kernel(table, inside, ids, unconditional),
              _publish_kernel_np(table, inside, ids, unconditional))


def test_k10_placements_reach_warps_and_chunks():
    """The placed collisions are where the docstring says: one free slot
    twice in one warp, across warps and across chunks, id 0 before and
    after a nonzero id, an occupied slot, slots -2, -1 and n_slots."""
    table, slots, ids = CS._seq_placed_case(np.random.default_rng(0),
                                            CS.BIG_BATCH, 32)
    flat = table.reshape(-1)
    for group in ((4, 29), (3, 40), (1000, 1030), (10, 1500, 2500),
                  (6, 45), (1020, 1028), (8, 50)):
        assert len({int(slots[i]) for i in group}) == 1
        assert flat[slots[group[0]]] == 0
    assert ids[6] == 0 != ids[45] and ids[1020] == 0 != ids[1028]
    assert ids[8] != 0 == ids[50]
    assert slots[12] == slots[60] and flat[slots[12]] != 0
    assert slots[14:17].tolist() == [-2, -1, 4096]


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_k10_closed_form_matches_the_loop(data):
    """Property: the closed form, and the kernel's transcription, equal the
    sequential loop on random tables and requests (slots colliding in a
    small range that includes -2, -1 and n_slots, ids in 0-3)."""
    rows = data.draw(st.sampled_from([1, 2]))
    n = rows * 128
    cells = data.draw(st.lists(st.integers(0, 3), min_size=8, max_size=8))
    table = np.zeros(n, np.int32)
    table[:8] = cells
    m = data.draw(st.integers(0, 90))
    slots = np.array(data.draw(st.lists(
        st.sampled_from([-2, -1, 0, 1, 2, 3, 4, 5, n - 1, n]),
        min_size=m, max_size=m)), np.int32)
    ids = np.array(data.draw(st.lists(st.integers(0, 3), min_size=m,
                                      max_size=m)), np.int32)
    unconditional = data.draw(st.booleans())
    table = table.reshape(rows, 128)
    want = _plain(table, slots, ids, unconditional)
    _same(closed_form(table, slots, ids, unconditional), want)
    _same(publish_seq_kernel(table, slots, ids, unconditional), want)


@pytest.mark.parametrize("m,rows,blocks", [(0, 32, 8), (1, 8, 2),
                                           (64, 32, 4), (1024, 32, 1),
                                           (3000, 8192, 64)])
def test_k10_grid_cuts_the_table_into_slices(m, rows, blocks):
    """The slices cover the table once whatever the batch: a small batch
    spreads the 4096-slot copy over 4-8 CTAs, a chunk of 1024 copies it in
    one; an empty batch still copies."""
    table = np.arange(rows * 128, dtype=np.int32).reshape(rows, 128)
    assert seq_grid(m, table.size)[2] == blocks
    out, granted = publish_seq_kernel(table, np.zeros(m, np.int32),
                                      np.zeros(m, np.int32), True)
    np.testing.assert_array_equal(out.reshape(-1)[1:], table.reshape(-1)[1:])
    assert granted.all() and granted.size == m


def test_k10_wrapper_takes_tables_past_the_old_limit():
    """No table limit is left in the wrapper (the parent kernel refused
    tables past 56,064 slots); on the CPU it runs the plain version."""
    assert not hasattr(TP, "MAX_SEQ_SLOTS")
    table, slots, ids = CS._seq_placed_case(np.random.default_rng(3), 64,
                                            8192)
    got = TP.publish(torch.from_numpy(table), torch.from_numpy(slots),
                     torch.from_numpy(ids))
    _same((got[0].numpy(), got[1].numpy()),
          publish_seq_kernel(table, slots, ids, False))


# ---------------------------------------------------------------------------
# K3: the transcription
# ---------------------------------------------------------------------------

# (warps, 16-byte loads a thread a trip) of the layouts the launcher picks:
# up to 4096 slots, and past it (where 8 warps loop and 32 warps of one
# load a trip ran faster on the card)
POLL_LAYOUTS = {"small": (8, 4), "wide": (32, 1)}


def poll_layout(n_slots):
    return POLL_LAYOUTS["small" if n_slots <= SMALL_TABLE else "wide"]


def poll_kernel(table, lock, warps, loads):
    """The kernel's count: each thread's groups of four slots, ``loads`` a
    trip (a group past the table reads as ``~lock``), per-thread partials,
    one ``__reduce_add_sync`` a warp, then the warps' sums."""
    groups = table.reshape(-1, 4)
    n_groups = groups.shape[0]
    threads = warps * WARP
    tid = np.arange(threads)
    local = np.zeros(threads, np.int64)
    for base in range(0, n_groups, threads * loads):
        v = []
        for q in range(loads):          # every load of the trip first
            g = base + q * threads + tid
            v.append(np.where((g < n_groups)[:, None],
                              groups[np.minimum(g, n_groups - 1)], ~lock))
        for x in v:
            local += (x == lock).sum(axis=1)
    warp_sums = local.reshape(warps, WARP).sum(axis=1)
    return int(warp_sums.sum())


def _poll_table(rows, case):
    """A table of ``rows`` x 128 and a lock in no slot, one slot, only the
    last slot or every slot."""
    rng = np.random.default_rng(rows)
    n = rows * 128
    if case == "every":
        return np.full((rows, 128), 7, np.int32), 7
    flat = rng.integers(1, 50, n).astype(np.int32)
    lock = {"none": 77, "one": 60, "last": 61}[case]
    if case == "one":
        flat[rng.integers(0, n - 1)] = 60
    if case == "last":
        flat[-1] = 61
    return flat.reshape(rows, 128), lock


@pytest.mark.parametrize("case", ["none", "one", "last", "every"])
@pytest.mark.parametrize("rows", CS.TABLE_ROWS)
def test_k3_count_matches_pallas_and_ref(rows, case):
    table, lock = _poll_table(rows, case)
    want = int((table == lock).sum())
    assert int(R.poll_ref(torch.from_numpy(table), lock)) == want
    for warps, loads in POLL_LAYOUTS.values():
        assert poll_kernel(table, lock, warps, loads) == want
    assert poll_kernel(table, lock, *poll_layout(table.size)) == want
    _, count = _scan_call(jnp.asarray(table), jnp.asarray(lock, jnp.int32),
                          interpret=True)
    assert int(count) == want
    lower = int(_poll_call(jnp.asarray(table), jnp.asarray(lock, jnp.int32),
                           interpret=True))
    assert (lower == 0) == (want == 0) and lower <= want


def test_k3_layouts_cover_the_table_in_one_trip():
    """Both layouts read the 4096-slot table in one trip of 16-byte loads:
    8 warps of four loads a thread, or 32 warps of one."""
    for warps, loads in POLL_LAYOUTS.values():
        assert warps * WARP * loads * 4 == SMALL_TABLE
