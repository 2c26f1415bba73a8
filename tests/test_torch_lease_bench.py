"""The port's lease microbenchmarks (``repro_torch.benchmarks``) on the CPU.

* The legacy host-looped lease path of ``device_bravo`` against the same
  composition in ``repro`` (``repro.kernels.ref.publish_ref``/``clear_ref``
  in place of the Pallas ``publish``/``clear``, which are dead under the
  installed jax, ROADMAP R1): tables, grants and the 5 host transfers per
  acquire/release pair, exactly.
* Both entry points in ``--smoke --device cpu``: exit 0, no failed check,
  every section present, and the registry's three bias-flap gates met."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import device_bravo as JDB
from repro.kernels import ref as JREF
from repro_torch.benchmarks import device_bravo as TBD
from repro_torch.benchmarks import registry as TBR
from repro_torch.core import device_bravo as TDB


class _JaxTransfers:
    """``benchmarks/device_bravo.py``'s counting shims, for jax arrays."""

    def __init__(self):
        self.h2d = self.d2h = 0

    def to_device(self, x):
        self.h2d += 1
        return jnp.asarray(x)

    def to_host_int(self, x) -> int:
        self.d2h += 1
        return int(x)

    def to_host_arr(self, x):
        self.d2h += 1
        return np.asarray(x)


def _jax_legacy_acquire(state, lock_id, reader_ids, tc):
    if tc.to_host_int(state.rbias) == 0:
        return state, np.zeros((len(reader_ids),), bool)
    sl = tc.to_device(JDB.slots_for(lock_id, reader_ids))
    ids = jnp.full((len(reader_ids),), lock_id, jnp.int32)
    table, granted = JREF.publish_ref(state.table, sl, ids)
    if tc.to_host_int(state.rbias) == 0:
        table = JREF.clear_ref(table, sl)
        granted = jnp.zeros_like(granted)
    return dataclasses.replace(state, table=table), tc.to_host_arr(granted)


def _jax_legacy_release(state, lock_id, reader_ids, tc):
    sl = tc.to_device(JDB.slots_for(lock_id, reader_ids))
    return dataclasses.replace(state, table=JREF.clear_ref(state.table, sl))


@pytest.mark.parametrize("batch", [1, 16, 64, 300])
def test_legacy_path_matches_jax_composition(batch):
    """Two locks, each batch released after both acquired (at the larger
    batches some readers collide in the table and are denied), then an
    acquire under a cleared bias."""
    rng = np.random.default_rng(batch)
    readers = [rng.integers(0, 1 << 30, batch), rng.integers(0, 1 << 30,
                                                             batch)]
    js, ts = JDB.init_state(), TDB.init_state(device="cpu")
    jtc, ttc = _JaxTransfers(), TBD.TransferCounter(ts.table.device)
    for lock, rids in zip((5, 6), readers):
        js, jg = _jax_legacy_acquire(js, lock, rids, jtc)
        ts, tg = TBD.legacy_acquire(ts, lock, rids, ttc)
        np.testing.assert_array_equal(np.asarray(js.table), ts.table.numpy())
        np.testing.assert_array_equal(jg, tg)
    for lock, rids in zip((5, 6), readers):
        js = _jax_legacy_release(js, lock, rids, jtc)
        ts = TBD.legacy_release(ts, lock, rids, ttc)
        np.testing.assert_array_equal(np.asarray(js.table), ts.table.numpy())
    assert (ttc.h2d, ttc.d2h) == (jtc.h2d, jtc.d2h) == (4, 6)   # 5 a pair
    assert not ts.table.any()
    js = dataclasses.replace(js, rbias=jnp.zeros((), jnp.int32))
    ts = dataclasses.replace(ts, rbias=ts.rbias.new_zeros(()))
    js, jg = _jax_legacy_acquire(js, 5, readers[0], jtc)
    ts, tg = TBD.legacy_acquire(ts, 5, readers[0], ttc)
    np.testing.assert_array_equal(jg, tg)
    assert not tg.any() and not ts.table.any()
    assert (ttc.h2d, ttc.d2h) == (jtc.h2d, jtc.d2h) == (4, 7)


def test_device_bravo_entry_point_on_the_cpu(tmp_path):
    out = tmp_path / "device_bravo.json"
    assert TBD.main(["--smoke", "--device", "cpu", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["failures"] == [] and rec["device"] == "cpu"
    for key in ("correctness", "in_place", "transfers", "latency",
                "collective"):
        assert key in rec, key
    assert rec["correctness"]["verified"]
    assert rec["in_place"]["table_ptr_unchanged"]
    assert rec["in_place"]["legacy_new_table_per_call"]
    assert rec["in_place"]["memory_check"] == "inactive"
    t = rec["transfers"]
    assert (t["legacy_h2d"], t["legacy_d2h"]) == (2, 3)
    assert t["legacy_transfers_per_pair"] == 5
    assert t["fused_sync_gate"] == "inactive"     # not "passed" on a CPU
    lat = rec["latency"]
    assert lat["batch"] == 64
    for key in ("fused_pair_us", "legacy_pair_us", "pair_speedup",
                "revoke_drained_us"):
        assert lat[key] > 0, key
    col = rec["collective"]
    assert col["ranks"] == 1
    for name, shape in (("1d", {"data": 1}), ("2d", {"pod": 1, "data": 1})):
        assert col[name]["mesh"] == shape and col[name]["count_ok"]
        assert col[name]["scan_collective_us"] > 0


def test_registry_entry_point_meets_the_bias_flap_gates(tmp_path):
    out = tmp_path / "registry.json"
    assert TBR.main(["--smoke", "--device", "cpu", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["failures"] == []
    for key in ("correctness", "in_place", "transfers", "bias_flap",
                "multi_dispatch", "kv_pool"):
        assert key in rec, key
    flap = rec["bias_flap"]
    assert flap["registry"]["rounds"] == 6 and flap["registry"]["locks"] == 32
    assert flap["registry"]["slow_frac_others"] < 0.05
    assert flap["scalar_rbias"]["slow_frac_others"] > 0.5
    assert flap["registry"]["slow_frac_noisy_lock"] > 0.5
    assert rec["transfers"]["fused_sync_gate"] == "inactive"
