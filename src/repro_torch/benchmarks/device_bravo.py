"""Device-BRAVO microbenchmark: acquire/release/revoke latency, transfer
counts and the in-place proof of the single-lock lease table.

The port of ``benchmarks/device_bravo.py``.  It measures the zero-sync
lease path (:class:`~repro_torch.core.device_bravo.DeviceLeaseTable`: one
K2 launch per acquire and per release, the table updated in place) against
the legacy host-looped path (host rbias reads, a host slot upload per call,
a host grant download, and the K10 kernel, which copies the table on every
call), and checks the kernels of both against their plain versions.

    PYTHONPATH=src python -m repro_torch.benchmarks.device_bravo [--smoke]
        [--batch 64] [--iters N] [--device cpu] [--out PATH]

Runs on the CUDA card unless ``--device cpu`` is given; writes its JSON
record only to ``--out``; exits nonzero on any mismatch or lost guarantee.

Transfer accounting: every host crossing of the legacy path goes through
the counting shims of :class:`TransferCounter`, and the lease table's pair
runs under ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
host-device synchronization (on the CPU the gate is recorded as inactive).
``collective``: ``make_distributed_revoke`` on a 1-D ("data",) and a 2-D
("pod", "data") mesh over the current world (a world of one rank starts
here when none runs: NCCL on the card, gloo on the CPU), on ``repro``'s
seed-9 table, its count held to numpy's.  ``repro``'s full mode runs it on
512 fake devices; a run across several cards waits for a machine with
them (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..core import device_bravo as DB
from ..device import resolve
from ..kernels import ops as K
from ..kernels import ref as R
from ..kernels import table_publish as TP
from .smoke import FAILURES, check, in_place, sync, sync_gate, timeit


# ---------------------------------------------------------------------------
# Legacy host-looped lease path, with every host crossing routed through
# counting shims
# ---------------------------------------------------------------------------


class TransferCounter:
    def __init__(self, device: torch.device):
        self.device = device
        self.h2d = 0
        self.d2h = 0

    def to_device(self, x) -> torch.Tensor:
        self.h2d += 1
        return torch.as_tensor(np.asarray(x), device=self.device)

    def to_host_int(self, x: torch.Tensor) -> int:
        self.d2h += 1
        return int(x)

    def to_host_arr(self, x: torch.Tensor) -> np.ndarray:
        self.d2h += 1
        return x.cpu().numpy()

    @property
    def total(self) -> int:
        return self.h2d + self.d2h


def legacy_acquire(state, lock_id, reader_ids, tc: TransferCounter):
    """The pre-fusion acquire: host rbias checks, host slot upload, host
    grant download, and the publish kernel that copies the table."""
    if tc.to_host_int(state.rbias) == 0:
        return state, np.zeros((len(reader_ids),), bool)
    sl = tc.to_device(DB.slots_for(lock_id, reader_ids))
    ids = torch.full((len(reader_ids),), lock_id, dtype=torch.int32,
                     device=state.table.device)
    table, granted = K.publish(state.table, sl, ids)
    if tc.to_host_int(state.rbias) == 0:       # recheck (Listing 1 line 18)
        table = K.clear(table, sl)
        granted = torch.zeros_like(granted)
    return dataclasses.replace(state, table=table), tc.to_host_arr(granted)


def legacy_release(state, lock_id, reader_ids, tc: TransferCounter):
    sl = tc.to_device(DB.slots_for(lock_id, reader_ids))
    return dataclasses.replace(state, table=K.clear(state.table, sl))


# ---------------------------------------------------------------------------
# Sections
# ---------------------------------------------------------------------------


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a, b))


def bench_correctness(dev) -> dict:
    """The path's kernels against their plain versions: K2 (publish, the
    rbias undo, the clear), K9, K3, K10 (publish and clear), and the
    device hashing against the host ``slots_for``."""
    rng = np.random.default_rng(0)
    table = np.zeros((32, 128), np.int32)
    occ = rng.choice(4096, 64, replace=False)
    table.reshape(-1)[occ] = 99
    slots = rng.integers(0, 4096, size=128).astype(np.int32)
    slots[1] = slots[0]                       # force an in-batch collision
    ids = rng.integers(1, 1 << 20, size=128).astype(np.int32)
    t, s, i = (torch.as_tensor(x, device=dev) for x in (table, slots, ids))
    one = torch.ones((), dtype=torch.int32, device=dev)

    tk, gk = K.fused_publish(t.clone(), one, s, i)
    tr, gr = R.publish_ref(t, one, s, i)
    check(_same(tk, tr) and _same(gk, gr), "fused_publish == publish_ref")

    tz, gz = K.fused_publish(t.clone(), torch.zeros_like(one), s, i)
    check(_same(tz, t) and not bool(gz.any()),
          "fused_publish rbias=0 -> full undo")

    tc = K.fused_clear(tk.clone(), s)
    check(_same(tc, R.clear_ref(tr, s)), "fused_clear == clear_ref")

    mask, cnt = K.revocation_scan(tk, 99)
    mref, cref = R.scan_ref(tk, 99)
    check(_same(mask, mref) and int(cnt) == int(cref),
          "revocation_scan == scan_ref")
    check(int(K.revocation_poll(tk, 99)) == int(cref),
          "revocation_poll exact count")

    tp, gp = K.publish(t, s, i)
    tpr, gpr = R.publish_seq_ref(t, s, i)
    check(_same(tp, tpr) and _same(gp, gpr), "publish == publish_seq_ref")
    check(tp.data_ptr() != t.data_ptr() and _same(t, torch.as_tensor(
        table, device=dev)), "publish writes a new table")
    check(_same(K.clear(tp, s), R.clear_seq_ref(tpr, s)),
          "clear == clear_seq_ref")
    # the sequential edge cases: duplicate unconditional stores (the last
    # wins) and a conditional publish of id 0 (the slot stays free)
    dup = torch.as_tensor(np.array([7, 7, 9, 9], np.int32), device=dev)
    dids = torch.as_tensor(np.array([0, 5, 6, 8], np.int32), device=dev)
    zeros = torch.zeros_like(t)
    for unc in (True, False):
        got = TP.publish(zeros, dup, dids, unconditional=unc)
        want = R.publish_seq_ref(zeros, dup, dids, unconditional=unc)
        check(_same(got[0], want[0]) and _same(got[1], want[1]),
              f"publish (unconditional={unc}) edge cases == publish_seq_ref")

    readers = np.arange(1000, 1000 + 64)
    st = DB.init_state(device=dev)
    st, g = DB.acquire(st, 21, readers)
    host_slots = DB.slots_for(21, readers)
    flat = st.table.reshape(-1).cpu().numpy()
    check(bool(g.all()) and bool((flat[host_slots] == 21).all()),
          "device hashing == host slots_for")
    return {"verified": not FAILURES}


def bench_in_place(dev, batch: int) -> dict:
    """The lease table's pair updates its table in place; the legacy path
    returns a new table on every publish and clear (K10 copies it)."""
    tbl = DB.DeviceLeaseTable(device=dev)
    h = tbl.handle()
    rids = torch.arange(batch, dtype=torch.int32, device=dev)

    def pair():
        h.release(rids, granted=h.acquire(rids))

    out = in_place(dev, lambda: tbl.state.table, pair)
    st = DB.init_state(device=dev)
    readers = np.arange(batch)
    tc = TransferCounter(dev)
    st1, _ = legacy_acquire(st, 5, readers, tc)
    st2 = legacy_release(st1, 5, readers, tc)
    ptrs = {st.table.data_ptr(), st1.table.data_ptr(), st2.table.data_ptr()}
    out["legacy_new_table_per_call"] = len(ptrs) == 3
    check(out["legacy_new_table_per_call"],
          "legacy publish and clear each return a new table")
    return out


def bench_transfers(dev, batch: int) -> dict:
    """Host-device transfers per acquire/release pair: legacy vs fused."""
    readers = np.arange(batch)
    tc = TransferCounter(dev)
    st = DB.init_state(device=dev)
    st, _ = legacy_acquire(st, 5, readers, tc)
    st = legacy_release(st, 5, readers, tc)
    check(tc.h2d == 2 and tc.d2h == 3,
          f"legacy pair: 2 uploads + 3 downloads (got {tc.h2d} + {tc.d2h})")

    tbl = DB.DeviceLeaseTable(device=dev)
    h = tbl.handle()
    rids = torch.arange(batch, dtype=torch.int32, device=dev)

    def pair():
        h.release(rids, granted=h.acquire(rids))   # grant-masked, as the
        #                                            engine's steady state
    pair()                                         # warm-up
    gate = sync_gate(dev, pair)
    fused = {"passed": 0, "tripped": -1}.get(gate)
    if gate != "inactive":
        check(gate == "passed", "fused pair runs under "
                                "set_sync_debug_mode('error')")
        check(tc.total >= 2 * max(fused, 1),
              f"transfers/pair: legacy={tc.total} >= 2x fused={fused}")
    return {"legacy_transfers_per_pair": tc.total,
            "legacy_h2d": tc.h2d, "legacy_d2h": tc.d2h,
            "fused_transfers_per_pair_steady": fused,
            "fused_sync_gate": gate}


def bench_latency(dev, batch: int, iters: int) -> dict:
    readers = np.arange(batch)
    rids = torch.arange(batch, dtype=torch.int32, device=dev)

    tbl = DB.DeviceLeaseTable(device=dev)
    h = tbl.handle()

    def fused_pair():
        h.release(rids, granted=h.acquire(rids))
        sync(dev)

    fused_s = timeit(fused_pair, iters)

    st_box = {"st": DB.init_state(device=dev)}

    def legacy_pair():
        tc = TransferCounter(dev)
        st, _ = legacy_acquire(st_box["st"], 5, readers, tc)
        st_box["st"] = legacy_release(st, 5, readers, tc)
        sync(dev)

    legacy_s = timeit(legacy_pair, iters)

    h.acquire(rids)
    h.release(rids)

    def revoke_drained():
        tbl.state = dataclasses.replace(
            tbl.state, rbias=torch.ones_like(tbl.state.rbias))
        h.revoke(pipeline_depth=2)

    revoke_s = timeit(revoke_drained, max(2, iters // 8))
    return {"batch": batch, "iters": iters,
            "fused_pair_us": fused_s * 1e6,
            "legacy_pair_us": legacy_s * 1e6,
            "pair_speedup": legacy_s / fused_s,
            "revoke_drained_us": revoke_s * 1e6}


def collective_table() -> np.ndarray:
    """``repro``'s table: 37 of 4096 slots hold 77 (numpy seed 9)."""
    rng = np.random.default_rng(9)
    table = np.zeros((32, 128), np.int32)
    hits = rng.choice(4096, 37, replace=False)
    table.reshape(-1)[hits] = 77
    return table


def bench_collective(dev, iters: int) -> dict:
    """Distributed revocation scan on the 1D and 2D meshes."""
    import torch.distributed as dist

    from ..launch.mesh import local_world, make_mesh

    with local_world(dev):
        world = dist.get_world_size()
        pod = 2 if world % 2 == 0 and world > 1 else 1
        meshes = [("1d", (world,), ("data",), ("data",)),
                  ("2d", (pod, world // pod), ("pod", "data"),
                   ("pod", "data"))]
        table = collective_table()
        want = int((table == 77).sum())
        t = torch.from_numpy(table).to(dev)
        out = {"ranks": world}
        for name, shape, names, axes in meshes:
            mesh = make_mesh(shape, names, device=dev)
            fn = DB.make_distributed_revoke(
                mesh, axis=axes[0] if len(axes) == 1 else axes)
            cnt = int(fn(t, 77))
            check(cnt == want == 37,
                  f"distributed revoke count on {name} mesh {shape} == "
                  f"numpy's {want} (got {cnt})")
            dt = timeit(lambda: int(fn(t, 77)), max(2, iters // 8))
            out[name] = {"mesh": dict(zip(names, shape)), "axes": list(axes),
                         "count_ok": cnt == want,
                         "scan_collective_us": dt * 1e6}
        return out


def run(device=None, *, smoke: bool = False, batch: int = 64,
        iters=None, collective: bool = True) -> dict:
    """Every section on ``device`` (default: the CUDA card); -> the
    record, whose ``failures`` lists every check that did not hold.
    ``collective=False`` leaves that section to the caller
    (``chip_smoke.py`` runs it in its last phase)."""
    dev = resolve(device)
    iters = iters or (4 if smoke else 100)
    FAILURES.clear()
    rec = {
        "bench": "device_bravo",
        "mode": "smoke" if smoke else "full",
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "torch": torch.__version__,
        "correctness": bench_correctness(dev),
        "in_place": bench_in_place(dev, batch),
        "transfers": bench_transfers(dev, batch),
        "latency": bench_latency(dev, batch, iters),
        "collective": (bench_collective(dev, iters) if collective
                       else {"run": "by the caller"}),
    }
    rec["failures"] = list(FAILURES)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="fast mode: verify-only iterations")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--batch", type=int, default=64,
                    help="readers per batched acquire")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="output JSON path")
    args = ap.parse_args(argv)
    rec = run(args.device, smoke=args.smoke, batch=args.batch,
              iters=args.iters)
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1))
        print(f"wrote {args.out}", flush=True)
    print(json.dumps(rec["latency"], indent=1))
    if rec["failures"]:
        print(f"FAILED: {rec['failures']}", file=sys.stderr)
        return 1
    print("device-bravo bench OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
