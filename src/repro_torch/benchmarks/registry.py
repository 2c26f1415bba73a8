"""Registry microbenchmark: the shared-bias flap, before and after.

The port of ``benchmarks/registry.py``.  The headline experiment: 32 locks
multiplexed over one visible-readers table, a read-heavy workload on all of
them, and ONE noisy writer repeatedly revoking lock 0.  Under the scalar
``rbias`` (:class:`~repro_torch.core.device_bravo.DeviceLeaseTable`, the
paper's single-lock design) every revocation clears the bias of ALL 32
locks and the shared inhibit window pins it off: the other 31 locks'
acquires go ~100% slow-path.  Under the registry's per-lock bias lanes
only lock 0 flaps; the other 31 locks' slow-path share stays at the
hash-collision floor (< 5%).

Also records: the multi-lock kernels (K1, K4) against their plain versions,
the in-place proof for the registry's acquire/release pair, the zero-sync
proof (the pair under ``torch.cuda.set_sync_debug_mode("error")``), the
one-launch-vs-32 multi-lock batch, and KV-pool latencies.

    PYTHONPATH=src python -m repro_torch.benchmarks.registry [--smoke]
        [--rounds N] [--locks 32] [--readers 4] [--device cpu] [--out PATH]

Runs on the CUDA card unless ``--device cpu`` is given; writes its JSON
record only to ``--out``; exits nonzero on any mismatch or lost guarantee.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..core import device_bravo as DB
from ..core import registry as REG
from ..device import resolve
from ..kernels import ops as K
from ..kernels import ref as R
from ..serving.kv_pool import KVPool
from .smoke import FAILURES, check, in_place, sync, sync_gate, timeit


# ---------------------------------------------------------------------------
# Sections
# ---------------------------------------------------------------------------


def bench_correctness(dev) -> dict:
    """Multi-lock kernels against their plain versions."""
    rng = np.random.default_rng(0)
    table = np.zeros((32, 128), np.int32)
    occ = rng.choice(4096, 64, replace=False)
    table.reshape(-1)[occ] = 424242
    rbias = np.ones(REG.MAX_LOCKS, np.int32)
    rbias[rng.choice(REG.MAX_LOCKS, 40, replace=False)] = 0
    m = 128
    slots = rng.integers(0, 4096, m).astype(np.int32)
    slots[1] = slots[0]                       # in-batch collisions
    lidx = rng.integers(0, REG.MAX_LOCKS, m).astype(np.int32)
    ids = rng.integers(1, 1 << 20, m).astype(np.int32)
    t, rb, s, li, i = (torch.as_tensor(x, device=dev)
                       for x in (table, rbias, slots, lidx, ids))

    tk, gk = K.fused_publish_multi(t.clone(), rb, s, li, i)
    tr, gr = R.publish_multi_ref(t, rb, s, li, i)
    check(torch.equal(tk, tr) and torch.equal(gk, gr),
          "fused_publish_multi == publish_multi_ref")
    # all-lanes-clear == nothing lands (the scalar kernel's rbias=0 case)
    tz, gz = K.fused_publish_multi(t.clone(), torch.zeros_like(rb), s, li, i)
    check(torch.equal(tz, t) and not bool(gz.any()),
          "fused_publish_multi all-unbiased -> full undo")
    # per-lane undo: only the unbiased lanes' requests are undone
    biased_req = rbias[lidx] != 0
    check(not gk.cpu().numpy()[~biased_req].any(),
          "unbiased lanes' requests all denied")

    vals = torch.as_tensor(rng.choice(1 << 20, 16).astype(np.int32),
                           device=dev)
    check(torch.equal(K.revocation_poll_multi(tk, vals),
                      R.multi_count_ref(tk, vals)),
          "revocation_poll_multi == multi_count_ref")
    return {"verified": not FAILURES}


def bench_in_place(dev, batch: int = 16) -> dict:
    """The registry's acquire/release pair keeps the scalar path's
    guarantee: the table is updated in place, nothing is allocated."""
    reg = REG.BravoRegistry(device=dev)
    h = reg.alloc("inplace")
    rids = torch.arange(batch, dtype=torch.int32, device=dev)

    def pair():
        h.release(rids, granted=h.acquire(rids))

    return in_place(dev, lambda: reg.table, pair)


def bench_transfers(dev, batch: int = 16) -> dict:
    """Steady-state registry acquire/release pair: no host-device sync
    (the guarantee the single-lock table's benchmark proves too)."""
    reg = REG.BravoRegistry(device=dev)
    h = reg.alloc("xfer")
    rids = torch.arange(batch, dtype=torch.int32, device=dev)

    def pair():
        h.release(rids, granted=h.acquire(rids))

    pair()                                        # warm-up
    gate = sync_gate(dev, pair)
    if gate != "inactive":
        check(gate == "passed",
              "registry pair runs under set_sync_debug_mode('error')")
    return {"fused_transfers_per_pair_steady":
            {"passed": 0, "tripped": -1}.get(gate),
            "fused_sync_gate": gate}


def _flap_workload(make_handles, revoke_noisy, rounds: int, locks: int,
                   readers: int, dev) -> dict:
    """One round = noisy writer revokes lock 0, then every lock rearms,
    acquires its reader batch, and (once all are live) releases.  Returns
    per-lock grant tallies."""
    hs = make_handles()
    batches = [torch.arange(k * 1000, k * 1000 + readers, dtype=torch.int32,
                            device=dev) for k in range(locks)]
    granted = np.zeros(locks, np.int64)
    requests = np.zeros(locks, np.int64)
    t0 = time.perf_counter()
    for _ in range(rounds):
        revoke_noisy(hs)
        masks = []
        for k in range(locks):
            hs[k].rearm()
            g = hs[k].acquire(batches[k])
            gh = g.cpu().numpy()
            granted[k] += gh.sum()
            requests[k] += gh.size
            masks.append(g)
        for k in range(locks):
            hs[k].release(batches[k], granted=masks[k])
    sync(dev)
    dt = time.perf_counter() - t0
    slow = 1.0 - granted / requests
    return {"slow_frac_noisy_lock": float(slow[0]),
            "slow_frac_others": float(slow[1:].mean()),
            "slow_frac_others_max": float(slow[1:].max()),
            "rounds": rounds, "locks": locks, "readers_per_lock": readers,
            "wall_s": dt}


def bench_bias_flap(dev, rounds: int, locks: int, readers: int) -> dict:
    """The acceptance experiment: scalar shared rbias vs per-lock lanes.

    The noisy writer revokes with a huge inhibit multiplier so the bias
    window spans the whole run, the worst-case flap.  Scalar: that window
    (and the global drain gate) holds EVERY lock's fast path down.
    Registry: only lock 0 pays; the other 31 locks ride the fast path at
    the hash-collision floor."""
    n_huge = 10**6

    def scalar_handles():
        tbl = DB.DeviceLeaseTable(device=dev)
        return [tbl.handle() for _ in range(locks)]

    def registry_handles():
        reg = REG.BravoRegistry(device=dev)
        return [reg.alloc(f"L{k}") for k in range(locks)]

    def noisy(hs):
        hs[0].revoke(n=n_huge)

    scalar = _flap_workload(scalar_handles, noisy, rounds, locks, readers,
                            dev)
    registry = _flap_workload(registry_handles, noisy, rounds, locks,
                              readers, dev)
    check(registry["slow_frac_others"] < 0.05,
          f"registry: other locks slow-path "
          f"{registry['slow_frac_others']:.2%} < 5%")
    check(scalar["slow_frac_others"] > 0.5,
          f"scalar rbias: other locks slow-path "
          f"{scalar['slow_frac_others']:.2%} (the flap)")
    check(registry["slow_frac_noisy_lock"] > 0.5,
          "registry: the noisy lock itself IS inhibited")
    return {"scalar_rbias": scalar, "registry": registry}


def bench_multi_dispatch(dev, locks: int, readers: int, iters: int) -> dict:
    """A mixed batch spanning all locks: one launch by lane index vs one
    launch per lock."""
    reg = REG.BravoRegistry(device=dev)
    hs = [reg.alloc(f"M{k}") for k in range(locks)]
    lidx = torch.as_tensor(np.repeat([h.idx for h in hs], readers)
                           .astype(np.int32), device=dev)
    rids = torch.arange(locks * readers, dtype=torch.int32, device=dev)
    batches = [torch.arange(k * readers, (k + 1) * readers,
                            dtype=torch.int32, device=dev)
               for k in range(locks)]

    def one_dispatch():
        g = reg.acquire_by_index(lidx, rids)
        reg.release_by_index(lidx, rids, g)
        sync(dev)

    def per_lock():
        gs = [hs[k].acquire(batches[k]) for k in range(locks)]
        for k in range(locks):
            hs[k].release(batches[k], granted=gs[k])
        sync(dev)

    fused_s = timeit(one_dispatch, iters)
    loop_s = timeit(per_lock, max(1, iters // 4))
    check(not reg.held_multi(hs).any(), "multi-dispatch workload drains clean")
    return {"locks": locks, "readers_per_lock": readers,
            "one_dispatch_us": fused_s * 1e6,
            "per_lock_dispatch_us": loop_s * 1e6,
            "dispatch_speedup": loop_s / fused_s}


def bench_kv_pool(dev, iters: int) -> dict:
    """Device-resident paged-KV pool hot paths (+ zero-sync batch read)."""
    pool = KVPool(4096, stripes=4, device=dev)
    rids = torch.as_tensor([3, 7, 11, 15], dtype=torch.int32, device=dev)
    pool.allocate(3, 8)
    pool.allocate(7, 8)
    mask = pool.lookup_batch(rids).cpu().numpy()    # warm-up
    check(mask[0].sum() == 8 and mask[2].sum() == 0,
          "kv pool batch mask matches allocations")
    gate = sync_gate(dev, lambda: pool.lookup_batch(rids))
    if gate != "inactive":
        check(gate == "passed",
              "kv lookup_batch runs under set_sync_debug_mode('error')")

    def lookup():
        pool.lookup_batch(rids)
        sync(dev)

    lookup_s = timeit(lookup, iters)
    box = {"rid": 100}

    def alloc_reclaim():
        rid = box["rid"]
        box["rid"] += 1
        pool.allocate(rid, 8)
        pool.reclaim(rid)

    pair_s = timeit(alloc_reclaim, max(2, iters // 4))
    check(pool.free_count() == 4096 - 16, "kv pool conserves pages")
    check(not pool.registry.held_multi(pool.locks).any(),
          "kv pool leases drain clean")
    return {"n_pages": 4096, "stripes": 4, "lookup_sync_gate": gate,
            "lookup_batch_us": lookup_s * 1e6,
            "alloc_reclaim_pair_us": pair_s * 1e6}


def run(device=None, *, smoke: bool = False, rounds=None, locks: int = 32,
        readers: int = 4) -> dict:
    """Every section on ``device`` (default: the CUDA card); -> the
    record, whose ``failures`` lists every check that did not hold."""
    dev = resolve(device)
    rounds = rounds or (6 if smoke else 24)
    iters = 4 if smoke else 50
    FAILURES.clear()
    rec = {
        "bench": "registry",
        "mode": "smoke" if smoke else "full",
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "torch": torch.__version__,
        "max_locks": REG.MAX_LOCKS,
        "correctness": bench_correctness(dev),
        "in_place": bench_in_place(dev),
        "transfers": bench_transfers(dev),
        "bias_flap": bench_bias_flap(dev, rounds, locks, readers),
        "multi_dispatch": bench_multi_dispatch(dev, locks, readers, iters),
        "kv_pool": bench_kv_pool(dev, iters),
    }
    rec["failures"] = list(FAILURES)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="fast mode: fewer rounds and iterations")
    ap.add_argument("--rounds", type=int, default=None,
                    help="bias-flap rounds (default: 6 smoke / 24 full)")
    ap.add_argument("--locks", type=int, default=32)
    ap.add_argument("--readers", type=int, default=4,
                    help="readers per lock per round")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out", default=None, help="output JSON path")
    args = ap.parse_args(argv)
    rec = run(args.device, smoke=args.smoke, rounds=args.rounds,
              locks=args.locks, readers=args.readers)
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1))
        print(f"wrote {args.out}", flush=True)
    print(json.dumps(rec["bias_flap"], indent=1))
    if rec["failures"]:
        print(f"FAILED: {rec['failures']}", file=sys.stderr)
        return 1
    print("registry bench OK", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
