"""Runner of the paper's lock experiments — one function per paper
table/figure, the twin of the reference's ``benchmarks/run.py``.

Prints ``name,us_per_call,derived`` CSV, the reference's rows.  Default =
quick mode (a few thread counts, short virtual-time budgets, headline
locks); ``--full`` sweeps the paper's full grids.  ``--live`` re-runs on
real threads.  ``--json-out PATH`` writes every row's ``BenchResult``.
Times are virtual time on the modelled 72-CPU X5-2 (``common.X5_2``)
unless ``--live``.  A host program: it touches no tensor and takes no
device.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--full] [--live] \
        [--only fig4] [--json-out PATH]

The reference's ``roofline`` entry is not here: it summarises the TPU
dry run's ``reports/dryrun/*.json``, whose launch layer has no PyTorch
counterpart.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

from . import figures as F

HEADLINE = ("ba", "bravo-ba", "pthread", "bravo-pthread", "percpu",
            "cohort-rw")
QUICK_LOCKS = ("ba", "bravo-ba", "percpu")

RESULTS = []


def emit(res) -> None:
    RESULTS.append(res)
    print(res.row(), flush=True)


def fig1(full: bool, live: bool) -> None:
    pool_sizes = (1, 16, 256, 4096) if not full else \
        (1, 4, 16, 64, 256, 1024, 4096, 8192)
    for n_locks in pool_sizes:
        shared = F.interference(n_locks, nthreads=16, shared=True, live=live)
        private = F.interference(n_locks, nthreads=16, shared=False,
                                 live=live)
        ratio = shared.ops_per_ms / max(private.ops_per_ms, 1e-9)
        shared.extras["ratio_vs_private"] = ratio
        emit(shared)


def fig2(full: bool, live: bool) -> None:
    threads = (2, 8, 32) if not full else (1, 2, 4, 8, 16, 32, 64)
    for lock in (HEADLINE if full else QUICK_LOCKS):
        for t in threads:
            emit(F.alternator(lock, t, rounds=200 if not full else 500,
                              live=live))


def fig3(full: bool, live: bool) -> None:
    readers = (4, 16, 63) if not full else (1, 2, 4, 8, 16, 32, 63)
    for lock in (HEADLINE if full else QUICK_LOCKS + ("cohort-rw",)):
        for r in readers:
            emit(F.test_rwlock(lock, r, live=live))


def fig4(full: bool, live: bool) -> None:
    ps = (0.9, 0.01, 0.0001) if not full else \
        (0.9, 0.5, 0.1, 0.01, 0.001, 0.0001)
    threads = (4, 16, 48) if not full else (1, 2, 4, 8, 16, 32, 64)
    for p in ps:
        for lock in (HEADLINE if full else QUICK_LOCKS):
            for t in threads:
                emit(F.rwbench(lock, t, p, live=live))


def fig5(full: bool, live: bool) -> None:
    readers = (4, 16, 48) if not full else (1, 2, 4, 8, 16, 32, 63)
    # two write cadences: ~15us/Put (hot; shows BRAVO's revocation-flap
    # regime) and ~150us/Put (rocksdb-realistic; BRAVO wins)
    for ww in (4000, 40000):
        for lock in (HEADLINE if full else QUICK_LOCKS):
            for r in readers:
                emit(F.kv_readwhilewriting(lock, r, live=live,
                                           write_work=ww))


def fig6(full: bool, live: bool) -> None:
    readers = (4, 16, 46) if not full else (1, 2, 4, 8, 16, 32, 62)
    for lock in (HEADLINE if full else QUICK_LOCKS):
        for r in readers:
            emit(F.hash_table_bench(lock, r, live=live))


def fig7(full: bool, live: bool) -> None:
    readers = (4, 16, 48) if not full else (1, 2, 4, 8, 16, 32, 63)
    for lock in ("ba", "bravo-ba"):
        for r in readers:
            emit(F.locktorture(lock, r, writers=1, read_hold_ns=5000,
                               write_hold_ns=1000, live=live))


def fig8(full: bool, live: bool) -> None:
    readers = (4, 16, 64) if not full else (1, 2, 4, 8, 16, 32, 64)
    for lock in ("ba", "bravo-ba"):
        for r in readers:
            emit(F.locktorture(lock, r, writers=0, read_hold_ns=5000,
                               write_hold_ns=0, live=live))


def metis(full: bool, live: bool) -> None:
    threads = (4, 16, 48) if not full else (1, 2, 4, 8, 16, 32, 64)
    for p in (0.02, 0.3):           # wc/page_fault-like vs mmap-like
        for lock in ("ba", "bravo-ba"):
            for t in threads:
                emit(F.metis_analogue(lock, t, p, live=live))


ALL = {"fig1": fig1, "fig2": fig2, "fig3": fig3, "fig4": fig4,
       "fig5": fig5, "fig6": fig6, "fig7": fig7, "fig8": fig8,
       "metis": metis}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.run",
        description="the paper's lock experiments under the simulator")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--live", action="store_true")
    ap.add_argument("--only", default=None)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    RESULTS.clear()
    print("name,us_per_call,derived")
    for name, fn in ALL.items():
        if args.only and args.only not in name:
            continue
        fn(args.full, args.live)
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(
            [dataclasses.asdict(r) for r in RESULTS], indent=1))


if __name__ == "__main__":
    main()
