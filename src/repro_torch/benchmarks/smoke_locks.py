"""Quick smoke of the lock zoo: every lock variant under ``LiveMem`` (real
threads) and ``SimMem`` (the deterministic coherence simulator), the twin
of the reference's ``scripts/smoke_locks.py``.  A host program: it touches
no tensor.

    PYTHONPATH=src python -m repro_torch.benchmarks.smoke_locks

Each run has ``nthreads - 1`` readers check that a writer's two stores are
never seen torn, and the writer's stores all land.  Under ``SimMem`` the
run's virtual time and cache-line transfers are deterministic.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from ..core.atomics import LiveMem
from ..core.factory import LockEnv
from ..core.sim import SimMem, Topology

__all__ = ["ALL", "exercise", "run", "main"]

ALL = ["pthread", "bravo-pthread", "pf-t", "bravo-pf-t", "ba", "bravo-ba",
       "percpu", "cohort-rw", "bravo-cohort-rw"]


def exercise(env, nthreads: int, iters: int, name: str) -> Optional[str]:
    """Run lock ``name`` of ``env`` (any ``LockEnv``: this package's or the
    reference's) with ``nthreads - 1`` readers and one writer of ``iters``
    rounds each; raise on a torn read or a lost write.  -> the lock's BRAVO
    stats line, or None for a lock without them."""
    lock = env.make(name)
    mem = env.mem
    shared = {"x": 0, "reads": 0}
    bad = []

    def reader(i):
        def run():
            for _ in range(iters):
                t = lock.acquire_read()
                a = shared["x"]
                mem.work(5)
                b = shared["x"]
                if a != b:
                    bad.append((a, b))
                lock.release_read(t)
                mem.work(10)
        return run

    def writer(i):
        def run():
            for _ in range(iters // 2):
                t = lock.acquire_write()
                shared["x"] += 1
                mem.work(5)
                shared["x"] += 1
                lock.release_write(t)
                mem.work(30)
        return run

    fns = [reader(i) for i in range(nthreads - 1)] + [writer(nthreads - 1)]
    mem.run_threads(fns)
    if bad:
        raise AssertionError(f"{name}: torn reads {bad[:3]}")
    if shared["x"] != 2 * (iters // 2):
        raise AssertionError(f"{name}: {shared['x']} writes landed of "
                             f"{2 * (iters // 2)}")
    if hasattr(lock, "stats") and lock.stats:
        return (f"  {name}: fast={lock.stats.fast_acquires} "
                f"slow={lock.stats.slow_acquires} "
                f"revocations={lock.stats.revocations}")
    return None


def run(emit=print) -> List[dict]:
    """Every variant live (4 threads on 8 CPUs) and simulated (6 threads on
    ``Topology(2, 2, 2)``), 60 rounds; -> one record a simulated run."""
    for name in ALL:
        line = exercise(LockEnv(LiveMem(num_cpus=8)), 4, 60, name)
        if line:
            emit(line)
        emit(f"live ok: {name}")
    sims = []
    for name in ALL:
        env = LockEnv(SimMem(6, Topology(2, 2, 2)))
        line = exercise(env, 6, 60, name)
        if line:
            emit(line)
        sims.append({"lock": name, "vtime_ns": env.mem.vtime,
                     "line_transfers": env.mem.stats.line_transfers})
        emit(f"sim  ok: {name}  vtime={env.mem.vtime / 1e3:.1f}us "
             f"xfers={env.mem.stats.line_transfers}")
    return sims


def main() -> int:
    run()
    print("ALL OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
