"""Shared harness of the paper's lock experiments (the twin of the
reference's ``benchmarks/common.py``).

Every paper figure is reproduced under the deterministic coherence
simulator (72 virtual CPUs, the paper's 2-socket Oracle X5-2 topology):
its times are virtual nanoseconds on that modelled machine, not a reading
of any host or card.  Live threads on a host with few cores cannot exhibit
coherence scaling; the simulator carries the quantitative reproduction and
``--live`` runs the same code on real threads for sanity.  These are host
programs: they touch no tensor.

Output convention (``repro_torch.benchmarks.run``):
``name,us_per_call,derived`` CSV rows, where ``derived`` carries
figure-specific values (ops/s per thread count, ratios, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from ..core.atomics import LiveMem
from ..core.factory import PAPER_LOCK_NAMES, LockEnv
from ..core.sim import SimMem, Topology

__all__ = ["X5_2", "DEFAULT_THREADS", "QUICK_THREADS", "PAPER_LOCK_NAMES",
           "BenchResult", "make_env", "run_timed", "Counter", "XorShift",
           "LockEnv"]

X5_2 = Topology(sockets=2, cores_per_socket=18, smt=2)   # 72 CPUs

DEFAULT_THREADS = (1, 2, 4, 8, 16, 32, 64)
QUICK_THREADS = (1, 4, 16, 64)


@dataclasses.dataclass
class BenchResult:
    bench: str
    lock: str
    threads: int
    ops: int
    elapsed_ns: float
    extras: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def ops_per_ms(self) -> float:
        return self.ops / max(self.elapsed_ns, 1) * 1e6

    def row(self) -> str:
        us_per_call = self.elapsed_ns / 1e3 / max(self.ops, 1) \
            * self.threads
        extras = ";".join(f"{k}={v:.4g}" for k, v in self.extras.items())
        return (f"{self.bench}/{self.lock}/t{self.threads},"
                f"{us_per_call:.4f},ops_per_ms={self.ops_per_ms:.1f}"
                + (";" + extras if extras else ""))


def make_env(threads: int, live: bool = False, table_size: int = 4096,
             n: int = 9) -> LockEnv:
    if live:
        return LockEnv(LiveMem(num_cpus=X5_2.num_cpus), table_size, n)
    return LockEnv(SimMem(threads, X5_2), table_size, n)


def run_timed(env: LockEnv, nthreads: int,
              worker: Callable[[int, "Counter"], Callable[[], None]],
              vtime_budget_ns: int) -> BenchResult:
    """Spawn ``nthreads`` workers; each loops until its virtual clock passes
    the budget; returns total completed operations."""
    counters = [Counter() for _ in range(nthreads)]
    fns = [worker(i, counters[i]) for i in range(nthreads)]
    env.mem.run_threads(fns)
    ops = sum(c.n for c in counters)
    elapsed = getattr(env.mem, "vtime", None)
    if elapsed is None:
        elapsed = max(c.wall_ns for c in counters)
    return BenchResult("", "", nthreads, ops, float(elapsed))


class Counter:
    __slots__ = ("n", "wall_ns")

    def __init__(self):
        self.n = 0
        self.wall_ns = 0


class XorShift:
    """Thread-local Marsaglia xor-shift (paper §3 uses the same family)."""

    __slots__ = ("s",)

    def __init__(self, seed: int):
        self.s = (seed * 2654435761 + 1) & 0xFFFFFFFFFFFFFFFF

    def next(self) -> int:
        x = self.s
        x ^= (x << 13) & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 7
        x ^= (x << 17) & 0xFFFFFFFFFFFFFFFF
        self.s = x
        return x

    def uniform(self) -> float:
        return self.next() / 2**64
