"""One benchmark per paper figure/table (paper §5-§6), the twin of the
reference's ``benchmarks/figures.py``: the same workloads under the same
deterministic simulator give the same results, field for field.  Times are
virtual nanoseconds on the modelled 72-CPU X5-2 (``common.X5_2``).

Figure 1  inter-lock interference (shared vs private readers table)
Figure 2  alternator (serialized readers, reader-indicator sloshing)
Figure 3  test_rwlock (1 writer, T readers; urcu benchmark)
Figure 4  RWBench at P(write) in {9/10 ... 1/10000}
Figure 5  KV-store readwhilewriting (rocksdb analogue on our engine's
          page-table + model-store locks)
Figure 6  hash_table_bench (1 inserter + 1 eraser + T readers)
Figure 7  locktorture, 1 writer (long critical sections)
Figure 8  locktorture, 0 writers, 5us critical sections
Tables1/2 Metis analogue: page_fault (read-heavy) vs mmap (write-heavy)
          on a VMA-style address-space lock
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from .common import (BenchResult, Counter, LockEnv, XorShift, make_env)


def _loop(env, budget_ns):
    mem = env.mem

    def done() -> bool:
        return mem.now() >= budget_ns
    return done


# ---------------------------------------------------------------- Figure 1
def interference(n_locks: int, nthreads: int = 16,
                 budget_ns: int = 1_500_000, shared: bool = True,
                 live: bool = False) -> BenchResult:
    env = make_env(nthreads, live)
    if shared:
        locks = [env.make("bravo-ba") for _ in range(n_locks)]
    else:
        # idealized variant: a private 4096-slot table per lock instance
        from ..core.table import VisibleReadersTable
        locks = []
        for _ in range(n_locks):
            table = VisibleReadersTable(env.mem, 4096,
                                        name=f"priv{len(locks)}")
            locks.append(env.make("bravo-ba", table=table))

    def worker(i: int, c: Counter):
        rng = XorShift(i + 1)
        mem = env.mem

        def run():
            while mem.now() < budget_ns:
                lk = locks[rng.next() % n_locks]
                t = lk.acquire_read()
                mem.work(20)
                lk.release_read(t)
                mem.work(100)
                c.n += 1
        return run

    r = run_timed_named(env, nthreads, worker, budget_ns)
    r.bench = f"fig1_interference{'_shared' if shared else '_private'}" \
              f"_L{n_locks}"
    r.lock = "bravo-ba"
    return r


# ---------------------------------------------------------------- Figure 2
def alternator(lock_name: str, nthreads: int,
               rounds: int = 300, live: bool = False) -> BenchResult:
    env = make_env(nthreads, live)
    lock = env.make(lock_name)
    mem = env.mem
    flags = [mem.alloc(f"alt{i}") for i in range(nthreads)]
    total = Counter()

    def worker(i: int, c: Counter):
        def run():
            me, right = flags[i], flags[(i + 1) % nthreads]
            for r in range(rounds):
                want = r if i == 0 else r + 1
                if want > 0:
                    mem.wait_while(me, lambda v, w=want: v < w)
                t = lock.acquire_read()
                lock.release_read(t)
                c.n += 1
                right.fetch_add(1)
        return run

    res = run_timed_named(env, nthreads, worker, 0)
    res.bench = "fig2_alternator"
    res.lock = lock_name
    return res


# ---------------------------------------------------------------- Figure 3
def test_rwlock(lock_name: str, readers: int, budget_ns: int = 1_500_000,
                live: bool = False) -> BenchResult:
    nthreads = readers + 1
    env = make_env(nthreads, live)
    lock = env.make(lock_name)
    mem = env.mem

    def worker(i: int, c: Counter):
        if i == 0:
            def writer():
                while mem.now() < budget_ns:
                    t = lock.acquire_write()
                    mem.work(10)
                    lock.release_write(t)
                    mem.work(1000)
                    c.n += 1
            return writer

        def reader():
            while mem.now() < budget_ns:
                t = lock.acquire_read()
                mem.work(10)
                lock.release_read(t)
                c.n += 1
        return reader

    r = run_timed_named(env, nthreads, worker, budget_ns)
    r.bench = "fig3_test_rwlock"
    r.lock = lock_name
    r.threads = readers
    return r


# ---------------------------------------------------------------- Figure 4
def rwbench(lock_name: str, nthreads: int, p_write: float,
            budget_ns: int = 1_200_000, live: bool = False) -> BenchResult:
    env = make_env(nthreads, live)
    lock = env.make(lock_name)
    mem = env.mem

    def worker(i: int, c: Counter):
        rng = XorShift(i * 7 + 3)

        def run():
            while mem.now() < budget_ns:
                if rng.uniform() < p_write:
                    t = lock.acquire_write()
                    mem.work(10)
                    lock.release_write(t)
                else:
                    t = lock.acquire_read()
                    mem.work(10)
                    lock.release_read(t)
                mem.work(rng.next() % 200)
                c.n += 1
        return run

    r = run_timed_named(env, nthreads, worker, budget_ns)
    r.bench = f"fig4_rwbench_p{p_write:g}"
    r.lock = lock_name
    return r


# ---------------------------------------------------------------- Figure 5
def kv_readwhilewriting(lock_name: str, readers: int,
                        budget_ns: int = 1_200_000,
                        live: bool = False,
                        write_work: int = 4000) -> BenchResult:
    """rocksdb readwhilewriting analogue: GetLock()-style striped locks
    around a shared dict; 1 writer thread updates, T readers Get()."""
    nthreads = readers + 1
    env = make_env(nthreads, live)
    stripes = [env.make(lock_name) for _ in range(8)]
    mem = env.mem
    store: Dict[int, int] = {k: k for k in range(512)}

    def worker(i: int, c: Counter):
        rng = XorShift(i + 11)
        if i == 0:
            def writer():
                while mem.now() < budget_ns:
                    k = rng.next() % 512
                    lk = stripes[k % 8]
                    t = lk.acquire_write()
                    store[k] = store.get(k, 0) + 1
                    mem.work(8)
                    lk.release_write(t)
                    mem.work(write_work)
                    c.n += 1
            return writer

        def reader():
            while mem.now() < budget_ns:
                k = rng.next() % 512
                lk = stripes[k % 8]
                t = lk.acquire_read()
                _ = store.get(k)
                mem.work(8)
                lk.release_read(t)
                c.n += 1
        return reader

    r = run_timed_named(env, nthreads, worker, budget_ns)
    r.bench = f"fig5_readwhilewriting_w{write_work}"
    r.lock = lock_name
    r.threads = readers
    return r


# ---------------------------------------------------------------- Figure 6
def hash_table_bench(lock_name: str, readers: int,
                     budget_ns: int = 1_200_000,
                     live: bool = False) -> BenchResult:
    """1 eraser + 1 inserter (writers) + T readers on one central lock."""
    nthreads = readers + 2
    env = make_env(nthreads, live)
    lock = env.make(lock_name)
    mem = env.mem
    table: Dict[int, int] = {k: k for k in range(4096)}

    def worker(i: int, c: Counter):
        rng = XorShift(i + 29)
        if i < 2:
            def wr():
                while mem.now() < budget_ns:
                    k = rng.next() % 8192
                    t = lock.acquire_write()
                    if i == 0:
                        table.pop(k, None)
                    else:
                        table[k] = k
                    mem.work(12)
                    lock.release_write(t)
                    mem.work(60)
                    c.n += 1
            return wr

        def rd():
            while mem.now() < budget_ns:
                k = rng.next() % 8192
                t = lock.acquire_read()
                _ = table.get(k)
                mem.work(12)
                lock.release_read(t)
                c.n += 1
        return rd

    r = run_timed_named(env, nthreads, worker, budget_ns)
    r.bench = "fig6_hash_table"
    r.lock = lock_name
    r.threads = readers
    return r


# ------------------------------------------------------------- Figures 7/8
def locktorture(lock_name: str, readers: int, writers: int,
                read_hold_ns: int, write_hold_ns: int,
                budget_ns: int = 2_000_000,
                live: bool = False) -> BenchResult:
    nthreads = readers + writers
    env = make_env(nthreads, live)
    lock = env.make(lock_name)
    mem = env.mem
    reads = Counter()
    writes = Counter()

    def worker(i: int, c: Counter):
        if i < writers:
            def wr():
                while mem.now() < budget_ns:
                    t = lock.acquire_write()
                    mem.work(max(write_hold_ns // 4, 1))
                    lock.release_write(t)
                    mem.work(max(write_hold_ns // 8, 1))
                    c.n += 1
                    writes.n += 1
            return wr

        def rd():
            while mem.now() < budget_ns:
                t = lock.acquire_read()
                mem.work(max(read_hold_ns // 4, 1))
                lock.release_read(t)
                c.n += 1
                reads.n += 1
        return rd

    r = run_timed_named(env, nthreads, worker, budget_ns)
    r.bench = f"fig{'7' if writers else '8'}_locktorture" \
              f"_w{writers}_hold{read_hold_ns}"
    r.lock = lock_name
    r.threads = readers
    r.extras["reads"] = reads.n
    r.extras["writes"] = writes.n
    return r


# ------------------------------------------------------------- Tables 1/2
def metis_analogue(lock_name: str, nthreads: int, p_mmap: float,
                   budget_ns: int = 1_500_000,
                   live: bool = False) -> BenchResult:
    """Metis wc/wrmem analogue: worker threads fault pages (read-lock the
    address-space lock) and occasionally mmap/munmap (write-lock)."""
    env = make_env(nthreads, live)
    mmap_sem = env.make(lock_name)
    mem = env.mem
    vma = {"regions": 16}

    def worker(i: int, c: Counter):
        rng = XorShift(i + 101)

        def run():
            while mem.now() < budget_ns:
                if rng.uniform() < p_mmap:
                    t = mmap_sem.acquire_write()
                    vma["regions"] += 1
                    mem.work(40)
                    mmap_sem.release_write(t)
                else:
                    t = mmap_sem.acquire_read()   # page fault
                    mem.work(15)
                    mmap_sem.release_read(t)
                mem.work(50)                       # user-space map work
                c.n += 1
        return run

    r = run_timed_named(env, nthreads, worker, budget_ns)
    r.bench = f"metis_pmmap{p_mmap:g}"
    r.lock = lock_name
    return r


# --------------------------------------------------------------- plumbing
def run_timed_named(env: LockEnv, nthreads: int, worker,
                    budget_ns: int) -> BenchResult:
    counters = [Counter() for _ in range(nthreads)]
    fns = [worker(i, counters[i]) for i in range(nthreads)]
    env.mem.run_threads(fns)
    ops = sum(c.n for c in counters)
    elapsed = getattr(env.mem, "vtime", 1.0)
    return BenchResult("", "", nthreads, ops, float(elapsed))
