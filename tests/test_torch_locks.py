"""The port's lock zoo and BRAVO transformation (``repro_torch.core``):
the twin of ``tests/test_locks.py``, and the lock smoke
(``repro_torch.benchmarks.smoke_locks``) under ``SimMem`` equal to the
reference's locks run by the same program, virtual time and cache-line
transfers alike."""

import threading

import pytest

import repro.core as ref_core
from repro_torch.benchmarks import smoke_locks
from repro_torch.core.atomics import LiveMem
from repro_torch.core.factory import ALL_LOCK_NAMES, LockEnv
from repro_torch.core.sim import SimMem, Topology

SIM_TOPO = Topology(sockets=2, cores_per_socket=2, smt=2)


def make_env(backend: str, nthreads: int) -> LockEnv:
    if backend == "live":
        return LockEnv(LiveMem(num_cpus=8))
    return LockEnv(SimMem(nthreads, SIM_TOPO))


BACKENDS = ["live", "sim"]
NAMES = list(ALL_LOCK_NAMES) + ["bravo-cohort-rw"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", NAMES)
def test_mutual_exclusion_and_read_consistency(backend, name):
    """Readers never observe a torn write; writer updates are all applied."""
    nthreads, iters = 4, 40
    env = make_env(backend, nthreads)
    lock = env.make(name)
    mem = env.mem
    shared = {"a": 0, "b": 0}
    torn = []

    def reader():
        for _ in range(iters):
            t = lock.acquire_read()
            a = shared["a"]
            mem.work(3)
            b = shared["b"]
            if a != b:
                torn.append((a, b))
            lock.release_read(t)
            mem.work(5)

    def writer():
        for _ in range(iters):
            t = lock.acquire_write()
            shared["a"] += 1
            mem.work(3)
            shared["b"] += 1
            lock.release_write(t)
            mem.work(5)

    mem.run_threads([reader] * (nthreads - 1) + [writer])
    assert not torn, torn[:3]
    assert shared["a"] == shared["b"] == iters


@pytest.mark.parametrize("backend", BACKENDS)
def test_readers_run_concurrently(backend):
    """With no writers, BRAVO readers overlap (read-read concurrency)."""
    nthreads = 4
    env = make_env(backend, nthreads)
    lock = env.make("bravo-ba")
    mem = env.mem
    state = {"active": 0, "max_active": 0}
    guard = threading.Lock()

    def reader():
        for _ in range(20):
            t = lock.acquire_read()
            with guard:
                state["active"] += 1
                state["max_active"] = max(state["max_active"],
                                          state["active"])
            mem.work(20)
            with guard:
                state["active"] -= 1
            lock.release_read(t)

    mem.run_threads([reader] * nthreads)
    if backend == "sim":
        # deterministic: with long read sections, overlap must occur
        assert state["max_active"] >= 2


def test_bravo_fastpath_and_table_hygiene():
    env = LockEnv(LiveMem(num_cpus=8))
    lock = env.make("bravo-ba")
    mem = env.mem

    def reader():
        for _ in range(50):
            t = lock.acquire_read()
            lock.release_read(t)

    mem.run_threads([reader] * 4)
    st = lock.stats
    assert st.fast_acquires > 0, "fast path never taken"
    # all slots must be clear after quiescence
    assert env.table.scan(lock.lock_id) == []


def test_bravo_revocation_blocks_writer_until_readers_leave():
    """A fast-path reader inside its CS must block a revoking writer."""
    env = LockEnv(SimMem(2, SIM_TOPO))
    lock = env.make("bravo-ba")
    mem = env.mem
    order = []

    def reader():
        t = lock.acquire_read()
        order.append(("r_in", mem.now()))
        mem.work(2000)           # long critical section
        order.append(("r_out", mem.now()))
        lock.release_read(t)

    def writer():
        mem.work(200)            # arrive while the reader is inside
        t = lock.acquire_write()
        order.append(("w_in", mem.now()))
        lock.release_write(t)

    mem.run_threads([reader, writer])
    ev = [e for e, _ in order]
    assert ev.index("w_in") > ev.index("r_out"), order
    assert lock.stats.revocations == 1


def test_inhibit_until_disables_bias_after_revocation():
    env = LockEnv(SimMem(1, SIM_TOPO), n=9)
    lock = env.make("bravo-ba")
    mem = env.mem

    def run():
        t = lock.acquire_read()       # slow path -> sets RBias
        lock.release_read(t)
        t = lock.acquire_read()       # fast path now
        lock.release_read(t)
        assert lock.stats.fast_acquires == 1
        t = lock.acquire_write()      # revokes
        lock.release_write(t)
        assert lock.rbias.load() == 0
        inhibit = lock.inhibit_until.load()
        assert inhibit > mem.now()    # InhibitUntil = now + N * revocation
        t = lock.acquire_read()       # slow path again; too early to re-arm
        lock.release_read(t)
        assert lock.rbias.load() == 0

    mem.run_threads([run])


def test_writer_slowdown_bound_n9():
    """Listing 1's policy: revocation cost is amortized below ~1/(N+1)."""
    env = LockEnv(SimMem(2, SIM_TOPO), n=9)
    lock = env.make("bravo-ba")
    mem = env.mem
    stats = {}

    def writer():
        for _ in range(200):
            t = lock.acquire_write()
            mem.work(10)
            lock.release_write(t)
            mem.work(10)
        stats["end"] = mem.now()

    def reader():
        for _ in range(200):
            t = lock.acquire_read()
            mem.work(2)
            lock.release_read(t)
            mem.work(2)

    mem.run_threads([writer, reader])
    st = lock.stats
    # revocation time must be <= ~1/(N+1) of total elapsed time
    assert st.revocation_ns <= stats["end"] / (env.n + 1) * 1.5, \
        (st.revocation_ns, stats["end"])


@pytest.mark.parametrize("name", ["ba", "pthread", "cohort-rw"])
def test_footprint_accounting(name):
    env = LockEnv(LiveMem())
    base = env.make(name)
    wrapped = env.make(f"bravo-{name}")
    assert wrapped.footprint_bytes() == base.footprint_bytes() + 12
    assert env.table.footprint_bytes() == 4096 * 8  # 32KB shared table


def test_revocation_inhibit_window_and_fastpath_recovery():
    """Paper §3 (*primum non nocere*): after a writer revocation, readers
    must NOT re-arm RBias while ``now < InhibitUntil`` (every acquisition in
    the window takes the slow path), and once the window passes the bias
    re-arms and ``fastpath_rate`` recovers."""
    env = LockEnv(SimMem(1, SIM_TOPO), n=9)
    lock = env.make("bravo-ba")
    mem = env.mem

    def run():
        st = lock.stats
        t = lock.acquire_read()          # slow path; arms RBias
        lock.release_read(t)
        t = lock.acquire_read()          # fast path
        lock.release_read(t)
        assert st.fast_acquires == 1
        t = lock.acquire_write()         # revokes; opens the inhibit window
        lock.release_write(t)
        assert st.revocations == 1
        inhibit = lock.inhibit_until.load()
        assert inhibit > mem.now()

        fast_before = st.fast_acquires
        in_window = 0
        while mem.now() < inhibit and in_window < 500:
            t = lock.acquire_read()
            if mem.now() < inhibit:      # still inside the window
                assert lock.rbias.load() == 0, \
                    "RBias re-armed before InhibitUntil"
            lock.release_read(t)
            in_window += 1
        assert in_window >= 1
        # every acquisition that started inside the window was slow-path
        assert st.fast_acquires == fast_before
        rate_window = st.fastpath_rate

        while mem.now() < inhibit:       # idle past the window
            mem.work(50)
        t = lock.acquire_read()          # slow path; re-arms RBias
        lock.release_read(t)
        assert lock.rbias.load() == 1
        fast_mid = st.fast_acquires
        for _ in range(50):
            t = lock.acquire_read()
            lock.release_read(t)
        assert st.fast_acquires == fast_mid + 50
        assert st.fastpath_rate > rate_window

    mem.run_threads([run])


def test_shared_table_across_locks():
    """One table serves every lock in the address space (paper §3)."""
    env = LockEnv(LiveMem(num_cpus=8))
    locks = [env.make("bravo-ba") for _ in range(16)]
    mem = env.mem

    def worker(i):
        def run():
            for k in range(30):
                lk = locks[(i + k) % len(locks)]
                t = lk.acquire_read()
                mem.work(2)
                lk.release_read(t)
        return run

    mem.run_threads([worker(i) for i in range(4)])
    for lk in locks:
        assert env.table.scan(lk.lock_id) == []


@pytest.mark.parametrize("name", smoke_locks.ALL)
def test_smoke_locks_sim_equals_reference(name):
    """``smoke_locks.exercise`` under ``SimMem(6, Topology(2, 2, 2))``: the
    port's lock and the reference's lock give the same virtual time, the
    same cache-line transfers and the same BRAVO stats line."""
    runs = []
    for core_env, core_sim in (
            (LockEnv, (SimMem, Topology)),
            (ref_core.LockEnv, (ref_core.SimMem, ref_core.Topology))):
        sim, topo = core_sim
        env = core_env(sim(6, topo(2, 2, 2)))
        line = smoke_locks.exercise(env, 6, 60, name)
        runs.append((env.mem.vtime, env.mem.stats.line_transfers, line))
    assert runs[0] == runs[1]
    assert runs[0][0] > 0 and runs[0][1] > 0


def test_smoke_locks_run_covers_every_variant():
    lines = []
    sims = smoke_locks.run(lines.append)
    assert [r["lock"] for r in sims] == smoke_locks.ALL
    assert set(smoke_locks.ALL) == set(ALL_LOCK_NAMES) | {"bravo-cohort-rw"}
    for name in smoke_locks.ALL:
        assert f"live ok: {name}" in lines
