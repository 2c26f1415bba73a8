"""Underlying reader-writer locks evaluated in the paper.

All locks implement :class:`RWLock` against the abstract memory interface
(:mod:`repro_torch.core.atomics`), so the same code runs under real threads
(``LiveMem``) and the coherence simulator (``SimMem``).

Implemented locks (paper §2/§5):

* :class:`CentralCounterRWLock` — "pthread": centralized reader counter,
  reader preference (writer starvation admitted), blocking waiters (futex).
* :class:`PFTLock` — Brandenburg-Anderson Phase-Fair Ticket (PF-T):
  centralized rin/rout counter pair, global spinning.
* :class:`PFQLock` — "BA": phase-fair with centralized rin/rout reader
  indicator, MCS writer queue with local spinning, and locally-spinning
  waiting readers (per-thread flags drained by the releasing writer).
* :class:`PerCPULock` — one BA sub-lock per logical CPU; readers acquire
  their CPU's sub-lock, writers acquire all of them.
* :class:`CohortRWLock` — C-RW-WP: per-NUMA-node ingress/egress reader
  indicators + cohort mutex for writers (writer preference).

Tokens: ``acquire_read``/``acquire_write`` return a token that must be passed
to the matching release.  Locks that need no token return ``None``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .atomics import Cell, Mem

__all__ = [
    "RWLock",
    "CentralCounterRWLock",
    "PFTLock",
    "PFQLock",
    "PerCPULock",
    "CohortRWLock",
    "LOCK_FAMILIES",
]


class RWLock:
    name = "rwlock"

    def acquire_read(self):
        raise NotImplementedError

    def release_read(self, tok) -> None:
        # tok is mandatory across the interface: several implementations
        # (BRAVO, percpu, cohort-rw) cannot release without it; locks that
        # need no token return None from acquire and ignore it here
        raise NotImplementedError

    def acquire_write(self):
        raise NotImplementedError

    def release_write(self, tok) -> None:
        raise NotImplementedError

    def footprint_bytes(self) -> int:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# pthread-like centralized counter lock (reader preference, blocking)
# ---------------------------------------------------------------------------

_ACTIVE_W = 0x1
_WWAIT = 0x2            # waiting-writer count, bits 1..11
_WWAIT_MASK = 0xFFE
_RD = 0x1000            # reader count, bits 12+


class CentralCounterRWLock(RWLock):
    """Centralized reader-counter lock in the style of glibc pthread_rwlock
    (default PREFER_READER policy: readers never block on waiting writers,
    admitting writer starvation; waiters block in the 'kernel' via futex)."""

    name = "pthread"

    def __init__(self, mem: Mem):
        self.mem = mem
        self.state = mem.alloc("pthread.state")

    def acquire_read(self):
        st = self.state
        while True:
            s = st.load()
            if s & _ACTIVE_W:
                self.mem.futex_wait(st, s)
                continue
            if st.cas(s, s + _RD):
                return None

    def release_read(self, tok=None) -> None:
        old = self.state.fetch_add(-_RD)
        new = old - _RD
        if (new >> 12) == 0 and (new & _WWAIT_MASK):
            self.mem.futex_wake(self.state)

    def acquire_write(self):
        st = self.state
        registered = False
        while True:
            s = st.load()
            if (s >> 12) == 0 and not (s & _ACTIVE_W):
                new = (s | _ACTIVE_W) - (_WWAIT if registered else 0)
                if st.cas(s, new):
                    return None
                continue
            if not registered:
                st.fetch_add(_WWAIT)
                registered = True
                continue
            self.mem.futex_wait(st, s)

    def release_write(self, tok=None) -> None:
        old = self.state.fetch_add(-_ACTIVE_W)
        if (old - _ACTIVE_W) != 0 or True:
            # wake both waiting readers and writers; readers win the race
            # (reader preference)
            self.mem.futex_wake(self.state)

    def footprint_bytes(self) -> int:
        return 56  # glibc pthread_rwlock_t on 64-bit Linux (paper §5)


# ---------------------------------------------------------------------------
# Brandenburg-Anderson PF-T (phase-fair ticket; global spinning)
# ---------------------------------------------------------------------------

_PHID = 0x1
_PRES = 0x2
_WBITS = 0x3
_RINC = 0x4


class PFTLock(RWLock):
    name = "pf-t"

    def __init__(self, mem: Mem):
        self.mem = mem
        self.rin = mem.alloc("pft.rin")
        self.rout = mem.alloc("pft.rout")
        self.win = mem.alloc("pft.win")
        self.wout = mem.alloc("pft.wout")

    def acquire_read(self):
        w = self.rin.fetch_add(_RINC) & _WBITS
        if w != 0:
            # wait for the current writer phase to end (global spin on rin)
            self.mem.wait_while(self.rin, lambda v: (v & _WBITS) == w)
        return None

    def release_read(self, tok=None) -> None:
        self.rout.fetch_add(_RINC)

    def acquire_write(self):
        t = self.win.fetch_add(1)
        self.mem.wait_while(self.wout, lambda v: v != t)
        w = _PRES | (t & _PHID)
        old = self.rin.fetch_or(w)
        target = old & ~_WBITS  # readers that arrived before us
        self.mem.wait_while(self.rout, lambda v: (v & ~_WBITS) != target)
        return None

    def release_write(self, tok=None) -> None:
        self.rin.fetch_and(~_WBITS)   # ends the write phase; admits readers
        self.wout.fetch_add(1)

    def footprint_bytes(self) -> int:
        return 128  # 4 ints padded to one 128B sector


# ---------------------------------------------------------------------------
# Brandenburg-Anderson PF-Q ("BA"): central reader counters + local spinning
# ---------------------------------------------------------------------------


class _PerThreadNodes:
    """Lazily-allocated per-(lock, thread) cells (MCS qnodes, wait flags)."""

    def __init__(self, mem: Mem, name: str, cells_per_thread: int):
        self.mem = mem
        self.name = name
        self.k = cells_per_thread
        self._nodes: Dict[int, Tuple[Cell, ...]] = {}

    def get(self, tid: int) -> Tuple[Cell, ...]:
        node = self._nodes.get(tid)
        if node is None:
            arr = self.mem.alloc_array(f"{self.name}.t{tid}", self.k,
                                       entries_per_line=self.k)
            node = tuple(arr.cell(i) for i in range(self.k))
            self._nodes[tid] = node  # dict insert: atomic under CPython GIL
        return node


class PFQLock(RWLock):
    """Phase-fair queue lock ("BA" in the paper).

    Properties preserved from Brandenburg-Anderson PF-Q: centralized rin/rout
    reader-indicator counters RMW'd by every arriving/departing reader (the
    coherence hot-spot BRAVO targets), an MCS queue with local spinning for
    writers, local spinning on per-thread flags for waiting readers, and
    phase-fairness (a waiting reader cohort is admitted at the end of the
    current write phase, and the next writer waits for it to drain).
    """

    name = "ba"

    def __init__(self, mem: Mem):
        self.mem = mem
        self.rin = mem.alloc("pfq.rin")
        self.rout = mem.alloc("pfq.rout")
        self.wtail = mem.alloc("pfq.wtail")     # MCS tail: tid+1 or 0
        self.wphase = mem.alloc("pfq.wphase")   # write-phase parity source
        self.rhead = mem.alloc("pfq.rhead")     # Treiber stack of waiters
        # per-thread cells: [mcs_locked, mcs_next, rflag, rnext]
        self._nodes = _PerThreadNodes(mem, "pfq.nodes", 4)
        self._registry: Dict[int, Tuple[Cell, ...]] = self._nodes._nodes
        # owner-side record of "my node may still be on the stack" (a reader
        # can return while its node is still linked; re-pushing a linked node
        # would create a cycle).  Only the owning thread touches its entry.
        self._pushed: Dict[int, bool] = {}

    # -- readers ------------------------------------------------------------
    def acquire_read(self):
        mem = self.mem
        w = self.rin.fetch_add(_RINC) & _WBITS
        if w == 0:
            return None
        tid = mem.thread_id()
        _, _, rflag, rnext = self._nodes.get(tid)
        while True:
            v = self.rin.load()
            if (v & _WBITS) != w:
                return None  # phase ended while we prepared to wait
            if self._pushed.get(tid):
                if rflag.load() == 0:
                    # node still linked from an earlier early-return: reuse
                    # it — the active phase-w writer will drain it on release
                    mem.wait_while(rflag, lambda f: f == 0)
                    continue
                self._pushed[tid] = False  # drained; node is free again
            rflag.store(0)
            # push self on the waiter stack
            while True:
                h = self.rhead.load()
                rnext.store(h)
                if self.rhead.cas(h, tid + 1):
                    break
            self._pushed[tid] = True
            # recheck: the phase may have ended between fetch_add and push
            v = self.rin.load()
            if (v & _WBITS) != w:
                return None  # node stays linked; next drain frees it
            mem.wait_while(rflag, lambda f: f == 0)  # local spin

    def release_read(self, tok=None) -> None:
        self.rout.fetch_add(_RINC)

    # -- writers ------------------------------------------------------------
    def acquire_write(self):
        mem = self.mem
        tid = mem.thread_id()
        locked, nxt, _, _ = self._nodes.get(tid)
        locked.store(1)
        nxt.store(0)
        pred = self.wtail.swap(tid + 1)
        if pred != 0:
            plocked, pnext, _, _ = self._nodes.get(pred - 1)
            pnext.store(tid + 1)
            mem.wait_while(locked, lambda v: v == 1)  # local spin
        # we are the active writer; open our write phase
        p = self.wphase.fetch_add(1) & _PHID
        old = self.rin.fetch_or(_PRES | p)
        target = old & ~_WBITS
        mem.wait_while(self.rout, lambda v: (v & ~_WBITS) != target)
        return None

    def release_write(self, tok=None) -> None:
        mem = self.mem
        tid = mem.thread_id()
        self.rin.fetch_and(~_WBITS)      # end of write phase
        # wake the waiting-reader cohort (one store per waiter: local spin)
        h = self.rhead.swap(0)
        while h != 0:
            _, _, rflag, rnext = self._nodes.get(h - 1)
            h = rnext.load()
            rflag.store(1)
        # MCS handoff to the next writer
        locked, nxt, _, _ = self._nodes.get(tid)
        if nxt.load() == 0:
            if self.wtail.cas(tid + 1, 0):
                return
            mem.wait_while(nxt, lambda v: v == 0)
        succ = nxt.load()
        slocked, _, _, _ = self._nodes.get(succ - 1)
        slocked.store(0)

    def footprint_bytes(self) -> int:
        return 128  # 2 ints + 4 pointers, one 128B sector (paper §5)


# ---------------------------------------------------------------------------
# Per-CPU distributed lock (brlock-style)
# ---------------------------------------------------------------------------


class PerCPULock(RWLock):
    name = "percpu"

    def __init__(self, mem: Mem, ncpu: Optional[int] = None):
        self.mem = mem
        self.ncpu = ncpu if ncpu is not None else mem.num_cpus
        self.subs: List[PFQLock] = [PFQLock(mem) for _ in range(self.ncpu)]

    def acquire_read(self):
        i = self.mem.cpu_of() % self.ncpu
        self.subs[i].acquire_read()
        return i

    def release_read(self, tok) -> None:
        # token = the CPU index acquired on; required, None would misindex
        self.subs[tok].release_read()

    def acquire_write(self):
        for s in self.subs:
            s.acquire_write()
        return None

    def release_write(self, tok=None) -> None:
        for s in self.subs:
            s.release_write()

    def footprint_bytes(self) -> int:
        return 128 * self.ncpu  # one padded BA instance per logical CPU


# ---------------------------------------------------------------------------
# Cohort reader-writer lock, C-RW-WP (writer preference)
# ---------------------------------------------------------------------------


class _CohortMutex:
    """Two-level cohort mutex: per-node ticket locks + global flag with
    intra-node ownership passing (bounded by ``pass_limit``)."""

    def __init__(self, mem: Mem, nodes: int, pass_limit: int = 64):
        self.mem = mem
        self.nodes = nodes
        self.pass_limit = pass_limit
        self.tin = [mem.alloc(f"cohort.tin{n}") for n in range(nodes)]
        self.tout = [mem.alloc(f"cohort.tout{n}") for n in range(nodes)]
        self.have_global = [mem.alloc(f"cohort.hg{n}") for n in range(nodes)]
        self.passes = [mem.alloc(f"cohort.pass{n}") for n in range(nodes)]
        self.gflag = mem.alloc("cohort.gflag")

    def acquire(self, node: int) -> None:
        mem = self.mem
        t = self.tin[node].fetch_add(1)
        mem.wait_while(self.tout[node], lambda v: v != t)
        if self.have_global[node].load():
            return  # global ownership passed within our cohort
        while True:
            if self.gflag.cas(0, 1):
                return
            mem.wait_while(self.gflag, lambda v: v == 1)

    def release(self, node: int) -> None:
        waiters = self.tin[node].load() > self.tout[node].load() + 1
        if waiters and self.passes[node].load() < self.pass_limit:
            self.passes[node].fetch_add(1)
            self.have_global[node].store(1)
        else:
            self.have_global[node].store(0)
            self.passes[node].store(0)
            self.gflag.store(0)
        self.tout[node].fetch_add(1)

    def footprint_bytes(self) -> int:
        return 128 * self.nodes + 128


class CohortRWLock(RWLock):
    """C-RW-WP from Calciu et al.: distributed per-node reader indicators
    (ingress/egress pairs) + a cohort mutex for writers; writer preference."""

    name = "cohort-rw"

    def __init__(self, mem: Mem, nodes: Optional[int] = None):
        self.mem = mem
        self.nodes = nodes if nodes is not None else mem.num_sockets
        self.ingress = [mem.alloc(f"crw.in{n}") for n in range(self.nodes)]
        self.egress = [mem.alloc(f"crw.eg{n}") for n in range(self.nodes)]
        self.wflag = mem.alloc("crw.wflag")
        self.mutex = _CohortMutex(mem, self.nodes)

    def acquire_read(self):
        mem = self.mem
        node = mem.socket_of() % self.nodes
        while True:
            self.ingress[node].fetch_add(1)
            if self.wflag.load() == 0:
                return node
            # writer present: back out and wait (writer preference)
            self.egress[node].fetch_add(1)
            mem.wait_while(self.wflag, lambda v: v == 1)

    def release_read(self, tok) -> None:
        # token = the NUMA node whose ingress we bumped; required
        self.egress[tok].fetch_add(1)

    def acquire_write(self):
        mem = self.mem
        node = mem.socket_of() % self.nodes
        self.mutex.acquire(node)
        self.wflag.store(1)
        for n in range(self.nodes):
            while True:
                i = self.ingress[n].load()
                e = self.egress[n].load()
                if i == e:
                    break
                mem.wait_while(self.egress[n], lambda v, i=i: v < i)
        return node

    def release_write(self, tok) -> None:
        # token = the node the cohort mutex was acquired on; required
        self.wflag.store(0)
        self.mutex.release(tok)

    def footprint_bytes(self) -> int:
        # per-node indicator sectors + central state + cohort mutex (paper §5)
        return 128 * self.nodes + 128 + self.mutex.footprint_bytes()


LOCK_FAMILIES = {
    "pthread": CentralCounterRWLock,
    "pf-t": PFTLock,
    "ba": PFQLock,
    "percpu": PerCPULock,
    "cohort-rw": CohortRWLock,
}
