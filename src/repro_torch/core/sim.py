"""Deterministic discrete-event cache-coherence simulator.

``SimMem`` implements the :class:`repro_torch.core.atomics.Mem` interface so the
*same* lock algorithms run under real threads (``LiveMem``) or under this
simulator.  The simulator executes lock code on real OS threads but enforces a
strict global order: exactly one simulated thread runs at a time, and the
turn is always granted to the thread with the smallest virtual clock
(ties broken by thread id), so every memory operation is applied in
non-decreasing virtual-time order — a sequentially-consistent, deterministic
interleaving.

Virtual time advances according to a MESI-like coherence cost model over a
parameterized topology (default: 2 sockets x 18 cores x 2 SMT = 72 CPUs,
matching the paper's Oracle X5-2 system-under-test).  Loads/stores/RMWs are
charged local-hit / same-socket / cross-socket transfer latencies; sequential
table scans are charged a prefetch-amortized per-line cost (the paper observes
~1.1ns/slot); spin-waits are modeled by ``wait_while`` which is semantically a
spin loop but wakes the waiter exactly when the watched line changes, charging
the coherence transfer — the correct MESI cost (re-reads of a Shared line are
free until invalidated).
"""

from __future__ import annotations

import heapq
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

from .atomics import AtomicArray, Cell, Mem, MemStats

__all__ = ["SimMem", "Topology", "CoherenceParams", "SimDeadlock"]


class SimDeadlock(RuntimeError):
    pass


@dataclass(frozen=True)
class Topology:
    sockets: int = 2
    cores_per_socket: int = 18
    smt: int = 2

    @property
    def num_cpus(self) -> int:
        return self.sockets * self.cores_per_socket * self.smt

    def cpu_of(self, tid: int) -> int:
        """Spread threads across sockets first (free-range unbound threads)."""
        socket = tid % self.sockets
        core = (tid // self.sockets) % self.cores_per_socket
        smt = (tid // (self.sockets * self.cores_per_socket)) % self.smt
        return (socket, core, smt)

    def socket_of(self, tid: int) -> int:
        return tid % self.sockets


@dataclass
class CoherenceParams:
    local_hit_ns: float = 2.0
    smt_xfer_ns: float = 8.0
    same_socket_xfer_ns: float = 42.0
    cross_socket_xfer_ns: float = 120.0
    mem_lat_ns: float = 85.0
    rmw_extra_ns: float = 14.0       # lock-prefix overhead, even uncontended
    pause_ns: float = 25.0
    park_ns: float = 1600.0          # futex sleep entry (syscall + sched)
    wake_ns: float = 2200.0          # futex wake-to-run latency
    wake_call_ns: float = 350.0      # cost to the waker
    scan_per_line_ns: float = 8.8    # ~1.1ns/slot * 8 slots, prefetched
    work_ns: float = 3.6             # one unit ~ one std::mt19937 step
    fence_ns: float = 0.0            # subsumed by CAS on TSO


class _TState:
    __slots__ = ("clock", "cond", "done", "parked")

    def __init__(self, cond: threading.Condition):
        self.clock: float = 0.0
        self.cond = cond
        self.done = False
        self.parked = False


class SimMem(Mem):
    def __init__(self, num_threads: int, topology: Topology = Topology(),
                 params: CoherenceParams = CoherenceParams(),
                 collect_stats: bool = True):
        super().__init__()
        self.topo = topology
        self.p = params
        self.n = num_threads
        self._collect = collect_stats
        self._m = threading.Lock()
        self._ts: List[_TState] = [
            _TState(threading.Condition(self._m)) for _ in range(num_threads)
        ]
        self._vals: List[float] = []
        self._heap: List[Tuple[float, int]] = []
        self._turn: Optional[int] = None
        self._started = False
        self._registered = 0
        self._ndone = 0
        self._nparked = 0
        self._driver = threading.Condition(self._m)
        self._tl = threading.local()
        # coherence state per line
        self._owner: Dict[int, int] = {}          # line -> core-owner tid
        self._sharers: Dict[int, Set[int]] = {}   # line -> sharer tids
        # a line can serve one ownership transfer at a time: concurrent RMWs
        # to one cache line SERIALIZE (this is the coherence collapse that
        # central reader indicators suffer and BRAVO avoids)
        self._line_busy: Dict[int, float] = {}
        # futex + spin-watch state
        self._futex: Dict[int, List[int]] = {}    # cell index -> waiting tids
        self._watch: Dict[int, List[Tuple[int, Callable[[int], bool]]]] = {}

    # ------------------------------------------------------------------ alloc
    def alloc_array(self, name: str, n: int, init: int = 0,
                    entries_per_line: int = 8) -> AtomicArray:
        with self._m:
            base = len(self._vals)
            line0 = self._nlines
            nlines = (n + entries_per_line - 1) // entries_per_line
            self._vals.extend([init] * n)
            self._nwords += n
            self._nlines += nlines
        return AtomicArray(self, base, n, line0, entries_per_line, name)

    # ------------------------------------------------------------- identity
    def register_thread(self, tid: int) -> None:
        self._tl.tid = tid

    def thread_id(self) -> int:
        return self._tl.tid

    def _host_thread(self) -> bool:
        """True when called from a non-simulated (driver/test) thread —
        such callers get uncosted direct reads for post-mortem inspection."""
        return getattr(self._tl, "tid", None) is None

    def cpu_of(self, tid: Optional[int] = None) -> int:
        t = self.thread_id() if tid is None else tid
        s, c, m = self.topo.cpu_of(t)
        return (s * self.topo.cores_per_socket + c) * self.topo.smt + m

    def socket_of(self, tid: Optional[int] = None) -> int:
        t = self.thread_id() if tid is None else tid
        return self.topo.socket_of(t)

    @property
    def num_cpus(self) -> int:
        return self.topo.num_cpus

    @property
    def num_sockets(self) -> int:
        return self.topo.sockets

    # ---------------------------------------------------------- scheduling
    def _grant_next(self) -> None:
        """m held.  Grant the turn to the min-clock waiter, if any."""
        if self._turn is not None or not self._started:
            return
        if self._heap:
            _, u = heapq.heappop(self._heap)
            self._turn = u
            self._ts[u].cond.notify()
            return
        live = self.n - self._ndone
        if live > 0 and self._nparked == live:
            raise SimDeadlock(
                f"all {live} live threads are parked "
                f"(futex={ {k: v for k, v in self._futex.items() if v} }, "
                f"watch={ {k: [t for t, _ in v] for k, v in self._watch.items() if v} })")
        if live == 0:
            self._driver.notify_all()

    def _reschedule(self, t: int) -> None:
        """m held.  Re-enter the run queue and wait for our turn."""
        st = self._ts[t]
        heapq.heappush(self._heap, (st.clock, t))
        if self._turn == t:
            self._turn = None
        self._grant_next()
        while self._turn != t:
            st.cond.wait()

    def _maybe_yield(self, t: int) -> None:
        """m held, turn owned by t.  Yield if an earlier-clock thread waits."""
        st = self._ts[t]
        if self._heap and self._heap[0] < (st.clock, t):
            self._reschedule(t)

    def _ensure_turn(self, t: int) -> None:
        """m held.  Guarantee we own the turn and are globally minimal."""
        if self._turn != t:
            self._reschedule(t)
        else:
            self._maybe_yield(t)

    # ----------------------------------------------------------- coherence
    def _dist_ns(self, a: int, b: int) -> float:
        sa, ca, _ = self.topo.cpu_of(a)
        sb, cb, _ = self.topo.cpu_of(b)
        if sa == sb and ca == cb:
            return self.p.smt_xfer_ns
        if sa == sb:
            return self.p.same_socket_xfer_ns
        return self.p.cross_socket_xfer_ns

    def _charge_load(self, t: int, line: int) -> float:
        owner = self._owner.get(line)
        if owner == t:
            return self.p.local_hit_ns
        sh = self._sharers.setdefault(line, set())
        if owner is not None:
            cost = self._dist_ns(owner, t)
            del self._owner[line]
            sh.clear()
            sh.update((owner, t))
            self._bump_xfer(t, owner)
            return cost
        if t in sh:
            return self.p.local_hit_ns
        if sh:
            src = min(sh, key=lambda s: self._dist_ns(s, t))
            sh.add(t)
            self._bump_xfer(t, src)
            return self._dist_ns(src, t)
        sh.add(t)
        return self.p.mem_lat_ns

    def _charge_store(self, t: int, line: int, rmw: bool) -> float:
        extra = self.p.rmw_extra_ns if rmw else 0.0
        owner = self._owner.get(line)
        if owner == t:
            return self.p.local_hit_ns + extra
        sh = self._sharers.get(line) or set()
        cost = 0.0
        if owner is not None:
            cost = self._dist_ns(owner, t)
            self._bump_xfer(t, owner)
        elif sh - {t}:
            src = max(sh - {t}, key=lambda s: self._dist_ns(s, t))
            cost = self._dist_ns(src, t)
            self._bump_xfer(t, src)
        elif t in sh:
            cost = self.p.local_hit_ns  # S->M upgrade, no data transfer
        else:
            cost = self.p.mem_lat_ns
        self._owner[line] = t
        if line in self._sharers:
            self._sharers[line].clear()
        return cost + extra

    def _bump_xfer(self, a: int, b: int) -> None:
        if self._collect:
            self.stats.line_transfers += 1
            if self.topo.socket_of(a) != self.topo.socket_of(b):
                self.stats.remote_transfers += 1

    # ------------------------------------------------------------- mutation
    def _notify_change(self, t: int, cell_index: int, new_val: int) -> None:
        """m held.  Wake spin-watchers whose predicate is now false."""
        ws = self._watch.get(cell_index)
        if not ws:
            return
        keep: List[Tuple[int, Callable[[int], bool]]] = []
        st = self._ts[t]
        for (w, pred) in ws:
            if pred(new_val):
                keep.append((w, pred))
            else:
                wst = self._ts[w]
                # waiter's next load pays the transfer from the writer
                wst.clock = max(wst.clock, st.clock) + self._dist_ns(t, w)
                wst.parked = False
                self._nparked -= 1
                heapq.heappush(self._heap, (wst.clock, w))
        if keep:
            self._watch[cell_index] = keep
        else:
            del self._watch[cell_index]

    # ------------------------------------------------------------ atomic ops
    def load(self, cell: Cell) -> int:
        if self._host_thread():
            return self._vals[cell.index]
        t = self.thread_id()
        with self._m:
            self._ensure_turn(t)
            st = self._ts[t]
            cost = self._charge_load(t, cell.line)
            if cost > self.p.local_hit_ns:   # transfer: waits for the line
                start = max(st.clock, self._line_busy.get(cell.line, 0.0))
                st.clock = start + cost
                self._line_busy[cell.line] = st.clock
            else:
                st.clock += cost
            if self._collect:
                self.stats.loads += 1
            return self._vals[cell.index]

    def store(self, cell: Cell, value: int) -> None:
        t = self.thread_id()
        with self._m:
            self._ensure_turn(t)
            st = self._ts[t]
            cost = self._charge_store(t, cell.line, rmw=False)
            start = max(st.clock, self._line_busy.get(cell.line, 0.0)) \
                if cost > self.p.local_hit_ns else st.clock
            st.clock = start + cost
            self._line_busy[cell.line] = st.clock
            if self._collect:
                self.stats.stores += 1
            self._vals[cell.index] = value
            self._notify_change(t, cell.index, value)

    def _rmw(self, cell: Cell, fn: Callable[[int], Tuple[int, object]]):
        t = self.thread_id()
        with self._m:
            self._ensure_turn(t)
            st = self._ts[t]
            cost = self._charge_store(t, cell.line, rmw=True)
            start = max(st.clock, self._line_busy.get(cell.line, 0.0))
            st.clock = start + cost
            self._line_busy[cell.line] = st.clock
            if self._collect:
                self.stats.rmws += 1
                pl = self.stats.per_line_rmws
                pl[cell.line] = pl.get(cell.line, 0) + 1
            old = self._vals[cell.index]
            new, ret = fn(old)
            if new != old:
                self._vals[cell.index] = new
                self._notify_change(t, cell.index, new)
            return ret

    def cas(self, cell: Cell, expect: int, new: int) -> bool:
        return self._rmw(
            cell, lambda old: (new, True) if old == expect else (old, False))

    def fetch_add(self, cell: Cell, delta: int) -> int:
        return self._rmw(cell, lambda old: (old + delta, old))

    def fetch_or(self, cell: Cell, bits: int) -> int:
        return self._rmw(cell, lambda old: (old | bits, old))

    def fetch_and(self, cell: Cell, bits: int) -> int:
        return self._rmw(cell, lambda old: (old & bits, old))

    def swap(self, cell: Cell, new: int) -> int:
        return self._rmw(cell, lambda old: (new, old))

    def scan_array(self, arr: AtomicArray, match: int) -> List[int]:
        if self._host_thread():
            base, vals = arr.base, self._vals
            return [i for i in range(arr.n) if vals[base + i] == match]
        t = self.thread_id()
        with self._m:
            self._ensure_turn(t)
            nlines = (arr.n + arr.entries_per_line - 1) // arr.entries_per_line
            cost = nlines * self.p.scan_per_line_ns
            # lines dirty in another core must be transferred (not hidden by
            # the prefetcher); the scan demotes them to Shared.
            for li in range(arr.line0, arr.line0 + nlines):
                owner = self._owner.get(li)
                if owner is not None and owner != t:
                    cost += self._dist_ns(owner, t)
                    del self._owner[li]
                    self._sharers.setdefault(li, set()).update((owner, t))
                    self._bump_xfer(t, owner)
            self._ts[t].clock += cost
            if self._collect:
                self.stats.scans += 1
            base = arr.base
            vals = self._vals
            return [i for i in range(arr.n) if vals[base + i] == match]

    # ------------------------------------------------------- time / waiting
    def now(self) -> int:
        return int(self._ts[self.thread_id()].clock)

    def pause(self) -> None:
        t = self.thread_id()
        with self._m:
            self._ensure_turn(t)
            self._ts[t].clock += self.p.pause_ns

    def work(self, units: int) -> None:
        t = self.thread_id()
        with self._m:
            self._ensure_turn(t)
            self._ts[t].clock += units * self.p.work_ns

    def fence(self) -> None:
        if self.p.fence_ns:
            t = self.thread_id()
            with self._m:
                self._ensure_turn(t)
                self._ts[t].clock += self.p.fence_ns

    def wait_while(self, cell: Cell, pred: Callable[[int], bool]) -> None:
        """Spin-wait (MESI-accurately) while ``pred(cell)`` holds."""
        t = self.thread_id()
        st = self._ts[t]
        with self._m:
            while True:
                self._ensure_turn(t)
                st.clock += self._charge_load(t, cell.line)
                if self._collect:
                    self.stats.loads += 1
                if not pred(self._vals[cell.index]):
                    return
                # park as a spin-watcher: wakes exactly when the line changes
                self._watch.setdefault(cell.index, []).append((t, pred))
                st.parked = True
                self._nparked += 1
                if self._turn == t:
                    self._turn = None
                self._grant_next()
                while self._turn != t:
                    st.cond.wait()

    # ----------------------------------------------------------------- futex
    def futex_wait(self, cell: Cell, expect: int) -> None:
        t = self.thread_id()
        st = self._ts[t]
        with self._m:
            self._ensure_turn(t)
            st.clock += self._charge_load(t, cell.line)
            if self._vals[cell.index] != expect:
                return
            if self._collect:
                self.stats.parks += 1
            st.clock += self.p.park_ns
            self._futex.setdefault(cell.index, []).append(t)
            st.parked = True
            self._nparked += 1
            if self._turn == t:
                self._turn = None
            self._grant_next()
            while self._turn != t:
                st.cond.wait()

    def futex_wake(self, cell: Cell, n: int = 1 << 30) -> None:
        t = self.thread_id()
        with self._m:
            self._ensure_turn(t)
            st = self._ts[t]
            st.clock += self.p.wake_call_ns
            ws = self._futex.get(cell.index)
            if not ws:
                return
            wake, rest = ws[:n], ws[n:]
            if rest:
                self._futex[cell.index] = rest
            else:
                del self._futex[cell.index]
            for w in wake:
                if self._collect:
                    self.stats.wakes += 1
                wst = self._ts[w]
                wst.clock = max(wst.clock, st.clock) + self.p.wake_ns
                wst.parked = False
                self._nparked -= 1
                heapq.heappush(self._heap, (wst.clock, w))

    # ------------------------------------------------------------- lifecycle
    def run_threads(self, fns: List[Callable[[], None]]) -> None:
        assert len(fns) == self.n, (len(fns), self.n)
        errs: List[BaseException] = []

        def wrap(tid: int, fn: Callable[[], None]) -> None:
            self.register_thread(tid)
            st = self._ts[tid]
            try:
                with self._m:
                    self._registered += 1
                    heapq.heappush(self._heap, (st.clock, tid))
                    if self._registered == self.n:
                        self._driver.notify_all()
                    while self._turn != tid:
                        st.cond.wait()
                fn()
            except BaseException as e:
                errs.append(e)
            finally:
                with self._m:
                    st.done = True
                    self._ndone += 1
                    if self._turn == tid:
                        self._turn = None
                    try:
                        self._grant_next()
                    except SimDeadlock as e:
                        errs.append(e)
                        self._driver.notify_all()
                    if self._ndone == self.n:
                        self._driver.notify_all()

        threads = [threading.Thread(target=wrap, args=(i, fn), daemon=True)
                   for i, fn in enumerate(fns)]
        for th in threads:
            th.start()
        with self._m:
            while self._registered < self.n:
                self._driver.wait()
            self._started = True
            self._grant_next()
            while self._ndone < self.n and not errs:
                self._driver.wait(timeout=1.0)
        for th in threads:
            th.join(timeout=30.0)
        if errs:
            raise errs[0]

    @property
    def vtime(self) -> float:
        """Max virtual clock across threads (simulation duration)."""
        return max(st.clock for st in self._ts)
