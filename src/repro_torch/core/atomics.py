"""Atomic memory substrate shared by all lock implementations.

Lock algorithms (``repro_torch.core.rwlocks``, ``repro_torch.core.bravo``) are written
against the abstract :class:`Mem` interface.  Two backends exist:

* :class:`LiveMem` — real ``threading`` threads.  CAS/fetch-add are built on
  striped micro-locks (one per simulated cache line), which both provides
  atomicity under CPython and models per-cache-line exclusivity.
* :class:`repro_torch.core.sim.SimMem` — a deterministic discrete-event simulator
  with a MESI-like coherence cost model over a parameterized 2-socket
  topology.  The *same* lock code runs under both backends.

All cell values are Python ints (lock identities are small ints handed out by
:func:`repro_torch.core.table.lock_id`), which keeps CAS semantics trivial in both
backends.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

__all__ = [
    "Cell",
    "AtomicArray",
    "Mem",
    "LiveMem",
    "MemStats",
]


@dataclass
class Cell:
    """A single atomically-accessed machine word.

    ``line`` identifies the cache line the word lives on; cells that share a
    ``line`` contend (false sharing) in both backends.
    """

    mem: "Mem"
    index: int
    line: int
    name: str = ""

    def load(self) -> int:
        return self.mem.load(self)

    def store(self, value: int) -> None:
        self.mem.store(self, value)

    def cas(self, expect: int, new: int) -> bool:
        return self.mem.cas(self, expect, new)

    def fetch_add(self, delta: int) -> int:
        return self.mem.fetch_add(self, delta)

    def fetch_or(self, bits: int) -> int:
        return self.mem.fetch_or(self, bits)

    def fetch_and(self, bits: int) -> int:
        return self.mem.fetch_and(self, bits)

    def swap(self, new: int) -> int:
        return self.mem.swap(self, new)

    def wait_while(self, pred) -> None:
        self.mem.wait_while(self, pred)


class AtomicArray:
    """A contiguous array of cells, ``entries_per_line`` words per line."""

    def __init__(self, mem: "Mem", base: int, n: int, line0: int,
                 entries_per_line: int, name: str):
        self.mem = mem
        self.base = base
        self.n = n
        self.line0 = line0
        self.entries_per_line = entries_per_line
        self.name = name
        self._cells = [
            Cell(mem, base + i, line0 + i // entries_per_line, f"{name}[{i}]")
            for i in range(n)
        ]

    def __len__(self) -> int:
        return self.n

    def cell(self, i: int) -> Cell:
        return self._cells[i]

    def scan(self, match: int) -> List[int]:
        """Sequential scan for ``match``; returns matching indices.

        Backends charge a prefetch-amortized cost (the paper reports
        ~1.1ns/slot on real hardware thanks to hardware prefetch); the scan
        itself reads every slot, exactly like Listing 1 lines 42-44.
        """
        return self.mem.scan_array(self, match)


@dataclass
class MemStats:
    loads: int = 0
    stores: int = 0
    rmws: int = 0
    scans: int = 0
    parks: int = 0
    wakes: int = 0
    # coherence events are only meaningful under SimMem
    line_transfers: int = 0
    remote_transfers: int = 0
    per_line_rmws: Dict[int, int] = field(default_factory=dict)

    def snapshot(self) -> "MemStats":
        s = MemStats(self.loads, self.stores, self.rmws, self.scans,
                     self.parks, self.wakes, self.line_transfers,
                     self.remote_transfers, dict(self.per_line_rmws))
        return s


class Mem:
    """Abstract atomic memory + thread services."""

    def __init__(self) -> None:
        self.stats = MemStats()
        self._nlines = 0
        self._nwords = 0

    # ---- allocation ------------------------------------------------------
    def alloc(self, name: str = "", init: int = 0) -> Cell:
        """Allocate one word on its own (padded) cache line."""
        arr = self.alloc_array(name, 1, init=init, entries_per_line=1)
        return arr.cell(0)

    def alloc_array(self, name: str, n: int, init: int = 0,
                    entries_per_line: int = 8) -> AtomicArray:
        raise NotImplementedError

    # ---- atomic ops ------------------------------------------------------
    def load(self, cell: Cell) -> int:
        raise NotImplementedError

    def store(self, cell: Cell, value: int) -> None:
        raise NotImplementedError

    def cas(self, cell: Cell, expect: int, new: int) -> bool:
        raise NotImplementedError

    def fetch_add(self, cell: Cell, delta: int) -> int:
        raise NotImplementedError

    def fetch_or(self, cell: Cell, bits: int) -> int:
        raise NotImplementedError

    def fetch_and(self, cell: Cell, bits: int) -> int:
        raise NotImplementedError

    def swap(self, cell: Cell, new: int) -> int:
        raise NotImplementedError

    def scan_array(self, arr: AtomicArray, match: int) -> List[int]:
        raise NotImplementedError

    def fence(self) -> None:
        """store-load fence; subsumed by CAS on TSO, so a no-op by default."""

    # ---- time / scheduling ----------------------------------------------
    def now(self) -> int:
        """Monotonic time in ns (virtual under SimMem)."""
        raise NotImplementedError

    def pause(self) -> None:
        """CPU pause inside a spin loop."""
        raise NotImplementedError

    def work(self, units: int) -> None:
        """Critical-/non-critical-section local work (units of ~1 RNG step)."""
        raise NotImplementedError

    def wait_while(self, cell: Cell, pred: Callable[[int], bool]) -> None:
        """Spin-wait while ``pred(value_of(cell))`` holds.

        Semantically identical to ``while pred(load(cell)): pause()`` but lets
        backends model it MESI-accurately (re-reads of a Shared line are free
        until the line is invalidated by the eventual writer).
        """
        raise NotImplementedError

    # ---- futex-style blocking -------------------------------------------
    def futex_wait(self, cell: Cell, expect: int) -> None:
        """Block while ``cell`` holds ``expect`` (may wake spuriously)."""
        raise NotImplementedError

    def futex_wake(self, cell: Cell, n: int = 1 << 30) -> None:
        raise NotImplementedError

    # ---- identity --------------------------------------------------------
    def thread_id(self) -> int:
        raise NotImplementedError

    def cpu_of(self, tid: Optional[int] = None) -> int:
        """Logical CPU the thread runs on (stable per thread)."""
        raise NotImplementedError

    def socket_of(self, tid: Optional[int] = None) -> int:
        raise NotImplementedError

    @property
    def num_cpus(self) -> int:
        raise NotImplementedError

    @property
    def num_sockets(self) -> int:
        raise NotImplementedError

    def run_threads(self, fns: List[Callable[[], None]]) -> None:
        """Run one thread per callable to completion."""
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Live backend
# ---------------------------------------------------------------------------


class LiveMem(Mem):
    """Real-thread backend.

    Atomicity is provided by striped micro-locks, one per cache line; this is
    also a crude contention model (two threads RMWing the same line serialize
    on the same stripe, threads touching different lines do not).
    """

    def __init__(self, num_cpus: int = 72, num_sockets: int = 2,
                 collect_stats: bool = False):
        super().__init__()
        self._vals: List[int] = []
        self._line_locks: List[threading.Lock] = []
        self._alloc_lock = threading.Lock()
        self._tl = threading.local()
        self._next_tid = 0
        self._tid_lock = threading.Lock()
        self._num_cpus = num_cpus
        self._num_sockets = num_sockets
        self._collect = collect_stats
        self._futex_cond: Dict[int, threading.Condition] = {}
        self._futex_lock = threading.Lock()

    # ---- allocation ------------------------------------------------------
    def alloc_array(self, name: str, n: int, init: int = 0,
                    entries_per_line: int = 8) -> AtomicArray:
        with self._alloc_lock:
            base = len(self._vals)
            line0 = len(self._line_locks)
            nlines = (n + entries_per_line - 1) // entries_per_line
            self._vals.extend([init] * n)
            self._line_locks.extend(threading.Lock() for _ in range(nlines))
            self._nwords += n
            self._nlines += nlines
        return AtomicArray(self, base, n, line0, entries_per_line, name)

    def _lock_of(self, cell: Cell) -> threading.Lock:
        return self._line_locks[cell.line]

    # ---- atomic ops ------------------------------------------------------
    def load(self, cell: Cell) -> int:
        if self._collect:
            self.stats.loads += 1
        return self._vals[cell.index]  # aligned word read: atomic under GIL

    def store(self, cell: Cell, value: int) -> None:
        if self._collect:
            self.stats.stores += 1
        self._vals[cell.index] = value

    def cas(self, cell: Cell, expect: int, new: int) -> bool:
        with self._lock_of(cell):
            if self._collect:
                self.stats.rmws += 1
                pl = self.stats.per_line_rmws
                pl[cell.line] = pl.get(cell.line, 0) + 1
            if self._vals[cell.index] == expect:
                self._vals[cell.index] = new
                return True
            return False

    def fetch_add(self, cell: Cell, delta: int) -> int:
        with self._lock_of(cell):
            if self._collect:
                self.stats.rmws += 1
                pl = self.stats.per_line_rmws
                pl[cell.line] = pl.get(cell.line, 0) + 1
            old = self._vals[cell.index]
            self._vals[cell.index] = old + delta
            return old

    def fetch_or(self, cell: Cell, bits: int) -> int:
        with self._lock_of(cell):
            if self._collect:
                self.stats.rmws += 1
            old = self._vals[cell.index]
            self._vals[cell.index] = old | bits
            return old

    def fetch_and(self, cell: Cell, bits: int) -> int:
        with self._lock_of(cell):
            if self._collect:
                self.stats.rmws += 1
            old = self._vals[cell.index]
            self._vals[cell.index] = old & bits
            return old

    def swap(self, cell: Cell, new: int) -> int:
        with self._lock_of(cell):
            if self._collect:
                self.stats.rmws += 1
            old = self._vals[cell.index]
            self._vals[cell.index] = new
            return old

    def scan_array(self, arr: AtomicArray, match: int) -> List[int]:
        if self._collect:
            self.stats.scans += 1
        vals = self._vals
        base = arr.base
        return [i for i in range(arr.n) if vals[base + i] == match]

    # ---- time / scheduling ----------------------------------------------
    def now(self) -> int:
        return time.monotonic_ns()

    def pause(self) -> None:
        # Yield the GIL so spin loops do not starve the lock holder on a
        # single-core host.
        time.sleep(0)

    def work(self, units: int) -> None:
        x = 0x9E3779B97F4A7C15
        for _ in range(units):
            x ^= (x << 13) & 0xFFFFFFFFFFFFFFFF
            x ^= x >> 7
            x ^= (x << 17) & 0xFFFFFFFFFFFFFFFF

    def wait_while(self, cell: Cell, pred: Callable[[int], bool]) -> None:
        n = 0
        while pred(self._vals[cell.index]):
            n += 1
            time.sleep(0.0 if n < 64 else 0.0002)

    # ---- futex -----------------------------------------------------------
    def _cond_for(self, cell: Cell) -> threading.Condition:
        with self._futex_lock:
            c = self._futex_cond.get(cell.index)
            if c is None:
                c = threading.Condition()
                self._futex_cond[cell.index] = c
            return c

    def futex_wait(self, cell: Cell, expect: int) -> None:
        c = self._cond_for(cell)
        with c:
            if self._vals[cell.index] != expect:
                return
            if self._collect:
                self.stats.parks += 1
            c.wait(timeout=0.05)  # spurious wakeups are permitted

    def futex_wake(self, cell: Cell, n: int = 1 << 30) -> None:
        c = self._cond_for(cell)
        with c:
            if self._collect:
                self.stats.wakes += 1
            if n == 1:
                c.notify(1)
            else:
                c.notify_all()

    # ---- identity --------------------------------------------------------
    def register_thread(self, tid: int) -> None:
        self._tl.tid = tid
        with self._tid_lock:
            self._next_tid = max(self._next_tid, tid + 1)

    def thread_id(self) -> int:
        tid = getattr(self._tl, "tid", None)
        if tid is None:
            with self._tid_lock:
                tid = self._next_tid
                self._next_tid += 1
            self._tl.tid = tid
        return tid

    def cpu_of(self, tid: Optional[int] = None) -> int:
        t = self.thread_id() if tid is None else tid
        return t % self._num_cpus

    def socket_of(self, tid: Optional[int] = None) -> int:
        return self.cpu_of(tid) % self._num_sockets

    @property
    def num_cpus(self) -> int:
        return self._num_cpus

    @property
    def num_sockets(self) -> int:
        return self._num_sockets

    def run_threads(self, fns: List[Callable[[], None]]) -> None:
        errs: List[BaseException] = []

        def wrap(tid: int, fn: Callable[[], None]) -> None:
            self.register_thread(tid)
            try:
                fn()
            except BaseException as e:  # pragma: no cover - surfaced below
                errs.append(e)

        ts = [threading.Thread(target=wrap, args=(i, fn), daemon=True)
              for i, fn in enumerate(fns)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if errs:
            raise errs[0]
