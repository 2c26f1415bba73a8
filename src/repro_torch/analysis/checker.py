"""Model-checking race detector for the host lock protocols.

Every lock algorithm in this repo runs against the abstract
:class:`repro_torch.core.atomics.Mem` interface, which makes systematic
concurrency testing cheap: :class:`CheckMem` is a third backend (next to
``LiveMem`` and ``SimMem``) that runs real threads **turn-based** — exactly
one thread executes at a time, and every atomic operation is a preemption
point where a scheduler decides who runs next.  :class:`Explorer` drives a
bounded DFS over those decisions with sleep-set partial-order pruning
(Godefroid), so 2-4 thread scenarios over ``bravo.py`` / ``rwlocks.py`` /
the registry and KV-pool protocol models are covered exhaustively up to the
schedule budget.

Every committed operation is recorded as an :class:`Event` carrying a
vector clock (join of the acting thread's clock with the cell's last-writer
clock), so a reported violation comes with happens-before metadata, and the
scenario's invariant callback (``on_step``) runs after **every** event.
Violations are minimized to the shortest decision prefix that still
reproduces, and :meth:`Explorer.replay` re-executes that prefix
deterministically.

Determinism contract: scenario code must not consult wall-clock time or
randomness — ``CheckMem.now()`` returns the global step counter, and
scenarios pin BRAVO lock ids (see ``scenarios.py``) so hash slots are
stable across runs.  The interleaving model is sequential consistency
(every op is globally ordered), which is *stronger* than the TSO model the
paper assumes; races found here are real under TSO too, while TSO
store-buffer reorderings are out of scope (the algorithms fence at the one
point where it matters, Dice & Kogan §3).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..core.atomics import AtomicArray, Cell, Mem

__all__ = [
    "CheckMem",
    "CheckerError",
    "Event",
    "Explorer",
    "ExploreResult",
    "InvariantViolation",
    "Violation",
    "format_trace",
]

#: op kinds that write (for the independence relation used by sleep sets)
_WRITES = frozenset({"store", "cas", "fa", "fo", "fand", "swap", "wake"})

#: an op is ``(kind, word_index, span)``; span > 1 only for scans
Op = Tuple[str, int, int]


class CheckerError(RuntimeError):
    """The checker itself is broken (non-deterministic scenario, leaked
    thread) — distinct from a protocol violation."""


class InvariantViolation(Exception):
    """Raised by a scenario's invariant callback when a declared protocol
    invariant does not hold at the current event."""

    def __init__(self, invariant: str, message: str):
        super().__init__(f"{invariant}: {message}")
        self.invariant = invariant
        self.message = message


class _Abort(Exception):
    """Internal: unwind all scenario threads of the current run."""


@dataclass
class Event:
    """One committed atomic operation."""

    step: int
    tid: int
    kind: str
    index: int
    name: str
    value: int
    vc: Tuple[int, ...]

    def __str__(self) -> str:
        where = self.name or (f"[{self.index}]" if self.index >= 0 else "-")
        return (f"#{self.step:<4d} T{self.tid} {self.kind:<5s} {where}"
                f" = {self.value}")


@dataclass
class Violation:
    """A reproducible invariant violation: the DFS decision prefix that
    triggers it plus the full event trace of the violating run."""

    invariant: str
    message: str
    scenario: str
    schedule: List[int]
    events: List[Event]

    def __str__(self) -> str:
        return (f"[{self.scenario}] {self.invariant}: {self.message} "
                f"(schedule={self.schedule}, {len(self.events)} events)")


def format_trace(v: Violation, tail: int = 40) -> str:
    """Human-readable minimal schedule trace for a violation."""
    lines = [str(v), f"last {min(tail, len(v.events))} events:"]
    lines += [f"  {e}" for e in v.events[-tail:]]
    return "\n".join(lines)


def _conflicts(a: Op, b: Op) -> bool:
    """Dependence relation: ops commute unless they touch overlapping words
    and at least one writes.  Thread starts order with everything."""
    ka, ia, sa = a
    kb, ib, sb = b
    if ka == "begin" or kb == "begin":
        return True
    if ia + sa <= ib or ib + sb <= ia:        # disjoint word spans
        return False
    return ka in _WRITES or kb in _WRITES


# ---------------------------------------------------------------------------
# Schedule controllers (the pluggable "who runs next" policy)
# ---------------------------------------------------------------------------


class _Ctl:
    """Default controller: run-to-completion (current thread first, then
    lowest tid).  Deterministic; used for plain runs and as the
    continuation policy past a replay prefix."""

    def choose(self, pending: Dict[int, Op], current: Optional[int]) -> int:
        if current is not None and current in pending:
            return current
        return min(pending)

    def on_executed(self, tid: int, op: Op) -> None:  # pragma: no cover
        pass


class _ReplayCtl(_Ctl):
    """Follow a recorded decision prefix at multi-candidate points, then
    fall back to the default policy."""

    def __init__(self, prefix: List[int]):
        self.prefix = prefix
        self.depth = 0

    def choose(self, pending: Dict[int, Op], current: Optional[int]) -> int:
        if len(pending) == 1:
            return next(iter(pending))
        if self.depth < len(self.prefix):
            t = self.prefix[self.depth]
            self.depth += 1
            if t not in pending:
                raise CheckerError(
                    f"replay diverged at depth {self.depth - 1}: decision "
                    f"T{t} not among ready threads {sorted(pending)} — "
                    f"scenario is non-deterministic")
            return t
        return super().choose(pending, current)


# ---------------------------------------------------------------------------
# CheckMem
# ---------------------------------------------------------------------------


class CheckMem(Mem):
    """Turn-based instrumented backend.

    Exactly one scenario thread holds the turn.  Each atomic op (a) parks
    the thread at a preemption point, (b) asks the controller which ready
    thread runs next, (c) executes on the flat value array, (d) commits an
    :class:`Event` (vector clocks, watcher wakeups, invariant callback).
    ``wait_while``/``futex_wait`` block the thread; writers to the watched
    word make it ready again, but *when* it actually resumes is a scheduler
    decision like any other.
    """

    def __init__(self, ctl: Optional[_Ctl] = None, max_steps: int = 20000,
                 num_cpus: int = 8):
        super().__init__()
        self.ctl = ctl or _Ctl()
        self.max_steps = max_steps
        self._num_cpus = num_cpus
        self._vals: List[int] = []
        self._names: List[str] = []
        self._cv = threading.Condition()
        self._threads: Dict[int, "_TState"] = {}
        self._ident2tid: Dict[int, int] = {}
        self._turn: Optional[int] = None
        self._started = False
        self._step = 0
        self.events: List[Event] = []
        self._cell_vc: Dict[int, Tuple[int, ...]] = {}
        self.on_step: Optional[Callable[[Event], None]] = None
        self.violation: Optional[Violation] = None
        self.abort_reason: Optional[str] = None
        self.error: Optional[CheckerError] = None
        self.scenario_name = ""

    # ---- allocation (pre-run, single-threaded) ---------------------------
    def alloc_array(self, name: str, n: int, init: int = 0,
                    entries_per_line: int = 8) -> AtomicArray:
        base = len(self._vals)
        line0 = self._nlines
        self._vals.extend([init] * n)
        self._names.extend(f"{name}[{i}]" if n > 1 else name
                           for i in range(n))
        self._nlines += (n + entries_per_line - 1) // entries_per_line
        self._nwords += n
        return AtomicArray(self, base, n, line0, entries_per_line, name)

    # ---- host-side inspection (no scheduling) ----------------------------
    def peek(self, cell: Cell) -> int:
        """Read a cell from invariant-checker context without creating a
        schedule point or an event."""
        return self._vals[cell.index]

    def peek_index(self, index: int) -> int:
        return self._vals[index]

    # ---- scheduling core -------------------------------------------------
    def _tid(self) -> int:
        return self._ident2tid[threading.get_ident()]

    def _check_abort(self) -> None:
        if self.abort_reason is not None:
            raise _Abort()

    def _abort_run(self, reason: str) -> None:
        """Tear down the current run (all threads unwind via _Abort)."""
        self.abort_reason = reason
        self._cv.notify_all()

    def _record_violation(self, invariant: str, message: str) -> None:
        if self.violation is None:
            self.violation = Violation(invariant, message,
                                       self.scenario_name, [],
                                       list(self.events))
        self._abort_run(f"violation:{invariant}")

    def _grant(self, tid: int) -> None:
        ts = self._threads[tid]
        self._turn = tid
        ts.granted = True
        self._cv.notify_all()

    def _schedule_next(self, current: Optional[int]) -> None:
        """Pick the next thread to run.  ``current`` is the calling thread
        if it is itself ready (parked at an op), else None."""
        pending = {t: ts.pending for t, ts in self._threads.items()
                   if ts.status == "ready"}
        if not pending:
            blocked = [t for t, ts in self._threads.items()
                       if ts.status == "blocked"]
            if blocked:
                desc = "; ".join(
                    f"T{t} on {self._names[self._threads[t].block[1]]}"
                    for t in blocked)
                self._record_violation(
                    "deadlock", f"no runnable thread; blocked: {desc}")
                raise _Abort()
            self._turn = None               # all done: wake the driver
            self._cv.notify_all()
            return
        try:
            choice = self.ctl.choose(pending, current)
        except _Abort:
            self._abort_run("prune")
            raise
        except CheckerError as e:
            self.error = e
            self._abort_run("checker-error")
            raise _Abort() from None
        self._grant(choice)

    def _sched(self, kind: str, index: int, span: int = 1) -> None:
        """Park the calling thread at a preemption point with a pending op;
        return once the controller grants it the turn.  Caller holds _cv."""
        tid = self._tid()
        ts = self._threads[tid]
        self._check_abort()
        ts.pending = (kind, index, span)
        if ts.granted:                       # pre-granted by a wakeup
            ts.granted = False
            ts.status = "running"
            return
        ts.status = "ready"
        if not self._started:                # driver makes the 1st decision
            self._cv.notify_all()
        else:
            self._schedule_next(tid)
        while not (self._turn == tid and ts.granted):
            self._cv.wait()
            self._check_abort()
        ts.granted = False
        ts.status = "running"

    def _commit(self, kind: str, index: int, value: int,
                span: int = 1) -> None:
        """Record the executed op: step counter, vector clock, watcher
        wakeups, sleep-set notification, invariant callback."""
        tid = self._tid()
        ts = self._threads[tid]
        self._step += 1
        if self._step > self.max_steps:
            self._abort_run("step-budget")
            raise _Abort()
        ts.vc[tid] += 1
        if index >= 0:
            for w in range(index, index + span):
                cvc = self._cell_vc.get(w)
                if cvc:
                    ts.vc = [max(a, b) for a, b in zip(ts.vc, cvc)]
            if kind in _WRITES:
                self._cell_vc[index] = tuple(ts.vc)
        ev = Event(self._step, tid, kind, index,
                   self._names[index] if index >= 0 else "", value,
                   tuple(ts.vc))
        self.events.append(ev)
        if kind in _WRITES:
            self._wake_watchers(index)
        self.ctl.on_executed(tid, (kind, index, span))
        if self.on_step is not None:
            try:
                self.on_step(ev)
            except InvariantViolation as v:
                self._record_violation(v.invariant, v.message)
                raise _Abort() from None

    def _wake_watchers(self, index: int) -> None:
        """A write to ``index`` re-readies spin waiters whose predicate no
        longer holds, and all futex waiters on the word (spurious wakes are
        allowed by the futex contract)."""
        v = self._vals[index]
        for t, ts in self._threads.items():
            if ts.status != "blocked" or ts.block[1] != index:
                continue
            mode, _, arg = ts.block
            if mode == "spin" and arg(v):
                continue                     # still spinning
            ts.status = "ready"
            ts.block = None
            ts.pending = ("wakeup", index, 1)

    def _block(self, mode: str, index: int, arg) -> None:
        """Park the calling thread as blocked; return once re-readied AND
        granted.  The grant is left unconsumed for spin waiters (it covers
        the re-load they are about to issue) and consumed for futex waiters
        (which simply return).  Caller holds _cv."""
        tid = self._tid()
        ts = self._threads[tid]
        ts.status = "blocked"
        ts.block = (mode, index, arg)
        self.stats.parks += 1
        self._schedule_next(None)
        while not (self._turn == tid and ts.granted):
            self._cv.wait()
            self._check_abort()
        ts.status = "running"

    # ---- atomic ops ------------------------------------------------------
    def load(self, cell: Cell) -> int:
        with self._cv:
            self._sched("load", cell.index)
            v = self._vals[cell.index]
            self.stats.loads += 1
            self._commit("load", cell.index, v)
            return v

    def store(self, cell: Cell, value: int) -> None:
        with self._cv:
            self._sched("store", cell.index)
            self._vals[cell.index] = value
            self.stats.stores += 1
            self._commit("store", cell.index, value)

    def cas(self, cell: Cell, expect: int, new: int) -> bool:
        with self._cv:
            self._sched("cas", cell.index)
            ok = self._vals[cell.index] == expect
            if ok:
                self._vals[cell.index] = new
            self.stats.rmws += 1
            self._commit("cas", cell.index,
                         new if ok else self._vals[cell.index])
            return ok

    def _rmw(self, kind: str, cell: Cell, f) -> int:
        with self._cv:
            self._sched(kind, cell.index)
            old = self._vals[cell.index]
            self._vals[cell.index] = f(old)
            self.stats.rmws += 1
            self._commit(kind, cell.index, self._vals[cell.index])
            return old

    def fetch_add(self, cell: Cell, delta: int) -> int:
        return self._rmw("fa", cell, lambda v: v + delta)

    def fetch_or(self, cell: Cell, bits: int) -> int:
        return self._rmw("fo", cell, lambda v: v | bits)

    def fetch_and(self, cell: Cell, bits: int) -> int:
        return self._rmw("fand", cell, lambda v: v & bits)

    def swap(self, cell: Cell, new: int) -> int:
        return self._rmw("swap", cell, lambda v: new)

    def scan_array(self, arr: AtomicArray, match: int) -> List[int]:
        with self._cv:
            self._sched("scan", arr.base, arr.n)
            out = [i for i in range(arr.n)
                   if self._vals[arr.base + i] == match]
            self.stats.scans += 1
            self._commit("scan", arr.base, len(out), arr.n)
            return out

    def fence(self) -> None:
        """No-op: the interleaving model is sequentially consistent, which
        subsumes every fence the algorithms issue."""

    # ---- waiting ---------------------------------------------------------
    def wait_while(self, cell: Cell, pred: Callable[[int], bool]) -> None:
        while True:
            with self._cv:
                self._sched("load", cell.index)
                v = self._vals[cell.index]
                self.stats.loads += 1
                self._commit("load", cell.index, v)
                if not pred(v):
                    return
                self._block("spin", cell.index, pred)
                # woken with the grant unconsumed: the next loop
                # iteration's _sched consumes it and re-loads

    def futex_wait(self, cell: Cell, expect: int) -> None:
        with self._cv:
            self._sched("load", cell.index)
            v = self._vals[cell.index]
            self.stats.loads += 1
            self._commit("load", cell.index, v)
            if v != expect:
                return
            self._block("futex", cell.index, expect)
            ts = self._threads[self._tid()]
            ts.granted = False               # grant consumed by returning

    def futex_wake(self, cell: Cell, n: int = 1 << 30) -> None:
        with self._cv:
            self._sched("wake", cell.index)
            self.stats.wakes += 1
            self._commit("wake", cell.index, n)
            # _wake_watchers (from _commit) already readied the waiters

    # ---- time / identity -------------------------------------------------
    def now(self) -> int:
        return self._step

    def pause(self) -> None:
        pass

    def work(self, units: int) -> None:
        pass

    def thread_id(self) -> int:
        return self._tid()

    def cpu_of(self, tid: Optional[int] = None) -> int:
        return tid if tid is not None else self._tid()

    def socket_of(self, tid: Optional[int] = None) -> int:
        return 0

    @property
    def num_cpus(self) -> int:
        return self._num_cpus

    @property
    def num_sockets(self) -> int:
        return 1

    # ---- driver ----------------------------------------------------------
    def run_threads(self, fns: List[Callable[[], None]]) -> None:
        self._threads = {i: _TState(i, len(fns)) for i in range(len(fns))}
        workers = [threading.Thread(target=self._wrap, args=(i, fn),
                                    daemon=True)
                   for i, fn in enumerate(fns)]
        for w in workers:
            w.start()
        with self._cv:
            while not all(ts.status == "ready"
                          for ts in self._threads.values()):
                self._cv.wait()
            self._started = True
            try:
                self._schedule_next(None)    # first decision
            except _Abort:
                pass
            while (self.abort_reason is None and
                   not all(ts.status == "done"
                           for ts in self._threads.values())):
                self._cv.wait()
        for w in workers:
            w.join(timeout=5.0)
            if w.is_alive():                 # pragma: no cover
                raise CheckerError("scenario thread leaked past its run")

    def _wrap(self, tid: int, fn: Callable[[], None]) -> None:
        with self._cv:
            self._ident2tid[threading.get_ident()] = tid
        try:
            with self._cv:
                self._sched("begin", -1)     # parks until first grant
                self._commit("begin", -1, 0)
            fn()
        except _Abort:
            pass
        except InvariantViolation as v:
            with self._cv:
                self._record_violation(v.invariant, v.message)
        except BaseException as e:           # noqa: BLE001 — report, not raise
            with self._cv:
                self._record_violation(
                    "uncaught-exception",
                    f"T{tid} raised {type(e).__name__}: {e}")
        finally:
            with self._cv:
                ts = self._threads[tid]
                ts.status = "done"
                ts.granted = False
                if self.abort_reason is None:
                    try:
                        self._schedule_next(None)
                    except _Abort:
                        pass
                else:
                    self._cv.notify_all()


class _TState:
    __slots__ = ("tid", "status", "pending", "granted", "block", "vc")

    def __init__(self, tid: int, n: int):
        self.tid = tid
        self.status = "new"        # new | ready | running | blocked | done
        self.pending: Op = ("begin", -1, 1)
        self.granted = False
        self.block = None          # (mode, index, arg) while blocked
        self.vc = [0] * n


# ---------------------------------------------------------------------------
# DFS exploration with sleep sets
# ---------------------------------------------------------------------------


@dataclass
class _Node:
    """One multi-candidate choice point on the current DFS path."""

    order: List[int]               # candidate order at this point
    pending: Dict[int, Op]         # each candidate's pending op
    sleep: Dict[int, Op]           # sleep set ON ENTRY to this node
    tried: List[int] = field(default_factory=list)


@dataclass
class ExploreResult:
    violation: Optional[Violation]
    schedules: int
    complete: bool                 # DFS exhausted below max_schedules
    pruned: int                    # runs cut by sleep-set pruning
    budget_hits: int               # runs cut by the per-run step budget


class _DfsCtl(_Ctl):
    """Per-run controller for one DFS descent: replays the stack's current
    decisions, then extends the tree; maintains the live sleep set."""

    def __init__(self, ex: "Explorer"):
        self.ex = ex
        self.depth = 0
        self.sleep: Dict[int, Op] = {}
        self.prune = False

    def choose(self, pending: Dict[int, Op], current: Optional[int]) -> int:
        ex = self.ex
        if len(pending) == 1:
            t = next(iter(pending))
            if t in self.sleep:     # sole successor already covered
                self.prune = True
                raise _Abort()
            return t
        if self.depth < len(ex.stack):      # replay segment
            node = ex.stack[self.depth]
            t = node.tried[-1]
            if t not in pending or node.pending != pending:
                raise CheckerError(
                    f"DFS replay diverged at depth {self.depth} — "
                    f"scenario is non-deterministic")
            entry = dict(node.sleep)
            for u in node.tried[:-1]:       # siblings already explored
                entry[u] = node.pending[u]
            self.sleep = entry
        else:                               # fresh territory: first child
            order = ex.order(pending, current)
            avail = [u for u in order if u not in self.sleep]
            if not avail:
                self.prune = True
                raise _Abort()
            t = avail[0]
            ex.stack.append(_Node(order, dict(pending), dict(self.sleep),
                                  [t]))
        self.depth += 1
        return t

    def on_executed(self, tid: int, op: Op) -> None:
        if self.sleep:
            self.sleep = {u: uop for u, uop in self.sleep.items()
                          if u != tid and not _conflicts(uop, op)}


class Explorer:
    """Bounded systematic exploration of one scenario.

    ``build(mem)`` must return a scenario *instance* exposing ``threads``
    (list of zero-arg callables), an optional ``check(event)`` invariant
    callback, and an optional ``at_end()`` whole-run check.  The same
    build-fn contract is shared with plain SimMem smoke runs.
    """

    def __init__(self, build: Callable[[CheckMem], object],
                 name: str = "scenario", max_schedules: int = 4000,
                 max_steps: int = 20000, seed: int = 0):
        self.build = build
        self.name = name
        self.max_schedules = max_schedules
        self.max_steps = max_steps
        self.seed = seed
        self.stack: List[_Node] = []
        self._last_prune = False
        self._shuffle = _lcg(seed) if seed else None

    def order(self, pending: Dict[int, Op],
              current: Optional[int]) -> List[int]:
        """Candidate order at a fresh node: run-to-completion first, then
        ascending tid; an optional seeded LCG shuffles the tail so
        different seeds walk the tree in different orders."""
        rest = sorted(t for t in pending if t != current)
        if self._shuffle is not None:
            for i in range(len(rest) - 1, 0, -1):
                j = next(self._shuffle) % (i + 1)
                rest[i], rest[j] = rest[j], rest[i]
        return ([current] + rest) if current in pending else rest

    # ---- single runs -----------------------------------------------------
    def _run_dfs(self) -> CheckMem:
        ctl = _DfsCtl(self)
        mem = CheckMem(ctl, max_steps=self.max_steps)
        mem.scenario_name = self.name
        inst = self.build(mem)
        mem.on_step = getattr(inst, "check", None)
        mem.run_threads(inst.threads)
        if mem.error is not None:
            raise mem.error
        self._last_prune = ctl.prune
        if mem.violation is None and mem.abort_reason is None:
            at_end = getattr(inst, "at_end", None)
            if at_end is not None:
                try:
                    at_end()
                except InvariantViolation as v:
                    with mem._cv:
                        mem._record_violation(v.invariant, v.message)
        if mem.violation is not None:
            mem.violation.schedule = [n.tried[-1] for n in self.stack]
        return mem

    def replay(self, schedule: List[int]) -> Optional[Violation]:
        """Deterministically re-execute a decision prefix (default policy
        past its end); returns the violation it produces, if any."""
        mem = CheckMem(_ReplayCtl(list(schedule)), max_steps=self.max_steps)
        mem.scenario_name = self.name
        inst = self.build(mem)
        mem.on_step = getattr(inst, "check", None)
        mem.run_threads(inst.threads)
        if mem.error is not None:
            raise mem.error
        if mem.violation is None and mem.abort_reason is None:
            at_end = getattr(inst, "at_end", None)
            if at_end is not None:
                try:
                    at_end()
                except InvariantViolation as v:
                    with mem._cv:
                        mem._record_violation(v.invariant, v.message)
        if mem.violation is not None:
            mem.violation.schedule = list(schedule)
        return mem.violation

    def minimize(self, v: Violation) -> Violation:
        """Shortest decision prefix (default continuation) that still
        reproduces the same invariant violation."""
        for i in range(len(v.schedule) + 1):
            got = self.replay(v.schedule[:i])
            if got is not None and got.invariant == v.invariant:
                return got
        return v                              # pragma: no cover

    # ---- the DFS loop ----------------------------------------------------
    def explore(self) -> ExploreResult:
        schedules = pruned = budget_hits = 0
        self.stack = []
        while schedules < self.max_schedules:
            schedules += 1
            mem = self._run_dfs()
            if mem.violation is not None:
                v = self.minimize(mem.violation)
                return ExploreResult(v, schedules, False, pruned,
                                     budget_hits)
            if self._last_prune:
                pruned += 1
            if mem.abort_reason == "step-budget":
                budget_hits += 1
            if not self._backtrack():
                return ExploreResult(None, schedules, True, pruned,
                                     budget_hits)
        return ExploreResult(None, schedules, False, pruned, budget_hits)

    def _backtrack(self) -> bool:
        """Advance the deepest node with an untried, non-sleeping sibling;
        pop exhausted nodes.  False when the tree is exhausted."""
        while self.stack:
            node = self.stack[-1]
            nxt = next((t for t in node.order
                        if t not in node.tried and t not in node.sleep),
                       None)
            if nxt is not None:
                node.tried.append(nxt)
                return True
            self.stack.pop()
        return False


def _lcg(seed: int):
    """Tiny deterministic PRNG (no `random` import, no global state)."""
    x = seed & 0xFFFFFFFF or 1
    while True:
        x = (x * 1664525 + 1013904223) & 0xFFFFFFFF
        yield x >> 16
