"""Checked scenarios: thread programs + declared invariants.

Each scenario is a small (2-3 thread) program over the real lock code
(``core/bravo.py`` + ``core/rwlocks.py``) or over a host model of a device
protocol (the registry's per-lock drain gates, the KV pool's owner-vector
refcount encoding), plus the invariants the protocol claims.  The
:class:`~repro_torch.analysis.checker.Explorer` runs the program under every
schedule (up to budget) and calls ``check`` after every atomic event.

Scenario thread programs are backend-agnostic: ``build`` accepts any
``Mem`` and the ghost-state reads go through :func:`peek` (the flat value
array every backend exposes), so the same program also runs under
``SimMem`` as a smoke test.  The per-event ``check`` hook, however, only
fires under ``CheckMem`` — systematic exploration is the point.

Determinism: BRAVO assigns ``lock_id`` from a global counter, and the
visible-readers slot is ``mix_hash(lock_id, tid)``, so scenarios **pin**
the lock value via :func:`pin_lock_value`, which also guarantees the
scenario's threads hash to pairwise-distinct slots (a collision would make
the release-clears-slot invariant ambiguous).

The ``MUTATIONS`` re-introduce historical (or designed-against) bugs
behind flags so the mutation tests can assert the explorer still catches
them:

* ``release-token-mismatch`` — the bug: ``release_read`` routes a
  fast-path token to the underlying lock, leaving the table slot published
  forever and underflowing the central reader counter.
* ``drain-off-by-one`` — revocation skips the first matching slot, so a
  writer can enter its critical section while a fast-path reader is live.
* ``cow-write-through`` — a writer mutates a page whose owner word says
  shared (refcount >= 1) instead of copy-on-write diverging.
* ``park-wakeup-lost`` — the writer-parking hazard: the finishing
  writer drops the park-word bump + wake, so a writer parked on its drain
  gate sleeps forever (caught by the built-in deadlock invariant).
* ``cow-skips-scale`` — the quantized-store COW hazard: the
  copy-on-write divergence copies a page's int8 bytes but not its
  dequantization scale, so the private copy decodes with whatever scale
  the destination page last had (caught by the stale-scale ghost set).
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

from ..core.atomics import Cell, Mem
from ..core.bravo import BRAVO, adaptive_inhibit
from ..core.rwlocks import CentralCounterRWLock
from ..core.table import VisibleReadersTable, mix_hash
from .checker import InvariantViolation

__all__ = ["MUTATIONS", "SCENARIOS", "Scenario", "peek", "pin_lock_value"]


def peek(mem: Mem, cell: Cell) -> int:
    """Ghost-state read of a cell — no schedule point, no event.  Works on
    every backend (they all keep values in a flat ``_vals`` list)."""
    return mem._vals[cell.index]


def pin_lock_value(table: VisibleReadersTable, tids: List[int],
                   avoid: Optional[set] = None, start: int = 7) -> int:
    """Smallest lock value >= ``start`` whose slots for ``tids`` are
    pairwise distinct and disjoint from ``avoid`` (slot indices).
    Deterministic, so every DFS run sees identical slot geometry."""
    avoid = avoid or set()
    v = start
    while True:
        slots = [mix_hash(v, t) & (table.size - 1) for t in tids]
        if len(set(slots)) == len(slots) and not (set(slots) & avoid):
            return v
        v += 1


@dataclass
class Instance:
    """One built scenario run: thread bodies + invariant hooks."""

    threads: List[Callable[[], None]]
    check: Optional[Callable] = None     # per-event invariant (CheckMem)
    at_end: Optional[Callable[[], None]] = None


@dataclass
class Scenario:
    name: str
    n_threads: int
    build: Callable[[Mem, Optional[str]], Instance]
    max_schedules: int = 4000
    max_steps: int = 20000


# ---------------------------------------------------------------------------
# S1/S2 — BRAVO over the pthread-style lock (the real algorithm code)
# ---------------------------------------------------------------------------


class _ReleaseTokenBugBRAVO(BRAVO):
    """MUTATION release-token-mismatch (the bug): fast-path releases
    are mis-routed to the underlying lock, so the table slot stays
    published and the central counter underflows."""

    def release_read(self, tok) -> None:
        kind, x = tok
        self.u.release_read(None if kind == "fast" else x)


def _build_bravo(mem: Mem, mutation: Optional[str], reader_tids: List[int],
                 writer_tid: int, reader_iters: int) -> Instance:
    table = VisibleReadersTable(mem, size=64, name="VR")
    under = CentralCounterRWLock(mem)
    cls = (_ReleaseTokenBugBRAVO if mutation == "release-token-mismatch"
           else BRAVO)
    lock = cls(under, table, mem, collect_stats=False)
    lock.lock_id = pin_lock_value(table, reader_tids)   # determinism pin
    lid = lock.lock_id
    # start in the biased steady state (RBias armed) so the reader fast
    # path is reachable in the first iteration; host-side init, not an op
    mem._vals[lock.rbias.index] = 1
    slots = {t: table.slot_for(lid, t) for t in reader_tids}
    scratch = mem.alloc("scratch")
    all_tids = reader_tids + [writer_tid]
    g = SimpleNamespace(phase={t: "idle" for t in all_tids},
                        readers=0, writers=0)

    def reader(t):
        def go():
            for _ in range(reader_iters):
                g.phase[t] = "acquiring"
                tok = lock.acquire_read()
                g.readers += 1
                g.phase[t] = "cs"
                scratch.load()               # observable CS window
                g.readers -= 1
                g.phase[t] = "releasing"
                lock.release_read(tok)
                g.phase[t] = "idle"
        return go

    def writer():
        g.phase[writer_tid] = "acquiring"
        tok = lock.acquire_write()
        g.writers += 1
        g.phase[writer_tid] = "cs"
        scratch.load()                       # observable CS window
        g.writers -= 1
        g.phase[writer_tid] = "releasing"
        lock.release_write(tok)
        g.phase[writer_tid] = "idle"

    def check(ev):
        # (I1) writer exclusion after drain: a writer in its CS excludes
        # every reader (fast- and slow-path) and every other writer.
        if g.writers > 1:
            raise InvariantViolation(
                "writer-exclusion", f"{g.writers} writers in CS")
        if g.writers and g.readers:
            raise InvariantViolation(
                "writer-exclusion",
                f"{g.readers} reader(s) in CS alongside a writer")
        # (I2) central reader counter never underflows (a release without
        # a matching slow-path acquire would go negative).
        s = peek(mem, under.state)
        if s < 0:
            raise InvariantViolation(
                "reader-count-underflow", f"pthread state = {s}")
        # (I3) reader-visible-or-counted: every reader inside its CS is
        # either published in the table or counted by the underlying lock.
        in_cs = [t for t in reader_tids if g.phase[t] == "cs"]
        visible = sum(1 for t in in_cs if peek(mem, slots[t]) == lid)
        if visible + (s >> 12) < len(in_cs):
            raise InvariantViolation(
                "reader-visible-or-counted",
                f"{len(in_cs)} readers in CS but only {visible} visible "
                f"+ {s >> 12} counted")
        # (I4) release clears the slot: an idle thread is never visible.
        for t in reader_tids:
            if g.phase[t] == "idle" and peek(mem, slots[t]) == lid:
                raise InvariantViolation(
                    "release-clears-slot",
                    f"T{t} idle but slot {slots[t].name} still "
                    f"publishes lock {lid}")
        # (I5) re-arming respects the inhibit window (rearm at a virtual
        # time earlier than InhibitUntil would void the paper's ~1/(N+1)
        # writer slow-down bound).
        if (ev.kind == "store" and ev.index == lock.rbias.index
                and ev.value == 1):
            until = peek(mem, lock.inhibit_until)
            if ev.step < until:
                raise InvariantViolation(
                    "rearm-respects-inhibit",
                    f"rbias armed at t={ev.step} < InhibitUntil={until}")

    def at_end():
        for i in range(table.size):
            if mem._vals[table.arr.base + i] == lid:
                raise InvariantViolation(
                    "table-drained",
                    f"slot {i} still publishes lock {lid} after all "
                    f"threads finished")
        s = peek(mem, under.state)
        if s != 0:
            raise InvariantViolation(
                "lock-quiescent", f"pthread state = {s} at exit")

    threads = [reader(t) for t in reader_tids] + [writer]
    return Instance(threads, check, at_end)


def build_bravo_rw(mem: Mem, mutation: Optional[str] = None) -> Instance:
    """1 fast/slow reader vs 1 revoking writer."""
    return _build_bravo(mem, mutation, reader_tids=[0], writer_tid=1,
                        reader_iters=1)


def build_bravo_2r1w(mem: Mem, mutation: Optional[str] = None) -> Instance:
    """2 readers vs 1 revoking writer (one iteration each)."""
    return _build_bravo(mem, mutation, reader_tids=[0, 1], writer_tid=2,
                        reader_iters=1)


# ---------------------------------------------------------------------------
# S3 — host model of the registry's per-lock drain gates
# ---------------------------------------------------------------------------


class RegistryModel:
    """Host model of :class:`repro_torch.core.registry.BravoRegistry`'s revoke /
    rearm protocol: per-lock rbias lanes, per-lock drain gates, one shared
    visible-readers table.  The device kernels batch these ops; the
    protocol (and its bugs) live in the ordering modeled here."""

    def __init__(self, mem: Mem, n_locks: int = 2, table_size: int = 64,
                 drain_bug: bool = False):
        self.mem = mem
        self.table = VisibleReadersTable(mem, size=table_size, name="VR")
        self.rbias = mem.alloc_array("reg.rbias", n_locks, init=1)
        self.gate = mem.alloc_array("reg.gate", n_locks)
        self.inhibit = mem.alloc_array("reg.inhibit", n_locks)
        self.drain_bug = drain_bug
        self._ewma = [0] * n_locks
        # pin lock values: distinct slots per (lock, tid) pair and across
        # locks, so ghost slot checks are unambiguous
        self.lock_vals: List[int] = []
        taken: set = set()
        for _ in range(n_locks):
            v = pin_lock_value(self.table, [0, 1, 2], avoid=taken,
                               start=(self.lock_vals[-1] + 1
                                      if self.lock_vals else 7))
            self.lock_vals.append(v)
            taken |= {mix_hash(v, t) & (table_size - 1) for t in (0, 1, 2)}

    # -- reader fast path (same shape as BRAVO.acquire_read) --------------
    def try_acquire(self, l: int) -> Optional[Cell]:
        if self.rbias.cell(l).load() == 0:
            return None
        slot = self.table.slot_for(self.lock_vals[l], self.mem.thread_id())
        if not slot.cas(0, self.lock_vals[l]):
            return None
        self.mem.fence()
        if self.rbias.cell(l).load():
            return slot
        slot.store(0)                        # lost to a revoking writer
        return None

    def release(self, slot: Cell) -> None:
        slot.store(0)

    # -- writer-side revocation (registry.revoke) --------------------------
    def revoke(self, l: int) -> None:
        self.gate.cell(l).fetch_add(1)       # open this lock's drain gate
        try:
            self.rbias.cell(l).store(0)
            self.mem.fence()
            start = self.mem.now()
            matches = self.table.scan(self.lock_vals[l])
            if self.drain_bug:               # MUTATION drain-off-by-one
                matches = matches[1:]
            for i in matches:
                self.mem.wait_while(
                    self.table.cell(i),
                    lambda v, L=self.lock_vals[l]: v == L)
            self._ewma[l], window = adaptive_inhibit(
                self._ewma[l], self.mem.now() - start, 9)
            self.inhibit.cell(l).store(self.mem.now() + window)
        finally:
            self.gate.cell(l).fetch_add(-1)

    def rearm(self, l: int) -> bool:
        """Re-arm ``l``'s bias — gated ONLY on ``l``'s own drain gate and
        inhibit window (per-lock independence)."""
        if self.gate.cell(l).load():
            return False
        if self.mem.now() < self.inhibit.cell(l).load():
            return False
        self.rbias.cell(l).store(1)
        return True


def build_registry_model(mem: Mem,
                         mutation: Optional[str] = None) -> Instance:
    """Reader on lock A vs revoking writer on A vs a thread exercising
    lock B's rearm while A may be mid-drain."""
    model = RegistryModel(mem, n_locks=2,
                          drain_bug=(mutation == "drain-off-by-one"))
    A, B = 0, 1
    scratch = mem.alloc("scratch")
    g = SimpleNamespace(readers={A: 0, B: 0}, writers={A: 0, B: 0})

    def t_reader_a():                        # tid 0
        for _ in range(2):
            slot = model.try_acquire(A)
            if slot is None:
                continue
            g.readers[A] += 1
            scratch.load()                   # observable CS window
            g.readers[A] -= 1
            model.release(slot)

    def t_writer_a():                        # tid 1
        model.revoke(A)
        g.writers[A] += 1
        scratch.load()                       # writer CS: drain must be done
        g.writers[A] -= 1

    def t_lock_b():                          # tid 2
        # (I8) drain-independence: A's gate (possibly open right now) must
        # never block B's rearm; B's own gate is closed and its inhibit
        # window is 0, so this must succeed unconditionally.
        if not model.rearm(B):
            raise InvariantViolation(
                "rearm-independence",
                f"rearm(B) refused; gate(A)={peek(mem, model.gate.cell(A))}"
                f" gate(B)={peek(mem, model.gate.cell(B))}")
        slot = model.try_acquire(B)
        if slot is not None:
            g.readers[B] += 1
            scratch.load()
            g.readers[B] -= 1
            model.release(slot)

    def check(ev):
        for l in (A, B):
            # (I6) per-lock writer exclusion after drain.  Note this is
            # deliberately about readers *in their CS*, not published
            # slots: a slot CAS that lands after the writer's scan is
            # legal — that reader's recheck will see rbias == 0 and back
            # off before entering its CS.
            if g.writers[l] and g.readers[l]:
                raise InvariantViolation(
                    "writer-exclusion-after-drain",
                    f"lock {l}: {g.readers[l]} fast reader(s) in CS "
                    f"while the revoking writer is in its CS")
            # (I7) gates are balanced counters
            if peek(mem, model.gate.cell(l)) < 0:
                raise InvariantViolation(
                    "gate-underflow",
                    f"gate({l}) = {peek(mem, model.gate.cell(l))}")

    def at_end():
        for l in (A, B):
            if peek(mem, model.gate.cell(l)) != 0:
                raise InvariantViolation(
                    "gate-underflow", f"gate({l}) != 0 at exit")

    return Instance([t_reader_a, t_writer_a, t_lock_b], check, at_end)


# ---------------------------------------------------------------------------
# S3b — writer parking + bounded drain + stuck-lane scrub
# ---------------------------------------------------------------------------


class ParkingModel:
    """Host model of the registry's writer path: bounded drain with a
    DrainTimeout/scrub escape, and a TWA-style parking word (seq-count
    futex) where a second writer parks on the first writer's drain.

    The bounded drain is modelled deterministically: each matching slot is
    polled ONCE after the scan; a slot still publishing counts as a
    deadline hit (the checker has no wall clock — one failed recheck IS
    the timeout).  On timeout the lane is scrubbed and the lock value
    regenerated (``gen`` bumps), and the writer does NOT enter its CS —
    mirroring the deliberate raise in ``BravoRegistry.revoke``."""

    def __init__(self, mem: Mem, lose_wakeup: bool = False):
        self.mem = mem
        self.table = VisibleReadersTable(mem, size=64, name="VR")
        self.rbias = mem.alloc("park.rbias")
        self.gate = mem.alloc("park.gate")     # _revoking drain gate
        self.park = mem.alloc("park.word")     # TWA slot: seq-count futex
        self.lose_wakeup = lose_wakeup
        # two generations of the lane's lock value, slot-disjoint so the
        # stale publish and the rearmed lock are unambiguous cells
        self.val0 = pin_lock_value(self.table, [0, 1, 2])
        taken = {mix_hash(self.val0, t) & (self.table.size - 1)
                 for t in (0, 1, 2)}
        self.val1 = pin_lock_value(self.table, [0, 1, 2], avoid=taken,
                                   start=self.val0 + 1)
        self.cur = self.val0                   # ghost: current lock value
        self.gen = 0                           # ghost: bumps on scrub
        mem._vals[self.rbias.index] = 1        # biased steady state

    # -- reader fast path --------------------------------------------------
    def try_acquire(self) -> Optional[Cell]:
        val = self.cur
        if self.rbias.load() == 0:
            return None
        slot = self.table.slot_for(val, self.mem.thread_id())
        if not slot.cas(0, val):
            return None
        self.mem.fence()
        if self.rbias.load():
            return slot
        slot.store(0)                          # lost to a revoking writer
        return None

    # -- writer path -------------------------------------------------------
    def _park_until_idle(self) -> None:
        """TWA parking: wait on the seq word while the gate is open.
        Wakeups are hints — the gate is rechecked after every wake."""
        while True:
            seq = self.park.load()
            if self.gate.load() == 0:
                return
            self.mem.futex_wait(self.park, seq)

    def _unpark(self) -> None:
        if self.lose_wakeup:                   # MUTATION park-wakeup-lost
            return
        self.park.fetch_add(1)
        self.mem.futex_wake(self.park)

    def revoke(self) -> bool:
        """Bounded drain; True -> drained (caller may enter its CS),
        False -> deadline hit, lane scrubbed (caller must NOT proceed)."""
        self._park_until_idle()
        self.gate.fetch_add(1)
        try:
            self.rbias.store(0)
            self.mem.fence()
            val = self.cur
            for i in self.table.scan(val):
                if peek(self.mem, self.table.cell(i)) != val:
                    continue                   # cleared between scan & poll
                if self.table.cell(i).load() == val:   # the bounded poll
                    self._scrub(val)
                    return False
            return True
        finally:
            self.gate.fetch_add(-1)
            self._unpark()

    def _scrub(self, val: int) -> None:
        """Stuck-lane scrub: zero every slot publishing ``val`` and
        REGENERATE the lane's lock value, so the wedged publish can never
        match the rearmed lock."""
        for i in self.table.scan(val):
            self.table.cell(i).store(0)
        self.cur = self.val1
        self.gen += 1


def build_parking_model(mem: Mem, mutation: Optional[str] = None) -> Instance:
    """Wedged reader (never releases) vs two writers on ONE lock: writer 1
    hits the bounded-drain deadline and scrubs; writer 2 parks on writer
    1's drain gate (TWA word, not a table poll), is woken by writer 1's
    unpark, retries on the REGENERATED value and enters its CS.

    The ``park-wakeup-lost`` mutation drops the unpark (seq bump + wake):
    writer 2 stays blocked in ``futex_wait`` forever, which the explorer's
    built-in deadlock invariant reports."""
    model = ParkingModel(mem, lose_wakeup=(mutation == "park-wakeup-lost"))
    scratch = mem.alloc("scratch")
    g = SimpleNamespace(wedged=False, writers_cs=0, timeouts=0)

    def t_stuck_reader():                      # tid 0: wedged forever
        slot = model.try_acquire()
        if slot is not None:
            g.wedged = True                    # holds the lease; no release

    def t_writer1():                           # tid 1
        if model.revoke():
            g.writers_cs += 1
            scratch.load()                     # CS: drain really finished
            g.writers_cs -= 1
        else:
            g.timeouts += 1                    # degraded path: no CS

    def t_writer2():                           # tid 2: parks on writer 1
        if model.revoke():
            g.writers_cs += 1
            scratch.load()
            g.writers_cs -= 1
        else:
            g.timeouts += 1

    def check(ev):
        # (I11) reader exclusion after a SUCCESSFUL drain: a writer in
        # its CS never coexists with a slot matching the CURRENT lock
        # value — a non-wedged reader backed off or released, and the
        # wedged reader's stale publish is OLD-generation by construction
        # (that is the whole point of the scrub).  Writer-writer
        # exclusion is the HOST write lock's job, outside this model:
        # revoke only drains readers, which is why the gate is a counter.
        if g.writers_cs:
            for i in range(model.table.size):
                if mem._vals[model.table.arr.base + i] == model.cur:
                    raise InvariantViolation(
                        "stale-lane-matches-rearmed-lock",
                        f"slot {i} publishes CURRENT value {model.cur} "
                        f"while a writer is in its CS")
        # (I12) the drain gate is a balanced counter.
        if peek(mem, model.gate) < 0:
            raise InvariantViolation(
                "gate-underflow", f"gate = {peek(mem, model.gate)}")

    def at_end():
        if peek(mem, model.gate) != 0:
            raise InvariantViolation(
                "gate-underflow", "gate != 0 at exit")
        # (I13) post-scrub hygiene: once the value regenerated, no slot
        # may still publish it-or-the-old-one EXCEPT the wedged reader's
        # own (pre-scrub grants are gen-skipped, their slots scrubbed).
        if model.gen:
            for i in range(model.table.size):
                if mem._vals[model.table.arr.base + i] == model.cur:
                    raise InvariantViolation(
                        "stale-lane-matches-rearmed-lock",
                        f"slot {i} publishes regenerated value "
                        f"{model.cur} at exit")

    return Instance([t_stuck_reader, t_writer1, t_writer2], check, at_end)


# ---------------------------------------------------------------------------
# S4 — host model of the KV pool's owner-vector / COW protocol
# ---------------------------------------------------------------------------

FREE = -1


class KVPoolModel:
    """Host model of the paged-KV owner vector: ``owner[p] >= 0``
    = privately owned by request ``rid``; ``-1`` = free; ``<= -2`` =
    shared with refcount ``-1 - owner``.  Data writes are only legal on a
    privately-owned page — shared pages diverge copy-on-write."""

    def __init__(self, mem: Mem, n_pages: int = 3, write_bug: bool = False):
        self.mem = mem
        self.owner = mem.alloc_array("pool.owner", n_pages, init=FREE)
        self.data = mem.alloc_array("pool.data", n_pages)
        self.write_bug = write_bug

    def alloc(self, rid: int) -> Optional[int]:
        for p in range(self.owner.n):
            if self.owner.cell(p).cas(FREE, rid):
                return p
        return None

    def write(self, p: int, val: int) -> None:
        self.data.cell(p).store(val)

    def insert_shared(self, p: int, rid: int) -> bool:
        """Publish a private page into the prefix cache (rc = 1)."""
        return self.owner.cell(p).cas(rid, -2)

    def reclaim(self, p: int, rid: int) -> bool:
        return self.owner.cell(p).cas(rid, FREE)

    def acquire_ref(self, p: int) -> bool:
        c = self.owner.cell(p)
        while True:
            v = c.load()
            if v > -2:
                return False                 # no longer shared
            if c.cas(v, v - 1):
                return True

    def release_ref(self, p: int) -> None:
        c = self.owner.cell(p)
        while True:
            v = c.load()
            if c.cas(v, v + 1):              # -2 -> -1 frees the page
                return


def _legal_owner_transition(old: int, new: int) -> bool:
    if old == FREE and new >= 0:
        return True                          # alloc
    if old >= 0 and new == FREE:
        return True                          # reclaim
    if old >= 0 and new == -2:
        return True                          # insert_shared (rc = 1)
    if old <= -2 and new == old - 1:
        return True                          # acquire_ref
    if old <= -2 and new == old + 1:
        return True                          # release_ref (rc 1 -> free)
    return False


def build_kvpool_model(mem: Mem, mutation: Optional[str] = None) -> Instance:
    """Producer shares a page; two consumers take refs; one consumer
    'modifies' it — correctly via COW divergence, or (mutated) by writing
    straight through the shared page."""
    model = KVPoolModel(mem, n_pages=3,
                        write_bug=(mutation == "cow-write-through"))
    mailbox = mem.alloc("mailbox")           # published page + 1 (0 = none)
    rid_of = {0: 1, 1: 2, 2: 3}              # ghost: tid -> request id
    prev_owner = {p: FREE for p in range(model.owner.n)}
    shared_page = SimpleNamespace(p=None)

    def t_producer():                        # tid 0, rid 1
        p = model.alloc(1)
        model.write(p, 11)
        model.insert_shared(p, 1)
        shared_page.p = p
        mailbox.store(p + 1)

    def t_modifier():                        # tid 1, rid 2
        mem.wait_while(mailbox, lambda v: v == 0)
        p = mailbox.load() - 1
        if not model.acquire_ref(p):
            return
        model.data.cell(p).load()            # read the shared prefix
        if model.write_bug:                  # MUTATION cow-write-through
            model.write(p, 22)
        else:                                # COW: diverge onto a new page
            q = model.alloc(2)
            model.write(q, 22)
            model.reclaim(q, 2)
        model.release_ref(p)

    def t_reader():                          # tid 2, rid 3
        mem.wait_while(mailbox, lambda v: v == 0)
        p = mailbox.load() - 1
        if not model.acquire_ref(p):
            return
        model.data.cell(p).load()
        model.release_ref(p)

    def check(ev):
        # (I9) owner-word encoding: every transition is one of the five
        # legal edges (alloc, reclaim, insert, ref++, ref--).
        for p in range(model.owner.n):
            cur = peek(mem, model.owner.cell(p))
            old = prev_owner[p]
            if cur != old:
                prev_owner[p] = cur
                if not _legal_owner_transition(old, cur):
                    raise InvariantViolation(
                        "owner-encoding",
                        f"owner[{p}]: illegal transition {old} -> {cur}")
        # (I10) no write through a shared (or free) page: data stores are
        # only legal while the page is privately owned by the writer.
        if (ev.kind == "store" and model.data.base <= ev.index
                < model.data.base + model.data.n):
            p = ev.index - model.data.base
            ov = peek(mem, model.owner.cell(p))
            rid = rid_of[ev.tid]
            if ov <= -2:
                raise InvariantViolation(
                    "cow-write-through-shared",
                    f"T{ev.tid} (rid {rid}) wrote page {p} while shared "
                    f"(owner={ov}, refcount={-1 - ov})")
            if ov != rid:
                raise InvariantViolation(
                    "cow-write-through-shared",
                    f"T{ev.tid} (rid {rid}) wrote page {p} it does not "
                    f"own (owner={ov})")

    def at_end():
        p = shared_page.p
        if p is not None and peek(mem, model.data.cell(p)) != 11:
            raise InvariantViolation(
                "cow-write-through-shared",
                f"shared page {p} content mutated to "
                f"{peek(mem, model.data.cell(p))}")

    return Instance([t_producer, t_modifier, t_reader], check, at_end)


# ---------------------------------------------------------------------------
# S5 — quantized page store: scale metadata vs the owner-vector contract
# ---------------------------------------------------------------------------


class QuantScaleModel(KVPoolModel):
    """:class:`KVPoolModel` plus the quantized store's per-page
    dequantization ``scale`` word.  The scale is pool METADATA under the
    same owner-vector contract as the page bytes: written only while the
    page is privately owned, never through a shared page, and ALWAYS
    rewritten before new data lands on a (re)allocated page — int8 bytes
    are meaningless under the previous tenant's scale."""

    def __init__(self, mem: Mem, n_pages: int = 3,
                 cow_scale_bug: bool = False):
        super().__init__(mem, n_pages)
        self.scale = mem.alloc_array("pool.scale", n_pages)
        self.cow_scale_bug = cow_scale_bug

    def write_quant(self, p: int, val: int, sc: int) -> None:
        """Quantize-and-scatter: the scale store PRECEDES the data store,
        so at no point does the page hold new bytes under an old scale."""
        self.scale.cell(p).store(sc)
        self.write(p, val)


def build_quant_scale_model(mem: Mem,
                            mutation: Optional[str] = None) -> Instance:
    """Producer publishes a quantized page; a modifier takes a ref and
    diverges copy-on-write (bytes AND scale — or, mutated, bytes only); a
    reader dequantizes the shared page.  The ghost ``needs_fresh`` set
    tracks pages whose owner went FREE -> rid without a scale store yet:
    data landing on such a page is the stale-scale-on-realloc bug, and a
    scale store on a shared page is the shared-scale-rewrite bug."""
    model = QuantScaleModel(mem, n_pages=3,
                            cow_scale_bug=(mutation == "cow-skips-scale"))
    mailbox = mem.alloc("mailbox")           # published page + 1 (0 = none)
    rid_of = {0: 1, 1: 2, 2: 3}              # ghost: tid -> request id
    prev_owner = {p: FREE for p in range(model.owner.n)}
    needs_fresh: set = set()                 # ghost: alloc'd, scale stale
    shared_page = SimpleNamespace(p=None)

    def t_producer():                        # tid 0, rid 1
        p = model.alloc(1)
        model.write_quant(p, 11, 5)          # bytes 11 under scale 5
        model.insert_shared(p, 1)
        shared_page.p = p
        mailbox.store(p + 1)

    def t_modifier():                        # tid 1, rid 2
        mem.wait_while(mailbox, lambda v: v == 0)
        p = mailbox.load() - 1
        if not model.acquire_ref(p):
            return
        d = model.data.cell(p).load()        # read the shared prefix...
        s = model.scale.cell(p).load()       # ...and its scale
        q = model.alloc(2)                   # COW: diverge onto a new page
        if model.cow_scale_bug:              # MUTATION cow-skips-scale
            model.write(q, d)                # bytes copied, scale not
        else:
            model.write_quant(q, d, s)       # content + scale as one unit
        model.write_quant(q, 22, 7)          # the divergent requant
        model.reclaim(q, 2)
        model.release_ref(p)

    def t_reader():                          # tid 2, rid 3
        mem.wait_while(mailbox, lambda v: v == 0)
        p = mailbox.load() - 1
        if not model.acquire_ref(p):
            return
        model.scale.cell(p).load()           # dequant reads scale first
        model.data.cell(p).load()
        model.release_ref(p)

    def check(ev):
        # (I9) the owner encoding itself, as in S4 — and the ghost set:
        # a page entering private ownership from FREE owes a scale store
        # before any data store.
        for p in range(model.owner.n):
            cur = peek(mem, model.owner.cell(p))
            old = prev_owner[p]
            if cur != old:
                prev_owner[p] = cur
                if not _legal_owner_transition(old, cur):
                    raise InvariantViolation(
                        "owner-encoding",
                        f"owner[{p}]: illegal transition {old} -> {cur}")
                if old == FREE and cur >= 0:
                    needs_fresh.add(p)       # fresh tenant, stale scale
        if ev.kind != "store":
            return
        if model.scale.base <= ev.index < model.scale.base + model.scale.n:
            p = ev.index - model.scale.base
            ov = peek(mem, model.owner.cell(p))
            rid = rid_of[ev.tid]
            # (I14) a shared page's scale is immutable: rewriting it would
            # silently re-decode every reference-holder's bytes.
            if ov <= -2:
                raise InvariantViolation(
                    "shared-scale-rewrite",
                    f"T{ev.tid} (rid {rid}) rewrote scale[{p}] while "
                    f"shared (owner={ov}, refcount={-1 - ov})")
            if ov != rid:
                raise InvariantViolation(
                    "shared-scale-rewrite",
                    f"T{ev.tid} (rid {rid}) wrote scale[{p}] on a page "
                    f"it does not own (owner={ov})")
            needs_fresh.discard(p)           # the owed store landed
        if model.data.base <= ev.index < model.data.base + model.data.n:
            p = ev.index - model.data.base
            # (I15) no bytes under a stale scale: a (re)allocated page's
            # data store must be preceded by its own scale store.
            if p in needs_fresh:
                raise InvariantViolation(
                    "stale-scale-on-realloc",
                    f"T{ev.tid} stored data[{p}] before refreshing its "
                    f"scale — bytes would decode under the previous "
                    f"tenant's scale")

    def at_end():
        p = shared_page.p
        if p is not None and peek(mem, model.scale.cell(p)) != 5:
            raise InvariantViolation(
                "shared-scale-rewrite",
                f"shared page {p} scale mutated to "
                f"{peek(mem, model.scale.cell(p))}")

    return Instance([t_producer, t_modifier, t_reader], check, at_end)


# ---------------------------------------------------------------------------
# S6 — latency-feedback admission controller (real policy code)
# ---------------------------------------------------------------------------


def build_controller_model(mem: Mem,
                           mutation: Optional[str] = None) -> Instance:
    """A latency sensor feeding the REAL
    :class:`repro_torch.serving.scheduler.LatencyFeedbackController` (pure
    host policy — the checker drives its transition function directly).

    The sensor thread publishes two over-target latencies, then a
    healthy one, then signals done; the controller thread takes three
    updates against whatever it happens to read (any interleaving), then
    waits for the signal and takes six guaranteed-healthy updates.

    Invariants (the wedge-freedom contract):

    * ``controller-cap-bounds`` — after every committed op the cap stays
      in ``[min_slots, max_slots]`` and the watermark in
      ``[0, watermark_max]`` with ``watermark_max < 1``: no reachable
      state shuts admission completely.
    * ``controller-wedged`` (at exit) — if any shrink happened, the six
      trailing healthy updates must have produced at least one recovery
      grow (cooldown=1 + max(recover_after=1, probe_after=2) < 6 from
      every reachable post-shrink state).  The
      ``ctrl-recovery-dropped`` mutation — the additive-recovery branch
      never fires — wedges the cap at its post-shrink floor and trips
      exactly this.
    """
    from ..serving.scheduler import (ControllerConfig,
                                     LatencyFeedbackController)

    class _DroppedRecoveryController(LatencyFeedbackController):
        """MUTATION ctrl-recovery-dropped: the healthy streak never
        accumulates, so additive recovery (and the ceiling probe) never
        fire — one burst wedges admission at the shrunken cap forever."""

        def step(self, *a):
            self._healthy = -(10 ** 9)
            return super().step(*a)

    ccfg = ControllerConfig(step_p99_target_ms=1.0, min_samples=1,
                            min_slots=1, decrease=0.5, recover_after=1,
                            cooldown=1, probe_after=2,
                            watermark_step=0.1, watermark_max=0.5)
    cls = (_DroppedRecoveryController
           if mutation == "ctrl-recovery-dropped"
           else LatencyFeedbackController)
    ctrl = cls(ccfg, max_slots=4, free_frac=0.0)
    lat = mem.alloc("lat_us")       # sensor -> controller (0 = no sample)
    done = mem.alloc("sensor_done")
    cap_pub = mem.alloc("cap_pub")  # controller's published decisions —
    frac_pub = mem.alloc("frac_x1000")  # the observable admission limits

    def _update():
        v = lat.load()              # schedule point: any interleaving of
        if v:                       # sensor writes is explored
            ctrl.step(v * 1000.0, 1, 0.0, 0)
        cap_pub.store(ctrl.slot_cap)
        frac_pub.store(int(ctrl.free_frac * 1000))

    def t_sensor():                 # tid 0
        lat.store(2000)             # 2ms — over the 1ms knee target
        lat.store(2000)
        lat.store(100)              # burst drained: healthy again
        done.store(1)

    def t_controller():             # tid 1
        for _ in range(3):          # races the burst: may see 0/2000/100
            _update()
        mem.wait_while(done, lambda v: v == 0)
        for _ in range(6):          # guaranteed-healthy tail: recovery
            _update()               # must happen if anything shrank

    def check(ev):
        if not (ccfg.min_slots <= ctrl.slot_cap <= ctrl.max_slots):
            raise InvariantViolation(
                "controller-cap-bounds",
                f"slot cap {ctrl.slot_cap} outside "
                f"[{ccfg.min_slots}, {ctrl.max_slots}]")
        if not (0.0 <= ctrl.free_frac <= ccfg.watermark_max):
            raise InvariantViolation(
                "controller-cap-bounds",
                f"watermark {ctrl.free_frac} outside "
                f"[0, {ccfg.watermark_max}]")

    def at_end():
        if ctrl.shrinks > 0 and ctrl.grows == 0:
            raise InvariantViolation(
                "controller-wedged",
                f"cap shrank to {ctrl.slot_cap} and never recovered "
                f"under sustained healthy latency (shrinks="
                f"{ctrl.shrinks}, grows=0): admission wedged")

    return Instance([t_sensor, t_controller], check, at_end)


# ---------------------------------------------------------------------------
# Registry of scenarios and mutations
# ---------------------------------------------------------------------------

SCENARIOS: Dict[str, Scenario] = {
    "bravo-rw": Scenario("bravo-rw", 2, build_bravo_rw,
                         max_schedules=4000),
    "bravo-2r1w": Scenario("bravo-2r1w", 3, build_bravo_2r1w,
                           max_schedules=6000),
    "registry-model": Scenario("registry-model", 3, build_registry_model,
                               max_schedules=6000),
    "parking-model": Scenario("parking-model", 3, build_parking_model,
                              max_schedules=10000),
    "kvpool-model": Scenario("kvpool-model", 3, build_kvpool_model,
                             max_schedules=6000),
    "quant-scale-model": Scenario("quant-scale-model", 3,
                                  build_quant_scale_model,
                                  max_schedules=6000),
    "controller-model": Scenario("controller-model", 2,
                                 build_controller_model,
                                 max_schedules=4000),
}

#: mutation flag -> the scenario whose invariants catch it
MUTATIONS: Dict[str, str] = {
    "release-token-mismatch": "bravo-rw",
    "drain-off-by-one": "registry-model",
    "park-wakeup-lost": "parking-model",
    "cow-write-through": "kvpool-model",
    "cow-skips-scale": "quant-scale-model",
    "ctrl-recovery-dropped": "controller-model",
}
