"""Continuous-batching scheduler: admission, chunked prefill, preemption.

This module is the serving control plane's POLICY — it owns no threads, no
locks and no device dispatch.  The :class:`~repro_torch.serving.engine.
ServingEngine` keeps the mechanisms (handler threads, the BRAVO host locks,
the registry lease batches, the jitted steps) and consults the scheduler for
every decision: who is admitted, what runs this tick, who grows, who is
evicted.  That split is deliberate: the lock-protocol work-3 lives
entirely in the engine's mechanism layer, and the scheduler can be unit
tested as a pure state machine.

Per-request FSM (:class:`SlotState`)::

    WAITING --admit--> PREFILL --chunks done--> DECODE --max_new--> DONE
                          ^                        |
       (re-admit) ---- EVICTED <---page pressure---'
       (EVICTED slots queue alongside WAITING ones; admission treats
        them alike, at the head of the queue)

* **Admission control** bounds in-flight work two ways, following
  "Avoiding Scalability Collapse by Restricting Concurrency" (Dice &
  Kogan): a hard slot cap (``max_slots`` — the concurrency-restriction
  watermark on the readers hitting the lease fast path every step) and a
  KV-page watermark (``admit_free_frac`` — a request is only admitted if
  its pages fit without pushing the pool below the floor).  With the
  prefix cache on, the engine's ``need_fn`` charges a request only the
  pages its prompt does NOT share with the pool's prefix index.
* **Chunked prefill** interleaves with decode: each prefill tick processes
  at most ``prefill_rows`` requests and ``token_budget`` prompt tokens,
  cut into right-aligned chunks of ``prefill_chunk``; between prefill
  ticks, ``decode_ticks_per_prefill`` decode ticks run so admitted
  requests keep streaming tokens.  Chunks attend to the already-paged
  prefix, so nothing is recomputed across ticks.
* **Preemption** is ordered by page pressure from the
  :class:`~repro_torch.serving.kv_pool.KVPool`: when an allocation cannot be
  served, the newest slot (LIFO — protects oldest work from starvation) is
  evicted, its pages reclaimed, and its request requeued with the tokens
  generated so far folded into the prompt — greedy decoding makes the
  continuation deterministic, so eviction never changes output.
"""

from __future__ import annotations

import collections
import dataclasses
import enum
from typing import Any, Deque, Dict, List, Optional

import numpy as np

from ..obs import TRACER as _TR

__all__ = ["Phase", "SlotState", "SchedulerConfig", "Plan", "Scheduler",
           "ControllerConfig", "LatencyFeedbackController"]


class Phase(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    EVICTED = "evicted"


@dataclasses.dataclass
class SlotState:
    """One request's scheduler state (the FSM node).

    ``prefix`` starts as the prompt; on eviction the tokens generated so
    far are folded into it, so a re-admitted slot re-prefills prompt +
    generated and continues exactly where it left off."""

    rid: int
    prefix: np.ndarray                  # (S,) int32 tokens to prefill
    max_new: int
    phase: Phase = Phase.WAITING
    row: int = -1                       # decode-batch row while scheduled
    prefill_pos: int = 0                # prefix tokens already paged
    pos: int = 0                        # total valid cache length
    out: List[int] = dataclasses.field(default_factory=list)
    pages: List[int] = dataclasses.field(default_factory=list)
    evictions: int = 0
    seq: int = -1                       # admission order (victim choice)
    arrival: int = -1                   # submit order (admission fairness;
    #                                     survives defer/evict requeues)
    tenant: str = ""                    # SLO bookkeeping (loadgen classes)
    cls: str = ""
    priority: int = 0                   # admission priority (higher first)
    request: Any = None                 # engine Request (opaque here)
    admit_ns: int = 0                   # engine-owned: monotonic_ns of the
    #                                     LATEST admission (TTFT sensor —
    #                                     reporting TTFT comes from the
    #                                     trace's FIRST admit instead)
    # ---- prefix-cache state (engine-owned; policy only reads cached_pos)
    keys: Any = None                    # chained page keys (kh, kl, lens)
    cache_plan: Any = None              # (pool version, cov, k_ref, cow,
    #                                     need) from the admission peek
    cached_pos: int = 0                 # prompt tokens served from cache
    shared_refs: List[int] = dataclasses.field(default_factory=list)

    @property
    def n_prefix(self) -> int:
        return len(self.prefix)

    @property
    def remaining_prefill(self) -> int:
        return self.n_prefix - self.prefill_pos


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Scheduler policy knobs (all pure host-side; shapes that feed jitted
    steps — ``max_slots``, ``prefill_rows``, ``prefill_chunk``, the page
    geometry — are fixed so the engine compiles each step exactly once)."""

    max_slots: int = 4            # concurrency-restriction watermark
    page_size: int = 16
    max_seq: int = 128            # per-request prompt + generation bound
    prefill_chunk: int = 32       # tokens per prefill chunk (compile shape)
    prefill_rows: int = 2         # prefill batch height (compile shape)
    token_budget: int = 64        # prompt tokens per prefill tick
    admit_free_frac: float = 0.0  # admission floor: keep this fraction free
    decode_ticks_per_prefill: int = 1   # interleave ratio
    prefix_cache: bool = True     # dedup shared prompt prefixes over the
    #                               pool's device-side page index
    aging_every: int = 4          # anti-starvation: every Nth admission
    #                               takes the OLDEST waiting slot regardless
    #                               of priority (0 = strict priority)
    controller: Optional["ControllerConfig"] = None  # latency-feedback
    #                               admission (None = static watermark)

    @property
    def lanes(self) -> int:
        """Page-index lanes per request (covers max_seq)."""
        return -(-self.max_seq // self.page_size)

    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)


@dataclasses.dataclass
class Plan:
    """One tick's work order, executed by the engine."""
    kind: str                            # "prefill" | "decode" | "idle"
    slots: List[SlotState]
    chunks: List[int] = dataclasses.field(default_factory=list)  # prefill
    grow: List[SlotState] = dataclasses.field(default_factory=list)  # decode


class Scheduler:
    """Continuous-batching policy over a fixed pool of batch rows."""

    def __init__(self, config: SchedulerConfig, n_pages: int):
        self.cfg = config
        self.n_pages = n_pages
        self.waiting: Deque[SlotState] = collections.deque()
        self.running: Dict[int, SlotState] = {}      # row -> slot
        self._free_rows = list(range(config.max_slots - 1, -1, -1))
        self._seq = 0
        self._arrivals = 0
        self._since_prefill = config.decode_ticks_per_prefill
        self.admissions = 0
        self.evictions = 0
        self.finished = 0
        # runtime admission limits: initialized from the static config,
        # modulated by the latency-feedback controller through
        # set_limits() (compile shapes — max_slots rows — never change;
        # the cap only bounds how many rows are simultaneously active)
        self.slot_cap = config.max_slots
        self.admit_free_frac = config.admit_free_frac

    # ------------------------------------------------------------ lifecycle
    def submit(self, st: SlotState) -> None:
        if st.n_prefix + st.max_new > self.cfg.max_seq:
            raise ValueError(
                f"request {st.rid}: prompt {st.n_prefix} + max_new "
                f"{st.max_new} exceeds max_seq {self.cfg.max_seq}")
        st.phase = Phase.WAITING
        if st.arrival < 0:
            st.arrival = self._arrivals
            self._arrivals += 1
        self.waiting.append(st)
        if _TR.enabled:
            _TR.emit("sched", "submit", rid=st.rid, prompt=st.n_prefix,
                     max_new=st.max_new)

    def admit(self, free_pages: int, need_fn=None) -> List[SlotState]:
        """Admission control: move WAITING slots to PREFILL while a batch
        row is free and the slot's pages fit above the admission watermark.
        ``need_fn(st)`` overrides the page charge — the engine passes the
        post-dedup estimate, so a request is charged only the pages its
        prompt does NOT share with the prefix cache.  The caller allocates
        the returned slots' pages (and calls :meth:`defer` on any whose
        allocation fails after all).

        Candidate order is highest ``priority`` first (submit order
        within a priority), so one tenant's burst of background work
        cannot starve an interactive class's SLO; every
        ``cfg.aging_every``-th admission instead takes the *oldest*
        waiting slot regardless of priority, so low-priority work is
        starvation-free under a sustained high-priority burst.  The
        active-slot cap (``self.slot_cap``, <= ``max_slots``) and the
        page watermark (``self.admit_free_frac``) are runtime values —
        the latency-feedback controller moves them; shrinking the cap
        never evicts, it only pauses admission until slots drain."""
        floor = self.admit_free_frac * self.n_pages
        admitted: List[SlotState] = []
        while self.waiting and self._free_rows \
                and len(self.running) < self.slot_cap:
            st = self.waiting[self._pick_idx()]
            need = (need_fn(st) if need_fn is not None
                    else self.cfg.pages_for(st.n_prefix + 1))
            if free_pages - need < floor:
                break
            self.waiting.remove(st)
            st.row = self._free_rows.pop()
            st.seq = self._seq
            self._seq += 1
            st.phase = Phase.PREFILL
            st.prefill_pos = st.pos = 0
            self.running[st.row] = st
            self.admissions += 1
            free_pages -= need
            admitted.append(st)
            if _TR.enabled:
                _TR.emit("sched", "admit", rid=st.rid, row=st.row,
                         need=need)
        return admitted

    def _pick_idx(self) -> int:
        """Next admission candidate's index in ``waiting``: best
        (priority desc, arrival asc), except every ``aging_every``-th
        admission which takes the oldest outright (anti-starvation).
        When every waiting slot has equal priority this degenerates to
        index 0 — the earlier FIFO behavior (evicted slots sit at the
        head AND have the oldest arrivals, so requeues still win)."""
        n = len(self.waiting)
        if n == 1:
            return 0
        aging = self.cfg.aging_every
        if aging > 0 and self.admissions % aging == aging - 1:
            return min(range(n), key=lambda i: self.waiting[i].arrival)
        return min(range(n), key=lambda i: (-self.waiting[i].priority,
                                            self.waiting[i].arrival))

    def set_limits(self, slot_cap: Optional[int] = None,
                   free_frac: Optional[float] = None) -> None:
        """Apply the latency-feedback controller's decision (the engine
        calls this — never assigns scheduler attributes directly; the
        ``scheduler-state-mutation`` lint enforces it).  Values are
        clamped so admission can never be wedged shut: at least one
        active slot, watermark strictly below the whole pool."""
        if slot_cap is not None:
            self.slot_cap = max(1, min(int(slot_cap), self.cfg.max_slots))
        if free_frac is not None:
            self.admit_free_frac = max(0.0, min(float(free_frac), 0.95))

    def defer(self, st: SlotState) -> None:
        """Undo an admission whose page allocation failed: back to the head
        of the queue (oldest work keeps priority).  The engine released any
        prefix refs it took; the plan is re-peeked at the next attempt."""
        self._release_row(st)
        st.cache_plan = None
        st.cached_pos = 0
        st.phase = Phase.WAITING
        self.waiting.appendleft(st)
        if _TR.enabled:
            _TR.emit("sched", "defer", rid=st.rid)

    def _release_row(self, st: SlotState) -> None:
        self.running.pop(st.row, None)
        if st.row >= 0:
            self._free_rows.append(st.row)
        st.row = -1

    # ----------------------------------------------------------------- plan
    def plan(self) -> Plan:
        """Pick this tick's work: prefill and decode interleave at the
        configured ratio; prefill is chunked to ``token_budget`` tokens
        over at most ``prefill_rows`` slots, oldest first."""
        prefill = sorted((s for s in self.running.values()
                          if s.phase is Phase.PREFILL), key=lambda s: s.seq)
        decode = sorted((s for s in self.running.values()
                         if s.phase is Phase.DECODE), key=lambda s: s.row)
        if prefill and (not decode or self._since_prefill
                        >= self.cfg.decode_ticks_per_prefill):
            chosen, chunks = [], []
            budget = self.cfg.token_budget
            for st in prefill:
                c = min(self.cfg.prefill_chunk, st.remaining_prefill, budget)
                if c <= 0:
                    break
                chosen.append(st)
                chunks.append(c)
                budget -= c
                if len(chosen) == self.cfg.prefill_rows:
                    break
            if chosen:
                self._since_prefill = 0
                return Plan("prefill", chosen, chunks=chunks)
        if decode:
            self._since_prefill += 1
            # the step writes the pending token's K/V at position pos - 1
            grow = [st for st in decode
                    if st.pos > len(st.pages) * self.cfg.page_size]
            return Plan("decode", decode, grow=grow)
        if prefill:   # interleave counter said decode, but none exists
            self._since_prefill = self.cfg.decode_ticks_per_prefill
            return self.plan()
        return Plan("idle", [])

    # ------------------------------------------------------------- progress
    def on_prefill(self, st: SlotState, chunk: int) -> bool:
        """Record a prefilled chunk; returns True when the prefix is fully
        paged (the slot moves to DECODE and the tick's last-column token is
        this request's next generated token)."""
        st.prefill_pos += chunk
        st.pos = st.prefill_pos
        if st.prefill_pos >= st.n_prefix:
            st.phase = Phase.DECODE
            return True
        return False

    def on_token(self, st: SlotState, token: int) -> bool:
        """Record a generated token; returns True when the request is done
        (caller reclaims pages and frees the row via :meth:`finish`)."""
        st.out.append(token)
        st.pos += 1
        return len(st.out) >= st.max_new

    def finish(self, st: SlotState) -> None:
        self._release_row(st)
        st.phase = Phase.DONE
        st.pages = []
        self.finished += 1
        if _TR.enabled:
            _TR.emit("sched", "finish", rid=st.rid, tokens=len(st.out))

    # ------------------------------------------------------------ preemption
    def pick_victim(self, exclude: Optional[SlotState] = None
                    ) -> Optional[SlotState]:
        """Newest running slot (LIFO — oldest work is never starved),
        preferring DECODE victims over mid-PREFILL ones."""
        cands = [s for s in self.running.values() if s is not exclude]
        if not cands:
            return None
        decode = [s for s in cands if s.phase is Phase.DECODE]
        pool = decode or cands
        return max(pool, key=lambda s: s.seq)

    def evict(self, st: SlotState) -> None:
        """Preempt ``st``: fold generated tokens into the prefix (greedy
        decode makes the continuation deterministic — output is unchanged)
        and requeue at the head.  Caller reclaims the pages."""
        self._release_row(st)
        if st.out:
            st.prefix = np.concatenate(
                [st.prefix, np.asarray(st.out, st.prefix.dtype)])
        st.prefill_pos = st.pos = 0
        st.pages = []
        st.keys = st.cache_plan = None   # prefix grew: keys are stale (the
        st.cached_pos = 0                # engine released the refs already)
        st.phase = Phase.EVICTED     # queued for re-admission; admit()
        st.evictions += 1            # moves it (back) to PREFILL
        self.evictions += 1
        self.waiting.appendleft(st)
        if _TR.enabled:
            _TR.emit("sched", "evict", rid=st.rid, n=st.evictions)

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        return {"waiting": len(self.waiting),
                "running": len(self.running),
                "admissions": self.admissions,
                "evictions": self.evictions,
                "finished": self.finished,
                "slot_cap": self.slot_cap,
                "admit_free_frac": round(self.admit_free_frac, 4)}


# ---------------------------------------------------------------------------
# Latency-feedback admission control (closing the arXiv:1905.10818 loop)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Knobs of :class:`LatencyFeedbackController` (all pure policy).

    A target set to 0 disables that sensor; with both disabled the
    controller never acts (equivalent to the static watermark)."""

    step_p99_target_ms: float = 0.0   # windowed p99 decode-step latency
    ttft_p99_target_ms: float = 0.0   # windowed p99 time-to-first-token
    period_s: float = 0.1             # update cadence (engine paces it)
    window_s: float = 1.0             # sensor window
    slices: int = 8                   # sub-windows per sensor window
    min_samples: int = 3              # sensor quorum before acting on it
    min_slots: int = 1                # cap floor (never wedged: >= 1)
    decrease: float = 0.5             # multiplicative cap decrease
    recover_after: int = 2            # consecutive healthy updates -> +1
    cooldown: int = 2                 # updates to sit out after a change
    probe_after: int = 8              # healthy updates at the ceiling
    #                                   before probing one slot above it
    watermark_step: float = 0.05      # additive free-frac move per change
    watermark_max: float = 0.5        # free-frac never exceeds this (< 1,
    #                                   so page admission is never wedged)


class LatencyFeedbackController:
    """AIMD admission control over the scheduler's runtime limits.

    State machine (the docs' decrease/recover/hysteresis contract)::

                      over target                 healthy x recover_after
        [STEADY] --------------------> [COOLDOWN] ----------------------.
           ^   cap *= decrease (>= min)   | sit out `cooldown` updates  |
           |   ceiling = cap_before - 1   v                             |
           |<----------------------- [STEADY] <--- cap += 1 (<= ceiling)
           |                                                            |
           '--- healthy x probe_after at the ceiling: ceiling += 1 <----'

    * **Multiplicative decrease** past the knee: one shrink per over-
      target observation, then a cooldown so the windows can drain the
      samples that triggered it (hysteresis — no flapping on one
      burst).
    * **Additive recovery**: after ``recover_after`` consecutive
      healthy updates the cap grows by one, but only up to the
      *ceiling* — one below where the knee was last seen.  The ceiling
      itself relaxes upward only after ``probe_after`` further healthy
      updates, so the controller converges near the knee instead of
      sawtoothing across it.
    * **Wedge-freedom** (the `controller-model` checker invariant):
      every transition clamps ``slot_cap >= min_slots >= 1`` and
      ``free_frac <= watermark_max < 1``, so there is no reachable
      state in which admission is permanently shut.

    The pure transition function is :meth:`step` (what the checker
    scenario and the seeded-sim test drive); :meth:`update` is the
    production wrapper that reads the windowed sensors.
    """

    def __init__(self, ccfg: ControllerConfig, *, max_slots: int,
                 free_frac: float = 0.0,
                 step_window=None, ttft_window=None):
        self.ccfg = ccfg
        self.max_slots = max_slots
        self.base_free_frac = min(free_frac, ccfg.watermark_max)
        self.slot_cap = max_slots
        self.free_frac = self.base_free_frac
        self.ceiling = max_slots
        self._step_w = step_window
        self._ttft_w = ttft_window
        self._healthy = 0
        self._cooldown = 0
        self.shrinks = 0
        self.grows = 0
        self.last_step_p99_ns = 0.0
        self.last_ttft_p99_ns = 0.0

    # ----------------------------------------------------------- transition
    def step(self, step_p99_ns: float, step_n: int,
             ttft_p99_ns: float, ttft_n: int) -> Optional[str]:
        """One control decision from raw sensor readings.  Returns
        ``"shrink"`` / ``"grow"`` when the limits changed, else None."""
        cc = self.ccfg
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        over = False
        if cc.step_p99_target_ms > 0 and step_n >= cc.min_samples:
            over |= step_p99_ns > cc.step_p99_target_ms * 1e6
        if cc.ttft_p99_target_ms > 0 and ttft_n >= cc.min_samples:
            over |= ttft_p99_ns > cc.ttft_p99_target_ms * 1e6
        if over:
            self._healthy = 0
            self._cooldown = cc.cooldown
            new_cap = max(cc.min_slots, int(self.slot_cap * cc.decrease))
            new_frac = min(cc.watermark_max,
                           self.free_frac + cc.watermark_step)
            # the knee is at or below the cap that tripped: remember it
            self.ceiling = max(cc.min_slots, self.slot_cap - 1)
            if new_cap < self.slot_cap or new_frac > self.free_frac:
                self.slot_cap = new_cap
                self.free_frac = new_frac
                self.shrinks += 1
                return "shrink"
            return None
        self._healthy += 1
        if self.slot_cap < self.ceiling:
            if self._healthy >= cc.recover_after:
                self._healthy = 0
                self._cooldown = cc.cooldown
                self.slot_cap = min(self.slot_cap + 1, self.ceiling)
                self.free_frac = max(self.base_free_frac,
                                     self.free_frac - cc.watermark_step)
                self.grows += 1
                return "grow"
        elif self.ceiling < self.max_slots \
                and self._healthy >= cc.probe_after:
            # sustained headroom at the ceiling: probe one slot above
            self._healthy = 0
            self._cooldown = cc.cooldown
            self.ceiling += 1
            self.slot_cap = min(self.slot_cap + 1, self.ceiling)
            self.free_frac = max(self.base_free_frac,
                                 self.free_frac - cc.watermark_step)
            self.grows += 1
            return "grow"
        return None

    # ----------------------------------------------------------- production
    def update(self, now_ns: Optional[int] = None) -> Optional[str]:
        """Read the windowed sensors and take one :meth:`step`.
        Aggregating (merges monitor cells) — the engine calls this at
        tick top level, never inside a lease window."""
        sp99 = sn = tp99 = tn = 0
        if self._step_w is not None:
            sp99 = self._step_w.quantile(0.99, now_ns)
            sn = self._step_w.count(now_ns)
        if self._ttft_w is not None:
            tp99 = self._ttft_w.quantile(0.99, now_ns)
            tn = self._ttft_w.count(now_ns)
        self.last_step_p99_ns = sp99
        self.last_ttft_p99_ns = tp99
        return self.step(sp99, sn, tp99, tn)
