"""Lock-free per-thread ring-buffer trace of typed events.

BRAVO is a *measured* trade-off — the adaptive ``N x revocation-cost``
rearm rule literally consumes the latencies the protocol produces — yet
until recently the repo threw most of its own timeline away: chaos failures
reported "token mismatch" with no record of the drain/park/scrub events
that led there.  This module is the event half of ``repro_torch.obs``: every
layer emits typed events (category + name + args) into a per-thread ring
buffer with monotonic-ns timestamps, and the merged timeline exports as
Chrome-trace/Perfetto JSON (:mod:`.chrome`) or a human-readable snapshot
(:func:`format_timeline`).

Design constraints (the overhead contract):

* **Disabled cost is one branch per site.**  ``Tracer.emit`` returns on
  the first line when ``self.enabled`` is False; nothing else is read,
  allocated or timed.  ``benchmarks/obs.py`` measures and gates this.
* **Enabled emit is lock-free.**  Each OS thread owns a private ring
  (created once, registered under a mutex held only at creation); the
  emit path is an index increment plus a tuple store into a
  pre-allocated list — no locks, no syscalls beyond ``monotonic_ns``.
  Wraparound overwrites the oldest events and counts drops; an emit can
  never block or fail.
* **Merging is off the hot path.**  ``snapshot()`` walks every ring
  under the registry mutex and sorts by ``(ts, tid, seq)`` — a total
  order that is deterministic for a given set of recorded events, no
  matter which thread calls it.

Event taxonomy (the ROADMAP standing constraint; new subsystems must
emit lifecycle events under one of these categories):

===========  ==============================================================
category     events
===========  ==============================================================
``req``      request lifecycle: ``submit``, ``admit``, ``prefill_chunk``,
             ``first_token`` (TTFT boundary), ``done``, ``evict``,
             ``defer`` — :func:`derive_requests` turns these into
             per-request TTFT/TPOT spans
``lock``     host + device lock protocol: ``fast`` / ``slow`` (reader
             publish path), ``revoke_begin`` / ``revoke_drain`` /
             ``revoke_timeout``, ``park`` / ``unpark``, ``lane_scrub``,
             ``gen_bump``, ``alloc`` / ``free``
``pool``     KV-page lifetime: ``alloc``, ``reclaim``, ``dedup_hit`` /
             ``dedup_miss``, ``cow_copy``, ``ref_release``,
             ``prefix_insert``, ``orphan_scrub``
``engine``   serving mechanisms: ``step_decode`` / ``step_prefill``
             (spans), ``swap_stage``, ``swap_begin``, ``swap_land``,
             ``swap_degrade``, ``swap_abandon``, ``worker_crash``,
             ``compact``
``sched``    pure-policy decisions: ``admit``, ``evict``, ``finish``,
             ``defer``, and the latency-feedback controller's
             ``ctrl_shrink`` / ``ctrl_grow`` (admission watermark and
             active-slot cap changes) + ``ctrl_state`` (periodic
             sample; exported as a Perfetto counter track)
``fault``    injected faults (``repro_torch.ft.faults``): ``inject`` with the
             fault name — every chaos failure carries its timeline
===========  ==============================================================
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

__all__ = ["Tracer", "TraceEvent", "format_timeline", "derive_requests",
           "CATEGORIES"]

CATEGORIES = ("req", "lock", "pool", "engine", "sched", "fault")


class TraceEvent(NamedTuple):
    ts_ns: int                  # monotonic_ns at emit
    cat: str                    # taxonomy category (see module docstring)
    name: str                   # event name within the category
    tid: int                    # OS thread ident of the emitter
    dur_ns: int                 # > 0 for spans, 0 for instants
    args: Optional[Dict[str, Any]]  # small payload (ints/strs), or None

    @property
    def key(self) -> str:
        return f"{self.cat}.{self.name}"


class _Ring:
    """One thread's event buffer: single writer (the owning thread), so
    the append path needs no lock.  ``idx`` only grows; the slot is
    ``idx & mask`` and anything older than ``idx - cap`` was dropped."""

    __slots__ = ("buf", "idx", "mask", "tid", "epoch")

    def __init__(self, cap: int, tid: int, epoch: int):
        self.buf: List[Any] = [None] * cap
        self.idx = 0
        self.mask = cap - 1
        self.tid = tid
        self.epoch = epoch

    def events(self) -> List[TraceEvent]:
        cap = self.mask + 1
        n = self.idx
        start = max(0, n - cap)
        out = []
        for seq in range(start, n):
            e = self.buf[seq & self.mask]
            if e is not None:
                out.append(e)
        return out

    @property
    def dropped(self) -> int:
        return max(0, self.idx - (self.mask + 1))


class Tracer:
    """The process-wide trace: per-thread rings behind one enable flag.

    ``capacity`` (per ring) is rounded up to a power of two so the hot
    path masks instead of modding.  ``clear()`` bumps an epoch; rings
    created before it are forgotten and threads lazily re-register —
    chaos runs call it between faults so each timeline stands alone."""

    def __init__(self, capacity: int = 8192):
        cap = 1
        while cap < max(capacity, 2):
            cap *= 2
        self.capacity = cap
        self.enabled = False
        self._mu = threading.Lock()
        self._rings: List[_Ring] = []
        self._local = threading.local()
        self._epoch = 0

    # ------------------------------------------------------------ lifecycle
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        """Forget every recorded event (new epoch; rings re-register)."""
        with self._mu:
            self._epoch += 1
            self._rings = []

    # ------------------------------------------------------------- emitting
    def _ring(self) -> _Ring:
        ring = _Ring(self.capacity, threading.get_ident(), self._epoch)
        with self._mu:
            ring.epoch = self._epoch   # re-read under the mutex: a clear()
            self._rings.append(ring)   # racing us must not orphan the ring
        self._local.ring = ring
        return ring

    def emit(self, cat: str, name: str, **args) -> None:
        """Record an instant event.  Disabled cost: this one branch."""
        if not self.enabled:
            return
        ring = getattr(self._local, "ring", None)
        if ring is None or ring.epoch != self._epoch:
            ring = self._ring()
        i = ring.idx
        ring.buf[i & ring.mask] = TraceEvent(
            time.monotonic_ns(), cat, name, ring.tid, 0, args or None)
        ring.idx = i + 1

    def emit_span(self, cat: str, name: str, t0_ns: int,
                  dur_ns: Optional[int] = None, **args) -> None:
        """Record a completed span that BEGAN at ``t0_ns`` (monotonic).
        ``dur_ns`` defaults to now - t0 — callers that already timed the
        work pass their own measurement so trace and metrics agree."""
        if not self.enabled:
            return
        if dur_ns is None:
            dur_ns = time.monotonic_ns() - t0_ns
        ring = getattr(self._local, "ring", None)
        if ring is None or ring.epoch != self._epoch:
            ring = self._ring()
        i = ring.idx
        ring.buf[i & ring.mask] = TraceEvent(
            t0_ns, cat, name, ring.tid, max(int(dur_ns), 1), args or None)
        ring.idx = i + 1

    class _Span:
        __slots__ = ("tr", "cat", "name", "args", "t0")

        def __init__(self, tr, cat, name, args):
            self.tr, self.cat, self.name, self.args = tr, cat, name, args

        def __enter__(self):
            self.t0 = time.monotonic_ns()
            return self

        def __exit__(self, *exc):
            self.tr.emit_span(self.cat, self.name, self.t0, **self.args)
            return False

    def span(self, cat: str, name: str, **args) -> "Tracer._Span":
        """``with tracer.span("engine", "swap"): ...`` — emits one
        complete span on exit (even when disabled the context manager is
        cheap; the emit itself is branch-gated)."""
        return Tracer._Span(self, cat, name, args)

    # ------------------------------------------------------------- reading
    def snapshot(self) -> List[TraceEvent]:
        """Merged, time-ordered view of every ring (sorted by
        ``(ts, tid, seq)`` — deterministic for a given event set)."""
        with self._mu:
            rings = list(self._rings)
        seq: List[TraceEvent] = []
        for r in rings:
            seq.extend(r.events())
        # Python's sort is stable; ring order within a thread is already
        # chronological, so (ts, tid) alone yields a total order that is
        # identical no matter which thread merges
        seq.sort(key=lambda e: (e.ts_ns, e.tid))
        return seq

    def dropped(self) -> int:
        with self._mu:
            return sum(r.dropped for r in self._rings)


# ---------------------------------------------------------------------------
# Derived views
# ---------------------------------------------------------------------------


def derive_requests(events: List[TraceEvent]) -> Dict[int, Dict[str, Any]]:
    """Per-request lifecycle spans from the ``req`` event stream.

    Returns ``{rid: {...}}`` with the admit/first-token/done timestamps
    plus the derived latencies the SLO work needs as sensors:

    * ``ttft_ns``  — first generated token minus admission (time to
      first token; None until both ends exist);
    * ``tpot_ns``  — (done - first token) / (tokens - 1), the mean
      time per output token across the decode phase;
    * ``evictions`` / ``preemptions`` / ``prefill_chunks`` /
      ``cached_tokens`` — how the request actually moved through the
      FSM (``preemptions`` == ``evictions``; the SLO report uses the
      scheduling name).

    Preemption safety: a LIFO-preempted request re-prefills after
    requeue and emits ``admit`` / ``first_token`` again — both are
    derived from the FIRST occurrence only, so TTFT always measures
    the original admission to the original first token, never the
    (shorter) re-prefill of an already-generated prefix.
    """
    reqs: Dict[int, Dict[str, Any]] = {}

    def slot(rid) -> Dict[str, Any]:
        return reqs.setdefault(int(rid), {
            "submit_ts": None, "admit_ts": None, "first_token_ts": None,
            "done_ts": None, "tokens": 0, "evictions": 0, "preemptions": 0,
            "prefill_chunks": 0, "cached_tokens": 0,
            "ttft_ns": None, "tpot_ns": None})

    for e in events:
        if e.cat != "req" or not e.args or "rid" not in e.args:
            continue
        r = slot(e.args["rid"])
        if e.name == "submit" and r["submit_ts"] is None:
            r["submit_ts"] = e.ts_ns
        elif e.name == "admit":
            if r["admit_ts"] is None:       # re-admissions keep the first
                r["admit_ts"] = e.ts_ns
            r["cached_tokens"] = max(r["cached_tokens"],
                                     int(e.args.get("cached", 0)))
        elif e.name == "prefill_chunk":
            r["prefill_chunks"] += 1
        elif e.name == "first_token" and r["first_token_ts"] is None:
            r["first_token_ts"] = e.ts_ns
        elif e.name == "done":
            r["done_ts"] = e.ts_ns
            r["tokens"] = int(e.args.get("tokens", r["tokens"]))
        elif e.name == "evict":
            r["evictions"] += 1
            r["preemptions"] += 1
    for r in reqs.values():
        if r["admit_ts"] is not None and r["first_token_ts"] is not None:
            r["ttft_ns"] = r["first_token_ts"] - r["admit_ts"]
        if (r["first_token_ts"] is not None and r["done_ts"] is not None
                and r["tokens"] > 1):
            r["tpot_ns"] = (r["done_ts"] - r["first_token_ts"]) \
                // (r["tokens"] - 1)
    return reqs


def format_timeline(events: List[TraceEvent], limit: int = 0) -> str:
    """Human-readable timeline (the chaos-failure dump): one line per
    event, timestamps relative to the first, spans annotated with their
    duration.  ``limit`` > 0 keeps only the LAST ``limit`` events (the
    tail leading up to a failure)."""
    if not events:
        return "(no trace events recorded)"
    if limit and len(events) > limit:
        events = events[-limit:]
    t0 = events[0].ts_ns
    lines = []
    for e in events:
        rel_ms = (e.ts_ns - t0) / 1e6
        extra = ""
        if e.dur_ns:
            extra = f" dur={e.dur_ns / 1e6:.3f}ms"
        if e.args:
            kv = " ".join(f"{k}={v}" for k, v in sorted(e.args.items()))
            extra += f" {kv}"
        lines.append(f"  t+{rel_ms:10.3f}ms [tid {e.tid % 100000:>5}] "
                     f"{e.cat}.{e.name}{extra}")
    return "\n".join(lines)
