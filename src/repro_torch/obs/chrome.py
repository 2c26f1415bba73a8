"""Chrome-trace / Perfetto JSON export of a merged event snapshot.

The format is the Trace Event Format consumed by ``chrome://tracing``
and https://ui.perfetto.dev: ``{"traceEvents": [...]}`` where each
event has ``name`` / ``ph`` / ``ts`` (microseconds) / ``pid`` /
``tid``.  Three phases are used:

* ``X`` (complete) — spans emitted via ``Tracer.emit_span`` (decode /
  prefill steps, revocation drains, hot-swap attempts).  Perfetto nests
  same-tid ``X`` events whose times contain each other, so a swap
  attempt span visually contains the registry drain it triggered.
* ``i`` (instant) — point events (lock publishes, pool allocs, faults).
* ``b`` / ``e`` (async) — per-request lifecycle spans DERIVED from the
  ``req`` stream (admit -> done), on their own ``id`` so requests that
  span threads and interleave still render as one track each.
* ``C`` (counter) — sampled numeric tracks.  Events listed in
  ``COUNTER_EVENTS`` (the latency-feedback controller's periodic
  ``sched.ctrl_state``: admission watermark, active slots / slot cap,
  windowed p99 step latency) export each numeric arg as one counter
  series, so every shrink/grow decision lines up visually with the
  latency curve it reacted to.

:func:`validate` re-checks an export against the schema (required keys
per phase, numeric timestamps, balanced async begin/end per id) — the
round-trip test and the ``benchmarks/obs.py`` acceptance gate both run
it, so "loads in Perfetto" is checked structurally in CI, not by hand.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from .trace import TraceEvent, derive_requests

__all__ = ["to_chrome", "validate", "dumps", "COUNTER_EVENTS"]

_REQUIRED = {"name", "ph", "ts", "pid", "tid"}

#: (cat, name) instants exported as Perfetto counter tracks (``C``
#: phase): each numeric arg becomes one series under the event name.
COUNTER_EVENTS = {("sched", "ctrl_state"), ("pool", "hbm_bytes")}


def to_chrome(events: List[TraceEvent], pid: int = 1) -> Dict[str, Any]:
    """Convert a ``Tracer.snapshot()`` into a Trace Event Format dict."""
    out: List[Dict[str, Any]] = []
    for e in events:
        rec: Dict[str, Any] = {
            "name": f"{e.cat}.{e.name}",
            "cat": e.cat,
            "ts": e.ts_ns / 1e3,           # Chrome trace wants microseconds
            "pid": pid,
            "tid": e.tid,
        }
        if e.args:
            rec["args"] = {k: (v if isinstance(v, (int, float, str, bool))
                               else str(v)) for k, v in e.args.items()}
        if e.dur_ns > 0:
            rec["ph"] = "X"
            rec["dur"] = e.dur_ns / 1e3
        elif (e.cat, e.name) in COUNTER_EVENTS and e.args:
            rec["ph"] = "C"                # counter sample: numeric series
            rec["tid"] = 0                 # one shared track per name
            rec["args"] = {k: v for k, v in rec["args"].items()
                           if isinstance(v, (int, float))
                           and not isinstance(v, bool)}
            if not rec["args"]:
                continue                   # nothing numeric to plot
        else:
            rec["ph"] = "i"
            rec["s"] = "t"                 # instant scoped to its thread
        out.append(rec)
    # derived per-request async spans: one track per rid, admit -> done
    # (or -> last event seen, for requests still in flight at snapshot)
    reqs = derive_requests(events)
    for rid, r in sorted(reqs.items()):
        if r["admit_ts"] is None:
            continue
        end = r["done_ts"]
        if end is None:
            end = max(t for t in (r["admit_ts"], r["first_token_ts"])
                      if t is not None)
        args = {"rid": rid, "tokens": r["tokens"],
                "evictions": r["evictions"]}
        if r["ttft_ns"] is not None:
            args["ttft_us"] = round(r["ttft_ns"] / 1e3, 1)
        if r["tpot_ns"] is not None:
            args["tpot_us"] = round(r["tpot_ns"] / 1e3, 1)
        base = {"name": f"req {rid}", "cat": "req", "pid": pid,
                "tid": 0, "id": rid}
        out.append({**base, "ph": "b", "ts": r["admit_ts"] / 1e3,
                    "args": args})
        out.append({**base, "ph": "e", "ts": end / 1e3})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def dumps(events: List[TraceEvent], pid: int = 1) -> str:
    return json.dumps(to_chrome(events, pid=pid))


def validate(obj: Any) -> List[str]:
    """Structural schema check of an export (or its ``json.loads``):
    returns a list of problems, empty when the trace is well-formed."""
    errs: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be a dict with a 'traceEvents' list"]
    evs = obj["traceEvents"]
    if not isinstance(evs, list):
        return ["'traceEvents' is not a list"]
    async_open: Dict[Any, int] = {}
    for i, e in enumerate(evs):
        if not isinstance(e, dict):
            errs.append(f"event {i}: not an object")
            continue
        missing = _REQUIRED - set(e)
        if missing:
            errs.append(f"event {i}: missing keys {sorted(missing)}")
            continue
        if not isinstance(e["ts"], (int, float)):
            errs.append(f"event {i}: non-numeric ts {e['ts']!r}")
        ph = e["ph"]
        if ph == "X":
            if not isinstance(e.get("dur"), (int, float)) or e["dur"] < 0:
                errs.append(f"event {i}: X phase needs dur >= 0")
        elif ph == "C":
            args = e.get("args")
            if not isinstance(args, dict) or not args:
                errs.append(f"event {i}: C phase needs a non-empty args "
                            f"dict of series values")
            elif not all(isinstance(v, (int, float))
                         and not isinstance(v, bool)
                         for v in args.values()):
                errs.append(f"event {i}: C phase args must be numeric")
        elif ph in ("b", "e"):
            if "id" not in e:
                errs.append(f"event {i}: async {ph} needs an id")
            else:
                k = (e["cat"], e["id"])
                async_open[k] = async_open.get(k, 0) + (1 if ph == "b"
                                                        else -1)
                if async_open[k] < 0:
                    errs.append(f"event {i}: async end before begin "
                                f"(id {e['id']})")
        elif ph != "i":
            errs.append(f"event {i}: unknown phase {ph!r}")
    for (cat, i_d), n in async_open.items():
        if n != 0:
            errs.append(f"async id {i_d} ({cat}): {n} unmatched begin(s)")
    return errs
