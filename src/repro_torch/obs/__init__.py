"""``repro_torch.obs`` — the unified low-overhead observability layer.

Three pieces, one contract:

* :mod:`.trace` — lock-free per-thread ring-buffer trace of typed
  events (request lifecycle, lock protocol, pool lifetime, engine ops,
  injected faults) with monotonic timestamps; exportable as
  Chrome-trace/Perfetto JSON (:mod:`.chrome`) or a human-readable
  timeline.
* :mod:`.metrics` — registry of counters / gauges / log-bucket
  histograms that replaces the scattered stats dicts (engine, pool,
  registry) with one namespace per serving plane.
* :mod:`.slo` — the SLO plane on top: windowed percentile
  monitors (p50/p99 over the last W seconds, O(1) per sample), per-
  class :class:`~.slo.SLOTarget` contracts, and the
  :class:`~.slo.SLOReport` attainment fold the load harness and the
  latency-feedback admission controller consume.
* the **overhead contract** — tracing disabled costs ONE branch per
  emit site; device-side counters are folded as dispatch-only adds and
  harvested only at control-event boundaries.  ``benchmarks/obs.py``
  measures both and gates them in CI.

The process-wide tracer lives here (``TRACER``): events from every
subsystem merge into one timeline, which is what makes a chaos failure
replayable.  Metrics registries are per-owner (the engine shares one
with its lock registry and KV pool) so tests and co-resident engines
never contaminate each other's counters.
"""

from .chrome import COUNTER_EVENTS  # noqa: F401
from .chrome import dumps as chrome_dumps  # noqa: F401
from .chrome import to_chrome, validate as validate_chrome  # noqa: F401
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,  # noqa: F401
                      default_metrics)
from .slo import SLOReport, SLOTarget, WindowedHistogram  # noqa: F401
from .trace import (CATEGORIES, TraceEvent, Tracer,  # noqa: F401
                    derive_requests, format_timeline)

__all__ = ["TRACER", "tracer", "enable", "disable", "clear", "snapshot",
           "Tracer", "TraceEvent", "derive_requests", "format_timeline",
           "CATEGORIES", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "default_metrics", "to_chrome",
           "chrome_dumps", "validate_chrome", "COUNTER_EVENTS",
           "WindowedHistogram", "SLOTarget", "SLOReport"]

#: The process-wide trace.  Subsystems cache this at import and gate
#: every emit on ``TRACER.enabled`` — one branch per site when off.
TRACER = Tracer()


def tracer() -> Tracer:
    return TRACER


def enable() -> None:
    TRACER.enable()


def disable() -> None:
    TRACER.disable()


def clear() -> None:
    TRACER.clear()


def snapshot():
    return TRACER.snapshot()
