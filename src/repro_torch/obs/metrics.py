"""Metrics registry: counters, gauges and log-bucket histograms.

The write path follows the same diffusion discipline as the trace rings
(and as BRAVO itself — spread cheap per-thread state wide, pay the
aggregation cost only on the rare read): each :class:`Counter` and
:class:`Histogram` keeps a private cell per OS thread, so an increment
is a plain list-element add with no lock and no contended cache line.
``value`` / ``quantile`` / ``snapshot`` merge the cells under a small
mutex held only against cell *creation* — reads are off the hot path by
contract (the ``obs-in-lease-window`` source-lint enforces exactly
this: emits inside a lease window, aggregation outside).

Histograms are log-bucketed: exact below 16, then 8 sub-buckets per
octave (bucket width 1/8 of the value), 512 buckets total — enough for
any ns-scale latency while bounding the quantile's relative error to
~±12.5% of the true value (``tests/test_obs.py`` checks this against a
numpy reference).  That resolution is the point: the registry's
adaptive ``N x revocation-cost`` rearm rule and the ROADMAP's
latency-feedback admission loop both consume these histograms as
sensors, and a log bucket is the cheapest structure whose error is
relative, not absolute.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "bucket_index", "bucket_bounds", "N_BUCKETS"]

N_BUCKETS = 512     # exact to 16, then 8 sub-buckets/octave up to 2^63


def bucket_index(v: int) -> int:
    """Log-bucket index for a non-negative int (values < 16 are exact;
    above, the top 3 bits below the MSB pick the sub-bucket)."""
    if v < 16:
        return v if v > 0 else 0
    e = v.bit_length() - 1          # 2^e <= v < 2^(e+1), e >= 4
    sub = (v >> (e - 3)) & 7
    return 8 * e - 16 + sub


def bucket_bounds(idx: int) -> tuple:
    """Inclusive-lower / exclusive-upper value bounds of bucket ``idx``."""
    if idx < 16:
        return idx, idx + 1
    e = (idx + 16) // 8
    sub = (idx + 16) % 8
    lo = (8 + sub) << (e - 3)
    return lo, lo + (1 << (e - 3))


class Counter:
    """Monotonic counter; per-thread cells make ``add`` lock-free and
    exact (each cell has a single writer)."""

    def __init__(self, name: str):
        self.name = name
        self._mu = threading.Lock()
        self._cells: List[List[int]] = []
        self._local = threading.local()

    def add(self, n: int = 1) -> None:
        cell = getattr(self._local, "cell", None)
        if cell is None:
            cell = [0]
            with self._mu:
                self._cells.append(cell)
            self._local.cell = cell
        cell[0] += n

    @property
    def value(self) -> int:
        with self._mu:
            return sum(c[0] for c in self._cells)


class Gauge:
    """Last-writer-wins scalar (a single slot store is atomic enough
    under the GIL; gauges are levels, not ledgers)."""

    def __init__(self, name: str):
        self.name = name
        self._v: float = 0

    def set(self, v) -> None:
        self._v = v

    @property
    def value(self):
        return self._v


class Histogram:
    """Log-bucket histogram of non-negative ints (latencies in ns,
    queue depths, page counts).  ``observe`` is lock-free per thread;
    quantiles merge the cells and interpolate inside the bucket."""

    def __init__(self, name: str):
        self.name = name
        self._mu = threading.Lock()
        self._cells: List[list] = []      # [buckets[512], count, total]
        self._local = threading.local()

    def observe(self, v) -> None:
        cell = getattr(self._local, "cell", None)
        if cell is None:
            cell = [[0] * N_BUCKETS, 0, 0]
            with self._mu:
                self._cells.append(cell)
            self._local.cell = cell
        v = int(v)
        cell[0][bucket_index(v)] += 1
        cell[1] += 1
        cell[2] += v

    def _merged(self):
        with self._mu:
            cells = list(self._cells)
        buckets = [0] * N_BUCKETS
        count = total = 0
        for b, c, t in cells:
            count += c
            total += t
            for i, n in enumerate(b):
                if n:
                    buckets[i] += n
        return buckets, count, total

    @property
    def count(self) -> int:
        return self._merged()[1]

    @property
    def mean(self) -> float:
        _, count, total = self._merged()
        return total / count if count else 0.0

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (0 <= q <= 1): the value at rank
        ``q * (count - 1)``, linearly interpolated within its bucket."""
        buckets, count, _ = self._merged()
        if count == 0:
            return 0.0
        rank = q * (count - 1)
        seen = 0
        for i, n in enumerate(buckets):
            if n == 0:
                continue
            if seen + n > rank:
                lo, hi = bucket_bounds(i)
                frac = (rank - seen + 0.5) / n
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += n
        return float(bucket_bounds(N_BUCKETS - 1)[1])

    def reset(self) -> None:
        """Drop recorded samples (cells stay registered; safe to call
        from any thread — concurrent observes may land on either side)."""
        with self._mu:
            for cell in self._cells:
                cell[0] = [0] * N_BUCKETS
                cell[1] = 0
                cell[2] = 0


class MetricsRegistry:
    """Named metrics, one instance per subsystem owner (the engine makes
    one and shares it with its registry + pool so ``snapshot()`` is the
    whole serving plane; standalone locks/pools default to a private
    one — no cross-test contamination)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            with self._mu:
                m = self._metrics.get(name)
                if m is None:
                    m = cls(name)
                    self._metrics[name] = m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def windowed(self, name: str, window_s: float = 2.0, slices: int = 8):
        """A :class:`repro_torch.obs.slo.WindowedHistogram` (p50/p99 over the
        last ``window_s`` seconds — the latency-feedback controller's
        sensor shape).  Window parameters apply on first registration;
        later callers get the existing monitor regardless of arguments
        (same idempotence as the other accessors)."""
        from .slo import WindowedHistogram   # circular: slo uses buckets
        m = self._metrics.get(name)
        if m is None:
            with self._mu:
                m = self._metrics.get(name)
                if m is None:
                    m = WindowedHistogram(name, window_s=window_s,
                                          slices=slices)
                    self._metrics[name] = m
        if not isinstance(m, WindowedHistogram):
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(m).__name__}, requested WindowedHistogram")
        return m

    def snapshot(self) -> Dict[str, object]:
        """Flat read of every metric: counters/gauges as scalars,
        histograms as ``{count, mean, p50, p90, p99}`` dicts, windowed
        monitors as their in-window ``{count, mean, p50, p99}``.
        Aggregating — off the hot path (never inside a lease window)."""
        with self._mu:
            items = sorted(self._metrics.items())
        out: Dict[str, object] = {}
        for name, m in items:
            if isinstance(m, Histogram):
                out[name] = {"count": m.count,
                             "mean": round(m.mean, 1),
                             "p50": round(m.quantile(0.50), 1),
                             "p90": round(m.quantile(0.90), 1),
                             "p99": round(m.quantile(0.99), 1)}
            elif hasattr(m, "window_snapshot"):
                out[name] = m.window_snapshot()
            else:
                out[name] = m.value
        return out


_default: Optional[MetricsRegistry] = None
_default_mu = threading.Lock()


def default_metrics() -> MetricsRegistry:
    """Process-wide fallback registry for subsystems constructed without
    an owner (standalone scripts, examples)."""
    global _default
    if _default is None:
        with _default_mu:
            if _default is None:
                _default = MetricsRegistry()
    return _default
