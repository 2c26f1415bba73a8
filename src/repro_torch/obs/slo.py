"""SLO plane: windowed percentile monitors, targets, attainment reports.

:mod:`.metrics` histograms answer "what was p99 *since the process
started*" — the right shape for a bench record, the wrong shape for a
feedback controller, which must react to the last few seconds and
forget a burst once it has drained.  This module adds the time axis:

* :class:`WindowedHistogram` — a ring of log-bucket histogram
  *slices* (same 512-bucket layout as :class:`.metrics.Histogram`,
  via :func:`.metrics.bucket_index`).  Each observe lands in the slice
  owned by ``now // slice_ns``; a slice is lazily zeroed the first
  time a *new* period touches its ring slot, so rotation costs O(512)
  once per slice per thread and the steady-state observe is O(1) and
  lock-free (per-thread cells, single-writer each, exactly the
  diffusion discipline of the base histogram).  ``quantile()`` merges
  only the slices whose period falls inside the last window — an
  aggregating read, off the hot path by the same
  ``obs-in-lease-window`` contract as the base registry.
* :class:`SLOTarget` — one serving class's latency contract (TTFT /
  TPOT / step-latency targets, in ms; 0 disables a clause).
* :class:`SLOReport` — folds :func:`repro_torch.obs.trace.derive_requests`
  output plus a ``{rid: (tenant, class)}`` map into per-class and
  per-tenant attainment (fraction of finished requests meeting every
  enabled clause of their class target), with p50/p99 TTFT/TPOT per
  bucket and the prefix-cache collision/pages-saved counters the
  load harness surfaces.

Everything here is stdlib-only (``repro_torch.obs`` must import without
jax); numpy percentiles in reports are replaced by the same
rank-interpolated walk the base histogram uses.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from .metrics import N_BUCKETS, bucket_bounds, bucket_index

__all__ = ["WindowedHistogram", "SLOTarget", "SLOReport"]


class WindowedHistogram:
    """p50/p99 over the last ``window_s`` seconds, O(1) per sample.

    The window is cut into ``slices`` sub-windows; the ring holds one
    extra so the oldest *complete* slice is still mergeable while the
    newest fills (coverage is between ``window_s`` and
    ``window_s * (1 + 1/slices)``, biased old — the controller wants
    "recent including right now", not a calendar boundary).

    ``now_ns`` is injectable on every call so tests (and the checker's
    controller model) drive a fake clock; production callers omit it
    and get ``time.monotonic_ns()``.
    """

    def __init__(self, name: str, window_s: float = 2.0, slices: int = 8):
        if slices < 1:
            raise ValueError("slices must be >= 1")
        self.name = name
        self.window_s = float(window_s)
        self.slices = slices
        self.slice_ns = max(int(window_s * 1e9 / slices), 1)
        self._ring = slices + 1
        self._mu = threading.Lock()
        # cell: per ring slot [period_id, buckets[512], count, total]
        self._cells: List[List[list]] = []
        self._local = threading.local()

    def _cell(self) -> List[list]:
        cell = getattr(self._local, "cell", None)
        if cell is None:
            cell = [[-1, [0] * N_BUCKETS, 0, 0] for _ in range(self._ring)]
            with self._mu:
                self._cells.append(cell)
            self._local.cell = cell
        return cell

    def observe(self, v, now_ns: Optional[int] = None) -> None:
        """Record one sample (lock-free; amortized O(1) — a ring slot is
        rezeroed only when a new period first touches it)."""
        if now_ns is None:
            now_ns = time.monotonic_ns()
        cell = self._cell()
        pid = now_ns // self.slice_ns
        ent = cell[pid % self._ring]
        if ent[0] != pid:               # slice rotated: reclaim the slot
            ent[0] = pid
            ent[1] = [0] * N_BUCKETS
            ent[2] = 0
            ent[3] = 0
        v = int(v)
        ent[1][bucket_index(v)] += 1
        ent[2] += 1
        ent[3] += v

    # --------------------------------------------------------- aggregation
    def _merged(self, now_ns: Optional[int] = None):
        """Merge every in-window slice of every thread (aggregating read —
        never inside a lease window)."""
        if now_ns is None:
            now_ns = time.monotonic_ns()
        cur = now_ns // self.slice_ns
        oldest = cur - self.slices      # inclusive: last `slices`+current
        with self._mu:
            cells = list(self._cells)
        buckets = [0] * N_BUCKETS
        count = total = 0
        for cell in cells:
            for pid, b, c, t in cell:
                if pid < oldest or pid > cur or c == 0:
                    continue
                count += c
                total += t
                for i, n in enumerate(b):
                    if n:
                        buckets[i] += n
        return buckets, count, total

    def count(self, now_ns: Optional[int] = None) -> int:
        return self._merged(now_ns)[1]

    def mean(self, now_ns: Optional[int] = None) -> float:
        _, count, total = self._merged(now_ns)
        return total / count if count else 0.0

    def quantile(self, q: float, now_ns: Optional[int] = None) -> float:
        """Approximate in-window q-quantile (same ±12.5% relative-error
        contract as :meth:`.metrics.Histogram.quantile`)."""
        buckets, count, _ = self._merged(now_ns)
        return _bucket_quantile(buckets, count, q)

    def window_snapshot(self, now_ns: Optional[int] = None
                        ) -> Dict[str, float]:
        buckets, count, total = self._merged(now_ns)
        return {"count": count,
                "mean": round(total / count, 1) if count else 0.0,
                "p50": round(_bucket_quantile(buckets, count, 0.50), 1),
                "p99": round(_bucket_quantile(buckets, count, 0.99), 1),
                "window_s": self.window_s}


def _bucket_quantile(buckets: List[int], count: int, q: float) -> float:
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


def _percentile(xs: List[float], q: float) -> float:
    """Exact linear-interpolated percentile (numpy semantics, stdlib)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    rank = q * (len(s) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (rank - lo)


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """One serving class's latency contract.  A clause set to 0 is
    disabled (not asserted, not counted against attainment)."""

    name: str = "default"
    ttft_ms: float = 0.0       # admission -> first generated token
    tpot_ms: float = 0.0       # mean per-token decode latency
    step_ms: float = 0.0       # engine step-latency target (controller
    #                            sensor, not a per-request clause)

    def met(self, ttft_ns: Optional[int], tpot_ns: Optional[int]) -> bool:
        """Did a finished request meet every enabled clause?  A missing
        measurement for an enabled clause counts as a miss (a request
        that never produced a first token did not meet its TTFT)."""
        if self.ttft_ms > 0:
            if ttft_ns is None or ttft_ns > self.ttft_ms * 1e6:
                return False
        if self.tpot_ms > 0 and tpot_ns is not None \
                and tpot_ns > self.tpot_ms * 1e6:
            return False
        return True


def _bucket_stats(rows: List[Dict[str, Any]], target: Optional[SLOTarget]
                  ) -> Dict[str, Any]:
    ttfts = [r["ttft_ns"] / 1e6 for r in rows if r["ttft_ns"] is not None]
    tpots = [r["tpot_ns"] / 1e6 for r in rows if r["tpot_ns"] is not None]
    done = [r for r in rows if r["done_ts"] is not None]
    out: Dict[str, Any] = {
        "requests": len(rows),
        "done": len(done),
        "preemptions": sum(r.get("preemptions", 0) for r in rows),
        "ttft_p50_ms": round(_percentile(ttfts, 0.50), 3),
        "ttft_p99_ms": round(_percentile(ttfts, 0.99), 3),
        "tpot_p50_ms": round(_percentile(tpots, 0.50), 3),
        "tpot_p99_ms": round(_percentile(tpots, 0.99), 3),
    }
    if target is not None:
        met = sum(1 for r in done
                  if target.met(r["ttft_ns"], r["tpot_ns"]))
        out["attained"] = met
        out["attainment"] = round(met / len(done), 4) if done else 0.0
    return out


@dataclasses.dataclass
class SLOReport:
    """Attainment fold of a trace: overall, per class, per tenant.

    ``classes`` maps rid -> ``(tenant, class)``; requests absent from
    the map land in ``("?", "default")``.  ``pool`` carries the prefix
    cache's effectiveness counters (collision rate is the set-assoc
    rework's baseline)."""

    overall: Dict[str, Any]
    per_class: Dict[str, Dict[str, Any]]
    per_tenant: Dict[str, Dict[str, Any]]
    pool: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_requests(cls, reqs: Dict[int, Dict[str, Any]],
                      classes: Optional[Dict[int, Tuple[str, str]]] = None,
                      targets: Optional[Dict[str, SLOTarget]] = None,
                      pool_stats: Optional[Dict[str, Any]] = None,
                      pages_saved: int = 0) -> "SLOReport":
        classes = classes or {}
        targets = targets or {}
        by_cls: Dict[str, List[Dict[str, Any]]] = {}
        by_tenant: Dict[str, List[Dict[str, Any]]] = {}
        rows = list(reqs.values())
        for rid, r in reqs.items():
            tenant, kls = classes.get(rid, ("?", "default"))
            by_cls.setdefault(kls, []).append(r)
            by_tenant.setdefault(tenant, []).append(r)
        default_t = targets.get("default")
        overall = _bucket_stats(rows, default_t)
        per_class = {k: _bucket_stats(v, targets.get(k, default_t))
                     for k, v in sorted(by_cls.items())}
        if "attainment" not in overall:
            # no blanket default target: overall attainment aggregates
            # the per-class folds (classes without a target excluded)
            att = sum(c["attained"] for c in per_class.values()
                      if "attained" in c)
            dn = sum(c["done"] for c in per_class.values()
                     if "attained" in c)
            overall["attained"] = att
            overall["attainment"] = round(att / dn, 4) if dn else 0.0
        per_tenant = {k: _bucket_stats(v, None)
                      for k, v in sorted(by_tenant.items())}
        pool: Dict[str, Any] = {}
        if pool_stats is not None:
            lookups = int(pool_stats.get("prefix_lookups", 0))
            colls = int(pool_stats.get("prefix_collisions", 0))
            pool = {"prefix_lookups": lookups,
                    "prefix_hits": int(pool_stats.get("prefix_hits", 0)),
                    "prefix_collisions": colls,
                    "collision_rate": round(colls / lookups, 4)
                    if lookups else 0.0,
                    "pages_saved": int(pages_saved)}
        return cls(overall=overall, per_class=per_class,
                   per_tenant=per_tenant, pool=pool)

    def to_dict(self) -> Dict[str, Any]:
        return {"overall": self.overall, "per_class": self.per_class,
                "per_tenant": self.per_tenant, "pool": self.pool}
