"""Trace-driven load generator: the million-user harness's front end.

Benchmarks so far replayed a handful of hand-rolled prompts; this
module generates *traffic* — deterministic, seeded traces with the
shapes production serving actually sees (ROADMAP "million-user load
harness" item):

* **Bursty + diurnal arrivals.**  Requests arrive by a thinned
  non-homogeneous Poisson process: a base rate modulated by a slow
  sinusoidal "diurnal" curve and a square-wave burst (``burst_factor``
  x for ``burst_duty`` of every ``burst_period_s``).  Bursts are what
  saturate a static admission watermark; the diurnal curve gives the
  latency-feedback controller headroom to recover into.
* **Multi-tenant class mixes.**  Each request draws a
  :class:`TenantClass` (tenant name, class name, admission priority,
  per-class :class:`~repro_torch.obs.slo.SLOTarget`) by configured weight —
  the scheduler's per-class priority and the SLO report's attainment
  folds both key off these labels.
* **Zipf-shared system prompts.**  A request's prompt is a shared
  system prefix (rank drawn Zipf(``zipf_s``) over
  ``n_system_prompts``, token content seeded by rank) followed by a
  unique suffix — the realistic duplication pattern that exercises the
  prefix cache (and its direct-mapped collision counter).
* **Long-tail lengths.**  Suffix and decode lengths are lognormal,
  clipped to the engine's ``max_seq`` budget.

``generate_trace(cfg)`` is pure (same cfg -> byte-identical trace);
:func:`replay` submits the trace against a live engine with real
inter-arrival gaps (optionally time-scaled) and folds the run's trace
events + pool counters into an :class:`~repro_torch.obs.slo.SLOReport`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..obs import TRACER as _TR
from ..obs import derive_requests
from ..obs.slo import SLOReport, SLOTarget

__all__ = ["TenantClass", "LoadgenConfig", "TraceRequest", "LoadTrace",
           "generate_trace", "replay", "fold_report"]


@dataclasses.dataclass(frozen=True)
class TenantClass:
    """One slice of the traffic mix."""
    tenant: str
    cls: str
    weight: float = 1.0
    priority: int = 0
    target: SLOTarget = dataclasses.field(
        default_factory=lambda: SLOTarget())


@dataclasses.dataclass(frozen=True)
class LoadgenConfig:
    """Seeded description of a traffic trace (pure data; the same
    config always generates the same trace)."""

    duration_s: float = 10.0
    base_rps: float = 4.0             # mean arrival rate outside bursts
    burst_factor: float = 4.0         # rate multiplier inside a burst
    burst_period_s: float = 4.0       # one burst per period
    burst_duty: float = 0.25          # fraction of the period bursting
    diurnal_amplitude: float = 0.0    # 0..1 sinusoidal modulation depth
    diurnal_period_s: float = 60.0
    tenants: Tuple[TenantClass, ...] = (
        TenantClass("tenant-a", "interactive", weight=2.0, priority=1,
                    target=SLOTarget("interactive", ttft_ms=500.0)),
        TenantClass("tenant-b", "batch", weight=1.0, priority=0,
                    target=SLOTarget("batch")),
    )
    # prompt shape
    vocab: int = 1000
    n_system_prompts: int = 8         # distinct shared prefixes
    zipf_s: float = 1.2               # sharing skew (higher = more shared)
    system_prompt_len: int = 16       # tokens (page-aligned helps dedup)
    suffix_len_median: float = 8.0    # lognormal median of unique suffix
    suffix_len_sigma: float = 0.6     # lognormal shape (long tail)
    max_new_median: float = 6.0       # lognormal median decode length
    max_new_sigma: float = 0.5
    max_seq: int = 64                 # prompt + decode budget (engine's)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    rid: int
    at_s: float                       # offset from trace start
    tenant: str
    cls: str
    priority: int
    sys_id: int                       # which shared system prompt
    prompt: np.ndarray                # (S,) int32
    max_new: int


@dataclasses.dataclass
class LoadTrace:
    cfg: LoadgenConfig
    requests: List[TraceRequest]

    @property
    def classes(self) -> Dict[int, Tuple[str, str]]:
        """rid -> (tenant, class), the SLOReport fold's key."""
        return {r.rid: (r.tenant, r.cls) for r in self.requests}

    @property
    def targets(self) -> Dict[str, SLOTarget]:
        return {t.cls: t.target for t in self.cfg.tenants}


def _rate(cfg: LoadgenConfig, t: float) -> float:
    """Arrival rate at trace offset ``t`` (the lambda(t) the thinning
    samples against)."""
    r = cfg.base_rps
    if cfg.diurnal_amplitude > 0:
        r *= 1.0 + cfg.diurnal_amplitude * np.sin(
            2 * np.pi * t / cfg.diurnal_period_s)
    if cfg.burst_factor > 1 and cfg.burst_duty > 0:
        phase = (t % cfg.burst_period_s) / cfg.burst_period_s
        if phase < cfg.burst_duty:
            r *= cfg.burst_factor
    return max(r, 0.0)


def _zipf_ranks(rng: np.random.Generator, n: int, k: int,
                s: float) -> np.ndarray:
    """n draws over ranks [0, k) with P(rank) proportional to
    (rank+1)^-s (bounded Zipf — numpy's ``zipf`` is unbounded)."""
    w = (np.arange(1, k + 1, dtype=np.float64)) ** (-s)
    return rng.choice(k, size=n, p=w / w.sum())


def _system_prompt(cfg: LoadgenConfig, sys_id: int) -> np.ndarray:
    """The shared prefix for rank ``sys_id`` — content depends only on
    (seed, sys_id), so every request sharing the rank shares the exact
    token pages."""
    rng = np.random.default_rng((cfg.seed << 8) ^ (sys_id + 1))
    return rng.integers(1, cfg.vocab, cfg.system_prompt_len,
                        dtype=np.int32)


def generate_trace(cfg: LoadgenConfig) -> LoadTrace:
    """Deterministic trace from a seeded config (thinning for the
    arrival process, lognormal lengths, Zipf prompt sharing)."""
    rng = np.random.default_rng(cfg.seed)
    lam_max = cfg.base_rps * max(cfg.burst_factor, 1.0) \
        * (1.0 + cfg.diurnal_amplitude)
    # arrival times by thinning a homogeneous lambda_max process
    times: List[float] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / lam_max)
        if t >= cfg.duration_s:
            break
        if rng.random() < _rate(cfg, t) / lam_max:
            times.append(t)
    n = len(times)
    weights = np.asarray([tc.weight for tc in cfg.tenants], np.float64)
    tclass = rng.choice(len(cfg.tenants), size=n, p=weights / weights.sum())
    sys_ids = _zipf_ranks(rng, n, cfg.n_system_prompts, cfg.zipf_s)
    sys_prompts = [_system_prompt(cfg, i)
                   for i in range(cfg.n_system_prompts)]
    suffix = np.clip(rng.lognormal(np.log(cfg.suffix_len_median),
                                   cfg.suffix_len_sigma, n),
                     1, None).astype(np.int64)
    max_new = np.clip(rng.lognormal(np.log(cfg.max_new_median),
                                    cfg.max_new_sigma, n),
                      1, None).astype(np.int64)
    reqs: List[TraceRequest] = []
    for i in range(n):
        tc = cfg.tenants[tclass[i]]
        # clip to the engine budget: prompt + decode <= max_seq
        mn = int(min(max_new[i], cfg.max_seq - cfg.system_prompt_len - 1))
        sl = int(min(suffix[i],
                     cfg.max_seq - cfg.system_prompt_len - mn))
        if mn < 1 or sl < 1:
            continue
        tail = rng.integers(1, cfg.vocab, sl, dtype=np.int32)
        prompt = np.concatenate([sys_prompts[sys_ids[i]], tail])
        reqs.append(TraceRequest(
            rid=i, at_s=times[i], tenant=tc.tenant, cls=tc.cls,
            priority=tc.priority, sys_id=int(sys_ids[i]), prompt=prompt,
            max_new=mn))
    return LoadTrace(cfg=cfg, requests=reqs)


def replay(engine, trace: LoadTrace, *, speed: float = 1.0,
           rid_base: int = 0, timeout_s: float = 120.0) -> List[Any]:
    """Submit a trace against a live engine with real inter-arrival
    gaps (``speed`` > 1 compresses time), wait for every request, and
    return the engine ``Request`` objects (rid = ``rid_base`` + trace
    rid; callers replaying the same trace twice offset the base so
    trace events never collide)."""
    from .engine import Request   # local: loadgen stays engine-agnostic
    out = []
    t0 = time.monotonic()
    for tr in trace.requests:
        delay = tr.at_s / speed - (time.monotonic() - t0)
        if delay > 0:
            time.sleep(delay)
        r = Request(rid=rid_base + tr.rid, prompt=tr.prompt,
                    max_new=tr.max_new, tenant=tr.tenant, cls=tr.cls,
                    priority=tr.priority)
        engine.submit(r)
        out.append(r)
        engine.check_health()
    deadline = time.monotonic() + timeout_s
    for r in out:
        if not r.done.wait(max(deadline - time.monotonic(), 0.001)):
            engine.check_health()
            raise TimeoutError(f"request {r.rid} not done after "
                               f"{timeout_s}s")
    return out


def fold_report(trace: LoadTrace, *, rid_base: int = 0,
                events=None, pool_stats: Optional[Dict[str, Any]] = None,
                pages_saved: int = 0) -> SLOReport:
    """Fold a replay's trace events into the per-tenant/per-class
    attainment report.  ``events`` defaults to the global tracer's
    snapshot; ``pool_stats``/``pages_saved`` come from
    ``engine.kv_pool.stats()`` / ``engine.stats.pages_saved``."""
    if events is None:
        events = _TR.snapshot()
    reqs = derive_requests(events)
    classes = {rid_base + rid: tc for rid, tc in trace.classes.items()}
    reqs = {rid: r for rid, r in reqs.items() if rid in classes}
    return SLOReport.from_requests(reqs, classes=classes,
                                   targets=trace.targets,
                                   pool_stats=pool_stats,
                                   pages_saved=pages_saved)
