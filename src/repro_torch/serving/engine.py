"""Serving engine: mechanisms (threads, locks, device state) under a
scheduler (policy).

The port of ``repro.serving.engine``.  Every step takes **read** permission
on the model-epoch lock and on the KV page map's stripes: the host rwlock
(``lock_name``: ``bravo-ba``, ``ba``, ...) and one lease publish per lock
for the whole batch in the shared visible-readers table of one
:class:`~repro_torch.core.registry.BravoRegistry`.  The weight updater
hot-swaps the model (write lock: revoke the model lock's bias lane and
drain its leases), and page allocation and reclamation revoke the stripe
they touch.  Lease acquire, release and the drain polls run in the
hand-written CUDA kernels K1-K4 (``kernels/``).

Two modes:

* **Scheduler mode** (``scheduler=SchedulerConfig(...)``), the serving
  path: continuous batching under :mod:`.scheduler` (admission, chunked
  prefill, page-pressure eviction, the prefix cache with copy-on-write).
  The KV page *contents* live in one page store
  (``models.model.init_paged_caches``) owned by the engine; the (request ->
  pages) *map* lives in the :class:`~.kv_pool.KVPool`.  Each tick takes the
  page-stripe leases and the model-epoch lease for the WHOLE batch in one
  publish each, holds them across the step, and the step reads pages in
  place through the attention kernels K5 (decode) and K6 (chunk prefill).
  With ``quant_kv=True`` the store holds int8 pages with float32
  per-(page, KV head) scales (about half the bytes of the bf16 store): the
  step re-quantizes the pages it writes (``kernels.quant.requant_scatter``)
  and reads them through K7 and K8, prefix keys carry the layout tag, and
  the copy-on-write page copy moves data and scale together.
  The device batch state (page-index matrix, cache lengths, current tokens)
  changes only on control-plane events, so a decode tick moves no bytes
  between host and device except the generated tokens.  On the card the
  paged decode and chunk-prefill steps each run as one CUDA graph
  (``steps.jit_step``, where ``repro`` jits them): eager on the first
  tick with a new parameter tree, captured on the second and replayed
  after; the leases bracket the replay outside the graph, and ``stop()``
  drops the graphs.
* **Handler mode** (``scheduler=None``): each handler thread gathers up to
  ``slots_per_handler`` requests, runs one prefill and then decode steps
  against a dense per-batch cache, beside the pool's page map.  On the
  card both steps run as CUDA graphs (``steps.jit_step``, where ``repro``
  jits them), each handler thread with its own step objects for each
  batch size, so two threads never share (and thrash) one graph.  The
  decode cache tree of a (thread, batch size) is kept by the engine,
  zeroed in place at the start of each batch and donated to the decode
  step, which writes every leaf in place (``steps.in_place``); a hot swap
  costs each step object that sees the new tree one eager step and one
  capture.

Scheduler mode also carries ``repro``'s latency-feedback admission
(``SchedulerConfig(controller=ControllerConfig(...))``): windowed step and
TTFT sensors feed a :class:`~.scheduler.LatencyFeedbackController` that
moves the scheduler's slot cap and admission watermark at tick top level.
The step sensor times a decode tick through its token readback, the
tick's one synchronization, so it reads the card's time and not the
launches' enqueue.  ``hot_swap(checkpoint=(dir, step))`` stages a
checkpoint written by :mod:`repro_torch.ft.checkpoint` (or by ``repro``'s)
leaf by leaf, CRC-verified, onto the engine's device before any lock is
taken.

On a mesh (``mesh=`` from ``launch.mesh``, ``rules=`` a
``dist.sharding.MeshRules``) the steps are ``repro``'s meshed steps: each
rank runs the engine, and the paged attention and the MoE layers run per
rank with their collectives.  On a mesh of more than one rank every rank
is given the same requests (and swaps) in the same order, and the ranks'
collectives must come in one order, so no rank's clock may decide its own
batches.  The engine's agreeing thread (the scheduler thread; in handler
mode the dealer thread) starts each round with one all-reduce over a gloo
group, by which the ranks agree on how many queued requests to take,
whether a staged hot swap is ready on every rank, and whether to stop.

* Scheduler mode admits the agreed requests at that tick.  With the
  latency controller, rank 0's controller decides: its windows and its
  clock are the sensors, so the band is measured on rank 0's clock, and
  its decision, slot cap, watermark and sensor readings ride the same
  all-reduce, so every rank applies the same limits at the same tick
  (``ctrl_log``).
* Handler mode cuts the agreed requests, in queue order, into batches of
  up to ``slots_per_handler`` and deals them to the idle handler threads
  in thread order.  The busy threads' steps (a batch's prefill, then its
  ``S - 1 + max_new`` decode steps) then take turns, one step a thread in
  thread order, one round of turns between two agreement rounds, so every
  rank issues its collectives, its steps' graph decisions and its swap
  installs in one order.  This gives up the overlap of handler threads on
  a mesh; a batch whose rows the live data axes do not divide fails in
  the MoE layer on every rank alike (ROADMAP R17), and ends the rank's
  serving (``EngineFailure`` at ``stop()``).

A hot swap is staged on each rank and installed by the agreeing thread at
the round the ranks agree on, between two turns in handler mode, so every
rank's parameter tree, and with it its graphs' key, changes on the same
step call; revocation stays per rank (each rank's lease table is its
own).  The steps' graphs hold their collectives (NCCL on the card) and
agree each call's warm-up, capture or replay over the same group
(``steps.GraphedStep.decide``), so every rank warms up, captures and
replays on the same calls.  A mesh of one rank (the card's smoke run)
changes nothing else: on one card and on a one-rank mesh both modes run
as they do without a mesh.

Not ported: ``repro``'s host-only mode (``device_leases=False``); every
lock here mirrors its readers on the device.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import queue
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..core.atomics import LiveMem
from ..core.device_bravo import LeaseHandle
from ..core.errors import DrainTimeout
from ..core.factory import LockEnv
from ..core.registry import BravoRegistry, RegistryHandle
from ..device import DeviceLike, resolve
from ..dist.sharding import MeshRules
from ..kernels.quant import quant_layout_tag
from ..models import model as M
from ..models.common import ModelConfig
from ..obs import TRACER as _TR
from ..obs.metrics import MetricsRegistry
from .kv_pool import KVPool, page_keys
from .scheduler import (LatencyFeedbackController, Phase, Scheduler,
                        SchedulerConfig, SlotState)
from .steps import (GraphedStep, flatten, in_place, jit_step,
                    make_decode_step, make_paged_prefill_step,
                    make_prefill_step, unflatten)


@dataclasses.dataclass
class EngineConfig:
    """Engine mechanism timings (the scheduler config stays pure policy)."""
    handler_poll_s: float = 0.1     # handlers' inq.get timeout
    idle_poll_s: float = 0.05       # scheduler loop's idle inq.get timeout
    join_timeout_s: float = 10.0    # stop()'s per-thread join bound
    drain_wait_poll_s: float = 0.0005  # lease revocation poll cadence
    drain_max_wait_s: float = 5.0   # bounded-drain deadline (DrainTimeout)
    swap_retries: int = 3           # hot_swap attempts after a DrainTimeout
    swap_backoff_s: float = 0.05    # base backoff between attempts (doubles)
    obs_warmup_steps: int = 2       # decode steps kept out of the step-
    #                                 latency histogram (warm-up outliers)


class EngineFailure(RuntimeError):
    """A worker thread died.  Carries every recorded failure as
    ``(thread_name, exception, scheduler_state)`` triples."""

    def __init__(self, failures):
        names = ", ".join(f"{n}: {type(e).__name__}({e})"
                          for n, e, _ in failures)
        super().__init__(f"{len(failures)} engine thread(s) died — {names}")
        self.failures = list(failures)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,) int32
    max_new: int = 16
    out: Optional[np.ndarray] = None
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    # tenant/class label the request for SLO reports; priority feeds the
    # scheduler's admission order
    tenant: str = ""
    cls: str = ""
    priority: int = 0


_ENGINE_COUNTERS = (
    "decode_steps",
    "tokens_out",
    "prefills",
    "weight_swaps",
    "swap_retries",     # hot_swap attempts that hit a DrainTimeout
    "swap_failures",    # hot_swaps abandoned after all retries
    "compactions",
    "read_acquires",
    # prefix-cache accounting (scheduler mode)
    "pages_charged",    # pages actually allocated at admission
    "pages_saved",      # prompt pages served by shared reference
    "cow_copies",       # partial-page divergences copied on write
    "cached_tokens",    # prompt tokens whose prefill was skipped
)


class EngineStats:
    """Attribute view over the engine's ``engine.*`` metrics counters."""

    def __init__(self, metrics: MetricsRegistry):
        object.__setattr__(self, "_c", {
            n: metrics.counter(f"engine.{n}") for n in _ENGINE_COUNTERS})

    def inc(self, name: str, n: int = 1) -> None:
        self._c[name].add(n)

    def __getattr__(self, name: str) -> int:
        try:
            return self.__dict__["_c"][name].value
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        raise AttributeError(
            "EngineStats is a metrics view: use inc(name, n) to count")

    def asdict(self) -> Dict[str, int]:
        return {n: c.value for n, c in self._c.items()}


Lease = Optional[Union[LeaseHandle, RegistryHandle]]

# an agreement round's controller fields (``ServingEngine._ctrl_propose``)
_CTRL_DECISIONS = ("shrink", "grow")
_INT64_MAX = 2 ** 63 - 1


def _f64_bits(x: float) -> int:
    """A float64's bits as an int64 (order-keeping for x >= 0)."""
    return struct.unpack("<q", struct.pack("<d", x))[0]


def _f64_of(bits: int) -> float:
    return struct.unpack("<d", struct.pack("<q", bits))[0]


class _TurnsClosed(Exception):
    """A handler's turn will not come: the rank's serving has ended."""


class ModelStore:
    """Epoch-versioned weights, guarded by a reader-writer lock (and,
    optionally, by a device-side lease handle mirroring the readers: a
    plain :class:`~repro_torch.core.device_bravo.LeaseHandle` or a registry
    lock; same protocol)."""

    def __init__(self, params, lock, leases: Lease = None):
        self.params = params
        self.epoch = 0
        self.lock = lock
        self.leases = leases

    def read(self):
        tok = self.lock.acquire_read()
        return tok, self.params, self.epoch

    def done_read(self, tok):
        self.lock.release_read(tok)

    def read_batch(self, reader_ids: torch.Tensor):
        """Epoch read for a request batch: the host read lock plus ONE lease
        publish for all ``reader_ids`` (device int32); no host-device
        synchronization.  The token carries the grant mask so
        ``done_read_batch`` clears only the leases actually won."""
        tok = self.lock.acquire_read()
        granted = gen = None
        if self.leases is not None:
            try:
                self.leases.rearm()
                granted = self.leases.acquire(reader_ids)
                gen = getattr(self.leases, "gen", None)
            except BaseException:        # never leak the host read lock
                self.lock.release_read(tok)
                raise
        return (tok, granted, gen), self.params, self.epoch

    def done_read_batch(self, tok, reader_ids: torch.Tensor):
        host_tok, granted, gen = tok
        try:
            if granted is not None:
                # generation check: after a stuck-lane scrub regenerated
                # the lock value, our slots are already scrubbed and a
                # release would hash to the new value's slots (a plain
                # LeaseHandle has no generation)
                if gen is None or gen == getattr(self.leases, "gen", None):
                    self.leases.release(reader_ids, granted=granted)
        finally:
            self.lock.release_read(host_tok)

    def swap(self, new_params, **revoke_kw):
        """Install new weights: write lock, bounded drain of the device
        leases (``revoke_kw`` forwards ``max_wait_s``/``wait_poll_s``),
        then epoch bump.  A :class:`DrainTimeout` propagates BEFORE the
        params are touched."""
        tok = self.lock.acquire_write()
        try:
            if self.leases is not None:
                self.leases.revoke(**revoke_kw)
            self.params = new_params
            self.epoch += 1
        finally:
            self.lock.release_write(tok)


class PageTable:
    """Paged-KV bookkeeping (page -> request map) in a device
    :class:`~repro_torch.serving.kv_pool.KVPool`: reads take registry
    stripe leases, and the host rwlock is the thread-level write exclusion
    the pool requires of its callers."""

    def __init__(self, lock, pool: KVPool):
        self.lock = lock
        self.pool = pool

    @property
    def free(self) -> List[int]:
        """Free pages: a synchronized snapshot of the device pool."""
        return self.pool.free_pages()

    def lookup(self, rid: int) -> List[int]:
        tok = self.lock.acquire_read()
        try:
            return self.pool.lookup(rid)
        finally:
            self.lock.release_read(tok)

    def read_batch(self, rids: torch.Tensor):
        """Page-map read for a device-resident rid batch: one stripe-lease
        publish + ownership mask, no host sync.  The host read lock AND the
        leases are held until ``done_read_batch``."""
        tok = self.lock.acquire_read()
        try:
            ptok, mask = self.pool.read_batch(rids)
        except BaseException:          # never leak the host read lock
            self.lock.release_read(tok)
            raise
        return (tok, ptok), mask

    def done_read_batch(self, token) -> None:
        host_tok, ptok = token
        try:
            self.pool.done_read_batch(ptok)
        finally:
            self.lock.release_read(host_tok)

    def allocate(self, rid: int, n: int) -> List[int]:
        """Dispatches the allocation under the write lock and reads the
        page indices back only after releasing it, so the writer hold time
        (the BRAVO revocation window) excludes the round-trip."""
        tok = self.lock.acquire_write()
        try:
            take, ok = self.pool.allocate_async(rid, n)
        finally:
            self.lock.release_write(tok)
        return self.pool.materialize_alloc(take, ok)   # sync OUTSIDE

    def reclaim(self, rid: int) -> int:
        tok = self.lock.acquire_write()
        try:
            cnt = self.pool.reclaim_async(rid)
        finally:
            self.lock.release_write(tok)
        return int(cnt)                                # sync OUTSIDE

    # ------------------------------------------------------- prefix cache
    # The refcount mutators take the host WRITE lock for thread exclusion
    # but only dispatch under it (materializing after release, like
    # allocate), and none revokes a stripe bias: refcounts never change a
    # live rid's page mask or any page a leased reader can address.

    def match_prefix(self, kh, kl, ln):
        """Peek the prefix index (read lock; no refs taken)."""
        tok = self.lock.acquire_read()
        try:
            return self.pool.match_prefix(kh, kl, ln)
        finally:
            self.lock.release_read(tok)

    def acquire_prefix(self, kh, kl, ln, take):
        """Take refs on the hit run's ``take``-selected pages; -> (per-key
        page list, free pages consumed)."""
        tok = self.lock.acquire_write()
        try:
            res = self.pool.acquire_prefix_async(kh, kl, ln, take)
        finally:
            self.lock.release_write(tok)
        return self.pool.materialize_prefix(*res)      # sync OUTSIDE

    def insert_prefix(self, rid: int, kh, kl, ln, lane_pages) -> List[bool]:
        """Publish a request's written prompt pages; -> converted mask."""
        tok = self.lock.acquire_write()
        try:
            ins = self.pool.insert_prefix_async(rid, kh, kl, ln, lane_pages)
        finally:
            self.lock.release_write(tok)
        return ins.tolist()                            # sync OUTSIDE

    def release_refs(self, pages) -> int:
        """Drop refs on shared pages; -> pages freed (refcount hit 0)."""
        tok = self.lock.acquire_write()
        try:
            cnt = self.pool.release_refs_async(pages)
        finally:
            self.lock.release_write(tok)
        return int(cnt)                                # sync OUTSIDE

    def compact(self, live=None) -> int:
        """Background compaction tick.  Handler mode passes no live set and
        there is nothing to plan.  With a ``live`` rid list (scheduler
        mode): scrub orphan pages, owned by a rid not in ``live``.  The
        synchronizing orphan PLAN runs before the write lock is taken, and
        a clean plan never takes it; under the lock only the owner update
        (and the flagged stripes' revocation) is dispatched, and the freed
        count is read after release.  Returns the pages scrubbed."""
        if live is None:
            return 0
        live_dev = torch.tensor(list(live), dtype=torch.int32,
                                device=self.pool.device)
        per_stripe, total = self.pool.orphan_plan(live_dev)  # sync, no
        if total == 0:                                       # lock held
            return 0
        tok = self.lock.acquire_write()
        try:
            cnt = self.pool.scrub_orphans_async(live_dev, per_stripe > 0)
        finally:
            self.lock.release_write(tok)
        return int(cnt)                        # sync OUTSIDE the lock


def copy_page(store: Dict[str, torch.Tensor], src: torch.Tensor,
              dst: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Copy-on-write: page ``src`` of every leaf of the page store (all
    layers, K and V, and on the quantized store their scales) into page
    ``dst``, in place.  ``src`` and ``dst`` are int32 scalars on the
    store's device, so a CUDA graph of this copy replays for any pair.
    -> ``store``."""
    s, d = src.long().view(1), dst.long().view(1)
    for x in store.values():
        x.index_copy_(1, d, x.index_select(1, s))
    return store


@dataclasses.dataclass
class HandlerSteps:
    """One handler thread's steps at one batch size (``jit_step`` graphs
    on the card), and the decode cache tree the decode step updates in
    place, which the engine zeroes at the start of each batch."""
    prefill: Callable
    decode: Callable
    caches: Any


def _logits_only(prefill: Callable) -> Callable:
    """Handler mode's prefill, which reads nothing of the step's result:
    the step returning its logits alone, so a graph of it copies no cache
    out at a replay."""
    def logits(params, batch):
        return prefill(params, batch)[0]
    return logits


def _perturb(params):
    """Default hot-swap update: every float leaf times (1 + 1e-6)."""
    if isinstance(params, dict):
        return {k: _perturb(v) for k, v in params.items()}
    return params * (1.0 + 1e-6) if params.is_floating_point() else params


class ServingEngine:
    """The serving engine on ``device`` (default: the CUDA card, raising if
    there is none); ``params`` must lie on that device.  Scheduler mode
    with ``scheduler=SchedulerConfig(...)``, handler mode without.
    ``quant_kv=True`` selects the quantized page store in scheduler mode
    and, as in ``repro``, changes nothing in handler mode."""

    def __init__(self, cfg: ModelConfig, params, *,
                 lock_name: str = "bravo-ba", handlers: int = 4,
                 max_seq: int = 128, slots_per_handler: int = 4,
                 n_pages: int = 4096, env: Optional[LockEnv] = None,
                 kv_stripes: int = 4,
                 scheduler: Optional[SchedulerConfig] = None,
                 engine_cfg: Optional[EngineConfig] = None,
                 quant_kv: bool = False, device: DeviceLike = None,
                 mesh=None, rules: Optional[MeshRules] = None):
        self.device = resolve(device)
        self.cfg = cfg
        self.mesh = mesh
        self.rules = rules if rules is not None or mesh is None \
            else MeshRules()
        # ranks of a mesh of more than one agree at every tick (see the
        # module docstring) over a host group
        self._host_group = None
        self._pending: collections.deque = collections.deque()
        # a mesh of more than one rank: hot swaps wait here for the round
        # the ranks agree on (``_agree``)
        self._staged: Optional[dict] = None
        self._staged_mu = threading.Lock()
        self._swap_serial = threading.Lock()
        if mesh is not None and math.prod(mesh.shape) > 1:
            self._host_group = dist.new_group(backend="gloo")
        # handler mode on a mesh of more than one rank: each thread's
        # batches, and the turn its steps wait for (``_deal_loop``)
        self._hq: List["queue.Queue[Optional[List[Request]]]"] = []
        self._turn_cv = threading.Condition()
        self._turn: Optional[int] = None
        self._turn_ok = True
        self._turns_closed = False
        # step calls so far (handler turns given, scheduler ticks), the
        # count at which each agreed hot swap was installed on a mesh of
        # more than one rank, and the controller's decisions as (tick,
        # decision, slot cap, admission watermark)
        self._turns = self._ticks = 0
        self.swap_at: List[int] = []
        self.ctrl_log: List[tuple] = []
        self.ecfg = engine_cfg or EngineConfig()
        self.env = env or LockEnv(LiveMem())
        self.metrics = MetricsRegistry()
        # ONE registry = one shared visible-readers table for every device
        # lock; each guarded resource gets its own bias lane, so a weight
        # swap's revocation never flaps the page locks' fast path
        self.registry = BravoRegistry(metrics=self.metrics,
                                      device=self.device)
        model_h = self.registry.alloc(name="model")
        self.kv_pool = KVPool(n_pages, registry=self.registry,
                              stripes=kv_stripes, metrics=self.metrics)
        self.store = ModelStore(params, self.env.make(lock_name),
                                leases=model_h)
        self.pages = PageTable(self.env.make(lock_name), self.kv_pool)
        self.lock_name = lock_name
        self.handlers = handlers
        self.max_seq = max_seq
        self.slots = slots_per_handler
        self.stats = EngineStats(self.metrics)
        self._h_step = self.metrics.histogram("engine.step_ns")
        self._h_swap = self.metrics.histogram("engine.swap_ns")
        self._g_queue = self.metrics.gauge("engine.queue_depth")
        self.inq: "queue.Queue[Optional[Request]]" = queue.Queue()
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._failures: List[tuple] = []
        self._failures_lock = threading.Lock()
        self._degraded = threading.Event()   # hot-swap drain failed: stop
        #                                      admitting, drain in-flight
        # handler mode's steps, bare: ``_handler_steps`` makes each
        # thread's graphs of them at each batch size
        self._prefill = _logits_only(make_prefill_step(cfg, mesh,
                                                       self.rules))
        self._decode = in_place(make_decode_step(cfg, mesh, self.rules),
                                arg=1, out=2)
        self._graph_handlers = True    # False: bare (smoke.eager_steps)
        self._hsteps: Dict[tuple, HandlerSteps] = {}
        self._controller = None

        # ---- scheduler mode (continuous batching over the paged pool) ----
        self.sched_cfg = scheduler
        self.scheduler: Optional[Scheduler] = None
        if scheduler is None:
            return
        sc = scheduler
        dev = self.device
        self.scheduler = Scheduler(sc, n_pages)
        # the page STORE (contents); the pool above holds the MAP.
        # quant_kv=True stores pages int8 + per-(page, head) scales as
        # sibling leaves; the step, the COW page copy and the gauge below
        # treat the store as a dict of leaves, so the layout rides through
        self.quant_kv = quant_kv
        self._pages_kv = M.init_paged_caches(cfg, n_pages, sc.page_size,
                                             quantized=quant_kv, device=dev)
        # quantized pages dedup by their int8 bytes: prefix keys carry a
        # layout tag, so a quantized page key never aliases a bf16 one
        self._quant_tag = (quant_layout_tag(sc.page_size, cfg.n_kv_heads,
                                            cfg.hd) if quant_kv else 0)
        hbm = sum(x.numel() * x.element_size()
                  for x in self._pages_kv.values())
        self._g_hbm = self.metrics.gauge("pool.hbm_bytes")
        self._g_hbm.set(hbm)
        if _TR.enabled:
            _TR.emit("pool", "hbm_bytes", bytes=hbm,
                     quantized=int(quant_kv))
        # quant write/hit volume: O(1) increments from host-known tick
        # shapes, applied after the lease windows close
        self._c_quant_tok = self.metrics.counter("pool.quant_tokens")
        self._c_quant_hit = self.metrics.counter("pool.quant_hits")
        ms, lanes = sc.max_slots, sc.lanes
        # device-resident batch state: touched only on control-plane events
        # (admission, growth, eviction, first token); the decode tick reads
        # and bumps it on the device with no host traffic
        self._page_tbl = torch.full((ms, lanes), -1, dtype=torch.int32,
                                    device=dev)
        self._clen = torch.zeros((ms,), dtype=torch.int32, device=dev)
        self._cur = torch.zeros((ms, 1), dtype=torch.int32, device=dev)
        self._rids = torch.full((ms,), -1, dtype=torch.int32, device=dev)
        self._active = torch.zeros((ms,), dtype=torch.int32, device=dev)
        # one CUDA graph each on the card (``jit_step``), as ``repro`` jits
        # them; the page store is used in place, as it donates it
        # on a mesh of more than one rank they agree each call's warm-up,
        # capture or replay over the host group
        self._decode_paged = jit_step(
            make_decode_step(cfg, mesh, self.rules, paged=True),
            donate_argnums=(1,), group=self._host_group)
        self._prefill_paged = jit_step(
            make_paged_prefill_step(cfg, mesh, self.rules),
            donate_argnums=(1,), group=self._host_group)
        # copy-on-write of one page over the donated store, as ``repro``'s
        # jit_step; the page pair rides as device scalars, so one graph a
        # store serves every copy
        self._copy_page_step = jit_step(copy_page, donate_argnums=(0,))
        self._free_est = n_pages        # host mirror of pool pressure
        self._compact_req = False
        # decode steps seen so far: the first obs_warmup_steps stay out of
        # the latency histogram
        self._steps_seen = 0
        # latency-feedback admission: windowed sensors and the controller
        # over the scheduler's runtime limits.  The engine observes into
        # the windows next to the histograms and lets the controller read
        # them at tick top level, never inside a lease window
        self._w_step = self._w_ttft = None
        self._h_ttft = self.metrics.histogram("engine.ttft_ns")
        if sc.controller is not None:
            cc = sc.controller
            self._w_step = self.metrics.windowed(
                "slo.step_ns", cc.window_s, cc.slices)
            self._w_ttft = self.metrics.windowed(
                "slo.ttft_ns", cc.window_s, cc.slices)
            self._controller = LatencyFeedbackController(
                cc, max_slots=sc.max_slots, free_frac=sc.admit_free_frac,
                step_window=self._w_step, ttft_window=self._w_ttft)
            self._g_slot_cap = self.metrics.gauge("sched.slot_cap")
            self._g_free_frac = self.metrics.gauge("sched.admit_free_frac")
            self._g_slot_cap.set(sc.max_slots)
            self._g_free_frac.set(sc.admit_free_frac)
            self._ctrl_next_ns = 0

    # ------------------------------------------------------------- handlers
    def _handler(self, hid: int) -> None:
        B = self.slots
        while not self._stop.is_set():
            reqs: List[Request] = []
            try:
                reqs.append(self.inq.get(timeout=self.ecfg.handler_poll_s))
            except queue.Empty:
                continue
            if reqs[0] is None:
                return
            while len(reqs) < B:
                try:
                    r = self.inq.get_nowait()
                    if r is None:
                        self.inq.put(None)
                        break
                    reqs.append(r)
                except queue.Empty:
                    break
            self._serve_batch(hid, reqs)

    def _mesh_handler(self, hid: int) -> None:
        """Handler ``hid`` on a mesh of more than one rank: it serves the
        batches the dealer deals it, each step in its turn.  A batch that
        fails closes the turns, which ends the rank's serving."""
        while True:
            reqs = self._hq[hid].get()
            if reqs is None:
                return
            try:
                self._serve_batch(hid, reqs)
            except _TurnsClosed:
                return
            except BaseException:
                self._close_turns()
                raise

    def _deal_loop(self) -> None:
        """Handler mode's agreeing thread on a mesh of more than one rank
        (module docstring): an agreement round, the agreed requests dealt
        to the idle handlers as batches, then one turn to each busy
        handler in thread order; after an agreed stop, the batches in
        flight are served to their end.  Every rank computes the same deal
        and the same turns from the agreed counts.  A failed turn ends the
        loop at once."""
        B = self.slots
        left = [0] * self.handlers       # turns left of each batch in flight
        stopping = False
        try:
            while True:
                taken: List[Request] = []
                if not stopping:
                    idle = [h for h in range(self.handlers) if not left[h]]
                    taken, stopping = self._agree(cap=len(idle) * B)
                    for h, i in zip(idle, range(0, len(taken), B)):
                        batch = taken[i:i + B]
                        S = max(len(r.prompt) for r in batch)
                        left[h] = S + max(r.max_new for r in batch)
                        self._hq[h].put(batch)
                busy = [h for h in range(self.handlers) if left[h]]
                if not busy:
                    if stopping:
                        return
                    self._stop.wait(self.ecfg.idle_poll_s)
                    continue
                for h in busy:
                    if not self._give_turn(h):
                        return
                    left[h] -= 1
        finally:
            self._close_turns()
            for q in self._hq:
                q.put(None)

    def _give_turn(self, hid: int) -> bool:
        """Let handler ``hid`` run one step and wait for it.  -> whether
        the step ran without an error (False also once the turns close)."""
        self._turns += 1
        with self._turn_cv:
            self._turn = hid
            self._turn_cv.notify_all()
            while self._turn is not None and not self._turns_closed:
                self._turn_cv.wait()
            return self._turn is None and self._turn_ok

    @contextlib.contextmanager
    def _turn_of(self, hid: int):
        """One step of handler ``hid``: in its turn on a mesh of more than
        one rank (``_deal_loop``), at once otherwise."""
        if self._host_group is None:
            yield
            return
        with self._turn_cv:
            while self._turn != hid:
                if self._turns_closed:
                    raise _TurnsClosed()
                self._turn_cv.wait()
        ok = False
        try:
            yield
            ok = True
        finally:
            with self._turn_cv:
                self._turn, self._turn_ok = None, ok
                self._turn_cv.notify_all()

    def _close_turns(self) -> None:
        with self._turn_cv:
            self._turns_closed = True
            self._turn_cv.notify_all()

    def _decode_caches(self, batch: int) -> Any:
        """Zero decode caches for ``batch`` rows, each leaf in the dtype
        the decode step returns for it (found by running the step on the
        meta device): a step that promotes a leaf, as Zamba2's convolution
        window beside float32 weights or RWKV's token shifts at float32
        compute, gets it promoted from the start, which changes no value,
        since zeros promote to zeros."""
        caches = M.init_caches(self.cfg, batch, self.max_seq,
                               dtype=torch.bfloat16, device="meta")
        p_leaves, p_struct = flatten(self.store.params)
        meta = unflatten(p_struct, [torch.empty_like(x, device="meta")
                                    for x in p_leaves])
        tok = torch.zeros((batch, 1), dtype=torch.int32, device="meta")
        clen = torch.ones((batch,), dtype=torch.int32, device="meta")
        # one step reaches the fixed point: promoting twice is promoting once
        caches = make_decode_step(self.cfg)(meta, caches, tok, clen)[2]
        leaves, struct = flatten(caches)
        return unflatten(struct, [
            torch.zeros(x.shape, dtype=x.dtype, device=self.device)
            for x in leaves])

    def _handler_steps(self, hid: int, batch: int) -> HandlerSteps:
        """Handler ``hid``'s steps at ``batch`` rows, with its decode cache
        tree zeroed (made on first use, and again after ``stop()``)."""
        hs = self._hsteps.get((hid, batch))
        if hs is None:
            g, grp = self._graph_handlers, self._host_group
            hs = self._hsteps[(hid, batch)] = HandlerSteps(
                prefill=(jit_step(self._prefill, group=grp) if g
                         else self._prefill),
                decode=(jit_step(self._decode, donate_argnums=(1,),
                                 group=grp) if g else self._decode),
                caches=None)
        if hs.caches is None:
            hs.caches = self._decode_caches(batch)
        else:
            for x in flatten(hs.caches)[0]:
                x.zero_()
        return hs

    def handler_step_stats(self) -> Dict[str, Dict[str, Any]]:
        """Each handler step object's warm-ups, captures and replays, by
        ``"h<thread>_b<batch size>"``."""
        return {f"h{hid}_b{b}": {
                    name: dataclasses.asdict(step.stats)
                    for name, step in (("prefill", hs.prefill),
                                       ("decode", hs.decode))
                    if isinstance(step, GraphedStep)}
                for (hid, b), hs in sorted(self._hsteps.items())}

    def _serve_batch(self, hid: int, reqs: List[Request]) -> None:
        dev = self.device
        B = len(reqs)
        S = max(len(r.prompt) for r in reqs)
        toks = np.zeros((B, S), np.int32)
        for i, r in enumerate(reqs):
            toks[i, S - len(r.prompt):] = r.prompt  # left-pad
            self.pages.allocate(r.rid, (len(r.prompt) + r.max_new + 63) // 64)
        # the batch's reader ids, device-resident once per batch: every
        # lease publish/clear below is a single kernel launch on them
        rid_dev = torch.tensor([r.rid for r in reqs], dtype=torch.int32,
                               device=dev)
        toks_dev = torch.from_numpy(toks).to(dev)

        hs = self._handler_steps(hid, B)
        # prefill under a read lock (one epoch for the whole batch)
        with self._turn_of(hid):
            tok, params, _ = self.store.read_batch(rid_dev)
            try:
                hs.prefill(params, {"tokens": toks_dev})
            finally:
                self.store.done_read_batch(tok, rid_dev)
        self.stats.inc("prefills")

        caches = hs.caches
        # feed the prompt token by token through decode steps (per-slot
        # lengths differ), then generate
        outs: List[List[int]] = [[] for _ in range(B)]
        cur = toks_dev[:, :1]
        max_new = max(r.max_new for r in reqs)
        for step in range(S - 1 + max_new):
            clen = torch.full((B,), step + 1, dtype=torch.int32, device=dev)
            # page-map read held across the step: the stripe leases (and
            # host read lock) pin the batch's pages until the step is in
            with self._turn_of(hid):
                ptok, _page_mask = self.pages.read_batch(rid_dev)
                try:
                    rtok, params_now, _ = self.store.read_batch(rid_dev)
                    try:
                        nxt, _logits, caches = hs.decode(params_now, caches,
                                                         cur, clen)
                    finally:
                        self.store.done_read_batch(rtok, rid_dev)
                finally:
                    self.pages.done_read_batch(ptok)
            self.stats.inc("decode_steps")
            self.stats.inc("read_acquires")
            if step + 1 < S:
                cur = toks_dev[:, step + 1:step + 2]
            else:
                cur = nxt
                nn = nxt[:, 0].cpu().numpy()
                for i in range(B):
                    if len(outs[i]) < reqs[i].max_new:
                        outs[i].append(int(nn[i]))
        for i, r in enumerate(reqs):
            r.out = np.asarray(outs[i], np.int32)
            self.pages.reclaim(r.rid)
            r.done.set()
        self.stats.inc("tokens_out", sum(len(o) for o in outs))

    # ------------------------------------------------------- scheduler mode
    def _submit_slot(self, r: Request) -> None:
        self.scheduler.submit(SlotState(
            rid=r.rid, prefix=np.asarray(r.prompt, np.int32),
            max_new=r.max_new, request=r, tenant=r.tenant, cls=r.cls,
            priority=r.priority))

    def _drain_inq(self) -> None:
        if self._host_group is not None:
            return                   # the ranks admit by agreement
        while True:
            try:
                r = self.inq.get_nowait()
            except queue.Empty:
                return
            if r is not None:        # None = the handlers' stop sentinel;
                self._submit_slot(r)  # the loop exits via _stop instead

    def _bind_pages(self, st: SlotState, pages: List[int],
                    charged: Optional[int] = None) -> None:
        """Append pages to the slot's lanes.  ``charged`` is how many FREE
        pages this binding consumed — shared-by-ref pages cost nothing
        unless the ref revived a refcount-0 cached page."""
        base = len(st.pages)
        st.pages.extend(pages)
        self._free_est -= len(pages) if charged is None else charged
        self._page_tbl[st.row, base:base + len(pages)] = torch.tensor(
            pages, dtype=torch.int32)    # one small upload, control plane

    def _clear_row(self, row: int) -> None:
        self._page_tbl[row] = -1
        for vec in (self._clen, self._cur, self._active):
            vec[row] = 0
        self._rids[row] = -1

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy-on-write: duplicate one page of the store (all layers, K
        and V, and on the quantized store their scales) into a private
        page, in place, through the graphed :func:`copy_page`."""
        pair = torch.tensor([src, dst], dtype=torch.int32,
                            device=self.device)   # one small upload
        self._copy_page_step(self._pages_kv, pair[0], pair[1])

    def _release_slot_pages(self, st: SlotState) -> int:
        """Return a slot's pages to the pool: drop its refs on shared
        prefix pages (a page is freed only at refcount 0), then reclaim its
        privates."""
        freed = 0
        if st.shared_refs:
            freed += self.pages.release_refs(
                np.asarray(st.shared_refs, np.int32))
            st.shared_refs = []
        return freed + self.pages.reclaim(st.rid)

    def _evict(self, st: SlotState) -> None:
        """Preempt under page pressure: drop refs + reclaim, requeue (the
        scheduler folds generated tokens into the prefix), clear the
        row."""
        row = st.row
        self._free_est += self._release_slot_pages(st)
        self.scheduler.evict(st)
        self._clear_row(row)
        if _TR.enabled:
            _TR.emit("req", "evict", rid=st.rid)

    def _finish(self, st: SlotState) -> None:
        row = st.row
        self._free_est += self._release_slot_pages(st)
        self.scheduler.finish(st)
        self._clear_row(row)
        if _TR.enabled:
            _TR.emit("req", "done", rid=st.rid, tokens=len(st.out))
        r = st.request
        if r is not None:
            r.out = np.asarray(st.out, np.int32)
            r.done.set()

    def _grow_slot(self, st: SlotState, n: int) -> bool:
        """Allocate ``n`` pages for a running slot, evicting newest-first
        (page-pressure preemption) until the allocation fits."""
        while True:
            pages = self.pages.allocate(st.rid, n)
            if pages:
                self._bind_pages(st, pages)
                return True
            victim = self.scheduler.pick_victim(exclude=st)
            if victim is None:
                return False
            self._evict(victim)

    def _peek_need(self, st: SlotState) -> int:
        """Post-dedup page charge for admission: a request pays only for
        the pages its prompt does NOT share with the prefix cache (plus
        any refcount-0 cached pages a hit would pin).  Also records the
        slot's cache plan: prompt tokens covered, pages by reference, and
        whether the boundary page needs a copy-on-write."""
        sc = self.sched_cfg
        total = sc.pages_for(st.n_prefix + 1)
        if not sc.prefix_cache:
            return total
        pool = self.kv_pool
        if st.cache_plan is not None and st.cache_plan[0] == pool.version:
            return st.cache_plan[4]   # pool unchanged since the last peek
        if st.keys is None:
            st.keys = page_keys(st.prefix, sc.page_size, pad_to=sc.lanes,
                                quant_tag=self._quant_tag)
        _, n_run, free_hit = self.pages.match_prefix(*st.keys)
        lens = st.keys[2]
        # usable coverage: the hit run's tokens, capped so the LAST prompt
        # token is always recomputed — its logits seed the first generated
        # token
        cov = min(int(np.sum(lens[:n_run])), st.n_prefix - 1)
        k_ref = cov // sc.page_size
        cow = cov % sc.page_size > 0
        revived = sum(free_hit[:k_ref + (1 if cow else 0)])
        need = total - k_ref + revived
        st.cache_plan = (pool.version, cov, k_ref, cow, need)
        return need

    def _attach_prefix(self, st: SlotState) -> bool:
        """Bind an admitted slot's pages, deduplicated against the prefix
        cache: shared full pages ride by reference (refcount++), a
        partial-page divergence is COPIED into a private page (never
        written through), and only the remainder is freshly allocated.
        False -> the pool was short after all; the caller defers the
        slot."""
        sc = self.sched_cfg
        total = sc.pages_for(st.n_prefix + 1)
        cov, k_ref, cow = (st.cache_plan[1:4] if st.cache_plan
                           else (0, 0, False))
        refs: List[int] = []
        cow_src = -1
        revived = 0
        if k_ref or cow:
            take = np.zeros((sc.lanes,), bool)
            take[:k_ref + (1 if cow else 0)] = True
            hit, revived = self.pages.acquire_prefix(*st.keys, take)
            refs = [p for p in hit[:k_ref] if p >= 0]
            cow_src = hit[k_ref] if cow else -1
            if len(refs) != k_ref or (cow and cow_src < 0):
                # the cache changed between peek and acquire: drop what was
                # granted and fall back to a plain allocation (no _free_est
                # credit: the revives were never debited)
                got = refs + ([cow_src] if cow_src >= 0 else [])
                if got:
                    self.pages.release_refs(np.asarray(got, np.int32))
                refs, cov, k_ref, cow, cow_src, revived = \
                    [], 0, 0, False, -1, 0
        pages = self.pages.allocate(st.rid, total - k_ref)
        if not pages:
            if refs or cow_src >= 0:
                got = refs + ([cow_src] if cow_src >= 0 else [])
                self.pages.release_refs(np.asarray(got, np.int32))
            st.cache_plan = None
            return False
        if cow:
            # lane k_ref: private copy of the divergent boundary page; the
            # transient ref pinned the source across the copy
            self._copy_page(cow_src, pages[0])
            self._free_est += self.pages.release_refs(
                np.asarray([cow_src], np.int32))
        st.shared_refs = refs
        st.cached_pos = cov
        st.prefill_pos = st.pos = cov     # chunked prefill resumes here
        st.admit_ns = time.monotonic_ns()
        self._rids[st.row] = st.rid
        self._bind_pages(st, refs + pages, charged=len(pages) + revived)
        self.stats.inc("pages_charged", len(pages))
        self.stats.inc("pages_saved", k_ref)
        self.stats.inc("cow_copies", int(cow))
        self.stats.inc("cached_tokens", cov)
        if self.quant_kv and cov:
            self._c_quant_hit.add(cov)   # tokens ridden as shared int8
        if _TR.enabled:
            _TR.emit("req", "admit", rid=st.rid, cached=cov,
                     pages=len(pages), shared=k_ref)
            if cow:
                _TR.emit("pool", "cow_copy", rid=st.rid)
        return True

    def _admit(self) -> None:
        """Admission: the scheduler applies the watermarks (charging each
        request its post-dedup page need); the engine attaches the
        admitted slots' pages (no eviction on admission: a new request
        never preempts running work)."""
        if self._degraded.is_set():
            return      # drain failure in flight: admit nothing new
        admitted = self.scheduler.admit(self._free_est,
                                        need_fn=self._peek_need)
        for i, st in enumerate(admitted):
            if not self._attach_prefix(st):
                # the host free estimate was stale: un-admit this slot AND
                # every later one (reversed, so the queue keeps its order)
                for back in reversed(admitted[i:]):
                    self.scheduler.defer(back)
                break

    def _publish_prefix(self, st: SlotState) -> None:
        """A slot just finished paging its prompt: offer its pages to the
        prefix index.  Only pages the slot OWNS convert; converted pages
        move from the slot's private set to its ref list, so teardown
        releases them instead of reclaiming."""
        sc = self.sched_cfg
        kh, kl, ln = st.keys
        n_keys = int(np.sum(ln > 0))
        lane_pg = np.full((sc.lanes,), -1, np.int32)
        for i in range(n_keys):        # key i's page is lane i
            lane_pg[i] = st.pages[i]
        ins = self.pages.insert_prefix(st.rid, kh, kl, ln, lane_pg)
        st.shared_refs = st.shared_refs + [
            int(lane_pg[i]) for i in range(n_keys) if ins[i]]

    def _run_prefill(self, plan) -> None:
        """One chunked-prefill tick: right-aligned chunks for up to
        ``prefill_rows`` slots, under the page-stripe + model-epoch lease
        batch (held across the step, like decode)."""
        sc = self.sched_cfg
        rows, width, lanes = sc.prefill_rows, sc.prefill_chunk, sc.lanes
        toks = np.zeros((rows, width), np.int32)
        clens = np.zeros((rows,), np.int32)
        newls = np.zeros((rows,), np.int32)
        ptbl = np.full((rows, lanes), -1, np.int32)
        rids = np.full((rows,), -1, np.int32)
        for i, (st, chunk) in enumerate(zip(plan.slots, plan.chunks)):
            seg = st.prefix[st.prefill_pos:st.prefill_pos + chunk]
            toks[i, width - chunk:] = seg
            newls[i] = chunk
            clens[i] = st.prefill_pos + chunk
            ptbl[i, :len(st.pages)] = st.pages
            rids[i] = st.rid
        # new device tensors each tick; the graphed step copies them into
        # its input buffers
        rid_dev, toks_d, clens_d, newls_d, ptbl_d = (
            torch.from_numpy(a).to(self.device)
            for a in (rids, toks, clens, newls, ptbl))
        t0 = time.monotonic_ns()
        ptok, _ = self.pages.read_batch(rid_dev)
        try:
            rtok, params, _ = self.store.read_batch(rid_dev)
            try:
                nxt, _ = self._prefill_paged(params, self._pages_kv, toks_d,
                                             clens_d, newls_d, ptbl_d)
            finally:
                self.store.done_read_batch(rtok, rid_dev)
        finally:
            self.pages.done_read_batch(ptok)
        nxt_h = nxt.cpu().numpy()
        if _TR.enabled:
            _TR.emit_span("engine", "prefill_step", t0,
                          rows=len(plan.slots))
            for st, chunk in zip(plan.slots, plan.chunks):
                _TR.emit("req", "prefill_chunk", rid=st.rid, chunk=chunk,
                         pos=st.prefill_pos)
        done: List[SlotState] = []
        first_toks = 0
        for i, (st, chunk) in enumerate(zip(plan.slots, plan.chunks)):
            if self.scheduler.on_prefill(st, chunk):
                if self.sched_cfg.prefix_cache:
                    self._publish_prefix(st)   # prompt pages fully written
                tok = int(nxt_h[i])     # final chunk: first generated token
                first_toks += 1
                row = st.row
                self._cur[row, 0] = tok
                self._clen[row] = st.pos + 1
                self._active[row] = 1
                if st.admit_ns:
                    ttft = time.monotonic_ns() - st.admit_ns
                    self._h_ttft.observe(ttft)
                    if self._w_ttft is not None:
                        self._w_ttft.observe(ttft)
                if _TR.enabled:
                    _TR.emit("req", "first_token", rid=st.rid)
                if self.scheduler.on_token(st, tok):
                    done.append(st)     # max_new == 1
        for st in done:
            self._finish(st)
        self.stats.inc("prefills")
        self.stats.inc("read_acquires")
        self.stats.inc("tokens_out", first_toks)
        if self.quant_kv:
            self._c_quant_tok.add(int(np.sum(newls)))

    def _decode_tick(self) -> torch.Tensor:
        """The data plane of one decode tick, with no host-device traffic:
        ONE lease publish per lock for the whole batch, held across the
        paged decode step, then the releases; the device batch state moves
        on in place.  -> the generated tokens (max_slots, 1) on the
        device."""
        rid_dev = self._rids
        ptok, _ = self.pages.read_batch(rid_dev)
        try:
            rtok, params, _ = self.store.read_batch(rid_dev)
            try:
                nxt, _logits, _ = self._decode_paged(
                    params, self._pages_kv, self._cur, self._clen,
                    self._page_tbl)
            finally:
                self.store.done_read_batch(rtok, rid_dev)
        finally:
            self.pages.done_read_batch(ptok)
        self._cur = nxt
        self._clen += self._active
        return nxt

    def _run_decode(self, plan) -> None:
        """One decode tick over every DECODE row: grow pages first (with
        page-pressure eviction), then :meth:`_decode_tick`; only the
        generated tokens come back to the host."""
        for st in plan.grow:
            if st.phase is not Phase.DECODE:
                continue                 # evicted by an earlier growth
            if not self._grow_slot(st, 1):
                self._evict(st)          # no other victim: requeue itself
        slots = [st for st in plan.slots if st.phase is Phase.DECODE]
        if not slots:
            return
        t0 = time.monotonic_ns()
        toks = self._decode_tick()[:, 0].cpu().numpy()   # the output sync
        dt = time.monotonic_ns() - t0
        self._steps_seen += 1
        if self._steps_seen > self.ecfg.obs_warmup_steps:
            self._h_step.observe(dt)
            if self._w_step is not None:
                self._w_step.observe(dt)
        if _TR.enabled:
            _TR.emit_span("engine", "decode_step", t0, dur_ns=dt,
                          batch=len(slots))
        done = [st for st in slots
                if self.scheduler.on_token(st, int(toks[st.row]))]
        for st in done:
            self._finish(st)
        self.stats.inc("decode_steps")
        self.stats.inc("read_acquires")
        self.stats.inc("tokens_out", len(slots))
        if self.quant_kv:
            self._c_quant_tok.add(len(slots))

    def _ctrl_tick(self) -> None:
        """Latency-feedback admission update, paced to the controller's
        period.  Reads the windowed sensors (host aggregates, at tick top
        level, never inside a lease window) and applies a decision through
        ``scheduler.set_limits``."""
        due = self._ctrl_update()
        if due:
            self._ctrl_apply(due[0])

    def _ctrl_update(self) -> tuple:
        """One controller update if its period is due by this rank's
        clock: -> ``(decision,)``, or ``()`` when not due."""
        now = time.monotonic_ns()
        if now < self._ctrl_next_ns:
            return ()
        ctrl = self._controller
        self._ctrl_next_ns = now + int(ctrl.ccfg.period_s * 1e9)
        return (ctrl.update(now),)

    def _ctrl_apply(self, decision: Optional[str]) -> None:
        """One controller update's effect: a decision's new limits through
        ``scheduler.set_limits``, the gauges, ``ctrl_log`` and the trace."""
        ctrl = self._controller
        if decision is not None:
            self.scheduler.set_limits(ctrl.slot_cap, ctrl.free_frac)
            self._g_slot_cap.set(ctrl.slot_cap)
            self._g_free_frac.set(ctrl.free_frac)
            self.ctrl_log.append((self._ticks, decision, ctrl.slot_cap,
                                  ctrl.free_frac))
            if _TR.enabled:
                _TR.emit("sched", f"ctrl_{decision}", cap=ctrl.slot_cap,
                         watermark_pct=round(ctrl.free_frac * 100, 1),
                         p99_step_us=round(ctrl.last_step_p99_ns / 1e3, 1),
                         p99_ttft_us=round(ctrl.last_ttft_p99_ns / 1e3, 1))
        if _TR.enabled:
            # a counter-track sample (Perfetto ``C`` events): the watermark
            # and slot curves line up with the latency they track
            _TR.emit("sched", "ctrl_state",
                     watermark_pct=round(ctrl.free_frac * 100, 1),
                     slot_cap=ctrl.slot_cap,
                     active_slots=len(self.scheduler.running),
                     p99_step_us=round(ctrl.last_step_p99_ns / 1e3, 1),
                     p99_ttft_us=round(ctrl.last_ttft_p99_ns / 1e3, 1))

    def _ctrl_propose(self) -> List[int]:
        """The controller's part of an agreement round: on rank 0, when
        its period is due by rank 0's clock, one update, as ``[kind, slot
        cap, watermark's float64 bits, step p99 ns, TTFT p99 ns]`` (kind
        0: not due, 1: no decision, 2 + i: ``_CTRL_DECISIONS[i]``); the
        largest int64 on every other rank, so the round's MIN carries rank
        0's."""
        none = [_INT64_MAX] * 5
        ctrl = self._controller
        if ctrl is None or dist.get_rank(group=self._host_group) != 0:
            return none
        due = self._ctrl_update()
        if not due:
            return [0] + none[1:]
        kind = 1 if due[0] is None else 2 + _CTRL_DECISIONS.index(due[0])
        return [kind, ctrl.slot_cap, _f64_bits(ctrl.free_frac),
                round(ctrl.last_step_p99_ns), round(ctrl.last_ttft_p99_ns)]

    def _ctrl_agreed(self, kind, cap, frac_bits, step_p99, ttft_p99) -> None:
        """Apply rank 0's controller update, agreed in the round, on this
        rank: every other rank's controller takes rank 0's limits and
        sensor readings first."""
        if kind == 0 or self._controller is None:
            return
        ctrl = self._controller
        decision = None if kind == 1 else _CTRL_DECISIONS[kind - 2]
        if dist.get_rank(group=self._host_group) != 0:
            ctrl.slot_cap, ctrl.free_frac = cap, _f64_of(frac_bits)
            ctrl.last_step_p99_ns = float(step_p99)
            ctrl.last_ttft_p99_ns = float(ttft_p99)
        self._ctrl_apply(decision)

    def _schedule_tick(self) -> bool:
        """One policy round: service compaction, admit, run the plan.
        Returns False when idle (the loop then blocks on the queue)."""
        self._drain_inq()
        self._g_queue.set(len(self.scheduler.waiting))
        if self._compact_req:
            self._compact_req = False
            live = [s.rid for s in self.scheduler.running.values()]
            self._free_est += self.pages.compact(live=live)
            self.stats.inc("compactions")
            if _TR.enabled:
                _TR.emit("engine", "compact")
        if self._controller is not None and self._host_group is None:
            self._ctrl_tick()        # on a mesh: in the agreement round
        self._admit()
        plan = self.scheduler.plan()
        self._ticks += 1
        if plan.kind == "prefill":
            self._run_prefill(plan)
            return True
        if plan.kind == "decode":
            self._run_decode(plan)
            return True
        return False

    def _agree(self, cap: Optional[int] = None):
        """One round of the ranks' agreement: queue what has arrived, take
        the number of requests every rank holds (at most ``cap``; all
        ranks are given the same requests in the same order), apply rank
        0's controller update, install the staged hot swap once every rank
        has staged one (all ranks are given the same swaps in the same
        order), stop once any rank stops.  -> (the requests taken, in
        queue order; whether to stop)."""
        while True:
            try:
                r = self.inq.get_nowait()
            except queue.Empty:
                break
            if r is not None:
                self._pending.append(r)
        t = torch.tensor([len(self._pending), -int(self._stop.is_set()),
                          int(self._staged is not None)]
                         + self._ctrl_propose(), dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self._host_group)
        t = t.tolist()
        n = t[0] if cap is None else min(t[0], cap)
        taken = [self._pending.popleft() for _ in range(n)]
        if t[1] < 0:
            return taken, True
        self._ctrl_agreed(*t[3:])
        if t[2]:
            with self._staged_mu:
                slot = self._staged
            self.swap_at.append(self._turns if self.scheduler is None
                                else self._ticks)
            try:
                slot["ok"] = self._install(slot["params"], slot["retries"],
                                           slot["backoff_s"])
            finally:
                with self._staged_mu:
                    self._staged = None
                slot["done"].set()
        return taken, False

    def _schedule_loop(self) -> None:
        if self._host_group is not None:
            while True:
                taken, stop = self._agree()
                for r in taken:
                    self._submit_slot(r)
                if stop:
                    return
                if not self._schedule_tick():
                    self._stop.wait(self.ecfg.idle_poll_s)
        while not self._stop.is_set():
            if not self._schedule_tick():
                try:
                    r = self.inq.get(timeout=self.ecfg.idle_poll_s)
                except queue.Empty:
                    continue
                if r is not None:
                    self._submit_slot(r)

    def _agreeing(self) -> None:
        """The agreeing thread's loop on a mesh of more than one rank
        (``_schedule_loop`` or ``_deal_loop``); a swap still staged when
        the ranks stop is not installed."""
        try:
            if self.scheduler is not None:
                self._schedule_loop()
            else:
                self._deal_loop()
        finally:
            with self._staged_mu:
                slot, self._staged = self._staged, None
            if slot is not None:
                slot["done"].set()

    # ------------------------------------------------------- background ops
    def _updater(self, period_s: float, perturb: Callable[[Any], Any]):
        while not self._stop.wait(period_s):
            self.hot_swap(perturb(self.store.params))

    def _compactor(self, period_s: float):
        while not self._stop.wait(period_s):
            if self.scheduler is not None:
                # the scheduler thread is the only page allocator in this
                # mode: hand it the request, so the live-rid snapshot never
                # races an admission
                self._compact_req = True
            else:
                self.pages.compact()
                self.stats.inc("compactions")

    def stage_checkpoint(self, directory, step: int):
        """Stream a checkpoint into a shadow params tree while serving
        continues.  Each leaf is CRC-verified as it is read and put on the
        engine's device in the dtype of the leaf it replaces, so the host
        holds at most one shard; a corrupt leaf raises
        :class:`~repro_torch.ft.checkpoint.CheckpointCorrupt` here, before
        any lock is taken or epoch bumped."""
        from ..ft.checkpoint import load_checkpoint

        if _TR.enabled:
            _TR.emit("engine", "swap_stage", step=step)
        return load_checkpoint(directory, step, like=self.store.params,
                               verify=True, device=self.device)

    def hot_swap(self, new_params: Any = None, *,
                 checkpoint: Optional[tuple] = None,
                 retries: Optional[int] = None,
                 backoff_s: Optional[float] = None) -> bool:
        """Weight hot-swap: revoke the model-epoch leases with a BOUNDED
        drain and install ``new_params``.  On :class:`DrainTimeout`,
        degrade instead of crashing and retry with doubling backoff.
        Returns True once the swap lands; False if all retries drained
        out (serving continues on the old weights).  On a mesh of more
        than one rank the swap is staged and lands at the round every rank
        agrees on (module docstring); False also if the ranks stop
        first."""
        if (new_params is None) == (checkpoint is None):
            raise ValueError(
                "hot_swap: pass exactly one of new_params / checkpoint")
        if checkpoint is not None:
            new_params = self.stage_checkpoint(*checkpoint)
        if self._host_group is not None:
            return self._stage_swap(new_params, retries, backoff_s)
        return self._install(new_params, retries, backoff_s)

    def _agreeing_name(self) -> str:
        return "scheduler" if self.scheduler is not None else "dealer"

    def _stage_swap(self, new_params, retries, backoff_s) -> bool:
        """On a mesh of more than one rank: stage ``new_params`` for the
        agreeing thread, which installs it at the round every rank agrees
        on (:meth:`_agree`), and wait for that.  -> the install's result;
        False if the ranks stop first.  One swap is staged at a time."""
        slot = {"params": new_params, "retries": retries,
                "backoff_s": backoff_s, "done": threading.Event(),
                "ok": False}
        with self._swap_serial:
            with self._staged_mu:
                self._staged = slot
            while not slot["done"].wait(self.ecfg.idle_poll_s):
                if self._stop.is_set() and not any(
                        t.name == self._agreeing_name() and t.is_alive()
                        for t in self._threads):
                    with self._staged_mu:
                        if self._staged is slot:
                            self._staged = None
                    break
        return slot["ok"]

    def _install(self, new_params, retries: Optional[int],
                 backoff_s: Optional[float]) -> bool:
        """The swap itself, with the bounded drain and its retries (see
        :meth:`hot_swap`)."""
        ecfg = self.ecfg
        retries = ecfg.swap_retries if retries is None else retries
        backoff = ecfg.swap_backoff_s if backoff_s is None else backoff_s
        for attempt in range(retries + 1):
            t0 = time.monotonic_ns()
            try:
                self.store.swap(new_params,
                                wait_poll_s=ecfg.drain_wait_poll_s,
                                max_wait_s=ecfg.drain_max_wait_s)
            except DrainTimeout:
                self.stats.inc("swap_retries")
                if attempt == retries:
                    self.stats.inc("swap_failures")
                    if _TR.enabled:
                        _TR.emit("engine", "swap_abandon", attempt=attempt)
                    self._degraded.clear()
                    return False
                if _TR.enabled:
                    _TR.emit("engine", "swap_degrade", attempt=attempt)
                self._degraded.set()
                self._stop.wait(backoff * (2 ** attempt))
            else:
                self._degraded.clear()
                self.stats.inc("weight_swaps")
                self._h_swap.observe(time.monotonic_ns() - t0)
                if _TR.enabled:
                    _TR.emit_span("engine", "swap_land", t0,
                                  attempt=attempt, epoch=self.store.epoch)
                return True
        return False

    # --------------------------------------------------------------- public
    def _spawn(self, name: str, target: Callable, *args) -> None:
        """Start a worker whose death is RECORDED and re-raised from
        ``stop()`` / ``check_health()``."""
        def body():
            try:
                if self.device.type == "cuda":
                    # CUDA's current device is each thread's own (device
                    # 0 in a new thread): the engine's threads work on its
                    # card, which on a mesh is this rank's
                    torch.cuda.set_device(self.device)
                target(*args)
            except BaseException as e:
                if _TR.enabled:
                    _TR.emit("engine", "worker_crash", thread=name,
                             error=type(e).__name__)
                snap = None
                try:
                    if self.scheduler is not None:
                        snap = self.scheduler.stats()
                except Exception:
                    pass                 # the snapshot must never mask e
                with self._failures_lock:
                    self._failures.append((name, e, snap))
        t = threading.Thread(target=body, name=name, daemon=True)
        t.start()
        self._threads.append(t)

    def start(self, *, swap_period_s: float = 0.0,
              perturb: Optional[Callable[[Any], Any]] = None,
              compact_period_s: float = 0.0) -> None:
        if self._host_group is not None:
            if self.scheduler is None:
                self._hq = [queue.Queue() for _ in range(self.handlers)]
                for h in range(self.handlers):
                    self._spawn(f"handler-{h}", self._mesh_handler, h)
            self._spawn(self._agreeing_name(), self._agreeing)
        elif self.scheduler is not None:
            self._spawn("scheduler", self._schedule_loop)
        else:
            for h in range(self.handlers):
                self._spawn(f"handler-{h}", self._handler, h)
        if swap_period_s > 0:
            self._spawn("updater", self._updater, swap_period_s,
                        perturb or _perturb)
        if compact_period_s > 0:
            self._spawn("compactor", self._compactor, compact_period_s)

    def submit(self, req: Request) -> None:
        prompt = np.asarray(req.prompt)
        if prompt.size and (prompt.min() < 0
                            or prompt.max() >= self.cfg.vocab):
            raise ValueError(
                f"request {req.rid}: prompt tokens must lie in [0, "
                f"{self.cfg.vocab})")
        if self.sched_cfg is not None and \
                len(req.prompt) + req.max_new > self.sched_cfg.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + max_new "
                f"{req.max_new} exceeds scheduler max_seq "
                f"{self.sched_cfg.max_seq}")
        if _TR.enabled:
            _TR.emit("req", "submit", rid=req.rid,
                     prompt=len(req.prompt), max_new=req.max_new)
        self.inq.put(req)

    def check_health(self) -> None:
        """Raise :class:`EngineFailure` if any worker thread has died."""
        with self._failures_lock:
            if self._failures:
                raise EngineFailure(self._failures)

    def stop(self) -> None:
        """Stop workers and RE-RAISE any recorded thread death."""
        self._stop.set()
        for _ in self._threads:
            self.inq.put(None)
        for t in self._threads:
            t.join(timeout=self.ecfg.join_timeout_s)
        # the graphed steps hold their pools and the parameter trees they
        # were captured on; the handler steps' cache trees go too (their
        # counts stay readable)
        steps = [getattr(self, name, None) for name in (
            "_decode_paged", "_prefill_paged", "_copy_page_step")]
        for hs in list(self._hsteps.values()):
            steps += [hs.prefill, hs.decode]
            hs.caches = None
        for step in steps:
            if isinstance(step, GraphedStep):
                step.reset()
        self.check_health()

    def lock_stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"engine": self.stats.asdict()}
        for name, lk in (("model", self.store.lock),
                         ("pages", self.pages.lock)):
            st = getattr(lk, "stats", None)
            if st is not None:
                out[name] = dataclasses.asdict(st)
        out["device_leases"] = self.registry.stats()
        out["kv_pool"] = self.kv_pool.stats()
        if self.scheduler is None:
            out["handler_steps"] = self.handler_step_stats()
        else:
            out["scheduler"] = self.scheduler.stats()
            if self._h_step.count:
                out["scheduler"]["decode_p50_us"] = round(
                    self._h_step.quantile(0.50) / 1e3, 2)
                out["scheduler"]["decode_p99_us"] = round(
                    self._h_step.quantile(0.99) / 1e3, 2)
        out["metrics"] = self.metrics.snapshot()
        return out
