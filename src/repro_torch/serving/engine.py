"""Serving engine, handler mode: worker threads serve request batches under
BRAVO locks, with the lease path on the device.

The port of ``repro.serving.engine`` without the scheduler.  Each handler
thread gathers up to ``slots_per_handler`` requests, allocates their KV
pages, runs one prefill and then decode steps one token at a time.  Every
step takes **read** permission on the model-epoch lock and on the KV page
map's stripes: the host rwlock (``lock_name``: ``bravo-ba``, ``ba``, ...)
and one lease publish per lock for the whole batch in the shared
visible-readers table of one
:class:`~repro_torch.core.registry.BravoRegistry`.  The weight updater
hot-swaps the model (write lock: revoke the model lock's bias lane and
drain its leases), and page allocation and reclamation revoke the stripe
they touch.  Lease acquire, release and the drain polls run in the
hand-written CUDA kernels K1-K4 (``kernels/``); the model is plain PyTorch.

Scheduler mode (``scheduler=...``, continuous batching over the paged
pool) runs the paged-attention Pallas kernels in ``repro`` and comes with
the next slice; so does ``stage_checkpoint``.  Both raise
``NotImplementedError`` here.  ``repro``'s host-only mode
(``device_leases=False``: no registry, a host page list) is not ported:
every lock here mirrors its readers on the device.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.atomics import LiveMem
from ..core.errors import DrainTimeout
from ..core.factory import LockEnv
from ..core.registry import BravoRegistry, RegistryHandle
from ..device import DeviceLike, resolve
from ..models import model as M
from ..models.common import ModelConfig
from ..obs import TRACER as _TR
from ..obs.metrics import MetricsRegistry
from .kv_pool import KVPool
from .steps import make_decode_step, make_prefill_step

_NOT_PORTED = ("is not ported yet: scheduler mode, the paged KV data plane "
               "and checkpoint staging come with the next slice "
               "(ROADMAP.md)")


@dataclasses.dataclass
class EngineConfig:
    """Engine mechanism timings."""
    handler_poll_s: float = 0.1     # handlers' inq.get timeout
    join_timeout_s: float = 10.0    # stop()'s per-thread join bound
    drain_wait_poll_s: float = 0.0005  # lease revocation poll cadence
    drain_max_wait_s: float = 5.0   # bounded-drain deadline (DrainTimeout)
    swap_retries: int = 3           # hot_swap attempts after a DrainTimeout
    swap_backoff_s: float = 0.05    # base backoff between attempts (doubles)


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


_ENGINE_COUNTERS = (
    "decode_steps",
    "tokens_out",
    "prefills",
    "weight_swaps",
    "swap_retries",     # hot_swap attempts that hit a DrainTimeout
    "swap_failures",    # hot_swaps abandoned after all retries
    "compactions",
    "read_acquires",
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


class ModelStore:
    """Epoch-versioned weights, guarded by a reader-writer lock and by a
    registry lock mirroring the readers on the device."""

    def __init__(self, params, lock, leases: RegistryHandle):
        self.params = params
        self.epoch = 0
        self.lock = lock
        self.leases = leases

    def read_batch(self, reader_ids: torch.Tensor):
        """Epoch read for a request batch: the host read lock plus ONE lease
        publish (K1) for all ``reader_ids`` (device int32); no host-device
        synchronization.  The token carries the grant mask so
        ``done_read_batch`` clears only the leases actually won."""
        tok = self.lock.acquire_read()
        try:
            self.leases.rearm()
            granted = self.leases.acquire(reader_ids)
            gen = self.leases.gen
        except BaseException:            # never leak the host read lock
            self.lock.release_read(tok)
            raise
        return (tok, granted, gen), self.params, self.epoch

    def done_read_batch(self, tok, reader_ids: torch.Tensor):
        host_tok, granted, gen = tok
        try:
            # generation check: after a stuck-lane scrub regenerated the
            # lock value, our slots are already scrubbed and a release
            # would hash to the new value's slots
            if gen == self.leases.gen:
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

    def compact(self, live=None) -> int:
        """Background compaction tick.  Handler mode passes no live set and
        the pool has nothing to plan.  The orphan scrub over a live set is
        scheduler-mode work."""
        if live is not None:
            raise NotImplementedError(f"orphan-page compaction {_NOT_PORTED}")
        return 0


def _perturb(params):
    """Default hot-swap update: every float leaf times (1 + 1e-6)."""
    if isinstance(params, dict):
        return {k: _perturb(v) for k, v in params.items()}
    return params * (1.0 + 1e-6) if params.is_floating_point() else params


class ServingEngine:
    """Handler-mode serving engine on ``device`` (default: the CUDA card,
    raising if there is none).  ``params`` must lie on that device."""

    def __init__(self, cfg: ModelConfig, params, *,
                 lock_name: str = "bravo-ba", handlers: int = 4,
                 max_seq: int = 128, slots_per_handler: int = 4,
                 n_pages: int = 4096, env: Optional[LockEnv] = None,
                 kv_stripes: int = 4,
                 scheduler=None, engine_cfg: Optional[EngineConfig] = None,
                 quant_kv: bool = False, device: DeviceLike = None):
        if scheduler is not None or quant_kv:
            raise NotImplementedError(f"scheduler mode {_NOT_PORTED}")
        self.device = resolve(device)
        self.cfg = cfg
        self.ecfg = engine_cfg or EngineConfig()
        self.env = env or LockEnv(LiveMem())
        self.metrics = MetricsRegistry()
        # ONE registry = one shared visible-readers table for every device
        # lock; each guarded resource gets its own bias lane
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
        self._h_swap = self.metrics.histogram("engine.swap_ns")
        self.inq: "queue.Queue[Optional[Request]]" = queue.Queue()
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._failures: List[tuple] = []
        self._failures_lock = threading.Lock()
        self._degraded = threading.Event()
        self._prefill = make_prefill_step(cfg)
        self._decode = make_decode_step(cfg)

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

    def _serve_batch(self, hid: int, reqs: List[Request]) -> None:
        cfg = self.cfg
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

        # prefill under a read lock (one epoch for the whole batch)
        tok, params, _ = self.store.read_batch(rid_dev)
        try:
            self._prefill(params, {"tokens": toks_dev})
        finally:
            self.store.done_read_batch(tok, rid_dev)
        self.stats.inc("prefills")

        caches = M.init_caches(cfg, B, self.max_seq, dtype=torch.bfloat16,
                               device=dev)
        # feed the prompt token by token through decode steps (per-slot
        # lengths differ), then generate
        outs: List[List[int]] = [[] for _ in range(B)]
        cur = toks_dev[:, :1]
        max_new = max(r.max_new for r in reqs)
        for step in range(S - 1 + max_new):
            clen = torch.full((B,), step + 1, dtype=torch.int32, device=dev)
            # page-map read held across the step: the stripe leases (and
            # host read lock) pin the batch's pages until the step is in
            ptok, _page_mask = self.pages.read_batch(rid_dev)
            try:
                rtok, params_now, _ = self.store.read_batch(rid_dev)
                try:
                    nxt, _logits, caches = self._decode(params_now, caches,
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

    # ------------------------------------------------------- background ops
    def _updater(self, period_s: float, perturb: Callable[[Any], Any]):
        while not self._stop.wait(period_s):
            self.hot_swap(perturb(self.store.params))

    def _compactor(self, period_s: float):
        while not self._stop.wait(period_s):
            self.pages.compact()
            self.stats.inc("compactions")

    def stage_checkpoint(self, directory, step: int):
        raise NotImplementedError(f"stage_checkpoint {_NOT_PORTED}")

    def hot_swap(self, new_params: Any = None, *,
                 checkpoint: Optional[tuple] = None,
                 retries: Optional[int] = None,
                 backoff_s: Optional[float] = None) -> bool:
        """Weight hot-swap: revoke the model-epoch leases with a BOUNDED
        drain and install ``new_params``.  On :class:`DrainTimeout`,
        degrade instead of crashing and retry with doubling backoff.
        Returns True once the swap lands; False if all retries drained
        out (serving continues on the old weights)."""
        if (new_params is None) == (checkpoint is None):
            raise ValueError(
                "hot_swap: pass exactly one of new_params / checkpoint")
        if checkpoint is not None:
            new_params = self.stage_checkpoint(*checkpoint)
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
                target(*args)
            except BaseException as e:
                if _TR.enabled:
                    _TR.emit("engine", "worker_crash", thread=name,
                             error=type(e).__name__)
                with self._failures_lock:
                    self._failures.append((name, e, None))
        t = threading.Thread(target=body, name=name, daemon=True)
        t.start()
        self._threads.append(t)

    def start(self, *, swap_period_s: float = 0.0,
              perturb: Optional[Callable[[Any], Any]] = None,
              compact_period_s: float = 0.0) -> None:
        for h in range(self.handlers):
            self._spawn(f"handler-{h}", self._handler, h)
        if swap_period_s > 0:
            self._spawn("updater", self._updater, swap_period_s,
                        perturb or _perturb)
        if compact_period_s > 0:
            self._spawn("compactor", self._compactor, compact_period_s)

    def submit(self, req: Request) -> None:
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
        out["metrics"] = self.metrics.snapshot()
        return out
