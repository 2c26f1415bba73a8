"""Seeded fault injection for the serving engine's revocation protocol.

The port of ``repro.ft.faults``.  The BRAVO writer path (revoke -> drain
-> swap -> rearm) is only as credible as its behaviour when the protocol's
assumptions break.  This module injects seven faults at the engine's real
seams (the device-lease handle, the page table, the updater thread, the
checkpoint stream), replays the same scheduler traffic under each, and
checks three invariants against a fault-free golden run:

* **token exactness**: every request's output equals the golden run's
  (greedy decode and identity weight swaps make this exact, not
  statistical);
* **refcount drain-to-zero**: the KV pool's free count returns to
  ``n_pages`` (no leaked or double-freed page);
* **lane hygiene**: the shared visible-readers table is all zero after
  ``stop()``: every lease released or scrubbed, no stale lane that a
  rearmed lock could mistake for its own.

Injectors are deterministic given ``seed``: delays, stall durations, the
corrupted leaf and steal sizes all come from one
``np.random.default_rng(seed * 1000 + FAULTS.index(fault))``.  Thread
interleavings still vary; the invariants are the properties that must hold
under any interleaving.

Run the matrix (on the CUDA card unless ``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.ft.faults --matrix --seed 0
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve
from ..obs import TRACER as _TR
from ..obs.trace import format_timeline
from .checkpoint import CheckpointCorrupt, read_manifest, save_checkpoint
from .straggler import StragglerDetector

FAULTS = ["delayed_revoke_ack", "dropped_revoke_ack", "stalled_reader",
          "straggler_tick", "pool_exhaustion", "corrupt_checkpoint",
          "thread_crash"]

N_PAGES = 64


# ---------------------------------------------------------------------------
# Seam proxies
# ---------------------------------------------------------------------------


class LeaseProxy:
    """Transparent wrapper over a lease handle (``RegistryHandle`` /
    ``LeaseHandle``): forwards everything, including the ``gen``
    attribute the store's generation check reads, while letting an
    injector intercept one method.  Installed as ``store.leases``."""

    def __init__(self, inner):
        object.__setattr__(self, "_inner", inner)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_inner"), name)


class DelayedRelease(LeaseProxy):
    """Delayed revocation acks: every device-lease release lands late by a
    seeded delay.  A bounded drain must TOLERATE late acks (they arrive
    within the deadline): this fault should complete with zero
    ``DrainTimeout``s, just a longer drain.

    The delay is a host sleep before the release is enqueued, in the
    thread that releases (the scheduler loop, which holds the host read
    lock meanwhile); nothing waits on the card, so the work already
    queued on the stream runs on."""

    def __init__(self, inner, rng, lo_s=0.002, hi_s=0.02):
        super().__init__(inner)
        object.__setattr__(self, "_delays",
                           rng.uniform(lo_s, hi_s, size=256))
        object.__setattr__(self, "_n", [0])

    def release(self, reader_ids, granted=None):
        n = object.__getattribute__(self, "_n")
        d = object.__getattribute__(self, "_delays")
        if _TR.enabled:
            _TR.emit("fault", "delayed_ack",
                     delay_us=round(float(d[n[0] % len(d)]) * 1e6))
        time.sleep(float(d[n[0] % len(d)]))
        n[0] += 1
        return object.__getattribute__(self, "_inner").release(
            reader_ids, granted=granted)


# ---------------------------------------------------------------------------
# Traffic harness
# ---------------------------------------------------------------------------


def _build_engine(cfg, params, *, device: DeviceLike = None,
                  n_pages=N_PAGES, drain_max_wait_s=0.25, token_budget=16):
    from ..serving.engine import EngineConfig, ServingEngine
    from ..serving.scheduler import SchedulerConfig

    sc = SchedulerConfig(max_slots=4, page_size=4, max_seq=32,
                         prefill_chunk=8, prefill_rows=2,
                         token_budget=token_budget)
    ecfg = EngineConfig(idle_poll_s=0.01, handler_poll_s=0.02,
                        drain_max_wait_s=drain_max_wait_s,
                        swap_retries=4, swap_backoff_s=0.02)
    return ServingEngine(cfg, params, n_pages=n_pages, scheduler=sc,
                         engine_cfg=ecfg, device=device)


def _prompts():
    return [np.arange(1, 6, dtype=np.int32) + i for i in range(3)]


def _serve(eng, prompts, max_new=4, *,
           mid: Optional[Callable[[], None]] = None,
           start_kw: Optional[dict] = None) -> List[List[int]]:
    """Submit the canonical traffic, run ``mid()`` on the calling thread
    while it decodes, wait for every request.  Nothing is ever dropped:
    a request that times out is an immediate failure."""
    from ..serving.engine import Request

    eng.start(**(start_kw or {}))
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    if mid is not None:
        mid()
    for r in reqs:
        assert r.done.wait(timeout=600), f"request {r.rid} timed out"
    return [list(map(int, r.out)) for r in reqs]


def _hygiene(eng, n_pages) -> Dict[str, Any]:
    """The two post-conditions every fault must leave behind; called after
    ``stop()``, so the one read of the table is outside any lease
    window."""
    table_live = int((eng.registry.table != 0).sum().item())
    return {"free_count": eng.kv_pool.free_count(),
            "free_ok": eng.kv_pool.free_count() == n_pages,
            "table_live_slots": table_live,
            "table_clean": table_live == 0}


def _reader(eng, rid: int) -> torch.Tensor:
    return torch.tensor([rid], dtype=torch.int32, device=eng.device)


def corrupt_copy(directory: str | Path, step: int, new_step: int,
                 leaf: int) -> Path:
    """Step ``new_step`` beside ``step`` in ``directory``: a copy of its
    manifest with leaf ``leaf``'s CRC flipped, and symbolic links to its
    shards (no shard is written again)."""
    d = Path(directory)
    src = (d / f"step_{step:09d}").resolve()
    dst = d / f"step_{new_step:09d}"
    dst.mkdir()
    manifest = read_manifest(d, step)
    manifest["leaves"][leaf]["crc32"] ^= 0x5A5A5A5A
    manifest["step"] = new_step
    for fn in manifest["shards"]:
        os.symlink(src / fn, dst / fn)
    (dst / "manifest.json").write_text(json.dumps(manifest))
    return dst


# ---------------------------------------------------------------------------
# The faults
# ---------------------------------------------------------------------------


def _fault_delayed_revoke_ack(cfg, params, rng, golden, device, checkpoint):
    eng = _build_engine(cfg, params, device=device)
    eng.store.leases = DelayedRelease(eng.store.leases, rng)
    swapped = []

    def mid():
        swapped.append(eng.hot_swap(params))      # identity weights

    toks = _serve(eng, _prompts(), mid=mid)
    eng.stop()
    st = eng.registry.stats()
    return toks, {"swap_ok": swapped == [True],
                  # late acks still beat the deadline: no timeout, no scrub
                  "no_timeout": st["drain_timeouts"] == 0,
                  **_hygiene(eng, N_PAGES)}


def _fault_dropped_revoke_ack(cfg, params, rng, golden, device, checkpoint):
    """One epoch read's device-lease release is LOST (the host read lock
    is released normally; only the ack never reaches the table).  The
    next revoke must hit its deadline, scrub the stuck lane, and the
    hot-swap must land on retry."""
    eng = _build_engine(cfg, params, device=device)

    def mid():
        rid = int(rng.integers(900, 1000))
        (host_tok, granted, _gen), _, _ = eng.store.read_batch(
            _reader(eng, rid))
        if _TR.enabled:
            _TR.emit("fault", "dropped_ack", rid=rid)
        # drop the device ack: release ONLY the host lock
        eng.store.lock.release_read(host_tok)
        assert granted is not None
        ok = eng.hot_swap(params)
        assert ok, "hot_swap should land once the stuck lane is scrubbed"

    toks = _serve(eng, _prompts(), mid=mid)
    eng.stop()
    st = eng.registry.stats()
    es = eng.lock_stats()["engine"]
    return toks, {"drain_timeouts_ok": st["drain_timeouts"] >= 1,
                  "scrubbed": st["lane_scrubs"] >= 1,
                  "swap_retried": es["swap_retries"] >= 1,
                  "swap_landed": es["weight_swaps"] >= 1,
                  **_hygiene(eng, N_PAGES)}


def _fault_stalled_reader(cfg, params, rng, golden, device, checkpoint):
    """A wedged reader publishes a model-epoch lease and never releases
    (its host thread is gone, so it holds no host lock).  The bounded
    drain times out, the lane scrub regenerates the lock value, and the
    retried swap proceeds: the stale publish can never match again."""
    eng = _build_engine(cfg, params, device=device)
    stall_rid = int(rng.integers(800, 900))

    def mid():
        eng.store.leases.rearm()
        granted = eng.store.leases.acquire(_reader(eng, stall_rid))
        if _TR.enabled:
            _TR.emit("fault", "stalled_reader", rid=stall_rid)
        assert int(granted[0]) == 1, "stall must win its lease"
        old_gen = eng.store.leases.gen
        ok = eng.hot_swap(params)
        assert ok, "hot_swap should land after the stuck-lane scrub"
        assert eng.store.leases.gen > old_gen, "scrub must bump the gen"

    toks = _serve(eng, _prompts(), mid=mid)
    eng.stop()
    st = eng.registry.stats()
    return toks, {"drain_timeouts_ok": st["drain_timeouts"] >= 1,
                  "scrubbed": st["lane_scrubs"] >= 1,
                  "parked": st["parks"] >= 0,
                  **_hygiene(eng, N_PAGES)}


def _fault_straggler_tick(cfg, params, rng, golden, device, checkpoint):
    """One host's step ticks straggle (seeded EWMA ~6x the median) while
    serving continues with a seeded per-release delay standing in for the
    slow tick.  The detector must flag exactly the straggler; serving
    must not care."""
    eng = _build_engine(cfg, params, device=device)
    eng.store.leases = DelayedRelease(eng.store.leases, rng,
                                      lo_s=0.001, hi_s=0.01)
    det = StragglerDetector(hosts=4, slow_factor=2.0)
    base = rng.uniform(8.0, 12.0, size=(4, 32))
    base[3] *= 6.0                           # host 3 straggles
    if _TR.enabled:
        _TR.emit("fault", "straggler_tick", host=3)
    for step in range(32):
        for h in range(4):
            det.heartbeat(h, float(base[h, step]))
    toks = _serve(eng, _prompts())
    eng.stop()
    snap = det.snapshot()
    return toks, {"straggler_flagged": snap["stragglers"] == [3],
                  "none_dead": snap["dead"] == [],
                  **_hygiene(eng, N_PAGES)}


def _fault_pool_exhaustion(cfg, params, rng, golden, device, checkpoint):
    """A rogue allocation steals most free pages mid-prefill; the
    scheduler must defer/evict rather than stream garbage, and once the
    pages come back every request finishes with exact tokens."""
    eng = _build_engine(cfg, params, device=device, token_budget=8)
    fake_rid = 777
    steal = int(rng.integers(48, 58))        # of 64: leaves ~1-4 slots' worth

    def mid():
        if _TR.enabled:
            _TR.emit("fault", "steal_pages", rid=fake_rid, n=steal)
        got = eng.pages.allocate(fake_rid, steal)
        assert len(got) == steal
        time.sleep(float(rng.uniform(0.2, 0.4)))
        eng.pages.reclaim(fake_rid)
        if _TR.enabled:
            _TR.emit("fault", "return_pages", rid=fake_rid, n=steal)

    toks = _serve(eng, _prompts(), mid=mid)
    eng.stop()
    return toks, _hygiene(eng, N_PAGES)


def _fault_corrupt_checkpoint(cfg, params, rng, golden, device, checkpoint):
    """A corrupted checkpoint stream must be rejected during STAGING
    (typed, at the first bad tensor, before any lock is taken or epoch
    swapped) and serving continues on the old weights.  The corruption is
    a manifest CRC mismatch on one seeded leaf of a copy of the
    checkpoint: the manifest is copied, the shards linked.
    ``checkpoint=(dir, step)`` names an existing checkpoint of
    ``params``; without it ``params`` are saved once to a temporary
    directory."""
    eng = _build_engine(cfg, params, device=device)
    outcome: Dict[str, Any] = {}
    made = bad = None
    if checkpoint is None:
        made = tempfile.mkdtemp(prefix="bravo_ckpt_")
        save_checkpoint(made, 1, params)
        checkpoint = (made, 1)
    src_dir, src_step = checkpoint
    bad_step = src_step + 1
    while (Path(src_dir) / f"step_{bad_step:09d}").exists():
        bad_step += 1
    try:
        n_leaves = len(read_manifest(src_dir, src_step)["leaves"])
        leaf = int(rng.integers(0, n_leaves))
        bad = corrupt_copy(src_dir, src_step, bad_step, leaf)
        if _TR.enabled:
            _TR.emit("fault", "corrupt_checkpoint", leaf=leaf)

        def mid():
            epoch_before = eng.store.epoch
            try:
                eng.hot_swap(checkpoint=(src_dir, bad_step))
            except CheckpointCorrupt as e:
                outcome["rejected"] = True
                outcome["typed"] = e.leaf == leaf
            else:
                outcome["rejected"] = False
            outcome["epoch_unchanged"] = eng.store.epoch == epoch_before

        toks = _serve(eng, _prompts(), mid=mid)
        eng.stop()
    finally:
        for d in (made, bad):
            if d is not None:
                shutil.rmtree(d, ignore_errors=True)
    return toks, {"rejected": outcome.get("rejected", False),
                  "typed": outcome.get("typed", False),
                  "epoch_unchanged": outcome.get("epoch_unchanged", False),
                  **_hygiene(eng, N_PAGES)}


def _fault_thread_crash(cfg, params, rng, golden, device, checkpoint):
    """The updater thread crashes mid-serve.  Serving finishes untouched,
    and stop() RE-RAISES the death with the scheduler state attached.
    The calling thread waits for the crash before it stops the engine,
    so a run whose traffic is done within the updater's first period
    still crashes it."""
    from ..serving.engine import EngineFailure
    eng = _build_engine(cfg, params, device=device)
    boom = RuntimeError("injected: updater crash")

    def bad_perturb(p):
        if _TR.enabled:
            _TR.emit("fault", "thread_crash", error=str(boom))
        raise boom

    def mid():
        # wait (bounded) for the crash: traffic that finishes within the
        # updater's first period would otherwise stop it before it runs
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                eng.check_health()
            except EngineFailure:
                return
            time.sleep(0.005)

    toks = _serve(eng, _prompts(), mid=mid,
                  start_kw={"swap_period_s": 0.05, "perturb": bad_perturb})
    crashed = typed = snap_ok = False
    try:
        eng.stop()
    except EngineFailure as e:
        crashed = True
        names = [n for n, _, _ in e.failures]
        typed = "updater" in names and any(exc is boom
                                           for _, exc, _ in e.failures)
        snap_ok = all(s is None or isinstance(s, dict)
                      for _, _, s in e.failures)
    return toks, {"reraised": crashed, "typed": typed,
                  "snapshot_ok": snap_ok, **_hygiene(eng, N_PAGES)}


_RUNNERS = {
    "delayed_revoke_ack": _fault_delayed_revoke_ack,
    "dropped_revoke_ack": _fault_dropped_revoke_ack,
    "stalled_reader": _fault_stalled_reader,
    "straggler_tick": _fault_straggler_tick,
    "pool_exhaustion": _fault_pool_exhaustion,
    "corrupt_checkpoint": _fault_corrupt_checkpoint,
    "thread_crash": _fault_thread_crash,
}


# ---------------------------------------------------------------------------
# The matrix
# ---------------------------------------------------------------------------


def smoke_model(device: DeviceLike = None) -> Tuple[Any, Any]:
    """The default model: the llama3.2-1b smoke config with parameters from
    seed 0 on ``device``."""
    from .. import configs
    from ..models import model as M

    cfg = configs.get_smoke("llama3.2-1b")
    return cfg, M.init_params(0, cfg, device=device)


def golden_run(cfg, params, device: DeviceLike = None) -> List[List[int]]:
    """The fault-free reference: same traffic, no injector, no swap
    (identity swaps cannot change greedy tokens, so their absence is not
    a difference the comparison can see)."""
    eng = _build_engine(cfg, params, device=device)
    toks = _serve(eng, _prompts())
    eng.stop()
    assert eng.kv_pool.free_count() == N_PAGES, "golden run leaked pages"
    return toks


def run_fault(fault: str, seed: int, cfg=None, params=None,
              golden: Optional[List[List[int]]] = None, *,
              device: DeviceLike = None,
              checkpoint: Optional[tuple] = None) -> Dict[str, Any]:
    """Run one fault; returns the per-invariant verdict dict.
    ``checkpoint=(dir, step)``: a checkpoint of ``params`` that
    ``corrupt_checkpoint`` copies instead of saving its own."""
    device = resolve(device)
    if cfg is None:
        cfg, params = smoke_model(device)
    rng = np.random.default_rng(seed * 1000 + FAULTS.index(fault))
    if golden is None:
        golden = golden_run(cfg, params, device)
    # Trace the whole fault run: clear the ring so the timeline dumped on
    # failure covers exactly this injection, and restore the caller's
    # tracer state afterwards.
    was_enabled = _TR.enabled
    _TR.clear()
    _TR.enable()
    _TR.emit("fault", "inject", fault=fault, seed=seed)
    try:
        toks, checks = _RUNNERS[fault](cfg, params, rng, golden, device,
                                       checkpoint)
    except BaseException:
        _dump_timeline(fault)
        raise
    finally:
        if not was_enabled:
            _TR.disable()
    checks["tokens_exact"] = toks == golden
    checks["ok"] = all(bool(v) for k, v in checks.items()
                       if isinstance(v, bool))
    if not checks["ok"]:
        _dump_timeline(fault)
    return {"fault": fault, "seed": seed, **checks}


def _dump_timeline(fault: str, limit: int = 200) -> None:
    """On any fault-matrix failure, print the per-request / per-lock event
    timeline so the failure is debuggable from the logs alone."""
    events = _TR.snapshot()
    print(f"--- obs timeline for failed fault {fault!r} "
          f"(last {min(limit, len(events))} of {len(events)} events) ---",
          file=sys.stderr)
    print(format_timeline(events[-limit:]), file=sys.stderr)
    print("--- end obs timeline ---", file=sys.stderr, flush=True)


def run_matrix(seed: int, faults: Optional[List[str]] = None, *,
               cfg=None, params=None, device: DeviceLike = None,
               checkpoint: Optional[tuple] = None) -> List[dict]:
    """The golden run, then each fault (default: all of :data:`FAULTS`),
    printing each verdict as one JSON line.  Default model:
    :func:`smoke_model`."""
    device = resolve(device)
    if cfg is None:
        cfg, params = smoke_model(device)
    golden = golden_run(cfg, params, device)
    out = []
    for f in faults or FAULTS:
        res = run_fault(f, seed, cfg, params, golden, device=device,
                        checkpoint=checkpoint)
        print(json.dumps(res), flush=True)
        out.append(res)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="seeded fault-injection matrix for the serving engine")
    ap.add_argument("--matrix", action="store_true", help="run every fault")
    ap.add_argument("--fault", choices=FAULTS, help="run one fault")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    faults = [args.fault] if args.fault else None
    if not args.matrix and not args.fault:
        ap.error("pass --matrix or --fault NAME")
    results = run_matrix(args.seed, faults, device=args.device)
    bad = [r["fault"] for r in results if not r["ok"]]
    print(json.dumps({"chaos": "FAIL" if bad else "OK", "failed": bad,
                      "n": len(results)}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
