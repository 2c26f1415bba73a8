#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure stops the script with a
non-zero exit and no result line:

1. environment: torch, CUDA, nvcc and the card (name, power limit);
2. build: nvcc compiles ``src/repro_torch/csrc/table_kernels.cu``, the one
   CUDA source of this path;
3. kernels: each table kernel (K1-K4) against its plain PyTorch version on
   the card, exact, at the 4096-slot table with M in {1, 4, 16, 256}, K in
   {1, 5, 128} and seeded sweeps with collisions, cleared bias lanes, -1
   slots and occupied slots; then each kernel's time (CUDA events, median)
   at the engine's shapes beside its plain version's and its bound;
4. sync gate: one lease acquire/release pair through the registry, the
   model-epoch store and the KV pool under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host-device sync);
5. engine: llama3.2-1b at its published width and depth (random weights
   from a seed, float32 parameters, bf16 compute), the handler-mode
   ``ServingEngine`` with weight hot-swap and compaction serving 8 requests
   of 16 prompt tokens and 16 new tokens; the table drains, every page is
   free, K1-K4 each launched during the run, and no request's greedy output
   is one token repeated;
6. tokens: with one request per batch and no swap, the engine's tokens
   equal a direct greedy loop through the port's prefill/decode steps;
7. precision: full-width decode steps with a float32 cache against one
   float32 forward pass over the same tokens (no cache), and the engine's
   bf16 compute against float32 compute on the same parameters, each
   within its stated tolerance.

The random weights are the reference's distributions with the (tied)
embedding scaled by ``EMBED_SCALE``.  Unscaled, the current token's own
embedding dominates the last hidden state, so the tied head returns the
current token and greedy decoding repeats one token whatever the cache
and attention hold; scaled, the blocks' outputs decide the next token.

The last lines are the kernels summary, the card line as nvidia-smi prints
it, and ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, when there is no CUDA device or no ``src/repro_torch`` beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
INT_OPS_PER_S = 67e12          # H100 SXM float32 rate outside tensor cores
SECTOR = 32                    # bytes: the least a device-memory access moves
EMBED_SCALE = 0.01
# Phase 7's tolerances: max |a - b| / max |b| over the logits of every step,
# and the least share of positions whose greedy token agrees.  Read on an
# H100 80GB HBM3 (700 W) at seed 0: 2.4e-6 for the float32 cached decode
# against the forward pass (float32 sums in another order), 0.014 and
# 47 of 48 greedy tokens for bf16 against float32; the limits leave
# margin over those readings.
CACHE_VS_FORWARD_REL = 1e-4
BF16_VS_F32_REL = 0.05
BF16_VS_F32_TOP1 = 0.9
SOURCE = "src/repro_torch/csrc/table_kernels.cu"
REPLACES = {
    "fused_publish_multi": "src/repro/kernels/table_publish.py:204",
    "fused_publish": "src/repro/kernels/table_publish.py:111",
    "revocation_poll": "src/repro/kernels/table_scan.py:67",
    "revocation_poll_multi": "src/repro/kernels/table_scan.py:85",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _case(rng, m, dev):
    """A 4096-slot table (~7% occupied), 128 bias lanes (30% cleared) and M
    requests whose slots collide with each other and with occupied slots,
    with some -1 slots."""
    import numpy as np
    import torch

    table = np.zeros((32, 128), np.int32)
    occ = rng.choice(4096, 300, replace=False)
    table.reshape(-1)[occ] = rng.integers(1, 50, 300)
    rbias = (rng.random(128) < 0.7).astype(np.int32)
    pool = np.concatenate([occ[:5], rng.choice(4096, max(2, m // 4)), [-1]])
    slots = rng.choice(pool, m).astype(np.int32)
    lidx = rng.integers(0, 128, m).astype(np.int32)
    ids = rng.integers(1, 1000, m).astype(np.int32)
    vals = rng.integers(1, 2**31 - 1, 128).astype(np.int32)
    rids = rng.integers(0, 2**31 - 1, m).astype(np.int32)
    rids[m // 2:] = rids[:m - m // 2]
    mask = rng.random(m) < 0.8
    return {k: torch.from_numpy(v).to(dev) for k, v in dict(
        table=table, rbias=rbias, slots=slots, lidx=lidx, ids=ids,
        vals=vals, rids=rids, mask=mask).items()}


def check_kernels(dev, seeds=range(8)) -> dict:
    """Every kernel entry against its plain version on the same inputs on
    ``dev``; -> {kernel: {"cases": n, "max_abs_err": e, "matched": True}}.
    Exact: raises on any difference."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import table_publish as TP

    out = {name: {"cases": 0, "max_abs_err": 0, "matched": True}
           for name in REPLACES}

    def agree(name, got, want):
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        out[name]["cases"] += 1
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
        if err:
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version by {err}")

    ms = [1, 4, 16, 256]
    for seed in seeds:
        rng = np.random.default_rng(seed)
        for m in ms + [int(rng.integers(2, 1025))]:
            c = _case(rng, m, dev)
            # K1, explicit slots
            t = c["table"].clone()
            want_t, want_g = R.publish_multi_ref(t, c["rbias"], c["slots"],
                                                 c["lidx"], c["ids"])
            _, g = K.fused_publish_multi(t, c["rbias"], c["slots"],
                                         c["lidx"], c["ids"])
            agree("fused_publish_multi", t, want_t)
            agree("fused_publish_multi", g, want_g)
            # K1, the registry's hashed entry (per-request and shared lane)
            for lidx in (c["lidx"] % 8, c["lidx"][:1]):
                t = c["table"].clone()
                want_t, want_g = R.acquire_hashed_ref(
                    t, c["rbias"], c["vals"], lidx if lidx.numel() > 1
                    else lidx.reshape(()), c["rids"])
                g = TP.acquire_hashed(t, c["rbias"], c["vals"], lidx,
                                      c["rids"])
                agree("fused_publish_multi", t, want_t)
                agree("fused_publish_multi", g, want_g)
            # K2: publish under a scalar bias, the clear, the masked release
            for rb in (0, 1):
                rbias = torch.full((), rb, dtype=torch.int32, device=dev)
                t = c["table"].clone()
                want_t, want_g = R.publish_ref(t, rbias, c["slots"],
                                               c["ids"])
                _, g = K.fused_publish(t, rbias, c["slots"], c["ids"])
                agree("fused_publish", t, want_t)
                agree("fused_publish", g, want_g)
            t = c["table"].clone()
            want_t = R.clear_ref(t, c["slots"])
            agree("fused_publish", K.fused_clear(t, c["slots"]), want_t)
            t = c["table"].clone()
            lidx = c["lidx"] % 8
            want_t = R.release_hashed_ref(t, c["vals"], lidx, c["rids"],
                                          c["mask"])
            TP.release_hashed(t, c["vals"], lidx, c["rids"], c["mask"])
            agree("fused_publish", t, want_t)
        # K3 and K4 on this seed's table, plus a full table
        c = _case(rng, 4, dev)
        full = torch.full((32, 128), 7, dtype=torch.int32, device=dev)
        for table in (c["table"], full):
            for lock in (0, 1, 7, int(c["table"].max()), 10_000):
                agree("revocation_poll", K.revocation_poll(table, lock),
                      R.poll_ref(table, lock))
            for k in (1, 5, 128):
                locks = torch.from_numpy(
                    rng.integers(0, 60, k).astype(np.int32)).to(dev)
                agree("revocation_poll_multi",
                      K.revocation_poll_multi(table, locks),
                      R.multi_count_ref(table, locks))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------------------
# Phase 3b: kernel times at the engine's shapes
# ---------------------------------------------------------------------------


def _median_ms(fn, n=100, reps=11) -> dict:
    """Per-call times of ``fn`` on the card, medians over ``reps`` CUDA-event
    windows of ``n`` calls each.  ``graph_ms``: the ``n`` calls captured in
    one CUDA graph and replayed, so the window holds device work and almost
    no launch gaps (the kernel's time).  ``call_ms``: the same calls
    launched from Python one by one (what a caller pays per call, wrapper
    and launch included)."""
    import torch

    def window(run, per):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / per

    def eager():
        for _ in range(n):
            fn()

    window(eager, n)                             # warm-up
    call = statistics.median(window(eager, n) for _ in range(reps))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        eager()
    graph.replay()
    replay = statistics.median(window(graph.replay, n) for _ in range(reps))
    return {"graph_ms": replay, "call_ms": call}


def _sectors(idx, elem_bytes=4) -> int:
    """Distinct 32-byte sectors holding the elements at ``idx`` of one
    array (indices < 0 touch nothing)."""
    import torch

    idx = idx.reshape(-1)
    idx = idx[idx >= 0].long()
    return int(torch.unique(idx * elem_bytes // SECTOR).numel())


def _span(n, elem_bytes=4) -> int:
    """Sectors of a contiguous array of ``n`` elements."""
    return -(-n * elem_bytes // SECTOR)


def time_kernels(dev, batch: int, n_locks: int) -> dict:
    """Kernel and plain-version times at the engine's shapes: a lease batch
    of ``batch`` readers (K1 acquire, K2 release) on the 4096-slot table, a
    drain poll (K3) and a hold-count poll of ``n_locks`` locks (K4).  The
    in-place kernels run again and again on one table (after the first
    acquire every slot is taken, so later acquires only read).  -> per
    kernel {ms, plain_ms (CUDA-graph replay), call_ms, plain_call_ms (eager
    calls), bound_ms, bound_by, bytes, ops}.

    ``bytes`` is what one timed call must move, in 32-byte sectors, priced
    at the HBM rate: each input element it reads and each output element
    it writes, once.  K1 and K2 touch only the batch's slots, lanes and
    request vectors (a few sectors), not the whole table; K3 and K4 read
    the whole table.  The table stays in L2 between calls, so the bound
    is lower still against L2's rate."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import table_publish as TP

    rng = np.random.default_rng(0)
    c = _case(rng, batch, dev)
    table = c["table"]
    lidx = c["lidx"] % n_locks
    rbias = torch.ones(128, dtype=torch.int32, device=dev)
    granted = TP.acquire_hashed(table, rbias, c["vals"], lidx, c["rids"])
    locks = c["vals"][:n_locks].contiguous()
    lock0 = int(locks[0])
    # what one timed call moves, from this run's data
    _, _, slots = R.hashed_requests(table, c["vals"], lidx, c["rids"])
    attempt = rbias[lidx.long()] != 0
    _, regrant = R.acquire_hashed_ref(table.clone(), rbias, c["vals"], lidx,
                                      c["rids"])
    req = 2 * _span(batch) + 2 * _sectors(lidx)   # rids, lanes; 2 gathers
    k1 = (req + _sectors(slots[attempt]) + _sectors(slots[regrant])
          + _span(batch, 1))                      # slot reads, stores, grants
    k2 = (req - _sectors(lidx) + _span(batch, 1)  # no rbias; the mask
          + _sectors(slots[granted]))             # stores
    tsec = _span(table.numel())
    shapes = {
        # (kernel, plain, bytes in + out, integer operations)
        "fused_publish_multi": (
            lambda: TP.acquire_hashed(table, rbias, c["vals"], lidx,
                                      c["rids"]),
            lambda: R.acquire_hashed_ref(table, rbias, c["vals"], lidx,
                                         c["rids"]),
            k1 * SECTOR, batch * (40 + batch)),
        "fused_publish": (
            lambda: TP.release_hashed(table, c["vals"], lidx, c["rids"],
                                      granted),
            lambda: R.release_hashed_ref(table, c["vals"], lidx, c["rids"],
                                         granted),
            k2 * SECTOR, batch * (40 + batch)),
        "revocation_poll": (
            lambda: K.revocation_poll(table, lock0),
            lambda: R.poll_ref(table, lock0),
            (tsec + 1) * SECTOR, 2 * table.numel()),
        "revocation_poll_multi": (
            lambda: K.revocation_poll_multi(table, locks),
            lambda: R.multi_count_ref(table, locks),
            (tsec + 2 * _span(n_locks)) * SECTOR,
            2 * table.numel() * n_locks),
    }
    out = {}
    for name, (kern, plain, nbytes, ops) in shapes.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT_OPS_PER_S * 1e3
        k, p = _median_ms(kern), _median_ms(plain)
        out[name] = {"ms": k["graph_ms"], "plain_ms": p["graph_ms"],
                     "call_ms": k["call_ms"], "plain_call_ms": p["call_ms"],
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "bytes": nbytes, "ops": ops}
    return out


# ---------------------------------------------------------------------------
# Phase 4: the lease fast path moves nothing between host and device
# ---------------------------------------------------------------------------


def sync_gate(dev) -> dict:
    import torch

    from repro_torch.core.atomics import LiveMem
    from repro_torch.core.factory import LockEnv
    from repro_torch.core.registry import BravoRegistry
    from repro_torch.serving.engine import ModelStore
    from repro_torch.serving.kv_pool import KVPool

    reg = BravoRegistry(device=dev)
    store = ModelStore({}, LockEnv(LiveMem()).make("bravo-ba"),
                       leases=reg.alloc(name="model"))
    pool = KVPool(64, registry=reg, stripes=4)
    ids = torch.arange(100, 104, dtype=torch.int32, device=dev)

    def pair():
        tok, _, _ = store.read_batch(ids)
        ptok, _ = pool.read_batch(ids)
        pool.done_read_batch(ptok)
        store.done_read_batch(tok, ids)

    pair()                                    # warm-up outside the gate
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pair()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    held = reg.held_multi([store.leases] + pool.locks).tolist()
    if any(held):
        raise AssertionError(f"leases left after the gated pair: {held}")
    return {"pairs": 1, "held_after": held}


# ---------------------------------------------------------------------------
# Phases 5 and 6: the engine at full width, and its tokens
# ---------------------------------------------------------------------------


def _prompts(seed, n, length, vocab):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, length).astype(np.int32)
            for _ in range(n)]


def run_engine(cfg, params, dev, *, n_req, prompt_len, max_new, handlers,
               slots, max_seq, swap_s, compact_s, seed) -> dict:
    import numpy as np

    from repro_torch.kernels import ops as K
    from repro_torch.serving.engine import Request, ServingEngine

    eng = ServingEngine(cfg, params, lock_name="bravo-ba",
                        handlers=handlers, slots_per_handler=slots,
                        max_seq=max_seq, device=dev)
    reqs = [Request(rid=i, prompt=p, max_new=max_new) for i, p in
            enumerate(_prompts(seed, n_req, prompt_len, cfg.vocab))]
    K.reset_launch_counts()
    t0 = time.monotonic()
    for r in reqs:
        eng.submit(r)
    eng.start(swap_period_s=swap_s, compact_period_s=compact_s)
    for r in reqs:
        if not r.done.wait(timeout=600):
            eng.stop()
            raise AssertionError(f"request {r.rid} timed out")
    wall = time.monotonic() - t0
    deadline = time.monotonic() + 30
    while eng.stats.weight_swaps < 1 and time.monotonic() < deadline:
        eng.check_health()
        time.sleep(0.05)
    eng.stop()
    st = eng.lock_stats()
    locks = [eng.store.leases] + eng.kv_pool.locks
    held = eng.registry.held_multi(locks)
    counts = K.launch_counts()
    free = len(eng.pages.free)
    for r in reqs:
        assert r.out is not None and len(r.out) == max_new, r.rid
        assert ((r.out >= 0) & (r.out < cfg.vocab)).all(), r.out
    _check_varied([r.out.tolist() for r in reqs])
    assert st["engine"]["weight_swaps"] >= 1, st["engine"]
    assert st["device_leases"]["revocations"] >= 1, st["device_leases"]
    assert free == eng.kv_pool.n_pages, free
    assert not held.any(), held.tolist()
    # the plain versions (CPU tensors) count no launch
    assert dev.type != "cuda" or all(counts.values()), counts

    def share(s):
        tot = s["fast_acquires"] + s["slow_acquires"]
        return s["fast_acquires"] / tot if tot else 0.0

    tokens = sum(len(r.out) for r in reqs)
    return {"requests": n_req, "tokens": tokens, "wall_s": wall,
            "tokens_per_s": tokens / wall,
            "decode_steps": st["engine"]["decode_steps"],
            "weight_swaps": st["engine"]["weight_swaps"],
            "compactions": st["engine"]["compactions"],
            "revocations": st["device_leases"]["revocations"],
            "lease_publishes": st["device_leases"]["publishes"],
            "fast_path_share": {"model": share(st["model"]),
                                "pages": share(st["pages"])},
            "pages_free": free, "held_after": held.tolist(),
            "launches": counts,
            "outputs": [r.out.tolist() for r in reqs]}


def _check_varied(outputs) -> None:
    """Greedy outputs that repeat one token do not depend on the cache or
    on attention, so a check on them could not fail: refuse them."""
    same = [o for o in outputs if len(set(o)) < 2]
    if same:
        raise AssertionError(f"greedy outputs repeat one token: {same}")


def decode_step_ms(cfg, params, dev, batch, steps, max_seq) -> dict:
    """Synchronized times of the engine's decode step at ``batch`` rows."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.serving.steps import make_decode_step

    step = make_decode_step(cfg)
    caches = M.init_caches(cfg, batch, max_seq, device=dev)
    cur = torch.ones((batch, 1), dtype=torch.int32, device=dev)
    times = []
    for i in range(steps):
        clen = torch.full((batch,), i + 1, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cur, _, caches = step(params, caches, cur, clen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"batch": batch, "steps": steps,
            "median_ms": statistics.median(times[2:]),
            "min_ms": min(times[2:]),
            "profile": _profile_steps(step, params, caches, cur, batch, dev)}


def _profile_steps(step, params, caches, cur, batch, dev, steps=4) -> dict:
    """torch.profiler over a few decode steps: device time per step (the
    sum of kernel times), wall time per step (profiler on), the device's
    busy share and the kernels that take the most device time.  Device
    numbers are None where the profiler recorded no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            clen = torch.full((batch,), 40 + i, dtype=torch.int32,
                              device=dev)
            cur, _, caches = step(params, caches, cur, clen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # kernels only: an operator's entry repeats its kernels' device time
    avgs = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    total = sum(dev_us(e) for e in avgs) / 1e3 / steps
    top = sorted(avgs, key=dev_us, reverse=True)[:6]
    return {"steps": steps, "wall_ms_per_step": wall_ms,
            "device_ms_per_step": total or None,
            "device_busy_share": total / wall_ms if total else None,
            "top": [{"name": e.key[:60], "ms_per_step": dev_us(e) / 1e3 /
                     steps, "calls_per_step": e.count / steps}
                    for e in top]}


def greedy_reference(cfg, params, prompt, max_new, max_seq, dev):
    """The engine's per-batch algorithm for one request, written out: one
    prefill, then the prompt fed token by token through decode steps, then
    greedy generation."""
    import numpy as np
    import torch

    from repro_torch.models import model as M
    from repro_torch.serving.steps import make_decode_step, make_prefill_step

    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    toks = torch.from_numpy(np.asarray(prompt, np.int32)[None]).to(dev)
    prefill(params, {"tokens": toks})
    caches = M.init_caches(cfg, 1, max_seq, dtype=torch.bfloat16, device=dev)
    cur, out = toks[:, :1], []
    s = toks.shape[1]
    for step in range(s - 1 + max_new):
        clen = torch.full((1,), step + 1, dtype=torch.int32, device=dev)
        nxt, _, caches = decode(params, caches, cur, clen)
        if step + 1 < s:
            cur = toks[:, step + 1:step + 2]
        else:
            cur = nxt
            if len(out) < max_new:
                out.append(int(nxt[0, 0]))
    return out


def token_check(cfg, params, dev, *, n_req, prompt_len, max_new, max_seq,
                seed) -> dict:
    from repro_torch.serving.engine import Request, ServingEngine

    eng = ServingEngine(cfg, params, lock_name="bravo-ba", handlers=1,
                        slots_per_handler=1, max_seq=max_seq, device=dev)
    prompts = _prompts(seed, n_req, prompt_len, cfg.vocab)
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    eng.start()
    for r in reqs:
        eng.submit(r)
    for r in reqs:
        if not r.done.wait(timeout=600):
            eng.stop()
            raise AssertionError(f"request {r.rid} timed out")
    eng.stop()
    for r, p in zip(reqs, prompts):
        want = greedy_reference(cfg, params, p, max_new, max_seq, dev)
        if r.out.tolist() != want:
            raise AssertionError(f"request {r.rid}: engine {r.out.tolist()} "
                                 f"!= direct greedy loop {want}")
    _check_varied([r.out.tolist() for r in reqs])
    return {"requests": n_req, "equal": True,
            "tokens": [r.out.tolist() for r in reqs]}


def precision_check(cfg, params, dev, *, batch, length, seed) -> dict:
    """Decode steps over one seeded token sequence per row (teacher-forced,
    so both sides see the same tokens), at full width:

    * float32 compute with a float32 cache against ONE float32 forward pass
      over the whole sequence with no cache: a wrong cache write, position
      or cached attention shows here;
    * the engine's bf16 compute (bf16 cache) against float32 compute (float
      32 cache) on the same parameters.

    Each reading is max |a - b| / max |b| over every step's logits and the
    share of positions whose greedy token agrees; raises past the stated
    tolerances."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import model as M
    from repro_torch.serving.steps import make_decode_step

    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    toks = torch.from_numpy(np.stack(
        _prompts(seed, batch, length, cfg.vocab))).to(dev)

    def decode_all(c, cache_dtype):
        step = make_decode_step(c)
        caches = M.init_caches(c, batch, length, dtype=cache_dtype,
                               device=dev)
        out = []
        for t in range(length):
            clen = torch.full((batch,), t + 1, dtype=torch.int32, device=dev)
            _, logits, caches = step(params, caches, toks[:, t:t + 1], clen)
            out.append(logits.float())
        return torch.stack(out, 1)                        # (B, T, V)

    with torch.no_grad():
        bf16 = decode_all(cfg, torch.bfloat16)
        f32 = decode_all(cfg32, torch.float32)
        full = M.forward(params, cfg32, {"tokens": toks},
                         make_caches=False)[0].float()

    def reading(a, b):
        return {"rel": float((a - b).abs().max() / b.abs().max()),
                "top1": float((a.argmax(-1) == b.argmax(-1)).float().mean())}

    cache = reading(f32, full)
    half = reading(bf16, f32)
    out = {"batch": batch, "steps": length,
           "cache_vs_forward": cache, "bf16_vs_f32": half,
           "tolerance": {"cache_vs_forward_rel": CACHE_VS_FORWARD_REL,
                         "cache_vs_forward_top1": 1.0,
                         "bf16_vs_f32_rel": BF16_VS_F32_REL,
                         "bf16_vs_f32_top1": BF16_VS_F32_TOP1}}
    if (cache["rel"] > CACHE_VS_FORWARD_REL or cache["top1"] < 1.0
            or half["rel"] > BF16_VS_F32_REL
            or half["top1"] < BF16_VS_F32_TOP1):
        raise AssertionError(f"precision outside tolerance: {out}")
    return out


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import llama3_2_1b
    from repro_torch.kernels import _build
    from repro_torch.kernels import table_publish as TP
    from repro_torch.models import model as M

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    emit({"phase": "environment", "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "nvcc": run([_build.nvcc(), "--version"]).splitlines()[-1],
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card})

    t0 = time.monotonic()
    _, nvcc_s = _build.compile_source(_build.CSRC / TP.SOURCE)
    emit({"phase": "build", "source": SOURCE,
          "seconds": time.monotonic() - t0, "nvcc_seconds": nvcc_s})

    checks = check_kernels(dev)
    emit({"phase": "kernels", "checks": checks})

    cfg = llama3_2_1b.CONFIG
    handlers, slots = 2, 4
    held_locks = 5                    # the model lock + 4 KV stripes
    times = time_kernels(dev, batch=slots, n_locks=held_locks)
    emit({"phase": "kernel_times", "card": card, "batch": slots,
          "bound_assumes": "32-byte sectors at the HBM rate, 3.35 TB/s",
          "times": times})

    emit({"phase": "sync_gate", **sync_gate(dev)})

    t0 = time.monotonic()
    params = M.init_params(args.seed, cfg, device=dev)
    params["embed"].mul_(EMBED_SCALE)
    torch.cuda.synchronize()
    emit({"phase": "init_params", "config": cfg.name,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "params": sum(int(x.numel()) for x in _leaves(params)),
          "embed_scale": EMBED_SCALE, "seconds": time.monotonic() - t0})
    eng = run_engine(cfg, params, dev, n_req=8, prompt_len=16, max_new=16,
                     handlers=handlers, slots=slots, max_seq=64,
                     swap_s=0.25, compact_s=0.2, seed=args.seed)
    step = decode_step_ms(cfg, params, dev, batch=slots, steps=32,
                          max_seq=64)
    emit({"phase": "engine", "card": card, **eng, "decode_step": step})

    emit({"phase": "tokens", **token_check(cfg, params, dev, n_req=2,
                                           prompt_len=16, max_new=8,
                                           max_seq=64, seed=args.seed + 1)})
    emit({"phase": "precision", **precision_check(
        cfg, params, dev, batch=2, length=24, seed=args.seed + 2)})

    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": eng["launches"][name],
         "max_abs_err": checks[name]["max_abs_err"],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"], "library_ms": None}
        for name in REPLACES]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    sys.exit(main())
