#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure stops the script with a
non-zero exit and no result line:

1. environment: torch, CUDA, nvcc and the card (name, power limit);
2. build: nvcc compiles the two CUDA sources,
   ``src/repro_torch/csrc/table_kernels.cu`` (K1-K4, K9, K10) and
   ``src/repro_torch/csrc/paged_attn.cu`` (K5-K8), one process each, both
   started together;
3. kernels: each table kernel (K1-K4) against its plain PyTorch version on
   the card, exact, at the 4096-slot table with M in {1, 4, 16, 256}, K in
   {1, 5, 128} and seeded sweeps with collisions, cleared bias lanes, -1
   slots and occupied slots; the legacy table kernels K9 (the revocation
   scan) and K10 (the sequential publish) the same way, exact, with K10's
   sequential edge cases (duplicate unconditional stores, id 0, slots
   outside the table, a table past 48 KiB); K1/K2 also at a batch of
   3000 (three chunks of 1024) and the single-lock K2 lease entries on
   64-bit reader ids; the paged attention kernels
   K5 (decode) and K6 (chunk prefill) against theirs at the engine's
   shapes, at gemma-2b's and granite-20b's head shapes (hd 256; 48 query
   heads on one KV head), at head dims the kernels pad (hubert-xlarge's
   80, phi-3-vision's 96, both one query head a KV head, and 12, whose
   bf16 and int8 rows are no whole number of 16-byte chunks) and in seeded
   sweeps over the traps (-1 lanes
   inside and past ``cache_len``, ``cache_len`` 0, a partial last page,
   padding columns, ``new_lens`` 0, a chunk longer than the paged prefix,
   every q/page type pair), within the stated tolerances; K5 also at
   forced KV split counts (1, 2, 3, one per lane), on pages that are not
   16-byte aligned and at the long-context shape (16 requests of
   3584-4096 positions); K7 and K8 (the same over int8 pages with per-page
   scales) against theirs over the same traps plus an all-zero page and a
   page whose group max saturates (spikes of 6, absolute tolerance, and of
   40, relative), K7 at the same forced splits, unaligned pages and
   long-context shape, and against the float32 K5/K6 on the pages before
   quantization; ``requant_scatter`` (the quantized store's
   write path) on the card byte for byte against the CPU; then each
   kernel's time (CUDA events, median) at the engine's shapes beside its
   plain version's, its bound and, for K5-K8,
   ``scaled_dot_product_attention`` over K/V already gathered dense (and
   dequantized, for K7/K8); K5/K7 also at the long-context shape, each
   beside the parent design (the chunk kernel at S = 1) and the kernel
   forced to one split, timed in the same run;
3c. device_bravo: the port's device-BRAVO benchmark
   (``repro_torch.benchmarks.device_bravo``, batch 64, 100 iterations):
   the single-lock ``DeviceLeaseTable`` (K2 acquire and release, K3 drain
   polls) against the legacy host-looped path (K10 publish and clear, 5
   host transfers a pair), K9 and K10 against their plain versions, the
   in-place proof and the sync gate of its pair; registry_bench: the
   port's registry benchmark (``repro_torch.benchmarks.registry``, 24
   rounds), with the shared-bias flap of the scalar table against the
   registry's per-lock lanes; each fails the script on any failed check;
4. sync gate: one lease acquire/release pair through the registry, the
   model-epoch store and the KV pool, one scheduler decode tick at full
   width (both leases, the paged decode step through K5, the releases) and
   one on the quantized store (``requant_scatter`` into the int8 pages,
   then K7), each under ``torch.cuda.set_sync_debug_mode("error")`` (no
   host-device sync); the ticks' tokens are read after the gate closes;
5. engine: llama3.2-1b at its published width and depth (random weights
   from a seed, float32 parameters, bf16 compute), the handler-mode
   ``ServingEngine`` with weight hot-swap and compaction serving 8 requests
   of 16 prompt tokens and 16 new tokens; the table drains, every page is
   free, K1-K4 each launched during the run, and no request's greedy output
   is one token repeated;
6. scheduler: the same model in scheduler mode (continuous batching over a
   2.1 GB bf16 page store, prefix cache on) serving 12 requests in two
   waves under hot-swap and compaction, the second wave repeating or
   sharing the first wave's prompts; every request finishes, every page is
   free with no refcount left, the table drains, the prefix cache saved
   pages and copied a boundary page, and K1, K2, K3, K5 and K6 each
   launched during the run; then the same run on the quantized store
   (``quant_kv=True``, int8 pages with float32 scales, 1.07 GB of K/V),
   which must launch K7 and K8 and neither K5 nor K6, count its quantized
   tokens and prefix hits, hold exactly half the bf16 run's K/V bytes and
   agree with the bf16 run's tokens on at least the stated share;
7. tokens: with one request per batch and no swap, the handler-mode
   engine's tokens equal a direct greedy loop through the port's
   prefill/decode steps;
8. precision: full-width decode steps with a float32 cache against one
   float32 forward pass over the same tokens (no cache); the engine's bf16
   compute against float32 compute on the same parameters; the paged path
   (prefill in chunks, then paged decode, float32 pages) against the same
   forward pass; the same over the quantized store (int8 pages, float32
   compute, through K8 and K7); and the scheduler engine's bf16 tokens
   against the direct greedy loop on the same prompts, each within its
   stated tolerance.

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
import concurrent.futures
import contextlib
import functools
import itertools
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
# The paged path against the forward pass (float32 compute and pages) is
# held to the cached decode's limit, 1e-4 relative with every greedy token
# equal.  The scheduler engine's bf16 tokens against the handler-mode greedy
# loop: both round K/V to bf16, but the paged prefill computes a prompt's
# K/V in chunks where the loop feeds it token by token, so bf16 rounding
# differs and one flipped token changes the rest of its request.  Read on
# an H100 80GB HBM3 (700 W) at seed 0: 2.6e-6 for the paged path; 0.80 of
# the scheduler's tokens equal (4 of 12 requests diverge, at tokens 0, 1,
# 4 and 14); the limits leave margin over those readings.
PAGED_VS_FORWARD_REL = 1e-4
SCHED_VS_GREEDY_SHARE = 0.6
# K5/K6 against their plain versions: float32 outputs within 1e-5 absolute
# (outputs are O(1); the sums run in another order; readings <= 6e-7 on an
# H100 80GB HBM3, 700 W); bfloat16 outputs within one bf16 step at the
# largest output (2**-7 * max |out|): both sides round float32 values that
# differ in the last bits, and one near a rounding boundary can go either
# way (largest reading on the same card 3.9e-3, inside that step).
PAGED_F32_ATOL = 1e-5
PAGED_BF16_ULP = 2.0 ** -7
# K7/K8 are held to the same tolerances against their plain versions, and
# against the float32 plain K5/K6 on the pages before quantization to
# ``repro``'s bound on the quantized attention output at unit-variance
# inputs (0.05 absolute; tests/test_quant_kv.py, ROADMAP R2).  Readings on
# an H100 80GB HBM3 (700 W): 0.023 (K7) and 0.029 (K8).
QUANT_VS_F32_ATOL = 0.05
# The paged path over the quantized store against the float32 forward pass
# (float32 compute, int8 pages), and the quantized scheduler run's tokens
# against the bf16 scheduler run's on the same prompts.  int8 pages round
# each K/V element by up to amax / 254 of its (page, KV head) group, so the
# logits move far more than float32 sums do, and one flipped greedy token
# changes the rest of its request.  Read on an H100 80GB HBM3 (700 W) at
# seed 0: 0.022 relative with 0.96 of the greedy tokens equal; 0.64 of the
# quantized run's tokens equal to the bf16 run's (7 of 12 requests
# diverge); the limits leave margin over those readings.
QUANT_PAGED_VS_FORWARD_REL = 0.05
QUANT_PAGED_VS_FORWARD_TOP1 = 0.9
QUANT_VS_BF16_SHARE = 0.5
# The decode kernel's long-context shape (K5/K7 checks and times): B 16,
# H 32, KVH 8, hd 64 (llama3.2-1b's attention), 256 lanes of 16 positions
# in a 4096-page store, cache_len drawn from [3584, 4096].
LONG_CONTEXT = dict(b=16, h=32, kvh=8, hd=64, ps=16, lanes=256, n_pages=4096)
LONG_LENGTHS = (3584, 4096)
# The head shapes of two dense configs of the reference that K5-K8 refused
# before they looped warps over heads and took hd 256: gemma-2b (8 query
# heads on 1 KV head, head_dim 256) and granite-20b (48 on 1, head_dim 128).
F1_SHAPES = [dict(b=4, s=5, h=8, kvh=1, hd=256, ps=8, lanes=6, n_pages=64),
             dict(b=4, s=3, h=48, kvh=1, hd=128, ps=8, lanes=6, n_pages=64)]
# Head dims the kernels run padded to the next width they are built for,
# each one query head a KV head: hubert-xlarge's (16 heads, hd 80),
# phi-3-vision's (32, hd 96), and minicpm's smoke config's (6, hd 12: bf16
# and int8 rows of 24 and 12 bytes, copied element by element)
PADDED_HD_SHAPES = [dict(b=4, s=3, h=16, kvh=16, hd=80, ps=8, lanes=6,
                         n_pages=64),
                    dict(b=4, s=3, h=32, kvh=32, hd=96, ps=8, lanes=6,
                         n_pages=64),
                    dict(b=4, s=3, h=6, kvh=6, hd=12, ps=8, lanes=6,
                         n_pages=64)]
# K5/K7 at forced split counts and on unaligned pages (_decode_variants):
# short rows, rows of 1024 positions (K7's all-heads layout, from 1024
# positions of lanes), and two padded head dims (the second pass writes
# rows of hd 80 and 12; hd 80 also in K7's all-heads layout)
DECODE_SPLIT_SHAPES = [dict(b=5, s=1, h=8, kvh=2, hd=64, ps=4, lanes=9,
                            n_pages=64),
                       dict(b=5, s=1, h=8, kvh=2, hd=64, ps=16, lanes=64,
                            n_pages=512),
                       dict(b=5, s=1, h=4, kvh=4, hd=80, ps=16, lanes=64,
                            n_pages=512),
                       dict(b=5, s=1, h=6, kvh=6, hd=12, ps=4, lanes=9,
                            n_pages=64)]
# The int8 trap page with a spike of 40 (outputs of ~40) against the plain
# K7/K8: float32 outputs within 1e-5 of the largest output, relative, since
# float32 rounding at that magnitude alone reaches 1e-5 absolute.
QUANT_SPIKE = 40.0
QUANT_SPIKE_REL = 1e-5
# K1/K2 at a batch of three 1024-request chunks
BIG_BATCH = 3000
SOURCES = {"table": "src/repro_torch/csrc/table_kernels.cu",
           "paged": "src/repro_torch/csrc/paged_attn.cu"}
REPLACES = {
    "fused_publish_multi": "src/repro/kernels/table_publish.py:204",
    "fused_publish": "src/repro/kernels/table_publish.py:111",
    "revocation_poll": "src/repro/kernels/table_scan.py:67",
    "revocation_poll_multi": "src/repro/kernels/table_scan.py:85",
    "paged_attention": "src/repro/kernels/paged_attn.py:42",
    "paged_chunk_attention": "src/repro/kernels/paged_chunk_attn.py:62",
    "paged_attention_quant": "src/repro/kernels/paged_attn.py:42 "
                             "(quantized=True; _paged_attn_quant_call, "
                             "paged_attn.py:188)",
    "paged_chunk_attention_quant": "src/repro/kernels/paged_chunk_attn.py:62"
                                   " (quantized=True; _chunk_attn_quant_call,"
                                   " paged_chunk_attn.py:200)",
    "revocation_scan": "src/repro/kernels/table_scan.py:28",
    "publish": "src/repro/kernels/table_publish.py:52",
}
TABLE_KERNELS = list(REPLACES)[:4]
PAGED_KERNELS = list(REPLACES)[4:6]
QUANT_KERNELS = list(REPLACES)[6:8]
LEGACY_KERNELS = list(REPLACES)[8:]
# the scheduler phase's configuration
SCHED = dict(max_slots=8, page_size=16, max_seq=128, prefill_chunk=32,
             prefill_rows=2, token_budget=64, prefix_cache=True)
SCHED_PAGES = 4096


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
           for name in TABLE_KERNELS + LEGACY_KERNELS}

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
        big = [BIG_BATCH] if seed < 2 else []
        for m in ms + [int(rng.integers(2, 1025))] + big:
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
            # K2, the single-lock lease acquire and release on 64-bit host
            # reader ids (the bits of uint64 ids past 2**32)
            rids64 = c["rids"].long() * (2**31 + 7) + 2**32
            rids64[:1] = 2**63 - 1
            for rb in (0, 1):
                rbias = torch.full((), rb, dtype=torch.int32, device=dev)
                t = c["table"].clone()
                want_t, want_g = R.publish_hashed_ref(
                    t, rbias, c["vals"][:1],
                    torch.zeros((), dtype=torch.int32, device=dev), rids64)
                g = TP.publish_hashed(t, rbias, c["vals"][:1], None, rids64)
                agree("fused_publish", t, want_t)
                agree("fused_publish", g, want_g)
            want_t = R.release_hashed_ref(
                t, c["vals"][:1], torch.zeros((), dtype=torch.int32,
                                              device=dev), rids64, g)
            TP.release_hashed(t, c["vals"][:1], None, rids64, g)
            agree("fused_publish", t, want_t)
            # K10, conditional and unconditional (-1 slots, collisions)
            for unc in (False, True):
                got = TP.publish(c["table"], c["slots"], c["ids"],
                                 unconditional=unc)
                want = R.publish_seq_ref(c["table"], c["slots"], c["ids"],
                                         unconditional=unc)
                agree("publish", got[0], want[0])
                agree("publish", got[1], want[1])
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
            # K9 on the same tables
            for lock in (0, 7, int(c["table"].max()), 10_000):
                mask, cnt = K.revocation_scan(table, lock)
                want_m, want_c = R.scan_ref(table, lock)
                agree("revocation_scan", mask, want_m)
                agree("revocation_scan", cnt, want_c)
        _check_legacy_edges(rng, dev, agree)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out


def _check_legacy_edges(rng, dev, agree) -> None:
    """K9 on tables of 8 and 64 rows; K10's sequential cases on small
    slots (duplicate unconditional stores with different ids, id 0, slots
    outside the table) and on a 128-row table (64 KiB of shared memory,
    past the 48 KiB a block has without opting in)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import table_publish as TP

    def dev_t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    for rows in (8, 64):
        table = dev_t(rng.integers(0, 4, (rows, 128)).astype(np.int32))
        for lock in (0, 3, 9):
            mask, cnt = K.revocation_scan(table, lock)
            want_m, want_c = R.scan_ref(table, lock)
            agree("revocation_scan", mask, want_m)
            agree("revocation_scan", cnt, want_c)
    for rows, span in ((32, 16), (128, 16384)):
        table = np.zeros((rows, 128), np.int32)
        table.reshape(-1)[rng.choice(rows * 128, 9, replace=False)] = 4
        slots = rng.integers(-2, span + 2, 200).astype(np.int32)
        ids = rng.integers(0, 3, 200).astype(np.int32)
        for unc in (False, True):
            args = (dev_t(table), dev_t(slots), dev_t(ids))
            got = TP.publish(*args, unconditional=unc)
            want = R.publish_seq_ref(*args, unconditional=unc)
            agree("publish", got[0], want[0])
            agree("publish", got[1], want[1])


# ---------------------------------------------------------------------------
# Phase 3, paged attention: K5 and K6 against their plain versions
# ---------------------------------------------------------------------------


def _paged_case(rng, dev, *, b, s, h, kvh, hd, ps, lanes, n_pages,
                q_dtype, kv_dtype, traps=True, clen=None, nl=None):
    """Seeded K5/K6 operands with distinct pages per row and -1 lanes past
    each row's length.  With ``traps`` (b >= 4): row 0 has cache_len 0 and
    new_lens 0, row 1 a -1 lane inside its length, row 2 a chunk that is
    its whole prefix with a partial last page, row 3 a length past its
    lanes.  -> (q, k_pages, v_pages, page_idx, cache_len, new_lens)."""
    import numpy as np
    import torch

    cap = lanes * ps
    clen = (np.asarray(clen) if clen is not None
            else rng.integers(1, cap + 1, b)).astype(np.int32)
    nl = (np.asarray(nl) if nl is not None
          else np.minimum(rng.integers(1, s + 1, b), clen)).astype(np.int32)
    if traps:
        clen[0] = nl[0] = 0
        clen[1] = max(int(clen[1]), ps + 1)
        clen[2] = nl[2] = min(s, ps - 1) if s > 1 else 1
        clen[3] = cap + 5
    page_idx = np.full((b, lanes), -1, np.int32)
    perm = rng.permutation(n_pages)
    for i in range(b):
        npg = -(-min(int(clen[i]), cap) // ps)
        page_idx[i, :npg] = perm[i * lanes:i * lanes + npg]
    if traps:
        page_idx[1, 0] = -1
    q = torch.from_numpy(rng.normal(size=(b, s, h, hd)).astype(np.float32))
    kv = [torch.from_numpy(rng.normal(size=(n_pages, ps, kvh, hd))
                           .astype(np.float32)).to(dev).to(kv_dtype)
          for _ in range(2)]
    ints = [torch.from_numpy(x).to(dev) for x in (page_idx, clen, nl)]
    return (q.to(dev).to(q_dtype), *kv, *ints)


def _paged_agree(out, name, got, want, zero_mask, rel=None):
    """Record one K5-K8 comparison; raise past the stated tolerance (with
    ``rel``, float32 outputs are held to ``rel * max |want|`` instead of
    the absolute limit) or if a query with no valid position is not
    exactly zero."""
    import torch

    err = float((got.float() - want.float()).abs().max())
    if got.dtype != torch.float32:
        tol = PAGED_BF16_ULP * float(want.float().abs().max())
    elif rel is not None:
        tol = rel * float(want.float().abs().max())
    else:
        tol = PAGED_F32_ATOL
    o = out[name]
    o["cases"] += 1
    o["max_abs_err"] = max(o["max_abs_err"], err)
    if err > tol:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version by {err} > {tol}")
    if zero_mask is not None and bool(got[zero_mask].any()):
        raise AssertionError(f"{name}: a query with no valid position is "
                             f"not zero")


def check_paged_kernels(dev, seeds=range(3)) -> dict:
    """K5 and K6 against their plain versions on the same inputs on the
    card: the engine's shapes (decode B=8, prefill B=2 x 32 columns; H 32,
    KVH 8, hd 64, page 16, 8 lanes) and seeded sweeps over the traps and
    every (q, page) type pair."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops as K
    from repro_torch.kernels import paged_attn as PA
    from repro_torch.kernels import ref as R

    out = {name: {"cases": 0, "max_abs_err": 0.0, "matched": True,
                  "tolerance": {"float32": PAGED_F32_ATOL,
                                "bfloat16": "2**-7 * max |out|"}}
           for name in PAGED_KERNELS}
    engine = dict(h=32, kvh=8, hd=64, ps=16, lanes=8, n_pages=4096)
    shapes = [dict(engine, b=8, s=32), dict(b=5, s=5, h=8, kvh=2, hd=16,
                                            ps=4, lanes=6, n_pages=64),
              dict(b=4, s=7, h=12, kvh=4, hd=128, ps=8, lanes=9,
                   n_pages=64)] + F1_SHAPES + PADDED_HD_SHAPES
    types = [(torch.float32, torch.bfloat16), (torch.float32, torch.float32),
             (torch.bfloat16, torch.bfloat16), (torch.bfloat16,
                                                torch.float32)]
    for seed in seeds:
        rng = np.random.default_rng(seed)
        cases = [(dict(engine, b=8, s=1), types[0], False),
                 (dict(engine, b=2, s=32), types[0], False)]
        cases += [(sh, ty, True) for sh in shapes for ty in types]
        for sh, (qd, kd), traps in cases:
            q, kp, vp, pi, cl, nl = _paged_case(
                rng, dev, q_dtype=qd, kv_dtype=kd, traps=traps, **sh)
            s = q.shape[1]
            col = torch.arange(s, device=dev)
            pad = ((col[None, :] < s - nl[:, None])
                   | (cl[:, None] - s + col[None, :] < 0))
            _paged_agree(out, "paged_chunk_attention",
                         K.paged_chunk_attention(q, kp, vp, pi, cl, nl),
                         R.paged_chunk_attn_ref(q, kp, vp, pi, cl, nl), pad)
            q1 = q[:, -1].contiguous()
            _paged_agree(out, "paged_attention",
                         K.paged_attention(q1, kp, vp, pi, cl),
                         R.paged_attn_ref(q1, kp, vp, pi, cl), cl <= 0)
    rng = np.random.default_rng(50)
    for (qd, kd), sh in itertools.product(types, DECODE_SPLIT_SHAPES):
        q, kp, vp, pi, cl, _ = _paged_case(rng, dev, q_dtype=qd, kv_dtype=kd,
                                           **sh)
        q1 = q[:, 0].contiguous()
        want = R.paged_attn_ref(q1, kp, vp, pi, cl)
        for got in _decode_variants(PA.paged_attention, q1, (kp, vp), (),
                                    pi, cl):
            _paged_agree(out, "paged_attention", got, want, cl <= 0)
    for kd in (torch.bfloat16, torch.float32):
        q, kp, vp, pi, cl, _ = _long_case(rng, dev, kd)
        q1 = q[:, 0].contiguous()
        _paged_agree(out, "paged_attention",
                     K.paged_attention(q1, kp, vp, pi, cl),
                     R.paged_attn_ref(q1, kp, vp, pi, cl), cl <= 0)
    torch.cuda.synchronize()
    return out


def _unaligned(x):
    """The same values at an address one element past 16-byte alignment:
    the decode kernel then copies its rows element by element."""
    import torch

    flat = torch.empty(x.numel() + 16, dtype=x.dtype, device=x.device)
    y = flat[1:1 + x.numel()].view(x.shape)
    y.copy_(x)
    return y


def _decode_variants(fn, q, pages, scales, pi, cl):
    """K5 or K7 on one case, every way the kernel can run it: the split
    the wrapper ``fn`` picks, forced splits of 1, 2, 3 and one per lane (so
    splits past ``cache_len`` and splits of -1 lanes only occur), and
    pages that are not 16-byte aligned (one split and three)."""
    from repro_torch.kernels import paged_attn as PA

    lanes = pi.shape[1]
    yield fn(q, *pages, *scales, pi, cl)
    for n in (1, 2, 3, lanes):
        yield PA._decode(q, *pages, scales, pi, cl, n_split=n)
    bad = [_unaligned(x) for x in pages]
    for n in (1, 3):
        yield PA._decode(q, *bad, scales, pi, cl, n_split=n)


def _long_case(rng, dev, kv_dtype):
    """The long-context decode shape: 16 requests of 3584-4096 positions
    on 256 lanes of 16 (a 4096-page store, every page used once), float32
    q; -> _paged_case's tuple."""
    import numpy as np
    import torch

    b = LONG_CONTEXT["b"]
    return _paged_case(rng, dev, s=1, q_dtype=torch.float32,
                       kv_dtype=kv_dtype, traps=False,
                       clen=rng.integers(LONG_LENGTHS[0], LONG_LENGTHS[1] + 1,
                                         b),
                       nl=np.ones(b), **LONG_CONTEXT)


def _quantized(kp, vp, pi, traps, spike=6.0):
    """Quantize a case's float pages on the card (``kernels.quant``).  With
    ``traps``, first make one page the rows read all zero (its scale is
    1e-6 / 127 and it dequantizes to exact zeros) and give another one
    element per KV head that saturates to +-127 while the rest of its
    group quantizes coarsely.  The spike is 6 by default, twice the largest
    of a unit-normal page, so outputs stay O(1) and the absolute float32
    tolerance keeps its meaning; a spike of ``QUANT_SPIKE`` (40) makes
    outputs of ~40, whose float32 rounding alone reaches 1e-5, and is held
    to ``QUANT_SPIKE_REL`` instead.
    -> (k_pages, v_pages before quantization, kq, vq, k_scale, v_scale)."""
    import torch

    from repro_torch.kernels import quant as Q

    kp, vp = kp.float().clone(), vp.float().clone()
    if traps:
        used = torch.unique(pi[pi >= 0]).tolist()
        zero, sat = used[0], used[-1]
        for x in (kp, vp):
            x[zero] = 0.0
            x[sat, 0, :, 0] = spike
    (kq, ks), (vq, vs) = Q.quantize_pages(kp), Q.quantize_pages(vp)
    return kp, vp, kq, vq, ks, vs


def check_quant_kernels(dev, seeds=range(3)) -> dict:
    """K7 and K8 against their plain versions on the card, over the cases
    of :func:`check_paged_kernels` with int8 pages (q float32 and bf16),
    plus an all-zero page and a saturating page where the traps are; and,
    on the engine-shape cases (unit-variance pages, float32 q), against the
    float32 plain K5/K6 on the pages before quantization, within
    ``QUANT_VS_F32_ATOL``."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops as K
    from repro_torch.kernels import paged_attn as PA
    from repro_torch.kernels import ref as R

    out = {name: {"cases": 0, "max_abs_err": 0.0, "matched": True,
                  "tolerance": {"float32": PAGED_F32_ATOL,
                                "bfloat16": "2**-7 * max |out|",
                                "float32_spike_40": f"{QUANT_SPIKE_REL} * "
                                                    f"max |out|",
                                "vs_float32_pages": QUANT_VS_F32_ATOL},
                  "spike_cases": 0, "vs_f32_cases": 0,
                  "vs_f32_max_abs_err": 0.0}
           for name in QUANT_KERNELS}
    engine = dict(h=32, kvh=8, hd=64, ps=16, lanes=8, n_pages=4096)
    shapes = [dict(b=5, s=5, h=8, kvh=2, hd=16, ps=4, lanes=6, n_pages=64),
              dict(b=4, s=7, h=12, kvh=4, hd=128, ps=8, lanes=9,
                   n_pages=64)] + F1_SHAPES + PADDED_HD_SHAPES
    q_types = (torch.float32, torch.bfloat16)
    for seed in seeds:
        rng = np.random.default_rng(100 + seed)
        cases = [(dict(engine, b=8, s=1), torch.float32, False, None),
                 (dict(engine, b=2, s=32), torch.float32, False, None)]
        cases += [(sh, qd, True, spike) for sh in [dict(engine, b=8, s=32)]
                  + shapes for qd in q_types for spike in (None, QUANT_SPIKE)]
        for sh, qd, traps, spike in cases:
            q, kp, vp, pi, cl, nl = _paged_case(
                rng, dev, q_dtype=qd, kv_dtype=torch.float32, traps=traps,
                **sh)
            kp, vp, kq, vq, ks, vs = _quantized(
                kp, vp, pi, traps, *(() if spike is None else (spike,)))
            rel = None if spike is None else QUANT_SPIKE_REL
            s = q.shape[1]
            col = torch.arange(s, device=dev)
            pad = ((col[None, :] < s - nl[:, None])
                   | (cl[:, None] - s + col[None, :] < 0))
            q1 = q[:, -1].contiguous()
            got = {
                "paged_chunk_attention_quant": K.paged_chunk_attention_quant(
                    q, kq, vq, ks, vs, pi, cl, nl),
                "paged_attention_quant": K.paged_attention_quant(
                    q1, kq, vq, ks, vs, pi, cl)}
            _paged_agree(out, "paged_chunk_attention_quant",
                         got["paged_chunk_attention_quant"],
                         R.paged_chunk_attn_quant_ref(q, kq, vq, ks, vs, pi,
                                                      cl, nl), pad, rel)
            _paged_agree(out, "paged_attention_quant",
                         got["paged_attention_quant"],
                         R.paged_attn_quant_ref(q1, kq, vq, ks, vs, pi, cl),
                         cl <= 0, rel)
            if spike is not None:
                for name in QUANT_KERNELS:
                    out[name]["spike_cases"] += 1
            if traps:
                continue
            f32 = {"paged_chunk_attention_quant": R.paged_chunk_attn_ref(
                       q, kp, vp, pi, cl, nl),
                   "paged_attention_quant": R.paged_attn_ref(
                       q1, kp, vp, pi, cl)}
            for name, want in f32.items():
                err = float((got[name].float() - want.float()).abs().max())
                o = out[name]
                o["vs_f32_cases"] += 1
                o["vs_f32_max_abs_err"] = max(o["vs_f32_max_abs_err"], err)
                if err > QUANT_VS_F32_ATOL:
                    raise AssertionError(
                        f"{name}: {err} from the float32 pages > "
                        f"{QUANT_VS_F32_ATOL}")
    rng = np.random.default_rng(150)
    for qd, sh in itertools.product(q_types, DECODE_SPLIT_SHAPES):
        q, kp, vp, pi, cl, _ = _paged_case(rng, dev, q_dtype=qd,
                                           kv_dtype=torch.float32, **sh)
        _, _, kq, vq, ks, vs = _quantized(kp, vp, pi, traps=True)
        q1 = q[:, 0].contiguous()
        want = R.paged_attn_quant_ref(q1, kq, vq, ks, vs, pi, cl)
        for got in _decode_variants(PA.paged_attention_quant, q1, (kq, vq),
                                    (ks, vs), pi, cl):
            _paged_agree(out, "paged_attention_quant", got, want, cl <= 0)
    q, kp, vp, pi, cl, _ = _long_case(rng, dev, torch.float32)
    _, _, kq, vq, ks, vs = _quantized(kp, vp, pi, traps=False)
    q1 = q[:, 0].contiguous()
    _paged_agree(out, "paged_attention_quant",
                 K.paged_attention_quant(q1, kq, vq, ks, vs, pi, cl),
                 R.paged_attn_quant_ref(q1, kq, vq, ks, vs, pi, cl), cl <= 0)
    torch.cuda.synchronize()
    return out


def check_requant(dev, seeds=range(3)) -> dict:
    """``requant_scatter``, the quantized store's write path, on the card
    against the same call on the CPU (whose bytes the CPU tests hold equal
    to ``repro``'s), at the engine's shapes: a decode tick (B = 8, S = 1)
    and a prefill tick (2 rows x 32 columns, one with padding), over a
    store of stale bytes.  The int8 pages and float32 scales must be equal
    byte for byte."""
    import numpy as np
    import torch

    from repro_torch.kernels import quant as Q

    n_pages, ps, kvh, hd, lanes = 256, 16, 8, 64, 8
    cases = 0
    for seed in seeds:
        rng = np.random.default_rng(200 + seed)
        for b, s, nl, clen in ((8, 1, None, rng.integers(1, 129, 8)),
                               (2, 32, [32, 20], [32, 72])):
            perm = rng.permutation(n_pages)
            pages = np.full((b, lanes), -1, np.int32)
            for i in range(b):
                npg = -(-int(clen[i]) // ps)
                pages[i, :npg] = perm[i * lanes:i * lanes + npg]
            host = [rng.integers(-127, 128, (n_pages + 1, ps, kvh, hd))
                    .astype(np.int8) for _ in range(2)]
            host += [rng.uniform(0.001, 0.1, (n_pages + 1, kvh))
                     .astype(np.float32) for _ in range(2)]
            new = [rng.normal(size=(b, s, kvh, hd)).astype(np.float32)
                   for _ in range(2)]
            ints = [pages, np.asarray(clen, np.int32)] + (
                [] if nl is None else [np.asarray(nl, np.int32)])
            res = []
            for d in ("cpu", dev):
                store = [torch.tensor(x, device=d)[:n_pages] for x in host]
                args = [torch.tensor(x, device=d) for x in new + ints]
                Q.requant_scatter(*store, *args)
                res.append([x.cpu() for x in store])
            for a, c in zip(*res):
                if a.numpy().tobytes() != c.numpy().tobytes():
                    raise AssertionError("requant_scatter: the card's bytes "
                                         "differ from the CPU's")
            cases += 1
    return {"cases": cases, "bytes_equal": True}


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
    is lower still against L2's rate.

    K9 (the revocation scan) reads the table and writes its int8 mask and
    the count; K10 (the legacy publish) at the legacy path's batch of 64
    reads the table and the request vectors and writes a new table and the
    grants.  Both run one request or slot per thread in one CTA.  K10's
    plain version loops over the requests in Python, a few launches each,
    so its windows hold 10 calls instead of 100."""
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
    seq_m = 64                                    # the legacy path's batch
    seq = _case(rng, seq_m, dev)
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
        "revocation_scan": (
            lambda: K.revocation_scan(table, lock0),
            lambda: R.scan_ref(table, lock0),
            (tsec + _span(table.numel(), 1) + 1) * SECTOR,
            2 * table.numel()),
        "publish": (
            lambda: K.publish(table, seq["slots"], seq["ids"]),
            lambda: R.publish_seq_ref(table, seq["slots"], seq["ids"]),
            (2 * tsec + 2 * _span(seq_m) + _span(seq_m, 1)) * SECTOR,
            2 * seq_m),
    }
    out = {}
    for name, (kern, plain, nbytes, ops) in shapes.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / INT_OPS_PER_S * 1e3
        k = _median_ms(kern)
        p = _median_ms(plain, n=10 if name == "publish" else 100)
        out[name] = {"ms": k["graph_ms"], "plain_ms": p["graph_ms"],
                     "call_ms": k["call_ms"], "plain_call_ms": p["call_ms"],
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "bytes": nbytes, "ops": ops}
    return out


def _valid_positions(pi, cl, ps):
    """Per row, the KV positions a query may read: t < min(cache_len,
    lanes * ps) whose lane holds a page."""
    import torch

    t = torch.arange(pi.shape[1] * ps, device=pi.device)
    lane_ok = (pi >= 0).repeat_interleave(ps, dim=1)
    return lane_ok & (t[None, :] < cl[:, None])


def time_paged_kernels(dev, seed=0, quant=False) -> dict:
    """K5 and K6 times at the engine's shapes: a decode tick of the
    scheduler phase (B = 8 rows, lengths 24-88 of 128 positions, float32
    q, bf16 pages in a 4096-page store) and a prefill tick (2 rows x 32
    columns: a first chunk, and a chunk on a 40-token prefix); with
    ``quant``, K7 and K8 at the same shapes over int8 pages and their
    scales (the quantized scheduler phase's store).  K5/K7 also at the
    long-context shape (``LONG_CONTEXT``: 16 rows of 3584-4096 positions,
    whose K/V exceed the 50 MB L2), under the record's ``long_context``.

    For K5/K7 each record also holds, timed in the same windows' way,
    ``parent_ms``: the parent design, the chunk kernel at S = 1 (one CTA
    per request and KV head walking all its positions, no split, no
    asynchronous copies), and ``one_split_ms``: the new kernel forced to
    one split (the ablation of the KV split); ``splits`` is the split
    count the wrapper picked.

    The bound counts what one call must move, in 32-byte sectors at the
    HBM rate: each valid K and V row once per KV head (hd bf16 = 4
    sectors, hd int8 = 2), for int8 pages the sectors of the (page, KV
    head) scales those rows need, q and out, the page indices and lengths;
    and the float32 operations outside the tensor cores (4 * hd per query
    head and KV position it attends to) at 67 TFLOP/s.  ``library_ms`` is
    ``scaled_dot_product_attention`` over the same K/V already gathered
    dense (and dequantized; neither step timed), with a boolean mask and
    GQA: a yardstick only, the port never calls it."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    base = dict(h=32, kvh=8, hd=64, ps=16, lanes=8, n_pages=SCHED_PAGES,
                q_dtype=torch.float32,
                kv_dtype=torch.float32 if quant else torch.bfloat16,
                traps=False)
    dec = _paged_case(rng, dev, b=8, s=1, clen=rng.integers(24, 89, 8),
                      nl=np.ones(8), **base)
    pre = _paged_case(rng, dev, b=2, s=32, clen=[32, 72], nl=[32, 32],
                      **base)
    names = QUANT_KERNELS if quant else PAGED_KERNELS
    out = {name: _time_paged_case(dev, case, quant)
           for name, case in zip(names, (dec, pre))}
    long = _long_case(rng, dev, base["kv_dtype"])
    out[names[0]]["long_context"] = _time_paged_case(dev, long, quant,
                                                     plain_n=10)
    return out


def _time_paged_case(dev, case, quant, plain_n=100) -> dict:
    """One K5-K8 timing record (see :func:`time_paged_kernels`); the plain
    version and the library call run ``plain_n`` calls a window."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops as K
    from repro_torch.kernels import paged_attn as PA
    from repro_torch.kernels import quant as Q
    from repro_torch.kernels import ref as R

    q, kp, vp, pi, cl, nl = case
    scales = ()
    if quant:
        _, _, kp, vp, ks, vs = _quantized(kp, vp, pi, traps=False)
        scales = (ks, vs)
    b, s, h, hd = q.shape
    kvh, ps = kp.shape[2], kp.shape[1]
    valid = _valid_positions(pi, cl, ps)                        # (B, T)
    q_pos = cl[:, None] - s + torch.arange(s, device=dev)[None, :]
    real = (torch.arange(s, device=dev)[None, :] >= s - nl[:, None]) \
        & (q_pos >= 0)                                          # (B, S)
    seen = (valid[:, None, :] & real[:, :, None]
            & (torch.arange(valid.shape[1], device=dev)[None, None, :]
               <= q_pos[:, :, None]))                           # (B, S, T)
    used = valid[real.any(dim=1)]
    rows = int(used.sum())
    row_sec = _span(hd, kp.element_size())
    qsec = _span(q.numel(), q.element_size())
    sectors = (2 * rows * kvh * row_sec + 2 * qsec
               + _span(pi.numel()) + _span(b) * (1 if s == 1 else 2))
    if quant:        # each scale array: the (page, KV head) entries read
        lane_pg = pi[real.any(dim=1)].repeat_interleave(ps, dim=1)[used]
        sidx = (lane_pg.long()[:, None] * kvh
                + torch.arange(kvh, device=dev)[None, :])
        sectors += 2 * _sectors(sidx)
    flops = 4 * hd * h * int(seen.sum())
    extra = {}
    if s == 1:
        args = (q[:, 0].contiguous(), kp, vp, *scales, pi, cl)
        fn = PA.paged_attention_quant if quant else PA.paged_attention
        kern = functools.partial(fn, *args)
        plain = functools.partial(
            R.paged_attn_quant_ref if quant else R.paged_attn_ref, *args)
        chunk = (K.paged_chunk_attention_quant if quant
                 else K.paged_chunk_attention)
        parent = functools.partial(chunk, q, kp, vp, *scales, pi, cl, nl)
        one = functools.partial(PA._decode, args[0], kp, vp, scales, pi, cl,
                                n_split=1)
        splits, pps = PA.decode_plan(args[0], kp, pi.shape[1])
        # parent and new kernel in turns: parent, new, new, parent
        p0, k0 = _median_ms(parent), _median_ms(kern)
        k1, p1 = _median_ms(kern), _median_ms(parent)
        o = _median_ms(one)
        extra = {"parent_ms": (p0["graph_ms"] + p1["graph_ms"]) / 2,
                 "parent_readings_ms": [p0["graph_ms"], p1["graph_ms"]],
                 "readings_ms": [k0["graph_ms"], k1["graph_ms"]],
                 "one_split_ms": o["graph_ms"], "splits": splits,
                 "split_pages": pps}
        k = {"graph_ms": (k0["graph_ms"] + k1["graph_ms"]) / 2,
             "call_ms": (k0["call_ms"] + k1["call_ms"]) / 2}
    else:
        args = (q, kp, vp, *scales, pi, cl, nl)
        kern = functools.partial(
            K.paged_chunk_attention_quant if quant
            else K.paged_chunk_attention, *args)
        plain = functools.partial(
            R.paged_chunk_attn_quant_ref if quant
            else R.paged_chunk_attn_ref, *args)
        k = _median_ms(kern)
    idx = torch.where(pi >= 0, pi, 0).long()
    dense = [x[idx] if not quant else Q.dequantize_pages(x[idx], sc[idx])
             for x, sc in zip((kp, vp), scales or (None, None))]
    kd, vd = (x.reshape(b, -1, kvh, hd).transpose(1, 2).to(q.dtype)
              .contiguous() for x in dense)
    qd = q.transpose(1, 2).contiguous()                         # (B, H, S, hd)
    lib = functools.partial(F.scaled_dot_product_attention, qd, kd, vd,
                            attn_mask=seen[:, None], enable_gqa=True)
    want = (R.paged_chunk_attn_quant_ref(q, kp, vp, *scales, pi, cl, nl)
            if quant else R.paged_chunk_attn_ref(q, kp, vp, pi, cl, nl))
    err = float((lib().transpose(1, 2).float() - want.float()).abs().max())
    t_bytes = sectors * SECTOR / HBM_BYTES_PER_S * 1e3
    t_ops = flops / INT_OPS_PER_S * 1e3
    p, lb = _median_ms(plain, n=plain_n), _median_ms(lib, n=plain_n)
    bound = max(t_bytes, t_ops)
    return {"ms": k["graph_ms"], "plain_ms": p["graph_ms"],
            "library_ms": lb["graph_ms"], "call_ms": k["call_ms"],
            "plain_call_ms": p["call_ms"], "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_share": bound / k["graph_ms"], **extra,
            "bytes": sectors * SECTOR, "ops": flops,
            "kv_rows": rows, "library_max_abs_err": err,
            "shape": {"B": b, "S": s, "H": h, "KVH": kvh, "hd": hd,
                      "page": ps, "lanes": pi.shape[1],
                      "cache_len": cl.tolist(), "q": str(q.dtype),
                      "pages": str(kp.dtype)}}


# ---------------------------------------------------------------------------
# Phase 3c: the lease microbenchmarks
# ---------------------------------------------------------------------------


def lease_benchmarks(dev) -> dict:
    """The port's two lease benchmarks at their full settings, each with
    the launch counts set to 0 just before it and read just after (their
    check lines go to stderr); raises if a check of either failed, if a
    kernel of its path never ran, or if the lease table's pair was not
    gated clean."""
    from repro_torch.benchmarks import device_bravo as DBB
    from repro_torch.benchmarks import registry as RB
    from repro_torch.kernels import ops as K

    out = {}
    for phase, run, kernels in (
            ("device_bravo", lambda: DBB.run(dev, batch=64, iters=100),
             ["fused_publish", "revocation_poll"] + LEGACY_KERNELS),
            ("registry_bench", lambda: RB.run(dev), TABLE_KERNELS)):
        K.reset_launch_counts()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(sys.stderr):   # its [ok] lines
            rec = run()
        counts = K.launch_counts()
        if rec["failures"]:
            raise AssertionError(f"{phase}: failed checks {rec['failures']}")
        idle = [k for k in kernels if not counts[k]]
        if idle:
            raise AssertionError(f"{phase}: {idle} never launched")
        rec.update(launches=counts, seconds=time.monotonic() - t0)
        out[phase] = rec
    gate = out["device_bravo"]["transfers"]["fused_sync_gate"]
    if gate != "passed":
        raise AssertionError(f"device_bravo: the fused pair's sync gate "
                             f"{gate}")
    return out


# ---------------------------------------------------------------------------
# Phase 4: the lease fast path moves nothing between host and device
# ---------------------------------------------------------------------------


def sync_gate(dev, cfg, params) -> dict:
    """A lease acquire/release pair, one scheduler decode tick at full
    width on the bf16 store and one on the quantized store, each under
    ``set_sync_debug_mode("error")``: any host-device synchronization
    inside raises."""
    import numpy as np
    import torch

    from repro_torch.core.atomics import LiveMem
    from repro_torch.core.factory import LockEnv
    from repro_torch.core.registry import BravoRegistry
    from repro_torch.serving.engine import ModelStore, Request, ServingEngine
    from repro_torch.serving.kv_pool import KVPool
    from repro_torch.serving.scheduler import Phase, SchedulerConfig

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

    def gated(fn):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return res

    pair()                                    # warm-up outside the gate
    gated(pair)
    held = reg.held_multi([store.leases] + pool.locks).tolist()
    if any(held):
        raise AssertionError(f"leases left after the gated pair: {held}")

    def tick(quant_kv):
        # the scheduler tick: admit and prefill two requests outside the
        # gate (admission and the prefill's token read synchronize by
        # design), then one warm-up decode tick and one gated tick
        eng = ServingEngine(cfg, params, n_pages=64, device=dev,
                            quant_kv=quant_kv,
                            scheduler=SchedulerConfig(**SCHED))
        for i, p in enumerate(_prompts(7, 2, 20, cfg.vocab)):
            eng.submit(Request(rid=i, prompt=p, max_new=4))
        for _ in range(8):
            eng._schedule_tick()
            if all(s.phase is Phase.DECODE
                   for s in eng.scheduler.running.values()):
                break
        rows = sorted(eng.scheduler.running)
        if len(rows) != 2:
            raise AssertionError(f"gate: {len(rows)} slots reached decode")
        eng._decode_tick()
        nxt = gated(eng._decode_tick)
        toks = nxt[:, 0].cpu().numpy()       # read after the gate closes
        if not ((toks[rows] >= 0) & (toks[rows] < cfg.vocab)).all():
            raise AssertionError(f"gate: tokens out of range "
                                 f"{toks.tolist()}")
        locks = [eng.store.leases] + eng.kv_pool.locks
        tick_held = eng.registry.held_multi(locks).tolist()
        if any(tick_held):
            raise AssertionError(f"leases left after the gated tick: "
                                 f"{tick_held}")
        # the same tick's device time and busy share, profiled (two active
        # rows of max_slots; the step computes every row)
        prof = _profile(eng._decode_tick, steps=4)
        return {"tick_rows": len(rows),
                "tick_tokens": np.asarray(toks)[rows].tolist(),
                "tick_held_after": tick_held, "tick_profile": prof}

    bf16 = tick(quant_kv=False)
    quant = tick(quant_kv=True)
    return {"pairs": 1, "held_after": held, "decode_ticks": 2, **bf16,
            "quant": quant}


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
    # the plain versions (CPU tensors) count no launch; this path runs the
    # table kernels only (no paged attention in handler mode)
    assert dev.type != "cuda" or all(counts[k] for k in TABLE_KERNELS), \
        counts

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
    """torch.profiler over a few handler-mode decode steps at positions
    40 and on (see :func:`_profile`)."""
    import torch

    state = {"cur": cur, "caches": caches, "i": 0}

    def one():
        clen = torch.full((batch,), 40 + state["i"], dtype=torch.int32,
                          device=dev)
        state["cur"], _, state["caches"] = step(params, state["caches"],
                                                state["cur"], clen)
        state["i"] += 1

    return _profile(one, steps)


def _profile(fn, steps=4) -> dict:
    """torch.profiler over ``steps`` calls of ``fn``: device time per call
    (the sum of kernel times), wall time per call (profiler on), the
    device's busy share and the kernels that take the most device time.
    Device numbers are None where the profiler recorded no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
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

    cache = _reading(f32, full)
    half = _reading(bf16, f32)
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
# Phase 6: the scheduler-mode engine at full width
# ---------------------------------------------------------------------------


def _sched_prompts(seed, vocab, ps=16):
    """Wave 1: six prompts of 24-72 tokens (the last three at least 33).
    Wave 2: exact repeats of the first three, whose lengths are not one
    more than a multiple of the page (the last prompt token is always
    recomputed, so such a repeat takes its full pages by reference and
    copies its boundary page), and three prompts that share the first 32
    tokens (two full pages) of the last three and then diverge."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(24, 73, 6)
    lens[3:] = rng.integers(33, 73, 3)
    lens[:3] += lens[:3] % ps == 1
    wave1 = [rng.integers(1, vocab, int(n)).astype(np.int32) for n in lens]
    share = [np.concatenate([p[:32], rng.integers(
        1, vocab, int(rng.integers(8, 41)))]).astype(np.int32)
        for p in wave1[3:]]
    return wave1, wave1[:3] + share


def run_scheduler(cfg, params, dev, *, seed, max_new=16,
                  quant_kv=False) -> dict:
    """Two waves of six requests through ``ServingEngine(scheduler=...)``
    under hot-swap (every 0.25 s) and compaction (every 0.2 s).  Wave 2 is
    submitted once wave 1 has finished, since a prefix enters the index
    only when its request has finished prefill.  ``quant_kv``: the same on
    the quantized store, whose attention must run in K7/K8 alone."""
    from repro_torch.kernels import ops as K
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    eng = ServingEngine(cfg, params, n_pages=SCHED_PAGES, device=dev,
                        quant_kv=quant_kv,
                        scheduler=SchedulerConfig(**SCHED))
    ticks = {"prefill": [], "decode": []}
    for kind, acc in ticks.items():         # host wall time of each tick
        def timed(plan, fn=getattr(eng, f"_run_{kind}"), acc=acc):
            t0 = time.perf_counter()
            fn(plan)
            acc.append((time.perf_counter() - t0) * 1e3)
        setattr(eng, f"_run_{kind}", timed)
    wave1, wave2 = _sched_prompts(seed, cfg.vocab)
    waves = [[Request(rid=base + i, prompt=p, max_new=max_new)
              for i, p in enumerate(w)]
             for base, w in ((0, wave1), (len(wave1), wave2))]
    K.reset_launch_counts()
    t0 = time.monotonic()
    eng.start(swap_period_s=0.25, compact_period_s=0.2)
    for wave in waves:
        for r in wave:
            eng.submit(r)
        for r in wave:
            if not r.done.wait(timeout=600):
                eng.stop()
                raise AssertionError(f"request {r.rid} timed out")
    wall = time.monotonic() - t0
    eng.stop()
    counts = K.launch_counts()               # read right after the path
    reqs = waves[0] + waves[1]
    st = eng.lock_stats()
    pool = st["kv_pool"]
    locks = [eng.store.leases] + eng.kv_pool.locks
    held = eng.registry.held_multi(locks)
    free = eng.kv_pool.free_count()
    for r in reqs:
        assert r.out is not None and len(r.out) == max_new, r.rid
        assert ((r.out >= 0) & (r.out < cfg.vocab)).all(), r.out
    _check_varied([r.out.tolist() for r in reqs])
    es = st["engine"]
    assert free == SCHED_PAGES, free
    assert pool["refcount_total"] == 0 and pool["shared_pages"] == 0, pool
    assert not held.any(), held.tolist()
    assert es["pages_saved"] >= 1 and es["cow_copies"] >= 1, es
    assert es["weight_swaps"] >= 1, es
    attn, other = ((QUANT_KERNELS, PAGED_KERNELS) if quant_kv
                   else (PAGED_KERNELS, QUANT_KERNELS))
    path = ["fused_publish_multi", "fused_publish", "revocation_poll", *attn]
    # the plain versions (CPU tensors) count no launch
    assert dev.type != "cuda" or all(counts[k] for k in path), counts
    assert not any(counts[k] for k in other), counts
    quant = {name: eng.metrics.counter(name).value
             for name in ("pool.quant_tokens", "pool.quant_hits")}
    assert all(quant.values()) if quant_kv else not any(quant.values()), \
        quant
    ttft = eng.metrics.histogram("engine.ttft_ns")
    tokens = sum(len(r.out) for r in reqs)
    leaf_bytes = {name: x.numel() * x.element_size()
                  for name, x in eng._pages_kv.items()}
    return {"config": SCHED, "n_pages": SCHED_PAGES, "quant_kv": quant_kv,
            "page_store_bytes": sum(leaf_bytes.values()),
            "leaf_bytes": leaf_bytes,
            "hbm_bytes_gauge": eng.metrics.gauge("pool.hbm_bytes").value,
            **quant,
            "requests": len(reqs), "prompt_lens": [len(r.prompt)
                                                   for r in reqs],
            "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "decode_ticks": len(ticks["decode"]),
            "decode_tick_median_ms": statistics.median(ticks["decode"]),
            "prefill_ticks": len(ticks["prefill"]),
            "prefill_tick_median_ms": statistics.median(ticks["prefill"]),
            "ttft_median_ms": ttft.quantile(0.5) / 1e6,
            "weight_swaps": es["weight_swaps"],
            "compactions": es["compactions"],
            "pages_saved": es["pages_saved"], "cow_copies": es["cow_copies"],
            "cached_tokens": es["cached_tokens"],
            "prefix_hits": pool["prefix_hits"],
            "scheduler": st["scheduler"], "pages_free": free,
            "held_after": held.tolist(), "launches": counts,
            "prompts": [r.prompt.tolist() for r in reqs],
            "outputs": [r.out.tolist() for r in reqs]}


def _reading(a, b) -> dict:
    """max |a - b| / max |b| over logits, and the share of positions whose
    greedy token agrees."""
    return {"rel": float((a - b).abs().max() / b.abs().max()),
            "top1": float((a.argmax(-1) == b.argmax(-1)).float().mean())}


def paged_precision(cfg, params, dev, *, seed, quant=False) -> dict:
    """The paged data plane at full width in float32 (compute and pages):
    two rows of 40 prompt tokens prefilled in two right-aligned chunks of
    width 32 (row 0: 32 then 8 tokens, row 1: 8 then 32, so both chunks
    have padding columns), then 24 paged decode steps, teacher-forced,
    against ONE float32 forward pass with no cache over the same 64
    tokens: logits at every position within ``PAGED_VS_FORWARD_REL``,
    every greedy token equal.  ``quant``: the same over the quantized
    store (int8 pages, float32 compute; K8 then K7), within
    ``QUANT_PAGED_VS_FORWARD_REL`` and ``QUANT_PAGED_VS_FORWARD_TOP1``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import model as M

    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    b, prompt_len, steps, ps, width = 2, 40, 24, 16, 32
    total = prompt_len + steps
    toks_h = np.stack(_prompts(seed, b, total, cfg.vocab))
    toks = torch.from_numpy(toks_h).to(dev)
    lanes = -(-total // ps)
    n_pages = 2 * b * lanes
    store = M.init_paged_caches(cfg32, n_pages, ps, dtype=torch.float32,
                                quantized=quant, device=dev)
    perm = np.random.default_rng(seed).permutation(n_pages)[:b * lanes]
    pages = torch.from_numpy(perm.reshape(b, lanes).astype(np.int32)).to(dev)
    logits = []
    done = np.zeros(b, np.int32)
    with torch.no_grad():
        for chunk in ([32, 8], [8, 32]):
            chunk = np.asarray(chunk, np.int32)
            x = np.zeros((b, width), np.int32)
            for i in range(b):
                x[i, width - chunk[i]:] = toks_h[i, done[i]:done[i] + chunk[i]]
            done = done + chunk
            lg, _, _ = M.forward(
                params, cfg32, {"tokens": torch.from_numpy(x).to(dev)},
                caches=store, cache_len=torch.from_numpy(done).to(dev),
                pages=pages, new_lens=torch.from_numpy(chunk).to(dev))
            logits.append([lg[i, width - chunk[i]:].float()
                           for i in range(b)])
        rows = [torch.cat([c[i] for c in logits]) for i in range(b)]
        paged = [torch.stack(rows)]                     # (B, 40, V)
        for pos in range(prompt_len, total):
            clen = torch.full((b,), pos + 1, dtype=torch.int32, device=dev)
            lg, _, _ = M.forward(params, cfg32,
                                 {"tokens": toks[:, pos:pos + 1]},
                                 caches=store, cache_len=clen, pages=pages)
            paged.append(lg.float())
        paged = torch.cat(paged, dim=1)                 # (B, 64, V)
        full = M.forward(params, cfg32, {"tokens": toks},
                         make_caches=False)[0].float()
    r = _reading(paged, full)
    rel, top1 = ((QUANT_PAGED_VS_FORWARD_REL, QUANT_PAGED_VS_FORWARD_TOP1)
                 if quant else (PAGED_VS_FORWARD_REL, 1.0))
    out = {"batch": b, "prompt": prompt_len, "decode_steps": steps,
           "quantized": quant, "paged_vs_forward": r,
           "tolerance": {"rel": rel, "top1": top1}}
    if r["rel"] > rel or r["top1"] < top1:
        raise AssertionError(f"paged path outside tolerance: {out}")
    return out


def quant_vs_bf16(sched, qsched) -> dict:
    """The quantized scheduler run against the bf16 one on the same
    prompts: the int8 K/V leaves hold exactly half the bf16 leaves' bytes
    (read from each run's ``pool.hbm_bytes`` gauge, less the scales), and
    at least ``QUANT_VS_BF16_SHARE`` of the generated tokens are equal."""
    scales = sum(qsched["leaf_bytes"][k] for k in ("k_scale", "v_scale"))
    kv_int8 = qsched["hbm_bytes_gauge"] - scales
    if 2 * kv_int8 != sched["hbm_bytes_gauge"]:
        raise AssertionError(f"int8 K/V {kv_int8} B is not half the bf16 "
                             f"store's {sched['hbm_bytes_gauge']} B")
    if qsched["prompts"] != sched["prompts"]:
        raise AssertionError("the two scheduler runs served other prompts")
    same = [[a == b for a, b in zip(q, f)]
            for q, f in zip(qsched["outputs"], sched["outputs"])]
    share = sum(map(sum, same)) / sum(map(len, same))
    out = {"kv_bytes_int8": kv_int8, "scale_bytes": scales,
           "kv_bytes_bf16": sched["hbm_bytes_gauge"],
           "equal_token_share": share,
           "first_difference": [s.index(False) if not all(s) else None
                                for s in same],
           "tolerance": QUANT_VS_BF16_SHARE}
    if share < QUANT_VS_BF16_SHARE:
        raise AssertionError(f"quantized vs bf16 scheduler run: {out}")
    return out


def scheduler_vs_greedy(cfg, params, dev, sched) -> dict:
    """The scheduler engine's bf16 tokens against the handler-mode direct
    greedy loop (``greedy_reference``) on the same prompts: the share of
    positions whose token is equal, at least ``SCHED_VS_GREEDY_SHARE``."""
    want = {}
    equal = total = 0
    first_diff = []
    for prompt, got in zip(sched["prompts"], sched["outputs"]):
        key = tuple(prompt)
        if key not in want:
            want[key] = greedy_reference(cfg, params, prompt, len(got),
                                         SCHED["max_seq"], dev)
        ref = want[key]
        same = [a == b for a, b in zip(got, ref)]
        equal += sum(same)
        total += len(same)
        first_diff.append(same.index(False) if not all(same) else None)
    share = equal / total
    out = {"requests": len(first_diff), "equal_share": share,
           "first_difference": first_diff,
           "tolerance": SCHED_VS_GREEDY_SHARE}
    if share < SCHED_VS_GREEDY_SHARE:
        raise AssertionError(f"scheduler vs greedy loop: {out}")
    return out


# ---------------------------------------------------------------------------


def build_all() -> dict:
    """Compile both CUDA sources, one nvcc each, started together."""
    from repro_torch.kernels import _build

    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as ex:
        futs = {k: ex.submit(_build.compile_source,
                             _build.CSRC / os.path.basename(src))
                for k, src in SOURCES.items()}
        built = {SOURCES[k]: f.result() for k, f in futs.items()}
    return {"sources": list(SOURCES.values()),
            "seconds": time.monotonic() - t0,
            "nvcc_seconds": {k: v[1] for k, v in built.items()}}


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
    from repro_torch.models import model as M

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    emit({"phase": "environment", "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "nvcc": run([_build.nvcc(), "--version"]).splitlines()[-1],
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card})

    emit({"phase": "build", **build_all()})

    checks = check_kernels(dev)
    checks.update(check_paged_kernels(dev))
    checks.update(check_quant_kernels(dev))
    emit({"phase": "kernels", "checks": checks,
          "requant_scatter": check_requant(dev)})

    cfg = llama3_2_1b.CONFIG
    handlers, slots = 2, 4
    held_locks = 5                    # the model lock + 4 KV stripes
    times = time_kernels(dev, batch=slots, n_locks=held_locks)
    times.update(time_paged_kernels(dev, seed=args.seed))
    times.update(time_paged_kernels(dev, seed=args.seed, quant=True))
    emit({"phase": "kernel_times", "card": card, "batch": slots,
          "bound_assumes": "32-byte sectors at the HBM rate, 3.35 TB/s; "
                           "float32 operations at 67 TFLOP/s",
          "times": times})

    bench = lease_benchmarks(dev)
    emit({"phase": "device_bravo", "card": card, **bench["device_bravo"]})
    emit({"phase": "registry_bench", "card": card,
          **bench["registry_bench"]})

    t0 = time.monotonic()
    params = M.init_params(args.seed, cfg, device=dev)
    params["embed"].mul_(EMBED_SCALE)
    torch.cuda.synchronize()
    emit({"phase": "init_params", "config": cfg.name,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "params": sum(int(x.numel()) for x in _leaves(params)),
          "embed_scale": EMBED_SCALE, "seconds": time.monotonic() - t0})

    emit({"phase": "sync_gate", **sync_gate(dev, cfg, params)})

    eng = run_engine(cfg, params, dev, n_req=8, prompt_len=16, max_new=16,
                     handlers=handlers, slots=slots, max_seq=64,
                     swap_s=0.25, compact_s=0.2, seed=args.seed)
    step = decode_step_ms(cfg, params, dev, batch=slots, steps=32,
                          max_seq=64)
    emit({"phase": "engine", "card": card, **eng, "decode_step": step})

    sched = run_scheduler(cfg, params, dev, seed=args.seed + 3)
    emit({"phase": "scheduler", "card": card, **sched})
    qsched = run_scheduler(cfg, params, dev, seed=args.seed + 3,
                           quant_kv=True)
    emit({"phase": "scheduler_quant", "card": card, **qsched,
          "vs_bf16": quant_vs_bf16(sched, qsched)})

    emit({"phase": "tokens", **token_check(cfg, params, dev, n_req=2,
                                           prompt_len=16, max_new=8,
                                           max_seq=64, seed=args.seed + 1)})
    emit({"phase": "precision", **precision_check(
        cfg, params, dev, batch=2, length=24, seed=args.seed + 2),
        "paged": paged_precision(cfg, params, dev, seed=args.seed + 4),
        "paged_quant": paged_precision(cfg, params, dev, seed=args.seed + 4,
                                       quant=True),
        "scheduler_vs_greedy": scheduler_vs_greedy(cfg, params, dev,
                                                   sched)})

    # launches: the scheduler run (the serving path) for every kernel it
    # runs, the quantized scheduler run for K7/K8, the device_bravo
    # benchmark for K9/K10; K4 runs on the handler run's drained-table
    # check
    runs = {"handler": eng, "scheduler": sched, "scheduler_quant": qsched,
            "device_bravo": bench["device_bravo"]}
    launches_from = {name: "handler" if name == "revocation_poll_multi"
                     else "scheduler_quant" if name in QUANT_KERNELS
                     else "device_bravo" if name in LEGACY_KERNELS
                     else "scheduler" for name in REPLACES}
    launches = {name: runs[run]["launches"][name]
                for name, run in launches_from.items()}
    emit({"phase": "summary", "seconds": time.monotonic() - t_start,
          "launches_from": launches_from})
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": SOURCES["paged" if name in PAGED_KERNELS + QUANT_KERNELS
                           else "table"],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": checks[name]["max_abs_err"],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"],
         "bound_by": times[name]["bound_by"],
         "library_ms": times[name].get("library_ms")}
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
