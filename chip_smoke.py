#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure stops the script with a
non-zero exit and no result line:

1. environment: torch, CUDA, nvcc and the card (name, power limit);
2. build: nvcc compiles the two CUDA sources,
   ``src/repro_torch/csrc/table_kernels.cu`` (K1-K4, K9, K10) and
   ``src/repro_torch/csrc/paged_attn.cu`` (K5-K8), and each once more per
   timing build (``BUILDS``: the parent K1/K2 design, the parent chunk
   design), one process each, all started together; then ptxas's report (registers,
   spills, static shared memory) on the chunk kernel's instantiations;
2a. locks (on the host, while nvcc builds): the paper's lock experiments
   and the host analysis (``locks_phase``): every lock variant under
   ``LiveMem`` and ``SimMem`` (``repro_torch.benchmarks.smoke_locks``),
   the source lint over ``src/repro_torch`` with PyTorch's host syncs in
   its lease-window rule (0 findings, empty allowlist), and
   ``figures.test_rwlock`` for ``ba`` and ``bravo-ba`` at 4 readers and
   ``figures.alternator('bravo-ba', 4)``, whose rows are virtual time on
   the simulator's modelled 72-CPU X5-2;
3. kernels: each table kernel (K1-K4) against its plain PyTorch version on
   the card, exact, at the 4096-slot table with M in {1, 4, 16, 256}, K in
   {1, 5, 128} and seeded sweeps with collisions, cleared bias lanes, -1
   slots and occupied slots; K3 and K9 also on tables of 1024 to 1,048,576
   slots and on an unaligned view, for locks in no slot, one, only the
   last, every slot and 0, -1, -2**31 and 2**31 - 1; K4 on the same
   tables at K in ``MULTI_KS`` (1 to 1000, duplicates, those edge values
   and values in no slot) and 5000, one CTA a value; ``held_multi`` of a
   registry of 200 locks plus duplicates in one K4 launch (F4); the legacy
   table kernels K9 (the revocation scan) and K10 (the sequential publish) the
   same way, exact, with K10's sequential
   edge cases (duplicate unconditional stores, id 0, slots outside the
   table) and, in both modes, at M in ``SEQ_MS`` with collisions placed
   across warps and chunks on tables of 1024 to 1,048,576 slots and on an
   unaligned view, its input table unchanged; K1/K2 also at a batch of
   3000 (three chunks of 1024), at M in ``LEASE_MS`` (around a warp and a
   chunk), the single-lock K2 lease entries on 64-bit reader ids, and
   every K1/K2 entry on every K1/K2 build with collisions placed across
   warp and chunk boundaries, denied requests on later winners' slots and
   slots outside the table, on tables of 4096 and 65,536 slots over 128
   and 129 lanes; the paged attention kernels
   K5 (decode) and K6 (chunk prefill) against theirs at the engine's
   shapes, at gemma-2b's and granite-20b's head shapes (hd 256; 48 query
   heads on one KV head), at head dims the kernels pad (hubert-xlarge's
   80, phi-3-vision's 96, both one query head a KV head, and 12, whose
   bf16 and int8 rows are no whole number of 16-byte chunks) and in seeded
   sweeps over the traps (-1 lanes
   inside and past ``cache_len``, ``cache_len`` 0, a partial last page,
   padding columns, ``new_lens`` 0, a chunk longer than the paged prefix,
   every q/page type pair), within the stated tolerances; K5 and K6 also
   at forced KV split counts (1, 2, 3, one per lane) and on pages that are
   not 16-byte aligned (K6 also with 48 query heads on one KV head and at
   hd 12), K5 at the long-context shape (16 requests of 3584-4096
   positions), K6 at the two long-prefix shapes (2 rows of 32 or 256
   columns at the end of 3584-4096 positions); K7 and K8 (the same over
   int8 pages with per-page scales) against theirs over the same traps
   plus an all-zero page and a page whose group max saturates (spikes of
   6, absolute tolerance, and of 40, relative), at the same forced splits,
   unaligned pages and long shapes, and against the float32 K5/K6 on the
   pages before quantization; ``requant_scatter`` (the quantized store's
   write path) on the card byte for byte against the CPU; then each
   kernel's time (CUDA events, median) at the engine's shapes beside its
   plain version's, its bound and, for K5-K8,
   ``scaled_dot_product_attention`` over K/V already gathered dense (and
   dequantized, for K7/K8); K5/K7 also at the long-context shape and
   K6/K8 at the two long-prefix shapes; each K5-K8 time beside the parent
   chunk design's (for K5/K7 called at S = 1) and the kernel's forced to
   one split, timed in the same run; a kernel that does nothing,
   launched and timed as K1-K4 are (``launch_floor_ms``), and two one-warp
   floors under K1/K2 (``load_floor_ms``: a load and a store a thread;
   ``chain_floor_ms``: two dependent loads and a store); K1 and K2 (the
   release and the single-lock acquire) and the tick's acquire-release
   pair on the wrappers' build and the parent design in turns at the tick
   (4 requests over 5 lanes), at registry_bench's 128 over 32, at 1024
   over 128 and at 3000 over 128 (``lease_designs``); K3 and K10 the same
   way against their parent designs, K3 on 4096 and 65,536 slots, K10 in
   both modes at 64, 1024 and 3000 requests on 4096 slots and at 64 on
   65,536 and 1,048,576, where the parent refuses the table
   (``poll_publish_designs``); K4 at ``MULTI_SHAPES`` (K 1-5000 on 4096
   slots, K 5 and 1000 on 65,536) and K9 on 4096 and 65,536 slots against
   the parents and K3 on the same table, in turns (``scan_designs``; the
   parent K4 refuses K > 128);
3b. autotune: ``repro_torch.kernels.autotune`` on the ``paged`` build
   (``autotune_phase``): K5/K7's ``min_split_positions`` and K6/K8's
   ``pairs`` swept at llama3.2-1b's heads on 256 lanes of 16 (decode 16
   rows, chunk 2 rows x 32 columns), every candidate checked against the
   plain version (1e-5) before it is timed (a CUDA graph of 100 launches,
   median of 11 windows, twice in turns), the winners written to a
   temporary table; then the wrappers' plans read back with the committed
   ``kernels/tuning_table.json`` in force, equal to the committed knob's
   plan at the sweep shapes and to the built-in plan at the tick shapes;
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
   host-device sync); each gated tick is a replay of the step's CUDA
   graph (the tick before it runs eagerly and captures); the ticks'
   tokens are read after the gate closes;
5. engine: llama3.2-1b at its published width and depth (random weights
   from a seed, float32 parameters, bf16 compute), the handler-mode
   ``ServingEngine`` with weight hot-swap and compaction serving 8 requests
   of 16 prompt tokens and 16 new tokens; the table drains, every page is
   free, K1-K4 each launched during the run, and no request's greedy output
   is one token repeated; the handler steps run as CUDA graphs, one set a
   thread and batch size, their warm-ups, captures and replays recorded
   and every call one of a warm-up or a replay; the B = 4 decode step
   graphed and eager in turns (``decode_step_ms``: tokens equal step for
   step, one capture, each arm's times and profile);
6. scheduler: the same model in scheduler mode (continuous batching over a
   2.1 GB bf16 page store, prefix cache on) serving 12 requests in two
   waves under hot-swap and compaction, the second wave repeating or
   sharing the first wave's prompts; every request finishes, every page is
   free with no refcount left, the table drains, the prefix cache saved
   pages and copied a boundary page, and K1, K2, K3, K5 and K6 each
   launched during the run; then the same run without swaps on the bf16
   store and on the quantized store (``quant_kv=True``, int8 pages with
   float32 scales, 1.07 GB of K/V), which must launch K7 and K8 and
   neither K5 nor K6, count its quantized tokens and prefix hits, hold
   exactly half the bf16 run's K/V bytes and agree with the bf16 run's
   tokens on at least the stated share (without swaps, which ticks see
   which weights cannot move the share); then the
   bf16 run again on a store of ``EVICT_PAGES`` pages, where decode growth
   evicts running requests: it must evict at least once and finish every
   request with every page free and the table drained after ``stop()``;
   its K6 launches and the share of its tokens equal to the roomy run's
   are recorded; the scheduler engine's paged steps run as CUDA graphs
   (``steps.jit_step``) in every phase, and each scheduler run records
   its captures and ``torch.cuda.memory_allocated`` before, at its peak
   and after ``stop()``, which may not grow by more than
   ``SWAP_TREES_PEAK`` and ``SWAP_TREES_AFTER`` parameter trees whatever
   the number of swaps; the copy-on-write page copy runs as one graph a
   store: a warm-up at the first copy, a capture at the second, replays
   after;
6a. the serving benchmark twins at full width, each with the reference's
   gates and its repeated windows (``TWIN_WINDOWS``) reported as median,
   least and largest: ``obs_bench`` (``repro_torch.benchmarks.obs``: the
   emit site's cost, the tracing cost a decode step over untraced/traced
   pairs in turns, an identity swap's Chrome timeline, the traced
   registry pair under the sync gate), ``scheduler_bench`` (K5 at the
   reference's shape, the scheduler engine against the dense loop, the
   lease round trip and a paged decode step under the sync gate, the
   handler engine and the admission sweep over ``max_slots`` 1-8, each
   point graphed and eager in turns),
   ``prefill_bench`` (K6 against its plain version and the dense gather,
   no dense KV buffer among the shapes K6's wrapper makes, the prefix
   dedup sweep, K6 against the dense gather at three widths) and
   ``quant_bench`` (int8 page economics at the smoke config and full
   width, K7's error bounds, K5/K7 and K6/K8 timed in turns, the slo
   trace's prefix-index collision rate); tokens, teacher-forced, within a
   near-tie of the dense greedy loop's best;
6b. slo: the port's closed-loop SLO benchmark
   (``repro_torch.benchmarks.slo``) at full width: the latency-feedback
   controller calibrated on the card, then the reference's smoke burst
   trace (2.5 s, 8 requests/s, bursts of 5x) replayed against a static
   and a closed-loop scheduler engine of 8 slots, three replays of each
   in turns; zero dropped requests,
   at least one controller decision, a valid Chrome export with counter
   tracks, the sampled request's tokens the same in both replays and,
   teacher-forced, within a near-tie of the dense greedy loop's best at
   every step; the same request at float32 compute through the prefix
   cache equal to the dense loop at float32; the closed loop's p99 TTFT /
   goodput band on the medians of the replays recorded; then the same with
   the trace's arrivals compressed (2x, 4x, ... until a static replay's
   wall is ``OVERLOAD_RATIO`` times the arrivals' span), where the
   graphed engine queues, its band on the medians recorded too;
6c. hotswap: the port's hot-swap benchmark
   (``repro_torch.benchmarks.hotswap``) at full width and the twin's full
   sizes: 8 identity swaps under 8 requests; the float32 parameters
   (~4.9 GB) saved as a checkpoint, staged onto the card and swapped in
   while a feeder keeps every slot decoding, timed apart, and a copy with
   one corrupted CRC rejected at staging before any lock; device memory
   over the identity swaps grows by less than one tree; a wedged
   reader degrading the swap until its lane is scrubbed and the retry
   lands; every request finishes with the tokens the same engine gives
   without a swap, which stand, teacher-forced, within a near-tie of the
   dense greedy loop's best;
6d. faults: the seven-fault matrix (``repro_torch.ft.faults``) and its
   golden run on the full-width weights, every invariant true;
   ``corrupt_checkpoint`` links the hotswap phase's shards; the
   checkpoint directory is deleted afterwards.  Each of 6a-6d counts its
   launches alone; ``obs_bench`` and 6b-6d must launch K1, K2, K3, K5 and
   K6, ``scheduler_bench`` and ``prefill_bench`` K1, K2, K5 and K6,
   ``quant_bench`` K5-K8;
7. graph_step: the graphed step against the bare one (``smoke.
   eager_steps``) on the bf16 and the int8 store, one thread, no swap:
   the scheduler phase's two waves give equal tokens and equal K5-K8
   launches; at float32 compute every replayed decode tick's logits lie
   within ``GRAPH_LOGITS_REL`` of the largest; across a ``store.swap`` to
   a second seed's parameters between two decode ticks the tokens stay
   equal with exactly one recapture; decode ticks at 2 and 8 active rows
   and prefill ticks timed in turns (``GRAPH_WINDOWS`` windows; host
   wall, CUDA events, the profiled device ms and busy share, the capture
   ms, and the graphed tick's breakdown: lease pair, step call, replay,
   token read); the graphed page copy byte for byte against the eager one
   on each store, one capture; 8 swaps to new trees, each recaptured, grow
   ``memory_allocated`` by less than two trees;
7a. serve_bravo: ``repro_torch.examples.serve_bravo`` (handler mode on
   the smoke llama, 8 requests, swaps every 0.25 s, compaction every 0.4
   s) for ``bravo-ba``, ``ba`` and ``bravo-pthread``: every request done,
   K1-K3 launched, every handler call a warm-up or a replay;
8. tokens: with one request per batch and no swap, the handler-mode
   engine's tokens equal the dense greedy loop through the port's decode
   step (``benchmarks.smoke.dense_reference``);
9. precision: full-width decode steps with a float32 cache against one
   float32 forward pass over the same tokens (no cache); the engine's bf16
   compute against float32 compute on the same parameters; the paged path
   (prefill in chunks, then paged decode, float32 pages) against the same
   forward pass; the same over the quantized store (int8 pages, float32
   compute, through K8 and K7); and the scheduler engine's bf16 tokens
   against the dense greedy loop on the same prompts, each within its
   stated tolerance;
10. families: every other registered decoder config at full width, one
   model at a time, each released before the next with
   ``memory_allocated`` back within one store (its page store or decode
   caches) of the phase's start: ``rwkv6-7b`` (ssm) at 8 of 32 layers,
   ``zamba2-2.7b`` (hybrid) at 18 of 54, ``phi3.5-moe`` at 8 of 32 and
   ``llama4-maverick`` at 2 of 48 (moe, bf16 parameters;
   ``FAMILY_HANDLER``) in handler mode as in phase 5 (hot swaps of a new
   final norm scale, K1-K4 launched, graphed handler steps, the B = 4
   decode step graphed and eager in turns, the engine graphed and then
   on the bare steps, two requests alone equal to the greedy loop); and
   ``gemma-2b``, ``minicpm-2b`` (bf16) at 10 of 40 layers,
   ``phi-3-vision-4.2b`` at 8 of 32 and ``granite-20b`` at 13 of 52
   (``FAMILY_SCHEDULER``) in graphed
   scheduler mode as in phase 6 (K1-K3, K5, K6 launched), their tokens
   teacher-forced within ``BF16_VS_F32_REL`` of the dense loop's best,
   K5/K6 held to their plain versions at each config's head shape and
   timed at its tick shape beside SDPA and the byte bound;
11. train: the training path (``repro_torch.training``: ``loss_fn``,
   autograd, AdamW, the data pipeline, checkpoints), which runs none of
   the port's kernels (no launch counted in the phase): llama3.2-1b at
   full width and depth and hubert-xlarge at full width, 24 of 48 layers
   (``TRAIN_CONFIGS``), on train_4k's sequences of
   4096, the global batch cut to ``TRAIN_BATCH`` in microbatches of 1
   with every block recomputed: the step as one CUDA graph
   (``jit_train_step``, in place) and eager, ``TRAIN_TIMED_STEPS`` timed
   steps of each, the eager arm first (``train_run``: loss, gradient norm
   and sampled updates of the graph within ``train_card_vs_cpu``'s bounds
   of the eager step on the same batches; step ms, tokens/s, CUDA-event
   ms, the replays' included, capture ms, peak ``memory_allocated``,
   every step's loss finite and the first near ln V); one step of
   llama3.2-1b
   at full width, 2 layers, on the card against the same step on the CPU
   (``CARD_VS_CPU``); ``repro``'s quickstart contract (the smoke llama's
   loss down by 0.5 in 60 graphed steps); 6 graphed steps equal to 3 +
   checkpoint + restore + 3, bit for bit, under deterministic algorithms;
   ``memory_allocated`` back within one train batch of the phase's
   start;
12. mesh, the last phase (``mesh_phase``): the mesh layer over
   ``torch.distributed``, one rank a card over NCCL from a ``file://``
   store (on this one card in the script's process; on a machine of N
   cards one process a card, each running the same checks), torn down
   after: llama3.2-1b's graphed meshed scheduler engine at (data, model)
   = (2, N / 2) ((1, 1) on one card) against its bare steps in turns,
   hot swaps on and then off (tokens teacher-forced within 0.05, K1/K2/
   K5/K6 launched, warm-ups, captures, replays and the swaps' ticks the
   same on every rank, the no-swap tokens equal); the same engine with
   the latency controller on (``mesh.controller``: the ``slo`` twin's
   burst trace at the least speed that overloads it, one static and one
   closed-loop replay, rank 0's controller deciding, at least one
   decision, every rank's decision log and tokens equal, none dropped);
   handler mode on the mesh (``mesh.handler``: phi3.5-moe at 16 of 32
   layers at (1, N) and rwkv6-7b at 4 of 32 at (2, N / 2); at one card
   phi3.5-moe at 2; 2 handlers x 4 slots taking turns, graphed and bare under swaps
   and without, tokens, graph decisions and swap turns equal on every
   rank, K1-K4 launched, the B = 4 decode step on the mesh and off it in
   turns); ``make_distributed_
   revoke`` and ``make_sharded_revoke`` on ("data",) = N and ("pod",
   "data") = (2, N / 2), a registry's 16 KB table with 1000 readers
   holding one lock (counts equal to K3's and numpy's, only that lock's
   bias lane cleared), then the registry's revoke through
   ``configure_mesh``; ``make_compressed_psum`` over ("data",) = N on
   every leaf of one full-width train step's gradients (exact); the
   twins' ``mesh2d`` at (1, 1, 1) (one card) and ``collective``;
   phi3.5-moe's MoE layer at full width with its 16 experts over "model"
   = N, the capacity and the dropless bodies against the one-device layer
   (on each shard's tokens for the capacity body) on float32 activations
   (``MESH_MOE_REL``); phi3.5-moe's expert-parallel train step at full
   width cut to one layer, at (1, N) and (2, N / 2), eager and then
   graphed on the same batches from the same trees (the graph within
   1e-5, losses finite, losses and sampled parameters equal on every
   rank); all-reduces, all-gathers and all-to-alls counted.

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
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
INT_OPS_PER_S = 67e12          # H100 SXM float32 rate outside tensor cores
TENSOR_OPS_PER_S = 989e12      # H100 SXM bf16 tensor-core rate, dense
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
# The chunk kernel's long-prefix shapes (K6/K8 checks and times): 2 rows
# (the scheduler's prefill_rows) of a chunk at the end of a prefix of
# 3584-4096 positions, on llama3.2-1b's attention and 256 lanes of 16 in a
# 4096-page store; the chunk 32 columns wide (the scheduler's
# prefill_chunk) or 256 (a wide chunked-prefill width for long prompts).
LONG_PREFIX = dict(b=2, h=32, kvh=8, hd=64, ps=16, lanes=256, n_pages=4096)
LONG_PREFIX_COLUMNS = {"long_prefix": 32, "long_prefix_wide": 256}
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
# K6/K8 at forced split counts and on unaligned pages (_chunk_variants):
# short rows, rows of up to 1024 positions (20 columns x 4 heads = 80
# pairs), 160 pairs (more than one block in every layout), granite-20b's
# 48 query heads on one KV head (blocks that cut a column's heads), and hd
# 12 (rows of 24 and 12 bytes, copied element by element)
CHUNK_SPLIT_SHAPES = [dict(b=5, s=5, h=8, kvh=2, hd=64, ps=4, lanes=9,
                           n_pages=64),
                      dict(b=5, s=20, h=8, kvh=2, hd=64, ps=16, lanes=64,
                           n_pages=512),
                      dict(b=4, s=40, h=32, kvh=8, hd=64, ps=16, lanes=16,
                           n_pages=256),
                      dict(b=4, s=3, h=48, kvh=1, hd=128, ps=8, lanes=12,
                           n_pages=64),
                      dict(b=5, s=3, h=6, kvh=6, hd=12, ps=4, lanes=9,
                           n_pages=64)]
# The int8 trap page with a spike of 40 (outputs of ~40) against the plain
# K7/K8: float32 outputs within 1e-5 of the largest output, relative, since
# float32 rounding at that magnitude alone reaches 1e-5 absolute.
QUANT_SPIKE = 40.0
QUANT_SPIKE_REL = 1e-5
# K1/K2 at a batch of three 1024-request chunks
BIG_BATCH = 3000
# K1/K2 at batches around a warp and a chunk, with collisions placed across
# warp and chunk boundaries (_placed_case), on the 4096-slot table and on
# one of 65,536, over 128 lanes (the registry's most) and 129, on the
# wrappers' build and the parent design
LEASE_MS = (31, 32, 33, 64, 1023, 1024, 1025)
LEASE_ROWS = (32, 512)
LEASE_LANES = (128, 129)
# K1/K2 timed against the parent design: (batch, lanes) of the tick, of
# registry_bench, of a chunk and of three chunks
LEASE_SHAPES = ((4, 5), (128, 32), (1024, 128), (BIG_BATCH, 128))
# K10 checked at batches around a warp and a chunk and at three chunks, with
# collisions placed across warps and chunks (_seq_placed_case), and K3 and
# K10 on tables of 1024, 4096, 65,536 and 1,048,576 slots (the parent K10
# took at most 56,064)
SEQ_MS = (1, 31, 32, 33, 64, 1023, 1024, 1025, BIG_BATCH)
TABLE_ROWS = (8, 32, 512, 8192)
# K3 and K10 timed against the parent designs: K3 on 4096 and 65,536 slots;
# K10 (batch, rows) at the legacy pair's 64 requests on 4096 slots, at a
# chunk and three chunks, and at 64 on the larger tables
POLL_ROWS = (32, 512)
SEQ_SHAPES = ((64, 32), (1024, 32), (BIG_BATCH, 32), (64, 512), (64, 8192))
# K4 (one CTA a lock value) checked at these numbers of lock values (up to
# 1000, one value past the parent's 128, duplicates at 1000) on every table
# of TABLE_ROWS, and at MULTI_BIG_K on those up to 65,536 slots.  Every
# int32 is a lock value: EDGE_VALUES are in the tables and the lock vectors
MULTI_KS = (1, 5, 8, 16, 128, 129, 1000)
MULTI_BIG_K = 5000
EDGE_VALUES = (0, -1, -2**31, 2**31 - 1)
# K4 timed against the parent design: (slots, K) at the handler's 5, at
# 1-16 and 128, at 1000 and 5000 (the parent refuses), and at 5 and 1000
# on 65,536; K9 on SCAN_ROWS tables
MULTI_SHAPES = ((4096, 1), (4096, 5), (4096, 8), (4096, 16), (4096, 128),
                (4096, 1000), (4096, MULTI_BIG_K), (65536, 5), (65536, 1000))
SCAN_ROWS = (32, 512)
SOURCES = {"table": "src/repro_torch/csrc/table_kernels.cu",
           "paged": "src/repro_torch/csrc/paged_attn.cu"}
# builds: (source, build-time switches), the switches those of
# table_publish.PARENT_DEFINES and paged_attn.PARENT_DEFINES.  Timing only:
# "table_parent" runs the parent K1/K2, K3 and K10 designs, "paged_parent"
# the parent chunk design
BUILDS = {"table": (SOURCES["table"], ()),
          "table_parent": (SOURCES["table"], ("BRAVO_TABLE_PARENT=1",)),
          "paged": (SOURCES["paged"], ()),
          "paged_parent": (SOURCES["paged"], ("BRAVO_CHUNK_PARENT=1",))}
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
# the writer-path phases (slo, hotswap, faults) at full width: the
# checkpoint directory (the float32 parameters, ~4.9 GB of 256 MB shards)
# is kept from the hotswap phase for the faults phase, deleted at the end
CKPT_DIR = os.path.join(ROOT, ".chip_ckpt")
WRITER_KERNELS = ["fused_publish_multi", "fused_publish", "revocation_poll",
                  "paged_attention", "paged_chunk_attention"]
# the serving benchmark twins' phases (obs, scheduler, prefill, quant) at
# full width: the kernels each must launch, and the repeated windows (obs:
# untraced/traced pairs; scheduler: rounds of the admission sweep; prefill
# and quant: timing readings in turns); slo: replays of each arm
ENGINE_KERNELS = ["fused_publish_multi", "fused_publish", "paged_attention",
                  "paged_chunk_attention"]
# (scheduler at 2 since the mesh phase's train step joined the script:
# 42.3 s at 3 on a host whose script then took 1286.4 s; slo at 3, since a
# median of 2 replays is their mean and one slow replay moves the band)
TWIN_WINDOWS = {"obs": 5, "scheduler": 2, "prefill": 3, "quant": 3,
                "slo": 3}
# the eviction run: the same scheduler phase on a store so small that
# decode growth evicts (a request needs up to 6 pages of 16; wave 1's six
# need about 27); at 12-20 pages the port's CPU run of the smoke config
# evicted 1-2 times
EVICT_PAGES = 16
# the graph_step phase: eager and graphed ticks timed in turns, windows of
# ticks an arm, at 2 and 8 active rows; a replayed tick's float32 logits
# against the eager tick's, relative to the largest logit (3 windows since
# the mesh phase's train step joined the script: 78.5 s at 5 on a host
# whose script then took 1286.4 s; 2 since the slo phase's third replay,
# which it pays for: 74.1 s at 3 on a host whose script took 1053.1 s)
GRAPH_WINDOWS = 2
GRAPH_TICKS = 8
GRAPH_ROWS = (2, 8)
GRAPH_LOGITS_REL = 1e-5
# decode_step_ms: handler mode's B-row step graphed and eager in turns
HANDLER_WINDOWS = 6
HANDLER_WINDOW_STEPS = 5
# graph_step's copy-on-write check: a store of COPY_PAGES pages, copies
# (src, dst), one a page the copy before wrote
COPY_PAGES = 64
COPY_PAIRS = ((3, 10), (5, 11), (10, 12), (63, 0))
# device memory over a scheduler run with swaps, in parameter trees: after
# stop() (which drops the graphs) the engine holds its store's new tree;
# at the peak also the older tree each of its two graphed steps may still
# hold, the tree a swap is building, and the graphs' pools; never a tree a
# swap
SWAP_TREES_AFTER = 1.25
SWAP_TREES_PEAK = 4.5
# the families phase: (arch, depth or None for the published depth).
# Handler mode serves the families the page store cannot hold; the depth
# cut is where the parameters exceed the card's 80 GB (phi3.5-moe: 84 GB
# of bf16 at 32 layers, so 16; llama4: one period of a dense and a
# 128-expert MoE layer, ~37 GB).  Scheduler mode serves the other dense
# and vlm configs at their own head shapes; granite-20b's float32
# parameters are ~81 GB at 52 layers, so 26.  Since the train phase
# (~160-230 s) joined the script, the three slowest runs at full depth
# (rwkv6-7b 35.9 s, minicpm-2b 74.6, phi-3-vision 70.1 on an H100 80GB
# HBM3, 700 W) run half their layers, so the script stays near 950 s of
# its 1200.
# zamba2-2.7b at 30 of 54 layers (a multiple of its hybrid_attn_every, 6)
# to keep the script inside its time with the locks and autotune phases;
# phi-3-vision at 8 of 32 (51.5 s at 16 on an H100 80GB HBM3, 700 W) to
# make room for the mesh phase.  Since the mesh phase's expert-parallel
# train step joined the script, on hosts where it took 1265.8-1286.4 s
# (the nvcc builds 83.6-87.1 s against 60.0 on PR 28's), minicpm-2b runs
# 10 of 40 layers (60.2 s at 20), granite-20b 13 of 52 (55.9 s at 26),
# rwkv6-7b 8 of 32 (36.7 s at 16), zamba2-2.7b 18 of 54 (39.2 s at 30)
# and phi3.5-moe 8 of 32 (33.8 s at 16)
FAMILY_HANDLER = (("rwkv6-7b", 8), ("zamba2-2.7b", 18),
                  ("phi3.5-moe-42b-a6.6b", 8),
                  ("llama4-maverick-400b-a17b", 2))
FAMILY_SCHEDULER = (("gemma-2b", None), ("minicpm-2b", 10),
                    ("phi-3-vision-4.2b", 8), ("granite-20b", 13))
# the families' variety check: a greedy output that repeats one token
# depends on neither cache nor attention, and a random deep model can have
# such a fixed point for some prompts (on an H100 80GB HBM3, 700 W, at
# seed 0: minicpm-2b and granite-20b, 2 of 12 scheduler requests each,
# every other check held); so at least this share of each run's outputs
# must vary, every output is held by the run's other checks, and the
# repeated ones are counted in the record
FAMILY_VARIED = 0.5
# phase 11, training (``train_phase``): train_4k's sequences of 4096 at
# full width, its global batch of 256 cut to 4 (the card holds the float32
# parameters, gradients, moments and one step's new trees of llama3.2-1b,
# ~40 GB, beside the activations), in microbatches with every block
# recomputed; (config, layers).  The batch was 8 and hubert-xlarge ran all
# 48 layers until the mesh phase's expert-parallel train step joined the
# script (hubert 199.0 s, llama3.2-1b 76.5-78.5 s, on H100 80GB HBM3 hosts
# at 700 W whose script took 1265.8-1286.4 s)
TRAIN_CONFIGS = (("llama3.2-1b", None), ("hubert-xlarge", 24))
TRAIN_SEQ = 4096
TRAIN_BATCH = 4
TRAIN_PUBLISHED_BATCH = 256
TRAIN_MICROBATCHES = 4
TRAIN_TIMED_STEPS = 2           # timed steps of each arm
TRAIN_UPDATE_SAMPLES = 4096     # elements of each leaf held to the eager
TRAIN_LOSS_NEAR = 2.0           # nats: the first loss within this of ln V
# HuBERT's span masking (mask_prob 0.08, spans of 10 frames): the loss is
# taken over the masked frames, as its masked prediction is
HUBERT_MASK_PROB = 0.08
HUBERT_MASK_SPAN = 10
# one train step on the card against the same step on the CPU:
# llama3.2-1b at full width, 2 layers, 2 sequences of 256, float32
# compute, no TF32; the loss within 1e-5 and the gradient norm within
# 1e-4 relative, each sampled leaf's update within lr * (1e-3 + 1e-4 *
# max|g| / (|g| + eps)) (AdamW's first step moves an element by g / (|g|
# + eps), so an element near eps carries the gradient's absolute error
# into its update magnified; tests/test_torch_train_b.py), its moments
# within 1e-4 of their largest
CARD_VS_CPU = dict(layers=2, seq=256, batch=2)
CARD_VS_CPU_LOSS_REL = 1e-5
CARD_VS_CPU_GRAD_REL = 1e-4
CARD_VS_CPU_LEAVES = ("final_ln", "embed", "layers.attn.wq", "layers.attn.wk",
                      "layers.mlp.wo")
QUICKSTART_STEPS = 60
QUICKSTART_DROP = 0.5


_T0 = time.monotonic()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries ``elapsed_s``, the
    seconds since the script started, so a run shows where its time
    went."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.monotonic() - _T0}
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

    ms = [1, 4, 16, 256, *LEASE_MS]
    for seed in seeds:
        rng = np.random.default_rng(seed)
        big = [BIG_BATCH] if seed < 2 else []
        if seed < 2:
            _check_lease_placements(rng, dev, agree, out)
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
        _check_poll_tables(rng, dev, agree, multi=seed < 2)
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
        _check_legacy_edges(rng, dev, agree, placed=seed < 2)
    out["registry_held_multi"] = _check_registry_multi(dev, agree)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out


def _placed_case(rng, m, dev, rows=32, n_locks=128):
    """A table of ``rows`` x 128 slots (~7% occupied), ``n_locks`` bias
    lanes (lane 0 set, lane 1 cleared, the rest 70% set) and M requests
    with these placed where M reaches them: two biased requests for one
    free slot in one warp (4, 29), in different warps (3, 40) and in
    different chunks (1000, 1030); an earlier denied request on a later
    winner's free slot across warps (5, 37) and across chunks (1023,
    1024); biased requests for slots -1 (7) and n_slots + 3 (9).  The
    hashed entries get the same placements: the pair's reader ids are
    equal and lane 1 carries lane 0's lock value, so a denied and a biased
    request hash to one slot; requests 11 and 13 name lanes -1 and n_locks
    (slot -1)."""
    import numpy as np
    import torch

    n_slots = rows * 128
    table = np.zeros(n_slots, np.int32)
    occ = rng.choice(n_slots, n_slots // 14, replace=False)
    table[occ] = rng.integers(1, 50, occ.size)
    free = np.flatnonzero(table == 0)
    rbias = (rng.random(n_locks) < 0.7).astype(np.int32)
    rbias[:2] = (1, 0)
    pool = np.concatenate([occ[:8], rng.choice(n_slots, max(2, m // 2))])
    slots = rng.choice(pool, m).astype(np.int32)
    lidx = rng.integers(0, n_locks, m).astype(np.int32)
    ids = rng.integers(1, 1000, m).astype(np.int32)
    vals = rng.integers(1, 2**31 - 1, n_locks).astype(np.int32)
    vals[1] = vals[0]
    rids = rng.integers(0, 2**31 - 1, m).astype(np.int32)
    mask = rng.random(m) < 0.8
    spots = rng.choice(free, 5, replace=False)
    for (a, b, lane_a), slot in zip(((4, 29, 0), (3, 40, 0), (1000, 1030, 0),
                                     (5, 37, 1), (1023, 1024, 1)), spots):
        if b < m:
            slots[a] = slots[b] = slot
            lidx[a], lidx[b] = lane_a, 0
            rids[a] = rids[b]
    for i, slot, lane in ((7, -1, 0), (9, n_slots + 3, 0), (11, -1, -1),
                          (13, 5, n_locks)):
        if i < m:
            slots[i], lidx[i] = slot, lane
    return {k: torch.from_numpy(v).to(dev) for k, v in dict(
        table=table.reshape(rows, 128), rbias=rbias, slots=slots, lidx=lidx,
        ids=ids, vals=vals, rids=rids, mask=mask).items()}


def _lease_calls(c):
    """Every K1/K2 entry on the placed case ``c``: (kernel, entry, launch,
    plain); ``launch(lib, table, granted)`` runs the entry of build ``lib``
    on ``table`` in place, ``plain(table)`` -> (new table, granted or
    None)."""
    import torch

    from repro_torch.kernels import ref as R
    from repro_torch.kernels import table_publish as TP

    dev = c["table"].device
    zero, one = (torch.full((), v, dtype=torch.int32, device=dev)
                 for v in (0, 1))
    lane0 = torch.zeros((), dtype=torch.int32, device=dev)
    rids64 = c["rids"].long() * (2**31 + 7) + 2**32
    calls = [
        ("fused_publish_multi", "publish_multi",
         lambda lib, t, g: TP._launch_publish_multi(
             lib, t, c["rbias"], c["slots"], c["lidx"], c["ids"], g),
         lambda t: R.publish_multi_ref(t, c["rbias"], c["slots"], c["lidx"],
                                       c["ids"])),
        ("fused_publish_multi", "acquire_hashed",
         lambda lib, t, g: TP._launch_acquire_hashed(
             lib, t, c["rbias"], c["vals"], c["lidx"], 1, c["rids"], g),
         lambda t: R.acquire_hashed_ref(t, c["rbias"], c["vals"], c["lidx"],
                                        c["rids"])),
        ("fused_publish_multi", "acquire_hashed_shared_lane",
         lambda lib, t, g: TP._launch_acquire_hashed(
             lib, t, c["rbias"], c["vals"], lane0.reshape(1), 0, c["rids"],
             g),
         lambda t: R.acquire_hashed_ref(t, c["rbias"], c["vals"], lane0,
                                        c["rids"])),
        ("fused_publish", "clear",
         lambda lib, t, g: TP._launch_publish(
             lib, t, one, c["slots"], torch.zeros_like(c["ids"]), g,
             unconditional=True, check_rbias=False),
         lambda t: (R.clear_ref(t, c["slots"]), None)),
        ("fused_publish", "publish_hashed_64",
         lambda lib, t, g: TP._launch_publish_hashed(
             lib, t, one, c["vals"], c["lidx"], 1, rids64, g),
         lambda t: R.publish_hashed_ref(t, one, c["vals"], c["lidx"],
                                        rids64)),
        ("fused_publish", "release_hashed",
         lambda lib, t, g: TP._launch_release_hashed(
             lib, t, c["vals"], c["lidx"], 1, c["rids"], c["mask"]),
         lambda t: (R.release_hashed_ref(t, c["vals"], c["lidx"], c["rids"],
                                         c["mask"]), None)),
    ]
    for rb, name in ((zero, "publish_bias_clear"), (one, "publish")):
        calls.append((
            "fused_publish", name,
            lambda lib, t, g, rb=rb: TP._launch_publish(
                lib, t, rb, c["slots"], c["ids"], g, unconditional=False,
                check_rbias=True),
            lambda t, rb=rb: R.publish_ref(t, rb, c["slots"], c["ids"])))
    return calls


def _check_lease_placements(rng, dev, agree, out) -> None:
    """Every K1/K2 entry on ``_placed_case`` at each M of ``LEASE_MS``,
    table size of ``LEASE_ROWS`` and lane count of ``LEASE_LANES``, against
    its plain version, exact: on the wrappers' build (counted under the
    kernel's name) and on the parent design's build
    (``out["lease_builds"]``)."""
    import torch

    from repro_torch.kernels import table_publish as TP

    libs = {"kernel": TP.table_lib(), "parent": TP.parent_lib()}
    rec = out.setdefault("lease_builds", {k: {"cases": 0, "matched": True}
                                          for k in libs if k != "kernel"})
    for m in LEASE_MS:
        for rows in LEASE_ROWS:
            for n_locks in LEASE_LANES:
                c = _placed_case(rng, m, dev, rows, n_locks)
                for kernel, entry, launch, plain in _lease_calls(c):
                    want_t, want_g = plain(c["table"].clone())
                    for build, lib in libs.items():
                        t = c["table"].clone()
                        g = torch.empty(m, dtype=torch.bool, device=dev)
                        launch(lib, t, g)
                        if build == "kernel":
                            agree(kernel, t, want_t)
                            if want_g is not None:
                                agree(kernel, g, want_g)
                            continue
                        ok = torch.equal(t, want_t) and (
                            want_g is None or torch.equal(g, want_g))
                        rec[build]["cases"] += 1
                        if not ok:
                            raise AssertionError(
                                f"{entry} on the {build} build differs from "
                                f"its plain version (M {m}, {rows} rows, "
                                f"{n_locks} lanes)")


def _poll_tables(rng, rows):
    """The tables K3, K4 and K9 are checked on, ``rows`` x 128 slots each,
    as numpy arrays with the single locks K3 and K9 look for: values 1-49
    with 60 in one slot and 61 only in the last (locks 77, in no slot, 60
    and 61); every slot 7 (lock 7); and a table ~90% free holding every
    value of ``EDGE_VALUES`` and values 1-49 (locks 0, -1, -2**31 and
    2**31 - 1)."""
    import numpy as np

    n = rows * 128
    flat = rng.integers(1, 50, n).astype(np.int32)
    flat[rng.integers(0, n - 1)] = 60          # one slot
    flat[-1] = 61                              # only the last slot
    edges = np.zeros(n, np.int32)
    used = rng.choice(n, n // 10, replace=False)
    edges[used] = rng.choice(np.array([*EDGE_VALUES, *range(1, 50)],
                                      np.int32), used.size)
    edges[used[:len(EDGE_VALUES)]] = EDGE_VALUES
    return [(flat, (77, 60, 61)), (np.full(n, 7, np.int32), (7,)),
            (edges, EDGE_VALUES[1:] + (0,))]


def _multi_locks(rng, k, values):
    """K lock values for K4 over a table holding ``values``: drawn from
    ``values``, ``EDGE_VALUES`` and values in no slot, the first entry
    repeated last (a duplicate) from K = 2, each edge value among the
    first four from K = 4.  -> int32 numpy vector."""
    import numpy as np

    absent = rng.integers(1000, 2**30, 16)
    pool = np.unique(np.concatenate([values, EDGE_VALUES, absent]))
    locks = rng.choice(pool, k).astype(np.int32)
    if k >= 4:
        locks[:4] = EDGE_VALUES
    if k >= 2:
        locks[-1] = locks[0]
    return locks


def _check_poll_tables(rng, dev, agree, multi=False) -> None:
    """K3 and K9 on the tables of :func:`_poll_tables` for each of
    ``TABLE_ROWS``, for a lock that matches no slot, one slot, only the
    last slot, every slot and each edge value, on the table and on a copy
    of it one element past 16-byte alignment (the scalar path).  With
    ``multi``, K4 on the same tables at each K of ``MULTI_KS`` (and
    ``MULTI_BIG_K`` up to 65,536 slots; :func:`_multi_locks`), through the
    wrapper."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref as R

    for rows in TABLE_ROWS:
        for values, locks in _poll_tables(rng, rows):
            t = torch.from_numpy(values.reshape(rows, 128)).to(dev)
            present = np.unique(values)
            ks = MULTI_KS + ((MULTI_BIG_K,) if rows <= 512 else ())
            lock_sets = [torch.from_numpy(_multi_locks(rng, k, present))
                         .to(dev) for k in (ks if multi else ())]
            for table in (t, _unaligned(t)):
                for lock in locks:
                    agree("revocation_poll", K.revocation_poll(table, lock),
                          R.poll_ref(table, lock))
                    mask, cnt = K.revocation_scan(table, lock)
                    want_m, want_c = R.scan_ref(table, lock)
                    agree("revocation_scan", mask, want_m)
                    agree("revocation_scan", cnt, want_c)
                for ids in lock_sets:
                    agree("revocation_poll_multi",
                          K.revocation_poll_multi(table, ids),
                          R.multi_count_ref(table, ids))


def _check_registry_multi(dev, agree) -> dict:
    """F4 at the registry: ``BravoRegistry(max_locks=200)`` with 200 locks,
    every seventh held by 30 readers, and ``held_multi`` over all 200 plus
    three duplicates, exact against ``multi_count_ref`` in one K4 launch.
    -> {handles, launches, held}."""
    import numpy as np
    import torch

    from repro_torch.core.registry import BravoRegistry
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import table_scan as TS

    rng = np.random.default_rng(21)
    reg = BravoRegistry(max_locks=200, device=dev)
    hs = [reg.alloc() for _ in range(200)]
    for h in hs[::7]:
        rids = rng.integers(0, 2**31 - 1, 30).astype(np.int32)
        reg.acquire(h, torch.from_numpy(rids).to(dev))
    handles = hs + [hs[0], hs[7], hs[199]]
    before = TS.REVOCATION_POLL_MULTI.value
    got = torch.from_numpy(reg.held_multi(handles))
    launches = TS.REVOCATION_POLL_MULTI.value - before
    want = R.multi_count_ref(reg.table, torch.tensor(
        [h.lock_id for h in handles], dtype=torch.int32, device=dev))
    agree("revocation_poll_multi", got, want.cpu())
    held = int(want.sum())
    expected = int(dev.type == "cuda")   # the CPU runs the plain version
    if launches != expected or held == 0:
        raise AssertionError(f"held_multi: {launches} K4 launches "
                             f"({expected} expected), {held} slots held")
    return {"handles": len(handles), "launches": launches, "held": held}


def _seq_placed_case(rng, m, rows):
    """K10 operands as numpy arrays: a table of ``rows`` x 128 slots (~7%
    occupied) and M requests (ids 0-999, a fifth of them 0) on a pool of
    occupied and free slots, with these placed where M reaches them: two
    nonzero ids for one free slot in one warp (4, 29), in different warps
    (3, 40) and in different chunks (1000, 1030), three in three chunks
    (10, 1500, 2500); id 0 before a nonzero id across warps (6, 45) and
    across chunks (1020, 1028); a nonzero id before id 0 (8, 50); both on
    an occupied slot (12, 60); slots -2, -1 and n_slots (14, 15, 16).
    -> (table (rows, 128), slots, ids), int32."""
    import numpy as np

    n_slots = rows * 128
    table = np.zeros(n_slots, np.int32)
    occ = rng.choice(n_slots, n_slots // 14, replace=False)
    table[occ] = rng.integers(1, 50, occ.size)
    free = np.flatnonzero(table == 0)
    pool = np.concatenate([occ[:8], rng.choice(n_slots, max(2, m // 2))])
    slots = rng.choice(pool, m).astype(np.int32)
    ids = rng.integers(1, 1000, m).astype(np.int32)
    ids[rng.random(m) < 0.2] = 0
    spots = rng.choice(free, 8, replace=False)
    groups = (((4, 29), (5, 6)), ((3, 40), (7, 8)), ((1000, 1030), (9, 10)),
              ((10, 1500, 2500), (11, 12, 13)), ((6, 45), (0, 14)),
              ((1020, 1028), (0, 15)), ((8, 50), (16, 0)))
    for (idx, vals), slot in zip(groups, spots):
        for i, v in zip(idx, vals):
            if i < m:
                slots[i], ids[i] = slot, v
    for i, v in ((12, 17), (60, 0)):
        if i < m:
            slots[i], ids[i] = occ[0], v
    for i, slot in ((14, -2), (15, -1), (16, n_slots)):
        if i < m:
            slots[i] = slot
    return table.reshape(rows, 128), slots, ids


def _check_legacy_edges(rng, dev, agree, placed=False) -> None:
    """K9 on tables of 8 and 64 rows; K10's sequential cases on small
    slots (duplicate unconditional stores with different ids, id 0, slots
    outside the table) and on a 128-row table; with ``placed``, K10 in both
    modes on ``_seq_placed_case`` at each M of ``SEQ_MS`` on tables of each
    of ``TABLE_ROWS`` (up to 1,048,576 slots), and at M 64 and 1025 on a
    table one element past 16-byte alignment (the scalar copy).  Each K10
    case is exact against ``publish_seq_ref`` (run on the CPU for the
    placed cases, where it loops in Python over up to 3000 requests) and
    leaves its input table unchanged."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import table_publish as TP

    def dev_t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def publish(table, slots, ids, host=False):
        before = table.clone()
        for unc in (False, True):
            got = TP.publish(table, slots, ids, unconditional=unc)
            args = [x.cpu() if host else x for x in (table, slots, ids)]
            want = R.publish_seq_ref(*args, unconditional=unc)
            agree("publish", got[0].to(want[0].device), want[0])
            agree("publish", got[1].to(want[1].device), want[1])
        if not torch.equal(table, before):
            raise AssertionError("publish: the input table changed")

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
        publish(dev_t(table), dev_t(slots), dev_t(ids))
    if not placed:
        return
    for m in SEQ_MS:
        for rows in TABLE_ROWS:
            table, slots, ids = map(dev_t, _seq_placed_case(rng, m, rows))
            publish(table, slots, ids, host=True)
            if rows == 32 and m in (64, 1025):
                publish(_unaligned(table), slots, ids, host=True)


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
    from repro_torch.kernels import paged_chunk_attn as PCA
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
            _paged_agree(out, "paged_chunk_attention",
                         K.paged_chunk_attention(q, kp, vp, pi, cl, nl),
                         R.paged_chunk_attn_ref(q, kp, vp, pi, cl, nl),
                         _padding(q, cl, nl))
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
    for (qd, kd), sh in itertools.product(types, CHUNK_SPLIT_SHAPES):
        q, kp, vp, pi, cl, nl = _paged_case(rng, dev, q_dtype=qd,
                                            kv_dtype=kd, **sh)
        want = R.paged_chunk_attn_ref(q, kp, vp, pi, cl, nl)
        for got in _chunk_variants(PCA.paged_chunk_attention, q, (kp, vp),
                                   (), pi, cl, nl):
            _paged_agree(out, "paged_chunk_attention", got, want,
                         _padding(q, cl, nl))
    for name, cols in LONG_PREFIX_COLUMNS.items():
        q, kp, vp, pi, cl, nl = _long_prefix_case(rng, dev, torch.bfloat16,
                                                  cols)
        want = R.paged_chunk_attn_ref(q, kp, vp, pi, cl, nl)
        for got in _chunk_variants(PCA.paged_chunk_attention, q, (kp, vp),
                                   (), pi, cl, nl,
                                   forced=name == "long_prefix"):
            _paged_agree(out, "paged_chunk_attention", got, want, None)
    torch.cuda.synchronize()
    return out


def _padding(q, cl, nl):
    """(B, S) True where a chunk column is no query (padding, or a
    position before 0): its output must be exactly zero."""
    import torch

    s = q.shape[1]
    col = torch.arange(s, device=q.device)
    return ((col[None, :] < s - nl[:, None])
            | (cl[:, None] - s + col[None, :] < 0))


def _unaligned(x):
    """The same values at an address one element past 16-byte alignment
    (a contiguous view at an odd storage offset): the paged kernels then
    copy their rows element by element, K3 and K10 read 4-byte words."""
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


def _chunk_variants(fn, q, pages, scales, pi, cl, nl, forced=True):
    """K6 or K8 on one case: the split and layout the wrapper ``fn`` picks
    and, with ``forced``, in each layout (64 pairs a CTA; 128 and 16 where
    head_dim is 33 to 64) forced splits of 1, 2, 3 and one per lane (so
    splits past ``cache_len`` and splits of -1 lanes only occur) and pages
    that are not 16-byte aligned (one split and three); else one split
    besides in each layout."""
    from repro_torch.kernels import paged_chunk_attn as PCA

    lanes = pi.shape[1]
    yield fn(q, *pages, *scales, pi, cl, nl)
    lo, hi = PCA.PAIRS_HD
    layouts = ([PCA.WIDE_PAIRS, PCA.SMALL_PAIRS]
               if lo <= q.shape[-1] <= hi else [PCA.CHUNK_PAIRS])
    bad = [_unaligned(x) for x in pages]
    for pairs in layouts:
        for n in (1, 2, 3, lanes) if forced else (1,):
            yield PCA._chunk(q, *pages, scales, pi, cl, nl, n_split=n,
                             pairs=pairs)
        for n in (1, 3) if forced else ():
            yield PCA._chunk(q, *bad, scales, pi, cl, nl, n_split=n,
                             pairs=pairs)


def _long_prefix_case(rng, dev, kv_dtype, cols):
    """A long-prefix chunk: 2 rows of ``cols`` columns, every one real, at
    the end of 3584-4096 positions on 256 lanes of 16 (``LONG_PREFIX``),
    float32 q; -> _paged_case's tuple."""
    import numpy as np
    import torch

    b = LONG_PREFIX["b"]
    return _paged_case(rng, dev, s=cols, q_dtype=torch.float32,
                       kv_dtype=kv_dtype, traps=False,
                       clen=rng.integers(LONG_LENGTHS[0], LONG_LENGTHS[1] + 1,
                                         b),
                       nl=np.full(b, cols), **LONG_PREFIX)


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
    from repro_torch.kernels import paged_chunk_attn as PCA
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
            pad = _padding(q, cl, nl)
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
    for qd, sh in itertools.product(q_types, CHUNK_SPLIT_SHAPES):
        q, kp, vp, pi, cl, nl = _paged_case(rng, dev, q_dtype=qd,
                                            kv_dtype=torch.float32, **sh)
        _, _, kq, vq, ks, vs = _quantized(kp, vp, pi, traps=True)
        want = R.paged_chunk_attn_quant_ref(q, kq, vq, ks, vs, pi, cl, nl)
        for got in _chunk_variants(PCA.paged_chunk_attention_quant, q,
                                   (kq, vq), (ks, vs), pi, cl, nl):
            _paged_agree(out, "paged_chunk_attention_quant", got, want,
                         _padding(q, cl, nl))
    for name, cols in LONG_PREFIX_COLUMNS.items():
        q, kp, vp, pi, cl, nl = _long_prefix_case(rng, dev, torch.float32,
                                                  cols)
        _, _, kq, vq, ks, vs = _quantized(kp, vp, pi, traps=False)
        want = R.paged_chunk_attn_quant_ref(q, kq, vq, ks, vs, pi, cl, nl)
        for got in _chunk_variants(PCA.paged_chunk_attention_quant, q,
                                   (kq, vq), (ks, vs), pi, cl, nl,
                                   forced=name == "long_prefix"):
            _paged_agree(out, "paged_chunk_attention_quant", got, want, None)
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
    grants.  K9 runs K3's layout and stores a mask word a thread a group
    of four slots; K10 one request per
    thread in each CTA of a grid that cuts the table's copy into one slice
    a CTA (no table is staged in shared memory).  K10's plain version loops over the
    requests in Python, a few launches each, so its windows hold 10 calls
    instead of 100.

    ``launch_floor``: a kernel that does nothing, launched as the scans
    are and timed the same way; each table kernel's ``above_floor_us`` is
    its time less that floor.  ``load_floor`` and ``chain_floor``: one warp
    that does one load and one store a thread, or two dependent loads
    (``vals[idx[t]]`` over a 4096-entry vector) and a store, timed the same
    way; ``above_chain_us`` is a kernel's time less the chain floor."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import table_publish as TP
    from repro_torch.kernels import table_scan as TS

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
    floor = _median_ms(lambda: TS.empty_launch(dev))
    out["launch_floor"] = {"ms": floor["graph_ms"],
                           "call_ms": floor["call_ms"]}
    fsrc = torch.arange(TS.FLOOR_THREADS, dtype=torch.int32, device=dev)
    fout = torch.empty_like(fsrc)
    fvals = torch.arange(4096, dtype=torch.int32, device=dev)
    fidx = torch.from_numpy(rng.integers(0, 4096, TS.FLOOR_THREADS)
                            .astype(np.int32)).to(dev)
    TS.chain_floor_launch(fidx, fvals, fout)
    if not torch.equal(fout, fvals[fidx.long()]):
        raise AssertionError("chain_floor_launch: wrong values")
    for key, fn in (("load_floor", lambda: TS.load_floor_launch(fsrc, fout)),
                    ("chain_floor",
                     lambda: TS.chain_floor_launch(fidx, fvals, fout))):
        f = _median_ms(fn)
        out[key] = {"ms": f["graph_ms"], "call_ms": f["call_ms"]}
    chain = out["chain_floor"]["ms"]
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
                     "bytes": nbytes, "ops": ops,
                     "above_floor_us": (k["graph_ms"] - floor["graph_ms"])
                     * 1e3,
                     "above_chain_us": (k["graph_ms"] - chain) * 1e3}
    return out


def time_lease_designs(dev) -> dict:
    """K1 (the registry's acquire), K2 as the release and K2 as the
    single-lock acquire (``publish_hashed``) at each (batch, lanes) of
    ``LEASE_SHAPES`` on the 4096-slot table, on the wrappers' build and the
    parent K1/K2 design in turns (:func:`_in_turns`), each reading timed as
    :func:`time_kernels` times (graph replay of 100 calls, median of 11
    windows).  As in :func:`time_kernels`, every
    slot these acquires ask for is taken after the first acquire, so they
    read and lose.  ``acquire_release`` times the tick's pair instead, per
    pair: a K1 acquire into slots the pair's release freed (so each request
    first for a free slot wins and stores), then the K2 release of what it
    was granted.  -> {shape: {entry: {build: {ms (mean of the readings),
    spread_ms (largest less smallest), readings_ms}}}}."""
    import numpy as np
    import torch

    from repro_torch.kernels import table_publish as TP

    libs = {"parent": TP.parent_lib(), "kernel": TP.table_lib()}
    one = torch.ones((), dtype=torch.int32, device=dev)
    out = {}
    for batch, n_locks in LEASE_SHAPES:
        c = _case(np.random.default_rng(0), batch, dev)
        table = c["table"]
        lidx = c["lidx"] % n_locks
        rbias = torch.ones(n_locks, dtype=torch.int32, device=dev)
        vals = c["vals"][:n_locks].contiguous()
        rids = c["rids"]
        before = table.clone()
        free = table.clone()
        g = TP.acquire_hashed(table, rbias, vals, lidx, rids)
        gp = torch.empty_like(g)

        def pair(lib):
            TP._launch_acquire_hashed(lib, free, rbias, vals, lidx, 1, rids,
                                      gp)
            TP._launch_release_hashed(lib, free, vals, lidx, 1, rids, gp)

        entries = {
            "acquire_hashed": lambda lib: TP._launch_acquire_hashed(
                lib, table, rbias, vals, lidx, 1, rids, g),
            "release_hashed": lambda lib: TP._launch_release_hashed(
                lib, table, vals, lidx, 1, rids, g),
            "publish_hashed": lambda lib: TP._launch_publish_hashed(
                lib, table, one, vals, lidx, 1, rids, g),
            "acquire_release": pair}
        rec = {entry: _in_turns(libs, launch)
               for entry, launch in entries.items()}
        if not torch.equal(free, before):
            raise AssertionError("acquire_release: the pair left the table "
                                 "changed")
        out[f"{batch}x{n_locks}"] = rec
    return out


def _in_turns(libs, launch) -> dict:
    """``launch(lib)`` on each build of ``libs`` (parent first), once, then
    timed in turns (parent, kernel, kernel, parent, twice), each reading
    the graph-replay time of :func:`_median_ms`.  The ``parent`` build
    may refuse a launch (its K10 past 56,064 slots, its K4 past 128 lock
    values): it is then recorded as refused.  Any other build's error
    propagates.  ``libs`` may map names to
    anything ``launch`` takes, e.g. to callables with ``launch`` calling
    them.  -> {build: {ms (mean of the readings), spread_ms (largest
    less smallest), readings_ms} or {refused: message}}."""
    import torch

    rec, readings = {}, {}
    for build, lib in libs.items():
        try:
            launch(lib)
            torch.cuda.synchronize()
        except RuntimeError as e:
            if build != "parent":
                raise
            rec[build] = {"refused": str(e)}
    names = [b for b in libs if b not in rec]
    for build in (names + names[::-1]) * 2:
        readings.setdefault(build, []).append(
            _median_ms(lambda: launch(libs[build]))["graph_ms"])
    rec.update({b: {"ms": sum(r) / len(r), "spread_ms": max(r) - min(r),
                    "readings_ms": r} for b, r in readings.items()})
    return rec


def time_poll_publish_designs(dev) -> dict:
    """K3 and K10 on the wrappers' build and the parent designs in turns
    (:func:`_in_turns`), each reading timed as :func:`time_kernels` times
    (graph replay of 100 calls, median of 11 windows).  K3 on tables of
    each of ``POLL_ROWS`` (a lock held in ~2% of the slots); K10 in both
    modes (``publish``, conditional, and ``clear``, unconditional, the
    legacy pair's two launches) at each (batch, rows) of ``SEQ_SHAPES``,
    into one preallocated output.  Before timing, each build's result on
    the timed inputs is held exactly against the plain version.
    -> {"poll": {slots: rec}, "publish": {"MxSLOTS": {mode: rec}}}."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref as R
    from repro_torch.kernels import table_publish as TP
    from repro_torch.kernels import table_scan as TS

    libs = {"parent": TP.parent_lib(), "kernel": TP.table_lib()}
    rng = np.random.default_rng(0)
    out = {"poll": {}, "publish": {}}
    for rows in POLL_ROWS:
        flat = rng.integers(1, 50, rows * 128).astype(np.int32)
        table = torch.from_numpy(flat.reshape(rows, 128)).to(dev)
        count = torch.empty((), dtype=torch.int32, device=dev)
        for build, lib in libs.items():
            TS._launch_poll(lib, table, 7, count)
            if not torch.equal(count, R.poll_ref(table, 7)):
                raise AssertionError(f"revocation_poll on the {build} build "
                                     f"differs from its plain version")
        out["poll"][str(rows * 128)] = _in_turns(
            libs, lambda lib: TS._launch_poll(lib, table, 7, count))
    for m, rows in SEQ_SHAPES:
        table, slots, ids = (torch.from_numpy(x).to(dev)
                             for x in _seq_placed_case(rng, m, rows))
        new = torch.empty_like(table)
        granted = torch.empty(m, dtype=torch.bool, device=dev)
        rec = {}
        for mode, unc in (("publish", False), ("clear", True)):
            args = (table, slots, torch.zeros_like(ids) if unc else ids)
            want = R.publish_seq_ref(*(x.cpu() for x in args),
                                     unconditional=unc)

            def launch(lib, args=args, unc=unc):
                TP._launch_publish_seq(lib, args[0], new, *args[1:], granted,
                                       unconditional=unc)

            rec[mode] = _in_turns(libs, launch)
            for build in rec[mode]:
                if "refused" in rec[mode][build]:
                    continue
                launch(libs[build])
                if not (torch.equal(new.cpu(), want[0])
                        and torch.equal(granted.cpu(), want[1])):
                    raise AssertionError(f"publish on the {build} build "
                                         f"differs from its plain version "
                                         f"({m} x {rows * 128})")
        out["publish"][f"{m}x{rows * 128}"] = rec
    return out


def _scan_case(rng, rows, k):
    """A table of ``rows`` x 128 slots as a registry's holds it (~7% of
    the slots hold one of 128 lock values) and K lock values to poll:
    values held there, values in no slot, 0 (the free slots) and, past 128,
    duplicates.  -> (table, locks) int32 numpy arrays."""
    import numpy as np

    n = rows * 128
    vals = rng.integers(1, 2**31 - 1, 128).astype(np.int32)
    table = np.zeros(n, np.int32)
    held = rng.choice(n, n // 14, replace=False)
    table[held] = rng.choice(vals, held.size)
    pool = np.concatenate([vals, rng.integers(-2**31, 0, 128)])
    locks = rng.choice(pool, k).astype(np.int32)
    locks[0] = 0
    return table.reshape(rows, 128), locks


def time_scan_designs(dev) -> dict:
    """K4 and K9 on the wrappers' build (``kernel``) and the parent designs
    (``parent``) in turns (:func:`_in_turns`), each reading timed as
    :func:`time_kernels` times (graph replay of 100 calls, median of 11
    windows), with K3 on the same table (``poll``, the yardstick) in the
    same turns.  K4 at each (slots, K) of ``MULTI_SHAPES`` on
    :func:`_scan_case`'s tables; the parent refuses K > 128.  K9 on
    tables of each of ``SCAN_ROWS`` (a lock held in ~2% of the slots).
    Before timing, each build's result on the timed inputs is held exactly
    against the plain version.  -> {"multi_poll": {"SLOTSxK": rec},
    "scan": {slots: rec}}."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref as R
    from repro_torch.kernels import table_publish as TP
    from repro_torch.kernels import table_scan as TS

    parent, lib = TP.parent_lib(), TP.table_lib()
    rng = np.random.default_rng(0)
    out = {"multi_poll": {}, "scan": {}}

    def exact(name, build, run, check):
        try:
            run()
        except RuntimeError:   # the parent's refusal: _in_turns records it
            if build != "parent":
                raise
            return
        if not check():
            raise AssertionError(f"{name} differs from its plain version")

    for slots, k in MULTI_SHAPES:
        table, locks = (torch.from_numpy(x).to(dev)
                        for x in _scan_case(rng, slots // 128, k))
        counts = torch.empty(k, dtype=torch.int32, device=dev)
        count = torch.empty((), dtype=torch.int32, device=dev)
        want = R.multi_count_ref(table, locks)
        runs = {b: (lambda lb=lb: TS._launch_multi_poll(lb, table, locks,
                                                        counts))
                for b, lb in (("parent", parent), ("kernel", lib))}
        for name, run in runs.items():
            counts.fill_(-1)
            exact(f"revocation_poll_multi ({name}, {slots} x {k})", name,
                  run, lambda: torch.equal(counts, want))
        lock0 = int(locks[0])
        runs["poll"] = lambda: TS._launch_poll(lib, table, lock0, count)
        out["multi_poll"][f"{slots}x{k}"] = _in_turns(runs, lambda r: r())
    for rows in SCAN_ROWS:
        flat = rng.integers(1, 50, rows * 128).astype(np.int32)
        table = torch.from_numpy(flat.reshape(rows, 128)).to(dev)
        mask = torch.empty(table.shape, dtype=torch.int8, device=dev)
        count = torch.empty((), dtype=torch.int32, device=dev)
        want_m, want_c = R.scan_ref(table, 7)
        runs = {b: (lambda lb=lb: TS._launch_scan(lb, table, 7, mask, count))
                for b, lb in (("parent", parent), ("kernel", lib))}
        for name, run in runs.items():
            mask.fill_(-1)
            exact(f"revocation_scan ({name}, {rows * 128})", name, run,
                  lambda: torch.equal(mask, want_m)
                  and torch.equal(count, want_c))
        runs["poll"] = lambda: TS._launch_poll(lib, table, 7, count)
        out["scan"][str(rows * 128)] = _in_turns(runs, lambda r: r())
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
    whose K/V exceed the 50 MB L2), under the record's ``long_context``;
    K6/K8 also at the two long-prefix shapes (``LONG_PREFIX``: 2 rows of
    32 or 256 columns at the end of 3584-4096 positions), under
    ``long_prefix`` and ``long_prefix_wide``.

    Each record also holds, timed in the same windows' way and in turns
    with the kernel (parent, kernel, kernel, parent), ``parent_ms``: the
    parent chunk design (``paged_attn.parent_lib()``, the build whose
    chunk entry points run the chunk kernel that predates the KV split
    and the tensor cores: one CTA per request, block of columns and KV
    head walking all its positions, one element a thread staged as
    float32, SIMT arithmetic), called at S = 1 for K5/K7; and
    ``one_split_ms``: the kernel forced to one split (the ablation of the
    KV split); ``splits`` is the split count the wrapper picked.

    The bound counts what one call must move, in 32-byte sectors at the
    HBM rate: each valid K and V row once per KV head (hd bf16 = 4
    sectors, hd int8 = 2), for int8 pages the sectors of the (page, KV
    head) scales those rows need, q and out, the page indices and lengths;
    and the operations (4 * hd per query head and KV position it attends
    to) at the bf16 tensor-core rate, 989 TFLOP/s (``bound_ms``), and at
    the float32 rate outside the tensor cores, 67 TFLOP/s
    (``bound_simt_ms``).  ``library_ms`` is ``scaled_dot_product_attention``
    over the same K/V already gathered dense (and dequantized; neither
    step timed), with a boolean mask and GQA: a yardstick only, the port
    never calls it."""
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
    for key, cols in LONG_PREFIX_COLUMNS.items():
        case = _long_prefix_case(rng, dev, base["kv_dtype"], cols)
        out[names[1]][key] = _time_paged_case(dev, case, quant, plain_n=10)
    return out


def _time_paged_case(dev, case, quant, plain_n=100, designs=True) -> dict:
    """One K5-K8 timing record (see :func:`time_paged_kernels`); the plain
    version and the library call run ``plain_n`` calls a window.  Without
    ``designs``: the kernel alone, without the parent design and the
    one-split ablation beside it."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attn as PA
    from repro_torch.kernels import paged_chunk_attn as PCA
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
    if s == 1:
        args = (q[:, 0].contiguous(), kp, vp, *scales, pi, cl)
        fn = PA.paged_attention_quant if quant else PA.paged_attention
        kern = functools.partial(fn, *args)
        plain = functools.partial(
            R.paged_attn_quant_ref if quant else R.paged_attn_ref, *args)
        one = functools.partial(PA._decode, args[0], kp, vp, scales, pi, cl,
                                n_split=1)
        splits, pps = PA.decode_plan(args[0], kp, pi.shape[1])
    else:
        args = (q, kp, vp, *scales, pi, cl, nl)
        fn = (PCA.paged_chunk_attention_quant if quant
              else PCA.paged_chunk_attention)
        kern = functools.partial(fn, *args)
        plain = functools.partial(
            R.paged_chunk_attn_quant_ref if quant
            else R.paged_chunk_attn_ref, *args)
        one = functools.partial(PCA._chunk, q, kp, vp, scales, pi, cl, nl,
                                n_split=1)
        pairs, splits, pps = PCA.chunk_plan(q, kp, pi.shape[1])
    extra = {"splits": splits, "split_pages": pps}
    if designs:
        parent = functools.partial(PCA._chunk, q, kp, vp, scales, pi, cl,
                                   nl, n_split=1, lib=PA.parent_lib())
        # parent and kernel in turns: parent, kernel, kernel, parent
        p0, k0 = _median_ms(parent), _median_ms(kern)
        k1, p1 = _median_ms(kern), _median_ms(parent)
        reads = [k0, k1]
        extra.update(parent_ms=(p0["graph_ms"] + p1["graph_ms"]) / 2,
                     parent_readings_ms=[p0["graph_ms"], p1["graph_ms"]],
                     one_split_ms=_median_ms(one)["graph_ms"])
    else:
        reads = [_median_ms(kern)]
    k = {key: statistics.mean(r[key] for r in reads)
         for key in ("graph_ms", "call_ms")}
    extra["readings_ms"] = [r["graph_ms"] for r in reads]
    if s > 1:
        resident, smem = PCA.chunk_residency(q, kp, pairs)
        extra.update(pairs_per_cta=pairs, resident_ctas=resident,
                     smem_bytes=smem)
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
    t_ops = flops / TENSOR_OPS_PER_S * 1e3
    t_simt = flops / INT_OPS_PER_S * 1e3
    p, lb = _median_ms(plain, n=plain_n), _median_ms(lib, n=plain_n)
    bound = max(t_bytes, t_ops)
    return {"ms": k["graph_ms"], "plain_ms": p["graph_ms"],
            "library_ms": lb["graph_ms"], "call_ms": k["call_ms"],
            "plain_call_ms": p["call_ms"], "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_share": bound / k["graph_ms"],
            "bound_simt_ms": max(t_bytes, t_simt),
            "bound_simt_by": "bytes" if t_bytes >= t_simt else "operations",
            **extra, "bytes": sectors * SECTOR, "ops": flops,
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
            ("device_bravo", lambda: DBB.run(dev, batch=64, iters=100,
                                            collective=False),
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
        eng._decode_tick()                   # the step's eager warm-up
        eng._decode_tick()                   # its capture and a replay
        nxt = gated(eng._decode_tick)        # a replay
        toks = nxt[:, 0].cpu().numpy()       # read after the gate closes
        dstats = eng._decode_paged.stats
        if (dstats.warmups, dstats.captures, dstats.replays) != (1, 1, 2):
            raise AssertionError(f"gate: the gated tick was no replay "
                                 f"({dstats})")
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
        return {"tick_rows": len(rows), "gated_tick": "replay",
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
               slots, max_seq, swap_s, compact_s, seed, perturb=None,
               varied=1.0, eager=False) -> dict:
    """The handler-mode engine serving ``n_req`` seeded requests under
    hot-swap (``perturb``: the updater's new tree, the engine's default
    when None) and compaction: the table drains, every page is free, K1-K4
    each launched, and at least the share ``varied`` of the greedy outputs
    (all, by default) is not one token repeated.  ``eager=True`` serves
    through the bare steps (``smoke.eager_steps``), the eager arm of a
    comparison; else every handler call must be a warm-up or a replay of
    its graph (``_handler_graphs``)."""
    import numpy as np

    from repro_torch.benchmarks import smoke as SM
    from repro_torch.kernels import ops as K
    from repro_torch.serving.engine import Request, ServingEngine

    eng = ServingEngine(cfg, params, lock_name="bravo-ba",
                        handlers=handlers, slots_per_handler=slots,
                        max_seq=max_seq, device=dev)
    if eager:
        SM.eager_steps(eng)
    reqs = [Request(rid=i, prompt=p, max_new=max_new) for i, p in
            enumerate(_prompts(seed, n_req, prompt_len, cfg.vocab))]
    K.reset_launch_counts()
    t0 = time.monotonic()
    for r in reqs:
        eng.submit(r)
    eng.start(swap_period_s=swap_s, compact_period_s=compact_s,
              perturb=perturb)
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
    repeated = _check_varied([r.out.tolist() for r in reqs], varied)
    assert st["engine"]["weight_swaps"] >= 1, st["engine"]
    assert st["device_leases"]["revocations"] >= 1, st["device_leases"]
    assert free == eng.kv_pool.n_pages, free
    assert not held.any(), held.tolist()
    # the plain versions (CPU tensors) count no launch; this path runs the
    # table kernels only (no paged attention in handler mode)
    assert dev.type != "cuda" or all(counts[k] for k in TABLE_KERNELS), \
        counts
    graphs = None if eager else _handler_graphs(st, dev)

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
            "launches": counts, "repeated_outputs": repeated,
            "graphs": graphs, "outputs": [r.out.tolist() for r in reqs]}


def _engine_arm(run) -> dict:
    """The readings of ``run_engine``'s eager arm kept beside the graphed
    run (the graphed run first, then the eager one, on the same requests
    and swap period)."""
    return {k: run[k] for k in ("wall_s", "tokens_per_s", "decode_steps",
                                "weight_swaps", "revocations")}


def _handler_graphs(st, dev) -> dict:
    """A handler-mode run's step graphs (``lock_stats()``): each handler
    thread's warm-ups, captures and replays at each batch size, and the
    share of the decode steps that replayed.  On the card every prefill
    and decode call must be a warm-up or a replay (gate): nothing ran
    eagerly beside the graphs."""
    steps = st["handler_steps"]
    out = {"steps": steps}
    for kind, total in (("decode", st["engine"]["decode_steps"]),
                        ("prefill", st["engine"]["prefills"])):
        recs = [s[kind] for s in steps.values() if kind in s]
        n = {k: sum(r[k] for r in recs) for k in ("warmups", "captures",
                                                  "replays")}
        out[kind] = {**n, "calls": total,
                     "share_replayed": n["replays"] / total if total
                     else None,
                     "capture_ms_max": max((m for r in recs
                                            for m in r["capture_ms"]),
                                           default=None)}
        if dev.type == "cuda" and n["warmups"] + n["replays"] != total:
            raise AssertionError(f"handler {kind} calls outside the graphs: "
                                 f"{out}")
    return out


def _check_varied(outputs, least: float = 1.0) -> int:
    """Greedy outputs that repeat one token do not depend on the cache or
    on attention, so a check on them could not fail: refuse them unless at
    least the share ``least`` of the outputs vary.  -> how many repeat."""
    same = [o for o in outputs if len(set(o)) < 2]
    if len(outputs) - len(same) < least * len(outputs):
        raise AssertionError(f"greedy outputs repeat one token: {same}")
    return len(same)


def decode_step_ms(cfg, params, dev, batch, max_seq) -> dict:
    """The handler engine's decode step at ``batch`` rows, as the engine
    runs it (``ServingEngine._handler_steps``: the in-place step over a
    handler's cache tree, a CUDA graph on the card) and as its eager arm
    (``smoke.eager_steps``: the same step and tree, no graph), in turns:
    after each arm's first two calls (the graph's warm-up and capture),
    ``HANDLER_WINDOWS`` windows of ``HANDLER_WINDOW_STEPS`` synchronized
    steps, the arms in the order eager, graph, graph, eager, ...; then
    each arm's profile (``_profile``, 4 steps).  Each arm feeds its own
    tokens back from the same seeded first tokens, and the two token
    sequences must be equal step for step (gate); on the card the graph
    must have been warmed once, captured once and replayed at every other
    call (gate)."""
    import dataclasses

    from repro_torch.benchmarks import smoke as SM
    from repro_torch.serving.engine import ServingEngine

    eng = ServingEngine(cfg, params, handlers=1, slots_per_handler=batch,
                        max_seq=max_seq, device=dev)
    graph = eng._handler_steps(0, batch)
    # the windows' order starts with the first arm: eager, graph, graph, ...
    arms = {"eager": SM.eager_steps(eng)._handler_steps(1, batch),
            "graph": graph}
    out, one, tokens = _decode_in_turns(arms, params, dev, batch, cfg.vocab)
    for arm in ("graph", "eager"):
        out[arm]["profile"] = _profile(functools.partial(one, arm))
    toks = tokens()
    out["tokens_equal"] = toks["graph"] == toks["eager"]
    out["graph_steps"] = dataclasses.asdict(arms["graph"].decode.stats)
    eng.stop()
    calls = len(toks["graph"][0])
    g = out["graph_steps"]
    if not out["tokens_equal"] or (dev.type == "cuda" and (
            g["warmups"], g["captures"], g["replays"]) != (1, 1, calls - 1)):
        raise AssertionError(f"handler decode step, graph against eager: "
                             f"{out} {toks}")
    return out


def _decode_in_turns(arms, params, dev, batch, vocab) -> tuple:
    """Handler decode steps (``HandlerSteps``, by arm name) timed in turns:
    after each arm's first two calls (a graph's warm-up and capture),
    ``HANDLER_WINDOWS`` windows of ``HANDLER_WINDOW_STEPS`` synchronized
    steps, the arms in the order first, second, second, first, ...  Each
    arm feeds its own tokens back from the same seeded first tokens.  ->
    (the record, the one-step function of an arm name, each arm's tokens
    as (batch, calls) lists so far, a function)."""
    import numpy as np
    import torch

    names = list(arms)
    rng = np.random.default_rng(0)
    first = torch.from_numpy(rng.integers(1, vocab, (batch, 1)).astype(
        np.int32)).to(dev)
    state = {a: {"cur": first, "pos": 0, "tokens": []} for a in arms}

    def one(arm):
        st, hs = state[arm], arms[arm]
        st["pos"] += 1
        clen = torch.full((batch,), st["pos"], dtype=torch.int32,
                          device=dev)
        st["cur"], _, _ = hs.decode(params, hs.caches, st["cur"], clen)
        st["tokens"].append(st["cur"])

    for arm in names:
        for _ in range(2):
            one(arm)
    order = [names[(w + 1) // 2 % 2] for w in range(HANDLER_WINDOWS)]
    times = {a: [] for a in arms}
    for arm in order:
        for _ in range(HANDLER_WINDOW_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one(arm)
            torch.cuda.synchronize()
            times[arm].append((time.perf_counter() - t0) * 1e3)
    out = {"batch": batch, "windows": HANDLER_WINDOWS,
           "steps_a_window": HANDLER_WINDOW_STEPS, "order": order}
    for arm in names:
        out[arm] = {"median_ms": statistics.median(times[arm]),
                    "min_ms": min(times[arm]), "max_ms": max(times[arm]),
                    "steps": len(times[arm])}
    def tokens():
        return {a: torch.cat(state[a]["tokens"], 1).cpu().tolist()
                for a in arms}
    return out, one, tokens


def _profile(fn, steps=4, cpu=True) -> dict:
    """torch.profiler over ``steps`` calls of ``fn``: device time per call
    (the sum of kernel times), wall time per call (profiler on), the
    device's busy share and the kernels that take the most device time.
    Device numbers are None where the profiler recorded no device time.
    ``cpu=False`` traces the device alone (a train step launches ~10**5
    kernels, whose host-side events take minutes to fold)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
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


def token_check(cfg, params, dev, *, n_req, prompt_len, max_new, max_seq,
                seed, varied=1.0) -> dict:
    from repro_torch.benchmarks import smoke as SM
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
        want = SM.dense_reference(cfg, params, p, max_new, dev,
                                  max_seq=max_seq)
        if r.out.tolist() != want:
            raise AssertionError(f"request {r.rid}: engine {r.out.tolist()} "
                                 f"!= dense greedy loop {want}")
    repeated = _check_varied([r.out.tolist() for r in reqs], varied)
    return {"requests": n_req, "equal": True, "repeated_outputs": repeated,
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
                  quant_kv=False, n_pages=SCHED_PAGES, swap_s=0.25,
                  perturb=None, varied=1.0) -> dict:
    """Two waves of six requests through ``ServingEngine(scheduler=...)``
    under hot-swap (every ``swap_s`` s, none at 0; ``perturb``: the
    updater's new tree, the engine's default when None) and compaction
    (every 0.2 s).  Wave 2 is
    submitted once wave 1 has finished, since a prefix enters the index
    only when its request has finished prefill.  ``quant_kv``: the same on
    the quantized store, whose attention must run in K7/K8 alone.
    ``n_pages`` below ``SCHED_PAGES``: the eviction run, on a store so
    small that decode growth evicts running requests (their re-prefill
    then runs K6 on longer prefixes); it must evict at least once, and the
    prefix cache need not save a page there.  Records the graphed steps'
    warm-ups, captures and replays, and ``memory_allocated`` before the
    run, at its peak and after ``stop()``, in parameter trees, gated by
    ``SWAP_TREES_PEAK`` and ``SWAP_TREES_AFTER``.  The tick timers are
    taken off the engine after ``stop()``: stored on it they close over
    its bound methods, a reference cycle that kept each run's engine, its
    store and its last parameter tree allocated until the garbage
    collector ran."""
    import torch

    from repro_torch.kernels import ops as K
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    eng = ServingEngine(cfg, params, n_pages=n_pages, device=dev,
                        quant_kv=quant_kv,
                        scheduler=SchedulerConfig(**SCHED))
    ticks = {"prefill": [], "decode": []}
    replayed = {"prefill": [], "decode": []}
    for kind, acc in ticks.items():         # host wall time of each tick
        def timed(plan, fn=getattr(eng, f"_run_{kind}"), acc=acc,
                  step=getattr(eng, f"_{kind}_paged"), rep=replayed[kind]):
            before = (step.stats.warmups, step.stats.captures)
            t0 = time.perf_counter()
            fn(plan)
            acc.append((time.perf_counter() - t0) * 1e3)
            if (step.stats.warmups, step.stats.captures) == before:
                rep.append(acc[-1])         # the step replayed its graph
        setattr(eng, f"_run_{kind}", timed)
    wave1, wave2 = _sched_prompts(seed, cfg.vocab)
    waves = [[Request(rid=base + i, prompt=p, max_new=max_new)
              for i, p in enumerate(w)]
             for base, w in ((0, wave1), (len(wave1), wave2))]
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    t0 = time.monotonic()
    eng.start(swap_period_s=swap_s, compact_period_s=0.2, perturb=perturb)
    try:
        for wave in waves:
            for r in wave:
                eng.submit(r)
            for r in wave:
                if not r.done.wait(timeout=600):
                    raise AssertionError(f"request {r.rid} timed out")
        wall = time.monotonic() - t0
    finally:
        eng.stop()
        for kind in ticks:
            del eng.__dict__[f"_run_{kind}"]
    counts = K.launch_counts()               # read right after the path
    torch.cuda.synchronize()
    tree = sum(x.numel() * x.element_size() for x in _leaves(params))
    memory = {"allocated_before": mem0,
              "allocated_after": torch.cuda.memory_allocated(),
              "peak": torch.cuda.max_memory_allocated(),
              "param_tree_bytes": tree}
    memory["growth_trees"] = (memory["allocated_after"] - mem0) / tree
    memory["peak_growth_trees"] = (memory["peak"] - mem0) / tree
    steps = _step_stats(eng)
    # ticks past the histogram's warm-up that ran eagerly after a swap or
    # captured anew
    for kind in ("warmup", "capture"):
        steps["decode"][f"{kind}_ticks_in_step_ns"] = sum(
            c > eng.ecfg.obs_warmup_steps
            for c in steps["decode"][f"{kind}_at"])
    reqs = waves[0] + waves[1]
    st = eng.lock_stats()
    pool = st["kv_pool"]
    locks = [eng.store.leases] + eng.kv_pool.locks
    held = eng.registry.held_multi(locks)
    free = eng.kv_pool.free_count()
    for r in reqs:
        assert r.out is not None and len(r.out) == max_new, r.rid
        assert ((r.out >= 0) & (r.out < cfg.vocab)).all(), r.out
    repeated = _check_varied([r.out.tolist() for r in reqs], varied)
    es = st["engine"]
    assert free == n_pages, free
    assert pool["refcount_total"] == 0 and pool["shared_pages"] == 0, pool
    assert not held.any(), held.tolist()
    if n_pages == SCHED_PAGES:
        assert es["pages_saved"] >= 1 and es["cow_copies"] >= 1, es
    else:
        assert st["scheduler"]["evictions"] >= 1, st["scheduler"]
    # each copy-on-write ran once through the store's one graph: a warm-up,
    # a capture at the second copy, replays after
    cp, cows = steps["copy_page"], es["cow_copies"]
    assert dev.type != "cuda" or (
        cp["warmups"], cp["captures"], cp["warmups"] + cp["replays"]) == (
        min(cows, 1), int(cows >= 2), cows), (cp, cows)
    assert es["weight_swaps"] >= 1 or not swap_s, es
    assert memory["growth_trees"] <= SWAP_TREES_AFTER, (memory, es)
    assert memory["peak_growth_trees"] <= SWAP_TREES_PEAK, (memory, es)
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
    return {"config": SCHED, "n_pages": n_pages, "quant_kv": quant_kv,
            "swap_s": swap_s,
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
            # the ticks whose step replayed its graph (no warm-up, no
            # capture): after each swap a step runs eagerly and captures
            **{f"{k}_replay_ticks": len(v) for k, v in replayed.items()},
            **{f"{k}_replay_tick_median_ms": statistics.median(v) if v
               else None for k, v in replayed.items()},
            "ttft_median_ms": ttft.quantile(0.5) / 1e6,
            "weight_swaps": es["weight_swaps"],
            "compactions": es["compactions"],
            "pages_saved": es["pages_saved"], "cow_copies": es["cow_copies"],
            "cached_tokens": es["cached_tokens"],
            "prefix_hits": pool["prefix_hits"],
            "scheduler": st["scheduler"], "pages_free": free,
            "held_after": held.tolist(), "launches": counts,
            "repeated_outputs": repeated, "steps": steps, "memory": memory,
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
    prompts, both without swaps (with swaps, which ticks see which
    weights depends on timing, and the share with it): the int8 K/V
    leaves hold exactly half the bf16 leaves' bytes (read from each run's
    ``pool.hbm_bytes`` gauge, less the scales), and at least
    ``QUANT_VS_BF16_SHARE`` of the generated tokens are equal."""
    if sched["weight_swaps"] or qsched["weight_swaps"]:
        raise AssertionError("quant_vs_bf16 compares runs without swaps")
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


def eviction_summary(esched, sched) -> dict:
    """The eviction run (``run_scheduler`` at ``EVICT_PAGES``, which has
    already checked that it evicted, that every request finished with its
    tokens, and that every page is free and no lease held after
    ``stop()``) beside the roomy bf16 run on the same prompts: its
    evictions, K6 launches and the share of its tokens equal to the roomy
    run's (recorded, not gated: a requeued request re-prefills its prompt
    and generated tokens in other chunks, so bf16 rounding differs)."""
    if esched["prompts"] != sched["prompts"]:
        raise AssertionError("the eviction run served other prompts")
    same = [[a == b for a, b in zip(e, f)]
            for e, f in zip(esched["outputs"], sched["outputs"])]
    keys = ("n_pages", "requests", "tokens", "wall_s", "tokens_per_s",
            "decode_ticks", "prefill_ticks", "weight_swaps", "scheduler",
            "pages_free", "held_after", "launches")
    return {**{k: esched[k] for k in keys},
            "evictions": esched["scheduler"]["evictions"],
            "k6_launches": esched["launches"]["paged_chunk_attention"],
            "equal_token_share_vs_roomy": sum(map(sum, same))
            / sum(map(len, same)),
            "first_difference": [s.index(False) if not all(s) else None
                                 for s in same]}


def scheduler_vs_greedy(cfg, params, dev, still, sched) -> dict:
    """The scheduler engine's bf16 tokens against the dense greedy loop
    (``benchmarks.smoke.dense_reference``) on the same prompts.  The run
    without swaps (``still``), whose weights are the loop's: the share of
    positions whose token is equal, at least ``SCHED_VS_GREEDY_SHARE``.
    The run under swaps (``sched``), whose ticks see the updater's trees at
    times the clock decides: every token, teacher-forced, within
    ``BF16_VS_F32_REL`` of the largest logit of the loop's best (R12); its
    share is recorded."""
    from repro_torch.benchmarks import smoke as SM

    if still["weight_swaps"]:
        raise AssertionError("scheduler_vs_greedy's share reads a run "
                             "without swaps")
    if still["prompts"] != sched["prompts"]:
        raise AssertionError("the two scheduler runs served other prompts")
    want = {}

    def reading(run):
        same = []
        for prompt, got in zip(run["prompts"], run["outputs"]):
            key = tuple(prompt)
            if key not in want:
                want[key] = SM.dense_reference(cfg, params, prompt, len(got),
                                               dev, max_seq=SCHED["max_seq"])
            same.append([a == b for a, b in zip(got, want[key])])
        return {"equal_share": sum(map(sum, same)) / sum(map(len, same)),
                "first_difference": [s.index(False) if not all(s) else None
                                     for s in same]}

    out = {"requests": len(still["outputs"]), **reading(still),
           "tolerance": SCHED_VS_GREEDY_SHARE,
           "under_swaps": {"weight_swaps": sched["weight_swaps"],
                           **reading(sched),
                           "teacher_forced": SM.hold_tokens(
                               cfg, params, dev, sched["prompts"],
                               sched["outputs"], len(sched["outputs"][0]),
                               near_tie_rel=BF16_VS_F32_REL,
                               max_seq=SCHED["max_seq"])}}
    if out["equal_share"] < SCHED_VS_GREEDY_SHARE:
        raise AssertionError(f"scheduler vs greedy loop: {out}")
    if not out["under_swaps"]["teacher_forced"]["ok"]:
        raise AssertionError(f"scheduler under swaps vs greedy loop: {out}")
    return out


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phase 7: the serving step as one program (graph_step)
# ---------------------------------------------------------------------------


def _graph_engine(cfg, params, dev, *, eager=False, quant_kv=False,
                  n_pages=SCHED_PAGES):
    """A scheduler-mode engine at ``SCHED``: its steps graphed (the
    engine's path) or, with ``eager``, the bare steps in their place."""
    from repro_torch.benchmarks import smoke as SM
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    eng = ServingEngine(cfg, params, n_pages=n_pages, device=dev,
                        quant_kv=quant_kv, scheduler=SchedulerConfig(**SCHED))
    return SM.eager_steps(eng) if eager else eng


def _drive(eng, reqs, until=None, max_ticks=5000) -> int:
    """Submit ``reqs`` and run ``_schedule_tick`` on this thread until each
    is done (or, with ``until``, until ``until(eng)`` holds after a tick).
    -> the ticks run."""
    for r in reqs:
        eng.submit(r)
    for n in range(1, max_ticks + 1):
        if not eng._schedule_tick():
            raise AssertionError("the scheduler idled with work left")
        if until(eng) if until else all(r.done.is_set() for r in reqs):
            return n
    raise AssertionError(f"not done after {max_ticks} ticks")


def _all_decoding(eng) -> bool:
    sched = eng.scheduler
    return not sched.waiting and all(s.phase.name == "DECODE"
                                     for s in sched.running.values())


def _requests(prompts, max_new, base=0):
    from repro_torch.serving.engine import Request

    return [Request(rid=base + i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]


def _step_stats(eng) -> dict:
    """The scheduler engine's graphed steps' counts: the paged decode and
    prefill and the copy-on-write page copy."""
    import dataclasses

    out = {name: dataclasses.asdict(getattr(eng, f"_{name}_paged").stats)
           for name in ("decode", "prefill")}
    out["copy_page"] = dataclasses.asdict(eng._copy_page_step.stats)
    return out


def _graph_tokens(cfg, params, dev, *, quant_kv, seed) -> dict:
    """The scheduler phase's two waves through an eager and a graphed
    engine on this thread, no swap, no compaction, one arm after the other
    with the launch counts read alone: every token equal and K5-K8's
    launches equal."""
    from repro_torch.kernels import ops as K

    wave1, wave2 = _sched_prompts(seed, cfg.vocab)
    arms = {}
    for arm in ("eager", "graph"):
        eng = _graph_engine(cfg, params, dev, eager=arm == "eager",
                            quant_kv=quant_kv)
        K.reset_launch_counts()
        t0 = time.perf_counter()
        outs, ticks = [], 0
        for base, wave in ((0, wave1), (len(wave1), wave2)):
            reqs = _requests(wave, 16, base)
            ticks += _drive(eng, reqs)
            outs += [r.out.tolist() for r in reqs]
        arms[arm] = {"wall_s": time.perf_counter() - t0, "ticks": ticks,
                     "launches": K.launch_counts(), "outputs": outs}
        if arm == "graph":
            arms[arm]["steps"] = _step_stats(eng)
        del eng
    e, g = arms["eager"], arms["graph"]
    attn = PAGED_KERNELS + QUANT_KERNELS
    out = {"tokens_equal": e["outputs"] == g["outputs"],
           "attn_launches_equal": all(e["launches"][k] == g["launches"][k]
                                      for k in attn),
           "eager": {k: v for k, v in e.items() if k != "outputs"},
           "graph": {k: v for k, v in g.items() if k != "outputs"},
           "outputs": g["outputs"]}
    if not out["tokens_equal"] or not out["attn_launches_equal"]:
        raise AssertionError(f"graph_step tokens: {out} eager outputs "
                             f"{e['outputs']}")
    if not g["steps"]["decode"]["replays"] \
            or not g["steps"]["prefill"]["replays"]:
        raise AssertionError(f"graph_step: no replay {g['steps']}")
    return out


def _graph_logits(cfg, params, dev, *, quant_kv, seed) -> dict:
    """At float32 compute: the first wave's first four requests through an
    eager and a graphed engine in lockstep, every decode tick's logits
    recorded; each replayed tick's logits within ``GRAPH_LOGITS_REL`` of
    its largest logit, the tokens equal."""
    import dataclasses

    import torch

    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    prompts = _sched_prompts(seed, cfg.vocab)[0][:4]
    logs, reqs, engines = {}, {}, {}
    for arm in ("eager", "graph"):
        eng = _graph_engine(cfg32, params, dev, eager=arm == "eager",
                            quant_kv=quant_kv)
        log = logs[arm] = []

        def rec(*a, inner=eng._decode_paged, log=log):
            out = inner(*a)
            log.append(out[1].float())
            return out
        eng._decode_paged = rec
        engines[arm], reqs[arm] = eng, _requests(prompts, 6)
        for r in reqs[arm]:
            eng.submit(r)
    for _ in range(5000):
        if all(r.done.is_set() for r in reqs["graph"]):
            break
        for arm in ("eager", "graph"):
            engines[arm]._schedule_tick()
    if len(logs["eager"]) != len(logs["graph"]):
        raise AssertionError("graph_step logits: the arms ticked apart")
    rels = [float((g - e).abs().max() / e.abs().max())
            for e, g in zip(logs["eager"], logs["graph"])]
    # the graphed engine's first decode tick runs eagerly (its warm-up);
    # the second captures and replays
    out = {"decode_ticks": len(rels), "rel_replayed": max(rels[1:]),
           "rel_first": rels[0], "tolerance": GRAPH_LOGITS_REL,
           "tokens_equal": [r.out.tolist() for r in reqs["eager"]]
           == [r.out.tolist() for r in reqs["graph"]]}
    if len(rels) < 3 or out["rel_replayed"] > GRAPH_LOGITS_REL \
            or not out["tokens_equal"]:
        raise AssertionError(f"graph_step float32 logits: {out}")
    return out


def _graph_swap(cfg, params, params2, dev, *, quant_kv, seed) -> dict:
    """The first wave through an eager and a graphed engine; once every
    request decodes, ``store.swap`` to the second seed's parameters
    between two decode ticks: the tokens equal, and the graphed decode
    step captured exactly once more (the prefill step not again)."""
    prompts = _sched_prompts(seed, cfg.vocab)[0]
    outs, stats = {}, None
    for arm in ("eager", "graph"):
        eng = _graph_engine(cfg, params, dev, eager=arm == "eager",
                            quant_kv=quant_kv)
        reqs = _requests(prompts, 12)
        _drive(eng, reqs, until=lambda e: _all_decoding(e)
               and e.stats.decode_steps >= 3)
        if arm == "graph":
            before = _step_stats(eng)
        eng.store.swap(params2)
        while not all(r.done.is_set() for r in reqs):
            eng._schedule_tick()
        outs[arm] = [r.out.tolist() for r in reqs]
        if arm == "graph":
            stats = _step_stats(eng)
        del eng
    recaptures = stats["decode"]["captures"] - before["decode"]["captures"]
    out = {"tokens_equal": outs["eager"] == outs["graph"],
           "decode_recaptures": recaptures,
           "prefill_recaptures": stats["prefill"]["captures"]
           - before["prefill"]["captures"], "steps": stats}
    if not out["tokens_equal"] or recaptures != 1 \
            or out["prefill_recaptures"]:
        raise AssertionError(f"graph_step swap: {out} {outs}")
    return out


def _graph_swap_memory(cfg, params, dev, swaps=8) -> dict:
    """``swaps`` hot swaps to new parameter trees (``engine._perturb``),
    each followed by two decode ticks (the warm-up, then a capture):
    ``torch.cuda.memory_allocated`` may grow by the one tree the store
    then holds, not by a tree a swap."""
    import torch

    from repro_torch.serving.engine import _perturb

    eng = _graph_engine(cfg, params, dev)
    reqs = _requests(_sched_prompts(1, cfg.vocab)[0][:4], 40)
    _drive(eng, reqs, until=lambda e: _all_decoding(e)
           and e.stats.decode_steps >= 3)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    c0 = eng._decode_paged.stats.captures
    for _ in range(swaps):
        eng.store.swap(_perturb(eng.store.params))
        steps = eng.stats.decode_steps      # a warm-up tick, then a capture
        while eng.stats.decode_steps < steps + 2:
            eng._schedule_tick()
    torch.cuda.synchronize()
    m1 = torch.cuda.memory_allocated()
    tree = sum(x.numel() * x.element_size() for x in _leaves(params))
    out = {"swaps": swaps,
           "captures": eng._decode_paged.stats.captures - c0,
           "allocated_before": m0, "allocated_after": m1,
           "growth_bytes": m1 - m0, "param_tree_bytes": tree,
           "growth_trees": (m1 - m0) / tree}
    if out["captures"] != swaps or m1 - m0 >= 2 * tree:
        raise AssertionError(f"graph_step swap memory: {out}")
    return out


def _tick_ms(eng) -> tuple:
    """One scheduler tick that must run decode: -> (host wall ms, CUDA
    event ms)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    steps = eng.stats.decode_steps
    t0 = time.perf_counter()
    a.record()
    eng._schedule_tick()
    b.record()
    b.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    if eng.stats.decode_steps != steps + 1:
        raise AssertionError("graph_step timing: a tick ran no decode")
    return wall, a.elapsed_time(b)


def _tick_breakdown(eng, n=20) -> dict:
    """What a graphed decode tick's host wall holds: the lease pair (both
    locks, acquire and release) and the step call (key, input copies,
    replay, output copies) enqueued ``n`` times then waited for, the
    replay alone in CUDA events (the graph's device time), and the token
    read.  Repeats the current tick's writes; the engine is discarded
    after."""
    import torch

    rids = eng._rids
    step = eng._decode_paged
    args = (eng.store.params, eng._pages_kv, eng._cur, eng._clen,
            eng._page_tbl)

    def pair():
        ptok, _ = eng.pages.read_batch(rids)
        rtok, _, _ = eng.store.read_batch(rids)
        eng.store.done_read_batch(rtok, rids)
        eng.pages.done_read_batch(ptok)

    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3 / n, (time.perf_counter() - t0) * 1e3 / n

    pair_enq, pair_done = host_ms(pair)
    step_enq, step_done = host_ms(lambda: step(*args))
    graph = step._captured.graph
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(n):
        graph.replay()
    b.record()
    b.synchronize()
    nxt = step(*args)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nxt[:, 0].cpu().numpy()
    read = (time.perf_counter() - t0) * 1e3
    return {"lease_pair_enqueue_ms": pair_enq,
            "lease_pair_done_ms": pair_done,
            "step_call_enqueue_ms": step_enq, "step_call_done_ms": step_done,
            "replay_device_ms": a.elapsed_time(b) / n,
            "token_read_ms": read}


def _graph_tick_turns(cfg, params, dev, *, quant_kv, rows) -> dict:
    """Decode ticks with ``rows`` active rows (prompts of 24 tokens,
    up to 96 new), eager and graphed engines in turns: ``GRAPH_WINDOWS``
    windows of ``GRAPH_TICKS`` ticks an arm, the order flipped every
    window; host wall and CUDA-event ms a tick (median [least-largest] of
    the windows' medians), then each arm's profile (device ms and busy
    share) and the graphed tick's breakdown."""
    from repro_torch.benchmarks import smoke as SM

    prompts = _prompts(11 + rows, rows, 24, cfg.vocab)
    engines = {}
    for arm in ("eager", "graph"):
        eng = engines[arm] = _graph_engine(cfg, params, dev,
                                           eager=arm == "eager",
                                           quant_kv=quant_kv)
        _drive(eng, _requests(prompts, 96), until=lambda e: _all_decoding(e)
               and e.stats.decode_steps >= 3)
    walls = {a: [] for a in engines}
    events = {a: [] for a in engines}
    for w in range(GRAPH_WINDOWS):
        for arm in (("eager", "graph") if w % 2 == 0
                    else ("graph", "eager")):
            ts = [_tick_ms(engines[arm]) for _ in range(GRAPH_TICKS)]
            walls[arm].append(statistics.median(t[0] for t in ts))
            events[arm].append(statistics.median(t[1] for t in ts))
    out = {"rows": rows, "windows": GRAPH_WINDOWS, "ticks": GRAPH_TICKS}
    for arm, eng in engines.items():
        out[arm] = {"wall_ms": SM.spread(walls[arm]),
                    "event_ms": SM.spread(events[arm]),
                    "profile": _profile(eng._schedule_tick, steps=4)}
    g = engines["graph"]
    out["graph"]["steps"] = _step_stats(g)
    out["graph"]["breakdown"] = _tick_breakdown(g)
    out["wall_ratio_eager_over_graph"] = (out["eager"]["wall_ms"]["median"]
                                          / out["graph"]["wall_ms"]["median"])
    return out


def _graph_prefill_turns(cfg, params, dev, *, quant_kv) -> dict:
    """Prefill ticks, eager and graphed in turns: each window submits four
    fresh prompts of 64 tokens with one new token each (every tick a
    prefill tick, two rows of 32) to both arms; one window first, untimed,
    holds the capture.  Host ms a tick, median [least-largest] of the
    windows' medians."""
    from repro_torch.benchmarks import smoke as SM

    engines = {a: _graph_engine(cfg, params, dev, eager=a == "eager",
                                quant_kv=quant_kv)
               for a in ("eager", "graph")}
    walls = {a: [] for a in engines}
    for w in range(GRAPH_WINDOWS + 1):
        prompts = _prompts(100 + w, 4, 64, cfg.vocab)
        for arm in (("eager", "graph") if w % 2 == 0
                    else ("graph", "eager")):
            eng = engines[arm]
            reqs = _requests(prompts, 1, base=10 * w)
            for r in reqs:
                eng.submit(r)
            ts = []
            while not all(r.done.is_set() for r in reqs):
                pre = eng.stats.prefills
                t0 = time.perf_counter()
                eng._schedule_tick()
                ts.append((time.perf_counter() - t0) * 1e3)
                if eng.stats.prefills != pre + 1:
                    raise AssertionError("graph_step: a tick ran no prefill")
            if w:
                walls[arm].append(statistics.median(ts))
    return {"windows": GRAPH_WINDOWS,
            **{a: {"wall_ms": SM.spread(walls[a])} for a in engines},
            "graph_steps": _step_stats(engines["graph"])}


def _copy_page_bytes(cfg, dev, quant, seed=0) -> dict:
    """The copy-on-write page copy as the engine runs it (``jit_step`` of
    ``engine.copy_page`` over the donated store, the page pair as device
    scalars) against the eager indexed copy, on two equal seeded stores
    of ``COPY_PAGES`` pages (bf16, or int8 with float32 scales): after
    every copy of ``COPY_PAIRS`` (a warm-up, a capture, replays) every
    leaf equal byte for byte (gate), one capture."""
    import dataclasses

    import torch

    from repro_torch.models import model as M
    from repro_torch.serving.engine import copy_page
    from repro_torch.serving.steps import jit_step

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    graphed = M.init_paged_caches(cfg, COPY_PAGES, SCHED["page_size"],
                                  quantized=quant, device=dev)
    for x in graphed.values():
        if x.is_floating_point():
            x.copy_(torch.randn(x.shape, generator=g, device=dev))
        else:
            x.copy_(torch.randint(-127, 128, x.shape, generator=g,
                                  device=dev))
    eager = {k: v.clone() for k, v in graphed.items()}
    step = jit_step(copy_page, donate_argnums=(0,))
    equal = []
    for src, dst in COPY_PAIRS:
        pair = torch.tensor([src, dst], dtype=torch.int32, device=dev)
        step(graphed, pair[0], pair[1])
        for x in eager.values():
            x[:, dst] = x[:, src]
        equal.append(all(
            torch.equal(graphed[k].contiguous().view(torch.uint8),
                        eager[k].contiguous().view(torch.uint8))
            for k in graphed))
    out = {"store": "int8" if quant else "bf16", "pages": COPY_PAGES,
           "pairs": COPY_PAIRS, "leaves": sorted(graphed),
           "bytes_equal": equal,
           "steps": dataclasses.asdict(step.stats)}
    st = out["steps"]
    if not all(equal) or (dev.type == "cuda" and (
            st["warmups"], st["captures"], st["replays"]) != (
            1, 1, len(COPY_PAIRS) - 1)):
        raise AssertionError(f"copy_page, graph against eager: {out}")
    step.reset()
    return out


def graph_step_phase(cfg, params, dev, seed) -> dict:
    """The serving step as one CUDA graph (``steps.jit_step``) against the
    bare step, on the bf16 and the int8 store: tokens, launches, float32
    logits, a swap's recapture, memory over swaps, and ticks timed in
    turns."""
    from repro_torch.models import model as M

    params2 = M.init_params(seed + 1, cfg, device=dev)
    params2["embed"].mul_(EMBED_SCALE)
    out = {"windows": GRAPH_WINDOWS, "ticks_a_window": GRAPH_TICKS}
    t0 = time.monotonic()
    for store, quant in (("bf16", False), ("int8", True)):
        rec = out[store] = {}
        rec["tokens"] = _graph_tokens(cfg, params, dev, quant_kv=quant,
                                      seed=seed + 3)
        rec["logits_f32"] = _graph_logits(cfg, params, dev, quant_kv=quant,
                                          seed=seed + 3)
        rec["swap"] = _graph_swap(cfg, params, params2, dev, quant_kv=quant,
                                  seed=seed + 3)
        for rows in GRAPH_ROWS:
            rec[f"decode_rows_{rows}"] = _graph_tick_turns(
                cfg, params, dev, quant_kv=quant, rows=rows)
        rec["prefill"] = _graph_prefill_turns(cfg, params, dev,
                                              quant_kv=quant)
        rec["copy_page"] = _copy_page_bytes(cfg, dev, quant, seed)
    del params2
    out["swap_memory"] = _graph_swap_memory(cfg, params, dev)
    out["seconds"] = time.monotonic() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 10: the other model families, one full-width model at a time
# ---------------------------------------------------------------------------


def _swap_final_norm(params):
    """A hot swap's new parameter tree at full width: the final norm scale
    times (1 + 1e-6), every other leaf the old tree's.  The engine's
    default copies every leaf, and two trees of phi3.5-moe or granite-20b
    exceed the card."""
    return {**params, "final_ln": params["final_ln"] * (1.0 + 1e-6)}


def _family_params(arch, depth, dev, seed):
    """-> (config cut to ``depth`` layers, its parameters from ``seed``
    with the embedding scaled by ``EMBED_SCALE``, as ``main`` makes
    llama3.2-1b's, the seconds it took)."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models import model as M

    cfg = configs.get(arch)[0]
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    t0 = time.monotonic()
    params = M.init_params(seed, cfg, device=dev)
    params["embed"].mul_(EMBED_SCALE)
    torch.cuda.synchronize()
    return cfg, params, time.monotonic() - t0


def _family_model_record(cfg, params, depth, init_s) -> dict:
    from repro_torch import configs

    full = configs.get(cfg.name)[0]
    return {"config": cfg.name, "family": cfg.family,
            "layers": cfg.n_layers, "published_layers": full.n_layers,
            "depth_cut": depth is not None, "d_model": cfg.d_model,
            "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.hd],
            "param_dtype": str(cfg.param_dtype),
            "params": sum(int(x.numel()) for x in _leaves(params)),
            "param_bytes": sum(x.numel() * x.element_size()
                               for x in _leaves(params)),
            "init_s": init_s}


def _released(start, store_bytes, what) -> dict:
    """Collect and release after a model's runs; its ``memory_allocated``
    must come back within ``store_bytes`` (its page store or decode
    caches) of the phase's start (G3).  cuBLAS's workspaces are released
    first: the library keeps one for each thread that ran a product (32
    MB on the card at every new handler thread), whatever model ran."""
    import gc

    import torch

    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    rec = {"allocated_after_release": after,
           "growth_bytes": after - start, "store_bytes": store_bytes}
    if after - start > store_bytes:
        raise AssertionError(f"{what} left {after - start} B "
                             f"allocated, more than one store "
                             f"({store_bytes} B): {rec}")
    return rec


def family_handler_run(arch, depth, dev, seed, start) -> dict:
    """One family in handler mode at full width: 2 x 4 slots serving 8
    requests of 16 + 16 tokens under hot swaps (``_swap_final_norm``,
    every 0.25 s) and compaction (``run_engine``: K1-K4 launched, table
    drained, pages free), graphed and then eager; the B = 4 decode step
    timed and profiled; two
    requests alone, without swaps, equal to the direct greedy loop of the
    port's decode step (``token_check``); peak ``memory_allocated``."""
    import torch

    from repro_torch.models import model as M

    cfg, params, init_s = _family_params(arch, depth, dev, seed)
    rec = _family_model_record(cfg, params, depth, init_s)
    torch.cuda.reset_peak_memory_stats()
    slots, max_seq = 4, 64
    kw = dict(n_req=8, prompt_len=16, max_new=16, handlers=2, slots=slots,
              max_seq=max_seq, swap_s=0.25, compact_s=0.2, seed=seed,
              perturb=_swap_final_norm, varied=FAMILY_VARIED)
    rec["engine"] = run_engine(cfg, params, dev, **kw)
    rec["eager_engine"] = _engine_arm(run_engine(cfg, params, dev,
                                                 eager=True, **kw))
    rec["decode_step"] = decode_step_ms(cfg, params, dev, batch=slots,
                                        max_seq=max_seq)
    rec["tokens"] = token_check(cfg, params, dev, n_req=2, prompt_len=16,
                                max_new=8, max_seq=max_seq, seed=seed + 1,
                                varied=FAMILY_VARIED)
    rec["peak_allocated"] = torch.cuda.max_memory_allocated()
    caches = sum(x.numel() * x.element_size() for x in _leaves(
        M.init_caches(cfg, slots, max_seq, device="meta")))
    del params
    rec["memory"] = _released(start, caches, cfg.name)
    return rec


def _family_kernel_checks(dev, cfg, seeds=range(2)) -> dict:
    """K5 and K6 against their plain versions at ``cfg``'s head shape: the
    tick shapes (8 decode rows, 2 prefill rows of 32 columns; 16-position
    pages, 8 lanes) and seeded trap cases, for each (q, page) type pair
    the engine or the precision checks use."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops as K
    from repro_torch.kernels import ref as R

    out = {name: {"cases": 0, "max_abs_err": 0.0, "matched": True,
                  "tolerance": {"float32": PAGED_F32_ATOL,
                                "bfloat16": "2**-7 * max |out|"}}
           for name in PAGED_KERNELS}
    head = dict(h=cfg.n_heads, kvh=cfg.n_kv_heads, hd=cfg.hd, ps=16,
                lanes=8, n_pages=64)
    types = [(torch.bfloat16, torch.bfloat16), (torch.float32,
                                                torch.bfloat16),
             (torch.float32, torch.float32)]
    for seed in seeds:
        rng = np.random.default_rng(seed)
        cases = [(dict(head, b=8, s=1), False), (dict(head, b=2, s=32), False),
                 (dict(head, b=5, s=5), True)]
        for (sh, traps), (qd, kd) in itertools.product(cases, types):
            q, kp, vp, pi, cl, nl = _paged_case(
                rng, dev, q_dtype=qd, kv_dtype=kd, traps=traps, **sh)
            _paged_agree(out, "paged_chunk_attention",
                         K.paged_chunk_attention(q, kp, vp, pi, cl, nl),
                         R.paged_chunk_attn_ref(q, kp, vp, pi, cl, nl),
                         _padding(q, cl, nl))
            q1 = q[:, -1].contiguous()
            _paged_agree(out, "paged_attention",
                         K.paged_attention(q1, kp, vp, pi, cl),
                         R.paged_attn_ref(q1, kp, vp, pi, cl), cl <= 0)
    torch.cuda.synchronize()
    return out


def _family_kernel_times(dev, cfg, seed=0) -> dict:
    """K5 and K6 timed at ``cfg``'s tick shapes, the scheduler phase's
    (a decode tick of 8 rows at 24-88 positions, a prefill tick of 2 rows
    x 32 columns on prefixes of 0 and 40) with the engine's bf16 q and
    pages in a ``SCHED_PAGES`` store, each beside its plain version, SDPA
    and its byte bound (``_time_paged_case`` without the designs)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    base = dict(h=cfg.n_heads, kvh=cfg.n_kv_heads, hd=cfg.hd, ps=16,
                lanes=8, n_pages=SCHED_PAGES, q_dtype=cfg.compute_dtype,
                kv_dtype=torch.bfloat16, traps=False)
    dec = _paged_case(rng, dev, b=8, s=1, clen=rng.integers(24, 89, 8),
                      nl=np.ones(8), **base)
    pre = _paged_case(rng, dev, b=2, s=32, clen=[32, 72], nl=[32, 32],
                      **base)
    return {name: _time_paged_case(dev, case, False, designs=False)
            for name, case in zip(PAGED_KERNELS, (dec, pre))}


def family_scheduler_run(arch, depth, dev, seed, start) -> dict:
    """One dense or vlm config in graphed scheduler mode at full width:
    ``run_scheduler``'s two waves under swaps (``_swap_final_norm``) and
    compaction (K1-K3, K5 and K6 launched, prefix cache used, pages free,
    table drained, memory gates), the tokens teacher-forced within
    ``BF16_VS_F32_REL`` of the dense greedy loop's best at every step
    (R12), K5/K6 checked against their plain versions at the config's
    head shape and timed at its tick shape."""
    import torch

    from repro_torch.benchmarks import smoke as SM

    cfg, params, init_s = _family_params(arch, depth, dev, seed)
    rec = _family_model_record(cfg, params, depth, init_s)
    torch.cuda.reset_peak_memory_stats()
    sched = run_scheduler(cfg, params, dev, seed=seed + 3,
                          perturb=_swap_final_norm, varied=FAMILY_VARIED)
    rec["scheduler"] = {k: v for k, v in sched.items()
                        if k not in ("prompts", "outputs")}
    hold = SM.hold_tokens(cfg, params, dev, sched["prompts"],
                          sched["outputs"], 16, near_tie_rel=BF16_VS_F32_REL,
                          max_seq=SCHED["max_seq"])
    rec["teacher_forced"] = hold
    if not hold["ok"]:
        raise AssertionError(f"{cfg.name}: scheduler tokens outside the "
                             f"near-tie of the dense loop: {hold}")
    rec["kernel_checks"] = _family_kernel_checks(dev, cfg)
    rec["kernel_times"] = _family_kernel_times(dev, cfg)
    rec["peak_allocated"] = torch.cuda.max_memory_allocated()
    del params
    rec["memory"] = _released(start, sched["page_store_bytes"], cfg.name)
    return rec


def families_phase(dev, seed, emit_model) -> dict:
    """Every registered config but llama3.2-1b at full width, one model at
    a time, each released before the next (``_released``): the ``moe``,
    ``ssm`` and ``hybrid`` families in handler mode
    (``FAMILY_HANDLER``), the other dense and vlm configs in graphed
    scheduler mode (``FAMILY_SCHEDULER``).  ``emit_model`` prints each
    model's record as it finishes."""
    import gc

    import torch

    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    out = {"allocated_at_start": start, "handler": [], "scheduler": []}
    for mode, run, entries in (("handler", family_handler_run,
                                FAMILY_HANDLER),
                               ("scheduler", family_scheduler_run,
                                FAMILY_SCHEDULER)):
        for arch, depth in entries:
            t1 = time.monotonic()
            rec = run(arch, depth, dev, seed, start)
            rec["seconds"] = time.monotonic() - t1
            emit_model({"mode": mode, **rec})
            out[mode].append({"config": arch, "layers": rec["layers"],
                              "seconds": rec["seconds"]})
    out["seconds"] = time.monotonic() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 11: training
# ---------------------------------------------------------------------------


def _train_batches(cfg, dev, seed):
    """train_4k batches of ``TRAIN_BATCH`` sequences on the card, one a
    step: ``SyntheticLM`` tokens (``data.make_batches``, its seed
    ``seed``) for a token model; for the audio family, seeded frame
    embeddings (the stub frontend's output) with labels over its clusters
    and HuBERT's span mask, the loss taken over the masked frames."""
    import numpy as np
    import torch

    from repro_torch.data import DataConfig, make_batches

    if cfg.family != "audio":
        data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ + 1,
                          global_batch=TRAIN_BATCH, seed=seed)
        for b in make_batches(data):
            yield {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    rng = np.random.default_rng(seed)
    shape = (TRAIN_BATCH, TRAIN_SEQ)
    while True:
        starts = rng.random(shape) < HUBERT_MASK_PROB
        mask = np.zeros(shape, bool)
        for k in range(HUBERT_MASK_SPAN):
            mask[:, k:] |= starts[:, :TRAIN_SEQ - k]
        yield {"embeds": torch.randn(shape + (cfg.d_model,), generator=g,
                                     device=dev),
               "labels": torch.randint(0, cfg.vocab, shape, generator=g,
                                       device=dev, dtype=torch.int32),
               "mask": torch.from_numpy(mask.astype(np.float32)).to(dev)}


def _update_samples(params, n, seed=0) -> dict:
    """Up to ``n`` seeded element indices of every leaf (dotted name ->
    flat index tensor on the leaf's device)."""
    import torch

    from repro_torch.ft.checkpoint import tree_flatten

    g = torch.Generator().manual_seed(seed)
    leaves = tree_flatten(params)[0]
    names = _dotted(params)
    return {name: torch.randint(0, x.numel(), (min(n, x.numel()),),
                                generator=g).to(x.device)
            for name, x in zip(names, leaves)}


def _dotted(tree, prefix=""):
    """The dotted names of a tree's leaves, in ``tree_flatten``'s order
    (dicts by sorted key)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        out += _dotted(v, name + ".") if isinstance(v, dict) else [name]
    return out


def _sampled(tree, idx) -> dict:
    """The sampled elements of each leaf as float64 on the host."""
    return {name: _leaf(tree, name).reshape(-1)[i].double().cpu()
            for name, i in idx.items()}


def train_run(arch, dev, seed, depth=None) -> dict:
    """One published config at full width (cut to ``depth`` layers when
    given), trained on
    ``_train_batches`` with ``TrainConfig(remat="full", microbatches=4)``
    and the default AdamW, through the graphed step (``jit_train_step``,
    which updates its trees in place) and the eager one
    (``make_train_step``).  The graphed step's first call (its eager
    warm-up) takes batch 0.  Then the eager arm: ``TRAIN_TIMED_STEPS``
    steps on batches 1, 2, ... chained from the warm-up's trees, while no
    graph holds a pool (llama3.2-1b's pool and an eager step's
    temporaries do not fit the card together, so the arms cannot
    alternate without a capture at every turn).  Then the graph arm from
    the same trees: the capture (a capture and a replay) on batch 1 and
    ``TRAIN_TIMED_STEPS`` replays on batches 2, 3, ...  Timed: the host
    clock around a synchronized call, CUDA events beside it (a replay's
    event time is the graph's time on the card).  For each batch both
    arms ran (gate): the graphed step's loss within
    ``CARD_VS_CPU_LOSS_REL`` of the eager one's, its gradient norm within
    ``CARD_VS_CPU_GRAD_REL``, and ``TRAIN_UPDATE_SAMPLES`` sampled
    elements of each leaf's update (new minus the arm's own old value)
    within ``lr * (1e-3 + CARD_VS_CPU_GRAD_REL * max|g| / (|g| + eps))``
    of the eager update (``g`` the eager step's clipped gradient, from its
    first moment; ``train_card_vs_cpu``'s bounds).  Every loss finite and
    the first within ``TRAIN_LOSS_NEAR`` of ln V; peak
    ``memory_allocated``.  A tied embedding is scaled by ``EMBED_SCALE``
    as in every other phase: unscaled, each token's own embedding
    dominates the tied head's logits and the first loss of llama3.2-1b is
    ~16.2 against ln V = 11.76."""
    import dataclasses
    import gc
    import math

    import torch

    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import (OptimizerConfig, adamw_init,
                                                lr_schedule)
    from repro_torch.training.train_step import (TrainConfig,
                                                 jit_train_step,
                                                 make_train_step)

    cfg = configs.get(arch)[0]
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    t0 = time.monotonic()
    params = M.init_params(seed, cfg, device=dev)
    if "embed" in params:
        params["embed"].mul_(EMBED_SCALE)
    torch.cuda.synchronize()
    rec = _family_model_record(cfg, params, depth, time.monotonic() - t0)
    rec["embed_scale"] = EMBED_SCALE if "embed" in params else None
    opt = OptimizerConfig()
    tcfg = TrainConfig(remat="full", microbatches=TRAIN_MICROBATCHES)
    rec.update({"shape": "train_4k", "seq": TRAIN_SEQ,
                "global_batch": TRAIN_BATCH,
                "published_global_batch": TRAIN_PUBLISHED_BATCH,
                "microbatches": tcfg.microbatches, "remat": tcfg.remat,
                "optimizer": "AdamW, repro's defaults (lr 3e-4, warmup 100)",
                "reduced": [f"global batch {TRAIN_PUBLISHED_BATCH} -> "
                            f"{TRAIN_BATCH}"] + (
                    [] if depth is None else
                    [f"layers {rec['published_layers']} -> {depth}"]),
                "order": "graph warm-up; eager arm; graph arm"})
    state = adamw_init(params, opt)
    eager = make_train_step(cfg, opt, tcfg=tcfg)
    step = jit_train_step(cfg, opt, tcfg=tcfg)
    idx = _update_samples(params, TRAIN_UPDATE_SAMPLES, seed)
    batches = _train_batches(cfg, dev, seed)
    torch.cuda.reset_peak_memory_stats()

    def timed(fn, *args):
        start, stop = (torch.cuda.Event(enable_timing=True)
                       for _ in range(2))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        start.record()
        out = fn(*args)
        stop.record()
        torch.cuda.synchronize()
        return out, {"ms": (time.perf_counter() - t1) * 1e3,
                     "event_ms": start.elapsed_time(stop),
                     "loss": float(out[2]["loss"]),
                     "grad_norm": float(out[2]["grad_norm"])}

    (params, state, _), warm = timed(step, params, state, next(batches))
    b = [next(batches) for _ in range(TRAIN_TIMED_STEPS + 1)]
    # reference cycles through frames (torch.utils.checkpoint's early
    # stop) hold the warm-up's tensors until collected
    gc.collect()
    eager_runs, p, s = [], params, state
    for i in range(TRAIN_TIMED_STEPS):
        old = _sampled(p, idx)
        (p, s, _), e = timed(eager, p, s, b[i])
        e.update(old=old, new=_sampled(p, idx), m=_sampled(s["m"], idx),
                 lr=float(lr_schedule(opt, s["step"])),
                 gmax={n: float(_leaf(s["m"], n).abs().max())
                       / (1 - opt.b1) for n in idx})
        eager_runs.append(e)
    del p, s
    gc.collect()
    torch.cuda.empty_cache()
    graph_runs = []
    for i in range(TRAIN_TIMED_STEPS + 1):
        old = _sampled(params, idx)
        (params, state, _), c = timed(step, params, state, b[i])
        c.update(old=old, new=_sampled(params, idx))
        graph_runs.append(c)
    rec["steps"] = st = dataclasses.asdict(step.graph.stats)
    step.graph.reset()
    if (st["warmups"], st["captures"], st["replays"], st["capture_at"]) != (
            1, 1, TRAIN_TIMED_STEPS + 1, [2]):
        raise AssertionError(f"train: {arch} graph counts: {st}")
    checks = []
    for i, (e, c) in enumerate(zip(eager_runs, graph_runs)):
        worst = 0.0
        for n in idx:
            gr = e["m"][n].abs() / (1 - opt.b1)
            bound = e["lr"] * (1e-3 + CARD_VS_CPU_GRAD_REL * e["gmax"][n]
                               / (gr + opt.eps))
            d = ((c["new"][n] - c["old"][n]) - (e["new"][n] - e["old"][n]))
            worst = max(worst, float((d.abs() / bound).max()))
        ok = (abs(c["loss"] - e["loss"])
              <= CARD_VS_CPU_LOSS_REL * abs(e["loss"])
              and abs(c["grad_norm"] - e["grad_norm"])
              <= CARD_VS_CPU_GRAD_REL * e["grad_norm"] and worst <= 1.0)
        checks.append({"batch": i + 1, "graph_call": ("capture" if i == 0
                                                      else "replay"),
                       "loss": [e["loss"], c["loss"]],
                       "grad_norm": [e["grad_norm"], c["grad_norm"]],
                       "trees_equal_before": all(
                           torch.equal(c["old"][n], e["old"][n])
                           for n in idx),
                       "max_update_err_over_bound": worst, "ok": ok})
        if not ok:
            raise AssertionError(f"train: {arch} graphed step differs from "
                                 f"the eager one: {checks[-1]}")
    for r in eager_runs + graph_runs:
        for k in ("old", "new", "m", "gmax"):
            r.pop(k, None)

    def arm(runs):
        ms = [r["ms"] for r in runs]
        ev = [r["event_ms"] for r in runs]
        return {"median_ms": statistics.median(ms), "min_ms": min(ms),
                "max_ms": max(ms), "event_median_ms": statistics.median(ev),
                "event_min_ms": min(ev), "event_max_ms": max(ev),
                "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ
                / (statistics.median(ms) / 1e3), "steps": runs}

    losses = [warm["loss"]] + [r["loss"] for r in eager_runs + graph_runs]
    norms = [warm["grad_norm"]] + [r["grad_norm"]
                                   for r in eager_runs + graph_runs]
    rec.update({"warmup_step": warm, "capture_call": graph_runs[0],
                "graph": arm(graph_runs[1:]), "eager": arm(eager_runs),
                "checks": checks, "capture_ms": st["capture_ms"],
                "losses": losses, "grad_norms": norms,
                "ln_vocab": math.log(cfg.vocab),
                "update_samples": TRAIN_UPDATE_SAMPLES,
                "tolerance": {"loss_rel": CARD_VS_CPU_LOSS_REL,
                              "grad_rel": CARD_VS_CPU_GRAD_REL,
                              "update": "lr * (1e-3 + grad_rel * max|g| / "
                                        "(|g| + eps))"},
                "peak_allocated": torch.cuda.max_memory_allocated()})
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"train: {arch} non-finite loss: {rec}")
    if abs(losses[0] - math.log(cfg.vocab)) > TRAIN_LOSS_NEAR:
        raise AssertionError(f"train: {arch} first loss {losses[0]} not "
                             f"near ln V {math.log(cfg.vocab)}: {rec}")
    return rec


def _leaf(tree, dotted):
    for k in dotted.split("."):
        tree = tree[k]
    return tree


def train_card_vs_cpu(dev, seed) -> dict:
    """One train step of llama3.2-1b at full width cut to
    ``CARD_VS_CPU["layers"]`` layers, float32 compute, on the card and on
    the CPU from the same parameters (made on the CPU, copied over) and
    the same ``SyntheticLM`` batch: loss, gradient norm, and the new
    parameters and moments of ``CARD_VS_CPU_LEAVES`` within the stated
    tolerances."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import llama3_2_1b
    from repro_torch.data import DataConfig, make_batches
    from repro_torch.ft.elastic import reshard_tree
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import (OptimizerConfig, adamw_init,
                                                lr_schedule)
    from repro_torch.training.train_step import TrainConfig, make_train_step

    cfg = dataclasses.replace(llama3_2_1b.CONFIG,
                              n_layers=CARD_VS_CPU["layers"],
                              compute_dtype=torch.float32)
    cpu_params = M.init_params(seed, cfg, device="cpu")
    cpu_params["embed"].mul_(EMBED_SCALE)
    card_params = reshard_tree(cpu_params, cpu_params, device=dev)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0)
    step = make_train_step(cfg, opt, tcfg=TrainConfig(remat="none"))
    data = DataConfig(vocab=cfg.vocab, seq_len=CARD_VS_CPU["seq"] + 1,
                      global_batch=CARD_VS_CPU["batch"], seed=seed)
    b = next(make_batches(data))
    t0 = time.monotonic()
    cp, cs, cm = step(cpu_params, adamw_init(cpu_params, opt), b)
    cpu_s = time.monotonic() - t0
    t0 = time.monotonic()
    gp, gs, gm = step(card_params, adamw_init(card_params, opt), b)
    torch.cuda.synchronize()
    card_s = time.monotonic() - t0
    lr = float(lr_schedule(opt, torch.tensor(1)))
    rec = {"config": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "seq": CARD_VS_CPU["seq"],
           "batch": CARD_VS_CPU["batch"], "compute": "float32, no TF32",
           "cpu_s": cpu_s, "card_s": card_s,
           "loss": [float(cm["loss"]), float(gm["loss"])],
           "grad_norm": [float(cm["grad_norm"]), float(gm["grad_norm"])],
           "tolerance": {"loss_rel": CARD_VS_CPU_LOSS_REL,
                         "grad_rel": CARD_VS_CPU_GRAD_REL,
                         "update": "lr * (1e-3 + grad_rel * max|g| / "
                                   "(|g| + eps))"},
           "leaves": {}}
    ok = abs(rec["loss"][1] - rec["loss"][0]) <= \
        CARD_VS_CPU_LOSS_REL * abs(rec["loss"][0])
    ok &= abs(rec["grad_norm"][1] - rec["grad_norm"][0]) <= \
        CARD_VS_CPU_GRAD_REL * rec["grad_norm"][0]
    for name in CARD_VS_CPU_LEAVES:
        p0 = _leaf(cpu_params, name).numpy()
        c1, g1 = _leaf(cp, name).numpy(), _leaf(gp, name).cpu().numpy()
        m = _leaf(cs["m"], name).numpy()
        g = np.abs(m) / (1 - opt.b1)       # the CPU's clipped gradient
        bound = lr * (1e-3 + CARD_VS_CPU_GRAD_REL * g.max() / (g + opt.eps))
        d = np.abs((g1 - p0) - (c1 - p0))
        moments = max(
            float(np.abs(_leaf(gs[k], name).cpu().numpy()
                         - _leaf(cs[k], name).numpy()).max()
                  / max(np.abs(_leaf(cs[k], name).numpy()).max(), 1e-30))
            for k in ("m", "v"))
        leaf_ok = bool((d <= bound).all()) and moments <= \
            CARD_VS_CPU_GRAD_REL
        rec["leaves"][name] = {"elements": int(p0.size),
                               "max_update_err_over_bound":
                                   float((d / bound).max()),
                               "max_abs_update_err": float(d.max()),
                               "moments_rel_err": moments, "ok": leaf_ok}
        ok &= leaf_ok
    rec["ok"] = bool(ok)
    if not ok:
        raise AssertionError(f"train: card and CPU steps differ: {rec}")
    return rec


def train_quickstart(dev, seed) -> dict:
    """``repro``'s quickstart contract (tests/test_system.py) on the card:
    the smoke llama, ``QUICKSTART_STEPS`` steps of the graphed step
    (``jit_train_step``, as ``repro`` jits it) on the synthetic corpus,
    the last loss at least ``QUICKSTART_DROP`` below the first."""
    import dataclasses
    import math

    from repro_torch import configs
    from repro_torch.data import DataConfig, make_batches
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import OptimizerConfig, adamw_init
    from repro_torch.training.train_step import TrainConfig, jit_train_step

    cfg = configs.get_smoke("llama3.2-1b")
    params = M.init_params(seed, cfg, device=dev)
    opt = OptimizerConfig(lr=3e-3, warmup_steps=10,
                          total_steps=QUICKSTART_STEPS, schedule="cosine")
    state = adamw_init(params, opt)
    step = jit_train_step(cfg, opt, tcfg=TrainConfig(remat="none"))
    it = make_batches(DataConfig(vocab=cfg.vocab, seq_len=32,
                                 global_batch=16))
    t0 = time.monotonic()
    losses = []
    for _ in range(QUICKSTART_STEPS):
        params, state, m = step(params, state, next(it))
        losses.append(float(m["loss"]))
    rec = {"config": cfg.name, "steps": QUICKSTART_STEPS,
           "first_loss": losses[0], "last_loss": losses[-1],
           "drop": losses[0] - losses[-1], "required_drop": QUICKSTART_DROP,
           "graph": dataclasses.asdict(step.graph.stats),
           "seconds": time.monotonic() - t0}
    step.graph.reset()
    if not all(math.isfinite(x) for x in losses) \
            or rec["drop"] < QUICKSTART_DROP:
        raise AssertionError(f"train: quickstart contract failed: {rec}")
    return rec


def train_restart(dev, seed) -> dict:
    """``repro``'s ``test_checkpoint_restart_bit_exact`` on the card,
    through the graphed step (``jit_train_step``, which updates the trees
    it is given: each run starts from its own copy): 6 steps straight
    equal 3 steps, a checkpoint, a restore and 3 steps, bit for bit, under
    ``torch.use_deterministic_algorithms`` (the embedding's gradient is an
    indexed accumulation, whose default CUDA kernel adds in any order;
    cuBLAS on one stream is deterministic, so its warning is let
    through).  Each run's first step is the graph's eager warm-up, its
    second the capture, so step 4 runs eagerly after the restore and as a
    replay in the straight run."""
    import torch

    from repro_torch import configs
    from repro_torch.data import DataConfig, make_batches
    from repro_torch.ft.checkpoint import (latest_step, load_checkpoint,
                                           save_checkpoint, tree_flatten,
                                           tree_unflatten)
    from repro_torch.ft.elastic import reshard_tree
    from repro_torch.models import model as M
    from repro_torch.training.optimizer import OptimizerConfig, adamw_init
    from repro_torch.training.train_step import TrainConfig, jit_train_step

    cfg = configs.get_smoke("llama3.2-1b")
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0)
    step = jit_train_step(cfg, opt, tcfg=TrainConfig(remat="none"))
    data = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8)

    def run(params, state, start, n):
        leaves, treedef = tree_flatten((params, state))
        params, state = tree_unflatten(treedef, [x.clone() for x in leaves])
        it = make_batches(data, start_step=start)
        for _ in range(n):
            params, state, _ = step(params, state, next(it))
        return params, state

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    os.makedirs(CKPT_DIR, exist_ok=True)
    try:
        params = M.init_params(seed, cfg, device=dev)
        state = adamw_init(params, opt)
        pA, _ = run(params, state, 0, 6)
        pB, sB = run(params, state, 0, 3)
        save_checkpoint(CKPT_DIR, 3, {"params": pB, "state": sB})
        like = {"params": pB, "state": sB}
        restored = reshard_tree(load_checkpoint(CKPT_DIR, 3, like), like,
                                device=dev)
        assert latest_step(CKPT_DIR) == 3
        pC, _ = run(restored["params"], restored["state"], 3, 3)
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        step.graph.reset()
    a, c = tree_flatten(pA)[0], tree_flatten(pC)[0]
    rec = {"config": cfg.name, "steps": "6 == 3 + checkpoint + 3",
           "graph": {k: getattr(step.graph.stats, k)
                     for k in ("warmups", "captures", "replays")},
           "deterministic_algorithms": True,
           "leaves": len(a),
           "leaves_equal": sum(bool(torch.equal(x, y)) for x, y in zip(a, c)),
           "max_abs_diff": max(float((x - y).abs().max())
                               for x, y in zip(a, c))}
    if rec["leaves_equal"] != rec["leaves"]:
        raise AssertionError(f"train: restart is not bit-exact: {rec}")
    return rec


def train_phase(dev, seed, emit_model) -> dict:
    """Phase 11: the training path (``repro_torch.training``, the data
    pipeline, checkpoints), which runs none of the port's kernels:
    ``train_run`` for each of ``TRAIN_CONFIGS`` (``emit_model`` prints
    each record), ``train_card_vs_cpu``, ``train_quickstart`` and
    ``train_restart``; no kernel launched, and ``memory_allocated`` back
    within one train batch's bytes of the phase's start."""
    import gc

    import torch

    from repro_torch.kernels import ops as K

    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated()
    t0 = time.monotonic()
    K.reset_launch_counts()
    out = {"allocated_at_start": start, "models": []}
    for arch, depth in TRAIN_CONFIGS:
        gc.collect()            # the last model's trees, before the next
        torch.cuda.empty_cache()
        t1 = time.monotonic()
        rec = train_run(arch, dev, seed, depth)
        rec["seconds"] = time.monotonic() - t1
        emit_model(rec)
        out["models"].append({k: rec[k] for k in (
            "config", "graph", "eager", "capture_ms", "peak_allocated",
            "seconds")})
    out["card_vs_cpu"] = train_card_vs_cpu(dev, seed)
    out["quickstart"] = train_quickstart(dev, seed)
    out["restart"] = train_restart(dev, seed)
    out["launches"] = K.launch_counts()
    if any(out["launches"].values()):
        raise AssertionError(f"train: the training path launched a "
                             f"kernel: {out['launches']}")
    out["memory"] = _released(start, _train_batch_bytes(), "train")
    out["seconds"] = time.monotonic() - t0
    return out


def serve_bravo_phase(dev) -> dict:
    """``repro_torch.examples.serve_bravo`` on the card (its lines go to
    stderr): handler mode on the smoke llama under swaps every 0.25 s and
    compaction every 0.4 s, for ``bravo-ba``, ``ba`` and
    ``bravo-pthread``.  Each lock's 8 requests finish (the example raises
    otherwise) with a sample in the vocabulary, in at least 44 decode
    steps (4 batches of 6 + 6 - 1 steps when each takes two requests);
    K1-K3 launched (K4 runs only in a drain check, which the example
    makes none of); every handler call a warm-up or a replay of its
    graph."""
    from repro_torch import configs
    from repro_torch.examples import serve_bravo
    from repro_torch.kernels import ops as K

    vocab = configs.get_smoke("llama3.2-1b").vocab
    t0 = time.monotonic()
    K.reset_launch_counts()
    with contextlib.redirect_stdout(sys.stderr):
        runs = serve_bravo.main(["--device", str(dev)])
    counts = K.launch_counts()
    out = {"locks": [], "launches": counts}
    for r in runs:
        graphs = {kind: {k: sum(s[kind][k] for s in
                                r["handler_steps"].values())
                         for k in ("warmups", "captures", "replays")}
                  for kind in ("prefill", "decode")}
        rec = {k: v for k, v in r.items() if k != "handler_steps"}
        rec["graphs"] = graphs
        out["locks"].append(rec)
        dec = graphs["decode"]
        if (r["decode_steps"] < 44 or dec["warmups"] + dec["replays"]
                != r["decode_steps"] or not dec["replays"]
                or not all(0 <= t < vocab for t in r["sample"])):
            raise AssertionError(f"serve_bravo: {rec}")
    # the plain versions (CPU tensors) count no launch
    if dev.type == "cuda" and not all(counts[k] for k in TABLE_KERNELS[:3]):
        raise AssertionError(f"serve_bravo: K1-K3 not launched: {counts}")
    out["seconds"] = time.monotonic() - t0
    return out


def _train_batch_bytes() -> int:
    """The largest train batch's bytes: hubert's float32 frame embeddings,
    int32 labels and float32 mask."""
    from repro_torch import configs

    d = configs.get("hubert-xlarge")[0].d_model
    return TRAIN_BATCH * TRAIN_SEQ * 4 * (d + 2)


# ---------------------------------------------------------------------------
# Phases 6a-6d: the serving benchmark twins, and the writer path under load
# and faults, at full width
# ---------------------------------------------------------------------------


def _twin_phase(name, run, kernels=WRITER_KERNELS):
    """Run one benchmark twin's phase with the launch counts set to 0 just
    before it and read just after; raises on any failed check of the
    benchmark twins (their ``[ok]`` lines go to stderr) and if a kernel of
    its path never ran."""
    from repro_torch.benchmarks import smoke as SM
    from repro_torch.kernels import ops as K

    SM.FAILURES.clear()
    K.reset_launch_counts()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(sys.stderr):
        rec = run()
    counts = K.launch_counts()
    if SM.FAILURES:
        print(json.dumps({"phase": name, "failed_record": rec},
                         default=str), file=sys.stderr, flush=True)
        raise AssertionError(f"{name}: failed checks {SM.FAILURES}")
    idle = [k for k in kernels if not counts[k]]
    if idle:
        raise AssertionError(f"{name}: {idle} never launched")
    rec.update(launches=counts, seconds=time.monotonic() - t0)
    return rec


def obs_phase(cfg, params, dev) -> dict:
    """The ``obs`` twin: the emit site's cost disabled and enabled; the
    decode workload (6 requests of 8 tokens, 4 slots) untraced and traced
    in ``TWIN_WINDOWS["obs"]`` pairs in turns, the tracing cost a step
    under 2% of the median untraced decode p50 and the median of the
    pairs' direct p50 deltas under 25%; an identity hot-swap mid-serve
    whose Chrome export validates with every lifecycle complete; the
    traced registry pair under the sync gate.  bf16 rounds the paged path
    and the dense loop apart, so the traced and swapped runs' tokens must
    equal the untraced run's, which stand, teacher-forced, within
    ``BF16_VS_F32_REL`` of the dense loop's best."""
    from repro_torch.benchmarks import obs as OBS

    return _twin_phase("obs_bench", lambda: OBS.run(
        cfg, params, dev, windows=TWIN_WINDOWS["obs"],
        near_tie_rel=BF16_VS_F32_REL))


def scheduler_bench_phase(cfg, params, dev) -> dict:
    """The ``scheduler`` twin: K5 against its plain version (1e-5) and
    dense attention at the reference's shape; the scheduler engine's
    tokens, teacher-forced, within ``BF16_VS_F32_REL`` of the dense loop's
    best, every page reclaimed; the lease round trip and one paged decode
    step under the sync gate; the handler engine and ``max_slots`` 1, 2,
    4, 8 in ``TWIN_WINDOWS["scheduler"]`` rounds (tokens/s, decode
    p50/p99: median, least, largest)."""
    from repro_torch.benchmarks import scheduler as SB

    return _twin_phase("scheduler_bench", lambda: SB.run(
        cfg, params, dev, windows=TWIN_WINDOWS["scheduler"],
        near_tie_rel=BF16_VS_F32_REL, mesh=False), kernels=ENGINE_KERNELS)


def prefill_bench_phase(cfg, params, dev) -> dict:
    """The ``prefill`` twin: K6 against its plain version (1e-5) and the
    dense gather; no dense KV buffer among the shapes K6's wrapper makes
    (the plain version's dense gather found by the same recorder), the
    rise of the peak allocation recorded; K6 under the sync gate; the
    prefix dedup sweep (>= 2x fewer page allocations at 90% shared,
    balanced refcounts); K6 against the dense gather at three widths in
    ``TWIN_WINDOWS["prefill"]`` readings."""
    from repro_torch.benchmarks import prefill as PB

    return _twin_phase("prefill_bench", lambda: PB.run(
        cfg, params, dev, windows=TWIN_WINDOWS["prefill"]),
        kernels=ENGINE_KERNELS)


def quant_bench_phase(cfg, params, dev) -> dict:
    """The ``quant`` twin: int8 pages >= 2x smaller than bf16 at the smoke
    config and full width; K7 against the quantized plain version (1e-5)
    and the float32 one (0.05); K5/K7 and K6/K8 at the reference's shapes
    in ``TWIN_WINDOWS["quant"]`` readings (CUDA events); the slo trace
    through the prefix index, collision rate < 0.05."""
    from repro_torch.benchmarks import quant as QB

    return _twin_phase("quant_bench", lambda: QB.run(
        cfg, params, dev, windows=TWIN_WINDOWS["quant"]),
        kernels=PAGED_KERNELS + QUANT_KERNELS)


def slo_phase(cfg, params, dev) -> dict:
    """The ``slo`` twin's calibrated static and closed-loop replays of the
    reference's smoke trace (2.5 s at 8 requests/s, bursts of 5x for 30%
    of every 1.25 s, seed 7) at ``max_slots`` 8: zero
    dropped requests in both, at least one controller decision, the
    Chrome export valid with its counter tracks.  The sampled request's
    tokens are the same in both replays; bf16 rounds the paged path and
    the dense greedy loop apart (as in the scheduler phase), so the dense
    loop is fed the engine's tokens (teacher forcing) and at every step
    the engine's token must stand within ``BF16_VS_F32_REL`` of the
    largest logit of the loop's best (whether all were equal is
    recorded).  The same request at float32 compute, its prompt pages
    from the prefix cache, must equal the dense loop at float32 compute;
    served alone without the prefix cache in bf16 it is recorded beside
    the replays.  Each arm is replayed ``TWIN_WINDOWS["slo"]`` times in
    turns; the closed loop's band on the medians (p99 TTFT within 10% of
    static, or within 50% with goodput no worse) is recorded, not gated:
    it flips between cards even on the medians of three replays (ROADMAP
    G1).

    ``overload``: the same trace with its arrivals compressed
    (``SLO.overload_speed``: 2x, 4x, ... until a static replay's wall is
    at least ``SLO.OVERLOAD_RATIO`` times its arrivals' span, so the
    graphed engine queues as ``repro``'s CPU engine does at 1x), both
    arms replayed ``TWIN_WINDOWS["slo"]`` times in turns at that speed
    with the same checks, and the band judged on their medians: where
    the band makes its claim.  Recorded, not gated (ROADMAP G1)."""
    from repro_torch.benchmarks import slo as SLO

    def run():
        rec = SLO.bench_closed_loop(
            cfg, params, dev, smoke=True, gate_band=False,
            near_tie_rel=BF16_VS_F32_REL, windows=TWIN_WINDOWS["slo"])
        speed, probes = SLO.overload_speed(cfg, params, dev, smoke=True)
        if speed is None:
            raise AssertionError(f"slo: no speed overloads the engine: "
                                 f"{probes}")
        rec["overload"] = {"ratio": SLO.OVERLOAD_RATIO, "probes": probes,
                           **SLO.bench_closed_loop(
                               cfg, params, dev, smoke=True, gate_band=False,
                               near_tie_rel=BF16_VS_F32_REL,
                               windows=TWIN_WINDOWS["slo"], speed=speed)}
        return rec
    return _twin_phase("slo", run)


def hotswap_phase(cfg, params, dev) -> dict:
    """The ``hotswap`` twin's three sections at full width and its full
    sizes (8 tokens a request): 8 identity swaps under 8 requests; the
    float32 parameters saved to ``CKPT_DIR``, staged (streamed,
    CRC-verified, onto the card) and swapped in while a feeder keeps every
    slot decoding, and a copy with one corrupted manifest CRC rejected at
    staging with the leaf's index and the epoch unchanged; a wedged reader
    that degrades the swap until its lane is scrubbed and the retry lands.
    Every request finishes.  bf16 rounds the paged path and the dense
    greedy loop apart, so every request's tokens must equal those a fresh
    engine gives its prompt with no swap, and those, teacher-forced, stand
    within ``BF16_VS_F32_REL`` of the dense loop's best at every step."""
    from repro_torch.benchmarks import hotswap as HS

    rec = _twin_phase("hotswap", lambda: HS.run(
        cfg, params, dev, directory=CKPT_DIR, near_tie_rel=BF16_VS_F32_REL))
    tree = sum(x.numel() * x.element_size() for x in _leaves(params))
    sw = rec["swaps_under_traffic"]
    growth = sw["allocated_after_swaps"] - sw["allocated_before_swaps"]
    rec["swap_memory"] = {"growth_bytes": growth, "param_tree_bytes": tree,
                          "growth_trees": growth / tree}
    if growth >= tree:
        raise AssertionError(f"hotswap: device memory grew by a parameter "
                             f"tree over the swaps: {rec['swap_memory']}")
    return rec


def faults_phase(cfg, params, dev) -> dict:
    """The seven-fault matrix and its golden run at the reference's engine
    settings (64 pages of 4 tokens) on the full-width weights;
    ``corrupt_checkpoint`` corrupts a copy of the hotswap phase's
    checkpoint (its manifest, the shards linked).  Every invariant of
    every fault must hold, tokens equal to the golden run; a failing
    fault prints its obs timeline."""
    from repro_torch.ft import faults as F

    def run():
        res = F.run_matrix(0, cfg=cfg, params=params, device=dev,
                           checkpoint=(CKPT_DIR, 1))
        bad = [r["fault"] for r in res if not r["ok"]]
        if bad:
            raise AssertionError(f"faults: {bad} failed: {res}")
        return {"faults": res, "n": len(res)}
    return _twin_phase("faults", run)


def build_all() -> dict:
    """Compile the CUDA sources, one nvcc for each build in ``BUILDS``, all
    started together."""
    from repro_torch.kernels import _build

    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(len(BUILDS)) as ex:
        futs = {k: ex.submit(_build.compile_source,
                             _build.CSRC / os.path.basename(src), defines)
                for k, (src, defines) in BUILDS.items()}
        built = {k: f.result() for k, f in futs.items()}
    return {"sources": list(SOURCES.values()),
            "builds": {k: {"source": src, "defines": list(d)}
                       for k, (src, d) in BUILDS.items()},
            "seconds": time.monotonic() - t0,
            "nvcc_seconds": {k: v[1] for k, v in built.items()}}


def ptxas_chunk_report() -> list:
    """ptxas's report on the chunk kernel's instantiations in the wrappers'
    build of ``paged_attn.cu``: registers, stack frame, spill stores and
    loads, static shared memory (the tiles are dynamic shared memory: see the
    ``chunk_smem`` of the kernel checks)."""
    import re
    import shutil

    from repro_torch.kernels import _build

    text = _build.ptxas_report(
        _build.CSRC / os.path.basename(SOURCES["paged"])) or ""
    out, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": m.group(1)} if "chunk_attn_kernel" in \
                m.group(1) else None
            if cur is not None:
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            (cur["stack_frame"], cur["spill_stores"],
             cur["spill_loads"]) = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem_static"] = int(sm.group(1)) if sm else 0
    if out and shutil.which("c++filt"):
        names = run(["c++filt", *[r["kernel"] for r in out]]).splitlines()
        for r, name in zip(out, names):
            m = re.search(r"chunk_attn_kernel<[^>]*>", name)
            r["kernel"] = m.group(0) if m else name
    return out


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

    # the lock experiments and the lint run on the host while nvcc builds
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        building = ex.submit(build_all)
        emit({"phase": "locks", **locks_phase()})
        emit({"phase": "build", **building.result()})
    emit({"phase": "ptxas", "source": SOURCES["paged"],
          "chunk_kernels": ptxas_chunk_report()})

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
          "launch_floor_ms": times["launch_floor"]["ms"],
          "load_floor_ms": times["load_floor"]["ms"],
          "chain_floor_ms": times["chain_floor"]["ms"],
          "lease_designs": time_lease_designs(dev),
          "poll_publish_designs": time_poll_publish_designs(dev),
          "scan_designs": time_scan_designs(dev),
          "bound_assumes": "32-byte sectors at the HBM rate, 3.35 TB/s; "
                           "K1-K4, K9, K10: integer operations at 67 "
                           "TOP/s; K5-K8 (bound_ms): operations at the "
                           "bf16 tensor-core rate, 989 TFLOP/s (the least "
                           "time), and (bound_simt_ms) at the float32 "
                           "rate outside the tensor cores, 67 TFLOP/s",
          "times": times})

    emit({"phase": "autotune", "card": card, **autotune_phase(dev)})

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

    kw = dict(n_req=8, prompt_len=16, max_new=16, handlers=handlers,
              slots=slots, max_seq=64, swap_s=0.25, compact_s=0.2,
              seed=args.seed)
    eng = run_engine(cfg, params, dev, **kw)
    eager_eng = _engine_arm(run_engine(cfg, params, dev, eager=True, **kw))
    step = decode_step_ms(cfg, params, dev, batch=slots, max_seq=64)
    emit({"phase": "engine", "card": card, **eng, "eager_engine": eager_eng,
          "decode_step": step})

    sched = run_scheduler(cfg, params, dev, seed=args.seed + 3)
    emit({"phase": "scheduler", "card": card, **sched})
    # the two stores compared on runs without swaps (G2)
    still = run_scheduler(cfg, params, dev, seed=args.seed + 3, swap_s=0)
    qsched = run_scheduler(cfg, params, dev, seed=args.seed + 3,
                           quant_kv=True, swap_s=0)
    emit({"phase": "scheduler_quant", "card": card, **qsched,
          "bf16_without_swaps": {k: still[k] for k in (
              "tokens_per_s", "decode_tick_median_ms", "weight_swaps",
              "launches")},
          "vs_bf16": quant_vs_bf16(still, qsched)})
    esched = run_scheduler(cfg, params, dev, seed=args.seed + 3,
                           n_pages=EVICT_PAGES)
    emit({"phase": "scheduler_evict", "card": card,
          **eviction_summary(esched, sched)})

    emit({"phase": "obs_bench", "card": card,
          **obs_phase(cfg, params, dev)})
    emit({"phase": "scheduler_bench", "card": card,
          **scheduler_bench_phase(cfg, params, dev)})
    emit({"phase": "prefill_bench", "card": card,
          **prefill_bench_phase(cfg, params, dev)})
    emit({"phase": "quant_bench", "card": card,
          **quant_bench_phase(cfg, params, dev)})

    emit({"phase": "slo", "card": card, **slo_phase(cfg, params, dev)})
    param_bytes = sum(x.numel() * x.element_size() for x in _leaves(params))
    os.makedirs(CKPT_DIR, exist_ok=True)
    emit({"phase": "hotswap_disk", "checkpoint_dir": CKPT_DIR,
          "param_bytes": param_bytes,
          "disk_free_bytes": shutil.disk_usage(CKPT_DIR).free})
    try:
        emit({"phase": "hotswap", "card": card,
              **hotswap_phase(cfg, params, dev)})
        emit({"phase": "faults", "card": card,
              **faults_phase(cfg, params, dev)})
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    emit({"phase": "graph_step", "card": card,
          **graph_step_phase(cfg, params, dev, args.seed)})

    emit({"phase": "serve_bravo", "card": card, **serve_bravo_phase(dev)})

    emit({"phase": "tokens", **token_check(cfg, params, dev, n_req=2,
                                           prompt_len=16, max_new=8,
                                           max_seq=64, seed=args.seed + 1)})
    emit({"phase": "precision", **precision_check(
        cfg, params, dev, batch=2, length=24, seed=args.seed + 2),
        "paged": paged_precision(cfg, params, dev, seed=args.seed + 4),
        "paged_quant": paged_precision(cfg, params, dev, seed=args.seed + 4,
                                       quant=True),
        "scheduler_vs_greedy": scheduler_vs_greedy(cfg, params, dev,
                                                   still, sched)})

    del params
    emit({"phase": "families", "card": card, **families_phase(
        dev, args.seed,
        lambda rec: emit({"phase": "family", "card": card, **rec}))})

    emit({"phase": "train", "card": card, **train_phase(
        dev, args.seed,
        lambda rec: emit({"phase": "train_model", "card": card, **rec}))})

    emit({"phase": "mesh", "card": card, **mesh_phase(dev, args.seed)})

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


# ---------------------------------------------------------------------------
# Phase 12, the last: the mesh layer (M12) on one rank a card over NCCL
# ---------------------------------------------------------------------------

# the meshed engine's runs, in order: (arm, swaps): a first graphed run
# that takes the communicators' and kernels' first use, then the graphed
# and the bare steps in turns, under swaps and without
MESH_ENGINE_ARMS = (("warmup", True), ("graph", True), ("bare", True),
                    ("graph", False), ("bare", False))
MESH_KERNELS = ["fused_publish_multi", "fused_publish", "paged_attention",
                "paged_chunk_attention"]
MESH_SWAP_S = 0.15               # the meshed engines' hot-swap period
MESH_HOLDERS = 1000              # readers holding one lock in the revokes
MESH_TRAIN = dict(batch=1, seq=256)   # the gradient tree's train step
MESH_MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MESH_MOE_PREFILL = (4, 64)       # (B, S) through the capacity body
MESH_MOE_DECODE = 8              # tokens through the dropless body
MESH_MOE_REL = 1e-5
# the expert-parallel train step (``_mesh_train``): phi3.5-moe at full
# width cut to one of its 32 layers (a layer's float32 parameters are ~6.3
# GB, its AdamW moments ~12.6 GB; the eager arm holds two trees at once),
# one batch of 4 x 256 tokens a step, 3 steps an arm
MESH_TRAIN_LAYERS = 1
MESH_TRAIN_BATCH = (4, 256)
MESH_TRAIN_STEPS = 3
MESH_TRAIN_REL = 1e-5            # graph against eager
MESH_TRAIN_SAMPLES = 4096        # elements of each leaf compared
MESH_RANK_TIMEOUT_S = 900.0      # a rank process's deadline at N cards
# the sharded train step (``_mesh_sharded``).  One card: llama3.2-1b at
# full width, 2 of its 16 layers, against the unsharded step bit for bit.
# N cards: granite-20b at full width on (data, model) = (2, N / 2), on
# train_4k's sequences (4 x 4096), 2 microbatches (each rank's microbatch
# one sequence, as the train phase's); 2 of its 52 layers against the
# unsharded step on each card at float32 and at bf16 compute, then 16
# layers, whose unsharded train state (~106 GB) does not fit one card,
# eager then graphed
MESH_ONE_ARCH = "llama3.2-1b"
MESH_ONE_LAYERS = 2
MESH_ONE_BATCH = (2, 4096)
MESH_SHARDED_ARCH = "granite-20b"
MESH_SHARDED_CHECK_LAYERS = 2
MESH_SHARDED_LAYERS = 16
MESH_SHARDED_BATCH = (4, 4096)
MESH_SHARDED_MICRO = 2
MESH_SHARDED_STEPS = 3           # steps of each arm at 16 layers
MESH_SHARDED_SAMPLES = 4096      # elements of each block compared
# sharded against unsharded: the loss, the gradient norm, and each update
# within lr * (1e-3 + grad_rel * max|g| / (|g| + eps)) (R14's bound), at
# the full rate from step 1 (the tests' optimizer: at repro's warm-up
# rate, 3e-6 at step 1, the bound falls under a float32 parameter's
# rounding step)
MESH_SHARDED_OPT = dict(lr=1e-3, warmup_steps=0)
MESH_SHARDED_TOL = {"float32": {"loss_rel": 1e-5, "grad_rel": 1e-4},
                    "bfloat16": {"loss_rel": 1e-3, "grad_rel": 1e-2}}


def _mesh_shapes(world: int) -> dict:
    """Each check's mesh on a world of ``world`` ranks (one a card):
    the engine at (data, model) = (2, world / 2), the revokes on
    ("data",) = world and ("pod", "data") = (2, world / 2), the compressed
    all-reduce over ("data",), phi3.5-moe's 16 experts over "model" =
    world, and the train step at (1, world) and (2, world / 2); every one
    at (1, 1) or (1,) on one card."""
    half = (2, world // 2) if world > 1 else (1, 1)
    return {"engine": (half, ("data", "model")),
            "data": ((world,), ("data",)),
            "pod_data": (half, ("pod", "data")),
            "moe": ((1, world), ("data", "model")),
            "train": [((1, world), ("data", "model"))]
            + ([(half, ("data", "model"))] if world > 1 else [])}


def mesh_phase(dev, seed) -> dict:
    """Phase ``mesh``: ``repro``'s meshed paths (M12) on one rank a card
    over NCCL, run last so that no CUDA graph of an earlier phase shares
    the process with a communicator.  On one card the rank runs in this
    process; on ``N = torch.cuda.device_count()`` cards (a four-card
    machine) this process spawns one rank a card, each from the same
    ``file://`` store, and every rank runs the same checks
    (``_mesh_rank``) on the meshes of ``_mesh_shapes(N)``:
    llama3.2-1b's graphed meshed scheduler engine against its bare steps
    in turns, under hot swaps and without (``_mesh_engine``); both
    revokes and the
    registry's meshed revoke (``_mesh_revokes``); ``make_compressed_psum``
    over a train step's gradients (``_mesh_compressed``); the twins' mesh
    sections (``_mesh_twins``); phi3.5-moe's MoE layer with its experts
    over "model" (``_mesh_moe``); the expert-parallel train step eager
    and graphed (``_mesh_train``).  Then the checks across ranks: every
    rank's tokens, graph stats, losses and sampled parameters equal.  An
    NCCL failure, a rank that fails or outlives ``MESH_RANK_TIMEOUT_S``,
    or any failed check raises."""
    import tempfile

    import torch

    t0 = time.monotonic()
    world = torch.cuda.device_count() if dev.type == "cuda" else 1
    if world == 1:
        with tempfile.TemporaryDirectory() as d:
            recs = [_mesh_rank(dev, 0, 1, d, seed)]
    else:
        recs = _mesh_spawn(world, seed)
    out = _mesh_across(recs)
    out["seconds"] = time.monotonic() - t0
    return out


def _mesh_spawn(world: int, seed: int) -> list:
    """One process a card, rank ``r`` on card ``r``, each running
    ``_mesh_rank_main``; -> their records in rank order.  The kernels are
    built (``build_all``) before, so the ranks load them.  Every process
    is gone when this returns."""
    import tempfile

    code = ("import sys; sys.path[:0] = [{root!r}, {src!r}]; "
            "import chip_smoke; chip_smoke._mesh_rank_main(*sys.argv[1:])"
            ).format(root=ROOT, src=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory() as d:
        procs = []
        try:
            for r in range(world):
                log = open(os.path.join(d, f"rank{r}.log"), "w")
                procs.append((subprocess.Popen(
                    [sys.executable, "-c", code, str(r), str(world), d,
                     str(seed)], stdout=log, stderr=subprocess.STDOUT),
                    log))
            deadline = time.monotonic() + MESH_RANK_TIMEOUT_S
            paths = [os.path.join(d, f"rank{r}.json") for r in range(world)]
            while not all(map(os.path.exists, paths)):
                bad = [r for r, (p, _) in enumerate(procs)
                       if p.poll() not in (None, 0)]
                if bad or time.monotonic() > deadline:
                    for p, _ in procs:
                        p.kill()
                    tails = {}
                    for r, (p, log) in enumerate(procs):
                        log.flush()
                        with open(log.name) as f:
                            tails[r] = f.read()[-6000:]
                    raise AssertionError(
                        f"mesh: rank(s) {bad or 'all'} failed or timed out "
                        f"at {world} ranks: {json.dumps(tails)}")
                time.sleep(1.0)
            recs = []
            for path in paths:
                with open(path) as f:
                    recs.append(json.load(f))
            # the records are written: a rank still tearing its
            # communicators down after a grace period is stopped
            for p, _ in procs:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
            return recs
        finally:
            for p, log in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()


def _mesh_rank_main(rank, world, store_dir, seed) -> None:
    """A rank process of ``_mesh_spawn``: card ``rank``, TF32 off as
    ``main`` sets it; its record goes to ``store_dir/rank<r>.json``."""
    import torch

    rank, world, seed = int(rank), int(world), int(seed)
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        rec = _mesh_rank(dev, rank, world, store_dir, seed)
    except BaseException:
        # the peers may wait in a collective for this rank: exit at once,
        # so that ``_mesh_spawn`` sees a dead rank and stops the others
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    path = os.path.join(store_dir, f"rank{rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(rec, f)
    os.replace(path + ".tmp", path)


def _mesh_rank(dev, rank, world, store_dir, seed) -> dict:
    """Every check of the phase (``_mesh_checks``) on this rank of a world
    of ``world`` over NCCL started from ``store_dir``, torn down after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world

    backend = init_world(store_dir, rank, world, device=dev)
    try:
        if dev.type == "cuda" and backend != "nccl":
            raise AssertionError(f"mesh: backend {backend}, not nccl")
        rec = _mesh_checks(dev, seed)
    except BaseException:
        # tearing the process group down waits for the peers' collectives:
        # a failed rank of several leaves it to its process's exit
        if world == 1:
            dist.destroy_process_group()
        raise
    dist.destroy_process_group()
    return rec


def _mesh_checks(dev, seed) -> dict:
    """Every check of the phase on this rank of the running world, on the
    meshes of ``_mesh_shapes``."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import llama3_2_1b
    from repro_torch.dist import sharding as DS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M

    cfg = llama3_2_1b.CONFIG
    world = dist.get_world_size()
    shapes = _mesh_shapes(world)
    out = {"rank": dist.get_rank()}
    mesh = make_mesh(*shapes["engine"], device=dev)
    out["world"] = {"backend": dist.get_backend(), "ranks": world,
                    "nccl": str(torch.cuda.nccl.version()),
                    "meshes": {k: (list(map(list, v)) if k != "train"
                                   else [list(map(list, s)) for s in v])
                               for k, v in shapes.items()}}
    params = M.init_params(seed, cfg, device=dev)
    params["embed"].mul_(EMBED_SCALE)
    DS.reset_collective_counts()
    out["engine"] = _mesh_engine(cfg, params, dev, mesh, seed)
    out["controller"] = _mesh_controller(
        *((cfg, params) if world > 1 else
          _first_layers(cfg, params, MESH_HANDLER_ONE_LAYERS)), dev, mesh)
    data = make_mesh(*shapes["data"], device=dev)
    out["revokes"] = {
        "data": _mesh_revokes(dev, data, ("data",)),
        "pod_data": _mesh_revokes(dev, make_mesh(*shapes["pod_data"],
                                                 device=dev),
                                  ("pod", "data"))}
    out["compressed"] = _mesh_compressed(cfg, params, dev, data, seed)
    out["twins"] = _mesh_twins(cfg, params, dev)
    del params
    torch.cuda.empty_cache()
    out["handler"] = [
        _mesh_handler(dev, make_mesh(*shapes[key], device=dev), arch,
                      depth if world > 1 else MESH_HANDLER_ONE_LAYERS, seed)
        for arch, depth, key in MESH_HANDLER
        if world > 1 or arch in MESH_HANDLER_ONE]
    out["moe"] = _mesh_moe(dev, make_mesh(*shapes["moe"], device=dev),
                           seed)
    out["train"] = [_mesh_train(dev, make_mesh(*s, device=dev), seed)
                    for s in shapes["train"]]
    out["sharded"] = _mesh_sharded(dev, mesh, seed)
    out["sharded_serve"] = _mesh_sharded_serve(dev, mesh, seed)
    out["collectives"] = DS.collective_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    for kind in ("all_reduce", "all_gather", "all_to_all"):
        if not out["collectives"].get(kind):
            raise AssertionError(f"mesh: no {kind} ran: "
                                 f"{out['collectives']}")
    return out


def _mesh_across(recs) -> dict:
    """The checks across the ranks' records: each engine arm's tokens and
    graph stats, each train step's losses and sampled parameters, the
    same on every rank.  -> rank 0's record, each rank's collectives and
    timings beside it."""
    first = recs[0]
    for r in recs[1:]:
        for a, b in zip(first["engine"]["runs"], r["engine"]["runs"]):
            for k in ("outputs", "steps"):
                if a[k] != b[k]:
                    raise AssertionError(
                        f"mesh: the {a['arm']} engine's {k} differ between "
                        f"rank 0 and rank {r['rank']}: {a[k]} / {b[k]}")
        for a, b in zip(first["train"], r["train"]):
            for k in ("losses", "samples"):
                if a[k] != b[k]:
                    raise AssertionError(
                        f"mesh: the train step's {k} at {a['mesh']} differ "
                        f"between rank 0 and rank {r['rank']}")
        _handler_across(first, r)
        a, b = first["controller"]["replays"], r["controller"]["replays"]
        for x, y in zip(a, b):
            for k in ("decisions", "outputs", "final_slot_cap"):
                if x[k] != y[k]:
                    raise AssertionError(
                        f"mesh.controller: the {x['label']} replay's {k} "
                        f"differ between rank 0 and rank {r['rank']}: "
                        f"{x[k]} / {y[k]}")
        for k in ("losses", "grad_norms"):
            if "deep" not in first["sharded"]:
                break
            a, b = first["sharded"]["deep"][k], r["sharded"]["deep"][k]
            if a != b:
                raise AssertionError(
                    f"mesh: the sharded step's {k} differ between rank 0 "
                    f"and rank {r['rank']}: {a} / {b}")
    rows = {}                      # decode_32k's tokens by data coordinate
    for r in recs:
        full = r["sharded_serve"].get("decode_32k")
        if full is None:
            continue
        rank, tokens = rows.setdefault(full["coords"]["data"],
                                       (r["rank"], full["tokens"]))
        if tokens != full["tokens"]:
            raise AssertionError(
                f"mesh: decode_32k's tokens differ between ranks {rank} and "
                f"{r['rank']}, which share their rows")
    out = dict(first)
    out["engine"] = dict(first["engine"])
    out["engine"].pop("outputs", None)
    for rec in out["engine"]["runs"]:
        rec.pop("outputs", None)
    out["train"] = [{k: v for k, v in t.items() if k != "samples"}
                    for t in first["train"]]
    out["handler"] = [{**h, "runs": [{k: v for k, v in run.items()
                                      if k != "outputs"}
                                     for run in h["runs"]],
                       "float32": {k: v for k, v in h["float32"].items()
                                   if k != "outputs"}}
                      for h in first["handler"]]
    out["controller"] = {**first["controller"], "replays": [
        {k: v for k, v in x.items() if k != "outputs"}
        for x in first["controller"]["replays"]]}
    out["ranks_equal"] = True
    out["per_rank"] = [{"rank": r["rank"], "collectives": r["collectives"],
                        "engine_tokens_per_s": [x["tokens_per_s"] for x in
                                                r["engine"]["runs"]],
                        "train_ms": [t["ms"] for t in r["train"]],
                        "handler": [{
                            "config": h["config"],
                            "tokens_per_s": [x["tokens_per_s"]
                                             for x in h["runs"]],
                            "decode_step_ms": {
                                a: h["decode_step"][a]["median_ms"]
                                for a in ("mesh", "one")},
                            "seconds": h["seconds"]} for h in r["handler"]],
                        "controller": {
                            "p99_ttft_ms": [x["p99_ttft_ms"] for x in
                                            r["controller"]["replays"]],
                            "seconds": r["controller"]["seconds"]},
                        "sharded": _sharded_rank_summary(r["sharded"]),
                        "sharded_serve": _serve_rank_summary(
                            r["sharded_serve"])}
                       for r in recs]
    out["sharded_serve"] = dict(first["sharded_serve"])
    if "decode_32k" in out["sharded_serve"]:
        out["sharded_serve"]["decode_32k"] = {
            k: v for k, v in first["sharded_serve"]["decode_32k"].items()
            if k != "tokens"}
    return out


def _handler_across(first, r) -> None:
    """``mesh.handler`` across ranks: each run's tokens, graph decisions
    (warm-ups, captures, replays and the calls they came on) and the
    turn at which each swap landed, the same on rank 0 and ``r``."""
    def graphs(run):
        g = run["graphs"]
        return g and {name: {kind: {k: v for k, v in st.items()
                                    if k != "capture_ms"}
                             for kind, st in steps.items()}
                      for name, steps in g["steps"].items()}
    for h0, h1 in zip(first["handler"], r["handler"]):
        if h0["float32"]["outputs"] != h1["float32"]["outputs"]:
            raise AssertionError(
                f"mesh.handler: {h0['config']}'s float32 run: the outputs "
                f"differ between rank 0 and rank {r['rank']}")
        for a, b in zip(h0["runs"], h1["runs"]):
            for k, x, y in (("outputs", a["outputs"], b["outputs"]),
                            ("swap turns", a["swap_turns"], b["swap_turns"]),
                            ("graph decisions", graphs(a), graphs(b))):
                if x != y:
                    raise AssertionError(
                        f"mesh.handler: {h0['config']}'s {a['arm']} run "
                        f"(swaps {a['swaps']}): the {k} differ between rank "
                        f"0 and rank {r['rank']}: {x} / {y}")


def _sharded_rank_summary(rec) -> dict:
    """A rank's own readings of the sharded step: its coordinates, stored
    bytes, step times and peak memory."""
    deep = rec.get("deep")
    if deep is None:
        return {"seconds": rec["seconds"]}
    return {"coords": deep["coords"], "stored_bytes": deep["stored_bytes"],
            "ms": deep["ms"], "capture_ms": deep["graph_stats"][
                "capture_ms"], "peak_allocated": deep["peak_allocated"],
            "checks_ms": {k: rec[k]["ms"] for k in ("check_float32",
                                                    "check_bfloat16")}}


def _serve_rank_summary(rec) -> dict:
    """A rank's own readings of the sharded serving steps: decode_32k's
    coordinates, stored cache bytes, step times and peaks, and
    prefill_32k's ms and peak."""
    full, long = rec.get("decode_32k"), rec.get("prefill_32k")
    if full is None:
        return {"seconds": rec["seconds"]}
    return {"coords": full["coords"],
            "stored_cache_bytes": full["stored_cache_bytes"],
            "decode_ms": full["ms"], "decode_event_ms": full["event_ms"],
            "capture_ms": full["graph_stats"]["capture_ms"],
            "decode_peak_allocated": full["peak_allocated"],
            "prefill_32k_ms": long["ms"],
            "prefill_32k_peak_allocated": long["peak_allocated"],
            "seconds": {k: rec[k]["seconds"] for k in (
                "check_float32", "check_bfloat16", "decode_32k",
                "prefill_32k")}}


def _mesh_engine(cfg, params, dev, mesh, seed) -> dict:
    """llama3.2-1b's scheduler engine on ``mesh`` with ``MeshRules()``,
    its graphed steps and its bare ones (``smoke.eager_steps``), the runs
    of ``MESH_ENGINE_ARMS`` on ``run_scheduler``'s first wave (every
    request queued before the engine starts), under swaps of the final
    norm every ``MESH_SWAP_S`` s (``_swap_final_norm``) or none.  Every
    run's tokens are held to the dense loop, teacher-forced within
    ``BF16_VS_F32_REL`` of its best at every step; the graphed runs
    launch K1/K2/K5/K6, warm up, capture and replay, and under swaps land
    at least one; without swaps the graphed tokens equal the bare ones."""
    import dataclasses

    import torch

    from repro_torch.benchmarks.smoke import eager_steps, hold_tokens
    from repro_torch.dist.sharding import MeshRules
    from repro_torch.kernels import ops as K
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.serving.scheduler import SchedulerConfig

    prompts = _sched_prompts(seed + 3, cfg.vocab)[0]
    runs = []
    for arm, swaps in MESH_ENGINE_ARMS:
        eng = ServingEngine(cfg, params, n_pages=SCHED_PAGES, device=dev,
                            scheduler=SchedulerConfig(**SCHED), mesh=mesh,
                            rules=MeshRules())
        if arm == "bare":
            eager_steps(eng)
        reqs = [Request(rid=i, prompt=p, max_new=16)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t = time.monotonic()
        eng.start(swap_period_s=MESH_SWAP_S if swaps else 0.0,
                  perturb=_swap_final_norm)
        try:
            for r in reqs:
                while not r.done.wait(timeout=1.0):
                    eng.check_health()
                    if time.monotonic() - t > 600:
                        raise AssertionError(
                            f"mesh: request {r.rid} timed out")
            wall = time.monotonic() - t
        finally:
            eng.stop()
        counts = K.launch_counts()
        steps = {name: dataclasses.asdict(getattr(eng, f"_{name}_paged")
                                          .stats)
                 if arm != "bare" else None
                 for name in ("decode", "prefill")}
        for st in filter(None, steps.values()):
            st.pop("capture_ms")             # host time, not the rank's own
        runs.append({"arm": arm, "swaps": swaps, "wall_s": wall,
                     "tokens_per_s": 16 * len(reqs) / wall,
                     "weight_swaps": eng.stats.weight_swaps,
                     "launches": {k: counts[k] for k in MESH_KERNELS},
                     "steps": steps,
                     "outputs": [r.out.tolist() for r in reqs]})
    # every arm's tokens in one call, so a (prompt, tokens) pair that two
    # arms share is forced once
    hold = hold_tokens(cfg, params, dev, prompts * len(runs),
                       [o for r in runs for o in r["outputs"]], 16,
                       BF16_VS_F32_REL, max_seq=SCHED["max_seq"])
    if not hold["ok"]:
        raise AssertionError(f"mesh: the engines' tokens: {hold}")
    for r in runs:
        if r["arm"] == "bare":
            continue
        st = r["steps"]["decode"]
        if dev.type == "cuda" and not (all(r["launches"].values())
                                       and st["captures"] >= 1
                                       and st["replays"] >= 1
                                       and (r["weight_swaps"] >= 1)
                                       == r["swaps"]):
            raise AssertionError(f"mesh: the graphed engine: {r}")
    still = [r["outputs"] for r in runs if not r["swaps"]]
    if still[0] != still[1]:
        raise AssertionError("mesh: without swaps the graphed engine's "
                             "tokens differ from the bare steps'")
    return {"requests": len(prompts), "max_new": 16,
            "swap_period_s": MESH_SWAP_S,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "tokens_held": True, "near_tie_rel": BF16_VS_F32_REL,
            "max_deficit_rel": hold["max_deficit_rel"],
            "flips": sum(hold["flips"]), "runs": runs}


# the meshed engine's handler mode (``_mesh_handler``): (config, layers on
# N cards, the mesh of ``_mesh_shapes``).  phi3.5-moe at full width and
# half its depth (~42 GB of bf16, whole on each rank, as ``repro``'s
# handler mode holds the tree; the families phase's reading at 16 layers
# was taken at this depth), its 16 experts over "model"; rwkv6-7b, whose
# handler path issues no collective, checks the agreement alone, so it
# runs only across cards.  On one card phi3.5-moe runs at
# MESH_HANDLER_ONE_LAYERS (8.4 s there on an H100 80GB HBM3 at 700 W,
# rwkv6-7b 10.4)
MESH_HANDLER = (("phi3.5-moe-42b-a6.6b", 16, "moe"), ("rwkv6-7b", 4, "engine"))
MESH_HANDLER_ONE = ("phi3.5-moe-42b-a6.6b",)
MESH_HANDLER_ONE_LAYERS = 2
# (arm, swaps), in order: graphed and then bare under swaps, then once
# each without
MESH_HANDLER_ARMS = (("graph", True), ("bare", True), ("graph", False),
                     ("bare", False))
MESH_HANDLER_SWAP_S = 0.25
MESH_HANDLER_LOAD = dict(n_req=8, prompt_len=16, max_new=16, handlers=2,
                         slots=4, max_seq=64)
# the latency controller on a mesh (``_mesh_controller``): the requests of
# each replay held to the dense loop
MESH_CTRL_HELD = 4
MESH_CTRL_KERNELS = ["fused_publish_multi", "fused_publish",
                     "paged_attention", "paged_chunk_attention"]


def _mesh_handler(dev, mesh, arch, depth, seed) -> dict:
    """``arch`` at full width and ``depth`` layers in handler mode on
    ``mesh`` under its config's rules: ``MESH_HANDLER_LOAD`` (2 handlers
    x 4 slots, 8 requests of 16 + 16 tokens) for each arm of
    ``MESH_HANDLER_ARMS``, under swaps of the final norm every
    ``MESH_HANDLER_SWAP_S`` s (``_swap_final_norm``) or none; then the
    same load graphed without swaps at float32 compute; then the B = 4
    decode step on the mesh and the same tree's unmeshed step on this
    card in turns (``_mesh_decode_step``).  Gates: K1-K4 launched in
    every run (K4 by the drain check after ``stop()``: nothing held, every
    page free); every graphed handler call a warm-up or a replay
    (``_handler_graphs``) and, under swaps, one landed; without swaps the
    graphed tokens equal the bare ones; the float32 run's tokens
    teacher-forced within ``MESH_MOE_REL`` of the unmeshed greedy loop at
    float32 compute on this card (``_handler_forced``: at the engine's
    batches, so that only the mesh changes the computation); without an
    MoE layer, every bf16 run's tokens teacher-forced within
    ``BF16_VS_F32_REL`` of it.  With one, the bf16 runs' deficit is
    recorded, not gated: a top-k routing decision flips on a rounding, so
    bf16 sums in another order can stand further from the loop's best
    than the near-tie of a dense model (on four H100 80GB HBM3 at 700 W,
    phi3.5-moe at 16 layers on (1, 4): 0.052 against the loop one
    request at a time, the unmeshed engine 0.021).
    ``_mesh_across`` holds the tokens, graph stats and each swap's turn
    equal on every rank."""
    import dataclasses

    import torch

    from repro_torch import configs

    t0 = time.monotonic()
    cfg, params, init_s = _family_params(arch, depth, dev, seed)
    rules = configs.get(arch)[1]
    load = MESH_HANDLER_LOAD
    prompts = _prompts(seed, load["n_req"], load["prompt_len"], cfg.vocab)
    runs = [_handler_run(cfg, params, dev, mesh, rules, prompts, arm, swaps)
            for arm, swaps in MESH_HANDLER_ARMS]
    still = [r["outputs"] for r in runs if not r["swaps"]]
    if still[0] != still[1]:
        raise AssertionError(f"mesh.handler: {cfg.name}: without swaps the "
                             f"graphed tokens differ from the bare ones")

    moe = cfg.family == "moe"
    hold = _handler_forced(cfg, params, dev, prompts,
                           [r["outputs"] for r in runs])
    if not moe and hold["max_deficit_rel"] > BF16_VS_F32_REL:
        raise AssertionError(f"mesh.handler: {cfg.name}: the tokens: {hold}")
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    f32 = _handler_run(cfg32, params, dev, mesh, rules, prompts, "graph",
                       False)
    hold32 = _handler_forced(cfg32, params, dev, prompts, [f32["outputs"]])
    if hold32["max_deficit_rel"] > MESH_MOE_REL:
        raise AssertionError(f"mesh.handler: {cfg.name} at float32 "
                             f"compute: the tokens: {hold32}")
    step = _mesh_decode_step(cfg, params, dev, mesh, rules,
                             batch=load["slots"], max_seq=load["max_seq"])
    del params
    torch.cuda.empty_cache()
    return {"config": cfg.name, "layers": cfg.n_layers,
            "published_layers": configs.get(arch)[0].n_layers,
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "rules": repr(rules), "init_s": init_s, **load,
            "swap_period_s": MESH_HANDLER_SWAP_S,
            "bf16": {"gated": not moe, "near_tie_rel": BF16_VS_F32_REL,
                     **hold},
            "float32": {"near_tie_rel": MESH_MOE_REL, **hold32,
                        "tokens_per_s": f32["tokens_per_s"],
                        "outputs": f32["outputs"]},
            "runs": runs, "decode_step": step,
            "seconds": time.monotonic() - t0}


def _handler_forced(cfg, params, dev, prompts, runs) -> dict:
    """The unmeshed greedy loop on this card fed each run's tokens
    (``runs``: each a list of outputs for ``prompts``): the requests cut in
    queue order into ``MESH_HANDLER_LOAD``'s batches, as the engine deals
    them, each batch through an unmeshed handler decode step and cache
    tree as the engine makes them (bare), its prompts left-padded and fed
    token by token, then the run's tokens.  -> the steps whose token is not
    the loop's best (``flips``) and the largest ``smoke.deficit_rel``."""
    import torch

    from repro_torch.benchmarks import smoke as SM
    from repro_torch.serving.engine import ServingEngine

    load = MESH_HANDLER_LOAD
    B = load["slots"]
    eng = SM.eager_steps(ServingEngine(cfg, params, handlers=1,
                                       slots_per_handler=B,
                                       max_seq=load["max_seq"], device=dev))
    flips, worst = 0, 0.0
    for outs in runs:
        for i in range(0, len(prompts), B):
            ps, got = prompts[i:i + B], outs[i:i + B]
            hs = eng._handler_steps(0, len(ps))
            S = max(len(p) for p in ps)
            toks = torch.zeros((len(ps), S), dtype=torch.int32)
            for j, p in enumerate(ps):
                toks[j, S - len(p):] = torch.as_tensor(p)   # left-pad
            toks = toks.to(dev)
            cur = toks[:, :1]
            for step in range(S - 1 + max(len(g) for g in got)):
                clen = torch.full((len(ps),), step + 1, dtype=torch.int32,
                                  device=dev)
                _, lg, hs.caches = hs.decode(params, hs.caches, cur, clen)
                if step + 1 < S:
                    cur = toks[:, step + 1:step + 2]
                    continue
                k = step + 1 - S
                forced = [g[k] for g in got]
                lg = lg.float().cpu()
                for j, t in enumerate(forced):
                    flips += int(lg[j].argmax()) != t
                    worst = max(worst, SM.deficit_rel(lg[j], t))
                cur = torch.tensor(forced, dtype=torch.int32,
                                   device=dev)[:, None]
    eng.stop()
    return {"flips": flips, "max_deficit_rel": worst}


def _handler_run(cfg, params, dev, mesh, rules, prompts, arm, swaps) -> dict:
    """One run of ``_mesh_handler``: ``MESH_HANDLER_LOAD`` on ``prompts``
    through the graphed (``arm="graph"``) or bare steps on ``mesh``
    (None: this card alone), hot swaps on or off; the launch counts set to
    0 just before the engine starts and read after the drain check."""
    import torch

    from repro_torch.benchmarks import smoke as SM
    from repro_torch.kernels import ops as K
    from repro_torch.serving.engine import Request, ServingEngine

    load = MESH_HANDLER_LOAD
    eng = ServingEngine(cfg, params, handlers=load["handlers"],
                        slots_per_handler=load["slots"],
                        max_seq=load["max_seq"], device=dev, mesh=mesh,
                        rules=rules)
    if arm == "bare":
        SM.eager_steps(eng)
    reqs = [Request(rid=i, prompt=p, max_new=load["max_new"])
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t = time.monotonic()
    eng.start(swap_period_s=MESH_HANDLER_SWAP_S if swaps else 0.0,
              perturb=_swap_final_norm)
    try:
        _wait_requests(eng, reqs, t, "mesh.handler")
        wall = time.monotonic() - t
    finally:
        eng.stop()
    # the table drained (K4 over the model lock and the page stripes) and
    # every page free, as ``run_engine`` holds them
    held = eng.registry.held_multi([eng.store.leases] + eng.kv_pool.locks)
    counts = K.launch_counts()
    st = eng.lock_stats()
    if held.any() or len(eng.pages.free) != eng.kv_pool.n_pages:
        raise AssertionError(f"mesh.handler: {cfg.name}: leases held "
                             f"{held.tolist()} or pages not free")
    run = {"arm": arm, "swaps": swaps, "wall_s": wall,
           "tokens_per_s": load["max_new"] * len(reqs) / wall,
           "weight_swaps": eng.stats.weight_swaps,
           "swap_turns": list(eng.swap_at),
           "launches": {k: counts[k] for k in TABLE_KERNELS},
           "graphs": _handler_graphs(st, dev) if arm == "graph" else None,
           "outputs": [r.out.tolist() for r in reqs]}
    if dev.type == "cuda" and not (
            all(run["launches"].values())
            and (arm == "bare" or (run["weight_swaps"] >= 1) == swaps)):
        raise AssertionError(f"mesh.handler: {cfg.name}: {run}")
    return run


def _first_layers(cfg, params, n):
    """A dense config cut to its first ``n`` layers, and its parameters'
    views of them."""
    import dataclasses

    return (dataclasses.replace(cfg, n_layers=n),
            {**params, "layers": {k: {name: x[:n] for name, x in v.items()}
                                  for k, v in params["layers"].items()}})


def _wait_requests(eng, reqs, t, what) -> None:
    """Wait for every request of a run started at ``t``, raising a
    worker's death at once."""
    for r in reqs:
        while not r.done.wait(timeout=1.0):
            eng.check_health()
            if time.monotonic() - t > 600:
                raise AssertionError(f"{what}: request {r.rid} timed out")


def _mesh_decode_step(cfg, params, dev, mesh, rules, batch, max_seq) -> dict:
    """Handler mode's decode step at ``batch`` rows on ``mesh`` (a handler
    thread's graphed step, its decisions agreed across the ranks) and the
    same tree's unmeshed graphed step on this card, timed in turns as
    ``decode_step_ms`` times its arms (``_decode_in_turns``: the order
    one, mesh, mesh, one, ...).  Whether their tokens stay equal is
    recorded (the expert-parallel MoE sums its experts in another
    order)."""
    import dataclasses

    from repro_torch.serving.engine import ServingEngine

    engs = {"one": ServingEngine(cfg, params, handlers=1,
                                 slots_per_handler=batch, max_seq=max_seq,
                                 device=dev),
            "mesh": ServingEngine(cfg, params, handlers=1,
                                  slots_per_handler=batch, max_seq=max_seq,
                                  device=dev, mesh=mesh, rules=rules)}
    arms = {a: e._handler_steps(0, batch) for a, e in engs.items()}
    out, _, tokens = _decode_in_turns(arms, params, dev, batch, cfg.vocab)
    toks = tokens()
    for a, hs in arms.items():
        out[a]["graph_steps"] = dataclasses.asdict(hs.decode.stats)
    for e in engs.values():
        e.stop()
    out["tokens_equal"] = toks["mesh"] == toks["one"]
    return out


def _mesh_controller(cfg, params, dev, mesh) -> dict:
    """llama3.2-1b's graphed scheduler engine on ``mesh`` with the latency
    controller on: the ``slo`` twin's seeded burst trace, calibrated and
    replayed as the twin replays it (``SLO.controller_config`` on this
    mesh's uncontended readings), its arrivals compressed by the least of
    ``SLO.OVERLOAD_SPEEDS`` at which a static replay on the mesh is
    overloaded (rank 0's reading decides, agreed over a gloo group), then
    one static and one closed-loop replay in turns.  Rank 0's controller
    decides, on rank 0's clock.  Gates: at least one decision; no request
    dropped; K1, K2, K5 and K6 launched in each replay; the first
    ``MESH_CTRL_HELD`` requests of each replay teacher-forced within
    ``BF16_VS_F32_REL`` of the dense loop.  ``_mesh_across`` holds every
    rank's decision log (tick, decision, slot cap, watermark) and tokens
    equal.  p99 TTFT, goodput and the band are recorded, not gated."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.benchmarks import slo as SLO
    from repro_torch.benchmarks import smoke as SM
    from repro_torch.dist.sharding import MeshRules
    from repro_torch.kernels import ops as K

    t0 = time.monotonic()
    rules = MeshRules()
    many = math.prod(mesh.shape) > 1
    group = dist.new_group(backend="gloo") if many else None
    cc = SLO.controller_config(*SLO.calibrate_targets_ms(
        cfg, params, dev, mesh=mesh, rules=rules))
    _, trace = SLO._trace(cfg, True)
    last = max(t.at_s for t in trace.requests)
    probes, speed = [], None
    for s in SLO.OVERLOAD_SPEEDS:
        run = SLO._run(cfg, params, dev, trace, None, label="overload probe",
                       speed=s, mesh=mesh, rules=rules)
        over = [run["wall_s"] >= SLO.OVERLOAD_RATIO * last / s]
        if many:
            dist.broadcast_object_list(over, src=0, group=group)
        probes.append({"speed": s, "span_s": last / s,
                       "wall_s": run["wall_s"], "overloaded": over[0]})
        if over[0]:
            speed = s
            break
    if speed is None:
        raise AssertionError(f"mesh.controller: no speed overloads the "
                             f"meshed engine: {probes}")
    replays = []
    for arm, ctrl in (("static", None), ("closed_loop", cc)):
        K.reset_launch_counts()
        run = SLO._run(cfg, params, dev, trace, ctrl, label=arm, speed=speed,
                       mesh=mesh, rules=rules)
        counts = K.launch_counts()
        eng = run["engine"]
        rec = {**SLO._summary(run, arm),
               "launches": {k: counts[k] for k in MESH_CTRL_KERNELS},
               "decisions": [list(d) for d in eng.ctrl_log],
               "final_slot_cap": eng.scheduler.stats().get("slot_cap"),
               "outputs": [r.out.tolist() for r in run["reqs"]]}
        replays.append(rec)
        if rec["dropped"] or (dev.type == "cuda"
                              and not all(rec["launches"].values())):
            raise AssertionError(f"mesh.controller: the {arm} replay: "
                                 f"{ {k: rec[k] for k in ('dropped', 'launches')} }")
    if not replays[1]["decisions"]:
        raise AssertionError("mesh.controller: the controller made no "
                             "decision")
    holds = [SM.hold_tokens(cfg, params, dev, [tr.prompt], [r["outputs"][i]],
                            tr.max_new, BF16_VS_F32_REL, max_seq=64)
             for r in replays
             for i, tr in enumerate(trace.requests[:MESH_CTRL_HELD])]
    if not all(h["ok"] for h in holds):
        raise AssertionError(f"mesh.controller: the tokens: {holds}")
    st, cl = replays
    return {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "controller": dataclasses.asdict(cc), "speed": speed,
            "probes": probes, "requests": len(trace.requests),
            "replays": replays, "decisions": len(cl["decisions"]),
            "band_held": SLO.band_held(st["p99_ttft_ms"], cl["p99_ttft_ms"],
                                       st["goodput_tok_per_s"],
                                       cl["goodput_tok_per_s"]),
            "band_gated": False, "clock": "rank 0",
            "tokens_held": True, "held": len(holds),
            "near_tie_rel": BF16_VS_F32_REL,
            "max_deficit_rel": max(h["max_deficit_rel"] for h in holds),
            "seconds": time.monotonic() - t0}


def _mesh_revokes(dev, mesh, axes) -> dict:
    """Both revokes over ``axes`` with ``MESH_HOLDERS`` readers holding
    one lock of a registry (a 4096-slot, 16 KB table, the same on every
    rank, each rank scanning its rows), then the registry's own revoke
    through ``configure_mesh`` once they have released."""
    import numpy as np
    import torch

    from repro_torch.core import device_bravo as DB
    from repro_torch.core import registry as RG
    from repro_torch.kernels import ops as K

    reg = RG.BravoRegistry(device=dev)
    hs = [reg.alloc(f"mesh{i}") for i in range(4)]
    h = hs[2]
    ids = torch.arange(MESH_HOLDERS, dtype=torch.int32, device=dev)
    granted = h.acquire(ids)
    held = int(granted.sum())
    table = reg.table.cpu().numpy()
    want = int((table == h.lock_id).sum())
    k3 = int(K.revocation_poll(reg.table, h.lock_id))
    axis = axes[0] if len(axes) == 1 else axes
    dist_count = int(DB.make_distributed_revoke(mesh, axis)(reg.table, h))
    rb0 = reg.rbias.cpu().numpy()
    torch.cuda.synchronize()
    t = time.perf_counter()
    rb, shard_count = RG.make_sharded_revoke(mesh, axes)(
        reg.table, reg.rbias, h)
    rb = rb.cpu().numpy()
    ms = (time.perf_counter() - t) * 1e3
    other = np.arange(rb0.size) != h.idx
    if not (dist_count == int(shard_count) == k3 == want == held > 0):
        raise AssertionError(f"mesh: revoke counts {dist_count}, "
                             f"{int(shard_count)}; K3 {k3}; numpy {want}; "
                             f"granted {held}")
    if rb[h.idx] != 0 or not (rb[other] == rb0[other]).all():
        raise AssertionError("mesh: the sharded revoke's rbias")
    h.release(ids, granted)
    reg.configure_mesh(mesh, axes)
    scans = h.revoke()
    lane = int(reg.rbias[h.idx])
    if lane != 0 or h.held() != 0:
        raise AssertionError(f"mesh: registry revoke left lane {lane}, "
                             f"held {h.held()}")
    return {"axes": list(axes),
            "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
            "table_slots": int(table.size), "holders": MESH_HOLDERS,
            "granted": held, "distributed_count": dist_count,
            "sharded_count": int(shard_count), "k3_count": k3,
            "numpy_count": want, "lane_cleared": True,
            "sharded_revoke_ms": ms, "registry_revoke_scans": scans}


def _mesh_compressed(cfg, params, dev, mesh, seed) -> dict:
    """``make_compressed_psum`` over ("data",) on every leaf of one train
    step's gradients (``MESH_TRAIN``), each against the leaf functions:
    every rank holds the same leaf (rank 0's, broadcast), so the mean of
    the ranks' payloads is ``decompress(N q, scale, N) / N``."""
    import torch
    import torch.distributed as dist

    from repro_torch.ft.checkpoint import tree_flatten
    from repro_torch.ft.compression import (compress_grads_int8,
                                            decompress_grads_int8,
                                            make_compressed_psum)
    from repro_torch.training import train_step as TT

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    B, S = MESH_TRAIN["batch"], MESH_TRAIN["seq"]
    batch = {k: torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    loss, grads = TT._make_compute_grads(cfg, TT.TrainConfig(remat="full"))(
        params, batch)
    fn = make_compressed_psum(mesh, ("data",))
    n = mesh.shape[0]
    group = mesh.get_group("data")
    leaves = tree_flatten(grads)[0]
    count, ms = 0, 0.0
    for leaf in leaves:
        err = 1e-3 * torch.randn(leaf.shape, generator=g, device=dev)
        if n > 1:
            dist.broadcast(leaf, dist.get_global_rank(group, 0),
                           group=group)
        torch.cuda.synchronize()
        t = time.perf_counter()
        mean, new_err = fn(leaf, err)
        torch.cuda.synchronize()
        ms += (time.perf_counter() - t) * 1e3
        q, scale, want_err = compress_grads_int8(leaf, err)
        want = decompress_grads_int8(q.to(torch.int32) * n, scale, n) / n
        if not (torch.equal(mean, want) and torch.equal(new_err, want_err)):
            raise AssertionError("mesh: compressed psum differs from the "
                                 "leaf functions")
        count += leaf.numel()
    return {"ranks": n, "leaves": len(leaves), "elements": count,
            "loss": float(loss), "exact": True, "ms": ms}


def _mesh_twins(cfg, params, dev) -> dict:
    """The twins' mesh sections: ``scheduler.bench_mesh2d`` at (1, 1, 1)
    (teacher-forced within ``BF16_VS_F32_REL``, as the twin's full-width
    phase), on one rank only (its mesh is (2, 2, 2) on 8), and
    ``device_bravo.bench_collective`` on every rank (the 1D and 2D
    revokes' scan through the collective, timed)."""
    import torch.distributed as dist

    from repro_torch.benchmarks import device_bravo as DBB
    from repro_torch.benchmarks import scheduler as SB
    from repro_torch.benchmarks.smoke import FAILURES

    FAILURES.clear()
    rec = {}
    with contextlib.redirect_stdout(sys.stderr):   # their [ok] lines
        if dist.get_world_size() == 1:
            rec["mesh2d"] = SB.bench_mesh2d(cfg, params, dev, True, 8,
                                            BF16_VS_F32_REL)
            rec["mesh2d"].pop("tokens")
        rec["collective"] = DBB.bench_collective(dev, 16)
    if FAILURES:
        raise AssertionError(f"mesh: twin sections: {FAILURES}")
    return rec


def _mesh_moe(dev, mesh, seed) -> dict:
    """One phi3.5-moe MoE layer at full width (its bf16 parameters),
    float32 activations, its experts over "model": the capacity body (the
    rules' layout: tokens over the data axes and "model") and the dropless
    body through ``moe_forward`` with the mesh, in turns with the
    one-device layer.  The capacity body counts its capacity on each
    shard's tokens, so its reference is the one-device layer on each
    shard's block of tokens (the aux loss their mean); the dropless body's
    is the one-device layer on every token."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.dist.sharding import mesh_view
    from repro_torch.models import transformer as TT

    cfg, rules, _ = configs.get(MESH_MOE_ARCH)
    cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    p = {k: v[0] for k, v in TT.init_moe(g, cfg, 1).items()}
    data_axes = rules.batch_axes(mesh_view(mesh))
    shards = math.prod(mesh.shape)
    B, S = MESH_MOE_PREFILL
    x = torch.randn((B, S, cfg.d_model), generator=g, device=dev)
    xd = torch.randn((MESH_MOE_DECODE, 1, cfg.d_model), generator=g,
                     device=dev)
    out = {"arch": MESH_MOE_ARCH, "experts": cfg.moe_experts,
           "d_model": cfg.d_model, "d_ff": cfg.moe_d_ff or cfg.d_ff,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "prefill_tokens": B * S, "decode_tokens": MESH_MOE_DECODE}

    def per_shard(xin):
        blocks = xin.reshape(shards, -1, 1, cfg.d_model)
        ys, auxs = zip(*(TT.moe_forward(p, blk.transpose(0, 1), cfg)
                         for blk in blocks))
        return (torch.cat(ys, dim=1).reshape(xin.shape),
                torch.stack(auxs).mean())

    for body, xin, kw in (
            ("capacity", x, dict(split_tokens_over_model=True,
                                 weight_resident=rules.moe_weight_resident)),
            ("decode_tp", xd, dict(split_tokens_over_model=False,
                                   decode_tp=True))):
        decode = kw.get("decode_tp", False)
        times = {}
        for arm in ("mesh", "plain", "mesh", "plain"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if arm == "mesh":
                y, aux = TT.moe_forward(p, xin, cfg, mesh, data_axes, **kw)
            elif decode:
                y, aux = TT.moe_forward(p, xin, cfg, decode_tp=True)
            else:
                y, aux = per_shard(xin)
            torch.cuda.synchronize()
            times.setdefault(arm, []).append((time.perf_counter() - t) * 1e3)
            if arm == "mesh":
                ym, am = y, float(aux)
            else:
                yp, ap = y, float(aux)
        err = float((ym - yp).abs().max())
        scale = float(yp.abs().max())
        if not (torch.isfinite(ym).all() and err <= MESH_MOE_REL * scale
                and abs(am - ap) <= MESH_MOE_REL * abs(ap)):
            raise AssertionError(f"mesh: MoE {body}: {err} of {scale}, "
                                 f"aux {am} against {ap}")
        out[body] = {"max_abs_err": err, "max_abs": scale, "aux": am,
                     "aux_plain": ap, "ms": times}
    return out


def _mesh_train(dev, mesh, seed) -> dict:
    """The expert-parallel train step of phi3.5-moe at full width, cut to
    ``MESH_TRAIN_LAYERS`` layer(s), float32 parameters, on ``mesh``
    (expert-parallel where "model" is above 1): ``MESH_TRAIN_STEPS`` steps
    of ``make_train_step`` from the seed's trees, then the same batches
    through ``jit_train_step`` from the same trees made anew (its first
    call eager, its second captured and replayed, the rest replayed).
    Each step's loss is finite, the graph's loss and grad norm within
    ``MESH_TRAIN_REL`` of eager's and its sampled parameters within
    ``MESH_TRAIN_REL`` of the largest; every rank's losses and samples are
    compared across ranks by ``_mesh_across``."""
    import dataclasses
    import gc

    import torch

    from repro_torch import configs
    from repro_torch.dist.sharding import mesh_view
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as TO
    from repro_torch.training import train_step as TS

    cfg, rules, _ = configs.get(MESH_MOE_ARCH)
    cfg = dataclasses.replace(cfg, n_layers=MESH_TRAIN_LAYERS,
                              param_dtype=torch.float32)
    opt = TO.OptimizerConfig()
    tcfg = TS.TrainConfig(remat="full")
    B, S = MESH_TRAIN_BATCH
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    batches = [{k: torch.randint(0, cfg.vocab, (B, S), generator=g,
                                 device=dev, dtype=torch.int32)
                for k in ("tokens", "labels")}
               for _ in range(MESH_TRAIN_STEPS)]
    view = mesh_view(mesh)
    rec = {"arch": MESH_MOE_ARCH, "layers": MESH_TRAIN_LAYERS,
           "of_layers": configs.get(MESH_MOE_ARCH)[0].n_layers,
           "mesh": view.shape, "batch": [B, S],
           "expert_parallel": view.shape.get("model", 1) > 1}

    def trees():
        params = M.init_params(seed, cfg, device=dev)
        return params, TO.adamw_init(params, opt)

    def arm(step):
        params, state = trees()
        idx = _update_samples(params, MESH_TRAIN_SAMPLES, seed)
        rec["params"] = sum(x.numel() for x in M.leaves(params))
        losses, norms, ms, samples = [], [], [], []
        torch.cuda.reset_peak_memory_stats()
        for b in batches:
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t) * 1e3)
            norms.append(float(m["grad_norm"]))
            samples.append(_sampled(params, idx))
        peak = torch.cuda.max_memory_allocated()
        del params, state, m
        gc.collect()
        torch.cuda.empty_cache()
        return losses, norms, ms, samples, peak

    el, en, ems, es, epeak = arm(TS.make_train_step(cfg, opt, mesh, rules,
                                                    tcfg=tcfg))
    step = TS.jit_train_step(cfg, opt, mesh, rules, tcfg=tcfg)
    gl, gn, gms, gs, gpeak = arm(step)
    st = dataclasses.asdict(step.graph.stats)
    step.graph.reset()
    worst = 0.0
    for e, c in zip(es, gs):
        for n in e:
            scale = float(e[n].abs().max()) or 1.0
            worst = max(worst, float((c[n] - e[n]).abs().max()) / scale)
    ok = (all(math.isfinite(x) for x in el + gl + en + gn)
          and all(abs(a - b) <= MESH_TRAIN_REL * abs(a)
                  for a, b in zip(el + en, gl + gn))
          and worst <= MESH_TRAIN_REL
          and (st["warmups"], st["captures"], st["replays"]) == (
              1, 1, MESH_TRAIN_STEPS - 1))
    rec.update({"losses": {"eager": el, "graph": gl},
                "grad_norms": {"eager": en, "graph": gn},
                "ms": {"eager": ems, "graph": gms},
                "peak_allocated": {"eager": epeak, "graph": gpeak},
                "graph_stats": {k: st[k] for k in (
                    "warmups", "captures", "replays", "capture_ms")},
                "graph_vs_eager_rel": worst,
                "samples": {n: v.tolist() for n, v in gs[-1].items()},
                "tolerance": MESH_TRAIN_REL})
    if not ok:
        shown = {k: v for k, v in rec.items() if k != "samples"}
        raise AssertionError(f"mesh: the train step: {shown}")
    return rec


def _mesh_sharded(dev, mesh, seed) -> dict:
    """The sharded train step (``make_train_step``/``jit_train_step`` with
    ``sharded=True``: parameters by ``param_specs``, AdamW moments by
    ``zero1_specs``) on the engine's (data, model) ``mesh``, whose
    communicators are warm.  One card: ``_sharded_one_rank``.  N cards,
    (2, N / 2): granite-20b at full width, ``_sharded_vs_unsharded`` at
    float32 and at bf16 compute, then ``_sharded_deep``; the all-gathers,
    reduce-scatters and all-reduces it issued are counted, and each kind
    must be there.  The training path launches none of the port's
    kernels."""
    import torch

    from repro_torch.dist import sharding as DS

    t0 = time.monotonic()
    before = DS.collective_counts()
    if math.prod(DS.mesh_view(mesh).sizes) == 1:
        out = _sharded_one_rank(dev, mesh, seed)
    else:
        out = {"arch": MESH_SHARDED_ARCH, "mesh": _mesh_shape(mesh)}
        for dt in (torch.float32, torch.bfloat16):
            out[f"check_{str(dt)[6:]}"] = _sharded_vs_unsharded(
                dev, mesh, seed, dt)
        out["deep"] = _sharded_deep(dev, mesh, seed)
    after = DS.collective_counts()
    out["collectives"] = {k: v - before.get(k, 0) for k, v in after.items()
                          if v > before.get(k, 0)}
    for kind in ("all_gather", "reduce_scatter", "all_reduce"):
        if not out["collectives"].get(kind):
            raise AssertionError(f"mesh: the sharded step issued no {kind}: "
                                 f"{out['collectives']}")
    out["kernels"] = ("none: the training path launches none of the "
                      "port's kernels (PERF.md section 6)")
    out["seconds"] = time.monotonic() - t0
    return out


def _mesh_shape(mesh) -> dict:
    from repro_torch.dist.sharding import mesh_view
    return mesh_view(mesh).shape


def _sharded_setup(dev, mesh, seed, arch, layers, compute=None):
    """(cfg, rules, opt, tcfg, specs, whole params, blocks, moments) of
    a sharded step from the seed's whole float32 parameters (the same on
    every card); the blocks are copies (``ft.elastic.reshard_tree``)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.ft.elastic import reshard_tree
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as TO
    from repro_torch.training import train_step as TS

    cfg, rules, _ = configs.get(arch)
    cfg = dataclasses.replace(cfg, n_layers=layers, **(
        {} if compute is None else {"compute_dtype": compute}))
    opt = TO.OptimizerConfig(**MESH_SHARDED_OPT)
    tcfg = TS.TrainConfig(remat="full", microbatches=MESH_SHARDED_MICRO)
    pspecs, ospecs = TS.train_specs(cfg, rules, mesh)
    params = M.init_params(seed, cfg, device=dev)
    if "embed" in params:
        params["embed"].mul_(EMBED_SCALE)
    blocks = reshard_tree(params, params, rules, mesh, device=dev)
    state = TO.sharded_adamw_init(M.init_params(0, cfg, device="meta"),
                                  ospecs["m"], mesh, opt, dev)
    return cfg, rules, opt, tcfg, (pspecs, ospecs), params, blocks, state


def _token_batches(cfg, dev, seed, shape, n):
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return [{k: torch.randint(0, cfg.vocab, shape, generator=g, device=dev,
                              dtype=torch.int32)
             for k in ("tokens", "labels")} for _ in range(n)]


def _timed_step(step, *args):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = step(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _sharded_one_rank(dev, mesh, seed) -> dict:
    """llama3.2-1b at full width, ``MESH_ONE_LAYERS`` layers, on the (1,
    1) ``mesh``: every block is the whole leaf, so the sharded step (its
    collectives on one rank copy) equals the unsharded step bit for bit:
    the loss, the gradient norm, every parameter and moment."""
    import gc

    import torch

    from repro_torch import configs
    from repro_torch.dist.sharding import mesh_coords
    from repro_torch.ft.checkpoint import tree_flatten
    from repro_torch.training import optimizer as TO
    from repro_torch.training import train_step as TS

    cfg, rules, opt, tcfg, _, params, blocks, state = _sharded_setup(
        dev, mesh, seed, MESH_ONE_ARCH, MESH_ONE_LAYERS)
    b = _token_batches(cfg, dev, seed, MESH_ONE_BATCH, 1)[0]
    (p1, s1, m1), sharded_ms = _timed_step(
        TS.make_train_step(cfg, opt, mesh, rules, tcfg, sharded=True),
        blocks, state, b)
    (p2, s2, m2), plain_ms = _timed_step(
        TS.make_train_step(cfg, opt, tcfg=tcfg), params,
        TO.adamw_init(params, opt), b)
    one, two = ({"params": p, "m": s["m"], "v": s["v"]}
                for p, s in ((p1, s1), (p2, s2)))
    differ = [n for n, x, y in zip(_dotted(one), tree_flatten(one)[0],
                                   tree_flatten(two)[0])
              if not torch.equal(x, y)]
    rec = {"arch": MESH_ONE_ARCH, "layers": MESH_ONE_LAYERS,
           "of_layers": configs.get(MESH_ONE_ARCH)[0].n_layers,
           "mesh": _mesh_shape(mesh),
           "coords": mesh_coords(mesh), "batch": list(MESH_ONE_BATCH),
           "microbatches": tcfg.microbatches,
           "loss": [float(m1["loss"]), float(m2["loss"])],
           "grad_norm": [float(m1["grad_norm"]), float(m2["grad_norm"])],
           "ms": {"sharded": sharded_ms, "unsharded": plain_ms},
           "leaves_differ": differ}
    del one, two, p1, s1, p2, s2, params, blocks, state
    gc.collect()
    torch.cuda.empty_cache()
    if differ or rec["loss"][0] != rec["loss"][1] \
            or rec["grad_norm"][0] != rec["grad_norm"][1]:
        raise AssertionError(f"mesh: the sharded step at one rank is not "
                             f"the unsharded step bit for bit: {rec}")
    return rec


def _sharded_vs_unsharded(dev, mesh, seed, compute) -> dict:
    """granite-20b at full width, ``MESH_SHARDED_CHECK_LAYERS`` layers,
    float32 parameters at ``compute``: one sharded step on this rank's
    blocks, then the unsharded step on the whole trees on this card, from
    the same parameters and batch (``MESH_SHARDED_BATCH``).  The sharded
    loss and gradient norm within ``MESH_SHARDED_TOL`` of the unsharded
    ones, and ``MESH_SHARDED_SAMPLES`` sampled elements of each block's
    update within R14's bound of the same elements of the unsharded
    update (the rank's block of it)."""
    import gc

    import torch

    from repro_torch.ft.elastic import reshard_tree
    from repro_torch.training import optimizer as TO
    from repro_torch.training import train_step as TS

    name = str(compute)[6:]
    tol = MESH_SHARDED_TOL[name]
    cfg, rules, opt, tcfg, _, params, blocks, state = _sharded_setup(
        dev, mesh, seed, MESH_SHARDED_ARCH, MESH_SHARDED_CHECK_LAYERS,
        compute)
    b = _token_batches(cfg, dev, seed, MESH_SHARDED_BATCH, 1)[0]
    idx = _update_samples(blocks, MESH_SHARDED_SAMPLES, seed)
    old = _sampled(blocks, idx)
    torch.cuda.reset_peak_memory_stats()
    (p1, s1, m1), sharded_ms = _timed_step(
        TS.make_train_step(cfg, opt, mesh, rules, tcfg, sharded=True),
        blocks, state, b)
    sharded_peak = torch.cuda.max_memory_allocated()
    new_sh = _sampled(p1, idx)
    del p1, s1, blocks, state
    gc.collect()
    (p2, s2, m2), plain_ms = _timed_step(
        TS.make_train_step(cfg, opt, tcfg=tcfg), params,
        TO.adamw_init(params, opt), b)
    new_un = _sampled(reshard_tree(p2, p2, rules, mesh, device=dev), idx)
    m_un = _sampled(reshard_tree(s2["m"], p2, rules, mesh, device=dev), idx)
    gmax = {n: float(_leaf(s2["m"], n).abs().max()) / (1 - opt.b1)
            for n in idx}
    lr = float(TO.lr_schedule(opt, s2["step"]))
    worst = 0.0
    for n in idx:
        gr = m_un[n].abs() / (1 - opt.b1)
        bound = lr * (1e-3 + tol["grad_rel"] * gmax[n] / (gr + opt.eps))
        d = (new_sh[n] - old[n]) - (new_un[n] - old[n])
        worst = max(worst, float((d.abs() / bound).max()))
    loss, norm = ([float(m[k]) for m in (m1, m2)]
                  for k in ("loss", "grad_norm"))
    rec = {"layers": MESH_SHARDED_CHECK_LAYERS, "compute": name,
           "batch": list(MESH_SHARDED_BATCH),
           "microbatches": tcfg.microbatches, "loss": loss,
           "grad_norm": norm, "max_update_err_over_bound": worst,
           "ms": {"sharded": sharded_ms, "unsharded": plain_ms},
           "peak_allocated_sharded": sharded_peak, "tolerance": tol}
    del p2, s2, params
    gc.collect()
    torch.cuda.empty_cache()
    ok = (all(math.isfinite(x) for x in loss + norm)
          and abs(loss[0] - loss[1]) <= tol["loss_rel"] * abs(loss[1])
          and abs(norm[0] - norm[1]) <= tol["grad_rel"] * abs(norm[1])
          and worst <= 1.0)
    if not ok:
        raise AssertionError(f"mesh: the sharded step at {name} differs "
                             f"from the unsharded one: {rec}")
    return rec


def _sharded_deep(dev, mesh, seed) -> dict:
    """granite-20b at full width, ``MESH_SHARDED_LAYERS`` of its 52
    layers: ``MESH_SHARDED_STEPS`` steps of the sharded
    ``make_train_step`` from the seed's blocks, then the same batches
    through the sharded ``jit_train_step`` from the same blocks made anew
    (its first call eager, its second captured and replayed, the rest
    replayed).  Every loss finite, the graph's losses and norms within
    ``MESH_TRAIN_REL`` of eager's and its sampled blocks within
    ``MESH_TRAIN_REL`` of the largest; the trees each arm returns after
    its last step hold blocks of the specs' shapes, and the bytes this
    rank stores in them (its parameter and moment blocks) equal the
    specs' count, against the whole state's; the peak
    ``memory_allocated`` under the card's."""
    import dataclasses
    import gc

    import torch

    from repro_torch import configs
    from repro_torch.dist.sharding import (block_shape, mesh_coords,
                                           spec_leaves)
    from repro_torch.ft.checkpoint import tree_flatten
    from repro_torch.models import model as M
    from repro_torch.training import train_step as TS

    def trees():
        *head, params, blocks, state = _sharded_setup(
            dev, mesh, seed, MESH_SHARDED_ARCH, MESH_SHARDED_LAYERS)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        return head, blocks, state

    (cfg, rules, opt, tcfg, (pspecs, ospecs)), blocks, state = trees()
    batches = _token_batches(cfg, dev, seed + 1, MESH_SHARDED_BATCH,
                             MESH_SHARDED_STEPS)
    pshape = tree_flatten(M.init_params(0, cfg, device="meta"))[0]

    del blocks, state

    def nbytes(x):
        return x.numel() * x.element_size()
    want = {"params": [block_shape(p.shape, s, mesh) for p, s in
                       zip(pshape, spec_leaves(pspecs))],
            "moments": [block_shape(p.shape, s, mesh) for p, s in
                        zip(pshape, spec_leaves(ospecs["m"]))]}
    sd = opt.state_dtype.itemsize
    spec_bytes = sum(math.prod(b) * p.element_size() for p, b in
                     zip(pshape, want["params"])) + 2 * sum(
        math.prod(b) * sd for b in want["moments"])
    whole = sum(nbytes(p) for p in pshape)

    def stored(blocks, state):
        """The bytes of the blocks that a step returned, or None where a
        block's shape is not its spec's."""
        trees = [(tree_flatten(blocks)[0], want["params"])] + [
            (tree_flatten(state[k])[0], want["moments"]) for k in ("m", "v")]
        if any([tuple(x.shape) for x in got] != list(map(tuple, shapes))
               for got, shapes in trees):
            return None
        return sum(nbytes(x) for got, _ in trees for x in got)
    n = sum(p.numel() for p in pshape)
    rec = {"arch": MESH_SHARDED_ARCH, "layers": MESH_SHARDED_LAYERS,
           "of_layers": configs.get(MESH_SHARDED_ARCH)[0].n_layers,
           "mesh": _mesh_shape(mesh), "coords": mesh_coords(mesh),
           "batch": list(MESH_SHARDED_BATCH),
           "microbatches": tcfg.microbatches, "params": n,
           "spec_bytes": spec_bytes,
           "whole_state_bytes": {"params_m_v": whole + 2 * n * sd,
                                 "with_grads": 2 * whole + 2 * n * sd},
           "card_bytes": torch.cuda.get_device_properties(dev).total_memory}

    def arm(step):
        _, blocks, state = trees()
        idx = _update_samples(blocks, MESH_TRAIN_SAMPLES, seed)
        losses, norms, ms, samples = [], [], [], []
        torch.cuda.reset_peak_memory_stats()
        for b in batches:
            (blocks, state, m), t = _timed_step(step, blocks, state, b)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            ms.append(t)
            samples.append(_sampled(blocks, idx))
        peak = torch.cuda.max_memory_allocated()
        kept = stored(blocks, state)
        del blocks, state, m
        gc.collect()
        torch.cuda.empty_cache()
        return losses, norms, ms, samples, peak, kept

    el, en, ems, es, epeak, ekept = arm(
        TS.make_train_step(cfg, opt, mesh, rules, tcfg, sharded=True))
    step = TS.jit_train_step(cfg, opt, mesh, rules, tcfg, sharded=True)
    gl, gn, gms, gs, gpeak, gkept = arm(step)
    st = dataclasses.asdict(step.graph.stats)
    step.graph.reset()
    gc.collect()
    torch.cuda.empty_cache()
    worst = 0.0
    for e, c in zip(es, gs):
        for n in e:
            scale = float(e[n].abs().max()) or 1.0
            worst = max(worst, float((c[n] - e[n]).abs().max()) / scale)
    rec.update({"losses": {"eager": el, "graph": gl},
                "grad_norms": {"eager": en, "graph": gn},
                "ms": {"eager": ems, "graph": gms},
                "peak_allocated": {"eager": epeak, "graph": gpeak},
                "stored_bytes": {"eager": ekept, "graph": gkept},
                "graph_stats": {k: st[k] for k in (
                    "warmups", "captures", "replays", "capture_ms")},
                "graph_vs_eager_rel": worst, "tolerance": MESH_TRAIN_REL})
    ok = (all(math.isfinite(x) for x in el + gl + en + gn)
          and all(abs(a - b) <= MESH_TRAIN_REL * abs(a)
                  for a, b in zip(el + en, gl + gn))
          and worst <= MESH_TRAIN_REL
          and (st["warmups"], st["captures"], st["replays"]) == (
              1, 1, MESH_SHARDED_STEPS - 1)
          and ekept == gkept == spec_bytes
          and max(epeak, gpeak) < rec["card_bytes"])
    if not ok:
        raise AssertionError(f"mesh: the sharded step at "
                             f"{MESH_SHARDED_LAYERS} layers: {rec}")
    return rec


# ---------------------------------------------------------------------------
# The sharded serving steps (``_mesh_sharded_serve``): the dry run's
# prefill and decode steps per rank (``serving.steps.serve_specs``)
# ---------------------------------------------------------------------------

# One card, (1, 1): llama3.2-1b at full width, 2 of its 16 layers, a
# (2, 1024) prompt and 3 decode steps of 2 rows against a 2048-position
# cache, against the unsharded steps bit for bit, eager and graphed.  N
# cards, (2, N / 2): llama3.2-1b at full width and depth, (a) against the
# unsharded steps on each card at float32 and bf16 compute (a 4 x 2048
# prompt; 4 rows decoding 4 steps against a 32768-position cache ending
# full), (b) decode_32k's whole shape (128 rows, 32768 positions; a
# 34.4 GB cache block a rank), eager then graphed, (c) prefill_32k's
# sequence with its batch cut from 32 to 4
MESH_SERVE_ARCH = "llama3.2-1b"
MESH_SERVE_ONE = {"layers": 2, "prefill": (2, 1024), "rows": 2,
                  "cache": 2048, "steps": 3}
MESH_SERVE_CHECK = {"prefill": (4, 2048), "rows": 4, "cache": 32768,
                    "steps": 4}
MESH_SERVE_DECODE = {"rows": 128, "cache": 32768, "steps": 3}
MESH_SERVE_PREFILL = (4, 32768)
# sharded against unsharded, relative to the largest unsharded value: at
# float32 compute 1e-5 with tokens equal; at bf16 R12's rule, each token
# equal or a near-tie of the unsharded logits
MESH_SERVE_TOL = {"float32": 1e-5, "bfloat16": BF16_VS_F32_REL}


def _mesh_sharded_serve(dev, mesh, seed) -> dict:
    """The sharded prefill and decode steps (``make_prefill_step``/
    ``make_decode_step`` with ``sharded=True``: the dry run's layouts
    from ``serve_specs``) on the engine's (data, model) ``mesh``.  One
    card: ``_serve_one_rank``.  N cards: ``_serve_vs_unsharded`` at
    float32 and at bf16 compute, ``_serve_decode_full`` and
    ``_serve_prefill_long``.  The collectives are counted by kind, and the
    path launches none of the port's kernels (its attention is plain
    PyTorch, as ``repro``'s is plain ``jnp``): every K1-K10 count stays
    0."""
    import torch

    from repro_torch.dist import sharding as DS
    from repro_torch.kernels import ops as K

    t0 = time.monotonic()
    before, k0 = DS.collective_counts(), K.launch_counts()
    if math.prod(DS.mesh_view(mesh).sizes) == 1:
        out = _serve_one_rank(dev, mesh, seed)
    else:
        out = {"arch": MESH_SERVE_ARCH, "mesh": _mesh_shape(mesh)}
        for dt in (torch.float32, torch.bfloat16):
            t = time.monotonic()
            rec = _serve_vs_unsharded(dev, mesh, seed, dt)
            rec["seconds"] = time.monotonic() - t
            out[f"check_{str(dt)[6:]}"] = rec
        for name, fn in (("decode_32k", _serve_decode_full),
                         ("prefill_32k", _serve_prefill_long)):
            t = time.monotonic()
            out[name] = fn(dev, mesh, seed)
            out[name]["seconds"] = time.monotonic() - t
    after, k1 = DS.collective_counts(), K.launch_counts()
    out["collectives"] = {k: v - before.get(k, 0) for k, v in after.items()
                          if v > before.get(k, 0)}
    out["kernel_launches"] = {k: v - k0.get(k, 0) for k, v in k1.items()}
    if any(out["kernel_launches"].values()):
        raise AssertionError(f"mesh: the sharded serving path launched a "
                             f"kernel: {out['kernel_launches']}")
    for kind in ("all_gather", "all_reduce"):
        if not out["collectives"].get(kind):
            raise AssertionError(f"mesh: the sharded serving steps issued no "
                                 f"{kind}: {out['collectives']}")
    out["seconds"] = time.monotonic() - t0
    return out


def _serve_setup(dev, seed, layers=None, compute=None):
    """(cfg, rules, whole parameters) of llama3.2-1b from the seed, the
    same on every card (the embedding scaled as ``main`` scales it)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import model as M

    cfg, rules, _ = configs.get(MESH_SERVE_ARCH)
    cfg = dataclasses.replace(cfg, **({} if layers is None else
                                      {"n_layers": layers}),
                              **({} if compute is None else
                                 {"compute_dtype": compute}))
    params = M.init_params(seed, cfg, device=dev)
    params["embed"].mul_(EMBED_SCALE)
    return cfg, rules, params


def _seeded_fill(tree, seed) -> None:
    """Every leaf of a cache tree drawn anew, in place, from the seed."""
    import torch

    g = torch.Generator(device=next(iter(tree.values())).device)
    g.manual_seed(seed)
    for k in sorted(tree):
        tree[k].normal_(generator=g)


def _seeded_cache(cfg, rows, seq, dev, seed) -> dict:
    from repro_torch.models import model as M

    caches = M.init_caches(cfg, rows, seq, device=dev)
    _seeded_fill(caches, seed)
    return caches


def _decode_inputs(cfg, dev, seed, rows, cache, steps):
    """Each step's seeded input tokens (rows, 1) and its scalar cache_len,
    the last step's the whole cache."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed + 7)
    return [(torch.randint(0, cfg.vocab, (rows, 1), generator=g, device=dev,
                           dtype=torch.int32),
             torch.tensor(cache - steps + 1 + i, dtype=torch.int32,
                          device=dev)) for i in range(steps)]


def _rows_of(x, spec, mesh):
    from repro_torch.dist import sharding as DS

    return DS.shard_block(x, DS.P(tuple(spec)[0]), mesh)


def _evented(step, *args):
    """``step(*args)`` -> (its result, host ms to a synchronize, CUDA-event
    ms on the current stream)."""
    import torch

    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t = time.perf_counter()
    a.record()
    out = step(*args)
    b.record()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3, a.elapsed_time(b)


def _serve_one_rank(dev, mesh, seed) -> dict:
    """``MESH_SERVE_ONE`` on the (1, 1) ``mesh``: every block is the whole
    leaf and the cache's sequence one slice, so the sharded steps equal
    the unsharded ones bit for bit: the prefill's logits and caches, each
    decode step's tokens, logits and caches.  Then both sharded steps
    through ``jit_mesh_step`` (the prefill warmed up, captured and
    replayed; the decode step with its cache donated, from the same cache
    drawn anew), bit-equal to the eager ones."""
    import gc

    import torch

    from repro_torch import configs
    from repro_torch.ft.elastic import reshard_tree
    from repro_torch.serving import steps as ST

    one = MESH_SERVE_ONE
    cfg, rules, params = _serve_setup(dev, seed, one["layers"])
    b, p = one["prefill"]
    rows, seq, steps = one["rows"], one["cache"], one["steps"]
    batch = {"tokens": _token_batches(cfg, dev, seed, (b, p), 1)[0]["tokens"]}
    differ = []

    def same(name, x, y):
        if not torch.equal(x, y):
            differ.append(name)

    blocks = reshard_tree(params, params, rules, mesh, device=dev)
    pre = ST.make_prefill_step(cfg, mesh, rules, sharded=True, shape=(b, p))
    (l1, c1), sharded_ms = _timed_step(pre, blocks, batch)
    (l2, c2), plain_ms = _timed_step(ST.make_prefill_step(cfg), params,
                                     batch)
    same("prefill.logits", l1, l2)
    for k in c1:
        same(f"prefill.caches.{k}", c1[k], c2[k])
    graph = ST.jit_mesh_step(ST.make_prefill_step(
        cfg, mesh, rules, sharded=True, shape=(b, p)), mesh)
    for i in range(3):
        lg, cg = graph(blocks, batch)
        same(f"prefill.graph{i}.logits", lg, l1)
        for k in cg:
            same(f"prefill.graph{i}.caches.{k}", cg[k], c1[k])
    pstats = (graph.stats.warmups, graph.stats.captures, graph.stats.replays)
    del blocks, c1, c2, graph
    dblocks = reshard_tree(params, params, rules, mesh, decode=True,
                           device=dev)
    dec = ST.make_decode_step(cfg, mesh, rules, sharded=True,
                              shape=(rows, seq))
    plain = ST.make_decode_step(cfg)
    inputs = _decode_inputs(cfg, dev, seed, rows, seq, steps)
    whole = _seeded_cache(cfg, rows, seq, dev, seed)
    blk = _seeded_cache(cfg, rows, seq, dev, seed)
    eager = []
    for i, (tok, n) in enumerate(inputs):
        t1, g1, whole = plain(params, whole, tok, n)
        t2, g2, blk = dec(dblocks, blk, tok, n)
        same(f"decode{i}.token", t2, t1)
        same(f"decode{i}.logits", g2, g1)
        eager.append((t2, g2))
    for k in blk:
        same(f"decode.caches.{k}", blk[k], whole[k])
    graph = ST.jit_mesh_step(ST.make_decode_step(
        cfg, mesh, rules, sharded=True, shape=(rows, seq)), mesh,
        donate_argnums=(1,))
    _seeded_fill(blk, seed)
    for i, (tok, n) in enumerate(inputs):
        t3, g3, out = graph(dblocks, blk, tok, n)
        same(f"decode.graph{i}.token", t3, eager[i][0])
        same(f"decode.graph{i}.logits", g3, eager[i][1])
        if out is not blk:
            differ.append(f"decode.graph{i}: not in place")
    for k in blk:
        same(f"decode.graph.caches.{k}", blk[k], whole[k])
    dstats = (graph.stats.warmups, graph.stats.captures, graph.stats.replays)
    rec = {"arch": MESH_SERVE_ARCH, "layers": one["layers"],
           "of_layers": configs.get(MESH_SERVE_ARCH)[0].n_layers,
           "mesh": _mesh_shape(mesh), "prefill": [b, p],
           "decode": {"rows": rows, "cache": seq,
                      "cache_len": [int(n) for _, n in inputs]},
           "ms": {"prefill_sharded": sharded_ms,
                  "prefill_unsharded": plain_ms},
           "graph_stats": {"prefill": pstats, "decode": dstats},
           "differ": differ}
    del params, dblocks, whole, blk, graph, eager
    gc.collect()
    torch.cuda.empty_cache()
    if differ or pstats != (1, 1, 2) or dstats != (1, 1, steps - 1):
        raise AssertionError(f"mesh: the sharded serving steps at one rank "
                             f"are not the unsharded steps bit for bit: "
                             f"{rec}")
    return rec


def _rel_err(got, want) -> float:
    """max |got - want| over the largest |want|, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def _serve_vs_unsharded(dev, mesh, seed, compute) -> dict:
    """``MESH_SERVE_CHECK`` at ``compute``: llama3.2-1b at full width and
    depth, float32 parameters.  The sharded prefill on this rank's blocks
    and rows against the unsharded prefill of the whole batch on this
    card: the logits rows and the cache blocks (this rank's block of the
    unsharded caches) within ``MESH_SERVE_TOL`` of the largest.  Then the
    decode steps against a seeded cache whose last step fills it, the
    same inputs given to both (teacher-forced): each step's tokens (equal
    at float32; equal or a near-tie of the unsharded logits at bf16,
    R12) and logits rows within the tolerance, and the cache blocks after
    the last step."""
    import gc

    import torch

    from repro_torch.dist import sharding as DS
    from repro_torch.ft.elastic import reshard_tree
    from repro_torch.serving import steps as ST

    name = str(compute)[6:]
    tol = MESH_SERVE_TOL[name]
    chk = MESH_SERVE_CHECK
    cfg, rules, params = _serve_setup(dev, seed, None, compute)
    b, p = chk["prefill"]
    tokens = _token_batches(cfg, dev, seed, (b, p), 1)[0]["tokens"]
    pre = ST.make_prefill_step(cfg, mesh, rules, sharded=True, shape=(b, p))
    specs = pre.specs
    blocks = reshard_tree(params, params, rules, mesh, device=dev)
    torch.cuda.reset_peak_memory_stats()
    (l1, c1), sharded_ms = _timed_step(
        pre, blocks, {"tokens": _rows_of(tokens, specs["batch"]["tokens"],
                                         mesh)})
    peak = torch.cuda.max_memory_allocated()
    del blocks
    (l2, c2), plain_ms = _timed_step(ST.make_prefill_step(cfg), params,
                                     {"tokens": tokens})
    errs = {"prefill_logits": _rel_err(
        l1, _rows_of(l2, specs["batch"]["tokens"], mesh))}
    for k in c1:
        errs[f"prefill_{k}"] = _rel_err(
            c1[k], DS.shard_block(c2[k], specs["caches"][k], mesh))
    del l1, l2, c1, c2
    gc.collect()
    torch.cuda.empty_cache()
    rows, seq, steps = chk["rows"], chk["cache"], chk["steps"]
    dec = ST.make_decode_step(cfg, mesh, rules, sharded=True,
                              shape=(rows, seq))
    dspecs = dec.specs
    dblocks = reshard_tree(params, params, rules, mesh, decode=True,
                           device=dev)
    plain = ST.make_decode_step(cfg)
    whole = _seeded_cache(cfg, rows, seq, dev, seed)
    blk = {k: DS.shard_block(v, dspecs["caches"][k], mesh).clone()
           for k, v in whole.items()}
    tokens_ok, ms = [], {"sharded": [], "unsharded": []}
    errs["decode_logits"] = 0.0
    for tok, n in _decode_inputs(cfg, dev, seed, rows, seq, steps):
        (t1, g1, whole), u = _timed_step(plain, params, whole, tok, n)
        (t2, g2, blk), s = _timed_step(
            dec, dblocks, blk, _rows_of(tok, dspecs["token"], mesh), n)
        ms["unsharded"].append(u)
        ms["sharded"].append(s)
        want = _rows_of(g1, dspecs["token"], mesh).float()
        errs["decode_logits"] = max(errs["decode_logits"],
                                    _rel_err(g2, want))
        mine = torch.gather(want, 1, t2.long())[:, 0]
        near = mine >= want.max(dim=1).values - tol * float(
            want.abs().max())
        same = t2[:, 0] == _rows_of(t1, dspecs["token"], mesh)[:, 0]
        tokens_ok.append(bool(same.all()) if name == "float32"
                         else bool((same | near).all()))
    for k in blk:
        want = DS.shard_block(whole[k], dspecs["caches"][k], mesh)
        errs[f"decode_{k}"] = _rel_err(blk[k], want)
        errs[f"decode_{k}_rounding"] = _over_rounding(blk[k], want, tol)
    rec = {"compute": name, "layers": cfg.n_layers, "prefill": [b, p],
           "decode": {"rows": rows, "cache": seq, "steps": steps},
           "rel_err": errs, "tokens_ok": tokens_ok, "tolerance": tol,
           "ms": {"prefill_sharded": sharded_ms,
                  "prefill_unsharded": plain_ms, "decode": ms},
           "prefill_peak_allocated": peak}
    del params, dblocks, whole, blk
    gc.collect()
    torch.cuda.empty_cache()
    # the bf16 caches at float32 compute: a written K/V is a float32 value
    # within ``tol`` of the largest rounded to bf16 on both sides, so the
    # two differ by at most that plus one bf16 step of the value
    # (``_over_rounding``); at bf16 compute, ``tol`` of the largest
    limits = {}
    for k in errs:
        if k.endswith("_rounding"):
            limits[k] = 1.0 if name == "float32" else math.inf
        elif name == "float32" and k in ("decode_k", "decode_v"):
            limits[k] = math.inf              # held by the rounding bound
        else:
            limits[k] = tol
    rec["limits"] = limits
    if not all(tokens_ok) or not all(math.isfinite(e) and e <= limits[k]
                                     for k, e in errs.items()):
        raise AssertionError(f"mesh: the sharded serving steps at {name} "
                             f"differ from the unsharded ones: {rec}")
    return rec


def _over_rounding(got, want, rel) -> float:
    """max over the elements of two bf16 tensors of |got - want| over
    one bf16 step of |want| plus ``rel`` of the largest |want|: at most
    1 where both are roundings of float32 values within ``rel`` of the
    largest."""
    import torch

    got, want = got.float(), want.float()
    mag = want.abs().clamp_min(torch.finfo(torch.float32).tiny)
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    bound = step + rel * float(want.abs().max())
    return float(((got - want).abs() / bound).max())


def _cache_bytes(caches) -> int:
    return sum(x.numel() * x.element_size() for x in caches.values())


def _serve_decode_full(dev, mesh, seed) -> dict:
    """decode_32k's whole shape (``MESH_SERVE_DECODE``): llama3.2-1b at
    full width and depth, this rank's bf16 cache block (34,359,738,368
    bytes at (2, 2)) drawn on the card from the seed and its coordinates.
    ``steps`` decode steps eager, then the same from the same cache drawn
    anew through ``jit_mesh_step`` (the cache donated: a warm-up, a
    capture that replays, a replay), the last step's ``cache_len`` the
    whole cache.  Each step's host and CUDA-event ms, the capture's ms,
    the peak ``memory_allocated``, the bytes the cache blocks hold
    against the specs' count, the collectives by kind.  The graph equals
    eager bit for bit: tokens, logits, and the cache entries at the
    written positions; every logit finite."""
    import gc

    import torch

    from repro_torch.dist import sharding as DS
    from repro_torch.ft.elastic import reshard_tree
    from repro_torch.models import model as M
    from repro_torch.serving import steps as ST

    cfg, rules, params = _serve_setup(dev, seed)
    d = MESH_SERVE_DECODE
    rows, seq, steps = d["rows"], d["cache"], d["steps"]
    dblocks = reshard_tree(params, params, rules, mesh, decode=True,
                           device=dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    dec = ST.make_decode_step(cfg, mesh, rules, sharded=True,
                              shape=(rows, seq))
    specs = dec.specs
    whole = M.init_caches(cfg, rows, seq, device="meta")
    cut = DS.block_shape(tuple(whole["k"].shape), specs["caches"]["k"], mesh)
    spec_bytes = 2 * math.prod(cut) * whole["k"].element_size()
    coords = DS.mesh_coords(mesh)
    fill = seed * 1000 + coords.get("data", 0) * 10 + coords.get("model", 0)
    caches = {k: torch.empty(cut, dtype=whole[k].dtype, device=dev)
              for k in ("k", "v")}
    inputs = [(_rows_of(t, specs["token"], mesh), n)
              for t, n in _decode_inputs(cfg, dev, seed, rows, seq, steps)]
    # the written positions in this rank's slice of the sequence
    sl = specs["caches"]["k"][2]
    lo = 0
    for a in () if sl is None else (sl,) if isinstance(sl, str) else sl:
        lo = lo * DS.mesh_view(mesh).shape[a] + coords[a]
    lo *= cut[2]
    mine = [int(n) - 1 - lo for _, n in inputs
            if lo <= int(n) - 1 < lo + cut[2]]

    def arm(step):
        _seeded_fill(caches, fill)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        outs, host, event = [], [], []
        for tok, n in inputs:
            (t, g, out), h, e = _evented(step, dblocks, caches, tok, n)
            if out is not caches:
                raise AssertionError("mesh: the decode step did not "
                                     "return its cache blocks")
            outs.append((t.clone(), g.clone()))
            host.append(h)
            event.append(e)
        written = {k: caches[k][:, :, mine].clone() for k in caches}
        return outs, host, event, torch.cuda.max_memory_allocated(), written

    before = DS.collective_counts()
    e_outs, e_host, e_event, e_peak, e_written = arm(dec)
    counts = {k: v - before.get(k, 0) for k, v in
              DS.collective_counts().items() if v > before.get(k, 0)}
    graph = ST.jit_mesh_step(ST.make_decode_step(
        cfg, mesh, rules, sharded=True, shape=(rows, seq)), mesh,
        donate_argnums=(1,))
    g_outs, g_host, g_event, g_peak, g_written = arm(graph)
    st = graph.stats
    stats = {"warmups": st.warmups, "captures": st.captures,
             "replays": st.replays, "capture_ms": list(st.capture_ms)}
    equal = all(torch.equal(a, b) for x, y in zip(e_outs, g_outs)
                for a, b in zip(x, y)) and all(
        torch.equal(e_written[k], g_written[k]) for k in caches)
    finite = all(bool(torch.isfinite(g).all()) for _, g in e_outs)
    rec = {"arch": MESH_SERVE_ARCH, "layers": cfg.n_layers,
           "mesh": _mesh_shape(mesh), "coords": coords, "rows": rows,
           "cache": seq, "cache_len": [int(n) for _, n in inputs],
           "block": list(cut), "stored_cache_bytes": _cache_bytes(caches),
           "spec_cache_bytes": spec_bytes,
           "whole_cache_bytes": 2 * math.prod(whole["k"].shape)
           * whole["k"].element_size(),
           "tokens": [t[:, 0].tolist() for t, _ in g_outs],
           "ms": {"eager": e_host, "graph": g_host},
           "event_ms": {"eager": e_event, "graph": g_event},
           "peak_allocated": {"eager": e_peak, "graph": g_peak},
           "graph_stats": stats, "collectives": counts,
           "written_positions": mine, "graph_equals_eager": equal,
           "finite": finite,
           "card_bytes": torch.cuda.get_device_properties(dev).total_memory}
    del dblocks, caches, graph, e_outs, g_outs, e_written, g_written
    gc.collect()
    torch.cuda.empty_cache()
    if not (equal and finite and rec["stored_cache_bytes"] == spec_bytes
            and (st.warmups, st.captures, st.replays) == (1, 1, steps - 1)):
        raise AssertionError(f"mesh: decode_32k's sharded step: {rec}")
    return rec


def _serve_prefill_long(dev, mesh, seed) -> dict:
    """prefill_32k's sequence (``MESH_SERVE_PREFILL``, the batch cut from
    32 to 4): the sharded prefill of llama3.2-1b at full width and depth
    on this rank's rows, eager.  Its ms, the peak ``memory_allocated``,
    the cache blocks' bytes against the specs' count, finite logits
    rows over the whole vocab."""
    import gc

    import torch

    from repro_torch import configs
    from repro_torch.dist import sharding as DS
    from repro_torch.ft.elastic import reshard_tree
    from repro_torch.models import model as M
    from repro_torch.serving import steps as ST

    cfg, rules, params = _serve_setup(dev, seed)
    b, s = MESH_SERVE_PREFILL
    blocks = reshard_tree(params, params, rules, mesh, device=dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    pre = ST.make_prefill_step(cfg, mesh, rules, sharded=True, shape=(b, s))
    specs = pre.specs
    tokens = _token_batches(cfg, dev, seed, (b, s), 1)[0]["tokens"]
    local = {"tokens": _rows_of(tokens, specs["batch"]["tokens"], mesh)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (logits, caches), ms = _timed_step(pre, blocks, local)
    peak = torch.cuda.max_memory_allocated()
    # the new K/V come in the promoted dtype of the activations and the
    # weights, as in ``repro``
    whole = M.init_caches(cfg, b, s, device="meta", dtype=torch.promote_types(
        cfg.compute_dtype, cfg.param_dtype))
    spec_bytes = sum(math.prod(DS.block_shape(tuple(x.shape),
                                              specs["caches"][k], mesh))
                     * x.element_size() for k, x in whole.items())
    rec = {"arch": MESH_SERVE_ARCH, "layers": cfg.n_layers,
           "mesh": _mesh_shape(mesh), "batch": [b, s],
           "of_batch": configs.SHAPES["prefill_32k"].global_batch,
           "rows": list(local["tokens"].shape), "ms": ms,
           "peak_allocated": peak, "logits": list(logits.shape),
           "stored_cache_bytes": _cache_bytes(caches),
           "spec_cache_bytes": spec_bytes,
           "finite": bool(torch.isfinite(logits).all())}
    del blocks, logits, caches
    gc.collect()
    torch.cuda.empty_cache()
    if not (rec["finite"] and rec["stored_cache_bytes"] == spec_bytes
            and rec["logits"] == [b // DS.data_shards(rules, mesh),
                                  cfg.vocab]):
        raise AssertionError(f"mesh: prefill_32k's sharded step: {rec}")
    return rec


# ---------------------------------------------------------------------------
# Phases 2a and 3b: the lock experiments, the lint, the autotune sweep
# ---------------------------------------------------------------------------


def locks_phase() -> dict:
    """The paper's lock experiments and the host analysis on this machine's
    CPU, while the kernels build: ``repro_torch.benchmarks.smoke_locks``
    (every lock variant under ``LiveMem`` and ``SimMem``; it raises on a
    torn read or a lost write), the source lint over ``src/repro_torch``
    (PyTorch's host syncs in the lease-window rule; 0 findings after the
    allowlist, which must be empty), and three rows of the paper's figures
    under the coherence simulator: ``test_rwlock`` (fig. 3) for ``ba`` and
    ``bravo-ba`` at 4 readers and ``alternator('bravo-ba', 4)`` (fig. 2).
    The rows are virtual time on the modelled 72-CPU X5-2, not a reading
    of this host or of the card."""
    from repro_torch.analysis import check as CHK
    from repro_torch.analysis import lint_src as LS
    from repro_torch.benchmarks import figures as FIG
    from repro_torch.benchmarks import smoke_locks

    t0 = time.monotonic()
    lines = []
    sims = smoke_locks.run(lines.append)
    t_smoke = time.monotonic() - t0
    waivers = LS.load_allowlist(CHK.ALLOWLIST)
    findings = LS.apply_allowlist(LS.lint_tree(), waivers)
    if findings or waivers:
        raise AssertionError(f"locks: source lint: "
                             f"{[str(f) for f in findings]}, waivers "
                             f"{waivers}")
    t_lint = time.monotonic() - t0 - t_smoke
    rows = [FIG.test_rwlock("ba", 4), FIG.test_rwlock("bravo-ba", 4),
            FIG.alternator("bravo-ba", 4)]
    for r in rows:
        if not (r.ops > 0 and r.elapsed_ns > 0):
            raise AssertionError(f"locks: empty figure row {r.row()}")
    return {"smoke_locks": {"variants": len(sims), "sim": sims,
                            "seconds": t_smoke},
            "source_lint": {"root": "src/repro_torch", "findings": 0,
                            "seconds": t_lint},
            "figure_rows": [r.row() for r in rows],
            "figure_time": "virtual ns on the modelled 72-CPU X5-2",
            "test_rwlock_bravo_vs_ba": rows[1].ops_per_ms
            / rows[0].ops_per_ms,
            "seconds": time.monotonic() - t0}


def autotune_phase(dev) -> dict:
    """``repro_torch.kernels.autotune`` on the card, on the ``paged`` build
    the kernel phases loaded: the sweep of K5/K7's ``min_split_positions``
    and K6/K8's ``pairs`` at its two shapes (decode: 16 rows on 256 lanes;
    chunk: 2 rows x 32 columns on 256 lanes), every candidate checked
    against the plain version (1e-5) and then timed, its winners merged
    into a table in a temporary directory (never the repo's); the phase
    fails on a ``"WRONG"`` candidate, an untimed one or a table that does
    not hold the winners.  Then the wrappers' plans read back with the
    committed table (``kernels/tuning_table.json``) in force: at the sweep
    shapes each equals the plan of the committed knob, and at the engine's
    tick shapes (8 lanes of 16) each equals the built-in plan."""
    import tempfile

    import torch

    from repro_torch.kernels import autotune as AT
    from repro_torch.kernels import ops as K
    from repro_torch.kernels import paged_attn as PA
    from repro_torch.kernels import paged_chunk_attn as PCA

    t0 = time.monotonic()
    card = torch.cuda.get_device_name(dev)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tuning_table.json")
        report = AT.run(path, seed=0, device=dev)
        with open(path) as f:
            written = json.load(f)
    for kernel, r in report.items():
        for c, rec in r["results"].items():
            if rec == "WRONG" or rec["ms"] is None:
                raise AssertionError(f"autotune: {kernel} at {r['knob']}="
                                     f"{c}: {rec}")
        if written[kernel][card][r["knob"]] != r["best"]:
            raise AssertionError(f"autotune: {kernel}: table {written} "
                                 f"does not hold the winner {r['best']}")
    t_sweep = time.monotonic() - t0
    committed = json.loads(K.TUNING_PATH.read_text())
    heads = dict(h=32, kvh=8, hd=64, ps=16)
    plans = {}
    for kernel, (knob, _) in AT.KNOBS.items():
        value = committed.get(kernel, {}).get(card, {}).get(knob, 0)
        int8 = kernel.endswith("_quant")
        kv = torch.empty((1, 16, 8, 64), device=dev,
                         dtype=torch.int8 if int8 else torch.bfloat16)
        rec = {"committed": value,
               "read": K.tuned(kernel, knob, dev.index or 0)}
        for shape, lanes in (("sweep", 256), ("tick", 8)):
            if kernel.startswith("paged_attn"):
                b = AT.CARD_SHAPES["decode"]["b"] if shape == "sweep" else 8
                q = torch.empty((b, heads["h"], heads["hd"]), device=dev)
                plan = PA.decode_plan(q, kv, lanes)
                want = PA.decode_plan(q, kv, lanes,
                                      knob=value if shape == "sweep" else 0)
            else:
                q = torch.empty((2, 32, heads["h"], heads["hd"]), device=dev)
                plan = PCA.chunk_plan(q, kv, lanes)
                want = PCA.chunk_plan(q, kv, lanes,
                                      knob=value if shape == "sweep" else 0)
            if plan != want:
                raise AssertionError(f"autotune: {kernel} {shape} plan "
                                     f"{plan}, want {want}")
            rec[shape] = list(plan)
        if rec["read"] != value:
            raise AssertionError(f"autotune: {kernel}: read {rec['read']}, "
                                 f"committed {value}")
        plans[kernel] = rec
    return {"card_key": card, "sweep": report, "written": written,
            "plans": plans, "sweep_seconds": t_sweep,
            "seconds": time.monotonic() - t0}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    sys.exit(main())
