"""The port's benchmarks: ``device_bravo`` (the single-lock lease table
against the legacy host-looped path) and ``registry`` (the shared-bias
flap, the registry against the single-lock table); ``hotswap`` (weight
swaps under traffic, from a checkpoint and past a wedged reader) and
``slo`` (static admission against the latency-feedback controller on one
seeded burst trace); the serving twins ``obs`` (what tracing costs a
decode step), ``scheduler`` (the decode kernel, paged against dense
decode, the admission sweep), ``prefill`` (the chunk kernel, no dense KV
buffer, the prefix dedup sweep) and ``quant`` (the int8 page store's
bytes, error, latency and prefix-index collisions); the pass/fail helpers,
the spread of repeated windows and the dense token oracle they share in
``smoke``; ``decode_sweep`` and ``chunk_sweep``, the timing sweeps of
the paged kernels K5/K7 and K6/K8, which need a CUDA card; and the paper's
lock experiments, host programs under the coherence simulator:
``figures`` (one function a figure, on ``common``'s harness), ``run``
(their CSV rows) and ``smoke_locks`` (every lock variant live and
simulated)."""
