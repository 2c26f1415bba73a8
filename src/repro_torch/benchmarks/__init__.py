"""The port's lease microbenchmarks: ``device_bravo`` (the single-lock lease
table against the legacy host-looped path) and ``registry`` (the shared-bias
flap, the registry against the single-lock table), with the pass/fail
helpers they share in ``smoke``; and ``decode_sweep``, the timing sweep of
the paged decode kernel K5/K7 (ablations, warp layout, KV split), which
needs a CUDA card."""
