"""The port's lease microbenchmarks: ``device_bravo`` (the single-lock lease
table against the legacy host-looped path) and ``registry`` (the shared-bias
flap, the registry against the single-lock table), with the pass/fail
helpers they share in ``smoke``."""
