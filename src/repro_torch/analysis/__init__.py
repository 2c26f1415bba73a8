"""Host analysis of the lock protocols and of the port's source: the
protocol checker (``checker``, ``scenarios``: verbatim copies of
``repro.analysis``'s), the source lint (``lint_src``, with PyTorch's host
syncs in its lease-window rule) and their entry point, ``python -m
repro_torch.analysis.check``."""
