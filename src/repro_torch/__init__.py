"""PyTorch/CUDA port of the ``repro`` package (BRAVO reader-writer locks and
the serving engine built on them), for one NVIDIA Hopper card.

The module layout mirrors ``repro`` so every counterpart is easy to find;
the JAX package stays the reference.  Every Pallas kernel that this port has
reached is a hand-written CUDA C++ kernel under ``csrc/``, built with nvcc at
first use (``kernels/_build.py``).  The entry points (``ServingEngine``,
``BravoRegistry``, ``KVPool``, ``init_params``) run on ``cuda`` unless the
caller passes ``device="cpu"``; with no device argument and no GPU they
raise instead of quietly running on the host.
"""
