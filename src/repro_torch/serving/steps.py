"""Serving steps in plain PyTorch.

* prefill: full forward over the prompt -> last-position logits and the
  populated caches.
* decode: one new token per request against a per-request cache
  (``models.model.init_caches``), greedy.

PyTorch runs eagerly, so where ``repro`` returned functions for ``jax.jit``
these are the step functions themselves.  The paged variants
(``make_decode_step(paged=True)``, ``make_paged_prefill_step``) run the
Pallas kernels K5/K6 in ``repro`` and come with the scheduler slice.
"""

from __future__ import annotations

import torch

from ..models import model as M
from ..models.common import ModelConfig


def make_prefill_step(cfg: ModelConfig):
    def prefill(params, batch):
        logits, _, caches = M.forward(params, cfg, batch)
        return logits[:, -1], caches
    return prefill


def make_decode_step(cfg: ModelConfig, sample: str = "greedy",
                     paged: bool = False):
    """decode_step(params, caches, token, cache_len) -> (next_token (B, 1)
    int32, logits (B, V), caches).

    Callers pass ``cache_len = old_len + 1``: the new token's K/V is written
    at ``cache_len - 1`` (in place) and attention covers ``cache_len``
    positions."""
    if paged:
        raise NotImplementedError(
            "paged decode (the Pallas kernel K5 in repro) comes with the "
            "scheduler slice; see ROADMAP.md")
    if sample != "greedy":
        raise ValueError(sample)

    def decode(params, caches, token, cache_len):
        logits, _, caches = M.forward(params, cfg, {"tokens": token},
                                      caches=caches, cache_len=cache_len)
        logits = logits[:, -1]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt[:, None], logits, caches

    return decode
