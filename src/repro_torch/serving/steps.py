"""Serving steps in plain PyTorch.

* prefill: full forward over the prompt -> last-position logits and the
  populated caches.
* decode: one new token per request against a per-request cache
  (``models.model.init_caches``), greedy.
* paged variants (the scheduler's data plane): the KV cache is the pool's
  page store (``models.model.init_paged_caches``), addressed by each
  request's (B, P) page-index vector; decode attends through the kernel
  K5, chunked prefill writes right-aligned chunks into the pages and
  attends through K6.

PyTorch runs eagerly, so where ``repro`` returned functions for ``jax.jit``
these are the step functions themselves, and where ``repro`` donated the
page store the steps update it in place.
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
    """decode_step(params, caches, token, cache_len[, pages]) ->
    (next_token (B, 1) int32, logits (B, V), caches).

    Callers pass ``cache_len = old_len + 1``: the new token's K/V is written
    at ``cache_len - 1`` (in place) and attention covers ``cache_len``
    positions.  ``paged=True`` takes the page store from
    ``models.model.init_paged_caches`` as ``caches`` and the batch's (B, P)
    page-index matrix as ``pages`` (-1 = unused lane; a row with
    ``cache_len == 0`` is inactive, writes nothing and emits token 0)."""
    if sample != "greedy":
        raise ValueError(sample)

    def _sample(logits):
        logits = logits[:, -1]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt[:, None], logits

    if paged:
        def decode(params, caches, token, cache_len, pages):
            logits, _, caches = M.forward(params, cfg, {"tokens": token},
                                          caches=caches, cache_len=cache_len,
                                          pages=pages)
            nxt, logits = _sample(logits)
            return nxt, logits, caches
        return decode

    def decode(params, caches, token, cache_len):
        logits, _, caches = M.forward(params, cfg, {"tokens": token},
                                      caches=caches, cache_len=cache_len)
        nxt, logits = _sample(logits)
        return nxt, logits, caches

    return decode


def make_paged_prefill_step(cfg: ModelConfig):
    """prefill_chunk(params, caches, tokens, cache_len, chunk_lens, pages)
    -> (next_token (R,) int32, caches).

    One continuous-batching prefill tick: ``tokens`` is an (R, C) batch of
    RIGHT-ALIGNED prompt chunks (row i's last ``chunk_lens[i]`` columns are
    real), ``cache_len`` each row's valid length AFTER this chunk, and
    ``pages`` the rows' page-index vectors.  The chunk's K/V go into the
    page store and attend causally to everything already paged.
    ``next_token`` (argmax at the last column) is the request's first
    generated token when this was its final chunk; rows mid-prompt and
    padding rows (``chunk_lens == 0``) return a token the scheduler
    ignores."""

    def prefill(params, caches, tokens, cache_len, chunk_lens, pages):
        logits, _, caches = M.forward(params, cfg, {"tokens": tokens},
                                      caches=caches, cache_len=cache_len,
                                      pages=pages, new_lens=chunk_lens)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt, caches

    return prefill
