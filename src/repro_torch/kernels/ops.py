"""Public wrappers for the kernels: the names and argument order of
``repro.kernels.ops`` for all ten, the table kernels K1-K4, the paged
attention kernels K5/K6 and their variants over the quantized page store,
K7/K8, and the legacy table kernels K9 (``revocation_scan``) and K10
(``publish``, ``clear``).

Where ``repro``'s wrappers consumed the table buffer (donation and
``input_output_aliases``), these update the caller's table tensor in place
and return that same tensor; ``publish`` and ``clear`` return a new table,
as ``repro``'s legacy kernel did.  A CPU tensor takes the plain version
(``kernels.ref``); a CUDA tensor launches the hand-written kernel in
``csrc/table_kernels.cu`` or ``csrc/paged_attn.cu``, or raises.

The paged kernels' plans read one knob each from the autotune table,
``tuning_table.json`` beside this module (:func:`tuned`), written by
``kernels/autotune.py``: K5/K7 ``min_split_positions`` (the least KV
positions worth a split of the grid) and K6/K8 ``pairs`` ((column, query
head) pairs a CTA).  The table is keyed by kernel, then by the card's name
(``torch.cuda.get_device_name``), then by knob; it is read once per process
and cached on the host, so a plan stays a host computation, legal inside a
CUDA graph capture.  A missing file, card or knob, 0, or a value outside
the knob's candidates gives the plan the wrapper computes without a table.
"""

from __future__ import annotations

import functools
import json
import pathlib
from typing import Dict

import torch

from . import paged_attn as _pa
from . import paged_chunk_attn as _pca
from . import table_publish as _pub
from . import table_scan as _scan
from .table_publish import LANES

__all__ = ["as_table2d", "revocation_scan", "revocation_poll",
           "revocation_poll_multi", "publish", "clear",
           "fused_publish", "fused_publish_multi", "fused_clear",
           "paged_attention", "paged_attention_quant",
           "paged_chunk_attention", "paged_chunk_attention_quant", "LANES",
           "COUNTERS", "launch_counts", "reset_launch_counts", "tuned",
           "TUNING_PATH"]

# one launch counter per kernel, keyed by the ``repro.kernels.ops`` name
COUNTERS = {c.name: c for c in (_pub.FUSED_PUBLISH_MULTI, _pub.FUSED_PUBLISH,
                                _scan.REVOCATION_POLL,
                                _scan.REVOCATION_POLL_MULTI,
                                _pa.PAGED_ATTENTION,
                                _pca.PAGED_CHUNK_ATTENTION,
                                _pa.PAGED_ATTENTION_QUANT,
                                _pca.PAGED_CHUNK_ATTENTION_QUANT,
                                _scan.REVOCATION_SCAN, _pub.PUBLISH)}


TUNING_PATH = pathlib.Path(__file__).with_name("tuning_table.json")


@functools.lru_cache(maxsize=None)
def _tuning() -> dict:
    try:
        return json.loads(TUNING_PATH.read_text())
    except (OSError, ValueError):
        return {}


@functools.lru_cache(maxsize=None)
def tuned(kernel: str, knob: str, device_index: int) -> int:
    """The autotune table's ``knob`` of ``kernel`` (``repro``'s kernel
    names: ``paged_attn``, ``paged_attn_quant``, ``paged_chunk_attn``,
    ``paged_chunk_attn_quant``) for the card at ``device_index``; 0 (the
    wrapper's own plan) where the table has none.  Cached: the file and
    the card's name are read once per process."""
    card = torch.cuda.get_device_name(device_index)
    v = _tuning().get(kernel, {}).get(card, {}).get(knob, 0)
    return v if isinstance(v, int) and not isinstance(v, bool) else 0


def launch_counts() -> Dict[str, int]:
    return {name: c.value for name, c in COUNTERS.items()}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.reset()


def as_table2d(table_flat: torch.Tensor) -> torch.Tensor:
    n = table_flat.shape[0]
    if n % LANES:
        raise ValueError(f"table of {n} slots is not a multiple of {LANES}")
    return table_flat.reshape(n // LANES, LANES)


def revocation_scan(table2d: torch.Tensor, lock_id):
    """Revocation scan: -> (int8 match mask (rows, 128), exact int32
    count); ``rows`` must be a multiple of 8."""
    return _scan.revocation_scan(table2d, lock_id)


def publish(table2d: torch.Tensor, slots: torch.Tensor, ids: torch.Tensor):
    """Legacy batched CAS(0 -> id), one request after another:
    -> (NEW table, granted bool (M,))."""
    return _pub.publish(table2d, slots, ids, unconditional=False)


def clear(table2d: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Legacy release: store 0 into each slot.  -> NEW table."""
    return _pub.clear(table2d, slots)


def fused_publish(table2d: torch.Tensor, rbias: torch.Tensor,
                  slots: torch.Tensor, ids: torch.Tensor):
    """Batched CAS(0 -> id), masked by ``rbias != 0`` in kernel.
    -> (table [updated in place], granted bool (M,))."""
    return _pub.fused_publish(table2d, rbias, slots, ids,
                              unconditional=False, check_rbias=True)


def fused_clear(table2d: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Release: store 0 into each slot, in place; slot -1 is a no-op."""
    ones = torch.ones((), dtype=torch.int32, device=table2d.device)
    table2d, _ = _pub.fused_publish(table2d, ones, slots,
                                    torch.zeros_like(slots),
                                    unconditional=True, check_rbias=False)
    return table2d


def fused_publish_multi(table2d: torch.Tensor, rbias_vec: torch.Tensor,
                        slots: torch.Tensor, lock_idx: torch.Tensor,
                        ids: torch.Tensor):
    """Multi-lock batched CAS(0 -> id): each request is rechecked against
    its OWN lock's bias, gathered from ``rbias_vec`` inside the kernel.
    -> (table [updated in place], granted bool (M,))."""
    return _pub.fused_publish_multi(table2d, rbias_vec, slots, lock_idx, ids)


def revocation_poll(table2d: torch.Tensor, lock_id) -> torch.Tensor:
    """Drain poll: the exact number of slots publishing ``lock_id`` (which
    meets ``repro``'s contract: 0 iff none, else a positive lower bound)."""
    return _scan.revocation_poll(table2d, lock_id)


def revocation_poll_multi(table2d: torch.Tensor,
                          lock_ids: torch.Tensor) -> torch.Tensor:
    """Exact hold counts for a vector of lock values in ONE table pass."""
    return _scan.revocation_poll_multi(table2d, lock_ids)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, page_idx: torch.Tensor,
                    cache_len: torch.Tensor) -> torch.Tensor:
    """Decode attention by page index (K5).  q: (B, H, hd); k/v_pages:
    (n_pages, page_size, KVH, hd); page_idx: (B, P) int32 (-1 = unused
    lane); cache_len: (B,) int32.  -> (B, H, hd); the dense (B, S, KVH, hd)
    cache is never built."""
    return _pa.paged_attention(q, k_pages, v_pages, page_idx, cache_len)


def paged_chunk_attention(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_idx: torch.Tensor,
                          cache_len: torch.Tensor,
                          new_lens: torch.Tensor) -> torch.Tensor:
    """Chunk-prefill attention by page index (K6).  q: (B, S, H, hd)
    right-aligned chunks; cache_len: (B,) total valid length AFTER the
    chunk; new_lens: (B,) valid trailing columns.  -> (B, S, H, hd),
    padding columns zero."""
    return _pca.paged_chunk_attention(q, k_pages, v_pages, page_idx,
                                      cache_len, new_lens)


def paged_attention_quant(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, k_scale: torch.Tensor,
                          v_scale: torch.Tensor, page_idx: torch.Tensor,
                          cache_len: torch.Tensor) -> torch.Tensor:
    """Quantized-pool decode attention (K7): the contract of
    :func:`paged_attention` with int8 k/v_pages and (n_pages, KVH) float32
    per-page scales (``kernels.quant`` layout), dequantized in the kernel."""
    return _pa.paged_attention_quant(q, k_pages, v_pages, k_scale, v_scale,
                                     page_idx, cache_len)


def paged_chunk_attention_quant(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, k_scale: torch.Tensor,
                                v_scale: torch.Tensor, page_idx: torch.Tensor,
                                cache_len: torch.Tensor,
                                new_lens: torch.Tensor) -> torch.Tensor:
    """Quantized-pool chunk-prefill attention (K8): the contract of
    :func:`paged_chunk_attention` with int8 k/v_pages and (n_pages, KVH)
    float32 per-page scales, dequantized in the kernel."""
    return _pca.paged_chunk_attention_quant(q, k_pages, v_pages, k_scale,
                                            v_scale, page_idx, cache_len,
                                            new_lens)
