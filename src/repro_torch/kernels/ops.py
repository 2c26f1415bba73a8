"""Public wrappers for the table kernels: the names and argument order of
``repro.kernels.ops`` for the four kernels this port has (K1-K4).

Where ``repro``'s wrappers consumed the table buffer (donation and
``input_output_aliases``), these update the caller's table tensor in place
and return that same tensor.  A CPU tensor takes the plain version
(``kernels.ref``); a CUDA tensor launches the hand-written kernel in
``csrc/table_kernels.cu`` or raises.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import table_publish as _pub
from . import table_scan as _scan
from .table_publish import LANES

__all__ = ["as_table2d", "revocation_poll", "revocation_poll_multi",
           "fused_publish", "fused_publish_multi", "fused_clear", "LANES",
           "COUNTERS", "launch_counts", "reset_launch_counts"]

# one launch counter per kernel, keyed by the ``repro.kernels.ops`` name
COUNTERS = {c.name: c for c in (_pub.FUSED_PUBLISH_MULTI, _pub.FUSED_PUBLISH,
                                _scan.REVOCATION_POLL,
                                _scan.REVOCATION_POLL_MULTI)}


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
