"""splitmix64 slot hashing for the visible-readers table, in PyTorch.

``repro.kernels.hash`` computes the finalizer over uint32 limb pairs
because its device has no 64-bit integer lanes.  PyTorch has ``int64`` on
every device but no usable unsigned 64-bit arithmetic, so here the same
finalizer runs in wrapping ``int64``: multiplication and addition wrap mod
2**64 exactly as they would in ``uint64``, and each right shift is masked
to make it logical.  The results are bit-exact with :func:`mix_hash_u64`
(the numpy ``uint64`` oracle, kept verbatim) and with ``repro``'s limb
variant.  The CUDA kernels hash in native ``uint64`` (``csrc/``); this is
their plain version.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["mix_hash_u64", "mix_hash_i64", "hash_slots", "split64",
           "MASK32"]

MASK32 = 0xFFFFFFFF

# splitmix64 constants
_K1 = 0x9E3779B97F4A7C15
_K2 = 0xBF58476D1CE4E5B9
_K3 = 0x94D049BB133111EB


def _signed(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_S1, _S2, _S3 = _signed(_K1), _signed(_K2), _signed(_K3)


def split64(x: int) -> Tuple[int, int]:
    """Python int -> (hi, lo) uint32 limb values."""
    x &= 0xFFFFFFFFFFFFFFFF
    return (x >> 32) & MASK32, x & MASK32


def mix_hash_u64(lock_id: int, thread_ids: np.ndarray) -> np.ndarray:
    """Vectorized ``core.table.mix_hash`` over a reader-id vector (numpy
    ``uint64`` host oracle)."""
    t = np.asarray(thread_ids).astype(np.uint64)
    x = np.uint64(lock_id * _K1 & 0xFFFFFFFFFFFFFFFF) + t * _K2
    x ^= x >> np.uint64(30)
    x *= np.uint64(_K2)
    x ^= x >> np.uint64(27)
    x *= np.uint64(_K3)
    x ^= x >> np.uint64(31)
    return x


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits (``>>`` on int64 is arithmetic)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def mix_hash_i64(lock: torch.Tensor, tid: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer over int64 tensors holding uint64 bit patterns;
    the two inputs broadcast.  -> int64 with the uint64 result's bits."""
    x = lock * _S1 + tid * _S2
    x = x ^ _shr(x, 30)
    x = x * _S2
    x = x ^ _shr(x, 27)
    x = x * _S3
    return x ^ _shr(x, 31)


def _u64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) 32-bit limbs of any integer dtype -> int64 bit pattern."""
    return ((hi.to(torch.int64) & MASK32) << 32) | (lo.to(torch.int64)
                                                     & MASK32)


def hash_slots(lock_hi, lock_lo, tid_hi, tid_lo, n_slots: int) -> torch.Tensor:
    """Vectorized ``slots_for``: -> int32 slot indices in ``[0, n_slots)``.

    Same contract as ``repro.kernels.hash.hash_slots``: each id is given as
    (hi, lo) 32-bit limbs (int32 or int64 tensors; int32 limbs are read as
    their uint32 bits), and the inputs broadcast.  ``n_slots`` must be a
    power of two."""
    if n_slots <= 0 or n_slots & (n_slots - 1):
        raise ValueError(f"n_slots must be a power of two, got {n_slots}")
    h = mix_hash_i64(_u64(lock_hi, lock_lo), _u64(tid_hi, tid_lo))
    return (h & (n_slots - 1)).to(torch.int32)
