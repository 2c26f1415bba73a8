"""Elastic scaling: place a checkpointed train state, and re-derive the
microbatching when the data-parallel width changes.

The port of ``repro.ft.elastic`` on one card.  Checkpoints store full
(unsharded) arrays, so restoring them is a copy onto the device
(:func:`reshard_tree`); ``repro``'s sharded form, which lays a tree out
over a mesh with its rules' specs, waits for the port's multi-device work
(ROADMAP.md, M12).  The shard-index rebalance is the data pipeline's
(``data.pipeline.ShardIndex.rebalance``, the writer path of its BRAVO
lock).
"""

from __future__ import annotations

from typing import Any

import torch

from ..device import DeviceLike, resolve
from .checkpoint import tree_flatten, tree_unflatten


def reshard_tree(tree: Any, like: Any, device: DeviceLike = None) -> Any:
    """Place a host tree (numpy arrays or CPU tensors, as
    ``ft.checkpoint.load_checkpoint`` returns it) on ``device`` (default:
    the CUDA card, raising if there is none), each leaf in the dtype of
    ``like``'s leaf at its place."""
    dev = resolve(device)
    leaves, treedef = tree_flatten(tree)
    want = tree_flatten(like)[0]
    if len(want) != len(leaves):
        raise ValueError(f"tree mismatch: {len(leaves)} leaves against "
                         f"{len(want)}")
    return tree_unflatten(treedef, [
        torch.as_tensor(a).to(device=dev, dtype=w.dtype)
        for a, w in zip(leaves, want)])


def remicrobatch(global_batch: int, dp: int, target_tokens: int,
                 seq_len: int) -> int:
    """Pick microbatch count for a new DP width (elastic restarts)."""
    tokens_per_dp = global_batch * seq_len // dp
    micro = max(1, tokens_per_dp // target_tokens)
    while global_batch % micro != 0 or (global_batch // micro) % dp != 0:
        micro -= 1
        if micro <= 1:
            return 1
    return micro
