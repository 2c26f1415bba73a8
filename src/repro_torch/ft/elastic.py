"""Elastic scaling: place a checkpointed train state, and re-derive the
microbatching when the data-parallel width changes.

The port of ``repro.ft.elastic``.  Checkpoints store full (unsharded)
arrays, so restoring them is a copy onto the device; with a mesh of ranks
(``launch.mesh``) and its rules, :func:`reshard_tree` hands each rank its
block of every leaf under ``param_specs`` — the addressable shard JAX
gives the device at the same mesh coordinates — and
:func:`reshard_opt_state` the AdamW state's blocks under ``zero1_specs``
(the sharded train step's layout).  Loading a whole checkpoint and placing
it so restores a sharded train state on any mesh shape: the elastic
restart.  The shard-index rebalance
is the data pipeline's (``data.pipeline.ShardIndex.rebalance``, the
writer path of its BRAVO lock).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..device import DeviceLike, resolve
from ..dist.sharding import (MeshRules, P, param_specs, shard_block,
                             zero1_specs)
from .checkpoint import tree_flatten, tree_unflatten


def reshard_tree(tree: Any, tree_shape: Any,
                 rules: Optional[MeshRules] = None, mesh=None,
                 decode: bool = False, device: DeviceLike = None) -> Any:
    """Place a host tree (numpy arrays or CPU tensors, as
    ``ft.checkpoint.load_checkpoint`` returns it) on ``device`` (default:
    the CUDA card, raising if there is none), each leaf in the dtype of
    ``tree_shape``'s leaf at its place.  With ``mesh`` (and ``rules``,
    default ``MeshRules()``), each leaf is this rank's block under the
    rule-derived specs (``param_specs(tree_shape, rules, mesh,
    decode)``)."""
    dev = resolve(device)
    leaves, treedef = tree_flatten(tree)
    want = tree_flatten(tree_shape)[0]
    if len(want) != len(leaves):
        raise ValueError(f"tree mismatch: {len(leaves)} leaves against "
                         f"{len(want)}")
    if mesh is None:
        return tree_unflatten(treedef, [
            torch.as_tensor(a).to(device=dev, dtype=w.dtype)
            for a, w in zip(leaves, want)])
    specs = param_specs(tree_shape, rules or MeshRules(), mesh,
                        decode=decode)

    # each rank's block is cut on the host, so only the block reaches the
    # device
    def block(node, spec):
        if isinstance(node, dict):
            return {k: block(v, spec[k]) for k, v in node.items()}
        if node is None:
            return None
        return shard_block(torch.as_tensor(node), spec, mesh)

    blocks = tree_flatten(block(tree, specs))[0]
    return tree_unflatten(treedef, [
        b.to(device=dev, dtype=w.dtype, copy=True)
        for b, w in zip(blocks, want)])


def reshard_opt_state(state: Any, params_shape: Any,
                      rules: Optional[MeshRules] = None, mesh=None,
                      device: DeviceLike = None) -> Any:
    """Place a host AdamW state ``{"m", "v", "step"}`` (as
    ``ft.checkpoint.load_checkpoint`` returns it) on ``device``: the
    moments in the dtype the checkpoint holds, each this rank's block
    under ``zero1_specs`` of ``param_specs(params_shape, rules, mesh)``,
    the step count whole.  Beside :func:`reshard_tree` for the
    parameters, this restores a sharded train step's trees."""
    dev = resolve(device)
    specs = zero1_specs(param_specs(params_shape, rules or MeshRules(),
                                    mesh), params_shape, mesh)

    def block(node, spec):
        if isinstance(node, dict):
            return {k: block(v, spec[k]) for k, v in node.items()}
        return shard_block(torch.as_tensor(node), spec, mesh).to(
            device=dev, copy=True)

    return {"m": block(state["m"], specs), "v": block(state["v"], specs),
            "step": shard_block(torch.as_tensor(state["step"]), P(),
                                mesh).to(device=dev, copy=True)}


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
