"""int8 error-feedback gradient compression for the data-parallel
all-reduce, on tensors.

Each rank quantizes its local gradient to int8 (per-leaf absmax scale),
all-reduces the int8 payload (8x fewer bytes over the wire; summation in
int32), dequantizes, and keeps the quantization residual locally, adding it
back into the next step's gradient (error feedback) so the compression bias
vanishes over time [Seide et al., Karimireddy et al.].

The port of ``repro.ft.compression``.  :func:`make_compressed_psum` is
the all-reduce over the data-parallel axes of a mesh of ranks
(``launch.mesh``): each rank's leaf goes in, the int8 payloads sum in int32
(one ``all_reduce`` per axis) and the scales reduce by max.  It runs on any
world; the card's smoke run holds it on a world of one rank over NCCL, the
CPU tests on gloo worlds of 2-8 ranks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..dist.sharding import P, mesh_view, pmax, psum, shard_map_compat


def compress_grads_int8(g: torch.Tensor,
                        err: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (q int8, scale float32 scalar, new_err) with error feedback."""
    g32 = g.float()
    if err is not None:
        g32 = g32 + err
    scale = torch.clamp(g32.abs().max(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, g32 - deq


def decompress_grads_int8(q_sum: torch.Tensor, scale_max: torch.Tensor,
                          n_ranks: int) -> torch.Tensor:
    # payload summed in int32; every rank used its own scale, we conservatively
    # dequantize with the max scale (bounded error, absorbed by feedback)
    return q_sum.float() * scale_max


def make_compressed_psum(mesh, axes: Tuple[str, ...]):
    """Returns mean_compressed(grad_leaf, err) -> (mean_grad, new_err),
    leafwise over ``axes``: ``grad_leaf`` and ``err`` are this rank's; the
    mean and the new error come back to every rank."""
    n = 1
    for a in axes:
        n *= mesh_view(mesh).shape[a]

    def body(g, err):
        q, scale, new_err = compress_grads_int8(g, err)
        q_sum = psum(q.to(torch.int32), axes)
        s_max = pmax(scale, axes)
        mean = decompress_grads_int8(q_sum, s_max, n) / n
        return mean, new_err

    def one_leaf(g, err):
        spec = P(*([None] * g.dim()))
        return shard_map_compat(body, mesh, in_specs=(spec, spec),
                         out_specs=(spec, spec))(g, err)

    return one_leaf
