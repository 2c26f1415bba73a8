"""int8 error-feedback gradient compression for the data-parallel
all-reduce, on tensors.

Each rank quantizes its local gradient to int8 (per-leaf absmax scale),
all-reduces the int8 payload (8x fewer bytes over the wire; summation in
int32), dequantizes, and keeps the quantization residual locally, adding it
back into the next step's gradient (error feedback) so the compression bias
vanishes over time [Seide et al., Karimireddy et al.].

The port of ``repro.ft.compression``'s two leaf functions.  Its
``make_compressed_psum``, the all-reduce over a device mesh, needs a
process group over several devices and waits for the port's multi-device
work (ROADMAP.md, M12).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


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
