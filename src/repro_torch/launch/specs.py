"""Shape-only stand-ins for every model input: tensors on the meta device,
which hold a shape and a dtype and allocate nothing.

The port of ``repro.launch.specs``, whose ``jax.ShapeDtypeStruct``\\ s
become meta tensors.  ``batch_specs`` gives a training or prefill batch,
``decode_specs`` a decode step's ``(caches, token, cache_len)`` and
``params_shape`` the parameter tree.  Frontend-stub archs (audio/vlm)
receive precomputed frame/patch embeddings.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..models import model as M
from ..models.common import ModelConfig

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, B: int, S: int) -> Dict[str, Any]:
    """Training/prefill batch: tokens + labels (+ stub frontend embeds)."""
    if cfg.family == "audio":
        return {"embeds": sds((B, S, cfg.d_model), torch.bfloat16),
                "labels": sds((B, S), torch.int32)}
    if cfg.frontend_tokens:
        F = cfg.frontend_tokens
        return {"tokens": sds((B, S - F), torch.int32),
                "embeds": sds((B, F, cfg.d_model), torch.bfloat16),
                "labels": sds((B, S), torch.int32)}
    return {"tokens": sds((B, S), torch.int32),
            "labels": sds((B, S), torch.int32)}


def decode_specs(cfg: ModelConfig, B: int, S: int,
                 cache_dtype=torch.bfloat16) -> Tuple[Any, ...]:
    """(caches, token, cache_len) stand-ins for a decode step with a KV/SSM
    cache of length S.  cache_len is a scalar (uniform batch), as in
    ``repro``'s serve-step contract."""
    caches = M.init_caches(cfg, B, S, dtype=cache_dtype, device=META)
    return caches, sds((B, 1), torch.int32), sds((), torch.int32)


def params_shape(cfg: ModelConfig):
    return M.init_params(0, cfg, device=META)
