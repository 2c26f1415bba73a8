"""Architecture configs (one module per arch) + the shape table.

Every module defines:
  CONFIG: ModelConfig          — the exact published configuration
  SMOKE:  ModelConfig          — reduced same-family config for CPU tests
  RULES:  MeshRules            — per-arch sharding rules (the mesh layer,
                                 ``dist.sharding``)
  SHAPES: tuple[str, ...]      — applicable input shapes

Every architecture of ``repro`` is here, in its order, and :func:`get`
returns ``(CONFIG, RULES, SHAPES)`` as ``repro``'s does.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

from ..dist.sharding import MeshRules
from ..models.common import ModelConfig

ARCH_IDS = (
    "llama4-maverick-400b-a17b",
    "phi3.5-moe-42b-a6.6b",
    "phi-3-vision-4.2b",
    "hubert-xlarge",
    "minicpm-2b",
    "granite-20b",
    "gemma-2b",
    "llama3.2-1b",
    "rwkv6-7b",
    "zamba2-2.7b",
)

_MODULES = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str     # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get(arch: str) -> Tuple[ModelConfig, MeshRules, Tuple[str, ...]]:
    """-> (ModelConfig, MeshRules, applicable shape names)."""
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.CONFIG, getattr(mod, "RULES", MeshRules()), mod.SHAPES


def get_smoke(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.SMOKE
