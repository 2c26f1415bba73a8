"""Architecture configs (one module per arch) + the shape table.

Every module defines:
  CONFIG: ModelConfig          — the exact published configuration
  SMOKE:  ModelConfig          — reduced same-family config for CPU tests
  SHAPES: tuple[str, ...]      — applicable input shapes

``repro``'s modules also carry per-arch sharding rules (``RULES``); on one
card there is nothing to shard, so the port's have none and :func:`get`
returns ``(CONFIG, shapes)``.  The other architectures come with the slices
that port their model families (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

from ..models.common import ModelConfig

ARCH_IDS = (
    "llama3.2-1b",
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


def get(arch: str) -> Tuple[ModelConfig, Tuple[str, ...]]:
    """-> (ModelConfig, applicable shape names)."""
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.CONFIG, mod.SHAPES


def get_smoke(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.SMOKE
