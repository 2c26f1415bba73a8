"""Phi-3.5-MoE 42B-A6.6B [moe] — 16 experts, top-2 routing, every layer MoE,
GQA kv=8.  [hf:microsoft/Phi-3.5-MoE-instruct; hf]"""

import torch

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=6400, vocab=32064,
    moe_experts=16, moe_top_k=2, moe_every=1, moe_shared_expert=False,
    moe_d_ff=6400,
    # 16 experts fit one-per-chip at bf16 -> fully resident experts
    # (no ff sharding, no per-layer gathers); m/v are ZeRO-1 sharded.
    param_dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="phi3.5-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab=512,
    moe_experts=4, moe_top_k=2, moe_every=1, moe_d_ff=96,
)

SHAPES = ("train_4k", "prefill_32k", "decode_32k")
