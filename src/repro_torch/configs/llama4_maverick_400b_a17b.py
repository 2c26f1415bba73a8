"""Llama-4 Maverick 400B-A17B [moe] — interleaved MoE (every other layer),
128 routed experts top-1 + one shared expert, GQA kv=8, early-fusion
multimodal (text path only here).  [hf:meta-llama/Llama-4-*; unverified]"""

import torch

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048,
    moe_experts=128, moe_top_k=1, moe_every=2, moe_shared_expert=True,
    moe_d_ff=8192, rope_theta=500000.0,
    # 400B on 16GB chips: bf16 master weights + bf16 Adam moments
    # (EXPERIMENTS.md §Dry-run memory table documents the fit)
    param_dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="llama4-smoke", family="moe",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512,
    moe_experts=8, moe_top_k=1, moe_every=2, moe_shared_expert=True,
    moe_d_ff=128,
)

SHAPES = ("train_4k", "prefill_32k", "decode_32k")  # full attention: no 500k
