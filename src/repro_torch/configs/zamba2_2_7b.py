"""Zamba2-2.7B [hybrid] — 54 Mamba-2 blocks + a shared attention block
(every 6th position, per-site LoRA), ssm_state=64.  Hybrid -> runs the 500k
long-context decode shape with the attention KV cache sequence-sharded.
[arXiv:2411.15242; hf]"""

from ..dist.sharding import MeshRules
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab=32000,
    ssm_kind="mamba2", ssm_state=64, ssm_expand=2, hybrid_attn_every=6,
)

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512,
    ssm_kind="mamba2", ssm_state=16, ssm_expand=2, hybrid_attn_every=2,
)

RULES = MeshRules(shard_heads=True, shard_kv_heads=True)

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
