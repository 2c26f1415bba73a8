"""RWKV-6 "Finch" 7B [ssm] — attention-free, data-dependent decay, O(1)
decode state -> runs the 500k long-context decode shape.
[arXiv:2404.05892; hf]"""

from ..dist.sharding import MeshRules
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
    d_ff=14336, vocab=65536,
    use_rope=False,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke", family="ssm",
    n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, head_dim=64,
    d_ff=256, vocab=512, use_rope=False,
)

RULES = MeshRules(shard_heads=True)

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
