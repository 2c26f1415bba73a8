"""Llama-3.2-1B [dense] — small llama3, GQA kv=8, tied embeddings.
[hf:meta-llama/Llama-3.2-1B; unverified]"""

from ..dist.sharding import MeshRules
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab=128256,
    tie_embeddings=True, rope_theta=500000.0,
)

SMOKE = ModelConfig(
    name="llama3.2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, tie_embeddings=True,
)

RULES = MeshRules(shard_heads=True)

SHAPES = ("train_4k", "prefill_32k", "decode_32k")
