"""Granite-20B (code) [dense] — MQA (kv=1), wide FFN (gpt-bigcode style,
non-GLU GELU).  [arXiv:2405.04324; hf]"""

from ..dist.sharding import MeshRules
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab=49152,
    glu=False, act="gelu",
)

SMOKE = ModelConfig(
    name="granite-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=256, vocab=512, glu=False, act="gelu",
)

RULES = MeshRules(shard_heads=True)  # 48 % 16 == 0; kv=1 replicated

SHAPES = ("train_4k", "prefill_32k", "decode_32k")
