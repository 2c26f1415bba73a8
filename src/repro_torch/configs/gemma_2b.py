"""Gemma-2B [dense] — GeGLU, head_dim=256, MQA (kv=1), 256k vocab, tied
embeddings.  [arXiv:2403.08295; hf]"""

from ..dist.sharding import MeshRules
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256000,
    act="gelu", glu=True, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=32,
    d_ff=192, vocab=512, act="gelu", glu=True, tie_embeddings=True,
)

# 8 heads < |model|=16: attention activations replicated over model; the
# (huge) 256k-vocab embedding + GeGLU FFN carry the TP sharding instead.
RULES = MeshRules(shard_heads=False, attn_impl="seqshard")

SHAPES = ("train_4k", "prefill_32k", "decode_32k")
