"""HuBERT X-Large [audio] — encoder-only (bidirectional), conv feature
frontend STUBBED (input_specs provides frame embeddings); masked-prediction
head over 504 clusters.  [arXiv:2106.07447; unverified]"""

from ..dist.sharding import MeshRules
from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab=504,
    causal=False, use_rope=False, glu=False, act="gelu",
    frontend="audio_stub",
)

SMOKE = ModelConfig(
    name="hubert-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=64, causal=False, use_rope=False, glu=False, act="gelu",
    frontend="audio_stub",
)

RULES = MeshRules(shard_heads=True, shard_kv_heads=True)

# encoder-only: no decode step (DESIGN.md §Arch-applicability)
SHAPES = ("train_4k", "prefill_32k")
