"""MiniCPM-2B [dense] — llama-like, MHA (kv=36), tied embeddings, trained
with the WSD schedule (wired into training/optimizer.py).
[arXiv:2404.06395; hf]"""

from ..dist.sharding import MeshRules
from ..models.common import ModelConfig

import torch

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, head_dim=64,
    d_ff=5760, vocab=122753,
    tie_embeddings=True,
    # pure-SP training keeps weights replicated over model: bf16 master
    # weights so params+grads+ZeRO-1 moments fit (EXPERIMENTS.md §Perf it.6)
    param_dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="minicpm-smoke", family="dense",
    n_layers=2, d_model=72, n_heads=6, n_kv_heads=6, head_dim=12,
    d_ff=144, vocab=512, tie_embeddings=True,
)

# 36 heads % 16 != 0: weights shard on flattened q_dim (2304 % 16 == 0),
# head-split activations stay unsharded over model.
# §Perf iteration 6: 36 heads %% 16 != 0 made TP attention reshard every
# block (388GB/chip of residual gathers).  Pure sequence parallelism:
# weights replicated over model (except the 122k vocab), the residual
# stream stays (batch, seq/model, d) end to end -> attention/MLP run with
# ZERO per-layer collectives; only K/V gathers, grad reductions and the
# head remain.
RULES = MeshRules(shard_heads=False, attn_impl="seqshard",
                  tp_weights=False, residual_seq=True, fsdp=None)

SHAPES = ("train_4k", "prefill_32k", "decode_32k")
