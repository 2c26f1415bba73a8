"""Phi-3-vision 4.2B [vlm] — phi3-mini text backbone + CLIP frontend (STUB:
input_specs provides precomputed patch embeddings).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""

from ..models.common import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
    d_ff=8192, vocab=32064,
    frontend="vision_stub", frontend_tokens=256,
    rope_theta=10000.0,
)

SMOKE = ModelConfig(
    name="phi3v-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512, frontend="vision_stub", frontend_tokens=8,
)

SHAPES = ("train_4k", "prefill_32k", "decode_32k")
