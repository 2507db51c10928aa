"""llama-3.2-vision-90b [vlm]: 100L (80 self + 20 cross), d=8192, 64H GQA kv=8.

[hf:meta-llama/Llama-3.2-11B-Vision scaled per assignment; unverified]
Vision frontend is a STUB: input_specs supplies precomputed patch embeddings
(B, num_image_tokens, d_model); cross-attn layers (zero-init tanh gate) attend
to them after every 4 self-attention layers.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_attn_segment=5,  # [4 self | 1 cross] x 20
    num_image_tokens=1024,
    rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama-3.2-vision-smoke",
    family="vlm",
    num_layers=5,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    cross_attn_segment=5,
    num_image_tokens=16,
)
