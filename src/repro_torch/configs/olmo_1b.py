"""olmo-1b [dense]: non-parametric LayerNorm (no scale/bias).

16L d=2048 16H kv=16 (MHA) d_ff=8192 v=50304.  [arXiv:2402.00838; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="layernorm_np",
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="olmo-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=256,
    norm="layernorm_np",
)
