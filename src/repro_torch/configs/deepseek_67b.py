"""deepseek-67b [dense]: deep-narrow llama-arch.  95L d=8192 64H kv=8
d_ff=22016 v=102400.  [arXiv:2401.02954; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="deepseek-smoke",
    family="dense",
    num_layers=4,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_ff=192,
    vocab_size=256,
)
