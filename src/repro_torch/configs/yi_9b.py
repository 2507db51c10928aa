"""yi-9b [dense]: llama-arch GQA.  48L d=4096 32H kv=4 d_ff=11008 v=64000.

[arXiv:2403.04652; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="yi-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_ff=160,
    vocab_size=256,
)
