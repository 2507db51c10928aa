"""mixtral-8x22b [moe]: 8 experts top-2, sliding-window attention.

56L d=6144 48H kv=8 d_ff=16384 v=32768, SWA window 4096.
Expert sharding: "tp" (expert FFN width sharded over the model axis) because
8 experts do not divide the 16-way model axis.  [arXiv:2401.04088; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    experts_per_token=2,
    expert_sharding="tp",
    sliding_window=4096,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="mixtral-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    num_experts=4,
    experts_per_token=2,
    expert_sharding="tp",
    sliding_window=32,
)
