"""phi3.5-moe-42b-a6.6b [moe]: 16 experts top-2.

32L d=4096 32H kv=8 d_ff=6400 v=32064.
Expert sharding: "ep" (16 experts shard exactly over the 16-way model axis).
[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    num_experts=16,
    experts_per_token=2,
    expert_sharding="ep",
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="phi3.5-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    num_experts=4,
    experts_per_token=2,
    expert_sharding="ep",
)
