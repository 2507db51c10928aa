"""zamba2-2.7b [hybrid]: 54 Mamba-2 layers + shared attention block every 6.

[arXiv:2411.15242; hf]  d=2560, shared block: 32H GQA kv=32, d_ff=10240,
Mamba-2 with d_state=64, head_dim=64, expand=2.  The shared transformer block
is weight-tied across its 9 applications (zamba2's signature trick).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    ssm_version=2,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_every=6,
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="hybrid",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    ssm_version=2,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_expand=2,
    shared_attn_every=2,
    ssm_chunk=32,
)
