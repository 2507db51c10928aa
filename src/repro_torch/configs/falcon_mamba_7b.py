"""falcon-mamba-7b [ssm]: attention-free Mamba-1.

64L d=4096, d_inner=8192 (expand 2), d_state=16, conv k=4, v=65024.
[arXiv:2410.05355; unverified]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    ssm_version=1,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
)

SMOKE = ModelConfig(
    name="falcon-mamba-smoke",
    family="ssm",
    num_layers=3,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=256,
    ssm_version=1,
    ssm_state=8,
    ssm_conv=4,
    ssm_expand=2,
    ssm_chunk=32,
)
