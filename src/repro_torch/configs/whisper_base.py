"""whisper-base [audio]: encoder-decoder, conv frontend STUBBED.

6L enc + 6L dec, d=512, 8H MHA, d_ff=2048, v=51865 (padded to 51968 for TP
divisibility — noted in DESIGN.md).  input_specs supplies precomputed
(B, 1500, 512) frame embeddings in place of the mel+conv frontend.
[arXiv:2212.04356; unverified]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51968,  # 51865 padded to a multiple of 256
    encoder_layers=6,
    encoder_seq=1500,
    max_target_positions=448,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    encoder_layers=2,
    encoder_seq=32,
    max_target_positions=64,
)
