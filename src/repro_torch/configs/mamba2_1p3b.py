"""mamba2-1.3b [ssm] — 48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060]

Attention-free and O(1)-state decode -> runs the long_500k cell.
"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=64,  # SSD heads = expand*d_model / head_dim
    num_kv_heads=1,
    d_ff=0,
    vocab_size=50288,  # 50280 padded to a multiple of 16 for vocab sharding
    head_dim=64,
    block_pattern=("ssm",),
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk=256),
    tie_embeddings=True,
    dtype="bfloat16",
    remat="full",
)
