"""deepseek-67b [dense] — 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400 — llama-arch.  [arXiv:2401.02954]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    head_dim=128,
    rope_theta=10_000.0,
    act="silu",
    dtype="bfloat16",
    opt_moment_dtype="bfloat16",
    remat="full",
)
