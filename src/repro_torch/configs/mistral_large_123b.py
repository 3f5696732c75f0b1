"""mistral-large-123b [dense] — 88L d_model=12288 96H (GQA kv=8)
d_ff=28672 vocab=32768.  [hf:mistralai/Mistral-Large-Instruct-2407]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    head_dim=128,
    rope_theta=1_000_000.0,
    act="silu",
    dtype="bfloat16",
    opt_moment_dtype="bfloat16",  # 123B: fp32 moments would blow HBM
    remat="full",
)
