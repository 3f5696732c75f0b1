"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2.  [hf:xai-org/grok-1]

8 experts on a 16-wide model axis -> virtual experts r=2 (each expert
tensor-split in two; DESIGN.md §5).  Primary MixNet target arch.
"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=32768,
    vocab_size=131072,
    head_dim=128,
    moe=MoEConfig(
        num_experts=8,
        top_k=2,
        d_ff=32768,
        capacity_factor=1.25,
        backend="einsum",  # baseline; perf path flips to "mixnet"
        a2a_group=4,
    ),
    act="gelu",
    dtype="bfloat16",
    opt_moment_dtype="bfloat16",  # 314B total params
    remat="full",
)
