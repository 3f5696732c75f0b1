"""deepseek-v2-236b [moe] — 60L d_model=5120 128H (kv=128 via MLA)
d_ff=1536 per expert, vocab=102400 — MLA kv_lora=512, 2 shared + 160
routed experts top-6.  [arXiv:2405.04434]

Primary MixNet target arch: 160 experts over the 16-wide model axis =
10 experts/device, sparse shifting all-to-all.
"""

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=1536,
    vocab_size=102400,
    head_dim=128,
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=1536,
        nope_head_dim=128,
        rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=160,
        top_k=6,
        d_ff=1536,
        num_shared_experts=2,
        capacity_factor=1.25,
        backend="einsum",
        a2a_group=4,
    ),
    act="silu",
    dtype="bfloat16",
    opt_moment_dtype="bfloat16",
    remat="full",
)
