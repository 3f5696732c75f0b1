"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — M-RoPE, dynamic resolution.  [arXiv:2409.12191]

Transformer BACKBONE only: the vision frontend is a STUB
(``input_specs`` provides precomputed patch embeddings spliced into the
first positions; text tokens use equal (t,h,w) positions = plain RoPE).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    vision_patches=1024,
    act="silu",
    dtype="bfloat16",
    opt_moment_dtype="bfloat16",
    remat="full",
)
