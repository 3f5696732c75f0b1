"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (GQA kv=1)
d_ff=12288 vocab=256000 — RG-LRU + local attention at 2:1.
[arXiv:2402.19427]

38 layers = 12 x (rglru, rglru, local) + 2 tail RG-LRU blocks.
Sub-quadratic (local window 2048) -> runs the long_500k cell.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    block_pattern=("rglru", "rglru", "local"),
    tail_pattern=("rglru", "rglru"),
    window_size=2048,
    act="geglu",
    tie_embeddings=True,
    dtype="bfloat16",
    remat="full",
)
