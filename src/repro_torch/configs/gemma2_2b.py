"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000 — local/global alternating attention, logit softcaps.
[arXiv:2408.00118]

8 heads < the 16-wide model axis -> sequence-sharded attention
(ShardingPlan.heads_axis returns None; activations stay seq-sharded).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    d_ff=9216,
    vocab_size=256000,
    head_dim=256,
    block_pattern=("local", "global"),
    window_size=4096,
    logit_softcap=50.0,
    final_softcap=30.0,
    act="geglu",
    tie_embeddings=True,
    dtype="bfloat16",
    remat="full",
)
