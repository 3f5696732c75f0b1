"""whisper-base [audio] — 6L d_model=512 8H d_ff=2048 vocab=51865 —
encoder-decoder; conv/mel frontend is a STUB (``input_specs`` provides
1500 precomputed frame embeddings).  [arXiv:2212.04356]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,  # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51872,  # 51865 padded to a multiple of 16 for vocab sharding
    head_dim=64,
    encoder_layers=6,
    encoder_seq=1500,
    act="gelu",
    dtype="bfloat16",
    remat="full",
)
