"""The paper's own trainable model config: Mixtral-8x7B, the prototype of
Fig. 10 (hf:mistralai/Mixtral-8x7B-v0.1).

A copy of ``MIXTRAL_8X7B_CONFIG`` from :mod:`repro.configs.paper_models`,
without the netsim ``SimModel`` entries (those import the simulator and
come with the evaluation slice).
"""

from repro_torch.models.config import ModelConfig, MoEConfig

__all__ = ["MIXTRAL_8X7B_CONFIG"]

MIXTRAL_8X7B_CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=14336, backend="mixnet"),
    act="silu",
    dtype="bfloat16",
    remat="full",
)
