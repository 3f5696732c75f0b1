"""The paper's own evaluated MoE models (Table 1 / §D.1) as netsim
``SimModel``s, used to reproduce Figs 11-14/25-28, plus a trainable
Mixtral-8x7B ``ModelConfig`` for the end-to-end runs (the prototype of Fig.
10, hf:mistralai/Mixtral-8x7B-v0.1).  A copy of
:mod:`repro.configs.paper_models`; the ``SimModel`` entries keep the
reference's A100 compute and memory constants (simulated cluster, not the
card).
"""

from repro_torch.core.netsim import SimModel
from repro_torch.models.config import ModelConfig, MoEConfig

__all__ = [
    "MIXTRAL_8X7B", "MIXTRAL_8X22B", "QWEN_MOE", "DEEPSEEK_R1", "SIM_MODELS",
    "PAPER_SCALE_GPUS", "scale_layout", "MIXTRAL_8X7B_CONFIG",
]

# ---- netsim models (Table 1 + §D.1 parallelization) -----------------------

MIXTRAL_8X7B = SimModel(
    "mixtral-8x7b", num_blocks=32, d_model=4096, d_ff=14336, num_experts=8,
    top_k=2, num_heads=32, ep_degree=8, tp_degree=4, pp_degree=4,
)
MIXTRAL_8X22B = SimModel(
    "mixtral-8x22b", num_blocks=56, d_model=6144, d_ff=16384, num_experts=8,
    top_k=2, num_heads=48, ep_degree=8, tp_degree=8, pp_degree=8,
)
QWEN_MOE = SimModel(
    "qwen-moe", num_blocks=24, d_model=2048, d_ff=1408, num_experts=64,
    top_k=4, num_heads=16, ep_degree=32, tp_degree=1, pp_degree=4,
)
DEEPSEEK_R1 = SimModel(
    "deepseek-r1", num_blocks=61, d_model=7168, d_ff=2048, num_experts=256,
    top_k=8, num_heads=128, ep_degree=64, tp_degree=1, pp_degree=16,
)

SIM_MODELS = {
    m.name: m for m in (MIXTRAL_8X7B, MIXTRAL_8X22B, QWEN_MOE, DEEPSEEK_R1)
}

# ---- paper-scale cluster shapes (Fig 26's sweep axis, DESIGN.md §13) ------

PAPER_SCALE_GPUS = (32, 64, 128, 256, 512, 1024)


def scale_layout(model: SimModel, num_gpus: int) -> SimModel:
    """Re-layout ``model``'s parallelism onto a ``num_gpus`` cluster.

    TP stays at the model's native degree (it is shape-bound: head count /
    d_ff divisibility); PP absorbs what the depth allows, EP takes the
    rest — the same priority order the paper's Table 1 layouts follow.
    Raises when ``num_gpus`` cannot be factored over the model's shape.
    """
    import dataclasses

    tp = model.tp_degree
    if num_gpus % tp:
        raise ValueError(f"{num_gpus} GPUs not divisible by tp={tp}")
    rest = num_gpus // tp
    # Deepest pipeline the block count supports without exceeding the
    # model's native stage count or the remaining GPU budget.
    pp = model.pp_degree
    while pp > 1 and (rest % pp or model.num_blocks % pp):
        pp //= 2
    ep = rest // pp
    if ep < 1:
        raise ValueError(f"{num_gpus} GPUs too few for tp={tp} x pp={pp}")
    return dataclasses.replace(model, ep_degree=ep, tp_degree=tp, pp_degree=pp)

# ---- trainable Mixtral-8x7B (prototype-scale examples, Fig 10) ------------

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
