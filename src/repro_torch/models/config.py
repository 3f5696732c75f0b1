"""Model configuration schema covering all assigned architecture families:
dense / MoE / SSM / hybrid (RG-LRU) / audio enc-dec / VLM backbones.

A model is a cycle of block kinds (``block_pattern``) scanned
``num_layers / len(pattern)`` times — this keeps the HLO small (one scan
body per pattern) while expressing alternating structures like gemma2's
local/global attention or recurrentgemma's 2:1 RG-LRU:attention ratio.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0  # routed experts
    top_k: int = 0
    d_ff: int = 0  # per-expert hidden width
    num_shared_experts: int = 0  # deepseek-v2 style always-on experts
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    balance_loss: float = 1e-2
    # Dispatch backend: "einsum" (GShard dense dispatch — the paper-faithful
    # baseline a fat-tree style fabric serves) or "mixnet" (hierarchical
    # shard_map all-to-all with runtime expert placement — the paper's
    # system, adapted per DESIGN.md).
    backend: str = "einsum"
    # Hierarchical a2a group size (scale-up stage width) for the mixnet path.
    a2a_group: int = 4
    # Fuse the payload + gate-metadata transfers of the mixnet dispatch into
    # ONE packed a2a (bit-identical payload; halves the phase count).  Off
    # only for the unfused-parity regression baseline.
    a2a_fuse: bool = True
    # Token-dispatch semantics (repro.models.routing): "dropless" routes every
    # token (MegaBlocks-style sort-based layout, static shapes; capacity_factor
    # ignored) or "capacity" drops overflow beyond the capacity_factor buffers.
    dispatch: str = "dropless"
    # Row-tile height of the dropless block layout (the grouped GEMM's unit of
    # expert ownership; 8 = f32 sublane minimum, raise towards 128 for MXU).
    dispatch_block: int = 8
    # Chunked comm/compute overlap (repro.core.overlap, DESIGN.md §8): the
    # mixnet backend splits the token dim into this many chunks and
    # software-pipelines chunk k+1's dispatch a2a under chunk k's expert FFN
    # under chunk k-1's combine a2a.  1 = the serial path; >1 is bit-identical
    # to it (chunk rows are independent; capacity-mode keep decisions stay
    # global).  Degrades to the nearest divisor of the local token count.
    overlap_chunks: int = 1
    # Decode-time MoE path (DESIGN.md §9): "dense" computes every expert on
    # the handful of live tokens (weight-stationary, the §Perf default);
    # "sparse" keeps the configured backend's sparse dispatch at decode — the
    # mixnet backend then runs the EP all-to-all (with wire perms) for every
    # decode tick, the serving engine's EP-sharded decode path.
    decode_backend: str = "dense"
    # Speculative-decoding draft pass (DESIGN.md §11): same weights, cheaper
    # routed fan-out.  "off" = the full model; "topk1" narrows routing to the
    # single best expert per token; "shared_only" skips the routed experts
    # entirely (shared-expert + attention only — free when
    # num_shared_experts > 0).  Being part of the frozen config makes the
    # draft step a *separate jit program* from the verify step.
    draft_mode: str = "off"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    nope_head_dim: int = 128
    rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD parameters."""

    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 64


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    # Block pattern cycled over layers. Kinds: "global" (full attention),
    # "local" (sliding window), "rglru" (RG-LRU recurrent), "ssm" (mamba2).
    block_pattern: tuple = ("global",)
    # Extra non-repeating blocks appended after the scanned stack (for layer
    # counts not divisible by the pattern, e.g. recurrentgemma's 38 = 12x3+2).
    tail_pattern: tuple = ()
    window_size: int = 4096
    logit_softcap: float | None = None  # gemma2 attention softcap
    final_softcap: float | None = None  # gemma2 final-logit softcap
    rope_theta: float = 10_000.0
    mrope_sections: tuple | None = None  # qwen2-vl M-RoPE (t,h,w) halves
    norm_eps: float = 1e-6
    act: str = "silu"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # Optional sub-configs
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    # Encoder-decoder (whisper): encoder layers + fixed source length; the
    # modality frontend is a stub — inputs are precomputed frame embeddings.
    encoder_layers: int = 0
    encoder_seq: int = 0
    # VLM stub frontend: number of prepended patch embeddings in input_specs.
    vision_patches: int = 0
    # Optimizer moment dtype ("float32" | "bfloat16") — giant configs use
    # bf16 moments to fit HBM (DESIGN.md §5).
    opt_moment_dtype: str = "float32"
    # Remat policy for the scanned blocks: "none" | "full" | "dots".
    remat: str = "full"
    # Explicit Megatron-SP shard_map for dense MLP + attention o-proj
    # (beyond-paper perf path: guarantees reduce-scatter TP combines).
    sp_shardmap: bool = False
    # Double-buffered FSDP weight prefetch (repro.core.overlap, DESIGN.md §8):
    # block l+1's FFN weights are gathered over the fsdp axis with the
    # explicit AllGather ring while block l computes, instead of XLA's
    # on-demand gather at first use.  Train mode only; needs a mesh with an
    # fsdp axis.
    fsdp_prefetch: bool = False

    # ---- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def pattern_repeats(self) -> int:
        scanned = self.num_layers - len(self.tail_pattern)
        if scanned % len(self.block_pattern) != 0:
            raise ValueError(
                f"{self.name}: {scanned} scanned layers not divisible by "
                f"pattern {self.block_pattern}"
            )
        return scanned // len(self.block_pattern)

    @property
    def is_moe(self) -> bool:
        return self.moe is not None and self.moe.num_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if no block attends to unbounded context quadratically."""
        return all(
            k in ("local", "rglru", "ssm")
            for k in (*self.block_pattern, *self.tail_pattern)
        )

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have decode paths (see DESIGN.md)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for roofline's
        MODEL_FLOPS = 6*N*D."""
        d = self.d_model
        dh = self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        for kind in self.block_pattern:
            total += self._block_params(kind, d, dh) * self.pattern_repeats
        for kind in self.tail_pattern:
            total += self._block_params(kind, d, dh)
        if self.encoder_layers:
            total += self.encoder_layers * self._block_params("global", d, dh)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: shared + top_k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        dh = self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        attn = self._attn_params(d, dh)
        expert = 3 * d * self.moe.d_ff
        active = (self.moe.top_k + self.moe.num_shared_experts) * expert
        total += self.num_layers * (attn + active + 2 * d)
        return total

    def _attn_params(self, d: int, dh: int) -> int:
        if self.mla is not None:
            m = self.mla
            q = d * m.q_lora_rank + m.q_lora_rank * self.num_heads * (
                m.nope_head_dim + m.rope_head_dim
            )
            kv = d * (m.kv_lora_rank + m.rope_head_dim) + m.kv_lora_rank * (
                self.num_heads * (m.nope_head_dim + m.v_head_dim)
            )
            o = self.num_heads * m.v_head_dim * d
            return q + kv + o
        return d * self.num_heads * dh + 2 * d * self.num_kv_heads * dh + self.num_heads * dh * d

    def _block_params(self, kind: str, d: int, dh: int) -> int:
        norm = 2 * d
        if kind == "ssm":
            s = self.ssm
            inner = s.expand * d
            return norm + 2 * d * inner + inner * d + inner * (s.conv_width + 2)
        if kind == "rglru":
            width = d
            mult = 3 if self.act in ("silu", "swiglu", "geglu") else 2
            return (
                2 * norm
                + 3 * d * width  # y / x / out projections
                + 2 * width * width  # recurrence + input gates
                + 7 * width  # conv(4) + biases + lambda
                + mult * d * self.d_ff
            )
        attn = self._attn_params(d, dh)
        if self.is_moe:
            e = self.moe
            ffn = (e.num_experts + e.num_shared_experts) * 3 * d * e.d_ff + d * e.num_experts
        else:
            mult = 3 if self.act in ("silu", "swiglu", "geglu") else 2
            ffn = mult * d * self.d_ff
        return norm + attn + ffn

    def model_flops_per_token(self) -> float:
        """6 * N_active * 1 — the roofline MODEL_FLOPS rate (per token)."""
        return 6.0 * self.active_param_count()

    def validate(self) -> None:
        assert self.d_model > 0 and self.num_layers > 0
        if self.num_heads and self.num_kv_heads:
            assert self.num_heads % self.num_kv_heads == 0
        _ = self.pattern_repeats
        if self.is_moe:
            assert self.moe.top_k <= self.moe.num_experts
            assert self.moe.dispatch in ("dropless", "capacity")
            assert self.moe.overlap_chunks >= 1
            assert self.moe.decode_backend in ("dense", "sparse")
            assert self.moe.draft_mode in ("off", "topk1", "shared_only")


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A small same-family config for CPU smoke tests."""
    pattern = cfg.block_pattern
    defaults = dict(
        num_layers=2 * len(pattern) + len(cfg.tail_pattern),
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        dtype="float32",
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=32 if cfg.encoder_seq else 0,
        vision_patches=8 if cfg.vision_patches else 0,
        remat="none",
    )
    if cfg.moe is not None:
        defaults["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            d_ff=64,
        )
    if cfg.mla is not None:
        defaults["mla"] = MLAConfig(
            kv_lora_rank=32, q_lora_rank=48, nope_head_dim=16, rope_head_dim=8,
            v_head_dim=16,
        )
    if cfg.ssm is not None:
        defaults["ssm"] = SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk=16)
    defaults.update(overrides)
    return dataclasses.replace(cfg, **defaults)
