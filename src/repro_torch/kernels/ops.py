"""Public kernel entry points of the port.

Each op dispatches on the tensor's device: a CPU tensor goes to the plain
PyTorch version (:mod:`repro_torch.kernels.ref`) under ordinary autograd, a
CUDA tensor goes to the hand-written kernel — whose wrapper raises on
anything the kernel does not take.  When a gradient is needed on the card,
the op runs inside a ``torch.autograd.Function`` whose backward is a kernel
as well.  No path falls back from a kernel to the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (
    FlashAttentionFn,
    flash_attention_bwd_cuda,
    flash_attention_cuda,
    paged_flash_decode_cuda,
)
from repro_torch.kernels.grouped_matmul import (
    GroupedMatmulBlocksFn,
    GroupedMatmulFn,
    grouped_matmul_blocks_cuda,
    grouped_matmul_blocks_dw_cuda,
    grouped_matmul_blocks_dx_cuda,
    grouped_matmul_cuda,
    grouped_matmul_dw_cuda,
    grouped_matmul_dx_cuda,
)
from repro_torch.kernels.moe_dispatch import (
    MoECombineFn,
    MoEDispatchFn,
    moe_combine_bwd_cuda,
    moe_combine_cuda,
    moe_dispatch_cuda,
)
from repro_torch.kernels.rmsnorm import RMSNormFn, rmsnorm_bwd_cuda, rmsnorm_cuda
from repro_torch.kernels.ssd_chunk import ssd_chunk_cuda
from repro_torch.kernels.topk_gating import TopkGatingFn, topk_gating_bwd_cuda, topk_gating_cuda

__all__ = [
    "topk_gating", "flash_attention", "paged_flash_decode", "moe_dispatch", "moe_combine",
    "grouped_matmul", "rmsnorm", "ssd_chunk", "KERNELS", "launch_counts", "launch_shapes",
    "reset_launch_counts",
]

# Every kernel's CUDA wrapper, by kernel name (backward kernels included).
KERNELS = {
    "topk_gating": topk_gating_cuda,
    "topk_gating_bwd": topk_gating_bwd_cuda,
    "flash_attention": flash_attention_cuda,
    "flash_attention_bwd": flash_attention_bwd_cuda,
    "paged_flash_decode": paged_flash_decode_cuda,
    "moe_dispatch": moe_dispatch_cuda,
    "moe_combine": moe_combine_cuda,
    "moe_combine_bwd": moe_combine_bwd_cuda,
    "grouped_matmul_blocks": grouped_matmul_blocks_cuda,
    "grouped_matmul_blocks_dx": grouped_matmul_blocks_dx_cuda,
    "grouped_matmul_blocks_dw": grouped_matmul_blocks_dw_cuda,
    "grouped_matmul": grouped_matmul_cuda,
    "grouped_matmul_dx": grouped_matmul_dx_cuda,
    "grouped_matmul_dw": grouped_matmul_dw_cuda,
    "rmsnorm": rmsnorm_cuda,
    "rmsnorm_bwd": rmsnorm_bwd_cuda,
    "ssd_chunk": ssd_chunk_cuda,
}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def launch_shapes() -> dict[str, dict[tuple, int]]:
    """Launches by shape since the last :func:`reset_launch_counts`, of the
    kernels whose wrapper also counts them by shape (``shapes``)."""
    return {name: dict(fn.shapes) for name, fn in KERNELS.items() if hasattr(fn, "shapes")}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "shapes"):
            fn.shapes = {}


def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def topk_gating(logits: torch.Tensor, k: int):
    """``[T, E]`` logits -> (``[T, k]`` f32 weights, ``[T, k]`` i32 ids)."""
    if _on_cpu(logits):
        return ref.topk_gating(logits, k)
    logits = logits.float().contiguous()
    if _wants_grad(logits):
        return TopkGatingFn.apply(logits, k)
    return topk_gating_cuda(logits, k)


def flash_attention(q, k, v, *, causal: bool = True, window=None, softcap=None):
    """``q [B, Hq, S, D]``, ``k/v [B, Hkv, S, D]`` -> ``[B, Hq, S, D]``."""
    if _on_cpu(q):
        return ref.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    if _wants_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal, window, softcap)
    return flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap)


def paged_flash_decode(q, k_pool, v_pool, page_table, lengths, *, window=None, softcap=None):
    """``q [B, C, Hq, D]`` through the page pools ``[N, page, Hkv, D]``."""
    if _on_cpu(q):
        return ref.paged_flash_decode(
            q, k_pool, v_pool, page_table, lengths, window=window, softcap=softcap
        )
    return paged_flash_decode_cuda(
        q, k_pool, v_pool, page_table, lengths, window=window, softcap=softcap
    )


def moe_dispatch(x, src, *, inverse=None):
    """Gather token rows ``x [T, D]`` into a packed layout by ``src [P]``
    (i32 source row per slot, -1 = empty -> zeros).  ``inverse`` is the
    map the backward gathers through on the card: ``[T]`` for a one-to-one
    gather, ``[T, S]`` for a many-to-one one (see
    :mod:`repro_torch.kernels.moe_dispatch`)."""
    if _on_cpu(x):
        return ref.moe_dispatch(x, src)
    if _wants_grad(x):
        if inverse is None:
            raise ValueError("moe_dispatch on the card needs its inverse map for the backward")
        return MoEDispatchFn.apply(x, src, inverse)
    return moe_dispatch_cuda(x, src)


def moe_combine(y, slot, weights, *, inverse=None, out_dtype=torch.float32):
    """Weighted combine of packed rows ``y [P, D]`` back to token order via
    ``slot``/``weights [T, S]`` (``slot < 0`` terms skipped), summed in f32
    and rounded once to ``out_dtype`` (f32, or bf16 for bf16 rows).
    ``inverse [P]``: the flat ``t * S + s`` term reading each row, which the
    backward gathers through on the card."""
    if _on_cpu(y):
        return ref.moe_combine(y, slot, weights).to(out_dtype)
    weights = weights.float().contiguous()
    if _wants_grad(y, weights):
        if inverse is None:
            raise ValueError("moe_combine on the card needs its inverse map for the backward")
        return MoECombineFn.apply(y, slot, weights, inverse, out_dtype)
    return moe_combine_cuda(y, slot, weights, out_dtype=out_dtype)


def grouped_matmul(x, w, *, block_experts=None):
    """Per-expert GEMM.  ``block_experts=None``: capacity layout ``[E, C,
    D]`` against ``w [E, D, F]``; with a non-decreasing ``[n]``
    block->expert map: dropless block layout ``[n, B, D]`` (rows of tile
    ``i`` use ``w[block_experts[i]]``)."""
    if block_experts is None:
        if _on_cpu(x):
            return ref.grouped_matmul(x, w)
        if _wants_grad(x, w):
            return GroupedMatmulFn.apply(x, w)
        return grouped_matmul_cuda(x, w)
    if _on_cpu(x):
        return ref.grouped_matmul_blocks(x, w, block_experts)
    if _wants_grad(x, w):
        return GroupedMatmulBlocksFn.apply(x, w, block_experts)
    return grouped_matmul_blocks_cuda(x, w, block_experts)


def _no_backward(name: str, *tensors) -> None:
    if _wants_grad(*tensors):
        raise RuntimeError(
            f"{name} has no backward kernel yet (it comes with the Mamba-2 training slice); "
            "call it under torch.no_grad() on the card"
        )


def rmsnorm(x, w, *, eps: float = 1e-6, gate=None):
    """Fused RMSNorm over ``x [T, D]`` with weight ``w [D]`` (the norm is
    ``1 + w``), rounded once to x's dtype.  ``gate``: z ``[T, D]``; the norm
    is then of ``x * silu(z)`` (Mamba-2's gated norm, fused into the kernel
    on the card)."""
    if _on_cpu(x):
        return ref.rmsnorm(x, w, eps, gate)
    if gate is not None:
        _no_backward("the gated rmsnorm", x, w, gate)
        return rmsnorm_cuda(x.contiguous(), w.contiguous(), eps, gate=gate.contiguous())
    x, w = x.contiguous(), w.contiguous()
    if _wants_grad(x, w):
        return RMSNormFn.apply(x, w, eps)
    return rmsnorm_cuda(x, w, eps)


def ssd_chunk(x, da, bmat, cmat, *, heads: int):
    """Mamba-2 SSD intra-chunk pass: ``x [G, L, P]``, ``da [G, L]`` and
    ``bmat``/``cmat [G / heads, L, N]`` shared by the heads of each (batch,
    chunk), groups ordered (batch, chunk, head) -> (``y [G, L, P]``, chunk
    ``state [G, N, P]``), f32.  The CPU path expands B/C to the plain
    version's ``[G, L, N]``."""
    if _on_cpu(x):
        def per_group(m):
            return m[:, None].expand(m.shape[0], heads, *m.shape[1:]).reshape(-1, *m.shape[1:])

        return ref.ssd_chunk(x, da, per_group(bmat), per_group(cmat))
    _no_backward("ssd_chunk", x, da, bmat, cmat)
    return ssd_chunk_cuda(x.float().contiguous(), da.float().contiguous(),
                          bmat.float().contiguous(), cmat.float().contiguous(), heads)
