"""Fused softmax + top-k router gate: the CUDA kernel
(``csrc/topk_gating.cu``) beside its plain PyTorch version.

Port of :mod:`repro.kernels.topk_gating` (``topk_gating_pallas``), plus a
backward kernel (the JAX package differentiates its jnp reference) behind
:class:`TopkGatingFn`.  The wrappers check what the kernels take and raise
on anything else; they never fall back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import topk_gating as topk_gating_plain
from repro_torch.kernels.ref import topk_gating_bwd as topk_gating_bwd_plain

__all__ = [
    "topk_gating_cuda", "topk_gating_bwd_cuda", "TopkGatingFn", "topk_gating_plain",
    "topk_gating_bwd_plain", "MAX_EXPERTS",
]

MAX_EXPERTS = 1024

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "topk_gating_f32": ((_P, _P, _P, _I, _I, _I, _P), ctypes.c_int),
    "topk_gating_bwd_f32": ((_P, _P, _P, _P, _I, _I, _I, _P), ctypes.c_int),
}


def topk_gating_cuda(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``logits [T, E]`` f32 on the card -> (``[T, k]`` f32 weights,
    ``[T, k]`` i32 ids), descending, ties to the lowest id."""
    if logits.device.type != "cuda":
        raise ValueError(f"topk_gating_cuda needs a CUDA tensor, got {logits.device}")
    if logits.dtype != torch.float32:
        raise TypeError(f"topk_gating_cuda takes float32 logits, got {logits.dtype}")
    if logits.dim() != 2 or not logits.is_contiguous():
        raise ValueError("topk_gating_cuda takes contiguous [T, E] logits")
    t, e = logits.shape
    if not 1 <= k <= e or e > MAX_EXPERTS:
        raise ValueError(f"topk_gating_cuda: need 1 <= k={k} <= E={e} <= {MAX_EXPERTS}")
    w = torch.empty((t, k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((t, k), dtype=torch.int32, device=logits.device)
    if t == 0:
        return w, idx
    lib = build.library("topk_gating", _SIGNATURES)
    err = lib.topk_gating_f32(
        logits.data_ptr(), w.data_ptr(), idx.data_ptr(), t, e, k,
        torch.cuda.current_stream(logits.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"topk_gating kernel launch failed (CUDA error {err})")
    topk_gating_cuda.launches += 1
    return w, idx


topk_gating_cuda.launches = 0


def topk_gating_bwd_cuda(
    logits: torch.Tensor, dweights: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """``dlogits [T, E]`` f32 for the weights' gradient ``dweights [T, k]``
    f32, given the forward's ``logits`` and ids ``idx [T, k]`` i32."""
    for name, x, dt in (("logits", logits, torch.float32), ("dweights", dweights, torch.float32),
                        ("idx", idx, torch.int32)):
        if x.device.type != "cuda" or x.dtype != dt or x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"topk_gating_bwd_cuda: {name} must be a contiguous 2-D {dt} CUDA tensor")
    t, e = logits.shape
    if dweights.shape != idx.shape or idx.shape[0] != t or e > MAX_EXPERTS:
        raise ValueError("topk_gating_bwd_cuda: logits [T, E], dweights and idx [T, k]")
    out = torch.empty_like(logits)
    if t == 0:
        return out
    lib = build.library("topk_gating", _SIGNATURES)
    err = lib.topk_gating_bwd_f32(
        logits.data_ptr(), dweights.data_ptr(), idx.data_ptr(), out.data_ptr(), t, e,
        idx.shape[1], torch.cuda.current_stream(logits.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"topk_gating_bwd kernel launch failed (CUDA error {err})")
    topk_gating_bwd_cuda.launches += 1
    return out


topk_gating_bwd_cuda.launches = 0


class TopkGatingFn(torch.autograd.Function):
    """``topk_gating`` on the card, differentiable in the logits through the
    weights (the ids are integers)."""

    @staticmethod
    def forward(ctx, logits, k):
        w, idx = topk_gating_cuda(logits, k)
        ctx.save_for_backward(logits, idx)
        ctx.mark_non_differentiable(idx)
        return w, idx

    @staticmethod
    def backward(ctx, dweights, _didx):
        logits, idx = ctx.saved_tensors
        return topk_gating_bwd_cuda(logits, dweights.float().contiguous(), idx), None
