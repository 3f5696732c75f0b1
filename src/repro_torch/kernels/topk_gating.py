"""Fused softmax + top-k router gate: the CUDA kernel
(``csrc/topk_gating.cu``) beside its plain PyTorch version.

Port of :mod:`repro.kernels.topk_gating` (``topk_gating_pallas``).  The
wrapper checks what the kernel takes and raises on anything else; it never
falls back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import topk_gating as topk_gating_plain

__all__ = ["topk_gating_cuda", "topk_gating_plain", "MAX_EXPERTS"]

MAX_EXPERTS = 1024

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"topk_gating_f32": ((_P, _P, _P, _I, _I, _I, _P), ctypes.c_int)}


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
