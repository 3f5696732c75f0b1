"""Fused RMSNorm: the CUDA kernel (``csrc/rmsnorm.cu``) beside its plain
PyTorch version.

Port of :mod:`repro.kernels.rmsnorm` (``rmsnorm_pallas``).  ``x [T, D] *
rsqrt(mean(x^2) + eps) * (1 + w)``, f32 math, rounded once to x's dtype;
any T.  The wrapper checks what the kernel takes and raises on anything
else; it never falls back to the plain version.  There is no backward
kernel yet: :func:`repro_torch.kernels.ops.rmsnorm` raises on the card when
a gradient is wanted.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rmsnorm as rmsnorm_plain

__all__ = ["rmsnorm_cuda", "rmsnorm_plain", "MAX_VECTORS"]

# 16-byte vectors of a row that the one-pass kernel holds in registers (256
# threads x 4); a wider row takes the two-pass kernel.
MAX_VECTORS = 1024

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"rmsnorm_fwd": ((_P, _P, _P, _I, _I, ctypes.c_float, _I, _P), ctypes.c_int)}


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x [T, D]`` and ``w [D]`` on the card, both f32 or both bf16, D a
    multiple of 16 bytes' worth of elements -> ``[T, D]`` in x's dtype.  Up
    to ``MAX_VECTORS`` of them (8192 bf16, 4096 f32) the row is read once
    into registers; a wider row is read twice (sum of squares, then the
    normalising pass)."""
    for arg, t in (("x", x), ("w", w)):
        if t.device.type != "cuda":
            raise ValueError(f"rmsnorm_cuda: {arg} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"rmsnorm_cuda: {arg} must be contiguous and 16-byte aligned")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"rmsnorm_cuda: x {x.dtype} and w {w.dtype} must both be f32 or bf16")
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm_cuda: x [T, D] and w [D], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    t, d = x.shape
    vec = 16 // x.element_size()
    if d == 0 or d % vec:
        raise ValueError(f"rmsnorm_cuda: D={d} must be a positive multiple of {vec} for {x.dtype}")
    out = torch.empty_like(x)
    if t == 0:
        return out
    lib = build.library("rmsnorm", _SIGNATURES)
    err = lib.rmsnorm_fwd(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), t, d, float(eps), _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"rmsnorm kernel launch failed (CUDA error {err})")
    rmsnorm_cuda.launches += 1
    rmsnorm_cuda.shapes[(t, d)] = rmsnorm_cuda.shapes.get((t, d), 0) + 1
    return out


rmsnorm_cuda.launches = 0
rmsnorm_cuda.shapes = {}  # (T, D) -> launches
