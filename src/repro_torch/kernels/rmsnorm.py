"""Fused RMSNorm: the CUDA kernels (``csrc/rmsnorm.cu``) beside their plain
PyTorch versions.

Port of :mod:`repro.kernels.rmsnorm` (``rmsnorm_pallas``).  ``x [T, D] *
rsqrt(mean(x^2) + eps) * (1 + w)``, f32 math, rounded once to x's dtype;
any T.  With ``gate=z`` the kernel normalises ``x * silu(z)`` (Mamba-2's
gated norm, ``src/repro/models/ssm.py:189-190``), formed in registers as
PyTorch's two elementwise kernels would round it.  A backward kernel
(:func:`rmsnorm_bwd_cuda`) sits behind :class:`RMSNormFn`; the gated norm
has none yet.  The wrappers check what the kernels take and raise on
anything else; they never fall back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rmsnorm as rmsnorm_plain

__all__ = ["rmsnorm_cuda", "rmsnorm_bwd_cuda", "RMSNormFn", "rmsnorm_plain", "MAX_VECTORS"]

# 16-byte vectors of a row that the one-pass kernels hold in registers; a
# wider row takes the two-pass kernels.
MAX_VECTORS = 1024

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "rmsnorm_fwd": ((_P, _P, _P, _P, _I, _I, _F, _I, _I, _P), ctypes.c_int),
    "rmsnorm_bwd_blocks": ((_I,), ctypes.c_int),
    "rmsnorm_bwd": ((_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _P), ctypes.c_int),
}


def _check(name: str, x: torch.Tensor, w: torch.Tensor, **others) -> None:
    for arg, t in (("x", x), ("w", w), *others.items()):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous and 16-byte aligned")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"{name}: x {x.dtype} and w {w.dtype} must both be f32 or bf16")
    if x.dim() != 2 or w.shape != (x.shape[1],):
        raise ValueError(f"{name}: x [T, D] and w [D], got {tuple(x.shape)} and {tuple(w.shape)}")
    for arg, t in others.items():
        if t.shape != x.shape or t.dtype != x.dtype:
            raise ValueError(f"{name}: {arg} must have x's shape {tuple(x.shape)} and dtype "
                             f"{x.dtype}, got {tuple(t.shape)} {t.dtype}")
    d = x.shape[1]
    vec = 16 // x.element_size()
    if d == 0 or d % vec:
        raise ValueError(f"{name}: D={d} must be a positive multiple of {vec} for {x.dtype}")


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *,
                 gate: torch.Tensor | None = None, shape_rows: int | None = None
                 ) -> torch.Tensor:
    """``x [T, D]`` and ``w [D]`` on the card, both f32 or both bf16, D a
    multiple of 16 bytes' worth of elements -> ``[T, D]`` in x's dtype.
    ``gate``: z ``[T, D]`` in x's dtype; the norm is then of ``x *
    silu(z)``, bit for bit what this kernel gives on that product formed by
    PyTorch.  Up to ``MAX_VECTORS`` of them (8192 bf16, 4096 f32) the row is
    read once into registers; a wider row is read twice.  ``shape_rows``:
    the row count that picks the CTA shape (default T): a sequence-parallel
    rank's slice of a stream passes the whole stream's, so its rows get the
    bits the whole stream's launch gives them."""
    _check("rmsnorm_cuda", x, w, **({} if gate is None else {"gate": gate}))
    t, d = x.shape
    out = torch.empty_like(x)
    if t == 0:
        return out
    lib = build.library("rmsnorm", _SIGNATURES)
    err = lib.rmsnorm_fwd(
        x.data_ptr(), None if gate is None else gate.data_ptr(), w.data_ptr(), out.data_ptr(),
        t, d, float(eps), t if shape_rows is None else int(shape_rows), _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"rmsnorm kernel launch failed (CUDA error {err})")
    rmsnorm_cuda.launches += 1
    rmsnorm_cuda.shapes[(t, d)] = rmsnorm_cuda.shapes.get((t, d), 0) + 1
    return out


rmsnorm_cuda.launches = 0
rmsnorm_cuda.shapes = {}  # (T, D) -> launches


def rmsnorm_bwd_cuda(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-6, *, dw_dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(``dx [T, D]``, ``dw [D]``) of the ungated norm for the output
    gradient ``dy [T, D]``: f32 math, dx in x's dtype, dw summed over the
    rows in a fixed order (per-CTA shares, then their sum) and rounded once
    to ``dw_dtype``: x's (default), or f32 for one block's share of a sum
    the caller continues (``models.layers``' tree over sequence blocks)."""
    _check("rmsnorm_bwd_cuda", x, w, dy=dy)
    dw_f32 = dw_dtype == torch.float32 and x.dtype != torch.float32
    t, d = x.shape
    dx = torch.empty_like(x)
    if t == 0:
        return dx, torch.zeros(w.shape, dtype=dw_dtype or w.dtype, device=w.device)
    dw = torch.empty(w.shape, dtype=torch.float32 if dw_f32 else w.dtype, device=w.device)
    lib = build.library("rmsnorm", _SIGNATURES)
    part = torch.empty((lib.rmsnorm_bwd_blocks(t), d), dtype=torch.float32, device=x.device)
    err = lib.rmsnorm_bwd(
        x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(), dw.data_ptr(), part.data_ptr(),
        t, d, float(eps), int(dw_f32), _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"rmsnorm_bwd kernel launch failed (CUDA error {err})")
    rmsnorm_bwd_cuda.launches += 1
    return dx, dw


rmsnorm_bwd_cuda.launches = 0


class RMSNormFn(torch.autograd.Function):
    """The ungated norm on the card, differentiable in ``x`` and ``w``: the
    forward saves x and w and the backward recomputes each row's scale."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm_cuda(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd_cuda(x, w, dy.contiguous(), ctx.eps)
        return dx, dw, None
