"""Mamba-2 SSD intra-chunk pass: the CUDA kernel (``csrc/ssd_chunk.cu``)
beside its plain PyTorch version.

Port of :mod:`repro.kernels.ssd_chunk` (``ssd_chunk_pallas``).  Groups are
(batch, chunk, head) in that order.  The plain version keeps the Pallas
kernel's contract, ``bmat``/``cmat [G, L, N]``; the kernel takes them as
``[G / heads, L, N]`` — one row per (batch, chunk), shared by its heads, as
the model computes them — plus the head count, so the per-head copy is
never made.  The kernel computes C B^T once per (batch, chunk) into a
workspace this wrapper allocates, then the pass (two launches, counted as
one call).  The wrapper checks what the kernel takes and raises on anything
else; it never falls back.  There is no backward kernel yet:
:func:`repro_torch.kernels.ops.ssd_chunk` raises on the card when a
gradient is wanted.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import ssd_chunk as ssd_chunk_plain

__all__ = ["ssd_chunk_cuda", "ssd_chunk_plain", "MAX_STATE"]

MAX_STATE = 128  # N: the kernel stages [64, N] tiles of B and C in shared memory
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ssd_chunk_f32": ((_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "ssd_chunk_workspace_floats": ((_I, _I), ctypes.c_longlong),
}


def ssd_chunk_cuda(
    x: torch.Tensor, da: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor, heads: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [G, L, P]``, ``da [G, L]``, ``bmat``/``cmat [G / heads, L, N]``,
    all contiguous f32 on the card -> (``y [G, L, P]``, ``state [G, N,
    P]``) f32; group ``g`` reads B/C row ``g // heads``."""
    for arg, t in (("x", x), ("da", da), ("bmat", bmat), ("cmat", cmat)):
        if t.device.type != "cuda":
            raise ValueError(f"ssd_chunk_cuda: {arg} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_chunk_cuda: {arg} is {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError(f"ssd_chunk_cuda: {arg} must be contiguous")
    if x.dim() != 3 or da.dim() != 2 or bmat.dim() != 3:
        raise ValueError("ssd_chunk_cuda: x [G, L, P], da [G, L], bmat/cmat [G / heads, L, N]")
    g, l, p = x.shape
    n = bmat.shape[2]
    if heads < 1 or g % heads or da.shape != (g, l) or bmat.shape != (g // heads, l, n) \
            or cmat.shape != bmat.shape:
        raise ValueError(
            f"ssd_chunk_cuda: shapes x {tuple(x.shape)}, da {tuple(da.shape)}, bmat "
            f"{tuple(bmat.shape)}, cmat {tuple(cmat.shape)} with heads={heads} do not fit"
        )
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"ssd_chunk_cuda: state dim N={n} must be in 1..{MAX_STATE}")
    y = torch.empty_like(x)
    state = torch.empty((g, n, p), dtype=torch.float32, device=x.device)
    if g == 0 or l == 0 or p == 0:
        return y, state.zero_()
    lib = build.library("ssd_chunk", _SIGNATURES)
    work = torch.empty(lib.ssd_chunk_workspace_floats(l, g // heads), dtype=torch.float32,
                       device=x.device)
    err = lib.ssd_chunk_f32(
        x.data_ptr(), da.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), y.data_ptr(),
        state.data_ptr(), work.data_ptr(), g, l, p, n, heads,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"ssd_chunk kernel launch failed (CUDA error {err})")
    ssd_chunk_cuda.launches += 1
    ssd_chunk_cuda.shapes[(g, l)] = ssd_chunk_cuda.shapes.get((g, l), 0) + 1
    return y, state


ssd_chunk_cuda.launches = 0
ssd_chunk_cuda.shapes = {}  # (G, L) -> launches
