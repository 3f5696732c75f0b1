"""Grouped GEMMs of the expert FFN: the CUDA kernels
(``csrc/grouped_matmul.cu``) beside their plain PyTorch versions, and the
``torch.autograd.Function``s whose backward passes (dX and dW) are kernels
too.

Port of :mod:`repro.kernels.grouped_matmul`, both layouts:

- capacity (``grouped_matmul_pallas``): ``x [E, C, K] @ w [E, K, N] -> [E,
  C, N]``, the token-dropping buffers of ``dispatch="capacity"``;
- dropless blocks (``grouped_matmul_blocks_pallas``): ``x [n, B, K] @
  w[block_experts[n]] -> [n, B, N]``.  ``block_experts`` must be
  non-decreasing, as ``routing.dropless_plan`` builds it (the kernels find
  each expert's tiles by binary search).

Both accumulate in f32 and store in x's dtype.

The wrappers check device, dtype, shape and contiguity, allocate outputs
with ``torch.empty`` and raise on anything the kernels do not take; they
never fall back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import grouped_matmul as grouped_matmul_plain
from repro_torch.kernels.ref import grouped_matmul_bwd as grouped_matmul_bwd_plain
from repro_torch.kernels.ref import grouped_matmul_blocks as grouped_matmul_blocks_plain
from repro_torch.kernels.ref import grouped_matmul_blocks_bwd as grouped_matmul_blocks_bwd_plain

__all__ = [
    "grouped_matmul_cuda", "grouped_matmul_dx_cuda", "grouped_matmul_dw_cuda", "GroupedMatmulFn",
    "grouped_matmul_blocks_cuda", "grouped_matmul_blocks_dx_cuda", "grouped_matmul_blocks_dw_cuda",
    "GroupedMatmulBlocksFn", "grouped_matmul_plain", "grouped_matmul_bwd_plain",
    "grouped_matmul_blocks_plain", "grouped_matmul_blocks_bwd_plain", "TILE_ROWS",
]

TILE_ROWS = 8  # the kernels' dispatch tile (MoEConfig.dispatch_block)
MAX_EXPERTS = 1 << 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "grouped_matmul_blocks": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "grouped_matmul_blocks_dw": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "grouped_matmul_capacity": ((_P, _P, _P, _I, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "grouped_matmul_capacity_dw": ((_P, _P, _P, _I, _I, _I, _I, _I, _P), ctypes.c_int),
}


def _lib():
    return build.library("grouped_matmul", _SIGNATURES)


def _check(name: str, data: dict, block_experts: torch.Tensor | None = None) -> torch.dtype:
    dtype = None
    for arg, x in data.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if x.dtype not in _DTYPES:
            raise TypeError(f"{name}: {arg} is {x.dtype}, expected bf16 or f32")
        if dtype is not None and x.dtype != dtype:
            raise TypeError(f"{name}: {arg} is {x.dtype}, the other inputs {dtype}")
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
        dtype = x.dtype
    be = block_experts
    if be is None:
        return dtype
    if be.device.type != "cuda" or be.dtype != torch.int32 or be.dim() != 1 or not be.is_contiguous():
        raise ValueError(f"{name}: block_experts must be a contiguous [n] int32 CUDA tensor")
    return dtype


def _check_dims(name: str, dtype: torch.dtype, *dims: int) -> None:
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    if any(d % vec for d in dims):
        raise ValueError(f"{name}: dims {dims} must be multiples of {vec} for {dtype}")


def _launch_rows(name, x, w, be, *, trans: bool) -> torch.Tensor:
    dtype = _check(name, {"x": x, "w": w}, be)
    if x.dim() != 3 or w.dim() != 3 or x.shape[1] != TILE_ROWS or be.shape[0] != x.shape[0]:
        raise ValueError(f"{name}: x [n, {TILE_ROWS}, K], w [E, ., .], block_experts [n]")
    n, _, k = x.shape
    e = w.shape[0]
    kw, nw = (w.shape[2], w.shape[1]) if trans else (w.shape[1], w.shape[2])
    if kw != k or e > MAX_EXPERTS:
        raise ValueError(f"{name}: x {tuple(x.shape)} against w {tuple(w.shape)}")
    _check_dims(name, dtype, k, nw)
    out = torch.empty((n, TILE_ROWS, nw), dtype=dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = _lib().grouped_matmul_blocks(
        x.data_ptr(), w.data_ptr(), be.data_ptr(), out.data_ptr(), _DTYPES[dtype], n, e, k, nw,
        int(trans), torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{name} kernel launch failed (error {err})")
    return out


def grouped_matmul_blocks_cuda(x: torch.Tensor, w: torch.Tensor, block_experts: torch.Tensor):
    """``x [n, 8, K]`` (bf16 or f32) ``@ w[be[n]]`` with ``w [E, K, N]`` ->
    ``[n, 8, N]`` in x's dtype."""
    out = _launch_rows("grouped_matmul_blocks_cuda", x, w, block_experts, trans=False)
    grouped_matmul_blocks_cuda.launches += 1
    return out


grouped_matmul_blocks_cuda.launches = 0


def grouped_matmul_blocks_dx_cuda(dy: torch.Tensor, w: torch.Tensor, block_experts: torch.Tensor):
    """``dy [n, 8, N] @ w[be[n]]^T`` with ``w [E, K, N]`` read in place as
    ``[E, N, K]``'s transpose -> ``[n, 8, K]``: the forward kernel with its
    transposed-weight flag."""
    out = _launch_rows("grouped_matmul_blocks_dx_cuda", dy, w, block_experts, trans=True)
    grouped_matmul_blocks_dx_cuda.launches += 1
    return out


grouped_matmul_blocks_dx_cuda.launches = 0


def grouped_matmul_blocks_dw_cuda(
    x: torch.Tensor, dy: torch.Tensor, block_experts: torch.Tensor, num_experts: int
) -> torch.Tensor:
    """``dW[e] = sum over the tiles of expert e of x^T dy`` -> ``[E, K, N]``
    in x's dtype (f32 accumulation; zeros for an expert without tiles)."""
    name = "grouped_matmul_blocks_dw_cuda"
    dtype = _check(name, {"x": x, "dy": dy}, block_experts)
    if x.dim() != 3 or dy.dim() != 3 or x.shape[:2] != dy.shape[:2] or x.shape[1] != TILE_ROWS:
        raise ValueError(f"{name}: x [n, {TILE_ROWS}, K] and dy [n, {TILE_ROWS}, N]")
    if block_experts.shape[0] != x.shape[0] or not 0 < num_experts <= MAX_EXPERTS:
        raise ValueError(f"{name}: block_experts [n] and 0 < E <= {MAX_EXPERTS}")
    n, _, k = x.shape
    nw = dy.shape[2]
    _check_dims(name, dtype, k, nw)
    dw = torch.empty((num_experts, k, nw), dtype=dtype, device=x.device)
    if dw.numel() == 0:
        return dw
    err = _lib().grouped_matmul_blocks_dw(
        x.data_ptr(), dy.data_ptr(), block_experts.data_ptr(), dw.data_ptr(), _DTYPES[dtype], n,
        num_experts, k, nw, torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{name} kernel launch failed (error {err})")
    grouped_matmul_blocks_dw_cuda.launches += 1
    return dw


grouped_matmul_blocks_dw_cuda.launches = 0


def _launch_capacity(name, x, w, *, trans: bool) -> torch.Tensor:
    dtype = _check(name, {"x": x, "w": w})
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0]:
        raise ValueError(f"{name}: x [E, C, K] and w [E, ., .], got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    e, c, k = x.shape
    kw, nw = (w.shape[2], w.shape[1]) if trans else (w.shape[1], w.shape[2])
    if kw != k or e > MAX_EXPERTS:
        raise ValueError(f"{name}: x {tuple(x.shape)} against w {tuple(w.shape)}")
    _check_dims(name, dtype, k, nw)
    out = torch.empty((e, c, nw), dtype=dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = _lib().grouped_matmul_capacity(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), _DTYPES[dtype], e, c, k, nw, int(trans),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{name} kernel launch failed (error {err})")
    return out


def grouped_matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Capacity layout: ``x [E, C, K]`` (bf16 or f32) ``@ w [E, K, N]`` ->
    ``[E, C, N]`` in x's dtype."""
    out = _launch_capacity("grouped_matmul_cuda", x, w, trans=False)
    grouped_matmul_cuda.launches += 1
    return out


grouped_matmul_cuda.launches = 0


def grouped_matmul_dx_cuda(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``dy [E, C, N] @ w[e]^T`` with ``w [E, K, N]`` read in place ->
    ``[E, C, K]``: the capacity forward kernel with its transposed-weight
    flag."""
    out = _launch_capacity("grouped_matmul_dx_cuda", dy, w, trans=True)
    grouped_matmul_dx_cuda.launches += 1
    return out


grouped_matmul_dx_cuda.launches = 0


def grouped_matmul_dw_cuda(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """``dW[e] = x[e]^T dy[e]`` -> ``[E, K, N]`` in x's dtype, each expert's
    C rows summed in order (f32 accumulation, no atomics)."""
    name = "grouped_matmul_dw_cuda"
    dtype = _check(name, {"x": x, "dy": dy})
    if x.dim() != 3 or dy.dim() != 3 or x.shape[:2] != dy.shape[:2]:
        raise ValueError(f"{name}: x [E, C, K] and dy [E, C, N], got {tuple(x.shape)}, "
                         f"{tuple(dy.shape)}")
    e, c, k = x.shape
    nw = dy.shape[2]
    if e > MAX_EXPERTS:
        raise ValueError(f"{name}: {e} experts > {MAX_EXPERTS}")
    _check_dims(name, dtype, k, nw)
    dw = torch.empty((e, k, nw), dtype=dtype, device=x.device)
    if dw.numel() == 0:
        return dw
    err = _lib().grouped_matmul_capacity_dw(
        x.data_ptr(), dy.data_ptr(), dw.data_ptr(), _DTYPES[dtype], e, c, k, nw,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"{name} kernel launch failed (error {err})")
    grouped_matmul_dw_cuda.launches += 1
    return dw


grouped_matmul_dw_cuda.launches = 0


class GroupedMatmulFn(torch.autograd.Function):
    """Capacity-layout ``grouped_matmul`` whose backward is the dX and dW
    kernels."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return grouped_matmul_cuda(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = grouped_matmul_dx_cuda(dy, w) if ctx.needs_input_grad[0] else None
        dw = grouped_matmul_dw_cuda(x, dy) if ctx.needs_input_grad[1] else None
        return dx, dw


class GroupedMatmulBlocksFn(torch.autograd.Function):
    """``grouped_matmul_blocks`` whose backward is the dX and dW kernels."""

    @staticmethod
    def forward(ctx, x, w, block_experts):
        ctx.save_for_backward(x, w, block_experts)
        return grouped_matmul_blocks_cuda(x, w, block_experts)

    @staticmethod
    def backward(ctx, dy):
        x, w, be = ctx.saved_tensors
        dy = dy.contiguous()
        dx = grouped_matmul_blocks_dx_cuda(dy, w, be) if ctx.needs_input_grad[0] else None
        dw = (
            grouped_matmul_blocks_dw_cuda(x, dy, be, w.shape[0])
            if ctx.needs_input_grad[1] else None
        )
        return dx, dw, None
