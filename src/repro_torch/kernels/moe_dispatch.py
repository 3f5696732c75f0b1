"""MoE dispatch (row gather) and combine (weighted gather-sum): the CUDA
kernels (``csrc/moe_dispatch.cu``) beside their plain PyTorch versions, and
the ``torch.autograd.Function``s whose backward passes are kernels too.

Port of :mod:`repro.kernels.moe_dispatch` (``moe_dispatch_pallas`` and
``moe_combine_pallas``).  The wrappers check device, dtype, shape and
contiguity, allocate outputs with ``torch.empty`` and raise on anything the
kernels do not take; they never fall back.

Both backward passes need the inverse of the forward's index map, which
the dispatch plan already holds (``DispatchPlan.slot`` and ``.src`` are
inverse views of one permutation), so no gradient needs atomics:

* a one-to-one gather (the pack and the unpack) is differentiated by the
  same gather through its inverse ``[T]``;
* a many-to-one gather (the send buffer, where each token row feeds its
  top-k choices) is differentiated by the combine with unit weights
  through ``[T, S]``;
* the combine's own backward (``moe_combine_bwd``) works from each token's
  side: it reads ``dout[t]`` once, writes ``dy[slot[t, s]]`` for each of the
  token's terms and reduces ``dw[t, s]`` in a fixed order.  It relies on
  ``slot`` and ``src`` being exact inverses, as a plan's are, and zeros the
  rows whose ``src`` is -1.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import moe_combine as moe_combine_plain
from repro_torch.kernels.ref import moe_combine_bwd as moe_combine_bwd_plain
from repro_torch.kernels.ref import moe_dispatch as moe_dispatch_plain
from repro_torch.kernels.ref import moe_dispatch_bwd as moe_dispatch_bwd_plain

__all__ = [
    "moe_dispatch_cuda", "moe_combine_cuda", "moe_combine_bwd_cuda",
    "MoEDispatchFn", "MoECombineFn",
    "moe_dispatch_plain", "moe_dispatch_bwd_plain", "moe_combine_plain",
    "moe_combine_bwd_plain",
]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "moe_dispatch": ((_P, _P, _P, _I, _I, _I, _P), ctypes.c_int),
    "moe_combine": ((_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P), ctypes.c_int),
    "moe_combine_bwd": ((_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P), ctypes.c_int),
}


def _lib():
    return build.library("moe_dispatch", _SIGNATURES)


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _check(name: str, tensors: dict) -> None:
    for arg, (x, dtypes) in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if x.dtype not in dtypes:
            raise TypeError(f"{name}: {arg} is {x.dtype}, expected one of {dtypes}")


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed (error {err})")


_I32 = (torch.int32,)
_F32 = (torch.float32,)
_DATA = tuple(_DTYPES)


def moe_dispatch_cuda(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``x [T, D]`` gathered by ``src [P]`` i32 (-1 = empty row) -> ``[P, D]``."""
    _check("moe_dispatch_cuda", {"x": (x, _DATA), "src": (src, _I32)})
    if x.dim() != 2 or src.dim() != 1:
        raise ValueError("moe_dispatch_cuda takes x [T, D] and src [P]")
    t, d = x.shape
    out = torch.empty((src.shape[0], d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    err = _lib().moe_dispatch(
        x.data_ptr(), src.data_ptr(), out.data_ptr(), t, src.shape[0], d * x.element_size(),
        _stream(x),
    )
    _raise_on(err, "moe_dispatch")
    moe_dispatch_cuda.launches += 1
    return out


moe_dispatch_cuda.launches = 0


def moe_combine_cuda(
    y: torch.Tensor, slot: torch.Tensor, weights: torch.Tensor, out_dtype=torch.float32
) -> torch.Tensor:
    """``y [P, D]`` combined by ``slot [T, S]`` i32 / ``weights [T, S]`` f32
    -> ``[T, D]`` in ``out_dtype`` (f32, or bf16 for bf16 rows)."""
    _check("moe_combine_cuda", {"y": (y, _DATA), "slot": (slot, _I32), "weights": (weights, _F32)})
    if y.dim() != 2 or slot.dim() != 2 or weights.shape != slot.shape:
        raise ValueError("moe_combine_cuda takes y [P, D] and slot, weights [T, S]")
    if out_dtype not in _DTYPES or (y.dtype == torch.float32 and out_dtype != torch.float32):
        raise TypeError(f"moe_combine_cuda: no {y.dtype} -> {out_dtype} combine")
    p, d = y.shape
    t, s = slot.shape
    out = torch.empty((t, d), dtype=out_dtype, device=y.device)
    if out.numel() == 0:
        return out
    err = _lib().moe_combine(
        y.data_ptr(), slot.data_ptr(), weights.data_ptr(), out.data_ptr(), _DTYPES[y.dtype],
        _DTYPES[out_dtype], t, s, p, d, _stream(y),
    )
    _raise_on(err, "moe_combine")
    moe_combine_cuda.launches += 1
    return out


moe_combine_cuda.launches = 0


def moe_combine_bwd_cuda(
    dout: torch.Tensor,
    y: torch.Tensor,
    slot: torch.Tensor,
    weights: torch.Tensor,
    src: torch.Tensor,
    *,
    need_dw: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(dy ``[P, D]`` in y's dtype, dw ``[T, S]`` f32 or None) for the
    combine's output gradient ``dout [T, D]`` f32; ``src [P]`` is the flat
    ``t * S + s`` term reading each row, -1 for none.

    Precondition: ``slot`` and ``src`` are exact inverses (``slot[t, s] = p
    >= 0`` exactly when ``src[p] = t * S + s``), as a ``DispatchPlan``'s
    ``slot`` and ``src`` are.  The kernel writes ``dy[slot[t, s]]`` from
    token t's side and zeros the rows whose ``src`` is -1; a row that
    ``src`` names but no ``slot`` entry points back to is left unwritten."""
    _check("moe_combine_bwd_cuda", {
        "dout": (dout, _F32), "y": (y, _DATA), "slot": (slot, _I32),
        "weights": (weights, _F32), "src": (src, _I32),
    })
    p, d = y.shape
    t, s = slot.shape
    if dout.shape != (t, d) or weights.shape != (t, s) or src.shape != (p,):
        raise ValueError("moe_combine_bwd_cuda: dout [T, D], slot/weights [T, S], src [P]")
    dy = torch.empty_like(y)
    dw = torch.empty((t, s), dtype=torch.float32, device=y.device) if need_dw else None
    if max(p, t * s) == 0 or d == 0:
        return dy, dw
    err = _lib().moe_combine_bwd(
        dout.data_ptr(), y.data_ptr(), slot.data_ptr(), weights.data_ptr(), src.data_ptr(),
        dy.data_ptr(), None if dw is None else dw.data_ptr(), _DTYPES[y.dtype], t, s, p, d,
        _stream(y),
    )
    _raise_on(err, "moe_combine_bwd")
    moe_combine_bwd_cuda.launches += 1
    return dy, dw


moe_combine_bwd_cuda.launches = 0


class MoEDispatchFn(torch.autograd.Function):
    """``moe_dispatch`` with a kernel backward through ``inverse`` (``[T]``
    for a one-to-one gather, ``[T, S]`` for a many-to-one one)."""

    @staticmethod
    def forward(ctx, x, src, inverse):
        if inverse.shape[0] != x.shape[0]:
            raise ValueError(
                f"moe_dispatch: inverse map has {inverse.shape[0]} rows for {x.shape[0]} inputs"
            )
        ctx.save_for_backward(inverse)
        ctx.x_dtype = x.dtype
        return moe_dispatch_cuda(x, src)

    @staticmethod
    def backward(ctx, dout):
        (inverse,) = ctx.saved_tensors
        dout = dout.contiguous()
        if inverse.dim() == 1:
            dx = moe_dispatch_cuda(dout, inverse)
        else:
            ones = torch.ones(inverse.shape, dtype=torch.float32, device=dout.device)
            dx = moe_combine_cuda(dout, inverse, ones, out_dtype=ctx.x_dtype)
        return dx, None, None


class MoECombineFn(torch.autograd.Function):
    """``moe_combine`` with its backward kernel; ``inverse [P]`` is the
    flat ``t * S + s`` term reading each packed row (-1 for none), the exact
    inverse of ``slot``; the result is rounded once to ``out_dtype``."""

    @staticmethod
    def forward(ctx, y, slot, weights, inverse, out_dtype=torch.float32):
        if inverse.shape != (y.shape[0],):
            raise ValueError(f"moe_combine: inverse map {tuple(inverse.shape)} for {y.shape[0]} rows")
        ctx.save_for_backward(y, slot, weights, inverse)
        return moe_combine_cuda(y, slot, weights, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, dout):
        y, slot, weights, inverse = ctx.saved_tensors
        dy, dw = moe_combine_bwd_cuda(
            dout.float().contiguous(), y, slot, weights, inverse,
            need_dw=ctx.needs_input_grad[2],
        )
        return (dy if ctx.needs_input_grad[0] else None), None, dw, None, None
