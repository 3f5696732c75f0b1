"""Flash attention (prefill) and paged flash decode: the CUDA kernels
(``csrc/flash_attention.cu``, ``csrc/paged_flash_decode.cu``) beside their
plain PyTorch versions.

Port of :mod:`repro.kernels.flash_attention` (``flash_attention_pallas``
and ``paged_flash_decode_pallas``), plus a backward kernel for prefill
attention (the JAX package differentiates its jnp reference) behind
:class:`FlashAttentionFn`.  The wrappers check device, dtype, shape and
contiguity, allocate outputs with ``torch.empty`` and raise on anything the
kernels do not take; they never fall back.  Paged decode has no backward:
its wrapper raises when asked for a gradient.

Head dims: the kernels are built at every multiple of 32 up to 256.  Any
other multiple of 8 up to ``MAX_HEAD_DIM`` is zero-padded along D to the
next of them inside the wrapper, with the softmax scale of the true D, and
the results are sliced back: zero columns add exact zeros to every q.k and
the padded v columns are dropped, so the padding changes no value.

Which kernel runs is a static rule on the dtype and the padded head dim,
decided in ``csrc/flash_attention.cu`` before the launch: bf16 goes to the
TMA / wgmma kernels, forward at every width and backward up to D = 128;
the bf16 backward at D = 160 .. 256 (a 64-key tile of dK and dV does not
fit the wgmma kernel's registers) and all of f32 go to the f32-staged
CUDA-core kernels.  bf16 inputs must start on 16-byte boundaries (the TMA
maps; every fresh PyTorch allocation does).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention as flash_attention_plain
from repro_torch.kernels.ref import flash_attention_bwd as flash_attention_bwd_plain
from repro_torch.kernels.ref import paged_flash_decode as paged_flash_decode_plain

__all__ = [
    "flash_attention_cuda", "flash_attention_bwd_cuda", "FlashAttentionFn",
    "flash_attention_plain", "flash_attention_bwd_plain",
    "paged_flash_decode_cuda", "paged_flash_decode_plain", "MAX_HEAD_DIM",
]

MAX_HEAD_DIM = 256  # any multiple of 8 up to this is taken
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FLASH_SIG = {
    "flash_attention_fwd": (
        (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _F, _P), ctypes.c_int,
    ),
    "flash_attention_bwd": (
        (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _F, _P),
        ctypes.c_int,
    ),
}
_PAGED_SIG = {
    "paged_flash_decode": (
        (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _F, _P),
        ctypes.c_int,
    ),
}


def _check(name: str, tensors: dict, dtype=None) -> None:
    for arg, x in tensors.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name}: {arg} must be a CUDA tensor, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if dtype is not None and x.dtype != dtype:
            raise TypeError(f"{name}: {arg} is {x.dtype}, expected {dtype}")


def _knobs(window, softcap) -> tuple[int, float]:
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    return (0 if window is None else int(window)), (0.0 if softcap is None else float(softcap))


def _head_dim(name: str, d: int) -> int:
    """The kernel width that takes head dim ``d``: ``d`` rounded up to a
    multiple of 32.  Raises on a ``d`` the wrapper does not take."""
    if d <= 0 or d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} must be a positive multiple of 8 and at most "
                         f"{MAX_HEAD_DIM}")
    return -(-d // 32) * 32


def _pad(t: torch.Tensor, dp: int) -> torch.Tensor:
    """``t`` zero-padded along its last dim to ``dp``."""
    return t if t.shape[-1] == dp else F.pad(t, (0, dp - t.shape[-1]))


def _flash_shapes(name: str, q, k, v) -> tuple[int, int, int, int, int]:
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name} takes bf16 or f32, got {q.dtype}")
    _check(name, {"q": q, "k": k, "v": v}, q.dtype)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"{name} takes q [B,Hq,S,D] and k/v [B,Hkv,S,D]")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d or hq % hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    _head_dim(name, d)
    return b, hq, hkv, s, d


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    return_lse: bool = False,
):
    """``q [B, Hq, S, D]``, ``k/v [B, Hkv, S, D]`` (bf16 or f32, D a multiple
    of 8 up to 256) -> ``[B, Hq, S, D]`` in q's dtype; with ``return_lse``
    also each row's f32 log-sum-exp ``[B, Hq, S]`` (for the backward)."""
    b, hq, hkv, s, d = _flash_shapes("flash_attention_cuda", q, k, v)
    win, cap = _knobs(window, softcap)
    dp = _head_dim("flash_attention_cuda", d)
    q, k, v = (_pad(t, dp) for t in (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device) if return_lse else None
    if q.numel() == 0:
        out = out[..., :d]
        return (out, lse) if return_lse else out
    lib = build.library("flash_attention", _FLASH_SIG)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), _DTYPES[q.dtype],
        b, hq, hkv, s, dp, 1.0 / d**0.5, int(bool(causal)), win, cap,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed (error {err})")
    flash_attention_cuda.launches += 1
    if dp != d:
        out = out[..., :d].contiguous()
    return (out, lse) if return_lse else out


flash_attention_cuda.launches = 0


def flash_attention_bwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) for the output gradient ``dout``, from the forward's
    inputs, output and log-sum-exp (``return_lse=True``).  bf16 up to D =
    128 runs the wgmma kernels, bf16 above it and f32 the f32-staged ones
    (module docstring); both are deterministic (no atomics)."""
    b, hq, hkv, s, d = _flash_shapes("flash_attention_bwd_cuda", q, k, v)
    _check("flash_attention_bwd_cuda", {"out": out, "dout": dout}, q.dtype)
    _check("flash_attention_bwd_cuda", {"lse": lse}, torch.float32)
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (b, hq, s):
        raise ValueError("flash_attention_bwd_cuda: out/dout like q, lse [B, Hq, S]")
    win, cap = _knobs(window, softcap)
    dp = _head_dim("flash_attention_bwd_cuda", d)
    q, k, v, out, dout = (_pad(t, dp) for t in (q, k, v, out, dout))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.numel() == 0:
        return dq[..., :d], dk[..., :d], dv[..., :d]
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    lib = build.library("flash_attention", _FLASH_SIG)
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _DTYPES[q.dtype], b, hq, hkv, s, dp, 1.0 / d**0.5, int(bool(causal)), win, cap,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed (error {err})")
    flash_attention_bwd_cuda.launches += 1
    if dp != d:
        dq, dk, dv = (t[..., :d].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Prefill / training attention on the card with its backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = flash_attention_cuda(
            q, k, v, causal=causal, window=window, softcap=softcap, return_lse=True
        )
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.knobs = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse, dout.contiguous(), **ctx.knobs)
        return dq, dk, dv, None, None, None


def paged_flash_decode_cuda(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """``q [B, C, Hq, D]`` against pools ``[N, page, Hkv, D]`` through
    ``page_table [B, P]`` i32 (-1 = unallocated, read as page 0 as the plain
    version reads it) and ``lengths [B]`` i32
    (row c attends positions <= t + c) -> ``[B, C, Hq, D]`` in q's dtype,
    D a multiple of 8 up to 256 (a D off the kernel widths copies the pools
    zero-padded for the call).  It has no backward: it raises when grad
    mode is on and an input requires grad."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k_pool, v_pool)):
        raise RuntimeError(
            "paged_flash_decode_cuda has no backward: call it under torch.no_grad() "
            "or with inputs that do not require grad"
        )
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_flash_decode_cuda takes bf16 or f32, got {q.dtype}")
    _check("paged_flash_decode_cuda", {"q": q, "k_pool": k_pool, "v_pool": v_pool}, q.dtype)
    _check("paged_flash_decode_cuda", {"page_table": page_table, "lengths": lengths},
           torch.int32)
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError("paged_flash_decode_cuda takes q [B,C,Hq,D], pools [N,page,Hkv,D]")
    b, c, hq, d = q.shape
    _, page, hkv, dk = k_pool.shape
    if dk != d or hq % hkv:
        raise ValueError(f"paged_flash_decode_cuda: q {tuple(q.shape)} vs pool {tuple(k_pool.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != b or lengths.shape != (b,):
        raise ValueError("paged_flash_decode_cuda takes page_table [B, P] and lengths [B]")
    dp = _head_dim("paged_flash_decode_cuda", d)
    # Four warps, each with one page of K and V (bf16 rows padded by 8) and
    # its scores, and their partials.
    rs = dp + 8 if q.dtype == torch.bfloat16 else dp
    if 4 * (2 * page * rs * q.element_size() + 32 * page) + 32 * (2 + rs) * 4 > _SMEM_LIMIT:
        raise ValueError(f"paged_flash_decode_cuda: page {page} x D {dp} exceeds shared memory")
    win, cap = _knobs(window, softcap)
    if q.numel() == 0:
        return torch.empty_like(q)
    q, k_pool, v_pool = (_pad(t, dp) for t in (q, k_pool, v_pool))
    if q.data_ptr() % 16:
        q = q.clone()  # the kernel reads q in 16-byte chunks
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_flash_decode_cuda: the pools must start on 16-byte boundaries")
    out = torch.empty_like(q)
    lib = build.library("paged_flash_decode", _PAGED_SIG)
    err = lib.paged_flash_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b, c, hq, hkv, page,
        page_table.shape[1], dp, 1.0 / d**0.5, win, cap,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"paged_flash_decode kernel launch failed (error {err})")
    paged_flash_decode_cuda.launches += 1
    paged_flash_decode_cuda.shapes[(b, c)] = paged_flash_decode_cuda.shapes.get((b, c), 0) + 1
    return out[..., :d].contiguous() if dp != d else out


paged_flash_decode_cuda.launches = 0
paged_flash_decode_cuda.shapes = {}  # (B, C) -> launches
