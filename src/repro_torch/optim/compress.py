"""Gradient compression for the DP all-reduce.

Port of :mod:`repro.optim.compress`: a symmetric per-tensor int8 codec with
an error-feedback residual (Seide et al.), and the compressed hierarchical
reduction of paper §5.3 — quantize against a scale shared by every shard,
reduce the int32 values through the CommRuntime's reduce-scatter ->
all-reduce -> all-gather, one shared dequantization.  Over a
``DeviceMesh`` the axes are the mesh's named dims.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import commruntime as cr

__all__ = [
    "int8_encode", "int8_decode", "compressed_psum", "compressed_hierarchical_psum",
    "error_feedback_update",
]


def int8_encode(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization: returns (q, scale)."""
    amax = torch.max(torch.abs(x.float()))
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def _pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return cr.all_reduce(x, cr.axis_group(mesh, axis), op=dist.ReduceOp.MAX)


def compressed_psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """int8-quantized all-reduce over one mesh axis: quantize against the
    max scale over the shards, sum exactly in int32, decode once."""
    _, scale = int8_encode(x)
    scale = _pmax(scale, mesh, axis)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    total = cr.all_reduce(q.to(torch.int32), cr.axis_group(mesh, axis))
    return (total.float() * scale).to(x.dtype)


def compressed_hierarchical_psum(x: torch.Tensor, mesh, inner_axis: str | None,
                                 outer_axis: str | None = None, *, scatter_dim: int = 0,
                                 with_local: bool = False):
    """int8 hierarchical all-reduce through the runtime's stages.
    ``with_local=True`` also returns this shard's own decoded contribution
    (f32), which error feedback subtracts."""
    axes = [a for a in (inner_axis, outer_axis) if a]
    if not axes:
        return (x, x.float()) if with_local else x
    xf = x.float()
    scale = torch.clamp_min(torch.max(torch.abs(xf)), 1e-12) / 127.0
    for a in axes:
        scale = _pmax(scale, mesh, a)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int32)
    with torch.no_grad():
        if inner_axis is None:
            total = cr.all_reduce(q, cr.axis_group(mesh, outer_axis))
        else:
            total = cr.hierarchical_psum(q, mesh, inner_axis, outer_axis, scatter_dim=scatter_dim)
    out = (total.float() * scale).to(x.dtype)
    if with_local:
        return out, q.float() * scale
    return out


def error_feedback_update(grad, residual, encode_decode):
    """One error-feedback step: compress (grad + residual), keep the error.
    Returns (decoded, new_residual)."""
    target = grad.float() + residual.float()
    decoded = encode_decode(target)
    return decoded.to(grad.dtype), target - decoded.float()
