"""Public kernel entry points of the port.

Each op dispatches on the tensor's device: a CPU tensor goes to the plain
PyTorch version (:mod:`repro_torch.kernels.ref`), a CUDA tensor goes to the
hand-written kernel — whose wrapper raises on anything the kernel does not
take.  No path falls back from the kernel to the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda,
    paged_flash_decode_cuda,
)
from repro_torch.kernels.topk_gating import topk_gating_cuda

__all__ = [
    "topk_gating", "flash_attention", "paged_flash_decode", "KERNELS",
    "launch_counts", "reset_launch_counts",
]

# Every ported kernel's CUDA wrapper, by kernel name.
KERNELS = {
    "topk_gating": topk_gating_cuda,
    "flash_attention": flash_attention_cuda,
    "paged_flash_decode": paged_flash_decode_cuda,
}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def topk_gating(logits: torch.Tensor, k: int):
    """``[T, E]`` logits -> (``[T, k]`` f32 weights, ``[T, k]`` i32 ids)."""
    if _on_cpu(logits):
        return ref.topk_gating(logits, k)
    return topk_gating_cuda(logits.float().contiguous(), k)


def flash_attention(q, k, v, *, causal: bool = True, window=None, softcap=None):
    """``q [B, Hq, S, D]``, ``k/v [B, Hkv, S, D]`` -> ``[B, Hq, S, D]``."""
    if _on_cpu(q):
        return ref.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
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
