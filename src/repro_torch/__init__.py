"""PyTorch + CUDA port of :mod:`repro` (the serving and training slices).

Mirrors the JAX package's subpackage and module names; every Pallas kernel
on the ported path is a hand-written CUDA kernel under ``csrc/`` with its
plain PyTorch version beside it (:mod:`repro_torch.kernels`).  Nothing here
imports JAX or the JAX package.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The entry points' device rule: the card unless the caller asks for
    the CPU.  With no card and no explicit CPU request this raises — the
    port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
