"""Parameter interop: the JAX package's parameter tree, already converted to
numpy, into the port's tensors, name for name.

The port imports neither JAX nor the JAX package; a caller that has both
converts first (``jax.tree.map(np.asarray, params)``) and hands the numpy
tree over.  ``bfloat16`` leaves arrive as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` refuses: their bits are reinterpreted as ``uint16``,
built into an ``int16`` tensor and viewed as ``torch.bfloat16``.  The same
converter carries an AdamW state across (``{"mu", "nu", "step"}``: nested
moment trees and an int32 scalar), so two trainers can start from one
state.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["tensor_from_numpy", "params_from_numpy", "shard_params"]

# Leaves that stay f32 whatever ``cfg.dtype`` says: the MoE router, and the
# Mamba-2 block's per-head ``dt_bias``, ``A_log`` and ``D``.
_F32_LEAVES = frozenset({"router", "dt_bias", "A_log", "D"})


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """One numpy array (or scalar) as a tensor on ``device``, bit for bit.
    Integer arrays — expert-perm stacks, page tables — keep their int type."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_numpy(tree, cfg=None, device="cpu", *, trainable: bool = False):
    """The port's parameters (or optimizer state) from a numpy tree (nested
    dicts of arrays), same names, same shapes, same dtypes.  With ``cfg``
    given, each floating leaf is checked against the dtype both packages
    give it: f32 for the router and Mamba-2's ``dt_bias``, ``A_log`` and
    ``D``, ``cfg.dtype`` for every other; with ``trainable`` every floating
    leaf requires grad, as the trainer's parameters do."""

    def conv(node, path):
        if isinstance(node, dict):
            return {k: conv(v, f"{path}/{k}") for k, v in node.items()}
        t = tensor_from_numpy(node, device)
        if cfg is not None and t.is_floating_point():
            leaf = path.rsplit("/", 1)[-1]
            want = torch.float32 if leaf in _F32_LEAVES else getattr(torch, cfg.dtype)
            if t.dtype != want:
                raise TypeError(f"{path}: {t.dtype} but this leaf is {want} under {cfg.dtype}")
        if trainable and t.is_floating_point():
            t.requires_grad_(True)
        return t

    return conv(tree, "")


def shard_params(tree, plan, mesh, rank: int | None = None, *, cfg):
    """A rank's shard of a global numpy tree (the JAX package's, converted),
    by the one layout rule of :class:`repro_torch.parallel.sharding.TreeLayout`:
    the expert leaves keep the rank's ``E_virtual / P`` slots of the model
    axis and the tensor-parallel leaves their model-axis shard, under ZeRO-3
    the data shard of each leaf the data axis shards, over a
    ``"stage"`` axis the rank keeps its stage's repeats and ends (``cfg``,
    the model's config, sizes the tensor-parallel leaves and says whether
    the head is tied), every other leaf stays whole.
    ``rank`` is the global rank (default: this process's); the result is
    still numpy, for :func:`params_from_numpy`, so a card only ever receives
    its shard."""
    if mesh is None:
        return tree
    from repro_torch.parallel.sharding import TreeLayout

    layout = TreeLayout(plan, mesh, cfg)
    return layout.shard(tree, rank)
