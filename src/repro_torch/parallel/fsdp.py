"""ZeRO-3 over the data axis: a rank's parameter shards gathered before use.

The reference shards every leaf its init specs give an FSDP dim over the
data axis and lets GSPMD gather it where a product reads it.  The port
writes the gathers out.  A rank holds its data shard of each such leaf
(:class:`~repro_torch.parallel.sharding.TreeLayout`), and a leaf narrower
than ``cfg.d_model`` along its FSDP dim is read as a shard (:func:`shard_dim`,
as a tensor-parallel leaf narrower than the config's is read as the model
axis's shard):

* :func:`gather` all-gathers a shard over the data axis (a copy, the
  same bits on every rank) in the forward and again in a remat recompute;
  its backward sums the ranks' gradients of the whole leaf and keeps the
  rank's shard, as ``commruntime.reduce_scatter_ordered``: one all-to-all
  of the shares, then an f32 tree over rank order, cast once.  The
  replicated plan's gradient all-reduce over the data axis is the same sum
  (``train_step.reduce_grads``), so ZeRO-3 takes the replicated plan's
  steps bit for bit.
* :func:`gather_block` gathers one repeat's block leaves, :func:`gather_ends`
  the embedding and the LM head (once a step: a tied head's two uses sum
  their gradients before the one reduce-scatter, as the replicated leaf's
  do before its all-reduce).
* :func:`prefetch_ffn` is the reference's double-buffered prefetch
  (``cfg.fsdp_prefetch``, ``src/repro/models/transformer.py:455-500``): block
  l+1's FFN leaves (``_FFN_PREFETCH_DIMS`` there) are ring-gathered on the
  comm worker thread (``core.overlap.ring_gather_leaf``) while block l
  computes, and handed to :func:`gather_block`; a remat recompute gathers
  on demand.  Both are copies of the same shards, so prefetch and on-demand
  steps are the same bits.
"""

from __future__ import annotations

import torch

from repro_torch.core import commruntime as cr
from repro_torch.core.overlap import ring_gather_leaf
from repro_torch.parallel.sharding import fsdp_leaf_dim

__all__ = ["active", "shard_dim", "gather", "gather_block", "gather_ends", "prefetch_ffn",
           "gather_stage", "scatter_grad", "FFN_PREFETCH_LEAVES"]

# The FFN leaves the prefetch gathers (the reference's ``_FFN_PREFETCH_DIMS``).
FFN_PREFETCH_LEAVES = {"mlp": ("w_in", "w_gate", "w_out"), "moe": ("w_in", "w_gate", "w_out")}


def active(plan, mesh) -> bool:
    """True when ``plan`` shards parameters over a data axis of more than
    one rank of ``mesh``."""
    return (mesh is not None and plan is not None and plan.fsdp_axis is not None
            and cr.axis_size(mesh, plan.fsdp_axis) > 1)


def shard_dim(path: str, t: torch.Tensor, cfg, plan, mesh, lead: int = 0) -> int | None:
    """The dim of ``t``, the leaf at ``path`` (``lead`` leading dims fewer
    than the stored leaf: 1 for one repeat of a block leaf), that holds a
    data-axis shard, or None when ``t`` is whole over the data axis."""
    if not active(plan, mesh):
        return None
    dim = fsdp_leaf_dim(path)
    if dim is None:
        return None
    dim -= lead
    return dim if t.shape[dim] < cfg.d_model else None


def _scatter(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    """A whole leaf's gradient summed over ``group`` in rank order, the
    rank's shard along ``dim`` kept."""
    mine = cr.reduce_scatter_ordered(g.movedim(dim, 0).contiguous(), group)
    return mine.movedim(0, dim)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    full = cr.all_gather_raw(x.detach().movedim(dim, 0).contiguous(), group)
    return full.movedim(0, dim).contiguous()


class _Gather(torch.autograd.Function):
    """The shard all-gathered along ``dim`` (or a prefetch's ``pending``
    result); the backward is the rank-order reduce-scatter of the
    gradient."""

    @staticmethod
    def forward(ctx, shard, dim, group, pending):
        ctx.dim, ctx.group = dim, group
        return pending.wait() if pending is not None else _all_gather(shard, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.group), None, None, None


def gather(shard: torch.Tensor, dim: int, plan, mesh, pending=None) -> torch.Tensor:
    """The whole leaf of a rank's ZeRO-3 ``shard`` (sharded along ``dim``)
    over ``plan``'s data axis; ``pending``: a prefetch handle of the same
    gather (:func:`prefetch_ffn`)."""
    return _Gather.apply(shard, dim, cr.axis_group(mesh, plan.fsdp_axis), pending)


def gather_block(tree: dict, prefix: str, cfg, plan, mesh, pending=None) -> dict:
    """One repeat's block leaves (``tree``: their ``[...]`` slices of the
    stacked leaves at ``prefix``, e.g. ``blocks/0_global``) with every data
    shard gathered; ``pending``: ``{leaf path: prefetch handle}``."""
    if not active(plan, mesh):
        return tree
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}"
        if isinstance(v, dict):
            out[k] = gather_block(v, path, cfg, plan, mesh, pending)
            continue
        dim = shard_dim(path, v, cfg, plan, mesh, lead=1)
        handle = None if pending is None else pending.pop(path, None)
        out[k] = v if dim is None else gather(v, dim, plan, mesh, handle)
    return out


def gather_ends(params: dict, cfg, plan, mesh) -> dict:
    """``params`` with the embedding and the LM head whole over the data
    axis (the same dict when neither is a shard)."""
    if not active(plan, mesh):
        return params
    out = None
    for k in ("embed", "lm_head"):
        if k not in params:
            continue
        dim = shard_dim(k, params[k], cfg, plan, mesh)
        if dim is not None:
            out = dict(params) if out is None else out
            out[k] = gather(params[k], dim, plan, mesh)
    return params if out is None else out


def prefetch_ffn(blocks: dict, li: int, cfg, plan, mesh) -> dict:
    """Issue the ring gathers of repeat ``li``'s FFN shards (``blocks``: the
    stacked block tree) on the comm worker thread: ``{leaf path: handle}``
    for :func:`gather_block`."""
    out = {}
    for name, block in blocks.items():
        for kind, leaves in FFN_PREFETCH_LEAVES.items():
            sub = block.get(kind)
            if not isinstance(sub, dict):
                continue
            for leaf in leaves:
                if leaf not in sub:
                    continue
                path = f"blocks/{name}/{kind}/{leaf}"
                w = sub[leaf].detach()[li]
                dim = shard_dim(path, w, cfg, plan, mesh, lead=1)
                if dim is not None:
                    out[path] = ring_gather_leaf(w, mesh, plan.fsdp_axis, dim, async_op=True)
    return out


def gather_stage(blocks: dict, prefix: str, cfg, plan, mesh, keep_ffn: bool = False
                 ) -> tuple[dict, dict]:
    """A pipeline stage's stacked block leaves gathered whole once a step
    (the reference's stage specs drop their FSDP dims, ``pp_step.py:118-135``),
    as new leaves outside the graph: ``(tree, {leaf path: (whole leaf,
    dim)})``; the stage differentiates the microbatches with respect to the
    whole leaves, sums their gradients in microbatch order as the
    replicated stage does, and :func:`scatter_grad` reduces the sum once.
    ``keep_ffn`` (``cfg.fsdp_prefetch``): the FFN leaves stay shards, for
    the per-layer ring prefetch inside the stage (``pp_step.py:180-226``)."""
    whole: dict = {}

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            p = f"{path}/{k}"
            if isinstance(v, dict):
                out[k] = walk(v, p)
                continue
            dim = shard_dim(p, v, cfg, plan, mesh)
            kind, leaf = p.split("/")[-2:]
            if dim is None or (keep_ffn and leaf in FFN_PREFETCH_LEAVES.get(kind, ())):
                out[k] = v
                continue
            full = _all_gather(v, dim, cr.axis_group(mesh, plan.fsdp_axis))
            out[k] = full.requires_grad_(v.requires_grad)
            whole[p] = (out[k], dim)
        return out

    if not active(plan, mesh):
        return blocks, whole
    return walk(blocks, prefix), whole


def scatter_grad(g: torch.Tensor, dim: int, plan, mesh) -> torch.Tensor:
    """:func:`gather`'s backward on a whole leaf's gradient: summed over
    the data axis in rank order, the rank's shard along ``dim`` kept."""
    return _scatter(g, dim, cr.axis_group(mesh, plan.fsdp_axis))
