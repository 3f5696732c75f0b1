"""Shared MoE routing engine for the einsum, dense-decode and mixnet
backends.

Port of :mod:`repro.models.routing`: router logits -> top-k
(``ops.topk_gating``) -> renormalize -> virtual-slot destinations (the
runtime ``expert_perm`` re-addressing the control plane plans) -> ranks
within each destination bucket from ONE stable sort -> the static-shape
dispatch plans (``capacity_plan``, ``dropless_plan``) the mixnet backend
packs with.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops

__all__ = [
    "MoEStats",
    "RoutingInfo",
    "compute_routing",
    "effective_top_k",
    "resolve_perm",
    "router_losses",
    "expert_load",
    "capacity",
    "bucket_ranks",
    "dense_dispatch_masks",
    "DispatchPlan",
    "capacity_plan",
    "dropless_plan",
]


@dataclasses.dataclass
class MoEStats:
    """Per-layer telemetry consumed by the MixNet control plane (§5.1)."""

    expert_load: torch.Tensor  # [E] tokens routed to each (real) expert
    balance_loss: torch.Tensor
    z_loss: torch.Tensor
    dropped_fraction: torch.Tensor


@dataclasses.dataclass
class RoutingInfo:
    """Router decisions for a flat batch of T tokens (S = top_k · r)."""

    weights: torch.Tensor  # [T, K] f32, renormalized over the kept top-k
    idx: torch.Tensor  # [T, K] i32 real-expert ids (for load/loss telemetry)
    vdest: torch.Tensor  # [T, S] i32 physical virtual-slot destinations
    wfull: torch.Tensor  # [T, S] f32 combine weight per virtual destination


@dataclasses.dataclass
class DispatchPlan:
    """Static-shape token layout for one dispatch stage.

    ``slot[i]`` is the packed-buffer row of flat choice ``i`` (-1 dropped);
    ``src[p]`` is the flat choice occupying packed row ``p`` (-1 empty) —
    the two are inverse views of the same permutation (the backward passes
    on the card gather through them).  ``num_rows`` is the static packed
    height; ``block_experts`` (dropless layouts only) maps each
    ``block``-row tile to its owning expert, non-decreasing, for the
    grouped GEMM.  ``kept`` counts the placed choices (telemetry).
    """

    slot: torch.Tensor  # [N] i32
    src: torch.Tensor  # [num_rows] i32
    num_rows: int
    block_experts: torch.Tensor | None
    kept: torch.Tensor  # scalar


def effective_top_k(top_k: int, draft_mode: str = "off") -> int:
    """Routed choices per token under a speculative draft mode: ``topk1``
    narrows to the best expert, ``shared_only`` routes nothing (0 is a
    sentinel, not a valid ``top_k``)."""
    if draft_mode == "topk1":
        return min(top_k, 1)
    if draft_mode == "shared_only":
        return 0
    return top_k


def compute_routing(
    logits: torch.Tensor,
    *,
    top_k: int,
    num_virtual: int,
    replication: int,
    expert_perm: torch.Tensor | None = None,
    renormalize: bool = True,
    draft_mode: str = "off",
) -> RoutingInfo:
    """Top-k gate + virtual-slot destination map for ``[T, E]`` logits.

    Each choice (t, k) targets all ``r = replication`` tensor shards of its
    expert, re-addressed by the layer's ``expert_perm`` (virtual expert ->
    physical slot); ``wfull`` repeats the combine weight per shard.
    """
    top_k = effective_top_k(top_k, draft_mode)
    if top_k <= 0:
        raise ValueError("shared_only drafts skip routing entirely")
    t = logits.shape[0]
    weights, idx = ops.topk_gating(logits, top_k)
    if renormalize:
        weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    r = replication
    shards = torch.arange(r, dtype=torch.int32, device=logits.device)
    vdest = (idx[..., None] * r + shards).reshape(t, top_k * r)
    if expert_perm is not None:
        perm = resolve_perm(expert_perm, num_virtual, device=logits.device)
        vdest = perm[vdest.long()]
    wfull = weights.repeat_interleave(r, dim=-1)
    return RoutingInfo(weights=weights, idx=idx, vdest=vdest, wfull=wfull)


def resolve_perm(expert_perm, num_virtual: int, *, device=None) -> torch.Tensor:
    """Validate one layer's [E_virtual] expert->slot map (identity if None)."""
    if expert_perm is None:
        return torch.arange(num_virtual, dtype=torch.int32, device=device)
    perm = torch.as_tensor(expert_perm, dtype=torch.int32, device=device)
    if perm.shape != (num_virtual,):
        raise ValueError(
            f"expert_perm must be this layer's [E_virtual]={num_virtual} row, "
            f"got shape {tuple(perm.shape)}"
        )
    return perm


def expert_load(
    idx: torch.Tensor, num_experts: int, weights: torch.Tensor | None = None
) -> torch.Tensor:
    """[E] f32 routed-token counts per real expert (scatter-add).

    ``weights`` is an optional per-token weight ``[T]`` broadcast over the
    top-k choices — the serving engine's live-slot mask."""
    flat = idx.reshape(-1).long()
    if weights is None:
        contrib = torch.ones(flat.shape[0], dtype=torch.float32, device=idx.device)
    else:
        contrib = weights.reshape(-1).float().repeat_interleave(idx.shape[-1])
    out = torch.zeros(num_experts, dtype=torch.float32, device=idx.device)
    return out.index_add_(0, flat, contrib)


def router_losses(logits: torch.Tensor, idx: torch.Tensor, num_experts: int):
    """Switch-style balance loss + router z-loss (both f32 scalars)."""
    lf = logits.float()
    probs = torch.softmax(lf, dim=-1)
    mean_prob = probs.reshape(-1, num_experts).mean(dim=0)
    counts = expert_load(idx, num_experts)
    frac = counts / torch.clamp_min(counts.sum(), 1.0)
    balance = num_experts * torch.sum(frac * mean_prob)
    z = torch.mean(torch.logsumexp(lf, dim=-1) ** 2)
    return balance, z


def capacity(tokens: int, top_k: int, num_buckets: int, factor: float) -> int:
    """Per-bucket capacity for the capacity-factor mode (multiple of 4)."""
    c = int(np.ceil(tokens * top_k * factor / num_buckets))
    return max(4, int(np.ceil(c / 4) * 4))


def bucket_ranks(
    dest: torch.Tensor, num_buckets: int, *, valid: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank of each flat choice within its destination bucket.

    One stable sort over ``dest [N]`` orders choices by bucket while keeping
    token order inside each bucket.  Entries with ``valid`` False sort into
    a trash bucket.  Returns ``(rank [N] i32, counts [num_buckets] i32)``.
    """
    n = dest.shape[0]
    key = dest.long()
    total = num_buckets
    if valid is not None:
        key = torch.where(valid, key, torch.full_like(key, num_buckets))
        total = num_buckets + 1
    order = torch.argsort(key, stable=True)
    skey = key[order]
    counts = torch.zeros(total, dtype=torch.int64, device=dest.device)
    counts.index_add_(0, key, torch.ones_like(key))
    starts = torch.cumsum(counts, 0) - counts  # cumsum over buckets, not tokens
    rank_sorted = torch.arange(n, device=dest.device) - starts[skey]
    rank = torch.empty(n, dtype=torch.int64, device=dest.device)
    rank[order] = rank_sorted
    return rank.to(torch.int32), counts[:num_buckets].to(torch.int32)


def dense_dispatch_masks(
    vdest: torch.Tensor,
    rank: torch.Tensor,
    keep: torch.Tensor,
    wfull: torch.Tensor,
    num_slots: int,
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dispatch, combine) masks ``[..., num_slots, cap]`` for the GShard
    einsum backend, from the sort-based ranks.  The one-hots are built by
    comparison with an ``arange`` (``F.one_hot`` checks its input's range
    on the card, a host sync)."""
    dev = vdest.device
    de = (vdest[..., None] == torch.arange(num_slots, device=dev)).float()
    dc = (rank.clamp(0, cap - 1)[..., None] == torch.arange(cap, device=dev)).float()
    keepf = keep.float()
    dispatch = torch.einsum("...se,...sc,...s->...ec", de, dc, keepf)
    combine = torch.einsum("...se,...sc,...s->...ec", de, dc, keepf * wfull)
    return dispatch, combine


def _invert_slots(slot: torch.Tensor, keep: torch.Tensor, num_rows: int) -> torch.Tensor:
    """src[p] = flat choice occupying packed row p, -1 where empty."""
    n = slot.shape[0]
    scatter_to = torch.where(keep, slot.long(), torch.full_like(slot, num_rows, dtype=torch.long))
    src = torch.full((num_rows + 1,), -1, dtype=torch.int32, device=slot.device)
    src[scatter_to] = torch.arange(n, dtype=torch.int32, device=slot.device)
    return src[:num_rows]


def capacity_plan(
    dest: torch.Tensor,
    rank: torch.Tensor,
    valid: torch.Tensor | None,
    num_buckets: int,
    cap: int,
) -> DispatchPlan:
    """GShard layout: bucket-major ``[num_buckets * cap]`` rows, overflow
    (rank >= cap) dropped.  With ``cap`` >= the worst-case bucket count this
    layout is dropless (how the all-to-all send stage expresses dropless
    without dynamic buffer sizes)."""
    keep = rank < cap
    if valid is not None:
        keep = keep & valid
    slot = torch.where(keep, dest * cap + rank, torch.full_like(dest, -1)).to(torch.int32)
    num_rows = num_buckets * cap
    src = _invert_slots(slot, keep, num_rows)
    return DispatchPlan(slot=slot, src=src, num_rows=num_rows, block_experts=None,
                        kept=keep.sum())


def dropless_plan(
    dest: torch.Tensor,
    rank: torch.Tensor,
    counts: torch.Tensor,
    valid: torch.Tensor | None,
    num_buckets: int,
    block: int,
) -> DispatchPlan:
    """MegaBlocks layout: every valid choice placed, buckets padded up to a
    multiple of ``block`` rows so each ``block``-row tile is owned by exactly
    one expert.  Static height: padding never exceeds ``E * (block - 1)``
    rows; the trailing tiles past the last bucket are clipped to the last
    expert and hold zero rows."""
    n = dest.shape[0]
    dev = dest.device
    nblk = (n + num_buckets * (block - 1)) // block
    num_rows = nblk * block
    pcounts = ((counts.long() + block - 1) // block) * block
    ends = torch.cumsum(pcounts, 0)
    starts = ends - pcounts
    ok = valid if valid is not None else torch.ones((n,), dtype=torch.bool, device=dev)
    safe_dest = dest.long().clamp(0, num_buckets - 1)
    slot = torch.where(ok, starts[safe_dest] + rank, torch.full_like(ends[:1], -1))
    slot = slot.to(torch.int32)
    src = _invert_slots(slot, ok, num_rows)
    tile_rows = torch.arange(nblk, device=dev, dtype=torch.long) * block
    block_experts = torch.searchsorted(ends, tile_rows, right=True).clamp(0, num_buckets - 1)
    return DispatchPlan(slot=slot, src=src, num_rows=num_rows,
                        block_experts=block_experts.to(torch.int32), kept=ok.sum())
