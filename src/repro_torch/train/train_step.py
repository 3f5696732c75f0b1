"""Serving step factories: prefill, chunked-prefill continuation and the
greedy decode step.

Port of the serving half of :mod:`repro.train.train_step`.  ``jit`` has no
counterpart here: each factory returns a plain eager function (run under
``torch.no_grad``).  Training steps come with the training slice.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as tfm
from repro_torch.parallel.sharding import ShardingPlan

__all__ = ["make_prefill_step", "make_prefill_chunk_step", "make_serve_step"]


def make_prefill_step(cfg, plan: ShardingPlan, mesh=None, *, with_stats: bool = False):
    """``(params, batch, expert_perm, wire_perm) -> (next_tok [B, 1] i32,
    caches[, gate loads [reps, E]])``."""

    @torch.no_grad()
    def prefill_step(params, batch, expert_perm=None, wire_perm=None):
        feats, aux, caches = tfm.model_apply(
            params, batch, cfg, plan, mode="prefill",
            expert_perm=expert_perm, wire_perm=wire_perm,
        )
        logits = tfm.logits_from_features(params, feats[:, -1:], cfg)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        if with_stats:
            return next_tok, caches, aux.moe_stats
        return next_tok, caches

    return prefill_step


def make_prefill_chunk_step(cfg, plan: ShardingPlan, mesh=None, *, with_stats: bool = False):
    """Chunked-prefill continuation: a ``[B, C]`` slice of prompt tokens
    runs against EXISTING caches in decode mode (positions ``t .. t+C-1``
    written in place, attended causally over the cached prefix plus the
    chunk); returns the next-token prediction after the chunk's last
    token."""
    bad = [k for k in (*cfg.block_pattern, *cfg.tail_pattern) if k not in ("global", "local")]
    if bad:
        raise ValueError(f"chunked prefill needs attention-only block patterns, got {bad}")

    @torch.no_grad()
    def chunk_step(
        params, caches, tokens, t, expert_perm=None, wire_perm=None,
        gate_weights=None, page_table=None,
    ):
        feats, aux, caches = tfm.model_apply(
            params, {"tokens": tokens}, cfg, plan, mode="decode", caches=caches, t=t,
            expert_perm=expert_perm, wire_perm=wire_perm, gate_weights=gate_weights,
            page_table=page_table,
        )
        logits = tfm.logits_from_features(params, feats[:, -1:], cfg)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        if with_stats:
            return next_tok, caches, aux.moe_stats
        return next_tok, caches

    return chunk_step


def make_serve_step(
    cfg, plan: ShardingPlan, mesh=None, *, sample: bool = False, with_stats: bool = False,
):
    """One greedy decode step: ``tokens [B, 1]`` + caches -> next token
    ``[B, 1]``.  Sampled decoding comes with its slice."""
    if sample:
        raise NotImplementedError("sampled decoding comes with its slice")

    @torch.no_grad()
    def serve_step(
        params, caches, tokens, t, rng=None, expert_perm=None, wire_perm=None,
        gate_weights=None, page_table=None,
    ):
        feats, aux, caches = tfm.model_apply(
            params, {"tokens": tokens}, cfg, plan, mode="decode", caches=caches, t=t,
            expert_perm=expert_perm, wire_perm=wire_perm, gate_weights=gate_weights,
            page_table=page_table,
        )
        logits = tfm.logits_from_features(params, feats, cfg)[:, -1]
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        if with_stats:
            return next_tok, caches, aux.moe_stats
        return next_tok, caches

    return serve_step
