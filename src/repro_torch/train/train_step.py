"""Training and serving step factories.

Port of :mod:`repro.train.train_step`.  ``jit`` has no counterpart here:
each factory returns a plain eager function.  The training step
differentiates :func:`loss_fn` with ``torch.autograd.grad`` and applies
AdamW in place; the serving steps run under ``torch.no_grad``.  The DP
gradient reduction modes other than ``"auto"`` (the CommRuntime
all-reduce, its int8 compression) come with the multi-device slice.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as tfm
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_adamw
from repro_torch.parallel.sharding import ShardingPlan

__all__ = [
    "loss_fn", "make_train_step", "init_all", "make_prefill_step", "make_prefill_chunk_step",
    "make_serve_step",
]


def loss_fn(params, batch, cfg, plan, mesh=None, expert_perm=None, wire_perm=None):
    """``(loss, (ce, aux))``: chunked cross entropy plus the MoE balance and
    router-z losses.  ``expert_perm``: ``[repeats, E_virtual]`` per-layer
    expert->slot maps; ``wire_perm``: optional ``[repeats, P]`` device maps."""
    feats, aux, _ = tfm.model_apply(
        params, batch, cfg, plan, mesh=mesh, mode="train", expert_perm=expert_perm,
        wire_perm=wire_perm,
    )
    ce = tfm.chunked_cross_entropy(params, feats, batch["labels"], cfg)
    loss = ce
    if cfg.is_moe:
        loss = loss + cfg.moe.balance_loss * aux.balance_loss
        loss = loss + cfg.moe.router_z_loss * aux.z_loss
    return loss, (ce, aux)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _unflat(pairs: dict, like):
    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}/{k}") for k, v in node.items()}
        return pairs[prefix]

    return build(like, "")


def make_train_step(
    cfg,
    plan: ShardingPlan,
    opt_cfg: AdamWConfig,
    mesh=None,
    microbatches: int = 1,
    dp_comm: str = "auto",
    dp_compress: bool = False,
):
    """``(params, opt_state, batch, expert_perm, wire_perm) -> (params,
    opt_state, metrics)``, updating ``params`` and ``opt_state`` in place.
    ``microbatches > 1`` accumulates gradients over batch slices in a
    Python loop."""
    if dp_comm not in ("auto", "runtime"):
        raise ValueError(f"unknown dp_comm mode {dp_comm!r}")
    if dp_comm != "auto" or dp_compress:
        raise NotImplementedError(
            "dp_comm='runtime' and dp_compress come with the multi-device slice"
        )

    def grad_once(params, batch, expert_perm, wire_perm):
        """``(metrics, grads)``: the loss terms and expert loads, and every
        leaf's gradient by its path (zeros for a leaf the loss does not
        reach)."""
        leaves = dict(_flat(params))
        wrt = [k for k, t in leaves.items() if t.requires_grad]
        with torch.enable_grad():
            loss, (ce, aux) = loss_fn(params, batch, cfg, plan, mesh, expert_perm, wire_perm)
            got = torch.autograd.grad(loss, [leaves[k] for k in wrt], allow_unused=True)
        grads = dict(zip(wrt, got))
        for k, t in leaves.items():
            if grads.get(k) is None:
                grads[k] = torch.zeros_like(t)
        out = {"loss": loss, "ce": ce, "balance_loss": aux.balance_loss, "z_loss": aux.z_loss}
        if cfg.is_moe:
            out["expert_load"] = aux.moe_stats  # [repeats, E]
            out["dropped_fraction"] = aux.dropped_fraction  # [repeats]
        return {k: v.detach() for k, v in out.items()}, grads

    def add_slice(acc, part, m):
        # ``acc + part / m`` in slice order, as the reference's scan sums
        # from zeros (and 0 + v / m is v / m exactly).
        return {k: v / m if acc is None else acc[k] + v / m for k, v in part.items()}

    def train_step(params, opt_state, batch, expert_perm=None, wire_perm=None):
        if microbatches <= 1:
            metrics, grads = grad_once(params, batch, expert_perm, wire_perm)
        else:
            b = batch["tokens"].shape[0]
            m = microbatches
            assert b % m == 0, (b, m)
            toks = batch["tokens"].reshape(m, b // m, -1)
            labs = batch["labels"].reshape(m, b // m, -1)
            metrics = grads = None
            for i in range(m):
                mi, gi = grad_once(params, {"tokens": toks[i], "labels": labs[i]}, expert_perm,
                                   wire_perm)
                metrics, grads = add_slice(metrics, mi, m), add_slice(grads, gi, m)
        params, opt_state, opt_metrics = adamw_update(params, _unflat(grads, params), opt_state,
                                                      opt_cfg)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def init_all(seed: int, cfg, plan: ShardingPlan, opt_cfg: AdamWConfig, *, device=None):
    """``(params, specs, opt_state)``: seeded parameters with
    ``requires_grad`` on every floating leaf (the f32 router included) and
    zero AdamW moments.  ``specs`` is None: sharding specs come with the
    multi-device slice."""
    params = tfm.init_model(seed, cfg, plan, device=device)
    for _, t in _flat(params):
        if t.is_floating_point():
            t.requires_grad_(True)
    return params, None, init_adamw(params, opt_cfg)


def make_prefill_step(cfg, plan: ShardingPlan, mesh=None, *, with_stats: bool = False):
    """``(params, batch, expert_perm, wire_perm) -> (next_tok [B, 1] i32,
    caches[, gate loads [reps, E], or None for a model without MoE])``."""

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
