"""Model assembly: embeddings -> stacked block weights looped over repeats
-> final norm -> LM head.  Block patterns: attention-only (GQA) with MoE
FFNs or dense MLPs (``cfg.is_moe`` picks), and Mamba-2's SSD blocks
(``"ssm"``, no MLP).

Port of :mod:`repro.models.transformer`.  Parameters are the JAX package's
tree as nested dicts of tensors, block weights stacked ``[reps, ...]`` per
pattern position; the scan over repeats is a Python loop over that
leading dim.  Modes: ``train``/``prefill`` (full sequence; prefill also
returns stacked ``[reps, B, S, Hkv, dh]`` attention caches, or ``{"state",
"conv"}`` for ssm blocks) and ``decode`` (a ``[B, C]`` chunk against dense
or paged caches, written in place; ssm blocks decode one token).  Training
differentiates through ``model_apply`` with ``torch.autograd`` and takes
its loss from :func:`chunked_cross_entropy`.

``cfg.remat`` applies in ``train`` mode as the reference's ``jax.checkpoint``
around each layer group (one repeat of ``block_pattern``): ``"full"`` keeps
only the group's input and recomputes the rest in the backward; ``"dots"``
keeps the products without batch dims (:func:`_dots_policy`) and recomputes
the rest, the hand-written kernels included.  The recompute runs the same
deterministic kernels on the same inputs, so values and gradients do not
change; only memory and time do.

ZeRO-3 (a plan with ``fsdp_axis``): each layer group gathers its block
leaves' data shards over the data axis before use
(:func:`repro_torch.parallel.fsdp.gather_block`), in the forward and again
in a remat recompute, and the embedding and LM head once a step; the
gathers' backward reduce-scatters the gradients to the shards.  With
``cfg.fsdp_prefetch`` the next group's FFN leaves are ring-gathered on the
comm worker thread while this group computes (the reference's
double-buffered prefetch, ``transformer.py:455-500``).

Sequence parallelism (``cfg.sp_shardmap`` over a model axis that divides
the sequence, in ``train`` and ``prefill`` mode, :func:`seq_parallel`):
the residual stream lives sequence-sharded, each rank holding its ``[B, S
/ P, D]`` slice from the embedding to the final norm (the reference's
activation spec, ``transformer.py:427-447``); the blocks gather and
scatter the sequence around their products (``models.layers``), the mixnet
MoE region takes the rank's slice as it is.  Decode is unchanged.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.parallel import fsdp, tp
from repro_torch.parallel.sharding import (
    ShardingPlan,
    TreeLayout,
    token_gather,
    token_slice,
    virtual_experts,
)

__all__ = [
    "init_model", "model_apply", "embed", "apply_layers", "LayerOutputs",
    "final_norm", "logits_from_features", "local_logits", "gather_logits", "init_caches",
    "init_paged_caches", "paged_supported", "pad_caches", "ForwardAux",
    "chunked_cross_entropy", "seq_parallel",
]


def _is_ssm(cfg) -> bool:
    """Mamba-2: every block an SSD block, no tail."""
    return set(cfg.block_pattern) == {"ssm"} and not cfg.tail_pattern


def _check_supported(cfg) -> None:
    if cfg.vision_patches or cfg.encoder_layers:
        raise NotImplementedError(f"{cfg.name}: encoder and vision inputs come with later slices")
    if _is_ssm(cfg):
        return
    if not paged_supported(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the port runs attention-only GQA and all-ssm block patterns so far "
            f"(got {cfg.block_pattern} / tail {cfg.tail_pattern} / mla={cfg.mla is not None})"
        )


def seq_parallel(cfg, plan, mesh, mode: str, seq_len: int) -> bool:
    """True when the residual stream runs sequence-sharded over the model
    axis: ``cfg.sp_shardmap``, tensor parallelism on, ``train`` or
    ``prefill`` mode and a sequence the axis divides (the reference's
    ``seq_shardable``; its batch condition holds for every rank's rows)."""
    return (bool(cfg.sp_shardmap) and tp.enabled(plan, mesh) and mode in ("train", "prefill")
            and seq_len % plan.model_size == 0)


def init_model(seed: int, cfg, plan: ShardingPlan, *, device=None, mesh=None) -> dict:
    """Seeded parameters drawn directly on ``device`` (the card unless the
    caller asks for the CPU) in ``cfg.dtype``.  Over a ``mesh`` every rank
    draws the same values, leaf by leaf, and keeps its part of each
    (:class:`~repro_torch.parallel.sharding.TreeLayout`: its model-axis
    shard of the expert and tensor-parallel leaves, under ZeRO-3 its data
    shard of them, its stage's repeats and ends over a ``"stage"`` axis),
    so the ranks together hold the one-device draw."""
    cfg.validate()
    _check_supported(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    reps = cfg.pattern_repeats
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    layout = TreeLayout(plan, mesh, cfg)
    d = cfg.d_model
    params: dict = {"embed": L.normal(gen, (cfg.vocab_size, d), dtype, dev, d**-0.5)}
    blocks = {}
    for i, kind in enumerate(cfg.block_pattern):
        name = f"{i}_{kind}"
        if kind == "ssm":
            blocks[name] = layout.shard({
                "norm1": L.init_rms_norm(d, dtype, dev, reps),
                "ssm": ssm_mod.init_ssm(gen, cfg, plan, reps=reps, device=dev),
            }, prefix=f"blocks/{name}")
            continue
        block = {
            "norm1": L.init_rms_norm(d, dtype, dev, reps),
            "attn": L.init_attention(gen, cfg, plan, reps=reps, device=dev),
            "norm2": L.init_rms_norm(d, dtype, dev, reps),
        }
        block = layout.shard(block, prefix=f"blocks/{name}")
        if cfg.is_moe:
            block["moe"] = moe_mod.init_moe(
                gen, cfg, plan, reps=reps, device=dev,
                take=lambda leaf, w, name=name: layout.part(w, f"blocks/{name}/moe/{leaf}"))
        else:
            block["mlp"] = layout.shard(L.init_mlp(gen, cfg, reps=reps, device=dev),
                                        prefix=f"blocks/{name}/mlp")
        blocks[name] = block
    params["blocks"] = blocks
    params["final_norm"] = L.init_rms_norm(d, dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.normal(gen, (d, cfg.vocab_size), dtype, dev, d**-0.5)
    # The ends: a stage that does not hold one drops it; the vocab shards.
    for k in ("embed", "final_norm", "lm_head"):
        if k in params:
            part = layout.part(params[k], k)
            if part is None:
                del params[k]
            else:
                params[k] = part
    return params


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def paged_supported(cfg) -> bool:
    """True when every decode-time cache is a plain GQA attention K/V pair —
    the only layout the page pool holds."""
    return (
        all(k in ("global", "local") for k in cfg.block_pattern)
        and not cfg.tail_pattern
        and cfg.mla is None
        and cfg.family != "audio"
    )


def init_caches(cfg, batch: int, max_len: int, *, device, plan: ShardingPlan | None = None
                ) -> dict:
    """Dense per-slot caches per pattern position: ``{"k","v": [reps, B,
    max_len, Hkv, dh]}`` for attention (under ``plan``'s tensor parallelism
    the rank's kv heads), ``{"state": [reps, B, H, P, N], "conv": [reps, B,
    W-1, inner]}`` f32 for ssm."""
    _check_supported(cfg)
    reps = cfg.pattern_repeats
    out = {}
    for i, kind in enumerate(cfg.block_pattern):
        if kind == "ssm":
            c = ssm_mod.init_ssm_cache(cfg, reps * batch, device=device)
        else:
            c = L.init_attention_cache(cfg, reps * batch, max_len, device=device, plan=plan)
        out[f"{i}_{kind}"] = {k: v.reshape(reps, batch, *v.shape[1:]) for k, v in c.items()}
    return out


def init_paged_caches(cfg, num_pages: int, page_size: int, *, device,
                      plan: ShardingPlan | None = None) -> dict:
    """Paged decode caches: one ``[reps, N, page, Hkv, dh]`` K/V page pool
    per pattern position (under ``plan``'s tensor parallelism the rank's kv
    heads), shared by every serving slot through ONE ``[slots, P]`` page
    table."""
    if not paged_supported(cfg):
        raise ValueError(
            f"paged KV cache requires an attention-only pattern, got "
            f"{cfg.block_pattern} / tail {cfg.tail_pattern} / mla={cfg.mla}"
        )
    reps = cfg.pattern_repeats
    out = {}
    for i, kind in enumerate(cfg.block_pattern):
        c = L.init_paged_attention_cache(cfg, reps * num_pages, page_size, device=device,
                                         plan=plan)
        out[f"{i}_{kind}"] = {k: v.reshape(reps, num_pages, *v.shape[1:]) for k, v in c.items()}
    return out


def pad_caches(caches: dict, target_len: int) -> dict:
    """Grow the sequence axis (dim 2) of every ``k``/``v`` cache leaf to
    ``target_len`` with zeros; other leaves (ssm state, conv) pass through."""
    out = {}
    for name, c in caches.items():
        out[name] = {}
        for key, x in c.items():
            cur = x.shape[2]
            if key in ("k", "v") and cur < target_len:
                grown = x.new_zeros((*x.shape[:2], target_len, *x.shape[3:]))
                grown[:, :, :cur] = x
                x = grown
            out[name][key] = x
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ForwardAux:
    moe_stats: torch.Tensor | None  # [reps, E] expert loads; None without MoE
    balance_loss: torch.Tensor  # 0 without MoE
    z_loss: torch.Tensor
    dropped_fraction: torch.Tensor | None  # [reps] routed choices dropped, first block of each


def _layer(tree: dict, li: int) -> dict:
    """Repeat ``li``'s slice (views) of a stacked ``[reps, ...]`` tree."""
    return {k: _layer(v, li) if isinstance(v, dict) else v[li] for k, v in tree.items()}


def _layers(tree: dict, reps: int) -> list[dict]:
    """Every repeat's slice of a stacked tree, from ONE ``unbind`` per leaf:
    its backward stacks the per-layer gradients into one ``[reps, ...]``
    tensor, where per-layer indexing would allocate a full-size zero
    gradient for every layer."""
    flat = {k: _layers(v, reps) if isinstance(v, dict) else v.unbind(0) for k, v in tree.items()}
    return [{k: v[li] for k, v in flat.items()} for li in range(reps)]


def _dots_policy(ctx, op, *args, **kwargs):
    """``checkpoint_dots_with_no_batch_dims`` for PyTorch's ops: keep a plain
    matrix product (``mm``/``addmm``, and the batch-1 ``bmm`` an einsum
    without batch dims lowers to); recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
        op is aten.bmm.default and args[0].shape[0] == 1
    ):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str):
    """``fn`` under the reference's remat mode (``"none"``: as it is)."""
    if remat == "none":
        return fn
    if remat not in ("full", "dots"):
        raise ValueError(f"unknown remat mode {remat!r}")
    kw = {}
    if remat == "dots":
        from torch.utils.checkpoint import create_selective_checkpoint_contexts

        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(torch.utils.checkpoint.checkpoint, fn, use_reentrant=False, **kw)


def _apply_block(
    kind, p, x, cfg, plan, mode, cache, t, expert_perm, positions,
    wire_perm=None, gate_weights=None, page_table=None, writes=None, mesh=None, per_shard=False,
    sp=False,
):
    if kind == "ssm":
        # norm1 + SSD only (no norm2, no MLP), as the reference.  Every slot
        # advances its state, live or not, as the reference's decode does.
        b, s, d = x.shape
        h = ops.rmsnorm(x.reshape(b * s, d), p["norm1"], eps=cfg.norm_eps).reshape(b, s, d)
        y, sc = ssm_mod.ssm_apply(p["ssm"], h, cfg, mode=mode, cache=cache, t=t)
        return x + y, sc, None
    # Decode-time live mask: dead continuous-batching slots must not write
    # K/V at their stale positions.
    write_mask = None
    if mode == "decode" and gate_weights is not None:
        write_mask = gate_weights[:, 0] > 0
    tree = None if mode == "decode" else L.norm_tree(x, plan, mesh, sp)
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps, tree)
    y, ac = L.attention_apply(
        p["attn"], h, cfg, kind=kind, mode=mode, cache=cache, t=t,
        positions=positions, plan=plan, mesh=mesh, write_mask=write_mask,
        page_table=page_table, writes=writes, sp=sp,
    )
    x = x + y
    h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps, tree)
    if "mlp" in p:
        return x + L.mlp_apply(p["mlp"], h2, cfg, fixed_rows=mode == "decode", plan=plan,
                               mesh=mesh, sp=sp), ac, None
    y, stats = moe_mod.moe_apply(
        p["moe"], h2, cfg, plan, mesh=mesh, expert_perm=expert_perm, wire_perm=wire_perm,
        mode=mode, gate_weights=gate_weights, per_shard=per_shard, sp=sp,
    )
    return x + y, ac, stats


def model_apply(
    params,
    batch: dict,
    cfg,
    plan: ShardingPlan,
    *,
    mesh=None,
    mode: str = "train",
    caches=None,
    t=None,
    expert_perm=None,
    wire_perm=None,
    gate_weights=None,
    page_table=None,
):
    """Run the model.

    ``batch["tokens"]``: ``[B, S]``.  ``expert_perm``: ``[reps, Ev]``
    per-layer expert->slot maps; ``wire_perm``: optional ``[reps, P]``
    device maps; ``gate_weights``: optional ``[B, S]`` telemetry weight (the
    serving engine's live-slot mask); ``page_table``: optional ``[B, P]``
    i32 page ids switching decode onto the paged pools.  Decode writes the
    chunk's K/V into ``caches`` IN PLACE and returns the same dicts.
    ``mesh``: the ``DeviceMesh`` of ``plan``; ``batch`` is then this rank's
    data slice, the dense layers run it tensor-parallel over the model axis
    (or whole, where their sizes do not divide it), and the MoE layers
    shard it over the model axis; under ZeRO-3 each block's data shards
    are gathered before use.  Returns ``(features [B, S, D], aux, caches)``:
    the features replicated over the model axis, or in ``train`` mode of a
    sequence-parallel stream (:func:`seq_parallel`) the rank's ``[B, S /
    P, D]`` slice (:func:`chunked_cross_entropy` takes either).
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    params = fsdp.gather_ends(params, cfg, plan, mesh)
    sp = seq_parallel(cfg, plan, mesh, mode, s)
    x = embed(params, tokens, cfg, plan, mesh)
    if sp:
        x = token_slice(x, plan, mesh)
    reps = cfg.pattern_repeats
    names = [f"{i}_{k}" for i, k in enumerate(cfg.block_pattern)]
    if expert_perm is None and cfg.is_moe:
        ev, _ = virtual_experts(cfg.moe.num_experts, plan.model_size)
        expert_perm = torch.arange(ev, dtype=torch.int32, device=dev).expand(reps, ev)

    writes = None
    if mode == "decode" and not _is_ssm(cfg):
        # One write plan for every layer of the step (see L.DecodeWrites).
        gw = gate_weights
        first = caches[names[0]]["k"]
        writes = L.decode_writes(
            t, b, s, write_mask=None if gw is None else gw[:, 0] > 0,
            cache_len=None if page_table is not None else first.shape[2],
            page_table=page_table,
            page=first.shape[2] if page_table is not None else None, device=dev,
        )

    x, out = apply_layers(
        params["blocks"], x, cfg, plan, mesh=mesh, mode=mode, caches=caches, t=t,
        expert_perm=expert_perm, wire_perm=wire_perm, positions=batch.get("positions"),
        gate_weights=gate_weights, page_table=page_table, writes=writes, sp=sp,
    )
    new_caches = caches
    if mode == "prefill":
        new_caches = {
            n: {k: torch.stack([c[k] for c in cs]) for k in cs[0]}
            for n, cs in out.caches.items()
        }
    x = final_norm(params, x, cfg, None if mode == "decode" else L.norm_tree(x, plan, mesh, sp))
    if sp and mode != "train":
        x = token_gather(x, plan, mesh, s)
    moe = out.loads[0] is not None
    aux = ForwardAux(
        moe_stats=torch.stack(out.loads) if moe else None,
        balance_loss=torch.stack(out.balance).mean(),
        z_loss=torch.stack(out.z).mean(),
        dropped_fraction=torch.stack(out.drops) if moe else None,
    )
    return x, aux, new_caches


def _vocab_sharded(w: torch.Tensor, dim: int, cfg, plan, mesh) -> bool:
    return tp.enabled(plan, mesh) and w.shape[dim] < cfg.vocab_size


def embed(params, tokens: torch.Tensor, cfg, plan=None, mesh=None) -> torch.Tensor:
    """``[B, S]`` tokens -> the scaled ``[B, S, D]`` embeddings in
    ``cfg.dtype`` (the first half of :func:`model_apply`, on its own for a
    pipeline's first stage); with the rank's vocab rows, the vocab-parallel
    lookup (``tp.vocab_embed``); a ZeRO-3 shard of the table is gathered
    first."""
    table = fsdp.gather_ends(params, cfg, plan, mesh)["embed"]
    if _vocab_sharded(table, 0, cfg, plan, mesh):
        x = tp.vocab_embed(table, tokens, plan, mesh).to(getattr(torch, cfg.dtype))
    else:
        x = table[tokens.long()].to(getattr(torch, cfg.dtype))
    return x * (cfg.d_model**0.5)


def final_norm(params, x: torch.Tensor, cfg, tree=None) -> torch.Tensor:
    """The final norm of the block stack's output: the features the LM head
    reads (:func:`logits_from_features`, :func:`chunked_cross_entropy`),
    on its own for a pipeline's last stage; ``tree``: ``layers.norm_tree``'s
    (train and prefill mode)."""
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps, tree)


@dataclasses.dataclass
class LayerOutputs:
    """Per-repeat results of :func:`apply_layers`, one entry a repeat."""

    balance: list  # [] scalars: the repeat's mean balance loss over its MoE blocks
    z: list
    loads: list  # [E] loads of its first MoE block, or None
    drops: list
    caches: dict  # prefill: name -> one cache dict a repeat


def apply_layers(
    blocks: dict, x, cfg, plan: ShardingPlan, *, mesh=None, mode: str = "train", caches=None,
    t=None, expert_perm=None, wire_perm=None, positions=None, gate_weights=None,
    page_table=None, writes=None, per_shard: bool = False, sp: bool = False,
):
    """The block loop of :func:`model_apply` over the repeats that
    ``blocks`` holds (its leaves' leading dim): the whole stack, or a
    pipeline stage's contiguous slice of it.  ``expert_perm`` /
    ``wire_perm`` (and ``caches``) hold the same repeats' rows.
    ``per_shard``: the MoE layers run on this rank's rows even over a
    data-only mesh (see ``moe.moe_apply``), as a pipeline stage does.
    ``sp``: ``x`` is the rank's slice of a sequence-parallel stream
    (:func:`seq_parallel`).  Under ZeRO-3 each repeat's data shards are
    gathered inside its group (again in a remat recompute); with
    ``cfg.fsdp_prefetch`` in ``train`` mode repeat ``li + 1``'s FFN shards
    are issued to the comm worker before repeat ``li`` runs.
    Returns ``(x, LayerOutputs)``."""
    _check_supported(cfg)
    names = [f"{i}_{k}" for i, k in enumerate(cfg.block_pattern)]
    reps = blocks[names[0]]["norm1"].shape[0]
    block_params = {n: _layers(blocks[n], reps) for n in names}
    out = LayerOutputs([], [], [], [], {n: [] for n in names})
    dev = x.device
    zero3 = fsdp.active(plan, mesh)
    prefetch = zero3 and cfg.fsdp_prefetch and mode == "train"
    # repeat -> {leaf path: prefetch handle}; a group's first run takes its
    # handles, a remat recompute finds none and gathers on demand.
    pending: dict = {}

    def group(x, li):
        """One repeat of the block pattern.  Returns its output and stats
        (and its prefill caches): under remat the backward runs it again, so
        it touches nothing outside."""
        stats_list, ncs = [], []
        handles = pending.pop(li, {})
        for i, kind in enumerate(cfg.block_pattern):
            cache_i = _layer(caches[names[i]], li) if caches is not None else None
            bp = block_params[names[i]][li]
            if zero3:
                bp = fsdp.gather_block(bp, f"blocks/{names[i]}", cfg, plan, mesh, handles)
            x, nc, st = _apply_block(
                kind, bp, x, cfg, plan, mode,
                cache_i, t, None if expert_perm is None else expert_perm[li], positions,
                wire_perm=None if wire_perm is None else wire_perm[li],
                gate_weights=gate_weights, page_table=page_table, writes=writes, mesh=mesh,
                per_shard=per_shard, sp=sp,
            )
            ncs.append(nc)
            if st is not None:
                stats_list.append(st)
        if not stats_list:  # no MoE block: zero losses, no loads
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            return x, zero, zero, None, None, ncs
        bal = sum(st.balance_loss for st in stats_list) / len(stats_list)
        zl = sum(st.z_loss for st in stats_list) / len(stats_list)
        return x, bal, zl, stats_list[0].expert_load, stats_list[0].dropped_fraction, ncs

    run = group
    if mode == "train" and torch.is_grad_enabled():
        run = _remat(lambda x, li: group(x, li)[:5], cfg.remat)
    for li in range(reps):
        if prefetch:
            for lj in ((0, 1) if li == 0 else (li + 1,)):
                if lj < reps:
                    pending[lj] = fsdp.prefetch_ffn(blocks, lj, cfg, plan, mesh)
        x, b_, z_, load, drop, *rest = run(x, li)
        if mode == "prefill":
            for n, nc in zip(names, rest[0]):
                out.caches[n].append(nc)
        out.balance.append(b_)
        out.z.append(z_)
        out.loads.append(load)
        out.drops.append(drop)
    return x, out


def _head(params, cfg):
    """The LM head as ``(weight, its vocab dim)``."""
    return (params["embed"], 0) if cfg.tie_embeddings else (params["lm_head"], 1)


def _logits(params, x, cfg, plan=None, mesh=None, reduce: bool = True):
    """``x`` through the head the rank holds as a column product
    (``tp.column_parallel``: the whole vocab, or with ``plan`` and ``mesh``
    the rank's vocab slice; ``reduce=False``: ``x`` is ``tp.seq_gather``'s),
    gemma2's final softcap applied."""
    w, dim = _head(params, cfg)
    out = tp.column_parallel(x.reshape(-1, x.shape[-1]), [w.t() if dim == 0 else w],
                             plan, mesh, reduce=reduce)[0].reshape(*x.shape[:-1], -1)
    if cfg.final_softcap is not None:
        out = cfg.final_softcap * torch.tanh(out / cfg.final_softcap)
    return out


def _head_sharded(params, cfg, plan, mesh) -> bool:
    w, dim = _head(params, cfg)
    return _vocab_sharded(w, dim, cfg, plan, mesh)


def local_logits(params, x, cfg, plan=None, mesh=None):
    """The rank's ``[B, S, V / P]`` vocab slice of the logits under tensor
    parallelism (``tp.column_parallel``), else ``[B, S, V]``."""
    params = fsdp.gather_ends(params, cfg, plan, mesh)
    if _head_sharded(params, cfg, plan, mesh):
        return _logits(params, x, cfg, plan, mesh)
    return _logits(params, x, cfg)


def gather_logits(params, logits, cfg, plan=None, mesh=None):
    """:func:`local_logits`' slices all-gathered to the whole vocabulary
    (the identity without tensor parallelism)."""
    if _head_sharded(params, cfg, plan, mesh):
        return tp.gather_vocab(logits, plan, mesh)
    return logits


def logits_from_features(params, x, cfg, plan=None, mesh=None):
    """``[B, S, V]`` logits on every rank (vocab slices all-gathered under
    tensor parallelism)."""
    return gather_logits(params, local_logits(params, x, cfg, plan, mesh), cfg, plan, mesh)


def chunked_cross_entropy(params, features, labels, cfg, *, num_chunks: int = 8, plan=None,
                          mesh=None) -> torch.Tensor:
    """Mean CE computed in sequence chunks so ``[B, S, V]`` logits never
    fully materialize: each chunk's logits are recomputed in the backward
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``).
    Each token's loss is ``tp.vocab_cross_entropy`` (with the rank's vocab
    slice of the head, the vocab-parallel loss; one device and the ranks
    sum the same terms in the same order).  ``features`` narrower than
    ``labels`` along the sequence are a sequence-parallel rank's slice: the
    sequence is gathered first (``tp.seq_gather`` for a vocab-parallel
    head, whose input gradient is then summed over the model axis as the
    replicated stream's is; a copy for a whole head, which every rank runs
    alike)."""
    params = fsdp.gather_ends(params, cfg, plan, mesh)
    sharded = _head_sharded(params, cfg, plan, mesh)
    tpp = (plan, mesh) if sharded else (None, None)
    reduce = True
    if features.shape[1] != labels.shape[1]:
        if sharded:
            features, reduce = tp.seq_gather(features, plan, mesh), False
        else:
            features = token_gather(features, plan, mesh, labels.shape[1])
    b, s, d = features.shape
    while s % num_chunks:
        num_chunks -= 1
    step = s // num_chunks

    def chunk(f, lab):
        logits = _logits(params, f, cfg, *tpp, reduce=reduce).float()
        return torch.sum(tp.vocab_cross_entropy(logits, lab, *tpp))

    total = torch.zeros((), dtype=torch.float32, device=features.device)
    for c in range(num_chunks):
        f = features[:, c * step:(c + 1) * step]
        lab = labels[:, c * step:(c + 1) * step]
        if torch.is_grad_enabled():
            total = total + torch.utils.checkpoint.checkpoint(chunk, f, lab, use_reentrant=False)
        else:
            total = total + chunk(f, lab)
    return total / (b * s)
