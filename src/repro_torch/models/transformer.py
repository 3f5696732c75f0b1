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
from repro_torch.parallel.sharding import ShardingPlan, stage_layers, virtual_experts

__all__ = [
    "init_model", "stage_params", "model_apply", "embed", "apply_layers", "LayerOutputs",
    "final_norm", "logits_from_features", "init_caches",
    "init_paged_caches", "paged_supported", "pad_caches", "ForwardAux",
    "chunked_cross_entropy",
]


def _is_ssm(cfg) -> bool:
    """Mamba-2: every block an SSD block, no tail."""
    return set(cfg.block_pattern) == {"ssm"} and not cfg.tail_pattern


def _check_supported(cfg) -> None:
    if cfg.sp_shardmap:
        raise NotImplementedError(
            f"{cfg.name}: sp_shardmap=True (the sequence-parallel MLP and output projection) "
            f"{moe_mod._LATER}")
    if cfg.vision_patches or cfg.encoder_layers:
        raise NotImplementedError(f"{cfg.name}: encoder and vision inputs come with later slices")
    if _is_ssm(cfg):
        return
    if not paged_supported(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the port runs attention-only GQA and all-ssm block patterns so far "
            f"(got {cfg.block_pattern} / tail {cfg.tail_pattern} / mla={cfg.mla is not None})"
        )


def init_model(seed: int, cfg, plan: ShardingPlan, *, device=None, mesh=None) -> dict:
    """Seeded parameters drawn directly on ``device`` (the card unless the
    caller asks for the CPU) in ``cfg.dtype``.  Over a ``mesh`` every rank
    draws the same values and keeps its model-axis shard of the expert
    leaves, so the ranks together hold the one-device draw.  Over a mesh
    with a ``"stage"`` axis a rank also keeps only its stage's repeats
    (:func:`stage_params`): the generator is consumed in the same order."""
    cfg.validate()
    _check_supported(cfg)
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    reps = cfg.pattern_repeats
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    d = cfg.d_model
    params: dict = {"embed": L.normal(gen, (cfg.vocab_size, d), dtype, dev, d**-0.5)}
    blocks = {}
    for i, kind in enumerate(cfg.block_pattern):
        if kind == "ssm":
            blocks[f"{i}_{kind}"] = {
                "norm1": L.init_rms_norm(d, dtype, dev, reps),
                "ssm": ssm_mod.init_ssm(gen, cfg, plan, reps=reps, device=dev),
            }
            continue
        block = {
            "norm1": L.init_rms_norm(d, dtype, dev, reps),
            "attn": L.init_attention(gen, cfg, plan, reps=reps, device=dev),
            "norm2": L.init_rms_norm(d, dtype, dev, reps),
        }
        if cfg.is_moe:
            block["moe"] = moe_mod.init_moe(gen, cfg, plan, reps=reps, device=dev,
                                            model_index=_model_index(mesh, plan))
        else:
            block["mlp"] = L.init_mlp(gen, cfg, reps=reps, device=dev)
        blocks[f"{i}_{kind}"] = block
    params["blocks"] = blocks
    params["final_norm"] = L.init_rms_norm(d, dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.normal(gen, (d, cfg.vocab_size), dtype, dev, d**-0.5)
    s, n, lo, hi = stage_layers(mesh, reps)
    return params if n == 1 else stage_params(params, cfg, s, n, lo, hi, clone=True)


def stage_params(params: dict, cfg, s: int, n: int, lo: int, hi: int, *, clone=False) -> dict:
    """Stage ``s`` of ``n``'s part of a whole parameter tree: the block
    repeats ``[lo, hi)`` (in the canonical ``[repeats, ...]`` layout), the
    embedding on the first stage, the final norm and LM head on the last
    (both ends on a stage that is both).  A tied head is the embedding, so
    the last stage holds the embedding too (``train.pp_step`` sums its two
    stages' gradients, which keeps the copies equal).  Works on tensors
    (``clone`` copies the slices so the whole leaves can go) and on numpy
    trees alike."""

    def rows(node):
        if isinstance(node, dict):
            return {k: rows(v) for k, v in node.items()}
        part = node[lo:hi]
        return part.clone() if clone else part

    out = {}
    if s == 0 or (s == n - 1 and cfg.tie_embeddings):
        out["embed"] = params["embed"]
    out["blocks"] = rows(params["blocks"])
    if s == n - 1:
        out["final_norm"] = params["final_norm"]
        if "lm_head" in params:
            out["lm_head"] = params["lm_head"]
    return out


def _model_index(mesh, plan: ShardingPlan) -> int:
    if mesh is None or plan.model_axis is None:
        return 0
    return int(mesh.get_local_rank(plan.model_axis))


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


def init_caches(cfg, batch: int, max_len: int, *, device) -> dict:
    """Dense per-slot caches per pattern position: ``{"k","v": [reps, B,
    max_len, Hkv, dh]}`` for attention, ``{"state": [reps, B, H, P, N],
    "conv": [reps, B, W-1, inner]}`` f32 for ssm."""
    _check_supported(cfg)
    reps = cfg.pattern_repeats
    out = {}
    for i, kind in enumerate(cfg.block_pattern):
        if kind == "ssm":
            c = ssm_mod.init_ssm_cache(cfg, reps * batch, device=device)
        else:
            c = L.init_attention_cache(cfg, reps * batch, max_len, device=device)
        out[f"{i}_{kind}"] = {k: v.reshape(reps, batch, *v.shape[1:]) for k, v in c.items()}
    return out


def init_paged_caches(cfg, num_pages: int, page_size: int, *, device) -> dict:
    """Paged decode caches: one ``[reps, N, page, Hkv, dh]`` K/V page pool
    per pattern position, shared by every serving slot through ONE
    ``[slots, P]`` page table."""
    if not paged_supported(cfg):
        raise ValueError(
            f"paged KV cache requires an attention-only pattern, got "
            f"{cfg.block_pattern} / tail {cfg.tail_pattern} / mla={cfg.mla}"
        )
    reps = cfg.pattern_repeats
    out = {}
    for i, kind in enumerate(cfg.block_pattern):
        c = L.init_paged_attention_cache(cfg, reps * num_pages, page_size, device=device)
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
    h = L.rms_norm(x, p["norm1"], cfg.norm_eps)
    y, ac = L.attention_apply(
        p["attn"], h, cfg, kind=kind, mode=mode, cache=cache, t=t,
        positions=positions, plan=plan, write_mask=write_mask,
        page_table=page_table, writes=writes,
    )
    x = x + y
    h2 = L.rms_norm(x, p["norm2"], cfg.norm_eps)
    if "mlp" in p:
        return x + L.mlp_apply(p["mlp"], h2, cfg, fixed_rows=mode == "decode"), ac, None
    y, stats = moe_mod.moe_apply(
        p["moe"], h2, cfg, plan, mesh=mesh, expert_perm=expert_perm, wire_perm=wire_perm,
        mode=mode, gate_weights=gate_weights, per_shard=per_shard,
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
    data slice, every non-MoE layer runs on it whole, and the MoE layers
    shard it over the model axis.  Returns ``(features [B, S, D], aux,
    caches)``.
    """
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = tokens.device
    x = embed(params, tokens, cfg)
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
        gate_weights=gate_weights, page_table=page_table, writes=writes,
    )
    new_caches = caches
    if mode == "prefill":
        new_caches = {
            n: {k: torch.stack([c[k] for c in cs]) for k in cs[0]}
            for n, cs in out.caches.items()
        }
    x = final_norm(params, x, cfg)
    moe = out.loads[0] is not None
    aux = ForwardAux(
        moe_stats=torch.stack(out.loads) if moe else None,
        balance_loss=torch.stack(out.balance).mean(),
        z_loss=torch.stack(out.z).mean(),
        dropped_fraction=torch.stack(out.drops) if moe else None,
    )
    return x, aux, new_caches


def embed(params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """``[B, S]`` tokens -> the scaled ``[B, S, D]`` embeddings in
    ``cfg.dtype`` (the first half of :func:`model_apply`, on its own for a
    pipeline's first stage)."""
    x = params["embed"][tokens.long()].to(getattr(torch, cfg.dtype))
    return x * (cfg.d_model**0.5)


def final_norm(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """The final norm of the block stack's output: the features the LM head
    reads (:func:`logits_from_features`, :func:`chunked_cross_entropy`),
    on its own for a pipeline's last stage."""
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


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
    page_table=None, writes=None, per_shard: bool = False,
):
    """The block loop of :func:`model_apply` over the repeats that
    ``blocks`` holds (its leaves' leading dim): the whole stack, or a
    pipeline stage's contiguous slice of it.  ``expert_perm`` /
    ``wire_perm`` (and ``caches``) hold the same repeats' rows.
    ``per_shard``: the MoE layers run on this rank's rows even over a
    data-only mesh (see ``moe.moe_apply``), as a pipeline stage does.
    Returns ``(x, LayerOutputs)``."""
    _check_supported(cfg)
    names = [f"{i}_{k}" for i, k in enumerate(cfg.block_pattern)]
    reps = blocks[names[0]]["norm1"].shape[0]
    block_params = {n: _layers(blocks[n], reps) for n in names}
    out = LayerOutputs([], [], [], [], {n: [] for n in names})
    dev = x.device

    def group(x, li):
        """One repeat of the block pattern.  Returns its output and stats
        (and its prefill caches): under remat the backward runs it again, so
        it touches nothing outside."""
        stats_list, ncs = [], []
        for i, kind in enumerate(cfg.block_pattern):
            cache_i = _layer(caches[names[i]], li) if caches is not None else None
            x, nc, st = _apply_block(
                kind, block_params[names[i]][li], x, cfg, plan, mode,
                cache_i, t, None if expert_perm is None else expert_perm[li], positions,
                wire_perm=None if wire_perm is None else wire_perm[li],
                gate_weights=gate_weights, page_table=page_table, writes=writes, mesh=mesh,
                per_shard=per_shard,
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
        x, b_, z_, load, drop, *rest = run(x, li)
        if mode == "prefill":
            for n, nc in zip(names, rest[0]):
                out.caches[n].append(nc)
        out.balance.append(b_)
        out.z.append(z_)
        out.loads.append(load)
        out.drops.append(drop)
    return x, out


def logits_from_features(params, x, cfg):
    if cfg.tie_embeddings:
        out = torch.einsum("bsd,vd->bsv", x, params["embed"])
    else:
        out = torch.einsum("bsd,dv->bsv", x, params["lm_head"])
    if cfg.final_softcap is not None:
        out = cfg.final_softcap * torch.tanh(out / cfg.final_softcap)
    return out


def chunked_cross_entropy(params, features, labels, cfg, *, num_chunks: int = 8) -> torch.Tensor:
    """Mean CE computed in sequence chunks so ``[B, S, V]`` logits never
    fully materialize: each chunk's logits are recomputed in the backward
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``)."""
    b, s, d = features.shape
    while s % num_chunks:
        num_chunks -= 1
    step = s // num_chunks

    def chunk(f, lab):
        lg = logits_from_features(params, f, cfg).float()
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, lab.long()[..., None])[..., 0]
        return torch.sum(lse - gold)

    total = torch.zeros((), dtype=torch.float32, device=features.device)
    for c in range(num_chunks):
        f = features[:, c * step:(c + 1) * step]
        lab = labels[:, c * step:(c + 1) * step]
        if torch.is_grad_enabled():
            total = total + torch.utils.checkpoint.checkpoint(chunk, f, lab, use_reentrant=False)
        else:
            total = total + chunk(f, lab)
    return total / (b * s)
