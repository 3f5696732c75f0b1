"""Mixture-of-Experts layer: the einsum (GShard) backend, the dense-decode
path and the mixnet backend over the shared routing core.

Port of :mod:`repro.models.moe`.  Expert weights are stacked ``[Ev, d, f]``
per layer.  Every expert product runs batched over the expert dim
(``torch.bmm`` with the expert as the batch), never as one
``[T, D] x [D, E*F]`` product whose tiling could depend on an expert's
column position: with the combine summing each token's choices in GATE
order, an expert's output then does not depend on the slot it occupies, so
runtime re-placement (``expert_perm``) leaves generated tokens
bit-identical.

The ``mixnet`` backend (the paper's data plane, §5.3) runs on one device
(P = 1): send-buffer gather (``ops.moe_dispatch``), the CommRuntime
all-to-all (the identity at P = 1), the pack into the dropless block layout,
three grouped GEMMs over it (``ops.grouped_matmul(..., block_experts=)``),
the unpack and the weighted combine (``ops.moe_combine``).  Each gather is
given its inverse map from the dispatch plan, which is what its backward
kernel gathers through on the card.  P > 1 and the chunked overlap
pipeline (``overlap_chunks > 1``) come with the multi-device slice.

Speculative decoding's draft passes (``MoEConfig.draft_mode``, picked by
:func:`resolve_draft_mode` and :func:`draft_config`): ``topk1`` narrows the
routed fan-out to each token's best expert, ``shared_only`` skips the routed
experts and keeps the shared lane.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.commruntime import AllToAll, CommSpec
from repro_torch.kernels import ops
from repro_torch.models import routing
from repro_torch.models.layers import decode_rows, normal
from repro_torch.models.routing import MoEStats, router_losses
from repro_torch.parallel.sharding import ShardingPlan, virtual_experts

__all__ = [
    "init_moe", "moe_apply", "MoEStats", "router_losses", "chunk_count", "resolve_draft_mode",
    "draft_config",
]


def init_moe(gen, cfg, plan: ShardingPlan, *, reps: int, device) -> dict:
    """Stacked ``[reps, ...]`` router and expert weights."""
    e = cfg.moe
    d = cfg.d_model
    dtype = getattr(torch, cfg.dtype)
    ev, r = virtual_experts(e.num_experts, plan.model_size)
    if e.d_ff % r != 0:
        raise ValueError(f"expert d_ff {e.d_ff} not divisible by replication {r}")
    f = e.d_ff // r
    params = {
        "router": normal(gen, (reps, d, e.num_experts), torch.float32, device, d**-0.5),
        "w_in": normal(gen, (reps, ev, d, f), dtype, device, d**-0.5),
        "w_gate": normal(gen, (reps, ev, d, f), dtype, device, d**-0.5),
        "w_out": normal(gen, (reps, ev, f, d), dtype, device, e.d_ff**-0.5),
    }
    if e.num_shared_experts:
        f_sh = e.d_ff * e.num_shared_experts
        params["shared"] = {
            "w_in": normal(gen, (reps, d, f_sh), dtype, device, d**-0.5),
            "w_gate": normal(gen, (reps, d, f_sh), dtype, device, d**-0.5),
            "w_out": normal(gen, (reps, f_sh, d), dtype, device, f_sh**-0.5),
        }
    return params


def _actfn(act: str):
    # jax.nn.gelu defaults to the tanh approximation.
    if act in ("silu", "swiglu"):
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")


def _ffn_rows(xe, w_in, w_gate, w_out, act):
    """``xe [E, M, D]`` through each expert's gated FFN, batched over E."""
    h = torch.bmm(xe, w_in)
    gt = torch.bmm(xe, w_gate)
    return torch.bmm(_actfn(act)(gt) * h, w_out)


def _expert_ffn(x, w_in, w_gate, w_out, act, fixed_rows=False):
    """x ``[G, E, C, D]`` through each expert's gated FFN, batched over E;
    ``fixed_rows``: in blocks of ``layers.DECODE_ROWS`` rows an expert
    (decode mode: row-invariant)."""
    g, e, c, d = x.shape
    xe = x.transpose(0, 1).reshape(e, g * c, d)
    if fixed_rows:
        y = decode_rows(lambda r: _ffn_rows(r, w_in, w_gate, w_out, act), xe, dim=1)
    else:
        y = _ffn_rows(xe, w_in, w_gate, w_out, act)  # [E, G*C, D]
    return y.reshape(e, g, c, d).transpose(0, 1)


def _moe_einsum(params, x, cfg, plan: ShardingPlan, expert_perm=None, fixed_rows=False):
    """The GShard einsum backend; ``fixed_rows`` (decode mode) runs the
    router, the per-expert products and the combine on fixed row blocks
    (``layers.decode_rows``), so a token's output does not depend on how
    many tokens share the call."""
    e = cfg.moe
    b, s, d = x.shape
    ev, r = virtual_experts(e.num_experts, plan.model_size)
    sc = e.top_k * r
    g = plan.model_size if (plan.model_size > 1 and s % plan.model_size == 0) else 1
    t = s // g
    xg = x.reshape(b * g, t, d)
    if fixed_rows:
        logits = decode_rows(lambda r: r @ params["router"], xg.reshape(-1, d).float()).reshape(
            b * g, t, -1)
    else:
        logits = torch.einsum("gtd,de->gte", xg.float(), params["router"])
    info = routing.compute_routing(
        logits.reshape(-1, e.num_experts),
        top_k=e.top_k, num_virtual=ev, replication=r, expert_perm=expert_perm,
    )
    vdest = info.vdest.reshape(b * g, t * sc)
    wfull = info.wfull.reshape(b * g, t, sc)
    cap = t if e.dispatch == "dropless" else routing.capacity(
        t, e.top_k, e.num_experts, e.capacity_factor
    )
    rank = torch.stack([routing.bucket_ranks(dv, ev)[0] for dv in vdest])
    vdest = vdest.reshape(b * g, t, sc)
    rank = rank.reshape(b * g, t, sc)
    keep = rank < cap
    dispatch, _ = routing.dense_dispatch_masks(vdest, rank, keep, wfull, ev, cap)
    dropped = 1.0 - keep.sum() / (b * g * t * sc)

    xe = torch.einsum("gtec,gtd->gecd", dispatch.to(x.dtype), xg)  # [G, Ev, C, D]
    ye = _expert_ffn(xe, params["w_in"], params["w_gate"], params["w_out"], cfg.act, fixed_rows)
    # Combine in GATE order: gather each choice's expert row through its
    # (slot, rank) address and contract over the choices.  The JAX backend's
    # [.., Ev, C] combine einsum sums over slots, whose association would
    # move with a re-placement; the terms and weights here are the same.
    gi = torch.arange(b * g, device=x.device)[:, None, None]
    ysel = ye[gi, vdest.long(), rank.clamp(0, cap - 1).long()]  # [G, T, S, D]
    w = torch.where(keep, wfull, torch.zeros_like(wfull)).to(x.dtype)
    out = _combine(w.reshape(b * s, -1), ysel.reshape(b * s, -1, d), fixed_rows).reshape(b, s, d)

    balance, z = router_losses(logits, info.idx, e.num_experts)
    load = routing.expert_load(info.idx, e.num_experts)
    return out, MoEStats(load, balance, z, dropped.float())


def _combine(w, ysel, fixed_rows):
    """``out[t] = sum_s w[t, s] * ysel[t, s]`` for ``w [T, S]`` and ``ysel
    [T, S, D]``, on fixed row blocks when ``fixed_rows``."""
    f = lambda wr, yr: torch.einsum("ts,tsd->td", wr, yr)  # noqa: E731
    return decode_rows(f, w, ysel) if fixed_rows else f(w, ysel)


def _moe_dense_decode(params, x, cfg, plan: ShardingPlan, expert_perm=None,
                      gate_weights=None):
    """Decode-time MoE: ALL experts computed on the handful of live tokens,
    each choice's expert output gathered by ``vdest`` and summed in gate
    order, so decode tokens are bit-identical under any ``expert_perm``;
    every product on fixed row blocks (``layers.decode_rows``)."""
    e = cfg.moe
    b, s, d = x.shape
    ev, r = virtual_experts(e.num_experts, plan.model_size)
    xt = x.reshape(b * s, d)
    logits = decode_rows(lambda rr: rr @ params["router"], xt.float())
    info = routing.compute_routing(
        logits, top_k=e.top_k, num_virtual=ev, replication=r, expert_perm=expert_perm,
    )
    xe = xt.unsqueeze(0).expand(ev, -1, -1)
    y = decode_rows(
        lambda rr: _ffn_rows(rr, params["w_in"], params["w_gate"], params["w_out"], cfg.act), xe,
        dim=1,
    )  # [Ev, T, D]
    tok = torch.arange(b * s, device=x.device)[:, None]
    ysel = y[info.vdest.long(), tok]  # [T, S, D]
    out = _combine(info.wfull.to(y.dtype), ysel, True).reshape(b, s, d)

    balance, z = router_losses(logits, info.idx, e.num_experts)
    load = routing.expert_load(info.idx, e.num_experts, weights=gate_weights)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return out, MoEStats(load, balance, z, zero)


def chunk_count(total: int, requested: int) -> int:
    """Largest divisor of ``total`` that is <= ``requested`` (the chunked
    overlap pipeline's chunk count, ``repro.core.overlap.chunk_count``)."""
    c = max(min(int(requested), int(total)), 1)
    while total % c:
        c -= 1
    return c


def _moe_mixnet_local(
    params_local, xl, cfg, plan: ShardingPlan, expert_perm, axis_names=(),
    wire_perm=None, token_axes=(), gate_weights=None,
):
    """Per-device MoE body, serial path (``overlap_chunks`` resolving to one
    chunk).  Returns ``(out [B, S, D], load [E], balance, z, drop)``."""
    if wire_perm is not None:
        raise NotImplementedError("wire re-addressing needs a model axis: the multi-device slice")
    e = cfg.moe
    ev, r = virtual_experts(e.num_experts, plan.model_size)
    p_axis = max(plan.model_size, 1)
    ev_local = ev // p_axis
    dropless = e.dispatch == "dropless"
    router, w_in, w_gate, w_out = params_local
    bl, sl, d = xl.shape
    tl = bl * sl
    sc = e.top_k * r
    n = tl * sc
    xt = xl.reshape(tl, d)
    if gate_weights is not None:
        gate_weights = gate_weights.reshape(tl)
    act = _actfn(cfg.act)

    logits = xt.float() @ router
    info = routing.compute_routing(
        logits, top_k=e.top_k, num_virtual=ev, replication=r, expert_perm=expert_perm,
    )
    flat_dev = (info.vdest // ev_local).reshape(n)
    local_e = (info.vdest % ev_local).reshape(n)

    rank1, _ = routing.bucket_ranks(flat_dev, p_axis)
    cp = n if dropless else routing.capacity(tl, sc, p_axis, e.capacity_factor)
    keep1 = None if dropless else rank1 < cp

    a2a = AllToAll(CommSpec.from_plan(plan, group_size=e.a2a_group))
    if chunk_count(tl, e.overlap_chunks) > 1:
        raise NotImplementedError(
            "the chunked overlap pipeline (overlap_chunks > 1) comes with the multi-device slice"
        )

    def expert_ffn_block(rx, re):
        """Received rows -> per-expert pack -> grouped GEMMs -> unpacked
        rows aligned with the receive layout, and the kept count."""
        valid = re >= 0
        rank2, counts2 = routing.bucket_ranks(re, ev_local, valid=valid)
        if dropless:
            plan2 = routing.dropless_plan(re, rank2, counts2, valid, ev_local, e.dispatch_block)
            packed = ops.moe_dispatch(rx, plan2.src, inverse=plan2.slot)
            packed = packed.reshape(-1, e.dispatch_block, d)
            be = plan2.block_experts
            h = ops.grouped_matmul(packed, w_in, block_experts=be)
            gt = ops.grouped_matmul(packed, w_gate, block_experts=be)
            ye = ops.grouped_matmul(act(gt) * h, w_out, block_experts=be)
        else:
            c2 = routing.capacity(re.shape[0], 1, ev_local, e.capacity_factor)
            plan2 = routing.capacity_plan(re, rank2, valid, ev_local, c2)
            packed = ops.moe_dispatch(rx, plan2.src, inverse=plan2.slot).reshape(ev_local, c2, d)
            h = ops.grouped_matmul(packed, w_in)
            gt = ops.grouped_matmul(packed, w_gate)
            ye = ops.grouped_matmul(act(gt) * h, w_out)
        back = ops.moe_dispatch(ye.reshape(plan2.num_rows, d), plan2.slot, inverse=plan2.src)
        return back, plan2.kept

    # Serial path: one send buffer, one a2a pair.  The send gather is
    # many-to-one (a token feeds its top-k choices): its backward is the
    # combine with unit weights through plan1.slot.
    plan1 = routing.capacity_plan(flat_dev, rank1, keep1, p_axis, cp)
    src_tok = torch.where(plan1.src >= 0, plan1.src // sc, torch.full_like(plan1.src, -1))
    send_x = ops.moe_dispatch(xt, src_tok, inverse=plan1.slot.reshape(tl, sc))
    send_x = send_x.reshape(p_axis, cp, d)
    send_e = torch.where(
        plan1.src >= 0, local_e[plan1.src.clamp(0, n - 1).long()], torch.full_like(plan1.src, -1)
    ).reshape(p_axis, cp).to(torch.int32)
    # At P = 1 the fused and the separate transfers (``a2a_fuse``) are both
    # the identity; they differ only in what crosses a wire.
    recv_x, recv_e = a2a.fused(send_x, send_e)
    back, kept = expert_ffn_block(recv_x.reshape(p_axis * cp, d), recv_e.reshape(p_axis * cp))
    ret = a2a(back.reshape(p_axis, cp, d))
    out = ops.moe_combine(
        ret.reshape(p_axis * cp, d), plan1.slot.reshape(tl, sc), info.wfull, inverse=plan1.src,
        out_dtype=xl.dtype,
    )
    out = out.reshape(bl, sl, d)

    balance, z = router_losses(logits, info.idx, e.num_experts)
    load = routing.expert_load(info.idx, e.num_experts, weights=gate_weights)
    # Drop telemetry folds both stages: `kept` counts choices that won a
    # send slot AND an expert slot (exactly 0 dropped in dropless mode).
    drop = 1.0 - kept.float() / float(n)
    return out, load, balance, z, drop


def _moe_mixnet(params, x, cfg, plan: ShardingPlan, mesh, expert_perm, wire_perm=None,
                gate_weights=None):
    """``expert_perm``: THIS layer's ``[E_virtual]`` expert->slot map;
    ``wire_perm``: its optional ``[P]`` device map; ``gate_weights``: an
    optional ``[B, S]`` per-token telemetry weight."""
    if mesh is not None and plan.model_size > 1:
        raise NotImplementedError("the mixnet backend over a mesh comes with the multi-device slice")
    out, load, balance, z, drop = _moe_mixnet_local(
        (params["router"], params["w_in"], params["w_gate"], params["w_out"]), x, cfg, plan,
        expert_perm, wire_perm=wire_perm, gate_weights=gate_weights,
    )
    return out, MoEStats(load, balance, z, drop)


def moe_apply(
    params,
    x: torch.Tensor,
    cfg,
    plan: ShardingPlan,
    *,
    mesh=None,
    expert_perm=None,
    wire_perm=None,
    backend: str | None = None,
    mode: str | None = None,
    gate_weights: torch.Tensor | None = None,
):
    """``expert_perm``: this layer's ``[Ev]`` expert->slot map;
    ``wire_perm``: optional ``[P]`` device map, composed into the slot
    addressing (the dense backends hit the physically resident weights);
    ``gate_weights``: optional ``[B, S]`` telemetry weight per token."""
    e = cfg.moe
    if e.draft_mode == "topk1" and e.top_k > 1:
        # Speculative draft: narrow the routed fan-out to the gate's single
        # best expert by rewriting the config; every backend below runs as is.
        e = dataclasses.replace(
            e, top_k=routing.effective_top_k(e.top_k, e.draft_mode), draft_mode="off"
        )
        cfg = dataclasses.replace(cfg, moe=e)
    backend = backend or e.backend
    if backend != "einsum" and (x.shape[1] == 1 or mode == "decode"):
        # Decode: the weight-stationary dense path, unless the config pins
        # the mixnet backend's sparse dispatch at decode.
        if not (backend == "mixnet" and e.decode_backend == "sparse"):
            backend = "dense_decode"
    ev, _ = virtual_experts(e.num_experts, plan.model_size)
    perm = routing.resolve_perm(expert_perm, ev, device=x.device)
    if wire_perm is not None and backend != "mixnet":
        # Logical slot s lives at physical slot wire[s // epd] * epd + s % epd.
        epd = ev // max(plan.model_size, 1)
        wire = torch.as_tensor(wire_perm, dtype=torch.int32, device=x.device)
        perm = wire[(perm // epd).long()] * epd + perm % epd
        wire_perm = None
    if e.draft_mode == "shared_only":
        # Speculative draft with only the always-on lane: no routed experts,
        # and a zero load so draft passes never reach the control plane.
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        out = torch.zeros_like(x)
        stats = MoEStats(
            torch.zeros((e.num_experts,), dtype=torch.float32, device=x.device), zero, zero, zero
        )
    elif backend == "dense_decode":
        out, stats = _moe_dense_decode(
            params, x, cfg, plan, expert_perm=perm, gate_weights=gate_weights
        )
    elif backend == "mixnet":
        out, stats = _moe_mixnet(
            params, x, cfg, plan, mesh, perm, wire_perm=wire_perm, gate_weights=gate_weights,
        )
    elif backend == "einsum":
        out, stats = _moe_einsum(params, x, cfg, plan, expert_perm=perm,
                                 fixed_rows=mode == "decode")
    else:
        raise ValueError(f"unknown MoE backend {backend!r}")
    if "shared" in params:
        sh = params["shared"]

        def lane(r):
            return (F.silu(r @ sh["w_gate"]) * (r @ sh["w_in"])) @ sh["w_out"]

        if mode == "decode" or backend == "dense_decode":
            b, s, d = x.shape
            out = out + decode_rows(lane, x.reshape(b * s, d)).reshape(b, s, d)
        else:
            out = out + lane(x)
    return out, stats


def resolve_draft_mode(cfg, mode: str = "auto") -> str:
    """The draft pass for speculative decoding: ``auto`` takes
    ``shared_only`` when the model has a shared expert, ``topk1`` for a
    pure sparse MoE, and ``off`` (the draft is the model) without MoE."""
    if mode != "auto":
        return mode
    if not cfg.is_moe:
        return "off"
    return "shared_only" if cfg.moe.num_shared_experts > 0 else "topk1"


def draft_config(cfg, mode: str = "auto"):
    """The draft model's config: the same weights, ``draft_mode`` set on the
    MoE block."""
    mode = resolve_draft_mode(cfg, mode)
    if mode == "off" or not cfg.is_moe:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, draft_mode=mode))
