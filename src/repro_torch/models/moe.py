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

The ``mixnet`` backend (the paper's data plane, §5.3): send-buffer gather
(``ops.moe_dispatch``), the CommRuntime all-to-all (the payload and its
expert ids fused into one wire transfer; the identity at P = 1), the pack
into the dropless block layout, three grouped GEMMs over it
(``ops.grouped_matmul(..., block_experts=)``), the unpack, the return trip
and the weighted combine (``ops.moe_combine``).  Each gather is given its
inverse map from the dispatch plan, which is what its backward kernel
gathers through on the card.  Over a ``("data", "model")`` mesh each rank
runs that body on its token slice with its ``E_virtual / P`` experts,
re-addresses the wire chunks by a layer's ``wire_perm``, and reduces the
telemetry as the reference's ``shard_map`` body does; ``overlap_chunks >
1`` runs it as the chunked software pipeline.  Over a mesh the einsum and
dense-decode backends run each rank's own expert slots and gather their
outputs over the model axis; in training the experts' input enters through
``copy_to_model`` (its gradient summed over the model axis) and the
router reads the replicated input (its gradient is not summed: every rank
routes the group's rows).  The shared expert is tensor-parallel over the
model axis (``layers.ffn``) where its width divides it.  In a
sequence-parallel stream (``sp``) the layer's input is already the rank's
sequence slice: the mixnet region takes it as it is and leaves its output
sharded, the einsum and dense-decode backends run on the gathered sequence
(``layers.whole_in_sp``: their routers see the model group's rows) and keep
the rank's slice.  Under ZeRO-3 the expert leaves arrive gathered over the
data axis (``models.transformer.apply_layers``): each rank's are its model
rank's ``E_virtual / P`` slots, whole, as the reference's GSPMD gathers
them before its ``shard_map`` (``moe.py:522-553``).

Speculative decoding's draft passes (``MoEConfig.draft_mode``, picked by
:func:`resolve_draft_mode` and :func:`draft_config`): ``topk1`` narrows the
routed fan-out to each token's best expert, ``shared_only`` skips the routed
experts and keeps the shared lane.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core import commruntime as cr
from repro_torch.core.commruntime import AllToAll, CommSpec, fuse_pack, fuse_unpack
from repro_torch.core.overlap import chunk_count, software_pipeline
from repro_torch.kernels import ops
from repro_torch.models import routing
from repro_torch.models.layers import decode_rows, ffn, normal, whole_in_sp
from repro_torch.models.routing import MoEStats, router_losses
from repro_torch.parallel import sharding, tp
from repro_torch.parallel.sharding import ShardingPlan, virtual_experts

__all__ = [
    "init_moe", "moe_apply", "MoEStats", "router_losses", "chunk_count", "resolve_draft_mode",
    "draft_config",
]


def init_moe(gen, cfg, plan: ShardingPlan, *, reps: int, device, take=None) -> dict:
    """Stacked ``[reps, ...]`` router and expert weights, drawn one leaf at a
    time; ``take(name, tensor)`` keeps a rank's part of each leaf as it is
    drawn (``sharding.TreeLayout.part``: over a model axis of size P the
    expert leaves keep the rank's ``E_virtual / P`` slots of the same draw),
    so a rank never holds more than one whole leaf."""
    e = cfg.moe
    d = cfg.d_model
    dtype = getattr(torch, cfg.dtype)
    ev, r = virtual_experts(e.num_experts, plan.model_size)
    if e.d_ff % r != 0:
        raise ValueError(f"expert d_ff {e.d_ff} not divisible by replication {r}")
    f = e.d_ff // r
    keep = take or (lambda _, w: w)

    def draw(name, shape, std, dt=dtype):
        return keep(name, normal(gen, shape, dt, device, std))

    params = {
        "router": draw("router", (reps, d, e.num_experts), d**-0.5, torch.float32),
        "w_in": draw("w_in", (reps, ev, d, f), d**-0.5),
        "w_gate": draw("w_gate", (reps, ev, d, f), d**-0.5),
        "w_out": draw("w_out", (reps, ev, f, d), e.d_ff**-0.5),
    }
    if e.num_shared_experts:
        f_sh = e.d_ff * e.num_shared_experts
        params["shared"] = {
            "w_in": draw("shared/w_in", (reps, d, f_sh), d**-0.5),
            "w_gate": draw("shared/w_gate", (reps, d, f_sh), d**-0.5),
            "w_out": draw("shared/w_out", (reps, f_sh, d), f_sh**-0.5),
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


def _slot_range(plan: ShardingPlan, mesh, ev: int) -> tuple[int, int, int]:
    """``(lo, hi, P)``: the virtual slots ``[lo, hi)`` this rank's expert
    leaves hold over the model axis, of ``ev`` (all of them without one)."""
    p = cr.axis_size(mesh, plan.model_axis) if mesh is not None else 1
    if p <= 1:
        return 0, ev, 1
    m, k = cr.axis_index(mesh, plan.model_axis), ev // p
    return m * k, (m + 1) * k, p


class _GatherSlots(torch.autograd.Function):
    """``[n, ...]`` slot outputs all-gathered over the model axis in rank
    order; the backward keeps the rank's own slots of the gradient (every
    rank combines the same gathered outputs, so holds the same gradient)."""

    @staticmethod
    def forward(ctx, y, group, rank):
        ctx.rank, ctx.n = rank, y.shape[0]
        return cr.all_gather_raw(y, group)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None, None


def _gather_slots(y: torch.Tensor, plan: ShardingPlan, mesh, dim: int) -> torch.Tensor:
    """Every rank's per-slot outputs (its slots along ``dim``) gathered over
    the model axis into the physical slot order, the same bits on every
    rank (a copy, no sum); accounted under the model axis's link class."""
    moved = y.movedim(dim, 0).contiguous()
    full = _GatherSlots.apply(moved, cr.axis_group(mesh, plan.model_axis),
                              cr.axis_index(mesh, plan.model_axis))
    return full.movedim(0, dim)


def _moe_einsum(params, x, cfg, plan: ShardingPlan, expert_perm=None, fixed_rows=False,
                mesh=None):
    """The GShard einsum backend; ``fixed_rows`` (decode mode) runs the
    router, the per-expert products and the combine on fixed row blocks
    (``layers.decode_rows``), so a token's output does not depend on how
    many tokens share the call.

    Over a mesh (what GSPMD makes of the reference's constraints at
    ``moe.py:172`` and ``:207-209``): every rank of a model group routes the
    same rows, dispatches them to its OWN ``E_virtual / P`` slots and runs
    those experts only; the per-slot outputs ``[G, E_virtual, C, D]`` are
    gathered over the model axis and combined in gate order as at P = 1,
    so every rank holds the same output bits.  The telemetry is the rows the
    rank routed (a model group's, over a data axis a shard's)."""
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

    lo, hi, p = _slot_range(plan, mesh, ev)
    # The rank's experts read a part of the input: its gradient is summed
    # over the model axis (the router's, above, is each rank's whole).
    xd = tp.copy_to_model(xg, plan, mesh) if p > 1 else xg
    xe = torch.einsum("gtec,gtd->gecd", dispatch[:, :, lo:hi].to(x.dtype), xd)  # [G, Ev/P, C, D]
    ye = _expert_ffn(xe, params["w_in"], params["w_gate"], params["w_out"], cfg.act, fixed_rows)
    if p > 1:
        ye = _gather_slots(ye, plan, mesh, 1)  # [G, Ev, C, D]
    # Combine in GATE order: gather each choice's expert row through its
    # (slot, rank) address and contract over the choices.  The JAX backend's
    # [.., Ev, C] combine einsum sums over slots, whose association would
    # move with a re-placement; the terms and weights here are the same.
    gi = torch.arange(b * g, device=x.device)[:, None, None]
    ysel = ye[gi, vdest.long(), rank.clamp(0, cap - 1).long()]  # [G, T, S, D]
    w = torch.where(keep, wfull, torch.zeros_like(wfull)).to(x.dtype)
    out = _combine(w.reshape(b * s, -1), ysel.reshape(b * s, -1, d), fixed_rows).reshape(b, s, d)

    load, balance, z, dropped = _batch_stats(logits, info.idx, e.num_experts, plan, mesh,
                                             dropped.float())
    return out, MoEStats(load, balance, z, dropped)


def _batch_stats(logits, idx, num_experts: int, plan: ShardingPlan, mesh, dropped,
                 gate_weights=None):
    """``(load, balance, z, dropped)`` of the dense backends, whose rows are
    the rank's data shard over the batch axes and the whole model group's
    rows on every rank of it: over the batch axes the loads and the drop
    fraction are reduced and the aux losses are the whole batch's, as the
    reference's GSPMD program computes them (the balance loss from the
    batch's expert fractions and mean probabilities, its gradient reaching
    every shard through ``cr.psum``'s all-reduced transpose)."""
    axes = [] if mesh is None else [a for a in plan.batch_axes if cr.axis_size(mesh, a) > 1]
    load = routing.expert_load(idx, num_experts, weights=gate_weights)
    if not axes:
        balance, z = router_losses(logits, idx, num_experts)
        return load, balance, z, dropped
    lf = logits.float()
    mean_prob = torch.softmax(lf, dim=-1).reshape(-1, num_experts).mean(dim=0)
    z = torch.mean(torch.logsumexp(lf, dim=-1) ** 2)
    counts = routing.expert_load(idx, num_experts)
    for ax in axes:
        n = float(cr.axis_size(mesh, ax))
        mean_prob = cr.psum(mean_prob, mesh, ax) / n
        z = cr.psum(z, mesh, ax) / n
        grp = cr.axis_group(mesh, ax)
        counts = cr.all_reduce(counts, grp)
        load = cr.all_reduce(load, grp)
        dropped = cr.all_reduce(dropped, grp) / n
    frac = counts / torch.clamp_min(counts.sum(), 1.0)
    return load, num_experts * torch.sum(frac * mean_prob), z, dropped


def _combine(w, ysel, fixed_rows):
    """``out[t] = sum_s w[t, s] * ysel[t, s]`` for ``w [T, S]`` and ``ysel
    [T, S, D]``, on fixed row blocks when ``fixed_rows``."""
    f = lambda wr, yr: torch.einsum("ts,tsd->td", wr, yr)  # noqa: E731
    return decode_rows(f, w, ysel) if fixed_rows else f(w, ysel)


def _moe_dense_decode(params, x, cfg, plan: ShardingPlan, expert_perm=None,
                      gate_weights=None, mesh=None):
    """Decode-time MoE: ALL experts computed on the handful of live tokens,
    each choice's expert output gathered by ``vdest`` and summed in gate
    order, so decode tokens are bit-identical under any ``expert_perm``;
    every product on fixed row blocks (``layers.decode_rows``).

    Over a mesh (the reference's ``constrain`` at ``moe.py:606``): each rank
    runs its ``E_virtual / P`` local experts on every live token, the
    ``[E_virtual, T, D]`` outputs are gathered over the model axis (a copy,
    in slot order) and combined in gate order on every rank: no all-reduce,
    whose association could differ between ranks, so every rank's output is
    the same bits, the one-device path's."""
    e = cfg.moe
    b, s, d = x.shape
    ev, r = virtual_experts(e.num_experts, plan.model_size)
    xt = x.reshape(b * s, d)
    logits = decode_rows(lambda rr: rr @ params["router"], xt.float())
    info = routing.compute_routing(
        logits, top_k=e.top_k, num_virtual=ev, replication=r, expert_perm=expert_perm,
    )
    lo, hi, p = _slot_range(plan, mesh, ev)
    xe = (tp.copy_to_model(xt, plan, mesh) if p > 1 else xt).unsqueeze(0).expand(hi - lo, -1, -1)
    y = decode_rows(
        lambda rr: _ffn_rows(rr, params["w_in"], params["w_gate"], params["w_out"], cfg.act), xe,
        dim=1,
    )  # [Ev / P, T, D]
    if p > 1:
        y = _gather_slots(y, plan, mesh, 0)  # [Ev, T, D]
    tok = torch.arange(b * s, device=x.device)[:, None]
    ysel = y[info.vdest.long(), tok]  # [T, S, D]
    out = _combine(info.wfull.to(y.dtype), ysel, True).reshape(b, s, d)

    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    load, balance, z, _ = _batch_stats(logits, info.idx, e.num_experts, plan, mesh, zero,
                                       gate_weights)
    return out, MoEStats(load, balance, z, zero)


def _wire_perms(wire_perm, p_axis: int, device):
    """(dest_perm, src_perm) realizing a ControlPlane wire re-address.

    ``wire_perm`` is the layer's device map ``D`` (logical device k's experts
    physically live on device ``D[k]``).  The dispatch trip re-addresses
    chunks with ``D^-1``; the return trip restores logical order with ``D``.
    """
    if wire_perm is None:
        return None, None
    wire_src = torch.as_tensor(wire_perm, device=device).long()
    wire_dest = torch.empty_like(wire_src)
    wire_dest[wire_src] = torch.arange(p_axis, device=device)
    return wire_dest, wire_src


class _ShardMean(torch.autograd.Function):
    """A per-shard aux loss (balance, router z) averaged over one mesh axis.
    Every rank's loss then holds the same value with cotangent ``ct``; the
    gradient of the mean over all shards reaches this shard's term as
    ``ct * scale``: 1 over a batch axis (the DP reduction averages there)
    and ``1 / P`` over the model axis (the router's gradient is summed
    there) — what the reference's transpose of ``pmean`` under
    ``shard_map`` gives once its gradients are reduced."""

    @staticmethod
    def forward(ctx, x, group, size, scale):
        ctx.scale = scale
        return cr.all_reduce(x, group) / float(size)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None, None, None


def _reduce_telemetry(mesh, plan, axis_names, token_axes, load, balance, z, kept, offered):
    """The reference's reductions over the mesh (``moe.py:367-373``):
    counts SUM over axes that shard the tokens and MEAN over axes the tokens
    ride replicated; the aux losses MEAN."""
    for ax in axis_names:
        n = cr.axis_size(mesh, ax)
        if n == 1:
            continue
        grp = cr.axis_group(mesh, ax)
        scale = 1.0 / n if ax == plan.model_axis else 1.0
        balance = _ShardMean.apply(balance, grp, n, scale)
        z = _ShardMean.apply(z, grp, n, scale)
        div = 1.0 if ax in token_axes else float(n)
        load = cr.all_reduce(load, grp) / div
        kept = cr.all_reduce(kept, grp) / div
        offered = cr.all_reduce(offered, grp) / div
    return load, balance, z, kept, offered


def _moe_mixnet_local(
    params_local, xl, cfg, plan: ShardingPlan, expert_perm, axis_names=(),
    wire_perm=None, token_axes=(), gate_weights=None, mesh=None,
):
    """Per-rank MoE body (the reference's ``shard_map`` body, or the whole
    layer at P = 1).  ``cfg.moe.overlap_chunks > 1`` runs the chunked
    software pipeline (:func:`_mixnet_chunked`), bit-identical to the serial
    path.  Returns ``(out [B, S, D], load [E], balance, z, drop)``."""
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
    wire_dest, wire_src = _wire_perms(wire_perm, p_axis, xl.device)

    # Stage-1 keep decisions are global (chunk-invariant): dropless keeps
    # everything, capacity mode keeps rank < the serial capacity.
    rank1, _ = routing.bucket_ranks(flat_dev, p_axis)
    cp = n if dropless else routing.capacity(tl, sc, p_axis, e.capacity_factor)
    keep1 = None if dropless else rank1 < cp

    a2a = AllToAll(CommSpec.from_plan(plan, group_size=e.a2a_group, mesh=mesh))
    chunks = chunk_count(tl, e.overlap_chunks)
    # The tapped weights live in ``taps``, not on ``serial_dw``: the taps'
    # autograd nodes hold ``serial_dw``, and a reference back would be a cycle.
    serial_dw, taps = None, {}
    if chunks > 1 and torch.is_grad_enabled() and (
            w_in.requires_grad or w_gate.requires_grad or w_out.requires_grad):
        serial_dw = _SerialOrderDW(p_axis, cp, ev_local, e.dispatch_block)

    def gmm(x, w, be, chunk, key):
        if serial_dw is None:
            return ops.grouped_matmul(x, w, block_experts=be)
        if key not in taps:
            taps[key] = serial_dw.tap(w, key)
        return serial_dw.gmm(x, taps[key], be, key, chunk)

    def expert_ffn_block(rx, re, chunk=None):
        """Received rows -> per-expert pack -> grouped GEMMs -> unpacked
        rows aligned with the receive layout, and the kept count."""
        valid = re >= 0
        rank2, counts2 = routing.bucket_ranks(re, ev_local, valid=valid)
        if dropless or chunks > 1:
            # The block layout places every valid received row (the chunked
            # pipeline uses it for capacity mode too, as the reference).
            plan2 = routing.dropless_plan(re, rank2, counts2, valid, ev_local, e.dispatch_block)
            packed = ops.moe_dispatch(rx, plan2.src, inverse=plan2.slot)
            packed = packed.reshape(-1, e.dispatch_block, d)
            be = plan2.block_experts
            if serial_dw is not None:
                serial_dw.add_chunk(chunk, re, plan2.slot)
            h = gmm(packed, w_in, be, chunk, "w_in")
            gt = gmm(packed, w_gate, be, chunk, "w_gate")
            ye = gmm(act(gt) * h, w_out, be, chunk, "w_out")
        else:
            c2 = routing.capacity(re.shape[0], 1, ev_local, e.capacity_factor)
            plan2 = routing.capacity_plan(re, rank2, valid, ev_local, c2)
            packed = ops.moe_dispatch(rx, plan2.src, inverse=plan2.slot).reshape(ev_local, c2, d)
            h = ops.grouped_matmul(packed, w_in)
            gt = ops.grouped_matmul(packed, w_gate)
            ye = ops.grouped_matmul(act(gt) * h, w_out)
        back = ops.moe_dispatch(ye.reshape(plan2.num_rows, d), plan2.slot, inverse=plan2.src)
        return back, plan2.kept

    if chunks == 1:
        # Serial path: one send buffer, one a2a pair.  The send gather is
        # many-to-one (a token feeds its top-k choices): its backward is the
        # combine with unit weights through plan1.slot.
        plan1 = routing.capacity_plan(flat_dev, rank1, keep1, p_axis, cp)
        send_x, send_e = _send_buffers(xt, plan1, local_e, sc, p_axis, cp)
        if e.a2a_fuse:
            recv_x, recv_e = a2a.fused(send_x, send_e, dest_perm=wire_dest)
        else:
            recv_x = a2a(send_x, dest_perm=wire_dest)
            recv_e = a2a(send_e[..., None], dest_perm=wire_dest)[..., 0]
        back, kept = expert_ffn_block(recv_x.reshape(p_axis * cp, d),
                                      recv_e.reshape(p_axis * cp))
        ret = a2a(back.reshape(p_axis, cp, d), src_perm=wire_src)
        out = ops.moe_combine(
            ret.reshape(p_axis * cp, d), plan1.slot.reshape(tl, sc), info.wfull,
            inverse=plan1.src, out_dtype=xl.dtype,
        )
    else:
        out, kept = _mixnet_chunked(
            xt, info, flat_dev, local_e, keep1, a2a, expert_ffn_block, wire_dest, wire_src,
            chunks=chunks, p_axis=p_axis, sc=sc, cp=cp, fuse=e.a2a_fuse,
        )
    out = out.reshape(bl, sl, d)

    balance, z = router_losses(logits, info.idx, e.num_experts)
    load = routing.expert_load(info.idx, e.num_experts, weights=gate_weights)
    # Drop telemetry folds both stages: `kept` counts choices that won a
    # send slot AND an expert slot (exactly 0 dropped in dropless mode).
    kept = torch.as_tensor(kept, device=xl.device).float()
    offered = torch.tensor(float(n), device=xl.device)
    if axis_names:
        load, balance, z, kept, offered = _reduce_telemetry(
            mesh, plan, axis_names, token_axes, load, balance, z, kept, offered)
    drop = 1.0 - kept / offered
    return out, load, balance, z, drop


def _send_buffers(xt, plan1, local_e, sc: int, p_axis: int, cp: int):
    """The ``[P, cp, D]`` send buffer of ``xt``'s rows by ``plan1`` and its
    ``[P, cp]`` int32 local-expert ids (-1 in empty slots)."""
    n = local_e.shape[0]
    tl, d = xt.shape
    src_tok = torch.where(plan1.src >= 0, plan1.src // sc, torch.full_like(plan1.src, -1))
    send_x = ops.moe_dispatch(xt, src_tok, inverse=plan1.slot.reshape(tl, sc))
    send_e = torch.where(
        plan1.src >= 0, local_e[plan1.src.clamp(0, n - 1).long()], torch.full_like(plan1.src, -1)
    ).reshape(p_axis, cp).to(torch.int32)
    return send_x.reshape(p_axis, cp, d), send_e


def _mixnet_chunked(
    xt, info, flat_dev, local_e, keep1, a2a, expert_ffn_block,
    wire_dest, wire_src, *, chunks, p_axis, sc, cp, fuse,
):
    """Chunked dispatch/FFN/combine pipeline (``repro.core.overlap``).

    The token dim splits into ``chunks`` equal chunks; each runs send
    buffer -> dispatch a2a (per delegation stage) -> expert FFN -> return
    a2a (per stage) -> combine.  :func:`overlap.software_pipeline` issues
    stage s of chunk k at tick k + s, and every a2a stage is issued async
    and waited on by the next stage, so chunk k+1's dispatch is in flight
    under chunk k's FFN.  Returns (``[T, D]`` output in xt's dtype, kept
    count)."""
    tl, d = xt.shape
    tc = tl // chunks
    nc = tc * sc
    cp_c = nc if keep1 is None else min(nc, cp)
    disp_stages = a2a.stages()
    ret_stages = a2a.stages()
    fused = fuse and xt.element_size() in (2, 4)

    def s_build(_, k):
        lo = k * nc
        dest_c = flat_dev[lo:lo + nc]
        keep_c = None if keep1 is None else keep1[lo:lo + nc]
        rank_c, _ = routing.bucket_ranks(dest_c, p_axis, valid=keep_c)
        plan1_c = routing.capacity_plan(dest_c, rank_c, keep_c, p_axis, cp_c)
        send_x, send_e = _send_buffers(xt[k * tc:(k + 1) * tc], plan1_c, local_e[lo:lo + nc],
                                       sc, p_axis, cp_c)
        st = {"plan1": plan1_c}
        if fused:
            st["x"] = disp_stages[0](fuse_pack(send_x, send_e), dest_perm=wire_dest,
                                     async_op=True)
        else:
            st["x"] = disp_stages[0](send_x, dest_perm=wire_dest, async_op=True)
            st["e"] = disp_stages[0](send_e[..., None], dest_perm=wire_dest, async_op=True)
        return st

    def s_disp2(st, _):
        st = dict(st)
        st["x"] = disp_stages[1](st["x"].wait(), async_op=True)
        if not fused:
            st["e"] = disp_stages[1](st["e"].wait(), async_op=True)
        return st

    def s_ffn(st, k):
        if fused:
            recv_x, recv_e = fuse_unpack(st["x"].wait(), d)
        else:
            recv_x, recv_e = st["x"].wait(), st["e"].wait()[..., 0]
        back, kept_c = expert_ffn_block(recv_x.reshape(p_axis * cp_c, d),
                                        recv_e.reshape(p_axis * cp_c), k)
        back = back.reshape(p_axis, cp_c, d)
        last = len(ret_stages) == 1
        back = ret_stages[0](back, src_perm=wire_src if last else None, async_op=True)
        return {"plan1": st["plan1"], "back": back, "kept": kept_c}

    def s_ret2(st, _):
        st = dict(st)
        st["back"] = ret_stages[1](st["back"].wait(), src_perm=wire_src, async_op=True)
        return st

    def s_combine(st, k):
        wf_c = info.wfull[k * tc:(k + 1) * tc]
        plan1_c = st["plan1"]
        out_c = ops.moe_combine(
            st["back"].wait().reshape(p_axis * cp_c, d), plan1_c.slot.reshape(tc, sc), wf_c,
            inverse=plan1_c.src, out_dtype=xt.dtype,
        )
        return out_c, st["kept"]

    stage_fns = [s_build]
    if len(disp_stages) == 2:
        stage_fns.append(s_disp2)
    stage_fns.append(s_ffn)
    if len(ret_stages) == 2:
        stage_fns.append(s_ret2)
    stage_fns.append(s_combine)

    results = software_pipeline(chunks, stage_fns)
    out = torch.cat([res[0] for res in results], dim=0)
    kept = sum(res[1] for res in results)
    return out, kept


class _SerialOrderDW:
    """Expert weight gradients of the chunked pipeline, computed in the
    serial path's row order.

    Chunking splits each expert's received rows over the chunks' GEMMs, so
    per-chunk weight gradients summed by autograd round differently from
    the serial path's one product over all of the expert's rows: the
    trained weights would drift from the serial run's in their low bits.
    Here every chunk's GEMM (:class:`_ChunkGMM`) returns its input gradient
    only and leaves its ``(x, dy)`` rows; once every chunk's backward has run,
    the weight's tap (:class:`_WeightTap`) places those rows where the
    serial path packs them (source-major, chunk-minor: a source's serial
    send buffer is its chunks' buffers one after another) and takes the
    weight gradient in one product over that layout's dropless blocks:
    bit for bit the serial dropless path's.  In capacity mode the rows are
    those the global stage-1 decisions keep (at most ``cp`` a source), so
    the product does not depend on the chunk count; the serial capacity
    path itself runs another layout (kernel 6, with its own stage-2
    capacity), so chunked and one-chunk capacity runs need not keep the
    same rows."""

    def __init__(self, p_axis: int, cp: int, experts: int, block: int):
        self.p_axis, self.cp, self.experts, self.block = p_axis, cp, experts, block
        self.chunks: dict = {}  # chunk -> (received expert ids, received -> packed row)
        self.rows: dict = {}  # weight key -> {chunk: (x, dy)}
        self._layout = None

    def add_chunk(self, chunk: int, re: torch.Tensor, slot: torch.Tensor) -> None:
        self.chunks[chunk] = (re, slot)

    def tap(self, w, key: str):
        """``w`` behind its tap: pass it to :meth:`gmm` with the same key."""
        self.rows[key] = {}
        return _WeightTap.apply(w, self, key)

    def gmm(self, x, w_tapped, be, key: str, chunk: int):
        return _ChunkGMM.apply(x, w_tapped, be, self, key, chunk)

    def layout(self):
        """(serial block->expert map, and per chunk its packed rows and the
        serial packed rows they land on), built once."""
        if self._layout is None:
            p, cp = self.p_axis, self.cp
            dev = next(iter(self.chunks.values()))[0].device
            re_serial = torch.full((p, cp), -1, dtype=torch.int32, device=dev)
            fill = torch.zeros(p, dtype=torch.long, device=dev)
            placed = {}
            for k in sorted(self.chunks):
                re, slot = self.chunks[k]
                re = re.reshape(p, -1)
                valid = re >= 0
                # Serial position of each valid row: after the source's rows
                # of the earlier chunks, in its own order.
                pos = fill[:, None] + torch.cumsum(valid.long(), 1) - 1
                src_rows = torch.arange(p, device=dev)[:, None].expand_as(re)
                re_serial[src_rows[valid], pos[valid]] = re[valid]
                placed[k] = (slot.reshape(p, -1)[valid].long(), src_rows[valid] * cp + pos[valid])
                fill += valid.sum(1)
            re_flat = re_serial.reshape(p * cp)
            valid = re_flat >= 0
            rank2, counts2 = routing.bucket_ranks(re_flat, self.experts, valid=valid)
            plan2 = routing.dropless_plan(re_flat, rank2, counts2, valid, self.experts, self.block)
            rows = {k: (chunk_rows, plan2.slot.long()[serial_idx])
                    for k, (chunk_rows, serial_idx) in placed.items()}
            self._layout = (plan2.block_experts, plan2.num_rows, rows)
        return self._layout

    def weight_grad(self, w: torch.Tensor, key) -> torch.Tensor:
        be, num_rows, rows = self.layout()
        parts = self.rows.pop(key)
        x0, dy0 = next(iter(parts.values()))
        xs = x0.new_zeros((num_rows, x0.shape[-1]))
        dys = dy0.new_zeros((num_rows, dy0.shape[-1]))
        for k, (x, dy) in parts.items():
            chunk_rows, serial_rows = rows[k]
            xs[serial_rows] = x.reshape(-1, x.shape[-1])[chunk_rows]
            dys[serial_rows] = dy.reshape(-1, dy.shape[-1])[chunk_rows]
        xs = xs.reshape(-1, self.block, xs.shape[-1])
        dys = dys.reshape(-1, self.block, dys.shape[-1])
        if xs.device.type == "cpu":
            # The serial path's own autograd product on the CPU.
            with torch.enable_grad():
                wr = w.detach().requires_grad_()
                y = ops.grouped_matmul(xs, wr, block_experts=be)
                return torch.autograd.grad(y, wr, dys)[0]
        from repro_torch.kernels.grouped_matmul import grouped_matmul_blocks_dw_cuda

        return grouped_matmul_blocks_dw_cuda(xs, dys.contiguous(), be, w.shape[0])


class _WeightTap(torch.autograd.Function):
    """Identity on an expert weight whose backward is the serial-order
    weight gradient (:class:`_SerialOrderDW`); it runs after every chunk's
    GEMM backward, as all of them consume its output."""

    @staticmethod
    def forward(ctx, w, owner, key):
        ctx.owner, ctx.key = owner, key
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(w)
        return w.view_as(w)

    @staticmethod
    def backward(ctx, _):
        w, = ctx.saved_tensors
        return ctx.owner.weight_grad(w, ctx.key), None, None


class _ChunkGMM(torch.autograd.Function):
    """One chunk's dropless block GEMM: the op's forward; the backward gives
    the input gradient and leaves ``(x, dy)`` for the weight's tap."""

    @staticmethod
    def forward(ctx, x, w, be, owner, key, chunk):
        ctx.owner, ctx.key, ctx.chunk = owner, key, chunk
        ctx.save_for_backward(x, w, be)
        with torch.no_grad():
            return ops.grouped_matmul(x, w, block_experts=be)

    @staticmethod
    def backward(ctx, dy):
        x, w, be = ctx.saved_tensors
        ctx.owner.rows[ctx.key][ctx.chunk] = (x, dy)
        dx = None
        if ctx.needs_input_grad[0]:
            if x.device.type == "cpu":
                with torch.enable_grad():
                    xr = x.detach().requires_grad_()
                    y = ops.grouped_matmul(xr, w.detach(), block_experts=be)
                    dx = torch.autograd.grad(y, xr, dy)[0]
            else:
                from repro_torch.kernels.grouped_matmul import grouped_matmul_blocks_dx_cuda

                dx = grouped_matmul_blocks_dx_cuda(dy.contiguous(), w, be)
        return dx, None, None, None, None, None


def _moe_mixnet(params, x, cfg, plan: ShardingPlan, mesh, expert_perm, wire_perm=None,
                gate_weights=None, per_shard=False, sp=False):
    """``expert_perm``: THIS layer's ``[E_virtual]`` expert->slot map;
    ``wire_perm``: its optional ``[P]`` device map; ``gate_weights``: an
    optional ``[B, S]`` per-token telemetry weight.

    Over a mesh, ``x`` is this rank's data slice of the batch and the
    expert leaves are its ``[E_virtual / P, ...]`` shard.  The region takes
    the rank's sequence slice over the model axis
    (:func:`sharding.token_slice`), runs the per-rank body with the
    reference's telemetry reductions, and all-gathers the output back.  A
    data-only mesh (model size 1) runs the layer on the whole batch,
    all-gathered over the data axis, as the reference's layer sees it, and
    keeps the rank's rows; with ``per_shard`` it runs on the rank's rows
    with per-shard aux losses, as the reference's pipeline stage body
    (``pp_step.py:217-221``) does.  ``sp``: ``x`` is already the rank's
    sequence slice (a sequence-parallel stream), and so is the output."""
    weights = (params["router"], params["w_in"], params["w_gate"], params["w_out"])
    if mesh is None or (plan.model_size <= 1 and plan.data_size <= 1):
        out, load, balance, z, drop = _moe_mixnet_local(
            weights, x, cfg, plan, expert_perm, wire_perm=wire_perm, gate_weights=gate_weights,
        )
        return out, MoEStats(load, balance, z, drop)
    if plan.model_size <= 1 and not per_shard:
        ax = plan.batch_axes[-1]
        b = x.shape[0]
        xg = cr.all_gather(x, mesh, ax)
        gw = None if gate_weights is None else cr.all_gather(gate_weights, mesh, ax)
        out, load, balance, z, drop = _moe_mixnet_local(
            weights, xg, cfg, plan, expert_perm, wire_perm=wire_perm, gate_weights=gw,
        )
        i = cr.axis_index(mesh, ax)
        return out[i * b:(i + 1) * b], MoEStats(load, balance, z, drop)
    s = x.shape[1] * (plan.model_size if sp else 1)
    if plan.model_size <= 1:  # per_shard on a data-only mesh
        out, load, balance, z, drop = _moe_mixnet_local(
            weights, x, cfg, plan, expert_perm, tuple(plan.batch_axes), wire_perm=wire_perm,
            token_axes=tuple(plan.batch_axes), gate_weights=gate_weights, mesh=mesh,
        )
        return out, MoEStats(load, balance, z, drop)
    sharded = sharding.seq_sharded(plan, s)
    axis_names = tuple(plan.batch_axes) + (plan.model_axis,)
    token_axes = tuple(plan.batch_axes) + ((plan.model_axis,) if sharded else ())
    xl = x if sp else sharding.token_slice(x, plan, mesh)
    gw = None
    if gate_weights is not None:
        gw = gate_weights
        if sharded:
            m, sl = cr.axis_index(mesh, plan.model_axis), s // plan.model_size
            gw = gate_weights[:, m * sl:(m + 1) * sl]
    out, load, balance, z, drop = _moe_mixnet_local(
        weights, xl, cfg, plan, expert_perm, axis_names, wire_perm=wire_perm,
        token_axes=token_axes, gate_weights=gw, mesh=mesh,
    )
    if sp:
        return out, MoEStats(load, balance, z, drop)
    return sharding.token_gather(out, plan, mesh, s), MoEStats(load, balance, z, drop)


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
    per_shard: bool = False,
    sp: bool = False,
):
    """``expert_perm``: this layer's ``[Ev]`` expert->slot map;
    ``wire_perm``: optional ``[P]`` device map, composed into the slot
    addressing (the dense backends hit the physically resident weights);
    ``gate_weights``: optional ``[B, S]`` telemetry weight per token;
    ``per_shard``: over a data-only mesh, the rank's rows alone (a
    pipeline stage's layer, :func:`_moe_mixnet`); ``sp``: ``x`` is the
    rank's ``[B, S / P, D]`` slice of a sequence-parallel stream, and the
    output is too (see the module docstring)."""
    e = cfg.moe
    if e.draft_mode == "topk1" and e.top_k > 1:
        # Speculative draft: narrow the routed fan-out to the gate's single
        # best expert by rewriting the config; every backend below runs as is.
        e = dataclasses.replace(
            e, top_k=routing.effective_top_k(e.top_k, e.draft_mode), draft_mode="off"
        )
        cfg = dataclasses.replace(cfg, moe=e)
    backend = backend or e.backend
    seq_len = x.shape[1] * (plan.model_size if sp else 1)
    if backend != "einsum" and (seq_len == 1 or mode == "decode"):
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
    elif backend == "mixnet":
        out, stats = _moe_mixnet(
            params, x, cfg, plan, mesh, perm, wire_perm=wire_perm, gate_weights=gate_weights,
            per_shard=per_shard, sp=sp,
        )
    elif backend in ("dense_decode", "einsum"):
        def dense(xg):
            if backend == "dense_decode":
                return _moe_dense_decode(params, xg, cfg, plan, expert_perm=perm,
                                         gate_weights=gate_weights, mesh=mesh)
            return _moe_einsum(params, xg, cfg, plan, expert_perm=perm,
                               fixed_rows=mode == "decode", mesh=mesh)

        out, stats = whole_in_sp(dense, x, plan, mesh) if sp else dense(x)
    else:
        raise ValueError(f"unknown MoE backend {backend!r}")
    if "shared" in params:
        sh = params["shared"]
        sharded = tp.enabled(plan, mesh) and sh["w_in"].shape[-1] < e.d_ff * e.num_shared_experts
        fixed = mode == "decode" or backend == "dense_decode"
        if sp and not sharded:
            y = whole_in_sp(lambda xg: ffn(sh["w_in"], sh["w_gate"], sh["w_out"], xg, F.silu,
                                           fixed), x, plan, mesh)
        else:
            y = ffn(sh["w_in"], sh["w_gate"], sh["w_out"], x, F.silu, fixed,
                    *((plan, mesh) if sharded else (None, None)), sp=sp)
        out = out + y
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
