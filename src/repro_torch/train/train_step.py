"""Training and serving step factories.

Port of :mod:`repro.train.train_step`.  ``jit`` has no counterpart here:
each factory returns a plain eager function.  The training step
differentiates :func:`loss_fn` with ``torch.autograd.grad`` and applies
AdamW in place; the serving steps run under ``torch.no_grad``.

Over a ``("data", "model")`` mesh (``dp_comm="auto"``) every rank
differentiates its own loss — its data slice of the batch, the dense
layers tensor-parallel and the MoE layers expert-parallel over the model
axis — and the DP gradient reduction follows one rule per leaf
(:func:`reduce_grads`, :func:`grad_kind`):

* ``"expert"`` leaves (``moe/w_in``, ``moe/w_gate``, ``moe/w_out``),
  sharded over the model axis: averaged over the data axis;
* ``"tensor"`` leaves, the rank's tensor-parallel shard
  (:class:`~repro_torch.parallel.sharding.TreeLayout`: attention heads,
  MLP and shared-expert columns and rows, vocab rows): averaged over the
  data axis (their partial input gradients are summed inside the backward,
  ``parallel.tp``);
* ``"router"``: the mixnet router, which sees only the rank's token slice:
  summed over the model axis, then averaged over the data axis (the
  ``einsum`` and ``dense_decode`` routers see the group's rows on every
  rank and are ``"redundant"``);
* every other leaf (the norms, replicated leaves), computed redundantly by
  each rank of a model group: averaged over the data axis only; every rank
  of the group holds the same gradient bit for bit.

Every sum over a data axis is ``commruntime``'s rank-order one
(``all_reduce_ordered``).  Under ZeRO-3 (``plan.fsdp_axis``) a leaf the
data axis shards (``parallel.fsdp``) arrives summed over it already, as the
rank's shard (its gather's backward, ``reduce_scatter_ordered``: the same
sum), and is only averaged here; the AdamW update then runs on the shards.

The clipping norm is the whole model's: the replicated leaves once, each
tensor-parallel leaf's squares gathered over the model axis and summed in
rank order, the experts' squares in logical expert order whatever their
placement.  A leaf a data axis shards under ZeRO-3 adds its shards'
squares in data rank order; the replicated plan sums the same blocks of
its whole leaf in the same order (``TreeLayout.data_blocks``), so ZeRO-3
and the replicated plan clip by one norm, bit for bit.
``dp_comm="runtime"`` computes per-shard gradients
on a data-only mesh and reduces them through the CommRuntime's
hierarchical :class:`~repro_torch.core.commruntime.AllReduce`, optionally
int8 with error feedback (``dp_compress``), as the reference's
``shard_map`` does.

Sampled serving steps draw with :mod:`repro_torch.prng`, the counterpart of
the ``jax.random`` calls the reference makes, on the logits' device.  The
serving steps take the mesh through ``model_apply``: over a ``("model",)``
mesh every rank holds its kv heads of the KV caches (or paged pools) and
runs its heads of attention, the MoE layers run EP-sharded
(``models.moe.moe_apply``), and the logits are all-gathered to the whole
vocabulary before any argmax or draw, so every rank returns the same
tokens.
"""

from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core import commruntime as cr
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import decode_rows
from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_update,
    init_adamw,
    square_sum,
)
from repro_torch.parallel import fsdp
from repro_torch.parallel.sharding import EXPERT_LEAVES, ShardingPlan, TreeLayout

__all__ = [
    "loss_fn", "make_train_step", "init_all", "init_ef_residual", "reduce_grads",
    "grad_kind", "leaf_squares", "data_summed", "make_prefill_step", "make_prefill_chunk_step",
    "make_serve_step", "make_verify_step", "make_draft_loop_step",
]


def _attention_only(cfg, what: str) -> None:
    bad = [k for k in (*cfg.block_pattern, *cfg.tail_pattern) if k not in ("global", "local")]
    if bad:
        raise ValueError(f"{what} needs attention-only block patterns, got {bad}")


def _decode_logits(params, feats: torch.Tensor, cfg, plan=None, mesh=None) -> torch.Tensor:
    """``[B, C, V]`` logits of decode-mode features, the LM head on fixed
    row blocks (``layers.decode_rows``): a row's logits do not depend on how
    many rows the step scores.  Under tensor parallelism each rank's vocab
    slice is all-gathered once after the blocks."""
    b, c, d = feats.shape
    local = decode_rows(
        lambda r: tfm.local_logits(params, r[None], cfg, plan, mesh)[0], feats.reshape(b * c, d)
    ).reshape(b, c, -1)
    return tfm.gather_logits(params, local, cfg, plan, mesh)


def _sample_rows(logits: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Per-row Gumbel-argmax sample: ``[B, V]`` logits x ``[B, 2]`` keys,
    each row drawing on its OWN key (the serving engine's key discipline,
    DESIGN.md §11), so speculative and serial decode draw the same token
    from the same logits."""
    l32 = logits.float()
    return torch.argmax(l32 + prng.gumbel(keys, l32.shape[-1:]), dim=-1)


def loss_fn(params, batch, cfg, plan, mesh=None, expert_perm=None, wire_perm=None):
    """``(loss, (ce, aux))``: chunked cross entropy plus the MoE balance and
    router-z losses.  ``expert_perm``: ``[repeats, E_virtual]`` per-layer
    expert->slot maps; ``wire_perm``: optional ``[repeats, P]`` device maps.
    Under ZeRO-3 the embedding and the head are gathered once for both
    uses."""
    params = fsdp.gather_ends(params, cfg, plan, mesh)
    feats, aux, _ = tfm.model_apply(
        params, batch, cfg, plan, mesh=mesh, mode="train", expert_perm=expert_perm,
        wire_perm=wire_perm,
    )
    ce = tfm.chunked_cross_entropy(params, feats, batch["labels"], cfg, plan=plan, mesh=mesh)
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


def grad_kind(path: str, layout: TreeLayout) -> str:
    """``"expert"``, ``"tensor"``, ``"router"`` or ``"redundant"``: which
    reduction rule a leaf's gradient follows over a mesh (see the module
    docstring); ``layout`` tells the tensor-parallel leaves, its config the
    MoE backend."""
    parts = path.strip("/").split("/")
    if len(parts) >= 2 and parts[-2] == "moe":
        if parts[-1] in EXPERT_LEAVES:
            return "expert"
        if parts[-1] == "router":
            return "router" if layout.cfg.moe.backend == "mixnet" else "redundant"
    return "redundant" if layout.replicated(path) else "tensor"


def reduce_grads(grads: dict, plan: ShardingPlan, mesh, cfg) -> dict:
    """The DP gradient reduction of ``dp_comm="auto"`` over ``mesh``, per
    leaf (``{path: grad}``, reduced in place), in place of the reference's
    GSPMD reduction; ``cfg``: the model's config (its MoE backend tells the
    router's rule)."""
    layout = TreeLayout(plan, mesh, cfg)
    for path, g in grads.items():
        # In place: the gradients are the step's own tensors, and a second
        # copy of every gradient would not fit beside four ranks' states.
        g = g.contiguous()
        if grad_kind(path, layout) == "router" and plan.model_size > 1:
            cr.all_reduce(g, cr.axis_group(mesh, plan.model_axis), inplace=True)
        shard = fsdp.shard_dim(path, g, cfg, plan, mesh) is not None
        for ax in plan.batch_axes:
            n = cr.axis_size(mesh, ax)
            if n > 1:
                if not (shard and ax == plan.fsdp_axis):  # else summed by the gather's backward
                    cr.all_reduce_ordered(g, cr.axis_group(mesh, ax), inplace=True)
                g.div_(float(n))
        grads[path] = g
    return grads


def leaf_squares(g: torch.Tensor, path: str, layout: TreeLayout, lead: int = 0) -> torch.Tensor:
    """The f64 sum of the squares of a rank's gradient ``g`` of the leaf at
    ``path`` (``lead`` leading dims fewer than the stored leaf), over the
    ZeRO-3 data blocks in rank order (``TreeLayout.data_blocks``): a
    replicated plan's whole leaf sums its blocks as the sharded plan's ranks
    do (:func:`data_summed` then adds those ranks' sums)."""
    blocks = layout.data_blocks(path)
    if blocks is None or blocks[1] == 1:
        return square_sum(g)
    dim, n = blocks
    total = None
    for part in g.chunk(n, dim - lead):
        v = square_sum(part.contiguous())
        total = v if total is None else total + v
    return total


def _axis_summed(vals: list, pos: list, mesh, axis: str) -> list:
    """``vals`` (f64 tensors) with each entry at ``pos`` replaced by its sum
    over ``axis`` in rank order (one all-gather of them all), the same bits
    on every rank."""
    flat = torch.cat([vals[i].reshape(-1) for i in pos])
    table = cr.all_gather_raw(flat[None], cr.axis_group(mesh, axis))
    summed = table[0]
    for q in range(1, table.shape[0]):
        summed = summed + table[q]
    out, at = list(vals), 0
    for i in pos:
        k = vals[i].numel()
        out[i] = summed[at:at + k].reshape(vals[i].shape)
        at += k
    return out


def data_summed(vals: list, pos: list, plan: ShardingPlan, mesh) -> list:
    """:func:`_axis_summed` over the ZeRO-3 data axis: the squares of a leaf
    the data axis shards."""
    if not pos or not fsdp.active(plan, mesh):
        return vals
    return _axis_summed(vals, pos, mesh, plan.fsdp_axis)


def model_summed(vals: list, pos: list, plan: ShardingPlan, mesh) -> list:
    """:func:`_axis_summed` over the model axis: a tensor-parallel leaf's
    squares."""
    if not pos or plan.model_size <= 1:
        return vals
    return _axis_summed(vals, pos, mesh, plan.model_axis)


def _mesh_grad_norm(grads: dict, plan: ShardingPlan, mesh, expert_perm, wire_perm, cfg):
    """The whole model's gradient norm from a rank's reduced gradients: the
    replicated leaves once, each tensor-parallel leaf's squares summed over
    the model axis in rank order, then every expert's squares in logical
    expert order, gathered over the model axis.  The order does not depend
    on where the experts sit, so a wire re-address and the equivalent weight
    move clip by the same norm, bit for bit.  ``cfg``: the model's config
    (its leaves' global sizes tell the tensor-parallel ones)."""
    layout = TreeLayout(plan, mesh, cfg)
    kinds = {p: grad_kind(p, layout) for p in grads}
    paths = sorted(grads)
    # Every leaf's squares (an expert leaf's per slot: [reps, E_virtual /
    # P]), its ZeRO-3 shards' summed over the data axis.
    sq = [torch.stack([torch.stack([leaf_squares(e, p, layout, lead=2) for e in layer])
                       for layer in grads[p]]) if kinds[p] == "expert"
          else leaf_squares(grads[p], p, layout) for p in paths]
    sq = dict(zip(paths, data_summed(sq, [i for i, p in enumerate(paths)
                                          if layout.fsdp_dim(p) is not None], plan, mesh)))
    total = None
    for p in paths:
        if kinds[p] in ("redundant", "router"):
            total = sq[p] if total is None else total + sq[p]
    tensors = [p for p in paths if kinds[p] == "tensor"]
    for v in model_summed([sq[p] for p in tensors], list(range(len(tensors))), plan, mesh):
        total = v if total is None else total + v
    for path in paths:
        if kinds[path] != "expert":
            continue
        g = grads[path]
        # [reps, E_virtual / P] per-slot sums, gathered to [reps, E_virtual]
        # in physical slot order, then read in logical expert order.
        sq_e = sq[path]
        if plan.model_size > 1:
            sq_e = cr.all_gather_raw(sq_e.t().contiguous(),
                                     cr.axis_group(mesh, plan.model_axis)).t()
        slots = _physical_slots(expert_perm, wire_perm, sq_e.shape, g.device)
        part = torch.sum(torch.gather(sq_e, 1, slots))
        total = part if total is None else total + part
    return torch.sqrt(total).float()


def _physical_slots(expert_perm, wire_perm, shape, device) -> torch.Tensor:
    """``[reps, Ev]`` physical slot of each logical expert: its slot under
    ``expert_perm``, then its device block moved by the layer's wire map."""
    reps, ev = shape
    if expert_perm is None:
        return torch.arange(ev, device=device).expand(reps, ev)
    slots = torch.as_tensor(expert_perm, device=device).long().reshape(reps, ev)
    if wire_perm is not None:
        wire = torch.as_tensor(wire_perm, device=device).long().reshape(reps, -1)
        epd = ev // wire.shape[1]
        slots = torch.gather(wire, 1, slots // epd) * epd + slots % epd
    return slots


def init_ef_residual(params, plan: ShardingPlan):
    """This rank's error-feedback residuals for ``dp_compress=True``: an f32
    ``[1, *shape]`` zero per leaf — the rank's shard of the reference's
    ``[D, *shape]`` residual (leading dim = the DP degree, sharded over the
    batch axes)."""
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros((1, *tree.shape), dtype=torch.float32, device=tree.device)

    return zeros(params)


def _make_runtime_grad_fn(cfg, plan: ShardingPlan, mesh, compress: bool = False):
    """Per-shard gradients on a data-only mesh, reduced with the CommRuntime
    hierarchical AllReduce (``dp_comm="runtime"``); ``compress`` runs the
    int8 codec with per-shard error feedback.  The MoE aux losses are
    per-shard values averaged, as the reference's ``shard_map`` body."""
    if mesh is None or not plan.batch_axes or plan.model_size > 1:
        raise ValueError(
            "dp_comm='runtime' requires a data-parallel mesh without a model "
            f"axis (got mesh={mesh is not None}, plan={plan})"
        )
    if plan.fsdp_axis is not None:
        raise ValueError(
            "dp_comm='runtime' replicates parameters and is incompatible with FSDP "
            "sharding; build the plan with make_plan(mesh, fsdp=False)"
        )
    local_plan = ShardingPlan((), None, 1, None, 1)
    reduce_op = cr.AllReduce(cr.CommSpec.for_grad_reduce(plan, mesh))

    def grad_fn(params, batch, expert_perm, residual=None):
        metrics, grads = _local_grads(params, batch, cfg, local_plan, None, expert_perm, None)
        new_residual = None
        if compress:
            res_of = dict(_flat(residual))
            red, res = {}, {}
            for k, g in grads.items():
                target = g.float() + res_of[k][0]
                total, local = reduce_op.compressed(target, mean=True)
                red[k] = total.to(g.dtype)
                res[k] = (target - local)[None]
            grads, new_residual = red, _unflat(res, residual)
        else:
            grads = {k: reduce_op(g, mean=True) for k, g in grads.items()}
        out = {k: reduce_op(v, mean=True) for k, v in metrics.items()
               if k not in ("expert_load", "dropped_fraction")}
        if "expert_load" in metrics:
            # Loads are counts: SUM over shards; the drop fraction averages.
            out["expert_load"] = reduce_op(metrics["expert_load"])
            out["dropped_fraction"] = reduce_op(metrics["dropped_fraction"], mean=True)
        return out, grads, new_residual

    return grad_fn


def _local_grads(params, batch, cfg, plan, mesh, expert_perm, wire_perm):
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


def make_train_step(
    cfg,
    plan: ShardingPlan,
    opt_cfg: AdamWConfig,
    mesh=None,
    microbatches: int = 1,
    dp_comm: str = "auto",
    dp_compress: bool = False,
):
    """``(params, opt_state, batch, expert_perm, wire_perm[, ef_residual]) ->
    (params, opt_state, metrics[, ef_residual])``, updating ``params`` and
    ``opt_state`` in place.  ``microbatches > 1`` accumulates gradients over
    batch slices in a Python loop.  Over a mesh ``batch`` is this rank's
    data slice; the loss and cross entropy reported are the global batch's
    (averaged over the data axis)."""
    if dp_comm not in ("auto", "runtime"):
        raise ValueError(f"unknown dp_comm mode {dp_comm!r}")
    if dp_compress and dp_comm != "runtime":
        raise ValueError("dp_compress=True requires dp_comm='runtime'")
    if dp_compress and microbatches > 1:
        raise ValueError(
            "dp_compress=True supports microbatches=1 only (the error-feedback "
            "residual is a per-step state, not a per-slice one)"
        )
    runtime_grads = (
        _make_runtime_grad_fn(cfg, plan, mesh, compress=dp_compress)
        if dp_comm == "runtime" else None
    )
    on_mesh = mesh is not None and (plan.model_size > 1 or plan.data_size > 1)

    def grad_once(params, batch, expert_perm, wire_perm, residual=None):
        if runtime_grads is not None:
            if wire_perm is not None:
                raise ValueError(
                    "wire_perm needs a model axis; dp_comm='runtime' runs on a DP-only mesh"
                )
            return runtime_grads(params, batch, expert_perm, residual)
        metrics, grads = _local_grads(params, batch, cfg, plan, mesh, expert_perm, wire_perm)
        if on_mesh:
            grads = reduce_grads(grads, plan, mesh, cfg)
            for ax in plan.batch_axes:
                n = cr.axis_size(mesh, ax)
                if n > 1:
                    for k in ("loss", "ce"):
                        metrics[k] = cr.all_reduce(metrics[k], cr.axis_group(mesh, ax)) / float(n)
        return metrics, grads, None

    def add_slice(acc, part, m):
        # ``acc + part / m`` in slice order, as the reference's scan sums
        # from zeros (and 0 + v / m is v / m exactly).
        return {k: v / m if acc is None else acc[k] + v / m for k, v in part.items()}

    def train_step(params, opt_state, batch, expert_perm=None, wire_perm=None,
                   ef_residual=None):
        new_residual = None
        if microbatches <= 1:
            metrics, grads, new_residual = grad_once(params, batch, expert_perm, wire_perm,
                                                     ef_residual)
        else:
            b = batch["tokens"].shape[0]
            m = microbatches
            assert b % m == 0, (b, m)
            toks = batch["tokens"].reshape(m, b // m, -1)
            labs = batch["labels"].reshape(m, b // m, -1)
            metrics = grads = None
            for i in range(m):
                mi, gi, _ = grad_once(params, {"tokens": toks[i], "labels": labs[i]},
                                      expert_perm, wire_perm)
                metrics, grads = add_slice(metrics, mi, m), add_slice(grads, gi, m)
        gnorm = (_mesh_grad_norm(grads, plan, mesh, expert_perm, wire_perm, cfg)
                 if on_mesh and runtime_grads is None else None)
        params, opt_state, opt_metrics = adamw_update(params, _unflat(grads, params), opt_state,
                                                      opt_cfg, grad_norm=gnorm)
        if dp_compress:
            return params, opt_state, {**metrics, **opt_metrics}, new_residual
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def init_all(seed: int, cfg, plan: ShardingPlan, opt_cfg: AdamWConfig, *, device=None,
             mesh=None):
    """``(params, specs, opt_state)``: seeded parameters with
    ``requires_grad`` on every floating leaf (the f32 router included) and
    zero AdamW moments; over a ``mesh`` the rank's shard of them.  ``specs``
    is None: layouts are explicit in the port."""
    params = tfm.init_model(seed, cfg, plan, device=device, mesh=mesh)
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
            params, batch, cfg, plan, mesh=mesh, mode="prefill",
            expert_perm=expert_perm, wire_perm=wire_perm,
        )
        logits = tfm.logits_from_features(params, feats[:, -1:], cfg, plan, mesh)
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
    _attention_only(cfg, "chunked prefill")

    @torch.no_grad()
    def chunk_step(
        params, caches, tokens, t, expert_perm=None, wire_perm=None,
        gate_weights=None, page_table=None,
    ):
        feats, aux, caches = tfm.model_apply(
            params, {"tokens": tokens}, cfg, plan, mesh=mesh, mode="decode", caches=caches, t=t,
            expert_perm=expert_perm, wire_perm=wire_perm, gate_weights=gate_weights,
            page_table=page_table,
        )
        logits = _decode_logits(params, feats[:, -1:], cfg, plan, mesh)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        if with_stats:
            return next_tok, caches, aux.moe_stats
        return next_tok, caches

    return chunk_step


def make_serve_step(
    cfg, plan: ShardingPlan, mesh=None, *, sample: bool = False, with_stats: bool = False,
):
    """One decode step: ``tokens [B, 1]`` + caches -> next token ``[B, 1]``,
    greedy, or sampled when ``sample`` and ``rng`` is given: ``rng [B, 2]``
    draws each row on its own key, a single key ``[2]`` draws the whole
    batch with ``categorical``."""

    @torch.no_grad()
    def serve_step(
        params, caches, tokens, t, rng=None, expert_perm=None, wire_perm=None,
        gate_weights=None, page_table=None,
    ):
        feats, aux, caches = tfm.model_apply(
            params, {"tokens": tokens}, cfg, plan, mesh=mesh, mode="decode", caches=caches, t=t,
            expert_perm=expert_perm, wire_perm=wire_perm, gate_weights=gate_weights,
            page_table=page_table,
        )
        logits = _decode_logits(params, feats, cfg, plan, mesh)[:, -1]
        if sample and rng is not None:
            if rng.dim() == 2:  # [B, 2] per-slot keys (DESIGN.md §11)
                next_tok = _sample_rows(logits, rng)
            else:  # one key for the whole batch
                next_tok = prng.categorical(rng, logits.float())
        else:
            next_tok = torch.argmax(logits, dim=-1)
        next_tok = next_tok.to(torch.int32)[:, None]
        if with_stats:
            return next_tok, caches, aux.moe_stats
        return next_tok, caches

    return serve_step


def make_verify_step(
    cfg, plan: ShardingPlan, mesh=None, *, sample: bool = False, with_stats: bool = False,
):
    """Speculative VERIFY step (DESIGN.md §11): score a ``[B, C]`` causal
    continuation in one pass and emit the model's token at EVERY position.
    Position ``j`` consumes token ``j`` (the last accepted token at ``j = 0``,
    draft token ``j`` otherwise) and overwrites cache position ``t + j`` with
    the full model's K/V, so ``tokens[:, j]`` of the result is what serial
    decode would emit after the chunk prefix ``.. j``.  ``rng``:
    ``[B, C, 2]`` per-(slot, position) sample keys."""
    _attention_only(cfg, "speculative verify")

    @torch.no_grad()
    def verify_step(
        params, caches, tokens, t, rng=None, expert_perm=None, wire_perm=None,
        gate_weights=None, page_table=None,
    ):
        feats, aux, caches = tfm.model_apply(
            params, {"tokens": tokens}, cfg, plan, mesh=mesh, mode="decode", caches=caches, t=t,
            expert_perm=expert_perm, wire_perm=wire_perm, gate_weights=gate_weights,
            page_table=page_table,
        )
        logits = _decode_logits(params, feats, cfg, plan, mesh)  # [B, C, V]
        b, c, _ = logits.shape
        if sample and rng is not None:
            toks = _sample_rows(logits.reshape(b * c, -1), rng.reshape(b * c, 2)).reshape(b, c)
        else:
            toks = torch.argmax(logits, dim=-1)
        toks = toks.to(torch.int32)
        if with_stats:
            return toks, caches, aux.moe_stats
        return toks, caches

    return verify_step


def make_draft_loop_step(cfg, plan: ShardingPlan, mesh=None, *, k: int, sample: bool = False):
    """Speculative DRAFT loop (DESIGN.md §11): ``k`` greedy or sampled
    decode steps of the draft config (``models.moe.draft_config``), an eager
    loop where the reference fuses a ``lax.scan``.  The draft writes its K/V
    into the same paged pool at ``t .. t+k-1``; verify overwrites them.
    ``rng``: ``[B, k, 2]`` keys, the ones verify uses (common random
    numbers).  Returns the drafts ``[B, k]`` i32 and the caches; the
    draft's gate statistics are dropped, as the reference drops them."""
    _attention_only(cfg, "speculative drafting")

    @torch.no_grad()
    def draft_loop(
        params, caches, tokens, t, rng=None, expert_perm=None, wire_perm=None,
        gate_weights=None, page_table=None,
    ):
        b = tokens.shape[0]
        tok, drafts = tokens, []
        for i in range(k):
            feats, _, caches = tfm.model_apply(
                params, {"tokens": tok}, cfg, plan, mesh=mesh, mode="decode", caches=caches,
                t=t + i, expert_perm=expert_perm, wire_perm=wire_perm, gate_weights=gate_weights,
                page_table=page_table,
            )
            logits = _decode_logits(params, feats, cfg, plan, mesh)[:, -1]
            if sample:
                keys = rng[:, i] if rng is not None else torch.zeros(
                    (b, 2), dtype=torch.int64, device=logits.device)
                nxt = _sample_rows(logits, keys)
            else:
                nxt = torch.argmax(logits, dim=-1)
            tok = nxt.to(torch.int32)[:, None]
            drafts.append(tok)
        return torch.cat(drafts, dim=1), caches

    return draft_loop
