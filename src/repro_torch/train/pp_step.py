"""Pipeline-parallel train step: the GPipe schedule of
:mod:`repro_torch.train.pipeline` composed with the MoE data plane.

Port of :mod:`repro.train.pp_step`.  One process per rank of a
``("stage", "model")`` (or ``("stage", "data", "model")``) mesh:

* **A stage holds its layers.**  Rank ``(s, ...)`` holds the contiguous
  repeats ``[s * L / S, (s + 1) * L / S)`` in the canonical ``[repeats,
  ...]`` leaf layout with its model-axis shard of the experts
  (``models.transformer.init_model`` over the mesh); stage 0 also holds
  ``embed``, the last stage ``final_norm`` and ``lm_head``.  A leaf a stage
  does not hold is not in its parameters, so not in its AdamW state.  A
  tied head is the embedding: the last stage holds a copy, and after the
  backward the two ends exchange their parts of its gradient (the lookup's
  and the head's) and sum them in one order, so both copies take the same
  update and stay equal, as PP(1)'s one embedding.
* **Inside a stage the data plane is the flat step's.**  Every microbatch
  runs ``transformer.apply_layers`` over the stage's repeats with their
  rows of ``expert_perm``/``wire_perm``: attention and the MLP
  tensor-parallel over the model group (the rank's heads and columns, or
  whole where the sizes do not divide it), the mixnet MoE layer on the
  rank's token slice (dispatch all-to-all, ``overlap_chunks``, wire
  re-addressing), per-shard aux losses as the reference's stage body.
  The embedding and the head are vocab-parallel inside their stages; a
  tied embedding's two copies hold the same vocab rows, so their gradient
  parts pair up rank by rank.
* **One loss.**  The last stage concatenates the ``M`` outputs and takes
  the final norm and ONE full-batch chunked cross entropy, as the
  reference's single ``value_and_grad`` does (``pp_step.py:401-413``).  The
  aux losses are linear in the per-(layer, microbatch) terms, so each stage
  backpropagates its own terms with their constant weights
  (``balance_loss / (repeats * M)``, ``router_z_loss / (repeats * M)``) in
  its backward instead of shipping graphs across stages.
* **Every rank reports the same bits.**  The per-layer aux means and the
  loads are gathered over the stage axis into the canonical ``[repeats]``
  / ``[repeats, E]`` order on every rank; the loss and cross entropy are
  sent from the last stage.
* **The clipping norm is the whole model's**, summed in the canonical
  (leaf, repeat) order on every rank from per-repeat squares gathered over
  the stage axis (the experts' in logical expert order), so PP(S) and
  PP(1) clip by the same norm bit for bit.
* **ZeRO-3 inside a stage** (a plan with ``fsdp_axis`` over a ``"data"``
  axis of the mesh, as the reference's ``_stage_leaf_spec`` and
  ``_gather_ffn``, ``pp_step.py:118-135``, ``:180-226``): a stage holds
  its data shards and gathers its block leaves whole once a step
  (``fsdp.gather_stage``); their gradients are summed over the
  microbatches, then reduce-scattered once, so the ZeRO-3 stages equal the
  replicated stages bit for bit.  With ``cfg.fsdp_prefetch`` the FFN leaves
  stay shards and ``transformer.apply_layers`` ring-gathers them layer by
  layer inside each microbatch (reduce-scattered there, each microbatch
  on its own: within rounding of the replicated stages).  The ends gather
  theirs where they are used.

The DP reduction over a data axis is ``train_step.reduce_grads``.
``batch`` is this rank's rows, microbatch-major: row ``j`` of microbatch
``i`` of the global batch's data slice is local row ``i * mb_local + j``
(:func:`local_microbatch_rows`), the rows the reference's microbatch
spec gives the rank.
"""

from __future__ import annotations

import torch

from repro_torch.core import commruntime as cr
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.parallel import fsdp
from repro_torch.parallel.sharding import ShardingPlan, TreeLayout, stage_layers, virtual_experts
from repro_torch.train.pipeline import GPipe, broadcast_from
from repro_torch.train.train_step import (
    _flat,
    _physical_slots,
    _unflat,
    data_summed,
    grad_kind,
    leaf_squares,
    model_summed,
    reduce_grads,
)

__all__ = ["make_pp_train_step", "local_microbatch_rows"]

# The leaves outside the block stack, in canonical (sorted path) order, and
# the stage that holds each: -1 is the last.
_END_LEAVES = (("/embed", 0), ("/final_norm", -1), ("/lm_head", -1))


def _validate(cfg, plan, mesh, pp_stages, stage_axis):
    if mesh is None or stage_axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"pp_stages={pp_stages} needs a mesh with a {stage_axis!r} axis")
    size = cr.axis_size(mesh, stage_axis)
    if size != pp_stages:
        raise ValueError(f"mesh {stage_axis!r} axis is {size}, pp_stages is {pp_stages}")
    if cfg.pattern_repeats % pp_stages:
        raise ValueError(
            f"{cfg.pattern_repeats} block repeats not divisible by {pp_stages} stages")
    bad = [k for k in cfg.block_pattern if k not in ("global", "local")]
    if bad or cfg.tail_pattern or cfg.encoder_layers or cfg.vision_patches:
        raise NotImplementedError(
            "pipeline-parallel stages support attention(+MLP/MoE) block patterns only "
            f"(got pattern={cfg.block_pattern}, tail={cfg.tail_pattern})")
    if cfg.is_moe:
        if cfg.moe.backend != "mixnet":
            raise NotImplementedError(
                f"PP composes with the mixnet MoE data plane only (backend={cfg.moe.backend!r})")
        if cfg.moe.num_shared_experts:
            raise NotImplementedError("shared experts are not wired through the PP stage body yet")
        p = max(plan.model_size, 1)
        if p > 1 and cfg.moe.num_experts % p:
            raise NotImplementedError(
                f"PP stages shard the expert dim over the model axis; {cfg.moe.num_experts} "
                f"experts do not divide over {p} devices (virtual-expert replication is not "
                "wired through the stage body)")


def local_microbatch_rows(a, plan: ShardingPlan, mesh, microbatches: int):
    """This rank's rows of a global ``[B, ...]`` batch for the pipelined
    step: each microbatch's data-axis slice, microbatch-major."""
    if mesh is None or not plan.batch_axes:
        return a
    b = a.shape[0]
    if b % microbatches:
        raise ValueError(f"batch {b} not divisible by {microbatches} microbatches")
    a = a.reshape(microbatches, b // microbatches, *a.shape[1:])
    for ax in plan.batch_axes:
        n = cr.axis_size(mesh, ax)
        if a.shape[1] % n:
            raise ValueError(f"microbatch {a.shape[1]} not divisible by the {ax} axis ({n})")
        k = a.shape[1] // n
        i = cr.axis_index(mesh, ax)
        a = a[:, i * k:(i + 1) * k]
    return a.reshape(-1, *a.shape[2:])


def _tied_embed_grad(lookup, head, pipe: GPipe) -> torch.Tensor:
    """A tied embedding's gradient on the first and the last stage: the
    lookup's part plus the head's, summed in that order on both, so the two
    copies (and PP(1)'s one) take the same bits.  Over more than one stage
    the ends swap their parts in one p2p exchange over the stage axis."""
    if pipe.stages > 1:
        mine = lookup if pipe.first else head
        other = torch.empty(mine.shape, dtype=mine.dtype, device=mine.device)
        peer = pipe.stages - 1 if pipe.first else 0
        cr._exchange({peer: mine}, {peer: other}, pipe.group)
        lookup, head = (mine, other) if pipe.first else (other, mine)
    return lookup + head


def _repeat_squares(grads: dict, plan, mesh, perm, wire, layout) -> list:
    """Per block leaf (sorted path order), per repeat, the f64 sum of its
    gradient's squares (``train_step.leaf_squares``: a ZeRO-3 shard's summed
    over the data axis in rank order); a tensor-parallel leaf's summed over
    the model axis in rank order, an expert leaf's slots gathered over the
    model axis and read in logical expert order
    (``train_step._mesh_grad_norm``)."""
    out, tensors, shards = [], [], []
    for path in sorted(k for k in grads if k.startswith("/blocks/")):
        g = grads[path]
        kind = grad_kind(path, layout)
        sharded = layout.fsdp_dim(path) is not None
        if kind != "expert":
            rows = range(len(out), len(out) + len(g))
            if kind == "tensor":
                tensors.extend(rows)
            if sharded:
                shards.extend(rows)
            out.extend(leaf_squares(row, path, layout, lead=1) for row in g)
            continue
        sq = torch.stack([torch.stack([leaf_squares(e, path, layout, lead=2) for e in layer])
                          for layer in g])
        if sharded:
            sq = data_summed([sq], [0], plan, mesh)[0]
        if plan.model_size > 1:
            sq = cr.all_gather_raw(sq.t().contiguous(), cr.axis_group(mesh, plan.model_axis)).t()
        slots = _physical_slots(perm, wire, sq.shape, g.device)
        out.extend(torch.sum(torch.gather(row, 0, idx)) for row, idx in zip(sq, slots))
    return model_summed(data_summed(out, shards, plan, mesh), tensors, plan, mesh)


def _pp_grad_norm(grads: dict, plan, mesh, stage_axis: str, reps_local: int, perm, wire,
                  layout) -> torch.Tensor:
    """The whole model's gradient norm, the same bits on every rank and for
    every stage count: per-repeat squares gathered over the stage axis,
    summed in canonical (leaf, repeat) order, then the end leaves from the
    stage that holds each (a leaf no stage holds adds an exact zero)."""
    n = cr.axis_size(mesh, stage_axis)
    vals = _repeat_squares(grads, plan, mesh, perm, wire, layout)
    k = len(vals)
    dev = next(iter(grads.values())).device
    ends = [leaf_squares(grads[path], path, layout) if path in grads
            else torch.zeros((), dtype=torch.float64, device=dev) for path, _ in _END_LEAVES]
    # A ZeRO-3 end's shards summed over the data axis, a vocab-parallel
    # end's parts over the model axis (every rank joins, holding the leaf or
    # not: a data or model group lies in one stage).
    ends = data_summed(ends, [i for i, (path, _) in enumerate(_END_LEAVES)
                              if layout.fsdp_dim(path) is not None], plan, mesh)
    ends = model_summed(ends, [i for i, (path, _) in enumerate(_END_LEAVES)
                               if grad_kind(path, layout) == "tensor"], plan, mesh)
    table = torch.stack([*vals, *ends]).reshape(1, -1)
    if n > 1:
        table = cr.all_gather_raw(table, cr.axis_group(mesh, stage_axis))
    total = None
    for j in range(0, k, reps_local):  # leaf-major, repeats in global order
        for q in range(n):
            for v in table[q, j:j + reps_local]:
                total = v if total is None else total + v
    for e, (_, owner) in enumerate(_END_LEAVES):
        v = table[owner % n, k + e]
        total = v if total is None else total + v
    return torch.sqrt(total).float()


def make_pp_train_step(
    cfg,
    plan: ShardingPlan,
    opt_cfg: AdamWConfig,
    mesh,
    *,
    pp_stages: int,
    microbatches: int = 1,
    stage_axis: str = "stage",
):
    """``(params, opt_state, batch, expert_perm, wire_perm) -> (params,
    opt_state, metrics)`` with the block repeats pipelined over
    ``pp_stages`` stages, updating this rank's ``params`` and ``opt_state``
    in place.  ``expert_perm`` / ``wire_perm`` are the canonical ``[repeats,
    ...]`` stacks (every rank holds them whole; the step takes its stage's
    rows).  ``plan`` is ``make_plan(mesh)``: the stage axis is invisible to
    it.  Metrics: ``loss``, ``ce``, ``balance_loss``,
    ``z_loss``, ``expert_load [repeats, E]`` and AdamW's."""
    _validate(cfg, plan, mesh, pp_stages, stage_axis)
    m = microbatches
    reps = cfg.pattern_repeats
    _, n, lo, hi = stage_layers(mesh, reps, stage_axis)
    p_model = max(plan.model_size, 1)
    ev = virtual_experts(cfg.moe.num_experts, p_model)[0] if cfg.is_moe else 1
    on_mesh = plan.model_size > 1 or plan.data_size > 1
    layout = TreeLayout(plan, mesh, cfg)
    dtype = getattr(torch, cfg.dtype)
    w_bal = cfg.moe.balance_loss / (reps * m) if cfg.is_moe else 0.0
    w_z = cfg.moe.router_z_loss / (reps * m) if cfg.is_moe else 0.0

    def train_step(params, opt_state, batch, expert_perm=None, wire_perm=None):
        tokens, labels = batch["tokens"], batch["labels"]
        b, t_len = tokens.shape
        if b % m:
            raise ValueError(f"batch {b} not divisible by {m} microbatches")
        if p_model > 1 and t_len % p_model:
            raise ValueError(f"seq {t_len} must divide the model axis {p_model} for the "
                             "sequence-sharded MoE region of a stage")
        mb = b // m
        dev = tokens.device
        perm = wire = None
        if cfg.is_moe:
            perm = (torch.arange(ev, dtype=torch.int32, device=dev).expand(reps, ev)
                    if expert_perm is None else torch.as_tensor(expert_perm, device=dev))
            perm = perm[lo:hi]
            if wire_perm is not None:
                wire = torch.as_tensor(wire_perm, dtype=torch.int32, device=dev)[lo:hi]
        pipe = GPipe(mesh, m, stage_axis)
        leaves = dict(_flat(params))
        wrt = [k for k, t in leaves.items() if t.requires_grad]
        stage_blocks, whole = fsdp.gather_stage(params["blocks"], "/blocks", cfg, plan, mesh,
                                                keep_ffn=cfg.fsdp_prefetch)

        inputs = x_emb = None
        if pipe.first:
            with torch.enable_grad():
                x_emb = tfm.embed(params, tokens, cfg, plan, mesh)
            inputs = x_emb.detach().reshape(m, mb, t_len, cfg.d_model).unbind(0)
        like = torch.empty((mb, t_len, cfg.d_model), dtype=dtype, device=dev)

        def stage_fn(x, _):
            return tfm.apply_layers(stage_blocks, x, cfg, plan, mesh=mesh, mode="train",
                                    expert_perm=perm, wire_perm=wire, per_shard=True)

        ys, outs = pipe.forward(stage_fn, inputs, like,
                                input_grad=leaves["/embed"].requires_grad if pipe.first else True)

        grads: dict = {}
        out_grads = ce = None
        if pipe.last:
            feats_in = torch.cat([y.detach() for y in ys]).requires_grad_()
            ends = [k for k in ("/final_norm", "/lm_head") if k in wrt]
            if cfg.tie_embeddings and "/embed" in wrt:
                ends.append("/embed")
            with torch.enable_grad():
                feats = tfm.final_norm(params, feats_in, cfg, L.norm_tree(feats_in))
                ce = tfm.chunked_cross_entropy(params, feats, labels, cfg, plan=plan, mesh=mesh)
                got = torch.autograd.grad(ce, [leaves[k] for k in ends] + [feats_in])
            grads.update(zip(ends, got[:-1]))
            out_grads = got[-1].reshape(m, mb, t_len, cfg.d_model).unbind(0)
            ce = ce.detach()

        def aux_terms(i):
            o = outs[i]
            return [t for li in range(hi - lo) for t in ((o.balance[li], w_bal), (o.z[li], w_z))]

        blocks = [k for k in wrt if k.startswith("/blocks/")]
        got, in_grads = pipe.backward([whole[k][0] if k in whole else leaves[k] for k in blocks],
                                      out_grads, aux_terms if cfg.is_moe else None)
        grads.update((k, g if g is None or k not in whole
                      else fsdp.scatter_grad(g, whole[k][1], plan, mesh))
                     for k, g in zip(blocks, got))
        head = grads.pop("/embed", None)  # the tied head's part, on the last stage
        lookup = None
        if pipe.first and "/embed" in wrt:
            lookup, = torch.autograd.grad(x_emb, leaves["/embed"], torch.cat(in_grads))
        if "/embed" in wrt:
            grads["/embed"] = (_tied_embed_grad(lookup, head, pipe) if cfg.tie_embeddings
                               else lookup)
        for k, t in leaves.items():
            if grads.get(k) is None:
                grads[k] = torch.zeros_like(t)

        # Telemetry: per-layer means over the microbatches, the loads summed.
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        bal, zl, loads = [], [], []
        for li in range(hi - lo):
            bacc = zacc = zero
            lacc = None
            for o in outs:
                bacc = bacc + o.balance[li].detach() / m
                zacc = zacc + o.z[li].detach() / m
                if o.loads[li] is not None:
                    lacc = o.loads[li] if lacc is None else lacc + o.loads[li]
            bal.append(bacc)
            zl.append(zacc)
            loads.append(lacc)
        stage_grp = cr.axis_group(mesh, stage_axis) if n > 1 else None
        aux = torch.stack([*bal, *zl]).reshape(1, 2, hi - lo)
        if n > 1:
            aux = cr.all_gather_raw(aux, stage_grp)
        bal_mean = torch.mean(aux[:, 0].reshape(reps))
        z_mean = torch.mean(aux[:, 1].reshape(reps))

        if on_mesh:
            grads = reduce_grads(grads, plan, mesh, cfg)
        gnorm = _pp_grad_norm(grads, plan, mesh, stage_axis, hi - lo, perm, wire, layout)
        params, opt_state, opt_metrics = adamw_update(params, _unflat(grads, params), opt_state,
                                                      opt_cfg, grad_norm=gnorm)

        head = None
        if pipe.last:
            for ax in plan.batch_axes:
                k = cr.axis_size(mesh, ax)
                if k > 1:
                    ce = cr.all_reduce(ce, cr.axis_group(mesh, ax)) / float(k)
            loss = ce
            if cfg.is_moe:
                loss = loss + cfg.moe.balance_loss * bal_mean
                loss = loss + cfg.moe.router_z_loss * z_mean
            head = torch.stack([loss, ce])
        head = broadcast_from(head, n - 1, torch.empty(2, dtype=torch.float32, device=dev),
                              mesh, stage_axis)
        metrics = {"loss": head[0], "ce": head[1], "balance_loss": bal_mean, "z_loss": z_mean,
                   **opt_metrics}
        if cfg.is_moe:
            load = torch.stack(loads)
            if n > 1:
                load = cr.all_gather_raw(load, stage_grp)
            metrics["expert_load"] = load
        return params, opt_state, metrics

    return train_step
