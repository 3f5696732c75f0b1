"""Pipeline parallelism: the GPipe schedule over a ``"stage"`` mesh axis.

Port of :mod:`repro.train.pipeline`.  The reference runs the schedule as
one SPMD program, a ``lax.scan`` over ``M + S - 1`` ticks whose transpose
is the reverse pipeline; its warmup and drain ticks feed zeros because
every stage must run every tick.  Here each rank is a process of its own,
so a stage runs exactly its ``M`` microbatches and no bubble tick at all
(the reference masks those ticks' outputs and telemetry, so nothing
observable changes):

* **forward**: stage ``s`` takes microbatch ``i`` (stage 0 from its
  inputs, every other stage from stage ``s - 1``), applies its layers and
  sends the output to stage ``s + 1``, for ``i = 0 .. M - 1``;
* **backward**: each stage differentiates its own graph of microbatch
  ``i`` against the output gradient (from stage ``s + 1``, or the loss on
  the last stage) and sends the input gradient to stage ``s - 1``, for
  ``i = 0 .. M - 1``.  Every graph is held until the backward, so the
  order is free; this one sums each leaf's gradient in the order the flat
  step accumulates its microbatches (``train_step.make_train_step``),
  so a bf16 gradient rounds as the flat step's does.  (Differentiated in
  reverse, as the reference's transposed scan runs, Mixtral's losses on
  the H100 drifted 1.2e-4 relative from the one-device trainer in 4
  steps.)

Transfers run over the stage axis's process group between ranks with the
same coordinates on every other axis (:func:`repro_torch.core.commruntime._exchange`:
staged through host memory under gloo, counted as ``cross_region`` wire
bytes).  Every rank of a stage's model group issues its model-axis
collectives and its stage transfers in one order, so the schedule cannot
deadlock.  :class:`GPipe` is the schedule the pipelined train step
(:mod:`repro_torch.train.pp_step`) drives; :func:`pipeline_apply` is the
reference's bare, differentiable schedule.
"""

from __future__ import annotations

import torch

from repro_torch.core import commruntime as cr

__all__ = ["num_ticks", "pipeline_apply", "GPipe", "broadcast_from"]


def num_ticks(num_microbatches: int, num_stages: int) -> int:
    """The reference's tick count: every microbatch plus the pipe's fill."""
    return num_microbatches + num_stages - 1


def _send(t: torch.Tensor, peer: int, group) -> None:
    cr._exchange({peer: t}, {}, group)


def _recv(like: torch.Tensor, peer: int, group) -> torch.Tensor:
    buf = torch.empty_like(like)
    cr._exchange({}, {peer: buf}, group)
    return buf


def broadcast_from(t: torch.Tensor | None, root: int, like: torch.Tensor, mesh,
                   axis: str = "stage") -> torch.Tensor:
    """Stage ``root``'s ``t`` on every stage (``like`` gives the others its
    shape and dtype): point-to-point sends from the root, so every rank
    holds the root's bits."""
    s, n = cr.axis_index(mesh, axis), cr.axis_size(mesh, axis)
    if n == 1:
        return t
    group = cr.axis_group(mesh, axis)
    if s == root:
        cr._exchange({peer: t for peer in range(n) if peer != root}, {}, group)
        return t
    return _recv(like, root, group)


class GPipe:
    """One step of the schedule on this rank: :meth:`forward` over the ``M``
    microbatches, then :meth:`backward` over them again.  It keeps each
    microbatch's graph between the two (with ``cfg.remat`` only each
    repeat's input)."""

    def __init__(self, mesh, num_microbatches: int, axis: str = "stage"):
        self.m = num_microbatches
        self.stage = cr.axis_index(mesh, axis)
        self.stages = cr.axis_size(mesh, axis)
        self.group = cr.axis_group(mesh, axis) if self.stages > 1 else None
        self.first = self.stage == 0
        self.last = self.stage == self.stages - 1
        self.xs: list = []
        self.ys: list = []

    def forward(self, stage_fn, inputs, like: torch.Tensor, *, input_grad: bool = True):
        """Run ``stage_fn(x, i) -> (y, extra)`` on each microbatch, ``y``
        of ``like``'s shape and dtype.  ``inputs``: the first stage's ``M``
        inputs (ignored on the others).  ``input_grad``: keep the first
        stage's input gradients (the others always send theirs back).
        Returns the ``M`` outputs and extras (the last stage's outputs are
        the pipeline's)."""
        extras = []
        for i in range(self.m):
            if self.first:
                x = inputs[i].detach()
            else:
                x = _recv(like, self.stage - 1, self.group)
            x.requires_grad_(input_grad or not self.first)
            with torch.enable_grad():
                y, extra = stage_fn(x, i)
            if not self.last:
                _send(y, self.stage + 1, self.group)
            self.xs.append(x)
            self.ys.append(y)
            extras.append(extra)
        return self.ys, extras

    def backward(self, wrt: list, out_grads=None, extra_terms=None):
        """The backward schedule, microbatch 0 first.  ``wrt``: this
        stage's leaves; ``out_grads``: the last stage's gradient of each
        output;
        ``extra_terms(i)``: ``[(scalar, weight), ...]`` added to microbatch
        ``i``'s backward (the stage's own loss terms).  Returns each leaf's
        gradient summed over the microbatches in order (None where no
        microbatch reached it) and, on the first stage, each
        microbatch's input gradient (None where not kept)."""
        acc = [None] * len(wrt)
        in_grads = [None] * self.m
        for i in range(self.m):
            y, x = self.ys[i], self.xs[i]
            g = out_grads[i] if self.last else _recv(y, self.stage + 1, self.group)
            outs, gouts = [y], [g]
            for term, weight in (extra_terms(i) if extra_terms is not None else ()):
                if term.requires_grad:
                    outs.append(term)
                    gouts.append(torch.full_like(term, weight))
            want_x = x.requires_grad
            got = torch.autograd.grad(outs, [*wrt, x] if want_x else wrt, gouts,
                                      allow_unused=True)
            for j, gj in enumerate(got[:len(wrt)]):
                if gj is not None:
                    acc[j] = gj if acc[j] is None else acc[j] + gj
            if want_x:
                if self.first:
                    in_grads[i] = got[-1]
                else:
                    _send(got[-1], self.stage - 1, self.group)
            # This microbatch's graph is spent.
            self.ys[i] = self.xs[i] = None
        return acc, in_grads


def _flat_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _rebuild(tree, leaves: dict, prefix=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}/{k}") for k, v in tree.items()}
    return leaves[prefix]


class _PipelineFn(torch.autograd.Function):
    """The schedule as one differentiable op on every rank: forward returns
    the last stage's outputs everywhere; backward takes the last stage's
    output gradient (every rank computes the same loss from the same
    outputs, so the others' copies are not summed) through the backward
    schedule to this rank's stage parameters, and the first stage's input
    gradient to every rank."""

    @staticmethod
    def forward(ctx, stage_fn, tree, paths, mesh, axis, mbs, *leaves):
        pipe = GPipe(mesh, mbs.shape[0], axis)
        alias = {p: t.detach().requires_grad_(t.requires_grad) for p, t in zip(paths, leaves)}
        params = _rebuild(tree, alias)
        ys, _ = pipe.forward(lambda x, i: (stage_fn(params, x), None), list(mbs.unbind(0)),
                             mbs[0], input_grad=ctx.needs_input_grad[5])
        out = torch.stack([y.detach() for y in ys]) if pipe.last else None
        ctx.pipe, ctx.alias, ctx.paths, ctx.mesh, ctx.axis = pipe, alias, paths, mesh, axis
        return broadcast_from(out, pipe.stages - 1, torch.empty_like(mbs), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        pipe = ctx.pipe
        wrt = [ctx.alias[p] for p in ctx.paths if ctx.alias[p].requires_grad]
        grads, in_grads = pipe.backward(wrt, list(g.unbind(0)) if pipe.last else None)
        by_path = dict(zip([p for p in ctx.paths if ctx.alias[p].requires_grad], grads))
        leaf_grads = [by_path.get(p) for p in ctx.paths]
        dmbs = None
        if ctx.needs_input_grad[5]:
            dmbs = torch.stack(in_grads) if pipe.first else None
            dmbs = broadcast_from(dmbs, 0, g, ctx.mesh, ctx.axis)
        return (None, None, None, None, None, dmbs, *leaf_grads)


def pipeline_apply(stage_fn, stage_params, microbatches: torch.Tensor, mesh, *,
                   axis: str = "stage") -> torch.Tensor:
    """Run ``microbatches [M, mb, ...]`` through a GPipe pipeline.

    ``stage_fn(params, x) -> y`` is applied by every stage to its resident
    activation (``y`` of ``x``'s shape: homogeneous stages).
    ``stage_params``: THIS rank's stage's parameters (a dict tree; the
    reference's ``[S, ...]`` leaves' row ``s``).  ``microbatches``: the same
    ``[M, mb, ...]`` on every rank.  Returns the last stage's ``[M, mb,
    ...]`` outputs on every rank, differentiable: the backward schedule
    takes the gradient to every stage's parameters (and to
    ``microbatches``)."""
    paths, leaves = zip(*_flat_leaves(stage_params)) if stage_params else ((), ())
    return _PipelineFn.apply(stage_fn, stage_params, list(paths), mesh, axis, microbatches,
                             *leaves)
