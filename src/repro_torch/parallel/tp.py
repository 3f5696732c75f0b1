"""Megatron tensor parallelism over the model axis: the collectives and the
vocab-parallel pieces.

The reference lets GSPMD insert these collectives around its sharded
leaves (``sharding.py:1-12``); the port writes them out.  Inside a model
group the residual stream is replicated: every rank holds the same
activations, and the same full gradient of them.  A tensor-parallel block
runs its input through the rank's columns (:func:`column_parallel`: the
backward sums the partial input gradients in f32 and casts once), runs the
rank's heads or columns, and hands its row-parallel f32 partial
(:func:`partial_mm`) to :func:`across`, which sums the ranks' partials,
cast once after the sum (identity backward): bf16 partials rounded before
the sum would leave one device's bits in many more elements
(``chip_smoke.py`` phase 14f prints both).  Each such sum is a fixed tree
(TREE_LEAVES, below) that one device takes too, in training and serving
alike, so at P = 1, 2 and 4 a rank's products and sums are one device's.
:func:`copy_to_model` is the plain pair of the identity and an f32
all-reduce of the gradient, for inputs read through other products.  Every
collective goes through :mod:`repro_torch.core.commruntime`, so its bytes
are counted under the model axis's link class, and a failed collective
raises.

Sequence parallelism (``cfg.sp_shardmap``, the reference's
``mlp_apply_sp`` / ``oproj_sp``, ``layers.py:565-641``): the residual
stream lives sequence-sharded over the model axis, each rank holding its
``[B, S / P, D]`` slice.  A block's input is :func:`seq_gather`-ed into the
whole sequence before its column products (the backward sums the ranks'
f32 input-gradient partials of the rank's slice as the same tree and casts
once), and its row-parallel f32 partial is :func:`seq_scatter`-ed: one
all-to-all of the f32 sequence shares, the tree over rank order on the
rank's share, cast once.  Every element is summed exactly as
:func:`across` sums it, so the stream's slices are the replicated
stream's bits, and no all-gather of the casts follows.

The vocab-parallel pieces: :func:`vocab_embed` (a masked local lookup plus
an all-reduce, exact: one rank contributes each row), :func:`vocab_cross_entropy`
(the max, the sum of exponentials and the target's logit all-reduced; the
backward is softmax minus one-hot on the local slice) and
:func:`gather_vocab` (the logits all-gathered to the whole vocabulary, for
serving; its backward keeps the rank's slice).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import commruntime as cr

__all__ = [
    "enabled", "model_group", "model_rank", "copy_to_model", "reduce_from_model",
    "column_parallel", "partial_mm", "across", "TREE_LEAVES", "leaves", "vocab_embed",
    "vocab_cross_entropy", "gather_vocab", "seq_gather", "seq_scatter",
]


def enabled(plan, mesh) -> bool:
    """True when ``plan`` has a model axis of more than one rank over
    ``mesh``: the layer's leaves are then the rank's shards wherever
    :class:`~repro_torch.parallel.sharding.TreeLayout` shards them."""
    return (mesh is not None and plan is not None and plan.model_axis is not None
            and plan.model_size > 1)


def model_group(plan, mesh):
    return cr.axis_group(mesh, plan.model_axis)


def model_rank(plan, mesh) -> int:
    return cr.axis_index(mesh, plan.model_axis)


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward sums the ranks' partial gradients in f32 and
    casts once after the sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return cr.all_reduce(g.float(), ctx.group).to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum of the ranks' partials; the backward is the identity (every
    rank holds the same full gradient of the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        return cr.all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, plan, mesh) -> torch.Tensor:
    """A tensor-parallel block's replicated input (or a replicated weight
    the rank reads only part of): the backward all-reduces its gradient
    over the model axis."""
    return _CopyToModel.apply(x, model_group(plan, mesh))


def reduce_from_model(x: torch.Tensor, plan, mesh) -> torch.Tensor:
    return _ReduceFromModel.apply(x, model_group(plan, mesh))


# Every sum whose terms a model axis splits is taken as a fixed binary tree
# over TREE_LEAVES blocks of its reduced dimension: a rank of P holds
# TREE_LEAVES / P contiguous leaves and sums them first, the ranks' sums are
# summed in rank order as the rest of the tree (``_across``), and one device
# sums all the leaves alike; so at P = 1, 2 and 4 the ranks and one device
# add the same f32 terms in the same order and round once.  Each leaf is a
# contiguous product of the same shape on every side, which the library
# computes alike (its column blocks too).  A model axis of 8 or 16 sums in
# rank order only: within rounding of one device, not its bits.
TREE_LEAVES = 4


def leaves(p: int) -> int:
    """The tree leaves each of ``p`` ranks holds (1 where ``p`` does not
    divide TREE_LEAVES: the sums then follow rank order only)."""
    return TREE_LEAVES // p if TREE_LEAVES % p == 0 else 1


_tree = cr.tree_sum


def _mm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` accumulated in f32 and rounded once, to f32."""
    if a.dtype == torch.float32:
        return a @ w
    if a.is_cuda:
        return torch.mm(a, w, out_dtype=torch.float32)
    return a.float() @ w.float()


def _blocked_mm(a: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """``a [M, K] @ w [K, N]`` in f32 as the tree of ``n`` contiguous
    K-block products (one product where ``n`` does not divide K)."""
    k = a.shape[1]
    if n <= 1 or k % n:
        return _mm_f32(a, w)
    k //= n
    return _tree([_mm_f32(a[:, i * k:(i + 1) * k].contiguous(), w[i * k:(i + 1) * k])
                  for i in range(n)])


def _across(x: torch.Tensor, group, dtype=None) -> torch.Tensor:
    """The ranks' f32 ``x`` summed as the tree over rank order and cast to
    ``dtype`` (None: kept f32) once, the same bits on every rank; ``x``
    itself without a group.  Every rank's partial is all-gathered and
    summed on every rank: one collective (a fixed-order reduce-scatter of
    f32 shares and an all-gather of the casts moves fewer bytes, but ran
    slower through gloo on the card: ``PERF.md``)."""
    if group is None:
        return x if dtype is None else x.to(dtype)
    out = _tree(list(cr.all_gather_raw(x[None], group).unbind(0)))
    return out if dtype is None else out.to(dtype)


def _leaf_sums(gs, ws, n: int) -> torch.Tensor:
    """``sum_i g_i @ w_i^T`` in f32 as the tree of ``n`` leaves, leaf ``j``
    the sum over ``i`` of the products of the ``j``-th column blocks of
    ``g_i`` and ``w_i`` (one leaf where ``n`` does not divide a width)."""
    if n <= 1 or any(w.shape[1] % n for w in ws):
        n = 1
    out = []
    for j in range(n):
        leaf = None
        for g, w in zip(gs, ws):
            k = w.shape[1] // n
            t = _mm_f32(g[:, j * k:(j + 1) * k].contiguous(), w[:, j * k:(j + 1) * k].t())
            leaf = t if leaf is None else leaf + t
        out.append(leaf)
    return _tree(out)


class _ColumnParallel(torch.autograd.Function):
    """``x [M, K]`` through column blocks ``w_i [K, N_i]``: ``y_i = x @
    w_i``, ``x`` taken in the blocks' dtype.  The backward sums the input
    gradients ``g_i @ w_i^T`` as one tree over the columns
    (:func:`_leaf_sums` of the rank's ``n`` leaves, then the ranks') and
    casts once to ``x``'s dtype (an f32 ``x``, :func:`seq_gather`'s, gets
    the f32 partial); ``dw_i = x^T g_i`` as autograd's."""

    @staticmethod
    def forward(ctx, x, group, n, *ws):
        ctx.group, ctx.n, ctx.dtype = group, n, x.dtype
        x = x.to(ws[0].dtype)
        ctx.save_for_backward(x, *ws)
        return tuple(x @ w for w in ws)

    @staticmethod
    def backward(ctx, *gs):
        x, *ws = ctx.saved_tensors
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _across(_leaf_sums(gs, ws, ctx.n), ctx.group, ctx.dtype)
        dws = [x.t() @ g if need else None for g, need in zip(gs, ctx.needs_input_grad[3:])]
        return (dx, None, None, *dws)


def column_parallel(x: torch.Tensor, ws, plan=None, mesh=None, *, reduce: bool = True
                    ) -> tuple:
    """``x [M, K]`` through each of the column blocks ``ws`` (a block's
    input products), the input gradient summed as one f32 tree over their
    columns and cast once; with ``plan`` and ``mesh``, ``ws`` are the
    rank's shards and the tree runs over the model axis too, unless not
    ``reduce``: then the rank's f32 partial of the input gradient returns
    (``x`` is :func:`seq_gather`'s, whose backward sums the partials)."""
    if mesh is None:
        return _ColumnParallel.apply(x, None, TREE_LEAVES, *ws)
    return _ColumnParallel.apply(x, model_group(plan, mesh) if reduce else None,
                                 leaves(plan.model_size), *ws)


class _PartialMM(torch.autograd.Function):
    """``a [M, K] @ w [K, N]`` with an f32 result, the tree of ``n`` K-block
    products (the row-parallel partial); the backward takes the gradient in
    the operands' dtype, as one device's product of that dtype does."""

    @staticmethod
    def forward(ctx, a, w, n):
        ctx.save_for_backward(a, w)
        return _blocked_mm(a, w, n)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        g = g.to(a.dtype)
        da = g @ w.t() if ctx.needs_input_grad[0] else None
        dw = a.t() @ g if ctx.needs_input_grad[1] else None
        return da, dw, None


def partial_mm(a: torch.Tensor, w: torch.Tensor, n: int = 1) -> torch.Tensor:
    return _PartialMM.apply(a, w, n)


class _Across(torch.autograd.Function):
    """:func:`_across` of the ranks' partials; the backward is the identity
    (every rank holds the same full gradient of the sum)."""

    @staticmethod
    def forward(ctx, x, group, dtype):
        return _across(x, group, dtype)

    @staticmethod
    def backward(ctx, g):
        return g.float(), None, None


def across(partial: torch.Tensor, plan, mesh, dtype) -> torch.Tensor:
    """The ranks' f32 partials (a row-parallel product's: the rank's tree
    leaves summed by :func:`partial_mm`) summed over the model axis as the
    rest of the tree and cast to ``dtype`` once, the same bits on every
    rank (identity backward)."""
    return _Across.apply(partial, model_group(plan, mesh), dtype)


def _seq_scatter_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``[B, S, ...]`` f32 partials -> this rank's ``[B, S / P, ...]`` of
    their sum over ``group``: one all-to-all of the sequence shares, then
    :func:`_tree` over rank order (f32)."""
    p = dist.get_world_size(group)
    xs = x.transpose(0, 1).contiguous()  # [S, B, ...]: the shares are rows
    got = cr._a2a_raw(xs, group).wait().reshape(p, xs.shape[0] // p, *xs.shape[1:])
    return _tree(list(got.unbind(0))).transpose(0, 1)


def _seq_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``[B, S / P, ...]`` slices -> ``[B, S, ...]`` in rank order."""
    full = cr.all_gather_raw(x.transpose(0, 1).contiguous(), group)
    return full.transpose(0, 1).contiguous()


class _SeqGather(torch.autograd.Function):
    """The ranks' sequence slices all-gathered, upcast to f32 (exactly);
    the backward sums the ranks' f32 partials of this rank's slice
    (:func:`_seq_scatter_sum`) and casts once to the slice's dtype."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.dtype = group, x.dtype
        return _seq_all_gather(x, group).float()

    @staticmethod
    def backward(ctx, g):
        return _seq_scatter_sum(g.float(), ctx.group).to(ctx.dtype), None


def seq_gather(x: torch.Tensor, plan, mesh) -> torch.Tensor:
    """A sequence-parallel block's input: the rank's ``[B, S / P, D]``
    slice -> the whole ``[B, S, D]``, in f32 (the values of ``x``'s dtype),
    for :func:`column_parallel` ``(..., reduce=False)``: the input
    gradient's f32 partials come back here and are summed over the model
    axis as the tree :func:`across` takes, for the rank's slice only, and
    cast once."""
    return _SeqGather.apply(x, model_group(plan, mesh))


class _SeqScatter(torch.autograd.Function):
    """The ranks' f32 ``[B, S, D]`` partials summed (:func:`_seq_scatter_sum`)
    into the rank's slice, cast to ``dtype``; the backward all-gathers the
    slices' gradients, as f32 (what :class:`_Across`'s backward gives)."""

    @staticmethod
    def forward(ctx, x, group, dtype):
        ctx.group = group
        return _seq_scatter_sum(x, group).to(dtype)

    @staticmethod
    def backward(ctx, g):
        return _seq_all_gather(g, ctx.group).float(), None, None


def seq_scatter(partial: torch.Tensor, plan, mesh, dtype) -> torch.Tensor:
    """A sequence-parallel block's output: the ranks' f32 row-parallel
    partials ``[B, S, D]`` (:func:`partial_mm`'s) summed over the model
    axis as :func:`across` sums them and cast to ``dtype`` once, the rank
    keeping its ``[B, S / P, D]`` sequence slice (the reference's
    ``psum_scatter`` over the sequence)."""
    return _SeqScatter.apply(partial, model_group(plan, mesh), dtype)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, plan, mesh) -> torch.Tensor:
    """``[B, S]`` tokens through the rank's ``[V / P, D]`` rows of the
    embedding: each rank looks up the tokens in its rows (zeros elsewhere)
    and the all-reduce adds one row and zeros, exactly."""
    vl = table.shape[0]
    ids = tokens.long() - model_rank(plan, mesh) * vl
    inside = (ids >= 0) & (ids < vl)
    rows = table[ids.clamp(0, vl - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device))
    return reduce_from_model(rows, plan, mesh)


class _VocabCE(torch.autograd.Function):
    """Per-row cross entropy of ``[N, V']`` f32 logits (the rank's vocab
    slice over a group, else the whole vocab) against global labels: the
    max (all-reduced), the sum of exponentials as the vocab's tree (the
    rank's ``n`` leaves, then the ranks') and the target's logit (one rank
    holds it: the all-reduce adds zeros).  The backward is ``softmax -
    onehot`` on the slice."""

    @staticmethod
    def forward(ctx, logits, labels, group, lo, n):
        vl = logits.shape[-1]
        m = logits.max(dim=-1).values
        lab = labels.long() - lo
        inside = (lab >= 0) & (lab < vl)
        lab = lab.clamp(0, vl - 1)
        gold = torch.where(inside, torch.gather(logits, 1, lab[:, None])[:, 0],
                           torch.zeros((), dtype=logits.dtype, device=logits.device))
        if group is not None:
            m = cr.all_reduce(m, group, op=dist.ReduceOp.MAX)
            gold = cr.all_reduce(gold, group)
        e = torch.exp(logits - m[:, None])
        n = n if vl % n == 0 else 1
        w = vl // n
        total = _across(_tree([e[:, i * w:(i + 1) * w].contiguous().sum(dim=-1)
                               for i in range(n)]), group)
        ctx.save_for_backward(e, total, lab, inside)
        return torch.log(total) + m - gold

    @staticmethod
    def backward(ctx, g):
        e, total, lab, inside = ctx.saved_tensors
        grad = e / total[:, None]
        rows = torch.arange(grad.shape[0], device=grad.device)
        grad[rows[inside], lab[inside]] -= 1.0
        return grad * g[:, None], None, None, None, None


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, plan=None, mesh=None
                        ) -> torch.Tensor:
    """``[..., V']`` f32 logits and ``[...]`` labels -> the per-row losses
    ``[...]``; with ``plan`` and ``mesh`` the logits are the rank's vocab
    slice and each loss is the whole vocabulary's."""
    v = logits.shape[-1]
    if mesh is None:
        out = _VocabCE.apply(logits.reshape(-1, v), labels.reshape(-1), None, 0, TREE_LEAVES)
    else:
        out = _VocabCE.apply(logits.reshape(-1, v), labels.reshape(-1), model_group(plan, mesh),
                             model_rank(plan, mesh) * v, leaves(plan.model_size))
    return out.reshape(labels.shape)


class _GatherVocab(torch.autograd.Function):
    """The ranks' vocab slices (last dim) all-gathered in rank order; the
    backward keeps the rank's slice (every rank holds the same gradient of
    the whole)."""

    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.rank, ctx.v = rank, x.shape[-1]
        full = cr.all_gather_raw(x.movedim(-1, 0).contiguous(), group)
        return full.movedim(0, -1).contiguous()

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.rank * ctx.v:(ctx.rank + 1) * ctx.v], None, None


def gather_vocab(x: torch.Tensor, plan, mesh) -> torch.Tensor:
    return _GatherVocab.apply(x, model_group(plan, mesh), model_rank(plan, mesh))
