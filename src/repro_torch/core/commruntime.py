"""CommRuntime: the collective runtime of the MixNet data plane over
``torch.distributed``.

Port of :mod:`repro.core.commruntime`.  A declarative :class:`CommSpec`
(mesh axis, its factorization into ``num_groups x group_size``, the wire
re-addressing perms a ControlPlane plan installs) and the ops built from it:
:class:`AllToAll` (flat or the two-stage delegation lowering, with
``dest_perm``/``src_perm`` re-addressing and the fused payload + id
transfer), :class:`AllToAllStage`, :class:`AllReduce` (the hierarchical
reduce-scatter -> all-reduce -> all-gather of paper §5.3, optionally int8),
:class:`AllGather`, :class:`ReduceScatter` and :class:`Permute`.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` whose dims are
named like the reference's axes (``("data", "model")``); the functional
lowerings take ``(x, mesh, axis)`` where the reference's ``shard_map``
programs take an axis name.  Each lowering is a ``torch.autograd.Function``
whose backward is the transposed collective: an all-to-all is its own
transpose, all-gather and reduce-scatter transpose into each other, a
permuted all-to-all's backward gathers through the inverse permutations.

The delegation all-to-all's two stages run over subgroups of the axis (the
reference's ``axis_index_groups``), created by :func:`_stage_groups` in the
same order on every rank.  Gloo takes the card's tensors for every
collective here; point-to-point transfers (the rings, :class:`Permute`)
stage through host memory under gloo, whose send and receive take host
buffers, counted in ``comm.host_staged_bytes``.  Every executed collective
records its per-device wire bytes by link class in ``comm.link_bytes``
(:func:`wire_bytes`).

The analytic side is the reference's, shared with the flow-level simulator
(:mod:`repro_torch.core.netsim`): :meth:`CommSpec.from_fabric` derives a
cost-only spec from a :mod:`repro_torch.core.fabric` topology, every op's
``cost`` prices one phase against the fabric's link rates (recording its
bytes in ``comm.link_bytes``), and :attr:`AllToAll.lowering` selects the
priced a2a schedule (hier / flat / ring) without changing what ``__call__``
executes.
"""

from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.obs import metrics

__all__ = [
    "CommSpec", "LinkBytes", "record_link_bytes", "AllToAll", "AllToAllStage", "AllReduce",
    "AllGather", "ReduceScatter", "Permute", "ep_alltoall_bytes", "dp_gradient_bytes",
    "device_perm_from_slots", "fuse_pack", "fuse_unpack", "flat_all_to_all",
    "hierarchical_all_to_all", "mixnet_all_to_all", "hierarchical_psum", "ring_all_gather",
    "ring_reduce_scatter", "axis_size", "axis_index", "axis_group", "all_reduce",
    "all_gather_objects", "host_staged_bytes", "wire_bytes", "all_gather_raw",
    "reduce_scatter_raw", "all_to_all_rows", "psum", "psum_scatter", "all_gather", "tree_sum",
    "reduce_scatter_ordered", "all_reduce_ordered", "side_group", "run_async",
]

# ---------------------------------------------------------------------------
# mesh axes, groups, host staging
# ---------------------------------------------------------------------------


def axis_size(mesh, axis: str | None) -> int:
    if mesh is None or axis is None:
        return 1
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def axis_index(mesh, axis: str | None) -> int:
    if mesh is None or axis is None:
        return 0
    return int(mesh.get_local_rank(axis))


def _axis_link(axis: str) -> str:
    return "cross_region" if axis in ("pod", "data", "stage") else "scale_out"


def axis_group(mesh, axis: str):
    grp = mesh.get_group(axis)
    _GROUP_LINK[id(grp)] = _axis_link(axis)
    return grp


def _grid_groups(p: int, group_size: int) -> tuple[list[list[int]], list[list[int]]]:
    if p % group_size != 0:
        raise ValueError(f"axis size {p} not divisible by group size {group_size}")
    g = p // group_size
    intra = [[gg * group_size + h for h in range(group_size)] for gg in range(g)]
    inter = [[gg * group_size + h for gg in range(g)] for h in range(group_size)]
    return intra, inter


_STAGE_GROUPS: dict = {}


def _stage_groups(mesh, axis: str, group_size: int):
    """This rank's (intra, inter) subgroups of ``axis`` factored as
    ``num_groups x group_size``.  Every rank creates every subgroup of every
    copy of the axis, in one order (``dist.new_group`` is collective over
    the whole world)."""
    key = (id(mesh), axis, group_size)
    if key not in _STAGE_GROUPS:
        dim = mesh.mesh_dim_names.index(axis)
        rows = mesh.mesh.movedim(dim, -1).reshape(-1, mesh.mesh.shape[dim]).tolist()
        intra, inter = _grid_groups(len(rows[0]), group_size)
        me = dist.get_rank()
        mine = [None, None]
        for row in rows:
            for which, lists in enumerate((intra, inter)):
                for lst in lists:
                    ranks = [row[i] for i in lst]
                    grp = dist.new_group(ranks)
                    if me in ranks:
                        mine[which] = grp
                        _GROUP_LINK[id(grp)] = ("scale_up", "scale_out")[which]
        _STAGE_GROUPS[key] = (mesh, tuple(mine))  # the mesh pins id(mesh)
    return _STAGE_GROUPS[key][1]


def _staged(group, t: torch.Tensor) -> bool:
    """Point-to-point transfers of the card's tensors stage through host
    memory under gloo, whose send and receive take host buffers (its
    collectives take the card's tensors: ``ROADMAP.md``)."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


_KINDS = ("all_to_all", "all_reduce", "all_gather", "reduce_scatter", "p2p")


def host_staged_bytes() -> float:
    """Bytes this process has staged through host memory (both ways)."""
    return metrics.default().value("comm.host_staged_bytes", op="p2p")


_LINKS = ("scale_up", "scale_out", "cross_region")
# The link class each process group's traffic rides (``LinkBytes``): a batch
# axis (the DP ring) and a pipeline's stage hops the EPS fabric
# (cross_region, as ``commruntime.py:392`` of the reference), the model
# axis and the delegation's inter-group stage the regional fabric
# (scale_out), its intra-group stage scale_up.
_GROUP_LINK: dict[int, str] = {}


def wire_bytes() -> LinkBytes:
    """Per-device bytes this process has put on the wire by link class
    (``comm.link_bytes``, every executed collective and transfer)."""
    reg = metrics.default()
    return LinkBytes(*(sum(reg.value("comm.link_bytes", op=k, link=link) for k in _KINDS)
                       for link in _LINKS))


def _count_wire(kind: str, inp: torch.Tensor, group) -> None:
    """Record one executed collective's per-device wire bytes over ``n``
    ranks: an all-to-all or reduce-scatter sends ``(n - 1) / n`` of its
    input, an all-gather its shard to ``n - 1`` peers, a ring all-reduce
    ``2 (n - 1) / n`` of its input, a point-to-point send all of it."""
    n = dist.get_world_size(group)
    frac = {"all_to_all": (n - 1) / n, "reduce_scatter": (n - 1) / n, "all_gather": n - 1.0,
            "all_reduce": 2.0 * (n - 1) / n, "p2p": 1.0}[kind]
    nbytes = float(inp.numel() * inp.element_size()) * frac
    record_link_bytes(kind, LinkBytes(**{_GROUP_LINK.get(id(group), "scale_out"): nbytes}))


class _Pending:
    """An issued collective: ``wait()`` finishes it (and ``finish``, a copy
    into its output), applies ``post`` to the output once, and returns it."""

    def __init__(self, out, work=None, finish=None, post=None):
        self.out, self.work, self.finish, self.post = out, work, finish, post

    def wait(self):
        if self.work is not None:
            self.work.wait()
            self.work = None
        if self.finish is not None:
            # The copy fills an autograd output in place: not a step of the
            # graph.
            with torch.no_grad():
                self.finish()
            self.finish = None
        if self.post is not None:
            self.out = self.post(self.out)
            self.post = None
        return self.out


def _collective(kind: str, fn, out: torch.Tensor, inp: torch.Tensor, group,
                async_op: bool = False) -> _Pending:
    """Run ``fn(out, inp, group, async_op)`` (one ``torch.distributed``
    call), its wire bytes recorded."""
    _count_wire(kind, inp, group)
    return _Pending(out, fn(out, inp, group, async_op))


def _a2a_raw(x: torch.Tensor, group, async_op: bool = False) -> _Pending:
    x = x.contiguous()
    out = torch.empty_like(x)
    return _collective(
        "all_to_all",
        lambda o, i, g, a: dist.all_to_all_single(o, i, group=g, async_op=a),
        out, x, group, async_op,
    )


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM, *, inplace: bool = False
               ) -> torch.Tensor:
    """All-reduce (no autograd): into a copy, or into ``x`` itself when
    ``inplace`` (a contiguous tensor nothing else reads)."""
    out = x.detach() if inplace else x.detach().clone().contiguous()
    return _collective(
        "all_reduce", lambda o, i, g, a: dist.all_reduce(o, op=op, group=g, async_op=a),
        out, out, group,
    ).wait()


def all_gather_raw(x: torch.Tensor, group) -> torch.Tensor:
    """``[n, ...]`` -> ``[p * n, ...]`` ordered by group rank."""
    x = x.contiguous()
    p = dist.get_world_size(group)
    out = torch.empty((p * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    return _collective(
        "all_gather",
        lambda o, i, g, a: dist.all_gather_into_tensor(o, i, group=g, async_op=a),
        out, x, group,
    ).wait()


def reduce_scatter_raw(x: torch.Tensor, group) -> torch.Tensor:
    """``[p * n, ...]`` -> this rank's ``[n, ...]`` of the sum."""
    x = x.contiguous()
    p = dist.get_world_size(group)
    out = torch.empty((x.shape[0] // p, *x.shape[1:]), dtype=x.dtype, device=x.device)
    return _collective(
        "reduce_scatter",
        lambda o, i, g, a: dist.reduce_scatter_tensor(o, i, group=g, async_op=a),
        out, x, group,
    ).wait()


def tree_sum(parts: list) -> torch.Tensor:
    """``parts`` summed as a binary tree in their order: pairs, then pairs of
    the pair sums (an odd one out carried up)."""
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] if i + 1 < len(parts) else parts[i]
                 for i in range(0, len(parts), 2)]
    return parts[0]


def reduce_scatter_ordered(x: torch.Tensor, group) -> torch.Tensor:
    """``[p * n, ...]`` -> this rank's ``[n, ...]`` of the sum over the
    group, the same bits whatever the library's reduction order: one
    all-to-all of the ``n``-row shares, then the ``p`` received shares
    summed in f32 as :func:`tree_sum` over rank order and cast once to
    ``x``'s dtype.  A data axis's gradient sums take it under ZeRO-3 and
    replicated alike (:func:`all_reduce_ordered`), so both give each
    element the same bits (gloo's own sum order is its ring's)."""
    p = dist.get_world_size(group)
    if p == 1:
        return x
    if x.shape[0] % p:
        raise ValueError(f"dim 0 ({x.shape[0]}) not divisible by the group's {p} ranks")
    got = _a2a_raw(x, group).wait().reshape(p, x.shape[0] // p, *x.shape[1:])
    return tree_sum([s.float() for s in got.unbind(0)]).to(x.dtype)


def all_reduce_ordered(x: torch.Tensor, group, *, inplace: bool = False) -> torch.Tensor:
    """The sum over ``group`` of every rank's ``x`` (no autograd) as
    :func:`reduce_scatter_ordered` of its flat elements (zero-padded to a
    multiple of the group) and an all-gather of the sums: the ring
    all-reduce's bytes, and each element the bits a ZeRO-3 rank's shard of
    it gets.  ``inplace``: into ``x`` (contiguous), else a new tensor."""
    p = dist.get_world_size(group)
    out = x.detach() if inplace else x.detach().clone()
    if p == 1:
        return out
    flat = out.reshape(-1)
    pad = -flat.numel() % p
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    mine = reduce_scatter_ordered(flat.reshape(p, -1), group)
    full = all_gather_raw(mine, group).reshape(-1)
    out.reshape(-1).copy_(full[:out.numel()])
    return out


_SIDE_GROUPS: dict = {}


def side_group(mesh, axis: str):
    """A second process group over this rank's ``axis`` of ``mesh``, made
    once (collectively: every rank makes every row's, in one order), for
    transfers a worker thread runs (:func:`run_async`) while the calling
    thread runs collectives on the mesh's own groups: two threads never
    share a group."""
    key = (id(mesh), axis)
    if key not in _SIDE_GROUPS:
        dim = mesh.mesh_dim_names.index(axis)
        rows = mesh.mesh.movedim(dim, -1).reshape(-1, mesh.mesh.shape[dim]).tolist()
        me, mine = dist.get_rank(), None
        for row in rows:
            grp = dist.new_group(row)
            if me in row:
                mine = grp
                _GROUP_LINK[id(grp)] = _axis_link(axis)
        _SIDE_GROUPS[key] = (mesh, mine)  # the mesh pins id(mesh)
    return _SIDE_GROUPS[key][1]


# One worker: asynchronous transfers run in the order they were issued,
# which is the same on every rank.
_WORKER: list = []
_WORKER_LOCK = threading.Lock()
_SIDE_STREAMS: dict = {}


class _Async:
    """A transfer running on the worker thread: ``wait()`` returns its
    result, ordered after the transfer on the caller's CUDA stream."""

    def __init__(self, fut, cuda: bool):
        self.fut, self.cuda = fut, cuda

    def wait(self):
        out, done = self.fut.result()
        if self.cuda:
            cur = torch.cuda.current_stream(out.device)
            cur.wait_event(done)
            out.record_stream(cur)
        return out


def run_async(fn, x: torch.Tensor) -> _Async:
    """``fn(x)`` (a transfer over a :func:`side_group`, no autograd) on a
    worker thread, so that it runs while this thread issues compute.  On
    the card the worker runs on a stream of its own that first waits for
    everything this thread's stream had issued (``x`` is ready) and is
    waited for by ``wait()``'s caller: staged copies through host memory
    then wait for the transfer's own stream only."""
    with _WORKER_LOCK:
        if not _WORKER:
            _WORKER.append(ThreadPoolExecutor(max_workers=1, thread_name_prefix="comm"))
    cuda = x.device.type == "cuda"
    if cuda:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(x.device))
        if x.device not in _SIDE_STREAMS:
            _SIDE_STREAMS[x.device] = torch.cuda.Stream(x.device)
        side = _SIDE_STREAMS[x.device]

        def job():
            with torch.no_grad(), torch.cuda.device(x.device), torch.cuda.stream(side):
                side.wait_event(ready)
                out = fn(x)
                done = torch.cuda.Event()
                done.record(side)
            return out, done
    else:
        def job():
            with torch.no_grad():
                return fn(x), None
    return _Async(_WORKER[0].submit(job), cuda)


def all_to_all_rows(send: torch.Tensor, in_split: list[int], out_split: list[int], group
                    ) -> torch.Tensor:
    """All-to-all of whole rows with split sizes (no autograd): ``send``'s
    first ``in_split[0]`` rows go to group rank 0, and so on; returns the
    ``sum(out_split)`` rows received, by source rank."""
    send = send.contiguous()
    out = torch.empty((sum(out_split), *send.shape[1:]), dtype=send.dtype, device=send.device)
    return _collective(
        "all_to_all",
        lambda o, i, g, a: dist.all_to_all_single(o, i, out_split, in_split, group=g,
                                                  async_op=a),
        out, send, group,
    ).wait()


def _exchange(sends: dict[int, torch.Tensor], recvs: dict[int, torch.Tensor], group) -> None:
    """Point-to-point transfers (``batch_isend_irecv``): ``sends[peer]``
    goes to group rank ``peer``, ``recvs[peer]`` is filled from it, in
    place.  Staged through host memory under gloo."""
    if not sends and not recvs:
        return
    staged = _staged(group, next(iter({**sends, **recvs}.values())))
    ops, back = [], []
    for peer, t in sorted(sends.items()):
        t = t.detach().contiguous()
        _count_wire("p2p", t, group)
        if staged:
            t = t.cpu()
            metrics.counter("comm.host_staged_bytes", op="p2p").inc(
                float(t.numel() * t.element_size()))
        ops.append(dist.P2POp(dist.isend, t, dist.get_global_rank(group, peer), group))
    for peer, t in sorted(recvs.items()):
        buf = torch.empty(t.shape, dtype=t.dtype) if staged else t
        if staged:
            back.append((t, buf))
            metrics.counter("comm.host_staged_bytes", op="p2p").inc(
                float(buf.numel() * buf.element_size()))
        ops.append(dist.P2POp(dist.irecv, buf, dist.get_global_rank(group, peer), group))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    for t, buf in back:
        t.copy_(buf)


def all_gather_objects(obj, group=None) -> list:
    """Every rank's picklable ``obj`` (the plan-agreement check)."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


# ---------------------------------------------------------------------------
# functional lowerings (each an autograd Function)
# ---------------------------------------------------------------------------


class _SelfTranspose(torch.autograd.Function):
    """A data movement that is its own transpose (an all-to-all, either
    delegation stage): the backward runs the same movement on the
    gradient.  ``holder`` (a list) takes the pending handle of an async
    forward; the output is valid after its ``wait()``."""

    @staticmethod
    def forward(ctx, x, move, holder):
        ctx.move = move
        pend = move(x, holder is not None)
        if holder is not None:
            holder.append(pend)
        return pend.out if holder is not None else pend.wait()

    @staticmethod
    def backward(ctx, g):
        return ctx.move(g, False).wait(), None, None


def _flat_move(group):
    return lambda x, a: _a2a_raw(x, group, a)


def _scale_up_move(group, p: int, h: int):
    """Delegation stage 1: the h-chunk dim of ``[G, H, ...]`` exchanged
    inside the group (``split = concat = 1``)."""
    g = p // h

    def move(x, a):
        xr = x.reshape(g, h, *x.shape[1:]).transpose(0, 1).contiguous()
        inner = _a2a_raw(xr, group, a)
        out = torch.empty_like(x)

        def finish():
            res = inner.wait().reshape(h, g, *x.shape[1:])
            out.copy_(res.transpose(0, 1).reshape(x.shape))

        return _Pending(out, None, finish)

    return move


def _scale_out_move(group):
    """Delegation stage 2: the g-chunk dim of ``[G, H, ...]`` exchanged
    across groups (``split = concat = 0``: the flat layout as it is)."""
    return lambda x, a: _a2a_raw(x, group, a)


def _a2a(x, move, holder=None):
    return _SelfTranspose.apply(x, move, holder)


def flat_all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Single-shot all-to-all. ``x``: ``[P, ...]`` chunks by destination;
    returns ``[P, ...]`` by source."""
    if axis_size(mesh, axis) == 1:
        return x
    return _a2a(x, _flat_move(axis_group(mesh, axis)))


def _a2a_scale_up(x, mesh, axis: str, group_size: int, holder=None):
    p = axis_size(mesh, axis)
    intra, _ = _stage_groups(mesh, axis, group_size)
    return _a2a(x, _scale_up_move(intra, p, group_size), holder)


def _a2a_scale_out(x, mesh, axis: str, group_size: int, holder=None):
    _, inter = _stage_groups(mesh, axis, group_size)
    return _a2a(x, _scale_out_move(inter), holder)


def hierarchical_all_to_all(x: torch.Tensor, mesh, axis: str, group_size: int) -> torch.Tensor:
    """Two-stage (delegation) all-to-all over an axis of size
    ``P = G * group_size`` (device index ``g * group_size + h``): stage 1
    inside each group, stage 2 across groups.  Bit-identical to
    :func:`flat_all_to_all`."""
    p = axis_size(mesh, axis)
    h = group_size
    if p == 1 or h == 1 or h >= p:
        return flat_all_to_all(x, mesh, axis)
    return _a2a_scale_out(_a2a_scale_up(x, mesh, axis, h), mesh, axis, h)


def mixnet_all_to_all(x, mesh, axis: str, group_size: int, *, dest_perm=None, src_perm=None):
    """Hierarchical all-to-all with wire re-addressing: the chunk sent to
    device ``k`` is the one logically addressed to ``dest_perm[k]``;
    ``src_perm`` restores the logical order of what arrived."""
    if dest_perm is not None:
        x = x[_idx(dest_perm, x)]
    y = hierarchical_all_to_all(x, mesh, axis, group_size)
    if src_perm is not None:
        y = y[_idx(src_perm, y)]
    return y


def _idx(perm, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(perm) if not isinstance(perm, torch.Tensor) else perm,
                           device=like.device).long()


class _AllReduceFn(torch.autograd.Function):
    """Sum over a group; the transpose of a sum-reduction is the same sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _AllGatherFn(torch.autograd.Function):
    """Tiled all-gather on dim 0; its transpose is the reduce-scatter."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_raw(g, ctx.group), None


class _ReduceScatterFn(torch.autograd.Function):
    """Tiled reduce-scatter on dim 0; its transpose is the all-gather."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_scatter_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_raw(g, ctx.group), None


def psum(x: torch.Tensor, mesh, axis: str | None) -> torch.Tensor:
    """``lax.psum`` over one mesh axis (differentiable)."""
    if axis is None or axis_size(mesh, axis) == 1:
        return x
    return _AllReduceFn.apply(x, axis_group(mesh, axis))


def _moved(fn, x, dim: int):
    if dim == 0:
        return fn(x)
    return fn(x.movedim(dim, 0)).movedim(0, dim)


def psum_scatter(x, mesh, axis: str, *, scatter_dim: int = 0):
    """``lax.psum_scatter(tiled=True)`` (differentiable)."""
    grp = axis_group(mesh, axis)
    return _moved(lambda t: _ReduceScatterFn.apply(t, grp), x, scatter_dim)


def all_gather(x, mesh, axis: str, *, dim: int = 0):
    """``lax.all_gather(tiled=True)`` (differentiable)."""
    grp = axis_group(mesh, axis)
    return _moved(lambda t: _AllGatherFn.apply(t, grp), x, dim)


def hierarchical_psum(x, mesh, inner_axis: str, outer_axis: str | None = None, *,
                      scatter_dim: int = 0):
    """Paper §5.3 hierarchical all-reduce: reduce-scatter over
    ``inner_axis``, all-reduce over ``outer_axis``, all-gather back.
    Scalars and shapes the inner axis does not divide take the flat sum."""
    inner = axis_size(mesh, inner_axis)
    if inner == 1 or x.dim() == 0 or x.shape[scatter_dim] % inner != 0:
        y = psum(x, mesh, inner_axis)
        return psum(y, mesh, outer_axis) if outer_axis else y
    part = psum_scatter(x, mesh, inner_axis, scatter_dim=scatter_dim)
    if outer_axis is not None:
        part = psum(part, mesh, outer_axis)
    return all_gather(part, mesh, inner_axis, dim=scatter_dim)


class _RingFn(torch.autograd.Function):
    """A ring collective on dim 0; ``kind`` ``"gather"`` or ``"scatter"``,
    each the other's transpose."""

    @staticmethod
    def forward(ctx, x, group, kind):
        ctx.group, ctx.kind = group, kind
        return (_ring_gather if kind == "gather" else _ring_scatter)(x.detach(), group)

    @staticmethod
    def backward(ctx, g):
        fn = _ring_scatter if ctx.kind == "gather" else _ring_gather
        return fn(g.contiguous(), ctx.group), None, None


def _ring_step(block: torch.Tensor, group) -> torch.Tensor:
    """One hop: send ``block`` to the next rank, receive the previous's."""
    p = dist.get_world_size(group)
    me = dist.get_rank(group)
    got = torch.empty_like(block)
    _exchange({(me + 1) % p: block}, {(me - 1) % p: got}, group)
    return got


def _ring_gather(x, group):
    p = dist.get_world_size(group)
    me = dist.get_rank(group)
    blocks = [None] * p
    blocks[me] = x
    cur = x
    for t in range(1, p):
        cur = _ring_step(cur, group)
        blocks[(me - t) % p] = cur  # hop t brings device (me - t)'s block
    return torch.cat(blocks, dim=0)


def _ring_scatter(x, group):
    p = dist.get_world_size(group)
    me = dist.get_rank(group)
    if x.shape[0] % p:
        raise ValueError(f"dim 0 ({x.shape[0]}) not divisible by axis size {p}")
    chunks = x.reshape(p, x.shape[0] // p, *x.shape[1:])
    # After t additions the partial this rank holds is destined for rank
    # (me - t); chunks[...] is the local term for that destination.
    acc = chunks[(me - 1) % p]
    for t in range(1, p):
        acc = _ring_step(acc.contiguous(), group) + chunks[(me - 1 - t) % p]
    return acc


def ring_all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Explicit ring all-gather (p - 1 neighbour hops); equal to the tiled
    all-gather in ascending device order."""
    if axis_size(mesh, axis) == 1:
        return x
    return _RingFn.apply(x, axis_group(mesh, axis), "gather")


def ring_reduce_scatter(x: torch.Tensor, mesh, axis: str, *, scatter_dim: int = 0):
    """Explicit ring reduce-scatter: the partial for device ``d`` starts at
    ``d + 1`` and rides p - 1 hops, each holder adding its chunk (ring
    order: exact for integers, allclose for floats)."""
    if axis_size(mesh, axis) == 1:
        return x
    if x.shape[scatter_dim] % axis_size(mesh, axis):
        raise ValueError(
            f"dim {scatter_dim} ({x.shape[scatter_dim]}) not divisible by axis size "
            f"{axis_size(mesh, axis)}")
    grp = axis_group(mesh, axis)
    return _moved(lambda t: _RingFn.apply(t.contiguous(), grp, "scatter"), x, scatter_dim)


# ---------------------------------------------------------------------------
# CommSpec
# ---------------------------------------------------------------------------


def _as_tuple(perm) -> tuple[int, ...] | None:
    if perm is None:
        return None
    if isinstance(perm, torch.Tensor):
        perm = perm.cpu().numpy()
    return tuple(int(i) for i in np.asarray(perm).tolist())


@dataclasses.dataclass(frozen=True)
class CommSpec:
    """Where a collective runs and how its axis factors into groups
    (``axis_size = num_groups * group_size``); ``outer_axis`` is the
    cross-region domain a hierarchical reduction rings over;
    ``dest_perm``/``src_perm`` the wire re-addressing state; ``mesh`` the
    ``DeviceMesh`` the named axes live on (None for a cost-only or
    one-device spec)."""

    axis: str | None = None
    axis_size: int = 1
    group_size: int = 1
    outer_axis: str | None = None
    outer_size: int = 1
    dest_perm: tuple[int, ...] | None = None
    src_perm: tuple[int, ...] | None = None
    mesh: object = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.axis_size < 1 or self.group_size < 1 or self.outer_size < 1:
            raise ValueError(f"bad CommSpec sizes: {self}")
        if self.hierarchical and self.axis_size % self.group_size != 0:
            raise ValueError(
                f"axis size {self.axis_size} not divisible by group size {self.group_size}"
            )
        for perm in (self.dest_perm, self.src_perm):
            if perm is not None and sorted(perm) != list(range(len(perm))):
                raise ValueError(f"not a permutation: {perm}")

    @property
    def hierarchical(self) -> bool:
        """True when the lowering runs the two-stage delegation grid."""
        return 1 < self.group_size < self.axis_size

    @property
    def num_groups(self) -> int:
        return self.axis_size // self.group_size if self.hierarchical else 1

    @classmethod
    def from_plan(cls, plan, *, group_size: int = 1, mesh=None) -> "CommSpec":
        """Spec for the regional (``model``) axis of a ``ShardingPlan``; a
        group spanning the whole axis degrades to the flat lowering."""
        if plan.model_axis is None or plan.model_size <= 1:
            return cls(axis=None, axis_size=1)
        g = 1 if group_size >= plan.model_size else group_size
        return cls(axis=plan.model_axis, axis_size=plan.model_size, group_size=g, mesh=mesh)

    @classmethod
    def for_grad_reduce(cls, plan, mesh) -> "CommSpec":
        """DP gradient reduction over the plan's batch axes: the innermost
        is the region (reduce-scatter stage), the outer the ring."""
        axes = plan.batch_axes
        if mesh is None or not axes:
            return cls(axis=None, axis_size=1)
        inner = axes[-1]
        outer = axes[0] if len(axes) > 1 else None
        return cls(
            axis=inner, axis_size=axis_size(mesh, inner), group_size=axis_size(mesh, inner),
            outer_axis=outer, outer_size=axis_size(mesh, outer) if outer else 1, mesh=mesh,
        )

    @classmethod
    def from_fabric(cls, fabric, num_servers_region: int | None = None) -> "CommSpec":
        """Cost-only spec whose region/group factorization comes from the
        fabric topology: groups = servers of the OCS region, group width =
        the intra-server scale-up domain (NVSwitch)."""
        cfg = fabric.cfg
        region = num_servers_region or cfg.num_servers
        gps = max(cfg.gpus_per_server, 1)
        return cls(
            axis=None,
            axis_size=region * gps,
            group_size=gps,
            outer_size=max(cfg.num_servers, 1),
        )

    def reconfigure(self, dest_perm=None, src_perm=None) -> "CommSpec":
        """New spec with updated wire re-addressing (None clears a side)."""
        return dataclasses.replace(
            self, dest_perm=_as_tuple(dest_perm), src_perm=_as_tuple(src_perm)
        )


# ---------------------------------------------------------------------------
# bytes-on-link accounting
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinkBytes:
    """Per-device wire bytes of one collective phase by link class:
    ``scale_up`` (intra-group, delegation stage 1), ``scale_out``
    (inter-group regional, stage 2), ``cross_region`` (the DP ring)."""

    scale_up: float = 0.0
    scale_out: float = 0.0
    cross_region: float = 0.0

    @property
    def total(self) -> float:
        return self.scale_up + self.scale_out + self.cross_region


_LB_COUNTERS: dict = {}
_LB_GENERATION = -1


def record_link_bytes(op: str, lb: LinkBytes) -> None:
    """Fold one phase's wire bytes into ``comm.link_bytes{link=...,op=...}``."""
    global _LB_GENERATION
    reg = metrics.default()
    if reg.generation != _LB_GENERATION:
        _LB_GENERATION = reg.generation
        _LB_COUNTERS.clear()
    for link, v in (("scale_up", lb.scale_up), ("scale_out", lb.scale_out),
                    ("cross_region", lb.cross_region)):
        if v:
            c = _LB_COUNTERS.get((op, link))
            if c is None:
                c = _LB_COUNTERS[(op, link)] = reg.counter("comm.link_bytes", op=op, link=link)
            c.inc(v)


def ep_alltoall_bytes(tokens: int, top_k: int, d_model: int, dtype_bytes: int) -> float:
    """Payload bytes of ONE EP all-to-all phase (whole EP group): every routed
    token copy carries its d_model activation row."""
    return float(tokens) * top_k * d_model * dtype_bytes


def dp_gradient_bytes(param_count: float, gpus_per_replica: int, gpus_per_server: int,
                      dtype_bytes: int) -> float:
    """Gradient bytes one server contributes to the DP ring."""
    per_gpu = float(param_count) / max(gpus_per_replica, 1)
    return per_gpu * gpus_per_server * dtype_bytes


def device_perm_from_slots(slot_perm: np.ndarray, slots_per_device: int) -> np.ndarray | None:
    """Collapse an expert-slot permutation to a device-level wire permutation.

    Returns ``None`` when slots cross device boundaries or are reordered
    within a device block — those plans are realized by the weight gather
    instead, and the wire layout stays put.
    """
    slot_perm = np.asarray(slot_perm)
    if slot_perm.size % slots_per_device != 0:
        return None
    blocks = slot_perm.reshape(-1, slots_per_device)
    devs = blocks // slots_per_device
    if not (devs == devs[:, :1]).all():
        return None  # a device's slots scatter across devices
    within = blocks % slots_per_device
    if not (within == np.arange(slots_per_device)[None, :]).all():
        return None  # reordered within the block: not a pure device move
    return devs[:, 0].astype(np.int64)


# ---------------------------------------------------------------------------
# the fused payload + id transfer
# ---------------------------------------------------------------------------


def _ids_to_lanes(ids: torch.Tensor, dtype) -> torch.Tensor:
    """int32 metadata as exact small-integer lanes of the payload dtype:
    numeric, not a bitcast (the -1 sentinel would form a NaN).  Ids in
    [-1, 2**16 - 2] for 16-bit payloads, [-1, 2**24 - 2] for 32-bit."""
    enc = ids.to(torch.int32) + 1
    if torch.empty((), dtype=dtype).element_size() == 4:
        return enc.to(dtype)[..., None]
    return torch.stack([(enc & 0xFF).to(dtype), ((enc >> 8) & 0xFF).to(dtype)], dim=-1)


def _lanes_to_ids(lanes: torch.Tensor) -> torch.Tensor:
    if lanes.element_size() == 4:
        return lanes[..., 0].to(torch.int32) - 1
    return lanes[..., 0].to(torch.int32) + (lanes[..., 1].to(torch.int32) << 8) - 1


def fuse_pack(payload: torch.Tensor, ids: torch.Tensor) -> torch.Tensor | None:
    """Pack int32 ids into trailing exact lanes of ``payload``'s dtype (one
    wire tensor); None when the dtype has no exact lane encoding."""
    if payload.element_size() not in (2, 4):
        return None
    return torch.cat([payload, _ids_to_lanes(ids, payload.dtype).detach()], dim=-1)


def fuse_unpack(packed: torch.Tensor, d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`fuse_pack`: (payload ``[..., d]``, int32 ids); the
    payload comes out contiguous, as the kernels take their rows."""
    return packed[..., :d].contiguous(), _lanes_to_ids(packed[..., d:].detach())


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _OpBase:
    spec: CommSpec

    def reconfigure(self, dest_perm=None, src_perm=None):
        """Same op, re-addressed wire chunks."""
        return dataclasses.replace(self, spec=self.spec.reconfigure(dest_perm, src_perm))

    def _perms(self, dest_perm, src_perm):
        if dest_perm is None and self.spec.dest_perm is not None:
            dest_perm = self.spec.dest_perm
        if src_perm is None and self.spec.src_perm is not None:
            src_perm = self.spec.src_perm
        return dest_perm, src_perm

    @property
    def _live(self) -> bool:
        return self.spec.axis is not None and self.spec.axis_size > 1


@dataclasses.dataclass(frozen=True)
class AllToAll(_OpBase):
    """EP all-to-all over ``[P, ...]`` send layouts (chunks by destination
    in, by source out): flat, or the delegation lowering when the spec is
    hierarchical; the spec's wire perms (or per-call overrides) re-address
    the chunks.

    ``lowering`` selects the *priced* wire schedule only (what netsim and
    the autotuner search over; ``__call__`` always runs the spec's
    lowering):

    * ``"hier"``: the delegation lowering (default), per-server aggregation
      amortizes per-message overheads;
    * ``"flat"``: the same bytes as ``group_size`` x more per-GPU messages,
      each remote server paying the per-message propagation latency;
    * ``"ring"``: store-and-forward, R - 1 sequential neighbour hops each
      carrying the residual full payload over one p2p link.
    """

    lowering: str = "hier"

    def __post_init__(self):
        if self.lowering not in ("hier", "flat", "ring"):
            raise ValueError(
                f"unknown a2a lowering {self.lowering!r}; expected 'hier', 'flat', or 'ring'")

    def __call__(self, x, *, dest_perm=None, src_perm=None):
        dest_perm, src_perm = self._perms(dest_perm, src_perm)
        if not self._live:
            if dest_perm is not None:
                x = x[_idx(dest_perm, x)]
            if src_perm is not None:
                x = x[_idx(src_perm, x)]
            return x
        return mixnet_all_to_all(x, self.spec.mesh, self.spec.axis, self.spec.group_size,
                                 dest_perm=dest_perm, src_perm=src_perm)

    def fused(self, payload, ids, *, dest_perm=None, src_perm=None):
        """ONE packed wire transfer for a payload ``[P, C, D]`` and its int32
        metadata ``[P, C]``; the payload moves bit-identically to the
        unfused pair.  The id lanes carry no gradient."""
        packed = fuse_pack(payload, ids)
        if packed is None:
            return (
                self(payload, dest_perm=dest_perm, src_perm=src_perm),
                self(ids[..., None], dest_perm=dest_perm, src_perm=src_perm)[..., 0],
            )
        out = self(packed, dest_perm=dest_perm, src_perm=src_perm)
        return fuse_unpack(out, payload.shape[-1])

    def stages(self) -> tuple["AllToAllStage", ...]:
        """The wire phases as separately callable stages (scale-up then
        scale-out for a hierarchical spec, one stage otherwise); composed in
        order they equal ``__call__`` bit for bit."""
        if self.spec.hierarchical:
            return (AllToAllStage(self, 0, 2), AllToAllStage(self, 1, 2))
        return (AllToAllStage(self, 0, 1),)

    def bytes_on_link(self, nbytes: float) -> LinkBytes:
        """Wire bytes for ``nbytes`` of per-device send payload."""
        p = self.spec.axis_size
        if p <= 1:
            return LinkBytes()
        if not self.spec.hierarchical:
            return LinkBytes(scale_out=nbytes * (p - 1) / p)
        h = self.spec.group_size
        g = self.spec.num_groups
        return LinkBytes(scale_up=nbytes * (h - 1) / h, scale_out=nbytes * (g - 1) / g)

    def route_demand(self, demand: np.ndarray) -> np.ndarray:
        """Physical inter-server demand after the spec's ``dest_perm``."""
        if self.spec.dest_perm is None:
            return demand
        demand = np.asarray(demand)
        perm = np.asarray(self.spec.dest_perm)
        if perm.shape[0] != demand.shape[1]:
            raise ValueError(f"dest_perm length {perm.shape[0]} != demand dim {demand.shape[1]}")
        return demand[:, perm]

    def cost(self, fabric, demand: np.ndarray) -> float:
        """Completion seconds of one a2a phase with ``demand`` bytes between
        servers, priced on ``fabric``'s link rates under ``lowering``."""
        demand = np.asarray(self.route_demand(demand))
        r = demand.shape[0]
        # Wire bytes this phase moves between servers (the diagonal stays
        # local).
        offdiag = float(demand.sum())
        if demand.ndim == 2 and demand.shape[0] == demand.shape[1]:
            offdiag -= float(np.trace(demand))
        record_link_bytes("a2a", LinkBytes(scale_out=max(offdiag, 0.0)))
        if self.lowering == "ring" and r > 1:
            per_hop = float(max(demand.sum(axis=1).max(), demand.sum(axis=0).max()))
            return (r - 1) * fabric.p2p_time(per_hop)
        base = fabric.alltoall_time(demand)
        if self.lowering == "flat" and r > 1:
            # Same wire bytes, group_size x more messages: each GPU pays the
            # per-message latency for every remote server it talks to.
            msgs = max(self.spec.group_size, 1) * (r - 1)
            return base + msgs * fabric.cfg.propagation_delay_s
        return base


@dataclasses.dataclass(frozen=True)
class AllToAllStage:
    """One wire phase of an :class:`AllToAll` (stage 0 of a delegation
    spec is the scale-up exchange and applies ``dest_perm``, stage 1 the
    scale-out exchange and applies ``src_perm``; a one-stage tuple's member
    is the whole op).  ``async_op=True`` returns a pending handle whose
    ``wait()`` gives the output: the overlap pipeline issues a chunk's
    stage, runs another chunk's work, then waits."""

    op: AllToAll
    index: int
    count: int

    @property
    def link_class(self) -> str:
        """Which LinkBytes class this stage's traffic rides."""
        if self.count == 2 and self.index == 0:
            return "scale_up"
        return "scale_out"

    def __call__(self, x, *, dest_perm=None, src_perm=None, async_op: bool = False):
        s = self.op.spec
        dperm, sperm = self.op._perms(dest_perm, src_perm)
        holder = [] if async_op else None
        live = self.op._live
        if self.index == 0 and dperm is not None:
            x = x[_idx(dperm, x)]
        if self.count == 1:
            y = _a2a(x, _flat_move(axis_group(s.mesh, s.axis)), holder) if live else x
        elif self.index == 0:
            y = _a2a_scale_up(x, s.mesh, s.axis, s.group_size, holder) if live else x
            sperm = None
        else:
            y = _a2a_scale_out(x, s.mesh, s.axis, s.group_size, holder) if live else x
        post = None if sperm is None else (lambda t: t[_idx(sperm, t)])
        if not holder:
            y = y if post is None else post(y)
            return _Pending(y) if async_op else y
        # The return trip's src_perm gathers once the transfer has landed.
        return _Pending(y, holder[0].work, holder[0].finish, post)

    def bytes_on_link(self, nbytes: float) -> LinkBytes:
        full = self.op.bytes_on_link(nbytes)
        if self.count == 1:
            return full
        if self.index == 0:
            return LinkBytes(scale_up=full.scale_up)
        return LinkBytes(scale_out=full.scale_out)


@dataclasses.dataclass(frozen=True)
class AllReduce(_OpBase):
    """Hierarchical all-reduce (§5.3) over the spec's axis (the region) and
    ``outer_axis`` (the ring); ``compress`` runs it through the int8 codec
    (:mod:`repro_torch.optim.compress`)."""

    def _check(self):
        s = self.spec
        if s.axis is None and s.axis_size > 1:
            raise ValueError(
                "cost-only AllReduce spec (axis=None, axis_size>1) has no executable lowering"
            )

    def __call__(self, x, *, scatter_dim: int = 0, mean: bool = False, compress: bool = False):
        self._check()
        s = self.spec
        if compress:
            from repro_torch.optim.compress import compressed_hierarchical_psum

            y = compressed_hierarchical_psum(x, s.mesh, s.axis, s.outer_axis,
                                             scatter_dim=scatter_dim)
        elif s.axis is None:
            y = psum(x, s.mesh, s.outer_axis) if s.outer_axis else x
        else:
            y = hierarchical_psum(x, s.mesh, s.axis, s.outer_axis, scatter_dim=scatter_dim)
        if mean:
            y = y / float(max(s.axis_size, 1) * max(s.outer_size, 1))
        return y

    def compressed(self, x, *, scatter_dim: int = 0, mean: bool = False):
        """``(reduced, local_decoded)``: the int8 reduction and this shard's
        own decoded contribution (f32), which error feedback subtracts."""
        from repro_torch.optim.compress import compressed_hierarchical_psum

        self._check()
        s = self.spec
        total, local = compressed_hierarchical_psum(
            x, s.mesh, s.axis, s.outer_axis, scatter_dim=scatter_dim, with_local=True
        )
        if mean:
            total = total / float(max(s.axis_size, 1) * max(s.outer_size, 1))
        return total, local

    def bytes_on_link(self, nbytes: float, *, compress_ratio: float = 1.0) -> LinkBytes:
        nbytes = nbytes * compress_ratio
        i, o = self.spec.axis_size, self.spec.outer_size
        if i <= 1 and o <= 1:
            return LinkBytes()
        if o > 1:
            inner = 2.0 * nbytes * (i - 1) / i if i > 1 else 0.0
            ring = 2.0 * (nbytes / max(i, 1)) * (o - 1) / o
            return LinkBytes(scale_up=inner, cross_region=ring)
        return LinkBytes(cross_region=2.0 * nbytes * (i - 1) / i)

    def cost(self, fabric, bytes_per_server: float, num_servers: int | None = None, *,
             compress_ratio: float = 1.0) -> float:
        """Seconds of one reduction of ``bytes_per_server`` on ``fabric``
        (``compress_ratio`` prices the int8 wire)."""
        n = num_servers or (self.spec.outer_size if self.spec.outer_size > 1 else None)
        record_link_bytes("allreduce",
                          self.bytes_on_link(bytes_per_server, compress_ratio=compress_ratio))
        return fabric.allreduce_time(bytes_per_server * compress_ratio, n)


@dataclasses.dataclass(frozen=True)
class AllGather(_OpBase):
    """All-gather over the spec's axis: ``impl="ring"`` the explicit
    neighbour ring, ``"flat"`` the single-shot collective."""

    impl: str = "ring"

    def __call__(self, x, *, axis: int = 0, tiled: bool = True):
        s = self.spec
        if not self._live:
            return x if tiled else x.unsqueeze(axis)
        if not tiled:
            return all_gather(x.unsqueeze(axis), s.mesh, s.axis, dim=axis)
        if self.impl == "ring":
            return _moved(lambda t: ring_all_gather(t, s.mesh, s.axis), x, axis)
        return all_gather(x, s.mesh, s.axis, dim=axis)

    def bytes_on_link(self, nbytes: float) -> LinkBytes:
        return LinkBytes(scale_out=nbytes * max(self.spec.axis_size - 1, 0))

    def cost(self, fabric, shard_bytes: float) -> float:
        p = self.spec.axis_size
        if p <= 1:
            return 0.0
        record_link_bytes("allgather", self.bytes_on_link(shard_bytes))
        return (p - 1) * fabric.p2p_time(shard_bytes)


@dataclasses.dataclass(frozen=True)
class ReduceScatter(_OpBase):
    """Tiled reduce-scatter over the spec's axis: ``impl="ring"`` the
    explicit ring (ring summation order), ``"flat"`` the collective."""

    impl: str = "flat"

    def __call__(self, x, *, scatter_dim: int = 0):
        s = self.spec
        if not self._live:
            return x
        if x.shape[scatter_dim] % s.axis_size != 0:
            raise ValueError(
                f"dim {scatter_dim} ({x.shape[scatter_dim]}) not divisible by axis size "
                f"{s.axis_size}")
        if self.impl == "ring":
            return ring_reduce_scatter(x, s.mesh, s.axis, scatter_dim=scatter_dim)
        return psum_scatter(x, s.mesh, s.axis, scatter_dim=scatter_dim)

    def bytes_on_link(self, nbytes: float) -> LinkBytes:
        p = self.spec.axis_size
        if p <= 1:
            return LinkBytes()
        return LinkBytes(scale_out=nbytes * (p - 1) / p)

    def cost(self, fabric, nbytes: float) -> float:
        p = self.spec.axis_size
        if p <= 1:
            return 0.0
        record_link_bytes("reducescatter", self.bytes_on_link(nbytes))
        return (p - 1) * fabric.p2p_time(nbytes / p)


class _PermuteFn(torch.autograd.Function):
    """Device ``k`` receives device ``perm[k]``'s payload; the transpose
    sends it back (device ``perm[k]`` receives ``k``'s gradient)."""

    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _permute_raw(x.detach(), group, perm)

    @staticmethod
    def backward(ctx, g):
        inv = [0] * len(ctx.perm)
        for k, src in enumerate(ctx.perm):
            inv[src] = k
        return _permute_raw(g.contiguous(), ctx.group, tuple(inv)), None, None


def _permute_raw(x, group, perm):
    me = dist.get_rank(group)
    out = torch.empty_like(x)
    src = perm[me]
    dests = [k for k, s in enumerate(perm) if s == me]
    if src == me:
        out.copy_(x)
    sends = {k: x for k in dests if k != me}
    if len(sends) > 1:
        raise ValueError(f"not a permutation: {perm}")
    _exchange(sends, {src: out} if src != me else {}, group)
    return out


@dataclasses.dataclass(frozen=True)
class Permute(_OpBase):
    """Point-to-point wire re-address with the all-to-all's gather
    semantics: after the hop device ``k`` holds device ``perm[k]``'s payload
    (default: the spec's ``dest_perm``, else the previous ring neighbour)."""

    def __call__(self, x, *, perm=None):
        s = self.spec
        if not self._live:
            return x
        if perm is None:
            perm = (s.dest_perm if s.dest_perm is not None
                    else tuple((i - 1) % s.axis_size for i in range(s.axis_size)))
        return _PermuteFn.apply(x, axis_group(s.mesh, s.axis), _as_tuple(perm))

    def bytes_on_link(self, nbytes: float) -> LinkBytes:
        if self.spec.axis_size <= 1:
            return LinkBytes()
        return LinkBytes(scale_out=nbytes)

    def cost(self, fabric, nbytes: float) -> float:
        if self.spec.axis_size <= 1:
            return 0.0
        record_link_bytes("permute", self.bytes_on_link(nbytes))
        return fabric.p2p_time(nbytes)
