"""Sharding plan over a ``("data", "model")`` device mesh.

Port of :mod:`repro.parallel.sharding`.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims; the plan says
which axes shard the batch (DP), which is the regional model axis (EP for
the MoE layers) and whether parameters shard over the data axis (ZeRO-3:
``make_plan(mesh)``, the reference's default; ``make_plan(mesh,
fsdp=False)`` keeps every leaf whole over it).  A pipeline's ``"stage"``
axis (and any other name) is invisible to the plan, as in the reference:
inside a stage the batch and model axes mean what they mean without one.
:func:`stage_layers` gives a rank's stage and the repeats it holds.

Where each parameter and optimizer leaf lives is ONE rule
(:class:`TreeLayout`): a leaf's global logical array is the canonical
``[repeats, ...]`` one; under a mesh the block leaves keep the rank's
stage's repeats (dim 0 over ``"stage"``), the expert leaves
(``moe/w_in``, ``moe/w_gate``, ``moe/w_out``) also the rank's ``E_virtual
/ P`` slots (dim 1 over the model axis), the embedding lives on the first
stage (and the last, for a tied head), the final norm and LM head on the
last.  Over the model axis the dense leaves follow the reference's
Megatron rules (``layers.py:98-110``, ``:546-552``, ``moe.py:116-128``,
``transformer.py:87``, ``:117``) wherever the size divides: the attention
heads of ``wq``/``wo`` (of ``wk``/``wv`` when the kv heads divide too), the
MLP's and the shared expert's ``w_in``/``w_gate`` columns and ``w_out``
rows, the embedding's and the LM head's vocab; the serving engine's paged
KV pools keep the rank's kv heads.  Every other leaf (the norms, the
router, the SSM leaves) is replicated over the model axis.  Under ZeRO-3
(``plan.fsdp_axis``) the data axis also shards each leaf the reference's
init specs give an FSDP dim (``layers.py:107-110``, ``:546-551``,
``moe.py:112-128``, ``transformer.py:87``, ``:117``, ``ssm.py:47-57``):
the ``d_model`` dim of the attention, MLP, expert, shared-expert and
Mamba-2 projections, of the embedding and of the LM head, where the data
axis divides ``d_model`` (else the leaf stays whole over it); this
composes with the expert and tensor-parallel dims (:meth:`TreeLayout.fsdp_dim`).
``models.transformer.init_model``, ``interop.shard_params`` and
``train.checkpoint`` all go through it, for the parameters and the AdamW
moments alike.

Layouts are explicit in the port, so :func:`constrain` is the identity.  In
place of ``shard_map``'s token spec for the MoE region (``moe.py:503-520``
of the reference), :func:`token_slice` and :func:`token_gather` move a
rank's activations in and out of the region: every rank of a model group
runs the non-MoE layers on the same local batch, the MoE region takes the
rank's sequence slice over the model axis (the whole sequence when the
model size does not divide it, the reference's ``seq_ax=None``), and its
output is all-gathered back.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import commruntime as cr

__all__ = [
    "ShardingPlan", "make_plan", "virtual_experts", "constrain", "seq_sharded", "token_slice",
    "token_gather", "mesh_coord", "stage_layers", "TreeLayout", "EXPERT_LEAVES",
    "local_kv_heads", "fsdp_leaf_dim",
]

# The stacked expert leaves under ``blocks/*/moe`` (sharded over the model
# axis; a tuple: every rank walks them in this order), and the path words
# that only name a tree, not a leaf's place in the model (a checkpoint's
# ``params``/``opt`` and AdamW's ``mu``/``nu``).
EXPERT_LEAVES = ("w_in", "w_gate", "w_out")
_TREE_WORDS = frozenset({"params", "opt", "mu", "nu"})

# The dense leaves tensor parallelism shards over the model axis: a block
# leaf's last two path words -> the dim of its stacked ``[repeats, ...]``
# array that it shards, and what that dim counts (the config's field).
_TP_BLOCK_LEAVES = {
    ("attn", "wq"): (2, "heads"), ("attn", "wo"): (1, "heads"),
    ("attn", "wk"): (2, "kv_heads"), ("attn", "wv"): (2, "kv_heads"),
    ("mlp", "w_in"): (2, "d_ff"), ("mlp", "w_gate"): (2, "d_ff"), ("mlp", "w_out"): (1, "d_ff"),
    ("shared", "w_in"): (2, "shared_ff"), ("shared", "w_gate"): (2, "shared_ff"),
    ("shared", "w_out"): (1, "shared_ff"),
}

# The leaves ZeRO-3 shards over the data axis: a leaf's last two path words
# (one word for an end leaf) -> the dim of its ``d_model`` in the stored
# array (block leaves stacked ``[repeats, ...]``), the reference's FSDP dim.
_FSDP_LEAVES = {
    ("attn", "wq"): 1, ("attn", "wk"): 1, ("attn", "wv"): 1, ("attn", "wo"): 3,
    ("mlp", "w_in"): 1, ("mlp", "w_gate"): 1, ("mlp", "w_out"): 2,
    ("shared", "w_in"): 1, ("shared", "w_gate"): 1, ("shared", "w_out"): 2,
    ("moe", "w_in"): 2, ("moe", "w_gate"): 2, ("moe", "w_out"): 3,
    ("ssm", "w_z"): 1, ("ssm", "w_x"): 1, ("ssm", "w_B"): 1, ("ssm", "w_C"): 1,
    ("ssm", "w_dt"): 1, ("ssm", "w_out"): 2,
    ("embed",): 1, ("lm_head",): 0,
}


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    batch_axes: tuple  # axes sharding the batch dim, e.g. ("pod", "data")
    model_axis: str | None  # TP/EP axis name (None on single-device)
    model_size: int
    fsdp_axis: str | None  # params sharded over this axis too (ZeRO-3)
    data_size: int = 1

    def heads_axis(self, num_heads: int) -> str | None:
        """Shard a heads dim over the model axis only when divisible."""
        if self.model_axis and num_heads % max(self.model_size, 1) == 0:
            return self.model_axis
        return None

    def dim_axis(self, dim: int) -> str | None:
        if self.model_axis and dim % max(self.model_size, 1) == 0:
            return self.model_axis
        return None

    def fsdp_for(self, dim: int) -> str | None:
        if self.fsdp_axis and dim % max(self.data_size, 1) == 0:
            return self.fsdp_axis
        return None


def make_plan(mesh=None, *, fsdp: bool = True) -> ShardingPlan:
    """The plan of a mesh's named axes (the no-op plan for None)."""
    if mesh is None or not mesh.mesh_dim_names:
        return ShardingPlan((), None, 1, None, 1)
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.mesh.shape))
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    return ShardingPlan(
        batch_axes=batch_axes,
        model_axis="model" if "model" in names else None,
        model_size=int(sizes.get("model", 1)),
        fsdp_axis="data" if (fsdp and "data" in names) else None,
        data_size=int(sizes.get("data", 1)),
    )


def local_kv_heads(cfg, plan: ShardingPlan) -> int:
    """The kv heads a rank's attention (and its decode caches) holds: all
    of them without tensor parallelism, ``Hkv / P`` when they divide the
    model axis, and when only the q heads do, the rank's ``lcm(Hkv, P) /
    P`` of the kv heads repeated up to the axis size (the reference's
    repeat, ``layers.py:305-309``)."""
    h, hkv, p = cfg.num_heads, cfg.num_kv_heads, max(plan.model_size, 1)
    if not plan.heads_axis(h) or p == 1:
        return hkv
    if plan.heads_axis(hkv):
        return hkv // p
    return math.lcm(hkv, p) // p


def mesh_coord(mesh, axis: str, rank: int | None = None) -> int:
    """Global rank ``rank``'s (default: this process's) index along
    ``axis`` of ``mesh``."""
    if rank is None:
        return int(mesh.get_local_rank(axis))
    coords = (mesh.mesh == rank).nonzero()[0].tolist()
    return int(coords[list(mesh.mesh_dim_names).index(axis)])


def stage_layers(mesh, reps: int, axis: str = "stage", rank: int | None = None
                 ) -> tuple[int, int, int, int]:
    """``(stage, stages, lo, hi)``: a rank's pipeline stage over ``axis``
    and the block repeats ``[lo, hi)`` it holds, the contiguous slice
    ``[s * reps / S, (s + 1) * reps / S)``; ``(0, 1, 0, reps)`` without a
    stage axis."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 0, 1, 0, reps
    n = int(mesh.size(list(mesh.mesh_dim_names).index(axis)))
    if reps % n:
        raise ValueError(f"{reps} block repeats not divisible by {n} stages")
    s = mesh_coord(mesh, axis, rank)
    per = reps // n
    return s, n, s * per, (s + 1) * per


def fsdp_leaf_dim(path: str) -> int | None:
    """The dim of the stored leaf at ``path`` that ZeRO-3 may shard (its
    ``d_model``), or None for a leaf it never shards; on a block leaf's
    one-repeat slice it is one less."""
    parts = _model_path(path)
    if parts in (["embed"], ["lm_head"]):
        return _FSDP_LEAVES[tuple(parts)]
    if parts[:1] == ["blocks"] and len(parts) >= 3:
        return _FSDP_LEAVES.get(tuple(parts[-2:]))
    return None


def _model_path(path: str) -> list[str]:
    """A leaf path's words from the model tree's root: ``opt/mu/blocks/x``
    -> ``["blocks", "x"]``."""
    parts = [p for p in str(path).split("/") if p]
    while parts and parts[0] in _TREE_WORDS:
        parts = parts[1:]
    return parts


@dataclasses.dataclass(frozen=True)
class TreeLayout:
    """Where each leaf of a parameter (or AdamW, or checkpoint) tree lives
    under ``plan`` over ``mesh`` (None: one device) for the model of
    ``cfg``, which gives a tensor-parallel leaf's global size and whether
    the LM head is the embedding.  ``rank`` arguments are global ranks
    (default: this process's)."""

    plan: ShardingPlan
    mesh: object
    cfg: object

    @property
    def tied(self) -> bool:
        return bool(self.cfg.tie_embeddings)

    def _stages(self) -> int:
        if self.mesh is None or "stage" not in (self.mesh.mesh_dim_names or ()):
            return 1
        return int(self.mesh.size(list(self.mesh.mesh_dim_names).index("stage")))

    def _stage(self, rank):
        n = self._stages()
        return (0 if n == 1 else mesh_coord(self.mesh, "stage", rank)), n

    def _model_sharded(self) -> bool:
        return (self.plan.model_axis is not None and self.plan.model_size > 1
                and self.mesh is not None)

    def _experts_sharded(self, parts) -> bool:
        return (len(parts) >= 3 and parts[0] == "blocks" and parts[-2] == "moe"
                and parts[-1] in EXPERT_LEAVES and self._model_sharded())

    def _tp_leaf(self, parts) -> tuple[int, int] | None:
        """``(dim, global size of that dim)`` of a leaf tensor parallelism
        may shard over the model axis, or None."""
        if not self._model_sharded():
            return None
        cfg = self.cfg
        if parts in (["embed"], ["lm_head"]):
            return (0 if parts == ["embed"] else 1), cfg.vocab_size
        if parts[:1] == ["kv"] and parts[-1:] in (["k"], ["v"]):  # [reps, N, page, Hkv, dh]
            return 3, cfg.num_kv_heads
        if parts[:1] == ["blocks"] and tuple(parts[-2:]) in _TP_BLOCK_LEAVES:
            dim, what = _TP_BLOCK_LEAVES[tuple(parts[-2:])]
            if what == "shared_ff":
                return dim, cfg.moe.d_ff * cfg.moe.num_shared_experts
            return dim, {"heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
                         "d_ff": cfg.d_ff}[what]
        return None

    def _tp_dim(self, parts, shape, path: str) -> int | None:
        """The dim of the global leaf of ``shape`` that the model axis
        shards, or None (replicated: the size does not divide)."""
        leaf = self._tp_leaf(parts)
        if leaf is None:
            return None
        dim, p = leaf[0], self.plan.model_size
        if shape[dim] % p == 0:
            return dim
        if parts[:1] == ["kv"] and self.plan.heads_axis(self.cfg.num_heads):
            raise NotImplementedError(
                f"{path}: {shape[dim]} kv heads repeated over a model axis of {p} (the rank's "
                "pool holds repeated heads); such a pool is not checkpointed")
        return None

    def _data_sharded(self) -> bool:
        return (self.plan.fsdp_axis is not None and self.mesh is not None
                and self.plan.data_size > 1 and self.cfg.d_model % self.plan.data_size == 0)

    def fsdp_dim(self, path: str) -> int | None:
        """The dim of the stored leaf at ``path`` that the data axis shards
        under this plan (ZeRO-3), or None (the leaf is whole over it)."""
        return fsdp_leaf_dim(path) if self._data_sharded() else None

    def data_blocks(self, path: str) -> tuple[int, int] | None:
        """``(dim, n)``: the ``n`` blocks along ``dim`` in which a rank's
        gradient of the leaf at ``path`` holds the data axis's ZeRO-3
        shards: the plan's data size where the leaf is whole over a data
        axis that could shard it (a replicated plan sums a leaf's squares
        over the same blocks as ZeRO-3's ranks do), 1 where the rank holds
        its shard; None where no data axis could shard it."""
        dim = fsdp_leaf_dim(path)
        n = self.plan.data_size
        if dim is None or self.mesh is None or n <= 1 or self.cfg.d_model % n:
            return None
        return dim, 1 if self._data_sharded() else n

    def slices(self, path: str, shape, rank: int | None = None) -> tuple | None:
        """The index (a tuple of slices) of the part of the global leaf of
        ``shape`` that ``rank`` holds, or None when it holds none of it."""
        parts = _model_path(path)
        s, n = self._stage(rank)
        idx = [slice(None)] * len(shape)
        if parts[:1] == ["blocks"]:
            if n > 1:
                _, _, lo, hi = stage_layers(self.mesh, int(shape[0]), rank=rank)
                idx[0] = slice(lo, hi)
            if self._experts_sharded(parts):
                p = self.plan.model_size
                if shape[1] % p:
                    raise ValueError(f"{path}: {shape[1]} expert slots over a model axis of {p}")
                m, k = mesh_coord(self.mesh, self.plan.model_axis, rank), shape[1] // p
                idx[1] = slice(m * k, (m + 1) * k)
        elif parts == ["embed"]:
            if not (s == 0 or (s == n - 1 and self.tied)):
                return None
        elif parts in (["final_norm"], ["lm_head"]):
            if s != n - 1:
                return None
        dim = self._tp_dim(parts, shape, path)
        if dim is not None:
            m = mesh_coord(self.mesh, self.plan.model_axis, rank)
            k = shape[dim] // self.plan.model_size
            idx[dim] = slice(m * k, (m + 1) * k)
        dim = self.fsdp_dim(path)
        if dim is not None:
            i = mesh_coord(self.mesh, self.plan.fsdp_axis, rank)
            k = shape[dim] // self.plan.data_size
            idx[dim] = slice(i * k, (i + 1) * k)
        return tuple(idx)

    def global_shape(self, path: str, local_shape) -> tuple:
        """The global leaf's shape from a rank's part of it."""
        shape = list(local_shape)
        parts = _model_path(path)
        if parts[:1] == ["blocks"]:
            shape[0] *= self._stages()
            if self._experts_sharded(parts):
                shape[1] *= self.plan.model_size
        leaf = self._tp_leaf(parts)
        if leaf is not None and leaf[1] % self.plan.model_size == 0:
            shape[leaf[0]] = leaf[1]
        dim = self.fsdp_dim(path)
        if dim is not None:
            shape[dim] = self.cfg.d_model
        return tuple(shape)

    def part(self, a, path: str, rank: int | None = None):
        """``rank``'s part of the global leaf ``a`` (a tensor or an array), or
        None.  A tensor's part is a copy when it is not all of ``a``, so the
        whole leaf can go."""
        idx = self.slices(path, a.shape, rank)
        if idx is None:
            return None
        if all(i == slice(None) for i in idx):
            return a
        out = a[idx]
        return out.clone() if isinstance(out, torch.Tensor) else out

    def place(self, out, part, path: str, rank: int) -> None:
        """The inverse of :meth:`part`: write ``rank``'s ``part`` into the
        global leaf ``out`` in place."""
        out[self.slices(path, out.shape, rank)] = part

    def shard(self, tree, rank: int | None = None, prefix: str = ""):
        """``rank``'s part of every leaf of a global nested-dict tree; a leaf
        it does not hold is left out."""
        if not isinstance(tree, dict):
            return self.part(tree, prefix, rank)
        out = {}
        for k, v in tree.items():
            got = self.shard(v, rank, f"{prefix}/{k}")
            if got is not None:
                out[k] = got
        return out

    def replicated(self, path: str) -> bool:
        """True when every rank of a model group holds the same part of the
        leaf at ``path`` (its global size read from the config): the whole
        leaf, or under ZeRO-3 the group's data shard of it; False for the
        expert and the tensor-parallel leaves the model axis shards."""
        parts = _model_path(path)
        if self._experts_sharded(parts):
            return False
        leaf = self._tp_leaf(parts)
        return leaf is None or leaf[1] % self.plan.model_size != 0


def virtual_experts(num_experts: int, model_size: int) -> tuple[int, int]:
    """(virtual expert count, replication factor r).

    When E < model axis size, each expert is split into r = axis/E tensor
    shards ("virtual experts") so the expert dim shards exactly; tokens are
    dispatched to all r shards and the combine sums the partial products
    (row-split matmul identity).  When E >= axis, r = 1.
    """
    if model_size <= 1 or num_experts >= model_size:
        return num_experts, 1
    if model_size % num_experts != 0:
        raise ValueError(
            f"cannot factor {num_experts} experts over model axis {model_size}"
        )
    r = model_size // num_experts
    return num_experts * r, r


def constrain(x, mesh, spec=None):
    """Sharding constraint: the identity (layouts are explicit in the port)."""
    return x


def seq_sharded(plan: ShardingPlan, seq_len: int) -> bool:
    """True when the MoE region takes a sequence slice over the model axis
    (the reference's ``seq_ax = model``): the model size divides S."""
    return plan.model_size > 1 and seq_len % plan.model_size == 0


class _TokenSlice(torch.autograd.Function):
    """Rank ``m``'s sequence slice of ``[B, S, D]`` (the whole sequence when
    not ``sharded``).  Backward: the model group's slice gradients
    all-gathered (summed, for the whole-sequence copies), so every rank of
    the group holds the full residual-stream gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis, sharded):
        ctx.mesh, ctx.axis, ctx.sharded = mesh, axis, sharded
        if not sharded:
            return x.view_as(x)
        m, p = cr.axis_index(mesh, axis), cr.axis_size(mesh, axis)
        s = x.shape[1] // p
        return x[:, m * s:(m + 1) * s].contiguous()

    @staticmethod
    def backward(ctx, g):
        grp = cr.axis_group(ctx.mesh, ctx.axis)
        if not ctx.sharded:
            return cr.all_reduce(g, grp), None, None, None
        full = cr.all_gather_raw(g.transpose(0, 1).contiguous(), grp)
        return full.transpose(0, 1).contiguous(), None, None, None


class _TokenGather(torch.autograd.Function):
    """The MoE region's output all-gathered over the model axis along the
    sequence (the identity when not ``sharded``).  Backward: the rank's own
    slice, not summed — every rank of the group computes the same loss; the
    whole-sequence copies each take 1/P of the gradient, as the
    reference's transpose of a replicated output does."""

    @staticmethod
    def forward(ctx, y, mesh, axis, sharded):
        ctx.mesh, ctx.axis, ctx.sharded = mesh, axis, sharded
        if not sharded:
            return y.view_as(y)
        full = cr.all_gather_raw(y.transpose(0, 1).contiguous(), cr.axis_group(mesh, axis))
        ctx.size = cr.axis_size(mesh, axis)
        return full.transpose(0, 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        if not ctx.sharded:
            return g / float(cr.axis_size(ctx.mesh, ctx.axis)), None, None, None
        m = cr.axis_index(ctx.mesh, ctx.axis)
        s = g.shape[1] // ctx.size
        return g[:, m * s:(m + 1) * s].contiguous(), None, None, None


def token_slice(x: torch.Tensor, plan: ShardingPlan, mesh) -> torch.Tensor:
    """``[B, S, D]`` -> the MoE region's ``[B, S / P, D]`` (or ``[B, S, D]``)."""
    return _TokenSlice.apply(x, mesh, plan.model_axis, seq_sharded(plan, x.shape[1]))


def token_gather(y: torch.Tensor, plan: ShardingPlan, mesh, seq_len: int) -> torch.Tensor:
    """The MoE region's output back to ``[B, S, D]`` on every rank."""
    return _TokenGather.apply(y, mesh, plan.model_axis, seq_sharded(plan, seq_len))
