"""Sharding plan — the single-device part the serving slice needs.

Port of :mod:`repro.parallel.sharding`: :class:`ShardingPlan`,
``make_plan(None)``, :func:`virtual_experts`, and :func:`constrain` as an
identity.  One card means the model axis has size P = 1; meshes, specs and
``shard_map`` come with the multi-device slice.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ShardingPlan", "make_plan", "virtual_experts", "constrain"]


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    batch_axes: tuple  # axes sharding the batch dim, e.g. ("pod", "data")
    model_axis: str | None  # TP/EP axis name (None on single-device)
    model_size: int
    fsdp_axis: str | None  # params sharded over this axis too (ZeRO-3)
    data_size: int = 1


def make_plan(mesh=None) -> ShardingPlan:
    """The no-op single-device plan (``mesh=None``)."""
    if mesh is not None:
        raise NotImplementedError("meshes come with the multi-device slice")
    return ShardingPlan((), None, 1, None, 1)


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
    """Sharding constraint: the identity without a mesh (always, here)."""
    return x
