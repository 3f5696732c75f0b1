"""CommRuntime: the parts the single-card slices reach.

Port of :mod:`repro.core.commruntime`: the EP all-to-all payload formula
(the serving engine's ``a2a_bytes``), the device-block test
:class:`PlacementApplier` runs before a wire re-address, and the
:class:`CommSpec` / :class:`AllToAll` pair the mixnet MoE layer builds.  At
P = 1 the all-to-all is the identity (``moe.py:291-295`` of the reference:
the op degrades to identity inside itself); a spec over more than one
device raises until the multi-device slice lowers it onto
``torch.distributed``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ep_alltoall_bytes", "device_perm_from_slots", "CommSpec", "AllToAll"]


@dataclasses.dataclass(frozen=True)
class CommSpec:
    """Where a collective runs and how its axis factors into groups
    (``axis_size = num_groups * group_size``).  The wire re-addressing
    state of the reference's spec comes with the multi-device slice."""

    axis: str | None = None
    axis_size: int = 1
    group_size: int = 1

    def __post_init__(self):
        if self.axis_size < 1 or self.group_size < 1:
            raise ValueError(f"bad CommSpec sizes: {self}")
        if 1 < self.group_size < self.axis_size and self.axis_size % self.group_size:
            raise ValueError(
                f"axis size {self.axis_size} not divisible by group size {self.group_size}"
            )

    @classmethod
    def from_plan(cls, plan, *, group_size: int = 1) -> "CommSpec":
        """Spec for the regional (``model``) axis of a ``ShardingPlan``; a
        group spanning the whole axis degrades to the flat lowering."""
        if plan.model_axis is None or plan.model_size <= 1:
            return cls(axis=None, axis_size=1)
        g = 1 if group_size >= plan.model_size else group_size
        return cls(axis=plan.model_axis, axis_size=plan.model_size, group_size=g)


@dataclasses.dataclass(frozen=True)
class AllToAll:
    """EP all-to-all over ``[P, ...]`` send layouts (chunks ordered by
    destination in, by source out).  The wire re-addressing arguments of
    the reference come with the multi-device slice."""

    spec: CommSpec

    def __call__(self, x):
        if self.spec.axis is not None and self.spec.axis_size > 1:
            raise NotImplementedError(
                "the all-to-all over more than one device comes with the multi-device slice"
            )
        return x

    def fused(self, payload, ids):
        """ONE wire transfer for a payload ``[P, C, D]`` and its int32
        metadata ``[P, C]``.  On one device nothing crosses a wire, so the
        two travel as they are (the reference packs the ids into exact
        payload lanes and unpacks them bit for bit)."""
        return self(payload), self(ids)


def ep_alltoall_bytes(
    tokens: int, top_k: int, d_model: int, dtype_bytes: int
) -> float:
    """Payload bytes of ONE EP all-to-all phase (whole EP group): every routed
    token copy carries its d_model activation row."""
    return float(tokens) * top_k * d_model * dtype_bytes


def device_perm_from_slots(
    slot_perm: np.ndarray, slots_per_device: int
) -> np.ndarray | None:
    """Collapse an expert-slot permutation to a device-level wire permutation.

    Returns ``None`` when slots cross device boundaries or are reordered
    within a device block — those plans are realized by the router-side
    re-addressing instead, and the wire layout stays put.
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
