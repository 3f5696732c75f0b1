"""CommRuntime byte formulas the serving engine's accounting uses.

Port of the two numpy helpers of :mod:`repro.core.commruntime` that the
serving slice reaches: the EP all-to-all payload formula (the engine's
``a2a_bytes``) and the device-block test :class:`PlacementApplier` runs
before a wire re-address.  The collectives themselves come with the
multi-device slice.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ep_alltoall_bytes", "device_perm_from_slots"]


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
