"""Dynamic expert placement — the TPU-native analogue of OCS circuit
allocation (DESIGN.md §2).

On a fixed-topology TPU mesh the reconfigurable degree of freedom is *which
expert lives on which device*.  The same greedy bottleneck logic as
Algorithm 1 drives a permutation of the expert->device assignment so that the
heaviest-communicating experts are co-located or placed on adjacent devices
of the ``model`` axis ring, shrinking the realized all-to-all bytes-on-wire.

The permutation is applied to the *stacked expert weight tensors* by a gather
on the expert axis — a cheap intra-region collective, charged like the
paper charges the 25 ms OCS blocking time.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "PlacementPlan",
    "solve_expert_placement",
    "placement_cost",
    "apply_placement",
    "inverse_permutation",
]


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """``perm[e]`` = new slot of expert ``e``; slots map onto devices
    round-robin (slot // experts_per_device = device)."""

    perm: np.ndarray
    cost_before: float
    cost_after: float

    @property
    def gain(self) -> float:
        return self.cost_before - self.cost_after


def placement_cost(
    token_demand: np.ndarray, perm: np.ndarray, experts_per_device: int
) -> float:
    """Bytes-on-wire of an all-to-all under an expert->slot permutation.

    ``token_demand[s, e]`` = bytes source-device ``s`` sends to expert ``e``.
    Traffic to an expert hosted on the sender's own device is free (rides the
    local VMEM/HBM path, like the paper's NVSwitch-local traffic); everything
    else crosses the region.  The region finishes when its busiest device
    (in or out) finishes, so cost = max over devices of crossing bytes.
    """
    token_demand = np.asarray(token_demand, dtype=np.float64)
    n_dev, n_exp = token_demand.shape[0], token_demand.shape[1]
    owner = perm // experts_per_device  # expert -> device
    dev_mat = np.zeros((n_dev, n_dev))
    for e in range(n_exp):
        dev_mat[:, owner[e]] += token_demand[:, e]
    cross = dev_mat.copy()
    np.fill_diagonal(cross, 0.0)
    return float(max(cross.sum(axis=1).max(initial=0), cross.sum(axis=0).max(initial=0)))


def solve_expert_placement(
    token_demand: np.ndarray,
    experts_per_device: int,
    *,
    sweeps: int = 2,
) -> PlacementPlan:
    """Greedy bottleneck-relief placement (Algorithm 1 adapted).

    Starts from the identity placement; repeatedly considers the device with
    the highest crossing traffic and tries swapping each of its experts with
    every other expert, keeping the best-improving swap (first-improvement
    over ``sweeps`` passes).  O(sweeps * E^2) with tiny constants — host-side
    control-plane code that runs every ``reconfig_every_n`` steps.
    """
    token_demand = np.asarray(token_demand, dtype=np.float64)
    n_exp = token_demand.shape[1]
    perm = np.arange(n_exp)
    before = placement_cost(token_demand, perm, experts_per_device)
    best = before
    for _ in range(sweeps):
        improved = False
        for a in range(n_exp):
            for b in range(a + 1, n_exp):
                if perm[a] // experts_per_device == perm[b] // experts_per_device:
                    continue
                perm[a], perm[b] = perm[b], perm[a]
                c = placement_cost(token_demand, perm, experts_per_device)
                if c < best - 1e-9:
                    best = c
                    improved = True
                else:
                    perm[a], perm[b] = perm[b], perm[a]
        if not improved:
            break
    return PlacementPlan(perm=perm, cost_before=before, cost_after=best)


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    return inv


def apply_placement(stacked_expert_weights, perm: np.ndarray):
    """Gather stacked ``[E, ...]`` expert tensors into their new slots.

    ``out[slot] = weights[expert_with_that_slot]`` so that device
    ``slot // experts_per_device`` now hosts the experts the plan assigned it.
    Works on a tensor (or array) or a nested dict of them whose leading axis
    is the expert axis.
    """
    inv = inverse_permutation(np.asarray(perm))

    def gather(x):
        if isinstance(x, dict):
            return {k: gather(v) for k, v in x.items()}
        return x[inv]

    return gather(stacked_expert_weights)
