"""Unified runtime-reconfiguration control plane (paper Fig 20, DESIGN.md
§3), port of :mod:`repro.core.controlplane`.

One engine drives the monitor -> COPILOT -> solve -> reconfigure loop for
both consumers of runtime reconfiguration:

  * the flow-level simulator (:mod:`repro_torch.core.netsim`), where a
    decision is a per-layer OCS cross-map actuated through
    ``fabric.prepare`` with the hide-or-block semantics of §5.1 (OCS mode,
    a bound ``fabric``), and
  * the trainer and the serving engine, where a decision is a per-layer
    expert->slot permutation applied to the stacked expert weights and
    threaded to the router (placement mode)::

    engine.observe(layer, load)   # every step, every MoE layer (monitor)
    engine.end_step()             # advance the window + batched COPILOT refit
    plan = engine.plan(layer)     # per-layer decision (solve + hysteresis)
    engine.apply(plan)            # actuate: OCS cross-map or perm stack

Failure handling (§5.4) goes through the same engine: in OCS mode the bound
fabric masks the failed server's circuits, in placement mode the engine
emits failover plans.  ``end_step`` refits COPILOT
(:mod:`repro_torch.core.copilot`) across all layers in one batched call.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import commruntime as cr
from repro_torch.core.copilot import CopilotPredictor
from repro_torch.core.placement import (
    inverse_permutation,
    placement_cost,
    solve_expert_placement,
)
from repro_torch.core.traffic import TrafficMonitor
from repro_torch.obs import metrics, trace
from repro_torch.parallel.sharding import EXPERT_LEAVES

__all__ = [
    "EXPERT_LEAVES",
    "LayerPlan",
    "ControlPlane",
    "FailureHandler",
    "PlacementApplier",
    "RegionGateStats",
    "permute_expert_weights",
]


class RegionGateStats:
    """Region-conditioned expert-mix statistics (EWMA per traffic region).

    The paper's §3 measurement — gate load is *regionally* skewed — applied
    at the granularity a fleet steers on: for every traffic region ``r`` keep
    an exponentially weighted per-layer expert mix ``mix[r] : [L, E]`` plus a
    confidence weight (total observation mass).  Each serving tick a replica
    attributes its observed gate load to the regions of its live requests
    (weights = each region's share of live slots); with locality steering the
    replicas become region-pure and the per-region statistics sharpen — the
    self-reinforcing loop DESIGN.md §12 describes.

    Everything is plain numpy and JSON-serializable (``state_dict``) so the
    stats ride the same checkpoint path as the placement perms.
    """

    def __init__(self, num_regions: int, num_layers: int, num_experts: int,
                 *, alpha: float = 0.3):
        self.num_regions = num_regions
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.alpha = alpha
        self.mix = np.full(
            (num_regions, num_layers, num_experts), 1.0 / num_experts
        )
        self.weight = np.zeros(num_regions)

    def observe(self, region_weights: dict[int, float], load: np.ndarray) -> None:
        """Fold one tick's gate load ``[L, E]`` into each live region's EWMA,
        scaled by that region's share of the tick's live slots."""
        load = np.asarray(load, dtype=np.float64)
        s = load.sum(axis=-1, keepdims=True)
        norm = np.where(s > 0, load / np.maximum(s, 1e-12), 1.0 / load.shape[-1])
        for region, w in region_weights.items():
            if w <= 0 or not (0 <= region < self.num_regions):
                continue
            a = min(self.alpha * w, 1.0)
            self.mix[region] = (1.0 - a) * self.mix[region] + a * norm
            self.weight[region] += w

    def mix_for(self, region: int) -> np.ndarray | None:
        """``[L, E]`` mix estimate, or None while the region is still cold."""
        if not (0 <= region < self.num_regions) or self.weight[region] < 1.0:
            return None
        return self.mix[region]

    @staticmethod
    def merged(stats: list["RegionGateStats | None"]) -> "RegionGateStats | None":
        """Fleet-level view: confidence-weighted average across replicas."""
        live = [s for s in stats if s is not None]
        if not live:
            return None
        out = RegionGateStats(
            live[0].num_regions, live[0].num_layers, live[0].num_experts
        )
        for r in range(out.num_regions):
            w = np.array([s.weight[r] for s in live])
            out.weight[r] = w.sum()
            if out.weight[r] > 0:
                out.mix[r] = sum(
                    s.mix[r] * wr for s, wr in zip(live, w)
                ) / out.weight[r]
        return out

    def state_dict(self) -> dict:
        return {"mix": self.mix.tolist(), "weight": self.weight.tolist(),
                "alpha": self.alpha}

    def load_state_dict(self, state: dict) -> None:
        mix = np.asarray(state["mix"], dtype=np.float64)
        if mix.shape != self.mix.shape:
            raise ValueError(
                f"region stats shape {mix.shape} != {self.mix.shape}"
            )
        self.mix = mix
        self.weight = np.asarray(state["weight"], dtype=np.float64)
        self.alpha = float(state.get("alpha", self.alpha))


def permute_expert_weights(params, inv_stack: np.ndarray, num_virtual: int, *, mesh=None,
                           axis: str | None = None, layers: tuple[int, int] | None = None):
    """Move every MoE block's stacked expert tensors into their new slots.

    ``inv_stack`` is ``[L, E_virtual]`` of per-layer *inverse* permutations
    (``inv[s]`` = the slot whose expert moves into slot ``s``); identity rows
    leave a layer untouched.  Applied to every ``[L, E_virtual, ...]`` leaf
    under ``params["blocks"][*]["moe"]`` — the weight-side half of a
    reconfiguration, mirrored by the router-side ``perm_stack`` composition
    in :meth:`ControlPlane.apply`.

    IN PLACE, one layer and one leaf at a time, walking each permutation
    cycle with a single expert's slice as scratch: a whole-stack gather
    would need a second copy of every expert weight (at grok-1's width one
    layer's leaf alone is 3.2 GB).

    Over a mesh whose ``axis`` shards the slots (each rank holds ``[L,
    E_virtual / P, ...]``), the slots a plan moves across ranks travel in one
    all-to-all over the axis per layer and leaf (:func:`_exchange_slots`);
    under ZeRO-3 each rank's slots are its data shard of them, so each data
    coordinate's model group exchanges its own shards.

    ``layers=(lo, hi)``: ``params`` holds the repeats ``[lo, hi)`` of the
    stack (a pipeline stage's), so only those rows of ``inv_stack`` apply."""
    inv_stack = np.asarray(inv_stack)
    if layers is not None:
        inv_stack = inv_stack[layers[0]:layers[1]]
    reps = inv_stack.shape[0]
    if mesh is not None and axis is not None:
        if cr.axis_size(mesh, axis) > 1:
            return _permute_sharded(params, inv_stack, num_virtual, mesh, axis)
    for bparams in params["blocks"].values():
        if "moe" not in bparams:
            continue
        for wname in EXPERT_LEAVES:
            leaf = bparams["moe"][wname]
            if leaf.dim() < 2 or leaf.shape[0] != reps or leaf.shape[1] != num_virtual:
                continue
            for layer in range(reps):
                _permute_slots_(leaf[layer], inv_stack[layer])
    return params


@torch.no_grad()
def _permute_slots_(w: torch.Tensor, inv: np.ndarray) -> None:
    """``w[s] <- w[inv[s]]`` for every slot, in place, cycle by cycle."""
    done = np.zeros(len(inv), dtype=bool)
    for start in range(len(inv)):
        if done[start] or inv[start] == start:
            done[start] = True
            continue
        scratch = w[start].clone()
        s = start
        while inv[s] != start:
            w[s].copy_(w[inv[s]])
            done[s] = True
            s = int(inv[s])
        w[s].copy_(scratch)
        done[s] = True


def _permute_sharded(params, inv_stack: np.ndarray, num_virtual: int, mesh, axis: str):
    p, m = cr.axis_size(mesh, axis), cr.axis_index(mesh, axis)
    epd = num_virtual // p
    group = cr.axis_group(mesh, axis)
    reps = inv_stack.shape[0]
    for bparams in params["blocks"].values():
        if "moe" not in bparams:
            continue
        for wname in EXPERT_LEAVES:
            leaf = bparams["moe"][wname]
            if leaf.dim() < 2 or leaf.shape[0] != reps or leaf.shape[1] != epd:
                continue
            for layer in range(reps):
                if (inv_stack[layer] != np.arange(num_virtual)).any():
                    _exchange_slots(leaf[layer], inv_stack[layer], m, p, epd, group)
    return params


@torch.no_grad()
def _exchange_slots(w: torch.Tensor, inv: np.ndarray, m: int, p: int, epd: int, group) -> None:
    """``w [epd, ...]`` holds global slots ``m * epd ..``; set ``slot s <-
    slot inv[s]`` for each of them, in place.  Every rank sends, in slot
    order, the rows the other ranks' slots take from it (its own included),
    through one all-to-all with split sizes."""
    send_rows, in_split = [], []
    for q in range(p):
        rows = [int(inv[s]) - m * epd for s in range(q * epd, (q + 1) * epd)
                if int(inv[s]) // epd == m]
        send_rows += rows
        in_split.append(len(rows))
    mine = range(m * epd, (m + 1) * epd)
    order = [s - m * epd for q in range(p) for s in mine if int(inv[s]) // epd == q]
    out_split = [sum(1 for s in mine if int(inv[s]) // epd == q) for q in range(p)]
    flat = w.reshape(epd, -1)
    send = flat[torch.as_tensor(send_rows, dtype=torch.long, device=w.device)]
    recv = cr.all_to_all_rows(send, in_split, out_split, group)
    flat[torch.as_tensor(order, dtype=torch.long, device=w.device)] = recv


@dataclasses.dataclass
class LayerPlan:
    """One layer's reconfiguration decision.

    Exactly one of ``perm`` (placement mode: expert->slot permutation over
    the *current slot occupancy*) and ``demand`` (OCS mode: the demand
    matrix to actuate through ``fabric.prepare``) is set when
    ``reconfigure`` is True.
    """

    layer: int
    reconfigure: bool
    perm: np.ndarray | None = None
    demand: np.ndarray | None = None
    predicted: bool = False  # demand came from COPILOT, not observation
    gain_bytes: float = 0.0
    reason: str = ""


class FailureHandler:
    """§5.4 failure handling at the placement level.

    Devices are slots on the ``model`` axis.  A failed device's experts are
    re-homed onto backup slots spread over survivors, producing an expert
    permutation the runtime applies exactly like a routine reconfiguration.
    """

    def __init__(self, num_experts: int, num_devices: int):
        if num_experts % num_devices != 0:
            raise ValueError("experts must divide devices for slot bookkeeping")
        self.num_experts = num_experts
        self.num_devices = num_devices
        self.experts_per_device = num_experts // num_devices
        self.failed: set[int] = set()

    def fail_device(self, device: int) -> None:
        if device < 0 or device >= self.num_devices:
            raise ValueError("bad device id")
        self.failed.add(device)
        if len(self.failed) >= self.num_devices:
            raise RuntimeError("all devices failed — unrecoverable")

    def restore_device(self, device: int) -> None:
        self.failed.discard(device)

    def healthy_devices(self) -> list[int]:
        return [d for d in range(self.num_devices) if d not in self.failed]

    def remap(self) -> np.ndarray:
        """Expert -> slot map avoiding failed devices (elastic capacity).

        Experts originally on failed devices round-robin onto healthy ones;
        healthy experts keep their slots where possible (minimal movement,
        'minor topology adjustments' per §5.4).  Overflow slots live past the
        nominal range; ``device_of_slot`` translates slot -> device.
        """
        epd = self.experts_per_device
        healthy = self.healthy_devices()
        if not healthy:
            raise RuntimeError("no healthy devices")
        slots = np.full(self.num_experts, -1, dtype=np.int64)
        for e in range(self.num_experts):
            dev = e // epd
            if dev not in self.failed:
                slots[e] = e
        overflow = {d: 0 for d in healthy}
        cursor = 0
        for e in range(self.num_experts):
            if slots[e] >= 0:
                continue
            dev = healthy[cursor % len(healthy)]
            cursor += 1
            slots[e] = self.num_experts + dev * epd + overflow[dev]
            overflow[dev] += 1
        return slots

    def swap_remap(self) -> np.ndarray:
        """Bounded failover *permutation* over ``[0, E)``.

        Every expert homed on a failed device swaps slots with a round-robin
        chosen backup expert on a healthy device.  Unlike :meth:`remap` this
        stays within the nominal slot range, so stacked ``[L, E, ...]``
        weight tensors keep their shape — the TPU analogue of pre-provisioned
        backup slots.  The displaced (cold) backup experts are the ones
        parked on the failed device.
        """
        epd = self.experts_per_device
        healthy = self.healthy_devices()
        if not healthy:
            raise RuntimeError("no healthy devices")
        perm = np.arange(self.num_experts)
        cursor = 0
        for e in range(self.num_experts):
            if e // epd not in self.failed:
                continue
            dev = healthy[cursor % len(healthy)]
            backup = dev * epd + (cursor // len(healthy)) % epd
            perm[e], perm[backup] = perm[backup], perm[e]
            cursor += 1
        return perm

    def device_of_slot(self, slot: int) -> int:
        if slot < self.num_experts:
            return slot // self.experts_per_device
        return (slot - self.num_experts) // self.experts_per_device


class ControlPlane:
    """The shared reconfiguration engine (one per reconfigurable region).

    OCS mode (``fabric`` bound): plans carry demand matrices and ``apply``
    actuates them through ``fabric.prepare`` with hide-or-block accounting.
    Placement mode (no fabric): plans carry expert permutations over the
    current slot occupancy and ``apply`` composes them into the per-layer
    ``perm_stack`` the model's router consumes.
    """

    def __init__(
        self,
        num_layers: int,
        num_experts: int,
        *,
        num_devices: int = 1,
        replication: int = 1,
        fabric=None,
        window: int = 8,
        min_gain_fraction: float = 0.05,
        reconfig_cost_bytes: float = 0.0,
        use_copilot: bool = True,
        fit_steps: int = 150,
        batched_refit: bool = True,
        num_regions: int = 0,
    ):
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.num_devices = max(num_devices, 1)
        self.replication = max(replication, 1)
        self.num_virtual = num_experts * self.replication
        self.experts_per_device = max(self.num_virtual // self.num_devices, 1)
        self.fabric = fabric
        self.min_gain_fraction = min_gain_fraction
        self.reconfig_cost_bytes = reconfig_cost_bytes
        self.monitor = TrafficMonitor(num_layers, num_experts, window=window)
        self.copilot = (
            CopilotPredictor(
                num_layers, num_experts, fit_steps=fit_steps, batched_refit=batched_refit
            )
            if use_copilot and num_layers > 1
            else None
        )
        self.failures = (
            FailureHandler(self.num_virtual, self.num_devices)
            if self.num_devices > 1 and self.num_virtual % self.num_devices == 0
            else None
        )
        self.layer_perms = np.tile(
            np.arange(self.num_virtual, dtype=np.int64), (num_layers, 1)
        )
        self.reconfig_count = 0
        # Measurement plane (DESIGN.md §14): cached metric children so the
        # per-step observe path stays one float add.
        _m = metrics.default()
        self._m_steps = _m.counter("controlplane.steps")
        self._m_plan_go = _m.counter("controlplane.plans", verdict="reconfigure")
        self._m_plan_hold = _m.counter("controlplane.plans", verdict="hold")
        # Per-replica region-conditioned stats (fleet steering, DESIGN.md §12).
        self.region_stats = (
            RegionGateStats(num_regions, num_layers, num_experts)
            if num_regions > 0
            else None
        )

    @classmethod
    def for_simulation(
        cls,
        model,
        fabric,
        *,
        num_servers_region: int | None = None,
        gpus_per_server: int = 8,
        use_copilot: bool = True,
        fit_steps: int = 60,
    ) -> "ControlPlane":
        """Engine for one simulated PP stage's EP region (netsim consumer)."""
        region = num_servers_region or max(model.gpus_per_stage // gpus_per_server, 2)
        return cls(
            num_layers=model.layers_per_stage,
            num_experts=model.num_experts,
            num_devices=region,
            fabric=fabric,
            use_copilot=use_copilot,
            fit_steps=fit_steps,
        )

    # -- lifecycle: observe ---------------------------------------------------
    def observe(self, layer: int, expert_load, device_matrix=None) -> None:
        """Record one layer's realized expert load for this step."""
        self.monitor.record(layer, expert_load, device_matrix)

    def observe_regions(self, region_weights: dict[int, float],
                        load: np.ndarray) -> None:
        """Attribute one tick's ``[L, E]`` gate load to traffic regions
        (no-op unless the engine was built with ``num_regions > 0``)."""
        if self.region_stats is not None and region_weights:
            self.region_stats.observe(region_weights, load)

    def end_step(self) -> None:
        """Close the step: advance the monitor window, refit COPILOT (one
        batched call across all layers)."""
        self._m_steps.inc()
        self.monitor.advance()
        if self.copilot is not None:
            self.copilot.update(self.monitor)

    # -- lifecycle: predict ---------------------------------------------------
    def predict_load(self, layer: int) -> np.ndarray | None:
        """COPILOT forecast of ``layer``'s load from layer-1's latest
        observation (§B.1): what the FP's first all-to-all is planned from,
        before the gate of ``layer`` has run.  None when unavailable."""
        if self.copilot is None or layer < 1:
            return None
        prev = self.monitor.loads(layer - 1)
        if not len(prev):
            return None
        src = min(layer - 1, self.copilot.num_layers - 2)
        return self.copilot.predict(src, prev[-1])

    # -- lifecycle: plan ------------------------------------------------------
    def plan(
        self,
        layer: int,
        demand: np.ndarray | None = None,
        *,
        predicted: bool = False,
    ) -> LayerPlan:
        """Per-layer decision with its gain/hysteresis verdict journaled as
        a structured reconfiguration audit event (DESIGN.md §14)."""
        p = self._plan(layer, demand, predicted=predicted)
        (self._m_plan_go if p.reconfigure else self._m_plan_hold).inc()
        tr = trace.default()
        if tr.enabled:
            tr.audit("controlplane.plan", {
                "layer": p.layer,
                "reconfigure": p.reconfigure,
                "gain_bytes": float(p.gain_bytes),
                "reason": p.reason,
                "predicted": bool(p.predicted),
            }, cat="reconfig_audit")
        return p

    def _plan(
        self,
        layer: int,
        demand: np.ndarray | None = None,
        *,
        predicted: bool = False,
    ) -> LayerPlan:
        """Per-layer reconfiguration decision.

        OCS mode: ``demand`` is the region's ``[S, S]`` inter-server matrix
        (observed or COPILOT-predicted) and the plan carries it to the
        fabric; Algorithm 1 runs inside ``fabric.prepare``.

        Placement mode: ``demand`` is ``[D, E_virtual]`` bytes device->slot;
        when omitted it is proxied from the monitor's latest load for the
        layer, mapped through the current slot occupancy.  The plan passes
        the hide-or-block hysteresis only when the predicted byte gain beats
        the permutation's own cost.
        """
        if self.fabric is not None:
            if demand is None:
                raise ValueError("OCS mode requires an explicit demand matrix")
            return LayerPlan(
                layer, True, demand=np.asarray(demand, dtype=np.float64),
                predicted=predicted, reason="ocs cross-map",
            )
        if demand is None:
            demand = self._demand_proxy(layer)
        if demand is None:
            return LayerPlan(layer, False, reason="no traffic observed")
        demand = np.asarray(demand, dtype=np.float64)
        solved = solve_expert_placement(demand, self.experts_per_device)
        perm, cost_after = solved.perm, solved.cost_after
        if self.failures is not None and self.failures.failed:
            perm = self._park_coldest_on_failed(perm, demand.sum(axis=0))
            cost_after = placement_cost(demand, perm, self.experts_per_device)
        gain = solved.cost_before - cost_after
        threshold = self.min_gain_fraction * max(solved.cost_before, 1e-9)
        if gain <= max(threshold, 0.0) or gain <= self.reconfig_cost_bytes:
            return LayerPlan(
                layer, False, gain_bytes=gain, reason="gain below reconfig cost"
            )
        return LayerPlan(
            layer, True, perm=perm, gain_bytes=gain, reason="bottleneck relief"
        )

    def _demand_proxy(self, layer: int) -> np.ndarray | None:
        """``[D, E_virtual]`` demand proxy from the layer's latest load:
        every data shard contributes tokens proportional to the global load,
        expressed over the *current slot occupancy* so routine plans compose
        correctly after earlier reconfigurations."""
        loads = self.monitor.loads(layer)
        if not len(loads):
            return None
        vload = np.repeat(loads[-1], self.replication) / self.replication
        occupant = inverse_permutation(self.layer_perms[layer])
        slot_load = vload[occupant]
        return np.tile(slot_load[None, :], (self.num_devices, 1))

    def _park_coldest_on_failed(
        self, perm: np.ndarray, slot_load: np.ndarray
    ) -> np.ndarray:
        """Adjust a solved permutation so failed devices host only the
        coldest experts (their traffic is the §5.4 degradation we accept)."""
        epd = self.experts_per_device
        failed_slots = {
            s for s in range(self.num_virtual) if s // epd in self.failures.failed
        }
        if not failed_slots:
            return perm
        perm = perm.copy()
        k = len(failed_slots)
        cold = set(np.argsort(slot_load, kind="stable")[:k].tolist())
        hot_on_failed = [
            c for c in range(self.num_virtual)
            if perm[c] in failed_slots and c not in cold
        ]
        cold_elsewhere = [c for c in sorted(cold) if perm[c] not in failed_slots]
        for a, b in zip(hot_on_failed, cold_elsewhere):
            perm[a], perm[b] = perm[b], perm[a]
        return perm

    # -- lifecycle: apply -----------------------------------------------------
    def apply(self, plan: LayerPlan, *, hide_window: float = math.inf) -> float:
        """Actuate a plan; returns the *blocking* seconds (0 when hidden).

        OCS mode mirrors §5.1's hide-or-block: only the part of the
        reconfiguration delay that does not fit in ``hide_window`` (the
        pipelined compute between the phase's all-to-alls) stalls the pipe.
        Placement mode composes the layer's permutation into ``perm_stack``;
        the caller moves the expert weights with the matching inverse
        permutation (:class:`PlacementApplier`).
        """
        if not plan.reconfigure:
            return 0.0
        if self.fabric is not None:
            overflow = max(0.0, self.fabric.cfg.reconfig_delay_s - hide_window)
            blocked = self.fabric.prepare(plan.demand, can_hide=overflow <= 0.0)
            self.reconfig_count += 1
            metrics.counter("controlplane.reconfigs", mode="ocs").inc()
            return min(blocked, overflow)
        base = self.layer_perms[plan.layer]
        self.layer_perms[plan.layer] = plan.perm[base]
        self.reconfig_count += 1
        metrics.counter("controlplane.reconfigs", mode="placement").inc()
        return 0.0

    def perm_stack(self) -> np.ndarray:
        """``[L, E_virtual]`` per-layer expert->slot maps for the router."""
        return self.layer_perms.astype(np.int32).copy()

    # -- state round-trip (checkpointable placement, DESIGN.md §9) ------------
    def state_dict(self) -> dict:
        """JSON-serializable placement state: what a checkpoint must carry so
        a restored server resumes with the SAME expert placement (the perm
        stack composes against physically permuted weights — restoring one
        without the other would misroute every token)."""
        state = {
            "layer_perms": self.layer_perms.tolist(),
            "reconfig_count": int(self.reconfig_count),
        }
        if self.region_stats is not None:
            state["region_stats"] = self.region_stats.state_dict()
        return state

    def load_state_dict(self, state: dict) -> None:
        perms = np.asarray(state["layer_perms"], dtype=np.int64)
        if perms.shape != self.layer_perms.shape:
            raise ValueError(
                f"perm stack shape {perms.shape} does not match engine "
                f"{self.layer_perms.shape}"
            )
        for row in perms:
            if sorted(row.tolist()) != list(range(self.num_virtual)):
                raise ValueError(f"not a permutation row: {row}")
        self.layer_perms = perms
        self.reconfig_count = int(state.get("reconfig_count", 0))
        if self.region_stats is not None and "region_stats" in state:
            self.region_stats.load_state_dict(state["region_stats"])

    # -- failures (§5.4) ------------------------------------------------------
    def fail_device(self, device: int) -> list[LayerPlan]:
        """A server/device drops out of the region.

        OCS mode: the bound fabric loses the server's optical circuits (EPS
        fallback, ``MixNetFabric.fail_server_ocs``) and subsequent plans
        route around it; no placement plans.  Placement mode: returns
        per-layer failover plans (bounded remap permutations) for the
        consumer to apply through the standard decide/apply path.
        """
        if self.failures is not None:
            self.failures.fail_device(device)
        if self.fabric is not None:
            self.fabric.fail_server_ocs(device)
            return []
        if self.failures is None:
            raise ValueError("placement-mode failures need >= 2 devices")
        perm = self.failures.swap_remap()
        return [
            LayerPlan(l, True, perm=perm.copy(), reason="failover remap")
            for l in range(self.num_layers)
        ]

    def fail_nic(self, server: int, failed_nics: int = 1) -> None:
        """Partial NIC failure: the server keeps running with fewer optical
        links (OCS mode only; the fabric reroutes over the rest + EPS)."""
        if self.fabric is None:
            raise ValueError("NIC failures only exist in OCS (fabric) mode")
        self.fabric.fail_server_nic(server, failed_nics)

    def restore_device(self, device: int) -> None:
        if self.failures is not None:
            self.failures.restore_device(device)
        if self.fabric is not None:
            self.fabric.restore_server_ocs(device)

    def failover_slots(self) -> np.ndarray:
        """§5.4 elastic remap (overflow slots allowed) — exposed for
        consumers that relocate state rather than permute it."""
        if self.failures is None:
            raise ValueError("no failure bookkeeping for this region")
        return self.failures.remap()


class PlacementApplier:
    """Shared actuation of placement-mode :class:`LayerPlan` batches against
    stacked expert weights — the runtime half both the trainer and the
    serving engine drive (DESIGN.md §3/§9).

    A plan whose permutation moves whole device blocks is installed as a
    **wire re-address** (``device_perm_from_slots`` -> a per-layer ``[P]``
    device map threaded to the a2a's ``dest_perm``/``src_perm``) — the
    expert weights never move, exactly like pushing a new cross-map to the
    OCS.  Any other plan falls back to the weight gather
    (:func:`permute_expert_weights`), flushing the layer's pending wire perm
    into the same gather so the two realizations always compose.
    Router-side perms go through the engine either way (``perm[base]``
    ordering in :meth:`ControlPlane.apply`).
    """

    def __init__(self, cp: ControlPlane, *, model_size: int = 1, wire_capable: bool = False,
                 mesh=None, axis: str | None = None, layers: tuple[int, int] | None = None):
        self.cp = cp
        self.model_size = max(model_size, 1)
        # Over a mesh the expert slots shard over ``axis``: the weight path
        # exchanges the slots a plan moves across ranks.  On a pipeline
        # stage the weights hold the layers ``[lo, hi)`` only: a plan for
        # another stage's layer moves nothing here, but the perm stack and
        # the wire maps stay whole on every rank.
        self.mesh, self.axis, self.layers = mesh, axis, layers
        # Wire re-addressing needs the mixnet data plane and a control-plane
        # device space that IS the model axis (one slot block per device).
        self.wire_capable = (
            wire_capable
            and self.model_size > 1
            and cp.num_devices == self.model_size
        )
        self.wire_perm: np.ndarray | None = None
        self.wire_reconfig_count = 0
        # Plans for the layers these weights hold, by how they were realized
        # (on a pipeline stage: that stage's share of the counts above).
        self.applied_here = {"wire": 0, "weight": 0}

    def apply(self, params, plans: list[LayerPlan]):
        """Actuate ``plans``; returns ``(params, changed)``."""
        cp = self.cp
        live = [p for p in plans if p.reconfigure]
        if not live:
            return params, False
        ev = cp.num_virtual
        epd = cp.experts_per_device
        p_axis = self.model_size
        inv_stack = np.tile(np.arange(ev, dtype=np.int64), (cp.num_layers, 1))
        gather_needed = False
        for p in live:
            devp = (
                cr.device_perm_from_slots(np.asarray(p.perm), epd)
                if self.wire_capable
                else None
            )
            if devp is not None:
                # Wire path: the occupant of logical device a moves to device
                # devp[a]; physically nothing moves, so the layer's device
                # map composes as D'[k] = D[devp^-1[k]].
                if self.wire_perm is None:
                    self.wire_perm = np.tile(
                        np.arange(p_axis, dtype=np.int64), (cp.num_layers, 1)
                    )
                d_cur = self.wire_perm[p.layer]
                self.wire_perm[p.layer] = d_cur[inverse_permutation(devp)]
                self.wire_reconfig_count += 1
                self._count_here(p.layer, "wire")
                metrics.counter("placement.applies", mode="wire").inc()
                continue
            inv = inverse_permutation(p.perm)
            if self.wire_perm is not None and (
                self.wire_perm[p.layer] != np.arange(p_axis)
            ).any():
                # Flush the pending wire perm into this gather: new physical
                # slot s receives Phi(perm^-1(s)) where Phi maps logical slot
                # -> physical slot under the current device map.
                d_cur = self.wire_perm[p.layer]
                slots = np.arange(ev)
                phi = d_cur[slots // epd] * epd + slots % epd
                inv = phi[inv]
                self.wire_perm[p.layer] = np.arange(p_axis)
            inv_stack[p.layer] = inv
            gather_needed = True
            self._count_here(p.layer, "weight")
            metrics.counter("placement.applies", mode="weight_gather").inc()
        if gather_needed:
            params = permute_expert_weights(params, inv_stack, ev, mesh=self.mesh,
                                            axis=self.axis, layers=self.layers)
        for p in live:
            cp.apply(p)
        return params, True

    def _count_here(self, layer: int, how: str) -> None:
        if self.layers is None or self.layers[0] <= layer < self.layers[1]:
            self.applied_here[how] += 1

    # -- state round-trip -----------------------------------------------------
    def state_dict(self) -> dict:
        return {
            "controlplane": self.cp.state_dict(),
            "wire_perm": None if self.wire_perm is None else self.wire_perm.tolist(),
            "wire_reconfig_count": int(self.wire_reconfig_count),
            "model_size": int(self.model_size),
        }

    def load_state_dict(self, state: dict) -> bool:
        """Restore a saved placement; returns True when it was folded.

        At the saved model size the perm stack, the wire maps, the counts
        and the region statistics restore as saved.  At another (a state
        without ``model_size`` was saved at its wire map's width, or at this
        size) the wire map is folded into the perm stack, ``perm =
        wire[perm // epd] * epd + perm % epd`` (the stored expert arrays are
        in physical slot order, so no data moves), the wire map becomes the
        identity and the region statistics start fresh.  A state of another
        number of virtual experts raises ``ValueError``."""
        cp_state = dict(state["controlplane"])
        perms = np.asarray(cp_state["layer_perms"], dtype=np.int64)
        if perms.ndim != 2 or perms.shape[1] != self.cp.num_virtual:
            raise ValueError(
                f"the saved placement addresses {perms.shape[-1]} virtual experts, this "
                f"engine {self.cp.num_virtual}: a restore may not change the number of "
                "virtual experts (E < P on either side)")
        wp = state.get("wire_perm")
        wire = None if wp is None else np.asarray(wp, dtype=np.int64)
        saved = int(state.get("model_size", wire.shape[1] if wire is not None
                              else self.model_size))
        folded = saved != self.model_size
        if folded:
            if wire is not None:
                epd = perms.shape[1] // wire.shape[1]
                perms = np.take_along_axis(wire, perms // epd, axis=1) * epd + perms % epd
            cp_state["layer_perms"] = perms.tolist()
            cp_state.pop("region_stats", None)
            wire = None
        self.cp.load_state_dict(cp_state)
        self.wire_perm = wire
        self.wire_reconfig_count = int(state.get("wire_reconfig_count", 0))
        return folded
