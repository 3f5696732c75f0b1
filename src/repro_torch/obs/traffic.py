"""Traffic-matrix observatory — the paper's §3 measurement study applied to
this repo's own runs (DESIGN.md §14).

MixNet's design is licensed by a production measurement: per-iteration
expert traffic matrices show strong *locality* (a few experts/devices take
most of the traffic) and strong *regional* skew (different request regions
activate different expert mixes) — Figs 7–12.  The observatory reproduces
that study live: consumers stream per-tick/step gate loads
(``record(load, perm_stack, region_weights)``) and it accumulates

* ``expert_traffic [L, E]`` — routed token mass per layer per expert;
* ``device_traffic [L, D]`` — the same mass mapped through the *current*
  expert→slot permutation onto devices (the expert→device traffic matrix,
  under whatever placement the control plane has actuated so far);
* per-region expert mixes, when the caller attributes ticks to traffic
  regions (the fleet-steering statistics, DESIGN.md §12).

and computes the statistics the paper measures: a normalized-HHI
**locality score** per layer (0 = uniform, 1 = single-expert), the
**regional concentration** (share of a layer's traffic on the hottest
device block), the **effective expert count** ``1/Σ mix²`` (netsim's
expert-residency floor uses the same quantity), and the **regional skew**
(mean Bhattacharyya miss between each region's mix and the global mix —
the signal that makes gate-locality steering win).

Everything is plain numpy and JSON round-trippable (``report`` /
``from_report``), so a run's observatory rides the trace file as one typed
event and ``scripts/measure_run.py`` can rebuild the study offline.
"""

from __future__ import annotations

import numpy as np

__all__ = ["TrafficObservatory"]


def _bhattacharyya(a: np.ndarray, b: np.ndarray) -> float:
    a = a / max(float(a.sum()), 1e-12)
    b = b / max(float(b.sum()), 1e-12)
    return float(np.sqrt(a * b).sum())


class TrafficObservatory:
    def __init__(
        self,
        num_layers: int,
        num_experts: int,
        *,
        num_devices: int = 1,
        replication: int = 1,
        num_regions: int = 0,
    ):
        self.num_layers = int(num_layers)
        self.num_experts = int(num_experts)
        self.num_devices = max(int(num_devices), 1)
        self.replication = max(int(replication), 1)
        self.num_virtual = self.num_experts * self.replication
        self.experts_per_device = max(self.num_virtual // self.num_devices, 1)
        self.num_regions = int(num_regions)
        self.expert_traffic = np.zeros((self.num_layers, self.num_experts))
        self.device_traffic = np.zeros((self.num_layers, self.num_devices))
        self.region_traffic = np.zeros(
            (max(self.num_regions, 1), self.num_layers, self.num_experts)
        )
        self.ticks = 0

    # -- ingestion ------------------------------------------------------------
    def record(
        self,
        load,
        perm_stack=None,
        region_weights: dict[int, float] | None = None,
    ) -> None:
        """Fold one tick/step's realized gate load into the matrices.

        ``load``: ``[L, E]`` routed token mass (rows may be all-zero).
        ``perm_stack``: ``[L, E_virtual]`` expert→slot maps (the control
        plane's ``perm_stack()``); identity when omitted.  ``region_weights``
        attributes the tick's mass to traffic regions (each region's share
        of the live slots, as :meth:`ServeEngine.live_region_weights`)."""
        load = np.asarray(load, dtype=np.float64)
        if load.ndim != 2:
            raise ValueError(f"load must be [L, E], got shape {load.shape}")
        layers = min(load.shape[0], self.num_layers)
        load = load[:layers, : self.num_experts]
        self.expert_traffic[:layers] += load
        # Expert→device: each expert's mass splits evenly over its replicas;
        # a virtual slot s lives on device s // experts_per_device.
        vload = (
            np.repeat(load, self.replication, axis=1) / self.replication
        )  # [layers, E_virtual]
        if perm_stack is None:
            slots = np.tile(np.arange(self.num_virtual), (layers, 1))
        else:
            slots = np.asarray(perm_stack)[:layers, : self.num_virtual]
        devs = np.clip(slots // self.experts_per_device, 0, self.num_devices - 1)
        for l in range(layers):
            np.add.at(self.device_traffic[l], devs[l], vload[l])
        if region_weights and self.num_regions:
            for region, w in region_weights.items():
                if w > 0 and 0 <= region < self.num_regions:
                    self.region_traffic[region, :layers] += w * load
        self.ticks += 1

    # -- §3 statistics --------------------------------------------------------
    @staticmethod
    def _normalized_hhi(mass: np.ndarray) -> np.ndarray:
        """Per-row concentration in [0, 1]: 0 = uniform, 1 = single bin."""
        n = mass.shape[-1]
        s = mass.sum(axis=-1, keepdims=True)
        share = np.where(s > 0, mass / np.maximum(s, 1e-12), 1.0 / n)
        hhi = (share**2).sum(axis=-1)
        if n <= 1:
            return np.zeros_like(hhi)
        return (hhi - 1.0 / n) / (1.0 - 1.0 / n)

    def locality_per_layer(self) -> np.ndarray:
        """``[L]`` expert-traffic concentration (normalized HHI) — the §3
        'a small set of experts receives most traffic' statistic."""
        return self._normalized_hhi(self.expert_traffic)

    def locality_score(self) -> float:
        return float(self.locality_per_layer().mean())

    def device_concentration(self) -> np.ndarray:
        """``[L]`` share of each layer's traffic on its hottest device —
        the regional-concentration statistic (traffic a regional fabric can
        keep local instead of crossing regions)."""
        s = self.device_traffic.sum(axis=-1)
        top = self.device_traffic.max(axis=-1)
        return np.where(s > 0, top / np.maximum(s, 1e-12), 1.0 / self.num_devices)

    def effective_experts(self) -> np.ndarray:
        """``[L]`` effective number of experts ``1/Σ mix²`` — what the
        fleet netsim's expert-residency HBM floor streams."""
        s = self.expert_traffic.sum(axis=-1, keepdims=True)
        mix = np.where(
            s > 0,
            self.expert_traffic / np.maximum(s, 1e-12),
            1.0 / self.num_experts,
        )
        return 1.0 / np.maximum((mix**2).sum(axis=-1), 1e-12)

    def regional_skew(self) -> float:
        """Mass-weighted mean Bhattacharyya *miss* between each region's
        expert mix and the global mix, over layers — 0 when every region
        routes identically, →1 as regions activate disjoint experts."""
        if not self.num_regions:
            return 0.0
        glob = self.expert_traffic
        weights, misses = [], []
        for r in range(self.num_regions):
            mass = float(self.region_traffic[r].sum())
            if mass <= 0:
                continue
            per_layer = [
                1.0 - _bhattacharyya(self.region_traffic[r, l], glob[l])
                for l in range(self.num_layers)
                if glob[l].sum() > 0
            ]
            if per_layer:
                weights.append(mass)
                misses.append(float(np.mean(per_layer)))
        if not weights:
            return 0.0
        w = np.asarray(weights)
        return float((w * np.asarray(misses)).sum() / w.sum())

    # -- round-trip (the trace-event payload) ---------------------------------
    def report(self) -> dict:
        """The §3-style study as one JSON-able document."""
        total = self.expert_traffic.sum()
        return {
            "ticks": self.ticks,
            "num_layers": self.num_layers,
            "num_experts": self.num_experts,
            "num_devices": self.num_devices,
            "replication": self.replication,
            "num_regions": self.num_regions,
            "total_routed": float(total),
            "locality_score": self.locality_score(),
            "locality_per_layer": self.locality_per_layer().tolist(),
            "device_concentration": self.device_concentration().tolist(),
            "effective_experts": self.effective_experts().tolist(),
            "regional_skew": self.regional_skew(),
            "expert_traffic": self.expert_traffic.tolist(),
            "device_traffic": self.device_traffic.tolist(),
            "region_traffic": (
                self.region_traffic.tolist() if self.num_regions else []
            ),
        }

    @classmethod
    def from_report(cls, rep: dict) -> "TrafficObservatory":
        obs = cls(
            rep["num_layers"],
            rep["num_experts"],
            num_devices=rep.get("num_devices", 1),
            replication=rep.get("replication", 1),
            num_regions=rep.get("num_regions", 0),
        )
        obs.expert_traffic = np.asarray(rep["expert_traffic"], dtype=np.float64)
        obs.device_traffic = np.asarray(rep["device_traffic"], dtype=np.float64)
        if rep.get("region_traffic"):
            obs.region_traffic = np.asarray(
                rep["region_traffic"], dtype=np.float64
            )
        obs.ticks = int(rep.get("ticks", 0))
        return obs

    def merge(self, other: "TrafficObservatory") -> "TrafficObservatory":
        """Sum another observatory's matrices into this one (fleet view)."""
        if (self.num_layers, self.num_experts) != (
            other.num_layers, other.num_experts,
        ):
            raise ValueError("observatory shapes differ")
        self.expert_traffic += other.expert_traffic
        if self.device_traffic.shape == other.device_traffic.shape:
            self.device_traffic += other.device_traffic
        if self.region_traffic.shape == other.region_traffic.shape:
            self.region_traffic += other.region_traffic
        self.ticks += other.ticks
        return self
