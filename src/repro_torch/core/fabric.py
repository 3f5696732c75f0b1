"""Interconnect fabric models (paper §7.1 "Simulated GPU interconnect fabrics").

Every fabric answers the same three questions for the flow-level simulator
(:mod:`repro_torch.core.netsim`):

  * ``alltoall_time(demand)``   — completion time of an EP all-to-all given an
    inter-server demand matrix in bytes,
  * ``allreduce_time(bytes_)``  — completion time of a DP ring all-reduce,
  * ``p2p_time(bytes_)``        — PP stage-to-stage transfer time,

plus ``prepare(demand)`` which lets reconfigurable fabrics (MixNet, TopoOpt)
adapt — MixNet re-runs Algorithm 1 every call (runtime reconfiguration, maybe
blocking), TopoOpt only honours the first call (one-shot, pre-training).

All times are seconds; bandwidths are bytes/second per NIC.  The models are
flow-level: a transfer's rate is its allocated circuit/fallback bandwidth and
a phase completes when its slowest flow completes.  This reproduces the
paper's *relative* results (Figs 12-14, 26-28) without packet-level detail.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import topology as topo

__all__ = [
    "FabricConfig",
    "Fabric",
    "FatTree",
    "OverSubFatTree",
    "RailOptimized",
    "TopoOpt",
    "MixNetFabric",
    "make_fabric",
]

GBPS = 1e9 / 8.0  # bytes/sec per Gbps


@dataclasses.dataclass
class FabricConfig:
    num_servers: int = 128
    gpus_per_server: int = 8
    nics_per_server: int = 8
    link_gbps: float = 400.0
    # MixNet split (paper §7.1: 2 EPS + 6 OCS by default).
    eps_nics: int = 2
    ocs_nics: int = 6
    reconfig_delay_s: float = 0.025  # Polatis millisecond OCS (25 ms)
    nvlink_bytes_per_s: float = 900e9  # intra-server scale-up
    oversub_ratio: float = 3.0
    propagation_delay_s: float = 1e-6
    # Packet-switched fabrics lose a slice of line rate to ECMP hash
    # collisions / incast on skewed all-to-alls (the packet-level effect the
    # paper's htsim captures); layer-1 optical circuits do not contend.
    eps_a2a_efficiency: float = 0.90

    @property
    def nic_bw(self) -> float:
        return self.link_gbps * GBPS


class Fabric:
    """Base class: non-blocking full-bandwidth abstraction."""

    name = "abstract"

    def __init__(self, cfg: FabricConfig):
        self.cfg = cfg

    # -- reconfiguration hooks -------------------------------------------
    def prepare(self, demand: np.ndarray, *, can_hide: bool = True) -> float:
        """Adapt to the coming demand; return *blocking* seconds (not hidden)."""
        return 0.0

    # -- transfer primitives ----------------------------------------------
    def server_bandwidth(self) -> float:
        """Aggregate scale-out bandwidth of one server (bytes/s)."""
        return self.cfg.nics_per_server * self.cfg.nic_bw

    def alltoall_time(self, demand: np.ndarray) -> float:
        """Non-blocking fabrics: each server drains at its aggregate NIC bw.

        Completion = max over servers of (bytes in or out) / server bw,
        derated by the packet-fabric a2a efficiency.
        """
        demand = np.asarray(demand, dtype=np.float64)
        out_bytes = demand.sum(axis=1)
        in_bytes = demand.sum(axis=0)
        worst = max(out_bytes.max(initial=0.0), in_bytes.max(initial=0.0))
        bw = self.server_bandwidth() * self.cfg.eps_a2a_efficiency
        return worst / bw + self.cfg.propagation_delay_s

    def allreduce_time(self, bytes_per_server: float, num_servers: int | None = None) -> float:
        """Ring all-reduce: 2*(n-1)/n of the data crosses each server's NICs."""
        n = num_servers or self.cfg.num_servers
        if n <= 1:
            return 0.0
        wire = 2.0 * (n - 1) / n * bytes_per_server
        return wire / self.server_bandwidth() + n * self.cfg.propagation_delay_s

    def p2p_time(self, bytes_: float) -> float:
        return bytes_ / self.server_bandwidth() + self.cfg.propagation_delay_s

    def intra_host_time(self, bytes_: float) -> float:
        return bytes_ / self.cfg.nvlink_bytes_per_s


class FatTree(Fabric):
    """1:1 non-blocking fat-tree — the reference EPS fabric."""

    name = "fat-tree"


class OverSubFatTree(Fabric):
    """Fat-tree with 3:1 core over-subscription: inter-rack bw divided."""

    name = "oversub-fat-tree"

    def server_bandwidth(self) -> float:
        return self.cfg.nics_per_server * self.cfg.nic_bw / self.cfg.oversub_ratio


class RailOptimized(Fabric):
    """Nvidia rail-optimized topology.

    Same aggregate bandwidth as fat-tree; GPUs of the same rank share a rail
    switch, so same-rail flows take one hop while cross-rail flows first hop
    through NVSwitch (cheap).  Flow-level this is fat-tree performance with a
    small intra-host forwarding surcharge on the all-to-all (which is
    inherently cross-rail for a fraction (r-1)/r of the bytes).
    """

    name = "rail-optimized"

    def alltoall_time(self, demand: np.ndarray) -> float:
        base = super().alltoall_time(demand)
        demand = np.asarray(demand, dtype=np.float64)
        r = self.cfg.nics_per_server
        cross_rail = demand.sum() * (r - 1) / r / max(self.cfg.num_servers, 1)
        return base + self.intra_host_time(cross_rail)


class TopoOpt(Fabric):
    """TopoOpt-style one-shot optical topology (patch panel, §7.1).

    All NICs sit on a big static patch panel.  The topology is optimized once
    (first ``prepare`` call) for the demand it sees then; afterwards it never
    changes.  Traffic between pairs without a direct circuit relays through
    intermediate servers (halved effective bandwidth, one extra hop).
    """

    name = "topoopt"

    def __init__(self, cfg: FabricConfig):
        super().__init__(cfg)
        self._circuits: np.ndarray | None = None

    def prepare(self, demand: np.ndarray, *, can_hide: bool = True) -> float:
        if self._circuits is None or self._circuits.shape[0] != demand.shape[0]:
            # TopoOpt's degree-limited direct-connect topology serves DP ring
            # + PP chain + EP jointly (it co-optimizes all parallelisms over
            # one flat patch panel) — only the NICs left over from the DP/PP
            # circuits point at EP peers.
            ep_alpha = max(2, self.cfg.nics_per_server - 4)
            solved = topo.reconfigure_ocs(
                demand,
                alpha=ep_alpha,
                num_servers=demand.shape[0],
                experts_per_server=1,
            )
            self._circuits = solved.circuits
        return 0.0  # one-shot reconfig happens before training

    def alltoall_time(self, demand: np.ndarray) -> float:
        if self._circuits is None or self._circuits.shape[0] != demand.shape[0]:
            self._circuits = None
            self.prepare(demand)
        demand = np.asarray(demand, dtype=np.float64)
        # Circuits are full duplex: a pair's completion is driven by its
        # heavier direction.
        pair = np.triu(np.maximum(demand, demand.T), k=1)
        bw = self.cfg.nic_bw
        # Direct circuits at full bw; non-matching pairs relay through an
        # intermediate server, consuming two hops of somebody's circuits —
        # effectively half a link once shared.
        circ = self._circuits.astype(np.float64)
        direct_bw = np.triu(circ, k=1) * bw
        relay_bw = 0.5 * bw
        eff_bw = np.where(direct_bw > 0, direct_bw, relay_bw)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(pair > 0, pair / eff_bw, 0.0)
        return float(t.max(initial=0.0)) + self.cfg.propagation_delay_s


class MixNetFabric(Fabric):
    """MixNet: EPS (2 NICs) + regionally reconfigurable OCS (6 NICs).

    ``prepare`` re-runs Algorithm 1 for every all-to-all phase.  When the
    reconfiguration can be hidden inside compute (the 2nd FP a2a and both BP
    a2as, §5.1) the returned blocking time is zero; for the 1st FP a2a either
    COPILOT predicted the demand in advance (hidden) or the fabric blocks for
    ``reconfig_delay_s``.
    """

    name = "mixnet"

    def __init__(self, cfg: FabricConfig):
        super().__init__(cfg)
        self._circuits: np.ndarray | None = None
        self.reconfig_count = 0
        self.blocked_seconds = 0.0
        self._failed_servers: set[int] = set()
        self._degree_caps: dict[int, int] = {}

    @staticmethod
    def demand_hint(demand: np.ndarray) -> np.ndarray:
        return np.maximum(demand, demand.T)

    def fail_server_nic(self, server: int, failed_nics: int = 1) -> None:
        """§5.4 NIC failure: the server keeps running with fewer optical
        links; traffic re-routes over its remaining circuits + EPS."""
        self._degree_caps[server] = max(self.cfg.ocs_nics - failed_nics, 0)

    # -- control plane -----------------------------------------------------
    # NOTE: the demand matrix a MixNet fabric sees is *regional* — one OCS
    # slice serves one EP group (§4.2).  Its shape defines the region size;
    # cfg.num_servers only matters for the global EPS (DP/PP) paths and cost.
    def prepare(self, demand: np.ndarray, *, can_hide: bool = True) -> float:
        region = demand.shape[0]
        solved = topo.reconfigure_ocs(
            demand,
            alpha=self.cfg.ocs_nics,
            num_servers=region,
            experts_per_server=1,
        )
        circuits = solved.circuits
        if self._failed_servers or self._degree_caps:
            circuits = circuits.copy()
            for s in self._failed_servers:
                circuits[s, :] = 0
                circuits[:, s] = 0
            # Partial NIC failures: cap a server's optical degree by dropping
            # its lightest circuits (the controller re-solves around them).
            for s, cap in self._degree_caps.items():
                if s >= region:
                    continue
                while circuits[s].sum() > cap:
                    nz = np.nonzero(circuits[s])[0]
                    j = nz[np.argmin(self.demand_hint(demand)[s, nz])]
                    circuits[s, j] -= 1
                    circuits[j, s] -= 1
        self._circuits = circuits
        self.reconfig_count += 1
        block = 0.0 if can_hide else self.cfg.reconfig_delay_s
        self.blocked_seconds += block
        return block

    def fail_server_ocs(self, server: int) -> None:
        """Full optical loss for a server: EPS fallback only (§5.4)."""
        self._failed_servers.add(server)
        if self._circuits is not None:
            self._circuits[server, :] = 0
            self._circuits[:, server] = 0

    def restore_server_ocs(self, server: int) -> None:
        self._failed_servers.discard(server)

    # -- data plane ----------------------------------------------------------
    def alltoall_time(self, demand: np.ndarray) -> float:
        """Completion of one EP all-to-all on the hybrid fabric.

        The delegation runtime (§5.3) splits traffic into two classes:
          * circuit-covered pairs drain over their dedicated duplex circuits
            (contention-free layer 1) — bounded per pair by its circuit count
            and per server by its optical degree;
          * uncovered pairs multiplex over the server's EPS NICs (the runtime
            steers flows across "NICs in both the EPS and OCS fabrics").
        Completion = the slowest of the three bottlenecks.
        """
        demand = np.asarray(demand, dtype=np.float64)
        if self._circuits is None or self._circuits.shape[0] != demand.shape[0]:
            self._circuits = topo.uniform_topology(demand.shape[0], self.cfg.ocs_nics)
        bw = self.cfg.nic_bw
        circ = self._circuits.astype(np.float64)
        eps_cap = self.cfg.eps_nics * bw * self.cfg.eps_a2a_efficiency

        # Fluid completion time: find the smallest T such that every directed
        # flow d[i,j] drains within T over (a) its pair's duplex circuits at
        # full rate and (b) an EPS allocation, subject to each server's EPS
        # egress/ingress capacity.  Feasibility is monotone in T -> bisection.
        def feasible(t: float) -> bool:
            resid = np.maximum(demand - circ * bw * t, 0.0)
            out_ok = resid.sum(axis=1) <= eps_cap * t + 1e-9
            in_ok = resid.sum(axis=0) <= eps_cap * t + 1e-9
            return bool(out_ok.all() and in_ok.all())

        hi = max(
            demand.sum(axis=1).max(initial=0.0), demand.sum(axis=0).max(initial=0.0)
        ) / eps_cap + 1e-12  # everything over EPS always feasible
        lo = 0.0
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if feasible(mid):
                hi = mid
            else:
                lo = mid
        return hi + self.cfg.propagation_delay_s

    def allreduce_time(self, bytes_per_server: float, num_servers: int | None = None) -> float:
        # DP rides the EPS fabric (hierarchical all-reduce, §5.3): intra-host
        # reduce to the gateway GPU on NVSwitch, ring over EPS NICs, broadcast.
        n = num_servers or self.cfg.num_servers
        if n <= 1:
            return 0.0
        eps_bw = self.cfg.eps_nics * self.cfg.nic_bw
        wire = 2.0 * (n - 1) / n * bytes_per_server
        intra = 2.0 * self.intra_host_time(bytes_per_server)
        return wire / eps_bw + intra + n * self.cfg.propagation_delay_s

    def p2p_time(self, bytes_: float) -> float:
        eps_bw = self.cfg.eps_nics * self.cfg.nic_bw
        return bytes_ / eps_bw + self.cfg.propagation_delay_s


_FABRICS = {
    "mixnet": MixNetFabric,
    "fat-tree": FatTree,
    "oversub-fat-tree": OverSubFatTree,
    "rail-optimized": RailOptimized,
    "topoopt": TopoOpt,
}


def make_fabric(name: str, cfg: FabricConfig) -> Fabric:
    try:
        return _FABRICS[name](cfg)
    except KeyError:
        raise ValueError(f"unknown fabric {name!r}; options: {sorted(_FABRICS)}")
