"""Networking cost model (paper §7.2, Table 4, Fig 11) and Pareto analysis
(Fig 13: performance-per-dollar).

Component prices are Table 4 verbatim.  Only *actually used* switch ports are
billed, matching the paper's methodology (which follows TopoOpt's).
"""

from __future__ import annotations

import dataclasses
import math

__all__ = [
    "ComponentPrices",
    "PRICES",
    "fabric_cost",
    "cost_efficiency",
]


@dataclasses.dataclass(frozen=True)
class ComponentPrices:
    transceiver: float
    nic: float
    eps_port: float
    ocs_port: float
    patch_panel_port: float
    fiber: float = 20.0  # per-link fiber cost, TopoOpt methodology


# Table 4 (USD), keyed by link bandwidth in Gbps.
PRICES: dict[int, ComponentPrices] = {
    100: ComponentPrices(99, 659, 187, 520, 100),
    200: ComponentPrices(239, 1079, 374, 520, 100),
    400: ComponentPrices(659, 1499, 1090, 520, 100),
    800: ComponentPrices(1399, 2248, 1400, 520, 100),
}


def _fat_tree_ports(num_servers: int, nics_per_server: int) -> int:
    """Used EPS switch ports for a 3-tier 1:1 fat-tree hosting N*nics links.

    A k-ary fat-tree serves k^3/4 hosts with 5k^3/4 switch ports (k^3/2 edge +
    k^3/2 aggregation + k^3/4 core): 5 switch ports per host link, each port
    carrying its own transceiver.
    """
    host_links = num_servers * nics_per_server
    return 5 * host_links


def fabric_cost(
    fabric_name: str,
    num_servers: int,
    link_gbps: int,
    *,
    nics_per_server: int = 8,
    eps_nics: int = 2,
    ocs_nics: int = 6,
    oversub_ratio: float = 3.0,
) -> float:
    """Total networking cost (USD) of one cluster interconnect.

    Components per fabric:
      fat-tree / rail-optimized: NICs + host transceivers + 3-tier switch
        ports with a transceiver on every switch port.
      oversub fat-tree: core tier divided by the over-subscription ratio.
      topoopt: NICs + host transceivers + patch-panel ports (flat).
      mixnet: EPS share like fat-tree on ``eps_nics`` + OCS ports on
        ``ocs_nics`` (OCS ports need no per-port transceiver on the switch
        side — layer-1 mirrors), Fig 11's advantage.
    """
    p = PRICES[link_gbps]
    host_links = num_servers * nics_per_server
    nic_cost = host_links * p.nic + host_links * p.transceiver + host_links * p.fiber

    if fabric_name in ("fat-tree", "rail-optimized"):
        ports = _fat_tree_ports(num_servers, nics_per_server)
        switch = ports * p.eps_port + ports * p.transceiver
        if fabric_name == "rail-optimized":
            switch *= 0.97  # slightly better port packing per rail (Fig 11)
        return nic_cost + switch
    if fabric_name == "oversub-fat-tree":
        # Edge tier at full width; aggregation/core capacity divided by the
        # over-subscription ratio (4 of the 5 per-host ports live above edge).
        ports = host_links * (1 + 4 / oversub_ratio)
        return nic_cost + ports * p.eps_port + ports * p.transceiver
    if fabric_name == "topoopt":
        # Flat patch panel; >1K GPUs needs multi-tier panels + long-reach
        # transceivers (paper §7.2) — surcharge beyond 128 servers.
        panel_ports = host_links
        tiers = max(1, math.ceil(math.log(max(num_servers / 128, 1), 4)) + 1)
        return nic_cost + panel_ports * p.patch_panel_port * tiers
    if fabric_name == "mixnet":
        eps_links = num_servers * eps_nics
        eps_ports = 3 * eps_links
        eps = eps_ports * p.eps_port + eps_ports * p.transceiver
        ocs_links = num_servers * ocs_nics
        ocs = ocs_links * p.ocs_port
        # NIC/transceiver/fiber already counted in nic_cost for all 8 NICs.
        return nic_cost + eps + ocs
    raise ValueError(f"unknown fabric {fabric_name!r}")


def cost_efficiency(iteration_time_s: float, cost_usd: float) -> float:
    """Performance per dollar: 1 / (iteration time * cost), Fig 13's metric."""
    return 1.0 / (iteration_time_s * cost_usd)
