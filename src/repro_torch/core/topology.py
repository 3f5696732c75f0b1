"""Algorithm 1: greedy OCS circuit allocation (paper §5.2).

This is control-plane code — it runs between training steps on the host,
never inside the XLA graph — so it is written in plain numpy.

The solver takes the expert-level all-to-all demand matrix ``E`` (bytes to
move between every (src_expert, dst_expert) pair), folds it down to an
inter-server demand matrix ``D`` (Step 1), then greedily assigns optical
circuits to the current *bottleneck* server pair — the pair whose remaining
transfer would finish last given the circuits allocated so far (Steps 2-3) —
until every server has exhausted its optical degree ``alpha``.  Finally the
circuit matrix is expanded to a NIC-level port mapping with NUMA-balanced
permutation (Step 4) ready to be pushed to the OCS (Step 5).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "OCSTopology",
    "calculate_server_demand",
    "reconfigure_ocs",
    "topology_completion_time",
]


@dataclasses.dataclass(frozen=True)
class OCSTopology:
    """Result of one run of Algorithm 1.

    Attributes:
      circuits: ``[N, N]`` int matrix; ``circuits[i, j]`` = number of optical
        circuits provisioned between servers *i* and *j* (symmetric).
      nic_map: list of ``(src_server, src_nic, dst_server, dst_nic)`` tuples —
        the physical cross-connect list pushed to the OCS.
      alpha: per-server optical degree used.
      demand: the upper-triangular inter-server demand the solver saw (bytes).
    """

    circuits: np.ndarray
    nic_map: tuple
    alpha: int
    demand: np.ndarray

    @property
    def num_servers(self) -> int:
        return self.circuits.shape[0]

    def links_of(self, server: int) -> int:
        return int(self.circuits[server].sum())


def calculate_server_demand(
    expert_demand: np.ndarray,
    experts_per_server: int,
) -> np.ndarray:
    """Step 1 — fold the expert-level demand into inter-server demand.

    TX and RX demand of a pair are provisioned together (the OCS link is
    bidirectional), so the result is upper-triangular with
    ``D[i, j] = demand(i->j) + demand(j->i)`` for ``i < j`` and zero diagonal
    (intra-server traffic rides NVSwitch / intra-chip, not the OCS).
    """
    expert_demand = np.asarray(expert_demand, dtype=np.float64)
    n_experts = expert_demand.shape[0]
    if expert_demand.shape != (n_experts, n_experts):
        raise ValueError(f"expert demand must be square, got {expert_demand.shape}")
    if n_experts % experts_per_server != 0:
        raise ValueError(
            f"{n_experts} experts not divisible by {experts_per_server} per server"
        )
    n_servers = n_experts // experts_per_server
    # Sum expert blocks into server blocks.
    server = expert_demand.reshape(
        n_servers, experts_per_server, n_servers, experts_per_server
    ).sum(axis=(1, 3))
    np.fill_diagonal(server, 0.0)
    upper = np.triu(server + server.T, k=1)
    return upper


def _find_bottleneck_link(
    demand: np.ndarray, circuits: np.ndarray, eps_bw: float
) -> tuple[int, int, float]:
    """Step 2 — the (i, j) pair with the longest remaining completion time.

    Completion time of a pair = demand / bandwidth, where bandwidth is the
    allocated circuit count (plus the EPS fallback share ``eps_bw`` expressed
    in circuit-equivalents so pairs with zero circuits still finish).
    """
    with np.errstate(divide="ignore"):
        t = demand / (circuits + eps_bw)
    t = np.where(demand > 0, t, 0.0)
    idx = int(np.argmax(t))
    i, j = divmod(idx, demand.shape[1])
    return i, j, float(t[i, j])


def reconfigure_ocs(
    expert_demand: np.ndarray,
    alpha: int,
    num_servers: int,
    experts_per_server: int | None = None,
    *,
    eps_bw_fraction: float = 0.25,
    nics_per_numa: int = 2,
    rng: np.random.Generator | None = None,
) -> OCSTopology:
    """Algorithm 1 (paper §5.2): greedy bottleneck-relief circuit allocation.

    Args:
      expert_demand: ``[E, E]`` all-to-all demand in bytes between experts.
      alpha: optical degree — number of OCS-facing NICs per server.
      num_servers: N.
      experts_per_server: defaults to ``E // num_servers``.
      eps_bw_fraction: bandwidth of the EPS fallback path relative to one
        optical circuit (pairs without circuits still drain via EPS).
      nics_per_numa: used by the Step-4 NUMA-balanced port permutation.

    Returns:
      :class:`OCSTopology` with the circuit matrix and NIC-level mapping.
    """
    expert_demand = np.asarray(expert_demand, dtype=np.float64)
    n_experts = expert_demand.shape[0]
    if experts_per_server is None:
        if n_experts % num_servers != 0:
            raise ValueError("cannot infer experts_per_server")
        experts_per_server = n_experts // num_servers
    if alpha < 0:
        raise ValueError("alpha must be >= 0")

    # Step 1: inter-server demand (upper triangular).
    demand = calculate_server_demand(expert_demand, experts_per_server)
    if demand.shape[0] != num_servers:
        raise ValueError(
            f"demand folds to {demand.shape[0]} servers, expected {num_servers}"
        )

    circuits = np.zeros((num_servers, num_servers), dtype=np.int64)
    avail = np.full(num_servers, alpha, dtype=np.int64)

    # Steps 2-3: iteratively relieve the bottleneck pair.
    while True:
        # Only pairs whose BOTH endpoints still have free optical NICs are
        # eligible; mask others out of the bottleneck search.
        eligible = (avail[:, None] > 0) & (avail[None, :] > 0)
        masked = np.where(np.triu(eligible, k=1), demand, 0.0)
        if not masked.any():
            break
        i, j, t = _find_bottleneck_link(masked, circuits, eps_bw_fraction)
        if t <= 0.0:
            break
        circuits[i, j] += 1
        circuits[j, i] += 1
        avail[i] -= 1
        avail[j] -= 1

    # Step 4: NIC-level mapping with NUMA-balanced permutation.  Circuits of
    # the same server pair are spread across NUMA nodes round-robin so
    # multi-circuit pairs do not converge on one PCIe root complex.
    # NIC k of a server lives on NUMA node ``k // nics_per_numa``.  Pairs are
    # walked heaviest-first and each extra circuit of the same pair strides the
    # cursor by ``nics_per_numa`` (mod alpha) so that a 2-circuit pair lands on
    # two different NUMA nodes — the paper's permuteLinks step.
    nic_used = [set() for _ in range(num_servers)]
    nic_map = []

    def _next_nic(server: int, preferred: int) -> int:
        for off in range(max(alpha, 1)):
            cand = (preferred + off) % max(alpha, 1)
            if cand not in nic_used[server]:
                nic_used[server].add(cand)
                return cand
        raise RuntimeError("optical degree exhausted — solver bug")

    order = np.dstack(np.unravel_index(np.argsort(-demand, axis=None), demand.shape))[0]
    for i, j in order:
        count = int(circuits[i, j]) if i < j else 0
        for c in range(count):
            stride = c * max(nics_per_numa, 1)
            src_nic = _next_nic(int(i), stride % max(alpha, 1))
            dst_nic = _next_nic(int(j), stride % max(alpha, 1))
            nic_map.append((int(i), src_nic, int(j), dst_nic))

    return OCSTopology(
        circuits=circuits,
        nic_map=tuple(nic_map),
        alpha=alpha,
        demand=demand,
    )


def topology_completion_time(
    topo_circuits: np.ndarray,
    demand: np.ndarray,
    circuit_bw: float,
    eps_bw: float,
) -> float:
    """All-to-all completion time (seconds) on a given circuit allocation.

    The all-to-all finishes when its slowest pair finishes; each pair drains
    over its optical circuits plus the shared EPS fallback.  Used both by the
    greedy solver's evaluation and by tests/benchmarks.
    """
    demand = np.triu(np.asarray(demand, dtype=np.float64), k=1)
    bw = topo_circuits * circuit_bw + eps_bw
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(demand > 0, demand / bw, 0.0)
    return float(np.max(t)) if t.size else 0.0


def uniform_topology(num_servers: int, alpha: int) -> np.ndarray:
    """Round-robin circuit placement (the topology-oblivious baseline)."""
    circuits = np.zeros((num_servers, num_servers), dtype=np.int64)
    avail = np.full(num_servers, alpha, dtype=np.int64)
    hop = 1
    while hop < num_servers and avail.min() > 0:
        for i in range(num_servers):
            j = (i + hop) % num_servers
            if i < j and avail[i] > 0 and avail[j] > 0:
                circuits[i, j] += 1
                circuits[j, i] += 1
                avail[i] -= 1
                avail[j] -= 1
        hop += 1
    return circuits
