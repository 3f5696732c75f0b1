"""Flow-level training-iteration simulator (paper §7: large-scale simulations),
port of :mod:`repro.core.netsim`.

Host-side numpy, like the reference: it prices the paper's simulated A100
cluster (``SimModel``'s ``flops_per_gpu`` and ``hbm_bytes_per_s`` are the
reference's A100 constants, kept so the two packages agree number for
number), so every time it returns is a simulated iteration time of that
cluster, not a time of the card this package runs on.

The paper drives htsim (packet level) with a FlexFlow task DAG.  On a CPU-only
container we replace packet fidelity with a flow-level completion-time model
(see DESIGN.md §2) but keep the *same experiment structure*:

  model + parallelization --> per-layer timeline of compute phases and
  all-to-all/all-reduce/p2p communication phases --> composed through the
  1F1B pipeline schedule --> one iteration time, per fabric.

The gate-trace generator reproduces the §3 measurement characteristics:
temporally varying, spatially sparse expert loads with cross-layer
conditional structure (which is what MIXNET-COPILOT exploits) and a
load-balancing-loss-driven slow convergence toward uniformity.

Reconfiguration is driven exclusively through the shared
:class:`repro_torch.core.controlplane.ControlPlane` engine (the same engine the
trainer uses): the simulator observes loads into its monitor, asks it for
per-layer plans (COPILOT-predicted for the FP's first all-to-all), and
applies them against the fabric with hide-or-block accounting.

Communication phases are priced through the SAME CommRuntime ops the trainer
executes (:mod:`repro_torch.core.commruntime`, DESIGN.md §7): an ``AllToAll`` /
``AllReduce`` built from a fabric-derived :class:`CommSpec` owns both the
byte accounting (``ep_alltoall_bytes``, ``dp_gradient_bytes``) and the
phase-latency costing — this module keeps no private collective formulas.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import commruntime as comm
from repro_torch.core import overlap
from repro_torch.core.controlplane import ControlPlane
from repro_torch.core.fabric import Fabric
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

__all__ = [
    "SimModel",
    "GateTraceGenerator",
    "IterationResult",
    "simulate_iteration",
    "simulate_training",
    "ServingResult",
    "simulate_serving",
    "ReconfigAmortizer",
    "FleetServingResult",
    "simulate_fleet",
]


@dataclasses.dataclass
class SimModel:
    """Just enough of an MoE model + parallelization to cost one iteration.

    Mirrors Table 1 / §D.1 configurations.
    """

    name: str
    num_blocks: int
    d_model: int
    d_ff: int
    num_experts: int
    top_k: int
    num_heads: int
    seq_len: int = 4096
    micro_batch: int = 8
    num_microbatches: int = 8
    ep_degree: int = 8
    tp_degree: int = 4
    pp_degree: int = 4
    dtype_bytes: int = 2
    vocab: int = 32000
    # Effective per-GPU compute throughput (flop/s) — A100 bf16 peak x MFU.
    flops_per_gpu: float = 312e12 * 0.4
    # Per-GPU HBM bandwidth (bytes/s) — the serving scenario's decode ticks
    # are memory-bound (every live token streams the expert weights), so
    # their compute floor is weights-read time, not flops (DESIGN.md §9).
    hbm_bytes_per_s: float = 1.6e12
    # Chunked comm/compute overlap (repro_torch.core.overlap, DESIGN.md §8): the
    # per-layer dispatch->expert->combine phases run as a C-chunk software
    # pipeline on the event timeline.  1 = the serial (additive) schedule,
    # reproduced exactly.
    overlap_chunks: int = 1
    # Price the DP gradient reduction as int8-compressed (the trainer's
    # dp_compress path): wire bytes scale by 1/dtype_bytes through the SAME
    # AllReduce byte accounting.
    dp_compress: bool = False
    # A2A pricing lowering (commruntime.AllToAll.lowering, DESIGN.md §13):
    # "hier" (delegation, default), "flat" (per-GPU messages, pays the
    # per-message latency delegation amortizes), or "ring" (store-and-
    # forward; latency-optimal only for tiny payloads).
    a2a_lowering: str = "hier"
    # MoE dispatch mode: "dropless" routes every token (full a2a payload);
    # "capacity" caps each expert at capacity_factor * fair share — dropped
    # tokens skip the wire AND the expert FFN, but goodput only counts kept
    # tokens (IterationResult.kept_fraction), so the autotuner sees a real
    # throughput-vs-quality tradeoff, not a free discount.
    moe_dispatch: str = "dropless"
    capacity_factor: float = 1.25
    # Pipeline-tier overlap (DESIGN.md §13): treat the GPipe warmup/drain
    # bubble as a hideable window for comm the chunk tier left exposed —
    # first the residual EP a2a, then the DP gradient reduce-scatter.  Off
    # by default (the historical additive accounting).
    pp_overlap: bool = False

    # ---- derived sizes -----------------------------------------------------
    @property
    def tokens_per_microbatch(self) -> int:
        return self.micro_batch * self.seq_len

    @property
    def layers_per_stage(self) -> int:
        return max(self.num_blocks // self.pp_degree, 1)

    @property
    def gpus_per_stage(self) -> int:
        return self.ep_degree * self.tp_degree

    def param_count(self) -> float:
        attn = 4 * self.d_model * self.d_model
        expert = 3 * self.d_model * self.d_ff
        return self.num_blocks * (attn + self.num_experts * expert) + 2 * self.vocab * self.d_model

    # ---- per-microbatch per-stage compute times -----------------------------
    def attention_flops(self) -> float:
        t = self.tokens_per_microbatch
        proj = 2 * t * 4 * self.d_model * self.d_model
        attn = 2 * 2 * self.micro_batch * self.seq_len**2 * self.d_model
        return (proj + attn) * self.layers_per_stage

    def expert_flops(self) -> float:
        t = self.tokens_per_microbatch
        return 2 * t * self.top_k * 3 * self.d_model * self.d_ff * self.layers_per_stage

    def attention_time(self) -> float:
        return self.attention_flops() / (self.flops_per_gpu * self.gpus_per_stage)

    def expert_time(self) -> float:
        return self.expert_flops() / (self.flops_per_gpu * self.gpus_per_stage)

    def expert_time_per_layer(self) -> float:
        return self.expert_time() / self.layers_per_stage

    def attention_time_per_layer(self) -> float:
        return self.attention_time() / self.layers_per_stage

    # ---- communication sizes -------------------------------------------------
    # Byte formulas live in the CommRuntime (the same accounting the trainer's
    # ops carry); these wrappers only feed it this model's shapes.
    def a2a_bytes_total(self) -> float:
        """Bytes moved by ONE all-to-all phase of one layer (whole EP group)."""
        return comm.ep_alltoall_bytes(
            self.tokens_per_microbatch, self.top_k, self.d_model, self.dtype_bytes
        )

    def dp_gradient_bytes_per_server(self, gpus_per_server: int = 8) -> float:
        """Gradient bytes a server contributes to the DP ring (hierarchical
        all-reduce §5.3 — the server gateway aggregates its GPUs' shards)."""
        return comm.dp_gradient_bytes(
            self.param_count(),
            max(self.gpus_per_stage * self.pp_degree, 1),
            gpus_per_server,
            self.dtype_bytes,
        )


class GateTraceGenerator:
    """Synthetic per-layer expert-load traces with §3's statistics.

    Layer l+1's load is a noisy linear image of layer l's load through a
    slowly drifting column-stochastic matrix; all loads relax toward uniform
    over iterations (load-balancing loss) while staying sparse per iteration.
    """

    def __init__(
        self,
        num_layers: int,
        num_experts: int,
        *,
        seed: int = 0,
        sparsity: float = 3.0,
        drift: float = 0.02,
        balance_rate: float = 2e-3,
    ):
        self.num_layers = num_layers
        self.num_experts = num_experts
        self.rng = np.random.default_rng(seed)
        self.sparsity = sparsity
        self.drift = drift
        self.balance_rate = balance_rate
        self._transition = np.stack(
            [self._random_stochastic() for _ in range(max(num_layers - 1, 1))]
        )
        self._x0 = self.rng.dirichlet(np.full(num_experts, 1.0 / sparsity))
        self.iteration = 0

    def _random_stochastic(self) -> np.ndarray:
        e = self.num_experts
        m = self.rng.dirichlet(np.full(e, 1.0 / self.sparsity), size=e).T  # cols sum 1
        return m

    def step(self) -> np.ndarray:
        """Advance one iteration; return ``[L, E]`` per-layer load fractions."""
        e = self.num_experts
        uniform = np.full(e, 1.0 / e)
        # Drift the transitions and the entry distribution.
        blend = min(self.balance_rate * self.iteration, 0.9)
        for i in range(self._transition.shape[0]):
            if self.rng.random() < self.drift * 10:
                noise = self._random_stochastic()
                self._transition[i] = 0.95 * self._transition[i] + 0.05 * noise
        # Per-iteration spikiness (Fig 4a): the entry distribution jumps
        # substantially between iterations even late in training.
        x = (1 - blend) * self._x0 + blend * uniform
        x = 0.65 * x + 0.35 * self.rng.dirichlet(np.full(e, 1.0 / self.sparsity))
        x = x / x.sum()
        loads = [x]
        for l in range(self.num_layers - 1):
            x = self._transition[l] @ x
            x = 0.9 * x + 0.1 * self.rng.dirichlet(np.full(e, 1.0 / self.sparsity))
            x = (1 - blend) * x + blend * uniform
            x = x / x.sum()
            loads.append(x)
        self.iteration += 1
        return np.stack(loads)

    def device_demand(
        self,
        load: np.ndarray,
        model: SimModel,
        num_servers: int,
        *,
        node_limit: int = 4,
        total_bytes: float | None = None,
    ) -> np.ndarray:
        """Expert load fraction -> inter-server byte demand for one a2a.

        Two production effects shape the matrix (Fig 4b / Fig 5):
          * tokens within one batch shard are semantically correlated and
            concentrate on few experts (low-concentration Dirichlet rows);
          * group-limited gating (DeepSeek-V2/V3, cited by the paper) caps
            the number of *nodes* a token may route to, keeping the matrix
            sparse at server granularity even with hundreds of experts.

        ``total_bytes`` overrides the phase volume (default: one training
        microbatch's a2a) — the serving scenario passes the tick's live
        decode + prefill-chunk payload instead (DESIGN.md §9).
        """
        e = self.num_experts
        total = (
            SimModel.a2a_bytes_total(model) if total_bytes is None else total_bytes
        )
        per_src = total / max(num_servers, 1)
        per_server = max(e // max(num_servers, 1), 1)
        # Server-level attractiveness = summed load of its experts.
        srv_load = np.add.reduceat(
            np.resize(load, per_server * num_servers), np.arange(num_servers) * per_server
        )
        srv_load = srv_load / srv_load.sum()
        dem = np.zeros((num_servers, num_servers))
        limit = min(max(node_limit, 1), num_servers)
        for src in range(num_servers):
            # Group-limited gating: this shard's tokens reach <= limit servers.
            p = srv_load + 1e-9
            p = p / p.sum()
            dests = self.rng.choice(num_servers, size=limit, replace=False, p=p)
            weights = self.rng.dirichlet(srv_load[dests] * 8.0 + 0.1)
            dem[src, dests] += per_src * weights
        np.fill_diagonal(dem, 0.0)
        return dem


@dataclasses.dataclass
class IterationResult:
    total: float
    attn_compute: float
    expert_compute: float
    a2a: float
    reconfig_blocked: float
    dp_allreduce: float
    pp_bubble: float
    # Overlap accounting (DESIGN.md §8): the additive a2a total splits into
    # the part hidden under the compute window by the chunked pipeline and
    # the part that stays on the critical path.  hidden + exposed == a2a.
    # These two are the CHUNK tier; with ``pp_overlap`` the PIPELINE tier
    # then absorbs up to ``pp_bubble`` seconds of the still-exposed comm
    # into the warmup/drain idle slots (``pp_hidden_comm``) and the DP
    # reduction after it (``dp_hidden``).  Final critical-path comm =
    # ``exposed_comm - pp_hidden_comm``.
    hidden_comm: float = 0.0
    exposed_comm: float = 0.0
    pp_hidden_comm: float = 0.0
    dp_hidden: float = 0.0
    # Fraction of routed tokens actually delivered (== 1.0 for dropless;
    # < 1 when capacity dispatch drops overflow).  Goodput accounting
    # multiplies token throughput by this.
    kept_fraction: float = 1.0
    # Per-link-class bytes of ONE EP a2a phase, from the op's staged
    # accounting (AllToAllStage.bytes_on_link — the same numbers the
    # trainer's overlap scheduler consumes).
    a2a_link_bytes: dict = dataclasses.field(default_factory=dict)

    def breakdown(self) -> dict:
        return dataclasses.asdict(self)


def _stage_times(
    model: SimModel,
    fabric: Fabric,
    loads: np.ndarray,
    trace: GateTraceGenerator,
    num_servers_region: int,
    cp: ControlPlane,
    a2a_op: comm.AllToAll,
) -> tuple[float, float, float, float]:
    """One PP stage's event timeline over a FULL iteration (all microbatches).

    Reconfiguration semantics follow Fig 20, driven entirely through the
    shared control-plane engine (DESIGN.md §3): the topology is reconfigured
    *twice per MoE layer per iteration* (once covering the FP pair of
    all-to-alls, once the BP pair), amortized across microbatches — each
    layer gets its own OCS cross-map via ``cp.plan``/``cp.apply`` ->
    ``fabric.prepare``.  A reconfiguration blocks only if its delay exceeds
    the pipelined compute window between consecutive all-to-alls of that
    layer — with 25 ms OCS and production-size compute this is fully hidden
    (Fig 28's flat region), and degradation appears once the delay
    approaches the per-layer compute budget, reproducing Fig 28's cliff.

    Each layer's dispatch->expert->combine phases run through the chunked
    event timeline (:func:`repro_torch.core.overlap.pipelined_phase`) with
    ``model.overlap_chunks`` chunks; with 1 chunk the timeline IS the
    pre-overlap additive sum.  Returns ``(timeline_seconds,
    additive_a2a_seconds, blocked_seconds, exposed_comm_seconds,
    kept_fraction)`` — the last is the routed-token fraction actually
    delivered (capacity dispatch drops overflow tokens from both the wire
    and the expert FFN; dropless keeps it at 1.0).
    """
    attn_f = model.attention_time_per_layer()
    exp_f = model.expert_time_per_layer()
    m = model.num_microbatches
    chunks = max(model.overlap_chunks, 1)
    cap = (
        model.capacity_factor / model.num_experts
        if model.moe_dispatch == "capacity"
        else None
    )
    # Compute window available to hide one reconfiguration: the layer's
    # compute across the iteration's microbatches (fwd + bwd ~ 3x fwd).
    hide_window = m * (attn_f + exp_f)
    a2a_total = 0.0
    blocked = 0.0
    timeline = 0.0
    exposed = 0.0
    kept_sum = 0.0
    for li in range(model.layers_per_stage):
        load = loads[li % loads.shape[0]]
        kept = float(np.minimum(load, cap).sum()) if cap is not None else 1.0
        kept_sum += kept
        exp_l = exp_f * kept
        demand = trace.device_demand(load, model, num_servers_region) * kept
        # --- FP reconfig. For the layer's FIRST a2a the true matrix is not
        # yet known (§5.1): COPILOT predicts it (accurate prediction ->
        # near-matching circuits); without COPILOT the fabric keeps the
        # previous layer's topology (never blocks, but circuits mismatch).
        if fabric.cfg.reconfig_delay_s <= 1e-3:
            # Microsecond-scale OCS: exact reconfig fits before a2a#1 (Fig 28).
            blocked += cp.apply(cp.plan(li, demand))
        else:
            pred = cp.predict_load(li)
            if pred is not None:
                pred_demand = trace.device_demand(pred, model, num_servers_region)
                blocked += cp.apply(cp.plan(li, pred_demand, predicted=True))
            # else: reuse previous topology — no plan at all.
        t_disp = a2a_op.cost(fabric, demand)
        # --- FP a2a #2 (combine, transposed matrix): reconfig hidden when the
        # compute window allows; otherwise the overflow blocks the pipe.
        blocked += cp.apply(cp.plan(li, demand.T), hide_window=hide_window)
        t_comb = a2a_op.cost(fabric, demand.T)
        # --- BP reconfig + a2a pair (same matrices, §5.1; window = bwd
        # compute) — priced AFTER the BP prepare, whose circuits come from
        # the observed matrix (the FP pair may have run on predicted ones).
        blocked += cp.apply(cp.plan(li, demand), hide_window=2.0 * hide_window)
        t_disp_bp = a2a_op.cost(fabric, demand)
        t_comb_bp = a2a_op.cost(fabric, demand.T)
        a2a_total += m * (t_disp + t_comb + t_disp_bp + t_comb_bp)
        # Event timeline: attention is un-overlappable prefix compute; the
        # chunked dispatch/FFN/combine pipeline hides comm under the expert
        # window (bwd compute ~ 2x fwd, same a2a matrices).
        fp_t, fp_x = overlap.pipelined_phase(
            t_disp, exp_l, t_comb, chunks, serial_prefix=attn_f
        )
        bp_t, bp_x = overlap.pipelined_phase(
            t_disp_bp, 2.0 * exp_l, t_comb_bp, chunks, serial_prefix=2.0 * attn_f
        )
        timeline += m * (fp_t + bp_t)
        exposed += m * (fp_x + bp_x)
        cp.observe(li, load * model.tokens_per_microbatch * model.top_k)
    kept_mean = kept_sum / max(model.layers_per_stage, 1)
    return timeline, a2a_total, blocked, exposed, kept_mean


def _flush_ledger(scenario: str, **seconds_or_bytes) -> None:
    """Fold a scenario's comm ledger into the process metrics registry as
    ``netsim.<field>{scenario=...}`` counters (DESIGN.md §14)."""
    reg = obs_metrics.default()
    for field, v in seconds_or_bytes.items():
        if v:
            reg.counter(f"netsim.{field}", scenario=scenario).inc(float(v))


def _traced_scenario(fn):
    """Wrap a simulate_* entry point in a tracer span on the shared
    ``netsim`` track (no-op when tracing is disabled)."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        tr = obs_trace.default()
        if not tr.enabled:
            return fn(*args, **kwargs)
        with tr.span(f"netsim.{fn.__name__}", cat="netsim",
                     tid=tr.track("netsim")):
            return fn(*args, **kwargs)

    return wrapper


def simulate_iteration(
    model: SimModel,
    fabric: Fabric,
    trace: GateTraceGenerator,
    *,
    num_servers_region: int | None = None,
    controlplane: ControlPlane | None = None,
    gpus_per_server: int = 8,
) -> IterationResult:
    """Cost one training iteration of ``model`` on ``fabric``.

    ``controlplane`` is the engine driving reconfiguration for this region;
    a fresh one (no COPILOT history) is built when not supplied.
    """
    if num_servers_region is None:
        num_servers_region = max(model.gpus_per_stage // gpus_per_server, 2)
    if controlplane is None:
        controlplane = ControlPlane.for_simulation(
            model, fabric, num_servers_region=num_servers_region, use_copilot=False
        )
    loads = trace.step()

    # The comm phases are priced through the SAME CollectiveOp API the
    # trainer executes; the spec's region/group factorization comes from the
    # fabric topology (servers x intra-server scale-up domain).
    a2a_op = comm.AllToAll(
        comm.CommSpec.from_fabric(fabric, num_servers_region),
        lowering=model.a2a_lowering,
    )
    dp_op = comm.AllReduce(comm.CommSpec(
        axis=None,
        axis_size=max(gpus_per_server, 1),
        group_size=max(gpus_per_server, 1),
        outer_size=max(fabric.cfg.num_servers, 1),
    ))
    timeline, a2a, blocked, exposed, kept = _stage_times(
        model, fabric, loads, trace, num_servers_region, controlplane, a2a_op
    )
    # 1F1B: the critical path stretches the per-stage work by (M+P-1)/M.
    # ``timeline`` is the event-timeline per-stage time (== compute + a2a
    # when overlap_chunks=1, smaller when the chunked pipeline hides comm).
    m, p = model.num_microbatches, model.pp_degree
    stretch = (m + p - 1) / m
    pipeline = stretch * timeline
    bubble = (stretch - 1.0) * timeline
    # DP gradient all-reduce (hierarchical on MixNet), half overlapped with
    # bwd; dp_compress prices the int8 wire through the same op accounting.
    dp_bytes = model.dp_gradient_bytes_per_server(gpus_per_server)
    dp_ratio = (1.0 / model.dtype_bytes) if model.dp_compress else 1.0
    dp = 0.5 * dp_op.cost(fabric, dp_bytes, compress_ratio=dp_ratio)
    # Pipeline-tier overlap (DESIGN.md §13): the warmup/drain bubble is
    # stage-idle time — the NICs are free, so comm the chunk tier left
    # exposed can be deferred into those slots instead of stretching the
    # critical path.  Exposed a2a fills the bubble first (it is produced
    # throughout the schedule), the DP reduce-scatter takes what remains
    # (gradients become final exactly as stages drain).  The floor is
    # exact: pipeline - pp_hidden >= timeline (pure compute+residual path).
    pp_hidden = 0.0
    dp_hidden = 0.0
    if model.pp_overlap:
        pp_hidden = min(bubble, stretch * exposed)
        dp_hidden = min(bubble - pp_hidden, dp)
    total = pipeline + blocked + dp - pp_hidden - dp_hidden
    # Per-link bytes of one EP a2a phase through the op's staged accounting
    # (the identical AllToAllStage.bytes_on_link the trainer's scheduler
    # consumes for its chunk schedule).
    phase_bytes = model.a2a_bytes_total() / max(num_servers_region, 1)
    link_bytes: dict = {}
    for stage in a2a_op.stages():
        lb = stage.bytes_on_link(phase_bytes)
        link_bytes[stage.link_class] = (
            link_bytes.get(stage.link_class, 0.0) + getattr(lb, stage.link_class)
        )
    _flush_ledger(
        "training",
        hidden_comm_s=stretch * (a2a - exposed),
        exposed_comm_s=stretch * exposed,
        pp_hidden_comm_s=pp_hidden,
        dp_hidden_s=dp_hidden,
        reconfig_blocked_s=blocked,
    )
    return IterationResult(
        total=total,
        attn_compute=m * model.attention_time() * 3.0,
        expert_compute=m * model.expert_time() * 3.0,
        a2a=stretch * a2a,
        reconfig_blocked=blocked,
        dp_allreduce=dp,
        pp_bubble=bubble,
        hidden_comm=stretch * (a2a - exposed),
        exposed_comm=stretch * exposed,
        pp_hidden_comm=pp_hidden,
        dp_hidden=dp_hidden,
        kept_fraction=kept,
        a2a_link_bytes=link_bytes,
    )


# ---------------------------------------------------------------------------
# Serving scenario (DESIGN.md §9) — the inference analogue of Fig 26-28
# ---------------------------------------------------------------------------


class ReconfigAmortizer:
    """Per-window accounting for serving-cadence reconfiguration hiding.

    §5.1's rule amortizes an OCS reconfiguration over the pipelined compute
    between reconfigurations.  The old inline accounting extrapolated the
    *current tick's* compute over one global window
    (``every_ticks * tick_compute``) — wrong whenever ticks are
    heterogeneous (bursty prefill, draining slots, spec rounds), and
    unusable for a fleet where each replica has its own cadence and its own
    realized window.  This helper accumulates the compute that actually ran
    since the previous reconfiguration and hands exactly that budget to
    ``hide_window`` when the cadence fires.

    The FIRST firing gets an infinite window: it is the cold-start topology
    setup before any traffic was served, not a runtime reconfiguration —
    there is no elapsed window to amortize against and nothing in flight to
    stall.  Both :func:`simulate_serving` and :func:`simulate_fleet` (one
    instance per replica) share this accounting.
    """

    def __init__(self, every_ticks: int):
        self.every = int(every_ticks)
        self._budget = 0.0
        self._fired = False

    def due(self, tick: int) -> bool:
        return self.every > 0 and tick % self.every == 0

    def window(self) -> float:
        """Hide budget for a reconfiguration firing NOW; resets the
        accumulator so the next window starts empty."""
        if not self._fired:
            self._fired = True
            self._budget = 0.0
            return math.inf
        w = self._budget
        self._budget = 0.0
        return w

    def accumulate(self, hideable_s: float) -> None:
        """Record one tick's realized hideable compute (all phases that run
        while an OCS slice could be idling)."""
        self._budget += hideable_s


@dataclasses.dataclass
class ServingResult:
    """Priced serving run on one fabric: latency percentiles, goodput, and
    the Fig-13-style goodput-per-dollar the acceptance gate compares."""

    fabric: str
    ticks: int
    sim_seconds: float
    requests: int
    completed: int
    tokens_out: int
    ttft_p50_s: float
    ttft_p99_s: float
    tpot_p50_s: float
    tpot_p99_s: float
    goodput_tok_s: float
    cost_usd: float
    goodput_per_mdollar: float  # decode tokens/s per M$ of interconnect
    exposed_comm_fraction: float  # mean exposed/total a2a per tick
    reconfig_count: int
    reconfig_blocked_s: float
    # Total EP a2a payload bytes across the run, accounted through the SAME
    # CommRuntime formula (ep_alltoall_bytes) the real engine reports — the
    # serving cross-check in tests/test_serve.py.
    a2a_bytes_total: float
    # Paged-KV accounting (DESIGN.md §10): decode HBM reads priced from the
    # resident pages actually touched per tick, and admission gated by the
    # KV token budget instead of a fixed slot preallocation.
    kv_paged: bool = False
    kv_resident_tokens_peak: int = 0
    kv_budget_tokens: int = 0
    # Speculative decoding (DESIGN.md §11): draft span, modeled per-token
    # acceptance, and the resulting expected emitted tokens per verify round
    # (1.0 = non-speculative).
    spec_k: int = 0
    spec_acceptance: float = 0.0
    spec_tokens_per_round: float = 1.0

    def breakdown(self) -> dict:
        return dataclasses.asdict(self)


@_traced_scenario
def simulate_serving(
    model: SimModel,
    fabric: Fabric,
    *,
    mix="chat",
    num_requests: int = 64,
    slots: int = 16,
    seed: int = 0,
    use_reconfig: bool = True,
    reconfig_every_ticks: int = 256,
    prefill_chunk_tokens: int = 256,
    num_servers_region: int | None = None,
    gpus_per_server: int = 8,
    max_ticks: int = 200_000,
    paged_kv: bool = False,
    kv_page_tokens: int = 16,
    kv_budget_tokens: int = 0,
    spec_decode: tuple | None = None,
) -> ServingResult:
    """Price a continuous-batching serving run of ``model`` on ``fabric``.

    One tick = one engine decode step (:mod:`repro_torch.serve.engine` at flow
    level): every live slot decodes one token, up to ``prefill_chunk_tokens``
    of pending prompt stream through the same tick (chunked prefill), and
    each MoE layer pays a dispatch/combine a2a pair priced through the
    CommRuntime op on the fabric — hidden under the decode + interleaved
    prefill compute window by the chunked event timeline
    (:func:`repro_torch.core.overlap.decode_tick_phase`).

    With ``use_reconfig`` the shared ControlPlane re-solves the regional OCS
    cross-maps every ``reconfig_every_ticks`` from the drifting decode
    demand (the request mix moves, §3's locality), amortizing the
    reconfiguration delay over the window's compute; a static EPS fabric
    (e.g. fat-tree) with ``use_reconfig=False`` is the baseline the
    goodput-per-dollar gate compares against.

    **Paged KV** (``paged_kv=True``, DESIGN.md §10): each request's KV
    footprint is its *page-rounded live context* instead of a full-length
    slot preallocation, a region's shared prompt prefix is resident ONCE
    (copy-on-write pages, mirroring the engine's prefix registry), and the
    per-tick decode HBM-read term charges only the resident pages touched.
    ``kv_budget_tokens`` caps resident KV tokens: admission stalls at the
    head of the prefill queue until retiring requests release pages —
    exactly how :class:`repro_torch.serve.paged.PageAllocator` gates the engine —
    so at equal HBM budget the paged run sustains more concurrent decodes.

    **Speculative decoding** (``spec_decode=(K, acceptance_model)``,
    DESIGN.md §11): each live slot verifies a K-token draft span per tick,
    so one a2a launch (and one KV-cache streaming pass) amortizes over the
    expected ``1 + sum(p^i)`` emitted tokens — while the verify a2a payload
    and FLOPs scale with all K+1 positions and the draft pass adds K cheap
    (attention + one expert-equivalent) steps that re-stream KV each step.
    ``acceptance_model`` is the per-token draft acceptance probability
    (i.i.d. model), or a callable ``f(K) -> expected accepted tokens``.
    At low acceptance the extra positions/draft FLOPs are pure waste — the
    goodput-per-dollar crossover against ``spec_decode=None`` is exactly
    what ``benchmarks/run.py::spec_decode`` sweeps.
    """
    from repro_torch.core import cost as costm
    from repro_torch.serve.workload import WorkloadGenerator

    requests = WorkloadGenerator(mix, seed=seed).generate(num_requests)
    spec_k, spec_acc, spec_emit = 0, 0.0, 1.0
    if spec_decode is not None:
        spec_k, acc_model = int(spec_decode[0]), spec_decode[1]
        if spec_k > 0:
            if callable(acc_model):
                exp_acc = float(acc_model(spec_k))
            else:
                exp_acc = sum(float(acc_model) ** i for i in range(1, spec_k + 1))
            spec_acc = exp_acc / spec_k
            spec_emit = 1.0 + exp_acc  # + verify's correction/bonus token
        else:
            spec_k = 0
    region = num_servers_region or max(model.gpus_per_stage // gpus_per_server, 2)
    trace = GateTraceGenerator(model.layers_per_stage, model.num_experts, seed=seed)
    cp = (
        ControlPlane.for_simulation(
            model, fabric, num_servers_region=region, use_copilot=False
        )
        if use_reconfig
        else None
    )
    a2a_op = comm.AllToAll(comm.CommSpec.from_fabric(fabric, region))
    rate = model.flops_per_gpu * model.gpus_per_stage
    layers = model.layers_per_stage
    d, dff, k, dt = model.d_model, model.d_ff, model.top_k, model.dtype_bytes

    pending = sorted(requests, key=lambda r: r.arrival_s)
    cursor = 0
    amort = ReconfigAmortizer(reconfig_every_ticks if cp is not None else 0)

    # -- KV residency bookkeeping (tokens) --------------------------------
    # Dense: an admitted request pins its full prompt+output length for its
    # whole lifetime (slot preallocation).  Paged: it pins page-rounded live
    # context, and a region's shared prompt prefix is resident once across
    # all carriers (the engine's refcounted prefix pages).
    page = max(int(kv_page_tokens), 1)
    region_refs: dict[int, int] = {}  # carriers per region's shared prefix
    resident_tokens = 0
    resident_peak = 0

    def _kv_parts(req):
        total = req.prompt_len + req.max_new_tokens
        if not paged_kv:
            return 0, total
        pfx = min(getattr(req, "prefix_len", 0), req.prompt_len)
        return -(-pfx // page) * page, -(-(total - pfx) // page) * page

    def _kv_acquire(req):
        nonlocal resident_tokens
        shared, private = _kv_parts(req)
        resident_tokens += private
        if shared:
            n = region_refs.get(req.region, 0)
            region_refs[req.region] = n + 1
            if n == 0:
                resident_tokens += shared

    def _kv_release(req):
        nonlocal resident_tokens
        shared, private = _kv_parts(req)
        resident_tokens -= private
        if shared:
            n = region_refs[req.region] - 1
            region_refs[req.region] = n
            if n == 0:
                resident_tokens -= shared

    def _kv_fresh_cost(req):
        shared, private = _kv_parts(req)
        if shared and region_refs.get(req.region, 0) > 0:
            shared = 0  # prefix already resident: pages map for free
        return private + shared

    prefill_q: list = []  # [req, tokens_left]
    live: list = []  # [req, tokens_left, context_len]
    ttft: list[float] = []
    tpot: list[float] = []
    clock = 0.0
    ticks = 0
    tokens_out = 0
    completed = 0
    blocked_total = 0.0
    a2a_total_s = 0.0
    exposed_total_s = 0.0
    a2a_bytes_total = 0.0
    loads = trace.step()

    while ticks < max_ticks:
        # -- admission --------------------------------------------------------
        while cursor < len(pending) and pending[cursor].arrival_s <= clock:
            prefill_q.append([pending[cursor], pending[cursor].prompt_len])
            cursor += 1
        if not prefill_q and not live:
            if cursor >= len(pending):
                break
            clock = pending[cursor].arrival_s  # idle: jump to next arrival
            continue

        # -- this tick's work -------------------------------------------------
        n_live = len(live)
        pf_tokens = 0
        budget = prefill_chunk_tokens
        finished_prefills = []
        for item in prefill_q:
            if budget <= 0 or len(live) + len(finished_prefills) >= slots:
                break
            if item[1] == item[0].prompt_len:  # starting this request now
                need = _kv_fresh_cost(item[0])
                if (
                    kv_budget_tokens
                    and resident_tokens + need > kv_budget_tokens
                    and resident_tokens > 0  # an empty pool always admits one
                ):
                    break  # head-of-line waits for retiring requests' pages
                _kv_acquire(item[0])
            take = min(budget, item[1])
            item[1] -= take
            budget -= take
            pf_tokens += take
            if item[1] == 0:
                finished_prefills.append(item[0])
        resident_peak = max(resident_peak, resident_tokens)

        # Per-layer phase pricing: the a2a moves every routed token copy of
        # the tick (live decode + prefill chunk) — the same byte formula the
        # engine accounts (comm.ep_alltoall_bytes).  Speculative ticks route
        # the whole verify span (K+1 positions per live slot) through ONE
        # launch per layer: payload scales with positions, launches don't.
        vpos = n_live * (spec_k + 1) if spec_k else n_live
        routed = vpos + pf_tokens
        tick_s = 0.0
        blocked_tick = 0.0
        if routed:
            tick_bytes = comm.ep_alltoall_bytes(routed, k, d, dt)
            a2a_bytes_total += layers * tick_bytes
            mean_ctx = (
                np.mean([it[2] for it in live]) if live else 64.0
            )
            # Per-layer compute terms (flow level): decode attention is the
            # un-overlappable prefix, expert FFN + the interleaved prefill
            # chunk form the hideable window.  Decode is memory-bound: the
            # floor is streaming the layer's expert weights (+ the KV cache)
            # from HBM, which is what puts real decode ticks at ms scale and
            # makes the 25 ms OCS hideable across a reconfiguration window.
            hbm = model.hbm_bytes_per_s * model.gpus_per_stage
            if paged_kv:
                # KV read = resident pages TOUCHED this tick: each slot
                # streams its own page-rounded context, but a shared prefix
                # page transits HBM once for all carriers reading it.
                shared_touch: dict[int, int] = {}
                private_pages = 0
                for it in live:
                    pfx = min(getattr(it[0], "prefix_len", 0), it[2])
                    shared_touch[it[0].region] = max(
                        shared_touch.get(it[0].region, 0), -(-pfx // page)
                    )
                    private_pages += -(-(it[2] - pfx) // page)
                kv_read_tokens = (
                    private_pages + sum(shared_touch.values())
                ) * page
            else:
                kv_read_tokens = n_live * mean_ctx
            attn_t = max(
                # Matmul/score FLOPs scale with every verified position; the
                # KV HBM read does NOT — the whole span streams the cache
                # once per round (the speculative amortization).
                (2 * vpos * 4 * d * d + 2 * 2 * vpos * mean_ctx * d) / rate,
                (kv_read_tokens * 2 * d * dt) / hbm,  # KV read
            )
            exp_t = max(
                2 * vpos * k * 3 * d * dff / rate,
                # dense-decode weight streaming: every expert's FFN weights
                # transit HBM once per tick when any token is live.
                (model.num_experts * 3 * d * dff * dt) / hbm,
            )
            pf_t = pf_tokens * (2 * 4 * d * d + 2 * k * 3 * d * dff) / rate
            draft_t = 0.0
            if spec_k and n_live:
                # K draft steps: full attention + ONE expert-equivalent FFN
                # per token (shared_only / topk1 drafts), each step
                # re-streaming the live KV (serial steps can't amortize it)
                # plus one expert's weights.  Rides the hideable window with
                # the prefill chunk — wasted entirely when acceptance is low.
                draft_t = spec_k * max(
                    (
                        2 * n_live * 4 * d * d
                        + 2 * 2 * n_live * mean_ctx * d
                        + 2 * n_live * 3 * d * dff
                    ) / rate,
                    (kv_read_tokens * 2 * d * dt + 3 * d * dff * dt) / hbm,
                )
            if ticks % 8 == 0:
                loads = trace.step()
            # Amortized over the REALIZED window: one layer's OCS slice is
            # idle while every other phase of the inter-reconfiguration
            # stretch runs, so the hide budget is the compute that actually
            # accumulated since the previous reconfiguration (§5.1's rule at
            # serving cadence, per-window accounting via ReconfigAmortizer —
            # every layer's slice of one firing shares the window).
            window = amort.window() if cp is not None and amort.due(ticks) else None
            for li in range(layers):
                demand = trace.device_demand(
                    loads[li % loads.shape[0]], model, region,
                    total_bytes=tick_bytes,
                )
                if window is not None:
                    blocked_tick += cp.apply(
                        cp.plan(li, demand), hide_window=window
                    )
                t_disp = a2a_op.cost(fabric, demand)
                t_comb = a2a_op.cost(fabric, demand.T)
                total_t, exposed_t = overlap.decode_tick_phase(
                    t_disp, exp_t, t_comb, max(model.overlap_chunks, 1),
                    attn=attn_t, prefill_compute=pf_t + draft_t,
                )
                tick_s += total_t
                a2a_total_s += t_disp + t_comb
                exposed_total_s += exposed_t
            amort.accumulate(layers * (attn_t + exp_t + pf_t + draft_t))
            if cp is not None:
                for li in range(layers):
                    cp.observe(
                        li, loads[li % loads.shape[0]] * max(routed, 1) * k
                    )
                cp.end_step()
        blocked_total += blocked_tick
        clock += tick_s + blocked_tick  # un-hidden reconfig stalls the tick
        ticks += 1

        # -- bookkeeping: decode completions FIRST (only the slots that were
        # live — and therefore routed — this tick emit), then the tick's
        # finished prefills join the live set for the NEXT tick.
        still = []
        for it in live:
            # Speculative rounds emit the expected accepted prefix + the
            # verify correction/bonus token (flow level: the i.i.d.
            # acceptance expectation), clamped to what the request needs.
            emit = min(spec_emit, it[1]) if spec_k else 1
            it[1] -= emit
            it[2] += emit
            tokens_out += emit
            if it[1] <= 0:
                completed += 1
                _kv_release(it[0])
                span = max(clock - it[3], 0.0)
                tpot.append(span / max(it[0].max_new_tokens - 1, 1))
            else:
                still.append(it)
        live = still
        for req in finished_prefills:
            prefill_q = [it for it in prefill_q if it[0] is not req]
            ttft.append(clock - req.arrival_s)
            tokens_out += 1  # the prefill's next-token (first output)
            if req.max_new_tokens <= 1:
                completed += 1
                _kv_release(req)
            else:
                live.append([req, req.max_new_tokens - 1, req.prompt_len, clock])

    pct = lambda a, q: float(np.percentile(a, q)) if len(a) else 0.0
    cost_usd = costm.fabric_cost(
        fabric.name,
        fabric.cfg.num_servers,
        int(fabric.cfg.link_gbps),
        nics_per_server=fabric.cfg.nics_per_server,
        eps_nics=fabric.cfg.eps_nics,
        ocs_nics=fabric.cfg.ocs_nics,
        oversub_ratio=fabric.cfg.oversub_ratio,
    )
    sim_seconds = max(clock, 1e-12)
    goodput = tokens_out / sim_seconds
    _flush_ledger(
        "serving",
        a2a_s=a2a_total_s,
        exposed_comm_s=exposed_total_s,
        reconfig_blocked_s=blocked_total,
        a2a_bytes=a2a_bytes_total,
    )
    return ServingResult(
        fabric=fabric.name,
        ticks=ticks,
        sim_seconds=sim_seconds,
        requests=len(requests),
        completed=completed,
        tokens_out=int(round(tokens_out)),
        ttft_p50_s=pct(ttft, 50),
        ttft_p99_s=pct(ttft, 99),
        tpot_p50_s=pct(tpot, 50),
        tpot_p99_s=pct(tpot, 99),
        goodput_tok_s=goodput,
        cost_usd=cost_usd,
        goodput_per_mdollar=goodput / (cost_usd / 1e6),
        exposed_comm_fraction=exposed_total_s / max(a2a_total_s, 1e-12),
        reconfig_count=cp.reconfig_count if cp is not None else 0,
        reconfig_blocked_s=blocked_total,
        a2a_bytes_total=a2a_bytes_total,
        kv_paged=bool(paged_kv),
        kv_resident_tokens_peak=int(resident_peak),
        kv_budget_tokens=int(kv_budget_tokens),
        spec_k=spec_k,
        spec_acceptance=spec_acc,
        spec_tokens_per_round=spec_emit,
    )


@dataclasses.dataclass
class FleetServingResult:
    """Priced multi-replica serving run: fleet goodput-per-dollar with
    per-replica fabrics plus the cross-region electrical admission tier
    (the paper's regional-locality argument at fleet scale, DESIGN.md §12)."""

    policy: str
    fabric: str
    num_replicas: int
    ticks: int
    sim_seconds: float
    requests: int
    completed: int
    tokens_out: int
    ttft_p50_s: float
    ttft_p99_s: float
    goodput_tok_s: float
    fleet_cost_usd: float  # sum of per-replica fabric costs
    cross_tier_cost_usd: float  # electrical admission/steering tier
    goodput_per_mdollar: float
    slo_attainment: dict  # SLO class name -> fraction meeting TTFT target
    steer_counts: dict  # steering-reason -> requests
    reconfig_count: int
    reconfig_blocked_s: float
    # Per-replica EP a2a accounting: payload bytes and routed token copies,
    # tied by the SAME CommRuntime formula the engine reports —
    # a2a_bytes[j] == layers * ep_alltoall_bytes(routed_tokens[j], ...)
    # (cross-checked in tests/test_fleet.py like the single-engine tests).
    replica_a2a_bytes: list
    replica_routed_tokens: list
    replica_mean_active_experts: list  # mean per-tick effective experts
    cross_tier_bytes: float

    def breakdown(self) -> dict:
        return dataclasses.asdict(self)


def _region_expert_mixes(
    num_regions: int, num_experts: int, seed: int, concentration: float
) -> np.ndarray:
    """Per-region gate entry mixes ``[R, E]``: sparse Dirichlet draws, the
    §3 regional skew at fleet granularity.  Deterministic in ``seed``; low
    ``concentration`` = few hot experts per region (strong locality)."""
    rng = np.random.default_rng((seed << 8) ^ 0xF1EE7)
    mixes = rng.dirichlet(np.full(num_experts, concentration), size=num_regions)
    mixes = mixes + 1e-4  # keep every expert reachable
    return mixes / mixes.sum(axis=1, keepdims=True)


def _mix_demand(
    mix: np.ndarray, perm: np.ndarray, num_servers: int, epd: int,
    total_bytes: float,
) -> np.ndarray:
    """``[S, S]`` inter-server demand of serving ``mix`` under a placement:
    each source server holds an equal token share, sends each expert's slice
    to the server owning its slot; sender-local traffic never hits the wire."""
    share = np.zeros(num_servers)
    np.add.at(share, np.asarray(perm) // epd, mix)
    dem = np.tile((total_bytes / num_servers) * share[None, :], (num_servers, 1))
    np.fill_diagonal(dem, 0.0)
    return dem


@_traced_scenario
def simulate_fleet(
    model: SimModel,
    *,
    fabric_name: str = "mixnet",
    num_replicas: int = 4,
    link_gbps: float = 400.0,
    num_servers_replica: int | None = None,
    gpus_per_server: int = 8,
    mixes=("chat", "agentic", "batch_summarize"),
    num_requests: int = 96,
    seed: int = 0,
    policy: str = "locality",
    slots: int = 16,
    prefill_chunk_tokens: int = 256,
    use_reconfig: bool = True,
    reconfig_every_ticks: int = 64,
    reconfig_min_gain: float = 0.1,
    region_concentration: float = 0.15,
    arrival_scale: float = 1.0,
    cross_region_gbps: float = 400.0,
    locality_gamma: float = 0.5,
    steer_load_beta: float = 0.25,
    drain: tuple | None = None,  # (replica_idx, at_tick)
    fail: tuple | None = None,  # (replica_idx, at_tick)
    max_ticks: int = 200_000,
) -> FleetServingResult:
    """Price a multi-replica serving fleet with cross-replica steering.

    ``num_replicas`` replicas each own a ``num_servers_replica``-server
    fabric (priced individually) and a placement-mode ControlPlane; one
    global admission queue dispatches by SLO class priority
    (:data:`repro_torch.serve.workload.SLO_CLASSES`) and steers by ``policy``:

    * ``locality`` — :func:`repro_torch.serve.fleet.locality_score` against each
      replica's served-mix EWMA and placement fit (the engine-side score,
      reused verbatim at flow level);
    * ``least_loaded`` / ``round_robin`` — the baselines.

    The priced locality mechanism is expert-weight **residency**: a decode
    tick's HBM floor streams only the experts its served mix actually
    touches (effective experts ``1 / sum(mix^2)``, inverse Simpson), so a
    region-pure replica streams 2–3 hot experts where a blended one streams
    most of E — the §3 locality argument, cashed out as tokens/s.  Each
    replica's a2a is priced on its own fabric from the mix mapped through
    its placement; on the fleet cadence a replica whose *served* mix has
    drifted off its placement (its ControlPlane's min-gain hysteresis — the
    steer-vs-reconfigure rule) re-solves locally, paying the OCS delay
    against its :class:`ReconfigAmortizer` window.

    The **cross-region electrical tier** is the admission/steering fabric
    above the replicas: priced as a small packet-switched layer over
    ``num_replicas`` endpoints, and each steered request pays its prompt
    transfer across it before prefill starts (a TTFT adder).  Replicas tick
    synchronously off the admission clock (the slowest busy replica sets
    the tick — flow-level conservatism).

    ``drain=(j, t)`` / ``fail=(j, t)`` script degradation: a drained
    replica finishes in-flight work while its queued requests re-steer; a
    failed replica loses in-flight generation (those tokens are uncounted
    and the requests restart elsewhere).
    """
    from repro_torch.core import cost as costm
    from repro_torch.core.fabric import FabricConfig, make_fabric
    from repro_torch.core.placement import placement_cost
    from repro_torch.serve.fleet import locality_score
    from repro_torch.serve.workload import MIXES, WorkloadGenerator, slo_for

    if policy not in ("locality", "least_loaded", "round_robin"):
        raise ValueError(f"unknown steering policy {policy!r}")
    mixes = (mixes,) if isinstance(mixes, str) else tuple(mixes)
    num_regions = max(MIXES[m].num_regions for m in mixes)
    region_mix = _region_expert_mixes(
        num_regions, model.num_experts, seed, region_concentration
    )

    # -- the tagged request stream (one queue over all SLO classes) -------
    reqs = []
    for i, mname in enumerate(mixes):
        gen = WorkloadGenerator(mname, seed=seed + i)
        cls = slo_for(mname)
        share = num_requests // len(mixes) + (
            1 if i < num_requests % len(mixes) else 0
        )
        for sr in gen.generate(share):
            reqs.append({
                "rid": i * num_requests + sr.rid,
                "arrival_s": sr.arrival_s * arrival_scale,
                "prompt_len": sr.prompt_len,
                "max_new": sr.max_new_tokens,
                "region": sr.region % num_regions,
                "slo": cls,
            })
    pending = sorted(reqs, key=lambda r: (r["arrival_s"], r["rid"]))
    cursor = 0

    # -- per-replica state ------------------------------------------------
    S = num_servers_replica or max(model.gpus_per_stage // gpus_per_server, 2)
    layers = model.layers_per_stage
    d, dff, k, dt = model.d_model, model.d_ff, model.top_k, model.dtype_bytes
    E = model.num_experts
    rate = model.flops_per_gpu * S * gpus_per_server
    hbm = model.hbm_bytes_per_s * S * gpus_per_server
    R = num_replicas
    fabrics = [
        make_fabric(fabric_name, FabricConfig(
            num_servers=S, gpus_per_server=gpus_per_server,
            link_gbps=link_gbps,
        ))
        for _ in range(R)
    ]
    cps = [
        ControlPlane(
            num_layers=1, num_experts=E, num_devices=S,
            min_gain_fraction=reconfig_min_gain, use_copilot=False,
        )
        for _ in range(R)
    ]
    epd = cps[0].experts_per_device
    a2a_ops = [
        comm.AllToAll(comm.CommSpec.from_fabric(f, S)) for f in fabrics
    ]
    amorts = [ReconfigAmortizer(reconfig_every_ticks) for _ in range(R)]
    prefill_q = [[] for _ in range(R)]  # [req, tokens_left]
    live = [[] for _ in range(R)]  # [req, tokens_left, ctx, start_clock]
    mix_ewma = [np.full(E, 1.0 / E) for _ in range(R)]
    alive = [True] * R
    draining = [False] * R
    a2a_bytes = [0.0] * R
    routed_tokens = [0] * R
    neff_sum = [0.0] * R
    neff_ticks = [0] * R
    blocked_total = 0.0
    reconfig_count = 0
    steer_counts: dict[str, int] = {}
    cross_tier_bytes = 0.0
    xfer_s: dict[int, float] = {}  # rid -> cross-tier prompt-transfer delay
    queue: list = []  # (priority, arrival_s, seq, req)
    seq = 0
    hits_by_class: dict[str, list] = {}
    ttft_all: list[float] = []
    clock = 0.0
    busy_s = 0.0  # fleet service time (excludes idle arrival gaps)
    ticks = 0
    tokens_out = 0
    completed = 0
    drain_j, drain_t = drain if drain else (-1, -1)
    fail_j, fail_t = fail if fail else (-1, -1)

    def _backlog(j):
        return len(prefill_q[j]) + len(live[j])

    def _requeue(req):
        nonlocal seq
        import heapq

        heapq.heappush(queue, (req["slo"].priority, req["arrival_s"], seq, req))
        seq += 1

    def _replica_mix(j):
        """The mix replica j is serving right now (live + admitted)."""
        regs = [it[0]["region"] for it in live[j]]
        regs += [it[0]["region"] for it in prefill_q[j]]
        if not regs:
            return None
        return region_mix[regs].mean(axis=0)

    import heapq

    while ticks < max_ticks:
        while cursor < len(pending) and pending[cursor]["arrival_s"] <= clock:
            _requeue(pending[cursor])
            cursor += 1
        if drain_t == ticks and 0 <= drain_j < R:
            draining[drain_j] = True
            started = [it for it in prefill_q[drain_j]
                       if it[1] < it[0]["prompt_len"]]
            for it in prefill_q[drain_j]:
                if it[1] == it[0]["prompt_len"]:  # unstarted: re-steer
                    _requeue(it[0])
            prefill_q[drain_j] = started
        if fail_t == ticks and 0 <= fail_j < R and alive[fail_j]:
            alive[fail_j] = False
            for it in prefill_q[fail_j]:
                _requeue(it[0])
            for it in live[fail_j]:
                tokens_out -= it[0]["max_new"] - it[1]  # emitted-then-lost
                _requeue(it[0])
            prefill_q[fail_j] = []
            live[fail_j] = []

        busy = any(prefill_q[j] or live[j] for j in range(R))
        if not queue and not busy:
            if cursor >= len(pending):
                break
            clock = pending[cursor]["arrival_s"]
            # Keep scripted events tick-addressable across idle jumps.
            ticks += 1
            continue
        if queue and not busy and not any(
            alive[j] and not draining[j] for j in range(R)
        ):
            break  # whole fleet drained/failed: queued work is stranded

        # -- dispatch (strict SLO priority, steering policy) ---------------
        rr = ticks  # round-robin phase
        while queue:
            cands = [
                j for j in range(R)
                if alive[j] and not draining[j] and _backlog(j) < slots + 4
            ]
            if not cands:
                break
            _, _, _, req = heapq.heappop(queue)
            if policy == "round_robin":
                j = cands[rr % len(cands)]
                rr += 1
                reason = "round-robin"
            elif policy == "least_loaded":
                j = min(cands, key=lambda c: (_backlog(c), c))
                reason = "least-loaded"
            else:
                pm = region_mix[req["region"]]
                scored = sorted(
                    (
                        locality_score(
                            pm, mix_ewma[c],
                            placement_fit=placement_cost(
                                np.tile(pm[None, :], (S, 1)),
                                cps[c].layer_perms[0], epd,
                            ) / S,
                            backlog=_backlog(c), slots=slots,
                            gamma=locality_gamma, beta=steer_load_beta,
                        ),
                        c,
                    )
                    for c in cands
                )
                j = scored[0][1]
                reason = "locality"
            steer_counts[reason] = steer_counts.get(reason, 0) + 1
            if req["rid"] not in xfer_s:
                pbytes = req["prompt_len"] * dt * d  # activation-width proxy
                cross_tier_bytes += pbytes
                xfer_s[req["rid"]] = (
                    pbytes * 8 / max(cross_region_gbps * 1e9, 1e-9) + 1e-3
                    if R > 1 else 0.0
                )
            prefill_q[j].append([req, req["prompt_len"]])

        # -- one synchronized priced tick across replicas ------------------
        tick_dur = 0.0
        for j in range(R):
            if not alive[j] or not (prefill_q[j] or live[j]):
                continue
            n_live = len(live[j])
            pf_tokens = 0
            budget = prefill_chunk_tokens
            done_pf = []
            for item in prefill_q[j]:
                if budget <= 0 or n_live + len(done_pf) >= slots:
                    break
                take = min(budget, item[1])
                item[1] -= take
                budget -= take
                pf_tokens += take
                if item[1] == 0:
                    done_pf.append(item[0])
            routed = n_live + pf_tokens
            rep_t = 0.0
            blocked = 0.0
            if routed:
                mix = _replica_mix(j)
                mix_ewma[j] = 0.7 * mix_ewma[j] + 0.3 * mix
                served = mix_ewma[j]
                n_eff = 1.0 / float((served ** 2).sum())  # inverse Simpson
                neff_sum[j] += n_eff
                neff_ticks[j] += 1
                tick_bytes = comm.ep_alltoall_bytes(routed, k, d, dt)
                a2a_bytes[j] += layers * tick_bytes
                routed_tokens[j] += routed
                mean_ctx = (
                    float(np.mean([it[2] for it in live[j]])) if live[j] else 64.0
                )
                attn_t = max(
                    (2 * n_live * 4 * d * d + 2 * 2 * n_live * mean_ctx * d)
                    / rate,
                    (n_live * mean_ctx * 2 * d * dt) / hbm,
                )
                # The residency floor: only the experts the served mix
                # touches stream from HBM each tick (hot-expert caching) —
                # a region-pure replica's floor is its few hot experts.
                exp_t = max(
                    2 * routed * k * 3 * d * dff / rate,
                    (min(n_eff, E) * 3 * d * dff * dt) / hbm,
                )
                pf_t = pf_tokens * (2 * 4 * d * d + 2 * k * 3 * d * dff) / rate
                cps[j].observe(0, served * routed * k)
                cps[j].end_step()
                if use_reconfig and amorts[j].due(ticks):
                    window = amorts[j].window()
                    plan = cps[j].plan(0)
                    if plan.reconfigure:
                        # Steering stopped keeping this replica's mix
                        # resident: re-solve locally, pay the OCS delay
                        # against the realized window.
                        cps[j].apply(plan)
                        blocked = max(
                            0.0, fabrics[j].cfg.reconfig_delay_s - window
                        )
                        reconfig_count += 1
                demand = _mix_demand(
                    served, cps[j].layer_perms[0], S, epd, tick_bytes
                )
                if hasattr(fabrics[j], "prepare"):
                    fabrics[j].prepare(demand, can_hide=True)
                t_disp = a2a_ops[j].cost(fabrics[j], demand)
                t_comb = a2a_ops[j].cost(fabrics[j], demand.T)
                total_t, _ = overlap.decode_tick_phase(
                    t_disp, exp_t, t_comb, max(model.overlap_chunks, 1),
                    attn=attn_t, prefill_compute=pf_t,
                )
                rep_t = layers * total_t
                amorts[j].accumulate(layers * (attn_t + exp_t + pf_t))
            blocked_total += blocked
            tick_dur = max(tick_dur, rep_t + blocked)
            # completions (as simulate_serving: live decode emits first,
            # the tick's finished prefills join live for the NEXT tick)
            still = []
            for it in live[j]:
                it[1] -= 1
                it[2] += 1
                tokens_out += 1
                if it[1] <= 0:
                    completed += 1
                else:
                    still.append(it)
            live[j] = still
            for req in done_pf:
                prefill_q[j] = [it for it in prefill_q[j] if it[0] is not req]
                t1 = clock + rep_t + blocked - req["arrival_s"] + xfer_s.get(
                    req["rid"], 0.0
                )
                ttft_all.append(t1)
                name = req["slo"].name
                hits_by_class.setdefault(name, []).append(
                    int(t1 <= req["slo"].ttft_target_s)
                )
                tokens_out += 1  # the prefill's next-token
                if req["max_new"] <= 1:
                    completed += 1
                else:
                    live[j].append(
                        [req, req["max_new"] - 1, req["prompt_len"], clock]
                    )
        clock += tick_dur
        busy_s += tick_dur
        ticks += 1

    # -- pricing ----------------------------------------------------------
    fleet_cost = sum(
        costm.fabric_cost(
            f.name, f.cfg.num_servers, int(f.cfg.link_gbps),
            nics_per_server=f.cfg.nics_per_server, eps_nics=f.cfg.eps_nics,
            ocs_nics=f.cfg.ocs_nics, oversub_ratio=f.cfg.oversub_ratio,
        )
        for f in fabrics
    )
    cross_cost = (
        costm.fabric_cost(
            "fat-tree", max(R, 2), int(cross_region_gbps), nics_per_server=2
        )
        if R > 1
        else 0.0
    )
    sim_seconds = max(clock, 1e-12)
    # Goodput over fleet SERVICE time, not wall clock: an open-loop arrival
    # stream can leave the fleet idle between bursts, and that idle time is
    # a property of the workload, not of the steering policy under test.
    goodput = tokens_out / max(busy_s, 1e-12)
    pct = lambda a, q: float(np.percentile(a, q)) if len(a) else 0.0
    _flush_ledger(
        "fleet",
        a2a_bytes=float(sum(a2a_bytes)),
        cross_tier_bytes=cross_tier_bytes,
        reconfig_blocked_s=blocked_total,
    )
    return FleetServingResult(
        policy=policy,
        fabric=fabric_name,
        num_replicas=R,
        ticks=ticks,
        sim_seconds=sim_seconds,
        requests=len(pending),
        completed=completed,
        tokens_out=int(round(tokens_out)),
        ttft_p50_s=pct(ttft_all, 50),
        ttft_p99_s=pct(ttft_all, 99),
        goodput_tok_s=goodput,
        fleet_cost_usd=fleet_cost,
        cross_tier_cost_usd=cross_cost,
        goodput_per_mdollar=goodput / ((fleet_cost + cross_cost) / 1e6),
        slo_attainment={
            name: float(np.mean(v)) for name, v in sorted(hits_by_class.items())
        },
        steer_counts=steer_counts,
        reconfig_count=reconfig_count,
        reconfig_blocked_s=blocked_total,
        replica_a2a_bytes=list(a2a_bytes),
        replica_routed_tokens=[int(t) for t in routed_tokens],
        replica_mean_active_experts=[
            (neff_sum[j] / neff_ticks[j]) if neff_ticks[j] else 0.0
            for j in range(R)
        ],
        cross_tier_bytes=cross_tier_bytes,
    )


@_traced_scenario
def simulate_training(
    model: SimModel,
    fabric: Fabric,
    *,
    iterations: int = 10,
    seed: int = 0,
    use_copilot: bool = True,
    gpus_per_server: int = 8,
    controlplane: ControlPlane | None = None,
) -> list[IterationResult]:
    """Run several iterations through one persistent control-plane engine,
    fitting COPILOT online like the real system (Fig 20's outer loop).

    Pass ``controlplane`` to inject failures or custom engine settings — e.g.
    ``cp.fail_device(0)`` before calling to reproduce §5.4 scenarios."""
    region = max(model.gpus_per_stage // gpus_per_server, 2)
    trace = GateTraceGenerator(model.layers_per_stage, model.num_experts, seed=seed)
    cp = controlplane or ControlPlane.for_simulation(
        model, fabric, num_servers_region=region, use_copilot=use_copilot
    )
    results = []
    for _ in range(iterations):
        res = simulate_iteration(
            model,
            fabric,
            trace,
            num_servers_region=region,
            controlplane=cp,
            gpus_per_server=gpus_per_server,
        )
        results.append(res)
        cp.end_step()
    return results
