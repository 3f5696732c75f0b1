"""ServeEngine — the reconfigurable expert-parallel serving engine
(DESIGN.md §9), ported from :mod:`repro.serve.engine`.

The engine runs on the card unless it is given ``device="cpu"``.
Checkpoints (``save_checkpoint``/``restore_checkpoint``) carry the weights,
the paged KV pools and the placement and allocator state, and restore them
into the engine's own tensors in place; a trainer's checkpoint restores
into the parameters (its AdamW state is not read).

Over a ``("model",)`` mesh (``mesh=``, one process per rank, each holding
its shard of the experts): every rank runs the same host logic on the same
requests, in lock step because the tokens are the same bits on every rank;
the MoE layers run EP-sharded, the tick's gate load is reduced over the
mesh (so every rank plans alike), a plan that moves whole device blocks is
installed as a wire re-address (``ServeConfig(num_devices=P)``) and any
other moves the expert slots across ranks; checkpoints are global
(:mod:`repro_torch.train.checkpoint` with the tree's layout), so they
restore under any mesh.  Rank 0 alone prints.

Owns the request lifecycle end to end:

    workload (repro.serve.workload) -> admission -> chunked prefill
    interleaved into decode ticks (repro.serve.batching) -> EP-sharded
    decode -> per-tick gate-load observation -> ControlPlane.observe /
    end_step -> placement plans applied BETWEEN ticks (weight permutation,
    or wire re-address for whole-device-block plans) -> checkpoint.

This is the serving half of the paper's runtime-reconfiguration story: the
decode-time expert load is skewed and drifts with the request mix (§3's
locality, which the workload generator's regional skew reproduces), so the
same monitor -> solve -> actuate loop the trainer runs
(:class:`repro.core.controlplane.ControlPlane` +
:class:`~repro.core.controlplane.PlacementApplier`) migrates hot experts
toward the regions generating their traffic while the server keeps serving.

**Generation-consistency guarantee**: with identical seeds and request
streams, the generated tokens are bit-identical with reconfiguration on and
off.  A placement plan moves expert *weights* (or wire addresses) and
re-addresses the router through ``expert_perm`` in the same transaction —
and every decode-path combine sums choices in gate order, never slot order
(:mod:`repro.models.moe`), so no float association moves with the
permutation.  The parity sweep in ``tests/test_serve.py`` asserts this for
P ∈ {1,2,4,8} × dropless/capacity.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import commruntime as comm
from repro_torch.core.controlplane import ControlPlane, LayerPlan, PlacementApplier
from repro_torch.models import routing
from repro_torch.obs import metrics, trace
from repro_torch.obs.traffic import TrafficObservatory
from repro_torch.parallel.sharding import ShardingPlan, TreeLayout, virtual_experts
from repro_torch.serve import events as sev
from repro_torch.serve.batching import ContinuousBatcher, Request, TickStats
from repro_torch.serve.workload import SyntheticRequest, WorkloadGenerator
from repro_torch.train import checkpoint as ckpt

__all__ = ["ServeConfig", "ServeReport", "ServeEngine"]


@dataclasses.dataclass
class ServeConfig:
    slots: int = 4
    max_len: int = 128
    # Chunked prefill budget per tick (tokens); 0 = whole-prompt prefill at
    # admission (the pre-engine behaviour).
    prefill_chunk: int = 0
    # Virtual seconds one tick represents — maps workload arrival times onto
    # the tick clock deterministically (parity runs replay identically).
    tick_s: float = 0.05
    # Decode-time reconfiguration: every N ticks the engine asks the control
    # plane for per-layer placement plans and applies them between ticks.
    # 0 disables the control loop entirely.
    reconfig_every: int = 0
    reconfig_min_gain: float = 0.0
    # Control-plane device space (expert slots per device = Ev / num_devices).
    # 0 = the sharding plan's model-axis size.  A logical region larger than
    # the physical axis is legal — placement-mode perms are pure router/weight
    # re-addressing (DESIGN.md §2).
    num_devices: int = 0
    use_copilot: bool = False
    sample: bool = False
    max_ticks: int = 10_000
    # Paged KV cache (DESIGN.md §10).  None = auto (paged whenever the model
    # supports it); False forces the dense per-slot ring buffer.
    paged: bool | None = None
    page_size: int = 16
    num_pages: int = 0  # 0 = slots * ceil(max_len / page_size)
    prefix_cache: bool = True
    # Speculative decoding (DESIGN.md §11): draft up to spec_k tokens per
    # slot per tick with the cheap same-weights pass and verify them in one
    # chunked full-model step.  0 = off.  Requires the paged KV cache.
    spec_k: int = 0
    # Draft pass: "auto" (shared_only when the model has shared experts,
    # else topk1), or an explicit MoEConfig.draft_mode value.
    spec_draft_mode: str = "auto"
    # Base seed for the per-(request, emitted-token) sampling keys (only
    # used when sample=True).
    sample_seed: int = 0
    # Fleet hooks (DESIGN.md §12).  ``external_control`` builds the control
    # plane even with reconfig_every=0 — an external controller (FleetEngine)
    # decides WHEN to reconfigure and drives ``apply_plans`` itself.
    # ``num_regions`` > 0 turns on region-conditioned gate statistics: each
    # tick's observed gate load is attributed to the traffic regions of the
    # live requests (the per-replica statistics fleet steering merges).
    external_control: bool = False
    num_regions: int = 0


@dataclasses.dataclass
class ServeReport:
    """End-of-run serving metrics (ticks are the deterministic clock; wall
    seconds measure this host's actual throughput)."""

    requests: int
    completed: int
    rejected: int
    ticks: int
    tokens_out: int
    wall_s: float
    tokens_per_s: float
    ttft_ticks_p50: float
    ttft_ticks_p99: float
    ttft_s_p50: float  # virtual (tick_s-scaled) TTFT
    ttft_s_p99: float
    tpot_ticks_mean: float
    reconfig_count: int
    wire_reconfig_count: int
    # Decode-path EP all-to-all payload bytes, accounted through the SAME
    # CommRuntime formula netsim prices (ep_alltoall_bytes) — the serving
    # cross-check in tests/test_serve.py.
    a2a_bytes: float
    gate_load_total: np.ndarray | None
    # Paged-KV telemetry (zeros when running the dense ring buffer).
    kv_paged: bool = False
    kv_resident_pages_peak: int = 0
    kv_pool_pages: int = 0
    kv_prefix_hit_pages: int = 0
    kv_cow_forks: int = 0
    kv_evictions: int = 0
    # Speculative-decoding telemetry (DESIGN.md §11; zeros when spec_k=0).
    spec_k: int = 0
    spec_drafted: int = 0  # draft tokens proposed across the run
    spec_accepted: int = 0  # draft tokens accepted and emitted
    spec_acceptance: float = 0.0  # accepted / drafted
    draft_truncations: int = 0  # rejected-tail truncations applied
    pages_reclaimed: int = 0  # whole pages freed immediately by truncation


class ServeEngine:
    """Reconfigurable EP serving engine over a :class:`ContinuousBatcher`."""

    def __init__(
        self,
        params,
        cfg,
        plan: ShardingPlan,
        scfg: ServeConfig | None = None,
        *,
        mesh=None,
        name: str | None = None,
        device=None,
    ):
        self.cfg = cfg
        self.plan = plan
        self.mesh = mesh
        self.scfg = scfg or ServeConfig()
        s = self.scfg
        self.batcher = ContinuousBatcher(
            params, cfg, plan, slots=s.slots, max_len=s.max_len, mesh=mesh,
            prefill_chunk=s.prefill_chunk, sample=s.sample,
            paged=s.paged, page_size=s.page_size, num_pages=s.num_pages,
            prefix_cache=s.prefix_cache, spec_k=s.spec_k,
            spec_draft_mode=s.spec_draft_mode, sample_seed=s.sample_seed,
            device=device,
        )
        # Draft tokens pay a narrower routed fan-out on the wire (0 for
        # shared_only drafts — no dispatch a2a at all).
        self._draft_top_k = (
            routing.effective_top_k(cfg.moe.top_k, self.batcher.draft_mode)
            if cfg.is_moe and s.spec_k > 0
            else 0
        )
        self.controlplane: ControlPlane | None = None
        self.applier: PlacementApplier | None = None
        if cfg.is_moe and (s.reconfig_every or s.external_control):
            ev, r = virtual_experts(cfg.moe.num_experts, plan.model_size)
            ndev = s.num_devices or max(plan.model_size, 1)
            self.controlplane = ControlPlane(
                num_layers=cfg.pattern_repeats,
                num_experts=cfg.moe.num_experts,
                num_devices=ndev,
                replication=r,
                min_gain_fraction=s.reconfig_min_gain,
                use_copilot=s.use_copilot,
                num_regions=s.num_regions,
            )
            # Wire re-addressing on a model axis: the mixnet a2a realizes the
            # device map on the wire, the dense backends compose it into the
            # slot addressing (models.moe.moe_apply).  Any other plan moves
            # the expert slots, across ranks over a mesh.
            self.applier = PlacementApplier(
                self.controlplane,
                model_size=max(plan.model_size, 1),
                wire_capable=True,
                mesh=mesh,
                axis=plan.model_axis,
            )
            self.batcher.expert_perm = self.controlplane.perm_stack()
        # Per-tick decode a2a payload accounting (one EP a2a phase per MoE
        # layer per tick), through the CommRuntime byte formula.
        self._moe_layers = (
            cfg.pattern_repeats
            * sum(1 for k in cfg.block_pattern if k in ("global", "local"))
            if cfg.is_moe
            else 0
        )
        self._dtype_bytes = getattr(torch, cfg.dtype).itemsize
        self.a2a_bytes = 0.0
        self.gate_load_total: np.ndarray | None = None
        self.tick_log: list[TickStats] = []
        # Fleet/lifecycle state (DESIGN.md §12).
        self.draining = False
        self.decisions: list[sev.DecisionEvent] = []
        self._resident_mix: np.ndarray | None = None  # [L, E] EWMA gate mix
        # Measurement plane (DESIGN.md §14): the process tracer, this
        # engine's viewer track (lazy — fleet renames replicas before the
        # first tick), cached metric children, and the §3 observatory fed
        # every observed tick's gate load through the live perm stack.
        self.name = name or "serve"
        self._tr = trace.default()
        self._tid: int | None = None
        self._kv_last: tuple | None = None
        _m = metrics.default()
        self._m_ticks = _m.counter("serve.ticks")
        self._m_tokens = _m.counter("serve.tokens_served")
        self._m_a2a = _m.counter("serve.a2a_bytes")
        self.observatory = (
            TrafficObservatory(
                cfg.pattern_repeats,
                cfg.moe.num_experts,
                num_devices=(
                    self.controlplane.num_devices if self.controlplane else 1
                ),
                replication=(
                    self.controlplane.replication if self.controlplane else 1
                ),
                num_regions=s.num_regions,
            )
            if cfg.is_moe
            else None
        )

    # -- request intake -------------------------------------------------------
    @property
    def params(self):
        return self.batcher.params

    @property
    def tick(self) -> int:
        return self.batcher.tick

    # -- measurement plane (DESIGN.md §14) ------------------------------------
    @property
    def decision_log(self) -> list[dict]:
        """Backward-compat dict view of the typed ``decisions`` journal —
        same keys, same order as the legacy raw-dict log."""
        return [e.as_dict() for e in self.decisions]

    def _track_id(self) -> int:
        if self._tid is None:
            self._tid = self._tr.track(self.name)
            # Batcher spans (prefill/decode/spec) share this engine's row.
            self.batcher.trace_tid = self._tid
        return self._tid

    def _decide(self, ev: sev.DecisionEvent) -> None:
        """Journal a typed lifecycle decision and mirror it onto the trace
        as a structured audit event."""
        self.decisions.append(ev)
        metrics.counter("serve.decisions", kind=ev.kind).inc()
        if self._tr.enabled:
            self._tr.audit(
                f"serve.{ev.kind}", ev.as_dict(), cat="decision",
                tid=self._track_id(),
            )

    def submit(self, req: Request) -> None:
        if self.draining:
            raise RuntimeError("engine is draining; admissions refused")
        self.batcher.submit(req)

    # -- drain / restore lifecycle (DESIGN.md §12) ----------------------------
    def drain(self) -> list[Request]:
        """Stop accepting work: refuse new admissions, hand back every
        queued-but-not-started request (the fleet re-steers them), and let
        in-flight requests finish normally.  After draining idles the engine
        (``batcher.busy`` false), ``save_checkpoint`` exports a complete
        resumable state: params + placement + paged pool + prefix registry."""
        self.draining = True
        handed = [r for r in self.batcher.queue]
        self.batcher.queue.clear()
        for r in handed:
            r.submit_tick = -1
        self._decide(sev.DrainDecision(tick=self.tick, handed_back=len(handed)))
        return handed

    def restore(self) -> None:
        """Re-open admissions after a drain."""
        self.draining = False
        self._decide(sev.RestoreDecision(tick=self.tick))

    def unfinished_requests(self) -> list[Request]:
        """Every admitted-but-unfinished request (queued, prefilling or
        decoding) — what a fleet must re-admit elsewhere when this replica
        fails hard (as opposed to a graceful drain)."""
        live = [r for r in self.batcher.active if r is not None]
        live += [p.req for p in self.batcher.prefilling]
        live += list(self.batcher.queue)
        return live

    # -- the decode-time control loop ----------------------------------------
    @property
    def is_main(self) -> bool:
        """True on the rank that prints and reports (rank 0, or the only
        process)."""
        import torch.distributed as dist

        return self.mesh is None or not dist.is_initialized() or dist.get_rank() == 0

    def _mesh_load(self, load: np.ndarray) -> np.ndarray:
        """The tick's gate load averaged over the model axis: every rank then
        plans on the same bits (the ranks route the same rows, so the mean
        of equal counts is the count itself)."""
        p = comm.axis_size(self.mesh, self.plan.model_axis)
        if self.mesh is None or p <= 1:
            return load
        t = torch.as_tensor(np.asarray(load, np.float32), device=self.batcher.device)
        t = comm.all_reduce(t, comm.axis_group(self.mesh, self.plan.model_axis)) / float(p)
        return t.cpu().numpy()

    def _observe(self, stats: TickStats) -> None:
        if stats.gate_load is None:
            return
        load = np.asarray(self._mesh_load(stats.gate_load), dtype=np.float64)
        self.gate_load_total = (
            load if self.gate_load_total is None else self.gate_load_total + load
        )
        if load.sum() > 0:
            norm = load / np.maximum(load.sum(axis=-1, keepdims=True), 1e-12)
            self._resident_mix = (
                norm if self._resident_mix is None
                else 0.8 * self._resident_mix + 0.2 * norm
            )
        regions = self.live_region_weights()
        if self.observatory is not None:
            # §3 observatory: fold the tick's realized gate load through the
            # CURRENT perm stack so the expert→device matrix reflects the
            # placement actually serving it (DESIGN.md §14).
            self.observatory.record(
                load,
                self.controlplane.perm_stack() if self.controlplane else None,
                regions,
            )
        if self.controlplane is not None:
            for layer in range(load.shape[0]):
                self.controlplane.observe(layer, load[layer])
            self.controlplane.observe_regions(regions, load)
            self.controlplane.end_step()

    # -- exported gate statistics (fleet steering inputs, DESIGN.md §12) ------
    def live_region_weights(self) -> dict[int, float]:
        """Each traffic region's share of the currently live requests."""
        regs = [r.region for r in self.batcher.active
                if r is not None and r.region is not None]
        regs += [p.req.region for p in self.batcher.prefilling
                 if p.req.region is not None]
        if not regs:
            return {}
        out: dict[int, float] = {}
        for rg in regs:
            out[rg] = out.get(rg, 0.0) + 1.0 / len(regs)
        return out

    def resident_mix(self) -> np.ndarray | None:
        """``[L, E]`` EWMA of the recently served gate mix — what "the expert
        mix this replica is currently keeping resident" means for the fleet's
        locality score."""
        return self._resident_mix

    def region_stats(self):
        """Per-replica region-conditioned gate stats (None unless the engine
        was built with ``num_regions > 0`` and a control plane)."""
        return self.controlplane.region_stats if self.controlplane else None

    def placement_cost_of(self, mixes: np.ndarray) -> float:
        """Bottleneck crossing cost of serving per-layer expert mixes
        ``[L, E]`` under THIS replica's current placement, normalized to the
        per-layer demand mass — the placement-fit term of the fleet locality
        score.  Engines without a control plane score 0 (no placement state
        to mismatch)."""
        cp = self.controlplane
        if cp is None:
            return 0.0
        from repro_torch.core.placement import placement_cost

        mixes = np.asarray(mixes, dtype=np.float64)
        total = 0.0
        for layer in range(min(mixes.shape[0], cp.num_layers)):
            mix = mixes[layer]
            s = mix.sum()
            if s <= 0:
                continue
            vload = np.repeat(mix / s, cp.replication) / cp.replication
            demand = np.tile(vload[None, :], (cp.num_devices, 1))
            total += placement_cost(
                demand, cp.layer_perms[layer], cp.experts_per_device
            ) / cp.num_devices
        return float(total)

    def apply_plans(self, plans: list[LayerPlan]) -> bool:
        """Actuate placement plans BETWEEN ticks: expert weights are gathered
        into their new slots (or wire-re-addressed for whole-device-block
        plans) and the router's perm stack updates in the same transaction —
        in-flight slot caches are position-addressed, so live requests
        continue bit-identically (the §9 consistency guarantee)."""
        if self.applier is None:
            raise RuntimeError("no control plane configured (reconfig_every=0?)")
        params, changed = self.applier.apply(self.batcher.params, plans)
        if changed:
            self.batcher.params = params
            self.batcher.expert_perm = self.controlplane.perm_stack()
            self.batcher.wire_perm = self.applier.wire_perm
        return changed

    def _maybe_reconfigure(self) -> None:
        cp = self.controlplane
        if (cp is None or not self.scfg.reconfig_every or self.tick == 0
                or self.tick % self.scfg.reconfig_every):
            return
        with self._tr.span("serve.reconfig", tid=self._track_id(),
                           tick=self.tick) as sp:
            plans = [cp.plan(layer) for layer in range(cp.num_layers)]
            applied = self.apply_plans(plans)
            sp.set(applied=applied)
        self._decide(sev.ReconfigDecision(
            tick=self.tick,
            applied=applied,
            layers=[p.layer for p in plans if p.reconfigure],
            gain_bytes=float(sum(p.gain_bytes for p in plans
                                 if p.reconfigure)),
            reasons=sorted({p.reason for p in plans}),
        ))

    def step(self) -> TickStats:
        """One engine tick: decode + interleaved prefill chunk, stream the
        realized gate loads into the control plane, and (on cadence) apply
        placement plans before the next tick."""
        tr = self._tr
        if not tr.enabled:
            return self._step_inner()
        tid = self._track_id()
        with tr.span("serve.tick", tid=tid, tick=self.tick) as sp:
            stats = self._step_inner()
            sp.set(live=stats.live, prefill_tokens=stats.prefill_tokens,
                   admitted=stats.admitted, finished=stats.finished)
        tr.counter("serve.a2a_bytes", self.a2a_bytes, tid=tid)
        if self.batcher.paged:
            alloc = self.batcher.alloc
            kv = (alloc.resident_pages(), alloc.prefix_hit_pages,
                  alloc.evictions, alloc.cow_forks)
            # Counters render as step functions — only emit on change, so
            # steady-state decode ticks pay one less event.
            if kv != self._kv_last:
                self._kv_last = kv
                tr.counter("serve.kv", {
                    "resident_pages": float(kv[0]),
                    "prefix_hit_pages": float(kv[1]),
                    "evictions": float(kv[2]),
                    "cow_forks": float(kv[3]),
                }, tid=tid)
        return stats

    def _step_inner(self) -> TickStats:
        a2a0 = self.a2a_bytes
        stats = self.batcher.step()
        # Full-model routed positions: one per live slot on plain ticks, the
        # whole verify span on speculative ticks (the a2a launch amortizes
        # over the span, but its payload still scales with positions).
        decode_routed = stats.spec_verified if stats.spec_verified else stats.live
        served = decode_routed + stats.prefill_tokens
        if served and self._moe_layers:
            self.a2a_bytes += self._moe_layers * comm.ep_alltoall_bytes(
                served, self.cfg.moe.top_k, self.cfg.d_model, self._dtype_bytes
            )
        if stats.spec_drafted and self._moe_layers and self._draft_top_k:
            self.a2a_bytes += self._moe_layers * comm.ep_alltoall_bytes(
                stats.spec_drafted, self._draft_top_k, self.cfg.d_model,
                self._dtype_bytes,
            )
        self._m_ticks.inc()
        self._m_tokens.inc(served)
        self._m_a2a.inc(self.a2a_bytes - a2a0)
        self._observe(stats)
        self._maybe_reconfigure()
        self.tick_log.append(stats)
        return stats

    # -- driving a workload ---------------------------------------------------
    def run(
        self,
        requests: list[SyntheticRequest] | None = None,
        generator: WorkloadGenerator | None = None,
        *,
        eos_id: int | None = None,
        drain: bool = True,
    ) -> ServeReport:
        """Serve a workload to completion.

        ``requests`` (from ``generator.generate``) are admitted when the
        tick clock passes their arrival time; with ``drain`` the engine runs
        until every request completes (or ``max_ticks``)."""
        t0 = time.perf_counter()
        pending = sorted(requests or [], key=lambda r: r.arrival_s)
        cursor = 0
        while self.tick < self.scfg.max_ticks:
            now_s = self.tick * self.scfg.tick_s
            while cursor < len(pending) and pending[cursor].arrival_s <= now_s:
                sr = pending[cursor]
                self.submit(Request(
                    rid=sr.rid,
                    prompt=generator.prompt_tokens(sr),
                    max_new_tokens=sr.max_new_tokens,
                    eos_id=eos_id,
                    region=sr.region,
                ))
                cursor += 1
            if cursor >= len(pending) and not self.batcher.busy:
                break
            if not self.batcher.busy and cursor < len(pending):
                # Idle gap before the next arrival: jump the clock straight
                # to the arrival tick (mirrors netsim's clock jump) instead
                # of burning max_ticks on empty ticks.
                import math

                nxt = math.ceil(pending[cursor].arrival_s / self.scfg.tick_s)
                self.batcher.tick = max(self.tick + 1, nxt)
                continue
            self.step()
            if not drain and cursor >= len(pending):
                break
        return self.report(time.perf_counter() - t0)

    def report(self, wall_s: float) -> ServeReport:
        done = self.batcher.finished
        ok = [r for r in done if r.error is None]
        ttft = np.array(
            [r.first_token_tick - r.submit_tick for r in ok if r.first_token_tick >= 0],
            dtype=np.float64,
        )
        tpot = np.array(
            [
                (r.finish_tick - r.first_token_tick) / max(len(r.out) - 1, 1)
                for r in ok
                if len(r.out) > 1 and r.finish_tick >= 0
            ],
            dtype=np.float64,
        )
        tokens_out = sum(len(r.out) for r in ok)
        pct = lambda a, q: float(np.percentile(a, q)) if len(a) else 0.0
        ts = self.scfg.tick_s
        if (self._tr.enabled and self.observatory is not None
                and self.observatory.ticks):
            # The run's §3 study rides the trace as ONE typed event —
            # scripts/measure_run.py rebuilds the observatory from it.
            self._tr.audit(
                "traffic.report",
                {"scope": self.name, "report": self.observatory.report()},
                cat="traffic", tid=self._track_id(),
            )
        return ServeReport(
            requests=len(done),
            completed=len(ok),
            rejected=len(done) - len(ok),
            ticks=self.tick,
            tokens_out=tokens_out,
            wall_s=wall_s,
            tokens_per_s=tokens_out / max(wall_s, 1e-9),
            ttft_ticks_p50=pct(ttft, 50),
            ttft_ticks_p99=pct(ttft, 99),
            ttft_s_p50=pct(ttft, 50) * ts,
            ttft_s_p99=pct(ttft, 99) * ts,
            tpot_ticks_mean=float(tpot.mean()) if len(tpot) else 0.0,
            reconfig_count=(
                self.controlplane.reconfig_count if self.controlplane else 0
            ),
            wire_reconfig_count=(
                self.applier.wire_reconfig_count if self.applier else 0
            ),
            a2a_bytes=self.a2a_bytes,
            gate_load_total=self.gate_load_total,
            kv_paged=self.batcher.paged,
            kv_resident_pages_peak=self.batcher.kv_resident_pages_peak,
            kv_pool_pages=(
                self.batcher.num_pages if self.batcher.paged else 0
            ),
            kv_prefix_hit_pages=(
                self.batcher.alloc.prefix_hit_pages if self.batcher.paged else 0
            ),
            kv_cow_forks=(
                self.batcher.alloc.cow_forks if self.batcher.paged else 0
            ),
            kv_evictions=(
                self.batcher.alloc.evictions if self.batcher.paged else 0
            ),
            spec_k=self.batcher.spec_k,
            spec_drafted=self.batcher.spec_drafted,
            spec_accepted=self.batcher.spec_accepted,
            spec_acceptance=(
                self.batcher.spec_accepted / max(self.batcher.spec_drafted, 1)
            ),
            draft_truncations=(
                self.batcher.alloc.draft_truncations if self.batcher.paged else 0
            ),
            pages_reclaimed=(
                self.batcher.alloc.pages_reclaimed if self.batcher.paged else 0
            ),
        )

    # -- checkpoint round-trip (DESIGN.md §9, §12) ----------------------------
    def save_checkpoint(self, ckpt_dir: str, step: int | None = None) -> int:
        """Persist params WITH the placement state: the perm stack composes
        against the physically permuted weights, so restoring one without
        the other would misroute every token.

        Paged engines additionally export the KV pools and the allocator's
        page table / prefix registry (the drain checkpoint): a drained and
        restored replica keeps its warm prefix pages."""
        step = self.tick if step is None else step
        extra = {
            "placement": self.applier.state_dict() if self.applier else None,
            "serve": {"tick": self.tick},
        }
        tree = {"params": self.batcher.params}
        if self.batcher.paged:
            extra["kv_alloc"] = self.batcher.alloc.state_dict()
            tree["kv"] = self.batcher.caches
        ckpt.save(ckpt_dir, step, tree, extra=extra, layout=self._layout())
        return step

    def _layout(self) -> TreeLayout:
        return TreeLayout(self.plan, self.mesh, self.cfg)

    def restore_checkpoint(self, ckpt_dir: str, step: int | None = None) -> int:
        """Copy a checkpoint into this engine's parameters (and KV pools) in
        place, with its placement and allocator state."""
        step = ckpt.latest_step(ckpt_dir) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        extra = ckpt.load_extra(ckpt_dir, step)
        placement = extra.get("placement")
        if placement is not None and self.applier is None:
            raise RuntimeError(
                "checkpoint carries placement state but this engine has "
                "no control plane (set reconfig_every > 0)"
            )
        skeleton = {"params": self.batcher.params}
        kv_alloc = extra.get("kv_alloc")
        if kv_alloc is not None and self.batcher.paged:
            skeleton["kv"] = self.batcher.caches
        folded = False
        if placement is not None:
            # Placement first: another number of virtual experts raises
            # before any tensor is touched.
            folded = self.applier.load_state_dict(placement)
        ckpt.restore(ckpt_dir, step, skeleton, layout=self._layout())
        if folded and self.is_main:
            print(f"[serve] placement saved at another model size restored at "
                  f"{max(self.plan.model_size, 1)}: wire maps folded into the perm stack, "
                  "region statistics start fresh", flush=True)
        if kv_alloc is not None and self.batcher.paged:
            self.batcher.alloc.load_state_dict(kv_alloc)
        serve = extra.get("serve") or {}
        if "tick" in serve:
            self.batcher.tick = int(serve["tick"])
        if placement is not None:
            self.batcher.expert_perm = self.controlplane.perm_stack()
            self.batcher.wire_perm = self.applier.wire_perm
        return step
