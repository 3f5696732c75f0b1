"""FleetEngine — multi-replica serving with gate-locality steering
(DESIGN.md §12), ported from :mod:`repro.serve.fleet`.

MoE gate traffic is *regionally* skewed (the paper's §3 measurement), which
is why regionally reconfigurable domains beat global reconfiguration.  The
fleet applies the same argument one level up, where a "region" is a whole
:class:`~repro_torch.serve.engine.ServeEngine` replica: a fleet behind one
admission queue *steers* a request to the replica whose resident expert mix
matches its region before it ever *reconfigures* a replica.

Three layers, as in the reference:

* **Admission** — one global queue ordered by SLO class priority
  (:data:`repro_torch.serve.workload.SLO_CLASSES`: chat > agentic > batch),
  then arrival; strict-priority work-conserving dispatch to any replica with
  backlog headroom (a full fleet waits a tick: no deadlock).
* **Steering** — policy ``locality`` scores each candidate with
  :func:`locality_score` (the request region's predicted per-layer expert
  mix, merged across replicas and refined by a fitted COPILOT rollout,
  against the replica's resident mix and current placement, plus a load
  term); cold regions fall back to least-loaded.  ``least_loaded`` and
  ``round_robin`` are the baselines.
* **Steer-vs-reconfigure** — on the fleet cadence each replica's own
  :meth:`ControlPlane.plan` hysteresis re-tests its *served* traffic, and a
  plan that clears the min-gain threshold is applied replica-locally.

**Replica weights.**  A reconfiguration permutes a replica's expert
weights IN PLACE (``permute_expert_weights``), where JAX builds new arrays.
So replicas must not share expert tensors: :func:`replica_params` gives each
replica its own copy of the expert leaves (every other leaf is shared), and
:class:`FleetEngine` refuses replicas whose expert leaves share storage —
otherwise one replica's move would shift the experts under every other
replica, whose router maps did not change.

**Bit-exactness**: a request's tokens are a function of (prompt, params,
sampling keys) only — so the same request produces identical tokens on any
replica, steered or not, drained and re-admitted, or restarted after a
replica failure, under dropless dispatch.  On the card this rests on a
row's bits not depending on its batch (``layers.decode_rows``, kernel 3's
split from the table's width alone) nor on whether its prompt prefix was
a prefix-cache hit (both admissions run the same continuation chunk).
``tests/test_torch_fleet.py`` asserts it across policies x fleet sizes.
"""

from __future__ import annotations

import dataclasses
import heapq
import math

import numpy as np

import torch

from repro_torch.core.controlplane import EXPERT_LEAVES, RegionGateStats
from repro_torch.obs import metrics, trace
from repro_torch.obs.traffic import TrafficObservatory
from repro_torch.serve import events as sev
from repro_torch.serve.batching import Request
from repro_torch.serve.engine import ServeEngine, ServeReport
from repro_torch.serve.workload import (
    SLOClass,
    SyntheticRequest,
    WorkloadGenerator,
    slo_for,
)

__all__ = [
    "expert_leaves",
    "replica_params",
    "FleetConfig",
    "FleetRequest",
    "FleetReport",
    "FleetEngine",
    "locality_score",
    "fleet_requests",
]


@dataclasses.dataclass(frozen=True)
class FleetRequest:
    """One request as the fleet sees it: prompt already materialized (the
    fleet may steer it to any replica, or to several after a failure)."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival_s: float = 0.0
    region: int | None = None
    slo: SLOClass = dataclasses.field(default_factory=lambda: slo_for("default"))
    eos_id: int | None = None


@dataclasses.dataclass
class FleetConfig:
    policy: str = "locality"  # "locality" | "least_loaded" | "round_robin"
    tick_s: float = 0.05
    # Per-replica admitted backlog cap (live + prefilling + queued) — the
    # steering horizon: beyond it a request waits in the global queue where
    # it can still be re-steered.
    queue_cap: int = 8
    max_ticks: int = 20_000
    # Fleet-cadence steer-vs-reconfigure check (0 = steering only).  Each
    # replica's own ControlPlane hysteresis (min_gain_fraction) decides; the
    # fleet only sets the cadence and actuates replica-locally.
    reconfig_every: int = 0
    # Locality-score mixing: placement-fit weight and load-penalty weight.
    locality_gamma: float = 0.5
    steer_load_beta: float = 0.25


@dataclasses.dataclass
class FleetReport:
    requests: int
    completed: int
    ticks: int
    tokens_out: int
    policy: str
    steer_reasons: dict
    reconfig_events: int  # fleet-triggered replica reconfigurations
    ttft_ticks_p50: float
    ttft_ticks_p99: float
    slo_attainment: dict  # class name -> fraction meeting its TTFT target
    outputs: dict  # rid -> list of generated token ids
    per_replica: list[ServeReport]


def _bhattacharyya(a: np.ndarray, b: np.ndarray) -> float:
    """Overlap of two mix distributions in [0, 1] (1 = identical)."""
    a = np.asarray(a, dtype=np.float64).reshape(-1)
    b = np.asarray(b, dtype=np.float64).reshape(-1)
    a = a / max(float(a.sum()), 1e-12)
    b = b / max(float(b.sum()), 1e-12)
    return float(np.sqrt(a * b).sum())


def locality_score(
    predicted_mix: np.ndarray,
    resident_mix: np.ndarray | None,
    *,
    placement_fit: float = 0.0,
    backlog: int = 0,
    slots: int = 1,
    gamma: float = 0.5,
    beta: float = 0.25,
) -> float:
    """Steering score of one replica for one request — LOWER is better.

    ``1 - BC(predicted, resident)`` is the residency miss (how much of the
    request's predicted expert mix the replica is not already serving),
    ``placement_fit`` the normalized bottleneck cost of the predicted mix
    under the replica's current placement
    (:meth:`ServeEngine.placement_cost_of`), and the load term keeps
    locality from dogpiling the single best replica.
    """
    miss = 1.0 if resident_mix is None else 1.0 - _bhattacharyya(
        np.asarray(predicted_mix).mean(axis=0)
        if np.asarray(predicted_mix).ndim > 1 else predicted_mix,
        np.asarray(resident_mix).mean(axis=0)
        if np.asarray(resident_mix).ndim > 1 else resident_mix,
    )
    return miss + gamma * placement_fit + beta * backlog / max(slots, 1)


def fleet_requests(
    requests: list[SyntheticRequest],
    generator: WorkloadGenerator,
    *,
    slo: SLOClass | None = None,
    eos_id: int | None = None,
) -> list[FleetRequest]:
    """Materialize one mix's synthetic stream into steerable fleet requests
    (the SLO class defaults to the generator mix's)."""
    cls = slo or slo_for(generator.mix.name)
    return [
        FleetRequest(
            rid=sr.rid,
            prompt=generator.prompt_tokens(sr),
            max_new_tokens=sr.max_new_tokens,
            arrival_s=sr.arrival_s,
            region=sr.region,
            slo=cls,
            eos_id=eos_id,
        )
        for sr in requests
    ]


def expert_leaves(params) -> list[torch.Tensor]:
    """The leaves of ``params`` that a reconfiguration permutes in place
    (:func:`repro_torch.core.controlplane.permute_expert_weights`)."""
    return [
        leaf
        for bparams in params["blocks"].values()
        if "moe" in bparams
        for name, leaf in bparams["moe"].items()
        if name in EXPERT_LEAVES
    ]


@torch.no_grad()
def replica_params(params):
    """One replica's weight tree: every leaf shared with ``params`` except
    the expert leaves a reconfiguration permutes in place, which are cloned
    (eagerly, so a fleet's memory is known before it runs)."""
    blocks = {}
    for name, bparams in params["blocks"].items():
        if "moe" in bparams:
            moe = {
                k: v.clone() if k in EXPERT_LEAVES else v
                for k, v in bparams["moe"].items()
            }
            bparams = {**bparams, "moe": moe}
        blocks[name] = bparams
    return {**params, "blocks": blocks}


def _check_private_experts(engines: list[ServeEngine]) -> None:
    """Refuse replicas that share an expert leaf's storage: one replica's
    in-place reconfiguration would move the other's experts under its
    unchanged router map."""
    owner: dict[int, int] = {}
    for j, e in enumerate(engines):
        for leaf in expert_leaves(e.params):
            ptr = leaf.untyped_storage().data_ptr()
            if owner.setdefault(ptr, j) != j:
                raise ValueError(
                    f"replicas {owner[ptr]} and {j} share expert weight storage; "
                    "build each replica's tree with replica_params(params)"
                )


class FleetEngine:
    """N ServeEngine replicas behind one SLO-aware steering queue.

    Replicas may be heterogeneous (different slot counts, device regions or
    placement state) but must serve the SAME weights — steering assumes any
    replica produces the same tokens for a request (the bit-exactness bar).
    """

    def __init__(self, engines: list[ServeEngine], fcfg: FleetConfig | None = None):
        if not engines:
            raise ValueError("a fleet needs at least one replica")
        _check_private_experts(engines)
        self.engines = engines
        self.fcfg = fcfg or FleetConfig()
        if self.fcfg.policy not in ("locality", "least_loaded", "round_robin"):
            raise ValueError(f"unknown steering policy {self.fcfg.policy!r}")
        self.alive = [True] * len(engines)
        self.tick = 0
        self.decisions: list[sev.DecisionEvent] = []
        # Measurement plane (DESIGN.md §14): every replica gets its own
        # viewer track so the merged trace shows one row per replica plus
        # one for fleet-level steering/lifecycle decisions.
        self._tr = trace.default()
        self._tid: int | None = None
        for j, e in enumerate(engines):
            if e.name == "serve":  # default name -> stable replica track
                e.name = f"replica{j}"
        self._queue: list[tuple[int, float, int, FleetRequest]] = []
        self._seq = 0
        self._rr = 0
        self.records: dict[int, FleetRequest] = {}
        self.assignment: dict[int, int] = {}  # rid -> replica currently serving
        self._done: dict[int, Request] = {}
        self._arrival_tick: dict[int, int] = {}
        self._first_out_tick: dict[int, int] = {}
        self._finish_tick: dict[int, int] = {}
        self._polled: list[int] = [0] * len(engines)  # finished-list cursors
        self._steer_reasons: dict[str, int] = {}
        self.reconfig_events = 0

    # -- measurement plane (DESIGN.md §14) ------------------------------------
    @property
    def decision_log(self) -> list[dict]:
        """Backward-compat dict view of the typed ``decisions`` journal."""
        return [e.as_dict() for e in self.decisions]

    def _track_id(self) -> int:
        if self._tid is None:
            self._tid = self._tr.track("fleet")
        return self._tid

    def _decide(self, ev: sev.DecisionEvent) -> None:
        self.decisions.append(ev)
        metrics.counter("fleet.decisions", kind=ev.kind).inc()
        if self._tr.enabled:
            self._tr.audit(
                f"fleet.{ev.kind}", ev.as_dict(), cat="decision",
                tid=self._track_id(),
            )

    # -- intake ---------------------------------------------------------------
    def submit(self, freq: FleetRequest) -> None:
        self.records[freq.rid] = freq
        self._arrival_tick.setdefault(freq.rid, self.tick)
        heapq.heappush(
            self._queue, (freq.slo.priority, freq.arrival_s, self._seq, freq)
        )
        self._seq += 1

    # -- replica lifecycle ----------------------------------------------------
    def drain_replica(self, j: int) -> int:
        """Graceful drain: replica ``j`` refuses admissions and finishes its
        in-flight work; its queued-but-unstarted requests are re-steered."""
        handed = self.engines[j].drain()
        for r in handed:
            self.assignment.pop(r.rid, None)
            self.submit(self.records[r.rid])
        self._decide(sev.FleetDrainDecision(
            tick=self.tick, replica=j, resteered=len(handed)
        ))
        return len(handed)

    def restore_replica(self, j: int) -> None:
        self.engines[j].restore()
        self._decide(sev.FleetRestoreDecision(tick=self.tick, replica=j))

    def fail_replica(self, j: int) -> int:
        """Hard failure: everything unfinished on ``j`` (including partially
        generated requests) restarts from scratch elsewhere.  Tokens stay
        bit-identical because generation is a pure function of the request,
        not of the replica or its co-batched traffic."""
        self._poll(j)  # keep whatever finished before the failure
        self.alive[j] = False
        lost = self.engines[j].unfinished_requests()
        for r in lost:
            self.assignment.pop(r.rid, None)
            self.submit(self.records[r.rid])
        self._decide(sev.FleetFailDecision(
            tick=self.tick, replica=j, resteered=len(lost)
        ))
        return len(lost)

    # -- steering -------------------------------------------------------------
    def _backlog(self, j: int) -> int:
        b = self.engines[j].batcher
        return (
            len(b.queue)
            + len(b.prefilling)
            + sum(1 for r in b.active if r is not None)
        )

    def _candidates(self) -> list[int]:
        return [
            j
            for j, e in enumerate(self.engines)
            if self.alive[j]
            and not e.draining
            and self._backlog(j) < self.fcfg.queue_cap
        ]

    def _predicted_mixes(self, region: int | None) -> np.ndarray | None:
        """Fleet-level mix forecast for a region: merge every replica's
        region-conditioned stats, then refine layers > 0 through the first
        fitted COPILOT's transition rollout."""
        if region is None:
            return None
        merged = RegionGateStats.merged(
            [e.region_stats() for j, e in enumerate(self.engines) if self.alive[j]]
        )
        if merged is None:
            return None
        base = merged.mix_for(region)
        if base is None:
            return None
        for j, e in enumerate(self.engines):
            cp = e.controlplane
            if (
                self.alive[j]
                and cp is not None
                and cp.copilot is not None
                and cp.copilot.state.fitted_steps > 0
            ):
                rolled = cp.copilot.rollout(base[0])
                n = min(len(rolled), len(base))
                return 0.5 * base[:n] + 0.5 * rolled[:n]
        return base

    def _pick(self, freq: FleetRequest, cands: list[int]) -> tuple[int, str]:
        by_load = lambda: min(cands, key=lambda j: (self._backlog(j), j))
        if self.fcfg.policy == "round_robin":
            j = cands[self._rr % len(cands)]
            self._rr += 1
            return j, "round-robin"
        if self.fcfg.policy == "least_loaded":
            return by_load(), "least-loaded"
        mixes = self._predicted_mixes(freq.region)
        if mixes is None:
            return by_load(), "cold-region-fallback"
        f = self.fcfg
        scored = sorted(
            (
                locality_score(
                    mixes,
                    self.engines[j].resident_mix(),
                    placement_fit=self.engines[j].placement_cost_of(mixes),
                    backlog=self._backlog(j),
                    slots=self.engines[j].scfg.slots,
                    gamma=f.locality_gamma,
                    beta=f.steer_load_beta,
                ),
                j,
            )
            for j in cands
        )
        return scored[0][1], "locality"

    def _dispatch(self) -> None:
        while self._queue:
            cands = self._candidates()
            if not cands:
                return  # every replica full — wait for in-flight work
            prio, arr, seq, freq = heapq.heappop(self._queue)
            j, reason = self._pick(freq, cands)
            self.assignment[freq.rid] = j
            self._steer_reasons[reason] = self._steer_reasons.get(reason, 0) + 1
            self.engines[j].submit(Request(
                rid=freq.rid,
                prompt=freq.prompt,
                max_new_tokens=freq.max_new_tokens,
                eos_id=freq.eos_id,
                region=freq.region,
            ))
            self._decide(sev.SteerDecision(
                tick=self.tick, rid=freq.rid, region=freq.region,
                slo=freq.slo.name, replica=j, reason=reason,
            ))

    # -- steer-vs-reconfigure (fleet cadence) ---------------------------------
    def _maybe_reconfigure(self) -> None:
        f = self.fcfg
        if (
            f.policy != "locality"
            or not f.reconfig_every
            or self.tick == 0
            or self.tick % f.reconfig_every
        ):
            return
        for j, e in enumerate(self.engines):
            cp = e.controlplane
            if not self.alive[j] or cp is None or e.applier is None:
                continue
            # The replica's own hysteresis over its *served* (post-steering)
            # traffic is the decision rule: a plan clearing min_gain means
            # steering alone no longer keeps this replica's mix resident.
            plans = [cp.plan(layer) for layer in range(cp.num_layers)]
            if not any(p.reconfigure for p in plans):
                continue
            e.apply_plans(plans)
            self.reconfig_events += 1
            self._decide(sev.FleetReconfigDecision(
                tick=self.tick, replica=j,
                layers=[p.layer for p in plans if p.reconfigure],
                gain_bytes=float(sum(
                    p.gain_bytes for p in plans if p.reconfigure
                )),
            ))

    # -- progress tracking ----------------------------------------------------
    def _poll(self, j: int) -> None:
        e = self.engines[j]
        for r in e.batcher.finished[self._polled[j]:]:
            if r.error is None and r.rid not in self._done:
                self._done[r.rid] = r
                self._finish_tick[r.rid] = self.tick
        self._polled[j] = len(e.batcher.finished)
        for r in e.batcher.active:
            if r is not None and r.out and r.rid not in self._first_out_tick:
                self._first_out_tick[r.rid] = self.tick
        for r in e.batcher.finished:
            if r.error is None and r.out and r.rid not in self._first_out_tick:
                self._first_out_tick[r.rid] = self.tick

    @property
    def busy(self) -> bool:
        return bool(self._queue) or any(
            self.alive[j] and e.batcher.busy for j, e in enumerate(self.engines)
        )

    def step(self) -> None:
        """One fleet tick: dispatch from the global queue, tick every busy
        replica, poll completions, run the fleet-cadence reconfigure check."""
        metrics.counter("fleet.ticks").inc()
        tid = self._track_id() if self._tr.enabled else None
        with self._tr.span("fleet.tick", tid=tid, tick=self.tick):
            self._dispatch()
            for j, e in enumerate(self.engines):
                if not self.alive[j]:
                    continue  # failed replicas were polled once at failure
                if e.batcher.busy:
                    e.step()
                self._poll(j)
            self._maybe_reconfigure()
        self.tick += 1

    # -- driving a workload ---------------------------------------------------
    def run(
        self,
        requests: list[FleetRequest],
        *,
        drain_at: dict[int, int] | None = None,
        fail_at: dict[int, int] | None = None,
        restore_at: dict[int, int] | None = None,
    ) -> FleetReport:
        """Serve fleet requests to completion.

        ``drain_at`` / ``fail_at`` / ``restore_at`` map replica index ->
        fleet tick, for scripted degradation scenarios (the fleet keeps
        serving: handed-back work is re-steered the same tick)."""
        drain_at = drain_at or {}
        fail_at = fail_at or {}
        restore_at = restore_at or {}
        pending = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        cursor = 0
        event_ticks = sorted(
            set(drain_at.values()) | set(fail_at.values())
            | set(restore_at.values())
        )
        while self.tick < self.fcfg.max_ticks:
            for j, t in drain_at.items():
                if t == self.tick:
                    self.drain_replica(j)
            for j, t in fail_at.items():
                if t == self.tick:
                    self.fail_replica(j)
            for j, t in restore_at.items():
                if t == self.tick:
                    self.restore_replica(j)
            now_s = self.tick * self.fcfg.tick_s
            while cursor < len(pending) and pending[cursor].arrival_s <= now_s:
                self.submit(pending[cursor])
                cursor += 1
            if cursor >= len(pending) and not self.busy:
                break
            if not self.busy and cursor < len(pending):
                # Idle gap: jump the clock to the next arrival, but never
                # past a scheduled drain/fail/restore event.
                nxt = math.ceil(
                    pending[cursor].arrival_s / self.fcfg.tick_s
                )
                for et in event_ticks:
                    if self.tick < et < nxt:
                        nxt = et
                        break
                self.tick = max(self.tick + 1, nxt)
                continue
            self.step()
        return self.report()

    def observatory(self):
        """Fleet-wide §3 observatory: the replicas' matrices summed (the
        per-replica matrices stay available on each engine)."""
        merged = None
        for e in self.engines:
            if e.observatory is None or not e.observatory.ticks:
                continue
            if merged is None:
                merged = TrafficObservatory.from_report(e.observatory.report())
            else:
                merged.merge(e.observatory)
        return merged

    def report(self) -> FleetReport:
        obs = self.observatory()
        if self._tr.enabled and obs is not None:
            self._tr.audit(
                "traffic.report", {"scope": "fleet", "report": obs.report()},
                cat="traffic", tid=self._track_id(),
            )
        ok = list(self._done.values())
        ttft = np.array(
            [
                self._first_out_tick[rid] - self._arrival_tick[rid]
                for rid in self._done
                if rid in self._first_out_tick
            ],
            dtype=np.float64,
        )
        pct = lambda a, q: float(np.percentile(a, q)) if len(a) else 0.0
        attain: dict[str, list[int]] = {}
        for rid in self._done:
            freq = self.records[rid]
            hit = (
                rid in self._first_out_tick
                and (self._first_out_tick[rid] - self._arrival_tick[rid])
                * self.fcfg.tick_s
                <= freq.slo.ttft_target_s
            )
            attain.setdefault(freq.slo.name, []).append(int(hit))
        return FleetReport(
            requests=len(self.records),
            completed=len(ok),
            ticks=self.tick,
            tokens_out=sum(len(r.out) for r in ok),
            policy=self.fcfg.policy,
            steer_reasons=dict(self._steer_reasons),
            reconfig_events=self.reconfig_events,
            ttft_ticks_p50=pct(ttft, 50),
            ttft_ticks_p99=pct(ttft, 99),
            slo_attainment={
                k: float(np.mean(v)) for k, v in sorted(attain.items())
            },
            outputs={rid: list(r.out) for rid, r in self._done.items()},
            per_replica=[e.report(0.0) for e in self.engines],
        )
