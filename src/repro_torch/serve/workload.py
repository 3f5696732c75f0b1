"""Synthetic serving workloads (DESIGN.md §9).

One generator feeds BOTH serving consumers: the real engine
(:mod:`repro.serve.engine`, which materializes prompt tokens and drives the
jitted tick loop) and the flow-level simulator
(:func:`repro.core.netsim.simulate_serving`, which only needs arrival times,
lengths and regions) — so the priced scenario and the executed one see the
same traffic, the same way netsim and the trainer share the CommRuntime's
byte accounting.

A :class:`TrafficMix` describes one request population:

* **arrivals** — Poisson (independent exponential gaps) or bursty (a two
  state on/off modulated Poisson process, the production "thundering herd"
  shape);
* **lengths** — prompt and output lengths drawn from bounded Zipf
  (power-law) distributions, the documented long-tail of production traces
  (most requests short, a heavy tail of huge prompts / long generations);
* **regions** — each request originates in one of ``num_regions`` traffic
  regions with Zipf-skewed popularity.  Regional origin is what makes
  decode-time gate load *regionally* skewed — the locality a reconfigurable
  fabric exploits (paper §3) — and drives the per-region demand matrices of
  the netsim serving scenario.

Everything is deterministic in ``seed``: the engine's generation-parity
tests replay the identical request stream with reconfiguration on and off.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TrafficMix", "MIXES", "SyntheticRequest", "WorkloadGenerator",
           "clamp_requests", "SLOClass", "SLO_CLASSES", "slo_for"]


@dataclasses.dataclass(frozen=True)
class TrafficMix:
    """One named request population (arrival process + length laws)."""

    name: str
    rate_rps: float  # mean arrival rate (requests / second)
    arrival: str = "poisson"  # "poisson" | "bursty"
    burst_factor: float = 4.0  # on-state rate multiplier (bursty only)
    burst_on_s: float = 2.0  # mean on-period length (seconds)
    burst_off_s: float = 6.0  # mean off-period length (seconds)
    prompt_min: int = 8
    prompt_max: int = 128
    prompt_zipf_a: float = 1.2  # power-law exponent over [min, max]
    out_min: int = 4
    out_max: int = 64
    out_zipf_a: float = 1.1
    num_regions: int = 4
    region_zipf_a: float = 0.8  # request-origin skew across regions
    # Agentic traces re-send the same system prompt / tool schema on every
    # self-loop call: requests from one region share a common prompt prefix.
    # ``shared_prefix_tokens`` is the per-region prefix length and
    # ``shared_prefix_ratio`` the fraction of requests that carry it — the
    # traffic shape the paged KV cache's prefix registry (DESIGN.md §10)
    # turns into page reuse instead of recomputed prefill.
    shared_prefix_tokens: int = 0
    shared_prefix_ratio: float = 0.0
    # Replica-affinity churn: every ``region_churn_every_s`` seconds the
    # region popularity ranking rotates by ``region_churn_rot`` positions, so
    # the *hot* region migrates mid-stream.  This is the drift that makes a
    # fleet's gate-locality steering eventually lose — the resident mix a
    # replica reconfigured for stops matching its arrivals — and is the
    # trigger for the steer-vs-reconfigure decision rule (DESIGN.md §12).
    # Zero disables churn; mixes without it generate byte-identical streams
    # to earlier versions.
    region_churn_every_s: float = 0.0
    region_churn_rot: int = 1


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One admission-priority class (fleet scheduling, DESIGN.md §12).

    ``priority`` orders the global admission queue (lower dispatches first);
    ``ttft_target_s`` is the class's time-to-first-token objective, the
    attainment denominator :func:`repro.core.netsim.simulate_fleet` reports.
    """

    name: str
    priority: int
    ttft_target_s: float


# Priority classes for the named mixes.  Interactive chat is latency-critical,
# agentic loops tolerate moderate queueing (the caller is a program), batch
# jobs only care about completion.
SLO_CLASSES: dict[str, SLOClass] = {
    "chat": SLOClass("chat", priority=0, ttft_target_s=1.0),
    "agentic": SLOClass("agentic", priority=1, ttft_target_s=4.0),
    "agentic_shared": SLOClass("agentic_shared", priority=1, ttft_target_s=4.0),
    "agentic_churn": SLOClass("agentic_churn", priority=1, ttft_target_s=4.0),
    "batch_summarize": SLOClass("batch_summarize", priority=2, ttft_target_s=30.0),
}

_DEFAULT_SLO = SLOClass("default", priority=1, ttft_target_s=4.0)


def slo_for(mix_name: str) -> SLOClass:
    """SLO class for a mix name (unknown mixes get the mid-priority default)."""
    return SLO_CLASSES.get(mix_name, _DEFAULT_SLO)


# Named mixes the examples/benchmarks reference.  The shapes follow the
# production archetypes: chat = short prompts / medium outputs at steady
# Poisson rate; batch_summarize = long prompts / short outputs arriving in
# bursts (cron-fired document batches); agentic = medium prompts with LONG
# tool-call transcripts and bursty self-loops.
MIXES: dict[str, TrafficMix] = {
    "chat": TrafficMix(
        "chat", rate_rps=8.0, arrival="poisson",
        prompt_min=8, prompt_max=96, prompt_zipf_a=1.4,
        out_min=8, out_max=64, out_zipf_a=1.2,
    ),
    "batch_summarize": TrafficMix(
        "batch_summarize", rate_rps=4.0, arrival="bursty", burst_factor=6.0,
        prompt_min=64, prompt_max=512, prompt_zipf_a=0.8,
        out_min=4, out_max=24, out_zipf_a=1.5,
    ),
    "agentic": TrafficMix(
        "agentic", rate_rps=6.0, arrival="bursty", burst_factor=3.0,
        prompt_min=16, prompt_max=256, prompt_zipf_a=1.0,
        out_min=16, out_max=128, out_zipf_a=0.9,
        num_regions=4, region_zipf_a=1.2,
    ),
    # The agentic mix with the self-loop structure made explicit: ~90% of
    # requests re-send their region's 64-token system prompt verbatim.
    "agentic_shared": TrafficMix(
        "agentic_shared", rate_rps=6.0, arrival="bursty", burst_factor=3.0,
        prompt_min=80, prompt_max=256, prompt_zipf_a=1.0,
        out_min=16, out_max=128, out_zipf_a=0.9,
        num_regions=4, region_zipf_a=1.2,
        shared_prefix_tokens=64, shared_prefix_ratio=0.9,
    ),
    # Region-skewed agentic traffic whose hot region migrates every few
    # seconds — the fleet-steering stress mix: locality steering must either
    # follow the drift or trigger a replica reconfiguration.
    "agentic_churn": TrafficMix(
        "agentic_churn", rate_rps=6.0, arrival="bursty", burst_factor=3.0,
        prompt_min=16, prompt_max=256, prompt_zipf_a=1.0,
        out_min=16, out_max=128, out_zipf_a=0.9,
        num_regions=4, region_zipf_a=1.6,
        region_churn_every_s=8.0, region_churn_rot=1,
    ),
}


@dataclasses.dataclass(frozen=True)
class SyntheticRequest:
    """One generated request (framework-free: netsim consumes it as-is)."""

    rid: int
    arrival_s: float
    prompt_len: int
    max_new_tokens: int
    region: int
    prefix_len: int = 0  # leading tokens shared with the region's prefix


def clamp_requests(
    reqs: list["SyntheticRequest"],
    *,
    prompt_max: int | None = None,
    max_new: int | None = None,
    arrival_s: float | None = None,
) -> list["SyntheticRequest"]:
    """Benchmark-shape a generated stream: cap prompt lengths, pin output
    budgets and/or arrivals, preserving every distributional property the
    caps don't touch.

    The decode benchmarks (``paged_decode``, ``spec_decode``) want the mix's
    region/prefix structure but a decode-heavy shape (short prompts, fixed
    generation budget, no arrival gaps).  Clamping ``prompt_len`` keeps the
    materialized tokens a PREFIX of the unclamped prompt
    (:meth:`WorkloadGenerator.prompt_tokens` draws sequentially from the
    same streams), and ``prefix_len`` is re-clamped so the shared-prefix
    invariant ``prefix_len <= prompt_len`` survives aggressive caps."""
    out = []
    for r in reqs:
        plen = min(r.prompt_len, prompt_max) if prompt_max else r.prompt_len
        out.append(dataclasses.replace(
            r,
            prompt_len=plen,
            prefix_len=min(r.prefix_len, plen),
            max_new_tokens=max_new if max_new is not None else r.max_new_tokens,
            arrival_s=arrival_s if arrival_s is not None else r.arrival_s,
        ))
    return out


def _bounded_zipf(rng: np.random.Generator, a: float, lo: int, hi: int, n: int):
    """Discrete power-law sample over [lo, hi]: p(k) ∝ (k - lo + 1)^-a."""
    support = np.arange(lo, hi + 1)
    p = (support - lo + 1.0) ** -a
    p /= p.sum()
    return rng.choice(support, size=n, p=p)


class WorkloadGenerator:
    """Deterministic request-stream generator for one :class:`TrafficMix`."""

    def __init__(self, mix: TrafficMix | str, *, seed: int = 0, vocab_size: int = 256):
        self.mix = MIXES[mix] if isinstance(mix, str) else mix
        self.seed = seed
        self.vocab_size = vocab_size

    def generate(self, num_requests: int) -> list[SyntheticRequest]:
        m = self.mix
        rng = np.random.default_rng(self.seed)
        # -- arrival process --------------------------------------------------
        if m.arrival == "poisson":
            gaps = rng.exponential(1.0 / m.rate_rps, size=num_requests)
            arrivals = np.cumsum(gaps)
        elif m.arrival == "bursty":
            # Two-state MMPP: on-periods run at rate*burst_factor, off-periods
            # at a trickle; state dwell times are exponential.
            arrivals = np.empty(num_requests)
            t, state, state_left = 0.0, 1, rng.exponential(m.burst_on_s)
            for i in range(num_requests):
                rate = m.rate_rps * (m.burst_factor if state else 0.2)
                gap = rng.exponential(1.0 / rate)
                while gap > state_left:
                    t += state_left
                    gap = (gap - state_left) * (
                        (m.burst_factor if state else 0.2)
                        / (0.2 if state else m.burst_factor)
                    )
                    state = 1 - state
                    state_left = rng.exponential(
                        m.burst_on_s if state else m.burst_off_s
                    )
                t += gap
                state_left -= gap
                arrivals[i] = t
        else:
            raise ValueError(f"unknown arrival process {m.arrival!r}")
        # -- lengths + regions ------------------------------------------------
        plens = _bounded_zipf(rng, m.prompt_zipf_a, m.prompt_min, m.prompt_max,
                              num_requests)
        olens = _bounded_zipf(rng, m.out_zipf_a, m.out_min, m.out_max,
                              num_requests)
        rp = (np.arange(1, m.num_regions + 1) ** -m.region_zipf_a).astype(float)
        rp /= rp.sum()
        regions = rng.choice(m.num_regions, size=num_requests, p=rp)
        if m.region_churn_every_s > 0:
            # Rotate the popularity ranking over time: the region drawn at
            # Zipf rank k at time t is (k + rot * floor(t / every)) mod R, so
            # the hot region walks around the ring deterministically.
            shift = (arrivals // m.region_churn_every_s).astype(np.int64)
            regions = (regions + m.region_churn_rot * shift) % m.num_regions
        # Shared prefixes (drawn only when configured, so mixes without them
        # generate byte-identical streams to earlier versions).
        if m.shared_prefix_tokens > 0:
            carries = rng.random(num_requests) < m.shared_prefix_ratio
            prefix_lens = np.where(
                carries, np.minimum(m.shared_prefix_tokens, plens), 0
            )
        else:
            prefix_lens = np.zeros(num_requests, np.int64)
        return [
            SyntheticRequest(
                rid=i,
                arrival_s=float(arrivals[i]),
                prompt_len=int(plens[i]),
                max_new_tokens=int(olens[i]),
                region=int(regions[i]),
                prefix_len=int(prefix_lens[i]),
            )
            for i in range(num_requests)
        ]

    def prompt_tokens(self, req: SyntheticRequest) -> np.ndarray:
        """Materialize the request's prompt (deterministic in (seed, rid)).

        The leading token encodes the region so requests from the same region
        share a prefix — the correlation that concentrates gate load
        per-region (paper §3's semantic locality, at toy scale).  When the mix
        assigns the request a shared prefix (``req.prefix_len > 0``), the
        first ``prefix_len`` tokens come from a region-seeded stream instead:
        every carrying request from that region sends the identical system
        prompt, which is what the paged cache's prefix registry deduplicates.
        """
        rng = np.random.default_rng((self.seed << 20) ^ req.rid)
        toks = rng.integers(0, self.vocab_size, size=req.prompt_len)
        if req.prefix_len > 0:
            prng = np.random.default_rng((self.seed << 20) ^ 0x5AFE ^ req.region)
            toks[: req.prefix_len] = prng.integers(
                0, self.vocab_size, size=req.prefix_len
            )
        toks[0] = req.region % self.vocab_size
        return toks.astype(np.int32)
