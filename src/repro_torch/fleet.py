"""Multi-replica serving fleet with gate-locality steering (DESIGN.md §12).

ServeEngine replicas behind one SLO-aware admission queue: requests are
steered to the replica whose resident expert mix best matches their
region's predicted mix, one replica is gracefully drained mid-run (its
queued work re-steers, its in-flight work finishes) and restored, and the
run ends by proving the fleet guarantee: every steered or re-steered
request generated tokens bit-identical to unsteered single-replica serving.

    PYTHONPATH=src python -m repro_torch.fleet [--arch grok-1-314b]
        [--mix agentic] [--requests 8] [--policy locality] [--drain-tick 3]
        [--trace build/fleet_trace.json] [--metrics build/fleet_metrics.json]
        [--device cuda|cpu]

The counterpart of ``examples/fleet.py``, with its flags and its reduced
configs.  It runs on the card unless ``--device cpu`` is given; without a
card it exits nonzero.  Each replica gets its own copy of the expert
weights (:func:`repro_torch.serve.fleet.replica_params`): a reconfiguration
permutes them in place.
"""

from __future__ import annotations

import argparse

from repro_torch import resolve_device
from repro_torch.configs import ARCH_NAMES, get_reduced
from repro_torch.models.transformer import init_model
from repro_torch.obs import metrics, trace
from repro_torch.parallel.sharding import make_plan
from repro_torch.serve.batching import Request
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.fleet import FleetConfig, FleetEngine, fleet_requests, replica_params
from repro_torch.serve.workload import MIXES, WorkloadGenerator, clamp_requests


def make_replica(params, cfg, plan, args) -> ServeEngine:
    scfg = ServeConfig(
        slots=args.slots,
        max_len=args.max_len,
        num_devices=args.num_devices,
        external_control=True,  # the FleetEngine decides when to reconfigure
        num_regions=MIXES[args.mix].num_regions,
        reconfig_min_gain=0.0,
    )
    return ServeEngine(params, cfg, plan, scfg, device=args.device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="grok-1-314b")
    ap.add_argument("--mix", choices=sorted(MIXES), default="agentic")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--policy", default="locality",
                    choices=["locality", "least_loaded", "round_robin"])
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-len", type=int, default=48)
    ap.add_argument("--num-devices", type=int, default=4)
    ap.add_argument("--drain-tick", type=int, default=3)
    ap.add_argument("--restore-tick", type=int, default=10)
    ap.add_argument("--reconfig-every", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default="",
                    help="export a Perfetto trace of the run to this path")
    ap.add_argument("--metrics", default="",
                    help="dump the metrics-registry snapshot to this path")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu: refuse
    if args.trace:
        trace.enable()

    cfg = get_reduced(args.arch)
    if cfg.encoder_layers or not cfg.is_moe:
        raise SystemExit("the fleet demo needs a pure-decoder MoE arch")
    if cfg.moe.num_experts % args.num_devices:
        args.num_devices = 1
    plan = make_plan(None)
    params = init_model(0, cfg, plan, device=args.device)

    gen = WorkloadGenerator(args.mix, seed=args.seed, vocab_size=cfg.vocab_size)
    out_cap = max(1, min(10, args.max_len // 4))
    raw = clamp_requests(gen.generate(args.requests),
                         prompt_max=args.max_len - out_cap - 2,
                         max_new=out_cap)
    freqs = fleet_requests(raw, gen)

    print(f"fleet of {args.replicas}x reduced {args.arch} on mix={args.mix} "
          f"({args.device}): {len(freqs)} requests, policy={args.policy}, "
          f"drain replica 1 @ tick {args.drain_tick}")
    fleet = FleetEngine(
        [make_replica(replica_params(params), cfg, plan, args)
         for _ in range(args.replicas)],
        FleetConfig(policy=args.policy, reconfig_every=args.reconfig_every),
    )
    rep = fleet.run(
        freqs,
        drain_at={1: args.drain_tick} if args.replicas > 1 else None,
        restore_at={1: args.restore_tick} if args.replicas > 1 else None,
    )

    print("  steering/reconfig decision log:")
    for d in fleet.decision_log:
        rest = {k: v for k, v in d.items() if k not in ("tick", "kind")}
        print(f"    tick {d['tick']:>4}: {d['kind']:<8} {rest}")
    print(f"  completed={rep.completed}/{rep.requests} in {rep.ticks} fleet "
          f"ticks; steer reasons: {rep.steer_reasons}; "
          f"fleet reconfigurations: {rep.reconfig_events}")
    print(f"  TTFT p50/p99 = {rep.ttft_ticks_p50:.0f}/{rep.ttft_ticks_p99:.0f}"
          f" ticks; SLO attainment: {rep.slo_attainment}")
    if rep.completed != len(freqs):
        raise SystemExit("fleet stranded requests")

    # The fleet guarantee: steering and drain never changed a single token.
    # The reference replica serves the untouched initial weights.
    single = make_replica(params, cfg, plan, args)
    for fr in sorted(freqs, key=lambda f: (f.arrival_s, f.rid)):
        single.submit(Request(rid=fr.rid, prompt=fr.prompt,
                              max_new_tokens=fr.max_new_tokens,
                              eos_id=fr.eos_id, region=fr.region))
    while single.batcher.busy:
        single.step()
    ref = {r.rid: list(r.out) for r in single.batcher.finished}
    if rep.outputs != ref:
        raise SystemExit("steering changed generated tokens")
    print("  parity: fleet tokens bit-identical to single-replica serving")

    if args.trace:
        n = trace.export(args.trace)
        failures = trace.validate_file(args.trace)
        if failures:
            raise SystemExit(f"trace schema failures: {failures[:3]}")
        print(f"  trace: {n} events -> {args.trace} (one merged timeline: "
              "fleet + every replica; open in ui.perfetto.dev)")
    if args.metrics:
        metrics.default().to_json(args.metrics)
        print(f"  metrics snapshot -> {args.metrics}")
    return {"report": rep, "decisions": fleet.decision_log}


if __name__ == "__main__":
    main()
