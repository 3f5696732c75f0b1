"""Offline measurement report from an exported trace file (DESIGN.md §14).

Port of ``scripts/measure_run.py``.  Reads a Chrome/Perfetto trace written
by ``repro_torch.obs.trace.export`` (e.g. ``python -m repro_torch.fleet
--trace build/fleet_trace.json``), schema-checks it, and
reproduces the paper's §3 measurement study from the ``traffic.report``
audit events the engines embed: per-layer expert-traffic locality, hottest-
device concentration, effective expert count, and regional skew.  Also
summarizes the structured decision/reconfiguration audit stream and the
counter series, so one trace file answers "what did this run do and why".

    PYTHONPATH=src python -m repro_torch.measure_run TRACE.json [--json OUT.json]
"""

from __future__ import annotations


import argparse
import json
from collections import Counter, defaultdict

from repro_torch.obs import trace
from repro_torch.obs.traffic import TrafficObservatory


def load_events(path: str) -> list[dict]:
    with open(path) as f:
        doc = json.load(f)
    return doc.get("traceEvents", doc) if isinstance(doc, dict) else doc


def span_summary(events: list[dict]) -> dict[str, dict]:
    """name -> {count, total_ms, mean_ms} over complete (ph="X") spans."""
    agg: dict[str, list[float]] = defaultdict(list)
    for ev in events:
        if ev.get("ph") == "X":
            agg[ev["name"]].append(float(ev.get("dur", 0.0)) / 1e3)
    return {
        name: {
            "count": len(durs),
            "total_ms": sum(durs),
            "mean_ms": sum(durs) / len(durs),
        }
        for name, durs in sorted(agg.items())
    }


def counter_totals(events: list[dict]) -> dict[str, float]:
    """Last sample per counter series (samples are cumulative per emitter)."""
    last: dict[str, float] = {}
    for ev in events:
        if ev.get("ph") == "C":
            for series, v in ev.get("args", {}).items():
                key = (
                    ev["name"] if series == "value" else f"{ev['name']}.{series}"
                )
                last[key] = float(v)
    return last


def decision_summary(events: list[dict]) -> Counter:
    kinds: Counter = Counter()
    for ev in events:
        if ev.get("cat") in ("decision", "reconfig_audit") and ev.get("ph") in (
            "i", "I",
        ):
            kinds[ev["name"]] += 1
    return kinds


def traffic_reports(events: list[dict]) -> dict[str, TrafficObservatory]:
    """scope -> rebuilt observatory (last report per scope wins: reports are
    cumulative snapshots of the run so far)."""
    out: dict[str, TrafficObservatory] = {}
    for ev in events:
        if ev.get("name") == "traffic.report" and ev.get("cat") == "traffic":
            args = ev.get("args", {})
            if "report" in args:
                out[args.get("scope", "run")] = TrafficObservatory.from_report(
                    args["report"]
                )
    return out


def print_observatory(scope: str, obs: TrafficObservatory) -> None:
    loc = obs.locality_per_layer()
    conc = obs.device_concentration()
    eff = obs.effective_experts()
    print(f"\n  §3 traffic study [{scope}] — {obs.ticks} ticks, "
          f"{obs.num_layers} layers x {obs.num_experts} experts on "
          f"{obs.num_devices} devices:")
    print(f"    locality score (normalized HHI, 0=uniform 1=one expert): "
          f"{obs.locality_score():.3f}")
    print("    layer  locality  hottest-device-share  effective-experts")
    for l in range(obs.num_layers):
        print(f"    {l:>5}  {loc[l]:>8.3f}  {conc[l]:>20.3f}  {eff[l]:>17.2f}")
    if obs.num_regions:
        print(f"    regional skew (Bhattacharyya miss vs global mix): "
              f"{obs.regional_skew():.3f} over {obs.num_regions} regions")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", help="trace JSON exported by repro_torch.obs.trace")
    ap.add_argument("--json", default="", help="also dump the report as JSON")
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero on schema failures")
    args = ap.parse_args(argv)

    events = load_events(args.trace)
    failures = trace.validate_events(events)
    n_spans = sum(1 for e in events if e.get("ph") == "X")
    print(f"{args.trace}: {len(events)} events ({n_spans} spans), "
          f"schema {'OK' if not failures else 'FAILED'}")
    for f in failures[:10]:
        print(f"  schema: {f}")
    if failures and args.strict:
        raise SystemExit(1)

    spans = span_summary(events)
    if spans:
        print("\n  span time by name:")
        for name, s in spans.items():
            print(f"    {name:<24} x{s['count']:<5} total {s['total_ms']:>9.1f} ms"
                  f"  mean {s['mean_ms']:>8.2f} ms")

    decisions = decision_summary(events)
    if decisions:
        print("\n  decision / reconfiguration audit events:")
        for name, n in decisions.most_common():
            print(f"    {name:<24} x{n}")

    counters = counter_totals(events)
    if counters:
        print("\n  counter series (last sample):")
        for name, v in sorted(counters.items()):
            print(f"    {name:<24} {v:,.0f}")

    observatories = traffic_reports(events)
    for scope, obs in sorted(observatories.items()):
        print_observatory(scope, obs)
    if not observatories:
        print("\n  no traffic.report events (run a MoE serve/fleet example "
              "with --trace to capture the §3 study)")

    doc = {
        "events": len(events),
        "schema_failures": failures,
        "spans": spans,
        "decisions": dict(decisions),
        "counters": counters,
        "traffic": {s: o.report() for s, o in observatories.items()},
    }
    if args.json:
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=2)
        print(f"\n  wrote {args.json}")
    return doc


if __name__ == "__main__":
    main()
