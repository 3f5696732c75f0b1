"""repro.obs — the measurement plane (DESIGN.md §14).

One schema from kernel-adjacent tick loops up to fleet steering: the paper's
entire design is justified by a *measurement study* (§3's per-iteration
expert traffic matrices), so the repo must be able to produce that study
about its own runs.  Three zero-dependency pieces:

* :mod:`repro.obs.trace` — spans + counters + typed audit events in Chrome
  ``trace_event`` JSON (a whole serve/train/fleet run opens in
  ``chrome://tracing`` / Perfetto).  Disabled is a no-op.
* :mod:`repro.obs.metrics` — a registry of named counters / gauges /
  histograms with labeled series and a JSON snapshot, replacing ad-hoc
  dict telemetry.
* :mod:`repro.obs.traffic` — the §3 observatory: per-layer expert→device
  traffic matrices accumulated from live gate loads, with the locality /
  regional-concentration statistics the paper measures.

This package must stay importable without jax (netsim and the pure-python
consumers are jax-free), and the instrumented hot paths only ever pay one
attribute check when tracing is disabled.
"""

from repro_torch.obs import metrics, trace, traffic

__all__ = ["trace", "metrics", "traffic"]
