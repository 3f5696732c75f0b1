"""Metrics registry: named counters / gauges / histograms with labeled
series and a JSON snapshot (DESIGN.md §14).

The structured replacement for ad-hoc dict telemetry: every layer registers
its series against ONE process-wide registry (``default()``), so a run's
quantitative story — serve ticks, tokens, allocator churn, comm bytes by
link class, control-plane verdicts, netsim hidden/exposed seconds — is a
single ``snapshot()`` away, keyed by a stable ``name{label=value}`` schema.

Emission is deliberately cheap: a labeled child is resolved once and cached
(``registry.counter("comm.link_bytes", op="a2a")``), after which ``inc`` is
one float add under the GIL — safe to call from serve/train tick loops and
netsim inner loops.  Nothing here imports jax or numpy.
"""

from __future__ import annotations

import json
import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default",
    "counter",
    "gauge",
    "histogram",
    "snapshot",
    "reset",
]


def _series_key(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


# Counters are bumped from the comm worker thread too (the FSDP prefetch's
# transfers, ``core.commruntime.run_async``): ``+=`` is a read-modify-write.
_INC_LOCK = threading.Lock()


class Counter:
    """Monotonically increasing value (events, bytes, tokens)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        with _INC_LOCK:
            self.value += v

    def to_json(self) -> dict:
        return {"labels": self.labels, "value": self.value}


class Gauge:
    """Last-written value (resident pages, loss, EMA step time)."""

    __slots__ = ("name", "labels", "value")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def to_json(self) -> dict:
        return {"labels": self.labels, "value": self.value}


class Histogram:
    """Power-of-two bucketed distribution (latencies, span lengths).

    Buckets are upper bounds ``2^k`` for ``k`` in [min_exp, max_exp]; one
    overflow bucket catches the rest.  Tracks count/sum/min/max exactly.
    """

    __slots__ = ("name", "labels", "count", "sum", "min", "max", "buckets",
                 "_bounds")

    def __init__(self, name: str, labels: dict, *, min_exp: int = -20,
                 max_exp: int = 30):
        self.name = name
        self.labels = labels
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self._bounds = [2.0 ** k for k in range(min_exp, max_exp + 1)]
        self.buckets = [0] * (len(self._bounds) + 1)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        lo, hi = 0, len(self._bounds)
        while lo < hi:  # first bound >= v (bisect, but dependency-free)
            mid = (lo + hi) // 2
            if self._bounds[mid] >= v:
                hi = mid
            else:
                lo = mid + 1
        self.buckets[lo] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def to_json(self) -> dict:
        nonzero = {
            (f"le_{self._bounds[i]:g}" if i < len(self._bounds) else "overflow"): n
            for i, n in enumerate(self.buckets)
            if n
        }
        return {
            "labels": self.labels,
            "count": self.count,
            "sum": self.sum,
            "mean": self.mean,
            "min": self.min,
            "max": self.max,
            "buckets": nonzero,
        }


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._series: dict[str, object] = {}
        # Bumped by reset(): long-lived caches of child handles (e.g.
        # commruntime's link-bytes cache) key on this to drop orphans.
        self.generation = 0

    def _get(self, cls, name: str, labels: dict):
        key = _series_key(name, labels)
        s = self._series.get(key)
        if s is None:
            with self._lock:
                s = self._series.get(key)
                if s is None:
                    s = cls(name, labels)
                    self._series[key] = s
        if not isinstance(s, cls):
            raise TypeError(
                f"metric {key!r} already registered as {type(s).__name__}"
            )
        return s

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def snapshot(self) -> dict:
        """JSON-able view: ``{"counters": {key: {...}}, "gauges": ...}``."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        kind = {Counter: "counters", Gauge: "gauges", Histogram: "histograms"}
        with self._lock:
            items = list(self._series.items())
        for key, s in sorted(items):
            out[kind[type(s)]][key] = s.to_json()
        return out

    def value(self, name: str, **labels) -> float:
        """Current value of a counter/gauge series (0.0 if never written)."""
        key = _series_key(name, labels)
        s = self._series.get(key)
        return getattr(s, "value", 0.0) if s is not None else 0.0

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)

    def reset(self) -> None:
        with self._lock:
            self._series = {}
            self.generation += 1


_DEFAULT = MetricsRegistry()


def default() -> MetricsRegistry:
    return _DEFAULT


def counter(name: str, **labels) -> Counter:
    return _DEFAULT.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return _DEFAULT.gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return _DEFAULT.histogram(name, **labels)


def snapshot() -> dict:
    return _DEFAULT.snapshot()


def reset() -> None:
    _DEFAULT.reset()
