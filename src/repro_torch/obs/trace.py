"""Zero-dependency tracer: spans, counters, and typed audit events in the
Chrome ``trace_event`` format (DESIGN.md §14).

One process-wide :class:`Tracer` (``default()``) is shared by every layer —
Trainer steps, ServeEngine ticks, FleetEngine steering, ControlPlane plan
verdicts, netsim scenario runs — so a whole run exports as ONE merged
timeline that opens directly in ``chrome://tracing`` or
https://ui.perfetto.dev.  Components that share a host thread (fleet
replicas, netsim scenarios) get their own *track* (a synthetic ``tid`` with
a ``thread_name`` metadata record) via :meth:`Tracer.track`.

Design constraints, asserted by ``tests/test_obs.py``:

* **Disabled is a no-op.**  The tracer ships disabled; every emit path
  starts with one attribute check and returns a shared null object, so the
  instrumented hot loops (serve ticks, train steps, netsim inner loops) pay
  near-zero overhead by default.  The benchmark gate
  (``benchmarks/run.py::observability``) bounds the *enabled* serve-tick
  overhead too (< 3%).
* **Thread-safe, ring-buffered.**  Events land in a bounded deque (oldest
  events drop first); concurrent emitters never block each other beyond a
  short append lock.
* **Schema.**  Every exported event carries ``name``/``ph``/``ts``/``pid``/
  ``tid``; spans are complete (``ph="X"``) events whose intervals nest,
  counters are ``ph="C"``, typed audit events are instants (``ph="i"``)
  whose payload rides ``args``.  :func:`validate_events` is the shared
  schema check used by tests, CI and ``scripts/measure_run.py``.
"""

from __future__ import annotations

import json
import os
import threading
import time

__all__ = [
    "Tracer",
    "default",
    "enable",
    "disable",
    "export",
    "validate_events",
    "validate_file",
]


class _NullSpan:
    """Shared no-op context manager — the disabled tracer's span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """A live span: records a complete (``ph="X"``) event on exit."""

    __slots__ = ("_tracer", "name", "cat", "tid", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, tid: int, args: dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.tid = tid
        self.args = args

    def set(self, **args):
        """Attach result fields discovered while the span runs."""
        self.args.update(args)
        return self

    def __enter__(self):
        self._t0 = self._tracer._now_us()
        return self

    def __exit__(self, *exc):
        # Hot path: one timestamp, one dict, one locked append — kept flat
        # (no helper calls) because the serve/train tick overhead gate in
        # benchmarks/run.py::observability charges every interpreter cycle
        # spent here against the < 3% budget.
        tr = self._tracer
        t1 = (tr._clock() - tr._epoch) * 1e6
        ev = {
            "name": self.name,
            "cat": self.cat,
            "ph": "X",
            "ts": self._t0,
            "dur": t1 - self._t0,
            "pid": tr.pid,
            "tid": self.tid,
            "args": self.args,
        }
        lock = tr._lock
        lock.acquire()
        events = tr._events
        if len(events) >= tr.capacity:
            keep = tr.capacity // 2
            tr._dropped += len(events) - keep
            tr._events = events = events[-keep:]
        events.append(ev)
        lock.release()
        return False


class Tracer:
    def __init__(self, capacity: int = 262_144, clock=time.perf_counter):
        self.enabled = False
        self.pid = os.getpid()
        self.capacity = int(capacity)
        self._clock = clock
        self._epoch = clock()
        self._lock = threading.Lock()
        self._events: list[dict] = []
        self._dropped = 0
        # Synthetic tracks for components sharing a host thread; real thread
        # ids collide with nothing in this range (ids start at 1).
        self._tracks: dict[str, int] = {}
        self._next_track = 1

    # -- time / track bookkeeping -------------------------------------------
    def _now_us(self) -> float:
        return (self._clock() - self._epoch) * 1e6

    def _default_tid(self) -> int:
        return threading.get_ident() & 0x7FFFFFFF

    def track(self, name: str) -> int:
        """Register (or look up) a named track; returns its ``tid``.

        Pass the returned id as ``tid=`` to span/instant/counter so one
        component's events form their own row in the viewer even when many
        components tick on the same host thread (fleet replicas)."""
        with self._lock:
            tid = self._tracks.get(name)
            if tid is None:
                tid = self._next_track
                self._next_track += 1
                self._tracks[name] = tid
            return tid

    def _append(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) >= self.capacity:
                # Ring semantics: drop the oldest half in one O(n) slice
                # instead of an O(n) pop per event.
                keep = self.capacity // 2
                self._dropped += len(self._events) - keep
                self._events = self._events[-keep:]
            self._events.append(ev)

    # -- emitters ------------------------------------------------------------
    def span(self, name: str, *, cat: str = "span", tid: int | None = None, **args):
        """Context manager timing a region: ``with tracer.span("serve.tick")``.

        Returns the shared null span when disabled — the no-op fast path."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, self._default_tid() if tid is None else tid, args)

    def instant(self, name: str, *, cat: str = "event", tid: int | None = None, **args):
        """A point-in-time typed event (``ph="i"``); payload rides ``args``."""
        if not self.enabled:
            return
        self._append({
            "name": name,
            "cat": cat,
            "ph": "i",
            "s": "t",
            "ts": self._now_us(),
            "pid": self.pid,
            "tid": self._default_tid() if tid is None else tid,
            "args": args,
        })

    def counter(self, name: str, values, *, tid: int | None = None):
        """A counter sample (``ph="C"``): ``values`` is a float or a dict of
        named series (Perfetto stacks the series of one counter name)."""
        if not self.enabled:
            return
        # Flat hot path (see _Span.__exit__): per-tick counters ride the
        # same < 3% overhead budget as spans.
        if isinstance(values, dict):
            args = {k: float(v) for k, v in values.items()}
        else:
            args = {"value": float(values)}
        ev = {
            "name": name,
            "cat": "counter",
            "ph": "C",
            "ts": (self._clock() - self._epoch) * 1e6,
            "pid": self.pid,
            "tid": self._default_tid() if tid is None else tid,
            "args": args,
        }
        lock = self._lock
        lock.acquire()
        events = self._events
        if len(events) >= self.capacity:
            keep = self.capacity // 2
            self._dropped += len(events) - keep
            self._events = events = events[-keep:]
        events.append(ev)
        lock.release()

    def audit(self, name: str, payload: dict, *, cat: str = "audit", tid: int | None = None):
        """A structured audit record (reconfiguration verdicts, steering
        decisions) — an instant whose args ARE the typed event's fields."""
        if not self.enabled:
            return
        self.instant(name, cat=cat, tid=tid, **payload)

    # -- snapshot / export ---------------------------------------------------
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events = []
            self._dropped = 0

    def _metadata_events(self) -> list[dict]:
        meta = [{
            "name": "process_name", "ph": "M", "ts": 0.0,
            "pid": self.pid, "tid": 0, "args": {"name": "repro"},
        }]
        with self._lock:
            tracks = dict(self._tracks)
        for name, tid in sorted(tracks.items(), key=lambda kv: kv[1]):
            meta.append({
                "name": "thread_name", "ph": "M", "ts": 0.0,
                "pid": self.pid, "tid": tid, "args": {"name": name},
            })
        return meta

    def export(self, path: str) -> int:
        """Write the Chrome/Perfetto JSON; returns the number of events."""
        events = self._metadata_events() + self.events()
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        d = os.path.dirname(os.path.abspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(events)


# -- process-wide default tracer (the merged-timeline contract) --------------
_DEFAULT = Tracer()


def default() -> Tracer:
    return _DEFAULT


def enable() -> Tracer:
    _DEFAULT.enabled = True
    return _DEFAULT


def disable() -> Tracer:
    _DEFAULT.enabled = False
    return _DEFAULT


def export(path: str) -> int:
    return _DEFAULT.export(path)


# -- the shared schema check -------------------------------------------------
_REQUIRED = ("name", "ph", "ts", "pid", "tid")


def validate_events(events: list) -> list[str]:
    """Validate trace events against the §14 schema; returns human-readable
    failures (empty = valid).  Checks: every event carries
    ``name``/``ph``/``ts``/``pid``/``tid``; complete spans carry a
    non-negative ``dur`` and, per track, nest properly (two spans either
    disjoint or one containing the other); counter samples carry numeric
    series; the whole list JSON round-trips."""
    failures: list[str] = []
    if not isinstance(events, list):
        return ["trace is not a list of events"]
    spans_by_track: dict[tuple, list[tuple[float, float, str]]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            failures.append(f"event[{i}] is not an object")
            continue
        missing = [k for k in _REQUIRED if k not in ev]
        if missing:
            failures.append(f"event[{i}] ({ev.get('name')!r}) missing {missing}")
            continue
        if not isinstance(ev["ts"], (int, float)):
            failures.append(f"event[{i}] ({ev['name']!r}) non-numeric ts")
        ph = ev["ph"]
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                failures.append(f"event[{i}] ({ev['name']!r}) span without dur")
            else:
                spans_by_track.setdefault((ev["pid"], ev["tid"]), []).append(
                    (float(ev["ts"]), float(ev["ts"]) + float(dur), ev["name"])
                )
        elif ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args or not all(
                isinstance(v, (int, float)) for v in args.values()
            ):
                failures.append(
                    f"event[{i}] ({ev['name']!r}) counter without numeric series"
                )
        elif ph not in ("i", "I", "M", "B", "E"):
            failures.append(f"event[{i}] ({ev['name']!r}) unknown phase {ph!r}")
    for track, spans in spans_by_track.items():
        # Parent-before-child order: ascending start, DESCENDING end, so a
        # span starting with its parent sorts after it.
        spans.sort(key=lambda t: (t[0], -t[1]))
        stack: list[tuple[float, float, str]] = []
        for s0, s1, name in spans:
            while stack and stack[-1][1] <= s0:
                stack.pop()
            if stack and s1 > stack[-1][1]:
                failures.append(
                    f"track {track}: span {name!r} [{s0:.1f}, {s1:.1f}] "
                    f"partially overlaps {stack[-1][2]!r} "
                    f"[{stack[-1][0]:.1f}, {stack[-1][1]:.1f}]"
                )
                continue
            stack.append((s0, s1, name))
    try:
        json.loads(json.dumps(events))
    except (TypeError, ValueError) as e:  # pragma: no cover - defensive
        failures.append(f"trace does not JSON round-trip: {e}")
    return failures


def validate_file(path: str) -> list[str]:
    """Schema-check an exported trace file (the CI step's entry point)."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [f"cannot load {path}: {e}"]
    events = doc.get("traceEvents") if isinstance(doc, dict) else doc
    if events is None:
        return [f"{path}: no traceEvents array"]
    return validate_events(events)
