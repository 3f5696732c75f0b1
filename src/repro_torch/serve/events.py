"""Typed serving decision events (DESIGN.md §14).

`ServeEngine` and `FleetEngine` used to journal lifecycle decisions as raw
dicts in ``decision_log``.  These dataclasses are the typed replacement:
each decision is one event object that (a) renders back to the exact legacy
dict via :meth:`as_dict` — the ``decision_log`` property view keeps every
existing consumer byte-identical — and (b) doubles as the payload of a
structured trace audit event (``tracer.audit("serve.decision", ...)``), so
a run's decision trail rides the exported Perfetto timeline.

Field order matters: ``as_dict`` iterates dataclass fields, and the legacy
dict literals put ``tick`` then ``kind`` first — consumers like
``examples/serve.py`` print ``{k: v for k, v in d.items() if ...}`` and
rely on that insertion order.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

__all__ = [
    "DecisionEvent",
    "DrainDecision",
    "RestoreDecision",
    "ReconfigDecision",
    "FleetDrainDecision",
    "FleetRestoreDecision",
    "FleetFailDecision",
    "SteerDecision",
    "FleetReconfigDecision",
]


@dataclass(kw_only=True)
class DecisionEvent:
    tick: int
    kind: str = "?"

    def as_dict(self) -> dict:
        """The legacy ``decision_log`` dict — same keys, same order."""
        return {f.name: getattr(self, f.name) for f in fields(self)}


# -- single-engine lifecycle (ServeEngine) ------------------------------------
@dataclass(kw_only=True)
class DrainDecision(DecisionEvent):
    kind: str = "drain"
    handed_back: int = 0


@dataclass(kw_only=True)
class RestoreDecision(DecisionEvent):
    kind: str = "restore"


@dataclass(kw_only=True)
class ReconfigDecision(DecisionEvent):
    kind: str = "reconfig"
    applied: bool = False
    layers: list[int] = None
    gain_bytes: float = 0.0
    reasons: list[str] = None


# -- fleet lifecycle (FleetEngine) --------------------------------------------
@dataclass(kw_only=True)
class FleetDrainDecision(DecisionEvent):
    kind: str = "drain"
    replica: int = 0
    resteered: int = 0


@dataclass(kw_only=True)
class FleetRestoreDecision(DecisionEvent):
    kind: str = "restore"
    replica: int = 0


@dataclass(kw_only=True)
class FleetFailDecision(DecisionEvent):
    kind: str = "fail"
    replica: int = 0
    resteered: int = 0


@dataclass(kw_only=True)
class SteerDecision(DecisionEvent):
    kind: str = "steer"
    rid: int = 0
    region: int | None = None
    slo: str = ""
    replica: int = 0
    reason: str = ""


@dataclass(kw_only=True)
class FleetReconfigDecision(DecisionEvent):
    kind: str = "reconfig"
    replica: int = 0
    layers: list[int] = None
    gain_bytes: float = 0.0
