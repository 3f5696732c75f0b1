"""Cached measured autotuner over the runtime's communication knobs
(DESIGN.md §13), port of :mod:`repro.core.autotune`.  The cache file is the
reference's JSON, key for key, so a cache either package writes is read by
the other.

The repo grew four orthogonal comm knobs that were, until now, constants
picked per call site: ``overlap_chunks`` (the §8 chunked schedule depth),
the MoE dispatch mode (dropless vs capacity), the priced a2a lowering
(hier / flat / ring, :class:`repro_torch.core.commruntime.AllToAll`), and
``dp_compress`` (int8 gradient wire).  None of them has a shape-independent
winner: chunking pays a latency tax per chunk, capacity dispatch trades
delivered tokens for wire/FFN time, the flat a2a amortizes nothing but
costs nothing to set up, and compressed gradients only matter when the DP
reduction is exposed.

:func:`tune` searches the full grid with the *measured* objective — the
flow-level netsim prices each candidate on the actual fabric with the same
gate trace, and the score is **delivered-token goodput**
(``kept_fraction * tokens / iteration_time``), so capacity dispatch is a
real tradeoff, not a free discount.  Results are cached on disk keyed by
(model shape, parallelism layout, fabric, link rate); both consumers read
the same cache:

* netsim / benchmarks: :func:`apply` stamps the winning knobs onto a
  :class:`~repro_torch.core.netsim.SimModel`;
* the trainer: :func:`apply_to_trainer` maps them onto the execution-side
  config (``MoEConfig.overlap_chunks`` / ``MoEConfig.dispatch``,
  ``TrainerConfig.dp_compress`` where the mesh allows it) — see
  ``repro_torch.train.trainer.TrainerConfig.autotune_cache``.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os

import numpy as np

__all__ = [
    "SEARCH_SPACE",
    "TuneResult",
    "cache_key",
    "tune",
    "apply",
    "apply_to_trainer",
    "load_cached",
]

# The searched grid.  ``pp_overlap`` is not a knob: bubble-filling never
# hurts in the flow model, so the tuner measures every candidate with it on
# and the default baseline with it off (the pre-§13 accounting).
SEARCH_SPACE = {
    "overlap_chunks": (1, 2, 4, 8),
    "moe_dispatch": ("dropless", "capacity"),
    "a2a_lowering": ("hier", "flat", "ring"),
    "dp_compress": (False, True),
}


@dataclasses.dataclass(frozen=True)
class TuneResult:
    key: str
    knobs: dict
    goodput_tok_s: float
    default_goodput_tok_s: float

    @property
    def speedup(self) -> float:
        return self.goodput_tok_s / max(self.default_goodput_tok_s, 1e-12)

    def to_json(self) -> dict:
        return {
            "key": self.key,
            "knobs": self.knobs,
            "goodput_tok_s": self.goodput_tok_s,
            "default_goodput_tok_s": self.default_goodput_tok_s,
        }

    @classmethod
    def from_json(cls, d: dict) -> "TuneResult":
        return cls(
            key=d["key"],
            knobs=dict(d["knobs"]),
            goodput_tok_s=float(d["goodput_tok_s"]),
            default_goodput_tok_s=float(d["default_goodput_tok_s"]),
        )


def cache_key(model, fabric_name: str, link_gbps: int) -> str:
    """Stable identity of one tuning problem: model shape x layout x fabric."""
    return (
        f"{model.name}|ep{model.ep_degree}tp{model.tp_degree}"
        f"pp{model.pp_degree}mb{model.num_microbatches}"
        f"|{fabric_name}|{link_gbps}G"
    )


def _load_cache(path: str) -> dict:
    if path and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


def load_cached(path: str, key: str) -> TuneResult | None:
    """Cache lookup without measuring; None on miss."""
    entry = _load_cache(path).get(key)
    return TuneResult.from_json(entry) if entry else None


def _goodput(model, fabric_name, link_gbps, num_servers, iterations, seed):
    """Delivered tokens/s of ``model`` on a fresh fabric (same seed -> same
    gate trace across candidates, so the comparison is paired)."""
    from repro_torch.core.fabric import FabricConfig, make_fabric
    from repro_torch.core.netsim import simulate_training

    fab = make_fabric(
        fabric_name, FabricConfig(num_servers=num_servers, link_gbps=link_gbps)
    )
    res = simulate_training(
        model, fab, iterations=iterations, seed=seed,
        use_copilot=(fabric_name == "mixnet"),
    )
    res = res[1:] if len(res) > 1 else res
    t = float(np.mean([r.total for r in res]))
    kept = float(np.mean([r.kept_fraction for r in res]))
    tokens = model.num_microbatches * model.tokens_per_microbatch
    return kept * tokens / max(t, 1e-12)


def tune(
    model,
    fabric_name: str = "mixnet",
    link_gbps: int = 400,
    *,
    num_servers: int | None = None,
    cache_path: str | None = None,
    iterations: int = 2,
    seed: int = 0,
    refresh: bool = False,
    space: dict | None = None,
) -> TuneResult:
    """Measured grid search; returns (and caches) the best knob setting.

    ``model`` enters with its *default* knobs — that configuration, priced
    with ``pp_overlap`` off, is the baseline every candidate must beat.
    The winner is the measured-goodput argmax with ``pp_overlap`` on.
    """
    key = cache_key(model, fabric_name, link_gbps)
    if cache_path and not refresh:
        hit = load_cached(cache_path, key)
        if hit is not None:
            return hit
    if num_servers is None:
        num_servers = max(
            (model.gpus_per_stage * model.pp_degree) // 8, 2
        )
    space = dict(SEARCH_SPACE if space is None else space)
    default_score = _goodput(
        model, fabric_name, link_gbps, num_servers, iterations, seed
    )
    best_knobs, best_score = None, -1.0
    names = sorted(space)
    for values in itertools.product(*(space[n] for n in names)):
        knobs = dict(zip(names, values))
        cand = dataclasses.replace(model, pp_overlap=True, **knobs)
        score = _goodput(
            cand, fabric_name, link_gbps, num_servers, iterations, seed
        )
        if score > best_score:
            best_knobs, best_score = dict(knobs, pp_overlap=True), score
    result = TuneResult(
        key=key,
        knobs=best_knobs,
        goodput_tok_s=best_score,
        default_goodput_tok_s=default_score,
    )
    if cache_path:
        cache = _load_cache(cache_path)
        cache[key] = result.to_json()
        os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
        with open(cache_path, "w") as f:
            json.dump(cache, f, indent=2, sort_keys=True)
    return result


def apply(model, result: TuneResult):
    """Stamp a tuning result onto a netsim :class:`SimModel`."""
    return dataclasses.replace(model, **result.knobs)


def apply_to_trainer(cfg, tcfg, result: TuneResult):
    """Map a tuning result onto the execution-side configs.

    * ``overlap_chunks`` / dispatch mode -> ``cfg.moe`` (chunk_count degrades
      non-divisors gracefully at run time);
    * ``dp_compress`` -> ``tcfg`` ONLY when the trainer runs the runtime DP
      reduction (``dp_comm='runtime'`` and no PP) — elsewhere the knob has
      no execution path and is dropped rather than raising.

    The a2a lowering and ``pp_overlap`` are pricing-side knobs with no
    separate execution lowering (the data plane always runs the delegation
    a2a), so they do not map.  Returns ``(cfg, tcfg)`` replaced copies.
    """
    k = result.knobs
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe,
            overlap_chunks=int(k.get("overlap_chunks", cfg.moe.overlap_chunks)),
            dispatch=k.get("moe_dispatch", cfg.moe.dispatch),
        )
        cfg = dataclasses.replace(cfg, moe=moe)
    want_compress = bool(k.get("dp_compress", False))
    if want_compress and tcfg.dp_comm == "runtime" and tcfg.pp_stages <= 1:
        tcfg = dataclasses.replace(tcfg, dp_compress=True)
    return cfg, tcfg
