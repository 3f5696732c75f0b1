"""Assigned input shapes (the x-axis of the 40-cell matrix) and the
skip rules from DESIGN.md §4.

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of ``seq_len``), not ``train_step``.  ``long_500k`` requires
sub-quadratic attention: it runs for SSM / hybrid / local-attention archs
and is skipped (documented) for pure full-attention archs.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ShapeSpec", "SHAPES", "cell_supported"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# Archs allowed to run long_500k: any arch with no *global* full-attention
# block (SSM / hybrid / pure-local), plus gemma2 (alternating local/global:
# the decode step is linear-time; flagged in DESIGN.md §4).
_LONG_OK = {"mamba2-1.3b", "recurrentgemma-9b", "gemma2-2b"}


def cell_supported(cfg, shape: ShapeSpec) -> tuple[bool, str]:
    """(supported, reason-if-not) for an (arch, shape) cell."""
    if shape.name == "long_500k":
        if cfg.name in _LONG_OK or cfg.sub_quadratic:
            return True, ""
        return False, (
            "long_500k skipped: pure full-attention arch (quadratic global "
            "attention over 524k context; DESIGN.md §4)"
        )
    if cfg.family == "audio" and shape.name == "long_500k":
        return False, "enc-dec decoder context does not extend to 500k"
    return True, ""
