"""Chunked comm/compute overlap: the execution side of
:mod:`repro.core.overlap`.

:func:`software_pipeline` runs S stage functions over K chunks in the
skewed tick order ``stage s of chunk k at tick k + s``, later stages first
within a tick.  The MoE data plane's stages issue each all-to-all stage
async (``AllToAllStage(..., async_op=True)``) and the next stage waits on
it, so chunk k+1's dispatch is in flight under chunk k's expert FFN under
chunk k-1's combine; every chunk's rows are independent, so the result
equals the serial schedule's bit for bit.

The priced side (``pipelined_phase``, ``decode_tick_phase``) comes with the
evaluation slice, and the ZeRO-3 prefetch ``ring_gather_leaf`` with
parameter sharding.
"""

from __future__ import annotations

__all__ = ["chunk_count", "software_pipeline"]


def chunk_count(total: int, requested: int) -> int:
    """Largest divisor of ``total`` that is <= ``requested`` (equal chunk
    shapes; a request that does not divide degrades to the nearest
    divisor)."""
    c = max(min(int(requested), int(total)), 1)
    while total % c:
        c -= 1
    return c


def software_pipeline(num_chunks: int, stages):
    """Run ``stages`` (``fn(prev_result, chunk_index)`` each) over
    ``num_chunks`` chunks in software-pipeline order: stage ``s`` of chunk
    ``k`` at tick ``k + s``, later stages first within a tick.  Stage 0
    gets ``prev=None``.  Returns the last stage's results, one per chunk."""
    s_count = len(stages)
    if s_count == 0:
        return [None] * num_chunks
    results = [[None] * num_chunks for _ in range(s_count)]
    for t in range(num_chunks + s_count - 1):
        for s in reversed(range(s_count)):
            k = t - s
            if 0 <= k < num_chunks:
                prev = results[s - 1][k] if s > 0 else None
                results[s][k] = stages[s](prev, k)
    return results[-1]
