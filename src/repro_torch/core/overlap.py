"""Chunked comm/compute overlap engine (DESIGN.md §8), port of
:mod:`repro.core.overlap`.

:func:`software_pipeline` runs S stage functions over K chunks in the
skewed tick order ``stage s of chunk k at tick k + s``, later stages first
within a tick.  The MoE data plane's stages issue each all-to-all stage
async (``AllToAllStage(..., async_op=True)``) and the next stage waits on
it, so chunk k+1's dispatch is in flight under chunk k's expert FFN under
chunk k-1's combine; every chunk's rows are independent, so the result
equals the serial schedule's bit for bit.

The pricing side (netsim) is :func:`pipelined_phase`, the flow-level event
timeline of the same schedule on two resources (network, compute): with
``chunks=1`` it is exactly the additive serial sum, with more it reports how
much of the priced communication hid under the compute window; and
:func:`decode_tick_phase`, its serving-tick form.  :func:`ring_gather_leaf`
is the ZeRO-3 prefetch's gather: the transformer issues it for block l+1's
FFN weights before block l computes (``models.transformer.apply_layers``).
"""

from __future__ import annotations

__all__ = ["chunk_count", "software_pipeline", "pipelined_phase", "decode_tick_phase",
           "ring_gather_leaf"]


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


def pipelined_phase(
    dispatch: float,
    compute: float,
    combine: float,
    chunks: int,
    *,
    serial_prefix: float = 0.0,
) -> tuple[float, float]:
    """Event-timeline completion of one chunked dispatch->compute->combine
    phase on two resources (network, compute engine).

    ``dispatch``/``combine`` are the phase's total network seconds (e.g. the
    fabric-priced EP all-to-all pair), ``compute`` the total expert-FFN
    seconds, each split into ``chunks`` equal chunks.  ``serial_prefix`` is
    un-overlappable compute preceding the phase (the attention block).

    Precedence per chunk k: dispatch_k -> compute_k -> combine_k; the network
    serializes dispatches and combines (shared NICs), the compute engine
    serializes FFN chunks.  Tasks are issued greedily in the skewed tick
    order with combines drained before later dispatches — the same order
    :func:`software_pipeline` executes.

    Returns ``(total_seconds, exposed_comm_seconds)`` where
    ``exposed = total - serial_prefix - compute`` — the network time not
    hidden under the compute window.  Invariants (tested):
    ``chunks=1`` gives exactly the additive serial sum (all comm exposed);
    ``total`` never exceeds the serial sum and never undercuts
    ``max(compute path, network busy time)``; ``0 <= exposed <= comm``.
    """
    c = max(int(chunks), 1)
    d, e, cb = dispatch / c, compute / c, combine / c
    net_free = 0.0
    comp_free = 0.0
    d_done = [0.0] * c
    e_done = [0.0] * c
    c_done = [0.0] * c
    for t in range(c + 2):
        k = t - 2  # combine of chunk t-2 (drain first)
        if 0 <= k < c:
            start = max(net_free, e_done[k])
            c_done[k] = start + cb
            net_free = c_done[k]
        k = t - 1  # expert FFN of chunk t-1
        if 0 <= k < c:
            start = max(comp_free, d_done[k])
            e_done[k] = start + e
            comp_free = e_done[k]
        k = t  # dispatch of chunk t
        if 0 <= k < c:
            d_done[k] = net_free + d
            net_free = d_done[k]
    total = serial_prefix + c_done[c - 1]
    exposed = max(total - serial_prefix - compute, 0.0)
    return total, exposed


def decode_tick_phase(
    dispatch: float,
    expert: float,
    combine: float,
    chunks: int,
    *,
    attn: float = 0.0,
    prefill_compute: float = 0.0,
) -> tuple[float, float]:
    """Event timeline of ONE serving decode tick per MoE layer (DESIGN.md §9).

    A decode tick is the same dispatch -> expert-FFN -> combine phase the
    trainer pipelines, at live-batch scale, with two serving-specific terms:
    ``attn`` is the tick's un-overlappable decode-attention prefix (the
    router needs its output), and ``prefill_compute`` is the interleaved
    chunked-prefill work scheduled INTO this tick — compute with no ordering
    dependence on the decode a2a, so it joins the hideable window.  That is
    the scheduling argument for chunked prefill: tiny decode batches leave
    the network exposed, and the prefill chunk is what widens the compute
    window the a2a hides under.

    Returns ``(total_seconds, exposed_comm_seconds)`` with the same
    invariants as :func:`pipelined_phase` (``chunks=1`` with no prefill is
    the additive serial tick).
    """
    return pipelined_phase(
        dispatch, expert + prefill_compute, combine, chunks, serial_prefix=attn
    )


def ring_gather_leaf(x, mesh, fsdp_axis: str, fsdp_dim: int, *, async_op: bool = False):
    """Gather one ZeRO-3 weight shard over ``fsdp_axis`` along its
    ``fsdp_dim`` with the explicit ring (``commruntime`` ``_ring_gather``:
    p - 1 neighbour hops, in ascending device order), no autograd: the
    caller's :func:`repro_torch.parallel.fsdp.gather` gives it its
    backward.  Port of ``src/repro/core/overlap.py:172-211``; the shard is
    the rank's part of the leaf over every other axis already (layouts are
    explicit in the port), so only ``fsdp_dim`` is gathered.

    ``async_op``: the ring runs on the comm worker thread over the axis's
    :func:`~repro_torch.core.commruntime.side_group` (``commruntime.run_async``)
    and a handle returns, whose ``wait()`` gives the gathered leaf: the
    FSDP prefetch issues block l+1's gather before block l's compute and
    waits for it when block l+1 starts."""
    from repro_torch.core import commruntime as cr

    def ring(t, group):
        full = cr._ring_gather(t.detach().movedim(fsdp_dim, 0).contiguous(), group)
        return full.movedim(0, fsdp_dim).contiguous()

    if async_op:
        grp = cr.side_group(mesh, fsdp_axis)
        return cr.run_async(lambda t: ring(t, grp), x)
    import torch

    with torch.no_grad():
        return ring(x, cr.axis_group(mesh, fsdp_axis))

