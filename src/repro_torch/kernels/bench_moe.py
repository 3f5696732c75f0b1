#!/usr/bin/env python3
"""Time the port's MoE dispatch and combine kernels (kernel 4, the row
gather; kernel 5, the weighted combine, and the combine's backward) on one
CUDA card at every shape that Mixtral-8x7B's dropless training step gives
them (P = 1, T = 512 tokens, top-2, D = 4096, bf16, as ``_moe_mixnet_local``
builds its plans):

* ``send``: the send gather, x [512, 4096] -> [1024, 4096] (many-to-one);
* ``pack``: [1024, 4096] -> [1080, 4096] by the dropless plan's ``src``,
  with zero padding rows;
* ``unpack``: [1080, 4096] -> [1024, 4096] by its ``slot``;
* ``combine_f32``: y [1024, 4096] by slot / w [512, 2] -> [512, 4096] f32;
* ``combine_bf16``: the send gather's backward, unit weights, bf16 out;
* ``combine_bwd``: dout [512, 4096] f32 -> dy [1024, 4096] bf16, dw [512, 2].

    python3 src/repro_torch/kernels/bench_moe.py [--src DIR] [--tag NAME] [--variant NAME]

Run it as a file, not as a module: ``--src`` is the ``src`` directory whose
``repro_torch`` is timed (default: this checkout's), so one call can time
two trees in turns (parent, change, change, parent).  ``--variant`` times a
design variant of ``csrc/moe_dispatch.cu`` (text substitutions applied to a
copy, built with the flags of ``kernels/build.py``).  Before it is timed,
each result is checked: the gathers equal the plain gather, the combine is
bit-identical to an in-order loop (``acc = acc + w[:, s] * y[slot[:, s]]``,
each op rounded once), dy bit-identical to ``(w * dout).to(bf16)``, dw
within 1e-4 of the plain version.  Prints one line per call: CUDA-event
milliseconds (mean of 200 back-to-back calls after 3 warm-ups; for calls
this small, the host's issue rate), the device time under torch.profiler
with the inputs warm in L2 (back-to-back calls) and cold (a 128 MiB fill
before each call, not counted), the host microseconds per call (1,000 calls, no synchronise inside), the
same for the library call where one PyTorch call computes the function
(``index_select``, ``F.embedding_bag``), and the bound (bytes over
3.35 TB/s); then a contiguous copy of the same bytes as the card's copy
ceiling at this size, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[3]
# Run as a file, this directory comes first on the path: its module names
# (build, ops, ref, ...) must not shadow anything.
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == pathlib.Path(__file__).resolve().parent:
    sys.path.pop(0)
_spec = importlib.util.spec_from_file_location(
    "_repro_kernel_timing", pathlib.Path(__file__).with_name("timing.py"))
timing = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(timing)

T, E, K, D = 512, 8, 2, 4096
BLOCK = 8  # the dropless plan's tile height (MoEConfig.dispatch_block)
ITERS, HOST_ITERS = 200, 1000

# Design variants: (file, text in it, replacement).
VARIANTS = {
    # The vector gather with 8 loads a thread in flight.
    "gather_unroll_8": [(
        "moe_dispatch.cu", "constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;",
    )],
    # The vector gather with 2 loads a thread in flight (twice the CTAs).
    "gather_unroll_2": [(
        "moe_dispatch.cu", "constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;",
    )],
    # The vector gather in 512-thread CTAs (half as many).
    "gather_threads_512": [(
        "moe_dispatch.cu", "constexpr int kVecThreads = 256;", "constexpr int kVecThreads = 512;",
    )],
    # The vector gather's grid capped at 2 CTAs an SM, each looping over
    # tiles as the earlier one-warp-a-row kernel's 128 CTAs looped over rows.
    "gather_2_ctas": [(
        "moe_dispatch.cu", "constexpr int kVecCtasPerSm = 8;", "constexpr int kVecCtasPerSm = 2;",
    )],
    # The vector gather storing with evict-first (streaming) stores.
    "gather_streaming_stores": [(
        "moe_dispatch.cu", "if (i < total) out[i] = v[u];", "if (i < total) __stcs(&out[i], v[u]);",
    )],
    # The combine issuing 4 terms' loads at a time (2 at Mixtral's top-2).
    "combine_batch_4": [(
        "moe_dispatch.cu", "constexpr int kBatch = 2;", "constexpr int kBatch = 4;",
    )],
    # The backward without its register budget of 4 CTAs an SM.
    "bwd_no_budget": [(
        "moe_dispatch.cu", "constexpr int kBwdCtasPerSm = 4;", "constexpr int kBwdCtasPerSm = 1;",
    )],
}


def plans(torch, routing, gen):
    """The send gather's source rows, and the two dispatch plans at P = 1,
    as ``_moe_mixnet_local`` builds them from random logits."""
    n = T * K
    with torch.no_grad():
        logits = torch.randn((T, E), generator=gen, device="cuda")
        info = routing.compute_routing(logits, top_k=K, num_virtual=E, replication=1)
        zeros = torch.zeros(n, dtype=torch.int32, device="cuda")
        rank1, _ = routing.bucket_ranks(zeros, 1)
        plan1 = routing.capacity_plan(zeros, rank1, None, 1, n)
        src_tok = torch.where(plan1.src >= 0, plan1.src // K, torch.full_like(plan1.src, -1))
        local_e = info.vdest.reshape(n)
        valid = local_e >= 0
        rank2, counts2 = routing.bucket_ranks(local_e, E, valid=valid)
        plan2 = routing.dropless_plan(local_e, rank2, counts2, valid, E, BLOCK)
    return info.wfull.float().contiguous(), plan1, src_tok, plan2


def combine_in_order(torch, y, slot, w, out_dtype):
    """The combine as the kernel computes it: acc = 0, then acc + w * y for
    s = 0..S-1, each product and sum rounded once in f32, dropped terms
    skipped, one rounding to ``out_dtype``."""
    p = y.shape[0]
    acc = torch.zeros((slot.shape[0], y.shape[1]), device=y.device)
    for s in range(slot.shape[1]):
        ok = (slot[:, s] >= 0) & (slot[:, s] < p)
        term = w[:, s, None] * y[slot[:, s].clamp(0, p - 1).long()].float()
        acc = torch.where(ok[:, None], acc + term, acc)
    return acc.to(out_dtype)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(REPO / "src"))
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--variant", choices=sorted(VARIANTS))
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bench_moe.py: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import moe_dispatch as kmd
    from repro_torch.models import routing

    if args.variant:
        variant = timing.variant_library(build, "moe_dispatch", kmd._SIGNATURES,
                                         VARIANTS[args.variant])
        kmd._lib = lambda: variant
    card = timing.card_line()
    tag = args.tag + (f" [{args.variant}]" if args.variant else "")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    n = T * K

    wts, plan1, src_tok, plan2 = plans(torch, routing, gen)
    slot1 = plan1.slot.reshape(T, K)
    assert bool((src_tok >= 0).all()) and bool((plan2.slot >= 0).all())
    x = torch.randn((T, D), generator=gen, device="cuda").to(bf16)
    sent = kmd.moe_dispatch_cuda(x, src_tok)
    packed = kmd.moe_dispatch_cuda(sent, plan2.src)
    y = torch.randn((n, D), generator=gen, device="cuda").to(bf16)
    dsend = torch.randn((n, D), generator=gen, device="cuda").to(bf16)
    dout = torch.randn((T, D), generator=gen, device="cuda")
    ones = torch.ones((T, K), device="cuda")
    idx_send, idx_unpack, slot_l = src_tok.long(), plan2.slot.long(), slot1.long()
    wts_b = wts.to(bf16)

    # The checks: every result against its definition on the same inputs.
    assert torch.equal(sent, ref.moe_dispatch(x, src_tok)), "send gather"
    assert torch.equal(packed, ref.moe_dispatch(sent, plan2.src)), "pack"
    assert torch.equal(kmd.moe_dispatch_cuda(packed, plan2.slot), sent), "unpack"
    assert torch.equal(kmd.moe_combine_cuda(y, slot1, wts),
                       combine_in_order(torch, y, slot1, wts, torch.float32)), "combine f32"
    assert torch.equal(kmd.moe_combine_cuda(dsend, slot1, ones, out_dtype=bf16),
                       combine_in_order(torch, dsend, slot1, ones, bf16)), "combine bf16"
    gy, gw = kmd.moe_combine_bwd_cuda(dout, y, slot1, wts, plan1.src)
    f = plan1.src.long()
    assert torch.equal(gy, (wts.reshape(-1)[f][:, None] * dout[f // K]).to(bf16)), "dy"
    want_dy, want_dw = ref.moe_combine_bwd(dout, y, slot1, wts, plan1.src)
    torch.testing.assert_close(gw, want_dw, rtol=1e-4, atol=1e-4)

    rows = 2 * D  # bytes of one bf16 row
    n_pack = plan2.src.shape[0]
    calls = (
        ("send", f"x [{T}, {D}] -> [{n}, {D}]", (T + n) * rows + n * 4,
         lambda: kmd.moe_dispatch_cuda(x, src_tok),
         ("index_select", lambda: torch.index_select(x, 0, idx_send))),
        ("pack", f"[{n}, {D}] -> [{n_pack}, {D}], {n_pack - n} zero rows",
         (n + n_pack) * rows + n_pack * 4, lambda: kmd.moe_dispatch_cuda(sent, plan2.src), None),
        ("unpack", f"[{n_pack}, {D}] -> [{n}, {D}]", 2 * n * rows + n * 4,
         lambda: kmd.moe_dispatch_cuda(packed, plan2.slot),
         ("index_select", lambda: torch.index_select(packed, 0, idx_unpack))),
        ("combine_f32", f"y [{n}, {D}] bf16, slot/w [{T}, {K}] -> [{T}, {D}] f32",
         n * rows + T * K * 8 + T * D * 4, lambda: kmd.moe_combine_cuda(y, slot1, wts),
         ("embedding_bag (bf16 out)",
          lambda: F.embedding_bag(slot_l, y, per_sample_weights=wts_b, mode="sum"))),
        ("combine_bf16", f"dout [{n}, {D}] bf16, unit weights [{T}, {K}] -> [{T}, {D}] bf16",
         n * rows + T * K * 8 + T * rows,
         lambda: kmd.moe_combine_cuda(dsend, slot1, ones, out_dtype=bf16),
         ("embedding_bag", lambda: F.embedding_bag(slot_l, dsend, mode="sum"))),
        ("combine_bwd", f"dout [{T}, {D}] f32, y [{n}, {D}] bf16 -> dy [{n}, {D}], dw [{T}, {K}]",
         T * D * 4 + 2 * n * rows + T * K * 12 + n * 4,
         lambda: kmd.moe_combine_bwd_cuda(dout, y, slot1, wts, plan1.src), None),
    )
    # Cold L2: a 128 MiB fill before each call evicts the 50 MB cache, as the
    # grouped GEMMs' weight streams do between most of these calls in a step.
    scrub = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scrub.fill_(1)  # noqa: E731
    for name, shape, nbytes, kernel, library in calls:
        ms = timing.time_ms(torch, kernel, ITERS)
        dev, per = timing.device_ms(torch, kernel)
        cold, _ = timing.device_ms(torch, kernel, before=flush)
        host = timing.host_us(torch, kernel, HOST_ITERS)
        bms, _ = timing.bound_ms(nbytes, 0.0)
        lib = ""
        if library is not None:
            lname, lfn = library
            ldev, lper = timing.device_ms(torch, lfn)
            lcold, _ = timing.device_ms(torch, lfn, before=flush)
            lib = (f" {lname}: ms={timing.time_ms(torch, lfn, ITERS):.5f} device_ms={ldev:.5f} "
                   f"cold_device_ms={lcold:.5f} host_us={timing.host_us(torch, lfn, HOST_ITERS):.2f} "
                   f"[{' '.join(f'{k[:40]}={v:.5f}' for k, v in sorted(lper.items()))}]")
        parts = " ".join(f"{k[:40]}={v:.5f}" for k, v in sorted(per.items()))
        print(f"bench [{tag}] {name} {shape}: ms={ms:.5f} device_ms={dev:.5f} "
              f"cold_device_ms={cold:.5f} host_us={host:.2f} bound_ms={bms:.5f} "
              f"({nbytes / 1e6:.1f} MB, {nbytes / dev / 1e9:.2f} TB/s warm) [{parts}]{lib}",
              flush=True)
    # The card's copy ceiling at this size: one contiguous copy of the send
    # gather's output (the pack's bytes, less its padding rows).
    dst = torch.empty_like(sent)
    copy = lambda: dst.copy_(sent)  # noqa: E731
    dev, _ = timing.device_ms(torch, copy)
    cold, _ = timing.device_ms(torch, copy, before=flush)
    print(f"bench [{tag}] copy ceiling: copy_ of [{n}, {D}] bf16 ({2 * n * rows / 1e6:.1f} MB): "
          f"ms={timing.time_ms(torch, copy, ITERS):.5f} device_ms={dev:.5f} "
          f"cold_device_ms={cold:.5f} ({2 * n * rows / dev / 1e9:.2f} TB/s warm)", flush=True)
    print(f"bench [{tag}] card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
