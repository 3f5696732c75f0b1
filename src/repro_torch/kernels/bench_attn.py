#!/usr/bin/env python3
"""Time the port's flash-attention kernels (kernel 2, bf16 forward with its
log-sum-exp and the two-launch backward) on one CUDA card, beside
``F.scaled_dot_product_attention`` and its backward, at the shapes the port
runs: Mixtral-8x7B's training step (q [2, 32, 256, 128], k/v 8 heads),
grok-1's prefill (q [1, 48, 256, 128], k/v 8 heads) and Mixtral's heads at
S = 1024 and 4096, B = 1; all causal.

    python3 src/repro_torch/kernels/bench_attn.py [--src DIR] [--tag NAME] [--variant NAME]
    python3 src/repro_torch/kernels/bench_attn.py --paged [--src DIR] [--tag NAME] [--variant NAME]

Run it as a file, not as a module: ``--src`` is the ``src`` directory whose
``repro_torch`` is timed (default: this checkout's), so one call can time
two trees in turns (parent, change, change, parent).  ``--variant`` times a
design variant of ``csrc/flash_attention.cu``: the source is copied to a
scratch directory, the variant's text substitutions applied, and the
library built there with the flags of ``kernels/build.py``.  Before it is
timed, every result is held against SDPA on the same inputs in f32: the
output within the bf16 tolerance of ``tests/test_torch_cuda.py`` (rtol
1.6e-2, atol 1e-5) and the gradients within its bf16 gradient tolerance
(rtol 3e-2, atol 3e-2).  Prints one line per kernel and shape: CUDA-event
milliseconds, mean of back-to-back calls after 3 warm-ups (at small shapes
the host's issue rate), the device time under torch.profiler (the kernels'
own, each named), the same two for SDPA in bf16 (``enable_gqa``; its
backward through autograd), the bound (bytes over 3.35 TB/s or FLOP over
989 TFLOP/s, the larger) and the card's name and power limit.

``--paged`` times paged decode instead (kernel 3,
``csrc/paged_flash_decode.cu``; its variants are ``PAGED_VARIANTS``) at
grok-1's decode shapes, q [4, C, 48, 128] against bf16 pools of 8 kv heads
and pages of 16: ``chip_smoke.py``'s serve row (C = 1, contexts of 10, 44,
20 and 8 tokens, pool [64, 16, 8, 128]), a speculative verify pass over the
same pool (C = 5: row c attends positions <= t + c) and a long context (4
slots at t = 4095, pool [1024, 16, 8, 128], 67.1 MB of K/V), through a
permuted page table.
Each result is first held against the plain version in bf16's tolerance.
Per shape: CUDA-event ms, device ms warm and cold (a 128 MiB fill before
each call), the wall ms per call in a CUDA graph of 20 calls, host µs per
call, the same for a gather of the pages plus SDPA,
and the bound (the K/V, q, output and table bytes over 3.35 TB/s).
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

# (name, B, Hq, Hkv, S, D)
SHAPES = (
    ("mixtral train", 2, 32, 8, 256, 128),
    ("grok prefill", 1, 48, 8, 256, 128),
    ("mixtral S=1024", 1, 32, 8, 1024, 128),
    ("mixtral S=4096", 1, 32, 8, 4096, 128),
)
OUT_TOL = dict(rtol=1.6e-2, atol=1e-5)
GRAD_TOL = dict(rtol=3e-2, atol=3e-2)

# Design variants: (file, text in it, replacement).
VARIANTS = {
    # The forward's K/V ring held to two stages.
    "fwd_two_stages": [(
        "flash_attention.cu",
        "static constexpr int kStages = cmin(3, (kSmemMax - 1024 - 256 - Q_BYTES) / STAGE_BYTES);",
        "static constexpr int kStages = cmin(2, (kSmemMax - 1024 - 256 - Q_BYTES) / STAGE_BYTES);",
    )],
    # The forward's consumers issuing their GEMM phases without taking turns.
    "fwd_no_pingpong": [
        ("flash_attention.cu", "named_bar_sync(4 + c, 256);", ""),
        ("flash_attention.cu", "named_bar_arrive_if(4, 256, c == 1);", ""),
        ("flash_attention.cu", "named_bar_arrive_if(5 - c, 256, true);", ""),
        ("flash_attention.cu", "named_bar_arrive_if(5 - c, 256, c == 0);", ""),
    ],
}


# Paged-decode variants of csrc/paged_flash_decode.cu.
PAGED_VARIANTS = {
    # Eight warps a CTA instead of four.
    "warps8": [("paged_flash_decode.cu", "constexpr int kWarps = 4;", "constexpr int kWarps = 8;")],
    # No split of the context: one CTA a (b, kv head, row block).
    "splits1": [("paged_flash_decode.cu", "constexpr int kMaxSplits = 8;",
                 "constexpr int kMaxSplits = 1;")],
    # bf16 on CUDA cores, as f32 is.
    "bf16_cuda_cores": [("paged_flash_decode.cu",
                         "constexpr bool kMma = std::is_same_v<T, __nv_bfloat16>;",
                         "constexpr bool kMma = false;")],
    # At most 4 splits.
    "splits4": [("paged_flash_decode.cu", "constexpr int kMaxSplits = 8;",
                 "constexpr int kMaxSplits = 4;")],
    # A split for every 4 (16) pages of the table instead of every 8: still
    # a function of P alone.
    "pages4": [("paged_flash_decode.cu", "constexpr int kSplitPages = 8;",
                "constexpr int kSplitPages = 4;")],
    "pages16": [("paged_flash_decode.cu", "constexpr int kSplitPages = 8;",
                 "constexpr int kSplitPages = 16;")],
}
# (name, context lengths t, pages in the pool, table width P, query rows C
# a slot); page 16, grok-1's 48 query and 8 kv heads.
PAGED_SHAPES = (
    ("serve row", (10, 44, 20, 8), 64, 16, 1),
    ("verify", (10, 44, 20, 8), 64, 16, 5),
    ("long context", (4095, 4095, 4095, 4095), 1024, 256, 1),
)
PAGE, HQ, HKV, HD = 16, 48, 8, 128


def paged(torch, F, args) -> int:
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as kfa

    if args.variant:
        build._loaded["paged_flash_decode"] = timing.variant_library(
            build, "paged_flash_decode", kfa._PAGED_SIG, PAGED_VARIANTS[args.variant])
    card = timing.card_line()
    tag = args.tag + (f" [{args.variant}]" if args.variant else "")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cpu = torch.Generator().manual_seed(0)
    scrub = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scrub.fill_(1)  # noqa: E731
    for name, lengths, pages, width, c in PAGED_SHAPES:
        b = len(lengths)
        perm = torch.randperm(pages, generator=cpu)[: b * width].reshape(b, width)
        used = torch.tensor([-(-(t + c) // PAGE) for t in lengths])
        table = torch.where(torch.arange(width)[None, :] < used[:, None], perm, -1)
        table = table.to(torch.int32).cuda()
        tvec = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        q = torch.randn((b, c, HQ, HD), generator=gen, device="cuda").bfloat16()
        kp = torch.randn((pages, PAGE, HKV, HD), generator=gen, device="cuda").bfloat16()
        vp = torch.randn((pages, PAGE, HKV, HD), generator=gen, device="cuda").bfloat16()
        out = kfa.paged_flash_decode_cuda(q, kp, vp, table, tvec)
        want = ref.paged_flash_decode(q, kp, vp, table, tvec)
        torch.testing.assert_close(out.float(), want.float(), **OUT_TOL,
                                   msg=lambda m: f"{name}: {m}")
        assert torch.equal(out, kfa.paged_flash_decode_cuda(q, kp, vp, table, tvec)), \
            f"{name}: two calls differ"
        last = tvec[:, None] + torch.arange(c, device="cuda")[None, :]  # [B, C]
        mask = (torch.arange(width * PAGE, device="cuda")[None, None, None, :]
                <= last[:, None, :, None])

        def library():
            vk = ref.paged_gather_kv(kp, table).transpose(1, 2)
            vv = ref.paged_gather_kv(vp, table).transpose(1, 2)
            return F.scaled_dot_product_attention(q.transpose(1, 2), vk, vv, attn_mask=mask,
                                                  enable_gqa=True)

        kernel = lambda: kfa.paged_flash_decode_cuda(q, kp, vp, table, tvec)  # noqa: E731
        nbytes = (sum((t + c) * HKV * HD * 2 * 2 for t in lengths) + 2 * b * c * HQ * HD * 2
                  + table.numel() * 4 + b * 4)
        bms, by = timing.bound_ms(
            nbytes, sum(4.0 * HQ * HD * (t + j + 1) for t in lengths for j in range(c)))
        iters = 50 if max(lengths) > 1000 else 200
        ms = timing.time_ms(torch, kernel, iters)
        dev, per = timing.device_ms(torch, kernel)
        cold, _ = timing.device_ms(torch, kernel, before=flush)
        host = timing.host_us(torch, kernel, 1000)
        graph = timing.graph_ms(torch, kernel)
        ldev, _ = timing.device_ms(torch, library)
        lcold, _ = timing.device_ms(torch, library, before=flush)
        parts = " ".join(f"{k[:40]}={v:.5f}" for k, v in sorted(per.items()))
        print(f"bench [{tag}] paged_flash_decode {name}: q [{b}, {c}, {HQ}, {HD}] bf16, pool "
              f"[{pages}, {PAGE}, {HKV}, {HD}], t={list(lengths)}: ms={ms:.5f} "
              f"device_ms={dev:.5f} cold_device_ms={cold:.5f} graph_ms={graph:.5f} "
              f"host_us={host:.2f} bound_ms={bms:.6f} ({by}; {nbytes / 1e6:.2f} MB, "
              f"{nbytes / cold / 1e9:.2f} TB/s cold) gather+sdpa: ms={timing.time_ms(torch, library, 20):.5f} "
              f"device_ms={ldev:.5f} cold_device_ms={lcold:.5f} [{parts}]", flush=True)
        del q, kp, vp, out, want
        torch.cuda.empty_cache()
    print(f"bench [{tag}] card: {card}", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(REPO / "src"))
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--paged", action="store_true", help="time paged decode (kernel 3)")
    ap.add_argument("--variant", choices=sorted(set(VARIANTS) | set(PAGED_VARIANTS)))
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bench_attn.py: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    if args.paged:
        return paged(torch, F, args)
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kfa

    if args.variant:
        build._loaded["flash_attention"] = timing.variant_library(
            build, "flash_attention", kfa._FLASH_SIG, VARIANTS[args.variant])
    card = timing.card_line()
    tag = args.tag + (f" [{args.variant}]" if args.variant else "")
    gen = torch.Generator(device="cuda").manual_seed(0)

    for name, b, hq, hkv, s, d in SHAPES:
        q = torch.randn((b, hq, s, d), generator=gen, device="cuda").bfloat16()
        k = torch.randn((b, hkv, s, d), generator=gen, device="cuda").bfloat16()
        v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").bfloat16()
        do = torch.randn((b, hq, s, d), generator=gen, device="cuda").bfloat16()
        shape = f"{name}: q [{b}, {hq}, {s}, {d}], k/v {hkv} heads, bf16 causal"
        iters = 20 if s >= 4096 else 50

        # The f32 reference: SDPA on the same inputs, and its gradients.
        qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
        want = F.scaled_dot_product_attention(qf, kf, vf, is_causal=True, enable_gqa=True)
        want_grads = torch.autograd.grad(want, (qf, kf, vf), do.float())
        out, lse = kfa.flash_attention_cuda(q, k, v, causal=True, return_lse=True)
        torch.testing.assert_close(out.float(), want.detach(), **OUT_TOL,
                                   msg=lambda m: f"{shape} forward: {m}")
        grads = kfa.flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=True)
        for nm, got, ref in zip("qkv", grads, want_grads):
            torch.testing.assert_close(got.float(), ref, **GRAD_TOL,
                                       msg=lambda m, nm=nm: f"{shape} d{nm}: {m}")
        del qf, kf, vf, want, want_grads

        pairs = s * (s + 1) / 2
        fwd_bytes = 2 * (2 * b * hq + 2 * b * hkv) * s * d + 4 * b * hq * s
        fwd_flops = 4.0 * d * pairs * hq * b
        bwd_bytes = 2 * (3 * b * hq + 4 * b * hkv + b * hq) * s * d + 2 * 4 * b * hq * s
        bwd_flops = 10.0 * d * pairs * hq * b
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, enable_gqa=True)
        calls = (
            ("flash_attention", fwd_bytes, fwd_flops,
             lambda: kfa.flash_attention_cuda(q, k, v, causal=True, return_lse=True),
             lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)),
            ("flash_attention_bwd", bwd_bytes, bwd_flops,
             lambda: kfa.flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=True),
             lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True)),
        )
        for kname, nbytes, flops, kernel, library in calls:
            ms = timing.time_ms(torch, kernel, iters)
            dev, per = timing.device_ms(torch, kernel)
            lib = timing.time_ms(torch, library, iters)
            lib_dev, _ = timing.device_ms(torch, library)
            bms, by = timing.bound_ms(nbytes, flops)
            parts = " ".join(f"{n[:40]}={t:.5f}" for n, t in sorted(per.items()))
            print(f"bench [{tag}] {kname} {shape}: ms={ms:.5f} device_ms={dev:.5f} "
                  f"sdpa_ms={lib:.5f} sdpa_device_ms={lib_dev:.5f} bound_ms={bms:.5f} ({by}) "
                  f"tflops_device={flops / dev / 1e9:.1f} [{parts}]", flush=True)
        del q, k, v, do, out, lse, grads, ql, kl, vl, lib_out
        torch.cuda.empty_cache()
    print(f"bench [{tag}] card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
