#!/usr/bin/env python3
"""Time the port's Mamba-2 SSD intra-chunk kernel (kernel 9,
``csrc/ssd_chunk.cu``) on one CUDA card at the shapes Mamba-2 1.3B's
serving path gives it: one 256-token prefill (G = 64 groups: 1 chunk x 64
heads, L = 256, P = 64, N = 128), ``generate``'s batch of 4 x 512 tokens
(G = 512: 8 chunks x 64 heads), and prefills of 8, 20 and 44 tokens (G =
64, L = the prompt's length), as the serve in ``chip_smoke.py`` runs them.

    python3 src/repro_torch/kernels/bench_ssd.py [--src DIR] [--tag NAME] [--variant NAME]

Run it as a file, not as a module: ``--src`` is the ``src`` directory whose
``repro_torch`` is timed (default: this checkout's), so one call can time
two trees in turns (parent, change, change, parent).  ``--variant`` times a
design variant of ``csrc/ssd_chunk.cu`` (text substitutions applied to a
copy, built with the flags of ``kernels/build.py``).  The inputs are built
as the model builds them (x dt-weighted, da = -dt, B and C once per chunk).
Each result is first held against the plain version on the same inputs:
max |diff| within 1e-4 of the largest magnitude (``chip_smoke.py``'s
SSD_REL) for y and the state; a variant outside it is reported and timed,
the tree's own kernel raises.  Prints one line per shape: the error, the
CUDA-event milliseconds (mean of back-to-back calls after 3 warm-ups), the
device time under torch.profiler with the inputs warm in L2 and cold (a 128
MiB fill before each call), each kernel's share, the wall time per call
in a CUDA graph of 20 calls (the two kernels overlap: the profiler's sum
counts the overlap twice), and the bound: bytes over
3.35 TB/s, or the least FLOP (C B^T once per chunk and the gated product
over the causal half, the state product) times three (3xTF32) over 494.7
TFLOP/s, the larger; then the card's name and power limit.
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

HEADS, P, N = 64, 64, 128
# (name, batch x chunks, L)
SHAPES = (("prefill of 256 tokens", 1, 256), ("generate, 4 x 512 tokens", 8, 256),
          ("prefill of 44 tokens", 1, 44), ("prefill of 20 tokens", 1, 20),
          ("prefill of 8 tokens", 1, 8))
SSD_REL = 1e-4
ITERS = 50
TF32_PRODUCTS = 3  # TF32 products per f32 product (3xTF32)

# Design variants: (file, text in it, replacement).
VARIANTS = {
    # Eight k-steps of fragments in flight a warp instead of four.
    "ring8": [("ssd_chunk.cu", "constexpr int kRing = 4;", "constexpr int kRing = 8;")],
    # Attribution, not designs (their results are wrong): no tensor-core
    # products; no exp in the gate.
    "no_mma": [("ssd_chunk.cu", 'asm("mma.sync', 'if (false) asm("mma.sync')],
    "no_exp": [("ssd_chunk.cu", "return cb * exp2_ftz(causal ? dcum * kLog2e : -INFINITY);",
                "return causal ? cb : 0.f;")],
    # ... no state warps; no y warps.
    "no_state": [("ssd_chunk.cu", "const bool st_ok = !y_warp && last_pass && 16 * w8 < N;",
                  "const bool st_ok = false;")],
    "no_y": [("ssd_chunk.cu",
              "const bool ya_ok = y_warp && 16 * ya < L, yb_ok = y_warp && 16 * yb < L;",
              "const bool ya_ok = false, yb_ok = false;")],
}


def least_work(g: int, bc: int, l: int) -> tuple[float, float]:
    """(bytes, FLOP) the least work needs, as ``chip_smoke.py``'s ssd_cost."""
    tri = l * (l + 1) / 2
    nbytes = 4.0 * (2 * g * l * P + g * l + 2 * bc * l * N + g * N * P)
    flops = 2.0 * bc * tri * N + 2.0 * g * tri * P + 2.0 * g * l * N * P
    return nbytes, flops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(REPO / "src"))
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--variant", choices=sorted(VARIANTS))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_ssd.py: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import ssd_chunk as kssd

    if args.variant:
        build._loaded["ssd_chunk"] = timing.variant_library(
            build, "ssd_chunk", kssd._SIGNATURES, VARIANTS[args.variant])
    card = timing.card_line()
    tag = args.tag + (f" [{args.variant}]" if args.variant else "")
    gen = torch.Generator(device="cuda").manual_seed(0)
    scrub = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scrub.fill_(1)  # noqa: E731

    for name, bc, l in SHAPES:
        g = bc * HEADS
        dt = torch.nn.functional.softplus(torch.randn((g, l), generator=gen, device="cuda"))
        x = torch.randn((g, l, P), generator=gen, device="cuda") * dt[:, :, None]
        da = -dt
        bm = torch.randn((bc, l, N), generator=gen, device="cuda")
        cm = torch.randn((bc, l, N), generator=gen, device="cuda")
        y, st = kssd.ssd_chunk_cuda(x, da, bm, cm, HEADS)
        wy, wst = ref.ssd_chunk(x, da, bm.repeat_interleave(HEADS, 0),
                                cm.repeat_interleave(HEADS, 0))
        rel = max(((got - want).abs().max() / want.abs().max()).item()
                  for got, want in ((y, wy), (st, wst)))
        ok = rel <= SSD_REL
        if not ok and not args.variant:
            raise AssertionError(f"{name}: max |diff| / max |want| = {rel:.3e} > {SSD_REL}")
        kernel = lambda: kssd.ssd_chunk_cuda(x, da, bm, cm, HEADS)  # noqa: E731
        ms = timing.time_ms(torch, kernel, ITERS)
        dev, per = timing.device_ms(torch, kernel)
        cold, _ = timing.device_ms(torch, kernel, before=flush)
        graph = timing.graph_ms(torch, kernel)
        nbytes, flops = least_work(g, bc, l)
        bms, by = timing.bound_ms(nbytes, TF32_PRODUCTS * flops, "tfloat32")
        parts = " ".join(f"{k[:40]}={v:.5f}" for k, v in sorted(per.items()))
        print(f"bench [{tag}] ssd_chunk {name}: x [{g}, {l}, {P}] f32, B/C [{bc}, {l}, {N}]: "
              f"rel_err={rel:.3e} ({'within' if ok else 'OUTSIDE'} {SSD_REL}) ms={ms:.5f} "
              f"device_ms={dev:.5f} cold_device_ms={cold:.5f} graph_ms={graph:.5f} "
              f"bound_ms={bms:.5f} ({by}; "
              f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP x {TF32_PRODUCTS} TF32) "
              f"[{parts}]", flush=True)
        del x, da, bm, cm, y, st, wy, wst
        torch.cuda.empty_cache()
    print(f"bench [{tag}] card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
