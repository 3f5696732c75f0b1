#!/usr/bin/env python3
"""Time the port's grouped-GEMM kernels on one CUDA card at Mixtral-8x7B's
training shapes: kernel 7 (the dropless block layout) and kernel 6 (the
capacity layout), forward, dX and dW, at the w_in and w_out shapes, with a
balanced and a skewed dropless plan.

    python3 src/repro_torch/kernels/bench_gmm.py [--src DIR] [--tag NAME] [--variant NAME]

Run it as a file, not as a module: ``--src`` is the ``src`` directory whose
``repro_torch`` is timed (default: this checkout's), so one call can time
two trees in turns (parent, change, change, parent).  ``--variant`` times a design variant of
``csrc/grouped_matmul.cu``: the source is copied to a scratch directory, the
variant's text substitutions applied, and the library built there with the
flags of ``kernels/build.py``.  Every kernel result is held against the
library call (``torch._grouped_mm`` or ``torch.bmm``) within 1e-2 of its
largest magnitude before it is timed.  Prints one line per kernel and shape:
CUDA-event milliseconds, mean of 20 back-to-back calls after 3 warm-ups,
the library call's beside it, and the card's name and power limit.
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

D, F, E, TOP_K, TOKENS, CAPACITY = 4096, 14336, 8, 2, 512, 200
REL = 1e-2

# Design variants: (file, text in it, replacement).
VARIANTS = {
    # Kernel 7 finding its run by binary searches over be per expert (each
    # a chain of dependent loads) instead of one pass into a table.
    "fwd_binary_search": [(
        "grouped_matmul.cu",
        "const bool starts_in_smem = E + 1 <= kTableMax;",
        "const bool starts_in_smem = false;",
    )],
    # dW issuing only the k16 steps of a stage that hold rows of the expert
    # (1 of 4 in the last stage at C = 200): a loop bound read at run time.
    "dw_skip_empty_k16": [(
        "grouped_matmul.cu",
        "for (int kk = 0; kk < L::BR / 16; ++kk) {",
        "for (int kk = 0; kk < min(L::BR / 16, (re - rb - j * L::BR + 15) / 16); ++kk) {",
    )],
    # dW without persistence: one output tile a cluster, every tile its own
    # cluster (the producer cannot run ahead into a next tile).
    "dw_one_tile_a_cluster": [(
        "grouped_matmul.cu",
        "const int clusters = static_cast<int>(n_ctiles < c[1] ? n_ctiles : c[1]);",
        "const int clusters = static_cast<int>(n_ctiles);",
    )],
}


def plans(np):
    """Per-expert choice counts: the balanced plan of random top-2 gating
    over 512 tokens, and a skewed one with 3/8 of the choices on each of two
    experts."""
    rng = np.random.default_rng(0)
    top = np.argsort(-rng.standard_normal((TOKENS, E)), axis=1)[:, :TOP_K]
    n = TOKENS * TOP_K
    hot = 3 * n // 8
    rest = n - 2 * hot
    skew = [hot, hot] + [rest // (E - 2) + (i < rest % (E - 2)) for i in range(E - 2)]
    return {"balanced": np.bincount(top.ravel(), minlength=E), "skewed": np.asarray(skew)}


def blocks(torch, np, counts, width, gen):
    """Tiles of 8 rows for ``counts`` (zero padding rows), padded with
    trailing zero tiles clipped to the last expert up to the static bound
    ceil(n / 8) + E - 1 the dropless plan uses; returns x, be, offs."""
    tiles = [-(-int(c) // 8) for c in counts]
    n_tiles = -(-int(counts.sum()) // 8) + E - 1
    be = np.repeat(np.arange(E), tiles)
    be = np.concatenate([be, np.full(n_tiles - len(be), E - 1)]).astype(np.int32)
    x = torch.zeros((n_tiles * 8, width), device="cuda", dtype=torch.bfloat16)
    row = 0
    for c, t in zip(counts, tiles):
        x[row:row + c] = torch.randn((int(c), width), generator=gen, device="cuda").bfloat16()
        row += t * 8
    be_t = torch.from_numpy(be).cuda()
    offs = torch.cumsum(torch.bincount(be_t, minlength=E) * 8, 0).to(torch.int32)
    return x.reshape(n_tiles, 8, width), be_t, offs


def check(got, want, what):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert err <= REL * scale + 1e-6, f"{what}: max |diff| {err} > {REL} x {scale}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(REPO / "src"))
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--variant", choices=sorted(VARIANTS))
    ap.add_argument("--library", action="store_true", help="also time the library calls")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_gmm.py: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build
    from repro_torch.kernels import grouped_matmul as kgm

    if args.variant:
        lib = timing.variant_library(build, "grouped_matmul", kgm._SIGNATURES,
                                     VARIANTS[args.variant])
        kgm._lib = lambda: lib
    card = timing.card_line()
    tag = args.tag + (f" [{args.variant}]" if args.variant else "")
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def row(name, shape, kernel, library):
        want = library()
        check(kernel(), want, f"{name} {shape}")
        ms = timing.time_ms(torch, kernel, 20)
        lib_ms = f" library_ms={timing.time_ms(torch, library, 20):.5f}" if args.library else ""
        print(f"bench [{tag}] {name} {shape}: ms={ms:.5f}{lib_ms}", flush=True)

    for layer, (kd, nd) in (("w_in", (D, F)), ("w_out", (F, D))):
        w = (torch.randn((E, kd, nd), generator=gen, device="cuda") * kd**-0.5).to(bf)
        w_t = w.transpose(1, 2)
        for plan, counts in plans(np).items():
            x, be, offs = blocks(torch, np, counts, kd, gen)
            dy, _, _ = blocks(torch, np, counts, nd, gen)
            x2, dy2 = x.reshape(-1, kd), dy.reshape(-1, nd)
            shape = f"{layer} {plan} ({x.shape[0]} tiles)"
            row("grouped_matmul_blocks", shape, lambda: kgm.grouped_matmul_blocks_cuda(x, w, be),
                lambda: torch._grouped_mm(x2, w, offs=offs).reshape(x.shape[0], 8, nd))
            row("grouped_matmul_blocks_dx", shape,
                lambda: kgm.grouped_matmul_blocks_dx_cuda(dy, w, be),
                lambda: torch._grouped_mm(dy2, w_t, offs=offs).reshape(x.shape[0], 8, kd))
            row("grouped_matmul_blocks_dw", shape,
                lambda: kgm.grouped_matmul_blocks_dw_cuda(x, dy, be, E),
                lambda: torch._grouped_mm(x2.t(), dy2, offs=offs))
            del x, dy, x2, dy2
        xc = torch.randn((E, CAPACITY, kd), generator=gen, device="cuda").to(bf)
        dyc = torch.randn((E, CAPACITY, nd), generator=gen, device="cuda").to(bf)
        shape = f"{layer} capacity C={CAPACITY}"
        row("grouped_matmul", shape, lambda: kgm.grouped_matmul_cuda(xc, w),
            lambda: torch.bmm(xc, w))
        row("grouped_matmul_dx", shape, lambda: kgm.grouped_matmul_dx_cuda(dyc, w),
            lambda: torch.bmm(dyc, w_t))
        row("grouped_matmul_dw", shape, lambda: kgm.grouped_matmul_dw_cuda(xc, dyc),
            lambda: torch.bmm(xc.transpose(1, 2), dyc))
        if layer == "w_in":
            # What writing a dW costs the card alone: a fill of [E, K, N] bf16.
            out = torch.empty((E, kd, nd), device="cuda", dtype=bf)
            print(f"bench [{tag}] write ceiling: fill_ of [{E}, {kd}, {nd}] bf16: "
                  f"ms={timing.time_ms(torch, lambda: out.fill_(1.0), 20):.5f}", flush=True)
            del out
        del w, w_t, xc, dyc
        torch.cuda.empty_cache()
    print(f"bench [{tag}] card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
