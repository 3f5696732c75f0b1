#!/usr/bin/env python3
"""Time the port's flash-attention kernels (kernel 2, bf16 forward with its
log-sum-exp and the two-launch backward) on one CUDA card, beside
``F.scaled_dot_product_attention`` and its backward, at the shapes the port
runs: Mixtral-8x7B's training step (q [2, 32, 256, 128], k/v 8 heads),
grok-1's prefill (q [1, 48, 256, 128], k/v 8 heads) and Mixtral's heads at
S = 1024 and 4096, B = 1; all causal.

    python3 src/repro_torch/kernels/bench_attn.py [--src DIR] [--tag NAME] [--variant NAME]

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
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import shutil
import subprocess
import sys
import tempfile

REPO = pathlib.Path(__file__).resolve().parents[3]
# Run as a file, this directory comes first on the path: its module names
# (build, ops, ref, ...) must not shadow anything.
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == pathlib.Path(__file__).resolve().parent:
    sys.path.pop(0)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_BF16 = 989e12  # dense
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


def variant_library(build, kfa, name: str) -> ctypes.CDLL:
    tmp = pathlib.Path(tempfile.mkdtemp())
    for f in build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, tmp / f.name)
    for fname, old, new in VARIANTS[name]:
        text = (tmp / fname).read_text()
        assert old in text, f"variant {name}: {old!r} not in {fname}"
        (tmp / fname).write_text(text.replace(old, new))
    out = tmp / "libflash_attention.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(tmp), "-o", str(out),
                    str(tmp / "flash_attention.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    for fn, (argtypes, restype) in kfa._FLASH_SIG.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(torch, fn, iters: int = 10) -> tuple[float, dict]:
    """Device milliseconds a call of ``fn`` keeps the card busy (its kernels'
    time under torch.profiler, mean of ``iters`` calls), and per kernel name.
    Back-to-back CUDA-event times of a call that the host issues slower than
    the card runs it measure the host; this does not."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            per[ev.key] = per.get(ev.key, 0.0) + ev.self_device_time_total / 1e3 / iters
    return sum(per.values()), per


def bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(REPO / "src"))
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--variant", choices=sorted(VARIANTS))
    args = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("bench_attn.py: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kfa

    if args.variant:
        build._loaded["flash_attention"] = variant_library(build, kfa, args.variant)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
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
            ms = time_ms(torch, kernel, iters)
            dev, per = device_ms(torch, kernel)
            lib = time_ms(torch, library, iters)
            lib_dev, _ = device_ms(torch, library)
            bms, by = bound_ms(nbytes, flops)
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
