"""Timing helpers shared by ``chip_smoke.py`` and the kernel benchmarks
(``bench_attn.py``, ``bench_gmm.py``, ``bench_moe.py``).

Three clocks, because for small calls they disagree:

* :func:`time_ms` — CUDA events around back-to-back calls: the card's time
  when the card is the slower side, the host's issue rate when the host is;
* :func:`device_ms` — the kernels' own time under ``torch.profiler``;
* :func:`host_us` — a host clock over calls with no synchronise inside: what
  the wrapper costs the host per call.

Nothing here imports ``torch`` at module level: every function takes the
module as its first argument, so the benchmarks can load this file by path
before they import the tree they time.
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import subprocess
import tempfile
import time

__all__ = [
    "HBM_BYTES_PER_S", "PEAK_FLOPS", "card_line", "time_ms", "device_ms", "host_us",
    "bound_ms", "variant_library",
]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense, no sparsity


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` over ``iters`` back-to-back calls, by CUDA
    events.  A call that the host issues slower than the card runs it
    measures the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(torch, fn, iters: int = 10, before=None) -> tuple[float, dict]:
    """Device milliseconds a call of ``fn`` keeps the card busy (its kernels'
    time under torch.profiler over ``iters`` calls), and the same per kernel
    name.  ``before``, if given, runs before each call (to evict the L2
    cache, say); its kernels, found by profiling it alone, are left out.

    A kernel's time is its mean over the launches the trace holds, times
    its launches per call (at least one): traces have come back holding
    some of a run's launches, whose sum over ``iters`` read low."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(calls):
        calls()
        torch.cuda.synchronize()
        # A trace now and then comes back without its kernels: take another.
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(iters):
                    calls()
                torch.cuda.synchronize()
            per = {}
            for ev in prof.key_averages():
                if ev.device_type == DeviceType.CUDA and ev.count:
                    per_call = max(1, round(ev.count / iters))
                    per[ev.key] = (per.get(ev.key, 0.0)
                                   + ev.self_device_time_total / 1e3 / ev.count * per_call)
            if per:
                break
        return per

    if before is None:
        per = run(fn)
    else:
        skip = set(run(before))
        per = {k: v for k, v in run(lambda: (before(), fn())).items() if k not in skip}
    return sum(per.values()), per


def host_us(torch, fn, iters: int = 1000) -> float:
    """Host microseconds per call of ``fn`` over ``iters`` calls with no
    synchronise inside the loop (the card's queue absorbs the work)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def bound_ms(bytes_moved: float, flops: float, dtype: str = "bfloat16") -> tuple[float, str]:
    """The least time the card could take: bytes over 3.35 TB/s or
    operations over the peak rate of ``dtype``, the larger, and which."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def variant_library(build, source: str, signatures: dict, substitutions) -> ctypes.CDLL:
    """``csrc/<source>.cu`` of the tree ``build`` belongs to, copied with its
    headers to a scratch directory, each ``(file, old, new)`` of
    ``substitutions`` applied (``old`` must occur), built with
    ``build.NVCC_FLAGS`` and loaded with ``signatures`` declared."""
    tmp = pathlib.Path(tempfile.mkdtemp())
    for f in build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, tmp / f.name)
    for fname, old, new in substitutions:
        text = (tmp / fname).read_text()
        assert old in text, f"variant: {old!r} not in {fname}"
        (tmp / fname).write_text(text.replace(old, new))
    out = tmp / f"lib{source}.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(tmp), "-o", str(out),
                    str(tmp / f"{source}.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    for fn, (argtypes, restype) in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib

