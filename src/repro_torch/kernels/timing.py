"""Timing helpers shared by ``chip_smoke.py`` and the kernel benchmarks
(``bench_attn.py``, ``bench_gmm.py``, ``bench_moe.py``, ``bench_norm.py``,
``bench_ssd.py``).

Three clocks, because for small calls they disagree:

* :func:`time_ms` — CUDA events around back-to-back calls: the card's time
  when the card is the slower side, the host's issue rate when the host is;
* :func:`device_ms` — the kernels' own time under ``torch.profiler``;
* :func:`host_us` — a host clock over calls with no synchronise inside: what
  the wrapper costs the host per call;
* :func:`graph_ms` — CUDA events around a CUDA graph of back-to-back calls:
  the card's wall time per call with no host in the way, and with the
  overlap of kernels launched with programmatic stream serialization that
  the profiler's per-kernel sum counts twice.

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
    "graph_ms", "bound_ms", "variant_library", "empty_kernel", "trace_decode_tick",
]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tfloat32": 494.7e12}  # dense, no sparsity


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


def graph_ms(torch, fn, iters: int = 20, replays: int = 5) -> float:
    """Mean milliseconds per call of ``fn`` over a CUDA graph of ``iters``
    back-to-back calls, replayed ``replays`` times (after one warm-up
    replay), by CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # allocations of the capture's pool
        torch.cuda.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(iters):
                fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / (replays * iters)


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


_EMPTY_SRC = """
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def empty_kernel(torch, build):
    """A call that launches an empty kernel (one CTA of 32 threads) on the
    current stream: the launch floor a small kernel's device, event and
    graph times sit on.  Built with ``build.NVCC_FLAGS`` in a scratch
    directory."""
    tmp = pathlib.Path(tempfile.mkdtemp())
    (tmp / "empty.cu").write_text(_EMPTY_SRC)
    out = tmp / "libempty.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(tmp / "empty.cu")],
                   check=True)
    lib = ctypes.CDLL(str(out))
    lib.empty_launch.argtypes = (ctypes.c_void_p,)
    lib.empty_launch.restype = ctypes.c_int

    def call():
        err = lib.empty_launch(torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"empty kernel launch failed (CUDA error {err})")

    return call


def trace_decode_tick(torch, eng) -> dict:
    """Wrap ``eng.step`` (a ``ServeEngine``'s) so that its ticks run under
    torch.profiler until the first pure decode tick (one that admits
    nothing and decodes); ``out["launches"]`` is then the number of kernels
    that tick launched on the card (copies and fills not counted) and
    ``out["device_ms"]`` the sum of their device times.  While
    ``out["launches"]`` is None the next tick is traced: its host clock
    carries the profiler's cost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {"launches": None, "device_ms": None}
    step = eng.step

    def traced_step():
        if out["launches"] is not None:
            return step()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            st = step()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA
               and not any(w in ev.key.lower() for w in ("memcpy", "memset"))]
        n = sum(ev.count for ev in evs)
        if st.admitted == 0 and st.live > 0 and n > 0:
            out["launches"] = n
            out["device_ms"] = sum(ev.self_device_time_total for ev in evs) / 1e3
        return st

    eng.step = traced_step
    return out
