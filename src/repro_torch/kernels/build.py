"""Build the port's CUDA kernels with ``nvcc`` at first use and load them
with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds).  The
library's file name carries a hash of its sources and flags, so an edit
rebuilds; builds go to ``build/repro_torch_kernels/`` at the repository
root, which git ignores.  The hash covers every ``csrc/*.cuh``, so an edit
to a shared header rebuilds every library.  :func:`build_all` starts one
``nvcc`` per missing library, all at once.  A failed build raises with
nvcc's stderr.

    python -m repro_torch.kernels.build --ptxas [name ...]

compiles the named sources (all by default) with ``-Xptxas -v`` into a
scratch directory and prints ptxas's report: each kernel's registers,
spills and shared memory, and any C7520 note (wgmma serialised by ptxas).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["SOURCES", "BUILD_DIR", "build_all", "library", "nvcc"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = (
    "topk_gating", "flash_attention", "paged_flash_decode", "moe_dispatch", "grouped_matmul",
    "rmsnorm", "ssd_chunk",
)
# No --use_fast_math: the top-k ids and the softmax rely on IEEE expf/tanhf.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler (PATH, then $CUDA_HOME, then /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the toolkit is")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> list[str]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` process each, all started together.  Returns the names built."""
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = []
    for name in todo:
        # Compile to a temporary name and rename: a concurrent build never
        # sees a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [compiler, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )))
    failures = []
    for name, tmp, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{err}")
        else:
            os.replace(tmp, _lib_path(name))
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return todo


def library(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed), with
    ``signatures`` = {function: (argtypes, restype)} declared on it."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib


def ptxas_report(names=SOURCES) -> str:
    """nvcc's ``-Xptxas -v`` report for each source in ``names`` (compiled
    into a temporary directory, one process each, all at once), with a count
    of C7520 notes per source."""
    compiler = nvcc()
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(name, subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-o",
             str(Path(tmp) / f"lib{name}.so"), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )) for name in names]
        for name, proc in procs:
            text, _ = proc.communicate()
            out.append(f"== {name}.cu: exit {proc.returncode}, "
                       f"C7520 notes: {text.count('C7520')}\n{text}")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Build the port's CUDA kernels.")
    ap.add_argument("--ptxas", action="store_true",
                    help="print ptxas's register / spill / C7520 report instead of building")
    ap.add_argument("names", nargs="*", default=list(SOURCES))
    args = ap.parse_args(argv)
    if args.ptxas:
        print(ptxas_report(args.names))
    else:
        print("built:", build_all(args.names))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
