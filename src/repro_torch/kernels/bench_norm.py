#!/usr/bin/env python3
"""Time the port's RMSNorm kernels (kernel 8, ``csrc/rmsnorm.cu``: the norm,
the gated norm and the backward) and top-k gate (kernel 1,
``csrc/topk_gating.cu``: forward and backward) on one CUDA card at the
shapes the main paths give them, beside an empty kernel (the launch floor).

    python3 src/repro_torch/kernels/bench_norm.py [--src DIR] [--tag NAME] [--variant NAME]
        [--rows TEXT] [--ticks]

Run it as a file, not as a module: ``--src`` is the ``src`` directory whose
``repro_torch`` is timed (default: this checkout's), so one call can time
two trees in turns (parent, change, change, parent).  ``--variant`` times a
design variant of this tree's sources (text substitutions applied to a
copy, built with the flags of ``kernels/build.py``).

Shapes: Mamba-2 1.3B's serve (norm1 [T, 2048] and the gated norm [T,
4096] bf16 at prefills of T = 8, 20 and 44 tokens and at a decode tick of
4 slots), its 256-token prefill and ``generate``'s 4 x 512 tokens (the
gated norm at T = 256 and 2048, norm1 at 2048), grok-1's norms ([T, 6144]
bf16 at T = 4, 20, 44), Mixtral's training step (the norm [512, 4096]
bf16 forward and backward) and the gate ([512, 8] f32, k = 2, forward and
backward; [4, 8] and [44, 8] as grok-1 serves them).  A tree whose
kernel takes no gate is timed on what its path ran: ``F.silu``, the
multiply and the norm kernel (three launches); a tree with no backward
kernel on autograd of the plain version (what its training path ran).

Every result is first held against the plain version on the same inputs
(the gated kernel bit for bit against the ungated kernel on PyTorch's
``x * F.silu(z)``; gate ids exactly); a variant outside is reported and
timed, the tree's own kernel raises.  Prints one line per row: the error,
the CUDA-event ms (back-to-back calls: the host's issue rate at these
sizes), the device ms under torch.profiler warm and cold (a 128 MiB fill
before each call), the graph ms (a CUDA graph of 20 calls: the card's wall
time a call), the bound (bytes over 3.35 TB/s), and the library call's
device and event ms (``F.rms_norm``, its autograd backward, the unfused
silu + multiply + ``F.rms_norm``, ``topk∘softmax``); then the card's name
and power limit.  ``--ticks`` instead counts the kernels one decode tick
launches in the Mamba-2 and grok-1 serves of ``chip_smoke.py``, beside
the median host time of a decode tick.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
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

EPS = 1e-5  # Mamba-2's, grok-1's and Mixtral's norm_eps are 1e-5 or 1e-6: the time is the same
BF16_TOL = dict(rtol=1.6e-2, atol=1e-5)
F32_TOL = dict(rtol=1.3e-6, atol=1e-5)
ITERS = 200
# (row, kind, T, D): kind "norm", "gated" or "bwd".
NORM_ROWS = (
    [("mamba2 norm1 prefill", "norm", t, 2048) for t in (8, 20, 44)]
    + [("mamba2 norm1 decode", "norm", 4, 2048)]
    + [("mamba2 gated norm prefill", "gated", t, 4096) for t in (8, 20, 44)]
    + [("mamba2 gated norm decode", "gated", 4, 4096),
       ("mamba2 gated norm, prefill of 256", "gated", 256, 4096),
       ("mamba2 gated norm, generate", "gated", 2048, 4096),
       ("mamba2 norm1, generate", "norm", 2048, 2048)]
    + [("grok-1 norm", "norm", t, 6144) for t in (4, 20, 44)]
    + [("mixtral norm", "norm", 512, 4096), ("mixtral norm backward", "bwd", 512, 4096)]
)
# (row, kind, T, E, k): kind "fwd" or "bwd".
GATE_ROWS = (("grok-1 gate decode", "fwd", 4, 8, 2), ("grok-1 gate prefill", "fwd", 44, 8, 2),
             ("mixtral gate", "fwd", 512, 8, 2), ("mixtral gate backward", "bwd", 512, 8, 2))

# Design variants: (file, text in it, replacement).
VARIANTS = {
    # Forward lanes aim at 2 vectors of the row at every T (1 by default
    # under 256 rows): fewer warps a row; or at 1 at every T.
    "vpl2": [("rmsnorm.cu", "constexpr int kVecTarget = 1;", "constexpr int kVecTarget = 2;")],
    "many_off": [("rmsnorm.cu", "constexpr int kManyRows = 256;",
                  "constexpr int kManyRows = 1 << 30;")],
    # Backward lanes aim at 1 vector (2 by default); the backward on 64 or
    # 256 CTAs (128 by default).
    "bwd_vpl1": [("rmsnorm.cu", "constexpr int kBwdVecTarget = 2;",
                  "constexpr int kBwdVecTarget = 1;")],
    "bwd64": [("rmsnorm.cu", "constexpr int kBwdBlocks = 128;", "constexpr int kBwdBlocks = 64;")],
    "bwd256": [("rmsnorm.cu", "constexpr int kBwdBlocks = 128;",
                "constexpr int kBwdBlocks = 256;")],
    # No programmatic dependent launch (kernels 8 and 1).
    "nopdl": [("common.cuh", "  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")],
}


def times(torch, fn, flush, graph: bool = True) -> dict:
    """Event, device (warm and cold) and graph ms of ``fn``."""
    out = dict(ms=timing.time_ms(torch, fn, ITERS), device_ms=timing.device_ms(torch, fn)[0],
               cold_device_ms=timing.device_ms(torch, fn, before=flush)[0])
    if graph:
        out["graph_ms"] = timing.graph_ms(torch, fn)
    return out


def fmt(d: dict) -> str:
    return " ".join(f"{k}={v:.5f}" for k, v in d.items())


def norm_rows(torch, args, krms, ref, gen, flush):
    import torch.nn.functional as F

    has_gate = "gate" in inspect.signature(krms.rmsnorm_cuda).parameters
    has_bwd = hasattr(krms, "rmsnorm_bwd_cuda")
    bf16 = torch.bfloat16
    for name, kind, t, d in NORM_ROWS:
        if args.rows not in name:
            continue
        x = (torch.randn((t, d), generator=gen, device="cuda") * 3).to(bf16)
        w = (torch.randn((d,), generator=gen, device="cuda") * 0.1).to(bf16)
        z = (torch.randn((t, d), generator=gen, device="cuda") * 3).to(bf16)
        dy = torch.randn((t, d), generator=gen, device="cuda").to(bf16)
        w1 = (1.0 + w.float()).to(bf16)  # the library's weight, formed before timing
        if kind == "norm":
            kernel = lambda: krms.rmsnorm_cuda(x, w, EPS)  # noqa: E731
            got, want = kernel().float(), ref.rmsnorm(x, w, EPS).float()
            err = (got - want).abs().max().item()
            ok = torch.allclose(got, want, **BF16_TOL)
            lib = lambda: F.rms_norm(x, (d,), w1, EPS)  # noqa: E731
            nbytes, what = (2 * t * d + d) * 2, "kernel"
        elif kind == "gated":
            unfused = krms.rmsnorm_cuda(x * F.silu(z), w, EPS)
            if has_gate:
                kernel = lambda: krms.rmsnorm_cuda(x, w, EPS, gate=z)  # noqa: E731
                what = "fused gate"
            else:
                kernel = lambda: krms.rmsnorm_cuda(x * F.silu(z), w, EPS)  # noqa: E731
                what = "silu, multiply, kernel"
            err = (kernel().float() - unfused.float()).abs().max().item()
            ok = err == 0.0
            lib = lambda: F.rms_norm(x * F.silu(z), (d,), w1, EPS)  # noqa: E731
            nbytes = (3 * t * d + d) * 2
        else:
            xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
            want = torch.autograd.grad(ref.rmsnorm(xg, wg, EPS), (xg, wg), dy)
            if has_bwd:
                kernel = lambda: krms.rmsnorm_bwd_cuda(x, w, dy, EPS)  # noqa: E731
                what = "kernel"
            else:
                plain = ref.rmsnorm(xg, wg, EPS)
                def kernel():
                    return torch.autograd.grad(plain, (xg, wg), dy, retain_graph=True)
                what = "autograd of the plain version"
            got = kernel()
            err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
            # dw sums 512 rows in another order than autograd: 1e-2 of its largest magnitude.
            ok = (torch.allclose(got[0].float(), want[0].float(), **BF16_TOL)
                  and (got[1].float() - want[1].float()).abs().max().item()
                  <= 1e-2 * want[1].float().abs().max().item())
            xl, wl = x.clone().requires_grad_(), w1.clone().requires_grad_()
            lib_out = F.rms_norm(xl, (d,), wl, EPS)
            def lib():
                return torch.autograd.grad(lib_out, (xl, wl), dy, retain_graph=True)
            nbytes = (3 * t * d + 2 * d) * 2
        if not ok and not args.variant:
            raise AssertionError(f"{name} [{t}, {d}]: max |diff| {err:.3e} outside tolerance")
        bms, _ = timing.bound_ms(nbytes, 0.0, "bfloat16")
        mine = times(torch, kernel, flush, graph=kind != "bwd" or has_bwd)
        library = dict(library_ms=timing.time_ms(torch, lib, ITERS),
                       library_device_ms=timing.device_ms(torch, lib)[0])
        print(f"bench [{args.tag}] {name} [{t}, {d}] bf16 ({what}): max_abs_err={err:.3e} "
              f"({'within' if ok else 'OUTSIDE'}) {fmt(mine)} bound_ms={bms:.6f} (bytes) "
              f"{fmt(library)}", flush=True)


def gate_rows(torch, args, ktg, ref, gen, flush):
    for name, kind, t, e, k in GATE_ROWS:
        if args.rows not in name:
            continue
        logits = torch.randn((t, e), generator=gen, device="cuda")
        w, ids = ktg.topk_gating_cuda(logits, k)
        rw, ri = ref.topk_gating(logits, k)
        if kind == "fwd":
            kernel = lambda: ktg.topk_gating_cuda(logits, k)  # noqa: E731
            err = (w - rw).abs().max().item()
            ok = torch.equal(ids, ri) and torch.allclose(w, rw, **F32_TOL)
            lib = lambda: torch.topk(torch.softmax(logits, -1), k, dim=-1)  # noqa: E731
            nbytes = t * e * 4 + t * k * 8
        else:
            dwt = torch.randn((t, k), generator=gen, device="cuda")
            lg = logits.clone().requires_grad_()
            (want,) = torch.autograd.grad(ref.topk_gating(lg, k)[0], lg, dwt)
            kernel = lambda: ktg.topk_gating_bwd_cuda(logits, dwt, ids)  # noqa: E731
            err = (kernel() - want).abs().max().item()
            ok = torch.allclose(kernel(), want, **F32_TOL)
            lib = None
            nbytes = t * e * 8 + t * k * 8
        if not ok and not args.variant:
            raise AssertionError(f"{name} [{t}, {e}] k={k}: outside tolerance (err {err:.3e})")
        bms, _ = timing.bound_ms(nbytes, 0.0, "float32")
        mine = times(torch, kernel, flush)
        library = ({} if lib is None else
                   dict(library_ms=timing.time_ms(torch, lib, ITERS),
                        library_device_ms=timing.device_ms(torch, lib)[0]))
        print(f"bench [{args.tag}] {name} [{t}, {e}] f32 k={k}: max_abs_err={err:.3e} "
              f"({'within' if ok else 'OUTSIDE'}) {fmt(mine)} bound_ms={bms:.6f} (bytes) "
              f"{fmt(library)}", flush=True)


def tick_rows(torch, args):
    """Kernels launched by one pure decode tick, and the median host time of
    the pure decode ticks, of the Mamba-2 1.3B serve (48 layers) and the
    grok-1 serve (4 of 64 layers), with ``chip_smoke.py``'s engines and its
    8 chat requests, random weights from seed 0."""
    import dataclasses
    import gc
    import time

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    from repro_torch.parallel.sharding import make_plan
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.workload import WorkloadGenerator

    plan = make_plan(None)
    for name, layers, scfg in (
        ("mamba2-1.3b", None, dict(slots=4, max_len=256)),
        ("grok-1-314b", 4, dict(slots=4, max_len=256, page_size=16, num_devices=4,
                                reconfig_every=0)),
    ):
        cfg = get_config(name)
        cfg = cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)
        params = init_model(0, cfg, plan, device="cuda")
        gen = WorkloadGenerator("chat", seed=0, vocab_size=cfg.vocab_size)
        cap = max(1, min(12, scfg["max_len"] // 4))
        longest = scfg["max_len"] - cap - 2
        reqs = [dataclasses.replace(r, prompt_len=max(1, min(r.prompt_len, longest)),
                                    max_new_tokens=min(r.max_new_tokens, cap))
                for r in gen.generate(8)]
        eng = ServeEngine(params, cfg, plan, ServeConfig(**scfg), device="cuda")
        traced = timing.trace_decode_tick(torch, eng)
        step, ticks = eng.step, []

        def timed_step():
            untraced = traced["launches"] is not None
            t0 = time.perf_counter()
            st = step()
            if untraced and st.admitted == 0 and st.live > 0:
                ticks.append(1e3 * (time.perf_counter() - t0))
            return st

        eng.step = timed_step
        eng.run(reqs, gen)
        ticks.sort()
        print(f"bench [{args.tag}] {name} ({cfg.num_layers} layers) decode tick: "
              f"{traced['launches']} kernel launches, {traced['device_ms']} ms of device "
              f"time; host ms median {ticks[len(ticks) // 2]:.3f} over {len(ticks)} untraced "
              f"decode ticks", flush=True)
        del eng, params, step, timed_step
        gc.collect()
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(REPO / "src"))
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--variant", choices=sorted(VARIANTS))
    ap.add_argument("--rows", default="", help="time only the rows whose name holds this text")
    ap.add_argument("--ticks", action="store_true",
                    help="count the kernels of a Mamba-2 and a grok-1 decode tick instead")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_norm.py: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.kernels import topk_gating as ktg

    if args.variant:
        for source, mod in (("rmsnorm", krms), ("topk_gating", ktg)):
            subs = [s for s in VARIANTS[args.variant]
                    if s[0] in (f"{source}.cu", "common.cuh")]
            if subs:
                build._loaded[source] = timing.variant_library(build, source, mod._SIGNATURES, subs)
        args.tag += f" [{args.variant}]"
    card = timing.card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)
    scrub = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    flush = lambda: scrub.fill_(1)  # noqa: E731

    if args.ticks:
        tick_rows(torch, args)
        print(f"bench [{args.tag}] card: {card}", flush=True)
        return 0
    empty = timing.empty_kernel(torch, build)
    print(f"bench [{args.tag}] empty kernel (the launch floor): {fmt(times(torch, empty, flush))}",
          flush=True)
    norm_rows(torch, args, krms, ref, gen, flush)
    gate_rows(torch, args, ktg, ref, gen, flush)
    print(f"bench [{args.tag}] card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
