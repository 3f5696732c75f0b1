"""One-device training step times of the port on the card, and where the
device time goes.

Trains Mixtral-8x7B at full width and 2 of its 32 layers (the mixnet
backend, dropless) and gemma2-2b at full width and all 26 layers, each a few
steps of 2 x 256 tokens through ``Trainer`` from a seed, as ``chip_smoke.py``'s
one-device training phases do, and prints each model's median step (the
trainer's clock, the first step left out) and, with ``--profile``, the device
time of one more step by kernel.  ``gemma2_serve`` serves gemma2-2b (all 26
layers, paged, 4 slots) the 8 chat requests ``chip_smoke.py`` serves and
prints the median pure decode tick (the host's clock).  ``--src`` points at
another checkout's ``src`` directory, so two versions of the package are
timed by the same code:

    python scripts/one_device_step.py                      # this checkout
    python scripts/one_device_step.py --src OTHER/src --label parent

Each model prints one line ``one_device_step {json}``.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _class(name: str) -> str:
    low = name.lower()
    if any(w in low for w in ("topk_gating", "flash_fwd", "flash_bwd", "vector_gather_kernel",
                              "combine", "gmm_", "rmsnorm")):
        return "ported kernels"
    if any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass", "cublas", "sm90_")):
        return "matmul (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if "reduce" in low:
        return "reductions"
    return "other PyTorch kernels"


def profile_step(torch, tr, data) -> dict:
    """Device time of one training step by kernel and by class."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tr.tcfg.total_steps = tr.step + 1
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.train(data)
        torch.cuda.synchronize()
    kernels, classes = [], {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        classes[_class(ev.key)] = classes.get(_class(ev.key), 0.0) + ms
        kernels.append((ms, ev.count, ev.key[:100]))
    kernels.sort(reverse=True)
    return dict(device_ms=sum(classes.values()), launches=sum(n for _, n, _ in kernels),
                classes=classes, top=[dict(ms=ms, count=n, name=k) for ms, n, k in kernels[:25]])


def run(torch, name: str, cfg, seed: int, steps: int, profile: bool, label: str) -> dict:
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import make_plan
    from repro_torch.train.trainer import Trainer, TrainerConfig

    seq, batch = 256, 2
    tr = Trainer(cfg, AdamWConfig(warmup_steps=2, total_steps=steps),
                 TrainerConfig(total_steps=steps), make_plan(None), seed=seed, device="cuda")
    data = iter(SyntheticLM(cfg.vocab_size, seq_len=seq, global_batch=batch, seed=seed))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr.train(data)
    torch.cuda.synchronize()
    step_ms = [1e3 * m["step_time_s"] for m in tr.metrics_log]
    later = sorted(step_ms[1:])
    out = dict(label=label, model=name, layers=cfg.num_layers, tokens=batch * seq,
               median_ms=later[len(later) // 2], step_ms=step_ms,
               losses=[float(m["loss"]) for m in tr.metrics_log],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, card=card())
    if profile:
        out["profile"] = profile_step(torch, tr, data)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_ticks(torch, cfg, seed: int, label: str) -> dict:
    from repro_torch.models.transformer import init_model
    from repro_torch.parallel.sharding import make_plan
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.workload import WorkloadGenerator

    max_len, out_cap = 256, 12
    params = init_model(seed, cfg, make_plan(None), device="cuda")
    gen = WorkloadGenerator("chat", seed=seed, vocab_size=cfg.vocab_size)
    reqs = [dataclasses.replace(r, prompt_len=max(1, min(r.prompt_len, max_len - out_cap - 2)),
                                max_new_tokens=min(r.max_new_tokens, out_cap))
            for r in gen.generate(8)]
    eng = ServeEngine(params, cfg, make_plan(None),
                      ServeConfig(slots=4, max_len=max_len, page_size=16), device="cuda")
    ticks, step = [], eng.step

    def timed():
        t0 = time.perf_counter()
        st = step()
        ticks.append((1e3 * (time.perf_counter() - t0), st.admitted == 0 and st.live > 0))
        return st

    eng.step = timed
    rep = eng.run(reqs, gen)
    decode = sorted(ms for ms, pure in ticks if pure)
    out = dict(label=label, model="gemma2_serve", layers=cfg.num_layers, ticks=rep.ticks,
               decode_ticks=len(decode), median_ms=decode[len(decode) // 2],
               tokens=sorted((r.rid, list(r.out)) for r in eng.batcher.finished), card=card())
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(REPO / "src"), help="the package's source directory")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--models", default="mixtral,gemma2,gemma2_serve")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true", help="also trace one more step")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("one_device_step.py: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.configs.paper_models import MIXTRAL_8X7B_CONFIG
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s from {args.src}", flush=True)
    cfgs = {"mixtral": dataclasses.replace(MIXTRAL_8X7B_CONFIG, num_layers=2),
            "gemma2": get_config("gemma2-2b")}
    for name in args.models.split(","):
        if name == "gemma2_serve":
            res = serve_ticks(torch, cfgs["gemma2"], args.seed, args.label)
        else:
            res = run(torch, name, cfgs[name], args.seed, args.steps, args.profile, args.label)
        print("one_device_step " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
