#!/usr/bin/env python3
"""Time a paged admission of grok-1 at its published widths on one CUDA
card: the time to first token of one prompt, on a miss and on a
prefix-cache hit.

    python3 src/repro_torch/kernels/bench_admit.py [--src DIR] [--tag NAME] [--layers 2]

Run it as a file: ``--src`` is the ``src`` directory whose ``repro_torch``
is timed (default: this checkout's), so one call can time two trees in
turns (parent, change, change, parent).

grok-1 at its published widths, ``--layers`` of 64 (2: the depth of
``chip_smoke.py``'s fleet phase), random bf16 weights from seed 0, an
engine of ``ServeConfig(slots=4, max_len=256, page_size=16)``.  A miss:
a prompt of 36, 100, 180 or 244 tokens admitted into a fresh engine.  A
hit: a prompt of 100 or 244 tokens whose first 64 tokens (4 pages) an
earlier prompt left in the prefix cache.  Each case is timed 5 times
after one warm-up (host clock around the admission, which ends in a host
read of the first token, between two synchronizes), with the kernels the
admission launched; then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[3]
# Run as a file, this directory comes first on the path: its module names
# (build, ops, ref, ...) must not shadow anything.
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == pathlib.Path(__file__).resolve().parent:
    sys.path.pop(0)
_spec = importlib.util.spec_from_file_location(
    "_repro_kernel_timing", pathlib.Path(__file__).with_name("timing.py"))
timing = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(timing)

PREFIX = 64
MISS_LENS = (36, 100, 180, 244)
HIT_LENS = (100, 244)
REPEATS = 5


def admit_ms(torch, params, cfg, plan, prompt, warm_prompt=None) -> tuple[float, dict]:
    """One admission of ``prompt`` into a fresh engine (after admitting
    ``warm_prompt`` first, when given): host ms, and the kernels it
    launched."""
    from repro_torch.kernels import ops
    from repro_torch.serve.batching import Request
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    eng = ServeEngine(params, cfg, plan, ServeConfig(slots=4, max_len=256, page_size=16),
                      device="cuda")
    b = eng.batcher
    if warm_prompt is not None:
        b.submit(Request(rid=0, prompt=warm_prompt, max_new_tokens=4))
        b._admit()
    hits = b.alloc.prefix_hit_pages
    b.submit(Request(rid=1, prompt=prompt, max_new_tokens=4))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    b._admit()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    want = PREFIX // 16 if warm_prompt is not None else 0
    assert b.alloc.prefix_hit_pages - hits == want, "the admission did not hit as planned"
    return ms, {k: v for k, v in ops.launch_counts().items() if v}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(REPO / "src"))
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--layers", type=int, default=2)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_admit.py: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_model
    from repro_torch.parallel.sharding import make_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    card = timing.card_line()
    plan = make_plan(None)
    cfg = dataclasses.replace(get_config("grok-1-314b"), num_layers=args.layers)
    params = init_model(0, cfg, plan, device="cuda")
    rng = np.random.default_rng(0)
    draw = lambda n: rng.integers(1, cfg.vocab_size - 1, size=n).astype(np.int32)  # noqa: E731
    prefix = draw(PREFIX)
    cases = [(f"miss, prompt {n}", draw(n), None) for n in MISS_LENS]
    cases += [(f"hit on {PREFIX // 16} pages, prompt {n}",
               np.concatenate([prefix, draw(n - PREFIX)]),
               np.concatenate([prefix, draw(n - PREFIX)])) for n in HIT_LENS]
    admit_ms(torch, params, cfg, plan, cases[0][1])  # warm-up: builds, cuBLAS handles
    for name, prompt, warm in cases:
        admit_ms(torch, params, cfg, plan, prompt, warm)
        runs = [admit_ms(torch, params, cfg, plan, prompt, warm) for _ in range(REPEATS)]
        ms = sorted(r[0] for r in runs)
        print(f"bench [{args.tag}] grok-1 ({args.layers} layers) admission, {name}: "
              f"ms median {ms[len(ms) // 2]:.3f} (min {ms[0]:.3f}, max {ms[-1]:.3f}, "
              f"n={len(ms)}); kernels {runs[-1][1]}", flush=True)
    print(f"bench [{args.tag}] card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
