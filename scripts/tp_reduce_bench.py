"""Times the ways a tensor-parallel sum over the model axis can run: four
ranks over gloo, every rank on the same card, as ``chip_smoke.py``'s
multi-rank phases run them.

Each rank holds an f32 partial ``[M, N]`` (a row-parallel product's) and
the ranks need its sum over the axis, cast to bf16 once, the same bits on
every rank.  The variants:

* ``gather``: all-gather every rank's f32 partial, sum the tree in rank
  order on every rank, cast;
* ``a2a_split`` / ``a2a``: an all-to-all of f32 shares (with split sizes /
  without), the tree of one share on each rank, cast, all-gather the bf16
  sums (``a2a_f32``: all-gather them in f32 and cast after);
* ``all_reduce``: gloo's f32 all-reduce, then cast (its order is gloo's,
  so its bits are not the tree's).

Prints one line ``tp_reduce {json}`` per shape and variant from rank 0: the
median and the 10th and 90th percentiles of the host's clock per sum, and
whether the result equals ``gather``'s bits on every rank.

    python scripts/tp_reduce_bench.py [--iters 20]

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import time

RANKS = 4
# (M, N): gemma2-2b's and Mixtral's training partials (2 x 256 tokens), a
# decode tick's of grok-1 and gemma2-2b (4 slots).
SHAPES = ((512, 2304), (512, 4096), (4, 6144), (4, 2304))


def _tree(parts):
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] if i + 1 < len(parts) else parts[i]
                 for i in range(0, len(parts), 2)]
    return parts[0]


def variants(torch, dist):
    p = RANKS

    def gather(x):
        out = torch.empty((p, *x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x[None].contiguous())
        return _tree(list(out.unbind(0))).to(torch.bfloat16)

    def a2a(x, split: bool, gather_dtype):
        flat = x.reshape(-1)
        c = flat.numel() // p
        mine = torch.empty_like(flat)
        if split:
            dist.all_to_all_single(mine, flat, [c] * p, [c] * p)
        else:
            dist.all_to_all_single(mine, flat)
        share = _tree(list(mine.view(p, c).unbind(0))).to(gather_dtype)
        out = torch.empty((p * c,), dtype=gather_dtype, device=x.device)
        dist.all_gather_into_tensor(out, share)
        return out.view(x.shape).to(torch.bfloat16)

    def all_reduce(x):
        y = x.clone()
        dist.all_reduce(y)
        return y.to(torch.bfloat16)

    return {
        "gather": gather,
        "a2a_split": lambda x: a2a(x, True, torch.bfloat16),
        "a2a": lambda x: a2a(x, False, torch.bfloat16),
        "a2a_f32": lambda x: a2a(x, False, torch.float32),
        "all_reduce": all_reduce,
    }


def rank_main(rank: int, port: int, iters: int) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=RANKS)
    g = torch.Generator(device="cuda").manual_seed(rank)
    for m, n in SHAPES:
        x = torch.randn((m, n), generator=g, device="cuda")
        want = None
        for name, fn in variants(torch, dist).items():
            got = fn(x)
            if want is None:
                want = got
            same = torch.equal(got.view(torch.int16), want.view(torch.int16))
            flags = torch.tensor([int(same)])
            dist.all_reduce(flags)  # every rank's verdict
            ms = []
            for _ in range(iters + 3):
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                fn(x)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
            ms = sorted(ms[3:])
            if rank == 0:
                print("tp_reduce " + json.dumps(dict(
                    shape=[m, n], variant=name, median_ms=ms[len(ms) // 2],
                    p10_ms=ms[len(ms) // 10], p90_ms=ms[(9 * len(ms)) // 10],
                    bits_equal_gather_all_ranks=int(flags) == RANKS)), flush=True)
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("tp_reduce_bench.py: no CUDA device available", file=sys.stderr)
        return 2
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; {RANKS} ranks over gloo on one card", flush=True)
    mp.spawn(rank_main, args=(port, args.iters), nprocs=RANKS, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
