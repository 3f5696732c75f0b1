"""Training launcher.

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch grok-1-314b --reduced \
        --steps 20 --moe-backend mixnet --reconfig-every 4
    PYTHONPATH=src python -m repro_torch.launch.train --nproc 4 --device cpu --reduced ...

Port of :mod:`repro.launch.train`, with the same flags.  With more than one
rank the mesh is ``(world // model, model)`` over ``("data", "model")``,
``model`` the largest of 16, 8, 4, 2 that divides the world size (the
reference's factorization): the model axis runs the dense layers
tensor-parallel and the MoE layers expert-parallel, on either MoE backend
(``--moe-backend einsum`` or ``mixnet``); ``--nproc N`` spawns the N ranks itself (a
``tcp://localhost`` rendezvous on a free port), under ``torchrun`` each
process joins from the environment.  The backend is NCCL when every rank has
a card of its own and gloo when ranks share one or run on the CPU; rank 0
prints it, and the run's summary.  It runs on the card unless ``--device
cpu`` is given.  ``--ckpt-every N`` writes one global checkpoint every N
steps from all ranks; ``--resume`` restores the newest under ``--ckpt-dir``
and takes the data from the batch after its step, under the same or
another ``--nproc`` (the elastic case: the wire maps fold into the perm
stack).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import tempfile

import numpy as np

__all__ = ["main", "mesh_shape", "free_port"]


def mesh_shape(world: int) -> tuple[int, int]:
    """``(data, model)``: the largest model axis of 16, 8, 4, 2 dividing
    ``world`` (1 when none does)."""
    model = next((m for m in (16, 8, 4, 2) if world % m == 0), 1)
    return world // model, model


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parse(argv=None):
    from repro_torch.configs import ARCH_NAMES

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="grok-1-314b")
    ap.add_argument("--reduced", action="store_true", help="same-family smoke config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--data", default="", help="path for byte-level FileLM")
    ap.add_argument("--moe-backend", choices=("einsum", "mixnet"), default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--reconfig-every", type=int, default=0,
                    help="MixNet runtime reconfiguration cadence (0=off)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--nproc", type=int, default=0,
                    help="spawn this many ranks (0: one process, or torchrun's ranks)")
    return ap.parse_args(argv)


def run(args, rank: int | None = None, world: int | None = None,
        init_method: str | None = None) -> dict:
    """One rank of the launch (or the only process)."""
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data.pipeline import FileLM, SyntheticLM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import make_plan
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.moe_backend and cfg.is_moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, backend=args.moe_backend))
    world = int(os.environ.get("WORLD_SIZE", 1)) if world is None else world
    mesh, backend, device = None, None, args.device
    if world > 1:
        from repro_torch.launch.mesh import init_distributed, local_device, make_mesh

        rank, world, backend = init_distributed(
            rank=rank, world_size=world, init_method=init_method, device_type=args.device)
        device = local_device(rank, args.device)
        mesh = make_mesh(mesh_shape(world), ("data", "model"))
    plan = make_plan(mesh)  # ZeRO-3 over the data axis, as the reference's launcher
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps * 2, moment_dtype=cfg.opt_moment_dtype)
    tcfg = TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir or os.path.join(tempfile.gettempdir(), f"repro_ckpt_{cfg.name}"),
        reconfig_every=args.reconfig_every, num_microbatches=args.microbatches,
    )
    trainer = Trainer(cfg, opt, tcfg, plan, mesh=mesh, seed=args.seed, device=device)
    main_rank = trainer.is_main
    if args.resume and trainer.maybe_restore() and main_rank:
        print(f"resumed from step {trainer.step}")
    if args.data:
        data = FileLM(args.data, args.seq_len, args.batch, vocab_size=cfg.vocab_size)
    else:
        data = SyntheticLM(cfg.vocab_size, args.seq_len, args.batch, seed=args.seed)
    data = iter(data)
    for _ in range(trainer.step):  # a resumed run takes the batches after its step
        next(data)
    if main_rank:
        shape = None if mesh is None else tuple(mesh.mesh.shape)
        print(f"{cfg.name}: {cfg.param_count() / 1e6:.1f}M params on {world} rank(s), "
              f"mesh={shape}, backend={backend}, device={device}", flush=True)
    log = trainer.train(data)
    losses = [float(m["loss"]) for m in log]
    out = {"first": float(np.mean(losses[:3])), "last": float(np.mean(losses[-3:])),
           "reconfigs": trainer.reconfig_count, "wire_reconfigs": trainer.wire_reconfig_count}
    if main_rank:
        print(f"steps {trainer.step}: loss {out['first']:.3f} -> {out['last']:.3f}; "
              f"reconfigs={trainer.reconfig_count} (wire {trainer.wire_reconfig_count}); "
              f"stragglers={trainer.straggler_events}", flush=True)
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return out


def _spawned(rank: int, args, world: int, init_method: str) -> None:
    run(args, rank, world, init_method)


def main(argv=None):
    args = parse(argv)
    if args.nproc > 1:
        import torch.multiprocessing as mp

        mp.spawn(_spawned, args=(args, args.nproc, f"tcp://localhost:{free_port()}"),
                 nprocs=args.nproc, join=True)
        return None
    return run(args)


if __name__ == "__main__":
    main()
