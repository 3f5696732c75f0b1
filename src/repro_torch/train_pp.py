"""Pipeline-parallel MoE training: PP(S) stages x EP(P) expert parallelism,
one process per rank, with a live reconfiguration (a per-layer
expert->slot permutation plus a rotate-by-one wire re-address) flowing
through the stage pipe from step 2 on.

    PYTHONPATH=src python -m repro_torch.train_pp [--steps 4] [--stages 2] [--ep 4] [--device cpu]
        [--ckpt-every N --ckpt-dir DIR] [--resume]

Port of ``examples/train_pp.py``.  It spawns ``stages * ep`` ranks (gloo, a
free ``tcp://localhost`` port).  Each step's loss, and the final
parameters, are checked against the flat EP(P) train step on the same
batch within ``1e-5``: the pipelined composition is a scheduling change,
not a math change.  The flat steps run on the same ranks, over a
``("rep", "model")`` mesh whose first axis the plan ignores.  Without
``--device cpu`` the ranks share the card.  ``--ckpt-every N`` writes the
pipelined state as one global checkpoint every N steps; ``--resume``
restores the newest into the pipelined ranks AND into the flat run (the
canonical layout restores under either mesh) and goes on from its step.
"""

from __future__ import annotations

import argparse

import numpy as np

__all__ = ["main", "batch_for", "plan_for_step"]

B, T = 4, 16
MICROBATCHES = 2
TOL = 1e-5


def _config():
    from repro_torch.models.config import ModelConfig, MoEConfig

    return ModelConfig(
        name="pp-demo-moe", family="moe", num_layers=4, d_model=32, num_heads=3,
        num_kv_heads=1, d_ff=0, vocab_size=64, head_dim=8, dtype="float32", remat="none",
        moe=MoEConfig(num_experts=4, top_k=2, d_ff=32, capacity_factor=2.0, backend="mixnet",
                      overlap_chunks=2),
    )


def batch_for(step: int, vocab: int) -> dict:
    tok = np.random.default_rng(step).integers(0, vocab, (B, T)).astype(np.int32)
    return {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}


def plan_for_step(step: int, cfg, ep: int):
    """The toy control plane of the example: from step 2 on, a per-layer
    expert->slot permutation and a rotate-by-one wire map."""
    from repro_torch.parallel.sharding import virtual_experts

    if step < 2:
        return None, None
    reps = cfg.pattern_repeats
    ev, _ = virtual_experts(cfg.moe.num_experts, ep)
    rng = np.random.RandomState(step)
    perm = np.stack([rng.permutation(ev) for _ in range(reps)]).astype(np.int32)
    wire = np.stack([np.roll(np.arange(ep), li % ep) for li in range(reps)]).astype(np.int32)
    return perm, wire


def _flat_params(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_params(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def _rank(rank: int, args, init_method: str) -> None:
    import torch

    from repro_torch.launch.mesh import init_distributed, local_device, make_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import TreeLayout, make_plan, stage_layers
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.pp_step import local_microbatch_rows, make_pp_train_step
    from repro_torch.train.train_step import init_all, make_train_step

    if args.device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
    world = args.stages * args.ep
    init_distributed(rank=rank, world_size=world, init_method=init_method,
                     device_type=args.device)
    device = local_device(rank, args.device)
    cfg = _config()
    opt = AdamWConfig(lr=1e-3)
    pp_mesh = make_mesh((args.stages, args.ep), ("stage", "model"))
    ref_mesh = make_mesh((args.stages, args.ep), ("rep", "model"))
    pp_plan, ref_plan = make_plan(pp_mesh, fsdp=False), make_plan(ref_mesh, fsdp=False)
    params, _, opt_state = init_all(0, cfg, pp_plan, opt, device=device, mesh=pp_mesh)
    ref_params, _, ref_opt = init_all(0, cfg, ref_plan, opt, device=device, mesh=ref_mesh)
    pp_step = make_pp_train_step(cfg, pp_plan, opt, pp_mesh, pp_stages=args.stages,
                                 microbatches=MICROBATCHES)
    ref_step = make_train_step(cfg, ref_plan, opt, mesh=ref_mesh, microbatches=MICROBATCHES)
    main = rank == 0
    if main:
        print(f"== PP(S={args.stages}) x EP({args.ep}) on {world} ranks ({args.device}), "
              f"microbatches={MICROBATCHES}, vs the flat EP({args.ep}) step ==", flush=True)
    tensor = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    pp_layout = TreeLayout(pp_plan, pp_mesh, cfg)
    ref_layout = TreeLayout(ref_plan, ref_mesh, cfg)
    start = 0
    last = ckpt.latest_step(args.ckpt_dir) if args.resume and args.ckpt_dir else None
    if last is not None:
        ckpt.restore(args.ckpt_dir, last, {"params": params, "opt": opt_state}, layout=pp_layout)
        ckpt.restore(args.ckpt_dir, last, {"params": ref_params, "opt": ref_opt},
                     layout=ref_layout)
        start = last
        if main:
            nbytes, sec = ckpt.last_io["restore"]
            print(f"resumed from step {last} ({nbytes / 1e6:.2f} MB read a rank in {sec:.2f} s) "
                  "into the pipelined and the flat run", flush=True)
    for step in range(start, args.steps):
        batch = batch_for(step, cfg.vocab_size)
        perm, wire = plan_for_step(step, cfg, args.ep)
        tperm = None if perm is None else tensor(perm)
        pp_batch = {k: tensor(local_microbatch_rows(v, pp_plan, pp_mesh, MICROBATCHES))
                    for k, v in batch.items()}
        params, opt_state, m = pp_step(params, opt_state, pp_batch, tperm, wire)
        ref_params, ref_opt, rm = ref_step(ref_params, ref_opt,
                                           {k: tensor(v) for k, v in batch.items()}, tperm,
                                           wire)
        loss, ref_loss = float(m["loss"]), float(rm["loss"])
        np.testing.assert_allclose(loss, ref_loss, rtol=TOL)
        if main:
            tag = "  [reconfigured: perm+wire applied]" if perm is not None else ""
            print(f"step {step}: pp_loss={loss:.6f}  ref_loss={ref_loss:.6f}{tag}", flush=True)
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1, {"params": params, "opt": opt_state},
                      layout=pp_layout)
    # The whole trajectories agree, not just the scalar losses: this rank's
    # stage of every parameter against the flat run's.
    _, _, lo, hi = stage_layers(pp_mesh, cfg.pattern_repeats)
    ref = dict(_flat_params(ref_params))
    for path, leaf in _flat_params(params):
        want = ref[path][lo:hi] if path.startswith("/blocks/") else ref[path]
        np.testing.assert_allclose(leaf.detach().cpu().numpy(), want.detach().cpu().numpy(),
                                   rtol=TOL, atol=TOL, err_msg=path)
    torch.distributed.barrier()
    if main:
        print(f"PARITY_OK: {args.steps} steps, params match to {TOL} across a live "
              "reconfiguration", flush=True)
    torch.distributed.destroy_process_group()


def main(argv=None) -> None:
    import torch.multiprocessing as mp

    from repro_torch.launch.train import free_port

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--ep", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)
    if (args.ckpt_every or args.resume) and not args.ckpt_dir:
        ap.error("--ckpt-every and --resume need --ckpt-dir")
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")
    mp.spawn(_rank, args=(args, f"tcp://localhost:{free_port()}"),
             nprocs=args.stages * args.ep, join=True)


if __name__ == "__main__":
    main()
