"""Quickstart: train a small MoE LM end to end with the MixNet runtime —
the mixnet expert dispatch, traffic monitoring, COPILOT fitting and runtime
expert re-placement — through the port's ``Trainer``.

    PYTHONPATH=src python -m repro_torch.quickstart [--steps 40] [--device cuda|cpu]

The counterpart of ``examples/quickstart.py``, with the same widths and
parameter count but 2 query / 1 kv heads of 64 in place of 4 / 2 of 32: the
port's attention kernels take head dims 64, 128 and 256.  It runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.sharding import make_plan
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = ModelConfig(
        name="quickstart-moe",
        family="moe",
        num_layers=4,
        d_model=128,
        num_heads=2,
        num_kv_heads=1,
        d_ff=0,
        vocab_size=512,
        dtype="float32",
        remat="none",
        moe=MoEConfig(num_experts=8, top_k=2, d_ff=256, capacity_factor=2.0, backend="mixnet"),
    )
    opt = AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps * 2)
    tcfg = TrainerConfig(
        total_steps=args.steps,
        log_every=5,
        reconfig_every=8,  # the MixNet runtime reconfiguration cadence
        reconfig_min_gain=0.02,
        ckpt_every=0,
    )
    trainer = Trainer(cfg, opt, tcfg, make_plan(None), seed=0, device=args.device)
    data = SyntheticLM(cfg.vocab_size, seq_len=64, global_batch=8, seed=0)

    print(f"training {cfg.name} ({cfg.param_count() / 1e6:.1f}M params, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, "
          f"dispatch={cfg.moe.backend}) on {trainer.device}")
    log = trainer.train(iter(data))
    for m in log:
        if m["step"] % tcfg.log_every == 0 or m["step"] == 1:
            print(f"step {m['step']:4d}  loss {float(m['loss']):.3f}  "
                  f"balance {float(m['balance_loss']):.3f}  "
                  f"gnorm {float(m['grad_norm']):.2f}  "
                  f"{m['step_time_s'] * 1e3:.0f} ms")
    first = np.mean([float(m["loss"]) for m in log[:5]])
    last = np.mean([float(m["loss"]) for m in log[-5:]])
    print(f"\nloss {first:.3f} -> {last:.3f}  "
          f"(runtime reconfigurations: {trainer.reconfig_count}, "
          f"straggler events: {trainer.straggler_events})")
    return {"first": float(first), "last": float(last), "steps": len(log)}


if __name__ == "__main__":
    main()
