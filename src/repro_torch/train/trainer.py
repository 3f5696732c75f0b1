"""Training loop wiring the port together:

  data -> train_step -> MoE telemetry -> MixNet control plane
  (observe -> end_step (COPILOT refit) -> plan -> apply)
  -> checkpoint/restart -> straggler watchdog.

Port of :mod:`repro.train.trainer`.  Every ``reconfig_every`` steps the
trainer asks the shared :class:`ControlPlane` for per-layer placement plans
and, for layers whose gain clears the cost, moves that layer's stacked
expert weights into their new slots IN PLACE (``torch.no_grad``) and hands
the router the new per-layer slot map.

The reference permutes the parameters only (``trainer.py:256``): the AdamW
moments stay in their slots, so after a reconfiguration a slot's moments
belong to the expert that sat there before.  The port does the same on
purpose, so that it can be held against the reference step for step.

Checkpoints (:mod:`repro_torch.train.checkpoint`) carry the parameters,
the AdamW state and, in ``extra``, the placement state; ``maybe_restore``
copies them into the trainer's own tensors.  Over a mesh (flat or
pipelined) every rank takes part in one global checkpoint, the canonical
``[repeats, ...]`` arrays of one device, so it restores under any mesh or
on one rank: at the saved model size the placement restores as saved
(checked equal on every rank), at another the wire maps are folded into the
perm stack (``PlacementApplier.load_state_dict``).  As in the reference,
the ``dp_compress`` error-feedback residual is not checkpointed: the tree is
the parameters and the AdamW state.

Over a ``("data", "model")`` mesh (``Trainer(mesh=)``, one process per
rank): each rank takes its data-axis slice of the global batch, holds its
model-axis shard of the expert slots, and runs the step of
:mod:`repro_torch.train.train_step`.  Every rank computes the same plans
from the same reduced loads (checked after each reconfiguration: an
all-gather of a hash of the slot maps and wire perms).  A plan that moves
whole device blocks is installed as a wire re-address (no weight moves);
any other moves the expert slots across ranks.  ``dp_comm="runtime"`` and
``dp_compress`` run on a data-only mesh, the trainer carrying the
error-feedback residual.

Pipeline stages (``pp_stages > 1``, a mesh with a ``"stage"`` axis): each
rank holds its stage's repeats and runs the GPipe step of
:mod:`repro_torch.train.pp_step` over ``num_microbatches``.  Every rank
keeps the whole perm stack and wire maps and observes the canonical
``[repeats, E]`` loads, so every rank plans alike; a plan moves weights,
or re-addresses the wire, only in the stage that owns its layer.

The cached autotuner (:mod:`repro_torch.core.autotune`): with
``autotune_cache`` and ``autotune_key`` set, a hit replaces the constant
comm knobs (``overlap_chunks`` and the dispatch mode, ``dp_compress`` where
the mesh runs it) before the model is built; a miss prints a one-line
warning, bumps ``autotune.cache_miss`` and keeps the configured constants.

A model axis is tensor parallelism for the dense leaves and expert
parallelism for the MoE layers (:class:`~repro_torch.parallel.sharding.TreeLayout`),
on every MoE backend, and with ``cfg.sp_shardmap`` sequence parallelism for
the residual stream.  A plan with ``fsdp_axis`` (``make_plan(mesh)``, the
reference's default) is ZeRO-3: each rank holds its data shard of the
parameters and of the AdamW moments, the steps gather them
(:mod:`repro_torch.parallel.fsdp`), a weight move exchanges each data
coordinate's shards within its model group, and checkpoints hold the
global arrays as they do without it.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import commruntime as cr
from repro_torch.core.controlplane import (
    ControlPlane,
    LayerPlan,
    PlacementApplier,
    permute_expert_weights,
)
from repro_torch.obs import metrics, trace
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.sharding import (
    ShardingPlan,
    TreeLayout,
    stage_layers,
    virtual_experts,
)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.pp_step import local_microbatch_rows, make_pp_train_step
from repro_torch.train.train_step import init_all, init_ef_residual, make_train_step

__all__ = ["TrainerConfig", "Trainer", "permute_expert_weights"]


def _moved(placement: dict) -> bool:
    """True when a saved placement state moves any expert (a slot map or a
    wire map other than the identity)."""
    perms = np.asarray(placement["controlplane"]["layer_perms"])
    wire = placement.get("wire_perm")
    return bool((perms != np.arange(perms.shape[-1])).any()
                or (wire is not None and (np.asarray(wire) != np.arange(len(wire[0]))).any()))


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0  # 0 = disabled
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    ckpt_keep: int = 3
    ckpt_async: bool = True
    # MixNet runtime reconfiguration
    reconfig_every: int = 0  # 0 = disabled (paper-faithful needs >0)
    reconfig_min_gain: float = 0.05
    dp_comm: str = "auto"
    dp_compress: bool = False
    pp_stages: int = 1
    num_microbatches: int = 1
    # Cached autotuner: a cache file written by autotune.tune (either
    # package's) and the key to look up in it; see the module docstring.
    autotune_cache: str = ""
    autotune_key: str = ""
    # Straggler watchdog: warn when a step exceeds ema * factor.
    straggler_factor: float = 3.0


class Trainer:
    def __init__(
        self,
        cfg,
        opt_cfg: AdamWConfig,
        tcfg: TrainerConfig,
        plan: ShardingPlan,
        *,
        mesh=None,
        seed: int = 0,
        device=None,
    ):
        if tcfg.pp_stages > 1 and (tcfg.dp_comm != "auto" or tcfg.dp_compress):
            raise ValueError(
                "pp_stages > 1 composes with dp_comm='auto' only (the runtime DP reduction "
                "needs a DP-only mesh)"
            )
        if tcfg.autotune_cache and tcfg.autotune_key:
            from repro_torch.core import autotune

            tuned = autotune.load_cached(tcfg.autotune_cache, tcfg.autotune_key)
            if tuned is not None:
                cfg, tcfg = autotune.apply_to_trainer(cfg, tcfg, tuned)
            else:
                metrics.counter("autotune.cache_miss").inc()
                print(
                    f"[trainer] autotune cache miss: key {tcfg.autotune_key!r} "
                    f"not in {tcfg.autotune_cache} — using configured constants"
                )
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.plan = plan
        self.mesh = mesh
        self.device = resolve_device(device)
        self.params, self.specs, self.opt_state = init_all(
            seed, cfg, plan, opt_cfg, device=self.device, mesh=mesh
        )
        if tcfg.pp_stages > 1:
            self.step_fn = make_pp_train_step(cfg, plan, opt_cfg, mesh, pp_stages=tcfg.pp_stages,
                                              microbatches=tcfg.num_microbatches)
        else:
            self.step_fn = make_train_step(
                cfg, plan, opt_cfg, mesh=mesh, microbatches=tcfg.num_microbatches,
                dp_comm=tcfg.dp_comm, dp_compress=tcfg.dp_compress,
            )
        self.ef_residual = init_ef_residual(self.params, plan) if tcfg.dp_compress else None
        self.step = 0
        self.metrics_log: list[dict] = []
        self._ema_step_time: float | None = None
        self.straggler_events = 0
        self._tr = trace.default()
        self._tid: int | None = None
        _m = metrics.default()
        self._m_steps = _m.counter("train.steps")
        self._m_tokens = _m.counter("train.tokens")
        self._m_stragglers = _m.counter("train.stragglers")
        self._m_step_time = _m.histogram("train.step_time_s")

        # MixNet control plane (only meaningful for MoE archs).
        self.controlplane: ControlPlane | None = None
        self._applier: PlacementApplier | None = None
        self.expert_perm = None
        if cfg.is_moe and tcfg.reconfig_every:
            _, r = virtual_experts(cfg.moe.num_experts, plan.model_size)
            self.controlplane = ControlPlane(
                num_layers=cfg.pattern_repeats,
                num_experts=cfg.moe.num_experts,
                num_devices=max(plan.model_size, 1),
                replication=r,
                min_gain_fraction=tcfg.reconfig_min_gain,
            )
            self._applier = self._new_applier()
            self.expert_perm = self.controlplane.perm_stack()
        self.reconfig_count = 0

    @property
    def wire_perm(self) -> np.ndarray | None:
        return self._applier.wire_perm if self._applier is not None else None

    @property
    def wire_reconfig_count(self) -> int:
        return self._applier.wire_reconfig_count if self._applier is not None else 0

    # -- checkpoint/restart ---------------------------------------------------
    def _bound_applier(self) -> PlacementApplier:
        """The applier of the current control plane (rebound when the engine
        was swapped after construction: tests and the smoke run inject a
        multi-device ControlPlane directly)."""
        if self._applier is None or self._applier.cp is not self.controlplane:
            self._applier = self._new_applier()
        return self._applier

    def _new_applier(self) -> PlacementApplier:
        _, _, lo, hi = stage_layers(self.mesh, self.cfg.pattern_repeats)
        return PlacementApplier(self.controlplane, model_size=max(self.plan.model_size, 1),
                                mesh=self.mesh, axis=self.plan.model_axis, layers=(lo, hi))

    @property
    def is_main(self) -> bool:
        """True on the rank that logs (rank 0, or the only process)."""
        import torch.distributed as dist

        return self.mesh is None or not dist.is_initialized() or dist.get_rank() == 0

    def _layout(self) -> TreeLayout:
        return TreeLayout(self.plan, self.mesh, self.cfg)

    def maybe_restore(self) -> bool:
        """Restore the newest checkpoint under ``ckpt_dir`` into this
        trainer's tensors (in place), with its placement state; over a mesh
        every rank calls it."""
        last = ckpt.latest_step(self.tcfg.ckpt_dir)
        if last is None:
            return False
        extra = ckpt.load_extra(self.tcfg.ckpt_dir, last)
        placement = extra.get("placement")
        if self.controlplane is None and placement is not None and _moved(placement):
            raise ValueError(
                f"the checkpoint at step {last} holds a moved expert placement; build the "
                "trainer with reconfig_every > 0 so that it carries one")
        folded = False
        if self.controlplane is not None and placement is not None:
            # Placement first: a restore that would change the number of
            # virtual experts raises before any tensor is touched.
            folded = self._bound_applier().load_state_dict(placement)
            self.expert_perm = self.controlplane.perm_stack()
            self.reconfig_count = self.controlplane.reconfig_count
        ckpt.restore(self.tcfg.ckpt_dir, last, {"params": self.params, "opt": self.opt_state},
                     layout=self._layout())
        if self.mesh is not None and self.controlplane is not None:
            self._check_plans_agree()
        if self.is_main:
            nbytes, sec = ckpt.last_io["restore"]
            print(f"[trainer] restored step {last}: {nbytes / 1e9:.3f} GB read in {sec:.1f} s "
                  f"({nbytes / 1e9 / max(sec, 1e-9):.3f} GB/s) by each rank", flush=True)
            if folded:
                print(f"[trainer] placement saved at another model size restored at "
                      f"{max(self.plan.model_size, 1)}: wire maps folded into the perm stack, "
                      "region statistics start fresh", flush=True)
        self.step = last
        return True

    def _checkpoint(self):
        tree = {"params": self.params, "opt": self.opt_state}
        extra = (
            {"placement": self._bound_applier().state_dict()}
            if self.controlplane is not None else None
        )
        save = ckpt.save_async if self.tcfg.ckpt_async else ckpt.save
        save(self.tcfg.ckpt_dir, self.step, tree, keep=self.tcfg.ckpt_keep, extra=extra,
             layout=self._layout())

    # -- observability ---------------------------------------------------------
    def _track_id(self) -> int:
        if self._tid is None:
            self._tid = self._tr.track("trainer")
        return self._tid

    # -- MixNet reconfiguration ------------------------------------------------
    def _wire_capable(self) -> bool:
        """Wire re-addressing needs the mixnet data plane and a control-plane
        device space that IS the model axis (one slot block per device)."""
        cp = self.controlplane
        p = max(self.plan.model_size, 1)
        return (
            self.cfg.moe is not None
            and self.cfg.moe.backend == "mixnet"
            and p > 1
            and cp is not None
            and cp.num_devices == p
        )

    def _check_plans_agree(self) -> None:
        """Every rank must hold the same placement state (slot maps, wire
        perms, counts and region statistics), after a reconfiguration or a
        restore: an all-gather of its hash, raising on disagreement."""
        import hashlib
        import json

        state = self._bound_applier().state_dict()
        h = hashlib.sha256(json.dumps(state, sort_keys=True).encode())
        got = cr.all_gather_objects(h.hexdigest())
        if len(set(got)) != 1:
            raise RuntimeError(f"ranks disagree on the placement state: {got}")

    def _apply_layer_plans(self, plans: list[LayerPlan]) -> bool:
        """Actuate per-layer placement plans through the shared
        :class:`PlacementApplier` (wire re-address for whole-device-block
        plans, the expert weights moved in place otherwise)."""
        ap = self._bound_applier()
        # Re-evaluated per call: tests toggle _wire_capable on the instance.
        ap.wire_capable = self._wire_capable()
        tid = self._track_id() if self._tr.enabled else None
        with self._tr.span("train.reconfig", tid=tid, cat="reconfig", step=self.step) as sp:
            with torch.no_grad():
                self.params, changed = ap.apply(self.params, plans)
            sp.set(applied=bool(changed), plans=sum(1 for p in plans if p.reconfigure))
        if changed:
            self.expert_perm = self.controlplane.perm_stack()
            self.reconfig_count = self.controlplane.reconfig_count
        if self.mesh is not None:
            self._check_plans_agree()
        return changed

    def _reconfigure_step(self, expert_load: np.ndarray):
        """One step of the Fig 20 loop.  ``expert_load``: ``[repeats, E]``
        realized loads from the last step."""
        cp = self.controlplane
        for layer in range(expert_load.shape[0]):
            cp.observe(layer, expert_load[layer])
        cp.end_step()
        if self.step % self.tcfg.reconfig_every:
            return
        self._apply_layer_plans([cp.plan(layer) for layer in range(cp.num_layers)])

    def fail_device(self, device: int) -> None:
        """§5.4 failover: re-home the failed device's experts onto backup
        slots through the same decide/apply path as a reconfiguration."""
        if self.controlplane is None:
            raise RuntimeError(
                "no control plane configured (MoE arch + reconfig_every > 0 required)"
            )
        self._apply_layer_plans(self.controlplane.fail_device(device))

    def restore_device(self, device: int) -> None:
        if self.controlplane is None:
            raise RuntimeError(
                "no control plane configured (MoE arch + reconfig_every > 0 required)"
            )
        self.controlplane.restore_device(device)

    # -- main loop ---------------------------------------------------------------
    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _local_rows(self, a: np.ndarray) -> np.ndarray:
        """This rank's data-axis slice of a global ``[B, ...]`` batch (each
        microbatch's, microbatch-major, for the pipelined step)."""
        if self.mesh is None:
            return a
        if self.tcfg.pp_stages > 1:
            return local_microbatch_rows(a, self.plan, self.mesh, self.tcfg.num_microbatches)
        for ax in self.plan.batch_axes:
            n = cr.axis_size(self.mesh, ax)
            if a.shape[0] % n:
                raise ValueError(f"batch {a.shape[0]} not divisible by the {ax} axis ({n})")
            b = a.shape[0] // n
            i = cr.axis_index(self.mesh, ax)
            a = a[i * b:(i + 1) * b]
        return a

    def train(self, data_iter) -> list[dict]:
        t = self.tcfg
        while self.step < t.total_steps:
            batch_np = next(data_iter)
            batch = {
                "tokens": self._tensor(self._local_rows(batch_np.tokens), torch.int32),
                "labels": self._tensor(self._local_rows(batch_np.labels), torch.int32),
            }
            perm = self._tensor(self.expert_perm, torch.int32) if self.expert_perm is not None else None
            wire = self._tensor(self.wire_perm, torch.int32) if self.wire_perm is not None else None
            tid = self._track_id() if self._tr.enabled else None
            t0 = time.perf_counter()
            with self._tr.span("train.step", tid=tid, cat="train", step=self.step + 1) as sp:
                if self.tcfg.dp_compress:
                    self.params, self.opt_state, step_metrics, self.ef_residual = self.step_fn(
                        self.params, self.opt_state, batch, perm, wire, self.ef_residual
                    )
                else:
                    self.params, self.opt_state, step_metrics = self.step_fn(
                        self.params, self.opt_state, batch, perm, wire
                    )
                # The host read of the metrics ends the step on the device.
                step_metrics = {k: v.detach().cpu().numpy() for k, v in step_metrics.items()}
                sp.set(loss=float(step_metrics.get("loss", 0.0)))
            dt = time.perf_counter() - t0
            self._m_steps.inc()
            self._m_tokens.inc(float(batch_np.tokens.size))
            self._m_step_time.observe(dt)
            if self._tr.enabled:
                self._tr.counter("train.step_time_s", dt, tid=tid)
            # Straggler watchdog (mitigation = flag + report).
            if self._ema_step_time is not None and dt > t.straggler_factor * self._ema_step_time:
                self.straggler_events += 1
                self._m_stragglers.inc()
                if self._tr.enabled:
                    self._tr.instant(
                        "train.straggler", tid=tid, cat="train",
                        step=self.step + 1, dt_s=dt, ema_s=self._ema_step_time,
                    )
            self._ema_step_time = (
                dt if self._ema_step_time is None else 0.9 * self._ema_step_time + 0.1 * dt
            )
            self.step += 1
            step_metrics["step"] = self.step
            step_metrics["step_time_s"] = dt
            self.metrics_log.append(step_metrics)

            if self.controlplane is not None and "expert_load" in step_metrics:
                self._reconfigure_step(np.asarray(step_metrics["expert_load"]))
            if t.ckpt_every and self.step % t.ckpt_every == 0:
                self._checkpoint()
        ckpt.wait_pending()
        return self.metrics_log
