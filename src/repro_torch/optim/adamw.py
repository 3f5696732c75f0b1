"""AdamW with dtype-configurable moments and global-norm clipping.

Port of :mod:`repro.optim.adamw`: the same f32 formula, in the same order
(``adamw.py:60-91`` of the reference).  The update runs IN PLACE on the
parameter and moment tensors, one slice of a leaf at a time: a stacked
expert leaf of Mixtral-8x7B is ``[2, 8, 4096, 14336]``, one f32 temporary
of it 3.76 GB, and the formula makes about six.  Each leaf is walked in
slices along its leading dims (a ``[reps]`` slice, then smaller while a
slice holds more than ``_SLICE`` elements), so the temporaries stay near
a GB: four ranks of a mesh share one card.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "AdamWConfig", "init_adamw", "adamw_update", "global_norm", "sum_of_squares", "square_sum",
    "cosine_lr",
]

_SLICE = 1 << 26  # elements per in-place update slice (256 MiB of f32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"
    warmup_steps: int = 100
    total_steps: int = 10_000


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay, in f32 (``step`` an int tensor)."""
    f32 = torch.float32
    stepf = step.to(f32)
    warm = torch.clamp(stepf / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (stepf - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0
    )
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def _leaves(tree, prefix=""):
    """``(path, tensor)`` leaves in sorted key order (the order a JAX tree
    flattens a dict in)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def init_adamw(params, cfg: AdamWConfig):
    dt = getattr(torch, cfg.moment_dtype)

    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros(tree.shape, dtype=dt, device=tree.device)

    dev = next(t for _, t in _leaves(params)).device
    return {
        "mu": zeros(params),
        "nu": zeros(params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _slices(x: torch.Tensor):
    """Views of ``x`` along its leading dims, each at most ``_SLICE``
    elements (or one row of the last dim): as many leading rows a view as
    fit, a row's own slices when one row does not."""
    if x.numel() <= _SLICE or x.dim() <= 1:
        yield x
        return
    rows = _SLICE // (x.numel() // x.shape[0])
    if rows >= 1:
        yield from x.split(rows)
        return
    for row in x.unbind(0):
        yield from _slices(row)


def square_sum(x: torch.Tensor) -> torch.Tensor:
    """The f64 sum of ``x``'s squares (exact in f64 for bf16 and f32
    values; one read of an f64 copy, as the norm of it).  In f64 the sum's
    rounding is ~1e-16 relative, so the squares of a leaf summed whole, in
    slices or in parts on several ranks, in any order, give one f32 norm: a
    sharded run clips by one device's norm."""
    return sum(torch.square(torch.linalg.vector_norm(s, dtype=torch.float64))
               for s in _slices(x))


def sum_of_squares(tree, keep=None) -> torch.Tensor | None:
    """f64 sum of every (``keep(path)``) leaf's squares, in leaf order."""
    total = None
    for path, g in _leaves(tree):
        if keep is not None and not keep(path):
            continue
        sq = square_sum(g)
        total = sq if total is None else total + sq
    return total


def global_norm(tree) -> torch.Tensor:
    """The f32 norm of the f64 :func:`sum_of_squares`."""
    return torch.sqrt(sum_of_squares(tree)).float()


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, *, grad_norm=None):
    """One AdamW step, in place: ``params`` and ``state`` hold the new values
    when it returns (and are returned, as the reference returns its new
    trees).  ``grad_norm``: the clipping norm when the caller computes it
    (over a mesh, the norm of the whole model's gradient).  Returns
    ``(params, state, metrics)``."""
    step = state["step"] + 1
    lr = cosine_lr(cfg, step)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device), stepf)

    grad_of = dict(_leaves(grads))
    mu_of = dict(_leaves(state["mu"]))
    nu_of = dict(_leaves(state["nu"]))
    for path, p in _leaves(params):
        g, mu, nu = grad_of[path], mu_of[path], nu_of[path]
        for ps, gs, ms, ns in zip(_slices(p), _slices(g), _slices(mu), _slices(nu)):
            g32 = gs.float() * scale
            mu32 = cfg.b1 * ms.float() + (1 - cfg.b1) * g32
            nu32 = cfg.b2 * ns.float() + (1 - cfg.b2) * g32 * g32
            del g32
            mhat = mu32 / b1c
            vhat = nu32 / b2c
            ms.copy_(mu32)
            ns.copy_(nu32)
            del mu32, nu32
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * ps.float()
            del mhat, vhat
            ps.copy_(ps.float() - lr * delta)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
