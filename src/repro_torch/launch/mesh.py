"""Process groups and device meshes.

Port of :mod:`repro.launch.mesh`.  :func:`init_distributed` joins the
process group of a ``torchrun`` launch (or of ranks spawned with an explicit
address), and :func:`make_mesh` builds a
``torch.distributed.device_mesh.DeviceMesh`` with named dims, the port's
counterpart of ``jax.make_mesh``.  A FUNCTION, not a module constant:
importing this module touches no process group.

Backend: NCCL when every rank has a card of its own, gloo when ranks share
a card or run on the CPU (``init_distributed(backend="auto")``).  Under
gloo the collectives gloo refuses on CUDA tensors stage through host memory
(:mod:`repro_torch.core.commruntime`); the compute stays on the card.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "make_mesh", "pick_backend", "local_device"]

# A hung collective fails the run after this long.
TIMEOUT = datetime.timedelta(seconds=600)


def pick_backend(world: int, device_type: str) -> str:
    """``"nccl"`` when every rank has a card of its own, else ``"gloo"``."""
    if device_type == "cuda" and torch.cuda.is_available() and \
            torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def local_device(rank: int, device_type: str = "cuda") -> torch.device:
    """Rank ``rank``'s device: card ``rank % device_count`` (ranks beyond the
    cards share them), or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


def init_distributed(backend: str = "auto", *, rank: int | None = None,
                     world_size: int | None = None, init_method: str | None = None,
                     device_type: str = "cuda", timeout=TIMEOUT) -> tuple[int, int, str]:
    """Join the default process group; ``(rank, world, backend)``.

    Rank, world size and address come from the arguments, else from the
    ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``).  On the card the rank's device is set to
    ``rank % device_count``.
    """
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    if backend == "auto":
        backend = pick_backend(world_size, device_type)
    if device_type == "cuda":
        torch.cuda.set_device(local_device(rank))
    if not dist.is_initialized():
        kw = {} if init_method is None else {"init_method": init_method}
        dist.init_process_group(backend, rank=rank, world_size=world_size, timeout=timeout,
                                **kw)
    return rank, world_size, dist.get_backend()


def make_mesh(shape, axes):
    """A ``DeviceMesh`` of the world's ranks laid out row-major over
    ``shape`` with dims named ``axes`` (rank = data * model_size + model for
    ``("data", "model")``).  Its groups take the default group's backend."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
