"""Checkpointing with async save, keep-last-k GC and in-place restore.

Port of :mod:`repro.train.checkpoint`, with its on-disk layout:
``<dir>/step_<N>/arrays.npz`` + ``manifest.json`` (the flattened key names,
shapes, dtypes and the ``extra`` dict), so f32 and integer checkpoints
written by either package restore in the other.

* **Atomicity**: written to ``step_<N>.tmp`` then renamed — a crashed save
  never corrupts the latest checkpoint.
* **Streaming**: the writer converts and writes one leaf at a time into the
  zip (``np.lib.format.write_array``), which ``np.load`` reads as an
  ordinary npz, so host memory holds one leaf, not the tree.
* **Async**: ``save_async`` snapshots every leaf to host memory now and
  writes on a worker thread.
* **bfloat16**: numpy has no bf16 of its own.  A bf16 leaf is written as its
  2-byte bits (``<u2``) with ``"bfloat16"`` in the manifest; ``restore``
  takes the type from the manifest and also reads the ``|V2`` records the
  reference's ``np.savez`` leaves for an ml_dtypes bfloat16 leaf (which the
  reference itself cannot restore).
* **In place**: ``restore`` copies each leaf into the skeleton's tensor on
  that tensor's device (``copy_``): a second full tree would not fit beside
  the training state on the card.
* **Over a mesh** (``layout=``, a :class:`~repro_torch.parallel.sharding.TreeLayout`
  of more than one rank): the files hold the same GLOBAL logical arrays, so
  a checkpoint restores under any mesh, or on one rank; a ZeRO-3 rank's
  data shards are parts like any other (the layout's ``slices``), so one
  checkpoint restores under ZeRO-3, replicated or on one device.  Save gathers each
  leaf to the writer (global rank 0), leaf by leaf, the parts sent by the
  lowest rank holding each, over a gloo group (host buffers); every
  collective runs on the calling thread in the same order on every rank.  A
  synchronous save holds one leaf in the writer's host memory and ends with
  a barrier; ``save_async`` gathers the whole tree into the writer's
  snapshot now (the one-rank snapshot's memory) and only the file writing
  runs on the worker thread, and ``wait_pending`` ends with a barrier, so
  ``latest_step`` agrees on every rank before a restore.  Restore: every
  rank reads each member it holds a part of and copies its part into its
  own tensor; every shape is checked before anything is copied.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile

import numpy as np
import torch

from repro_torch.parallel.sharding import EXPERT_LEAVES

__all__ = ["save", "save_async", "restore", "load_extra", "latest_step", "wait_pending",
           "last_io"]

_SEP = "/"
_BF16 = "bfloat16"
_pending: list[threading.Thread] = []
_pending_barrier: list = []  # the io group of an unfinished mesh save_async
# The bytes and seconds of this process's last save and restore (what a
# caller prints as GB/s): {"save": (bytes, s), "restore": (bytes, s)}.
last_io: dict = {}


def _flatten(tree) -> dict:
    """``{"a/b/c": leaf}`` in sorted key order (lists and tuples by index),
    the reference's key names."""
    flat = {}

    def walk(path, node):
        if isinstance(node, dict):
            for k in sorted(node, key=str):
                walk(path + [str(k)], node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(path + [str(i)], v)
        else:
            flat[_SEP.join(path)] = node

    walk([], tree)
    return flat


def _c(a: np.ndarray) -> np.ndarray:
    """``a`` C-contiguous, 0-d arrays kept 0-d (``np.ascontiguousarray``
    makes them 1-d)."""
    return a if a.flags.c_contiguous else a.copy(order="C")


def _host(leaf) -> tuple[np.ndarray, str]:
    """``(array to write, dtype name for the manifest)``; bf16 as its bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16), _BF16
        a = t.cpu().numpy()
    else:
        a = np.asarray(leaf)
        if a.dtype.name == _BF16:  # an ml_dtypes array handed in by a caller
            return _c(a).view(np.uint16), _BF16
    return a, str(a.dtype)


def _write(ckpt_dir: str, step: int, leaves, keep: int, extra, names=None) -> int:
    """Write ``leaves`` (``(key, leaf)`` pairs) as one checkpoint, atomically,
    then drop all but the newest ``keep``; ``names``: the manifest's dtype
    names where the leaves are already host arrays (bf16 bits).  Returns
    the bytes written."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    shapes, dtypes = {}, {}
    nbytes = 0
    with zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in leaves:
            a, name = _host(leaf)
            if names is not None:
                name = names[key]
            shapes[key], dtypes[key] = list(a.shape), name
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, _c(a), allow_pickle=False)
            nbytes += a.nbytes
            del a
    manifest = {
        "step": step,
        "keys": sorted(shapes),
        "shapes": shapes,
        "dtypes": dtypes,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return nbytes


def _dist(layout) -> bool:
    import torch.distributed as dist

    return (layout is not None and layout.mesh is not None and dist.is_initialized()
            and dist.get_world_size() > 1)


_IO_GROUP: dict = {}


def _io_group():
    """A gloo group of every rank for the checkpoint's host buffers: the
    default group when it is gloo, else one made once (collectively)."""
    import torch.distributed as dist

    if dist.get_backend() == "gloo":
        return None
    if "g" not in _IO_GROUP:
        _IO_GROUP["g"] = dist.new_group(backend="gloo")
    return _IO_GROUP["g"]


def _metas(flat: dict, group) -> list[dict]:
    """Every rank's ``{key: (local shape, host dtype, manifest dtype)}``, in
    one all-gather (a rank of a pipeline stage lacks the other stages'
    ends)."""
    import torch.distributed as dist

    def dtypes(leaf):
        if isinstance(leaf, torch.Tensor):
            if leaf.dtype == torch.bfloat16:
                return "uint16", _BF16
            name = str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
            return name, name
        a = np.asarray(leaf)
        return ("uint16", _BF16) if a.dtype.name == _BF16 else (str(a.dtype), str(a.dtype))

    meta = {k: (list(v.shape), *dtypes(v)) for k, v in flat.items()}
    metas = [None] * dist.get_world_size()
    dist.all_gather_object(metas, meta, group=group)
    return metas


def _gathered(flat: dict, layout, group, metas):
    """Every leaf of the mesh's tree as a global host array, leaf by leaf in
    sorted key order, on the writer (global rank 0), which yields ``(key,
    array)``; the other ranks send the parts they own (the lowest rank
    holding each region) and yield nothing.  Every rank runs this to its
    end, in the same order."""
    import torch.distributed as dist

    me = dist.get_rank()
    for key in sorted(set().union(*metas)):
        holders = [r for r, meta in enumerate(metas) if key in meta]
        local_shape, host_dtype, _ = metas[holders[0]][key]
        shape = layout.global_shape(key, local_shape)
        dtype = np.dtype(host_dtype)
        owners, seen = {}, set()
        for r in holders:
            region = layout.slices(key, shape, r)
            if region is not None and repr(region) not in seen:
                seen.add(repr(region))
                owners[r] = region
        if me == 0:
            out = np.empty(shape, dtype)
            for r, region in owners.items():
                if r == 0:
                    part, _ = _host(flat[key])
                else:
                    buf = torch.empty(out[region].nbytes, dtype=torch.uint8)
                    dist.recv(buf, src=r, group=group)
                    part = buf.numpy().view(dtype)
                out[region] = part.reshape(out[region].shape)
            yield key, out
        elif me in owners:
            part, _ = _host(flat[key])
            dist.send(torch.from_numpy(_c(part).reshape(-1).view(np.uint8)), dst=0, group=group)


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3, extra: dict | None = None,
         layout=None):
    """Synchronous checkpoint write (atomic), one leaf in host memory at a
    time.  ``layout``: the tree's :class:`TreeLayout` over a mesh (every
    rank calls ``save``; the global arrays are written once, and every rank
    returns after the write)."""
    t0 = time.perf_counter()
    flat = _flatten(tree)
    if not _dist(layout):
        nbytes = _write(ckpt_dir, step, flat.items(), keep, extra)
        last_io["save"] = (nbytes, time.perf_counter() - t0)
        return
    import torch.distributed as dist

    group = _io_group()
    metas = _metas(flat, group)
    names = {k: m[2] for meta in metas for k, m in meta.items()}
    leaves = _gathered(flat, layout, group, metas)
    if dist.get_rank() == 0:
        nbytes = _write(ckpt_dir, step, leaves, keep, extra, names)
    else:
        nbytes = sum(0 for _ in leaves)
    dist.barrier(group=group)
    last_io["save"] = (nbytes, time.perf_counter() - t0)


def save_async(ckpt_dir: str, step: int, tree, *, keep: int = 3, extra=None, layout=None):
    """Snapshot every leaf to host memory now, write on a background thread.
    Over a mesh the snapshot is the writer's gather of the global arrays,
    made here on the calling thread; the other ranks keep nothing."""
    flat = _flatten(tree)
    if _dist(layout):
        import torch.distributed as dist

        group = _io_group()
        metas = _metas(flat, group)
        names = {k: m[2] for meta in metas for k, m in meta.items()}
        snapshot = list(_gathered(flat, layout, group, metas))
        _pending_barrier.append(group)
        if dist.get_rank() != 0:
            return None
        args = (ckpt_dir, step, snapshot, keep, extra, names)
    else:
        snapshot = [
            (k, v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor) else np.array(v))
            for k, v in flat.items()
        ]
        args = (ckpt_dir, step, snapshot, keep, extra)
    t = threading.Thread(target=_write, args=args, daemon=True)
    t.start()
    _pending.append(t)
    return t


def wait_pending():
    """Join every background write; after a mesh ``save_async``, a barrier,
    so that every rank sees the written step."""
    for t in _pending:
        t.join()
    _pending.clear()
    if _pending_barrier:
        import torch.distributed as dist

        group = _pending_barrier[-1]
        _pending_barrier.clear()
        dist.barrier(group=group)


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(
        d for d in os.listdir(ckpt_dir) if d.startswith("step_") and not d.endswith(".tmp")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
    ]
    return max(steps) if steps else None


def load_extra(ckpt_dir: str, step: int) -> dict:
    """The ``extra`` dict a checkpoint was saved with (empty if none): the
    control plane's placement state rides here, so that it round-trips with
    the permuted expert weights it addresses."""
    with open(os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")) as f:
        manifest = json.load(f)
    return manifest.get("extra") or {}


def _tensor(a: np.ndarray, name: str) -> torch.Tensor:
    """A stored array as a CPU tensor of the manifest's dtype, bit for bit."""
    if name == _BF16:
        if a.dtype.itemsize != 2:
            raise ValueError(f"bfloat16 leaf stored as {a.dtype}")
        return torch.from_numpy(_c(a).view(np.int16)).view(torch.bfloat16)
    want = np.dtype(name)
    if a.dtype != want:
        raise ValueError(f"leaf stored as {a.dtype}, manifest says {name}")
    return torch.from_numpy(_c(a))


def restore(ckpt_dir: str, step: int, skeleton, *, layout=None):
    """Load a checkpoint into the skeleton's tree, leaf by leaf.

    A tensor leaf receives the stored values IN PLACE (``copy_`` on its own
    device; dtype must match, and its shape the stored one's, or with
    ``layout`` its part of it); any other leaf is replaced by a CPU tensor
    of the stored array.  Every shape is checked before anything is copied:
    a checkpoint of another number of virtual experts (E < P on either
    side) raises ``ValueError``.  Returns the skeleton's tree."""
    t0 = time.perf_counter()
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    dtypes, shapes = manifest["dtypes"], manifest["shapes"]
    flat = _flatten(skeleton)
    for key, leaf in flat.items():
        if key not in dtypes:
            raise KeyError(f"{key}: not in the checkpoint at {path}")
        if not isinstance(leaf, torch.Tensor):
            continue
        want = tuple(leaf.shape) if layout is None else layout.global_shape(key, leaf.shape)
        if tuple(shapes[key]) != want:
            hint = ""
            if key.split(_SEP)[-1] in EXPERT_LEAVES and len(want) > 1 \
                    and shapes[key][1] != want[1]:
                hint = (f" (another number of virtual experts: {shapes[key][1]} stored, "
                        f"{want[1]} here)")
            raise ValueError(f"{key}: checkpoint holds {tuple(shapes[key])}, this tree's global "
                             f"leaf is {want}{hint}")
    restored = {}
    nbytes = 0
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for key, leaf in flat.items():
            src = _tensor(z[key], dtypes[key])
            nbytes += src.numel() * src.element_size()
            if isinstance(leaf, torch.Tensor):
                if layout is not None:
                    src = layout.part(src, key)
                if src.shape != leaf.shape or src.dtype != leaf.dtype:
                    raise ValueError(
                        f"{key}: checkpoint holds {src.dtype} {tuple(src.shape)}, the tree "
                        f"{leaf.dtype} {tuple(leaf.shape)}"
                    )
                with torch.no_grad():
                    leaf.copy_(src)
                restored[key] = leaf
            else:
                restored[key] = src
            del src
    last_io["restore"] = (nbytes, time.perf_counter() - t0)
    return _rebuild(skeleton, restored, [])


def _rebuild(node, flat: dict, path: list):
    if isinstance(node, dict):
        return {k: _rebuild(v, flat, path + [str(k)]) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, flat, path + [str(i)]) for i, v in enumerate(node))
    return flat[_SEP.join(path)]
