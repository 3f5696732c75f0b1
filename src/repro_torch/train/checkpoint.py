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
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile

import numpy as np
import torch

__all__ = ["save", "save_async", "restore", "load_extra", "latest_step", "wait_pending"]

_SEP = "/"
_BF16 = "bfloat16"
_pending: list[threading.Thread] = []


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


def _write(ckpt_dir: str, step: int, leaves, keep: int, extra) -> None:
    """Write ``leaves`` (``(key, leaf)`` pairs) as one checkpoint, atomically,
    then drop all but the newest ``keep``."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    shapes, dtypes = {}, {}
    with zipfile.ZipFile(os.path.join(tmp, "arrays.npz"), "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in leaves:
            a, name = _host(leaf)
            shapes[key], dtypes[key] = list(a.shape), name
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, _c(a), allow_pickle=False)
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


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3, extra: dict | None = None):
    """Synchronous checkpoint write (atomic), one leaf in host memory at a
    time."""
    _write(ckpt_dir, step, _flatten(tree).items(), keep, extra)


def save_async(ckpt_dir: str, step: int, tree, *, keep: int = 3, extra=None):
    """Snapshot every leaf to host memory now, write on a background thread."""
    snapshot = [
        (k, v.detach().to("cpu", copy=True) if isinstance(v, torch.Tensor) else np.array(v))
        for k, v in _flatten(tree).items()
    ]
    t = threading.Thread(target=_write, args=(ckpt_dir, step, snapshot, keep, extra),
                         daemon=True)
    t.start()
    _pending.append(t)
    return t


def wait_pending():
    for t in _pending:
        t.join()
    _pending.clear()


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


def restore(ckpt_dir: str, step: int, skeleton):
    """Load a checkpoint into the skeleton's tree, leaf by leaf.

    A tensor leaf receives the stored values IN PLACE (``copy_`` on its own
    device; shape and dtype must match); any other leaf is replaced by a
    CPU tensor of the stored array.  Returns the skeleton's tree."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        dtypes = json.load(f)["dtypes"]
    flat = _flatten(skeleton)
    restored = {}
    with np.load(os.path.join(path, "arrays.npz")) as z:
        for key, leaf in flat.items():
            if key not in dtypes:
                raise KeyError(f"{key}: not in the checkpoint at {path}")
            src = _tensor(z[key], dtypes[key])
            if isinstance(leaf, torch.Tensor):
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
    return _rebuild(skeleton, restored, [])


def _rebuild(node, flat: dict, path: list):
    if isinstance(node, dict):
        return {k: _rebuild(v, flat, path + [str(k)]) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, flat, path + [str(i)]) for i, v in enumerate(node))
    return flat[_SEP.join(path)]
