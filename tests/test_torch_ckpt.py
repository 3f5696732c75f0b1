"""The port's checkpoints (repro_torch.train.checkpoint) against the JAX
package's on the CPU: the same on-disk layout both ways for f32 and integer
trees, bf16 trees the reference wrote, keep-last-k GC, ``latest_step``,
``load_extra`` and ``save_async`` as in tests/test_train.py; the port's
own restart resuming bit-identically; the quickstart and the
``core.reconfig`` shim.  (A JAX trainer's checkpoint resumed by the port's
Trainer is checked in tests/test_torch_train.py, beside the step-for-step
run that writes it.)

Restores are bit-exact (``assert_array_equal`` on the bits)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jckpt
from repro_torch import quickstart
from repro_torch.core import controlplane, reconfig
from repro_torch.core.controlplane import ControlPlane
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.sharding import make_plan
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.backends.cuda.matmul.allow_tf32 = False
PLAN = make_plan(None)


def _tree(rng):
    return {
        "a": rng.standard_normal((2, 3)).astype(np.float32),
        "b": {"c": rng.integers(-9, 9, size=(4,)).astype(np.int32),
              "d": np.asarray(7, np.int32)},
        "e": [rng.standard_normal((5,)).astype(np.float32)],
    }


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_checkpoint_roundtrip_gc_latest_and_extra(tmp_path):
    """tests/test_train.py:77-90 for the port, plus ``load_extra``,
    ``save_async`` and a bf16 leaf; restores land in the given tensors."""
    tree = _torch_tree(_tree(np.random.default_rng(0)))
    tree["w"] = torch.linspace(-3, 3, 12).to(torch.bfloat16).reshape(3, 4)
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None
    for step in (1, 2, 3):
        ckpt.save(d, step, tree, keep=2, extra={"step": step})
    ckpt.save_async(d, 4, tree, keep=2, extra={"placement": {"x": [1, 2]}})
    ckpt.wait_pending()
    assert ckpt.latest_step(d) == 4
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    assert ckpt.load_extra(d, 3) == {"step": 3}
    assert ckpt.load_extra(d, 4) == {"placement": {"x": [1, 2]}}
    skel = _zeros_like(tree)
    held = list(_leaves(skel))
    back = ckpt.restore(d, 4, skel)
    for got, want, same in zip(_leaves(back), _leaves(tree), held):
        assert got is same  # restored in place
        assert got.dtype == want.dtype and torch.equal(got, want)
    with pytest.raises(ValueError):
        ckpt.restore(d, 4, {**skel, "a": torch.zeros((3, 2))})


def test_checkpoint_interchange_with_reference(tmp_path):
    """f32 and int32 trees: written by the reference, restored by the port,
    and the other way round, bit for bit; the manifests agree."""
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt.save(jd, 5, jax.tree.map(jnp.asarray, tree), extra={"k": 1})
    ckpt.save(td, 5, _torch_tree(tree), extra={"k": 1})
    back = ckpt.restore(jd, 5, _zeros_like(_torch_tree(tree)))
    for got, want in zip(_leaves(back), _leaves(tree)):
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.numpy().dtype == want.dtype and got.shape == want.shape
    jback = jckpt.restore(td, 5, jax.tree.map(jnp.asarray, tree))
    for got, want in zip(jax.tree.leaves(jback), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(got), want)
        assert np.asarray(got).dtype == want.dtype
    assert ckpt.load_extra(jd, 5) == jckpt.load_extra(td, 5) == {"k": 1}
    manifests = []
    for d in (jd, td):
        with open(os.path.join(d, "step_00000005", "manifest.json")) as f:
            manifests.append(json.load(f))
    for key in ("keys", "shapes", "dtypes"):
        assert manifests[0][key] == manifests[1][key]


def test_checkpoint_restores_reference_bf16(tmp_path):
    """A bf16 tree the reference wrote (its npz holds ``|V2`` records, which
    the reference cannot restore) restores into the port bit for bit."""
    rng = np.random.default_rng(2)
    vals = rng.standard_normal((3, 5)).astype(np.float32)
    tree = {"w": jnp.asarray(vals, jnp.bfloat16), "n": jnp.arange(4, dtype=jnp.int32)}
    jckpt.save(str(tmp_path), 1, tree)
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as z:
        assert z["w"].dtype == np.dtype("V2")
    skel = {"w": torch.zeros((3, 5), dtype=torch.bfloat16), "n": torch.zeros(4, dtype=torch.int32)}
    back = ckpt.restore(str(tmp_path), 1, skel)
    want = np.asarray(tree["w"]).view(np.uint16)
    np.testing.assert_array_equal(back["w"].view(torch.int16).numpy().view(np.uint16), want)
    np.testing.assert_array_equal(back["n"].numpy(), np.arange(4))
    # The port writes bf16 as its bits with the reference's manifest name.
    ckpt.save(str(tmp_path / "port"), 1, skel)
    back2 = ckpt.restore(str(tmp_path / "port"), 1, {"w": torch.ones((3, 5), dtype=torch.bfloat16),
                                                    "n": torch.ones(4, dtype=torch.int32)})
    assert torch.equal(back2["w"], back["w"])


def _tiny(cfg_cls, moe_cls):
    return cfg_cls(
        "tiny-moe8", "moe", 2, 32, 4, 2, 0, 64, dtype="float32", remat="none",
        moe=moe_cls(num_experts=8, top_k=2, d_ff=32, capacity_factor=2.0, backend="mixnet"),
    )


@pytest.mark.parametrize("ckpt_async", [False, True])
def test_port_trainer_restart_resumes_bit_identical(tmp_path, ckpt_async):
    """Train 4 steps checkpointing every 2 (placement moving), restart a
    fresh trainer from step 2: steps 3 and 4 give the same losses and the
    same state, bit for bit."""
    cfg = _tiny(ModelConfig, MoEConfig)
    cp_kw = dict(num_layers=2, num_experts=8, num_devices=4, min_gain_fraction=0.0)
    kw = dict(reconfig_every=2, reconfig_min_gain=0.0, ckpt_dir=str(tmp_path), ckpt_keep=1,
              ckpt_async=ckpt_async)
    tr = Trainer(cfg, AdamWConfig(lr=1e-3), TrainerConfig(total_steps=2, ckpt_every=2, **kw),
                 PLAN, device="cpu")
    tr.controlplane = ControlPlane(**cp_kw)
    data = iter(SyntheticLM(64, 16, 4, seed=0))
    tr.train(data)
    assert tr.reconfig_count > 0
    tr.tcfg.total_steps, tr.tcfg.ckpt_every = 4, 0
    log = tr.train(data)
    tr2 = Trainer(cfg, AdamWConfig(lr=1e-3), TrainerConfig(total_steps=4, **kw), PLAN, seed=3,
                  device="cpu")
    tr2.controlplane = ControlPlane(**cp_kw)
    assert tr2.maybe_restore() and tr2.step == 2
    data2 = iter(SyntheticLM(64, 16, 4, seed=0))
    for _ in range(2):
        next(data2)
    log2 = tr2.train(data2)
    for a, b in zip(log[-2:], log2[-2:]):
        assert np.asarray(a["loss"]).tobytes() == np.asarray(b["loss"]).tobytes()
    for a, b in zip(_leaves({"p": tr.params, "o": tr.opt_state}),
                    _leaves({"p": tr2.params, "o": tr2.opt_state})):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(tr.expert_perm, tr2.expert_perm)


def test_quickstart_runs_on_cpu():
    out = quickstart.main(["--steps", "3", "--device", "cpu"])
    assert out["steps"] == 3 and np.isfinite(out["last"])


def test_reconfig_shim_reexports_the_control_plane():
    assert reconfig.ControlPlane is controlplane.ControlPlane
    assert reconfig.FailureHandler is controlplane.FailureHandler
    assert reconfig.LayerPlan is controlplane.LayerPlan
