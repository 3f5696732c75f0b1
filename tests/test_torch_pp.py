"""The port's pipeline parallelism against the JAX package on the CPU: the
bare GPipe schedule (``pipeline_apply`` at S = 4 for M in {1, 3, 4, 12},
outputs and gradients), the pipelined train step at ``("stage", "model")``
= (2, 2) with an expert permutation and a wire map, at (4, 1), and at
``("stage", "data", "model")`` = (2, 2, 1), and the pipelined trainer
across a forced reconfiguration (the port of
``tests/test_pp_reconfig.py:63-98``, held to the JAX PP trainer).

Four JAX subprocesses (4 forced host devices, the mechanism of
``tests/conftest.py``'s ``run_multidevice``, every program jitted) and one
4-process gloo group run side by side on the same seeded numpy inputs,
once per module; the port's ranks take their stage and model shard of each
global tree through ``interop.shard_params``.  Tolerances: loads, slot
maps, wire perms and reconfiguration counts exactly; the schedule's
outputs within ``1e-5`` and its gradients within ``1e-4`` (the reference
test's); the step's loss and updated parameters within ``1e-5`` (XLA and
PyTorch sum in other orders, and the port's schedule differentiates per
microbatch where the reference's scan transposes); the trainer's losses
within ``rtol=1e-5``.  Port against port, bit for bit: PP(S = 4) ==
PP(S = 1) at P = 1 and PP(S = 2) == PP(S = 1) at P = 2 with the plan
(every parameter, the loss, the clipping norm and the loads), every rank
reporting the same metrics, and the non-expert parameters identical across
a stage's model group.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

TOL = dict(atol=1e-5, rtol=1e-5)
PIPE_S, PIPE_MB, PIPE_D = 4, 2, 8
PIPE_MS = (1, 3, 4, 12)  # M < S, M = S - 1, M = S, M > S
# name: (mesh shape, axis names, microbatches, with the plan)
STEPS = {
    "22": ((2, 2), ("stage", "model"), 2, True),
    "41": ((4, 1), ("stage", "model"), 4, False),
    "221": ((2, 2, 1), ("stage", "data", "model"), 2, False),
}
# The port-only PP(S = 1) runs each PP(S) run is held to bit for bit: a
# leading axis the plan ignores replicates the one-stage run over the world.
PP1 = {"41": ((4, 1, 1), ("rep", "stage", "model")), "22": ((2, 1, 2), ("rep", "stage", "model"))}
# test_pp_reconfig.py's load matrix: a co-located hot pair per layer.
LOADS = np.array([[40.0, 40.0, 1.0, 1.0], [1.0, 1.0, 40.0, 40.0],
                  [40.0, 40.0, 1.0, 1.0], [1.0, 1.0, 40.0, 40.0]])
EXPERT_LEAVES = ("w_in", "w_gate", "w_out")


def _cfg(mod):
    """``tests/test_pp_step.py:36-40``: 4 layers, d_model 32, 3 heads (not
    divisible by the model axis), 1 kv head, 4 experts top-2, mixnet."""
    return mod.ModelConfig("tiny-moe", "moe", 4, 32, 3, 1, 0, 64, head_dim=8, dtype="float32",
                           remat="none",
                           moe=mod.MoEConfig(num_experts=4, top_k=2, d_ff=32, capacity_factor=2.0,
                                             backend="mixnet", overlap_chunks=2))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def _nest(flat: dict, prefix: str) -> dict:
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix):].strip("/").split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _inputs() -> dict:
    """Every seeded input both sides read."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import config as tcfgmod
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import make_plan
    from repro_torch.train.train_step import init_all

    rng = np.random.default_rng(24)
    inp = {
        "pipe/w": (rng.standard_normal((PIPE_S, PIPE_D, PIPE_D)) * 0.3).astype(np.float32),
        "pipe/b": (rng.standard_normal((PIPE_S, PIPE_D)) * 0.1).astype(np.float32),
    }
    for m in PIPE_MS:
        inp[f"pipe/x{m}"] = rng.standard_normal((m, PIPE_MB, PIPE_D)).astype(np.float32)
    params, _, _ = init_all(0, _cfg(tcfgmod), make_plan(None), AdamWConfig(), device="cpu")
    for key, t in _flat(params):
        inp[f"params{key}"] = t.detach().numpy()
    data = SyntheticLM(64, 16, 4, seed=0)
    for i in range(4):
        bt = next(data)
        inp[f"tokens{i}"] = bt.tokens.astype(np.int32)
        inp[f"labels{i}"] = bt.labels.astype(np.int32)
    rs = np.random.RandomState(0)
    inp["perm"] = np.stack([rs.permutation(4) for _ in range(4)]).astype(np.int32)
    inp["wire"] = np.stack([np.roll(np.arange(2), li % 2) for li in range(4)]).astype(np.int32)
    return inp


# ---------------------------------------------------------------------------
# the JAX side: four subprocesses with 4 host devices
# ---------------------------------------------------------------------------

JAX_MAIN = r"""
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
sys.path.insert(0, TESTS)
import test_torch_pp as T
from repro.core.controlplane import ControlPlane
from repro.launch.mesh import make_mesh, use_mesh
from repro.models import config as jc
from repro.optim import adamw as jadamw
from repro.parallel.sharding import make_plan
from repro.train import trainer as jtrainer
from repro.train.pipeline import pipeline_apply
from repro.train.pp_step import make_pp_train_step

inp = dict(np.load(IN))
out = {}
cfg = T._cfg(jc)
opt = jadamw.AdamWConfig(lr=1e-3)
fresh = lambda: jax.tree.map(jnp.asarray, T._nest(inp, "params"))

if PART == "a":
    mesh = make_mesh((T.PIPE_S,), ("stage",))
    params = {"w": jnp.asarray(inp["pipe/w"]), "b": jnp.asarray(inp["pipe/b"])}
    stage_fn = lambda p, x: jnp.tanh(x @ p["w"] + p["b"])
    for m in T.PIPE_MS:
        mbs = jnp.asarray(inp[f"pipe/x{m}"])
        def loss(p, mbs=mbs):
            y = pipeline_apply(stage_fn, p, mbs, mesh)
            return jnp.sum(y ** 2), y
        (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        out[f"pipe{m}/out"], out[f"pipe{m}/gw"], out[f"pipe{m}/gb"] = y, g["w"], g["b"]


def pp_step(name):
    shape, axes, m, with_plan = T.STEPS[name]
    mesh = make_mesh(shape, axes)
    plan = make_plan(mesh, fsdp=False)
    perm = jnp.asarray(inp["perm"]) if with_plan else None
    wire = jnp.asarray(inp["wire"]) if with_plan else None
    batch = {"tokens": jnp.asarray(inp["tokens0"]), "labels": jnp.asarray(inp["labels0"])}
    with use_mesh(mesh):
        p0 = fresh()
        step = jax.jit(make_pp_train_step(cfg, plan, opt, mesh, pp_stages=shape[0],
                                          microbatches=m))
        p1, _, met = step(p0, jadamw.init_adamw(p0, opt), batch, perm, wire)
    for k in ("loss", "ce", "balance_loss", "z_loss", "expert_load", "grad_norm"):
        out[f"step{name}/{k}"] = met[k]
    out.update({f"step{name}/p{k}": v for k, v in T._flat(jax.tree.map(np.asarray, p1))})


if PART in "ac":
    pp_step("41" if PART == "a" else "221")

# The trainers start from the port's initial parameters, laid out on the
# mesh as a step's outputs are, and an identity wire map (what a first wire
# plan composes onto, and what a weight plan's flush skips, as for None):
# every step has one signature, so one compile.
mesh22 = make_mesh((2, 2), ("stage", "model"))


def _init(key, c, pl, o):
    with use_mesh(mesh22):
        p = jax.jit(lambda t: t)(fresh())
        return p, {"blocks": None}, jax.jit(lambda t: jadamw.init_adamw(t, o))(p)


jtrainer.init_all = _init
Batch = type("Batch", (), {})


def batches(n):
    for i in range(n):
        b = Batch()
        b.tokens, b.labels = inp[f"tokens{i}"], inp[f"labels{i}"]
        yield b


def trainer(steps, wire):
    tcfg = jtrainer.TrainerConfig(total_steps=steps, num_microbatches=2, reconfig_every=1000,
                                  reconfig_min_gain=0.01, pp_stages=2, ckpt_every=0)
    tr = jtrainer.Trainer(cfg, opt, tcfg, make_plan(mesh22, fsdp=False), mesh=mesh22)
    tr._applier.wire_perm = wire
    return tr


if PART == "d":
    # the (2, 2) step with the plan, as a one-step trainer runs it
    one = trainer(1, inp["wire"].astype(np.int64))
    one.expert_perm = inp["perm"]
    with use_mesh(mesh22):
        one.train(batches(1))
    met = one.metrics_log[0]
    for k in ("loss", "ce", "balance_loss", "z_loss", "expert_load", "grad_norm"):
        out[f"step22/{k}"] = met[k]
    out.update({f"step22/p{k}": v for k, v in T._flat(jax.tree.map(np.asarray, one.params))})

if PART == "b":
    # tests/test_pp_reconfig.py's forced reconfiguration
    tr = trainer(2, np.tile(np.arange(2, dtype=np.int64), (4, 1)))
    data = batches(4)
    with use_mesh(mesh22):
        tr.train(data)
        saved, tr.step = tr.step, tr.tcfg.reconfig_every
        tr._reconfigure_step(T.LOADS)
        tr.step = saved
        tr.tcfg = dataclasses.replace(tr.tcfg, total_steps=4)
        tr.train(data)
    out["trainer/loss"] = np.array([float(m["loss"]) for m in tr.metrics_log])
    out["trainer/perm"] = np.asarray(tr.expert_perm)
    out["trainer/wire"] = np.asarray(tr.wire_perm)
    out["trainer/counts"] = np.array([tr.reconfig_count, tr.wire_reconfig_count])
    out.update({f"trainer/p{k}": v for k, v in T._flat(jax.tree.map(np.asarray, tr.params))})

np.savez(OUT, **{k: np.asarray(v) for k, v in out.items()})
print("JAX_PP_OK")
"""


# ---------------------------------------------------------------------------
# the port side: 4 gloo ranks
# ---------------------------------------------------------------------------


def _port_rank(rank: int, inp_path: str, out_dir: str, port: int) -> None:
    import dataclasses

    import torch

    torch.set_num_threads(1)
    from repro_torch.core import commruntime as cr
    from repro_torch.interop import params_from_numpy, shard_params
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models import config as tc
    from repro_torch.models.transformer import init_model
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.optim.adamw import AdamWConfig, init_adamw
    from repro_torch.parallel.sharding import make_plan, stage_layers
    from repro_torch.train.pipeline import pipeline_apply
    from repro_torch.train.pp_step import local_microbatch_rows, make_pp_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    init_distributed(rank=rank, world_size=4, init_method=f"tcp://localhost:{port}",
                     device_type="cpu")
    inp = dict(np.load(inp_path))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    out = {}
    cfg = _cfg(tc)
    opt = AdamWConfig(lr=1e-3)
    tree = _nest(inp, "params")

    # the bare schedule: stage s holds row s of the reference's [S, ...]
    mesh = make_mesh((PIPE_S,), ("stage",))
    sp = {k: t(inp[f"pipe/{k}"][rank]).requires_grad_() for k in ("w", "b")}
    for m in PIPE_MS:
        y = pipeline_apply(lambda p, x: torch.tanh(x @ p["w"] + p["b"]), sp, t(inp[f"pipe/x{m}"]),
                           mesh)
        gw, gb = torch.autograd.grad(torch.sum(y ** 2), [sp["w"], sp["b"]])
        out[f"pipe{m}/out"], out[f"pipe{m}/gw"], out[f"pipe{m}/gb"] = y, gw, gb

    def link(op, which):
        return obs_metrics.default().value("comm.link_bytes", op=op, link=which)

    def pp_step(tag, shape, axes, m, with_plan):
        mesh = make_mesh(shape, axes)
        plan = make_plan(mesh, fsdp=False)
        params = params_from_numpy(shard_params(tree, plan, mesh, cfg=cfg), cfg, trainable=True)
        step = make_pp_train_step(cfg, plan, opt, mesh, pp_stages=shape[axes.index("stage")],
                                  microbatches=m)
        rows = lambda a: t(local_microbatch_rows(a, plan, mesh, m))  # noqa: E731
        batch = {"tokens": rows(inp["tokens0"]), "labels": rows(inp["labels0"])}
        before = {k: link("p2p", k) for k in ("cross_region", "scale_out", "scale_up")}
        p1, _, met = step(params, init_adamw(params, opt), batch,
                          t(inp["perm"]) if with_plan else None,
                          inp["wire"] if with_plan else None)
        out.update({f"{tag}/p2p_{k}": link("p2p", k) - v for k, v in before.items()})
        out.update({f"{tag}/{k}": v for k, v in met.items()})
        out.update({f"{tag}/p{k}": v for k, v in _flat(p1)})

    for name, (shape, axes, m, with_plan) in STEPS.items():
        pp_step(f"step{name}", shape, axes, m, with_plan)
    for name, (shape, axes) in PP1.items():
        pp_step(f"pp1_{name}", shape, axes, STEPS[name][2], STEPS[name][3])

    # init over a stage mesh keeps the stage's part of the one-device draw
    mesh = make_mesh((2, 2), ("stage", "model"))
    plan = make_plan(mesh, fsdp=False)
    mine = dict(_flat(init_model(3, cfg, plan, device="cpu", mesh=mesh)))
    whole = _nest({f"w{k}": a.numpy() for k, a in _flat(init_model(3, cfg, make_plan(None),
                                                                     device="cpu"))}, "w")
    want = dict(_flat(shard_params(whole, plan, mesh, cfg=cfg)))
    out["init/same_leaves"] = sorted(mine) == sorted(want)
    out["init/equal"] = all(torch.equal(a, t(want[k])) for k, a in mine.items())
    out["init/leaves"] = np.array(sorted(mine))

    # the pipelined trainer across a forced reconfiguration
    tr = Trainer(cfg, opt, TrainerConfig(total_steps=2, num_microbatches=2, reconfig_every=1000,
                                         reconfig_min_gain=0.01, pp_stages=2), plan, mesh=mesh,
                 device="cpu")
    tr.params = params_from_numpy(shard_params(tree, plan, mesh, cfg=cfg), cfg, trainable=True)
    tr.opt_state = init_adamw(tr.params, opt)
    batches = iter([type("B", (), {"tokens": inp[f"tokens{i}"], "labels": inp[f"labels{i}"]})
                    for i in range(4)])
    tr.train(batches)
    saved, tr.step = tr.step, tr.tcfg.reconfig_every
    tr._reconfigure_step(LOADS)
    tr.step = saved
    tr.tcfg = dataclasses.replace(tr.tcfg, total_steps=4)
    tr.train(batches)
    out["trainer/loss"] = np.array([float(mm["loss"]) for mm in tr.metrics_log])
    out["trainer/perm"] = np.asarray(tr.expert_perm)
    out["trainer/wire"] = (np.asarray(tr.wire_perm) if tr.wire_perm is not None
                           else np.tile(np.arange(2), (4, 1)))
    out["trainer/counts"] = np.array([tr.reconfig_count, tr.wire_reconfig_count])
    here = tr._bound_applier().applied_here
    out["trainer/here"] = np.array([here["weight"], here["wire"]])
    out.update({f"trainer/p{k}": v for k, v in _flat(tr.params)})

    # misconfigurations a stage mesh can show (the rest run in the test)
    from repro_torch.train import pp_step as pps

    def raises(exc, fn):
        try:
            fn()
        except exc:
            return True
        return False

    flat_mesh = make_mesh((2, 2), ("data", "model"))
    one = make_mesh((4, 1, 1), ("rep", "stage", "model"))
    one_plan = make_plan(one, fsdp=False)
    bad_cfg = lambda **kw: dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))  # noqa
    cases = [
        (ValueError, lambda: pps.make_pp_train_step(cfg, make_plan(flat_mesh), opt, flat_mesh,
                                                    pp_stages=2)),
        (ValueError, lambda: pps.make_pp_train_step(cfg, plan, opt, mesh, pp_stages=4)),
        (ValueError, lambda: pps.make_pp_train_step(cfg, one_plan, opt, one, pp_stages=3)),
        (NotImplementedError, lambda: pps.make_pp_train_step(
            bad_cfg(backend="einsum"), one_plan, opt, one, pp_stages=1)),
        (NotImplementedError, lambda: pps.make_pp_train_step(
            bad_cfg(num_shared_experts=1), one_plan, opt, one, pp_stages=1)),
        (NotImplementedError, lambda: pps.make_pp_train_step(
            cfg, dataclasses.replace(one_plan, model_axis="model", model_size=8), opt, one,
            pp_stages=1)),
        (NotImplementedError, lambda: pps.make_pp_train_step(
            dataclasses.replace(cfg, block_pattern=("global", "ssm"), num_layers=4), one_plan,
            opt, one, pp_stages=1)),
    ]
    out["misconfig"] = np.array([raises(exc, fn) for exc, fn in cases])
    out["stage"] = stage_layers(mesh, 4)[0]

    def conv(v):
        if isinstance(v, torch.Tensor):
            return v.detach().numpy()
        return np.asarray(v)

    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **{k: conv(v) for k, v in out.items()})
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def _port_main(inp_path: str, out_dir: str, port: int) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_port_rank, args=(inp_path, out_dir, port), nprocs=4, join=True)


# ---------------------------------------------------------------------------
# the module fixture: both sides, side by side
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.train import free_port

    d = tmp_path_factory.mktemp("pp")
    inp = _inputs()
    inp_path = str(d / "inputs.npz")
    np.savez(inp_path, **inp)
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + tests + os.pathsep + env.get("PYTHONPATH", "")
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    jcodes = [(f"TESTS = {json.dumps(tests)}\nIN = {json.dumps(inp_path)}\nPART = '{part}'\n"
               f"OUT = {json.dumps(str(d / f'jax_{part}.npz'))}\n" + JAX_MAIN) for part in "abcd"]
    tenv = dict(env, OMP_NUM_THREADS="1")
    tcode = (f"import test_torch_pp as T; "
             f"T._port_main({json.dumps(inp_path)}, {json.dumps(str(d))}, {free_port()})")
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=e)
             for code, e in ((tcode, tenv), *((c, jenv) for c in jcodes))]
    for p, what in zip(procs, ("port", "JAX", "JAX", "JAX", "JAX")):
        so, se = p.communicate(timeout=600)
        if p.returncode != 0:
            for q in procs:
                q.kill()
            raise AssertionError(f"{what} side failed:\nSTDOUT:\n{so[-3000:]}\n"
                                 f"STDERR:\n{se[-6000:]}")
    jax_out = {k: v for part in "abcd" for k, v in np.load(d / f"jax_{part}.npz").items()}
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]
    return jax_out, ranks, inp


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               **(tol or TOL))


def _coords(name: str, rank: int) -> tuple[int, int, int, int]:
    """``(stage, stages, model, model size)`` of ``rank`` on mesh ``name``."""
    shape, axes, _, _ = STEPS[name]
    idx = np.unravel_index(rank, shape)
    c = dict(zip(axes, idx))
    return int(c["stage"]), shape[0], int(c["model"]), shape[axes.index("model")]


class _GridMesh:
    """A mesh's rank grid and dim names, without a process group: what
    ``TreeLayout`` reads when every rank is named."""

    def __init__(self, shape, names):
        import torch

        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)
        self.mesh_dim_names = names

    def size(self, dim):
        return int(self.mesh.shape[dim])


def _layout(n: int, p: int):
    from repro_torch.models import config as tc
    from repro_torch.parallel.sharding import TreeLayout, make_plan

    grid = _GridMesh((n, p), ("stage", "model"))
    return TreeLayout(make_plan(grid, fsdp=False), grid, _cfg(tc))


def _shard(full: np.ndarray, key: str, s: int, n: int, m: int, p: int) -> np.ndarray:
    """The part of a whole leaf that rank (stage s of n, model m of p) holds:
    its stage's repeats, its expert slots and its tensor-parallel shard
    (``TreeLayout``'s rule)."""
    if key.startswith("/blocks/") or key in ("/embed", "/lm_head"):
        return _layout(n, p).part(full, key, s * p + m)
    return full


def _held(key: str, s: int, n: int) -> bool:
    return (key.startswith("/blocks/") or (key == "/embed" and s == 0)
            or (key in ("/final_norm", "/lm_head") and s == n - 1))


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


def test_num_ticks():
    from repro_torch.train.pipeline import num_ticks

    for m in (1, 3, 4, 12):
        assert num_ticks(m, 4) == m + 3
    assert num_ticks(1, 1) == 1 and num_ticks(7, 1) == 7


@pytest.mark.parametrize("m", PIPE_MS)
def test_pipeline_apply_matches_jax(runs, m):
    """Outputs on every rank (the last stage's), and each stage's
    gradients through the reverse schedule, for M below, at and above S."""
    jax_out, ranks, _ = runs
    for r, got in enumerate(ranks):
        _close(got[f"pipe{m}/out"], jax_out[f"pipe{m}/out"])
        np.testing.assert_array_equal(got[f"pipe{m}/out"], ranks[-1][f"pipe{m}/out"])
        _close(got[f"pipe{m}/gw"], jax_out[f"pipe{m}/gw"][r], atol=1e-4, rtol=1e-4)
        _close(got[f"pipe{m}/gb"], jax_out[f"pipe{m}/gb"][r], atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the pipelined step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(STEPS))
def test_pp_step_matches_jax(runs, name):
    """Loss, cross entropy, aux losses and clipping norm within 1e-5, the
    loads exactly, and every updated parameter this rank holds within
    1e-5; a leaf a stage does not hold is not in its parameters."""
    jax_out, ranks, _ = runs
    tag = f"step{name}"
    for r, got in enumerate(ranks):
        s, n, m, p = _coords(name, r)
        for k in ("loss", "ce", "balance_loss", "z_loss", "grad_norm"):
            _close(got[f"{tag}/{k}"], jax_out[f"{tag}/{k}"])
        np.testing.assert_array_equal(got[f"{tag}/expert_load"], jax_out[f"{tag}/expert_load"])
        keys = {k[len(f"{tag}/p"):] for k in jax_out if k.startswith(f"{tag}/p/")}
        held = {k for k in keys if _held(k, s, n)}
        assert {k[len(f"{tag}/p"):] for k in got if k.startswith(f"{tag}/p/")} == held
        for k in held:
            _close(got[f"{tag}/p{k}"], _shard(jax_out[f"{tag}/p{k}"], k, s, n, m, p))


@pytest.mark.parametrize("name", list(PP1))
def test_pp_equals_one_stage_bit_for_bit(runs, name):
    """PP(S) == PP(S = 1) on the same model axis: every parameter, the
    loss, the clipping norm, the aux losses and the loads."""
    _, ranks, _ = runs
    tag, one = f"step{name}", f"pp1_{name}"
    for r, got in enumerate(ranks):
        s, n, m, p = _coords(name, r)
        ref = ranks[m]  # rep 0, the one stage, model m
        for k in ("loss", "ce", "balance_loss", "z_loss", "grad_norm", "expert_load"):
            np.testing.assert_array_equal(got[f"{tag}/{k}"], ref[f"{one}/{k}"], k)
        for key in got:
            if key.startswith(f"{tag}/p/"):
                leaf = key[len(f"{tag}/p"):]
                np.testing.assert_array_equal(got[key], _shard(ref[f"{one}/p{leaf}"], leaf, s, n,
                                                               0, 1), key)


def test_every_rank_reports_the_same_metrics(runs):
    _, ranks, _ = runs
    for name in STEPS:
        for k in ("loss", "ce", "balance_loss", "z_loss", "grad_norm", "expert_load"):
            for got in ranks[1:]:
                np.testing.assert_array_equal(got[f"step{name}/{k}"], ranks[0][f"step{name}/{k}"])


def test_non_expert_parameters_identical_across_a_stage_model_group(runs):
    """Every leaf ``TreeLayout`` replicates is bit-identical across each
    stage's model group; each tensor-parallel leaf's parts, placed into the
    whole leaf, equal the JAX package's within the file's tolerance."""
    jax_out, ranks, _ = runs
    layout = _layout(2, 2)
    seen = sharded = 0
    for a, b in ((0, 1), (2, 3)):
        for key in ranks[a]:
            if not key.startswith(("step22/p/", "trainer/p/")):
                continue
            tag, leaf = key.split("/p/", 1)
            leaf = "/" + leaf
            if leaf.split("/")[-2] == "moe" and leaf.split("/")[-1] in EXPERT_LEAVES:
                continue
            if ranks[a][key].shape == ranks[b][key].shape and layout.slices(
                    leaf, jax_out[key].shape, a) == layout.slices(leaf, jax_out[key].shape, b):
                np.testing.assert_array_equal(ranks[a][key], ranks[b][key], key)
                seen += 1
                continue
            whole = np.zeros_like(jax_out[key])
            held = np.zeros(whole.shape, bool)
            for r in (a, b):
                layout.place(whole, ranks[r][key], leaf, r)
                held[layout.slices(leaf, whole.shape, r)] = True
            _close(whole[held], jax_out[key][held])
            sharded += 1
    assert seen > 0 and sharded > 0


def test_stage_transfers_are_cross_region_bytes(runs):
    """The (2, 2) step's point-to-point bytes ride the stage axis, counted
    as ``cross_region`` (the reference's EPS fabric): stage 0 sends each
    microbatch's ``[2, 16, 32]`` f32 output forward, stage 1 each input
    gradient back and the loss and cross entropy (8 bytes) to stage 0."""
    _, ranks, _ = runs
    act = 2 * 2 * 16 * 32 * 4
    for r, got in enumerate(ranks):
        s = r // 2
        assert float(got["step22/p2p_cross_region"]) == act + (8 if s == 1 else 0)
        assert float(got["step22/p2p_scale_out"]) == 0.0
        assert float(got["step22/p2p_scale_up"]) == 0.0


def test_init_over_stages_holds_the_one_device_draw(runs):
    _, ranks, _ = runs
    for r, got in enumerate(ranks):
        assert bool(got["init/same_leaves"]) and bool(got["init/equal"])
        leaves = set(got["init/leaves"].tolist())
        assert ("/embed" in leaves) == (r < 2)
        assert ("/lm_head" in leaves) == (r >= 2)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def test_pp_trainer_matches_jax_across_forced_reconfig(runs):
    """Two steps, the forced plan, two more: slot maps, wire perms and
    counts exactly, losses within rtol 1e-5, parameters within 1e-5."""
    jax_out, ranks, _ = runs
    assert int(jax_out["trainer/counts"].sum()) >= 1
    # each plan counted on the stage that owns its layer, once
    weight, wire = ranks[0]["trainer/here"] + ranks[2]["trainer/here"]
    assert weight + wire == jax_out["trainer/counts"][0]
    assert wire == jax_out["trainer/counts"][1]
    for r, got in enumerate(ranks):
        s, m = divmod(r, 2)
        for k in ("perm", "wire", "counts"):
            np.testing.assert_array_equal(got[f"trainer/{k}"], jax_out[f"trainer/{k}"])
        _close(got["trainer/loss"], jax_out["trainer/loss"], rtol=1e-5)
        for key in got:
            if key.startswith("trainer/p/"):
                leaf = key[len("trainer/p"):]
                _close(got[key], _shard(jax_out[key], leaf, s, 2, m, 2))


def test_pp_misconfigurations_rejected(runs):
    """``tests/test_pp_step.py:171-228``: no stage axis, a stage axis of
    another size, repeats not divisible, the einsum backend, shared
    experts, expert replication and a non-attention pattern; the trainer
    composes with ``dp_comm="auto"`` only."""
    from repro_torch.models import config as tc
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import make_plan
    from repro_torch.train.pp_step import make_pp_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    _, ranks, _ = runs
    for got in ranks:
        assert got["misconfig"].all(), got["misconfig"]
    cfg, opt = _cfg(tc), AdamWConfig(lr=1e-3)
    with pytest.raises(ValueError):
        make_pp_train_step(cfg, make_plan(None), opt, None, pp_stages=2)
    for kw in ({"dp_comm": "runtime"}, {"dp_comm": "runtime", "dp_compress": True}):
        with pytest.raises(ValueError):
            Trainer(cfg, opt, TrainerConfig(pp_stages=2, **kw), make_plan(None), device="cpu")
