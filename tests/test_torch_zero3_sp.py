"""ZeRO-3 over the data axis (with the FSDP ring prefetch) and the
sequence-parallel paths in the port, against the JAX package on the CPU.

The reference's toy configs: ``tests/test_overlap.py:463-486``'s mixnet MoE
and dense models (ZeRO-3 over ``(2, 2)`` ``("data", "model")``) and
``tests/test_system.py:128-150``'s sequence-parallel dense model.  Two JAX
subprocesses with 4 forced host devices (the trainer steps; the
``sp_shardmap=True`` forward and the pipelined step) run beside one
4-process gloo group of the port, all on the same seeded weights (the
port's one-device draws, handed to every side as numpy).

Tolerances: ``atol=rtol=1e-5`` against the JAX package's steps (XLA and
PyTorch sum in other orders), ``1e-4`` for the sequence-parallel forward
(the reference's own bound, ``tests/test_system.py:147``).  Port against
port, bit for bit: ZeRO-3 against the replicated plan (losses, the
clipping norm and the parameters gathered over the data axis, with a
weight and a wire re-placement too), the ring prefetch against the
on-demand gather, sequence parallelism against tensor parallelism (logits
and 3 training steps), a ZeRO-3 checkpoint restored replicated and on one
device, ZeRO-3 inside pipeline stages against the replicated stages.
"""

import dataclasses
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
SP_TOL = dict(atol=1e-4, rtol=0)
CFGS = ("moe", "dense", "sp")
STEPS = 3
B, S = 4, 16
# Layer 0: slots 0 and 4 swap across the model axis's two blocks (a weight
# move); layer 1: the blocks swap whole (a wire re-address).
PLANS = ((0, (4, 1, 2, 3, 0, 5, 6, 7)), (1, (4, 5, 6, 7, 0, 1, 2, 3)))


def _cfg(mod, name):
    """``moe`` and ``dense``: ``tests/test_overlap.py:473-482``; ``sp``:
    ``tests/test_system.py:137`` (remat "full": the recompute gathers
    again)."""
    if name == "moe":
        return mod.ModelConfig("moe", "moe", 2, 32, 4, 2, 0, 64, dtype="float32", remat="none",
                               moe=mod.MoEConfig(num_experts=8, top_k=2, d_ff=32,
                                                 capacity_factor=2.0, backend="mixnet",
                                                 a2a_group=2))
    if name == "dense":
        return mod.ModelConfig("dense", "dense", 2, 32, 4, 2, 64, 64, dtype="float32",
                               remat="none")
    return mod.ModelConfig("sp", "dense", 2, 32, 8, 4, 64, 128, dtype="float32", remat="full")


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def _nest(inp: dict, prefix: str) -> dict:
    out: dict = {}
    for key, v in inp.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix):].strip("/").split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


class _Batches:
    """The batches ``lo, lo + 1, ...`` of one config's inputs as a data
    iterator."""

    def __init__(self, inp, name, lo=0):
        self.inp, self.name, self.i = inp, name, lo

    def __next__(self):
        i, self.i = self.i, self.i + 1
        return type("B", (), {"tokens": self.inp[f"{self.name}/tokens{i}"],
                              "labels": self.inp[f"{self.name}/labels{i}"]})


def _inputs() -> dict:
    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import config as tc
    from repro_torch.models.transformer import init_model
    from repro_torch.parallel.sharding import make_plan

    inp = {}
    for name in CFGS:
        cfg = _cfg(tc, name)
        params = init_model(5, cfg, make_plan(None), device="cpu")
        with torch.no_grad():
            inp.update({f"w/{name}{k}": v.numpy() for k, v in _flat(params)})
        data = SyntheticLM(cfg.vocab_size, S, B, seed=1)
        for i in range(STEPS):
            bt = next(data)
            inp[f"{name}/tokens{i}"] = bt.tokens.astype(np.int32)
            inp[f"{name}/labels{i}"] = bt.labels.astype(np.int32)
    return inp


# ---------------------------------------------------------------------------
# the JAX side: two subprocesses with 4 host devices
# ---------------------------------------------------------------------------

JAX_MAIN = r"""
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
sys.path.insert(0, TESTS)
import test_torch_zero3_sp as T
from repro.launch.mesh import make_mesh, use_mesh
from repro.models import config as jc
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.parallel.sharding import make_plan
from repro.train import pp_step as jpp
from repro.train import train_step as jts

inp = dict(np.load(IN))
out = {}
opt = jadamw.AdamWConfig(lr=1e-3)
fresh = lambda n: jax.tree.map(jnp.asarray, T._nest(inp, f"w/{n}"))
batch = lambda n, i: {"tokens": jnp.asarray(inp[f"{n}/tokens{i}"]),
                      "labels": jnp.asarray(inp[f"{n}/labels{i}"])}
mesh = make_mesh((2, 2), ("data", "model"))
plan = make_plan(mesh)  # ZeRO-3 over "data", the reference's launcher's plan

if PART == "a":
    # the trainer's steps on make_plan(mesh), mixnet and dense
    for n in ("moe", "dense"):
        cfg, p = T._cfg(jc, n), fresh(n)
        st = jadamw.init_adamw(p, opt)
        with use_mesh(mesh):
            step = jax.jit(jts.make_train_step(cfg, plan, opt, mesh=mesh))
            for i in range(T.STEPS):
                p, st, m = step(p, st, batch(n, i))
                out[f"{n}/loss{i}"] = m["loss"]
        out.update({f"{n}/p{k}": v for k, v in T._flat(jax.tree.map(np.asarray, p))})
else:
    # the sequence-parallel forward, and one pipelined step over a plan of
    # make_plan(mesh) with the FSDP prefetch on
    cfg = dataclasses.replace(T._cfg(jc, "sp"), sp_shardmap=True)
    with use_mesh(mesh):
        f = jax.jit(lambda p, t: jtfm.model_apply(p, {"tokens": t}, cfg, plan, mesh=mesh,
                                                  mode="train")[0])(fresh("sp"),
                                                                    batch("sp", 0)["tokens"])
    out["sp/logits"] = jtfm.logits_from_features(fresh("sp"), f, cfg)
    cfg = dataclasses.replace(T._cfg(jc, "moe"), fsdp_prefetch=True)
    pmesh = make_mesh((2, 2), ("stage", "model"))
    p = fresh("moe")
    with use_mesh(pmesh):
        step = jax.jit(jpp.make_pp_train_step(cfg, make_plan(pmesh), opt, pmesh, pp_stages=2,
                                              microbatches=2))
        p, _, m = step(p, jadamw.init_adamw(p, opt), batch("moe", 0))
    out["pp/loss"] = m["loss"]
    out.update({f"pp/p{k}": v for k, v in T._flat(jax.tree.map(np.asarray, p))})
np.savez(OUT, **{k: np.asarray(v) for k, v in out.items()})
print("JAX_ZERO3_OK")
"""


# ---------------------------------------------------------------------------
# the port side: 4 gloo ranks
# ---------------------------------------------------------------------------


def _port_rank(rank: int, inp_path: str, out_dir: str, port: int) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from repro_torch.core import commruntime as cr
    from repro_torch.core.controlplane import ControlPlane, LayerPlan
    from repro_torch.interop import params_from_numpy, shard_params
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models import config as tc
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import AdamWConfig, init_adamw
    from repro_torch.parallel.sharding import TreeLayout, make_plan, token_gather
    from repro_torch.train import trainer as trainer_mod
    from repro_torch.train.pp_step import local_microbatch_rows, make_pp_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    init_distributed(rank=rank, world_size=4, init_method=f"tcp://localhost:{port}",
                     device_type="cpu")
    inp = dict(np.load(inp_path))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    out = {}
    opt = AdamWConfig(lr=1e-3)
    cfgs = {n: _cfg(tc, n) for n in CFGS}
    mesh = make_mesh((2, 2), ("data", "model"))
    z3, rep = make_plan(mesh), make_plan(mesh, fsdp=False)
    di = cr.axis_index(mesh, "data")
    rows = slice(di * B // 2, (di + 1) * B // 2)

    def load(name, plan, ms, cfg=None):
        cfg = cfg or cfgs[name]
        tree = shard_params(_nest(inp, f"w/{name}"), plan, ms, cfg=cfg)
        return params_from_numpy(tree, cfg, trainable=True)

    def whole(params, plan, ms, cfg):
        """Every leaf with its ZeRO-3 shards gathered over the data axis."""
        lay = TreeLayout(plan, ms, cfg)
        got = {}
        for k, v in _flat(params):
            d = lay.fsdp_dim(k)
            if d is not None:
                v = cr.all_gather_raw(v.detach().movedim(d, 0).contiguous(),
                                      cr.axis_group(ms, "data")).movedim(0, d)
            got[k] = v.detach().clone()
        return got

    def trained(name, plan, cfg, plans=False, steps=STEPS, ckpt=None):
        tr = Trainer(cfg, opt, TrainerConfig(total_steps=0, ckpt_dir=ckpt or out_dir,
                                             ckpt_every=1 if ckpt else 0, ckpt_async=False,
                                             reconfig_every=10**6), plan, mesh=mesh, device="cpu")
        tr.params, tr.opt_state = load(name, plan, mesh, cfg), None
        tr.opt_state = init_adamw(tr.params, opt)
        if plans:
            tr.controlplane = ControlPlane(num_layers=2, num_experts=8, num_devices=2)
            tr._apply_layer_plans([LayerPlan(li, True, perm=np.array(pm)) for li, pm in PLANS])
        tr.tcfg.total_steps = steps
        tr.train(_Batches(inp, name))
        return tr

    # ZeRO-3, replicated, prefetch, and with a weight and a wire plan
    for name in ("moe", "dense"):
        cfg = cfgs[name]
        runs = {"z3": (z3, cfg, False), "rep": (rep, cfg, False),
                "pf": (z3, dataclasses.replace(cfg, fsdp_prefetch=True), False)}
        if name == "moe":
            runs.update({"z3_plans": (z3, cfg, True), "rep_plans": (rep, cfg, True)})
        for tag, (plan, c, plans) in runs.items():
            tr = trained(name, plan, c, plans)
            key = f"{name}/{tag}"
            out[f"{key}/losses"] = np.array([float(m["loss"]) for m in tr.metrics_log])
            out[f"{key}/gnorm"] = np.array([float(m["grad_norm"]) for m in tr.metrics_log])
            out.update({f"{key}/p{k}": v for k, v in whole(tr.params, plan, mesh, c).items()})
            if plans:
                out[f"{key}/wire"] = np.asarray(tr.wire_perm)
                out[f"{key}/moves"] = np.array([tr.reconfig_count, tr.wire_reconfig_count])
            if tag == "z3":
                out[f"{key}/held"] = sum(v.numel() for _, v in _flat(tr.params))

    # sequence parallelism against tensor parallelism (both ZeRO-3)
    cfg = cfgs["sp"]
    cfg_sp = dataclasses.replace(cfg, sp_shardmap=True)
    tok = t(inp["sp/tokens0"])[rows]
    params = load("sp", z3, mesh)
    with torch.no_grad():
        for tag, c in (("tp", cfg), ("sp", cfg_sp)):
            pf, _, _ = tfm.model_apply(params, {"tokens": tok}, c, z3, mesh=mesh, mode="prefill")
            out[f"sp/{tag}_logits"] = tfm.logits_from_features(params, pf, c, z3, mesh)
        f, _, _ = tfm.model_apply(params, {"tokens": tok}, cfg_sp, z3, mesh=mesh)
        out["sp/train_local"] = np.array(f.shape[1])
        out["sp/train_logits"] = tfm.logits_from_features(
            params, token_gather(f, z3, mesh, S), cfg_sp, z3, mesh)
    bytes0 = cr.wire_bytes().scale_out
    for tag, c in (("tp", cfg), ("sp", cfg_sp)):
        tr = trained("sp", z3, c)
        out[f"sp/{tag}_losses"] = np.array([float(m["loss"]) for m in tr.metrics_log])
        out.update({f"sp/{tag}/p{k}": v for k, v in whole(tr.params, z3, mesh, c).items()})
        bytes1 = cr.wire_bytes().scale_out
        out[f"sp/{tag}_model_bytes"], bytes0 = bytes1 - bytes0, bytes1

    # a ZeRO-3 checkpoint at step 1, restored replicated and on one device
    ck = os.path.join(out_dir, "z3_ckpt")
    tr = trained("dense", z3, cfgs["dense"], steps=1, ckpt=ck)
    out["ckpt/z3_p1"] = whole(tr.params, z3, mesh, cfgs["dense"])["/blocks/0_global/mlp/w_in"]
    tr.tcfg.ckpt_every, tr.tcfg.total_steps = 0, 2
    tr.train(_Batches(inp, "dense", 1))
    out["ckpt/z3_loss2"] = float(tr.metrics_log[-1]["loss"])
    tr = Trainer(cfgs["dense"], opt, TrainerConfig(total_steps=2, ckpt_dir=ck), rep,
                 mesh=mesh, device="cpu")
    assert tr.maybe_restore() and tr.step == 1
    out["ckpt/rep_p1"] = whole(tr.params, rep, mesh, cfgs["dense"])["/blocks/0_global/mlp/w_in"]
    tr.train(_Batches(inp, "dense", 1))
    out["ckpt/rep_loss2"] = float(tr.metrics_log[-1]["loss"])
    if rank == 0:
        tr = Trainer(cfgs["dense"], opt, TrainerConfig(total_steps=1, ckpt_dir=ck),
                     make_plan(None), device="cpu")
        assert tr.maybe_restore() and tr.step == 1
        out["ckpt/one_p1"] = tr.params["blocks"]["0_global"]["mlp"]["w_in"].detach().clone()
    dist.barrier()

    # pipeline stages: (2, 2) ("stage", "model") over make_plan(mesh) with the
    # prefetch on, against JAX; ZeRO-3 stages over ("stage", "data") against
    # the replicated stages
    batch = {"tokens": t(inp["moe/tokens0"]), "labels": t(inp["moe/labels0"])}
    for tag, shape, axes, plans in (("pp", (2, 2), ("stage", "model"), (None,)),
                                    ("ppd", (2, 2), ("stage", "data"), (True, False))):
        ms = make_mesh(shape, axes)
        cfg = dataclasses.replace(cfgs["moe"], fsdp_prefetch=tag == "pp")
        for fsdp in plans:
            pl = make_plan(ms) if fsdp is None else make_plan(ms, fsdp=fsdp)
            params = load("moe", pl, ms, cfg)
            step = make_pp_train_step(cfg, pl, opt, ms, pp_stages=2, microbatches=2)
            rows_of = {k: local_microbatch_rows(v, pl, ms, 2) for k, v in batch.items()}
            params, _, m = step(params, init_adamw(params, opt), rows_of)
            key = tag if fsdp is None else f"{tag}/{'z3' if fsdp else 'rep'}"
            out[f"{key}/loss"], out[f"{key}/gnorm"] = m["loss"], m["grad_norm"]
            lay = TreeLayout(pl, ms, cfg)
            for k, v in _flat(params):
                d = lay.fsdp_dim(k)
                if d is not None:
                    v = cr.all_gather_raw(v.detach().movedim(d, 0).contiguous(),
                                          cr.axis_group(ms, "data")).movedim(0, d)
                out[f"{key}/p{k}"] = v

    def conv(v):
        return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **{k: conv(v) for k, v in out.items()})

    # the launcher: the plan it builds, over a (2, 2) mesh (it destroys the
    # group when it ends)
    plans_seen = []

    class Seen(Trainer):
        def __init__(self, *a, **k):
            plans_seen.append(a[3])
            super().__init__(*a, **k)

    trainer_mod.Trainer = Seen
    launch_train.mesh_shape = lambda world: (2, 2)
    args = launch_train.parse(["--arch", "gemma2-2b", "--reduced", "--device", "cpu",
                               "--steps", "1", "--batch", "4", "--seq-len", "16"])
    res = launch_train.run(args, rank, 4)
    with open(os.path.join(out_dir, f"launch{rank}.json"), "w") as fh:
        json.dump({"fsdp_axis": plans_seen[0].fsdp_axis, "data": plans_seen[0].data_size,
                   "loss": res["first"]}, fh)


def _port_main(inp_path: str, out_dir: str, port: int) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_port_rank, args=(inp_path, out_dir, port), nprocs=4, join=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.train import free_port

    d = tmp_path_factory.mktemp("zero3")
    inp = _inputs()
    inp_path = str(d / "inputs.npz")
    np.savez(inp_path, **inp)
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + tests + os.pathsep + env.get("PYTHONPATH", "")
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    jcodes = [(f"TESTS = {json.dumps(tests)}\nIN = {json.dumps(inp_path)}\n"
               f"PART = {json.dumps(part)}\n"
               f"OUT = {json.dumps(str(d / f'jax_{part}.npz'))}\n" + JAX_MAIN) for part in "ab"]
    tcode = (f"import test_torch_zero3_sp as T; "
             f"T._port_main({json.dumps(inp_path)}, {json.dumps(str(d))}, {free_port()})")
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=e)
             for code, e in ((tcode, dict(env, OMP_NUM_THREADS="1")), (jcodes[0], jenv),
                             (jcodes[1], jenv))]
    for p, what in zip(procs, ("port", "JAX (a)", "JAX (b)")):
        so, se = p.communicate(timeout=600)
        if p.returncode != 0:
            for q in procs:
                q.kill()
            raise AssertionError(f"{what} side failed:\nSTDOUT:\n{so[-3000:]}\n"
                                 f"STDERR:\n{se[-6000:]}")
    jax_out = {**np.load(d / "jax_a.npz"), **np.load(d / "jax_b.npz")}
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]
    launch = [json.loads((d / f"launch{r}.json").read_text()) for r in range(4)]
    return jax_out, ranks, launch


class _GridMesh:
    """A mesh's rank grid and dim names, without a process group."""

    def __init__(self, shape, names):
        import torch

        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)
        self.mesh_dim_names = names

    def size(self, dim):
        return int(self.mesh.shape[dim])


def _model_part(a, key: str, rank: int, name: str, shape=(2, 2), names=("data", "model")):
    """Rank ``rank``'s model-axis part of the global leaf ``a`` (what the
    port's gathered-over-data leaves hold)."""
    from repro_torch.models import config as tc
    from repro_torch.parallel.sharding import TreeLayout, make_plan

    grid = _GridMesh(shape, names)
    return TreeLayout(make_plan(grid, fsdp=False), grid, _cfg(tc, name)).part(a, key, rank)


def _close(got, want, msg="", **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               err_msg=msg, **(tol or TOL))


def test_layout_shards_the_d_model_dims_over_the_data_axis():
    """The ZeRO-3 dims (the reference's init specs) beside the model axis's,
    the global shape back from a part, and a leaf whose ``d_model`` the data
    axis does not divide kept whole."""
    from repro_torch.models import config as tc
    from repro_torch.parallel.sharding import TreeLayout, make_plan

    grid = _GridMesh((2, 2), ("data", "model"))
    lay = TreeLayout(make_plan(grid), grid, _cfg(tc, "moe"))
    shapes = {"/blocks/0_global/attn/wq": ((2, 32, 4, 8), {1: 0, 2: 1}),
              "/blocks/0_global/attn/wo": ((2, 4, 8, 32), {3: 0, 1: 1}),
              "/blocks/0_global/moe/w_in": ((2, 8, 32, 32), {2: 0, 1: 1}),
              "/blocks/0_global/moe/w_out": ((2, 8, 32, 32), {3: 0, 1: 1}),
              "/blocks/0_global/moe/router": ((2, 32, 8), {}),
              "/blocks/0_global/norm1": ((2, 32), {}),
              "/embed": ((64, 32), {1: 0, 0: 1}), "/lm_head": ((32, 64), {0: 0, 1: 1}),
              "/opt/mu/blocks/0_global/attn/wk": ((2, 32, 2, 8), {1: 0, 2: 1})}
    for rank in range(4):
        data, model = divmod(rank, 2)
        for key, (shape, want) in shapes.items():
            idx = lay.slices(key, shape, rank)
            got = {i: s for i, s in enumerate(idx) if s != slice(None)}
            assert sorted(got) == sorted(want), key
            for dim, axis in want.items():
                k = shape[dim] // 2
                c = (data, model)[axis]
                assert got[dim] == slice(c * k, (c + 1) * k), (key, dim)
            part = tuple(s.stop - s.start if s != slice(None) else n for s, n in zip(idx, shape))
            assert lay.global_shape(key, part) == shape, key
    odd = TreeLayout(make_plan(grid), grid, dataclasses.replace(_cfg(tc, "moe"), d_model=33))
    assert odd.fsdp_dim("/blocks/0_global/attn/wq") is None
    assert TreeLayout(make_plan(grid, fsdp=False), grid, _cfg(tc, "moe")).data_blocks(
        "/embed") == (1, 2)
    assert lay.data_blocks("/embed") == (1, 1) and lay.data_blocks("/final_norm") is None


@pytest.mark.parametrize("name", ["moe", "dense"])
def test_zero3_trainer_steps_match_jax(runs, name):
    """The ZeRO-3 trainer at (2, 2), step for step: every loss and every
    updated parameter (the rank's model part, its data shards gathered)
    within 1e-5 of the JAX package's train step on ``make_plan(mesh)``."""
    jax_out, ranks, _ = runs
    for r, got in enumerate(ranks):
        _close(got[f"{name}/z3/losses"], [jax_out[f"{name}/loss{i}"] for i in range(STEPS)])
        keys = [k for k in got if k.startswith(f"{name}/z3/p/")]
        assert len(keys) == len([k for k in jax_out if k.startswith(f"{name}/p/")])
        for key in keys:
            leaf = key[len(f"{name}/z3/p"):]
            _close(got[key], _model_part(jax_out[f"{name}/p{leaf}"], leaf, r, name), key)


@pytest.mark.parametrize("case", ["moe/z3:moe/rep", "dense/z3:dense/rep",
                                  "moe/z3_plans:moe/rep_plans", "moe/pf:moe/z3",
                                  "dense/pf:dense/z3"])
def test_port_pairs_bit_for_bit(runs, case):
    """ZeRO-3 against the replicated plan (also with a weight move across
    ranks and a wire re-address), the ring prefetch against the on-demand
    gather: losses, clipping norms and every gathered parameter bit for bit."""
    _, ranks, _ = runs
    a, b = case.split(":")
    for got in ranks:
        for k in ("losses", "gnorm"):
            np.testing.assert_array_equal(got[f"{a}/{k}"], got[f"{b}/{k}"])
        keys = [k for k in got if k.startswith(f"{a}/p/")]
        assert keys
        for key in keys:
            np.testing.assert_array_equal(got[key], got[b + key[len(a):]], key)
    if "plans" in case:
        for got in ranks:
            np.testing.assert_array_equal(got[f"{a}/moves"], [2, 1])  # 2 plans, 1 on the wire
            np.testing.assert_array_equal(got[f"{a}/wire"], got[f"{b}/wire"])


def test_zero3_rank_holds_its_data_shard(runs):
    """A ZeRO-3 rank of (2, 2) holds half the parameters of a replicated
    one's model part (the router and the norms stay whole)."""
    _, ranks, _ = runs
    from repro_torch.models import config as tc
    from repro_torch.models.transformer import init_model
    from repro_torch.parallel.sharding import TreeLayout, make_plan

    grid = _GridMesh((2, 2), ("data", "model"))
    cfg = _cfg(tc, "moe")
    full = init_model(5, cfg, make_plan(None), device="cpu")
    rep = sum(v.numel() for _, v in _flat(TreeLayout(make_plan(grid, fsdp=False), grid,
                                                      cfg).shard(full, 0)))
    whole = sum(v.numel() for k, v in _flat(full) if k.endswith(("router", "norm1", "norm2",
                                                                   "final_norm")))
    assert int(ranks[0]["moe/z3/held"]) == (rep - whole) // 2 + whole


def test_sp_forward_equals_tp_and_jax(runs):
    """Sequence parallelism (``sp_shardmap=True``) over (2, 2): prefill
    logits and the train-mode features (the rank's sequence slice, gathered)
    equal tensor parallelism's bit for bit, and the JAX package's
    ``sp_shardmap=True`` forward within 1e-4 (``tests/test_system.py:147``)."""
    jax_out, ranks, _ = runs
    for r, got in enumerate(ranks):
        assert int(got["sp/train_local"]) == S // 2
        np.testing.assert_array_equal(got["sp/sp_logits"], got["sp/tp_logits"])
        np.testing.assert_array_equal(got["sp/train_logits"], got["sp/tp_logits"])
        di = r // 2
        _close(got["sp/sp_logits"], jax_out["sp/logits"][di * B // 2:(di + 1) * B // 2],
               **SP_TOL)


def test_sp_training_equals_tp_bit_for_bit(runs):
    """Three training steps with the sequence-sharded stream: losses and
    every gathered parameter tensor parallelism's bit for bit."""
    _, ranks, _ = runs
    for got in ranks:
        np.testing.assert_array_equal(got["sp/sp_losses"], got["sp/tp_losses"])
        keys = [k for k in got if k.startswith("sp/sp/p/")]
        assert keys
        for key in keys:
            np.testing.assert_array_equal(got[key], got["sp/tp/" + key[len("sp/sp/"):]], key)
        assert float(got["sp/sp_model_bytes"]) > 0


def test_zero3_checkpoint_restores_replicated_and_on_one_device(runs):
    """A ZeRO-3 checkpoint at step 1: the replicated (2, 2) trainer and one
    device restore the same parameters bit for bit, and the replicated
    step 2 equals the uninterrupted ZeRO-3 run's."""
    _, ranks, _ = runs
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["ckpt/rep_p1"], got["ckpt/z3_p1"])
        assert float(got["ckpt/rep_loss2"]) == float(got["ckpt/z3_loss2"])
    one = ranks[0]["ckpt/one_p1"]
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(
            _model_part(one, "/blocks/0_global/mlp/w_in", r, "dense"), got["ckpt/z3_p1"])


def test_pp_stages_over_fsdp_plan_match_jax_and_replicated(runs):
    """One pipelined step, 2 stages x 2 microbatches: over ("stage",
    "model") with ``fsdp_prefetch`` on and the plan of ``make_plan(mesh)``,
    within 1e-5 of the JAX package's ``make_pp_train_step``; over ("stage",
    "data") ZeRO-3 stages (each holding its data shards, gathering them once
    a step) equal the replicated stages bit for bit."""
    jax_out, ranks, _ = runs
    grid = ((2, 2), ("stage", "model"))
    for r, got in enumerate(ranks):
        _close(got["pp/loss"], jax_out["pp/loss"])
        keys = [k for k in got if k.startswith("pp/p/")]
        assert keys
        for key in keys:
            leaf = key[len("pp/p"):]
            want = _model_part(jax_out[f"pp/p{leaf}"], leaf, r, "moe", *grid)
            _close(got[key], want, key)
        for k in ("loss", "gnorm"):
            np.testing.assert_array_equal(got[f"ppd/z3/{k}"], got[f"ppd/rep/{k}"])
        keys = [k for k in got if k.startswith("ppd/z3/p/")]
        assert keys
        for key in keys:
            np.testing.assert_array_equal(got[key], got["ppd/rep/" + key[len("ppd/z3/"):]], key)


def test_launcher_builds_the_zero3_plan(runs):
    """``python -m repro_torch.launch.train`` builds ``make_plan(mesh)``, as
    the reference's launcher (``src/repro/launch/train.py:66``): over a
    (2, 2) mesh the data axis shards the parameters, and it trains."""
    _, _, launch = runs
    for got in launch:
        assert got["fsdp_axis"] == "data" and got["data"] == 2
        assert np.isfinite(got["loss"]) and got["loss"] == launch[0]["loss"]
