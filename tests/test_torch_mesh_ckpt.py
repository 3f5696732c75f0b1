"""Checkpoints over a mesh in the port, against the JAX package on the CPU:
one global checkpoint from the ``("data", "model")`` and the pipelined
``("stage", "model")`` trainers, restored under the same mesh (bit for bit,
placement and wire map included), under another mesh and on one rank (the
wire map folded into the perm stack), and interchanged with the JAX
package's trainer.

One JAX subprocess with 4 forced host devices and one 4-process gloo group
run side by side, once per module, on the same seeded numpy inputs (the
port's one-device draw of the tiny MoE config, and the batches).  The
interchange runs both ways through files: the JAX side writes its
4-device checkpoint first and then waits for the port's ``(1, 4)`` one.

Tolerances: restores under the same mesh bit for bit; a step after a
restore under another mesh, on one rank or in the other package within
``atol=rtol=1e-5`` of the uninterrupted run's (the reductions sum in
another order).  The models' balance-loss weight is 0: over a mesh that
loss is a mean of per-shard values (``ROADMAP.md`` §3, as the reference's),
another function at another model size; the router z-loss, a token mean,
stays.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

TOL = dict(atol=1e-5, rtol=1e-5)
TINY = dict(num_experts=8, top_k=2, d_ff=32, capacity_factor=8.0, backend="mixnet", a2a_group=2,
            balance_loss=0.0)
BLOCK_PERM = [2, 3, 0, 1, 6, 7, 4, 5]  # devices 0<->1, 2<->3 at P = 4: a wire re-address
SLOT_PERM = [2, 1, 0, 3, 4, 5, 6, 7]  # slot 0 <-> 2 across a block: the weight path
# PP(2) x EP(2), E = 4: a wire plan on layer 0 and weight moves on layers 1-2.
PP_PERMS = {0: [2, 3, 0, 1], 1: [1, 0, 2, 3], 2: [2, 1, 0, 3]}
WAIT_S = 300


def _tiny_cfg(mod, **moe):
    return mod.ModelConfig("tiny-moe8", "moe", 2, 32, 4, 2, 0, 64, dtype="float32",
                           remat="none", moe=mod.MoEConfig(**{**TINY, **moe}))


def _pp_cfg(mod):
    """``tests/test_pp_reconfig.py``'s model."""
    return mod.ModelConfig("tiny-moe", "moe", 4, 32, 3, 1, 0, 64, head_dim=8, dtype="float32",
                           remat="none",
                           moe=mod.MoEConfig(num_experts=4, top_k=2, d_ff=32,
                                             capacity_factor=2.0, backend="mixnet",
                                             overlap_chunks=2, balance_loss=0.0))


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


def _inputs() -> dict:
    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import config as tc
    from repro_torch.models.transformer import init_model
    from repro_torch.parallel.sharding import make_plan

    inp = {}
    for tag, cfg in (("tiny", _tiny_cfg(tc)), ("pp", _pp_cfg(tc))):
        params = init_model(1, cfg, make_plan(None), device="cpu")
        with torch.no_grad():
            inp.update({f"{tag}{k}": v.numpy() for k, v in _flat(params)})
    for tag, seed in (("b", 5), ("pb", 0), ("pc", 7)):
        data = SyntheticLM(64, 16, 4, seed=seed)
        for i in range(4):
            bt = next(data)
            inp[f"{tag}_tokens_{i}"] = bt.tokens.astype(np.int32)
            inp[f"{tag}_labels_{i}"] = bt.labels.astype(np.int32)
    rng = np.random.default_rng(3)
    inp["arr/w"] = np.arange(64.0).reshape(8, 8)
    inp["arr/experts"] = rng.standard_normal((2, 8, 4, 3)).astype(np.float32)
    inp["arr/bits"] = rng.integers(0, 1 << 16, size=(2, 8, 5), dtype=np.uint16)
    return inp


class _Batches:
    """The ``tag`` batches ``lo, lo + 1, ...`` of the inputs as a data
    iterator."""

    def __init__(self, inp, tag, lo=0):
        self.inp, self.tag, self.i = inp, tag, lo

    def __next__(self):
        i, self.i = self.i, self.i + 1
        return type("B", (), {"tokens": self.inp[f"{self.tag}_tokens_{i}"],
                              "labels": self.inp[f"{self.tag}_labels_{i}"]})


def _wait_for(path: str) -> None:
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > WAIT_S:
            raise TimeoutError(path)
        time.sleep(0.2)


# ---------------------------------------------------------------------------
# the JAX side: one subprocess with 4 host devices
# ---------------------------------------------------------------------------

JAX_MAIN = r"""
import dataclasses, os, sys
import numpy as np
import jax, jax.numpy as jnp
sys.path.insert(0, TESTS)
import test_torch_mesh_ckpt as T
from repro.launch.mesh import make_mesh, use_mesh
from repro.models import config as jc
from repro.optim import adamw as jadamw
from repro.parallel.sharding import make_plan
from repro.train import trainer as jtrainer

inp = dict(np.load(IN))
out = {}
cfg = T._tiny_cfg(jc)
opt = jadamw.AdamWConfig(lr=1e-3)
fresh = lambda: jax.tree.map(jnp.asarray, T._nest(inp, "tiny"))
jtrainer.init_all = lambda key, c, pl, o: (fresh(), None, jadamw.init_adamw(fresh(), o))


def train(tr, mesh, data, upto):
    tr.tcfg = dataclasses.replace(tr.tcfg, total_steps=upto)
    if mesh is None:
        tr.train(data)
    else:
        with use_mesh(mesh):
            tr.train(data)
    return [float(m["loss"]) for m in tr.metrics_log]


# a 4-device checkpoint at step 2, and the uninterrupted step 3
mesh = make_mesh((2, 2), ("data", "model"))
tr = jtrainer.Trainer(cfg, opt, jtrainer.TrainerConfig(total_steps=0, ckpt_every=2,
                      ckpt_dir=os.path.join(DIR, "jax_ckpt"), ckpt_async=False),
                      make_plan(mesh, fsdp=False), mesh=mesh)
data = T._Batches(inp, "b")
train(tr, mesh, data, 2)
tr.tcfg = dataclasses.replace(tr.tcfg, ckpt_every=0)
out["jax22/loss3"] = train(tr, mesh, data, 3)[-1]
open(os.path.join(DIR, "jax_ready"), "w").close()

# the port's (1, 4) checkpoint (a weight plan, no wire map) on one device
T._wait_for(os.path.join(DIR, "port_ready"))
tr = jtrainer.Trainer(cfg, opt, jtrainer.TrainerConfig(total_steps=0, reconfig_every=10**6,
                      ckpt_dir=os.path.join(DIR, "port_weight")), make_plan(None))
assert tr.maybe_restore() and tr.step == 2
out["jax1/perm"] = np.asarray(tr.expert_perm)
out["jax1/loss3"] = train(tr, None, T._Batches(inp, "b", 2), 3)[-1]
np.savez(OUT, **{k: np.asarray(v) for k, v in out.items()})
print("JAX_MESH_CKPT_OK")
"""


# ---------------------------------------------------------------------------
# the port side: 4 gloo ranks
# ---------------------------------------------------------------------------


def _port_rank(rank: int, inp_path: str, out_dir: str, port: int) -> None:
    import dataclasses

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from repro_torch.core.controlplane import LayerPlan
    from repro_torch.interop import params_from_numpy, shard_params
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models import config as tc
    from repro_torch.optim.adamw import AdamWConfig, init_adamw
    from repro_torch.parallel.sharding import TreeLayout, make_plan
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.trainer import Trainer, TrainerConfig

    init_distributed(rank=rank, world_size=4, init_method=f"tcp://localhost:{port}",
                     device_type="cpu")
    inp = dict(np.load(inp_path))
    out = {}
    opt = AdamWConfig(lr=1e-3)
    meshes = {"14": make_mesh((1, 4), ("data", "model")),
              "22": make_mesh((2, 2), ("data", "model")),
              "41": make_mesh((4, 1), ("data", "model")),
              "pp": make_mesh((2, 2), ("stage", "model"))}
    path = lambda *a: os.path.join(out_dir, *a)  # noqa: E731

    # an array saved under (4, 1) restores under (2, 2), the expert dim over
    # "model" (tests/test_system.py:102), and on one rank
    tree = {"params": {"w": torch.from_numpy(inp["arr/w"]),
                       "blocks": {"0_global": {"moe": {
                           "w_in": torch.from_numpy(inp["arr/experts"]),
                           "w_out": torch.from_numpy(inp["arr/bits"].view(np.int16)).view(
                               torch.bfloat16)}}}}}
    lay41 = TreeLayout(make_plan(meshes["41"], fsdp=False), meshes["41"], _tiny_cfg(tc))
    lay22 = TreeLayout(make_plan(meshes["22"], fsdp=False), meshes["22"], _tiny_cfg(tc))
    ckpt.save(path("arr41"), 1, tree, layout=lay41)
    back = ckpt.restore(path("arr41"), 1, lay22.shard(_zeros(tree)), layout=lay22)
    out["arr/22"] = back["params"]["blocks"]["0_global"]["moe"]["w_in"]
    out["arr/22_bits"] = back["params"]["blocks"]["0_global"]["moe"]["w_out"].view(torch.int16)
    out["arr/22_w"] = back["params"]["w"]
    ckpt.save(path("arr22"), 1, lay22.shard(tree), layout=lay22)  # parts -> global
    if rank == 0:
        one = ckpt.restore(path("arr22"), 1, _zeros(tree))
        out["arr/1"] = one["params"]["blocks"]["0_global"]["moe"]["w_in"]
        out["arr/1_bits"] = one["params"]["blocks"]["0_global"]["moe"]["w_out"].view(torch.int16)

    def trainer(cfg, tag, mk, *, ckpt_dir="", every=0, async_=False, reconfig=True, **kw):
        """A trainer over mesh ``mk`` (None: one rank) starting from the
        ``tag`` weights of the inputs (None: its own seeded draw)."""
        mesh = meshes.get(mk)
        plan = make_plan(mesh, fsdp=False)
        tr = Trainer(cfg, opt, TrainerConfig(total_steps=0, reconfig_every=10**6 if reconfig
                                             else 0, reconfig_min_gain=0.0, ckpt_every=every,
                                             ckpt_dir=ckpt_dir, ckpt_async=async_, **kw),
                     plan, mesh=mesh, device="cpu")
        if tag is not None:
            tr.params = params_from_numpy(shard_params(_nest(inp, tag), plan, mesh, cfg=cfg),
                                          cfg, trainable=True)
            tr.opt_state = init_adamw(tr.params, opt)
        return tr

    def train(tr, data, upto):
        tr.tcfg.total_steps = upto
        tr.train(data)
        return [float(m["loss"]) for m in tr.metrics_log]

    def state(tr, tag):
        out.update({f"{tag}/p{k}": v for k, v in _flat(tr.params)})
        out[f"{tag}/perm"] = tr.expert_perm
        out[f"{tag}/wire"] = tr.wire_perm if tr.wire_perm is not None else np.zeros(0)
        out[f"{tag}/counts"] = [tr.reconfig_count, tr.wire_reconfig_count]

    cfg = _tiny_cfg(tc)
    # the port's (1, 4) checkpoint for the JAX package: a weight plan only
    tr = trainer(cfg, "tiny", "14", ckpt_dir=path("port_weight"), every=2)
    data = _Batches(inp, "b")
    train(tr, data, 1)
    tr._apply_layer_plans([LayerPlan(1, True, perm=np.array(SLOT_PERM))])
    train(tr, data, 2)
    tr.tcfg.ckpt_every = 0
    out["w14/loss3"] = train(tr, data, 3)[-1]
    out["w14/perm2"] = tr.expert_perm
    dist.barrier()
    if rank == 0:
        open(path("port_ready"), "w").close()

    # the uninterrupted (1, 4) run: a wire and a weight plan before step 2,
    # checkpoints at step 2 (async into one directory, sync into another)
    tr = trainer(cfg, "tiny", "14", ckpt_dir=path("async"), every=2, async_=True)
    data = _Batches(inp, "b")
    losses = train(tr, data, 1)
    tr._apply_layer_plans([LayerPlan(0, True, perm=np.array(BLOCK_PERM)),
                           LayerPlan(1, True, perm=np.array(SLOT_PERM))])
    train(tr, data, 2)
    tr.tcfg = dataclasses.replace(tr.tcfg, ckpt_async=False, ckpt_dir=path("sync"))
    tr._checkpoint()
    tr.tcfg.ckpt_every = 0
    out["run/loss"] = train(tr, data, 4)
    state(tr, "run")
    # resumed on (1, 4), sync and async
    for how in ("sync", "async"):
        tr = trainer(cfg, "tiny", "14", ckpt_dir=path(how))
        assert tr.maybe_restore() and tr.step == 2
        out[f"{how}/loss"] = train(tr, _Batches(inp, "b", 2), 4)
        state(tr, how)
    # a trainer's mesh checkpoint into a serving engine over ("model",) of 4
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    m4 = make_mesh((4,), ("model",))
    tr = trainer(cfg, "tiny", "14", ckpt_dir=path("sync"))
    assert tr.maybe_restore()
    eng = ServeEngine(params_from_numpy(shard_params(_nest(inp, "tiny"), make_plan(m4), m4,
                                                     cfg=cfg), cfg),
                      cfg, make_plan(m4), ServeConfig(num_devices=4, external_control=True),
                      mesh=m4, device="cpu")
    assert eng.restore_checkpoint(path("sync")) == 2
    out.update({f"engine/p{k}": v for k, v in _flat(eng.params)})
    out.update({f"engine_ref/p{k}": v for k, v in _flat(tr.params)})
    out["engine/perm"], out["engine/wire"] = eng.batcher.expert_perm, eng.batcher.wire_perm
    out["engine_ref/perm"], out["engine_ref/wire"] = tr.expert_perm, tr.wire_perm
    # elastic: (2, 2) and one rank, the wire map folded
    tr = trainer(cfg, "tiny", "22", ckpt_dir=path("sync"))
    assert tr.maybe_restore()
    out["e22/loss3"] = train(tr, _Batches(inp, "b", 2), 3)[-1]
    out["e22/perm"], out["e22/wire"] = tr.expert_perm, np.asarray(tr.wire_perm is None)
    if rank == 0:
        tr = trainer(cfg, "tiny", None, ckpt_dir=path("sync"))
        assert tr.maybe_restore()
        out["e1/loss3"] = train(tr, _Batches(inp, "b", 2), 3)[-1]
        out["e1/perm"] = tr.expert_perm

    # a restore that changes the number of virtual experts raises
    vcfg = _tiny_cfg(tc, num_experts=2, top_k=1)
    tr = trainer(vcfg, None, "14", ckpt_dir=path("virt"), every=1)
    train(tr, _Batches(inp, "b"), 1)
    if rank == 0:
        for reconfig in (True, False):
            tr = trainer(vcfg, None, None, ckpt_dir=path("virt"), reconfig=reconfig)
            try:
                tr.maybe_restore()
                out[f"virt/raised{int(reconfig)}"] = False
            except ValueError:
                out[f"virt/raised{int(reconfig)}"] = True
        # a moved placement into a trainer without a control plane
        tr = trainer(cfg, "tiny", None, ckpt_dir=path("sync"), reconfig=False)
        try:
            tr.maybe_restore()
            out["moved/raised"] = False
        except ValueError:
            out["moved/raised"] = True

    # PP(2) x EP(2): the round trip with placement, then onto flat (1, 4)
    pcfg = _pp_cfg(tc)
    pkw = dict(pp_stages=2, num_microbatches=2)
    tr = trainer(pcfg, "pp", "pp", ckpt_dir=path("pp"), every=2, **pkw)
    data = _Batches(inp, "pb")
    train(tr, data, 2)
    tr._apply_layer_plans([LayerPlan(layer, True, perm=np.array(p))
                           for layer, p in PP_PERMS.items()])
    train(tr, data, 4)
    tr2 = trainer(pcfg, "pp", "pp", ckpt_dir=path("pp"), **pkw)
    assert tr2.maybe_restore() and tr2.step == 4
    state(tr, "pp_run")
    state(tr2, "pp_back")
    out["pp_run/loss5"] = train(tr, _Batches(inp, "pc"), 5)[-1]
    out["pp_back/loss5"] = train(tr2, _Batches(inp, "pc"), 5)[-1]
    tr = trainer(pcfg, "pp", "14", ckpt_dir=path("pp"), num_microbatches=2)
    assert tr.maybe_restore() and tr.step == 4
    out["pp_flat/loss5"] = train(tr, _Batches(inp, "pc"), 5)[-1]

    # the JAX package's 4-device checkpoint into the port's (2, 2) trainer
    _wait_for(path("jax_ready"))
    tr = trainer(cfg, "tiny", "22", ckpt_dir=path("jax_ckpt"), reconfig=False)
    assert tr.maybe_restore() and tr.step == 2
    out["from_jax/loss3"] = train(tr, _Batches(inp, "b", 2), 3)[-1]

    def conv(v):
        if isinstance(v, torch.Tensor):
            return v.detach().numpy()
        return np.asarray(v)

    np.savez(path(f"rank{rank}.npz"), **{k: conv(v) for k, v in out.items()})
    dist.barrier()
    dist.destroy_process_group()


def _zeros(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def _port_main(inp_path: str, out_dir: str, port: int) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_port_rank, args=(inp_path, out_dir, port), nprocs=4, join=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.train import free_port

    d = tmp_path_factory.mktemp("mesh_ckpt")
    inp = _inputs()
    inp_path = str(d / "inputs.npz")
    np.savez(inp_path, **inp)
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + tests + os.pathsep + env.get("PYTHONPATH", "")
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    jcode = (f"TESTS = {json.dumps(tests)}\nIN = {json.dumps(inp_path)}\n"
             f"DIR = {json.dumps(str(d))}\nOUT = {json.dumps(str(d / 'jax.npz'))}\n" + JAX_MAIN)
    tcode = (f"import test_torch_mesh_ckpt as T; "
             f"T._port_main({json.dumps(inp_path)}, {json.dumps(str(d))}, {free_port()})")
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=e)
             for code, e in ((tcode, dict(env, OMP_NUM_THREADS="1")), (jcode, jenv))]
    for p, what in zip(procs, ("port", "JAX")):
        so, se = p.communicate(timeout=600)
        if p.returncode != 0:
            for q in procs:
                q.kill()
            raise AssertionError(f"{what} side failed:\nSTDOUT:\n{so[-3000:]}\n"
                                 f"STDERR:\n{se[-6000:]}")
    jax_out = dict(np.load(d / "jax.npz"))
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]
    return jax_out, ranks, inp


def test_array_saved_under_one_mesh_restores_under_another(runs):
    """Port of ``tests/test_system.py:102``: saved under (4, 1), restored
    under (2, 2) with the expert dim over "model", exactly (a bf16 leaf
    too); parts saved under (2, 2) restore whole on one rank."""
    _, ranks, inp = runs
    for r, got in enumerate(ranks):
        m = r % 2
        np.testing.assert_array_equal(got["arr/22"], inp["arr/experts"][:, m * 4:(m + 1) * 4])
        np.testing.assert_array_equal(got["arr/22_bits"].view(np.uint16),
                                      inp["arr/bits"][:, m * 4:(m + 1) * 4])
        np.testing.assert_array_equal(got["arr/22_w"], inp["arr/w"])
    np.testing.assert_array_equal(ranks[0]["arr/1"], inp["arr/experts"])
    np.testing.assert_array_equal(ranks[0]["arr/1_bits"].view(np.uint16), inp["arr/bits"])


@pytest.mark.parametrize("how", ["sync", "async"])
def test_mesh_resume_is_bit_for_bit(runs, how):
    """(1, 4) with a wire and a weight plan: steps 3-4 after a restore of
    step 2 equal the uninterrupted run's, losses, parameters, perm stack,
    wire map and counts."""
    _, ranks, _ = runs
    for got in ranks:
        assert (got["run/wire"] != np.arange(4)).any()
        np.testing.assert_array_equal(got[f"{how}/loss"], got["run/loss"][2:])
        for key in got:
            if key.startswith("run/") and key != "run/loss":
                np.testing.assert_array_equal(got[f"{how}/{key[4:]}"], got[key], key)


@pytest.mark.parametrize("where", ["e22", "e1"])
def test_elastic_restore_folds_the_wire_map(runs, where):
    """Restored onto (2, 2) and onto one rank: the wire map folded into the
    perm stack, the next loss within 1e-5 of the uninterrupted run's."""
    _, ranks, _ = runs
    run = ranks[0]
    wire = run["run/wire"]
    perm = run["run/perm"]
    epd = perm.shape[1] // wire.shape[1]
    folded = np.take_along_axis(wire, perm // epd, axis=1) * epd + perm % epd
    for got in (ranks if where == "e22" else ranks[:1]):
        np.testing.assert_array_equal(got[f"{where}/perm"], folded)
        np.testing.assert_allclose(got[f"{where}/loss3"], got["run/loss"][2], **TOL)
    if where == "e22":
        assert all(bool(got["e22/wire"]) for got in ranks)  # the identity: no wire map


def test_restore_changing_virtual_experts_raises(runs):
    _, ranks, _ = runs
    assert bool(ranks[0]["virt/raised1"]) and bool(ranks[0]["virt/raised0"])


def test_moved_placement_needs_a_control_plane(runs):
    """A checkpoint whose experts moved does not restore into a trainer
    that carries no placement: its router would address the wrong slots."""
    _, ranks, _ = runs
    assert bool(ranks[0]["moved/raised"])


def test_trainer_checkpoint_restores_into_mesh_engine(runs):
    """The (1, 4) trainer's step-2 checkpoint restored into an engine over
    ("model",) of 4: every parameter and the placement equal the restored
    trainer's, bit for bit, on every rank."""
    _, ranks, _ = runs
    for got in ranks:
        keys = [k for k in got if k.startswith("engine/")]
        assert len(keys) > 4
        for key in keys:
            np.testing.assert_array_equal(got[key], got["engine_ref/" + key[7:]], key)


def test_pipelined_round_trip_with_placement(runs):
    """Port of ``tests/test_pp_reconfig.py:101-138``: the PP(2) x EP(2)
    trainer's step-4 checkpoint restores its parameters, perm stack, wire
    map and counts bit for bit, and the next step's loss with them."""
    _, ranks, _ = runs
    for got in ranks:
        assert sum(got["pp_run/counts"]) >= 2 and (got["pp_run/wire"] != np.arange(2)).any()
        for key in got:
            if key.startswith("pp_run/") and key != "pp_run/loss5":
                np.testing.assert_array_equal(got["pp_back/" + key[7:]], got[key], key)
        np.testing.assert_array_equal(got["pp_back/loss5"], got["pp_run/loss5"])


def test_pipelined_checkpoint_restores_onto_flat_mesh(runs):
    _, ranks, _ = runs
    for got in ranks:
        np.testing.assert_allclose(got["pp_flat/loss5"], got["pp_run/loss5"], **TOL)


def test_jax_mesh_checkpoint_restores_into_port(runs):
    jax_out, ranks, _ = runs
    for got in ranks:
        np.testing.assert_allclose(got["from_jax/loss3"], jax_out["jax22/loss3"], **TOL)


def test_port_mesh_checkpoint_restores_into_jax(runs):
    """A (1, 4) checkpoint with a weight plan and no wire map: the JAX
    trainer on one device restores its perm stack and takes the next step
    within 1e-5 of the port's."""
    jax_out, ranks, _ = runs
    np.testing.assert_array_equal(jax_out["jax1/perm"], ranks[0]["w14/perm2"])
    np.testing.assert_allclose(jax_out["jax1/loss3"], ranks[0]["w14/loss3"], **TOL)
