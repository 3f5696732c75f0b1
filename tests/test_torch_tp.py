"""Tensor parallelism over the model axis in the port against the JAX package
on the CPU: attention heads (the kv-head repeat at H = 8, Hkv = 2 over P = 4,
and H = Hkv = 4), the MLP's columns and rows, the shared expert, the
vocab-parallel embedding, head and loss, on the ``(1, 4)`` and ``(2, 2)``
``("data", "model")`` meshes; training the ``einsum`` and ``dense_decode``
MoE backends over a mesh; a TP checkpoint, serving over ``("model",)`` and
pipeline stages with TP inside.

Two JAX subprocesses with 4 forced host devices (one a mesh) and one
4-process gloo group run side by side on the same seeded weights (the
port's one-device draws, handed to both as numpy).  The second JAX part
waits for the port's checkpoint (its ``port_ready`` marker) and restores it
into its trainer.

Tolerances: ``atol=rtol=1e-5`` against the JAX package (XLA and PyTorch sum
in other orders; the ranks sum the row-parallel partials in f32); port
against one device: the init parts and the embedding lookup exactly, the
vocab-parallel loss and its gradients within 1e-6; port against port, bit
for bit: the replicated leaves across each model group, paged against
dense decode, PP(2) against PP(1).
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
CE_TOL = dict(atol=1e-6, rtol=1e-6)
MESHES = {"14": (1, 4), "22": (2, 2)}
CFGS = ("kvrep", "kv4", "moe")
SEED = 3
WAIT_S = 300


def _cfg(mod, name):
    """``kvrep``: 8 q / 2 kv heads (repeated over P = 4), geglu, a tied
    head and gemma2's final softcap; ``kv4``: 4 / 4 heads, swiglu;
    ``moe``: the einsum backend with a shared expert."""
    if name == "kvrep":
        return mod.ModelConfig("tp-kvrep", "dense", 2, 32, 8, 2, 64, 128, dtype="float32",
                               remat="none", act="geglu", tie_embeddings=True,
                               final_softcap=30.0)
    if name == "kv4":
        return mod.ModelConfig("tp-kv4", "dense", 2, 32, 4, 4, 64, 128, dtype="float32",
                               remat="none", act="swiglu")
    return mod.ModelConfig("tp-moe", "moe", 2, 32, 4, 2, 0, 64, dtype="float32", remat="none",
                           moe=mod.MoEConfig(num_experts=8, top_k=2, d_ff=32, capacity_factor=8.0,
                                             num_shared_experts=1, backend="einsum"))


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


def _requests(gen):
    import dataclasses

    return [dataclasses.replace(r, prompt_len=12, max_new_tokens=4) for r in gen.generate(3)]


def _tokens(finished) -> str:
    return json.dumps(sorted((int(r.rid), [int(t) for t in r.out]) for r in finished))


class _Batches:
    """The batches ``lo, lo + 1, ...`` of the inputs as a data iterator."""

    def __init__(self, inp, lo=0):
        self.inp, self.i = inp, lo

    def __next__(self):
        i, self.i = self.i, self.i + 1
        return type("B", (), {"tokens": self.inp[f"b_tokens_{i}"],
                              "labels": self.inp[f"b_labels_{i}"]})


def _wait_for(path: str) -> None:
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > WAIT_S:
            raise TimeoutError(path)
        time.sleep(0.2)


def _layer_inputs(inp: dict, rng) -> None:
    """The MoE layer cases: layer 0 of the ``moe`` model's weights, an
    einsum input ``[4, 16, 32]`` and a decode input ``[6, 1, 32]`` with
    their cotangents."""
    for case, shape in (("einsum", (4, 16, 32)), ("dense_decode", (6, 1, 32))):
        inp[f"{case}/x"] = rng.standard_normal(shape).astype(np.float32)
        inp[f"{case}/cot"] = rng.standard_normal(shape).astype(np.float32)


def _inputs() -> dict:
    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import config as tc
    from repro_torch.models.transformer import init_model
    from repro_torch.parallel.sharding import make_plan

    inp = {}
    for name in CFGS:
        params = init_model(SEED, _cfg(tc, name), make_plan(None), device="cpu")
        with torch.no_grad():
            inp.update({f"w/{name}{k}": v.numpy() for k, v in _flat(params)})
    rng = np.random.default_rng(7)
    inp["tokens"] = rng.integers(0, 64, (4, 16)).astype(np.int32)
    inp["labels"] = rng.integers(0, 64, (4, 16)).astype(np.int32)
    inp["feats"] = rng.standard_normal((4, 16, 32)).astype(np.float32)
    inp["labels128"] = rng.integers(0, 128, (4, 16)).astype(np.int32)
    _layer_inputs(inp, rng)
    data = SyntheticLM(128, 16, 4, seed=5)
    for i in range(3):
        bt = next(data)
        inp[f"b_tokens_{i}"] = bt.tokens.astype(np.int32)
        inp[f"b_labels_{i}"] = bt.labels.astype(np.int32)
    return inp


# ---------------------------------------------------------------------------
# the JAX side: two subprocesses with 4 host devices
# ---------------------------------------------------------------------------

JAX_MAIN = r"""
import dataclasses, os, sys
import numpy as np
import jax, jax.numpy as jnp
sys.path.insert(0, TESTS)
import test_torch_tp as T
from repro.launch.mesh import make_mesh, use_mesh
from repro.models import config as jc
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.parallel.sharding import make_plan
from repro.serve.engine import ServeConfig, ServeEngine
from repro.serve.workload import WorkloadGenerator
from repro.train import train_step as jts
from repro.train import trainer as jtrainer

inp = dict(np.load(IN))
out = {}
opt = jadamw.AdamWConfig(lr=1e-3)
cfgs = {n: T._cfg(jc, n) for n in T.CFGS}
fresh = lambda n: jax.tree.map(jnp.asarray, T._nest(inp, f"w/{n}"))
tok = jnp.asarray(inp["tokens"])
batch = {"tokens": tok, "labels": jnp.asarray(inp["labels"])}


def forward(n, plan, mesh):
    # The prefill's features are the train forward's (the same full-sequence
    # program); the port's train and prefill logits are both held to them.
    cfg, p = cfgs[n], fresh(n)
    pf, _, _ = jtfm.model_apply(p, {"tokens": tok}, cfg, plan, mesh=mesh, mode="prefill")
    step = jts.make_train_step(cfg, plan, opt, mesh=mesh)
    p1, _, m = step(p, jadamw.init_adamw(p, opt), batch)
    return {"logits": jtfm.logits_from_features(p, pf, cfg), "loss": m["loss"],
            "gnorm": m["grad_norm"], "p": p1}


# One program per mesh for its three models: part "a" the (1, 4) one and
# the layers, part "b" the (2, 2) one, the engine and the checkpoint.
mk = "14" if PART == "a" else "22"
mesh = make_mesh(T.MESHES[mk], ("data", "model"))
plan = make_plan(mesh, fsdp=False)
with use_mesh(mesh):
    res = jax.jit(lambda: {n: forward(n, plan, mesh) for n in T.CFGS})()
for n, r in res.items():
    for k in ("logits", "loss", "gnorm"):
        out[f"{mk}/{n}/{k}"] = r[k]
    out.update({f"{mk}/{n}/p{k}": v for k, v in T._flat(jax.tree.map(np.asarray, r["p"]))})
cfg = cfgs["moe"]
layer0 = jax.tree.map(lambda a: a[0], fresh("moe")["blocks"]["0_global"]["moe"])


def layer(case):
    mode = "decode" if case == "dense_decode" else None
    cot = jnp.asarray(inp[f"{case}/cot"])

    def loss(x, router):
        o, st = jmoe.moe_apply({**layer0, "router": router}, x, cfg, plan, mesh=mesh,
                               backend=case, mode=mode)
        return jnp.sum(o * cot) + 0.01 * st.balance_loss + 0.001 * st.z_loss, o

    (_, o), (gx, gr) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(inp[f"{case}/x"]), layer0["router"])
    return {"out": o, "gx": gx, "grouter": gr}


if PART == "a":
    # the einsum and dense_decode layers' gradients over (1, 4)
    with use_mesh(mesh):
        res = jax.jit(lambda: {c: layer(c) for c in ("einsum", "dense_decode")})()
    out.update({f"layer/{c}/{k}": v for c, r in res.items() for k, v in r.items()})
else:
    # the 4-device engine on the kv-repeat model, paged, one chunk an admission
    m4 = make_mesh((4,), ("model",))
    cfg = cfgs["kvrep"]
    gen = WorkloadGenerator("chat", seed=3, vocab_size=cfg.vocab_size)
    reqs = T._requests(gen)
    eng = ServeEngine(fresh("kvrep"), cfg, make_plan(m4),
                      ServeConfig(slots=2, max_len=32, paged=True, prefill_chunk=20), mesh=m4)
    with use_mesh(m4):
        eng.run(reqs, gen)
    out["engine"] = np.array(T._tokens(eng.batcher.finished))

    # the port's (1, 4) TP checkpoint at step 1, one step on one device
    T._wait_for(os.path.join(DIR, "port_ready"))
    jtrainer.init_all = lambda key, c, pl, o: (fresh("kvrep"), None,
                                               jadamw.init_adamw(fresh("kvrep"), o))
    tr = jtrainer.Trainer(cfg, opt, jtrainer.TrainerConfig(total_steps=2,
                          ckpt_dir=os.path.join(DIR, "tp_ckpt")), make_plan(None))
    assert tr.maybe_restore() and tr.step == 1
    tr.train(T._Batches(inp, 1))
    out["ckpt/jax1"] = float(tr.metrics_log[-1]["loss"])
np.savez(OUT, **{k: np.asarray(v) for k, v in out.items()})
print("JAX_TP_OK")
"""


# ---------------------------------------------------------------------------
# the port side: 4 gloo ranks
# ---------------------------------------------------------------------------


def _port_rank(rank: int, inp_path: str, out_dir: str, port: int) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from repro_torch.core import commruntime as cr
    from repro_torch.interop import params_from_numpy, shard_params
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models import config as tc
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import AdamWConfig, init_adamw
    from repro_torch.parallel.sharding import TreeLayout, make_plan
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.workload import WorkloadGenerator
    from repro_torch.train.pp_step import make_pp_train_step
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    init_distributed(rank=rank, world_size=4, init_method=f"tcp://localhost:{port}",
                     device_type="cpu")
    inp = dict(np.load(inp_path))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    out = {}
    opt = AdamWConfig(lr=1e-3)
    cfgs = {n: _cfg(tc, n) for n in CFGS}
    one = make_plan(None)

    def load(name, plan, mesh, trainable=False):
        cfg = cfgs[name]
        tree = shard_params(_nest(inp, f"w/{name}"), plan, mesh, cfg=cfg)
        return params_from_numpy(tree, cfg, trainable=trainable)

    tok, lab = t(inp["tokens"]), t(inp["labels"])
    for mk, shape in MESHES.items():
        mesh = make_mesh(shape, ("data", "model"))
        plan = make_plan(mesh, fsdp=False)
        di, b = cr.axis_index(mesh, "data"), tok.shape[0] // shape[0]
        rows = slice(di * b, (di + 1) * b)
        for name, cfg in cfgs.items():
            tag = f"{mk}/{name}"
            # the init over the mesh: the rank's parts of the one-device draw
            drawn = tfm.init_model(SEED, cfg, plan, device="cpu", mesh=mesh)
            want = dict(_flat(TreeLayout(plan, mesh, cfg).shard(
                tfm.init_model(SEED, cfg, one, device="cpu"))))
            got = dict(_flat(drawn))
            out[f"{tag}/init_exact"] = (got.keys() == want.keys()
                                        and all(torch.equal(got[k], want[k]) for k in want))
            params = load(name, plan, mesh, trainable=True)
            with torch.no_grad():
                feats, _, _ = tfm.model_apply(params, {"tokens": tok}, cfg, plan, mesh=mesh)
                out[f"{tag}/logits"] = tfm.logits_from_features(params, feats, cfg, plan, mesh)
                pf, _, _ = tfm.model_apply(params, {"tokens": tok}, cfg, plan, mesh=mesh,
                                           mode="prefill")
                out[f"{tag}/prefill"] = tfm.logits_from_features(params, pf, cfg, plan, mesh)
            step = make_train_step(cfg, plan, opt, mesh=mesh)
            state = init_adamw(params, opt)
            params, state, m = step(params, state, {"tokens": tok[rows], "labels": lab[rows]})
            out[f"{tag}/loss"], out[f"{tag}/gnorm"] = m["loss"], m["grad_norm"]
            out.update({f"{tag}/p{k}": v.detach().clone() for k, v in _flat(params)})
            # a second step: the replicated leaves stay bit-identical
            params, state, m = step(params, state, {"tokens": tok[rows], "labels": lab[rows]})
            out.update({f"{tag}/q{k}": v for k, v in _flat(params)})

    # port against one device: the vocab-parallel lookup and loss
    mesh = make_mesh((1, 4), ("data", "model"))
    plan = make_plan(mesh, fsdp=False)
    for name in ("kvrep", "kv4"):
        cfg = cfgs[name]
        whole, part = load(name, one, None, True), load(name, plan, mesh, True)
        toks = t(inp["tokens"])
        with torch.no_grad():
            out[f"embed/{name}"] = torch.equal(tfm.embed(part, toks, cfg, plan, mesh),
                                               tfm.embed(whole, toks, cfg))
        head = "embed" if cfg.tie_embeddings else "lm_head"
        labels = t(inp["labels128"])
        for tree, pl, ms, key in ((whole, one, None, "one"), (part, plan, mesh, "tp")):
            f = t(inp["feats"]).requires_grad_()
            ce = tfm.chunked_cross_entropy(tree, f, labels, cfg, plan=pl, mesh=ms)
            gf, gh = torch.autograd.grad(ce, [f, tree[head]])
            out[f"ce/{name}/{key}"], out[f"ce/{name}/{key}_gf"] = ce, gf
            out[f"ce/{name}/{key}_gh"] = gh

    # the einsum and dense_decode layers over (1, 4), trained
    cfg = cfgs["moe"]
    layer0 = {k: v[0] if not isinstance(v, dict) else {kk: vv[0] for kk, vv in v.items()}
              for k, v in load("moe", plan, mesh)["blocks"]["0_global"]["moe"].items()}
    for case in ("einsum", "dense_decode"):
        x = t(inp[f"{case}/x"]).requires_grad_()
        router = layer0["router"].clone().requires_grad_()
        o, st = moe_mod.moe_apply({**layer0, "router": router}, x, cfg, plan, mesh=mesh,
                                  backend=case, mode="decode" if case == "dense_decode" else None)
        loss = torch.sum(o * t(inp[f"{case}/cot"])) + 0.01 * st.balance_loss + 0.001 * st.z_loss
        gx, gr = torch.autograd.grad(loss, [x, router])
        out.update({f"layer/{case}/out": o, f"layer/{case}/gx": gx, f"layer/{case}/grouter": gr})

    # serving over ("model",) of 4: paged against dense, the JAX engine's tokens
    m4 = make_mesh((4,), ("model",))
    cfg = cfgs["kvrep"]
    before = cr.wire_bytes().scale_out
    for paged in (True, False):
        gen = WorkloadGenerator("chat", seed=3, vocab_size=cfg.vocab_size)
        p4 = make_plan(m4)
        eng = ServeEngine(load("kvrep", p4, m4), cfg, p4,
                          ServeConfig(slots=2, max_len=32, paged=paged, prefill_chunk=20),
                          mesh=m4, device="cpu")
        eng.run(_requests(gen), gen)
        out[f"engine/{int(paged)}"] = np.array(_tokens(eng.batcher.finished))
        pools = eng.batcher.caches["0_global"]["k"]
        out[f"engine/{int(paged)}_kv_heads"] = pools.shape[-2]
    out["engine/model_bytes"] = cr.wire_bytes().scale_out - before

    # a (1, 4) TP checkpoint at step 1, restored at (2, 2) and on one rank
    ckpt_dir = os.path.join(out_dir, "tp_ckpt")
    meshes = {"14": make_mesh((1, 4), ("data", "model")),
              "22": make_mesh((2, 2), ("data", "model"))}

    def trainer(mk, steps, every=0):
        ms = meshes.get(mk)
        pl = make_plan(ms, fsdp=False)
        tr = Trainer(cfg, opt, TrainerConfig(total_steps=steps, ckpt_every=every,
                                             ckpt_dir=ckpt_dir, ckpt_async=False),
                     pl, mesh=ms, device="cpu")
        tr.params = load("kvrep", pl, ms, trainable=True)
        tr.opt_state = init_adamw(tr.params, opt)
        return tr

    tr = trainer("14", 1, every=1)
    tr.train(_Batches(inp))
    tr.tcfg.ckpt_every, tr.tcfg.total_steps = 0, 2
    tr.train(_Batches(inp, 1))
    out["ckpt/run14"] = float(tr.metrics_log[-1]["loss"])
    dist.barrier()
    if rank == 0:
        open(os.path.join(out_dir, "port_ready"), "w").close()
    tr = trainer("22", 2)
    assert tr.maybe_restore() and tr.step == 1
    tr.train(_Batches(inp, 1))
    out["ckpt/tp22"] = float(tr.metrics_log[-1]["loss"])
    if rank == 0:
        tr = Trainer(cfg, opt, TrainerConfig(total_steps=2, ckpt_dir=ckpt_dir), one,
                     device="cpu")
        assert tr.maybe_restore() and tr.step == 1
        tr.train(_Batches(inp, 1))
        out["ckpt/one"] = float(tr.metrics_log[-1]["loss"])
    dist.barrier()

    # PP(2) against PP(1) at P = 2, TP inside the stages (the tied head)
    for tag, shape, axes, stages in (("pp2", (2, 2), ("stage", "model"), 2),
                                     ("pp1", (2, 1, 2), ("rep", "stage", "model"), 1)):
        ms = make_mesh(shape, axes)
        pl = make_plan(ms, fsdp=False)
        params = load("kvrep", pl, ms, trainable=True)
        state = init_adamw(params, opt)
        step = make_pp_train_step(cfg, pl, opt, ms, pp_stages=stages, microbatches=2)
        for i in range(2):
            bt = {"tokens": t(inp[f"b_tokens_{i}"]), "labels": t(inp[f"b_labels_{i}"])}
            params, state, m = step(params, state, bt)
        out[f"{tag}/loss"], out[f"{tag}/gnorm"] = m["loss"], m["grad_norm"]
        out.update({f"{tag}/p{k}": v for k, v in _flat(params)})

    def conv(v):
        return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **{k: conv(v) for k, v in out.items()})
    dist.barrier()
    dist.destroy_process_group()


def _port_main(inp_path: str, out_dir: str, port: int) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_port_rank, args=(inp_path, out_dir, port), nprocs=4, join=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.train import free_port

    d = tmp_path_factory.mktemp("tp")
    inp = _inputs()
    inp_path = str(d / "inputs.npz")
    np.savez(inp_path, **inp)
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + tests + os.pathsep + env.get("PYTHONPATH", "")
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    jcodes = [(f"TESTS = {json.dumps(tests)}\nIN = {json.dumps(inp_path)}\n"
               f"DIR = {json.dumps(str(d))}\nPART = {json.dumps(part)}\n"
               f"OUT = {json.dumps(str(d / f'jax_{part}.npz'))}\n" + JAX_MAIN) for part in "ab"]
    tcode = (f"import test_torch_tp as T; "
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
    return jax_out, ranks


class _GridMesh:
    """A mesh's rank grid and dim names, without a process group: what
    ``TreeLayout`` reads when every rank is named."""

    def __init__(self, shape, names):
        import torch

        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)
        self.mesh_dim_names = names

    def size(self, dim):
        return int(self.mesh.shape[dim])


def _layout(shape, names, name):
    from repro_torch.models import config as tc
    from repro_torch.parallel.sharding import TreeLayout, make_plan

    grid = _GridMesh(shape, names)
    cfg = _cfg(tc, name)
    return TreeLayout(make_plan(grid, fsdp=False), grid, cfg)


def _close(got, want, msg="", **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               err_msg=msg, **(tol or TOL))


def test_layout_shards_the_dense_leaves_by_the_reference_rules():
    """Which leaves the model axis shards, and on which dim."""
    lay = _layout((1, 4), ("data", "model"), "kvrep")  # H = 8, Hkv = 2 at P = 4
    shapes = {"/blocks/0_global/attn/wq": (2, 32, 8, 4), "/blocks/0_global/attn/wk": (2, 32, 2, 4),
              "/blocks/0_global/attn/wo": (2, 8, 4, 32), "/blocks/0_global/mlp/w_in": (2, 32, 64),
              "/blocks/0_global/mlp/w_out": (2, 64, 32), "/blocks/0_global/norm1": (2, 32),
              "/embed": (128, 32), "/final_norm": (32,)}
    want = {"/blocks/0_global/attn/wq": 2, "/blocks/0_global/attn/wk": None,
            "/blocks/0_global/attn/wo": 1, "/blocks/0_global/mlp/w_in": 2,
            "/blocks/0_global/mlp/w_out": 1, "/blocks/0_global/norm1": None, "/embed": 0,
            "/final_norm": None}
    for key, shape in shapes.items():
        idx = lay.slices(key, shape, 1)
        sharded = [i for i, s in enumerate(idx) if s != slice(None)]
        assert sharded == ([] if want[key] is None else [want[key]]), key
        part = tuple(s.stop - s.start if s != slice(None) else n for s, n in zip(idx, shape))
        assert lay.global_shape(key, part) == shape, key
        assert lay.replicated(key) == (want[key] is None), key
    moe = _layout((1, 4), ("data", "model"), "moe")
    assert moe.slices("/blocks/0_global/moe/shared/w_in", (2, 32, 32), 2)[2] == slice(16, 24)
    assert moe.replicated("/blocks/0_global/moe/router")
    with pytest.raises(NotImplementedError):  # a pool of repeated kv heads
        lay.slices("/kv/0_global/k", (2, 9, 4, 2, 4), 0)


@pytest.mark.parametrize("mk", list(MESHES))
@pytest.mark.parametrize("name", CFGS)
def test_init_over_mesh_is_the_one_device_draw(runs, mk, name):
    _, ranks = runs
    assert all(bool(got[f"{mk}/{name}/init_exact"]) for got in ranks)


@pytest.mark.parametrize("mk", list(MESHES))
@pytest.mark.parametrize("name", CFGS)
def test_forward_and_step_match_jax(runs, mk, name):
    """Train and prefill logits, one step's loss, clipping norm and updated
    parameters (each rank's parts) within 1e-5 of the JAX package's
    4-device program."""
    jax_out, ranks = runs
    lay = _layout(MESHES[mk], ("data", "model"), name)
    tag = f"{mk}/{name}"
    for r, got in enumerate(ranks):
        for k in ("logits", "prefill", "loss", "gnorm"):
            _close(got[f"{tag}/{k}"], jax_out[f"{tag}/{'logits' if k == 'prefill' else k}"])
        keys = [k for k in got if k.startswith(f"{tag}/p/")]
        assert keys and len(keys) == len([k for k in jax_out if k.startswith(f"{tag}/p/")])
        for key in keys:
            _close(got[key], lay.part(jax_out[key], key[len(f"{tag}/p"):], r), key)


@pytest.mark.parametrize("mk", list(MESHES))
@pytest.mark.parametrize("name", CFGS)
def test_replicated_leaves_bit_identical_across_model_group(runs, mk, name):
    """After two steps every leaf the layout replicates holds the same bits
    on every rank of a model group (and of the mesh); the tensor-parallel
    leaves are the rank's shards."""
    _, ranks = runs
    lay = _layout(MESHES[mk], ("data", "model"), name)
    tag = f"{mk}/{name}/q"
    sharded = 0
    for key in ranks[0]:
        if not key.startswith(tag + "/"):
            continue
        leaf = key[len(tag):]
        if lay.replicated(leaf):
            for got in ranks[1:]:
                np.testing.assert_array_equal(got[key], ranks[0][key], key)
        else:
            sharded += 1
    assert sharded > 0


@pytest.mark.parametrize("name", ["kvrep", "kv4"])
def test_vocab_parallel_embed_and_loss_against_one_device(runs, name):
    """The lookup exactly; the loss and its gradients (features, the rank's
    head slice) within 1e-6."""
    _, ranks = runs
    head_dim = 0 if name == "kvrep" else 1  # tied: the embedding is the head
    for r, got in enumerate(ranks):
        assert bool(got[f"embed/{name}"])
        _close(got[f"ce/{name}/tp"], got[f"ce/{name}/one"], **CE_TOL)
        _close(got[f"ce/{name}/tp_gf"], got[f"ce/{name}/one_gf"], **CE_TOL)
        whole = got[f"ce/{name}/one_gh"]
        n = whole.shape[head_dim] // 4
        _close(got[f"ce/{name}/tp_gh"], np.take(whole, range(r * n, (r + 1) * n), head_dim),
               **CE_TOL)


@pytest.mark.parametrize("case", ["einsum", "dense_decode"])
def test_dense_backends_train_over_mesh_match_jax(runs, case):
    """Output, input gradient and router gradient of the MoE layer (shared
    expert included) over (1, 4): within 1e-5 of the JAX package's; every
    rank holds the same bits."""
    jax_out, ranks = runs
    for got in ranks:
        for k in ("out", "gx", "grouter"):
            _close(got[f"layer/{case}/{k}"], jax_out[f"layer/{case}/{k}"])
            np.testing.assert_array_equal(got[f"layer/{case}/{k}"], ranks[0][f"layer/{case}/{k}"])


def test_mesh_serving_paged_equals_dense_and_jax(runs):
    """Over ("model",) of 4 with the kv heads repeated: every rank's tokens
    the same, paged equal to dense, equal to the JAX 4-device engine's; the
    pools hold the rank's one kv head; TP bytes counted on the model axis."""
    jax_out, ranks = runs
    for got in ranks:
        assert str(got["engine/1"]) == str(ranks[0]["engine/1"])
        assert str(got["engine/1"]) == str(got["engine/0"])
        assert json.loads(str(got["engine/1"])) == json.loads(str(jax_out["engine"]))
        assert int(got["engine/1_kv_heads"]) == 1 and int(got["engine/0_kv_heads"]) == 1
        assert float(got["engine/model_bytes"]) > 0


def test_tp_checkpoint_restores_across_meshes_and_into_jax(runs):
    """A (1, 4) checkpoint at step 1: step 2 after a restore at (2, 2), on
    one rank and in the JAX trainer, within 1e-5 of the uninterrupted run."""
    jax_out, ranks = runs
    want = float(ranks[0]["ckpt/run14"])
    for got in ranks:
        assert float(got["ckpt/run14"]) == want
        _close(got["ckpt/tp22"], want)
    _close(ranks[0]["ckpt/one"], want)
    _close(jax_out["ckpt/jax1"], want)


def test_pp2_equals_pp1_bit_for_bit_with_tp_inside(runs):
    """PP(2) x TP(2) against PP(1) x TP(2) after two steps: the loss, the
    clipping norm and every parameter part bit for bit."""
    _, ranks = runs
    lay = _layout((2, 1), ("stage", "model"), "kvrep")
    for r, got in enumerate(ranks):
        s, m = divmod(r, 2)
        ref = ranks[m]  # rep 0's PP(1) rank holding the same model shard
        for k in ("loss", "gnorm"):
            np.testing.assert_array_equal(got[f"pp2/{k}"], ref[f"pp1/{k}"])
        keys = [k for k in got if k.startswith("pp2/p/")]
        assert keys
        for key in keys:
            leaf = key[len("pp2/p"):]
            np.testing.assert_array_equal(got[key], lay.part(ref["pp1/p" + leaf], leaf, s), key)
