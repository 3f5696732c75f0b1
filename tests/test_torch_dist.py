"""The port's multi-device slice against the JAX package on the CPU: the
CommRuntime lowerings (flat, delegation, permuted and fused all-to-all, the
hierarchical all-reduce, the rings), the mixnet MoE layer over ``(1, 4)``
and ``(2, 2)`` meshes and a data-only ``(4, 1)`` one (dropless, capacity, a
wire re-address, the chunked overlap pipeline, virtual experts, a sequence
the model axis does not divide), one train step's loss and gradients at
``(2, 2)``, the runtime DP reduction on a ``(4,)`` data mesh with and
without int8 compression, and the trainer's wire and weight re-placement
branches and control loop.

One JAX subprocess in two halves (4 forced host devices, the mechanism of
``tests/conftest.py``'s ``run_multidevice``) and one 4-process gloo group
(``torch.multiprocessing``) run side by side on the same seeded numpy
inputs, once per module; the port's ranks take their shard of each global
tree through ``interop.shard_params``.  Tolerances: data movement, plans,
loads, slot maps and wire perms exactly; f32 values, losses and gradients
within ``atol=rtol=1e-5`` (XLA and PyTorch sum in other orders), the
updated parameters of an AdamW step within ``1e-5`` absolute, an int8
error-feedback residual within one quantum where a rounding flips.  Port
against port, bit for bit: wire vs weight re-placement, fused vs unfused
a2a, chunked vs serial, tracing on vs off, redundant leaves across a model
group, and P = 4 vs P = 1 for dropless outputs.
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
MESHES = {"14": (1, 4), "22": (2, 2), "41": (4, 1)}
# (name, mesh, MoE config overrides, x shape); every case at E = 8 top-2 but
# "virtual" (E = 2 top-1: r = 2 virtual experts at P = 4).  "41" is a
# data-only mesh: the layer sees the whole batch, as the reference's does,
# so "tight" (capacity factor 1) drops by global ranks.
KINDS = {
    "dropless": {}, "capacity": {"dispatch": "capacity"}, "wire": {},
    "chunked": {"overlap_chunks": 2}, "virtual": {"num_experts": 2, "top_k": 1}, "seqrep": {},
    "tight": {"dispatch": "capacity", "capacity_factor": 1.0},
}
MOE_CASES = [
    (f"{kind}_{mk}", mk, KINDS[kind], (4, 6 if kind == "seqrep" else 16, 32))
    for mk, kinds in (("14", ("dropless", "capacity", "wire", "chunked", "virtual", "seqrep")),
                      ("22", ("dropless", "capacity", "wire", "chunked", "virtual")),
                      ("41", ("dropless", "tight")))
    for kind in kinds
]
TINY = dict(num_experts=8, top_k=2, d_ff=32, capacity_factor=8.0, backend="mixnet", a2a_group=2)
BLOCK_PERM = [2, 3, 0, 1, 6, 7, 4, 5]  # devices 0<->1, 2<->3: a wire re-address
SLOT_PERM = [2, 1, 0, 3, 4, 5, 6, 7]  # slot 0 <-> 2 across a block: the weight path
FLUSH_PERM = [1, 0, 2, 3, 4, 5, 6, 7]  # within a block: flushes a pending wire perm


def _moe_cfg(mod, **kw):
    moe = dict(num_experts=8, top_k=2, d_ff=48, capacity_factor=8.0, a2a_group=2,
               backend="mixnet")
    moe.update(kw)
    return mod.ModelConfig("t", "moe", 2, 32, 4, 2, 64, 128, dtype="float32",
                           moe=mod.MoEConfig(**moe))


def _tiny_cfg(mod):
    return mod.ModelConfig("tiny-moe8", "moe", 2, 32, 4, 2, 0, 64, dtype="float32",
                           remat="none", moe=mod.MoEConfig(**TINY))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def _nest(flat: dict, prefix: str) -> dict:
    out: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
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
    from repro_torch.parallel.sharding import make_plan, virtual_experts
    from repro_torch.train.train_step import init_all

    rng = np.random.default_rng(23)
    inp = {
        "low_x": rng.standard_normal((16, 3, 5)).astype(np.float32),
        "low_ct": rng.standard_normal((16, 3, 5)).astype(np.float32),
        "low_ids": rng.integers(-1, 300, size=(16, 3)).astype(np.int32),
        "low_int": rng.integers(-50, 50, size=(16, 3)).astype(np.float32),
        "low_ring": rng.integers(-50, 50, size=(8, 3)).astype(np.float32),
        "low_rs": rng.integers(-50, 50, size=(32, 3)).astype(np.float32),
        "low_dest": np.array([2, 0, 3, 1], np.int32),
        "low_src": np.array([1, 3, 0, 2], np.int32),
    }
    for name, mk, kw, shape in MOE_CASES:
        cfg = _moe_cfg(tcfgmod, **kw)
        e = cfg.moe
        ev, r = virtual_experts(e.num_experts, MESHES[mk][1])
        f = e.d_ff // r
        inp[f"{name}/x"] = rng.standard_normal(shape).astype(np.float32)
        inp[f"{name}/cot"] = rng.standard_normal(shape).astype(np.float32)
        inp[f"{name}/router"] = rng.standard_normal((32, e.num_experts)).astype(np.float32) * 0.5
        for w, sh in (("w_in", (ev, 32, f)), ("w_gate", (ev, 32, f)), ("w_out", (ev, f, 32))):
            inp[f"{name}/{w}"] = (rng.standard_normal(sh) / np.sqrt(sh[1])).astype(np.float32)
        inp[f"{name}/perm"] = rng.permutation(ev).astype(np.int32)
        inp[f"{name}/wire"] = rng.permutation(MESHES[mk][1]).astype(np.int32)
    cfg = _tiny_cfg(tcfgmod)
    params, _, _ = init_all(1, cfg, make_plan(None), AdamWConfig(), device="cpu")
    for key, t in _flat(params):
        inp[f"params{key}"] = t.detach().numpy()
    b = next(iter(SyntheticLM(64, 16, 4, seed=0)))
    inp["tokens"], inp["labels"] = b.tokens.astype(np.int32), b.labels.astype(np.int32)
    inp["step_perm"] = np.stack([rng.permutation(8) for _ in range(2)]).astype(np.int32)
    data = SyntheticLM(64, 16, 4, seed=5)
    for i in range(3):
        bt = next(data)
        inp[f"train_tokens_{i}"] = bt.tokens.astype(np.int32)
        inp[f"train_labels_{i}"] = bt.labels.astype(np.int32)
    return inp


# ---------------------------------------------------------------------------
# the JAX side: one subprocess with 4 host devices
# ---------------------------------------------------------------------------

JAX_MAIN = r"""
import dataclasses, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
sys.path.insert(0, TESTS)
import test_torch_dist as T
from repro.core import commruntime as cr
from repro.core.controlplane import ControlPlane, LayerPlan
from repro.launch.mesh import make_mesh, use_mesh
from repro.models import config as jc
from repro.models import moe as jmoe
from repro.optim import adamw as jadamw
from repro.parallel.sharding import make_plan, shard_map
from repro.train import train_step as jts
from repro.train import trainer as jtrainer

inp = dict(np.load(IN))
out = {}
meshes = {k: make_mesh(v, ("data", "model")) for k, v in T.MESHES.items()}
m4 = make_mesh((4,), ("model",))
d4 = make_mesh((4,), ("data",))


def smap(f, mesh, ins, outs):
    return jax.jit(shard_map(f, mesh=mesh, in_specs=ins, out_specs=outs, check_vma=False))


if PART == "a":
    pm = P("model")
    x = inp["low_x"]
    out["low_flat"] = smap(lambda v: cr.flat_all_to_all(v, "model"), m4, pm, pm)(x)
    out["low_hier"] = smap(lambda v: cr.hierarchical_all_to_all(v, "model", 2), m4, pm, pm)(x)
    dp, sp = jnp.asarray(inp["low_dest"]), jnp.asarray(inp["low_src"])
    mix = shard_map(lambda v: cr.mixnet_all_to_all(v, "model", 2, dest_perm=dp, src_perm=sp),
                    mesh=m4, in_specs=pm, out_specs=pm, check_vma=False)
    y, vjp = jax.vjp(jax.jit(mix), x)
    out["low_mixnet"], out["low_mixnet_grad"] = y, vjp(jnp.asarray(inp["low_ct"]))[0]
    op = cr.AllToAll(cr.CommSpec(axis="model", axis_size=4, group_size=2))
    fx, fi = smap(lambda v, i: op.fused(v, i, dest_perm=dp), m4, (pm, pm), (pm, pm))(
        jnp.asarray(x, jnp.bfloat16), inp["low_ids"])
    out["low_fused_x"], out["low_fused_ids"] = np.asarray(fx.astype(jnp.float32)), fi
    dm = P(("data", "model"))
    out["low_hpsum"] = smap(lambda v: cr.hierarchical_psum(v, "model", "data"), meshes["22"],
                            dm, dm)(inp["low_int"])
    out["low_ring_ag"] = smap(lambda v: cr.ring_all_gather(v, "model"), m4, pm, pm)(inp["low_ring"])
    out["low_ring_rs"] = smap(lambda v: cr.ring_reduce_scatter(v, "model"), m4, pm, pm)(inp["low_rs"])


def moe_case(name, mk, kw):
    mesh, plan = meshes[mk], make_plan(meshes[mk], fsdp=False)
    cfg = T._moe_cfg(jc, **kw)
    perm = jnp.asarray(inp[f"{name}/perm"])
    wire = jnp.asarray(inp[f"{name}/wire"]) if name.startswith("wire") else None
    cot = jnp.asarray(inp[f"{name}/cot"])
    dsz = T.MESHES[mk][0]

    def loss(xx, p):
        o, st = jmoe.moe_apply(p, xx, cfg, plan, mesh=mesh, backend="mixnet", expert_perm=perm,
                               wire_perm=wire)
        return jnp.sum(o * cot) / dsz + 0.01 * st.balance_loss + 0.001 * st.z_loss, (o, st)

    params = {w: jnp.asarray(inp[f"{name}/{w}"]) for w in ("router", "w_in", "w_gate", "w_out")}
    (_, (o, st)), (gx, gp) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(inp[f"{name}/x"]), params)
    res = {"out": o, "load": st.expert_load, "balance": st.balance_loss, "z": st.z_loss,
           "drop": st.dropped_fraction, "gx": gx}
    res.update({f"g_{k}": v for k, v in gp.items()})
    return res


# One program per mesh for all of its cases: one compile each.
for mk in T.MESHES:
    if (mk == "14") != (PART == "a"):  # "22" and "41" in the second half
        continue
    cases = [c for c in T.MOE_CASES if c[1] == mk]
    with use_mesh(meshes[mk]):
        res = jax.jit(lambda: {c[0]: moe_case(*c[:3]) for c in cases})()
    out.update({f"{name}/{k}": v for name, r in res.items() for k, v in r.items()})

cfg = T._tiny_cfg(jc)
opt = jadamw.AdamWConfig(lr=1e-3)
batch = {"tokens": jnp.asarray(inp["tokens"]), "labels": jnp.asarray(inp["labels"])}
flat_params = {k: v for k, v in inp.items() if k.startswith("params/")}
fresh = lambda: jax.tree.map(jnp.asarray, T._nest(flat_params, "params"))
if PART == "b":
    mesh, plan = meshes["22"], make_plan(meshes["22"], fsdp=False)
    with use_mesh(mesh):
        (l, (ce, aux)), g = jax.jit(jax.value_and_grad(
            lambda p: jts.loss_fn(p, batch, cfg, plan, mesh, jnp.asarray(inp["step_perm"])),
            has_aux=True))(fresh())
    out["step/loss"], out["step/ce"], out["step/load"] = l, ce, aux.moe_stats
    out.update({f"step/g{k}": v for k, v in T._flat(jax.tree.map(np.asarray, g))})

    dplan = make_plan(d4, fsdp=False)
    steps = [jts.make_train_step(cfg, dplan, opt, mesh=d4, dp_comm="runtime", dp_compress=c)
             for c in (False, True)]


    def both(p0, p1):
        perm = jnp.asarray(inp["step_perm"])
        r0 = steps[0](p0, jadamw.init_adamw(p0, opt), batch, perm, None)
        r1 = steps[1](p1, jadamw.init_adamw(p1, opt), batch, perm, None,
                      jts.init_ef_residual(p1, dplan))
        return r0, r1


    with use_mesh(d4):
        results = jax.jit(both)(fresh(), fresh())
    for comp, res in enumerate(results):
        tag = f"runtime{comp}"
        for k in ("loss", "grad_norm", "expert_load", "balance_loss", "z_loss"):
            out[f"{tag}/{k}"] = res[2][k]
        out.update({f"{tag}/p{k}": v for k, v in T._flat(jax.tree.map(np.asarray, res[0]))})
        if comp:
            out.update({f"{tag}/r{k}": v for k, v in T._flat(jax.tree.map(np.asarray, res[3]))})


if PART == "a":
    jtrainer.init_all = lambda key, c, pl, o: (fresh(), None, jadamw.init_adamw(fresh(), o))
    mesh, plan = meshes["14"], make_plan(meshes["14"], fsdp=False)


    def make():
        return jtrainer.Trainer(cfg, opt, jtrainer.TrainerConfig(total_steps=1, reconfig_every=1),
                                plan, mesh=mesh)


    loss_jit = jax.jit(lambda p, pm, wr: jts.loss_fn(p, batch, cfg, plan, mesh, pm, wr)[0])


    def loss_of(t):
        wire = jnp.asarray(t.wire_perm, jnp.int32) if t.wire_perm is not None else None
        with use_mesh(mesh):
            return loss_jit(t.params, jnp.asarray(t.expert_perm), wire)


    plans = lambda: [LayerPlan(0, True, perm=np.array(T.BLOCK_PERM)),
                     LayerPlan(1, True, perm=np.array(T.SLOT_PERM))]
    tr, ref = make(), make()
    ref._wire_capable = lambda: False
    tr._apply_layer_plans(plans())
    ref._apply_layer_plans(plans())
    out["trainer/perm"], out["trainer/wire"] = tr.expert_perm, tr.wire_perm
    out["trainer/lw"], out["trainer/lr"] = loss_of(tr), loss_of(ref)
    for t in (tr, ref):
        t._apply_layer_plans([LayerPlan(0, True, perm=np.array(T.FLUSH_PERM))])
    out["trainer/flush_perm"], out["trainer/flush_wire"] = tr.expert_perm, tr.wire_perm
    out["trainer/flush_lw"], out["trainer/flush_lr"] = loss_of(tr), loss_of(ref)


np.savez(OUT, **{k: np.asarray(v) for k, v in out.items()})
print("JAX_DIST_OK")
"""


# ---------------------------------------------------------------------------
# the port side: 4 gloo ranks
# ---------------------------------------------------------------------------


def _port_rank(rank: int, inp_path: str, out_dir: str, port: int) -> None:
    import dataclasses

    import torch

    torch.set_num_threads(1)
    from repro_torch.core import commruntime as cr
    from repro_torch.core.controlplane import ControlPlane, LayerPlan
    from repro_torch.interop import params_from_numpy, shard_params
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models import config as tc
    from repro_torch.models import moe as moe_mod
    from repro_torch.obs import trace
    from repro_torch.optim.adamw import AdamWConfig, init_adamw
    from repro_torch.parallel.sharding import make_plan
    from repro_torch.train import train_step as ts
    from repro_torch.train.trainer import Trainer, TrainerConfig

    init_distributed(rank=rank, world_size=4, init_method=f"tcp://localhost:{port}",
                     device_type="cpu")
    inp = dict(np.load(inp_path))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    out = {}
    meshes = {k: make_mesh(v, ("data", "model")) for k, v in MESHES.items()}
    m4 = make_mesh((4,), ("model",))
    d4 = make_mesh((4,), ("data",))

    # lowerings: this rank's block of each global [4 * n, ...] input
    def mine(a, n=4):
        return t(a[rank * n:(rank + 1) * n])

    x = mine(inp["low_x"])
    lb0 = cr.wire_bytes()
    out["low_flat"] = cr.flat_all_to_all(x, m4, "model")
    lb1 = cr.wire_bytes()
    out["low_hier"] = cr.hierarchical_all_to_all(x, m4, "model", 2)
    lb2 = cr.wire_bytes()
    out["low_link_flat"] = [b - a for a, b in zip(dataclasses.astuple(lb0),
                                                  dataclasses.astuple(lb1))]
    out["low_link_hier"] = [b - a for a, b in zip(dataclasses.astuple(lb1),
                                                  dataclasses.astuple(lb2))]
    xg = x.clone().requires_grad_()
    y = cr.mixnet_all_to_all(xg, m4, "model", 2, dest_perm=inp["low_dest"],
                             src_perm=inp["low_src"])
    out["low_mixnet"] = y
    out["low_mixnet_grad"], = torch.autograd.grad(y, xg, mine(inp["low_ct"]))
    op = cr.AllToAll(cr.CommSpec(axis="model", axis_size=4, group_size=2, mesh=m4))
    fx, fi = op.fused(x.bfloat16(), mine(inp["low_ids"]), dest_perm=inp["low_dest"])
    ux = op(x.bfloat16(), dest_perm=inp["low_dest"])
    out["low_fused_x"], out["low_fused_ids"] = fx.float(), fi
    out["low_unfused_x"] = ux.float()
    mesh22 = meshes["22"]
    out["low_hpsum"] = cr.hierarchical_psum(mine(inp["low_int"]), mesh22, "model", "data")
    out["low_ring_ag"] = cr.ring_all_gather(mine(inp["low_ring"], 2), m4, "model")
    out["low_ring_rs"] = cr.ring_reduce_scatter(mine(inp["low_rs"], 8), m4, "model")
    out["low_rs_flat"] = cr.ReduceScatter(
        cr.CommSpec(axis="model", axis_size=4, mesh=m4))(mine(inp["low_rs"], 8))
    out["low_permute"] = cr.Permute(cr.CommSpec(axis="model", axis_size=4, mesh=m4))(x)

    # the MoE layer
    def moe_case(name, mk, kw, fuse=True, aux=True):
        mesh = meshes[mk]
        plan = make_plan(mesh, fsdp=False)
        cfg = _moe_cfg(tc, a2a_fuse=fuse, **kw)
        dsz, msz = MESHES[mk]
        di, mi = cr.axis_index(mesh, "data"), cr.axis_index(mesh, "model")
        xf = inp[f"{name}/x"]
        b = xf.shape[0] // dsz
        xl = t(xf[di * b:(di + 1) * b]).requires_grad_()
        ws = {}
        for w in ("router", "w_in", "w_gate", "w_out"):
            a = inp[f"{name}/{w}"]
            if w != "router":
                n = a.shape[0] // msz
                a = a[mi * n:(mi + 1) * n]
            ws[w] = t(a).requires_grad_()
        wire = inp[f"{name}/wire"] if name.startswith("wire") else None
        o, st = moe_mod.moe_apply(ws, xl, cfg, plan, mesh=mesh, backend="mixnet",
                                  expert_perm=t(inp[f"{name}/perm"]), wire_perm=wire)
        cot = t(inp[f"{name}/cot"][di * b:(di + 1) * b])
        loss = torch.sum(o * cot)
        if aux:
            loss = loss + 0.01 * st.balance_loss + 0.001 * st.z_loss
        g = torch.autograd.grad(loss, [xl, *ws.values()])
        grads = ts.reduce_grads({f"/moe/{k}": v for k, v in zip(ws, g[1:])}, plan, mesh, cfg)
        res = {"out": o, "load": st.expert_load, "balance": st.balance_loss, "z": st.z_loss,
               "drop": st.dropped_fraction, "gx": g[0] / dsz}
        res.update({f"g_{k.split('/')[-1]}": v for k, v in grads.items()})
        return res

    for name, mk, kw, _ in MOE_CASES:
        out.update({f"{name}/{k}": v for k, v in moe_case(name, mk, kw).items()})
        if name.split("_")[0] in ("dropless", "capacity"):
            un = moe_case(name, mk, kw, fuse=False)
            out[f"{name}/out_unfused"] = un["out"]
            out[f"{name}/gx_unfused"] = un["gx"]
    # P = 4 against P = 1 (no mesh) on the whole batch, and chunked with the
    # dropless case's inputs
    p1 = {w: t(inp["dropless_14/" + w]) for w in ("router", "w_in", "w_gate", "w_out")}
    o1, _ = moe_mod.moe_apply(p1, t(inp["dropless_14/x"]), _moe_cfg(tc), make_plan(None),
                              backend="mixnet", expert_perm=t(inp["dropless_14/perm"]))
    out["p1/out"] = o1
    # the routed output's router gradient: P = 4 (summed over the model
    # axis) against P = 1
    p1r = t(inp["dropless_14/router"]).requires_grad_()
    o1, _ = moe_mod.moe_apply({**p1, "router": p1r}, t(inp["dropless_14/x"]), _moe_cfg(tc),
                              make_plan(None), backend="mixnet",
                              expert_perm=t(inp["dropless_14/perm"]))
    out["p1/g_router"], = torch.autograd.grad(torch.sum(o1 * t(inp["dropless_14/cot"])), p1r)
    out["p4/g_router"] = moe_case("dropless_14", "14", {}, aux=False)["g_router"]
    for mk in MESHES:
        for k in ("x", "cot", "router", "w_in", "w_gate", "w_out", "perm"):
            inp[f"chunkdl_{mk}/{k}"] = inp[f"dropless_{mk}/{k}"]
        res = moe_case(f"chunkdl_{mk}", mk, {"overlap_chunks": 2})
        out[f"chunkdl_{mk}/out"], out[f"chunkdl_{mk}/gx"] = res["out"], res["gx"]

    # one train step's loss and gradients at (2, 2)
    cfg = _tiny_cfg(tc)
    opt = AdamWConfig(lr=1e-3)
    flat_params = {k: v for k, v in inp.items() if k.startswith("params/")}
    tree = _nest(flat_params, "params")
    mesh, plan = meshes["22"], make_plan(meshes["22"], fsdp=False)
    di = cr.axis_index(mesh, "data")

    def local_batch(tok, lab, n):
        b = tok.shape[0] // n
        i = cr.axis_index(mesh, "data") if n > 1 else 0
        return {"tokens": t(tok[i * b:(i + 1) * b]), "labels": t(lab[i * b:(i + 1) * b])}

    params = params_from_numpy(shard_params(tree, plan, mesh, cfg=cfg), cfg, trainable=True)
    metrics, grads = ts._local_grads(params, local_batch(inp["tokens"], inp["labels"], 2), cfg,
                                     plan, mesh, t(inp["step_perm"]), None)
    grads = ts.reduce_grads(grads, plan, mesh, cfg)
    out["step/loss"] = cr.all_reduce(metrics["loss"], cr.axis_group(mesh, "data")) / 2
    out["step/load"] = metrics["expert_load"]
    out["step/gnorm"] = ts._mesh_grad_norm(grads, plan, mesh, t(inp["step_perm"]), None, cfg)
    out.update({f"step/g{k}": v for k, v in grads.items()})

    # the runtime DP reduction on a (4,) data mesh
    dplan = make_plan(d4, fsdp=False)
    b = inp["tokens"].shape[0] // 4
    lb = {"tokens": t(inp["tokens"][rank * b:(rank + 1) * b]),
          "labels": t(inp["labels"][rank * b:(rank + 1) * b])}
    for comp in (False, True):
        step = ts.make_train_step(cfg, dplan, opt, mesh=d4, dp_comm="runtime", dp_compress=comp)
        p0 = params_from_numpy(tree, cfg, trainable=True)
        args = [p0, init_adamw(p0, opt), lb, t(inp["step_perm"]), None]
        if comp:
            args.append(ts.init_ef_residual(p0, dplan))
        res = step(*args)
        tag = f"runtime{int(comp)}"
        for k in ("loss", "grad_norm", "expert_load", "balance_loss", "z_loss"):
            out[f"{tag}/{k}"] = res[2][k]
        out.update({f"{tag}/p{k}": v for k, v in _flat(res[0])})
        if comp:
            out.update({f"{tag}/r{k}": v for k, v in _flat(res[3])})

    # the trainer's wire and weight branches at (1, 4)
    mesh, plan = meshes["14"], make_plan(meshes["14"], fsdp=False)
    batch = {"tokens": t(inp["tokens"]), "labels": t(inp["labels"])}

    def make(steps=1, every=1):
        tr = Trainer(cfg, opt, TrainerConfig(total_steps=steps, reconfig_every=every,
                                             reconfig_min_gain=0.0), plan, mesh=mesh,
                     device="cpu")
        tr.params = params_from_numpy(shard_params(tree, plan, mesh, cfg=cfg), cfg, trainable=True)
        tr.opt_state = init_adamw(tr.params, opt)
        return tr

    def loss_of(tr):
        with torch.no_grad():
            wire = None if tr.wire_perm is None else t(tr.wire_perm)
            return ts.loss_fn(tr.params, batch, cfg, plan, mesh, t(tr.expert_perm), wire)[0]

    def plans():
        return [LayerPlan(0, True, perm=np.array(BLOCK_PERM)),
                LayerPlan(1, True, perm=np.array(SLOT_PERM))]

    tr, ref = make(), make()
    ref._wire_capable = lambda: False
    w0 = tr.params["blocks"]["0_global"]["moe"]["w_in"][0].detach().clone()
    tr._apply_layer_plans(plans())
    ref._apply_layer_plans(plans())
    out["trainer/w0_kept"] = torch.equal(w0, tr.params["blocks"]["0_global"]["moe"]["w_in"][0])
    out["trainer/perm"], out["trainer/wire"] = tr.expert_perm, tr.wire_perm
    out["trainer/ref_perm"] = ref.expert_perm
    out["trainer/lw"], out["trainer/lr"] = loss_of(tr), loss_of(ref)
    for tt in (tr, ref):
        tt._apply_layer_plans([LayerPlan(0, True, perm=np.array(FLUSH_PERM))])
    out["trainer/flush_perm"], out["trainer/flush_wire"] = tr.expert_perm, tr.wire_perm
    out["trainer/flush_lw"], out["trainer/flush_lr"] = loss_of(tr), loss_of(ref)

    # wire vs weight over two training steps (plans applied before the
    # first: the moments stay in their slots, see train/trainer.py), and
    # tracing on vs off
    runs = {}
    for tag, wire_ok, traced in (("wire", True, False), ("weight", False, False),
                                 ("traced", True, True)):
        tr = make(steps=0, every=1000)  # plans only where injected below
        if not wire_ok:
            tr._wire_capable = lambda: False
        tr.controlplane = ControlPlane(num_layers=2, num_experts=8, num_devices=4)
        tr._apply_layer_plans(plans())
        (trace.enable if traced else trace.disable)()
        losses = []
        for i in range(2):
            tr.tcfg.total_steps = i + 1
            bt = type("B", (), {"tokens": inp[f"train_tokens_{i}"],
                                "labels": inp[f"train_labels_{i}"]})
            losses.append(tr.train(iter([bt]))[-1]["loss"])
        trace.disable()
        runs[tag] = tr
        out[f"wvw/{tag}_loss"] = np.stack(losses)
        out.update({f"wvw/{tag}{k}": v for k, v in _flat(tr.params)})
    out["wvw/wire_perm"] = runs["wire"].wire_perm
    # the control loop, plans from the reduced loads on every rank
    tr = make(steps=0, every=1)
    tr.controlplane = ControlPlane(num_layers=2, num_experts=8, num_devices=4,
                                   min_gain_fraction=0.0)
    loads, perms, wires = [], [], []
    for i in range(3):
        tr.tcfg.total_steps = i + 1
        bt = type("B", (), {"tokens": inp[f"train_tokens_{i}"],
                            "labels": inp[f"train_labels_{i}"]})
        loads.append(tr.train(iter([bt]))[-1]["expert_load"])
        perms.append(np.asarray(tr.expert_perm))
        wires.append(np.asarray(tr.wire_perm if tr.wire_perm is not None
                                else np.arange(4)[None].repeat(2, 0)))
    out["loop/load"], out["loop/perm"], out["loop/wire"] = np.stack(loads), np.stack(perms), \
        np.stack(wires)
    out["loop/counts"] = np.array([tr.reconfig_count, tr.wire_reconfig_count])
    # a rank that disagrees on the placement fails every rank
    if rank == 1:
        tr.controlplane.layer_perms[0] = tr.controlplane.layer_perms[0][::-1].copy()
    try:
        tr._check_plans_agree()
        out["loop/disagree_raised"] = False
    except RuntimeError:
        out["loop/disagree_raised"] = True
    out["staged"] = cr.host_staged_bytes()

    def conv(v):
        if isinstance(v, torch.Tensor):
            v = v.detach()
            return v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
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

    d = tmp_path_factory.mktemp("dist")
    inp = _inputs()
    inp_path = str(d / "inputs.npz")
    np.savez(inp_path, **inp)
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + tests + os.pathsep + env.get("PYTHONPATH", "")
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                JAX_PLATFORMS="cpu")
    # The JAX side in two halves (one compile-bound process each), beside
    # the port's four ranks.
    jcodes = [(f"TESTS = {json.dumps(tests)}\nIN = {json.dumps(inp_path)}\nPART = '{part}'\n"
               f"OUT = {json.dumps(str(d / f'jax_{part}.npz'))}\n" + JAX_MAIN) for part in "ab"]
    tenv = dict(env, OMP_NUM_THREADS="1")
    tcode = (f"import test_torch_dist as T; "
             f"T._port_main({json.dumps(inp_path)}, {json.dumps(str(d))}, {free_port()})")
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=e)
             for code, e in ((tcode, tenv), (jcodes[0], jenv), (jcodes[1], jenv))]
    for p, what in zip(procs, ("port", "JAX", "JAX")):
        so, se = p.communicate(timeout=600)
        if p.returncode != 0:
            for q in procs:
                q.kill()
            raise AssertionError(f"{what} side failed:\nSTDOUT:\n{so[-3000:]}\n"
                                 f"STDERR:\n{se[-6000:]}")
    jax_out = {**np.load(d / "jax_a.npz"), **np.load(d / "jax_b.npz")}
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]
    return jax_out, ranks, inp


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               **(tol or TOL))


def _close_quantized(got, want):
    """An error-feedback residual ``target - q * scale``: within TOL but
    where the two sides' targets straddle an int8 rounding boundary (they
    differ by ~1e-7 relative), which moves the residual by one quantum; at
    most 0.1% of the elements may do so."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    bad = diff > TOL["atol"] + TOL["rtol"] * np.abs(want)
    quantum = 2.0 * np.max(np.abs(want))  # |residual| <= scale / 2
    assert bad.mean() <= 1e-3, bad.mean()
    assert (diff[bad] <= quantum * (1 + 1e-3)).all(), (diff[bad], quantum)


def _coords(mk: str, rank: int) -> tuple[int, int]:
    return divmod(rank, MESHES[mk][1])


class _GridMesh:
    """A mesh's rank grid and dim names, without a process group: what
    ``TreeLayout`` reads when every rank is named."""

    def __init__(self, shape, names):
        import torch

        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)
        self.mesh_dim_names = names

    def size(self, dim):
        return int(self.mesh.shape[dim])


def _layout(mk: str):
    """The port's ``TreeLayout`` of the tiny model over mesh ``mk``."""
    from repro_torch.models import config as tc
    from repro_torch.parallel.sharding import TreeLayout, make_plan

    grid = _GridMesh(MESHES[mk], ("data", "model"))
    return TreeLayout(make_plan(grid, fsdp=False), grid, _tiny_cfg(tc))


# ---------------------------------------------------------------------------
# lowerings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,n", [("low_flat", 4), ("low_hier", 4), ("low_mixnet", 4),
                                    ("low_mixnet_grad", 4), ("low_fused_x", 4),
                                    ("low_fused_ids", 4), ("low_hpsum", 4), ("low_ring_ag", 8),
                                    ("low_ring_rs", 2)])
def test_lowering_matches_jax_exactly(runs, name, n):
    jax_out, ranks, _ = runs
    for r in range(4):
        np.testing.assert_array_equal(ranks[r][name], jax_out[name][r * n:(r + 1) * n])


def test_executed_wire_bytes_match_the_ops_accounting(runs):
    """Every executed collective records its per-device wire bytes by link
    class (``comm.link_bytes``): a flat and a delegation all-to-all of 240
    bytes record what ``AllToAll.bytes_on_link`` prices."""
    import dataclasses

    from repro_torch.core.commruntime import AllToAll, CommSpec

    _, ranks, _ = runs
    flat = AllToAll(CommSpec(axis="model", axis_size=4)).bytes_on_link(240.0)
    hier = AllToAll(CommSpec(axis="model", axis_size=4, group_size=2)).bytes_on_link(240.0)
    for got in ranks:
        np.testing.assert_array_equal(got["low_link_flat"], dataclasses.astuple(flat))
        np.testing.assert_array_equal(got["low_link_hier"], dataclasses.astuple(hier))


def test_lowering_port_invariants(runs):
    """The delegation lowering equals the flat one; the fused transfer moves
    the payload as the unfused one does; the flat reduce-scatter equals the
    ring on integers; Permute's default is the +1 ring shift."""
    _, ranks, inp = runs
    for r in range(4):
        np.testing.assert_array_equal(ranks[r]["low_hier"], ranks[r]["low_flat"])
        np.testing.assert_array_equal(ranks[r]["low_fused_x"], ranks[r]["low_unfused_x"])
        np.testing.assert_array_equal(ranks[r]["low_rs_flat"], ranks[r]["low_ring_rs"])
        np.testing.assert_array_equal(ranks[r]["low_permute"],
                                      inp["low_x"][((r - 1) % 4) * 4:((r - 1) % 4 + 1) * 4])


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [c[0] for c in MOE_CASES])
def test_moe_layer_matches_jax(runs, case):
    """Output, loads (exact), aux losses, drop fraction, and the gradients
    of x and every weight after the port's per-leaf reduction."""
    jax_out, ranks, _ = runs
    mk = case.rsplit("_", 1)[1]
    dsz, msz = MESHES[mk]
    for r in range(4):
        di, mi = _coords(mk, r)
        got = ranks[r]
        b = jax_out[f"{case}/out"].shape[0] // dsz
        _close(got[f"{case}/out"], jax_out[f"{case}/out"][di * b:(di + 1) * b])
        _close(got[f"{case}/gx"], jax_out[f"{case}/gx"][di * b:(di + 1) * b])
        np.testing.assert_array_equal(got[f"{case}/load"], jax_out[f"{case}/load"])
        for k in ("balance", "z", "drop", "g_router"):
            _close(got[f"{case}/{k}"], jax_out[f"{case}/{k}"])
        for w in ("w_in", "w_gate", "w_out"):
            full = jax_out[f"{case}/g_{w}"]
            n = full.shape[0] // msz
            _close(got[f"{case}/g_{w}"], full[mi * n:(mi + 1) * n])
    if case.startswith("tight"):
        assert float(jax_out[f"{case}/drop"]) > 0.0


@pytest.mark.parametrize("case", ["dropless_14", "capacity_14", "dropless_22", "capacity_22"])
def test_moe_fused_equals_unfused_bit_for_bit(runs, case):
    _, ranks, _ = runs
    for got in ranks:
        np.testing.assert_array_equal(got[f"{case}/out"], got[f"{case}/out_unfused"])
        np.testing.assert_array_equal(got[f"{case}/gx"], got[f"{case}/gx_unfused"])


@pytest.mark.parametrize("mk", list(MESHES))
def test_moe_chunked_equals_serial_bit_for_bit(runs, mk):
    _, ranks, _ = runs
    for got in ranks:
        np.testing.assert_array_equal(got[f"chunkdl_{mk}/out"], got[f"dropless_{mk}/out"])
        np.testing.assert_array_equal(got[f"chunkdl_{mk}/gx"], got[f"dropless_{mk}/gx"])


def test_moe_p4_equals_p1_dropless_bit_for_bit(runs):
    _, ranks, _ = runs
    for got in ranks:
        np.testing.assert_array_equal(got["dropless_14/out"], got["p1/out"])


def test_moe_router_grad_p4_equals_p1(runs):
    """The reference's router gradient over a mesh is not off by a factor
    of P: for the routed output alone (no per-shard aux loss), the port's
    P = 4 router gradient, summed over the model axis, is P = 1's."""
    _, ranks, _ = runs
    for got in ranks:
        _close(got["p4/g_router"], got["p1/g_router"])


def test_moe_model_group_outputs_identical(runs):
    """Every rank of a model group holds the same gathered output."""
    _, ranks, _ = runs
    for case, _, _, _ in MOE_CASES:
        mk = case.rsplit("_", 1)[1]
        for r in range(4):
            first = (r // MESHES[mk][1]) * MESHES[mk][1]
            np.testing.assert_array_equal(ranks[r][f"{case}/out"], ranks[first][f"{case}/out"])


# ---------------------------------------------------------------------------
# the train step and the DP reductions
# ---------------------------------------------------------------------------


def test_train_step_loss_and_grads_match_jax(runs):
    jax_out, ranks, _ = runs
    grads = {k[len("step/g"):]: v for k, v in jax_out.items() if k.startswith("step/g/")}
    norm = np.sqrt(sum(np.sum(np.square(v.astype(np.float64))) for v in grads.values()))
    layout = _layout("22")
    for r in range(4):
        got = ranks[r]
        _close(got["step/loss"], jax_out["step/loss"])
        np.testing.assert_array_equal(got["step/load"], jax_out["step/load"])
        _close(got["step/gnorm"], norm)
        for key, want in grads.items():
            # the rank's expert slots and tensor-parallel shard
            _close(got[f"step/g{key}"], layout.part(want, key, r))


def test_redundant_leaves_identical_across_model_group(runs):
    """Every leaf ``TreeLayout`` replicates: bit-identical gradients on both
    ranks of each model group at (2, 2), and bit-identical parameters on all
    four ranks after two trainer steps at (1, 4).  Each tensor-parallel
    leaf's gradient parts, placed into the whole leaf, equal the JAX
    package's gradient within the file's tolerance."""
    jax_out, ranks, _ = runs
    lay22, lay14 = _layout("22"), _layout("14")
    sharded = 0
    for key in ranks[0]:
        if not key.startswith("step/g/"):
            continue
        leaf = key[len("step/g"):]
        if lay22.replicated(leaf):
            for a, b in ((0, 1), (2, 3)):
                np.testing.assert_array_equal(ranks[a][key], ranks[b][key], key)
        elif leaf.split("/")[-2] != "moe":
            want = jax_out[key]
            for a, b in ((0, 1), (2, 3)):
                whole = np.zeros_like(want)
                for r in (a, b):
                    lay22.place(whole, ranks[r][key], leaf, r)
                _close(whole, want)
            sharded += 1
    assert sharded > 0
    keys = [k for k in ranks[0] if k.startswith("wvw/wire/")
            and lay14.replicated(k[len("wvw/wire"):])]
    assert keys
    for key in keys:
        for r in range(1, 4):
            np.testing.assert_array_equal(ranks[r][key], ranks[0][key], key)


@pytest.mark.parametrize("comp", [0, 1])
def test_runtime_dp_reduction_matches_jax(runs, comp):
    jax_out, ranks, _ = runs
    tag = f"runtime{comp}"
    for r in range(4):
        got = ranks[r]
        for k in ("loss", "grad_norm", "balance_loss", "z_loss"):
            _close(got[f"{tag}/{k}"], jax_out[f"{tag}/{k}"])
        np.testing.assert_array_equal(got[f"{tag}/expert_load"], jax_out[f"{tag}/expert_load"])
        for key, want in jax_out.items():
            if key.startswith(f"{tag}/p/"):
                _close(got[key], want, atol=1e-5, rtol=0)
            elif key.startswith(f"{tag}/r/"):
                _close_quantized(got[key], want[r:r + 1])


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def test_trainer_wire_and_weight_branches_match_jax(runs):
    jax_out, ranks, _ = runs
    for got in ranks:
        assert bool(got["trainer/w0_kept"])  # the wire plan moved no weight
        for k in ("perm", "wire", "flush_perm", "flush_wire"):
            np.testing.assert_array_equal(got[f"trainer/{k}"], jax_out[f"trainer/{k}"])
        np.testing.assert_array_equal(got["trainer/ref_perm"], jax_out["trainer/perm"])
        for k in ("lw", "lr", "flush_lw", "flush_lr"):
            _close(got[f"trainer/{k}"], jax_out[f"trainer/{k}"])
        # port against port: the wire path computes the weight path's loss
        assert got["trainer/lw"] == got["trainer/lr"]
        assert got["trainer/flush_lw"] == got["trainer/flush_lr"]


def test_trainer_wire_equals_weight_path_bit_for_bit(runs):
    """Two steps after the two plans: losses and every parameter equal,
    the weight run's layer-0 experts sitting on the rank the wire map
    names; tracing on changes nothing."""
    _, ranks, _ = runs
    wire = ranks[0]["wvw/wire_perm"]
    assert (wire[0] != np.arange(4)).any() and (wire[1] == np.arange(4)).all()
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["wvw/wire_loss"], got["wvw/weight_loss"])
        np.testing.assert_array_equal(got["wvw/traced_loss"], got["wvw/wire_loss"])
        for key in got:
            if not key.startswith("wvw/wire/"):
                continue
            leaf = key[len("wvw/wire"):]
            np.testing.assert_array_equal(got["wvw/traced" + leaf], got[key])
            moved = leaf.endswith(("w_in", "w_gate", "w_out"))
            want = got[key]
            if moved:
                # rank r's slots hold, in the weight run, what the wire run
                # keeps on rank wire[0][r] for layer 0
                want = got[key].copy()
                want[0] = ranks[int(wire[0][r])][key][0]
            np.testing.assert_array_equal(got["wvw/weight" + leaf], want, key)


def test_trainer_control_loop_matches_jax(runs):
    """Three steps with a plan after each: every rank reports the same
    reduced loads, and its slot maps and wire perms are what the JAX
    package's ControlPlane and PlacementApplier make of those loads; a rank
    that disagrees fails every rank."""
    from repro.core.controlplane import ControlPlane as JControlPlane
    from repro.core.controlplane import PlacementApplier as JApplier

    _, ranks, _ = runs
    loads = ranks[0]["loop/load"]
    cp = JControlPlane(num_layers=2, num_experts=8, num_devices=4, min_gain_fraction=0.0)
    ap = JApplier(cp, model_size=4, wire_capable=True)
    perms, wires = [], []
    for step_load in loads:
        for layer in range(2):
            cp.observe(layer, step_load[layer])
        cp.end_step()
        ap.apply({"blocks": {}}, [cp.plan(layer) for layer in range(2)])
        perms.append(cp.perm_stack())
        wires.append(ap.wire_perm if ap.wire_perm is not None
                     else np.arange(4)[None].repeat(2, 0))
    for got in ranks:
        np.testing.assert_array_equal(got["loop/load"], loads)
        np.testing.assert_array_equal(got["loop/perm"], np.stack(perms))
        np.testing.assert_array_equal(got["loop/wire"], np.stack(wires))
        np.testing.assert_array_equal(got["loop/counts"],
                                      [cp.reconfig_count, ap.wire_reconfig_count])
        assert bool(got["loop/disagree_raised"])
    assert cp.reconfig_count > 0


def test_gloo_on_cpu_stages_nothing(runs):
    _, ranks, _ = runs
    assert all(float(got["staged"]) == 0.0 for got in ranks)
