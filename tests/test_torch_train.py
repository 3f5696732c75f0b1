"""The port's training slice against the JAX package on the CPU: the dispatch
plans, the plain MoE data movers and grouped GEMM (against the JAX oracles
and the Pallas kernels in interpret mode), the plain backward formulas
(against torch.autograd), the mixnet MoE layer's value and gradients
(against jax.value_and_grad), AdamW, the cosine schedule, the chunked cross
entropy, COPILOT, the trainer step for step, and re-placement invariance
port against port.

Inputs come from seeded numpy and go to both sides.  TF32 is off (it only
matters on a card).  Tolerances: integer and data-movement results exactly;
f32 results within ``atol=rtol=1e-5`` (the same math summed in another
order by XLA and by PyTorch's CPU kernels), except the trainer's losses
(``rtol=1e-4``: six optimizer steps compound those differences) and the
moments after them (``rtol=1e-3``).
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import copilot as jcopilot
from repro.core.controlplane import ControlPlane as JControlPlane
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.kernels import ref as jref
from repro.kernels.grouped_matmul import grouped_matmul_blocks_pallas, grouped_matmul_pallas
from repro.kernels.moe_dispatch import moe_combine_pallas, moe_dispatch_pallas
from repro.models import moe as jmoe
from repro.models import routing as jrouting
from repro.models import transformer as jtfm
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import MoEConfig as JMoEConfig
from repro.optim import adamw as jadamw
from repro.parallel.sharding import make_plan as jmake_plan
from repro.train import train_step as jtrain_step
from repro.train import trainer as jtrainer_mod
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.core import copilot
from repro_torch.core.controlplane import ControlPlane
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import grouped_matmul as kgm
from repro_torch.kernels import moe_dispatch as kmd
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rmsnorm as krms
from repro_torch.kernels import topk_gating as ktg
from repro_torch.models import moe as moe_mod
from repro_torch.models import routing
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import make_plan
from repro_torch.train.train_step import init_all, loss_fn, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(atol=1e-5, rtol=1e-5)
JPLAN = jmake_plan(None)
PLAN = make_plan(None)


def _t(a, **kw):
    return torch.from_numpy(np.array(a)).to(**kw) if kw else torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def _tiny(cfg_cls, moe_cls, dispatch="dropless", layers=2, capacity_factor=2.0, remat="none",
          **moe_kw):
    """The tiny mixnet config of the JAX trainer tests (test_train.py)."""
    return cfg_cls(
        "tiny-moe8", "moe", layers, 32, 4, 2, 0, 64, dtype="float32", remat=remat,
        moe=moe_cls(num_experts=8, top_k=2, d_ff=32, capacity_factor=capacity_factor,
                    backend="mixnet", dispatch=dispatch, **moe_kw),
    )


# ---------------------------------------------------------------------------
# dispatch plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_valid", [False, True])
def test_capacity_and_dropless_plans_exact(with_valid):
    rng = np.random.default_rng(int(with_valid))
    n, e = 50, 5
    dest = rng.integers(0, e, size=n).astype(np.int32)
    valid = rng.random(n) > 0.2 if with_valid else None
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else _t(valid)
    jrank, jcounts = jrouting.bucket_ranks(jnp.asarray(dest), e, valid=jv)
    rank, counts = routing.bucket_ranks(_t(dest), e, valid=tv)
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    jp = jrouting.capacity_plan(jnp.asarray(dest), jrank, jv, e, 7)
    tp = routing.capacity_plan(_t(dest), rank, tv, e, 7)
    jd = jrouting.dropless_plan(jnp.asarray(dest), jrank, jcounts, jv, e, 8)
    td = routing.dropless_plan(_t(dest), rank, counts, tv, e, 8)
    for got, want in ((tp, jp), (td, jd)):
        np.testing.assert_array_equal(got.slot.numpy(), np.asarray(want.slot))
        np.testing.assert_array_equal(got.src.numpy(), np.asarray(want.src))
        assert got.num_rows == want.num_rows and int(got.kept) == int(want.kept)
    assert tp.block_experts is None
    np.testing.assert_array_equal(td.block_experts.numpy(), np.asarray(jd.block_experts))
    assert (np.diff(td.block_experts.numpy()) >= 0).all()  # the kernels' precondition


# ---------------------------------------------------------------------------
# plain MoE ops against the JAX oracles and Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _moe_inputs():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((12, 16)).astype(np.float32)
    src = rng.integers(0, 12, size=20).astype(np.int32)
    src[rng.random(20) < 0.3] = -1
    y = rng.standard_normal((20, 16)).astype(np.float32)
    slot = np.concatenate([rng.permutation(20), [-1] * 4]).reshape(12, 2).astype(np.int32)
    slot[0] = -1
    w = rng.random((12, 2)).astype(np.float32)
    xb = rng.standard_normal((6, 8, 16)).astype(np.float32)
    wb = rng.standard_normal((3, 16, 24)).astype(np.float32)
    be = np.array([0, 0, 1, 1, 1, 2], np.int32)
    return x, src, y, slot, w, xb, wb, be


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_plain_moe_ops_match_jax(backend):
    x, src, y, slot, w, xb, wb, be = _moe_inputs()
    pallas = backend == "pallas"
    jd = (moe_dispatch_pallas(jnp.asarray(x), jnp.asarray(src), interpret=True) if pallas
          else jref.moe_dispatch(jnp.asarray(x), jnp.asarray(src)))
    np.testing.assert_array_equal(tref.moe_dispatch(_t(x), _t(src)).numpy(), np.asarray(jd))
    jc = (moe_combine_pallas(jnp.asarray(y), jnp.asarray(slot), jnp.asarray(w), interpret=True)
          if pallas else jref.moe_combine(jnp.asarray(y), jnp.asarray(slot), jnp.asarray(w)))
    got = tref.moe_combine(_t(y), _t(slot), _t(w))
    _close(got, jc)
    assert not got[0].any()  # a fully dropped row is exactly 0
    jg = (grouped_matmul_blocks_pallas(jnp.asarray(xb), jnp.asarray(wb), jnp.asarray(be),
                                       interpret=True) if pallas
          else jref.grouped_matmul_blocks(jnp.asarray(xb), jnp.asarray(wb), jnp.asarray(be)))
    _close(tref.grouped_matmul_blocks(_t(xb), _t(wb), _t(be)), jg)
    xc = xb[:3]
    jgc = (grouped_matmul_pallas(jnp.asarray(xc), jnp.asarray(wb), interpret=True) if pallas
           else jref.grouped_matmul(jnp.asarray(xc), jnp.asarray(wb)))
    _close(tref.grouped_matmul(_t(xc), _t(wb)), jgc)


# ---------------------------------------------------------------------------
# plain backward formulas against torch.autograd of the plain forwards
# ---------------------------------------------------------------------------


def _grad(fn, inputs, cot):
    inputs = [t.clone().requires_grad_() for t in inputs]
    out = fn(*inputs)
    out = out[0] if isinstance(out, tuple) else out
    return torch.autograd.grad(out, inputs, cot)


def _bwd_case(name):
    rng = np.random.default_rng(11)
    x, src, y, slot, w, xb, wb, be = _moe_inputs()
    if name == "topk_gating":
        logits = _t(rng.standard_normal((9, 8)).astype(np.float32))
        _, idx = tref.topk_gating(logits, 2)
        dw = _t(rng.standard_normal((9, 2)).astype(np.float32))
        want = _grad(lambda l: tref.topk_gating(l, 2), [logits], dw)
        return [tref.topk_gating_bwd(logits, dw, idx)], want
    if name.startswith("flash_attention"):
        kw = dict(causal=True, window=5, softcap=20.0) if name.endswith("knobs") else {}
        q = _t(rng.standard_normal((1, 4, 13, 64)).astype(np.float32))
        k = _t(rng.standard_normal((1, 2, 13, 64)).astype(np.float32))
        v = _t(rng.standard_normal((1, 2, 13, 64)).astype(np.float32))
        do = _t(rng.standard_normal((1, 4, 13, 64)).astype(np.float32))
        want = _grad(lambda a, b, c: tref.flash_attention(a, b, c, **kw), [q, k, v], do)
        return list(tref.flash_attention_bwd(q, k, v, do, **kw)), want
    if name == "moe_dispatch_one_to_one":
        dest = rng.permutation(16)[:12].astype(np.int32)
        s = np.full(16, -1, np.int32)
        s[dest] = np.arange(12)
        g = _t(rng.standard_normal((16, 16)).astype(np.float32))
        want = _grad(lambda a: tref.moe_dispatch(a, _t(s)), [_t(x)], g)
        return [tref.moe_dispatch_bwd(g, _t(dest), torch.float32)], want
    if name == "moe_dispatch_many_to_one":
        sl = rng.permutation(24).reshape(12, 2).astype(np.int32)
        sl[4, 1] = -1
        s = np.full(24, -1, np.int32)
        s[sl[sl >= 0]] = np.nonzero(sl.reshape(-1) >= 0)[0] // 2
        g = _t(rng.standard_normal((24, 16)).astype(np.float32))
        want = _grad(lambda a: tref.moe_dispatch(a, _t(s)), [_t(x)], g)
        return [tref.moe_dispatch_bwd(g, _t(sl), torch.float32)], want
    if name == "moe_combine":
        inv = np.full(20, -1, np.int32)
        flat = slot.reshape(-1)
        inv[flat[flat >= 0]] = np.nonzero(flat >= 0)[0]
        g = _t(rng.standard_normal((12, 16)).astype(np.float32))
        want = _grad(lambda a, b: tref.moe_combine(a, _t(slot), b), [_t(y), _t(w)], g)
        return list(tref.moe_combine_bwd(g, _t(y), _t(slot), _t(w), _t(inv))), want
    if name == "grouped_matmul":
        xc = _t(rng.standard_normal((3, 12, 16)).astype(np.float32))
        g = _t(rng.standard_normal((3, 12, 24)).astype(np.float32))
        want = _grad(tref.grouped_matmul, [xc, _t(wb)], g)
        return list(tref.grouped_matmul_bwd(xc, _t(wb), g)), want
    assert name == "grouped_matmul_blocks"
    g = _t(rng.standard_normal((6, 8, 24)).astype(np.float32))
    want = _grad(lambda a, b: tref.grouped_matmul_blocks(a, b, _t(be)), [_t(xb), _t(wb)], g)
    return list(tref.grouped_matmul_blocks_bwd(_t(xb), _t(wb), _t(be), g)), want


@pytest.mark.parametrize("name", [
    "topk_gating", "flash_attention", "flash_attention_knobs", "moe_dispatch_one_to_one",
    "moe_dispatch_many_to_one", "moe_combine", "grouped_matmul_blocks", "grouped_matmul",
])
def test_plain_backward_formula_matches_autograd(name):
    got, want = _bwd_case(name)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w.numpy())


def test_grouped_matmul_capacity_backward_matches_jax():
    """The capacity GEMM's plain dX and dW (what the kernels are held to on
    the card) against jax.vjp of the JAX package's reference, with an
    expert whose rows are all zero (empty capacity slots)."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 20, 16)).astype(np.float32)
    x[1] = 0
    w = rng.standard_normal((3, 16, 24)).astype(np.float32)
    g = rng.standard_normal((3, 20, 24)).astype(np.float32)
    y, vjp = jax.vjp(jref.grouped_matmul, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    _close(tref.grouped_matmul(_t(x), _t(w)), y)
    dx, dw = tref.grouped_matmul_bwd(_t(x), _t(w), _t(g))
    _close(dx, jdx)
    _close(dw, jdw)
    assert not dw[1].any()


# ---------------------------------------------------------------------------
# the mixnet MoE layer: value and gradients against jax.value_and_grad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dispatch", ["dropless", "capacity"])
def test_moe_mixnet_local_value_and_grad_match_jax(dispatch):
    _mixnet_local_against_jax(dispatch)


def test_moe_mixnet_chunked_capacity_matches_jax():
    """Capacity dispatch through the chunked pipeline (4 chunks of 4 tokens)
    at P = 1 with a capacity factor of 0.5, so stage 1 drops half the
    choices: output, dropped fraction and every gradient against the JAX
    package's chunked capacity layer."""
    drop = _mixnet_local_against_jax("capacity", capacity_factor=0.5, overlap_chunks=4)
    assert float(drop) == 0.5


def _mixnet_local_against_jax(dispatch, **kw):
    jcfg = _tiny(JModelConfig, JMoEConfig, dispatch, **kw)
    cfg = _tiny(ModelConfig, MoEConfig, dispatch, **kw)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 32)).astype(np.float32)
    ws = [
        rng.standard_normal((32, 8)).astype(np.float32) * 0.5,
        rng.standard_normal((8, 32, 32)).astype(np.float32) / 32**0.5,
        rng.standard_normal((8, 32, 32)).astype(np.float32) / 32**0.5,
        rng.standard_normal((8, 32, 32)).astype(np.float32) / 32**0.5,
    ]
    cot = rng.standard_normal((2, 8, 32)).astype(np.float32)
    perm = rng.permutation(8).astype(np.int32)

    def jloss(xl, *params):
        out, load, bal, z, drop = jmoe._moe_mixnet_local(
            tuple(params), xl, jcfg, JPLAN, jnp.asarray(perm), ()
        )
        return jnp.sum(out * cot) + 0.01 * bal + 0.001 * z, (load, drop)

    (jl, (jload, jdrop)), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4),
                                                          has_aux=True))(x, *ws)
    tx = [_t(a).requires_grad_() for a in (x, *ws)]
    out, load, bal, z, drop = moe_mod._moe_mixnet_local(tuple(tx[1:]), tx[0], cfg, PLAN, _t(perm))
    loss = torch.sum(out * _t(cot)) + 0.01 * bal + 0.001 * z
    grads = torch.autograd.grad(loss, tx)
    _close(loss, jl)
    np.testing.assert_array_equal(load.numpy(), np.asarray(jload))
    _close(drop, jdrop)
    for g, w in zip(grads, jg):
        _close(g, w)
    return drop


# ---------------------------------------------------------------------------
# AdamW, the schedule, the chunked cross entropy
# ---------------------------------------------------------------------------


def test_adamw_and_cosine_lr_match_jax():
    cfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    tcfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5)
    # The JAX side under one jit each (eagerly every primitive compiles).
    jlr = jax.jit(lambda s: jadamw.cosine_lr(cfg, s))
    jupdate = jax.jit(lambda p, g, s: jadamw.adamw_update(p, g, s, cfg))
    for s in range(8):
        _close(adamw.cosine_lr(tcfg, torch.tensor(s, dtype=torch.int32)),
               jlr(jnp.asarray(s, jnp.int32)))
    rng = np.random.default_rng(2)
    shapes = {"a": (2, 3, 4), "blocks": {"w": (2, 5), "b": (7,)}}
    mk = lambda sh: (rng.standard_normal(sh).astype(np.float32) if isinstance(sh, tuple)
                     else {k: mk(v) for k, v in sh.items()})
    p0 = mk(shapes)
    jp, js = jax.tree.map(jnp.asarray, p0), jadamw.init_adamw(jax.tree.map(jnp.asarray, p0), cfg)
    tp = params_from_numpy(p0)
    ts = adamw.init_adamw(tp, tcfg)
    for _ in range(3):
        g = mk(shapes)
        jp, js, jm = jupdate(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts, tm = adamw.adamw_update(tp, params_from_numpy(g), ts, tcfg)
        _close(tm["grad_norm"], jm["grad_norm"])
        _close(tm["lr"], jm["lr"])
    for tree_t, tree_j in ((tp, jp), (ts["mu"], js["mu"]), (ts["nu"], js["nu"])):
        for (_, a), (_, b) in zip(adamw._leaves(tree_t), adamw._leaves(
                jax.tree.map(np.asarray, tree_j))):
            _close(a, b)
    assert int(ts["step"]) == int(js["step"]) == 3


def test_adamw_slices_take_whole_rows(monkeypatch):
    """A leaf larger than a slice is walked in chunks of whole rows, not row
    by row (Mixtral's [32000, 4096] embedding: 2 slices, not 32,000 — one
    update per row took a step on the card from 0.3 to 14 s)."""
    monkeypatch.setattr(adamw, "_SLICE", 64)
    x = torch.arange(16000.0).reshape(1000, 16)
    parts = list(adamw._slices(x))
    assert len(parts) == 250 and all(p.numel() <= 64 for p in parts)
    assert torch.equal(torch.cat(parts), x)
    y = torch.arange(600.0).reshape(3, 5, 40)  # a row of 200 does not fit: its rows' slices
    parts = list(adamw._slices(y))
    assert len(parts) == 15 and all(p.numel() <= 64 for p in parts)
    assert torch.equal(torch.cat([p.reshape(-1) for p in parts]), y.reshape(-1))


def test_chunked_cross_entropy_matches_jax():
    jcfg = _tiny(JModelConfig, JMoEConfig)
    cfg = _tiny(ModelConfig, MoEConfig)
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 16, 32)).astype(np.float32)
    head = rng.standard_normal((32, 64)).astype(np.float32) * 0.2
    labels = rng.integers(0, 64, size=(2, 16)).astype(np.int32)
    jl, (jgf, jgh) = jax.value_and_grad(
        lambda f, h: jtfm.chunked_cross_entropy({"lm_head": h}, f, jnp.asarray(labels), jcfg),
        argnums=(0, 1),
    )(feats, head)
    f, h = _t(feats).requires_grad_(), _t(head).requires_grad_()
    loss = tfm.chunked_cross_entropy({"lm_head": h}, f, _t(labels), cfg)
    gf, gh = torch.autograd.grad(loss, (f, h))
    _close(loss, jl)
    _close(gf, jgf)
    _close(gh, jgh)


# ---------------------------------------------------------------------------
# COPILOT and the control plane
# ---------------------------------------------------------------------------


def test_copilot_fit_matches_jax():
    rng = np.random.default_rng(8)
    l, k, e = 3, 5, 8
    raw_x = rng.random((l, k, e)) + 0.05
    raw_y = rng.random((l, k, e)) + 0.05
    xs = raw_x / raw_x.sum(-1, keepdims=True)
    ys = raw_y / raw_y.sum(-1, keepdims=True)
    ws = np.tile(0.7 ** np.arange(k - 1, -1, -1), (l, 1))
    ws[1, :2] = 0.0  # a ragged window padded with zero-weight rows
    p0 = np.tile(np.full((e, e), 1.0 / e), (l, 1, 1))
    want = jcopilot.fit_transition_matrices(
        jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(ws), jnp.asarray(p0), steps=150
    )
    got = copilot.fit_transition_matrices(xs, ys, ws, p0, steps=150)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_controlplane_copilot_and_plans_match_jax():
    rng = np.random.default_rng(9)
    kw = dict(num_layers=3, num_experts=8, num_devices=4, min_gain_fraction=0.0)
    jcp, tcp = JControlPlane(**kw), ControlPlane(**kw)
    assert tcp.copilot is not None and jcp.copilot is not None
    for _ in range(4):
        loads = rng.integers(1, 40, size=(3, 8)).astype(np.float32)
        for cp in (jcp, tcp):
            for layer in range(3):
                cp.observe(layer, loads[layer])
            cp.end_step()
    np.testing.assert_allclose(tcp.copilot.state.transitions, jcp.copilot.state.transitions,
                               atol=1e-5, rtol=0)
    _close(tcp.predict_load(2), jcp.predict_load(2))
    for layer in range(3):
        jp, tp = jcp.plan(layer), tcp.plan(layer)
        assert jp.reconfigure == tp.reconfigure
        if jp.reconfigure:
            np.testing.assert_array_equal(tp.perm, jp.perm)


def test_controlplane_default_matches_reference():
    """Repair: the port's ControlPlane ran without COPILOT by default."""
    jdef = inspect.signature(JControlPlane).parameters["use_copilot"].default
    tdef = inspect.signature(ControlPlane).parameters["use_copilot"].default
    assert tdef is jdef is True
    assert ControlPlane(num_layers=2, num_experts=8).copilot is not None
    assert ControlPlane(num_layers=1, num_experts=8).copilot is None


# ---------------------------------------------------------------------------
# the trainer, step for step, and re-placement invariance
# ---------------------------------------------------------------------------


def _port_init_all(key, cfg, plan, opt_cfg):
    """The JAX trainer's initializer replaced by the port's seeded draw,
    converted (the trees match name for name): initializing either way
    gives both trainers one state, and this way no JAX program compiles
    for it.  The specs are only read by the pipeline-parallel step."""
    tcfg = _tiny(ModelConfig, MoEConfig, dispatch=cfg.moe.dispatch,
                 capacity_factor=cfg.moe.capacity_factor, remat=cfg.remat)
    params, _, _ = init_all(0, tcfg, PLAN, adamw.AdamWConfig(), device="cpu")
    jparams = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), params)
    return jparams, None, jadamw.init_adamw(jparams, opt_cfg)


@pytest.mark.parametrize("dispatch,capacity_factor,remat", [
    ("dropless", 2.0, "none"),
    ("capacity", 2.0, "full"),
    ("capacity", 1.0, "none"),  # 16 slots per expert for 128 choices: choices drop
])
def test_trainer_matches_jax_step_for_step(monkeypatch, tmp_path, dispatch, capacity_factor,
                                           remat):
    """Both trainers from one state, the same injected 4-device control plane
    (COPILOT on), 6 steps with a reconfiguration every 2: the dropless and
    the capacity layouts, with and without dropped choices, and remat "full"
    on both sides.  The JAX trainer also checkpoints at step 4; a fresh port
    trainer restores that checkpoint (weights, moments, placement) and runs
    steps 5 and 6 as the JAX trainer did."""
    monkeypatch.setattr(jtrainer_mod, "init_all", _port_init_all)
    kw = dict(dispatch=dispatch, capacity_factor=capacity_factor, remat=remat)
    jcfg, cfg = _tiny(JModelConfig, JMoEConfig, **kw), _tiny(ModelConfig, MoEConfig, **kw)
    kw = dict(total_steps=0, reconfig_every=2, reconfig_min_gain=0.0)
    ck = dict(ckpt_every=4, ckpt_dir=str(tmp_path), ckpt_async=False)
    jtr = JTrainer(jcfg, jadamw.AdamWConfig(lr=1e-3), JTrainerConfig(**kw, **ck), JPLAN, seed=0)
    tr = Trainer(cfg, adamw.AdamWConfig(lr=1e-3), TrainerConfig(**kw), PLAN, device="cpu")
    tr.params = params_from_numpy(jax.tree.map(np.asarray, jtr.params), cfg, trainable=True)
    tr.opt_state = params_from_numpy(jax.tree.map(np.asarray, jtr.opt_state))
    cp_kw = dict(num_layers=2, num_experts=8, num_devices=4, min_gain_fraction=0.0)
    jtr.controlplane, tr.controlplane = JControlPlane(**cp_kw), ControlPlane(**cp_kw)
    jdata, data = iter(JSyntheticLM(64, 16, 4, seed=0)), iter(SyntheticLM(64, 16, 4, seed=0))
    drops, jlog, perms = [], [], []
    for step in range(1, 7):
        jtr.tcfg.total_steps = tr.tcfg.total_steps = step
        jm, tm = jtr.train(jdata)[-1], tr.train(data)[-1]
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_array_equal(tm["expert_load"], np.asarray(jm["expert_load"]))
        assert tr.reconfig_count == jtr.reconfig_count
        np.testing.assert_array_equal(np.asarray(tr.expert_perm), np.asarray(jtr.expert_perm))
        drops.append(float(np.mean(tm["dropped_fraction"])))
        jlog.append(jm)
        perms.append(np.asarray(jtr.expert_perm).copy())
    assert tr.reconfig_count > 0
    assert (max(drops) > 0) == (capacity_factor < 2.0), drops
    resumed = Trainer(cfg, adamw.AdamWConfig(lr=1e-3),
                      TrainerConfig(**{**kw, "total_steps": 6}, ckpt_dir=str(tmp_path)), PLAN,
                      seed=1, device="cpu")
    resumed.controlplane = ControlPlane(**cp_kw)
    assert resumed.maybe_restore() and resumed.step == 4
    assert int(resumed.opt_state["step"]) == 4
    np.testing.assert_array_equal(resumed.expert_perm, perms[3])
    data = iter(SyntheticLM(64, 16, 4, seed=0))
    for _ in range(4):
        next(data)
    for tm, jm in zip(resumed.train(data), jlog[4:]):
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_array_equal(tm["expert_load"], np.asarray(jm["expert_load"]))
    # The moments stay in their slots in both (trainer.py:256 of the
    # reference permutes the parameters only).
    jmu = jax.tree.map(np.asarray, jtr.opt_state["mu"])
    for name in ("w_in", "w_gate", "w_out"):
        np.testing.assert_allclose(
            tr.opt_state["mu"]["blocks"]["0_global"]["moe"][name].numpy(),
            jmu["blocks"]["0_global"]["moe"][name], rtol=1e-3, atol=1e-7,
        )
        _close(tr.params["blocks"]["0_global"]["moe"][name],
               np.asarray(jtr.params["blocks"]["0_global"]["moe"][name]), rtol=1e-3, atol=1e-5)


def test_train_step_microbatches_match_jax():
    """Two microbatches of one step: the accumulated loss and loads and the
    updated parameters against the JAX step's scan over the slices."""
    jcfg, cfg = _tiny(JModelConfig, JMoEConfig), _tiny(ModelConfig, MoEConfig)
    jopt, opt = jadamw.AdamWConfig(lr=1e-3), adamw.AdamWConfig(lr=1e-3)
    params, _, state = init_all(1, cfg, PLAN, opt, device="cpu")
    to_jax = lambda tree: {k: to_jax(v) if isinstance(v, dict) else jnp.array(v.detach().numpy())
                           for k, v in tree.items()}
    jparams = to_jax(params)
    b = next(iter(SyntheticLM(64, 16, 4, seed=2)))
    jstep = jax.jit(jtrain_step.make_train_step(jcfg, JPLAN, jopt, microbatches=2))
    jp, _, jm = jstep(jparams, jadamw.init_adamw(jparams, jopt),
                      {"tokens": jnp.asarray(b.tokens), "labels": jnp.asarray(b.labels)})
    step = make_train_step(cfg, PLAN, opt, microbatches=2)
    tp, _, tm = step(params, state, {"tokens": _t(b.tokens), "labels": _t(b.labels)})
    for key in ("loss", "ce", "balance_loss", "z_loss", "grad_norm"):
        _close(tm[key], jm[key])
    np.testing.assert_allclose(tm["expert_load"].numpy(), np.asarray(jm["expert_load"]), rtol=1e-6)
    want = dict(_flat(jax.tree.map(np.asarray, jp)))
    for key, a in _flat(tp):
        _close(a, want[key])


def test_replacement_invariance_bit_exact_on_cpu():
    """Loss and gradients before and after moving the experts: bit-identical
    once the permutation is undone."""
    cfg = _tiny(ModelConfig, MoEConfig)
    params, _, _ = init_all(0, cfg, PLAN, adamw.AdamWConfig(), device="cpu")
    batch = next(iter(SyntheticLM(64, 16, 4, seed=1)))
    batch = {"tokens": _t(batch.tokens), "labels": _t(batch.labels)}
    rng = np.random.default_rng(0)
    perm = np.stack([rng.permutation(8) for _ in range(2)]).astype(np.int32)
    inv = np.argsort(perm, axis=1)

    def grads(p, expert_perm):
        leaves = dict(_flat(p))
        loss, _ = loss_fn(p, batch, cfg, PLAN, expert_perm=expert_perm)
        return loss, dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))

    loss1, g1 = grads(params, None)
    moved = {k: v for k, v in params.items()}
    moved["blocks"] = {"0_global": dict(params["blocks"]["0_global"])}
    moe = dict(params["blocks"]["0_global"]["moe"])
    for name in ("w_in", "w_gate", "w_out"):
        w = moe[name].detach()
        moe[name] = torch.stack([w[li][_t(inv[li]).long()] for li in range(2)]).requires_grad_()
    moved["blocks"]["0_global"]["moe"] = moe
    loss2, g2 = grads(moved, _t(perm))
    assert torch.equal(loss1, loss2)
    for key, a in g1.items():
        b = g2[key]
        if key.split("/")[-1] in ("w_in", "w_gate", "w_out"):
            b = torch.stack([b[li][_t(perm[li]).long()] for li in range(2)])
        assert torch.equal(a, b), key


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


def _loss_and_grads(params, cfg, batch):
    leaves = dict(_flat(params))
    loss, (_, aux) = loss_fn(params, batch, cfg, PLAN)
    return loss.detach(), torch.autograd.grad(loss, list(leaves.values())), aux


@pytest.mark.parametrize("dispatch", ["dropless", "capacity"])
def test_remat_modes_bit_identical(monkeypatch, dispatch):
    """remat "none", "full" and "dots" on the same weights and batch: the
    loss, every gradient and the stats bit-identical; "dots" keeps some
    products (its policy saves) and recomputes the rest."""
    cfg = _tiny(ModelConfig, MoEConfig, dispatch, capacity_factor=1.0)
    params, _, _ = init_all(0, cfg, PLAN, adamw.AdamWConfig(), device="cpu")
    b = next(iter(SyntheticLM(64, 16, 4, seed=1)))
    batch = {"tokens": _t(b.tokens), "labels": _t(b.labels)}
    saved = []
    policy = tfm._dots_policy

    def counting(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if out.name == "MUST_SAVE":
            saved.append(op)
        return out

    monkeypatch.setattr(tfm, "_dots_policy", counting)
    base = _loss_and_grads(params, cfg, batch)
    for remat in ("full", "dots"):
        loss, grads, aux = _loss_and_grads(params, dataclasses.replace(cfg, remat=remat), batch)
        assert torch.equal(loss, base[0]), remat
        assert all(torch.equal(a, g) for a, g in zip(grads, base[1])), remat
        assert torch.equal(aux.moe_stats, base[2].moe_stats)
        assert torch.equal(aux.dropped_fraction, base[2].dropped_fraction)
    assert saved and all(op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                                torch.ops.aten.addmm.default) for op in saved)
    assert (base[2].dropped_fraction > 0).any() == (dispatch == "capacity")


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_through_the_kernel_functions(monkeypatch, remat):
    """The card's path on the CPU: ops routed to the autograd Functions with
    each kernel wrapper replaced by its plain version and counted.  Under
    remat the backward recomputes the group through the same Functions:
    loss and gradients bit-identical to remat "none", every forward kernel
    launched twice."""
    counts = {}

    def fake(mod, name, fn):
        def run(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, run)

    fake(ktg, "topk_gating_cuda", tref.topk_gating)
    fake(ktg, "topk_gating_bwd_cuda", tref.topk_gating_bwd)
    fake(kfa, "flash_attention_cuda", lambda q, k, v, return_lse=False, **kw: (
        (tref.flash_attention(q, k, v, **kw), None) if return_lse
        else tref.flash_attention(q, k, v, **kw)))
    fake(kfa, "flash_attention_bwd_cuda",
         lambda q, k, v, o, lse, do, **kw: tref.flash_attention_bwd(q, k, v, do, **kw))
    fake(kmd, "moe_dispatch_cuda", tref.moe_dispatch)
    fake(kmd, "moe_combine_cuda",
         lambda y, s, w, out_dtype=torch.float32: tref.moe_combine(y, s, w).to(out_dtype))
    fake(kmd, "moe_combine_bwd_cuda",
         lambda d, y, s, w, inv, need_dw=True: tref.moe_combine_bwd(d, y, s, w, inv))
    fake(kgm, "grouped_matmul_cuda", tref.grouped_matmul)
    fake(kgm, "grouped_matmul_dx_cuda", lambda dy, w: tref.grouped_matmul(dy, w.transpose(1, 2)))
    fake(kgm, "grouped_matmul_dw_cuda", tref.grouped_matmul_dw)

    def rmsnorm_bwd(x, w, dy, eps=1e-6):
        xg, wg = x.detach().requires_grad_(), w.detach().requires_grad_()
        with torch.enable_grad():
            return torch.autograd.grad(tref.rmsnorm(xg, wg, eps), (xg, wg), dy)

    fake(krms, "rmsnorm_cuda", tref.rmsnorm)
    fake(krms, "rmsnorm_bwd_cuda", rmsnorm_bwd)
    for name in ("topk_gating_cuda", "flash_attention_cuda", "moe_dispatch_cuda",
                 "moe_combine_cuda", "grouped_matmul_cuda", "rmsnorm_cuda"):
        monkeypatch.setattr(ops, name, getattr({"t": ktg, "f": kfa, "m": kmd, "g": kgm,
                                                "r": krms}[name[0]], name))
    monkeypatch.setattr(ops, "_on_cpu", lambda x: False)
    cfg = _tiny(ModelConfig, MoEConfig, "capacity", capacity_factor=1.0)
    params, _, _ = init_all(0, cfg, PLAN, adamw.AdamWConfig(), device="cpu")
    b = next(iter(SyntheticLM(64, 16, 4, seed=1)))
    batch = {"tokens": _t(b.tokens), "labels": _t(b.labels)}
    base = _loss_and_grads(params, cfg, batch)
    none = dict(counts)
    counts.clear()
    loss, grads, _ = _loss_and_grads(params, dataclasses.replace(cfg, remat=remat), batch)
    assert torch.equal(loss, base[0])
    assert all(torch.equal(a, g) for a, g in zip(grads, base[1]))
    assert none["grouped_matmul_cuda"] == 6 and none["grouped_matmul_dw_cuda"] == 6
    for name in ("topk_gating_cuda", "flash_attention_cuda", "grouped_matmul_cuda"):
        assert counts[name] == 2 * none[name], (name, counts, none)
    # The final norm lies outside the rematerialised layers.
    assert counts["rmsnorm_cuda"] == 2 * none["rmsnorm_cuda"] - 1, (counts, none)
    for name in ("topk_gating_bwd_cuda", "flash_attention_bwd_cuda", "grouped_matmul_dx_cuda",
                 "grouped_matmul_dw_cuda", "moe_combine_bwd_cuda", "rmsnorm_bwd_cuda"):
        assert counts[name] == none[name], (name, counts, none)


@pytest.mark.parametrize("chunks", [2, 4])
def test_chunked_capacity_weight_grad_is_one_serial_order_product(monkeypatch, chunks):
    """The chunked capacity pipeline through the card's autograd Functions,
    each kernel wrapper faked by its plain version: every expert weight's
    gradient equals, bit for bit, one product over the rows stage 1 keeps,
    laid out in serial order and packed into the dropless blocks (built
    here by hand from the routing plans), whatever the chunk count; the
    input and router gradients and the output agree with it too."""
    for mod, name, fn in (
        (ktg, "topk_gating_cuda", tref.topk_gating),
        (ktg, "topk_gating_bwd_cuda", tref.topk_gating_bwd),
        (kmd, "moe_dispatch_cuda", tref.moe_dispatch),
        (kmd, "moe_combine_cuda",
         lambda y, sl, w, out_dtype=torch.float32: tref.moe_combine(y, sl, w).to(out_dtype)),
        (kmd, "moe_combine_bwd_cuda",
         lambda d, y, sl, w, inv, need_dw=True: tref.moe_combine_bwd(d, y, sl, w, inv)),
        (kgm, "grouped_matmul_blocks_cuda", tref.grouped_matmul_blocks),
        (kgm, "grouped_matmul_blocks_dx_cuda",
         lambda dy, w, be: tref.grouped_matmul_blocks(dy, w.transpose(1, 2), be)),
        (kgm, "grouped_matmul_blocks_dw_cuda", tref.grouped_matmul_blocks_dw),
    ):
        monkeypatch.setattr(mod, name, fn)
        if hasattr(ops, name):
            monkeypatch.setattr(ops, name, fn)
    monkeypatch.setattr(ops, "_on_cpu", lambda x: False)
    cfg = _tiny(ModelConfig, MoEConfig, "capacity", capacity_factor=0.5, overlap_chunks=chunks)
    e = cfg.moe
    rng = np.random.default_rng(11)
    x = _t(rng.standard_normal((2, 8, 32)).astype(np.float32)).requires_grad_()
    ws = [_t(rng.standard_normal(shape).astype(np.float32) * scale).requires_grad_()
          for shape, scale in (((32, 8), 0.5), ((8, 32, 32), 32**-0.5), ((8, 32, 32), 32**-0.5),
                               ((8, 32, 32), 32**-0.5))]
    cot = _t(rng.standard_normal((2, 8, 32)).astype(np.float32))
    out, _, _, _, drop = moe_mod._moe_mixnet_local(tuple(ws), x, cfg, PLAN, None)
    assert float(drop) == 0.5
    got = torch.autograd.grad(torch.sum(out * cot), [x, *ws])

    # One product over the serial layout, by hand: the serial send buffer of
    # the rows stage 1 keeps, packed into dropless blocks, no stage 2.
    router, w_in, w_gate, w_out = ws
    xt = x.reshape(16, 32)
    info = routing.compute_routing(xt @ router, top_k=2, num_virtual=8, replication=1,
                                   expert_perm=torch.arange(8, dtype=torch.int32))
    n, cp = 32, routing.capacity(16, 2, 1, 0.5)
    dest = torch.zeros(n, dtype=torch.int32)
    rank1, _ = routing.bucket_ranks(dest, 1)
    plan1 = routing.capacity_plan(dest, rank1, rank1 < cp, 1, cp)
    send_x, send_e = moe_mod._send_buffers(xt, plan1, info.vdest.reshape(n), 2, 1, cp)
    re = send_e.reshape(cp)
    rank2, counts2 = routing.bucket_ranks(re, 8, valid=re >= 0)
    plan2 = routing.dropless_plan(re, rank2, counts2, re >= 0, 8, e.dispatch_block)
    packed = ops.moe_dispatch(send_x.reshape(cp, 32), plan2.src, inverse=plan2.slot)
    packed = packed.reshape(-1, e.dispatch_block, 32)
    be = plan2.block_experts
    h = ops.grouped_matmul(packed, w_in, block_experts=be)
    gt = ops.grouped_matmul(packed, w_gate, block_experts=be)
    ye = ops.grouped_matmul(moe_mod._actfn(cfg.act)(gt) * h, w_out, block_experts=be)
    back = ops.moe_dispatch(ye.reshape(plan2.num_rows, 32), plan2.slot, inverse=plan2.src)
    want_out = ops.moe_combine(back, plan1.slot.reshape(16, 2), info.wfull, inverse=plan1.src,
                               out_dtype=x.dtype).reshape(2, 8, 32)
    want = torch.autograd.grad(torch.sum(want_out * cot), [x, *ws])
    assert torch.equal(out, want_out)
    for name, g, w in zip(("x", "router", "w_in", "w_gate", "w_out"), got, want):
        assert torch.equal(g, w), name


# ---------------------------------------------------------------------------
# the wrappers on the CPU
# ---------------------------------------------------------------------------


def test_paged_decode_refuses_a_gradient():
    """Repair: the paged decode wrapper returned a detached result under grad."""
    q = torch.zeros((1, 1, 2, 64), requires_grad=True)
    pool = torch.zeros((2, 4, 2, 64))
    with pytest.raises(RuntimeError, match="no backward"):
        kfa.paged_flash_decode_cuda(q, pool, pool, torch.zeros((1, 2), dtype=torch.int32),
                                    torch.zeros((1,), dtype=torch.int32))


def test_training_wrappers_refuse_cpu_tensors():
    x = torch.zeros((4, 8))
    i = torch.zeros((4,), dtype=torch.int32)
    checks = [
        lambda: kmd.moe_dispatch_cuda(x, i),
        lambda: kmd.moe_combine_cuda(x, i.reshape(2, 2), torch.zeros((2, 2))),
        lambda: kgm.grouped_matmul_blocks_cuda(torch.zeros((1, 8, 8)), torch.zeros((1, 8, 8)),
                                               torch.zeros((1,), dtype=torch.int32)),
        lambda: ktg.topk_gating_bwd_cuda(x, torch.zeros((4, 2)),
                                         torch.zeros((4, 2), dtype=torch.int32)),
        lambda: kgm.grouped_matmul_cuda(torch.zeros((2, 4, 8)), torch.zeros((2, 8, 8))),
        lambda: kgm.grouped_matmul_dx_cuda(torch.zeros((2, 4, 8)), torch.zeros((2, 8, 8))),
        lambda: kgm.grouped_matmul_dw_cuda(torch.zeros((2, 4, 8)), torch.zeros((2, 4, 8))),
    ]
    for fn in checks:
        with pytest.raises(ValueError):
            fn()
    assert not any(ops.launch_counts().values())


def test_ops_training_path_on_cpu_is_plain():
    x, src, y, slot, w, xb, wb, be = _moe_inputs()
    ops.reset_launch_counts()
    assert torch.equal(ops.moe_dispatch(_t(x), _t(src)), tref.moe_dispatch(_t(x), _t(src)))
    assert torch.equal(ops.moe_combine(_t(y), _t(slot), _t(w)),
                       tref.moe_combine(_t(y), _t(slot), _t(w)))
    assert torch.equal(ops.grouped_matmul(_t(xb), _t(wb), block_experts=_t(be)),
                       tref.grouped_matmul_blocks(_t(xb), _t(wb), _t(be)))
    assert torch.equal(ops.grouped_matmul(_t(xb[:3]), _t(wb)),
                       tref.grouped_matmul(_t(xb[:3]), _t(wb)))
    assert not any(ops.launch_counts().values())


def test_ops_moe_combine_out_dtype_on_cpu():
    """``out_dtype`` rounds the f32 combine once: what the MoE layer's cast
    to its activations' dtype did before it passed ``out_dtype``."""
    _, _, y, slot, w, _, _, _ = _moe_inputs()
    yb = _t(y).bfloat16()
    want = tref.moe_combine(yb, _t(slot), _t(w))
    got = ops.moe_combine(yb, _t(slot), _t(w), out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want.to(torch.bfloat16))
    assert torch.equal(ops.moe_combine(yb, _t(slot), _t(w)), want)
