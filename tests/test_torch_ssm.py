"""The port's Mamba-2 serving path against the JAX package: the plain
versions of kernels 8 (RMSNorm) and 9 (SSD intra-chunk pass) against the
Pallas kernels in interpret mode, ``ssm_apply`` in every mode, the whole
model in prefill and decode, ``ServeEngine`` and greedy ``generate``.
Reduced mamba2-1.3b (f32, 2 layers, d_model 64, 8 heads of 16, N = 16,
chunk 16), weights from the JAX initializer through ``params_from_numpy``;
inputs from seeded numpy.

Tolerances: the Pallas tests' own (1e-5 f32 and 2e-2 bf16 for RMSNorm,
1e-4 for the SSD pass); 1e-4 on features (the same f32 math in another
einsum order, through a cumulative sum over up to 24 steps); tokens and
tick counts exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.kernels.rmsnorm import rmsnorm_pallas
from repro.kernels.ssd_chunk import ssd_chunk_pallas
from repro.models import layers as jL
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro.parallel.sharding import make_plan as jmake_plan
from repro.serve.decode import generate as jgenerate
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_reduced
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels.rmsnorm import rmsnorm_cuda
from repro_torch.kernels.ssd_chunk import ssd_chunk_cuda
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.parallel.sharding import make_plan
from repro_torch.serve.decode import generate
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.workload import WorkloadGenerator

ARCH = "mamba2-1.3b"
JPLAN = jmake_plan(None)
PLAN = make_plan(None)
FEAT_TOL = dict(atol=1e-4, rtol=1e-4)


def _np(a):
    return np.asarray(a, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jget_reduced(ARCH), get_reduced(ARCH)
    jparams = jax.jit(lambda k: jtfm.init_model(k, jcfg, JPLAN)[0])(jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg)


def test_reduced_config_matches_the_reference():
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    assert (cfg.d_model, cfg.num_layers, cfg.dtype, cfg.block_pattern) == \
        (64, 2, "float32", ("ssm",))
    s = cfg.ssm
    assert (s.expand * cfg.d_model // s.head_dim, s.head_dim, s.state_dim, s.chunk) == \
        (8, 16, 16, 16)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)


# ---------------------------------------------------------------------------
# interop: the f32 leaves of a bf16 tree
# ---------------------------------------------------------------------------


def test_params_from_numpy_takes_f32_ssm_leaves_under_bf16(model):
    """The reference's bf16 tree (its leaf dtypes from ``jax.eval_shape`` of
    its initializer, the values those of the f32 tree cast to them)."""
    jcfg, cfg = jget_reduced(ARCH, dtype="bfloat16"), get_reduced(ARCH, dtype="bfloat16")
    like = jax.eval_shape(lambda k: jtfm.init_model(k, jcfg, JPLAN)[0], jax.random.PRNGKey(1))
    tree = jax.tree.map(lambda a, sd: np.asarray(a).astype(sd.dtype), model[2], like)
    params = params_from_numpy(tree, cfg)
    blk = params["blocks"]["0_ssm"]["ssm"]
    assert {blk[k].dtype for k in ("dt_bias", "A_log", "D")} == {torch.float32}
    assert blk["w_x"].dtype == blk["norm"].dtype == params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(tree["blocks"]["0_ssm"]["ssm"]["w_x"]),
                                  blk["w_x"].float().numpy())
    # Still refused: a bf16 leaf stored as f32, and an f32 leaf stored as bf16.
    for path, cast in ((("blocks", "0_ssm", "ssm", "w_x"), np.float32),
                       (("blocks", "0_ssm", "ssm", "A_log"), jnp.bfloat16)):
        bad = jax.tree.map(lambda a: a, tree)
        node = bad
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = np.asarray(node[path[-1]]).astype(cast)
        with pytest.raises(TypeError, match=path[-1]):
            params_from_numpy(bad, cfg)


# ---------------------------------------------------------------------------
# plain versions of kernels 8 and 9 against the Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,d", [(64, 128), (256, 512), (96, 48)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas(t, d, dtype):
    rng = np.random.default_rng(t + d)
    xn = (rng.standard_normal((t, d)) * 3).astype(np.float32)
    wn = (rng.standard_normal(d) * 0.1).astype(np.float32)
    jd = getattr(jnp, dtype)
    x, w = jnp.asarray(xn, jd), jnp.asarray(wn, jd)
    tx, tw = _t(_np(x)).to(getattr(torch, dtype)), _t(_np(w)).to(getattr(torch, dtype))
    got = ops.rmsnorm(tx, tw)
    assert got.dtype == tx.dtype
    tol = 1e-5 if dtype == "float32" else 2e-2
    for want in (rmsnorm_pallas(x, w, interpret=True), jax.jit(jL.rms_norm)(x, w)):
        assert np.abs(got.float().numpy() - _np(want)).max() < tol


def _ssd_inputs(g, l, p, n, seed, decay=0.1):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((g, l, p)) * 0.5).astype(np.float32)
    da = (-np.abs(rng.standard_normal((g, l))) * decay).astype(np.float32)
    bm = (rng.standard_normal((g, l, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((g, l, n)) * 0.5).astype(np.float32)
    return x, da, bm, cm


@pytest.mark.parametrize("l,p,n,decay", [(16, 16, 8, 0.1), (64, 32, 16, 0.1), (32, 64, 32, 0.1),
                                         (1, 16, 8, 0.1), (24, 16, 16, 40.0)])
def test_ssd_chunk_plain_matches_pallas(l, p, n, decay):
    """The last case decays by ~40 a step: above the diagonal exp overflows
    to inf, which only the mask hides (no NaN may come through)."""
    x, da, bm, cm = _ssd_inputs(3, l, p, n, seed=l + p, decay=decay)
    jy, jst = ssd_chunk_pallas(*map(jnp.asarray, (x, da, bm, cm)), interpret=True)
    y, st = ref.ssd_chunk(*map(_t, (x, da, bm, cm)))
    assert y.dtype == st.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    assert np.abs(y.numpy() - _np(jy)).max() < 1e-4
    assert np.abs(st.numpy() - _np(jst)).max() < 1e-4


def test_ops_ssd_chunk_shares_b_and_c_across_heads():
    """``ops.ssd_chunk`` takes B/C once per (batch, chunk); the CPU path
    equals the plain version on the expanded per-group copy."""
    heads = 4
    x, da, bm, cm = _ssd_inputs(2 * heads, 12, 8, 16, seed=5)
    bm, cm = bm[::heads], cm[::heads]
    y, st = ops.ssd_chunk(*map(_t, (x, da, bm, cm)), heads=heads)
    ye, ste = ref.ssd_chunk(_t(x), _t(da), _t(np.repeat(bm, heads, 0)), _t(np.repeat(cm, heads, 0)))
    assert torch.equal(y, ye) and torch.equal(st, ste)


def test_new_ops_take_the_plain_path_on_cpu_and_wrappers_refuse_it():
    ops.reset_launch_counts()
    x = torch.randn((5, 64))
    assert torch.equal(ops.rmsnorm(x, torch.zeros(64), eps=1e-6), ref.rmsnorm(x, torch.zeros(64)))
    with pytest.raises(ValueError):
        rmsnorm_cuda(x, torch.zeros(64))
    with pytest.raises(ValueError):
        ssd_chunk_cuda(torch.zeros((2, 4, 8)), torch.zeros((2, 4)), torch.zeros((1, 4, 8)),
                       torch.zeros((1, 4, 8)), 2)
    counts = ops.launch_counts()
    assert {"rmsnorm", "ssd_chunk"} <= set(counts) and not any(counts.values()), counts


# ---------------------------------------------------------------------------
# the block and the model against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [24, 17])  # L = 12 (two chunks), and L = 1 (17 is prime)
def test_ssm_apply_matches_jax(model, s):
    """Train, prefill, then one decode step from the prefill's cache (which
    the port writes in place)."""
    jcfg, cfg, jparams, params = model
    jp = jax.tree.map(lambda a: a[1], jparams["blocks"]["0_ssm"]["ssm"])
    p = {k: v[1] for k, v in params["blocks"]["0_ssm"]["ssm"].items()}
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    xd = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)

    @jax.jit
    def jrun(jp, x, xd):
        yt, _ = jssm.ssm_apply(jp, x, jcfg, mode="train")
        yp, c = jssm.ssm_apply(jp, x, jcfg, mode="prefill")
        yd, cd = jssm.ssm_apply(jp, xd, jcfg, mode="decode", cache=c)
        return yt, yp, c, yd, cd

    jyt, jyp, jc, jyd, jcd = jrun(jp, jnp.asarray(x), jnp.asarray(xd))
    yt, none = ssm_mod.ssm_apply(p, _t(x), cfg, mode="train")
    yp, c = ssm_mod.ssm_apply(p, _t(x), cfg, mode="prefill")
    assert none is None
    for got, want in ((yt, jyt), (yp, jyp), (c["state"], jc["state"]), (c["conv"], jc["conv"])):
        np.testing.assert_allclose(got.numpy(), _np(want), **FEAT_TOL)
    yd, cd = ssm_mod.ssm_apply(p, _t(xd), cfg, mode="decode", cache=c)
    assert cd is c
    for got, want in ((yd, jyd), (c["state"], jcd["state"]), (c["conv"], jcd["conv"])):
        np.testing.assert_allclose(got.numpy(), _np(want), **FEAT_TOL)


@functools.lru_cache(maxsize=None)
def _jmodel(jcfg, mode):
    return jax.jit(lambda p, tok, c, t: jtfm.model_apply(
        p, {"tokens": tok}, jcfg, JPLAN, mode=mode, caches=c, t=t))


@pytest.mark.parametrize("s", [24, 17])
def test_model_prefill_then_decode_matches_jax(model, s):
    jcfg, cfg, jparams, params = model
    tok = np.random.default_rng(s).integers(0, cfg.vocab_size, (2, s + 2)).astype(np.int32)
    jf, jaux, jc = _jmodel(jcfg, "prefill")(jparams, jnp.asarray(tok[:, :s]), None, None)
    f, aux, c = tfm.model_apply(params, {"tokens": _t(tok[:, :s])}, cfg, PLAN, mode="prefill")
    assert jaux.moe_stats is None and aux.moe_stats is None and float(aux.balance_loss) == 0.0
    np.testing.assert_allclose(f.numpy(), _np(jf), **FEAT_TOL)
    # Decode into f32 slot caches as the batcher holds them.
    slots = tfm.init_caches(cfg, 2, 64, device="cpu")
    jslots = jtfm.init_caches(jcfg, 2, 64)
    for n, leaves in c.items():
        for k, v in leaves.items():
            assert slots[n][k].shape == v.shape == jc[n][k].shape
            slots[n][k].copy_(v)
            jslots[n][k] = jc[n][k].astype(jslots[n][k].dtype)
    assert tfm.pad_caches(slots, 99) == slots
    for i in range(2):
        t = np.int32(s + i)
        jf, _, jslots = _jmodel(jcfg, "decode")(jparams, jnp.asarray(tok[:, s + i:s + i + 1]),
                                                jslots, jnp.asarray(t))
        with torch.no_grad():
            f, aux, out = tfm.model_apply(params, {"tokens": _t(tok[:, s + i:s + i + 1])}, cfg,
                                          PLAN, mode="decode", caches=slots, t=torch.tensor(t))
        assert out is slots and aux.moe_stats is None
        np.testing.assert_allclose(f.numpy(), _np(jf), **FEAT_TOL)
    for n in slots:
        for k in slots[n]:
            np.testing.assert_allclose(slots[n][k].numpy(), _np(jslots[n][k]), **FEAT_TOL)


def test_transformer_still_refuses_other_families():
    for arch in ("recurrentgemma-9b", "deepseek-v2-236b", "whisper-base"):
        with pytest.raises(NotImplementedError):
            tfm.init_model(0, get_reduced(arch), PLAN, device="cpu")
    # The dense families run since the dense slice (tests/test_torch_dense.py).
    assert "mlp" in tfm.init_model(0, get_reduced("deepseek-7b"), PLAN,
                                   device="cpu")["blocks"]["0_global"]


# ---------------------------------------------------------------------------
# ServeEngine and generate against JAX
# ---------------------------------------------------------------------------


def test_port_engine_matches_jax_engine(model):
    jcfg, cfg, jparams, params = model
    gen = WorkloadGenerator("chat", seed=3, vocab_size=cfg.vocab_size)
    reqs = [dataclasses.replace(r, prompt_len=min(r.prompt_len, 24),
                                max_new_tokens=min(r.max_new_tokens, 6))
            for r in gen.generate(4)]
    kw = dict(slots=2, max_len=40)
    jeng = JServeEngine(jparams, jcfg, JPLAN, JServeConfig(**kw))
    jrep = jeng.run(reqs, gen)
    eng = ServeEngine(params, cfg, PLAN, ServeConfig(**kw), device="cpu")
    rep = eng.run(reqs, gen)
    assert not jeng.batcher.paged and not eng.batcher.paged
    assert rep.completed == jrep.completed == len(reqs)
    assert rep.ticks == jrep.ticks
    assert {r.rid: r.out for r in eng.batcher.finished} == \
        {r.rid: r.out for r in jeng.batcher.finished}
    assert rep.gate_load_total is None and eng.controlplane is None
    assert all(st.gate_load is None for st in eng.tick_log)
    # Slot state at the end, the dead slots' included: every slot advances
    # every tick, live or not, in both engines.
    for n, leaves in eng.batcher.caches.items():
        for k, leaf in leaves.items():
            np.testing.assert_allclose(leaf.numpy(), _np(jeng.batcher.caches[n][k]), **FEAT_TOL)


def test_port_generate_matches_jax_generate(model):
    jcfg, cfg, jparams, params = model
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    want = np.asarray(jgenerate(jparams, jcfg, JPLAN, jnp.asarray(prompts), max_new_tokens=5))
    got = generate(params, cfg, PLAN, prompts, max_new_tokens=5)
    assert got.dtype == torch.int32 and got.shape == (2, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    # Sampled: the prefill's token is an argmax, as in the reference; the
    # same seed repeats itself (the sampled parity with JAX is in
    # tests/test_torch_spec.py).
    a = generate(params, cfg, PLAN, prompts, max_new_tokens=5, sample=True, seed=3)
    assert torch.equal(a, generate(params, cfg, PLAN, prompts, max_new_tokens=5, sample=True,
                                   seed=3))
    assert torch.equal(a[:, 0], got[:, 0])
