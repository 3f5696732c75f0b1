"""The port's dense transformer block against the JAX package on the CPU: the
MLP (silu-gated, GEGLU, plain gelu, plain silu), ``model_apply`` in train,
prefill and decode (dense and paged KV) for the four dense families at
reduced size (gemma2 with its window and softcap made to bind), the trainer
step for step against the JAX trainer (gemma2, tied, and deepseek-7b, each
resuming from the JAX trainer's checkpoint), the serving engine's tokens,
a tied-head pipeline (PP(2) equal to PP(1) bit for bit, and near the JAX
package's ``make_pp_train_step``), a data-parallel step over two gloo ranks
against one device, a dense checkpoint read both ways, the ``sp_shardmap``
refusal, remat, a prefix hit against a miss and the launcher.

Weights are seeded numpy in the JAX package's tree (taken from
``jax.eval_shape`` of its initializer, so no init program compiles),
handed to the port through ``params_from_numpy``; inputs are seeded numpy.
Tolerances: integer outputs and served tokens exactly; f32 results within
``atol=rtol=1e-5`` (the same math summed in another order by XLA and by
PyTorch's CPU kernels), logits within ``atol=1e-4``; after AdamW steps,
losses within ``rtol=1e-4`` and parameters within ``atol=1e-4`` (a tenth of
the learning rate: where a gradient is near AdamW's eps, the update's size
follows the gradient's low bits).
"""

import dataclasses
import functools
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_prefix import admission_logits, prefix_hit_and_miss

from repro.configs import get_reduced as jget_reduced
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import layers as jL
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.parallel.sharding import make_plan as jmake_plan
from repro.serve.decode import generate as jgenerate
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtrainer_mod
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.sharding import make_plan
from repro_torch.serve.decode import generate
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.workload import WorkloadGenerator
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.backends.cuda.matmul.allow_tf32 = False
TOL = dict(atol=1e-5, rtol=1e-5)
JPLAN = jmake_plan(None)
PLAN = make_plan(None)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")

# Per family, on both sides: gemma2's window (4096 in the reduced config)
# and softcap made to bind at S = 24; deepseek-7b keeps its group of 1
# (Hq = Hkv) at 4 heads.
ARCHS = {
    "gemma2-2b": dict(window_size=8, logit_softcap=2.0),
    "deepseek-7b": dict(num_kv_heads=4),
    "deepseek-67b": {},
    "mistral-large-123b": {},
}
SEQ, PAGE, PAGES = 24, 8, 4  # prompt length; page size; table width (32 positions)


def _cfgs(arch: str, **kw):
    kw = {**ARCHS[arch], **kw}
    return jget_reduced(arch, **kw), get_reduced(arch, **kw)


@functools.lru_cache(maxsize=None)
def _weights(arch: str) -> dict:
    """Seeded numpy weights in the JAX package's tree: norm weights
    N(0, 0.01) (the norm scales by 1 + w), each matrix N(0, 1 / its fan-in)
    as the JAX initializer scales it."""
    jcfg, _ = _cfgs(arch)
    shapes = jax.eval_shape(lambda k: jtfm.init_model(k, jcfg, JPLAN)[0], jax.random.PRNGKey(0))
    rng = np.random.default_rng(sorted(ARCHS).index(arch))

    def draw(path, s):
        name = path[-1].key
        if "norm" in name:
            fan_in = 100
        elif name == "embed":
            fan_in = s.shape[-1]
        elif name in ("wq", "wk", "wv"):
            fan_in = s.shape[-3]
        elif name == "wo":
            fan_in = s.shape[-3] * s.shape[-2]
        else:
            fan_in = s.shape[-2]
        return (rng.standard_normal(s.shape) * fan_in**-0.5).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _both(arch: str):
    """(JAX params, port params) of ``_weights(arch)``."""
    w = _weights(arch)
    return jax.tree.map(jnp.asarray, w), params_from_numpy(w, _cfgs(arch)[1])


def _close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


# ---------------------------------------------------------------------------
# the MLP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act,gated", [("silu", True), ("geglu", True), ("gelu", False),
                                       ("silu", False)])
def test_mlp_apply_matches_jax(act, gated):
    """Each activation on both sides, also on ``decode_rows`` blocks (37
    rows: one full block and a padded one)."""
    jcfg, cfg = _cfgs("deepseek-7b", act=act)
    rng = np.random.default_rng(3)
    w = {"w_in": rng.standard_normal((64, 96)) / 8, "w_out": rng.standard_normal((96, 64)) / 10}
    if gated:
        w["w_gate"] = rng.standard_normal((64, 96)) / 8
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.standard_normal((1, 37, 64)).astype(np.float32)
    want = jax.jit(functools.partial(jL.mlp_apply, cfg=jcfg))(
        jax.tree.map(jnp.asarray, w), jnp.asarray(x))
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    _close(L.mlp_apply(tw, torch.from_numpy(x), cfg), want)
    _close(L.mlp_apply(tw, torch.from_numpy(x), cfg, fixed_rows=True), want)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_builds_the_reference_tree(arch):
    """The port's own initializer gives the JAX package's tree: names,
    shapes, dtypes; a tied head has no ``lm_head``; non-MoE leaves only."""
    jcfg, cfg = _cfgs(arch)
    want = dict(_flat(jax.eval_shape(lambda k: jtfm.init_model(k, jcfg, JPLAN)[0],
                                     jax.random.PRNGKey(0))))
    got = dict(_flat(tfm.init_model(0, cfg, PLAN, device="cpu")))
    assert sorted(got) == sorted(want)
    for k, s in want.items():
        assert tuple(got[k].shape) == s.shape and str(got[k].dtype).endswith(str(s.dtype)), k
    assert ("/lm_head" in got) == (not cfg.tie_embeddings)
    assert not any("/moe/" in k for k in got) and any("/mlp/w_in" in k for k in got)
    assert any("/mlp/w_gate" in k for k in got) == (cfg.act in ("silu", "swiglu", "geglu"))


NUM_PAGES = 2 * PAGES + 2


def _paged(cache, table, xp):
    """A ``[reps, B, S, Hkv, dh]`` prefill cache laid into a ``[reps, N,
    page, Hkv, dh]`` pool through ``table`` (``xp``: numpy or jax.numpy)."""
    reps, b, s = cache.shape[:3]
    pos = np.arange(s)
    pid, off = table[:, pos // PAGE], np.broadcast_to(pos % PAGE, (b, s))
    pool = xp.zeros((reps, NUM_PAGES, PAGE, *cache.shape[3:]), cache.dtype)
    if xp is np:
        pool[:, pid, off] = cache
        return pool
    return pool.at[:, pid, off].set(cache)


@functools.lru_cache(maxsize=None)
def _jax_program(arch: str):
    """The JAX side of one family as one program: train-mode features and
    cross entropy, the prefill, then one decode chunk against the padded
    dense caches and against a paged pool holding the same K/V."""
    jcfg, _ = _cfgs(arch)
    apply = functools.partial(jtfm.model_apply, cfg=jcfg, plan=JPLAN)

    @jax.jit
    def run(params, tokens, labels, nxt, table, t):
        feats, _, _ = apply(params, {"tokens": tokens}, mode="train")
        ce = jtfm.chunked_cross_entropy(params, feats, labels, jcfg)
        pf, aux, caches = apply(params, {"tokens": tokens}, mode="prefill")
        logits = jtfm.logits_from_features(params, pf, jcfg)
        dense = jtfm.pad_caches(caches, PAGES * PAGE)
        pools = jax.tree.map(lambda c: _paged(c, table, jnp), caches)
        d, _, dc = apply(params, {"tokens": nxt}, mode="decode", caches=dense, t=t)
        pg, _, pc = apply(params, {"tokens": nxt}, mode="decode", caches=pools, t=t,
                          page_table=table)
        return feats, ce, logits, caches, aux.balance_loss, d, dc, pg, pc

    return run


@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_apply_matches_jax(arch):
    """Train-mode features and cross entropy; prefill features, logits and
    K/V caches; then one 2-token decode chunk at t = 24 against the padded
    dense caches and against a paged pool holding the same K/V (a permuted
    table): features and written caches against the JAX package, and the
    port's paged run equal to its dense run bit for bit."""
    jcfg, cfg = _cfgs(arch)
    jp, tp = _both(arch)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (2, SEQ)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (2, SEQ)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (2, 2)).astype(np.int32)
    table = rng.permutation(NUM_PAGES)[:2 * PAGES].reshape(2, PAGES).astype(np.int32)
    t = np.full((2,), SEQ, np.int32)
    jf, jce, jlogits, jcaches, jbal, jd, jdc, jpg, jpc = _jax_program(arch)(
        jp, *map(jnp.asarray, (tokens, labels, nxt, table, t)))
    t_tok = torch.from_numpy(tokens)
    with torch.no_grad():
        feats, aux, _ = tfm.model_apply(tp, {"tokens": t_tok}, cfg, PLAN, mode="train")
        ce = tfm.chunked_cross_entropy(tp, feats, torch.from_numpy(labels), cfg)
        pf, _, caches = tfm.model_apply(tp, {"tokens": t_tok}, cfg, PLAN, mode="prefill")
    assert aux.moe_stats is None and aux.dropped_fraction is None
    assert float(aux.balance_loss) == float(aux.z_loss) == float(jbal) == 0.0
    _close(feats, jf)
    _close(ce, jce)
    assert torch.equal(pf, feats)
    _close(tfm.logits_from_features(tp, pf, cfg), jlogits, atol=1e-4, rtol=1e-5)
    for name in caches:
        for k in ("k", "v"):
            _close(caches[name][k], jcaches[name][k])

    dense = tfm.pad_caches(caches, PAGES * PAGE)
    pools = {n: {k: torch.from_numpy(_paged(v.numpy(), table, np)) for k, v in c.items()}
             for n, c in caches.items()}
    kw = dict(mode="decode", t=torch.from_numpy(t))
    with torch.no_grad():
        d, _, dense = tfm.model_apply(tp, {"tokens": torch.from_numpy(nxt)}, cfg, PLAN,
                                      caches=dense, **kw)
        pg, _, pools = tfm.model_apply(tp, {"tokens": torch.from_numpy(nxt)}, cfg, PLAN,
                                       caches=pools, page_table=torch.from_numpy(table), **kw)
    _close(d, jd)
    _close(pg, jpg)
    assert torch.equal(d, pg)
    for name in dense:
        for k in ("k", "v"):
            _close(dense[name][k], jdc[name][k])
            _close(pools[name][k], jpc[name][k])


def test_remat_modes_bit_identical(monkeypatch):
    """Reduced gemma2 with remat "none", "full" and "dots": the loss and
    every gradient bit-identical; "dots" keeps the MLP's 2-D products (its
    policy saves ``mm``) and recomputes the rest."""
    from repro_torch.train.train_step import loss_fn

    _, cfg = _cfgs("gemma2-2b")
    params = params_from_numpy(_weights("gemma2-2b"), cfg, trainable=True)
    b = next(iter(SyntheticLM(cfg.vocab_size, SEQ, 2, seed=1)))
    batch = {"tokens": torch.from_numpy(b.tokens), "labels": torch.from_numpy(b.labels)}
    saved, policy = [], tfm._dots_policy

    def counting(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if out.name == "MUST_SAVE":
            saved.append((op, tuple(args[0].shape)))
        return out

    monkeypatch.setattr(tfm, "_dots_policy", counting)
    leaves = [t for _, t in _flat(params)]
    runs = []
    for remat in ("none", "full", "dots"):
        loss, _ = loss_fn(params, batch, dataclasses.replace(cfg, remat=remat), PLAN)
        runs.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    for loss, grads in runs[1:]:
        assert torch.equal(loss, runs[0][0])
        assert all(torch.equal(a, g) for a, g in zip(grads, runs[0][1]))
    assert (torch.ops.aten.mm.default, (2 * SEQ, cfg.d_model)) in saved


def test_prefix_hit_equals_a_miss(monkeypatch):
    """The card test's prefix check on reduced gemma2 on the CPU: a prompt
    admitted after another with the same 64-token prefix (a hit on 4
    pages) gets the miss's admission logits and tokens bit for bit."""
    _, cfg = _cfgs("gemma2-2b")
    out = prefix_hit_and_miss(_both("gemma2-2b")[1], cfg, "cpu", admission_logits(monkeypatch))
    assert torch.equal(out[True][0], out[False][0]) and out[True][1] == out[False][1]


def test_sp_shardmap_is_refused():
    """``sp_shardmap=True`` was refused until the sequence-parallel paths
    were ported; without a model axis it is now the plain path, as in the
    reference (its condition needs a mesh): the same init and the same
    features bit for bit (``tests/test_torch_zero3_sp.py`` runs it over a
    mesh)."""
    _, cfg = _cfgs("gemma2-2b")
    params = tfm.init_model(0, cfg, PLAN, device="cpu")
    sp = dataclasses.replace(cfg, sp_shardmap=True)
    drawn = tfm.init_model(0, sp, PLAN, device="cpu")
    assert all(torch.equal(drawn["blocks"]["0_local"][k], v)
               for k, v in params["blocks"]["0_local"].items() if not isinstance(v, dict))
    toks = {"tokens": torch.arange(8, dtype=torch.int32).reshape(1, 8)}
    with torch.no_grad():
        assert not tfm.seq_parallel(sp, PLAN, None, "train", 8)
        assert torch.equal(tfm.model_apply(params, toks, sp, PLAN)[0],
                           tfm.model_apply(params, toks, cfg, PLAN)[0])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-7b"])
def test_trainer_matches_jax_step_for_step(monkeypatch, tmp_path, arch):
    """Both trainers from one state (the JAX trainer's initializer replaced
    by the shared numpy weights), 4 steps, no control plane (dense); the JAX
    trainer checkpoints at step 3 and a fresh port trainer restores that
    record (weights and moments) and runs step 4 as the JAX trainer did."""
    jcfg, cfg = _cfgs(arch)
    opt = dict(lr=1e-3, warmup_steps=1)

    def init(key, c, pl, o):
        jp = _both(arch)[0]
        return jp, None, jadamw.init_adamw(jp, o)

    monkeypatch.setattr(jtrainer_mod, "init_all", init)
    kw = dict(total_steps=4, reconfig_every=2)
    jtr = jtrainer_mod.Trainer(jcfg, jadamw.AdamWConfig(**opt), jtrainer_mod.TrainerConfig(
        **kw, ckpt_every=3, ckpt_dir=str(tmp_path), ckpt_async=False), JPLAN, seed=0)
    tr = Trainer(cfg, AdamWConfig(**opt), TrainerConfig(**kw), PLAN, device="cpu")
    tr.params = params_from_numpy(_weights(arch), cfg, trainable=True)
    tr.opt_state = params_from_numpy(jax.tree.map(np.asarray, jtr.opt_state))
    assert tr.controlplane is None and jtr.controlplane is None
    jlog = jtr.train(iter(JSyntheticLM(cfg.vocab_size, 16, 2, seed=0)))
    log = tr.train(iter(SyntheticLM(cfg.vocab_size, 16, 2, seed=0)))
    for tm, jm in zip(log, jlog, strict=True):
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        assert "expert_load" not in tm and float(tm["balance_loss"]) == 0.0
    want = dict(_flat(jax.tree.map(np.asarray, jtr.params)))
    for k, a in _flat(tr.params):
        _close(a, want[k], rtol=1e-3, atol=1e-4)
    resumed = Trainer(cfg, AdamWConfig(**opt), TrainerConfig(**kw, ckpt_dir=str(tmp_path)),
                      PLAN, seed=1, device="cpu")
    assert resumed.maybe_restore() and resumed.step == 3
    data = iter(SyntheticLM(cfg.vocab_size, 16, 2, seed=0))
    for _ in range(3):
        next(data)
    for tm, jm in zip(resumed.train(data), jlog[3:], strict=True):
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)


def test_dense_checkpoint_read_both_ways(tmp_path):
    """A dense tied tree (gemma2's) written by the port restores in the JAX
    package bit for bit, and the JAX package's record of it in the port."""
    w = _weights("gemma2-2b")
    _, tp = _both("gemma2-2b")
    ckpt.save(str(tmp_path / "port"), 3, tp)
    jckpt.save(str(tmp_path / "jax"), 3, jax.tree.map(jnp.asarray, w))
    jback = jckpt.restore(str(tmp_path / "port"), 3, jax.tree.map(jnp.zeros_like, w))
    back = ckpt.restore(str(tmp_path / "jax"), 3, jax.tree.map(torch.zeros_like, tp))
    assert "lm_head" not in back
    jback = dict(_flat(jax.tree.map(np.asarray, jback)))
    back = dict(_flat(back))
    for k, c in _flat(w):
        np.testing.assert_array_equal(back[k].numpy(), c)
        np.testing.assert_array_equal(jback[k], c)


def test_launcher_trains_reduced_gemma2_on_cpu(capsys):
    launch_train.main(["--arch", "gemma2-2b", "--reduced", "--device", "cpu", "--steps", "2",
                       "--batch", "2", "--seq-len", "16"])
    out = capsys.readouterr().out
    assert "gemma2-2b" in out and "reconfigs=0" in out


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _requests(n, vocab, seed=3):
    gen = WorkloadGenerator("chat", seed=seed, vocab_size=vocab)
    reqs = [dataclasses.replace(r, prompt_len=min(r.prompt_len, 20),
                                max_new_tokens=min(r.max_new_tokens, 6))
            for r in gen.generate(n)]
    return gen, reqs


def test_engine_tokens_equal_the_jax_engine():
    """Reduced gemma2 (window and softcap binding) served by both engines,
    paged, each prompt admitted as one decode-mode chunk on both sides:
    the tokens are the JAX engine's exactly.  Port against port, the same
    tokens with dense KV, with whole-prompt admission, and decoded
    speculatively (the draft is the dense model itself); and ``generate``'s
    tokens (a batch prefill, then decode steps) equal the JAX package's."""
    jcfg, cfg = _cfgs("gemma2-2b")
    jp, tp = _both("gemma2-2b")
    gen, reqs = _requests(4, cfg.vocab_size)
    scfg = dict(slots=2, max_len=40, page_size=PAGE)
    jeng = JServeEngine(jp, jcfg, JPLAN, JServeConfig(**scfg, prefill_chunk=20))
    assert jeng.run(reqs, gen).completed == len(reqs)
    want = {r.rid: r.out for r in jeng.batcher.finished}
    for kw in ({"prefill_chunk": 20}, {}, {"paged": False}, {"spec_k": 3}):
        eng = ServeEngine(tp, cfg, PLAN, ServeConfig(**scfg, **kw), device="cpu")
        rep = eng.run(reqs, gen)
        assert rep.completed == len(reqs) and eng.controlplane is None, kw
        assert {r.rid: r.out for r in eng.batcher.finished} == want, kw
        if kw.get("spec_k"):
            assert eng.batcher.draft_mode == "off" and rep.spec_drafted > 0
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, SEQ)).astype(np.int32)
    want = np.asarray(jgenerate(jp, jcfg, JPLAN, jnp.asarray(prompts), max_new_tokens=4))
    np.testing.assert_array_equal(generate(tp, cfg, PLAN, prompts, max_new_tokens=4).numpy(), want)


# ---------------------------------------------------------------------------
# a tied head over pipeline stages: 2 gloo ranks and a JAX process with 2
# host devices, started with the module and read by the last test
# ---------------------------------------------------------------------------

PP_STEPS = 2
PP_MB = 2

JAX_PP = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
sys.path.insert(0, TESTS)
import test_torch_dense as T
from repro.launch.mesh import make_mesh, use_mesh
from repro.optim import adamw as jadamw
from repro.parallel.sharding import make_plan
from repro.train.pp_step import make_pp_train_step

inp = dict(np.load(IN))
jcfg, _ = T._cfgs("gemma2-2b")
opt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1)
mesh = make_mesh((2, 1), ("stage", "model"))
out = {}
with use_mesh(mesh):
    p = jax.tree.map(jnp.asarray, T._weights("gemma2-2b"))
    o = jadamw.init_adamw(p, opt)
    step = jax.jit(make_pp_train_step(jcfg, make_plan(mesh, fsdp=False), opt, mesh, pp_stages=2,
                                      microbatches=T.PP_MB))
    for i in range(T.PP_STEPS):
        p, o, met = step(p, o, {"tokens": jnp.asarray(inp[f"tokens{i}"]),
                                "labels": jnp.asarray(inp[f"labels{i}"])})
        out[f"loss{i}"] = met["loss"]
out.update({f"p{k}": np.asarray(v) for k, v in T._flat(jax.tree.map(np.asarray, p))})
np.savez(OUT, **out)
"""


def _pp_rank(rank: int, inp_path: str, out_dir: str, port: int) -> None:
    torch.set_num_threads(1)
    from repro_torch.interop import shard_params
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.optim.adamw import init_adamw
    from repro_torch.train.pp_step import make_pp_train_step

    init_distributed(rank=rank, world_size=2, init_method=f"tcp://localhost:{port}",
                     device_type="cpu")
    inp = dict(np.load(inp_path))
    _, cfg = _cfgs("gemma2-2b")
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)
    out = {}
    for tag, shape, axes in (("pp2", (2, 1), ("stage", "model")),
                             ("pp1", (2, 1, 1), ("rep", "stage", "model"))):
        mesh = make_mesh(shape, axes)
        plan = make_plan(mesh, fsdp=False)
        params = params_from_numpy(shard_params(_weights("gemma2-2b"), plan, mesh, cfg=cfg), cfg,
                                   trainable=True)
        state = init_adamw(params, opt)
        step = make_pp_train_step(cfg, plan, opt, mesh, pp_stages=shape[axes.index("stage")],
                                  microbatches=PP_MB)
        for i in range(PP_STEPS):
            batch = {k: torch.from_numpy(inp[f"{k}{i}"]) for k in ("tokens", "labels")}
            params, state, met = step(params, state, batch)
            out[f"{tag}/loss{i}"] = met["loss"].numpy()
            out[f"{tag}/norm{i}"] = met["grad_norm"].numpy()
        out.update({f"{tag}/p{k}": v.detach().numpy() for k, v in _flat(params)})
    # The data-parallel step over ("data", "model") = (2, 1): every leaf
    # (the MLP's too) stays whole on each rank and its gradient is averaged
    # over the data axis; against the one-device step on the whole batch.
    from repro_torch.optim.adamw import init_adamw as init
    from repro_torch.train.train_step import make_train_step

    mesh = make_mesh((2, 1), ("data", "model"))
    plan = make_plan(mesh, fsdp=False)
    held = shard_params(_weights("gemma2-2b"), plan, mesh, cfg=cfg)
    out["dp/whole"] = all(a.shape == b.shape for (_, a), (_, b) in
                          zip(_flat(held), _flat(_weights("gemma2-2b"))))
    batch = {k: torch.from_numpy(inp[f"{k}0"]) for k in ("tokens", "labels")}
    mine = {k: v[rank * 2:(rank + 1) * 2] for k, v in batch.items()}
    for tag, m, pl, b in (("dp", mesh, plan, mine), ("one", None, make_plan(None), batch)):
        params = params_from_numpy(held, cfg, trainable=True)
        params, _, met = make_train_step(cfg, pl, opt, mesh=m)(params, init(params, opt), b)
        out[f"{tag}/loss"] = met["loss"].numpy()
        out.update({f"{tag}/p{k}": v.detach().numpy() for k, v in _flat(params)})
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def _pp_main(inp_path: str, out_dir: str, port: int) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_pp_rank, args=(inp_path, out_dir, port), nprocs=2, join=True)


@pytest.fixture(scope="module", autouse=True)
def pp_runs(request, tmp_path_factory):
    """Both sides of the pipeline test, started with the module (when that
    test is collected) so they run beside its other tests; ``wait()``
    returns (JAX outputs, port ranks)."""
    from repro_torch.launch.train import free_port

    if not any(item.name == "test_tied_head_pipeline_equals_one_stage_and_jax"
               for item in request.session.items):
        yield None
        return
    d = tmp_path_factory.mktemp("pp")
    _, cfg = _cfgs("gemma2-2b")
    data = SyntheticLM(cfg.vocab_size, 16, 4, seed=0)
    inp = {}
    for i in range(PP_STEPS):
        b = next(data)
        inp[f"tokens{i}"], inp[f"labels{i}"] = b.tokens.astype(np.int32), b.labels.astype(np.int32)
    inp_path = str(d / "inputs.npz")
    np.savez(inp_path, **inp)
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + tests + os.pathsep + env.get("PYTHONPATH", "")
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=2", JAX_PLATFORMS="cpu")
    jcode = (f"TESTS = {json.dumps(tests)}\nIN = {json.dumps(inp_path)}\n"
             f"OUT = {json.dumps(str(d / 'jax.npz'))}\n" + JAX_PP)
    tcode = (f"import test_torch_dense as T; "
             f"T._pp_main({json.dumps(inp_path)}, {json.dumps(str(d))}, {free_port()})")
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=e, start_new_session=True)
             for code, e in ((tcode, dict(env, OMP_NUM_THREADS="1")), (jcode, jenv))]

    class Runs:
        result = None

        def wait(self):
            if self.result is None:
                for p, what in zip(procs, ("port", "JAX")):
                    so, se = p.communicate(timeout=600)
                    if p.returncode != 0:
                        stop()
                        raise AssertionError(f"{what} side failed:\nSTDOUT:\n{so[-3000:]}\n"
                                             f"STDERR:\n{se[-6000:]}")
                self.result = (dict(np.load(d / "jax.npz")),
                               [dict(np.load(d / f"rank{r}.npz")) for r in range(2)])
            return self.result

    def stop():
        """Ends both sides with their children (the spawned ranks)."""
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()

    runs = Runs()
    yield runs
    stop()


def test_tied_head_pipeline_equals_one_stage_and_jax(pp_runs):
    """Gemma2's tied head over 2 stages (the embedding on both ends, its
    gradient summed over the stage axis): every loss, clipping norm and
    parameter equal PP(1)'s bit for bit, both copies of the embedding
    equal, and the whole against the JAX package's pipelined step."""
    jax_out, ranks = pp_runs.wait()
    r0, r1 = ranks
    for r, stage in zip(ranks, (0, 1)):
        for i in range(PP_STEPS):
            assert r[f"pp2/loss{i}"] == r[f"pp1/loss{i}"]
            assert r[f"pp2/norm{i}"] == r[f"pp1/norm{i}"]
            _close(r[f"pp2/loss{i}"], jax_out[f"loss{i}"])
        for k in [k for k in r if k.startswith("pp2/p")]:
            name = k[len("pp2/p"):]
            want = r[f"pp1/p{name}"]
            if name.startswith("/blocks/"):
                want = want[stage:stage + 1]
            np.testing.assert_array_equal(r[k], want, err_msg=name)
            full = jax_out[f"p{name}"]
            _close(r[k], full[stage:stage + 1] if name.startswith("/blocks/") else full,
                   rtol=1e-5, atol=1e-4)
    assert "pp2/p/embed" in r0 and "pp2/p/embed" in r1 and "pp2/p/lm_head" not in r1
    np.testing.assert_array_equal(r0["pp2/p/embed"], r1["pp2/p/embed"])
    assert "pp2/p/final_norm" in r1 and "pp2/p/final_norm" not in r0


def test_dense_data_parallel_step_matches_one_device(pp_runs):
    """Two data ranks (gloo): every leaf whole on each rank (the MLP's and
    the tied embedding among them), the two ranks' parameters equal bit for
    bit after the step, and the step against one device on the whole batch
    (the loss within 1e-5, parameters within 1e-4 after AdamW)."""
    _, ranks = pp_runs.wait()
    r0, r1 = ranks
    assert r0["dp/whole"] and r1["dp/whole"]
    keys = [k for k in r0 if k.startswith("dp/p")]
    assert any("/mlp/w_gate" in k for k in keys)
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        _close(r0[k], r0["one/p" + k[len("dp/p"):]], rtol=1e-5, atol=1e-4)
    _close(r0["dp/loss"], r0["one/loss"])
