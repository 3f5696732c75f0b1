"""Sampled and speculative decoding in the port (repro_torch.prng,
train_step's sampled / verify / draft steps, the batcher's speculative
tick, moe's draft modes), against the JAX package and against itself.

- ``repro_torch.prng`` against ``jax.random``: keys, bits and the uniform's
  float bits exactly; ``gumbel`` within 2 ulp of max(|g|, 1) (PyTorch's
  ``log`` may round the inner log one ulp apart from XLA's, which moves a
  result near 0 by an ulp of 1).
- Port speculative tokens equal port serial tokens, greedy and sampled,
  with reconfiguration on and the page pool balancing after every tick;
  EOS at every position of a span; truncation across page boundaries; the
  seed discipline.
- Port tokens equal the JAX engine's and ``generate``'s for the same run
  (the toy is float32; tokens compared exactly).

The toy is the reference's MoE toy (``tests/test_spec.py``: 2 layers,
d_model 32, 8 experts top-2, mixnet backend).  Each JAX step is jitted once
per shape: every prompt here has the same length.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models import routing as jrouting
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import MoEConfig as JMoEConfig
from repro.parallel.sharding import make_plan as jmake_plan
from repro.serve.batching import Request as JRequest
from repro.serve.decode import generate as jgenerate
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train import train_step as jts
from repro_torch import prng
from repro_torch.models import moe, routing
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.transformer import init_model
from repro_torch.parallel.sharding import make_plan
from repro_torch.serve.batching import Request
from repro_torch.serve.decode import generate
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.train import train_step

PLAN = make_plan(None)
JPLAN = jmake_plan(None)
PROMPT_LEN = 8


def _cfgs(dispatch="dropless", shared=1):
    kw = dict(num_experts=8, top_k=2, d_ff=32, num_shared_experts=shared, capacity_factor=8.0,
              backend="mixnet", a2a_group=2, dispatch=dispatch)
    args = ("sps", "moe", 2, 32, 4, 2, 0, 64)
    return (JModelConfig(*args, dtype="float32", remat="none", moe=JMoEConfig(**kw)),
            ModelConfig(*args, dtype="float32", remat="none", moe=MoEConfig(**kw)))


@pytest.fixture(scope="module")
def toys():
    """The port's seeded parameters and the JAX package's copy (the trees
    match name for name), for the shared-expert toy and the pure sparse
    one."""
    out = {}
    for shared in (1, 0):
        params = init_model(1, _cfgs(shared=shared)[1], PLAN, device="cpu")
        out[shared] = (jax.tree.map(lambda t: jnp.asarray(t.numpy()), params), params)
    return out


def _prompts(seed, n=4, vocab=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab - 1, size=PROMPT_LEN).astype(np.int32) for _ in range(n)]


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _scfg(cls, spec_k, sample, sample_seed, reconfig, page_size):
    return cls(slots=2, max_len=48, prefill_chunk=0, paged=True, page_size=page_size,
               spec_k=spec_k, sample=sample, sample_seed=sample_seed,
               reconfig_every=3 if reconfig else 0, reconfig_min_gain=0.0, num_devices=4)


def _serve(params, cfg, prompts, *, spec_k, sample=False, sample_seed=0, eos=None, max_new=8,
           reconfig=False, page_size=8):
    """The port's engine, with a leak check after every tick."""
    eng = ServeEngine(_clone(params), cfg, PLAN,
                      _scfg(ServeConfig, spec_k, sample, sample_seed, reconfig, page_size),
                      device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=100 + i, prompt=p, max_new_tokens=max_new, eos_id=eos))
    while eng.batcher.busy:
        eng.step()
        eng.batcher.alloc.check_leaks()
    rep = eng.report(1.0)
    assert rep.completed == len(prompts)
    return {r.rid: list(r.out) for r in eng.batcher.finished}, rep, eng


def _jserve(jparams, jcfg, prompts, *, spec_k, sample=False, sample_seed=0, reconfig=False):
    eng = JServeEngine(jax.tree.map(lambda a: a, jparams), jcfg, JPLAN,
                       _scfg(JServeConfig, spec_k, sample, sample_seed, reconfig, 8))
    for i, p in enumerate(prompts):
        eng.submit(JRequest(rid=100 + i, prompt=p, max_new_tokens=8))
    while eng.batcher.busy:
        eng.step()
    return {r.rid: list(r.out) for r in eng.batcher.finished}, eng.report(1.0), eng


# ---------------------------------------------------------------------------
# prng against jax.random
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_prng_key_and_fold_in_match_jax(seed):
    k, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(k))
    for d in (0, 7, 12345, 2**31 - 1):
        k, tk = jax.random.fold_in(k, d), prng.fold_in(tk, d)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(k))
    # Batched: one key folded with a vector, and a key per datum.
    ks = jax.vmap(jax.random.fold_in, (None, 0))(k, jnp.arange(5))
    tks = prng.fold_in(tk, torch.arange(5))
    np.testing.assert_array_equal(tks.numpy(), np.asarray(ks))
    np.testing.assert_array_equal(prng.fold_in(tks, torch.arange(5) + 3).numpy(),
                                  np.asarray(jax.vmap(jax.random.fold_in)(ks, jnp.arange(5) + 3)))


SHAPES = [(1,), (7,), (3, 5), (2, 3, 4), (131,), (64,)]


@pytest.fixture(scope="module")
def jax_draws():
    """JAX's bits, uniforms (on [0, 1) and [tiny, 1)) and Gumbel draws at
    every shape of SHAPES, and a batch of three keys' bits at (7,): one
    jitted call."""
    tiny = np.finfo(np.float32).tiny

    @jax.jit
    def draws(k):
        ks = jax.vmap(jax.random.fold_in, (None, 0))(k, jnp.arange(3))
        return ([(jax.random.bits(k, s), jax.random.uniform(k, s),
                  jax.random.uniform(k, s, minval=tiny), jax.random.gumbel(k, s)) for s in SHAPES],
                jax.vmap(lambda kk: jax.random.bits(kk, (7,)))(ks))

    per_shape, batch = draws(jax.random.fold_in(jax.random.PRNGKey(3), 11))
    return [tuple(np.asarray(a) for a in d) for d in per_shape], np.asarray(batch)


@pytest.mark.parametrize("i", range(len(SHAPES)))
def test_prng_bits_uniform_gumbel_match_jax(jax_draws, i):
    shape = SHAPES[i]
    (bits, u, ut, g), batch = jax_draws[0][i], jax_draws[1]
    tk = prng.fold_in(prng.prng_key(3), 11)
    np.testing.assert_array_equal(prng.random_bits(tk, shape).numpy(), bits)
    np.testing.assert_array_equal(prng.uniform(tk, shape).numpy().view(np.uint32),
                                  u.view(np.uint32))
    tiny = np.finfo(np.float32).tiny
    np.testing.assert_array_equal(prng.uniform(tk, shape, tiny).numpy().view(np.uint32),
                                  ut.view(np.uint32))
    tg = prng.gumbel(tk, shape).numpy()
    assert (np.abs(tg - g) <= 2 * np.spacing(np.maximum(np.abs(g), 1).astype(np.float32))).all()
    if shape == (7,):  # a batch of keys draws each key's own row
        np.testing.assert_array_equal(
            prng.random_bits(prng.fold_in(tk, torch.arange(3)), shape).numpy(), batch)


def test_sample_rows_and_categorical_match_jax(monkeypatch):
    """The draw against JAX's with JAX's Gumbel noise injected: the argmax
    is then exact; ``categorical`` for one key likewise."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 97)).astype(np.float32) * 3
    keys = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.PRNGKey(9), jnp.arange(6))
    want = np.asarray(jts._sample_rows(jnp.asarray(logits), keys))
    noise = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (97,)))(keys))
    tkeys = prng.fold_in(prng.prng_key(9), torch.arange(6))
    monkeypatch.setattr(train_step.prng, "gumbel", lambda k, s: torch.from_numpy(noise))
    got = train_step._sample_rows(torch.from_numpy(logits), tkeys)
    np.testing.assert_array_equal(got.numpy(), want)
    monkeypatch.undo()
    np.testing.assert_array_equal(train_step._sample_rows(torch.from_numpy(logits), tkeys).numpy(),
                                  want)
    k = jax.random.PRNGKey(4)
    np.testing.assert_array_equal(
        prng.categorical(prng.prng_key(4), torch.from_numpy(logits)).numpy(),
        np.asarray(jax.random.categorical(k, jnp.asarray(logits))))


# ---------------------------------------------------------------------------
# draft configs
# ---------------------------------------------------------------------------


def test_draft_modes_match_jax():
    for top_k in (1, 2):
        for mode in ("off", "topk1", "shared_only"):
            assert routing.effective_top_k(top_k, mode) == jrouting.effective_top_k(top_k, mode)
    dense = ModelConfig("sp", "dense", 2, 32, 4, 2, 64, 64, dtype="float32", remat="none")
    jdense = JModelConfig("sp", "dense", 2, 32, 4, 2, 64, 64, dtype="float32", remat="none")
    for shared in (0, 1):
        jcfg, cfg = _cfgs(shared=shared)
        for mode in ("auto", "off", "topk1", "shared_only"):
            assert moe.resolve_draft_mode(cfg, mode) == jmoe.resolve_draft_mode(jcfg, mode)
            assert moe.draft_config(cfg, mode).moe.draft_mode == \
                jmoe.draft_config(jcfg, mode).moe.draft_mode
        assert cfg.moe.draft_mode == "off"  # the config passed in is untouched
    assert moe.resolve_draft_mode(dense) == jmoe.resolve_draft_mode(jdense) == "off"
    assert moe.draft_config(dense) is dense


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["greedy_shared_only", "sampled_topk1_capacity"])
def test_spec_equals_serial_with_reconfiguration(toys, case):
    """spec_k = 3 emits the serial stream token for token, with
    reconfiguration on: the shared_only draft greedy on dropless dispatch,
    the topk1 draft sampled on capacity dispatch."""
    sample = case.startswith("sampled")
    shared = 0 if sample else 1
    _, cfg = _cfgs("capacity" if sample else "dropless", shared)
    params = toys[shared][1]
    assert moe.resolve_draft_mode(cfg) == ("topk1" if sample else "shared_only")
    prompts = _prompts(9)
    base, rep_b, _ = _serve(params, cfg, prompts, spec_k=0, sample=sample, sample_seed=7,
                            reconfig=True)
    spec, rep_s, eng = _serve(params, cfg, prompts, spec_k=3, sample=sample, sample_seed=7,
                              reconfig=True)
    assert spec == base
    assert rep_s.spec_drafted > 0 and rep_s.spec_accepted > 0
    assert rep_s.reconfig_count > 0 and rep_b.reconfig_count > 0
    assert eng.batcher.spec_rounds > 0


def test_spec_eos_at_every_span_position(toys):
    """EOS at each position 0..k of the first span (k = 4): the speculative
    engine stops where serial decode stops (at the first EOS; the stream's
    first five tokens are distinct) and drops the verified tail."""
    _, cfg = _cfgs()
    params = toys[1][1]
    prompts = _prompts(31, n=1)
    ref, _, _ = _serve(params, cfg, prompts, spec_k=0, max_new=10)
    stream = ref[100]
    assert len(set(stream[:5])) == 5, stream
    for j in range(5):
        spec, rep, _ = _serve(params, cfg, prompts, spec_k=4, max_new=10, eos=stream[j])
        assert spec[100] == stream[: j + 1], f"eos at span position {j}"
        assert rep.completed == 1


def test_spec_truncation_across_pages(toys):
    """A draft the verifier mostly rejects, with pages of 4 < k + 1 = 5:
    truncation fires and returns whole pages, tokens unchanged."""
    _, cfg = _cfgs()
    params = toys[1][1]
    prompts = _prompts(17)
    base, _, _ = _serve(params, cfg, prompts, spec_k=0, page_size=4)
    spec, rep, _ = _serve(params, cfg, prompts, spec_k=4, page_size=4)
    assert spec == base
    assert rep.draft_truncations > 0 and rep.pages_reclaimed > 0


def test_spec_sampled_seed_discipline(toys):
    """The same seed draws the same stream, speculative or serial; another
    seed draws another stream."""
    _, cfg = _cfgs(shared=0)
    params = toys[0][1]
    prompts = _prompts(21, n=2)
    a, _, _ = _serve(params, cfg, prompts, spec_k=4, sample=True, sample_seed=5)
    b, _, _ = _serve(params, cfg, prompts, spec_k=0, sample=True, sample_seed=5)
    c, _, _ = _serve(params, cfg, prompts, spec_k=4, sample=True, sample_seed=6)
    assert a == b and a != c


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sample", [False, True])
def test_spec_engine_matches_jax(toys, sample):
    """The same speculative run in both engines: equal tokens, equal
    speculative telemetry and a2a bytes (greedy: the shared_only draft with
    reconfiguration on; sampled: the topk1 draft)."""
    shared = 0 if sample else 1
    jcfg, cfg = _cfgs(shared=shared)
    jparams, params = toys[shared]
    prompts = _prompts(5)
    want, jrep, jeng = _jserve(jparams, jcfg, prompts, spec_k=3, sample=sample, sample_seed=2,
                               reconfig=not sample)
    got, rep, eng = _serve(params, cfg, prompts, spec_k=3, sample=sample, sample_seed=2,
                           reconfig=not sample)
    assert got == want
    for f in ("spec_drafted", "spec_accepted", "spec_acceptance", "draft_truncations",
              "pages_reclaimed", "reconfig_count", "a2a_bytes"):
        assert getattr(rep, f) == getattr(jrep, f), f
    np.testing.assert_array_equal(rep.gate_load_total, jrep.gate_load_total)


def test_sampled_generate_matches_jax(toys):
    """``generate(sample=True)``: keys ``fold(fold(base, row), i + 1)``;
    the prefill's token is an argmax, as in the reference."""
    jcfg, cfg = _cfgs(shared=0)
    jparams, params = toys[0]
    prompts = np.stack(_prompts(8, n=3))
    want = np.asarray(jgenerate(jparams, jcfg, JPLAN, jnp.asarray(prompts), max_new_tokens=6,
                                sample=True, seed=4))
    got = generate(params, cfg, PLAN, prompts, max_new_tokens=6, sample=True, seed=4)
    np.testing.assert_array_equal(got.numpy(), want)
    greedy = generate(params, cfg, PLAN, prompts, max_new_tokens=6)
    assert torch.equal(got[:, 0], greedy[:, 0]) and not torch.equal(got, greedy)
