"""The port's ServeEngine (repro_torch.serve.engine): against the JAX
package's ServeEngine on the same weights and requests, and against itself
— tokens bit-identical with reconfiguration on and off, paged and dense KV
bit-identical on the CPU (both read through the same full-softmax view),
whole and chunked prefill token-equal — and the device rule of its entry
points.  Reduced grok-1-314b (f32, 2 layers), greedy decoding."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models.transformer import init_model as jinit_model
from repro.parallel.sharding import make_plan as jmake_plan
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_reduced
from repro_torch.interop import params_from_numpy
from repro_torch.models.transformer import init_model
from repro_torch.parallel.sharding import make_plan
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.serve.workload import WorkloadGenerator

PLAN = make_plan(None)
SCFG = dict(slots=2, max_len=40, reconfig_min_gain=0.0, num_devices=4)


def _requests(n, seed=3, vocab=256):
    gen = WorkloadGenerator("chat", seed=seed, vocab_size=vocab)
    reqs = [
        dataclasses.replace(r, prompt_len=min(r.prompt_len, 20),
                            max_new_tokens=min(r.max_new_tokens, 6))
        for r in gen.generate(n)
    ]
    return gen, reqs


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _serve(params, cfg, reqs, gen, **kw):
    eng = ServeEngine(_clone(params), cfg, PLAN, ServeConfig(**{**SCFG, **kw}), device="cpu")
    rep = eng.run(reqs, gen)
    return eng, rep, {r.rid: r.out for r in eng.batcher.finished}


@pytest.fixture(scope="module")
def port_model():
    cfg = get_reduced("grok-1-314b")
    return cfg, init_model(0, cfg, PLAN, device="cpu")


def test_port_engine_matches_jax_engine():
    jcfg = jget_reduced("grok-1-314b")
    jplan = jmake_plan(None)
    jparams = jax.jit(lambda k: jinit_model(k, jcfg, jplan)[0])(jax.random.PRNGKey(0))
    gen, reqs = _requests(4)
    jeng = JServeEngine(
        jax.tree.map(lambda a: a, jparams), jcfg, jplan,
        JServeConfig(**SCFG, reconfig_every=3),
    )
    jrep = jeng.run(reqs, gen)
    cfg = get_reduced("grok-1-314b")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg)
    eng, rep, toks = _serve(params, cfg, reqs, gen, reconfig_every=3)
    assert rep.completed == jrep.completed == len(reqs)
    assert toks == {r.rid: r.out for r in jeng.batcher.finished}
    assert rep.reconfig_count == jrep.reconfig_count > 0
    np.testing.assert_array_equal(eng.controlplane.perm_stack(), jeng.controlplane.perm_stack())
    assert rep.a2a_bytes == jrep.a2a_bytes
    np.testing.assert_array_equal(rep.gate_load_total, jrep.gate_load_total)


def test_port_reconfiguration_keeps_tokens_bit_identical(port_model):
    cfg, params = port_model
    gen, reqs = _requests(5, seed=4)
    eng_on, rep_on, on = _serve(params, cfg, reqs, gen, reconfig_every=2)
    _, rep_off, off = _serve(params, cfg, reqs, gen, reconfig_every=0)
    assert rep_on.completed == rep_off.completed == len(reqs)
    assert rep_on.reconfig_count > 0
    assert (eng_on.controlplane.perm_stack() != np.arange(8)).any()
    assert on == off


def test_port_paged_and_dense_kv_bit_identical_on_cpu(port_model):
    cfg, params = port_model
    gen, reqs = _requests(5, seed=5)
    eng_p, _, paged = _serve(params, cfg, reqs, gen, reconfig_every=3)
    eng_d, _, dense = _serve(params, cfg, reqs, gen, reconfig_every=3, paged=False)
    assert eng_p.batcher.paged and not eng_d.batcher.paged
    assert paged == dense


@pytest.mark.parametrize("paged", [True, False])
def test_port_whole_and_chunked_prefill_token_equal(port_model, paged):
    cfg, params = port_model
    gen, reqs = _requests(4, seed=6)
    _, _, whole = _serve(params, cfg, reqs, gen, paged=paged)
    _, rep, chunked = _serve(params, cfg, reqs, gen, paged=paged, prefill_chunk=5)
    assert rep.completed == len(reqs)
    assert whole == chunked


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = get_reduced("grok-1-314b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_model(0, cfg, PLAN)
    params = init_model(0, cfg, PLAN, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(params, cfg, PLAN, ServeConfig(**SCFG))


def test_slices_not_ported_yet_raise(port_model, tmp_path):
    cfg, params = port_model
    # Sampled and speculative decoding are ported (tests/test_torch_spec.py);
    # speculative decoding needs the paged cache, as in the reference.
    eng = ServeEngine(params, cfg, PLAN, ServeConfig(**SCFG, spec_k=2, sample=True), device="cpu")
    assert eng.batcher.draft_mode == "topk1" and eng.batcher.sample
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(params, cfg, PLAN, ServeConfig(**SCFG, spec_k=2, paged=False), device="cpu")
    # An engine without a control plane saves and restores (no placement
    # to carry).
    eng = ServeEngine(_clone(params), cfg, PLAN, ServeConfig(**SCFG), device="cpu")
    assert eng.restore_checkpoint(str(tmp_path), eng.save_checkpoint(str(tmp_path))) == 0
    # The mixnet backend came with the training slice: prefill runs it,
    # decode the dense path, as in the reference.  Only its multi-device
    # pieces still raise.
    mix = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, backend="mixnet"))
    rep = ServeEngine(params, mix, PLAN, ServeConfig(**SCFG), device="cpu").run(*_requests(1)[::-1])
    assert rep.completed == 1
    chunked = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, backend="mixnet", overlap_chunks=2))
    with pytest.raises(NotImplementedError, match="multi-device slice"):
        ServeEngine(params, chunked, PLAN, ServeConfig(**SCFG), device="cpu").run(
            *_requests(1)[::-1])


def test_checkpoint_roundtrip_mid_reconfig_bit_identical(tmp_path):
    """tests/test_serve.py:253-288 on the port: save mid-reconfiguration,
    restore into a FRESH engine: the restored perm stack composes with the
    restored (permuted) weights and KV pages, so the next tokens are
    bit-identical to the original engine's; an engine without a control
    plane refuses the placement."""
    cfg = ModelConfig(
        "srv", "moe", 2, 32, 4, 2, 0, 64, dtype="float32", remat="none",
        moe=MoEConfig(num_experts=8, top_k=2, d_ff=32, capacity_factor=8.0, backend="mixnet",
                      a2a_group=2, dispatch="dropless", decode_backend="dense"),
    )
    params = init_model(0, cfg, PLAN, device="cpu")

    def small(gen, n):
        return [dataclasses.replace(r, prompt_len=min(r.prompt_len, 20),
                                    max_new_tokens=min(r.max_new_tokens, 6))
                for r in gen.generate(n)]

    def engine(reconfig_every):
        scfg = ServeConfig(slots=2, max_len=40, reconfig_every=reconfig_every,
                           reconfig_min_gain=0.0, num_devices=4)
        return ServeEngine(_clone(params), cfg, PLAN, scfg, device="cpu")

    gen = WorkloadGenerator("chat", seed=9, vocab_size=cfg.vocab_size)
    eng = engine(2)
    eng.run(small(gen, 3), gen)
    assert eng.controlplane.reconfig_count > 0
    stack = eng.controlplane.perm_stack()
    assert (stack != np.tile(np.arange(8, dtype=np.int32), (2, 1))).any()
    step = eng.save_checkpoint(str(tmp_path))
    fresh = engine(10**9)
    fresh.restore_checkpoint(str(tmp_path), step)
    np.testing.assert_array_equal(fresh.batcher.expert_perm, stack)
    probe = small(WorkloadGenerator("chat", seed=11, vocab_size=cfg.vocab_size), 2)
    gen11 = WorkloadGenerator("chat", seed=11, vocab_size=cfg.vocab_size)
    eng.scfg.reconfig_every = 10**9
    eng.run(probe, gen11)
    fresh.run(probe, gen11)
    a = {r.rid: r.out for r in eng.batcher.finished if r.rid in {p.rid for p in probe}}
    b = {r.rid: r.out for r in fresh.batcher.finished}
    assert a == b and len(a) == 2
    with pytest.raises(RuntimeError):
        engine(0).restore_checkpoint(str(tmp_path), step)
