"""The port's model path (repro_torch.models) against the JAX package on the
same weights: routing, attention in prefill / dense decode / paged decode,
the MoE layer under a non-identity expert permutation, and the whole model
in prefill and decode.  Reduced grok-1-314b (f32, 2 layers, d_model 64),
weights from the JAX initializer handed over through
``repro_torch.interop.params_from_numpy``; inputs from seeded numpy.

Tolerance: ``atol=rtol=1e-5`` on f32 results (the same math summed in
another order by XLA and by PyTorch's CPU kernels); integer outputs (top-k
ids, slot destinations, bucket ranks) exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import layers as jL
from repro.models import moe as jmoe
from repro.models import routing as jrouting
from repro.models import transformer as jtfm
from repro.parallel.sharding import make_plan as jmake_plan
from repro_torch.configs import get_reduced
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import routing
from repro_torch.models import transformer as tfm
from repro_torch.parallel.sharding import make_plan

TOL = dict(atol=1e-5, rtol=1e-5)
JPLAN = jmake_plan(None)
PLAN = make_plan(None)


def jitted(fn, **static):
    """The JAX side under one jit (an eager first call compiles every
    primitive on its own, which costs far more on the CPU)."""
    return jax.jit(functools.partial(fn, **static))


def _jinit(seed, jcfg):
    return jax.jit(lambda k: jtfm.init_model(k, jcfg, JPLAN)[0])(jax.random.PRNGKey(seed))


@pytest.fixture(scope="module")
def model():
    jcfg = jget_reduced("grok-1-314b")
    cfg = get_reduced("grok-1-314b")
    jparams = _jinit(0, jcfg)
    np_tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, params_from_numpy(np_tree, cfg)


def _close(got, want, **tol):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), **(tol or TOL),
    )


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def test_params_convert_name_for_name(model):
    jcfg, cfg, jparams, params = model
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(jflat) > 0
    for path, leaf in jflat:
        node = params
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    # the port's own initializer builds the same tree: names, shapes, dtypes
    own = tfm.init_model(0, cfg, PLAN, device="cpu")
    assert len(jax.tree.leaves(own)) == len(jflat)
    for path, leaf in jflat:
        node = own
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape and str(node.dtype).endswith(str(leaf.dtype))


def test_bf16_round_trip_is_bit_exact(model):
    _, _, jparams, _ = model
    np_tree = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a if path[-1].key == "router" else a.astype(jnp.bfloat16)),
        jparams,
    )
    params = params_from_numpy(np_tree, get_reduced("grok-1-314b", dtype="bfloat16"))
    wq = np_tree["blocks"]["0_global"]["attn"]["wq"]
    got = params["blocks"]["0_global"]["attn"]["wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), wq.view(np.int16))
    assert params["blocks"]["0_global"]["moe"]["router"].dtype == torch.float32
    table = tensor_from_numpy(np.asarray([[3, -1]], np.int32))
    assert table.dtype == torch.int32 and table.tolist() == [[3, -1]]


def test_compute_routing_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((48, 8)).astype(np.float32)
    logits[3] = 1.0  # a tied row
    perm = rng.permutation(8).astype(np.int32)
    for r in (1, 2):
        ev = 8 * r
        p = rng.permutation(ev).astype(np.int32) if r == 2 else perm
        got = routing.compute_routing(torch.from_numpy(logits), top_k=2, num_virtual=ev,
                                      replication=r, expert_perm=torch.from_numpy(p))
        want = jitted(jrouting.compute_routing, top_k=2, num_virtual=ev, replication=r)(
            jnp.asarray(logits), expert_perm=jnp.asarray(p)
        )
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
        np.testing.assert_array_equal(got.vdest.numpy(), np.asarray(want.vdest))
        _close(got.weights, want.weights)
        _close(got.wfull, want.wfull)
        rank, counts = routing.bucket_ranks(got.vdest.reshape(-1), ev)
        jrank, jcounts = jitted(jrouting.bucket_ranks, num_buckets=ev)(want.vdest.reshape(-1))
        np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        shape = (4, 12, 2 * r)  # the einsum backend's [groups, tokens, choices]
        keep = rank.reshape(shape) < 10  # a capacity that drops some choices
        masks = routing.dense_dispatch_masks(
            got.vdest.reshape(shape), rank.reshape(shape), keep, got.wfull.reshape(shape), ev, 10
        )
        jmasks = jitted(jrouting.dense_dispatch_masks, num_slots=ev, cap=10)(
            want.vdest.reshape(shape), jrank.reshape(shape), jnp.asarray(keep.numpy()),
            want.wfull.reshape(shape),
        )
        for m, jm in zip(masks, jmasks):
            _close(m, jm)
    valid = rng.random(96) > 0.3
    dest = rng.integers(0, 8, 96).astype(np.int32)
    rank, counts = routing.bucket_ranks(torch.from_numpy(dest), 8, valid=torch.from_numpy(valid))
    jrank, jcounts = jitted(jrouting.bucket_ranks, num_buckets=8)(
        jnp.asarray(dest), valid=jnp.asarray(valid)
    )
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    load = routing.expert_load(torch.from_numpy(dest[:48].reshape(24, 2)), 8,
                               weights=torch.from_numpy(valid[:24].astype(np.float32)))
    _close(load, jitted(jrouting.expert_load, num_experts=8)(
        jnp.asarray(dest[:48].reshape(24, 2)), weights=jnp.asarray(valid[:24].astype(np.float32))
    ))


def _attn_inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)


def test_attention_prefill_matches_jax(model):
    jcfg, cfg, jparams, params = model
    x = _attn_inputs(cfg, 2, 13, 1)
    jp = _layer0(jparams["blocks"]["0_global"]["attn"])
    p = tfm._layer(params["blocks"]["0_global"]["attn"], 0)
    y, cache = L.attention_apply(p, torch.from_numpy(x), cfg, mode="prefill")
    jy, jcache = jitted(jL.attention_apply, cfg=jcfg, mode="prefill")(jp, jnp.asarray(x))
    _close(y, jy)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


def test_attention_dense_decode_matches_jax(model):
    jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(2)
    b, c, smax = 3, 2, 24
    x = _attn_inputs(cfg, b, c, 3)
    shape = (b, smax, cfg.num_kv_heads, cfg.resolved_head_dim)
    ck = rng.standard_normal(shape).astype(np.float32)
    cv = rng.standard_normal(shape).astype(np.float32)
    t = np.asarray([5, 11, 22], np.int32)  # row 2 wraps the ring buffer
    wm = np.asarray([True, False, True])
    jp = _layer0(jparams["blocks"]["0_global"]["attn"])
    p = tfm._layer(params["blocks"]["0_global"]["attn"], 0)
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    y, new = L.attention_apply(p, torch.from_numpy(x), cfg, mode="decode", cache=cache,
                               t=torch.from_numpy(t), write_mask=torch.from_numpy(wm))
    jy, jnew = jitted(jL.attention_apply, cfg=jcfg, mode="decode")(
        jp, jnp.asarray(x), cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
        t=jnp.asarray(t), write_mask=jnp.asarray(wm),
    )
    _close(y, jy)
    _close(new["k"], jnew["k"])
    _close(new["v"], jnew["v"])
    assert new["k"] is cache["k"]  # written in place


def test_attention_paged_decode_matches_jax(model):
    jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(4)
    b, c, page, n_pages, maxp = 3, 3, 4, 20, 6
    x = _attn_inputs(cfg, b, c, 5)
    shape = (n_pages, page, cfg.num_kv_heads, cfg.resolved_head_dim)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    t = np.asarray([2, 9, 17], np.int32)
    perm = rng.permutation(n_pages)[: b * maxp].reshape(b, maxp)
    used = -(-(t + c) // page)
    table = np.where(np.arange(maxp)[None, :] < used[:, None], perm, -1).astype(np.int32)
    wm = np.asarray([True, True, False])
    jp = _layer0(jparams["blocks"]["0_global"]["attn"])
    p = tfm._layer(params["blocks"]["0_global"]["attn"], 0)
    y, new = L.attention_apply(
        p, torch.from_numpy(x), cfg, mode="decode",
        cache={"k": torch.from_numpy(kp.copy()), "v": torch.from_numpy(vp.copy())},
        t=torch.from_numpy(t), write_mask=torch.from_numpy(wm),
        page_table=torch.from_numpy(table),
    )
    jy, jnew = jitted(jL.attention_apply, cfg=jcfg, mode="decode")(
        jp, jnp.asarray(x),
        cache={"k": jnp.asarray(kp), "v": jnp.asarray(vp)}, t=jnp.asarray(t),
        write_mask=jnp.asarray(wm), page_table=jnp.asarray(table),
    )
    _close(y, jy)
    _close(new["k"], jnew["k"])
    _close(new["v"], jnew["v"])


@pytest.mark.parametrize("backend,s", [("einsum", 7), ("einsum", 1), ("dense_decode", 1)])
def test_moe_apply_matches_jax_under_expert_perm(model, backend, s):
    jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, s, cfg.d_model)).astype(np.float32)
    perm = np.asarray([3, 0, 6, 1, 7, 2, 5, 4], np.int32)
    gw = np.asarray([[1.0] * s, [0.0] * s, [1.0] * s], np.float32)
    jp = _layer0(jparams["blocks"]["0_global"]["moe"])
    p = tfm._layer(params["blocks"]["0_global"]["moe"], 0)
    out, st = moe_mod.moe_apply(p, torch.from_numpy(x), cfg, PLAN, backend=backend,
                                expert_perm=torch.from_numpy(perm),
                                gate_weights=torch.from_numpy(gw), mode="decode")
    jout, jst = jitted(jmoe.moe_apply, cfg=jcfg, plan=JPLAN, backend=backend, mode="decode")(
        jp, jnp.asarray(x), expert_perm=jnp.asarray(perm), gate_weights=jnp.asarray(gw),
    )
    _close(out, jout)
    _close(st.expert_load, jst.expert_load)
    _close(st.balance_loss, jst.balance_loss)
    _close(st.z_loss, jst.z_loss)


def test_model_apply_prefill_and_decode_match_jax(model):
    jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    perm = np.stack([rng.permutation(8), rng.permutation(8)]).astype(np.int32)
    feats, aux, caches = tfm.model_apply(params, {"tokens": torch.from_numpy(tokens)}, cfg,
                                         PLAN, mode="prefill", expert_perm=torch.from_numpy(perm))
    jfeats, jaux, jcaches = jitted(jtfm.model_apply, cfg=jcfg, plan=JPLAN, mode="prefill")(
        jparams, {"tokens": jnp.asarray(tokens)}, expert_perm=jnp.asarray(perm)
    )
    _close(feats, jfeats)
    _close(aux.moe_stats, jaux.moe_stats)
    _close(tfm.logits_from_features(params, feats, cfg),
           jtfm.logits_from_features(jparams, jfeats, jcfg), atol=1e-4, rtol=1e-5)
    for name in caches:
        _close(caches[name]["k"], jcaches[name]["k"])
    # one decode step against the (padded) prefill caches
    caches = tfm.pad_caches(caches, 16)
    jcaches = jtfm.pad_caches(jcaches, 16)
    nxt = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    t = np.asarray([11, 11], np.int32)
    gw = np.ones((2, 1), np.float32)
    feats, aux, caches = tfm.model_apply(
        params, {"tokens": torch.from_numpy(nxt)}, cfg, PLAN, mode="decode", caches=caches,
        t=torch.from_numpy(t), expert_perm=torch.from_numpy(perm), gate_weights=torch.from_numpy(gw),
    )
    jfeats, jaux, jcaches = jitted(jtfm.model_apply, cfg=jcfg, plan=JPLAN, mode="decode")(
        jparams, {"tokens": jnp.asarray(nxt)}, caches=jcaches,
        t=jnp.asarray(t), expert_perm=jnp.asarray(perm), gate_weights=jnp.asarray(gw),
    )
    _close(feats, jfeats)
    _close(aux.moe_stats, jaux.moe_stats)
    for name in caches:
        _close(caches[name]["v"], jcaches[name]["v"])
