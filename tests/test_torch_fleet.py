"""The port's serving fleet (repro_torch.serve.fleet) on the reference's toy
MoE config (tests/test_fleet.py: 2 layers, d_model 32, 8 experts top-2,
mixnet with dense decode, f32; weights from the JAX package).

Against the JAX package's FleetEngine: outputs, the decision journal and
the report's counts exactly equal, and ``locality_score`` /
``fleet_requests`` exactly equal.  Against itself: tokens bit-identical to
unsteered single-replica serving across steering policies x fleet sizes,
replica failure, drain/restore and replicas of different slot counts; a
reconfiguration on one replica leaves every other replica's expert weights
(and the tree they were cloned from) as they were; a prefix-cache hit gives
a request a miss's logits and tokens bit for bit, also through a fleet on
the shared-prefix mix; the drained replica's checkpoint round trip; and the
entry points ``python -m repro_torch.fleet`` and ``repro_torch.measure_run``.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from _torch_prefix import admission_logits, prefix_hit_and_miss

from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import MoEConfig as JMoEConfig
from repro.models.transformer import init_model as jinit_model
from repro.parallel.sharding import make_plan as jmake_plan
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.fleet import FleetConfig as JFleetConfig
from repro.serve.fleet import FleetEngine as JFleetEngine
from repro.serve.fleet import fleet_requests as jfleet_requests
from repro.serve.fleet import locality_score as jlocality_score
from repro.serve.workload import WorkloadGenerator as JWorkloadGenerator
from repro.serve.workload import clamp_requests as jclamp_requests
from repro_torch import fleet as fleet_main
from repro_torch import measure_run
from repro_torch.core.controlplane import EXPERT_LEAVES, LayerPlan
from repro_torch.interop import params_from_numpy
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.obs import trace
from repro_torch.parallel.sharding import make_plan
from repro_torch.serve.batching import Request
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.serve.fleet import (
    FleetConfig,
    FleetEngine,
    fleet_requests,
    locality_score,
    replica_params,
)
from repro_torch.serve.workload import WorkloadGenerator, clamp_requests, slo_for

PLAN = make_plan(None)


def moe_cfg(mc=ModelConfig, moe=MoEConfig):
    return mc(
        "flt", "moe", 2, 32, 4, 2, 0, 64, dtype="float32", remat="none",
        moe=moe(num_experts=8, top_k=2, d_ff=32, capacity_factor=8.0,
                backend="mixnet", a2a_group=2, dispatch="dropless",
                decode_backend="dense"),
    )


def requests_of(gen_cls, clamp, fleet_req, n=8, mix="chat", seed=3, **clamp_kw):
    gen = gen_cls(mix, seed=seed, vocab_size=64)
    raw = clamp(gen.generate(n), **{"prompt_max": 16, "max_new": 5, **clamp_kw})
    return fleet_req(raw, gen)


@pytest.fixture(scope="module")
def setup():
    """The reference's weights (JAX init, jitted once) in both packages, and
    the chat requests as each package materializes them."""
    jcfg = moe_cfg(JModelConfig, JMoEConfig)
    jplan = jmake_plan(None)
    jparams = jax.jit(lambda k: jinit_model(k, jcfg, jplan)[0])(jax.random.PRNGKey(0))
    cfg = moe_cfg()
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg)
    return dict(
        jcfg=jcfg, jplan=jplan, jparams=jparams, cfg=cfg, params=params,
        jfreqs=requests_of(JWorkloadGenerator, jclamp_requests, jfleet_requests),
        freqs=requests_of(WorkloadGenerator, clamp_requests, fleet_requests),
    )


def scfg(**kw):
    return {**dict(slots=2, max_len=32, num_devices=4, external_control=True, num_regions=4,
                   reconfig_min_gain=0.0), **kw}


def make_replica(params, cfg, *, slots=2, **kw):
    return ServeEngine(replica_params(params), cfg, PLAN,
                       ServeConfig(**scfg(**{**kw, "slots": slots})), device="cpu")


def make_fleet(params, cfg, slots, policy, **fkw):
    fkw.setdefault("reconfig_every", 3)
    return FleetEngine([make_replica(params, cfg, slots=s) for s in slots],
                       FleetConfig(policy=policy, **fkw))


def single_replica(params, cfg, freqs, **kw):
    """Unsteered single-replica generation: the bit-exactness reference."""
    eng = make_replica(params, cfg, **kw)
    for fr in sorted(freqs, key=lambda f: (f.arrival_s, f.rid)):
        eng.submit(Request(rid=fr.rid, prompt=fr.prompt, max_new_tokens=fr.max_new_tokens,
                           eos_id=fr.eos_id, region=fr.region))
    while eng.batcher.busy:
        eng.step()
    return eng, {r.rid: list(r.out) for r in eng.batcher.finished if r.error is None}


@pytest.fixture(scope="module")
def reference(setup):
    _, ref = single_replica(setup["params"], setup["cfg"], setup["freqs"])
    assert len(ref) == len(setup["freqs"])
    return ref


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------


def test_fleet_matches_jax_fleet(setup, reference):
    """Size 2, locality, drain replica 1 at tick 2 and restore it at 8,
    reconfiguring every 3 ticks: the same outputs, decision journal (kind,
    tick, replica, reason, re-steered counts, reconfigured layers and gains)
    and report counts as the JAX fleet."""
    s = setup
    jengines = [JServeEngine(jax.tree.map(lambda a: a, s["jparams"]), s["jcfg"], s["jplan"],
                             JServeConfig(**scfg())) for _ in range(2)]
    # The replicas' jitted steps are pure functions of their arguments: share
    # one compile cache between them.
    for name in ("_step", "_prefill_fn", "_chunk_fn"):
        setattr(jengines[1].batcher, name, getattr(jengines[0].batcher, name))
    jfleet = JFleetEngine(jengines, JFleetConfig(policy="locality", reconfig_every=3))
    jrep = jfleet.run(s["jfreqs"], drain_at={1: 2}, restore_at={1: 8})
    fleet = make_fleet(s["params"], s["cfg"], [2, 2], "locality")
    rep = fleet.run(s["freqs"], drain_at={1: 2}, restore_at={1: 8})
    assert rep.outputs == jrep.outputs == reference
    assert fleet.decision_log == jfleet.decision_log
    assert {d["kind"] for d in fleet.decision_log} >= {"steer", "drain", "restore", "reconfig"}
    for f in ("requests", "completed", "ticks", "tokens_out", "policy", "steer_reasons",
              "reconfig_events", "ttft_ticks_p50", "ttft_ticks_p99", "slo_attainment"):
        assert getattr(rep, f) == getattr(jrep, f), f
    assert rep.reconfig_events > 0
    assert fleet.assignment == jfleet.assignment


def test_locality_score_and_fleet_requests_match_jax(setup):
    rng = np.random.default_rng(0)
    for _ in range(20):
        pred = rng.random((2, 8))
        res = None if rng.random() < 0.2 else rng.random((2, 8))
        kw = dict(placement_fit=float(rng.random()), backlog=int(rng.integers(0, 5)),
                  slots=int(rng.integers(1, 4)), gamma=0.5, beta=0.25)
        assert locality_score(pred, res, **kw) == jlocality_score(pred, res, **kw)
        assert locality_score(pred[0], None if res is None else res[0]) == jlocality_score(
            pred[0], None if res is None else res[0])
    for mine, theirs in zip(setup["freqs"], setup["jfreqs"], strict=True):
        np.testing.assert_array_equal(mine.prompt, theirs.prompt)
        assert mine.prompt.dtype == theirs.prompt.dtype
        for f in ("rid", "max_new_tokens", "arrival_s", "region", "eos_id"):
            assert getattr(mine, f) == getattr(theirs, f), f
        assert dataclasses.asdict(mine.slo) == dataclasses.asdict(theirs.slo)


def test_locality_forecast_with_copilot_matches_jax(setup):
    """The locality policy's forecast of a region's per-layer mix: gate
    statistics merged across replicas, refined by a fitted COPILOT's
    ``rollout`` — the JAX fleet's numbers exactly, for a warm and a cold
    region (same statistics and transition matrices injected on both
    sides)."""
    rng = np.random.default_rng(1)
    trans = rng.random((1, 8, 8))
    trans /= trans.sum(axis=1, keepdims=True)
    loads = [rng.random((2, 8)) * 10 for _ in range(6)]
    jeng = JServeEngine(jax.tree.map(lambda a: a, setup["jparams"]), setup["jcfg"],
                        setup["jplan"], JServeConfig(**scfg(use_copilot=True)))
    eng = make_replica(setup["params"], setup["cfg"], use_copilot=True)
    for e in (jeng, eng):
        for load in loads:
            e.controlplane.observe_regions({0: 0.75, 2: 0.25}, load)
        e.controlplane.copilot.state.transitions = trans.copy()
        e.controlplane.copilot.state.fitted_steps = 1
    fleet, jfleet = FleetEngine([eng]), JFleetEngine([jeng])
    for region in (0, 1, 2, None):
        mine, theirs = fleet._predicted_mixes(region), jfleet._predicted_mixes(region)
        assert (mine is None) == (theirs is None) == (region in (1, None))
        if mine is not None:
            np.testing.assert_array_equal(mine, theirs)
    x = rng.random(8)
    np.testing.assert_array_equal(eng.controlplane.copilot.rollout(x),
                                  jeng.controlplane.copilot.rollout(x))


# ---------------------------------------------------------------------------
# the port against itself: a request's tokens never depend on the replica
# ---------------------------------------------------------------------------

CASES = [(p, n, None) for p in ("locality", "least_loaded", "round_robin") for n in (1, 2, 4)]
CASES += [("locality", 3, "fail"), ("locality", 2, "drain")]


@pytest.mark.parametrize("policy,size,event", CASES)
def test_fleet_bit_exact_across_policies_sizes_and_events(setup, reference, policy, size,
                                                          event):
    """Steered, re-steered (drain) and restarted (a replica failing
    mid-run) requests generate the tokens of unsteered single-replica
    serving, bit for bit."""
    fleet = make_fleet(setup["params"], setup["cfg"], [2] * size, policy)
    kw = {"fail": dict(fail_at={0: 4}), "drain": dict(drain_at={1: 2}, restore_at={1: 8}),
          None: {}}[event]
    rep = fleet.run(setup["freqs"], **kw)
    assert rep.completed == len(setup["freqs"])
    assert rep.outputs == reference
    assert sum(rep.steer_reasons.values()) >= len(setup["freqs"])
    if size > 1:
        assert len(set(fleet.assignment.values())) > 1  # work spread over replicas
    if event == "fail":
        assert not fleet.alive[0]
        fails = [d for d in fleet.decision_log if d["kind"] == "fail"]
        assert fails and fails[0]["replica"] == 0
    if event == "drain":
        kinds = [d["kind"] for d in fleet.decision_log]
        assert "drain" in kinds and "restore" in kinds
        assert all(d["replica"] != 1 for d in fleet.decision_log
                   if d["kind"] == "steer" and 2 <= d["tick"] < 8)


def test_fleet_mixed_slot_counts(setup, reference):
    """Replicas of 1, 2 and 3 slots (kernel 3 and every decode product give
    a row the same bits whatever the batch): tokens unchanged."""
    fleet = make_fleet(setup["params"], setup["cfg"], [1, 2, 3], "locality")
    rep = fleet.run(setup["freqs"])
    assert rep.completed == len(setup["freqs"])
    assert rep.outputs == reference
    assert len(set(fleet.assignment.values())) > 1


def test_fleet_slo_priority_admission(setup):
    """Chat (priority 0) dispatches before batch (priority 2), whichever was
    submitted first."""
    freqs = setup["freqs"]
    batch = dataclasses.replace(freqs[0], rid=900, arrival_s=0.0,
                                slo=slo_for("batch_summarize"))
    chat = dataclasses.replace(freqs[1], rid=901, arrival_s=0.0, slo=slo_for("chat"))
    fleet = make_fleet(setup["params"], setup["cfg"], [2], "least_loaded")
    fleet.submit(batch)
    fleet.submit(chat)
    while fleet.busy:
        fleet.step()
    assert [d["rid"] for d in fleet.decision_log if d["kind"] == "steer"] == [901, 900]
    rep = fleet.report()
    assert rep.completed == 2 and set(rep.slo_attainment) == {"chat", "batch_summarize"}


# ---------------------------------------------------------------------------
# replica weights: a reconfiguration moves one replica's experts only
# ---------------------------------------------------------------------------


def test_reconfiguration_moves_one_replicas_experts_only(setup):
    """The port permutes expert weights in place, so each replica owns its
    expert leaves (``replica_params``) and shares every other leaf; a
    reconfiguration on replica 1 moves replica 1's experts and leaves
    replica 0's and the original tree's bit-identical.  A fleet refuses
    replicas that share an expert leaf."""
    params = setup["params"]
    cfg = setup["cfg"]
    snap = {n: params["blocks"][b]["moe"][n].clone() for b in params["blocks"]
            for n in EXPERT_LEAVES}
    engines = [make_replica(params, cfg) for _ in range(2)]
    for eng in engines:
        assert eng.params["embed"] is params["embed"]
        for b, bp in eng.params["blocks"].items():
            assert bp["moe"]["router"] is params["blocks"][b]["moe"]["router"]
    perm = np.roll(np.arange(8), 3)
    assert engines[1].apply_plans([LayerPlan(layer, True, perm=perm) for layer in range(2)])
    for b in params["blocks"]:
        for n in EXPERT_LEAVES:
            assert torch.equal(params["blocks"][b]["moe"][n], snap[n])
            assert torch.equal(engines[0].params["blocks"][b]["moe"][n], snap[n])
            moved = engines[1].params["blocks"][b]["moe"][n]
            assert not torch.equal(moved, snap[n])
            assert torch.equal(moved[:, perm], snap[n])  # the same experts, moved
    shared = ServeEngine(params, cfg, PLAN, ServeConfig(**scfg()), device="cpu")
    again = ServeEngine(params, cfg, PLAN, ServeConfig(**scfg()), device="cpu")
    with pytest.raises(ValueError, match="share expert weight storage"):
        FleetEngine([shared, again])


# ---------------------------------------------------------------------------
# prefix-cache hits: a hit gives a request a miss's bits
# ---------------------------------------------------------------------------


def test_prefix_hit_equals_miss(setup, monkeypatch):
    """The port's counterpart of tests/test_paged.py:186: prompt B after
    prompt A (same 64-token prefix: a hit on 4 pages) gets the admission
    logits and 10 greedy tokens it gets in a fresh engine, bit for bit."""
    out = prefix_hit_and_miss(setup["params"], setup["cfg"], "cpu",
                              admission_logits(monkeypatch))
    (miss_logits, miss_toks), (hit_logits, hit_toks) = out[False], out[True]
    assert torch.equal(hit_logits, miss_logits)
    assert hit_toks == miss_toks


def test_shared_prefix_mix_through_a_fleet(setup):
    """The agentic_shared mix (shared per-region prefixes) through a size-2
    fleet: whether a request hits depends on where it was steered, yet every
    token equals the single replica's."""
    kw = dict(page_size=4, max_len=48)
    freqs = requests_of(WorkloadGenerator, clamp_requests, fleet_requests, n=8,
                          mix="agentic_shared", seed=9, prompt_max=24, max_new=4)
    ref_eng, ref = single_replica(setup["params"], setup["cfg"], freqs, **kw)
    fleet = FleetEngine([make_replica(setup["params"], setup["cfg"], **kw) for _ in range(2)],
                        FleetConfig(policy="locality", reconfig_every=3))
    rep = fleet.run(freqs)
    assert rep.completed == len(freqs) and rep.outputs == ref
    hits = [r.kv_prefix_hit_pages for r in rep.per_replica]
    assert sum(hits) > 0 and ref_eng.batcher.alloc.prefix_hit_pages > 0
    assert len(set(fleet.assignment.values())) == 2


# ---------------------------------------------------------------------------
# the drained replica's checkpoint (port against port)
# ---------------------------------------------------------------------------


def test_drain_checkpoint_restore_bit_identical(setup, tmp_path):
    """tests/test_fleet.py:164 on the port: drain a paged replica mid-run,
    checkpoint it (KV pools, allocator, placement), restore into a fresh
    engine and re-admit the handed-back work: the union of tokens equals
    one uninterrupted run's, and the warm prefix registry survives."""
    params, cfg = setup["params"], setup["cfg"]
    freqs = requests_of(WorkloadGenerator, clamp_requests, fleet_requests, n=6,
                          mix="agentic_shared", seed=9, prompt_max=20, max_new=4)
    _, ref = single_replica(params, cfg, freqs)
    eng_a = make_replica(params, cfg, paged=True)
    for fr in freqs[:4]:
        eng_a.submit(Request(rid=fr.rid, prompt=fr.prompt, max_new_tokens=fr.max_new_tokens,
                             region=fr.region))
    for _ in range(3):
        if eng_a.batcher.busy:
            eng_a.step()
    handed = eng_a.drain()
    with pytest.raises(RuntimeError):
        eng_a.submit(Request(rid=999, prompt=freqs[0].prompt, max_new_tokens=2))
    while eng_a.batcher.busy:
        eng_a.step()
    step = eng_a.save_checkpoint(str(tmp_path))
    done_a = {r.rid: list(r.out) for r in eng_a.batcher.finished if r.error is None}

    eng_b = make_replica(params, cfg, paged=True)
    eng_b.restore_checkpoint(str(tmp_path), step)
    np.testing.assert_array_equal(eng_b.batcher.alloc.table, eng_a.batcher.alloc.table)
    assert eng_b.batcher.alloc._registry == eng_a.batcher.alloc._registry
    assert len(eng_b.batcher.alloc._registry) > 0
    hits_before = eng_b.batcher.alloc.prefix_hit_pages
    for fr in freqs:
        if fr.rid not in done_a:
            eng_b.submit(Request(rid=fr.rid, prompt=fr.prompt,
                                 max_new_tokens=fr.max_new_tokens, region=fr.region))
    while eng_b.batcher.busy:
        eng_b.step()
    done_b = {r.rid: list(r.out) for r in eng_b.batcher.finished if r.error is None}
    assert set(done_a) | set(done_b) == {fr.rid for fr in freqs}
    assert {**done_a, **done_b} == ref
    assert eng_b.batcher.alloc.prefix_hit_pages > hits_before
    assert len(handed) + len(done_a) >= 4


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def test_fleet_and_measure_run_entry_points_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.fleet --device cpu`` (reduced grok-1, two
    replicas, drain and restore, the parity check, a trace and a metrics
    snapshot), then ``python -m repro_torch.measure_run`` on its trace; both
    through their ``main`` in this process (the tracer is switched off and
    emptied afterwards)."""
    tr, met, out = (str(tmp_path / n) for n in ("trace.json", "metrics.json", "report.json"))
    try:
        res = fleet_main.main(["--device", "cpu", "--requests", "6", "--max-len", "32",
                               "--trace", tr, "--metrics", met])
    finally:
        trace.disable()
        trace.default().clear()
    log = capsys.readouterr().out
    assert "parity: fleet tokens bit-identical to single-replica serving" in log
    assert res["report"].completed == 6 and json.load(open(met))
    kinds = {d["kind"] for d in res["decisions"]}
    assert {"steer", "drain", "restore"} <= kinds
    doc = measure_run.main([tr, "--json", out, "--strict"])
    assert doc == json.load(open(out)) and not doc["schema_failures"]
    assert "schema OK" in capsys.readouterr().out
    assert {"fleet", "replica0", "replica1"} <= set(doc["traffic"])
    assert doc["decisions"]["fleet.steer"] == 6
    assert "fleet.tick" in doc["spans"] and "serve.tick" in doc["spans"]
