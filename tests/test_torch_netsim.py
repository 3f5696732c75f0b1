"""The port's evaluation plane against the JAX package's, on the CPU.

OCS topology (Algorithm 1), the fabrics, the Table 4 cost model, the
fabric-priced CommRuntime ops, the priced overlap phases, the control
plane's OCS mode, the flow-level netsim (training, serving, fleet), the
cached autotuner and the trainer's cache hook, and the
``reconfigure_fabric`` walkthrough.

Both sides are the same host-side numpy arithmetic on the same seeds, so
results are compared with ``==`` / ``np.array_equal``.  The one exception is
COPILOT's fit: the port runs it in numpy float32, the reference in XLA, so
netsim with COPILOT on is compared within ``COPILOT_RTOL`` (and its circuits
exactly).  The paper's claims (``tests/test_netsim.py``,
``tests/test_topology.py``) are also checked through the port alone.
"""

import contextlib
import dataclasses
import functools
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

from repro.configs import paper_models as jpm
from repro.core import autotune as jautotune
from repro.core import commruntime as jcomm
from repro.core import cost as jcost
from repro.core import fabric as jfab
from repro.core import netsim as jns
from repro.core import overlap as joverlap
from repro.core import topology as jtopo
from repro.core.controlplane import ControlPlane as JControlPlane
from repro_torch.configs import paper_models as tpm
from repro_torch.core import autotune as tautotune
from repro_torch.core import commruntime as tcomm
from repro_torch.core import cost as tcost
from repro_torch.core import fabric as tfab
from repro_torch.core import netsim as tns
from repro_torch.core import overlap as toverlap
from repro_torch.core import topology as ttopo
from repro_torch.core.controlplane import ControlPlane as TControlPlane
from repro_torch.obs import metrics

# COPILOT on: numpy float32 against XLA's float32 fit of the same program.
COPILOT_RTOL = 1e-6
FABRICS = ("mixnet", "fat-tree", "oversub-fat-tree", "rail-optimized", "topoopt")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _demand(seed: int, n: int, scale: float = 1e9) -> np.ndarray:
    d = np.random.default_rng(seed).random((n, n)) * scale
    np.fill_diagonal(d, 0.0)
    return d


def _fabric(mod, name: str, **kw):
    return mod.make_fabric(name, mod.FabricConfig(**kw))


# ---------------------------------------------------------------------------
# topology, fabrics, cost: exactly equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("servers,alpha,seed", [(2, 1, 0), (4, 3, 1), (8, 6, 2), (8, 8, 3)])
def test_algorithm1_equals_reference(servers, alpha, seed):
    expert = _demand(seed, servers * 2)
    got = ttopo.reconfigure_ocs(expert, alpha=alpha, num_servers=servers)
    want = jtopo.reconfigure_ocs(expert, alpha=alpha, num_servers=servers)
    assert np.array_equal(got.circuits, want.circuits)
    assert got.nic_map == want.nic_map and got.alpha == want.alpha
    assert np.array_equal(got.demand, want.demand)
    fold = ttopo.calculate_server_demand(expert, 2)
    assert np.array_equal(fold, jtopo.calculate_server_demand(expert, 2))
    for circ in (got.circuits, ttopo.uniform_topology(servers, alpha)):
        assert (ttopo.topology_completion_time(circ, fold, 1.0, 0.25)
                == jtopo.topology_completion_time(circ, fold, 1.0, 0.25))
    assert np.array_equal(ttopo.uniform_topology(servers, alpha),
                          jtopo.uniform_topology(servers, alpha))


@pytest.mark.parametrize("name", FABRICS)
def test_fabric_times_equal_reference(name):
    for gbps in (100, 400):
        t = _fabric(tfab, name, num_servers=16, link_gbps=gbps)
        j = _fabric(jfab, name, num_servers=16, link_gbps=gbps)
        for seed in range(3):
            dem = _demand(seed, 16, 256e6)
            assert t.prepare(dem) == j.prepare(dem)
            assert t.alltoall_time(dem) == j.alltoall_time(dem)
        for nbytes in (1e6, 3.5e9):
            assert t.allreduce_time(nbytes) == j.allreduce_time(nbytes)
            assert t.allreduce_time(nbytes, 4) == j.allreduce_time(nbytes, 4)
            assert t.p2p_time(nbytes) == j.p2p_time(nbytes)


@pytest.mark.parametrize("failure", ["none", "ocs", "nic"])
def test_mixnet_prepare_circuits_equal_reference(failure):
    t = _fabric(tfab, "mixnet", num_servers=8, link_gbps=400)
    j = _fabric(jfab, "mixnet", num_servers=8, link_gbps=400)
    for fab in (t, j):
        if failure == "ocs":
            fab.fail_server_ocs(2)
        elif failure == "nic":
            fab.fail_server_nic(1, failed_nics=4)
    for seed in range(3):
        dem = _demand(seed, 8)
        assert t.prepare(dem, can_hide=seed > 0) == j.prepare(dem, can_hide=seed > 0)
        assert np.array_equal(t._circuits, j._circuits)
        assert t.alltoall_time(dem) == j.alltoall_time(dem)
    if failure == "ocs":
        assert not t._circuits[2].any()
        t.restore_server_ocs(2)
        j.restore_server_ocs(2)
        t.prepare(_demand(9, 8))
        j.prepare(_demand(9, 8))
        assert np.array_equal(t._circuits, j._circuits) and t._circuits[2].any()
    if failure == "nic":
        assert t._circuits[1].sum() <= 2
    assert (t.reconfig_count, t.blocked_seconds) == (j.reconfig_count, j.blocked_seconds)


@pytest.mark.parametrize("gbps", [100, 200, 400, 800])
def test_fabric_cost_equals_reference(gbps):
    for name in FABRICS:
        for servers in (16, 128, 1024):
            assert tcost.fabric_cost(name, servers, gbps) == jcost.fabric_cost(name, servers, gbps)
    assert tcost.PRICES == {k: tcost.ComponentPrices(*dataclasses.astuple(v))
                            for k, v in jcost.PRICES.items()}
    assert tcost.cost_efficiency(2.5, 3e6) == jcost.cost_efficiency(2.5, 3e6)


# ---------------------------------------------------------------------------
# the priced CommRuntime ops and overlap phases: exactly equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lowering", ["hier", "flat", "ring"])
def test_op_costs_equal_reference(lowering):
    servers = 16
    tf = _fabric(tfab, "mixnet", num_servers=servers, link_gbps=400)
    jf = _fabric(jfab, "mixnet", num_servers=servers, link_gbps=400)
    dem = _demand(0, servers, 256e6)
    tf.prepare(dem)
    jf.prepare(dem)
    ts, js = tcomm.CommSpec.from_fabric(tf, 4), jcomm.CommSpec.from_fabric(jf, 4)
    assert (ts.axis, ts.axis_size, ts.group_size, ts.outer_size) == (
        js.axis, js.axis_size, js.group_size, js.outer_size)
    ts, js = tcomm.CommSpec.from_fabric(tf, servers), jcomm.CommSpec.from_fabric(jf, servers)
    ta, ja = tcomm.AllToAll(ts, lowering=lowering), jcomm.AllToAll(js, lowering=lowering)
    assert ta.cost(tf, dem) == ja.cost(jf, dem)
    perm = np.roll(np.arange(servers), 3)
    assert ta.reconfigure(dest_perm=perm).cost(tf, dem) == ja.reconfigure(
        dest_perm=perm).cost(jf, dem)
    assert ta.reconfigure(dest_perm=perm).lowering == lowering
    for stage_t, stage_j in zip(ta.stages(), ja.stages()):
        assert stage_t.link_class == stage_j.link_class
        assert stage_t.bytes_on_link(1e8) == tcomm.LinkBytes(
            *dataclasses.astuple(stage_j.bytes_on_link(1e8)))
    for ratio in (1.0, 0.5):
        args = (tcomm.CommSpec(axis=None, axis_size=8, group_size=8, outer_size=servers),
                jcomm.CommSpec(axis=None, axis_size=8, group_size=8, outer_size=servers))
        assert tcomm.AllReduce(args[0]).cost(tf, 3e9, compress_ratio=ratio) == jcomm.AllReduce(
            args[1]).cost(jf, 3e9, compress_ratio=ratio)
    for tcls, jcls in ((tcomm.AllGather, jcomm.AllGather),
                       (tcomm.ReduceScatter, jcomm.ReduceScatter),
                       (tcomm.Permute, jcomm.Permute)):
        assert tcls(ts).cost(tf, 7e7) == jcls(js).cost(jf, 7e7)
        assert tcls(tcomm.CommSpec()).cost(tf, 7e7) == 0.0
    with pytest.raises(ValueError):
        tcomm.AllToAll(ts, lowering="mesh")


def test_a2a_lowering_is_pricing_only():
    """As the reference's test: ``__call__`` has no lowering branch."""
    import inspect

    assert "lowering" not in inspect.getsource(tcomm.AllToAll.__call__)
    x = torch.arange(12.0).reshape(4, 3)
    for low in ("hier", "flat", "ring"):
        op = tcomm.AllToAll(tcomm.CommSpec(), lowering=low)
        assert torch.equal(op(x, dest_perm=[1, 0, 3, 2]), x[[1, 0, 3, 2]])


@pytest.mark.parametrize("chunks", [1, 2, 3, 8])
def test_priced_phases_equal_reference(chunks):
    rng = np.random.default_rng(chunks)
    for _ in range(4):
        d, e, c, a, pf = rng.random(5)
        assert toverlap.pipelined_phase(d, e, c, chunks, serial_prefix=a) == \
            joverlap.pipelined_phase(d, e, c, chunks, serial_prefix=a)
        assert toverlap.decode_tick_phase(d, e, c, chunks, attn=a, prefill_compute=pf) == \
            joverlap.decode_tick_phase(d, e, c, chunks, attn=a, prefill_compute=pf)


# ---------------------------------------------------------------------------
# the control plane's OCS mode: exactly equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("failure", ["none", "device", "nic"])
def test_ocs_control_plane_equals_reference(failure):
    tf = _fabric(tfab, "mixnet", num_servers=8, link_gbps=400, reconfig_delay_s=0.025)
    jf = _fabric(jfab, "mixnet", num_servers=8, link_gbps=400, reconfig_delay_s=0.025)
    tcp = TControlPlane(2, 8, num_devices=8, fabric=tf, use_copilot=False)
    jcp = JControlPlane(2, 8, num_devices=8, fabric=jf, use_copilot=False)
    if failure == "device":
        assert tcp.fail_device(3) == jcp.fail_device(3) == []
    elif failure == "nic":
        tcp.fail_nic(5, 3)
        jcp.fail_nic(5, 3)
    for step, window in enumerate((np.inf, 0.01, 0.03, 0.0)):
        dem = _demand(step, 8)
        tp, jp = tcp.plan(step % 2, dem, predicted=step == 1), jcp.plan(step % 2, dem,
                                                                         predicted=step == 1)
        assert (tp.layer, tp.reconfigure, tp.predicted, tp.reason) == (
            jp.layer, jp.reconfigure, jp.predicted, jp.reason)
        assert np.array_equal(tp.demand, jp.demand)
        assert tcp.apply(tp, hide_window=window) == jcp.apply(jp, hide_window=window)
        assert np.array_equal(tf._circuits, jf._circuits)
    assert (tcp.reconfig_count, tf.blocked_seconds) == (jcp.reconfig_count, jf.blocked_seconds)
    if failure == "device":
        assert not tf._circuits[3].any()
        tcp.restore_device(3)
        jcp.restore_device(3)
        tcp.apply(tcp.plan(0, _demand(7, 8)))
        jcp.apply(jcp.plan(0, _demand(7, 8)))
        assert np.array_equal(tf._circuits, jf._circuits)
    with pytest.raises(ValueError):
        tcp.plan(0)
    with pytest.raises(ValueError):
        TControlPlane(2, 8, num_devices=4).fail_nic(0)


# ---------------------------------------------------------------------------
# netsim: training, serving, fleet
# ---------------------------------------------------------------------------


def _train(ns, pm, fab_mod, name: str, copilot: bool, iters: int = 3):
    model = pm.scale_layout(pm.MIXTRAL_8X7B, 64)
    fab = _fabric(fab_mod, name, num_servers=16, link_gbps=400)
    res = ns.simulate_training(model, fab, iterations=iters, seed=0, use_copilot=copilot)
    return [r.breakdown() for r in res], getattr(fab, "_circuits", None)


@pytest.mark.parametrize("name", FABRICS)
def test_simulate_training_equals_reference(name):
    got, gcirc = _train(tns, tpm, tfab, name, False)
    want, wcirc = _train(jns, jpm, jfab, name, False)
    assert got == want
    assert (gcirc is None) == (wcirc is None)
    if gcirc is not None:
        assert np.array_equal(gcirc, wcirc)


def test_simulate_training_copilot_close_to_reference():
    """COPILOT on: the fit is numpy float32 here and XLA's in the
    reference, so the times agree within COPILOT_RTOL; the circuits the
    predictions lead to are equal."""
    got, gcirc = _train(tns, tpm, tfab, "mixnet", True, iters=3)
    want, wcirc = _train(jns, jpm, jfab, "mixnet", True, iters=3)
    assert np.array_equal(gcirc, wcirc)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for key in g:
            if key == "a2a_link_bytes":
                assert g[key] == w[key]
            else:
                np.testing.assert_allclose(g[key], w[key], rtol=COPILOT_RTOL, atol=0.0)


def test_simulate_serving_equals_reference():
    kw = dict(mix="chat", num_requests=4, slots=4, seed=3, reconfig_every_ticks=32,
              paged_kv=True, kv_budget_tokens=6000, spec_decode=(2, 0.6))
    results = []
    for ns, pm, fab in ((tns, tpm, tfab), (jns, jpm, jfab)):
        model = pm.scale_layout(pm.MIXTRAL_8X7B, 32)
        results.append(ns.simulate_serving(model, _fabric(fab, "mixnet", num_servers=4,
                                                          link_gbps=400), **kw).breakdown())
    assert results[0] == results[1]
    assert results[0]["completed"] == 4


def test_simulate_fleet_equals_reference():
    """The setting of tests/test_fleet.py's priced fleet, reduced to two
    replicas, with a drain."""
    kw = dict(num_replicas=2, num_requests=8, mixes=("chat", "agentic"), seed=0,
              arrival_scale=0.05, policy="locality", drain=(1, 40))
    results = []
    for ns in (tns, jns):
        model = ns.SimModel(name="flt-sim", num_blocks=8, d_model=1024, d_ff=4096,
                            num_experts=16, top_k=2, num_heads=16, ep_degree=16, tp_degree=1,
                            pp_degree=1, overlap_chunks=2)
        results.append(ns.simulate_fleet(model, **kw).breakdown())
    assert results[0] == results[1]
    assert results[0]["completed"] == results[0]["requests"]


def test_netsim_ledger_counters():
    reg = metrics.default()
    before = reg.counter("netsim.exposed_comm_s", scenario="training").value
    _train(tns, tpm, tfab, "fat-tree", False, iters=1)
    assert reg.counter("netsim.exposed_comm_s", scenario="training").value > before
    assert reg.counter("comm.link_bytes", op="a2a", link="scale_out").value > 0


# ---------------------------------------------------------------------------
# the paper's claims through the port alone (tests/test_netsim.py,
# tests/test_topology.py)
# ---------------------------------------------------------------------------


def _mean_iter_on(fab, seed=0, iters=5):
    res = tns.simulate_training(tpm.MIXTRAL_8X7B, fab, iterations=iters, seed=seed,
                                use_copilot=(fab.name == "mixnet"))
    return float(np.mean([r.total for r in res[1:]]))


@functools.lru_cache(maxsize=None)
def _mean_iter(fabric_name, gbps, reconfig_delay_s=0.025):
    """Mean iteration (the first dropped) of the paper's Mixtral on 128
    servers, 5 iterations; shared by the claims below."""
    return _mean_iter_on(_fabric(tfab, fabric_name, num_servers=128, link_gbps=gbps,
                                 reconfig_delay_s=reconfig_delay_s))


def test_port_paper_headline_and_fabric_order():
    """Fig 13's 1.2x at 100G / 1.9x at 400G, growing with the link rate;
    MixNet near fat-tree, ahead of the over-subscribed fat-tree and of
    TopoOpt; more bandwidth never slower."""
    ratios = {}
    for gbps in (100, 400):
        tm = _mean_iter("mixnet", gbps)
        tf = _mean_iter("fat-tree", gbps)
        ratios[gbps] = (tcost.cost_efficiency(tm, tcost.fabric_cost("mixnet", 128, gbps))
                        / tcost.cost_efficiency(tf, tcost.fabric_cost("fat-tree", 128, gbps)))
    assert ratios[100] > 1.2 and ratios[400] > 1.9 and ratios[400] > ratios[100], ratios
    tm = _mean_iter("mixnet", 400)
    assert tm <= _mean_iter("mixnet", 100) * 1.001
    assert tm <= _mean_iter("fat-tree", 400) * 1.25
    assert tm < _mean_iter("oversub-fat-tree", 400)
    assert _mean_iter("topoopt", 100) / _mean_iter("mixnet", 100) > 1.1
    for gbps in (100, 200, 400, 800):
        assert 0 < tcost.fabric_cost("mixnet", 128, gbps) < tcost.fabric_cost("fat-tree", 128,
                                                                              gbps)


def test_port_reconfig_cliff_and_failure_resilience():
    """Fig 28: 25 ms OCS is hidden, seconds-scale reconfiguration is not;
    Fig 14: one server's optical loss costs a few percent."""
    fast = _mean_iter("mixnet", 400)
    assert fast <= _mean_iter("mixnet", 400, reconfig_delay_s=1e-5) * 1.1
    assert _mean_iter("mixnet", 400, reconfig_delay_s=10.0) > fast * 1.5
    fab = _fabric(tfab, "mixnet", num_servers=128, link_gbps=400)
    healthy = _mean_iter_on(fab, iters=4)
    fab.fail_server_ocs(0)
    failed = _mean_iter_on(fab, seed=1, iters=4)
    assert healthy * 0.95 <= failed < healthy * 1.35


def test_port_algorithm1_properties():
    """Degree and symmetry invariants, greedy no slower than uniform on a
    skewed demand, monotone in the optical degree (tests/test_topology.py)."""
    for seed in range(10):
        rng = np.random.default_rng(seed)
        n, alpha = int(rng.choice([2, 4, 8])), int(rng.integers(1, 9))
        t = ttopo.reconfigure_ocs(_demand(seed, n * 2), alpha=alpha, num_servers=n)
        assert (t.circuits == t.circuits.T).all() and not np.diag(t.circuits).any()
        assert all(t.links_of(s) <= alpha for s in range(n))
        used = set()
        for i, ni, j, nj in t.nic_map:
            assert (i, ni) not in used and (j, nj) not in used
            used |= {(i, ni), (j, nj)}
        dem = _demand(seed, 8)
        dem[0, 1] = dem[1, 0] = dem.max() * 10
        pair = np.triu(dem + dem.T, 1)
        solved = ttopo.reconfigure_ocs(dem, alpha=6, num_servers=8, experts_per_server=1)
        assert ttopo.topology_completion_time(solved.circuits, pair, 1.0, 0.25) <= \
            ttopo.topology_completion_time(ttopo.uniform_topology(8, 6), pair, 1.0, 0.25) * 1.0001
    dem = _demand(7, 8)
    pair = np.triu(dem + dem.T, 1)
    times = [ttopo.topology_completion_time(
        ttopo.reconfigure_ocs(dem, alpha=a, num_servers=8, experts_per_server=1).circuits,
        pair, 1.0, 0.25) for a in (1, 2, 4, 6, 8)]
    assert all(b <= a * 1.0001 for a, b in zip(times, times[1:]))
    fold = ttopo.calculate_server_demand(np.arange(16.0).reshape(4, 4), experts_per_server=2)
    assert fold[1, 0] == 0.0 and fold[0, 1] == 18.0 + 42.0  # e[:2, 2:] + e[2:, :2]


# ---------------------------------------------------------------------------
# the autotuner and the trainer's cache hook
# ---------------------------------------------------------------------------

SMALL_SPACE = {
    "overlap_chunks": (1, 4),
    "moe_dispatch": ("dropless", "capacity"),
    "a2a_lowering": ("hier", "ring"),
    "dp_compress": (False,),
}


def test_tune_matches_reference_and_caches_interoperate(tmp_path):
    model_t = tpm.scale_layout(tpm.MIXTRAL_8X7B, 64)
    model_j = jpm.scale_layout(jpm.MIXTRAL_8X7B, 64)
    tpath, jpath = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    got = tautotune.tune(model_t, "mixnet", 400, num_servers=8, cache_path=tpath,
                         iterations=2, space=SMALL_SPACE)
    want = jautotune.tune(model_j, "mixnet", 400, num_servers=8, cache_path=jpath,
                          iterations=2, space=SMALL_SPACE)
    assert got.key == want.key == tautotune.cache_key(model_t, "mixnet", 400)
    assert got.knobs == want.knobs
    np.testing.assert_allclose(got.goodput_tok_s, want.goodput_tok_s, rtol=COPILOT_RTOL)
    np.testing.assert_allclose(got.default_goodput_tok_s, want.default_goodput_tok_s,
                               rtol=COPILOT_RTOL)
    # each package reads the other's file, key for key
    with open(tpath) as f, open(jpath) as g:
        assert json.load(f).keys() == json.load(g).keys()
    assert tautotune.load_cached(jpath, want.key).to_json() == want.to_json()
    assert jautotune.load_cached(tpath, got.key).to_json() == got.to_json()
    assert tautotune.load_cached(jpath, "absent") is None
    # the repository's cache, which the JAX package wrote
    hit = tautotune.load_cached(os.path.join(REPO, "autotune_cache.json"),
                                tautotune.cache_key(tpm.MIXTRAL_8X7B, "mixnet", 400))
    assert hit is not None and hit.knobs["overlap_chunks"] == 8
    tuned = tautotune.apply(model_t, got)
    assert tuned.pp_overlap and tuned.overlap_chunks == got.knobs["overlap_chunks"]


def _tiny_cfgs(chunks: int = 1):
    from repro.models.config import ModelConfig as JModelConfig
    from repro.models.config import MoEConfig as JMoEConfig
    from repro_torch.models.config import ModelConfig, MoEConfig

    return [mc("t", "moe", 2, 32, 4, 2, 0, 64, dtype="float32", remat="none",
               moe=moe(num_experts=4, top_k=2, d_ff=32, backend="mixnet",
                       overlap_chunks=chunks))
            for mc, moe in ((ModelConfig, MoEConfig), (JModelConfig, JMoEConfig))]


@pytest.mark.parametrize("tkw", [{}, {"dp_comm": "runtime"}, {"pp_stages": 2},
                                 {"dp_comm": "runtime", "pp_stages": 2}])
def test_apply_to_trainer_equals_reference(tkw):
    from repro.train.trainer import TrainerConfig as JTrainerConfig
    from repro_torch.train.trainer import TrainerConfig

    knobs = {"overlap_chunks": 4, "moe_dispatch": "capacity", "a2a_lowering": "ring",
             "dp_compress": True, "pp_overlap": True}
    tcfg, jcfg = _tiny_cfgs()
    tres = tautotune.TuneResult("k", dict(knobs), 2.0, 1.0)
    jres = jautotune.TuneResult("k", dict(knobs), 2.0, 1.0)
    c, t = tautotune.apply_to_trainer(tcfg, TrainerConfig(**tkw), tres)
    jc, jt = jautotune.apply_to_trainer(jcfg, JTrainerConfig(**tkw), jres)
    assert dataclasses.asdict(c.moe) == dataclasses.asdict(jc.moe)
    assert t.dp_compress == jt.dp_compress
    assert tres.speedup == jres.speedup == 2.0


def test_trainer_consumes_cache_and_chunked_equals_serial(tmp_path, capsys):
    """A hit sets the tuned ``overlap_chunks``; a miss keeps the config,
    warns once and counts ``autotune.cache_miss``.  The tuned (chunked)
    trainer's losses and weights equal the one-chunk trainer's bit for
    bit: the chunked pipeline's expert weight gradients are taken in the
    serial path's row order."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import make_plan
    from repro_torch.train.trainer import Trainer, TrainerConfig

    res = tautotune.TuneResult("t|cache-key", {"overlap_chunks": 4, "pp_overlap": True},
                               2.0, 1.0)
    cache = tmp_path / "cache.json"
    cache.write_text(json.dumps({res.key: res.to_json()}))
    cfg = _tiny_cfgs()[0]

    def run(key, c=cfg):
        tr = Trainer(c, AdamWConfig(lr=1e-3), TrainerConfig(
            total_steps=2, autotune_cache=str(cache), autotune_key=key), make_plan(None),
            seed=0, device="cpu")
        tr.train(iter(SyntheticLM(64, seq_len=16, global_batch=4, seed=0)))
        return tr

    misses = metrics.counter("autotune.cache_miss").value
    tuned = run(res.key)
    assert tuned.cfg.moe.overlap_chunks == 4
    untuned = run("absent")
    assert untuned.cfg.moe.overlap_chunks == 1
    assert metrics.counter("autotune.cache_miss").value == misses + 1
    assert "autotune cache miss" in capsys.readouterr().out
    assert [m["loss"] for m in tuned.metrics_log] == [m["loss"] for m in untuned.metrics_log]
    for (name, a), (_, b) in zip(_leaves(tuned.params), _leaves(untuned.params)):
        assert torch.equal(a, b), name


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


# ---------------------------------------------------------------------------
# the walkthrough
# ---------------------------------------------------------------------------


def test_reconfigure_fabric_prints_the_reference_numbers():
    from repro_torch import reconfigure_fabric

    spec = importlib.util.spec_from_file_location(
        "reference_reconfigure_fabric", os.path.join(REPO, "examples", "reconfigure_fabric.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    outs = []
    for fn in (reconfigure_fabric.main, example.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn()
        outs.append(buf.getvalue().splitlines())
    got, want = outs
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g.startswith("== 6:"):
            assert "card" in g and "TPU" in w
        else:
            assert g == w
