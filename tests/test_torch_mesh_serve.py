"""EP-sharded serving in the port against the JAX package on the CPU: the
``einsum`` and ``dense_decode`` MoE backends over a ``(1, 4)`` mesh, and the
serving engine over a ``("model",)`` mesh at P = 2 and 4 with the
reference's three invariants (``tests/test_serve.py:133-206``,
``tests/test_paged.py:290-356``, ``tests/test_spec.py:280-347``).

One JAX subprocess with 4 forced host devices and one 4-process gloo group
run side by side on the same seeded weights (the port's one-device draw,
handed to both as numpy), once per module.  P = 4 is a ``("model",)`` mesh
of the four ranks; P = 2 is a ``("rep", "model")`` mesh of 2 x 2, whose
first axis the plan ignores, so each pair of ranks serves on its own.

Tolerances: the layers' outputs within ``atol=rtol=1e-5`` of the JAX
package's on the same mesh (XLA and PyTorch sum in other orders), their
loads exactly; port against port, bit for bit: P = 4 against P = 1 for
dropless ``einsum`` and ``dense_decode``, every rank's tokens, and the
three invariants.  The engine's tokens equal the JAX 4-device engine's on
the sparse and paged sweeps, both engines admitting each prompt as one
decode-mode chunk (``prefill_chunk``), as ``tests/test_torch_serve.py``
holds them at one device; the speculative sweep is held port against port
only (the reference fails its own ``test_spec_parity_multidevice[4]`` on
this CPU).
"""

import dataclasses
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
# (backend, mode, dispatch, experts, top_k, x shape, wire): every layer case
# runs on the (1, 4) mesh with an expert perm; "virtual" has E = 2 < P.
LAYER_CASES = {
    "einsum_dropless": ("einsum", None, "dropless", 8, 2, (4, 16, 32), True),
    "einsum_capacity": ("einsum", None, "capacity", 8, 2, (4, 16, 32), False),
    "einsum_decode": ("einsum", "decode", "dropless", 8, 2, (6, 2, 32), True),
    "einsum_virtual": ("einsum", None, "dropless", 2, 1, (4, 16, 32), False),
    "dense_decode": ("dense_decode", "decode", "dropless", 8, 2, (6, 1, 32), True),
    "dense_virtual": ("dense_decode", "decode", "dropless", 2, 1, (6, 1, 32), False),
}
P1_CASES = ("einsum_dropless", "einsum_decode", "dense_decode")
# The JAX comparison's engines at P = 4: (dispatch, decode backend, paged).
JAX_ENGINES = {
    "sparse_dropless": ("dropless", "sparse", False),
    "sparse_capacity": ("capacity", "sparse", False),
    "paged_dropless": ("dropless", "dense", True),
    "paged_capacity": ("capacity", "dense", True),
}


def _layer_cfg(mod, dispatch, experts, top_k):
    return mod.ModelConfig("t", "moe", 2, 32, 4, 2, 64, 128, dtype="float32",
                           moe=mod.MoEConfig(num_experts=experts, top_k=top_k, d_ff=48,
                                             capacity_factor=1.0 if dispatch == "capacity"
                                             else 8.0, a2a_group=2, dispatch=dispatch))


def _srv_cfg(mod, dispatch="dropless", decode_backend="dense", shared=0):
    """The reference sweeps' model: 2 layers, d_model 32, 8 experts top-2."""
    return mod.ModelConfig(
        "srv", "moe", 2, 32, 4, 2, 0, 64, dtype="float32", remat="none",
        moe=mod.MoEConfig(num_experts=8, top_k=2, d_ff=32, num_shared_experts=shared,
                          capacity_factor=8.0, backend="mixnet", a2a_group=2,
                          dispatch=dispatch, decode_backend=decode_backend),
    )


def _requests(gen):
    return [dataclasses.replace(r, prompt_len=12, max_new_tokens=4) for r in gen.generate(3)]


def _spec_prompts():
    rng = np.random.default_rng(9)
    return [rng.integers(1, 63, size=int(n)).astype(np.int32) for n in (6, 11, 9)]


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


def _tokens(finished) -> str:
    return json.dumps(sorted((int(r.rid), [int(t) for t in r.out]) for r in finished))


def _inputs() -> dict:
    """Every seeded input both sides read: the layers' weights and
    activations, and the engines' weights (the port's one-device draws)."""
    import torch

    from repro_torch.models import config as tc
    from repro_torch.models.transformer import init_model
    from repro_torch.parallel.sharding import make_plan, virtual_experts

    rng = np.random.default_rng(31)
    inp = {}
    for case, (_, _, _, experts, _, shape, wire) in LAYER_CASES.items():
        ev, r = virtual_experts(experts, 4)
        f = 48 // r
        inp[f"{case}/x"] = rng.standard_normal(shape).astype(np.float32)
        inp[f"{case}/router"] = (rng.standard_normal((32, experts)) * 0.5).astype(np.float32)
        for w, sh in (("w_in", (ev, 32, f)), ("w_gate", (ev, 32, f)), ("w_out", (ev, f, 32))):
            inp[f"{case}/{w}"] = (rng.standard_normal(sh) / np.sqrt(sh[1])).astype(np.float32)
        inp[f"{case}/perm"] = rng.permutation(ev).astype(np.int32)
        inp[f"{case}/wire"] = (rng.permutation(4) if wire else np.arange(4)).astype(np.int32)
        inp[f"{case}/gw"] = (rng.random(shape[:2]) > 0.3).astype(np.float32)
    for tag, seed, shared in (("w0", 0, 0), ("w1", 1, 0), ("w1s", 1, 1)):
        params = init_model(seed, _srv_cfg(tc, shared=shared), make_plan(None), device="cpu")
        with torch.no_grad():
            inp.update({f"{tag}{k}": v.numpy() for k, v in _flat(params)})
    return inp


# ---------------------------------------------------------------------------
# the JAX side: one subprocess with 4 host devices
# ---------------------------------------------------------------------------

JAX_MAIN = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
sys.path.insert(0, TESTS)
import test_torch_mesh_serve as T
from repro.launch.mesh import make_mesh, use_mesh
from repro.models import config as jc
from repro.models import moe as jmoe
from repro.parallel.sharding import make_plan
from repro.serve.engine import ServeConfig, ServeEngine
from repro.serve.workload import WorkloadGenerator

inp = dict(np.load(IN))
out = {}
mesh = make_mesh((1, 4), ("data", "model"))
plan = make_plan(mesh, fsdp=False)


def layer(case):
    backend, mode, dispatch, experts, top_k, _, wire = T.LAYER_CASES[case]
    cfg = T._layer_cfg(jc, dispatch, experts, top_k)
    p = {w: jnp.asarray(inp[f"{case}/{w}"]) for w in ("router", "w_in", "w_gate", "w_out")}
    gw = jnp.asarray(inp[f"{case}/gw"]) if backend == "dense_decode" else None
    o, st = jmoe.moe_apply(p, jnp.asarray(inp[f"{case}/x"]), cfg, plan, mesh=mesh,
                           backend=backend, mode=mode, expert_perm=jnp.asarray(inp[f"{case}/perm"]),
                           wire_perm=jnp.asarray(inp[f"{case}/wire"]) if wire else None,
                           gate_weights=gw)
    return {"out": o, "load": st.expert_load}


with use_mesh(mesh):
    res = jax.jit(lambda: {c: layer(c) for c in T.LAYER_CASES})()
out.update({f"{c}/{k}": v for c, r in res.items() for k, v in r.items()})

m4 = make_mesh((4,), ("model",))
plan4 = make_plan(m4)
params = jax.tree.map(jnp.asarray, T._nest(inp, "w0"))
for tag, (dispatch, dec, paged) in T.JAX_ENGINES.items():
    cfg = T._srv_cfg(jc, dispatch, dec)
    gen = WorkloadGenerator("chat", seed=3, vocab_size=cfg.vocab_size)
    reqs = T._requests(gen)
    scfg = ServeConfig(slots=2, max_len=32, paged=paged, prefill_chunk=20, num_devices=4)
    eng = ServeEngine(jax.tree.map(lambda a: a, params), cfg, plan4, scfg, mesh=m4)
    with use_mesh(m4):
        rep = eng.run(reqs, gen)
    assert rep.completed == len(reqs)
    out[f"eng/{tag}"] = np.array(T._tokens(eng.batcher.finished))
np.savez(OUT, **{k: np.asarray(v) for k, v in out.items()})
print("JAX_MESH_SERVE_OK")
"""


# ---------------------------------------------------------------------------
# the port side: 4 gloo ranks
# ---------------------------------------------------------------------------


def _port_rank(rank: int, inp_path: str, out_dir: str, port: int) -> None:
    import torch

    torch.set_num_threads(1)
    from repro_torch.core import commruntime as cr
    from repro_torch.core.controlplane import LayerPlan
    from repro_torch.interop import params_from_numpy, shard_params
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models import config as tc
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel.sharding import make_plan
    from repro_torch.serve.batching import Request
    from repro_torch.serve.engine import ServeConfig, ServeEngine
    from repro_torch.serve.workload import WorkloadGenerator

    init_distributed(rank=rank, world_size=4, init_method=f"tcp://localhost:{port}",
                     device_type="cpu")
    inp = dict(np.load(inp_path))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    out = {}

    # the layers over (1, 4), and at P = 1
    mesh14 = make_mesh((1, 4), ("data", "model"))
    plan14, plan1 = make_plan(mesh14, fsdp=False), make_plan(None)
    with torch.no_grad():
        for case, (backend, mode, dispatch, experts, top_k, _, wire) in LAYER_CASES.items():
            cfg = _layer_cfg(tc, dispatch, experts, top_k)
            full = {w: inp[f"{case}/{w}"] for w in ("router", "w_in", "w_gate", "w_out")}
            n = full["w_in"].shape[0] // 4
            mine = {w: t(a if w == "router" else a[rank * n:(rank + 1) * n])
                    for w, a in full.items()}
            gw = t(inp[f"{case}/gw"]) if backend == "dense_decode" else None
            x, perm = t(inp[f"{case}/x"]), inp[f"{case}/perm"]
            w4 = inp[f"{case}/wire"] if wire else None
            o, st = moe_mod.moe_apply(mine, x, cfg, plan14, mesh=mesh14, backend=backend,
                                      mode=mode, expert_perm=t(perm), wire_perm=w4,
                                      gate_weights=gw)
            out[f"{case}/out"], out[f"{case}/load"] = o, st.expert_load
            if case in P1_CASES:
                # one device, the wire map composed into the slot map by hand
                w = inp[f"{case}/wire"]
                epd = full["w_in"].shape[0] // 4
                p1 = w[perm // epd] * epd + perm % epd
                o1, _ = moe_mod.moe_apply({k: t(v) for k, v in full.items()}, x, cfg, plan1,
                                          backend=backend, mode=mode, expert_perm=t(p1),
                                          gate_weights=gw)
                out[f"{case}/p1"] = o1

    # the engine sweeps at P = 4 and P = 2
    meshes = {4: make_mesh((4,), ("model",)), 2: make_mesh((2, 2), ("rep", "model"))}

    def engine(p, cfg, wtag, **kw):
        mesh = meshes[p]
        plan = make_plan(mesh)
        tree = _nest(inp, wtag)
        params = params_from_numpy(shard_params(tree, plan, mesh, cfg=cfg), cfg)
        return ServeEngine(params, cfg, plan, ServeConfig(num_devices=p, reconfig_min_gain=0.0,
                                                          **kw), mesh=mesh, device="cpu")

    for p in (4, 2):
        for dispatch in ("dropless", "capacity"):
            # sparse decode: reconfiguration on (a forced wire plan, then the
            # control loop) against off
            cfg = _srv_cfg(tc, dispatch, "sparse")
            gen = WorkloadGenerator("chat", seed=3, vocab_size=cfg.vocab_size)
            reqs = _requests(gen)
            for on in (True, False):
                eng = engine(p, cfg, "w0", slots=2, max_len=32, reconfig_every=2 if on else 0)
                if on:
                    block = np.arange(8).reshape(p, 8 // p)
                    block[[0, 1]] = block[[1, 0]]
                    eng.apply_plans([LayerPlan(layer, True, perm=block.reshape(-1).copy())
                                     for layer in range(cfg.pattern_repeats)])
                rep = eng.run(reqs, gen)
                tag = f"sparse{p}/{dispatch}/{int(on)}"
                out[f"{tag}/tokens"] = np.array(_tokens(eng.batcher.finished))
                out[f"{tag}/stats"] = [rep.completed, rep.reconfig_count, rep.a2a_bytes,
                                       eng.applier.wire_reconfig_count if on else 0]
            # paged against dense KV, with and without a forced weight plan
            cfg = _srv_cfg(tc, dispatch)
            for on in (False, True):
                for paged in (True, False):
                    eng = engine(p, cfg, "w0", slots=2, max_len=32, paged=paged,
                                 reconfig_every=2 if on else 0)
                    if on:
                        perm = np.arange(8)
                        perm[[0, 1]] = perm[[1, 0]]
                        eng.apply_plans([LayerPlan(layer, True, perm=perm.copy())
                                         for layer in range(cfg.pattern_repeats)])
                    rep = eng.run(reqs, gen)
                    tag = f"paged{p}/{dispatch}/{int(on)}/{int(paged)}"
                    out[f"{tag}/tokens"] = np.array(_tokens(eng.batcher.finished))
                    out[f"{tag}/stats"] = [rep.completed, rep.reconfig_count,
                                           int(rep.kv_paged), rep.kv_resident_pages_peak]
        # speculative against serial: shared_only (dropless, a shared
        # expert) and topk1 (capacity) drafts
        for dispatch, shared in (("dropless", 1), ("capacity", 0)):
            cfg = _srv_cfg(tc, dispatch, shared=shared)
            for on in (False, True):
                for k in (3, 0):
                    eng = engine(p, cfg, "w1s" if shared else "w1", slots=2, max_len=48,
                                 paged=True, page_size=8, spec_k=k, reconfig_every=3 if on else 0)
                    if on:
                        perm = np.arange(8)
                        perm[[0, 1]] = perm[[1, 0]]
                        eng.apply_plans([LayerPlan(layer, True, perm=perm.copy())
                                         for layer in range(cfg.pattern_repeats)])
                    for i, prompt in enumerate(_spec_prompts()):
                        eng.submit(Request(rid=100 + i, prompt=prompt, max_new_tokens=5))
                    while eng.batcher.busy:
                        eng.step()
                        eng.batcher.alloc.check_leaks()
                    rep = eng.report(1.0)
                    tag = f"spec{p}/{dispatch}/{int(on)}/{k}"
                    out[f"{tag}/tokens"] = np.array(_tokens(eng.batcher.finished))
                    out[f"{tag}/stats"] = [rep.completed, rep.reconfig_count, rep.spec_drafted,
                                           eng.batcher.draft_mode == "shared_only"]

    # the JAX comparison's engines: one decode-mode chunk per admission
    for tag, (dispatch, dec, paged) in JAX_ENGINES.items():
        cfg = _srv_cfg(tc, dispatch, dec)
        gen = WorkloadGenerator("chat", seed=3, vocab_size=cfg.vocab_size)
        eng = engine(4, cfg, "w0", slots=2, max_len=32, paged=paged, prefill_chunk=20)
        eng.run(_requests(gen), gen)
        out[f"eng/{tag}"] = np.array(_tokens(eng.batcher.finished))
    out["gather_bytes"] = cr.wire_bytes().scale_out

    def conv(v):
        return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **{k: conv(v) for k, v in out.items()})
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def _port_main(inp_path: str, out_dir: str, port: int) -> None:
    import torch.multiprocessing as mp

    mp.spawn(_port_rank, args=(inp_path, out_dir, port), nprocs=4, join=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.launch.train import free_port

    d = tmp_path_factory.mktemp("mesh_serve")
    inp = _inputs()
    inp_path = str(d / "inputs.npz")
    np.savez(inp_path, **inp)
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + tests + os.pathsep + env.get("PYTHONPATH", "")
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    jcode = (f"TESTS = {json.dumps(tests)}\nIN = {json.dumps(inp_path)}\n"
             f"OUT = {json.dumps(str(d / 'jax.npz'))}\n" + JAX_MAIN)
    tcode = (f"import test_torch_mesh_serve as T; "
             f"T._port_main({json.dumps(inp_path)}, {json.dumps(str(d))}, {free_port()})")
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=e)
             for code, e in ((tcode, dict(env, OMP_NUM_THREADS="1")), (jcode, jenv))]
    for p, what in zip(procs, ("port", "JAX")):
        so, se = p.communicate(timeout=600)
        if p.returncode != 0:
            for q in procs:
                q.kill()
            raise AssertionError(f"{what} side failed:\nSTDOUT:\n{so[-3000:]}\n"
                                 f"STDERR:\n{se[-6000:]}")
    jax_out = dict(np.load(d / "jax.npz"))
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]
    return jax_out, ranks


def _toks(got, key):
    return json.loads(str(got[key]))


def _same_on_every_rank(ranks, prefix):
    for key in ranks[0]:
        if key.startswith(prefix) and key.endswith("/tokens"):
            for got in ranks[1:]:
                assert str(got[key]) == str(ranks[0][key]), key


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_dense_backends_over_mesh_match_jax(runs, case):
    """Outputs within 1e-5 of the JAX package's on the same (1, 4) mesh,
    loads exactly, and every rank holds the same output bits."""
    jax_out, ranks = runs
    for got in ranks:
        np.testing.assert_allclose(got[f"{case}/out"], jax_out[f"{case}/out"], **TOL)
        np.testing.assert_array_equal(got[f"{case}/load"], jax_out[f"{case}/load"])
        np.testing.assert_array_equal(got[f"{case}/out"], ranks[0][f"{case}/out"])


@pytest.mark.parametrize("case", P1_CASES)
def test_dense_backends_p4_equal_p1_bit_for_bit(runs, case):
    _, ranks = runs
    for got in ranks:
        np.testing.assert_array_equal(got[f"{case}/out"], got[f"{case}/p1"])


def test_expert_output_gathers_accounted_on_the_model_axis(runs):
    _, ranks = runs
    assert all(float(got["gather_bytes"]) > 0 for got in ranks)


@pytest.mark.parametrize("p", [2, 4])
def test_sparse_decode_reconfig_parity_over_mesh(runs, p):
    """Port of ``tests/test_serve.py:133-206``: tokens with a forced wire
    plan and the control loop equal tokens without, dropless and capacity."""
    _, ranks = runs
    _same_on_every_rank(ranks, f"sparse{p}/")
    got = ranks[0]
    for dispatch in ("dropless", "capacity"):
        on, off = f"sparse{p}/{dispatch}/1", f"sparse{p}/{dispatch}/0"
        completed, reconfigs, a2a, wire = got[f"{on}/stats"]
        assert completed == 3 and reconfigs > 0 and a2a > 0 and wire > 0
        assert _toks(got, f"{on}/tokens") == _toks(got, f"{off}/tokens"), dispatch


@pytest.mark.parametrize("p", [2, 4])
def test_paged_equals_dense_over_mesh(runs, p):
    """Port of ``tests/test_paged.py:290-356``: paged tokens equal dense
    tokens, with and without a forced weight plan."""
    _, ranks = runs
    _same_on_every_rank(ranks, f"paged{p}/")
    got = ranks[0]
    for dispatch in ("dropless", "capacity"):
        for on in (0, 1):
            pg, dn = f"paged{p}/{dispatch}/{on}/1", f"paged{p}/{dispatch}/{on}/0"
            assert got[f"{pg}/stats"][2] == 1 and got[f"{dn}/stats"][2] == 0
            assert got[f"{pg}/stats"][3] > 0
            assert _toks(got, f"{pg}/tokens") == _toks(got, f"{dn}/tokens"), (dispatch, on)
            if on:
                assert got[f"{pg}/stats"][1] > 0


@pytest.mark.parametrize("p", [2, 4])
def test_speculative_equals_serial_over_mesh(runs, p):
    """Port of ``tests/test_spec.py:280-347`` (``check_leaks()`` after every
    tick ran in the ranks): speculative tokens equal serial tokens for the
    shared_only and topk1 drafts, reconfiguration on and off."""
    _, ranks = runs
    _same_on_every_rank(ranks, f"spec{p}/")
    got = ranks[0]
    for dispatch, shared in (("dropless", 1), ("capacity", 0)):
        for on in (0, 1):
            s, b = f"spec{p}/{dispatch}/{on}/3", f"spec{p}/{dispatch}/{on}/0"
            completed, reconfigs, drafted, shared_only = got[f"{s}/stats"]
            assert completed == 3 and drafted > 0 and bool(shared_only) == bool(shared)
            assert _toks(got, f"{s}/tokens") == _toks(got, f"{b}/tokens"), (dispatch, on)
            if on:
                assert reconfigs > 0


@pytest.mark.parametrize("tag", list(JAX_ENGINES))
def test_engine_over_mesh_matches_jax_engine(runs, tag):
    jax_out, ranks = runs
    for got in ranks:
        assert _toks(got, f"eng/{tag}") == json.loads(str(jax_out[f"eng/{tag}"]))
