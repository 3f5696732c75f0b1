"""The port's kernels (repro_torch.kernels): each plain PyTorch version
against the JAX package's oracle and its Pallas kernel in interpret mode,
the device dispatch of ``ops``, and the guard that keeps JAX and the JAX
package out of the port.  The CUDA kernels against their plain versions are
in ``test_torch_cuda.py``, which imports no JAX so that it runs on the
machine with the card."""

import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas, paged_flash_decode_pallas
from repro.kernels.topk_gating import topk_gating_pallas
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import topk_gating as ktg

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


# ---------------------------------------------------------------------------
# topk_gating
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t,e,k", [(64, 8, 2), (96, 16, 4), (32, 4, 1), (40, 160, 6)])
def test_topk_gating_plain_matches_jax(t, e, k):
    rng = np.random.default_rng(t + e + k)
    logits = (rng.standard_normal((t, e)) * 2.0).astype(np.float32)
    # Constructed ties: rows whose top entries are exactly equal.
    logits[0, :] = 0.5
    logits[1, 1::2] = 3.0
    w, i = tref.topk_gating(_t(logits), k)
    jw, ji = jref.topk_gating(jnp.asarray(logits), k)
    pw, pi = topk_gating_pallas(jnp.asarray(logits), k, interpret=True)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy(), np.asarray(pi))
    # ids tie to the lowest index
    np.testing.assert_array_equal(i[0].numpy(), np.arange(k))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(pw), rtol=1e-6)
    assert i.dtype == torch.int32 and w.dtype == torch.float32


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    dict(b=2, hq=4, hkv=2, s=32, d=16, causal=True, window=None, softcap=None),
    dict(b=1, hq=4, hkv=1, s=32, d=32, causal=True, window=8, softcap=None),
    dict(b=1, hq=6, hkv=2, s=32, d=16, causal=True, window=None, softcap=20.0),
    dict(b=1, hq=2, hkv=2, s=32, d=16, causal=False, window=None, softcap=None),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_plain_matches_jax(case):
    c = dict(case)
    rng = np.random.default_rng(c["s"] + c["hq"])
    q = rng.standard_normal((c["b"], c["hq"], c["s"], c["d"])).astype(np.float32)
    k = rng.standard_normal((c["b"], c["hkv"], c["s"], c["d"])).astype(np.float32)
    v = rng.standard_normal((c["b"], c["hkv"], c["s"], c["d"])).astype(np.float32)
    kw = dict(causal=c["causal"], window=c["window"], softcap=c["softcap"])
    out = tref.flash_attention(_t(q), _t(k), _t(v), **kw).numpy()
    expect = np.asarray(jref.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    pallas = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=16, bk=16, interpret=True, **kw
    ))
    np.testing.assert_allclose(out, expect, atol=1e-5, rtol=0)
    np.testing.assert_allclose(out, pallas, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_zero_padded_head_dim_is_exact(dtype):
    """The kernels are built at multiples of 32; their wrappers zero-pad any
    other head dim (a multiple of 8) to the next one, with the true D's
    softmax scale, and slice the results back.  On the plain forward and
    backward that padding changes no bit."""
    rng = np.random.default_rng(3)
    for d, kw in ((40, dict(causal=True, window=9, softcap=20.0)), (8, dict(causal=False))):
        dp = kfa._head_dim("test", d)
        assert dp == -(-d // 32) * 32
        q, do = (_t(rng.standard_normal((1, 4, 33, d)).astype(np.float32)).to(dtype)
                 for _ in range(2))
        k, v = (_t(rng.standard_normal((1, 2, 33, d)).astype(np.float32)).to(dtype)
                for _ in range(2))
        padded = [kfa._pad(t, dp) for t in (q, k, v, do)]
        got = tref.flash_attention(*padded[:3], scale=d**-0.5, **kw)[..., :d]
        assert torch.equal(got, tref.flash_attention(q, k, v, **kw))
        grads = tref.flash_attention_bwd(*padded, scale=d**-0.5, **kw)
        for a, b in zip(grads, tref.flash_attention_bwd(q, k, v, do, **kw)):
            assert torch.equal(a[..., :d], b)
    for bad in (36, 264, 0):
        with pytest.raises(ValueError):
            kfa._head_dim("test", bad)


# ---------------------------------------------------------------------------
# paged flash decode
# ---------------------------------------------------------------------------


def _paged_case(c, seed):
    b, hq, hkv, d, page, p = 3, 4, 2, 16, 8, 6
    n_pool = b * p + 5
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, c, hq, d)).astype(np.float32)
    k_pool = rng.standard_normal((n_pool, page, hkv, d)).astype(np.float32)
    v_pool = rng.standard_normal((n_pool, page, hkv, d)).astype(np.float32)
    perm = rng.permutation(n_pool)[: b * p].reshape(b, p).astype(np.int32)
    lengths = np.asarray([p * page - c - 1 - 9 * i for i in range(b)], np.int32)
    used = -(-(lengths + c) // page)
    table = np.where(np.arange(p)[None, :] < used[:, None], perm, -1).astype(np.int32)
    assert (table == -1).any()
    return q, k_pool, v_pool, table, lengths


@pytest.mark.parametrize("c", [1, 2, 4])
@pytest.mark.parametrize("knobs", [{}, dict(window=12, softcap=25.0)])
def test_paged_flash_decode_plain_matches_jax(c, knobs):
    q, kp, vp, table, lengths = _paged_case(c, seed=c)
    out = tref.paged_flash_decode(_t(q), _t(kp), _t(vp), _t(table), _t(lengths), **knobs)
    args = [jnp.asarray(a) for a in (q, kp, vp, table, lengths)]
    expect = np.asarray(jref.paged_flash_decode(*args, **knobs))
    pallas = np.asarray(paged_flash_decode_pallas(*args, interpret=True, **knobs))
    assert out.shape == q.shape
    np.testing.assert_allclose(out.numpy(), expect, atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), pallas, atol=1e-5, rtol=0)


def test_paged_gather_kv_matches_jax():
    _, kp, _, table, _ = _paged_case(2, seed=9)
    got = tref.paged_gather_kv(_t(kp), _t(table)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jref.paged_gather_kv(jnp.asarray(kp), jnp.asarray(table))))


# ---------------------------------------------------------------------------
# rmsnorm with its gate (Mamba-2's gated norm)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gated_rmsnorm_plain_matches_jax(dtype):
    """``ops.rmsnorm(x, w, gate=z)`` on the CPU against the JAX package's
    Mamba-2 block (``src/repro/models/ssm.py:189-190``): ``y * silu(z)``,
    then ``rms_norm``.  z spans +-100 (silu saturates to 0 and to z).
    Tolerance: f32 rtol and atol 1e-5; bf16 torch.testing's bf16 defaults
    (rtol 1.6e-2, atol 1e-5): the product rounds to bf16 in both, and silu's
    rounding may differ by an ulp."""
    from repro.models import layers as jL

    rng = np.random.default_rng(11)
    yn = (rng.standard_normal((6, 64)) * 3).astype(np.float32)
    zn = (rng.standard_normal((6, 64)) * 3).astype(np.float32)
    zn[0, :4] = [100.0, -100.0, 30.0, -30.0]
    wn = (rng.standard_normal(64) * 0.1).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    y, z, w = (jnp.asarray(a, jd) for a in (yn, zn, wn))
    want = np.asarray(jL.rms_norm(y * jax.nn.silu(z), w, 1e-6).astype(jnp.float32))
    got = ops.rmsnorm(*(_t(np.asarray(a.astype(jnp.float32))).to(td) for a in (y, w)), eps=1e-6,
                      gate=_t(np.asarray(z.astype(jnp.float32))).to(td))
    assert got.dtype == td
    rtol = 1e-5 if dtype == "float32" else 1.6e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=1e-5)


# ---------------------------------------------------------------------------
# ops dispatch and the wrappers' refusals
# ---------------------------------------------------------------------------


def test_ops_cpu_tensors_take_the_plain_path():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    logits = _t(rng.standard_normal((8, 8)).astype(np.float32))
    w, i = ops.topk_gating(logits, 2)
    rw, ri = tref.topk_gating(logits, 2)
    assert torch.equal(i, ri) and torch.equal(w, rw)
    q = _t(rng.standard_normal((1, 2, 16, 64)).astype(np.float32))
    assert torch.equal(ops.flash_attention(q, q, q), tref.flash_attention(q, q, q))
    qd, kp, vp, table, lengths = _paged_case(1, seed=3)
    got = ops.paged_flash_decode(_t(qd), _t(kp), _t(vp), _t(table), _t(lengths))
    assert torch.equal(got, tref.paged_flash_decode(_t(qd), _t(kp), _t(vp), _t(table), _t(lengths)))
    counts = ops.launch_counts()
    assert {"topk_gating", "flash_attention", "paged_flash_decode"} <= set(counts)
    assert not any(counts.values()), counts


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError):
        ktg.topk_gating_cuda(x, 2)
    q = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError):
        kfa.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError):
        kfa.paged_flash_decode_cuda(
            torch.zeros((1, 1, 2, 64)), torch.zeros((2, 4, 2, 64)), torch.zeros((2, 4, 2, 64)),
            torch.zeros((1, 2), dtype=torch.int32), torch.zeros((1,), dtype=torch.int32),
        )
    counts = ops.launch_counts()
    assert {"topk_gating", "flash_attention", "paged_flash_decode"} <= set(counts)
    assert not any(counts.values()), counts


def test_build_hash_covers_every_header(tmp_path, monkeypatch):
    """Editing any ``csrc/*.cuh`` (or adding one) renames every library, so
    each is rebuilt; nothing here runs nvcc."""
    import shutil

    from repro_torch.kernels import build

    for f in build.CSRC.iterdir():
        if f.suffix in (".cu", ".cuh"):
            shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build._lib_path(n) for n in build.SOURCES}
    assert {n: build._lib_path(n) for n in build.SOURCES} == before  # stable
    headers = sorted(tmp_path.glob("*.cuh"))
    assert {"common.cuh", "hopper.cuh"} <= {h.name for h in headers}
    seen = [before]
    for h in headers:
        h.write_text(h.read_text() + "\n// edited\n")
        now = {n: build._lib_path(n) for n in build.SOURCES}
        assert all(now[n] != old[n] for old in seen for n in build.SOURCES), h.name
        seen.append(now)
    (tmp_path / "extra.cuh").write_text("#pragma once\n")
    now = {n: build._lib_path(n) for n in build.SOURCES}
    assert all(now[n] != seen[-1][n] for n in build.SOURCES)


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

_GUARD = """
import importlib, importlib.util, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro.")]
print("BAD", bad)
assert not bad, bad
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _GUARD, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=str(REPO), timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    pat = re.compile(r"^\s*(import jax|from jax|import repro\.|from repro\.|from repro import|import repro$)", re.M)
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders
