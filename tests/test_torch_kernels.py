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
