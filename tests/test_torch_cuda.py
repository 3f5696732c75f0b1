"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports no JAX, so the machine with the card runs it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a card every test here skips (decided inside the test).  Tolerances
are ``torch.testing``'s dtype defaults: f32 (rtol 1.3e-6, atol 1e-5) for the
gate, whose probabilities differ from ``torch.softmax`` only in summation
order, and bf16 (rtol 1.6e-2, atol 1e-5) for attention in bf16, whose
kernel accumulates in f32 and rounds once; f32 attention uses rtol 1e-5,
atol 1e-5 (a different summation order over up to 77 keys).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_cuda, paged_flash_decode_cuda
from repro_torch.kernels.topk_gating import topk_gating_cuda

TOLS = {torch.float32: dict(rtol=1e-5, atol=1e-5), torch.bfloat16: dict(rtol=1.6e-2, atol=1e-5)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build with nvcc for sm_90a)")
    return torch.device("cuda")


def _table(lengths, c, page, max_pages, num_pages, seed):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_pages)[: len(lengths) * max_pages].reshape(len(lengths), max_pages)
    used = np.asarray([-(-(t + c) // page) for t in lengths])
    return torch.from_numpy(np.where(np.arange(max_pages)[None, :] < used[:, None], perm, -1)
                            .astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("t,e,k", [(4, 8, 2), (37, 8, 2), (45, 160, 6), (300, 1024, 8)])
def test_topk_gating_kernel(dev, t, e, k):
    g = torch.Generator(device=dev).manual_seed(t)
    logits = torch.randn((t, e), generator=g, device=dev) * 2
    logits[0] = 0.5  # an all-tied row goes to the lowest ids
    w, i = topk_gating_cuda(logits, k)
    rw, ri = ref.topk_gating(logits, k)
    assert torch.equal(i, ri) and i[0].tolist() == list(range(k))
    torch.testing.assert_close(w, rw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=33, softcap=30.0),
                                dict(causal=False)])
def test_flash_attention_kernel(dev, dtype, d, kw):
    g = torch.Generator(device=dev).manual_seed(d)
    q = torch.randn((2, 6, 77, d), generator=g, device=dev).to(dtype)
    k = torch.randn((2, 2, 77, d), generator=g, device=dev).to(dtype)
    v = torch.randn((2, 2, 77, d), generator=g, device=dev).to(dtype)
    got = flash_attention_cuda(q, k, v, **kw)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), ref.flash_attention(q, k, v, **kw).float(),
                               **TOLS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 2, 5])
@pytest.mark.parametrize("kw", [{}, dict(window=12, softcap=25.0)])
def test_paged_flash_decode_kernel(dev, dtype, c, kw):
    g = torch.Generator(device=dev).manual_seed(c)
    lengths = [37, 20, 3]
    table = _table(lengths, c, 8, 7, 30, seed=c).to(dev)
    t = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn((3, c, 6, 128), generator=g, device=dev).to(dtype)
    kp = torch.randn((30, 8, 2, 128), generator=g, device=dev).to(dtype)
    vp = torch.randn((30, 8, 2, 128), generator=g, device=dev).to(dtype)
    got = paged_flash_decode_cuda(q, kp, vp, table, t, **kw)
    torch.testing.assert_close(got.float(), ref.paged_flash_decode(q, kp, vp, table, t, **kw)
                               .float(), **TOLS[dtype])


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros((4, 8), device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        topk_gating_cuda(x, 2)
    q = torch.zeros((1, 2, 8, 96), device=dev)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q)  # head dim 96
    q = torch.zeros((1, 2, 8, 64), device=dev)
    with pytest.raises(ValueError):
        flash_attention_cuda(q.transpose(1, 2), q, q)  # not contiguous
