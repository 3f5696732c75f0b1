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


# ---------------------------------------------------------------------------
# training-path kernels: MoE dispatch / combine, the grouped GEMM and the
# backward kernels.  Data movement is exact; the combine and the GEMMs
# accumulate in f32 in another order than the plain versions (f32: rtol/atol
# 1e-5 against products summed over at most a few hundred terms; bf16
# outputs: one rounding of the f32 result, rtol 1.6e-2).  Backward kernels
# are held against torch.autograd of the plain forward.
# ---------------------------------------------------------------------------

from repro_torch.kernels.flash_attention import FlashAttentionFn  # noqa: E402
from repro_torch.kernels.grouped_matmul import (  # noqa: E402
    GroupedMatmulBlocksFn, GroupedMatmulFn, grouped_matmul_blocks_cuda, grouped_matmul_cuda,
    grouped_matmul_dw_cuda, grouped_matmul_dx_cuda,
)
from repro_torch.kernels.moe_dispatch import (  # noqa: E402
    MoECombineFn, MoEDispatchFn, moe_combine_cuda, moe_dispatch_cuda,
)
from repro_torch.kernels.topk_gating import TopkGatingFn  # noqa: E402

GRAD_TOLS = {torch.float32: dict(rtol=1e-4, atol=1e-4),
             torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}


def _src(rng, t, p, drop):
    src = rng.integers(0, t, size=p)
    src[rng.random(p) < drop] = -1
    return torch.from_numpy(src.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 4096), (torch.float32, 33),
                                     (torch.bfloat16, 5)])
def test_moe_dispatch_kernel_exact(dev, dtype, d):
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((37, d)).astype(np.float32)).to(dev, dtype)
    src = _src(rng, 37, 50, 0.3).to(dev)
    assert torch.equal(moe_dispatch_cuda(x, src), ref.moe_dispatch(x, src))


def _combine_case(rng, dev, dtype, s, t=37, p=80, d=96):
    """Each packed row read by at most one (token, choice) term, as in the
    MoE layer (the backward gathers through the inverse of slot)."""
    y = torch.from_numpy(rng.standard_normal((p, d)).astype(np.float32)).to(dev, dtype)
    slot = rng.permutation(p)[: t * s].reshape(t, s)
    slot = np.where(rng.random((t, s)) < 0.25, -1, slot)
    slot[0] = -1  # a fully dropped row must come out exactly 0
    w = torch.from_numpy(rng.random((t, s)).astype(np.float32)).to(dev)
    return y, torch.from_numpy(slot.astype(np.int32)).to(dev), w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 2])
def test_moe_combine_kernel_and_backward(dev, dtype, s):
    rng = np.random.default_rng(s)
    y, slot, w = _combine_case(rng, dev, dtype, s)
    got = moe_combine_cuda(y, slot, w)
    assert got.dtype == torch.float32 and torch.equal(got[0], torch.zeros_like(got[0]))
    torch.testing.assert_close(got, ref.moe_combine(y, slot, w), rtol=1e-6, atol=1e-6)
    # backward: the inverse map of slot (flat t * S + s per packed row)
    inv = torch.full((y.shape[0],), -1, dtype=torch.int32, device=dev)
    flat = slot.reshape(-1).long()
    keep = flat >= 0
    inv[flat[keep]] = torch.arange(flat.numel(), device=dev, dtype=torch.int32)[keep]
    g = torch.randn(got.shape, device=dev)
    y1, w1 = y.clone().requires_grad_(), w.clone().requires_grad_()
    MoECombineFn.apply(y1, slot, w1, inv).backward(g)
    y2, w2 = y.clone().requires_grad_(), w.clone().requires_grad_()
    ref.moe_combine(y2, slot, w2).backward(g)
    torch.testing.assert_close(y1.grad.float(), y2.grad.float(), **GRAD_TOLS[dtype])
    torch.testing.assert_close(w1.grad, w2.grad, **GRAD_TOLS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("many_to_one", [False, True])
def test_moe_dispatch_backward(dev, many_to_one):
    rng = np.random.default_rng(7)
    t, d, sc = 20, 64, 2
    x = torch.randn((t, d), device=dev, dtype=torch.bfloat16)
    if many_to_one:  # the send buffer: row p holds token src[p] // sc
        slot = rng.permutation(t * sc).reshape(t, sc).astype(np.int32)
        slot[3, 1] = -1
        src = np.full(t * sc, -1, np.int32)
        src[slot[slot >= 0]] = np.nonzero(slot.reshape(-1) >= 0)[0] // sc
        inverse = torch.from_numpy(slot).to(dev)
    else:  # a one-to-one pack with empty rows
        dest = rng.permutation(t + 6)[:t].astype(np.int32)
        src = np.full(t + 6, -1, np.int32)
        src[dest] = np.arange(t)
        inverse = torch.from_numpy(dest).to(dev)
    src = torch.from_numpy(src).to(dev)
    g = torch.randn((src.shape[0], d), device=dev, dtype=torch.bfloat16)
    x1 = x.clone().requires_grad_()
    MoEDispatchFn.apply(x1, src, inverse).backward(g)
    x2 = x.clone().requires_grad_()
    ref.moe_dispatch(x2, src).backward(g)
    torch.testing.assert_close(x1.grad.float(), x2.grad.float(), **GRAD_TOLS[torch.bfloat16])


def _blocks_case(rng, dev, dtype, e, k, n, counts):
    """A dropless block layout: expert e owns ceil(counts[e] / 8) tiles with
    zero padding rows, plus 3 trailing zero tiles clipped to the last expert."""
    be, rows = [], []
    for ei, c in enumerate(counts):
        tiles = -(-c // 8)
        be += [ei] * tiles
        blk = np.zeros((tiles * 8, k), np.float32)
        blk[:c] = rng.standard_normal((c, k))
        rows.append(blk)
    be += [e - 1] * 3
    rows.append(np.zeros((24, k), np.float32))
    x = torch.from_numpy(np.concatenate(rows).reshape(-1, 8, k)).to(dev, dtype)
    w = torch.from_numpy(rng.standard_normal((e, k, n)).astype(np.float32) / k**0.5).to(dev, dtype)
    return x, w, torch.tensor(be, dtype=torch.int32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", [(64, 192), (136, 40)])
def test_grouped_matmul_blocks_kernel_and_backward(dev, dtype, k, n):
    rng = np.random.default_rng(k + n)
    counts = [100, 0, 9, 64, 1]  # two runs, an empty expert, ragged tails
    x, w, be = _blocks_case(rng, dev, dtype, len(counts), k, n, counts)
    got = grouped_matmul_blocks_cuda(x, w, be)
    want = ref.grouped_matmul_blocks(x, w, be)
    torch.testing.assert_close(got.float(), want.float(), **TOLS[dtype])
    g = torch.randn(got.shape, device=dev).to(dtype)
    x1, w1 = x.clone().requires_grad_(), w.clone().requires_grad_()
    GroupedMatmulBlocksFn.apply(x1, w1, be).backward(g)
    x2, w2 = x.clone().requires_grad_(), w.clone().requires_grad_()
    ref.grouped_matmul_blocks(x2, w2, be).backward(g)
    torch.testing.assert_close(x1.grad.float(), x2.grad.float(), **GRAD_TOLS[dtype])
    torch.testing.assert_close(w1.grad.float(), w2.grad.float(), **GRAD_TOLS[dtype])
    assert torch.equal(w1.grad[1], torch.zeros_like(w1.grad[1]))  # no tiles, zero gradient


def _capacity_case(dev, dtype, e, c, k, n, seed):
    """Capacity buffers ``x [E, C, K]`` with empty slots (zero rows) and, for
    E > 1, expert 1 wholly empty; weights ``[E, K, N]`` and a cotangent."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, k)).astype(np.float32)
    x[:, c - c // 4:] = 0  # the tail of every buffer is unfilled
    if e > 1:
        x[1] = 0
    w = rng.standard_normal((e, k, n)).astype(np.float32) / k**0.5
    dy = rng.standard_normal((e, c, n)).astype(np.float32)
    return (torch.from_numpy(a).to(dev, dtype) for a in (x, w, dy))


# C in {4, 12, 20, 200} (and 260: two row chunks of one expert), E = 1,
# K and N multiples of 8 that are not multiples of the 32 / 64 tiles.
CAPACITY_CASES = [(3, 4, 64, 192), (3, 12, 72, 136), (1, 20, 40, 200), (3, 200, 136, 72),
                  (2, 260, 64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,k,n", CAPACITY_CASES)
def test_grouped_matmul_capacity_kernel(dev, dtype, e, c, k, n):
    x, w, _ = _capacity_case(dev, dtype, e, c, k, n, c + k)
    got = grouped_matmul_cuda(x, w)
    torch.testing.assert_close(got.float(), ref.grouped_matmul(x, w).float(), **TOLS[dtype])
    if e > 1:
        assert not got[1].any()  # an empty expert's rows stay exactly 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,k,n", CAPACITY_CASES)
def test_grouped_matmul_capacity_dx(dev, dtype, e, c, k, n):
    x, w, dy = _capacity_case(dev, dtype, e, c, k, n, c + n)
    want, _ = ref.grouped_matmul_bwd(x, w, dy)
    got = grouped_matmul_dx_cuda(dy, w)
    torch.testing.assert_close(got.float(), want.float(), **GRAD_TOLS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,k,n", CAPACITY_CASES)
def test_grouped_matmul_capacity_dw_and_autograd(dev, dtype, e, c, k, n):
    x, w, dy = _capacity_case(dev, dtype, e, c, k, n, c * k)
    got = grouped_matmul_dw_cuda(x, dy)
    _, want = ref.grouped_matmul_bwd(x, w, dy)
    torch.testing.assert_close(got.float(), want.float(), **GRAD_TOLS[dtype])
    if e > 1:
        assert not got[1].any()  # no filled rows, zero gradient
    x1, w1 = x.clone().requires_grad_(), w.clone().requires_grad_()
    GroupedMatmulFn.apply(x1, w1).backward(dy)
    x2, w2 = x.clone().requires_grad_(), w.clone().requires_grad_()
    ref.grouped_matmul(x2, w2).backward(dy)
    torch.testing.assert_close(x1.grad.float(), x2.grad.float(), **GRAD_TOLS[dtype])
    torch.testing.assert_close(w1.grad.float(), w2.grad.float(), **GRAD_TOLS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("t,e,k", [(37, 8, 2), (45, 160, 6)])
def test_topk_gating_backward(dev, t, e, k):
    g = torch.Generator(device=dev).manual_seed(t)
    logits = torch.randn((t, e), generator=g, device=dev)
    dw = torch.randn((t, k), generator=g, device=dev)
    l1 = logits.clone().requires_grad_()
    TopkGatingFn.apply(l1, k)[0].backward(dw)
    l2 = logits.clone().requires_grad_()
    ref.topk_gating(l2, k)[0].backward(dw)
    torch.testing.assert_close(l1.grad, l2.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=33, softcap=30.0),
                                dict(causal=False)])
def test_flash_attention_backward(dev, dtype, d, kw):
    g = torch.Generator(device=dev).manual_seed(d)
    q = torch.randn((2, 8, 77, d), generator=g, device=dev).to(dtype)
    k = torch.randn((2, 2, 77, d), generator=g, device=dev).to(dtype)
    v = torch.randn((2, 2, 77, d), generator=g, device=dev).to(dtype)
    do = torch.randn((2, 8, 77, d), generator=g, device=dev).to(dtype)
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    FlashAttentionFn.apply(*a, kw.get("causal", True), kw.get("window"), kw.get("softcap")) \
        .backward(do)
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    ref.flash_attention(*b, **kw).backward(do)
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad.float(), y.grad.float(), **GRAD_TOLS[dtype])


@pytest.mark.cuda
def test_paged_decode_refuses_grad(dev):
    q = torch.zeros((1, 1, 2, 64), device=dev, requires_grad=True)
    pool = torch.zeros((2, 8, 2, 64), device=dev)
    table = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    t = torch.zeros((1,), dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        paged_flash_decode_cuda(q, pool, pool, table, t)
    with torch.no_grad():
        paged_flash_decode_cuda(q, pool, pool, table, t)


# ---------------------------------------------------------------------------
# Mamba-2 kernels: RMSNorm (kernel 8) and the SSD intra-chunk pass (kernel
# 9).  RMSNorm sums squares in f32 in another order and rounds once:
# torch.testing's dtype defaults.  The SSD pass sums over N and up to L
# gated terms in f32 in another order, with its own cumulative sum: within
# 1e-4 of the largest magnitude.  Neither has a backward kernel yet: on the
# card the ops refuse a gradient.
# ---------------------------------------------------------------------------

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm_cuda  # noqa: E402
from repro_torch.kernels.ssd_chunk import ssd_chunk_cuda  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d", [(1, 48), (257, 48), (256, 2048), (256, 4096), (4, 4096), (3, 8)])
def test_rmsnorm_kernel(dev, dtype, t, d):
    g = torch.Generator(device=dev).manual_seed(t + d)
    x = (torch.randn((t, d), generator=g, device=dev) * 3).to(dtype)
    w = (torch.randn((d,), generator=g, device=dev) * 0.1).to(dtype)
    got = rmsnorm_cuda(x, w, 1e-6)
    assert got.dtype == dtype
    torch.testing.assert_close(got, ref.rmsnorm(x, w, 1e-6))


def _ssd_case(dev, groups, heads, l, p, n, fill, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.nn.functional.softplus(torch.randn((groups, l), generator=g, device=dev))
    x = torch.randn((groups, l, p), generator=g, device=dev) * dt[:, :, None]
    da = -dt if fill is None else torch.full((groups, l), float(fill), device=dev)
    bm = torch.randn((groups // heads, l, n), generator=g, device=dev)
    cm = torch.randn((groups // heads, l, n), generator=g, device=dev)
    return x, da, bm, cm


@pytest.mark.cuda
@pytest.mark.parametrize("groups,heads,l,p,n,fill", [
    (1, 1, 1, 64, 128, None), (3, 3, 3, 64, 128, None), (5, 5, 16, 16, 16, None),
    (6, 2, 100, 72, 100, None), (3, 1, 256, 64, 128, None), (128, 64, 256, 64, 128, None),
    (4, 4, 256, 64, 128, 0.0), (4, 4, 100, 64, 128, -30.0), (2, 2, 256, 64, 128, -40.0),
    (7, 7, 37, 33, 5, None),
])
def test_ssd_chunk_kernel(dev, groups, heads, l, p, n, fill):
    """fill = -40: above the diagonal the decay overflows, which only the
    mask may hide; no NaN or inf may come out."""
    x, da, bm, cm = _ssd_case(dev, groups, heads, l, p, n, fill, seed=l + groups)
    y, st = ssd_chunk_cuda(x, da, bm, cm, heads)
    wy, wst = ref.ssd_chunk(x, da, bm.repeat_interleave(heads, 0), cm.repeat_interleave(heads, 0))
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    for got, want in ((y, wy), (st, wst)):
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item() + 1e-6, err


@pytest.mark.cuda
def test_ssm_ops_refuse_grad_and_wrappers_refuse_bad_inputs(dev):
    x = torch.randn((4, 64), device=dev, requires_grad=True)
    w = torch.zeros((64,), device=dev)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.rmsnorm(x, w)
    with torch.no_grad():
        ops.rmsnorm(x, w)
    xs, da, bm, cm = _ssd_case(dev, 2, 2, 8, 16, 16, None, seed=0)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd_chunk(xs.requires_grad_(), da, bm, cm, heads=2)
    with pytest.raises(ValueError):
        rmsnorm_cuda(torch.zeros((2, 10), device=dev), torch.zeros((10,), device=dev))  # D % 4
    with pytest.raises(ValueError):
        rmsnorm_cuda(torch.zeros((2, 4100), device=dev), torch.zeros((4100,), device=dev))
    with pytest.raises(TypeError):
        rmsnorm_cuda(torch.zeros((2, 16), device=dev), torch.zeros((16,), device=dev,
                                                                    dtype=torch.bfloat16))
    z = torch.zeros((2, 8, 16), device=dev)
    with pytest.raises(ValueError):
        ssd_chunk_cuda(z, torch.zeros((2, 8), device=dev), torch.zeros((1, 8, 129), device=dev),
                       torch.zeros((1, 8, 129), device=dev), 2)  # N > 128
    with pytest.raises(ValueError):
        ssd_chunk_cuda(z, torch.zeros((2, 8), device=dev), z[:1], z[:1], 3)  # G % heads
    with pytest.raises(TypeError):
        ssd_chunk_cuda(z.bfloat16(), torch.zeros((2, 8), device=dev), z[:1], z[:1], 2)
