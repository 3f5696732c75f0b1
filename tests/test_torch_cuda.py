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

import threading

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


# Head dims: the kernels' widths (multiples of 32 up to 256) and dims the
# wrappers zero-pad to them (40 -> 64, 200 -> 224).
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 40, 64, 96, 128, 192, 200, 256])
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 40, 96, 192])
def test_paged_flash_decode_head_dims(dev, dtype, d):
    g = torch.Generator(device=dev).manual_seed(d)
    lengths = [37, 20, 3]
    table = _table(lengths, 2, 8, 7, 30, seed=d).to(dev)
    t = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn((3, 2, 6, d), generator=g, device=dev).to(dtype)
    kp = torch.randn((30, 8, 2, d), generator=g, device=dev).to(dtype)
    vp = torch.randn((30, 8, 2, d), generator=g, device=dev).to(dtype)
    for kw in ({}, dict(window=12, softcap=25.0)):
        got = paged_flash_decode_cuda(q, kp, vp, table, t, **kw)
        assert got.shape == q.shape and got.is_contiguous()
        torch.testing.assert_close(got.float(), ref.paged_flash_decode(q, kp, vp, table, t, **kw)
                                   .float(), **TOLS[dtype])


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.zeros((4, 8), device=dev, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        topk_gating_cuda(x, 2)
    for d in (36, 264):  # not a multiple of 8; above 256
        q = torch.zeros((1, 2, 8, d), device=dev)
        with pytest.raises(ValueError):
            flash_attention_cuda(q, q, q)
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

from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttentionFn, flash_attention_bwd_cuda,
)
from repro_torch.kernels.grouped_matmul import (  # noqa: E402
    GroupedMatmulBlocksFn, GroupedMatmulFn, grouped_matmul_blocks_cuda,
    grouped_matmul_blocks_dw_cuda, grouped_matmul_blocks_dx_cuda, grouped_matmul_cuda,
    grouped_matmul_dw_cuda, grouped_matmul_dx_cuda,
)
from repro_torch.kernels.moe_dispatch import (  # noqa: E402
    MoECombineFn, MoEDispatchFn, moe_combine_bwd_cuda, moe_combine_cuda, moe_dispatch_cuda,
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


# ---------------------------------------------------------------------------
# kernels 4 and 5 at every shape of Mixtral-8x7B's dropless step, and across
# widths, term counts, alignments and sizes.  The gathers only move bits;
# the combine sums its terms in order in f32 with one rounding per product
# and per sum, so it is bit-identical to the in-order loop below (each torch
# op rounds once); dy is one product rounded once.  Only dw, a dot product
# summed in another order than the plain version's, has a tolerance
# (f32: 1e-4 relative and absolute, as GRAD_TOLS).  Every output is equal bit
# for bit across two calls: no atomics.
# ---------------------------------------------------------------------------

MOE_WIDTHS = [5, 33, 96, 4096, 4100, 14336]


def _combine_in_order(y, slot, w, out_dtype=torch.float32):
    acc = torch.zeros((slot.shape[0], y.shape[1]), device=y.device)
    for s in range(slot.shape[1]):
        ok = ((slot[:, s] >= 0) & (slot[:, s] < y.shape[0]))[:, None]
        term = w[:, s, None] * y[slot[:, s].clamp(0, y.shape[0] - 1).long()].float()
        acc = torch.where(ok, acc + term, acc)
    return acc.to(out_dtype)


def _inverse(slot, p):
    """src [p]: the flat t * S + s term reading each row, -1 for none."""
    inv = torch.full((p,), -1, dtype=torch.int32, device=slot.device)
    flat = slot.reshape(-1).long()
    keep = flat >= 0
    inv[flat[keep]] = torch.arange(flat.numel(), device=slot.device, dtype=torch.int32)[keep]
    return inv


def _dy_want(dout, w, src, dtype):
    s = w.shape[1]
    f = src.clamp(min=0).long()
    dy = w.reshape(-1)[f][:, None] * dout[f // s]
    return torch.where((src >= 0)[:, None], dy, torch.zeros((), device=dout.device)).to(dtype)


def _check_combine_and_backward(y, slot, w, dtype):
    """The combine (f32 out, and bf16 out for bf16 rows) and its backward
    against their definitions, each twice."""
    p = y.shape[0]
    src = _inverse(slot, p)
    got = moe_combine_cuda(y, slot, w)
    assert torch.equal(got, _combine_in_order(y, slot, w))
    assert torch.equal(moe_combine_cuda(y, slot, w), got)
    dropped = (slot < 0).all(1)
    assert not got[dropped].any() and not got[dropped].signbit().any()
    if dtype == torch.bfloat16:
        got_b = moe_combine_cuda(y, slot, w, out_dtype=torch.bfloat16)
        assert torch.equal(got_b, got.to(torch.bfloat16))
        assert torch.equal(got_b, _combine_in_order(y, slot, w, torch.bfloat16))
    g = torch.randn(got.shape, device=y.device)
    dy, dw = moe_combine_bwd_cuda(g, y, slot, w, src)
    assert torch.equal(dy, _dy_want(g, w, src, dtype))
    assert not dy[src < 0].any()
    _, want_dw = ref.moe_combine_bwd(g, y, slot, w, src)
    torch.testing.assert_close(dw, want_dw, **GRAD_TOLS[torch.float32])
    assert not dw[slot < 0].any()
    dy2, dw2 = moe_combine_bwd_cuda(g, y, slot, w, src)
    assert torch.equal(dy2, dy) and torch.equal(dw2, dw)
    dy3, none = moe_combine_bwd_cuda(g, y, slot, w, src, need_dw=False)
    assert none is None and torch.equal(dy3, dy)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", MOE_WIDTHS)
def test_moe_dispatch_kernel_widths(dev, dtype, d):
    rng = np.random.default_rng(d + 1)
    x = torch.from_numpy(rng.standard_normal((300, d)).astype(np.float32)).to(dev, dtype)
    src = _src(rng, 300, 700, 0.2).to(dev)  # many-to-one, with -1 rows
    got = moe_dispatch_cuda(x, src)
    assert torch.equal(got, ref.moe_dispatch(x, src))
    assert torch.equal(moe_dispatch_cuda(x, src), got)
    assert not got[src < 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("d", MOE_WIDTHS)
def test_moe_combine_in_order_and_backward(dev, dtype, s, d):
    rng = np.random.default_rng(100 * s + d)
    t = 97
    p = t * s + 19  # 19 rows no term reads
    y = torch.from_numpy(rng.standard_normal((p, d)).astype(np.float32)).to(dev, dtype)
    slot = rng.permutation(p)[: t * s].reshape(t, s)
    slot = np.where(rng.random((t, s)) < 0.25, -1, slot)
    slot[0] = -1  # a fully dropped row
    w = torch.from_numpy(rng.standard_normal((t, s)).astype(np.float32)).to(dev)
    _check_combine_and_backward(y, torch.from_numpy(slot.astype(np.int32)).to(dev), w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_kernels_many_rows(dev, dtype):
    """8192 tokens top-2 at D = 4096: the gathers' CTAs loop over many rows,
    the combine runs several waves."""
    g = torch.Generator(device=dev).manual_seed(8192)
    t, s, d = 8192, 2, 4096
    p = t * s + 100
    x = torch.randn((t, d), generator=g, device=dev).to(dtype)
    src = torch.randint(-1, t, (p,), generator=g, device=dev, dtype=torch.int32)
    assert torch.equal(moe_dispatch_cuda(x, src), ref.moe_dispatch(x, src))
    y = torch.randn((p, d), generator=g, device=dev).to(dtype)
    slot = torch.randperm(p, generator=g, device=dev)[: t * s].reshape(t, s).to(torch.int32)
    slot[torch.rand((t, s), generator=g, device=dev) < 0.1] = -1
    w = torch.rand((t, s), generator=g, device=dev)
    _check_combine_and_backward(y, slot, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_kernels_off_alignment(dev, dtype):
    """Contiguous views one element past a 16-byte boundary: the gather's
    narrower vector paths and the one-element combine and backward."""
    rng = np.random.default_rng(17)
    t, s, d = 61, 2, 4096
    p = t * s + 7

    def shifted(a):
        buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=dev)
        view = buf[1:].view(a.shape)
        view.copy_(a)
        return view

    x = shifted(torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32)).to(dev, dtype))
    src = _src(rng, t, p, 0.2).to(dev)
    assert x.data_ptr() % 16 and x.is_contiguous()
    assert torch.equal(moe_dispatch_cuda(x, src), ref.moe_dispatch(x, src))
    y = shifted(torch.from_numpy(rng.standard_normal((p, d)).astype(np.float32)).to(dev, dtype))
    slot = rng.permutation(p)[: t * s].reshape(t, s)
    slot = np.where(rng.random((t, s)) < 0.25, -1, slot)
    w = torch.from_numpy(rng.random((t, s)).astype(np.float32)).to(dev)
    _check_combine_and_backward(y, torch.from_numpy(slot.astype(np.int32)).to(dev), w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["gather", "combine"])
def test_moe_kernels_past_2_31_accesses(dev, kernel):
    """Outputs of more than 2^31 accesses, where the gather and the combine
    index with 64-bit integers: the gather's 2-byte path (rows of 3 bf16)
    and the one-element combine (D = 33), checked in slices against their
    definitions."""
    g = torch.Generator(device=dev).manual_seed(31)
    if kernel == "gather":
        rows = 1 << 26
        t, d = 64, 3
        p = (1 << 31) // d + 4096
        x = torch.randn((t, d), generator=g, device=dev).bfloat16()
        src = torch.randint(-1, t, (p,), generator=g, device=dev, dtype=torch.int32)
        got = moe_dispatch_cuda(x, src)
        assert got.numel() > 1 << 31
        for a in range(0, p, rows):
            assert torch.equal(got[a:a + rows], ref.moe_dispatch(x, src[a:a + rows]))
    else:
        rows = 1 << 24
        p, d = 64, 33
        t = (1 << 31) // d + 4096
        y = torch.randn((p, d), generator=g, device=dev).bfloat16()
        slot = torch.randint(-1, p, (t, 1), generator=g, device=dev, dtype=torch.int32)
        w = torch.rand((t, 1), generator=g, device=dev)
        got = moe_combine_cuda(y, slot, w)
        assert got.numel() > 1 << 31
        for a in range(0, t, rows):
            assert torch.equal(got[a:a + rows], _combine_in_order(y, slot[a:a + rows],
                                                                    w[a:a + rows]))


def _mixtral_plans(dev, cf=None):
    """The send gather's sources and the two dispatch plans of Mixtral's
    step at P = 1 (T = 512 top-2 over 8 experts), as _moe_mixnet_local
    builds them; ``cf``: a stage-1 capacity factor that drops choices."""
    from repro_torch.models import routing

    t, e, k = 512, 8, 2
    n = t * k
    g = torch.Generator(device=dev).manual_seed(11)
    info = routing.compute_routing(torch.randn((t, e), generator=g, device=dev), top_k=k,
                                   num_virtual=e, replication=1)
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    rank1, _ = routing.bucket_ranks(zeros, 1)
    cp = n if cf is None else routing.capacity(t, k, 1, cf)
    plan1 = routing.capacity_plan(zeros, rank1, None if cf is None else rank1 < cp, 1, cp)
    src_tok = torch.where(plan1.src >= 0, plan1.src // k, torch.full_like(plan1.src, -1))
    local_e = torch.where(plan1.src >= 0, info.vdest.reshape(n)[plan1.src.clamp(0, n - 1).long()],
                          torch.full_like(plan1.src, -1)).to(torch.int32)
    valid = local_e >= 0
    rank2, counts2 = routing.bucket_ranks(local_e, e, valid=valid)
    plan2 = routing.dropless_plan(local_e, rank2, counts2, valid, e, 8)
    return info.wfull.float().contiguous(), plan1, src_tok, plan2


@pytest.mark.cuda
@pytest.mark.parametrize("call", ["send", "pack", "unpack", "combine_f32", "combine_bf16",
                                  "combine_bwd"])
def test_moe_kernels_main_path_shapes(dev, call):
    w, plan1, src_tok, plan2 = _mixtral_plans(dev)
    t, k = w.shape
    d = 4096
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((t, d), generator=g, device=dev).bfloat16()
    sent = moe_dispatch_cuda(x, src_tok)
    packed = moe_dispatch_cuda(sent, plan2.src)
    slot = plan1.slot.reshape(t, k)
    if call == "send":
        got, want = sent, ref.moe_dispatch(x, src_tok)
        assert got.shape == (t * k, d)
    elif call == "pack":
        got, want = packed, ref.moe_dispatch(sent, plan2.src)
        assert got.shape[0] > t * k and not got[plan2.src < 0].any()
    elif call == "unpack":
        got, want = moe_dispatch_cuda(packed, plan2.slot), sent
    elif call == "combine_f32":
        got = moe_combine_cuda(sent, slot, w)
        want = _combine_in_order(sent, slot, w)
    elif call == "combine_bf16":  # the send gather's backward: unit weights, bf16 out
        ones = torch.ones_like(w)
        got = moe_combine_cuda(sent, slot, ones, out_dtype=torch.bfloat16)
        want = _combine_in_order(sent, slot, ones, torch.bfloat16)
    else:
        _check_combine_and_backward(sent, slot, w, torch.bfloat16)
        return
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_moe_combine_backward_on_a_dropping_plan(dev):
    """A stage-1 capacity that drops choices (slot -1) and leaves no send row
    empty, then the dropless stage 2 with its padding rows: the backward's
    precondition (slot and src exact inverses) holds for both plans."""
    w, plan1, src_tok, plan2 = _mixtral_plans(dev, cf=0.75)
    t, k = w.shape
    slot = plan1.slot.reshape(t, k)
    assert (slot < 0).any() and (plan2.src < 0).any()
    assert torch.equal(_inverse(slot, plan1.src.shape[0]), plan1.src)
    g = torch.Generator(device=dev).manual_seed(13)
    y = torch.randn((plan1.src.shape[0], 256), generator=g, device=dev).bfloat16()
    _check_combine_and_backward(y, slot, w, torch.bfloat16)
    # stage 2 read as a combine over S = 1: packed rows by choice, padding unread
    yp = torch.randn((plan2.src.shape[0], 256), generator=g, device=dev).bfloat16()
    slot2 = plan2.slot.reshape(-1, 1)
    assert torch.equal(_inverse(slot2, yp.shape[0]), plan2.src)
    _check_combine_and_backward(yp, slot2, torch.rand(slot2.shape, generator=g, device=dev),
                                torch.bfloat16)


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


# Dropless plans at the bf16 kernels' tile edges: experts of 300 and 257
# rows (two 256-row runs each), every row in one expert, empty experts,
# ragged tails, K and N multiples of 8 off the 64-deep / 128-wide tiles, and
# the main path's K = 4096 with ~135 rows an expert.
BLOCKS_CASES = [([300, 0, 9, 257, 1], 72, 136), ([1024], 64, 192), ([0, 0, 700, 0], 136, 40),
                ([135, 120, 140, 128, 130, 137, 131, 123], 4096, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("counts,k,n", BLOCKS_CASES)
def test_grouped_matmul_blocks_tile_edges(dev, dtype, counts, k, n):
    rng = np.random.default_rng(sum(counts) + k + n)
    x, w, be = _blocks_case(rng, dev, dtype, len(counts), k, n, counts)
    got = grouped_matmul_blocks_cuda(x, w, be)
    torch.testing.assert_close(got.float(), ref.grouped_matmul_blocks(x, w, be).float(),
                               **TOLS[dtype])
    dy = torch.from_numpy(rng.standard_normal(got.shape).astype(np.float32)).to(dev, dtype)
    x1, w1 = x.clone().requires_grad_(), w.clone().requires_grad_()
    GroupedMatmulBlocksFn.apply(x1, w1, be).backward(dy)
    x2, w2 = x.clone().requires_grad_(), w.clone().requires_grad_()
    ref.grouped_matmul_blocks(x2, w2, be).backward(dy)
    torch.testing.assert_close(x1.grad.float(), x2.grad.float(), **GRAD_TOLS[dtype])
    torch.testing.assert_close(w1.grad.float(), w2.grad.float(), **GRAD_TOLS[dtype])
    for e, c in enumerate(counts):
        if c == 0:
            assert not w1.grad[e].any()  # no rows: exact zeros


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_blocks_many_experts(dev, dtype):
    """More experts than the kernels' shared-memory table of first tiles
    (4095): each block finds its rows by binary search instead."""
    counts = [0] * 5000
    for e, c in ((0, 20), (1, 300), (2345, 9), (4999, 64)):
        counts[e] = c
    rng = np.random.default_rng(5000)
    x, w, be = _blocks_case(rng, dev, dtype, len(counts), 64, 128, counts)
    got = grouped_matmul_blocks_cuda(x, w, be)
    torch.testing.assert_close(got.float(), ref.grouped_matmul_blocks(x, w, be).float(),
                               **TOLS[dtype])
    dy = torch.from_numpy(rng.standard_normal(got.shape).astype(np.float32)).to(dev, dtype)
    want_dx, want_dw = ref.grouped_matmul_blocks_bwd(x, w, be, dy)
    torch.testing.assert_close(grouped_matmul_blocks_dx_cuda(dy, w, be).float(), want_dx.float(),
                               **GRAD_TOLS[dtype])
    dw = grouped_matmul_blocks_dw_cuda(x, dy, be, len(counts))
    torch.testing.assert_close(dw.float(), want_dw.float(), **GRAD_TOLS[dtype])
    assert not dw[3].any()


def _blocks_in_order(blocks, order):
    """The dropless layout of per-expert row blocks with expert ``order[i]``
    relabelled i: each expert's rows zero-padded to whole tiles, tiles in
    label order, ``be`` sorted."""
    rows, be = [], []
    for i, e in enumerate(order):
        c, width = blocks[e].shape
        tiles = -(-c // 8)
        blk = np.zeros((tiles * 8, width), np.float32)
        blk[:c] = blocks[e]
        rows.append(blk)
        be += [i] * tiles
    return np.concatenate(rows), np.asarray(be, np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("counts,k,n", [BLOCKS_CASES[0], BLOCKS_CASES[3]])
def test_grouped_matmul_blocks_bf16_bit_identical_and_expert_permutation(dev, counts, k, n):
    """No atomics and no split of a reduction: two calls agree bit for bit,
    and permuting the experts (their tiles moved, be relabelled in sorted
    order) moves the forward, dX and dW results bit for bit."""
    rng = np.random.default_rng(k * n)
    e = len(counts)
    xs = [rng.standard_normal((c, k)).astype(np.float32) for c in counts]
    dys = [rng.standard_normal((c, n)).astype(np.float32) for c in counts]
    w = torch.from_numpy(rng.standard_normal((e, k, n)).astype(np.float32) / k**0.5).to(
        dev, torch.bfloat16)

    def run(order):
        xa, be = _blocks_in_order(xs, order)
        dya, _ = _blocks_in_order(dys, order)
        x = torch.from_numpy(xa.reshape(-1, 8, k)).to(dev, torch.bfloat16)
        dy = torch.from_numpy(dya.reshape(-1, 8, n)).to(dev, torch.bfloat16)
        be = torch.from_numpy(be).to(dev)
        wp = w[list(order)].contiguous()
        return (grouped_matmul_blocks_cuda(x, wp, be), grouped_matmul_blocks_dx_cuda(dy, wp, be),
                grouped_matmul_blocks_dw_cuda(x, dy, be, e))

    ident = list(range(e))
    first, again = run(ident), run(ident)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    order = [(3 * i + 1) % e for i in range(e)]
    moved = run(order)
    tiles = [-(-c // 8) for c in counts]
    start = np.concatenate([[0], np.cumsum(tiles)])
    at = 0
    for i, old in enumerate(order):
        t = tiles[old]
        for a, b in zip(moved[:2], first[:2]):
            assert torch.equal(a[at:at + t], b[start[old]:start[old] + t])
        assert torch.equal(moved[2][i], first[2][old])
        at += t


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


# C in {4, 12, 20, 200} (and 260, 300: two row chunks of one expert), E = 1,
# K and N multiples of 8 that are not multiples of the tiles (64 deep, 64
# or 128 wide), and the main path's C = 200 at K = 4096.
CAPACITY_CASES = [(3, 4, 64, 192), (3, 12, 72, 136), (1, 20, 40, 200), (3, 200, 136, 72),
                  (2, 260, 64, 64), (2, 300, 136, 200), (8, 200, 4096, 1024)]
# bf16 cases for the invariances the training path relies on.
INVARIANCE_CASES = [(3, 200, 136, 72), (2, 300, 136, 200), (8, 200, 4096, 1024)]


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
@pytest.mark.parametrize("e,c,k,n", INVARIANCE_CASES)
def test_grouped_matmul_capacity_bf16_bit_identical(dev, e, c, k, n):
    """No atomics and no split of K: two calls agree bit for bit."""
    x, w, dy = _capacity_case(dev, torch.bfloat16, e, c, k, n, c + k + n)
    assert torch.equal(grouped_matmul_cuda(x, w), grouped_matmul_cuda(x, w))
    assert torch.equal(grouped_matmul_dx_cuda(dy, w), grouped_matmul_dx_cuda(dy, w))
    assert torch.equal(grouped_matmul_dw_cuda(x, dy), grouped_matmul_dw_cuda(x, dy))


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,k,n", INVARIANCE_CASES)
def test_grouped_matmul_capacity_bf16_expert_permutation(dev, e, c, k, n):
    """An expert's rows do not depend on its slot: permuting the experts
    permutes the forward, dX and dW outputs bit for bit (re-placement)."""
    x, w, dy = _capacity_case(dev, torch.bfloat16, e, c, k, n, c * n + k)
    perm = torch.arange(e - 1, -1, -1, device=dev)
    xp, wp, dyp = (t[perm].contiguous() for t in (x, w, dy))
    assert torch.equal(grouped_matmul_cuda(xp, wp), grouped_matmul_cuda(x, w)[perm])
    assert torch.equal(grouped_matmul_dx_cuda(dyp, wp), grouped_matmul_dx_cuda(dy, w)[perm])
    assert torch.equal(grouped_matmul_dw_cuda(xp, dyp), grouped_matmul_dw_cuda(x, dy)[perm])


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
@pytest.mark.parametrize("d", [32, 40, 64, 96, 128, 192, 256])
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


# Many key tiles and a ragged tail (S = 1000) at grok-1's group of 6 (48 / 8
# heads) and Mixtral's group of 4 (32 / 8), D = 128, bf16.
@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv", [(48, 8), (32, 8)])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=True, window=300, softcap=30.0),
                                dict(causal=False)])
def test_flash_attention_long_sequence_bf16(dev, hq, hkv, kw):
    g = torch.Generator(device=dev).manual_seed(hq)
    s, d = 1000, 128
    q = torch.randn((1, hq, s, d), generator=g, device=dev).bfloat16()
    k = torch.randn((1, hkv, s, d), generator=g, device=dev).bfloat16()
    v = torch.randn((1, hkv, s, d), generator=g, device=dev).bfloat16()
    do = torch.randn((1, hq, s, d), generator=g, device=dev).bfloat16()
    got = flash_attention_cuda(q, k, v, **kw)
    torch.testing.assert_close(got.float(), ref.flash_attention(q, k, v, **kw).float(),
                               **TOLS[torch.bfloat16])
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    FlashAttentionFn.apply(*a, kw.get("causal", True), kw.get("window"), kw.get("softcap")) \
        .backward(do)
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    ref.flash_attention(*b, **kw).backward(do)
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad.float(), y.grad.float(), **GRAD_TOLS[torch.bfloat16])


# No atomics: two calls on the same inputs agree bit for bit, forward (with
# the log-sum-exp) and backward, at three kernel widths.
@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_attention_bf16_bit_identical(dev, d):
    g = torch.Generator(device=dev).manual_seed(d)
    q = torch.randn((2, 12, 300, d), generator=g, device=dev).bfloat16()
    k = torch.randn((2, 2, 300, d), generator=g, device=dev).bfloat16()
    v = torch.randn((2, 2, 300, d), generator=g, device=dev).bfloat16()
    do = torch.randn((2, 12, 300, d), generator=g, device=dev).bfloat16()
    runs = []
    for _ in range(2):
        out, lse = flash_attention_cuda(q, k, v, causal=True, return_lse=True)
        runs.append((out, lse, *flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=True)))
    for x, y in zip(*runs):
        assert torch.equal(x, y)


# The TMA maps are encoded on the calling thread.  A thread that has not yet
# used the CUDA runtime has no current context (PyTorch runs backward
# functions on such a worker thread); the kernels must not depend on one.
@pytest.mark.cuda
def test_flash_attention_bf16_from_a_fresh_thread(dev):
    g = torch.Generator(device=dev).manual_seed(7)
    q, do = (torch.randn((1, 4, 130, 128), generator=g, device=dev).bfloat16() for _ in "qd")
    k, v = (torch.randn((1, 2, 130, 128), generator=g, device=dev).bfloat16() for _ in "kv")
    out, lse = flash_attention_cuda(q, k, v, return_lse=True)
    want = (out, lse, *flash_attention_bwd_cuda(q, k, v, out, lse, do))
    got = {}

    def run():
        o, l = flash_attention_cuda(q, k, v, return_lse=True)
        got["run"] = (o, l, *flash_attention_bwd_cuda(q, k, v, o, l, do))

    worker = threading.Thread(target=run)
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive() and "run" in got
    for x, y in zip(want, got["run"]):
        assert torch.equal(x, y)


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
@pytest.mark.parametrize("t,d", [(1, 48), (257, 48), (256, 2048), (256, 4096), (4, 4096), (3, 8),
                                 (4, 8192), (5, 12288), (3, 16384), (2, 40000)])
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
    assert ops.rmsnorm(x, w).requires_grad  # the ungated norm has its backward kernel
    with pytest.raises(RuntimeError, match="no backward"):
        ops.rmsnorm(x, w, gate=torch.zeros_like(x))
    with torch.no_grad():
        ops.rmsnorm(x, w, gate=torch.zeros_like(x))
    xs, da, bm, cm = _ssd_case(dev, 2, 2, 8, 16, 16, None, seed=0)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd_chunk(xs.requires_grad_(), da, bm, cm, heads=2)
    with pytest.raises(ValueError):
        rmsnorm_cuda(torch.zeros((2, 10), device=dev), torch.zeros((10,), device=dev))  # D % 4
    with pytest.raises(ValueError):
        rmsnorm_cuda(torch.zeros((2, 0), device=dev), torch.zeros((0,), device=dev))  # D = 0
    with pytest.raises(TypeError):
        rmsnorm_cuda(torch.zeros((2, 16), device=dev), torch.zeros((16,), device=dev,
                                                                    dtype=torch.bfloat16))
    with pytest.raises(ValueError):  # a gate of another shape
        rmsnorm_cuda(torch.zeros((2, 16), device=dev), torch.zeros((16,), device=dev),
                     gate=torch.zeros((2, 8), device=dev))
    z = torch.zeros((2, 8, 16), device=dev)
    with pytest.raises(ValueError):
        ssd_chunk_cuda(z, torch.zeros((2, 8), device=dev), torch.zeros((1, 8, 129), device=dev),
                       torch.zeros((1, 8, 129), device=dev), 2)  # N > 128
    with pytest.raises(ValueError):
        ssd_chunk_cuda(z, torch.zeros((2, 8), device=dev), z[:1], z[:1], 3)  # G % heads
    with pytest.raises(TypeError):
        ssd_chunk_cuda(z.bfloat16(), torch.zeros((2, 8), device=dev), z[:1], z[:1], 2)


# ---------------------------------------------------------------------------
# Kernel 9 at the serving path's shapes and its edges: the prefill (one
# chunk of 64 heads) and generate (8 chunks) shapes, the Mamba-2 serve's
# short prefills (L = 8, 20, 44 at 64 heads), L from 1 to two passes
# of 256 rows, G = 1, odd G and odd head counts, N and P off the tiles,
# da = -40 a step, and two calls bit-identical.  Tolerance as above.
# ---------------------------------------------------------------------------

_SSD_SHAPES = (
    [(64, 64, 256, 64, 128, None), (512, 64, 256, 64, 128, None)]
    + [(64, 64, l, 64, 128, None) for l in (8, 20, 44)]
    + [(gr, h, l, 64, 128, None) for l in (1, 3, 100, 256) for gr, h in ((1, 1), (5, 5), (9, 3))]
    + [(6, 3, 100, p, n, None) for n in (16, 100, 128) for p in (16, 64, 80)]
    + [(3, 3, 256, 64, 128, -40.0), (3, 3, 100, 80, 100, -40.0),
       (2, 1, 300, 64, 128, None), (3, 3, 513, 16, 16, -40.0)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("groups,heads,l,p,n,fill", _SSD_SHAPES)
def test_ssd_chunk_kernel_shapes(dev, groups, heads, l, p, n, fill):
    x, da, bm, cm = _ssd_case(dev, groups, heads, l, p, n, fill, seed=7 * l + n + p)
    y, st = ssd_chunk_cuda(x, da, bm, cm, heads)
    wy, wst = ref.ssd_chunk(x, da, bm.repeat_interleave(heads, 0), cm.repeat_interleave(heads, 0))
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    for got, want in ((y, wy), (st, wst)):
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item() + 1e-6, err


@pytest.mark.cuda
@pytest.mark.parametrize("groups,heads,l,p,n", [(64, 64, 256, 64, 128), (9, 3, 100, 80, 100)])
def test_ssd_chunk_kernel_bit_identical(dev, groups, heads, l, p, n):
    x, da, bm, cm = _ssd_case(dev, groups, heads, l, p, n, None, seed=l)
    y1, st1 = ssd_chunk_cuda(x, da, bm, cm, heads)
    y2, st2 = ssd_chunk_cuda(x, da, bm, cm, heads)
    assert torch.equal(y1, y2) and torch.equal(st1, st2)


@pytest.mark.cuda
def test_launch_shapes_count_each_launch_by_shape(dev):
    """Kernels 8, 9 and 3 count their launches by shape, (T, D), (G, L) and
    (B, C), and a reset clears those counts with the others."""
    ops.reset_launch_counts()
    x = torch.randn((3, 64), device=dev)
    for t in (3, 3, 5):
        rmsnorm_cuda(x.new_ones((t, 64)), x[0])
    xs, da, bm, cm = _ssd_case(dev, 4, 2, 8, 16, 16, None, seed=1)
    ssd_chunk_cuda(xs, da, bm, cm, 2)
    q, kp, vp, table, t = _paged_case(dev, [3, 9], 5, 8, 2, 4, 2, 64, torch.bfloat16, seed=1)
    paged_flash_decode_cuda(q, kp, vp, table, t)
    assert ops.launch_shapes() == {"rmsnorm": {(3, 64): 2, (5, 64): 1},
                                   "ssd_chunk": {(4, 8): 1}, "paged_flash_decode": {(2, 5): 1}}
    assert ops.launch_counts()["rmsnorm"] == 3
    ops.reset_launch_counts()
    assert ops.launch_shapes() == {"rmsnorm": {}, "ssd_chunk": {}, "paged_flash_decode": {}}


# ---------------------------------------------------------------------------
# Kernel 3 split across CTAs: lengths at t = 0, on and just past a page
# boundary (15, 16) and a split boundary (127, 128: 8 pages of 16 a split
# at a table of 64 pages), a window that crosses a split, softcap, C in
# {1, 3}, head dims 64, 72 (zero-padded to 96), 128 and 256 in bf16 and f32;
# -1 entries inside the context (read as page 0, as the plain version does)
# and past it; more splits than live pages; grok-1's long-context shape;
# two calls bit-identical.  Tolerances as above.
# ---------------------------------------------------------------------------


def _paged_case(dev, lengths, c, page, width, hq, hkv, d, dtype, seed, pages=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    pages = pages or len(lengths) * width
    table = _table(lengths, c, page, width, pages, seed).to(dev)
    t = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn((len(lengths), c, hq, d), generator=g, device=dev).to(dtype)
    kp = torch.randn((pages, page, hkv, d), generator=g, device=dev).to(dtype)
    vp = torch.randn((pages, page, hkv, d), generator=g, device=dev).to(dtype)
    return q, kp, vp, table, t


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 72, 128, 256])
@pytest.mark.parametrize("c", [1, 3])
def test_paged_flash_decode_split_edges(dev, dtype, d, c):
    q, kp, vp, table, t = _paged_case(dev, [0, 15, 16, 127, 128, 200], c, 16, 64, 12, 2, d,
                                      dtype, seed=d + c)
    for kw in ({}, dict(softcap=30.0), dict(window=100, softcap=30.0), dict(window=1)):
        got = paged_flash_decode_cuda(q, kp, vp, table, t, **kw)
        torch.testing.assert_close(got.float(), ref.paged_flash_decode(q, kp, vp, table, t, **kw)
                                   .float(), **TOLS[dtype], msg=lambda m, kw=kw: f"{kw}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_flash_decode_holes_and_idle_splits(dev, dtype):
    # -1 inside the context and past it; a length of 5 in a table of 64 pages.
    q, kp, vp, table, t = _paged_case(dev, [300, 5, 47, 160], 2, 16, 64, 6, 1, 128, dtype,
                                      seed=3)
    table[0, 3] = -1
    table[2, 1] = -1
    table[3, 40] = -1
    table[1, 30] = 7  # a live entry far past the context: never read
    for kw in ({}, dict(window=64)):
        got = paged_flash_decode_cuda(q, kp, vp, table, t, **kw)
        torch.testing.assert_close(got.float(), ref.paged_flash_decode(q, kp, vp, table, t, **kw)
                                   .float(), **TOLS[dtype])


@pytest.mark.cuda
def test_paged_flash_decode_long_context_bit_identical(dev):
    # grok-1's decode heads at t = 4095: pool [1024, 16, 8, 128], 67 MB of K/V.
    q, kp, vp, table, t = _paged_case(dev, [4095] * 4, 1, 16, 256, 48, 8, 128, torch.bfloat16,
                                      seed=11, pages=1024)
    got = paged_flash_decode_cuda(q, kp, vp, table, t)
    torch.testing.assert_close(got.float(), ref.paged_flash_decode(q, kp, vp, table, t).float(),
                               **TOLS[torch.bfloat16])
    assert torch.equal(got, paged_flash_decode_cuda(q, kp, vp, table, t))


# ---------------------------------------------------------------------------
# Kernel 8's gate and backward.  The gated kernel must equal the ungated
# kernel on PyTorch's own ``x * F.silu(z)`` bit for bit (the path it
# replaces), at the Mamba-2 serve's shapes, the wide two-pass widths and z of
# +-100 (silu saturates).  The backward against torch.autograd of the plain
# version: dx within torch.testing's dtype defaults (f32 math rounded once,
# another order), dw within GRAD_TOLS (a sum over up to 512 rows in another
# order, rounded once), and two runs bit-identical (no atomics).
# ---------------------------------------------------------------------------

from repro_torch.kernels.rmsnorm import RMSNormFn, rmsnorm_bwd_cuda  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

_NORM_SHAPES = [(8, 4096), (20, 4096), (44, 4096), (4, 4096), (4, 2048), (1, 48), (257, 2048),
                (3, 12288), (2, 16384), (2, 40000)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d", _NORM_SHAPES)
def test_rmsnorm_gate_bit_identical_to_unfused(dev, dtype, t, d):
    g = torch.Generator(device=dev).manual_seed(t * d)
    x = (torch.randn((t, d), generator=g, device=dev) * 3).to(dtype)
    z = (torch.randn((t, d), generator=g, device=dev) * 3).to(dtype)
    z[0, :4] = torch.tensor([100.0, -100.0, 30.0, -30.0])
    z[-1, : d // 2] = -100.0
    w = (torch.randn((d,), generator=g, device=dev) * 0.1).to(dtype)
    got = rmsnorm_cuda(x, w, 1e-5, gate=z)
    assert torch.equal(got, rmsnorm_cuda(x * torch.nn.functional.silu(z), w, 1e-5))
    torch.testing.assert_close(got, ref.rmsnorm(x, w, 1e-5, z))
    assert torch.equal(ops.rmsnorm(x, w, eps=1e-5, gate=z), got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,d", [(512, 4096), (44, 6144), (4, 6144), (300, 2048), (1, 48),
                                 (5, 12288), (3, 16384), (130, 512)])
def test_rmsnorm_backward_against_autograd(dev, dtype, t, d):
    g = torch.Generator(device=dev).manual_seed(t + d)
    x = (torch.randn((t, d), generator=g, device=dev) * 3).to(dtype)
    w = (torch.randn((d,), generator=g, device=dev) * 0.1).to(dtype)
    dy = torch.randn((t, d), generator=g, device=dev).to(dtype)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    want_dx, want_dw = torch.autograd.grad(ref.rmsnorm(xg, wg, 1e-6), (xg, wg), dy)
    dx, dw = rmsnorm_bwd_cuda(x, w, dy, 1e-6)
    assert dx.dtype == dw.dtype == dtype
    torch.testing.assert_close(dx, want_dx)
    torch.testing.assert_close(dw.float(), want_dw.float(), **GRAD_TOLS[dtype])
    dx2, dw2 = rmsnorm_bwd_cuda(x, w, dy, 1e-6)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    xf, wf = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = RMSNormFn.apply(xf, wf, 1e-6)
    assert torch.equal(out, rmsnorm_cuda(x, w, 1e-6))
    out.backward(dy)
    assert torch.equal(xf.grad, dx) and torch.equal(wf.grad, dw)


@pytest.mark.cuda
def test_rms_norm_on_the_card_counts_kernel_launches(dev):
    """``layers.rms_norm`` on a CUDA tensor runs kernel 8 (``[B, S, D]`` as
    ``[B * S, D]``), its backward kernel when a gradient is wanted."""
    x = torch.randn((2, 3, 64), device=dev)
    w = torch.randn((64,), device=dev) * 0.1
    ops.reset_launch_counts()
    out = L.rms_norm(x, w, 1e-6)
    assert out.shape == x.shape and ops.launch_shapes()["rmsnorm"] == {(6, 64): 1}
    torch.testing.assert_close(out, ref.rmsnorm(x, w, 1e-6))
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    L.rms_norm(xg, wg, 1e-6).sum().backward()
    counts = ops.launch_counts()
    assert counts["rmsnorm"] == 2 and counts["rmsnorm_bwd"] == 1, counts
    assert xg.grad is not None and wg.grad is not None


# ---------------------------------------------------------------------------
# Kernel 1 on both layouts (a thread a row up to E = 32, a warp a row above):
# ids exactly the plain version's, with tied rows, -inf logits and T off a
# multiple of the CTA; weights within torch.testing's f32 defaults (another
# summation order); its backward against torch.autograd.
# ---------------------------------------------------------------------------


def _gate_logits(dev, t, e, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn((t, e), generator=g, device=dev) * 2
    logits[0] = 0.5  # every expert tied: ids 0..k-1
    logits[1, ::2] = 1.25  # ties among the best
    logits[2, : e // 2] = float("-inf")  # half the row masked
    logits[3, 1:] = float("-inf")  # one expert left: the rest tie at probability 0
    return logits


@pytest.mark.cuda
@pytest.mark.parametrize("e", [8, 160, 1024])
@pytest.mark.parametrize("k", [1, 2, 6])
@pytest.mark.parametrize("t", [37, 300])
def test_topk_gating_layouts(dev, e, k, t):
    logits = _gate_logits(dev, t, e, seed=t + e + k)
    w, i = topk_gating_cuda(logits, k)
    rw, ri = ref.topk_gating(logits, k)
    assert torch.equal(i, ri)
    assert i[0].tolist() == list(range(k))
    torch.testing.assert_close(w, rw)


@pytest.mark.cuda
@pytest.mark.parametrize("e,k", [(8, 2), (5, 3), (32, 6), (160, 6)])
def test_topk_gating_nan_rows_and_odd_widths(dev, e, k):
    """E off the 16-byte vector (5) and at the thread layout's edge (32); a
    row of -inf logits has NaN probabilities, ordered as torch.argmax orders
    NaNs (the lowest id first)."""
    logits = _gate_logits(dev, 70, e, seed=e)
    logits[4] = float("-inf")
    w, i = topk_gating_cuda(logits, k)
    rw, ri = ref.topk_gating(logits, k)
    assert torch.equal(i, ri)
    torch.testing.assert_close(w, rw, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("e,k", [(8, 2), (8, 1), (5, 3), (32, 6), (160, 6), (1024, 2)])
def test_topk_gating_backward_layouts(dev, e, k):
    g = torch.Generator(device=dev).manual_seed(e + k)
    logits = torch.randn((67, e), generator=g, device=dev)
    logits[1, : e // 2] = float("-inf")
    dw = torch.randn((67, k), generator=g, device=dev)
    l1 = logits.clone().requires_grad_()
    TopkGatingFn.apply(l1, k)[0].backward(dw)
    l2 = logits.clone().requires_grad_()
    ref.topk_gating(l2, k)[0].backward(dw)
    torch.testing.assert_close(l1.grad, l2.grad, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Row invariance on grok-1's decode path.  A speculative verify pass decodes
# C = k + 1 = 5 tokens a slot where a serial tick decodes one, so every
# operation on the path must give a row the same bits at M = B rows and at
# M = B * C rows: then speculative tokens equal serial tokens on the card.
# Each case runs the operation on [4, 5, ...] and on each [4, 1, ...] slice
# and compares the shared rows with torch.equal (no tolerance).
# ---------------------------------------------------------------------------

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.parallel.sharding import make_plan  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 40])
def test_paged_flash_decode_row_invariant(dev, dtype, window):
    """Kernel 3: a row's output is bit-identical at B in {1, 4} and C in
    {1, 5}.  grok-1's heads, a table of 16 pages (4 splits of 4 pages);
    rows of length 0 and 3 leave three of the four splits empty."""
    lengths = [0, 3, 100, 250]
    q, kp, vp, table, t = _paged_case(dev, lengths, 5, 16, 16, 48, 8, 128, dtype, seed=21,
                                      pages=64)
    kw = dict(window=window)
    full = paged_flash_decode_cuda(q, kp, vp, table, t, **kw)
    torch.testing.assert_close(full.float(), ref.paged_flash_decode(q, kp, vp, table, t, **kw)
                               .float(), **TOLS[dtype])
    for b in range(4):
        alone = paged_flash_decode_cuda(q[b : b + 1], kp, vp, table[b : b + 1], t[b : b + 1], **kw)
        assert torch.equal(alone[0], full[b]), f"slot {b} alone, C = 5"
    for c in range(5):
        one = paged_flash_decode_cuda(q[:, c : c + 1].contiguous(), kp, vp, table, t + c, **kw)
        assert torch.equal(one[:, 0], full[:, c]), f"row {c}, B = 4, C = 1"
        for b in range(4):
            alone = paged_flash_decode_cuda(q[b : b + 1, c : c + 1].contiguous(), kp, vp,
                                            table[b : b + 1], t[b : b + 1] + c, **kw)
            assert torch.equal(alone[0, 0], full[b, c]), f"row {c} of slot {b}, B = 1, C = 1"


def _rows_equal(f, x):
    """f on x [B, C, ...] and on each [B, 1, ...] slice: the shared rows are
    bit-identical."""
    full = f(x)
    for c in range(x.shape[1]):
        one = f(x[:, c : c + 1].contiguous())
        assert torch.equal(one[:, 0], full[:, c]), f"row {c} of {x.shape[1]}"


def _grok_op(op, dev):
    """grok-1's decode-mode operation ``op`` at its published widths, as the
    port runs it (products on ``layers.decode_rows`` blocks), with random
    weights: x [B, C, ...] -> [B, C, ...]."""
    from repro_torch.train.train_step import _decode_logits

    cfg = get_config("grok-1-314b")
    d, h, hkv, dh, v = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, 128, cfg.vocab_size
    g = torch.Generator(device=dev).manual_seed(5)

    def w(*shape, dtype=torch.bfloat16, scale=None):
        return (torch.randn(shape, generator=g, device=dev) * (scale or shape[0] ** -0.5)).to(dtype)

    if op in ("wq", "wk", "wv"):
        wt = w(d, h if op == "wq" else hkv, dh)
        return lambda x: L.column_products(x.reshape(-1, d), [wt.reshape(d, -1)], True)[0].reshape(
            *x.shape[:2], *wt.shape[1:]), (d,)
    if op == "wo":
        wt = w(h, dh, d, scale=(h * dh) ** -0.5)
        return lambda x: L.row_products(x.reshape(-1, h * dh), wt.reshape(h * dh, d), True).reshape(
            *x.shape[:2], d), (h, dh)
    if op == "lm_head":
        p = {"lm_head": w(d, v)}
        return lambda x: _decode_logits(p, x, cfg), (d,)
    if op == "rmsnorm":
        wt = w(d, scale=0.1)
        return lambda x: L.rms_norm(x, wt), (d,)
    if op == "topk_gating":
        return lambda x: torch.stack(ops.topk_gating(x.reshape(-1, 8), 2), -1).reshape(
            *x.shape[:2], 2, 2), (8,)
    e, f = cfg.moe.num_experts, cfg.moe.d_ff
    p = {"router": w(d, e, dtype=torch.float32), "w_in": w(e, d, f, scale=d**-0.5),
         "w_gate": w(e, d, f, scale=d**-0.5), "w_out": w(e, f, d, scale=f**-0.5)}
    if op == "router":
        return lambda x: L.decode_rows(lambda r: r @ p["router"], x.reshape(-1, d)).reshape(
            *x.shape[:2], e), (d,)
    if op == "expert_ffn":  # the per-expert products, M = 4 * tokens a group
        return lambda x: moe_mod._expert_ffn(
            x.reshape(x.shape[0], 1, -1, d).expand(-1, e, -1, -1), p["w_in"], p["w_gate"],
            p["w_out"], cfg.act, fixed_rows=True)[:, 0], (d,)
    assert op == "moe"
    return lambda x: moe_mod._moe_einsum(p, x, cfg, make_plan(None), fixed_rows=True)[0], (d,)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["wq", "wk", "wv", "wo", "lm_head", "rmsnorm", "topk_gating",
                                "router", "expert_ffn", "moe"])
def test_grok_decode_ops_row_invariant(dev, op):
    """Every operation of grok-1's decode path at its published widths gives
    a row the same bits at M = 4 (a serial tick) and M = 20 (a verify pass
    of spec_k = 4); the MoE through the einsum backend as the serve runs it
    (router, kernel 1, dispatch, the per-expert products, the combine).
    Without ``decode_rows`` blocks, cuBLAS fails this for wq, wo and the f32
    router product on the H100."""
    with torch.no_grad():
        f, tail = _grok_op(op, dev)
        g = torch.Generator(device=dev).manual_seed(9)
        x = torch.randn((4, 5, *tail), generator=g, device=dev)
        _rows_equal(f, x if op in ("topk_gating", "router") else x.to(torch.bfloat16))


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("sample", [False, True])
def test_spec_equals_serial_on_the_card(dev, sample):
    """Speculative decoding emits serial decoding's tokens bit for bit on
    the card: reduced grok-1 in bf16 (head dim 64, so kernel 3 runs at a
    kernel width), spec_k = 4 with the topk1 draft, reconfiguration on,
    greedy and sampled, the page pool balancing after every tick."""
    from repro_torch.configs import get_reduced
    from repro_torch.serve.batching import Request
    from repro_torch.serve.engine import ServeConfig, ServeEngine

    cfg = get_reduced("grok-1-314b", dtype="bfloat16", head_dim=64)
    params = tfm.init_model(0, cfg, make_plan(None), device=dev)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size - 1, size=n).astype(np.int32) for n in (5, 19, 9, 30)]

    def serve(spec_k):
        scfg = ServeConfig(slots=4, max_len=64, page_size=8, spec_k=spec_k, sample=sample,
                           sample_seed=3, reconfig_every=3, reconfig_min_gain=0.0, num_devices=4)
        # A clone: a reconfiguration permutes the engine's expert weights.
        eng = ServeEngine(_clone_tree(params), cfg, make_plan(None), scfg, device=dev)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=10 + i, prompt=p, max_new_tokens=12))
        while eng.batcher.busy:
            eng.step()
            eng.batcher.alloc.check_leaks()
        rep = eng.report(1.0)
        assert rep.completed == len(prompts)
        return {r.rid: r.out for r in eng.batcher.finished}, rep

    serial, _ = serve(0)
    spec, rep = serve(4)
    assert spec == serial
    assert rep.spec_drafted > 0 and rep.reconfig_count > 0


# ---------------------------------------------------------------------------
# A prefix-cache hit and a miss give a request the same bits.  A hit admits
# only the prompt's remainder over the cached pages, a miss the whole
# prompt; the request's next-token logits and its greedy tokens must not
# depend on which it was (the fleet steers a request to any replica, warm or
# cold).  Kernel 3 at a continuation chunk's shape: rows of a chunk that
# starts after 4 cached pages equal the same rows of a chunk from position 0.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_paged_flash_decode_chunk_rows_invariant(dev):
    """grok-1's heads, a table of 16 pages: q [1, 244, 48, 128] from
    position 0 and its last 180 rows from position 64 (4 cached pages of
    16): the shared rows are bit-identical, and both hold the plain
    version."""
    q, kp, vp, table, t = _paged_case(dev, [0], 244, 16, 16, 48, 8, 128, torch.bfloat16,
                                      seed=31, pages=32)
    miss = paged_flash_decode_cuda(q, kp, vp, table, t)
    torch.testing.assert_close(miss.float(), ref.paged_flash_decode(q, kp, vp, table, t).float(),
                               **TOLS[torch.bfloat16])
    tail = q[:, 64:].contiguous()
    hit = paged_flash_decode_cuda(tail, kp, vp, table, t + 64)
    torch.testing.assert_close(hit.float(), ref.paged_flash_decode(tail, kp, vp, table, t + 64)
                               .float(), **TOLS[torch.bfloat16])
    assert torch.equal(hit, miss[:, 64:])


@pytest.mark.cuda
def test_prefix_hit_equals_miss_on_the_card(dev, monkeypatch):
    """grok-1 at its published widths (1 of 64 layers, random bf16
    weights): a prefix hit gives B the logits and tokens a miss gives it,
    bit for bit, with the prefix cache on."""
    import dataclasses

    from _torch_prefix import admission_logits, prefix_hit_and_miss

    cfg = dataclasses.replace(get_config("grok-1-314b"), num_layers=1)
    params = tfm.init_model(0, cfg, make_plan(None), device=dev)
    out = prefix_hit_and_miss(params, cfg, dev, admission_logits(monkeypatch))
    (miss_logits, miss_toks), (hit_logits, hit_toks) = out[False], out[True]
    assert torch.equal(hit_logits, miss_logits), (hit_logits - miss_logits).abs().max()
    assert hit_toks == miss_toks


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["none", "full"])
def test_chunked_trainer_equals_serial_on_the_card(dev, remat):
    """The tuned ``overlap_chunks`` path trains bit for bit like one chunk:
    the chunked pipeline's expert weight gradients are taken in the serial
    path's row order (kernel 7's dW over the serial layout), so the losses
    and every parameter after a few steps are the one-chunk trainer's."""
    import dataclasses

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.config import ModelConfig, MoEConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import make_plan
    from repro_torch.train.trainer import Trainer, TrainerConfig

    base = ModelConfig("t", "moe", 2, 256, 4, 2, 0, 512, dtype="bfloat16", remat=remat,
                       moe=MoEConfig(num_experts=8, top_k=2, d_ff=512, backend="mixnet"))
    runs = []
    for chunks in (1, 4):
        cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, overlap_chunks=chunks))
        tr = Trainer(cfg, AdamWConfig(lr=1e-3), TrainerConfig(total_steps=3), make_plan(None),
                     seed=0, device=dev)
        tr.train(iter(SyntheticLM(512, seq_len=128, global_batch=2, seed=0)))
        runs.append(([m["loss"] for m in tr.metrics_log],
                     {k: v.detach().clone() for k, v in _flat_leaves(tr.params)}))
    assert runs[0][0] == runs[1][0]
    for name, leaf in runs[0][1].items():
        assert torch.equal(leaf, runs[1][1][name]), name


def _flat_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


# ---------------------------------------------------------------------------
# The dense models' shapes and options: gemma2's D = 256 with 8 / 4 heads,
# softcap 50 and a window that binds (its bf16 backward takes the
# f32-staged kernels above D = 128), kernel 3 at D = 256 with the window and
# at deepseek-7b's group of 1 (Hq = Hkv: one valid row of a CTA's 8), the
# norm at the dense widths (12288 bf16 takes the two-pass kernels); chunked
# capacity dispatch trains the same bits at any chunk count.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gemma2_shape_with_window_and_softcap(dev, dtype):
    g = torch.Generator(device=dev).manual_seed(256)
    s, d, kw = 600, 256, dict(causal=True, window=256, softcap=50.0)
    q = (torch.randn((2, 8, s, d), generator=g, device=dev) * 2).to(dtype)
    k = (torch.randn((2, 4, s, d), generator=g, device=dev) * 2).to(dtype)
    v = torch.randn((2, 4, s, d), generator=g, device=dev).to(dtype)
    do = torch.randn((2, 8, s, d), generator=g, device=dev).to(dtype)
    # f32: sums of 256-wide products over up to 256 keys in another order
    # than the plain version's, so 1e-4 (GRAD_TOLS) rather than TOLS' 1e-5.
    tol = GRAD_TOLS[dtype] if dtype == torch.float32 else TOLS[dtype]
    torch.testing.assert_close(flash_attention_cuda(q, k, v, **kw).float(),
                               ref.flash_attention(q, k, v, **kw).float(), **tol)
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    FlashAttentionFn.apply(*a, True, kw["window"], kw["softcap"]).backward(do)
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    ref.flash_attention(*b, **kw).backward(do)
    for x, y in zip(a, b):
        torch.testing.assert_close(x.grad.float(), y.grad.float(), **GRAD_TOLS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d,kw", [
    (8, 4, 256, dict(window=40, softcap=50.0)),  # gemma2's local layers
    (8, 4, 256, dict(softcap=50.0)),  # its global layers
    (32, 32, 128, {}),  # deepseek-7b: a group of 1
])
@pytest.mark.parametrize("c", [1, 5])
def test_paged_flash_decode_dense_model_shapes(dev, dtype, hq, hkv, d, kw, c):
    g = torch.Generator(device=dev).manual_seed(hq + d + c)
    lengths = [77, 20, 3, 130]
    table = _table(lengths, c, 16, 10, 48, seed=c).to(dev)
    t = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn((4, c, hq, d), generator=g, device=dev).to(dtype)
    kp = torch.randn((48, 16, hkv, d), generator=g, device=dev).to(dtype)
    vp = torch.randn((48, 16, hkv, d), generator=g, device=dev).to(dtype)
    got = paged_flash_decode_cuda(q, kp, vp, table, t, **kw)
    torch.testing.assert_close(got.float(), ref.paged_flash_decode(q, kp, vp, table, t, **kw)
                               .float(), **TOLS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [2304, 8192, 12288])
def test_rmsnorm_dense_model_widths(dev, dtype, d):
    g = torch.Generator(device=dev).manual_seed(d)
    x = (torch.randn((512, d), generator=g, device=dev) * 3).to(dtype)
    w = (torch.randn((d,), generator=g, device=dev) * 0.1).to(dtype)
    dy = torch.randn((512, d), generator=g, device=dev).to(dtype)
    torch.testing.assert_close(rmsnorm_cuda(x, w, 1e-6), ref.rmsnorm(x, w, 1e-6))
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    want_dx, want_dw = torch.autograd.grad(ref.rmsnorm(xg, wg, 1e-6), (xg, wg), dy)
    dx, dw = rmsnorm_bwd_cuda(x, w, dy, 1e-6)
    torch.testing.assert_close(dx, want_dx)
    torch.testing.assert_close(dw.float(), want_dw.float(), **GRAD_TOLS[dtype])


@pytest.mark.cuda
def test_chunked_capacity_trainer_same_at_any_chunk_count_on_the_card(dev):
    """Capacity dispatch through the chunked pipeline at a factor that drops
    at stage 1: 2 and 4 chunks train the same losses and parameters bit for
    bit (each expert weight's gradient is one kernel-7 dW over the rows
    stage 1 keeps, in serial order)."""
    import dataclasses

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.config import ModelConfig, MoEConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import make_plan
    from repro_torch.train.trainer import Trainer, TrainerConfig

    base = ModelConfig("t", "moe", 2, 256, 4, 2, 0, 512, dtype="bfloat16", remat="full",
                       moe=MoEConfig(num_experts=8, top_k=2, d_ff=512, backend="mixnet",
                                     dispatch="capacity", capacity_factor=0.5))
    runs = []
    for chunks in (2, 4):
        cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe, overlap_chunks=chunks))
        tr = Trainer(cfg, AdamWConfig(lr=1e-3), TrainerConfig(total_steps=3), make_plan(None),
                     seed=0, device=dev)
        tr.train(iter(SyntheticLM(512, seq_len=128, global_batch=2, seed=0)))
        assert all(float(m["dropped_fraction"].max()) > 0 for m in tr.metrics_log)
        runs.append(([m["loss"] for m in tr.metrics_log],
                     {k: v.detach().clone() for k, v in _flat_leaves(tr.params)}))
    assert runs[0][0] == runs[1][0]
    for name, leaf in runs[0][1].items():
        assert torch.equal(leaf, runs[1][1][name]), name


class _GridMesh:
    """A mesh's rank grid and dim names, without a process group: what
    ``TreeLayout`` reads when every rank is named."""

    def __init__(self, shape, names):
        self.mesh = torch.arange(int(np.prod(shape))).reshape(shape)
        self.mesh_dim_names = names

    def size(self, dim):
        return int(self.mesh.shape[dim])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,names", [((2, 2), ("stage", "model")), ((1, 4), ("data", "model"))])
def test_tree_layout_parts_reassemble_bit_for_bit_on_the_card(dev, dtype, shape, names):
    """The mesh checkpoint's slice and assemble helpers on card tensors:
    every rank's part of each leaf, placed back, is the global tree bit for
    bit; a part that is not the whole leaf is a copy."""
    from types import SimpleNamespace

    from repro_torch.parallel.sharding import TreeLayout, make_plan

    mesh = _GridMesh(shape, names)
    # What the layout reads of this tree's model: a tied head, 64 vocab rows.
    cfg = SimpleNamespace(tie_embeddings=True, vocab_size=64)
    layout = TreeLayout(make_plan(mesh, fsdp=False), mesh, cfg)
    g = torch.Generator(device=dev).manual_seed(3)
    tree = {"embed": torch.randn((64, 16), generator=g, device=dev).to(dtype),
            "blocks": {"0_global": {
                "norm1": torch.randn((4, 16), generator=g, device=dev).to(dtype),
                "moe": {"router": torch.randn((4, 16, 8), generator=g, device=dev),
                        "w_in": torch.randn((4, 8, 16, 24), generator=g, device=dev).to(dtype)}}},
            "final_norm": torch.randn((16,), generator=g, device=dev).to(dtype)}
    flat = dict(_flat_leaves(tree))
    out = {k: torch.zeros_like(v) for k, v in flat.items()}
    held = {k: 0 for k in flat}
    for r in range(4):
        for key, part in _flat_leaves(layout.shard(tree, rank=r)):
            assert part.device == flat[key].device and part.dtype == flat[key].dtype
            if part.shape != flat[key].shape:
                assert part.data_ptr() != flat[key].data_ptr()
            layout.place(out[key], part, key, r)
            held[key] += 1
            assert layout.global_shape(key, part.shape) == tuple(flat[key].shape)
    for key, v in flat.items():
        bits = (lambda t: t.view(torch.int16)) if dtype == torch.bfloat16 else (lambda t: t)
        want = bits(v) if v.dtype == dtype else v
        got = bits(out[key]) if v.dtype == dtype else out[key]
        assert torch.equal(got, want), key
        assert held[key] >= 1, key


def _flat_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_leaves(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


@pytest.mark.cuda
def test_dense_decode_gather_over_one_rank_group_equals_unsharded(dev):
    """``dense_decode`` over a one-rank ``("model",)`` group equals the
    unsharded backend bit for bit, and its slot gather (gloo on the card's
    bf16 tensors) returns the rank's outputs as they were."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import free_port
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.config import ModelConfig, MoEConfig
    from repro_torch.parallel.sharding import make_plan

    cfg = ModelConfig("t", "moe", 1, 64, 4, 2, 0, 128, dtype="bfloat16",
                      moe=MoEConfig(num_experts=8, top_k=2, d_ff=96))
    g = torch.Generator(device=dev).manual_seed(5)
    p = {"router": torch.randn((64, 8), generator=g, device=dev) * 0.5,
         "w_in": (torch.randn((8, 64, 96), generator=g, device=dev) / 8).bfloat16(),
         "w_gate": (torch.randn((8, 64, 96), generator=g, device=dev) / 8).bfloat16(),
         "w_out": (torch.randn((8, 96, 64), generator=g, device=dev) / 10).bfloat16()}
    x = torch.randn((6, 1, 64), generator=g, device=dev).bfloat16()
    perm = torch.tensor([3, 1, 4, 0, 6, 2, 7, 5], dtype=torch.int32, device=dev)
    owned = not dist.is_initialized()
    if owned:
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}", rank=0,
                                world_size=1)
    try:
        mesh = make_mesh((1,), ("model",))
        plan = make_plan(mesh)
        with torch.no_grad():
            o_mesh, st_mesh = moe_mod.moe_apply(p, x, cfg, plan, mesh=mesh, mode="decode",
                                                backend="dense_decode", expert_perm=perm)
            o, st = moe_mod.moe_apply(p, x, cfg, make_plan(None), mode="decode",
                                      backend="dense_decode", expert_perm=perm)
            y = torch.randn((8, 6, 64), generator=g, device=dev).bfloat16()
            gathered = moe_mod._gather_slots(y, plan, mesh, 0)
        assert torch.equal(o_mesh.view(torch.int16), o.view(torch.int16))
        assert torch.equal(st_mesh.expert_load, st.expert_load)
        assert gathered.device == y.device and torch.equal(gathered.view(torch.int16),
                                                           y.view(torch.int16))
    finally:
        if owned:
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# ZeRO-3 and sequence parallelism: two gloo ranks sharing the card
# ---------------------------------------------------------------------------


def _zero3_sp_rank(rank: int, port: int, out_dir: str) -> None:
    """One of two ranks on the card: the sequence reduce-scatter against
    ``tp._across`` (f32 partials cast to bf16, and kept f32), the ZeRO-3
    gather and its gradient reduce-scatter on bf16 leaves, and the
    sequence-parallel norm against one device's tree (forward, dx, dw)."""
    import json
    import os

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models import layers as L
    from repro_torch.parallel import fsdp, tp
    from repro_torch.parallel.sharding import make_plan

    init_distributed("gloo", rank=rank, world_size=2, init_method=f"tcp://localhost:{port}",
                     device_type="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    res = {}
    mesh = make_mesh((2,), ("model",))
    plan = make_plan(mesh)
    grp = tp.model_group(plan, mesh)
    g = torch.Generator(device=dev).manual_seed(11 + rank)
    for dtype in (torch.bfloat16, torch.float32):
        part = torch.randn((2, 64, 256), generator=g, device=dev) * 3
        whole = tp._across(part, grp, dtype)
        mine = tp.seq_scatter(part, plan, mesh, dtype)
        res[f"scatter_{dtype}"] = torch.equal(mine, whole[:, rank * 32:(rank + 1) * 32])
    dmesh = make_mesh((2,), ("data",))
    dplan = make_plan(dmesh)
    g0 = torch.Generator(device=dev).manual_seed(5)
    leaf = (torch.randn((4, 64, 96), generator=g0, device=dev) * 0.1).bfloat16()
    grads = [(torch.randn((4, 64, 96), generator=g0, device=dev)).bfloat16() for _ in range(2)]
    shard = leaf[:, rank * 32:(rank + 1) * 32].clone().requires_grad_()
    full = fsdp.gather(shard, 1, dplan, dmesh)
    res["gather"] = torch.equal(full, leaf)
    full.backward(grads[rank])
    want = (grads[0].float() + grads[1].float()).bfloat16()[:, rank * 32:(rank + 1) * 32]
    res["grad_scatter"] = torch.equal(shard.grad, want)
    g1 = torch.Generator(device=dev).manual_seed(7)
    x = (torch.randn((2, 512, 2304), generator=g1, device=dev) * 2).bfloat16()
    w = (torch.randn((2304,), generator=g1, device=dev) * 0.1).bfloat16()
    dy = torch.randn((2, 512, 2304), generator=g1, device=dev).bfloat16()
    xo, wo = x.clone().requires_grad_(), w.clone().requires_grad_()
    yo = L.rms_norm(xo, wo, 1e-6, L.norm_tree(xo))
    yo.backward(dy)
    xs = x[:, rank * 256:(rank + 1) * 256].clone().requires_grad_()
    ws = w.clone().requires_grad_()
    ys = L.rms_norm(xs, ws, 1e-6, L.norm_tree(xs, plan, mesh, sp=True))
    ys.backward(dy[:, rank * 256:(rank + 1) * 256].contiguous())
    res["norm_y"] = torch.equal(ys, yo[:, rank * 256:(rank + 1) * 256])
    res["norm_dx"] = torch.equal(xs.grad, xo.grad[:, rank * 256:(rank + 1) * 256])
    res["norm_dw"] = torch.equal(ws.grad, wo.grad)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump({str(k): bool(v) for k, v in res.items()}, fh)
    dist.barrier()
    dist.destroy_process_group()


@pytest.mark.cuda
def test_zero3_and_sp_collectives_bit_for_bit_on_the_card(dev, tmp_path):
    """On the card's tensors, two gloo ranks: the sequence reduce-scatter
    gives each rank's slice of ``tp._across``'s sum bit for bit (f32
    partials, cast to bf16 and kept f32); a ZeRO-3 gather returns the whole
    bf16 leaf and its backward the rank's shard of the rank-order sum; the
    sequence-parallel norm (kernel 8 over the rank's half, its weight
    gradient's f32 tree summed over the ranks) gives one device's output,
    input gradient and weight gradient bit for bit."""
    import json

    import torch.multiprocessing as mp

    from repro_torch.launch.train import free_port

    mp.spawn(_zero3_sp_rank, args=(free_port(), str(tmp_path)), nprocs=2, join=True)
    for r in range(2):
        got = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert got and all(got.values()), got
