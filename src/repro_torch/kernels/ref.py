"""Plain PyTorch versions of the ported kernels.

These are the semantics of record on the port's side: each CUDA kernel is
held against its function here (on the card by ``chip_smoke.py``, and by
the CUDA-marked tests), and the ``ops`` wrappers route CPU tensors here.
Each forward mirrors :mod:`repro.kernels.ref` of the JAX package.  The
``*_bwd`` functions are the plain backward formulas the backward kernels
compute (the JAX package has no VJP on its Pallas kernels: it
differentiates these references); the tests hold each against
``torch.autograd`` of its plain forward.
"""

from __future__ import annotations

import torch

__all__ = [
    "topk_gating",
    "topk_gating_bwd",
    "flash_attention",
    "flash_attention_bwd",
    "paged_gather_kv",
    "paged_flash_decode",
    "moe_dispatch",
    "moe_dispatch_bwd",
    "moe_combine",
    "moe_combine_bwd",
    "grouped_matmul",
    "grouped_matmul_blocks",
    "grouped_matmul_blocks_dw",
    "grouped_matmul_blocks_bwd",
    "rmsnorm",
    "ssd_chunk",
]

_NEG = -1e30


def topk_gating(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Softmax over experts then top-k.

    ``logits [T, E]`` -> (weights ``[T, k]`` f32 softmax probabilities of the
    chosen experts, ids ``[T, k]`` i32), descending by probability.  Ties go
    to the LOWEST expert id, as ``jax.lax.top_k`` does: k argmax passes
    (``torch.argmax`` returns the first maximal index), the chosen entry
    masked to -inf before the next pass.  ``torch.topk`` fixes no tie order.
    """
    probs = torch.softmax(logits.float(), dim=-1)
    cur = probs.clone()
    ws, ids = [], []
    for _ in range(k):
        i = torch.argmax(cur, dim=-1, keepdim=True)
        ws.append(torch.gather(probs, -1, i))
        ids.append(i)
        cur.scatter_(-1, i, float("-inf"))
    return torch.cat(ws, -1), torch.cat(ids, -1).to(torch.int32)


def topk_gating_bwd(
    logits: torch.Tensor, dweights: torch.Tensor, idx: torch.Tensor
) -> torch.Tensor:
    """Gradient of :func:`topk_gating`'s weights w.r.t. the logits: the ids
    carry none, so ``dlogits = p * (g - <p, g>)`` with ``p = softmax`` and
    ``g`` the ``[T, E]`` scatter of ``dweights`` at ``idx``."""
    p = torch.softmax(logits.float(), dim=-1)
    g = torch.zeros_like(p).scatter_add_(-1, idx.long(), dweights.float())
    return p * (g - (p * g).sum(-1, keepdim=True))


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention with GQA, causal / sliding-window mask and logit softcap.

    q ``[B, Hq, S, D]``, k/v ``[B, Hkv, S, D]`` with Hq % Hkv == 0; f32
    math, masked logits at -1e30 before the softmax (as the JAX oracle).
    ``scale`` defaults to ``1/sqrt(D)``."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    scale = 1.0 / d**0.5 if scale is None else scale
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    logits = torch.where(mask, logits, torch.full_like(logits, _NEG))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vx).to(q.dtype)


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention` for the output gradient
    ``dout``, in f32 math, cast to the inputs' dtype: ``dS = P * (dP -
    rowsum(dP * P))`` (times ``1 - tanh^2`` under softcap), dk and dv summed
    over each kv head's group of q heads."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    group = hq // hkv
    scale = 1.0 / d**0.5 if scale is None else scale
    qf, do = q.float(), dout.float()
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    raw = torch.einsum("bhqd,bhkd->bhqk", qf, kx) * scale
    logits = raw
    if softcap is not None:
        logits = softcap * torch.tanh(raw / softcap)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= (qpos - kpos) < window
    probs = torch.softmax(torch.where(mask, logits, torch.full_like(logits, _NEG)), dim=-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", probs, do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vx)
    ds = probs * (dp - (dp * probs).sum(-1, keepdim=True))
    ds = torch.where(mask, ds, torch.zeros_like(ds))
    if softcap is not None:
        ds = ds * (1.0 - torch.tanh(raw / softcap) ** 2)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kx) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale

    def fold(t):  # [B, Hq, S, D] -> [B, Hkv, S, D], summed over each group
        return t.reshape(b, hkv, group, s, d).sum(2)

    return dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)


def paged_gather_kv(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """``pool [N, page, ...]`` gathered through ``page_table [B, P]`` (-1 =
    unallocated, gathered as page 0 — callers mask positions past the
    sequence) into the contiguous view ``[B, P * page, ...]``."""
    g = pool[page_table.clamp(min=0).long()]  # [B, P, page, ...]
    b, p, page = g.shape[:3]
    return g.reshape(b, p * page, *g.shape[3:])


def paged_flash_decode(
    q: torch.Tensor,  # [B, C, Hq, D]
    k_pool: torch.Tensor,  # [N, page, Hkv, D]
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B, P] i32, -1 = unallocated
    lengths: torch.Tensor,  # [B] i32: chunk row c attends positions <= t + c
    *,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """Decode / chunk-continuation attention through a paged KV cache.

    Keeps the JAX oracle's page-at-a-time streaming schedule: for every
    page of the table, a ``[Hq, C, page]`` score tile, the running max /
    sum / f32 accumulator update, and ``acc / l`` (0 where ``l == 0``) at
    the end.  Batched over sequences and heads, looped over pages.
    """
    b, c, hq, d = q.shape
    _, page, hkv, _ = k_pool.shape
    pages = page_table.shape[1]
    group = hq // hkv
    scale = 1.0 / d**0.5
    dev = q.device
    table = page_table.long()
    t = lengths.to(torch.int64).expand(b) if lengths.dim() == 0 else lengths.long()
    qf = q.float().permute(0, 2, 1, 3) * scale  # [B, Hq, C, D]
    m = torch.full((b, hq, c, 1), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hq, c, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hq, c, d), dtype=torch.float32, device=dev)
    q_pos = t[:, None, None, None] + torch.arange(c, device=dev)[None, None, :, None]
    for p in range(pages):
        pid = table[:, p].clamp(min=0)
        kt = k_pool[pid].float().repeat_interleave(group, dim=2)  # [B, page, Hq, D]
        vt = v_pool[pid].float().repeat_interleave(group, dim=2)
        s = torch.einsum("bhcd,bjhd->bhcj", qf, kt)  # [B, Hq, C, page]
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        k_pos = p * page + torch.arange(page, device=dev)[None, None, None, :]
        mask = k_pos <= q_pos
        if window is not None:
            mask &= (q_pos - k_pos) < window
        s = torch.where(mask, s, torch.full_like(s, _NEG))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p_tile = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p_tile.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhcj,bjhd->bhcd", p_tile, vt)
        m = m_new
    denom = torch.where(l > 0.0, l, torch.ones_like(l))
    return (acc / denom).permute(0, 2, 1, 3).to(q.dtype)


# ---------------------------------------------------------------------------
# MoE data movement and the grouped expert GEMM
# ---------------------------------------------------------------------------


def moe_dispatch(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Row gather into a packed layout: ``x [T, D]``, ``src [P]`` i32 ->
    ``[P, D]``, ``x[src[p]]`` where ``src[p] >= 0`` and zeros elsewhere."""
    rows = x[src.clamp(0, max(x.shape[0] - 1, 0)).long()]
    return torch.where((src >= 0)[:, None], rows, torch.zeros((), dtype=x.dtype, device=x.device))


def moe_dispatch_bwd(dout: torch.Tensor, inverse: torch.Tensor, dtype) -> torch.Tensor:
    """Gradient of :func:`moe_dispatch` through its inverse map.

    ``inverse [T]`` (a one-to-one gather, such as the pack and the unpack):
    ``dx[i] = dout[inverse[i]]``, the same gather.  ``inverse [T, S]`` (a
    many-to-one gather, such as the send buffer): ``dx[t] = sum_s
    dout[inverse[t, s]]``, the combine with unit weights."""
    if inverse.dim() == 1:
        return moe_dispatch(dout, inverse)
    ones = torch.ones(inverse.shape, dtype=torch.float32, device=dout.device)
    return moe_combine(dout, inverse, ones).to(dtype)


def moe_combine(y: torch.Tensor, slot: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted combine back to token order: ``y [P, D]``, ``slot/weights
    [T, S]`` -> ``[T, D]`` f32, ``sum_s w[t,s] * y[slot[t,s]]`` over the
    terms with ``slot >= 0``."""
    rows = y[slot.clamp(0, max(y.shape[0] - 1, 0)).long()].float()  # [T, S, D]
    w = torch.where(slot >= 0, weights.float(), torch.zeros((), device=y.device))
    return (rows * w[..., None]).sum(1)


def moe_combine_bwd(
    dout: torch.Tensor,
    y: torch.Tensor,
    slot: torch.Tensor,
    weights: torch.Tensor,
    src: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dy, dweights) of :func:`moe_combine`.  ``src [P]`` is the inverse of
    ``slot``: the flat index ``t * S + s`` of the term that reads row p, -1
    for rows no term reads.  ``dy[p] = w[t,s] * dout[t]`` in y's dtype;
    ``dw[t,s] = <dout[t], y[slot[t,s]]>`` (0 where ``slot < 0``)."""
    t, s = slot.shape
    g = dout.float()
    f = src.clamp(0, max(t * s - 1, 0)).long()
    dy = weights.float().reshape(-1)[f][:, None] * g[f // s]
    dy = torch.where((src >= 0)[:, None], dy, torch.zeros((), device=y.device)).to(y.dtype)
    rows = y[slot.clamp(0, max(y.shape[0] - 1, 0)).long()].float()
    dw = (g[:, None, :] * rows).sum(-1)
    return dy, torch.where(slot >= 0, dw, torch.zeros((), device=y.device))


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Capacity-layout per-expert GEMM: ``[E, C, D] @ [E, D, F] -> [E, C,
    F]``, f32 accumulation cast to x's dtype."""
    return torch.bmm(x.float(), w.float()).to(x.dtype)


def grouped_matmul_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Capacity-layout weight gradient ``dw[e] = x[e]^T dy[e]`` ``[E, D, F]``,
    f32 accumulation stored in x's dtype."""
    return torch.bmm(x.float().transpose(1, 2), dy.float()).to(x.dtype)


def grouped_matmul_bwd(
    x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of :func:`grouped_matmul`: ``dx = dy @ w[e]^T`` (the forward
    through the transposed weights) and :func:`grouped_matmul_dw`."""
    return grouped_matmul(dy, w.transpose(1, 2)), grouped_matmul_dw(x, dy).to(w.dtype)


def _expert_runs(block_experts: torch.Tensor) -> list[tuple[int, int, int]]:
    """``(expert, first tile, end tile)`` of each run of equal consecutive
    entries of ``block_experts`` (one run per expert when it is sorted).
    Reads the map on the host."""
    be = block_experts.tolist()
    runs, start = [], 0
    for i in range(1, len(be) + 1):
        if i == len(be) or be[i] != be[start]:
            runs.append((int(be[start]), start, i))
            start = i
    return runs


def grouped_matmul_blocks(
    x: torch.Tensor, w: torch.Tensor, block_experts: torch.Tensor
) -> torch.Tensor:
    """Dropless block GEMM: ``x [n, B, D] @ w[block_experts[n]] -> [n, B,
    F]``, f32 accumulation cast to x's dtype.  One product per run of
    tiles owned by the same expert, so no ``[n, D, F]`` weight gather."""
    n, b, d = x.shape
    f = w.shape[2]
    parts = [
        (x[lo:hi].reshape(-1, d).float() @ w[e].float()).reshape(hi - lo, b, f)
        for e, lo, hi in _expert_runs(block_experts)
    ]
    if not parts:
        return x.new_zeros((0, b, f))
    return torch.cat(parts).to(x.dtype)


def grouped_matmul_blocks_dw(
    x: torch.Tensor, dy: torch.Tensor, block_experts: torch.Tensor, num_experts: int
) -> torch.Tensor:
    """``dw[e] = sum over e's tiles of x^T dy`` ``[E, D, F]``, f32
    accumulation stored in x's dtype (zeros for an expert without tiles)."""
    d = x.shape[2]
    f = dy.shape[2]
    dw = torch.zeros((num_experts, d, f), dtype=torch.float32, device=x.device)
    for e, lo, hi in _expert_runs(block_experts):
        dw[e] += x[lo:hi].reshape(-1, d).float().T @ dy[lo:hi].reshape(-1, f).float()
    return dw.to(x.dtype)


def grouped_matmul_blocks_bwd(
    x: torch.Tensor, w: torch.Tensor, block_experts: torch.Tensor, dy: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of :func:`grouped_matmul_blocks`: ``dx = dy @ w[e]^T`` per
    tile (the forward through the transposed weights) and
    :func:`grouped_matmul_blocks_dw`."""
    dx = grouped_matmul_blocks(dy, w.transpose(1, 2), block_experts)
    return dx, grouped_matmul_blocks_dw(x, dy, block_experts, w.shape[0]).to(w.dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            gate: torch.Tensor | None = None) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` over the last dim, f32 math,
    rounded once to x's dtype: the JAX package's ``layers.rms_norm`` (and
    ``ops.rmsnorm``'s plain branch, ``x [T, D]``, ``w [D]``).  ``gate``: z
    of x's shape; the norm is then of ``x * silu(z)`` in x's dtype, as the
    JAX package's Mamba-2 block forms it before its norm."""
    if gate is not None:
        x = x * torch.nn.functional.silu(gate)
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + w.float())).to(dtype)


def ssd_chunk(
    x: torch.Tensor, da: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD intra-chunk pass, one group per (batch, chunk, head).

    ``x [G, L, P]`` dt-weighted inputs, ``da [G, L]`` per-step log-decays,
    ``bmat``/``cmat [G, L, N]`` -> (``y [G, L, P]``, ``state [G, N, P]``),
    both f32::

        y[l]  = sum_{s <= l} (C_l . B_s) exp(cum[l] - cum[s]) x_s
        state = sum_s B_s^T exp(cum[L-1] - cum[s]) x_s

    with ``cum`` the within-chunk cumulative sum of ``da``.  The decay for
    ``s > l`` is positive and may overflow; ``where`` selects 0 there (a
    product with a 0/1 mask would give ``inf * 0 = NaN``)."""
    x, da, bmat, cmat = x.float(), da.float(), bmat.float(), cmat.float()
    l = x.shape[1]
    cum = torch.cumsum(da, dim=1)
    cb = torch.einsum("gln,gsn->gls", cmat, bmat)
    gate = torch.exp(cum[:, :, None] - cum[:, None, :])
    mask = torch.ones((l, l), dtype=torch.bool, device=x.device).tril()
    y = torch.einsum("gls,gls,gsp->glp", cb, torch.where(mask, gate, 0.0), x)
    st = torch.einsum("gsn,gs,gsp->gnp", bmat, torch.exp(cum[:, -1:] - cum), x)
    return y, st
