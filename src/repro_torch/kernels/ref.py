"""Plain PyTorch versions of the ported kernels.

These are the semantics of record on the port's side: each CUDA kernel is
held against its function here (on the card by ``chip_smoke.py``, and by
the CUDA-marked tests), and the ``ops`` wrappers route CPU tensors here.
Each mirrors :mod:`repro.kernels.ref` of the JAX package.
"""

from __future__ import annotations

import torch

__all__ = [
    "topk_gating",
    "flash_attention",
    "paged_gather_kv",
    "paged_flash_decode",
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


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
) -> torch.Tensor:
    """Attention with GQA, causal / sliding-window mask and logit softcap.

    q ``[B, Hq, S, D]``, k/v ``[B, Hkv, S, D]`` with Hq % Hkv == 0; f32
    math, masked logits at -1e30 before the softmax (as the JAX oracle)."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx) * (1.0 / d**0.5)
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
