"""Shared neural layers — the GQA half: norms, RoPE, attention for prefill
and decode over a dense or paged KV cache.

Port of :mod:`repro.models.layers`.  Layers are plain functions on tensors
with the JAX package's layouts at the public functions (``wq [d, h, dh]``,
caches ``[B, S, Hkv, dh]``, page pools ``[N, page, Hkv, dh]``).  Decode
writes its chunk's K/V into the cache IN PLACE (index writes into the
caller's tensors: no copy of a multi-GB cache per tick).  MLA, MLPs and the
sequence-parallel paths come with later slices.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref

__all__ = [
    "rms_norm", "init_rms_norm", "rope_frequencies", "apply_rope",
    "init_attention", "attention_apply", "init_attention_cache",
    "init_paged_attention_cache", "DecodeWrites", "decode_writes", "normal",
]

_NEG = -1e30


def normal(gen: torch.Generator, shape, dtype, device, scale: float) -> torch.Tensor:
    """Seeded N(0, 1) * scale, drawn directly in ``dtype`` on ``device``
    (scaled in place: one buffer even for multi-GB expert stacks)."""
    return torch.randn(shape, generator=gen, dtype=dtype, device=device).mul_(scale)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim in plain PyTorch (:func:`kref.rmsnorm`)."""
    return kref.rmsnorm(x, w, eps)


def init_rms_norm(d: int, dtype, device, reps: int | None = None) -> torch.Tensor:
    shape = (d,) if reps is None else (reps, d)
    return torch.zeros(shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float = 10_000.0,
    mrope_sections: tuple | None = None,
) -> torch.Tensor:
    """Rotate ``x [..., S, H, D]`` by ``positions [..., S]``."""
    if mrope_sections is not None:
        raise NotImplementedError("M-RoPE comes with the vlm slice")
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)  # [d/2]
    angles = positions[..., None].float() * freqs  # [..., S, d/2]
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def init_attention(gen, cfg, plan, *, reps: int, device) -> dict:
    """Stacked ``[reps, ...]`` attention weights."""
    d, h, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim
    dtype = getattr(torch, cfg.dtype)
    scale = d**-0.5
    return {
        "wq": normal(gen, (reps, d, h, dh), dtype, device, scale),
        "wk": normal(gen, (reps, d, hkv, dh), dtype, device, scale),
        "wv": normal(gen, (reps, d, hkv, dh), dtype, device, scale),
        "wo": normal(gen, (reps, h, dh, d), dtype, device, (h * dh) ** -0.5),
    }


@dataclasses.dataclass
class DecodeWrites:
    """Where a decode step writes its chunk's K/V: the same rows and
    destinations for every layer, so :func:`decode_writes` runs once per
    step (its row selection is the step's one host sync, taken before any
    layer's work is queued).  ``rows`` index the flattened ``[B * C]``
    chunk; ``slot``/``pos`` address a dense cache, ``pid``/``off`` a page
    pool."""

    rows: torch.Tensor
    slot: torch.Tensor | None = None
    pos: torch.Tensor | None = None
    pid: torch.Tensor | None = None
    off: torch.Tensor | None = None


def _positions(t, b: int, c: int, device) -> torch.Tensor:
    """``[B, C]`` absolute positions ``t .. t+C-1`` (t scalar or ``[B]``)."""
    tv = torch.as_tensor(t, device=device).to(torch.int64)
    tv = tv.expand(b) if tv.dim() == 0 else tv
    return tv[:, None] + torch.arange(c, device=device)


def decode_writes(
    t, b: int, c: int, *, write_mask=None, cache_len: int | None = None,
    page_table: torch.Tensor | None = None, page: int | None = None, device=None,
) -> DecodeWrites:
    """Rows that write K/V this step, with their destinations.

    Dense: position ``pos % cache_len`` of the row's own slot (ring-buffer
    semantics).  Paged: ``(table[b, pos // page], pos % page)``.  Rows whose
    ``write_mask`` is off (dead continuous-batching slots) or whose table
    entry is -1 are dropped, as the JAX scatter drops out-of-bounds rows."""
    pos_c = _positions(t, b, c, device)
    keep = torch.ones((b, c), dtype=torch.bool, device=device)
    if write_mask is not None:
        keep &= write_mask.to(device)[:, None]
    bi = torch.arange(b, device=device)[:, None].expand(b, c)
    if page_table is None:
        rows = keep.reshape(-1).nonzero().squeeze(1)
        return DecodeWrites(
            rows=rows, slot=bi.reshape(-1)[rows], pos=(pos_c % cache_len).reshape(-1)[rows]
        )
    maxp = page_table.shape[1]
    logical = torch.clamp(pos_c // page, max=maxp - 1)
    pid = torch.gather(page_table.long(), 1, logical)
    keep &= pid >= 0
    rows = keep.reshape(-1).nonzero().squeeze(1)
    return DecodeWrites(
        rows=rows, pid=pid.reshape(-1)[rows], off=(pos_c % page).reshape(-1)[rows]
    )


def _decode_attention(
    q: torch.Tensor,  # [B, C, H, dh]
    k_new: torch.Tensor,  # [B, C, Hkv, dh]
    v_new: torch.Tensor,
    cache: dict,
    t,  # first written position (scalar or [B])
    *,
    window: int | None,
    softcap: float | None,
    write_mask: torch.Tensor | None = None,
    writes: DecodeWrites | None = None,
) -> tuple[torch.Tensor, dict]:
    """Chunk attention against a ``[B, S, Hkv, dh]`` cache: positions
    ``t .. t+C-1`` are written (in place) and attended causally together
    with the ``<= t`` prefix."""
    ck, cv = cache["k"], cache["v"]
    b, s = ck.shape[0], ck.shape[1]
    c = q.shape[1]
    if writes is None:
        writes = decode_writes(t, b, c, write_mask=write_mask, cache_len=s, device=q.device)
    rows = writes.rows
    # In place: the step's K/V land in the caller's cache tensors.
    ck[writes.slot, writes.pos] = k_new.reshape(b * c, *k_new.shape[2:])[rows].to(ck.dtype)
    cv[writes.slot, writes.pos] = v_new.reshape(b * c, *v_new.shape[2:])[rows].to(cv.dtype)
    out = _attend_cache_view(
        q, ck, cv, _positions(t, b, c, q.device), window=window, softcap=softcap
    )
    return out, {"k": ck, "v": cv}


def _attend_cache_view(
    q: torch.Tensor,  # [B, C, H, dh]
    ck: torch.Tensor,  # [B, S, Hkv, dh] — dense cache or gathered paged view
    cv: torch.Tensor,
    pos_c: torch.Tensor,  # [B, C] absolute position of each chunk row
    *,
    window: int | None,
    softcap: float | None,
) -> torch.Tensor:
    """Full-softmax chunk attention against a contiguous K/V view.

    Shared by the dense path and the paged path's gathered view on the CPU:
    positions past ``pos_c`` are forced to -1e30 before the softmax, so the
    two run identical math on identical post-mask values (paged and dense
    bit-identical).  Operands in their own dtype, rounded as the JAX code
    rounds them, with f32 accumulation."""
    b, s, hkv, dh = ck.shape
    c, h = q.shape[1], q.shape[2]
    group = h // hkv
    qg = (q * dh**-0.5).reshape(b, c, hkv, group, dh)
    logits = torch.einsum("bckgd,bskd->bkgcs", qg.float(), ck.float())  # [B,Hkv,g,C,S]
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(s, device=q.device)
    valid = pos[None, None, :] <= pos_c[:, :, None]  # [B, C, S]
    if window is not None:
        valid &= (pos_c[:, :, None] - pos[None, None, :]) < window
    logits = torch.where(valid[:, None, None], logits, torch.full_like(logits, _NEG))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum(
        "bkgcs,bskd->bckgd", probs.to(cv.dtype).float(), cv.float()
    ).reshape(b, c, h, dh)
    return out.to(q.dtype)


def _paged_decode_attention(
    q: torch.Tensor,  # [B, C, H, dh]
    k_new: torch.Tensor,  # [B, C, Hkv, dh]
    v_new: torch.Tensor,
    cache: dict,  # {"k","v": [N, page, Hkv, dh]} page pool shared by slots
    page_table: torch.Tensor,  # [B, P] i32 page ids, -1 = unallocated
    t,  # first written position (scalar or [B])
    *,
    window: int | None,
    softcap: float | None,
    write_mask: torch.Tensor | None = None,
    writes: DecodeWrites | None = None,
) -> tuple[torch.Tensor, dict]:
    """Paged-cache counterpart of :func:`_decode_attention`.

    K/V for positions ``t .. t+C-1`` are written IN PLACE into the page
    pool at ``(table[b, pos // page], pos % page)``.  On the card the read
    is the paged flash-decode kernel (the JAX package calls its kernel only
    on a TPU; the port calls its own wherever there is a card).  On the CPU
    the read goes through a gathered contiguous view into the shared
    full-softmax math, which keeps CPU generation bit-identical to the
    dense cache."""
    ck, cv = cache["k"], cache["v"]
    n_pages, page, hkv, dh = ck.shape
    b, c = q.shape[0], q.shape[1]
    if writes is None:
        writes = decode_writes(
            t, b, c, write_mask=write_mask, page_table=page_table, page=page,
            device=q.device,
        )
    rows = writes.rows
    # In place: the step's K/V land in the shared pool.
    ck[writes.pid, writes.off] = k_new.reshape(b * c, hkv, dh)[rows].to(ck.dtype)
    cv[writes.pid, writes.off] = v_new.reshape(b * c, hkv, dh)[rows].to(cv.dtype)
    new_cache = {"k": ck, "v": cv}
    tv = torch.as_tensor(t, device=q.device).to(torch.int32)
    tv = tv.expand(b).contiguous() if tv.dim() == 0 else tv
    if q.device.type != "cpu":
        out = ops.paged_flash_decode(
            q.contiguous(), ck, cv, page_table.to(torch.int32).contiguous(), tv,
            window=window, softcap=softcap,
        )
        return out.to(q.dtype), new_cache
    view_k = kref.paged_gather_kv(ck, page_table)
    view_v = kref.paged_gather_kv(cv, page_table)
    out = _attend_cache_view(
        q, view_k, view_v, _positions(t, b, c, q.device), window=window, softcap=softcap
    )
    return out, new_cache


def attention_apply(
    params: dict,
    x: torch.Tensor,  # [B, S, D]
    cfg,
    *,
    kind: str = "global",  # "global" | "local"
    mode: str = "train",  # "train" | "prefill" | "decode"
    positions: torch.Tensor | None = None,
    cache: dict | None = None,
    t=None,
    plan=None,
    mesh=None,
    write_mask: torch.Tensor | None = None,
    page_table: torch.Tensor | None = None,
    writes: DecodeWrites | None = None,
) -> tuple[torch.Tensor, dict | None]:
    b, s, _ = x.shape
    window = cfg.window_size if kind == "local" else None
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, params["wv"])
    if mode == "decode":
        # Per-slot positions: t scalar (lockstep) or [B] (continuous
        # batching); s > 1 writes the chunked-prefill positions t..t+s-1.
        pos = _positions(t, b, s, x.device)
        q = apply_rope(q, pos, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, pos, cfg.rope_theta, cfg.mrope_sections)
        if page_table is not None:
            out, cache = _paged_decode_attention(
                q, k, v, cache, page_table, t, window=window,
                softcap=cfg.logit_softcap, write_mask=write_mask, writes=writes,
            )
        else:
            out, cache = _decode_attention(
                q, k, v, cache, t, window=window, softcap=cfg.logit_softcap,
                write_mask=write_mask, writes=writes,
            )
    else:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        if mode == "prefill":
            cache = {"k": k, "v": v}  # [B, S, Hkv, dh]
        out = ops.flash_attention(
            q.transpose(1, 2).contiguous(),
            k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(),
            causal=True, window=window, softcap=cfg.logit_softcap,
        ).transpose(1, 2)
    y = torch.einsum("bshk,hkd->bsd", out, params["wo"])
    return y, cache


def init_attention_cache(cfg, batch: int, max_len: int, *, device, dtype=None) -> dict:
    dt = dtype or getattr(torch, cfg.dtype)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }


def init_paged_attention_cache(
    cfg, num_pages: int, page_size: int, *, device, dtype=None
) -> dict:
    """Page-pool K/V cache: ``[N, page, Hkv, dh]`` shared by every slot —
    sequences own pages through a ``[slots, P]`` table, not a batch dim."""
    dt = dtype or getattr(torch, cfg.dtype)
    shape = (num_pages, page_size, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }
