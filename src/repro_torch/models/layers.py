"""Shared neural layers: norms, RoPE, GQA attention for prefill and decode
over a dense or paged KV cache, and the dense MLP block.

Port of :mod:`repro.models.layers`.  Layers are plain functions on tensors
with the JAX package's layouts at the public functions (``wq [d, h, dh]``,
caches ``[B, S, Hkv, dh]``, page pools ``[N, page, Hkv, dh]``).  Decode
writes its chunk's K/V into the cache IN PLACE (index writes into the
caller's tensors: no copy of a multi-GB cache per tick).  MLA comes with
a later slice.

Over a model axis (``plan`` and ``mesh`` with tensor parallelism on,
:mod:`repro_torch.parallel.tp`) attention runs the rank's q heads with the
kv heads they read (the rank's shard of them, or the reference's repeat of
replicated kv heads up to the axis size), and its decode caches hold those
kv heads only; the MLP is column-parallel then row-parallel.  Either
block's input products are ``tp.column_parallel`` (the input gradient
summed over the axis in f32) and its output projection's f32 partials are
summed over the axis and cast once.  Whether a block runs
so is read off its leaves: a leaf narrower than the config's is the rank's
shard (:class:`~repro_torch.parallel.sharding.TreeLayout` decides).

Sequence parallelism (``sp=True``, the reference's ``mlp_apply_sp`` and
``oproj_sp``, ``layers.py:565-641``): the block's input is the rank's
``[B, S / P, D]`` slice of a sequence-sharded stream; a tensor-parallel
block gathers the sequence before its column products
(``tp.seq_gather``) and sums its row-parallel partials into the rank's
slice (``tp.seq_scatter``), a block whose sizes do not divide the model
axis runs whole on the gathered sequence and keeps the rank's slice of its
output.  Either way every element is the replicated stream's bits.

A training norm (:func:`rms_norm` with ``tree``) sums its weight gradient
as a fixed tree over ``tp.TREE_LEAVES`` sequence blocks, which one device,
a tensor-parallel rank and a sequence-parallel rank (its blocks, then the
model axis's ranks) all take: the stream's sequence split leaves the bits
as they are.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.parallel import tp
from repro_torch.parallel.sharding import local_kv_heads, token_gather, token_slice

__all__ = [
    "rms_norm", "init_rms_norm", "rope_frequencies", "apply_rope",
    "init_attention", "attention_apply", "init_attention_cache",
    "init_paged_attention_cache", "DecodeWrites", "decode_writes", "normal", "decode_rows",
    "DECODE_ROWS", "column_products", "row_products", "init_mlp", "mlp_apply", "ffn",
    "kv_heads_of_rank", "can_use_sp_mlp", "norm_tree", "whole_in_sp",
]

_NEG = -1e30

# Rows of every decode-mode product (see ``decode_rows``).
DECODE_ROWS = 32


def decode_rows(fn, *xs: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``fn(*xs)`` for a row-wise product whose rows lie along ``dim`` of
    every input (and of its output), run on blocks of exactly
    ``DECODE_ROWS`` rows, the last one zero-padded.

    A library GEMM picks its algorithm, and with it the order of each row's
    sums, from the call's shapes: on the H100, cuBLAS rounds a row of
    ``[M, 6144] @ [6144, 6144]`` (grok-1's q and o projections) and of the
    f32 router product differently at M = 4 and M = 20.  Every decode-mode
    product runs through here, so a row's bits never depend on how many
    rows share the call, and a speculative verify pass over B x (k + 1)
    rows reproduces a serial tick's B rows bit for bit.  Each block is a
    fresh contiguous tensor, so the library also sees the same alignment."""
    m = xs[0].shape[dim]
    pad = -m % DECODE_ROWS
    if pad:
        xs = [torch.cat([x, x.new_zeros(x.shape[:dim] + (pad,) + x.shape[dim + 1:])], dim)
              for x in xs]
    blocks = zip(*(x.split(DECODE_ROWS, dim) for x in xs))
    outs = [fn(*(b.contiguous() for b in blk)) for blk in blocks]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim)
    return out.narrow(dim, 0, m) if pad else out


def normal(gen: torch.Generator, shape, dtype, device, scale: float) -> torch.Tensor:
    """Seeded N(0, 1) * scale, drawn directly in ``dtype`` on ``device``
    (scaled in place: one buffer even for multi-GB expert stacks)."""
    return torch.randn(shape, generator=gen, dtype=dtype, device=device).mul_(scale)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, tree=None) -> torch.Tensor:
    """RMSNorm over the last dim, ``[..., D]`` as ``[T, D]`` through
    :func:`ops.rmsnorm`: kernel 8 on the card (its backward kernel when a
    gradient is wanted), the plain version on the CPU.  ``tree``
    (:func:`norm_tree`'s, for ``x [B, S', D]``): the stream's norm in train
    and prefill mode, the weight gradient summed as the tree over sequence
    blocks (:class:`_TreeNorm`), a sequence-parallel rank's launch shaped as
    the whole stream's."""
    if tree is None:
        return ops.rmsnorm(x.reshape(-1, x.shape[-1]), w, eps=eps).reshape(x.shape)
    n, group, p = tree
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _TreeNorm.apply(x, w, eps, n, group, p)
    b, s, d = x.shape
    return ops.rmsnorm(x.reshape(-1, d), w, eps=eps, shape_rows=b * s * p).reshape(x.shape)


def norm_tree(x: torch.Tensor, plan=None, mesh=None, sp: bool = False):
    """The ``tree`` argument of :func:`rms_norm` for a stream ``x [B, S',
    D]`` in train or prefill mode: ``(blocks this rank sums, the model
    group or None, the ranks sharing the sequence)``; one device and a
    replicated stream take ``tp.TREE_LEAVES`` blocks, a sequence-parallel
    rank ``tp.leaves(P)`` and the model axis (one block where they do not
    divide its rows)."""
    s = x.shape[1]
    if not sp:
        return (tp.TREE_LEAVES if s % tp.TREE_LEAVES == 0 else 1), None, 1
    n = tp.leaves(plan.model_size)
    return (n if s % n == 0 else 1), tp.model_group(plan, mesh), plan.model_size


class _TreeNorm(torch.autograd.Function):
    """The norm of ``x [B, S', D]`` as one launch over its rows (shaped as
    the whole stream's over ``p`` ranks); the backward runs kernel 8's
    backward on each of ``n`` sequence blocks (``[B, S' / n, D]`` rows:
    the same shape on one device and on every rank) and sums their f32
    weight gradients as the tree, the rank's blocks then the ranks' sums
    over ``group`` in rank order (``tp._across``), cast once."""

    @staticmethod
    def forward(ctx, x, w, eps, n, group, p):
        ctx.eps, ctx.n, ctx.group = eps, n, group
        ctx.save_for_backward(x, w)
        b, s, d = x.shape
        return ops.rmsnorm(x.reshape(-1, d), w, eps=eps, shape_rows=b * s * p).reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        b, s, d = x.shape
        k = s // ctx.n
        dxs, dws = [], []
        for i in range(ctx.n):
            xb = x[:, i * k:(i + 1) * k].reshape(-1, d).contiguous()
            dyb = dy[:, i * k:(i + 1) * k].reshape(-1, d).contiguous()
            dx, dw = ops.rmsnorm_bwd(xb, w, dyb, eps=ctx.eps)
            dxs.append(dx.reshape(b, k, d))
            dws.append(dw.float())
        dx = dxs[0] if ctx.n == 1 else torch.cat(dxs, dim=1)
        return dx, tp._across(tp._tree(dws), ctx.group, w.dtype), None, None, None, None


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
    sp: bool = False,
) -> tuple[torch.Tensor, dict | None]:
    """GQA attention over ``x [B, S, D]`` (``sp``: the rank's ``[B, S / P,
    D]`` slice of a sequence-parallel stream; the output is then the
    rank's slice too)."""
    sharded = tp.enabled(plan, mesh) and params["wq"].shape[1] < cfg.num_heads
    if sp and not sharded:
        # Heads the model axis does not divide: whole attention on the
        # gathered sequence, the rank's slice of its output.
        return whole_in_sp(lambda xg: attention_apply(
            params, xg, cfg, kind=kind, mode=mode, positions=positions, cache=cache, t=t,
            write_mask=write_mask, page_table=page_table, writes=writes), x, plan, mesh)
    if sp:
        xg = tp.seq_gather(x, plan, mesh)  # [B, S, D] f32: the partials come back here
    else:
        xg = x
    b, s, _ = xg.shape
    window = cfg.window_size if kind == "local" else None
    # Decode-mode products on fixed row blocks (``decode_rows``): a verify
    # pass's rows equal a serial tick's.
    fixed = mode == "decode"
    tpp = (plan, mesh) if sharded else (None, None)
    wq, wk, wv = params["wq"], params["wk"], params["wv"]
    if sharded and wk.shape[1] == cfg.num_kv_heads:
        # Replicated kv heads: the ones the rank's q heads read, their
        # gradient summed over the axis (each rank reads a part).
        idx = kv_heads_of_rank(cfg, plan, tp.model_rank(plan, mesh))
        wk = tp.copy_to_model(wk, plan, mesh)[:, idx]
        wv = tp.copy_to_model(wv, plan, mesh)[:, idx]
    ws = [w.reshape(w.shape[0], -1) for w in (wq, wk, wv)]
    if sp:
        ys = tp.column_parallel(xg.reshape(b * s, -1), ws, plan, mesh, reduce=False)
    else:
        ys = column_products(xg.reshape(b * s, -1), ws, fixed, *tpp)
    q, k, v = (y.reshape(b, s, -1, w.shape[-1]) for y, w in zip(ys, (wq, wk, wv)))
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
    wo = params["wo"].reshape(-1, params["wo"].shape[-1])
    if sp:
        return _sp_row_out(out.reshape(b * s, -1), wo, b, s, plan, mesh), cache
    return row_products(out.reshape(b * s, -1), wo, fixed, *tpp).reshape(b, s, -1), cache


def whole_in_sp(fn, x: torch.Tensor, plan, mesh):
    """``fn`` of the whole sequence for a rank's slice ``x [B, S / P, D]`` of a
    sequence-parallel stream: the slices all-gathered (the backward keeps
    the rank's slice of the gradient every rank computes alike), ``fn``
    run as on a replicated stream, the rank's slice of its output kept (the
    backward all-gathers the slices' gradients).  Returns what ``fn`` does
    with its first value sliced."""
    s = x.shape[1] * plan.model_size
    got = fn(token_gather(x, plan, mesh, s))
    if isinstance(got, tuple):
        return (token_slice(got[0], plan, mesh), *got[1:])
    return token_slice(got, plan, mesh)


def _sp_row_out(h: torch.Tensor, w: torch.Tensor, b: int, s: int, plan, mesh) -> torch.Tensor:
    """A sequence-parallel block's output product: the rank's rows of the
    row-parallel ``h [B * S, K / P] @ w [K / P, N]`` as f32 leaves
    (``tp.partial_mm``), summed over the model axis into the rank's ``[B,
    S / P, N]`` sequence slice (``tp.seq_scatter``), cast once."""
    part = tp.partial_mm(h, w, tp.leaves(plan.model_size)).reshape(b, s, -1)
    return tp.seq_scatter(part, plan, mesh, h.dtype)


def column_products(x: torch.Tensor, ws, fixed_rows: bool, plan=None, mesh=None) -> list:
    """``x [M, K]`` through column blocks ``ws`` (``[K, N_i]``, the rank's
    shards over ``plan``'s model axis when ``mesh`` is given), a block's
    input products: ``tp.column_parallel`` (the input gradient summed in
    f32 and cast once), or in decode mode products on ``decode_rows``
    blocks."""
    if not fixed_rows:
        return list(tp.column_parallel(x, ws, plan, mesh))
    if mesh is not None:
        x = tp.copy_to_model(x, plan, mesh)
    return [decode_rows(lambda r, w=w: r @ w, x) for w in ws]


def row_products(h: torch.Tensor, w: torch.Tensor, fixed_rows: bool, plan=None, mesh=None
                 ) -> torch.Tensor:
    """``h [M, K] @ w [K, N]``, a block's output product, as the f32 tree of
    ``tp.TREE_LEAVES`` K-block products cast once; with ``mesh`` the rank's
    rows of a row-parallel product (its leaves, then ``tp.across`` the
    model axis).  ``fixed_rows``: on ``decode_rows`` blocks."""
    n = tp.TREE_LEAVES if mesh is None else tp.leaves(plan.model_size)

    def rows(r):
        return tp.partial_mm(r, w, n)

    part = decode_rows(rows, h) if fixed_rows else rows(h)
    return part.to(h.dtype) if mesh is None else tp.across(part, plan, mesh, h.dtype)


def kv_heads_of_rank(cfg, plan, m: int) -> list[int]:
    """The kv heads rank ``m``'s q heads read, in its local order, when
    the q heads shard over the model axis and the kv heads do not: its
    slice of the kv heads repeated ``P / gcd(Hkv, P)`` times each (the
    reference's ``jnp.repeat``, ``layers.py:305-309``)."""
    n = local_kv_heads(cfg, plan)
    rep = n * plan.model_size // cfg.num_kv_heads
    return [(m * n + j) // rep for j in range(n)]


def init_attention_cache(cfg, batch: int, max_len: int, *, device, dtype=None,
                         plan=None) -> dict:
    """``{"k","v": [B, max_len, Hkv, dh]}``; under ``plan``'s tensor
    parallelism the rank's kv heads (``sharding.local_kv_heads``)."""
    dt = dtype or getattr(torch, cfg.dtype)
    hkv = cfg.num_kv_heads if plan is None else local_kv_heads(cfg, plan)
    shape = (batch, max_len, hkv, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }


def init_paged_attention_cache(
    cfg, num_pages: int, page_size: int, *, device, dtype=None, plan=None
) -> dict:
    """Page-pool K/V cache: ``[N, page, Hkv, dh]`` shared by every slot —
    sequences own pages through a ``[slots, P]`` table, not a batch dim;
    under ``plan``'s tensor parallelism the rank's kv heads."""
    dt = dtype or getattr(torch, cfg.dtype)
    hkv = cfg.num_kv_heads if plan is None else local_kv_heads(cfg, plan)
    shape = (num_pages, page_size, hkv, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
    }


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg, *, reps: int, device) -> dict:
    """Stacked ``[reps, ...]`` dense MLP weights: ``w_in [d, f]``, ``w_out
    [f, d]`` and, for a gated activation, ``w_gate [d, f]``."""
    d, f = cfg.d_model, cfg.d_ff
    dtype = getattr(torch, cfg.dtype)
    out = {
        "w_in": normal(gen, (reps, d, f), dtype, device, d**-0.5),
        "w_out": normal(gen, (reps, f, d), dtype, device, f**-0.5),
    }
    if cfg.act in ("silu", "swiglu", "geglu"):
        out["w_gate"] = normal(gen, (reps, d, f), dtype, device, d**-0.5)
    return out


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; PyTorch's default
    # (erf) differs from it by up to ~1e-3.
    return F.gelu(x, approximate="tanh")


def can_use_sp_mlp(cfg, plan, mesh, mode: str, seq_len: int) -> bool:
    """The reference's condition for the sequence-parallel MLP
    (``layers.py:609-618``): a model axis, not decode, and the whole
    sequence and the MLP's width (the config's: the port's leaves are the
    rank's shards) divide it; a rank's rows always divide its data axis."""
    if mesh is None or plan is None or plan.model_axis is None or mode == "decode":
        return False
    p = max(plan.model_size, 1)
    return seq_len % p == 0 and cfg.d_ff % p == 0


def mlp_apply(params: dict, x: torch.Tensor, cfg, fixed_rows: bool = False, *, plan=None,
              mesh=None, sp: bool = False) -> torch.Tensor:
    """``x [B, S, D]`` through the dense MLP: gated (``act(x @ w_gate) * (x @
    w_in)``, silu for silu/swiglu, gelu for geglu) when ``w_gate`` is there,
    else ``gelu``/``silu`` of ``x @ w_in``; then ``@ w_out``.  The three
    products are plain library matmuls, as the reference leaves them to
    XLA (:func:`ffn`).  ``fixed_rows``: on ``decode_rows`` blocks (decode
    mode), so a row's bits do not depend on how many rows share the step.
    With the rank's columns of ``w_in``, tensor-parallel over ``plan``'s
    model axis; ``sp``: ``x`` is the rank's slice of a sequence-parallel
    stream (:func:`ffn`)."""
    if "w_gate" in params:
        act = F.silu if cfg.act in ("silu", "swiglu") else _gelu
    else:
        act = _gelu if cfg.act == "gelu" else F.silu
    sharded = tp.enabled(plan, mesh) and params["w_in"].shape[-1] < cfg.d_ff
    if sp and not (sharded and can_use_sp_mlp(cfg, plan, mesh, "train",
                                              x.shape[1] * plan.model_size)):
        return whole_in_sp(lambda xg: mlp_apply(params, xg, cfg, fixed_rows), x, plan, mesh)
    return ffn(params["w_in"], params.get("w_gate"), params["w_out"], x, act, fixed_rows,
               *((plan, mesh) if sharded else (None, None)), sp=sp)


def ffn(w_in, w_gate, w_out, x: torch.Tensor, act, fixed_rows: bool, plan=None, mesh=None,
        sp: bool = False) -> torch.Tensor:
    """``x [B, S, D]`` through ``w_in`` / ``w_gate`` (``act(x @ w_gate) * (x
    @ w_in)``, or ``act(x @ w_in)`` without a gate; :func:`column_products`)
    and ``w_out`` (:func:`row_products`); with ``mesh``, the rank's columns
    and rows over ``plan``'s model axis.  ``fixed_rows``: on
    ``decode_rows`` blocks.  ``sp`` (with ``mesh``): ``x`` is the rank's
    ``[B, S / P, D]`` slice of a sequence-parallel stream, gathered before
    the column products and returned as the rank's slice of the sum (the
    reference's ``mlp_apply_sp``)."""
    gated = w_gate is not None
    ws = [w_in, w_gate] if gated else [w_in]
    if sp:
        xg = tp.seq_gather(x, plan, mesh)
        b, s, d = xg.shape
        h, *g = tp.column_parallel(xg.reshape(b * s, d), ws, plan, mesh, reduce=False)
        h = act(g[0]) * h if gated else act(h)
        return _sp_row_out(h, w_out, b, s, plan, mesh)
    b, s, d = x.shape
    h, *g = column_products(x.reshape(b * s, d), ws, fixed_rows, plan, mesh)
    h = act(g[0]) * h if gated else act(h)
    return row_products(h, w_out, fixed_rows, plan, mesh).reshape(b, s, d)
