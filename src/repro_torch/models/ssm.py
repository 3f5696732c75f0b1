"""Mamba-2 SSD (state-space duality) block — arXiv:2405.21060.

Port of :mod:`repro.models.ssm`.  Training and prefill use the chunked
dual form: the quadratic attention-like pass inside each length-``L``
chunk and the chunk states go through :func:`ops.ssd_chunk` (the
hand-written kernel on the card, its plain version on the CPU; the JAX
package runs the same einsums inline), then a linear recurrence over the
chunks runs as a Python loop in f32.  Decode is the pure recurrence on a
``[B, H, P, N]`` state, written into the caller's cache IN PLACE.  The
gated norm goes through :func:`ops.rmsnorm`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import normal

__all__ = ["init_ssm", "ssm_apply", "init_ssm_cache"]


def init_ssm(gen: torch.Generator, cfg, plan, *, reps: int, device) -> dict:
    """Stacked ``[reps, ...]`` block weights, the reference's names, shapes
    and dtypes: ``dt_bias``, ``A_log`` and ``D`` stay f32."""
    s = cfg.ssm
    d = cfg.d_model
    inner = s.expand * d
    heads = inner // s.head_dim
    dtype = getattr(torch, cfg.dtype)
    f32 = dict(dtype=torch.float32, device=device)

    def rnd(shape, scale):
        return normal(gen, (reps, *shape), dtype, device, scale)

    return {
        # Fused input projection: [z | x | B | C | dt].
        "w_z": rnd((d, inner), d**-0.5),
        "w_x": rnd((d, inner), d**-0.5),
        "w_B": rnd((d, s.state_dim), d**-0.5),
        "w_C": rnd((d, s.state_dim), d**-0.5),
        "w_dt": rnd((d, heads), d**-0.5),
        "dt_bias": torch.zeros((reps, heads), **f32),
        "A_log": torch.zeros((reps, heads), **f32),  # A = -exp(A_log)
        "D": torch.ones((reps, heads), **f32),
        "conv": rnd((s.conv_width, inner), 0.1),
        "norm": torch.zeros((reps, inner), dtype=dtype, device=device),
        "w_out": rnd((inner, d), inner**-0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None):
    """Depthwise causal conv, width W.  ``x [B, S, C]``, ``w [W, C]``.
    Returns ``(silu(y), new_state)``; the state carries the last W-1 inputs
    (in x's dtype) for decode continuation."""
    width = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # [B, S+W-1, C]
    y = sum(xp[:, i : i + x.shape[1], :] * w[i][None, None, :] for i in range(width))
    new_state = xp[:, -(width - 1) :, :]
    return F.silu(y), new_state


def _ssd_chunked(x, dt, a_log, bmat, cmat, chunk: int):
    """Chunked SSD scan.  ``x [B, S, H, P]``, ``dt [B, S, H]`` (softplus-ed),
    ``a_log [H]``, ``bmat``/``cmat [B, S, N]`` -> ``y [B, S, H, P]``, f32.

    The chunk length is the largest divisor of S not above ``chunk`` (a
    prime S above it gives L = 1).  Groups of :func:`ops.ssd_chunk` are
    ordered (batch, chunk, head); B and C go in once per (batch, chunk)."""
    b, s_len, h, p = x.shape
    n = bmat.shape[-1]
    l = min(chunk, s_len)
    while s_len % l:
        l -= 1
    c = s_len // l
    a = -torch.exp(a_log)  # [H] negative
    xd = x * dt[..., None]  # dt-weighted input
    da = dt * a  # [B, S, H] log-decay per step

    xc = xd.reshape(b, c, l, h, p)
    dac = da.reshape(b, c, l, h)
    cc = cmat.reshape(b, c, l, n)
    cum = torch.cumsum(dac, dim=2)  # [B, c, L, H] within-chunk cumulative decay

    # ---- intra-chunk output and chunk states (kernel 9) ------------------
    y_intra, states = ops.ssd_chunk(
        xc.permute(0, 1, 3, 2, 4).reshape(b * c * h, l, p),
        dac.permute(0, 1, 3, 2).reshape(b * c * h, l),
        bmat.reshape(b * c, l, n),
        cc.reshape(b * c, l, n),
        heads=h,
    )
    y_intra = y_intra.reshape(b, c, h, l, p).permute(0, 1, 3, 2, 4)  # [B, c, L, H, P]
    # The kernel gives [.., N, P]; the reference's einsum "bchpn".
    states = states.reshape(b, c, h, n, p).transpose(-1, -2)  # [B, c, H, P, N]

    # ---- inter-chunk recurrence (a loop over chunks, f32) ------------------
    chunk_decay = torch.exp(cum[:, :, -1, :]).float()  # [B, c, H]
    hcur = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    h_prevs = []
    for ci in range(c):
        h_prevs.append(hcur)
        hcur = hcur * chunk_decay[:, ci, :, None, None] + states[:, ci].float()
    h_prevs = torch.stack(h_prevs, dim=1)  # [B, c, H, P, N]

    decay_from_start = torch.exp(cum)  # [B, c, L, H]
    y_inter = torch.einsum(
        "bcln,bclh,bchpn->bclhp", cc, decay_from_start, h_prevs.to(cc.dtype)
    )
    return (y_intra + y_inter).reshape(b, s_len, h, p)


def ssm_apply(params, x: torch.Tensor, cfg, *, mode: str = "train", cache=None, t=None):
    """Mamba-2 block.  ``x [B, S, D] -> [B, S, D]``; decode keeps S == 1.

    ``mode="prefill"`` returns the final ``{"state": [B, H, P, N] f32,
    "conv": [B, W-1, inner]}`` cache (conv in x's dtype, as the reference);
    ``mode="decode"`` advances ``cache`` one token IN PLACE (each leaf keeps
    its dtype, so a bf16 model's f32 conv leaf holds bf16-rounded values, as
    the reference's ``astype`` on write-back) and returns it."""
    s = cfg.ssm
    b, seq, d = x.shape
    inner = s.expand * d
    heads = inner // s.head_dim
    z = x @ params["w_z"]
    xi = x @ params["w_x"]
    bm = x @ params["w_B"]
    cm = x @ params["w_C"]
    dt = F.softplus((x @ params["w_dt"]).float() + params["dt_bias"])  # [B, S, H]

    if mode == "decode":
        xi, new_conv = _causal_conv(xi, params["conv"], cache["conv"])
        xh = xi.reshape(b, 1, heads, s.head_dim)
        a = -torch.exp(params["A_log"])
        h_prev = cache["state"]  # [B, H, P, N]
        dec = torch.exp(dt[:, 0, :] * a)  # [B, H]
        upd = torch.einsum(
            "bn,bhp->bhpn", bm[:, 0].float(), (xh[:, 0] * dt[:, 0, :, None]).float()
        )
        h_new = h_prev * dec[:, :, None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", cm[:, 0].float(), h_new)
        y = y + params["D"][:, None] * xh[:, 0].float()
        y = y.reshape(b, 1, inner).to(x.dtype)
        cache["state"].copy_(h_new)
        cache["conv"].copy_(new_conv)
    else:
        xi, new_conv = _causal_conv(xi, params["conv"], None)
        xh = xi.reshape(b, seq, heads, s.head_dim)
        y = _ssd_chunked(
            xh.float(), dt, params["A_log"], bm.float(), cm.float(), s.chunk,
        )
        y = y + params["D"][None, None, :, None] * xh.float()
        y = y.reshape(b, seq, inner).to(x.dtype)
        if mode == "prefill":
            # Final state for decode continuation: the recurrence's tail as
            # one einsum over the whole prompt.
            a = -torch.exp(params["A_log"])
            da = dt * a
            cum_total = torch.cumsum(da, dim=1)
            decay_to_end = torch.exp(cum_total[:, -1:, :] - cum_total)
            state = torch.einsum(
                "bsn,bsh,bshp->bhpn", bm.float(), decay_to_end, (xh * dt[..., None]).float()
            )
            cache = {"state": state, "conv": new_conv}
    y = ops.rmsnorm(y.reshape(b * seq, inner), params["norm"], eps=cfg.norm_eps,
                    gate=z.reshape(b * seq, inner))
    return y.reshape(b, seq, inner) @ params["w_out"], cache


def init_ssm_cache(cfg, batch: int, *, device) -> dict:
    s = cfg.ssm
    inner = s.expand * cfg.d_model
    heads = inner // s.head_dim
    return {
        "state": torch.zeros((batch, heads, s.head_dim, s.state_dim), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, inner), dtype=torch.float32, device=device),
    }
