"""Batched greedy generation: prefill a batch of prompts, then decode one
token per step against the dense caches.

Port of :mod:`repro.serve.decode` (``generate``).  The steps are
:func:`repro_torch.train.train_step.make_prefill_step` and
``make_serve_step``; caches are written in place.  Sampled decoding comes
with its slice.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as tfm
from repro_torch.train.train_step import make_prefill_step, make_serve_step

__all__ = ["generate"]


@torch.no_grad()
def generate(
    params,
    cfg,
    plan,
    prompt_tokens,
    *,
    max_new_tokens: int = 32,
    mesh=None,
    sample: bool = False,
    seed: int = 0,
    extra_batch: dict | None = None,
) -> torch.Tensor:
    """Prefill ``prompt_tokens [B, S_prompt]`` (a tensor or an array; it
    goes to the parameters' device), then decode ``max_new_tokens - 1``
    more tokens greedily.  Returns ``[B, max_new_tokens]`` i32: the
    prefill's next token, then each decoded one."""
    if sample:
        raise NotImplementedError("sampled decoding comes with its slice")
    dev = params["embed"].device
    prompt = torch.as_tensor(prompt_tokens, device=dev).to(torch.int32)
    b, s_prompt = prompt.shape
    prefill = make_prefill_step(cfg, plan, mesh=mesh)
    step = make_serve_step(cfg, plan, mesh=mesh)

    next_tok, caches = prefill(params, {"tokens": prompt, **(extra_batch or {})})
    caches = tfm.pad_caches(caches, s_prompt + max_new_tokens)
    out = [next_tok]
    tok = next_tok
    for i in range(max_new_tokens - 1):
        tok, caches = step(params, caches, tok, torch.tensor(s_prompt + i, device=dev))
        out.append(tok)
    return torch.cat(out, dim=1)
