"""Batched generation: prefill a batch of prompts, then decode one token
per step against the dense caches, greedy or sampled.

Port of :mod:`repro.serve.decode` (``generate``).  The steps are
:func:`repro_torch.train.train_step.make_prefill_step` and
``make_serve_step``; caches are written in place.
"""

from __future__ import annotations

import torch

from repro_torch import prng
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
    more tokens, greedily or, with ``sample``, each row's token n drawn on
    the key ``fold(fold(PRNGKey(seed), row), n)`` (the serving engine's key
    discipline).  The prefill's token is an argmax either way, as in the
    reference.  Returns ``[B, max_new_tokens]`` i32: the prefill's next
    token, then each decoded one."""
    dev = params["embed"].device
    prompt = torch.as_tensor(prompt_tokens, device=dev).to(torch.int32)
    b, s_prompt = prompt.shape
    prefill = make_prefill_step(cfg, plan, mesh=mesh)
    step = make_serve_step(cfg, plan, mesh=mesh, sample=sample)

    next_tok, caches = prefill(params, {"tokens": prompt, **(extra_batch or {})})
    caches = tfm.pad_caches(caches, s_prompt + max_new_tokens)
    row_keys = (prng.fold_in(prng.prng_key(seed, dev), torch.arange(b, device=dev))
                if sample else None)
    out = [next_tok]
    tok = next_tok
    for i in range(max_new_tokens - 1):
        sub = prng.fold_in(row_keys, i + 1) if sample else None
        tok, caches = step(params, caches, tok, torch.tensor(s_prompt + i, device=dev), sub)
        out.append(tok)
    return torch.cat(out, dim=1)
