"""A prefix-cache hit against a miss through the port's ServeEngine,
shared by the CPU test (``test_torch_fleet.py``) and the card test
(``test_torch_cuda.py``).  Imports no JAX."""

import numpy as np

from repro_torch.models import transformer as tfm
from repro_torch.parallel.sharding import make_plan
from repro_torch.serve.batching import Request
from repro_torch.serve.engine import ServeConfig, ServeEngine
from repro_torch.train import train_step


def admission_logits(monkeypatch):
    """Record the last row of every logits tensor the serving steps compute
    (the outermost call only: ``_decode_logits`` calls the LM head on row
    blocks)."""
    seen, depth = [], [0]
    for mod, name in ((train_step, "_decode_logits"), (tfm, "logits_from_features")):
        fn = getattr(mod, name)

        def rec(*a, _fn=fn, **kw):
            depth[0] += 1
            try:
                out = _fn(*a, **kw)
            finally:
                depth[0] -= 1
            if not depth[0]:
                seen.append(out[:, -1].float().cpu())
            return out

        monkeypatch.setattr(mod, name, rec)
    return seen


def prefix_hit_and_miss(params, cfg, dev, seen):
    """Prompt B (a 64-token prefix, its own 36-token tail) admitted into a
    fresh engine (a miss) and into one where prompt A (same prefix, another
    tail) came first (a hit on 4 pages): B's admission logits and its 10
    greedy tokens in each."""
    rng = np.random.default_rng(12)
    prefix = rng.integers(1, cfg.vocab_size - 1, size=64).astype(np.int32)
    a = np.concatenate([prefix, rng.integers(1, cfg.vocab_size - 1, size=36).astype(np.int32)])
    b = np.concatenate([prefix, rng.integers(1, cfg.vocab_size - 1, size=36).astype(np.int32)])
    out = {}
    for warm in (False, True):
        eng = ServeEngine(params, cfg, make_plan(None),
                          ServeConfig(slots=2, max_len=256, page_size=16), device=dev)
        if warm:
            eng.submit(Request(rid=0, prompt=a, max_new_tokens=10))
            eng.step()
        hits = eng.batcher.alloc.prefix_hit_pages
        del seen[:]
        eng.submit(Request(rid=1, prompt=b, max_new_tokens=10))
        eng.step()
        logits = seen[0]
        assert eng.batcher.alloc.prefix_hit_pages - hits == (4 if warm else 0)
        while eng.batcher.busy:
            eng.step()
        toks = {r.rid: r.out for r in eng.batcher.finished}[1]
        assert len(toks) == 10
        out[warm] = (logits, toks)
    return out
