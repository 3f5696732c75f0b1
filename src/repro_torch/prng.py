"""Counter-based random numbers drawn as ``jax.random`` draws them.

The serving engine's sampled decoding keys every emitted token with
``fold_in(fold_in(PRNGKey(seed), request), token index)`` and draws a
Gumbel-argmax from that key, as the JAX package does (DESIGN.md §11).  This
module is the counterpart of the parts of ``jax.random`` that path calls,
for jax's default threefry2x32 generator with ``jax_threefry_partitionable``
on (jax 0.9's default) and the "low" Gumbel mode:

- ``prng_key`` — ``jax.random.PRNGKey`` (``prng.threefry_seed``);
- ``fold_in`` — ``jax.random.fold_in`` (``prng._threefry_fold_in``);
- ``random_bits`` — ``jax.random.bits`` at 32 bits
  (``prng._threefry_random_bits_partitionable``, counters from
  ``prng.iota_2x32_shape``);
- ``uniform``, ``gumbel``, ``categorical`` — ``random._uniform``,
  ``random._gumbel`` (mode "low"), ``random.categorical`` for one key.

A key is an int64 tensor ``[..., 2]`` holding two uint32 words, and every
function takes a batch of keys (leading dims) and broadcasts.  The words are
int64 tensors holding uint32 values, masked after every add and rotate, so
the integer math runs on the keys' device (the card on the serving path)
with no host loop: keys, bits and the uniform's float bits equal JAX's
exactly.  ``gumbel``'s two logs are PyTorch's and may differ from XLA's by
an ulp.
"""

from __future__ import annotations

import math

import torch

__all__ = ["prng_key", "fold_in", "random_bits", "uniform", "gumbel", "categorical"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & _MASK) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The threefry2x32 hash of counter words ``(x1, x2)`` under key words
    ``(k1, k2)`` (all broadcast): 20 rounds and 5 key injections, as
    ``jax._src.prng._threefry2x32_lowering``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0, x1 = (x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a seed that fits in 32 bits: the
    words ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: the key ``[..., 2]`` hashed with the counter
    ``(0, data mod 2**32)``; ``data`` an int or an integer tensor that
    broadcasts against the key's leading dims."""
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & _MASK
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(o1, o2), dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32), for every key of
    ``key [..., 2]``: ``[..., *shape]`` int64 tensor of uint32 values.  The
    counter of element n (row-major) is the 64-bit n split in two words, and
    the draw is the xor of the hash's two outputs."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(*lead, 1)
    k2 = key[..., 1].reshape(*lead, 1)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & _MASK)
    return (b1 ^ b2).reshape(*lead, *shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits of each draw as
    the mantissa of a float in [1, 2), minus 1, scaled into [minval,
    maxval) and clipped below at minval."""
    bits = random_bits(key, shape)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` in float32, mode "low": ``-log(-log(u))`` of
    a uniform draw on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, _F32_TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` along the last axis for ONE
    key ``[2]``: the argmax of the logits plus Gumbel noise of their whole
    shape."""
    return torch.argmax(gumbel(key, logits.shape) + logits, dim=-1)
