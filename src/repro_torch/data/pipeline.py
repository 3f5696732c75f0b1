"""Deterministic data pipeline (a copy of :mod:`repro.data.pipeline`, which
is plain numpy: the same seed gives the same token streams in both
packages).

``SyntheticLM`` generates reproducible pseudo-text token streams (a mixture
of Zipfian unigrams and short repeated motifs so the loss actually has
structure to learn), sharded by (host, step) so every host reads a disjoint
stream — the standard multi-host input pattern, degenerate on one host.
``FileLM`` byte-tokenizes a local file for the end-to-end examples.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticLM", "FileLM", "Batch"]


@dataclasses.dataclass
class Batch:
    tokens: np.ndarray  # [B, S] int32
    labels: np.ndarray  # [B, S] int32 (next-token)


class SyntheticLM:
    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        global_batch: int,
        *,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
    ):
        if global_batch % num_hosts:
            raise ValueError("global batch must divide hosts")
        self.vocab = vocab_size
        self.seq = seq_len
        self.host_batch = global_batch // num_hosts
        self.seed = seed
        self.host_id = host_id
        self.step = 0
        # Zipfian unigram table (deterministic).
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.host_id) * 7_919 + self.step
        )
        b, s = self.host_batch, self.seq
        toks = rng.choice(self.vocab, size=(b, s + 1), p=self._probs).astype(np.int32)
        # Inject learnable motifs: short repeats at random offsets.
        for i in range(b):
            motif = rng.integers(0, self.vocab, size=8)
            for _ in range(max(s // 64, 1)):
                off = int(rng.integers(0, s - 8))
                toks[i, off : off + 8] = motif
        self.step += 1
        return Batch(tokens=toks[:, :-1], labels=toks[:, 1:])


class FileLM:
    """Byte-level tokens from a file, chunked into fixed windows."""

    def __init__(self, path: str, seq_len: int, global_batch: int, *, vocab_size: int = 256):
        data = np.frombuffer(open(path, "rb").read(), dtype=np.uint8)
        if vocab_size < 256:
            data = data % vocab_size
        self.data = data.astype(np.int32)
        self.seq = seq_len
        self.batch = global_batch
        self.pos = 0

    def __iter__(self):
        return self

    def __next__(self) -> Batch:
        need = self.batch * (self.seq + 1)
        if self.pos + need > len(self.data):
            self.pos = 0
        chunk = self.data[self.pos : self.pos + need].reshape(self.batch, self.seq + 1)
        self.pos += need
        return Batch(tokens=chunk[:, :-1], labels=chunk[:, 1:])
