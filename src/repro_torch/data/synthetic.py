"""Synthetic language-model data with learnable structure.

A fixed random bigram table (per seed) generates token streams, so a
trained model's loss genuinely decreases — federated examples and the
end-to-end driver verify learning, not just plumbing. Clients can get
*skewed* bigram tables (non-IID knob) by mixing a client-specific table.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seed: int = 0
    skew: float = 0.0          # 0 = IID across clients, 1 = fully client-local
    temperature: float = 1.0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # low-rank logits keep the table cheap for big vocabs
        r = 16
        self._a = rng.normal(size=(self.vocab, r)).astype(np.float32)
        self._b = rng.normal(size=(r, self.vocab)).astype(np.float32)

    def _probs_from(self, prev: np.ndarray, rng: np.random.Generator,
                    client_shift: Optional[np.ndarray]) -> np.ndarray:
        logits = self._a[prev] @ self._b / np.sqrt(16.0)
        if client_shift is not None:
            logits = (1 - self.skew) * logits + self.skew * client_shift[prev]
        logits = logits / self.temperature
        logits -= logits.max(axis=-1, keepdims=True)
        p = np.exp(logits)
        return p / p.sum(axis=-1, keepdims=True)

    def sample(self, batch: int, seq_len: int, rng_seed: int,
               client_id: Optional[int] = None) -> np.ndarray:
        rng = np.random.default_rng(rng_seed)
        shift = None
        if client_id is not None and self.skew > 0:
            crng = np.random.default_rng(self.seed * 7919 + client_id)
            shift = crng.normal(
                size=(self.vocab, self.vocab)
            ).astype(np.float32) if self.vocab <= 512 else None
        toks = np.empty((batch, seq_len), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=batch)
        for t in range(1, seq_len):
            p = self._probs_from(toks[:, t - 1], rng, shift)
            cum = np.cumsum(p, axis=-1)
            u = rng.random((batch, 1))
            toks[:, t] = (u < cum).argmax(axis=-1)
        return toks


def make_batch(vocab: int, batch: int, seq_len: int, seed: int,
               gen: Optional[SyntheticLM] = None,
               client_id: Optional[int] = None) -> Dict[str, np.ndarray]:
    gen = gen or SyntheticLM(vocab=vocab, seed=0)
    toks = gen.sample(batch, seq_len, rng_seed=seed, client_id=client_id)
    return {"tokens": toks, "labels": toks.copy()}
