"""Per-client batch loader over the synthetic generator."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.data.synthetic import SyntheticLM


@dataclasses.dataclass
class FederatedLoader:
    gen: SyntheticLM
    n_clients: int
    batch: int
    seq_len: int
    samples_per_client: List[int] | None = None  # -> client weights

    def __post_init__(self):
        if self.samples_per_client is None:
            rng = np.random.default_rng(self.gen.seed + 1)
            self.samples_per_client = list(
                rng.integers(50, 500, size=self.n_clients)
            )

    def client_weight(self, client_id: int) -> float:
        return float(self.samples_per_client[client_id])

    def client_batch(self, client_id: int, round_idx: int) -> Dict[str, np.ndarray]:
        toks = self.gen.sample(
            self.batch, self.seq_len,
            rng_seed=round_idx * 100003 + client_id,
            client_id=client_id,
        )
        return {"tokens": toks, "labels": toks.copy()}
