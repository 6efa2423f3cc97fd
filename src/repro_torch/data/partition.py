"""Federated data partitioning (cross-device FL: many clients, skewed)."""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(n_samples: int, n_clients: int, alpha: float,
                        seed: int = 0) -> List[np.ndarray]:
    """Sample-index partition with Dirichlet(alpha) client proportions —
    the standard non-IID quantity split. Every client gets >= 1 sample."""
    rng = np.random.default_rng(seed)
    props = rng.dirichlet([alpha] * n_clients)
    counts = np.maximum((props * n_samples).astype(int), 1)
    # fix rounding drift
    while counts.sum() > n_samples:
        counts[np.argmax(counts)] -= 1
    while counts.sum() < n_samples:
        counts[np.argmin(counts)] += 1
    idx = rng.permutation(n_samples)
    out, off = [], 0
    for c in counts:
        out.append(np.sort(idx[off: off + c]))
        off += c
    return out


def shard_partition(n_samples: int, n_clients: int) -> List[np.ndarray]:
    """Equal contiguous shards (IID baseline)."""
    return [np.arange(n_samples)[i::n_clients] for i in range(n_clients)]
