"""Secure aggregation via pairwise additive masks (``repro.core.secure``
in PyTorch; Bonawitz et al., CCS'17 §4 semantics, without the
dropout-recovery protocol).

Client i adds sum_{j>i} PRG(seed_ij) - sum_{j<i} PRG(seed_ji) to its
update; the pairwise terms cancel exactly in the plain sum, so only
sum-reducible fusions (IterAvg) keep the fused result. Each pair's mask
is drawn from an explicit ``torch.Generator`` seeded by a fixed integer
map of ``(seed, i, j)`` (``numpy.random.SeedSequence``), so clients i
and j derive the same stream without communication (a stand-in for the
key agreement).

The masks are not the JAX package's bits: its ``jax.random.fold_in``
stream has no torch counterpart, and a CPU generator and a CUDA
generator draw different streams from one seed. So every client of a
round must draw its masks on the same kind of device, or the pairs do
not cancel.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.dtypes import as_tensor


@dataclasses.dataclass(frozen=True)
class SecureMasking:
    n_clients: int
    seed: int = 0
    scale: float = 1.0

    def _pair_mask(self, i: int, j: int, n_params: int,
                   device: torch.device) -> torch.Tensor:
        state = np.random.SeedSequence([self.seed, i, j]).generate_state(
            1, np.uint64)[0]
        gen = torch.Generator(device=device)
        gen.manual_seed(int(state))
        return self.scale * torch.randn(
            (n_params,), generator=gen, dtype=torch.float32, device=device)

    def mask_for(self, client: int, n_params: int,
                 device: DeviceLike = None) -> torch.Tensor:
        """The net fp32 mask client ``client`` adds to its update, on
        ``device`` (the card by default)."""
        dev = resolve_device(device)
        m = torch.zeros((n_params,), dtype=torch.float32, device=dev)
        for j in range(self.n_clients):
            if j == client:
                continue
            lo, hi = min(client, j), max(client, j)
            pm = self._pair_mask(lo, hi, n_params, dev)
            if client == lo:
                m += pm
            else:
                m -= pm
        return m

    def mask_update(self, client: int, update,
                    device: DeviceLike = None) -> torch.Tensor:
        """``update`` (tensor or array) in fp32 plus its client's mask,
        on ``device`` (the card by default)."""
        dev = resolve_device(device)
        u = as_tensor(update, dev).to(torch.float32)
        return u + self.mask_for(client, u.shape[-1], dev)
