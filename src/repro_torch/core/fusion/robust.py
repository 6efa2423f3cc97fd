"""Byzantine-robust fusions, the port of ``repro.core.fusion.robust``.

CoordMedian  — coordinate-wise median (Yin et al., ICML'18).
TrimmedMean  — coordinate-wise beta-trimmed mean (Yin et al.).
Krum / MultiKrum — Blanchard et al., NeurIPS'17: pick the update(s) with
               the smallest sum of distances to their n-f-2 nearest
               neighbours.
Zeno         — Xie et al.: score updates by estimated descent against a
               validation gradient; average the top (n - b).
GeometricMedian — smoothed Weiszfeld iterations.

Streaming: trimmed mean and median stream EXACTLY through a per-
coordinate top-k / bottom-k carve. The carry is ``(sum (P,), count (),
topk (K, P), botk (K, P))`` — the running column sum plus the K largest
and K smallest values seen per coordinate — and

    trimmed_mean = (sum - sum(top_k) - sum(bot_k)) / (n - 2k)

with k = trim_count(n) <= K; the median is the same carve with
k = (n-1)//2. K is sized from ``n_hint`` at ``init_state``; ``finalize``
clamps k = min(trim_count(count), K).

Sentinels: ``topk`` is ascending and starts at -inf (real values fill
from the END), ``botk`` ascending from +inf (real values fill from the
START), so ``topk[K-k:]`` / ``botk[:k]`` hold only real values whenever
k <= count.

Krum, Zeno and GeometricMedian have no kernel in the JAX package and stay
plain PyTorch; their Gram and score products are ``torch.matmul``. Where
``jax.lax.top_k`` breaks ties toward the lower index, they take a stable
``torch.sort`` of the scores, so duplicate client rows select the same
indices as the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.fusion.base import EPS, FusionAlgorithm, dequant_payload
from repro_torch.kernels.robust_fusion.ref import (
    coordmedian_ref,
    topk_carve_ref,
    trimmedmean_ref,
)


# The plain fold: merge a (rows, P) block into the carried per-coordinate
# extremes, ``valid`` the (rows,) 0/1 row mask. The CUDA carve kernel
# computes the same merge in place.
carve_merge = topk_carve_ref


class _CarveStream:
    """Streaming mixin for order-statistic (carve) reducers. Subclasses
    define ``trim_count(n)`` — how many extremes to drop per side."""

    weighted = False

    @property
    def streamable(self) -> bool:
        return True

    def trim_count(self, n: int) -> int:
        raise NotImplementedError

    def _capacity(self, n_hint: int) -> int:
        return max(int(self.trim_count(int(n_hint))), 1)

    def init_state(self, dim, n_hint=None, device=None):
        if n_hint is None:
            raise ValueError(
                f"{self.name}: streaming needs n_hint (expected client "
                "count) to size the top-k carve buffers")
        k_cap = self._capacity(n_hint)
        return (
            torch.zeros((dim,), dtype=torch.float32, device=device),
            torch.zeros((), dtype=torch.float32, device=device),
            torch.full((k_cap, dim), -torch.inf, device=device),
            torch.full((k_cap, dim), torch.inf, device=device),
        )

    def fold_block(self, state, payload, weights, scale=None, *,
                   partial=None, carve=None):
        del partial
        if scale is not None:
            raise ValueError(
                f"{self.name}: order statistics cannot discount rows — "
                "staleness scales are unsupported")
        ssum, cnt, topk, botk = state
        if isinstance(payload, tuple):
            payload = dequant_payload(payload, ssum.shape[0])
        fn = carve if carve is not None else carve_merge
        ssum, topk, botk = fn(payload, weights, ssum, topk, botk)
        return (ssum, cnt + weights.sum(), topk, botk)

    def finalize(self, state):
        ssum, cnt, topk, botk = state
        n = int(cnt)
        if n <= 0:
            raise ValueError(f"{self.name}: empty round (count == 0)")
        k_cap = topk.shape[0]
        k = min(int(self.trim_count(n)), k_cap)
        s = ssum
        if k > 0:
            s = s - topk[k_cap - k:].sum(dim=0)
            s = s - botk[:k].sum(dim=0)
        return s / float(n - 2 * k)

    def state_signature(self, dim, n_hint=None):
        if n_hint is None:
            raise ValueError(f"{self.name}: state_signature needs n_hint")
        return ("carve", dim, self._capacity(n_hint))

    def state_nbytes(self, dim, n_hint=None) -> int:
        if n_hint is None:
            raise ValueError(f"{self.name}: state_nbytes needs n_hint")
        return 4 * (dim * (1 + 2 * self._capacity(n_hint)) + 1)

    def discount_state(self, state, gamma):
        raise ValueError(
            f"{self.name}: carried order-statistic state cannot be "
            "staleness-discounted")


class CoordMedian(_CarveStream, FusionAlgorithm):
    name = "coordmedian"
    coordinatewise = True

    def trim_count(self, n: int) -> int:
        # median == trimmed mean that drops all but the central 1 or 2
        return max((int(n) - 1) // 2, 0)

    def fuse(self, updates, weights):
        del weights
        return coordmedian_ref(updates)


@dataclasses.dataclass
class TrimmedMean(_CarveStream, FusionAlgorithm):
    """Drop the beta-fraction largest and smallest per coordinate."""

    beta: float = 0.1
    name = "trimmedmean"
    coordinatewise = True

    def trim_count(self, n: int) -> int:
        # clamp so 2k < n: int(n*beta) can otherwise empty the slice
        n = int(n)
        return max(min(int(n * self.beta), (n - 1) // 2), 0)

    def fuse(self, updates, weights):
        del weights
        return trimmedmean_ref(updates, self.trim_count(updates.shape[0]))


def _lowest(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k lowest scores, ties toward the lower index
    (``jax.lax.top_k(-scores, k)``)."""
    return torch.sort(scores, stable=True).indices[:k]


@dataclasses.dataclass
class Krum(FusionAlgorithm):
    """(Multi-)Krum. ``n_byzantine`` is the assumed attacker count f;
    ``m`` the number of selected updates to average (1 = classic Krum)."""

    n_byzantine: int = 1
    m: int = 1
    name = "krum"

    def scores_from_gram(self, gram: torch.Tensor) -> torch.Tensor:
        """Krum scores from the Gram matrix G = U U^T (n, n)."""
        n = gram.shape[0]
        sq = torch.diagonal(gram)
        d2 = sq[:, None] + sq[None, :] - 2.0 * gram     # pairwise ||.||^2
        d2 = d2 + torch.eye(n, device=gram.device) * 1e30   # exclude self
        k = max(n - self.n_byzantine - 2, 1)
        nearest = torch.sort(d2, dim=1).values[:, :k]  # k nearest
        return nearest.sum(dim=1)                       # (n,)

    def select_from_gram(self, gram: torch.Tensor) -> torch.Tensor:
        return _lowest(self.scores_from_gram(gram), self.m)

    def fuse(self, updates, weights):
        del weights
        u = updates.float()
        idx = self.select_from_gram(u @ u.T)
        return u[idx].mean(dim=0)


@dataclasses.dataclass
class Zeno(FusionAlgorithm):
    """Zeno scoring against a validation gradient g_val:
    score_i = <u_i, g_val> - rho * ||u_i||^2. Averages the best n - b.
    ``g_val`` is bound per round (``with_val_grad``)."""

    rho: float = 1e-3
    n_suspect: int = 1
    name = "zeno"

    def __post_init__(self):
        self._g_val = None

    def set_val_grad(self, g_val) -> None:
        """Bind g_val IN PLACE. Under concurrent tenants prefer
        ``with_val_grad`` (or the service's per-call
        ``aggregate(val_grad=...)``), which never touches this instance."""
        self._g_val = _as_f32(g_val)

    def with_val_grad(self, g_val) -> "Zeno":
        """A clone with ``g_val`` (a tensor, or an ndarray such as a JAX
        caller's ``np.asarray(g_val)``) bound, leaving this instance
        untouched."""
        clone = dataclasses.replace(self)
        clone._g_val = _as_f32(g_val)
        return clone

    def scores(self, inner: torch.Tensor, sqnorm: torch.Tensor) -> torch.Tensor:
        """inner: (n,) <u_i, g_val>; sqnorm: (n,) ||u_i||^2."""
        return inner - self.rho * sqnorm

    def fuse(self, updates, weights):
        del weights
        u = updates.float()
        g = self._g_val
        g = u.mean(dim=0) if g is None else g.to(u.device)
        s = self.scores(u @ g, (u * u).sum(dim=1))
        keep = max(u.shape[0] - self.n_suspect, 1)
        return u[_lowest(-s, keep)].mean(dim=0)


def _as_f32(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.from_numpy(np.array(x, dtype=np.float32))


@dataclasses.dataclass
class GeometricMedian(FusionAlgorithm):
    """Smoothed Weiszfeld (RFA, Pillutla et al.)."""

    iters: int = 8
    smooth: float = 1e-6
    name = "geomedian"

    def fuse(self, updates, weights):
        u = updates.float()
        w = weights.float().to(u.device)
        w = w / (w.sum() + EPS)
        z = torch.einsum("np,n->p", u, w)
        for _ in range(self.iters):
            d = torch.linalg.vector_norm(u - z[None, :], dim=1)
            beta = w / torch.clamp(d, min=self.smooth)
            beta = beta / beta.sum()
            z = torch.einsum("np,n->p", u, beta)
        return z
