"""Mixture-of-Experts layer: ``repro.models.layers.moe`` on one device.

Two of the reference's three execution paths, computing the same
function up to capacity drops:

``scatter`` (prefill and training, ``T > 1``): each token's top-k
    assignments go into static per-expert capacity buffers (E, C, d);
    the assignments ranked past an expert's capacity are dropped; the
    experts run as batched products over the buffers, and the results
    are gathered back and mixed by the gate values.

``dense-mix`` (a decode step, ``T == 1``): every expert runs on every
    token and the outputs are mixed by the top-k gates (zero elsewhere).
    With one token a sequence the step reads every expert's weights
    anyway, so nothing is dropped and nothing is gathered.

The reference's third path, the expert-parallel ``shard_map`` +
``all_to_all`` over a mesh, comes with the mesh tooling. Routing is the
reference's: fp32 softmax probabilities of an fp32 router, the top k by
a stable descending sort (ties go to the lower expert index, as
``jax.lax.top_k``), ranks in an expert by a stable argsort. The expert
products are PyTorch matrix products, as they are einsums outside any
Pallas kernel in the reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.models.layers.init import normal_param
from repro_torch.models.layers.mlp import MLP, mlp


class MoE(nn.Module):
    """router (d, E) fp32, w_gate / w_up (E, d, ff), w_down (E, ff, d)
    and the fused shared experts (an ``MLP`` of width n_shared * ff, or
    None): ``repro``'s MoEParams, in its shapes and init scales."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 n_shared: int, dtype: torch.dtype, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        s_in, s_out = d_model ** -0.5, d_ff ** -0.5
        mk = lambda shape, s, dt=dtype: normal_param(  # noqa: E731
            shape, s, dt, device, generator)
        # the router stays fp32 whatever the model's dtype
        self.router = mk((d_model, n_experts), s_in, torch.float32)
        self.w_gate = mk((n_experts, d_model, d_ff), s_in)
        self.w_up = mk((n_experts, d_model, d_ff), s_in)
        self.w_down = mk((n_experts, d_ff, d_model), s_out)
        self.shared = (MLP(d_model, n_shared * d_ff, dtype, device=device,
                           generator=generator) if n_shared else None)


# -- routing (shared by both paths) -------------------------------------------


def route(xt: torch.Tensor, router: torch.Tensor, top_k: int):
    """xt (n, d) -> (gate_vals (n, k) fp32, renormalised; gate_idx (n, k);
    probs (n, E) fp32)."""
    probs = torch.softmax(xt.float() @ router, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :top_k], idx[:, :top_k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return gate_vals, gate_idx, probs


def aux_loss(probs: torch.Tensor, gate_idx: torch.Tensor,
             E: int) -> torch.Tensor:
    """The load-balance loss E * sum_e mean_prob_e * mean_count_e."""
    me = probs.mean(dim=0)
    ce = F.one_hot(gate_idx, E).float().sum(dim=1).mean(dim=0)
    return E * (me * ce).sum()


def positions_in_expert(flat_idx: torch.Tensor, E: int) -> torch.Tensor:
    """Rank of each assignment among the assignments to the same expert,
    in order of appearance (a stable sort; O(n k) memory)."""
    nk = flat_idx.shape[0]
    order = torch.argsort(flat_idx, stable=True)
    sorted_idx = flat_idx[order]
    # where each expert's run starts in the sorted order: cumsum(counts)
    # - counts of the reference
    starts = torch.searchsorted(
        sorted_idx, torch.arange(E, dtype=sorted_idx.dtype,
                                 device=flat_idx.device))
    ranks_sorted = torch.arange(nk, device=flat_idx.device) \
        - starts[sorted_idx]
    return torch.empty_like(ranks_sorted).index_put_((order,), ranks_sorted)


def capacity(n_tok: int, top_k: int, E: int, cf: float) -> int:
    """Slots an expert's buffer has: top_k n cf / E, at least 8 and at
    most n top_k, rounded up to a multiple of 8."""
    c = int(max(top_k * n_tok * cf / E, 8))
    c = min(c, n_tok * top_k)
    return -(-c // 8) * 8


# -- paths --------------------------------------------------------------------


def dispatch_combine(xt: torch.Tensor, router: torch.Tensor,
                     wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                     top_k: int, cf: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scatter path on (n, d) tokens: (out (n, d), aux)."""
    n_tok, d = xt.shape
    E = router.shape[1]
    gate_vals, gate_idx, probs = route(xt, router, top_k)
    cap = capacity(n_tok, top_k, E, cf)
    flat_idx = gate_idx.reshape(-1)
    pos = positions_in_expert(flat_idx, E)
    keep = pos < cap
    slot = torch.where(keep, pos, torch.full_like(pos, cap - 1))
    keep_x = keep[:, None].to(xt.dtype)

    # a dropped assignment adds zeros into its expert's last slot
    contrib = xt.repeat_interleave(top_k, dim=0) * keep_x
    buf = torch.zeros((E, cap, d), dtype=xt.dtype, device=xt.device)
    buf = buf.index_put((flat_idx, slot), contrib, accumulate=True)
    g = torch.bmm(buf, wg)
    u = torch.bmm(buf, wu)
    h = F.silu(g.float()).to(xt.dtype) * u
    out_buf = torch.bmm(h, wd)

    gathered = out_buf[flat_idx, slot]
    gathered = gathered * (gate_vals.reshape(-1)[:, None].to(xt.dtype)
                           * keep_x)
    out = gathered.reshape(n_tok, top_k, d).sum(dim=1)
    return out, aux_loss(probs, gate_idx, E)


def moe_scatter(p: MoE, x: torch.Tensor, top_k: int, cf: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, T, d = x.shape
    out, aux = dispatch_combine(x.reshape(B * T, d), p.router, p.w_gate,
                                p.w_up, p.w_down, top_k, cf)
    if p.shared is not None:
        out = out + mlp(p.shared, x).reshape(B * T, d)
    return out.reshape(B, T, d), aux


def moe_dense_mix(p: MoE, x: torch.Tensor, top_k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every expert on every token, mixed by the top-k gates."""
    B, T, d = x.shape
    E = p.router.shape[1]
    xt = x.reshape(B * T, d)
    gate_vals, gate_idx, probs = route(xt, p.router, top_k)
    gates = torch.zeros((B * T, E), dtype=torch.float32,
                        device=x.device).scatter(1, gate_idx, gate_vals)
    g = torch.matmul(xt, p.w_gate)                          # (E, n, ff)
    u = torch.matmul(xt, p.w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    y = torch.bmm(h, p.w_down)                              # (E, n, d)
    out = torch.einsum("end,ne->nd", y, gates.to(x.dtype))
    if p.shared is not None:
        out = out + mlp(p.shared, x).reshape(B * T, d)
    return out.reshape(B, T, d), aux_loss(probs, gate_idx, E)


def moe(p: MoE, x: torch.Tensor, top_k: int, capacity_factor: float
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, d) -> (output (B, T, d), aux load-balance loss): the
    dense mix for one token a sequence, else the scatter path."""
    if x.shape[1] == 1:
        return moe_dense_mix(p, x, top_k)
    return moe_scatter(p, x, top_k, capacity_factor)
