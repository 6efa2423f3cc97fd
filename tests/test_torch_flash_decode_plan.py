"""A CPU model of the flash-decode kernel's schedule, held against the
JAX package's Pallas kernel (interpret mode, as
tests/test_torch_flash_decode.py runs it).

The CUDA kernel (``src/repro_torch/csrc/flash_decode.cu``) runs on the
card only. What this file models in plain PyTorch is its order of work:
``split_plan`` and ``head_tile`` pick the clusters, each CTA of a cluster
takes its share of the live slots, each of its lane groups runs an online
softmax in log2 units over U rows a stage with the -1e30 sentinel for
rows past its share, lane groups merge in a butterfly, warps in warp
order and CTAs in rank order. Empty shares (pos < splits - 1) must come
out with m = -1e30 and l = 0 and leave no NaN.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode.kernel import flash_decode as jdecode
from repro_torch.kernels.flash_decode import kernel

FP32 = dict(rtol=2e-4, atol=2e-5)     # tests/test_kernels_extra.py's tolerance
H100_SMS = 132
NEG = -1e30
WARPS, U = 8, 2                       # kWarps and Plan::U of the CUDA source


@pytest.fixture(autouse=True)
def _no_launches():
    kernel.reset_launches()
    yield
    assert kernel.LAUNCHES == {"flash_decode": 0}


def cta_plan(hd: int, elem: int):
    """The CUDA source's Plan<T, HD, GT>: rows a warp-load (32 over the
    lanes of a row, each reading 16 bytes) and rows a CTA a stage."""
    rpw = 32 // min(hd * elem // 16, 32)
    return rpw, U * WARPS * rpw


def _merge(parts):
    """(m, l, acc) partials merged in the given order, as the kernel
    merges warps and ranks: M = max m, then sums weighted by 2^(m - M)."""
    M = parts[0][0]
    for m, _, _ in parts[1:]:
        M = torch.maximum(M, m)
    L = torch.zeros_like(parts[0][1])
    A = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        e = torch.exp2(m - M)
        L = l * e + L
        A = a * e[..., None] + A
    return M, L, A


def model_decode(q, k, v, pos: int, sm_count: int = H100_SMS, elem: int = 4):
    """The kernel's schedule on fp32 tensors q (B, 1, nq, hd), k / v
    (B, S, nkv, hd). Returns (out, per-rank (m, l) of the cluster merge)."""
    B, _, nq, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    group = nq // nkv
    splits = kernel.split_plan(S, B * nkv, sm_count)
    rpw, rows = cta_plan(hd, elem)
    scale2 = torch.tensor(hd ** -0.5 * math.log2(math.e), dtype=torch.float32)
    nlive = S if pos >= S else pos + 1
    share = -(-nlive // splits)
    # all (b, kv head) clusters at once: (bk, group, ...)
    qg = q.reshape(B * nkv, group, hd)
    kh = k.permute(0, 2, 1, 3).reshape(B * nkv, S, hd)
    vh = v.permute(0, 2, 1, 3).reshape(B * nkv, S, hd)
    # the kernel's head tiles (kernel.head_tile) are independent: a tile
    # computes its heads exactly as the whole group would, so the model
    # runs the group
    streams = WARPS * rpw                      # (warp, lane group)
    ranks = []
    for r in range(splits):
        lo = min(nlive, r * share)
        hi = min(nlive, lo + share)
        m = torch.full((B * nkv, group, streams), NEG)
        l = torch.zeros((B * nkv, group, streams))
        acc = torch.zeros((B * nkv, group, streams, hd))
        w_idx = torch.arange(WARPS)[:, None]
        rg_idx = torch.arange(rpw)[None, :]
        for it in range(-(-(hi - lo) // rows)):
            s_u, p_rows, ok_u = [], [], []
            for u in range(U):
                row = (lo + it * rows + (u * WARPS + w_idx) * rpw + rg_idx).reshape(-1)
                ok = row < hi
                safe = torch.where(ok, row, torch.zeros_like(row))
                kr, vr = kh[:, safe], vh[:, safe]          # (bk, streams, hd)
                dot = torch.einsum("bgd,bsd->bgs", qg, kr)
                s_u.append(torch.where(ok, dot * scale2, torch.tensor(NEG)))
                p_rows.append(torch.where(ok[:, None], vr, torch.zeros_like(vr)))
                ok_u.append(ok)
            mx = m
            for s in s_u:
                mx = torch.maximum(mx, s)
            alpha = torch.exp2(m - mx)
            p = [torch.where(ok, torch.exp2(s - mx), torch.zeros_like(s))
                 for s, ok in zip(s_u, ok_u)]
            total = p[0]
            for pu in p[1:]:
                total = total + pu
            l = l * alpha + total
            m = mx
            acc = acc * alpha[..., None]
            for pu, vr in zip(p, p_rows):
                acc = pu[..., None] * vr[:, None] + acc
        # lane groups of a warp: butterfly over the row-group bits
        m = m.reshape(B * nkv, group, WARPS, rpw)
        l = l.reshape(B * nkv, group, WARPS, rpw)
        acc = acc.reshape(B * nkv, group, WARPS, rpw, hd)
        o = 1
        while o < rpw:
            partner = torch.arange(rpw) ^ o
            mo, lo_, ao = m[..., partner], l[..., partner], acc[..., partner, :]
            mx = torch.maximum(m, mo)
            a, bo = torch.exp2(m - mx), torch.exp2(mo - mx)
            l = lo_ * bo + l * a
            acc = ao * bo[..., None] + acc * a[..., None]
            m = mx
            o *= 2
        warps = [(m[..., w, 0], l[..., w, 0], acc[..., w, 0, :])
                 for w in range(WARPS)]
        ranks.append(_merge(warps))
    M, L, A = _merge(ranks)
    out = A / torch.clamp(L, min=1e-30)[..., None]
    return out.reshape(B, 1, nq, hd), [(mr, lr) for mr, lr, _ in ranks]


SHAPES = {1: (1, 1, 4), 8: (4, 2, 7), 128: (4, 32, 1)}   # bk: B, nkv, group
HD = 32


def _inputs(S, bk, seed):
    B, nkv, group = SHAPES[bk]
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, 1, nkv * group, HD)).astype(np.float32),
            rng.normal(size=(B, S, nkv, HD)).astype(np.float32),
            rng.normal(size=(B, S, nkv, HD)).astype(np.float32))


@pytest.mark.parametrize("bk", [1, 8, 128])
@pytest.mark.parametrize("pos_at", ["0", "1", "splits-1", "80", "S-1", "S",
                                    "5000"])
@pytest.mark.parametrize("S", [200, 600, 2048])
def test_model_matches_pallas(S, pos_at, bk):
    B, nkv, _ = SHAPES[bk]
    splits = kernel.split_plan(S, bk, H100_SMS)
    pos = {"0": 0, "1": 1, "splits-1": splits - 1, "80": 80, "S-1": S - 1,
           "S": S, "5000": 5000}[pos_at]
    q, k, v = _inputs(S, bk, S * 31 + bk + pos)
    block = 512 if S % 512 == 0 else S
    want = np.asarray(jdecode(*(jnp.asarray(a) for a in (q, k, v)),
                              jnp.int32(pos), block_s=block))
    got, ranks = model_decode(*(torch.from_numpy(a) for a in (q, k, v)), pos)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    # ranks past the live slots hold the sentinel, never -inf or NaN
    nlive = S if pos >= S else pos + 1
    share = -(-nlive // splits)
    for r, (m, l) in enumerate(ranks):
        assert torch.isfinite(m).all() and torch.isfinite(l).all()
        if r * share >= nlive:
            assert (m == NEG).all() and (l == 0).all()


def test_all_but_one_split_empty():
    """pos 0 with 8 splits: one live slot, seven CTAs with nothing to
    read; the merge weights of the empty ones are exactly 0."""
    q, k, v = _inputs(2048, 8, 5)
    got, ranks = model_decode(*(torch.from_numpy(a) for a in (q, k, v)), 0)
    assert len(ranks) == 8
    assert all((m == NEG).all() and (l == 0).all() for m, l in ranks[1:])
    assert torch.isfinite(got).all()
    # one live slot: the output is that slot's value row
    B, nkv, group = SHAPES[8]
    want = np.repeat(v[:, 0], group, axis=1)[:, None]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("S,bk,group,splits,tile", [
    (2048, 8, 7, 8, 4),      # Qwen2-0.5B step: B 4 x 2 kv heads, GQA 7
    (2048, 128, 1, 2, 1),    # Zamba2-1.2B shared block: B 4 x 32 heads, MHA
    (1024, 1, 4, 8, 1),      # Gemma3-1B local ring: B 1 x 1 kv head, MQA 4
    (200, 1, 4, 4, 1),       # the cap at ceil(S / 32) = 7
    (20, 1, 1, 1, 1),        # a cache of one split
])
def test_plan_at_the_serving_shapes(S, bk, group, splits, tile):
    assert kernel.split_plan(S, bk, H100_SMS) == splits
    assert kernel.head_tile(group, splits * bk, H100_SMS) == tile


def test_split_plan_is_a_power_of_two_within_its_caps():
    for S in (1, 31, 32, 33, 100, 255, 256, 4096):
        for bk in (1, 3, 8, 66, 132, 1000):
            n = kernel.split_plan(S, bk, H100_SMS)
            assert n in (1, 2, 4, 8) and n <= max(1, -(-S // 32))
            # the smallest that fills the card, where the caps allow
            assert n == 1 or (n // 2) * bk < H100_SMS
