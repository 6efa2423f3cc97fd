"""A model, in PyTorch on the CPU, of the arithmetic of the port's
attention backward on the tensor cores (bf16 / fp16 ``flash_attn_bwd``,
``src/repro_torch/csrc/flash_attention.cu``), held against ``jax.vjp`` of
the JAX model's ``blockwise_attention`` (its custom VJP) and against the
port's plain ``attention_bwd_ref``.

The model follows the kernels block by block: a dK / dV block owns
``kernel.bwd_tiles(hd)[0]`` keys and visits the query tiles of
``kernel.dkdv_query_tiles``; a dQ block owns as many queries and visits
the key tiles of ``kernel.dq_key_tiles``. Every product takes operands
rounded to the input dtype and sums in fp32, one 16-wide k-step of
``mma.sync.m16n8k16`` at a time, in the kernels' tile and k-step order;
p = exp2(s * scale * log2 e - lse * log2 e) with s the unscaled fp32 dot,
masked (p = 0) only on the tiles where a warp's 16 rows cross the
diagonal, the window's edge or T; p enters dV rounded once, as the
reference's ``pb``; ds = p (dp - delta) scale enters dQ and dK rounded
once, as its ``dsb``. With GQA the dK / dV partials of each q head are
summed in head order before the one rounding. The CUDA kernels are held
against the plain version on the card by ``chip_smoke.py`` phase 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers.attention import blockwise_attention
from repro_torch.kernels.flash_attention import kernel, ref

# tests/test_torch_flash_bwd.py's bf16 tolerance (the reference's bf16
# attention tolerance); fp16 is held to the same
TOL = dict(rtol=5e-2, atol=5e-2)
LOG2E = 1.4426950408889634
JDT = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def _products(a, b):
    """a (..., m, hd) . b (..., n, hd)^T in fp32, one 16-wide k-step at a
    time, in order."""
    acc = torch.zeros(a.shape[:-1] + (b.shape[-2],))
    for k0 in range(0, a.shape[-1], 16):
        acc = acc + a[..., k0:k0 + 16] @ b[..., k0:k0 + 16].transpose(-1, -2)
    return acc


def _accumulate(acc, a, b):
    """acc (..., m, n) + a (..., m, K) @ b (..., K, n) in fp32, one
    16-wide k-step of K at a time, in order."""
    for k0 in range(0, a.shape[-1], 16):
        acc = acc + a[..., k0:k0 + 16] @ b[..., k0:k0 + 16, :]
    return acc


def bwd_model(q, k, v, out, lse, dout, window=0, *, split_p=False,
              cast=True):
    """The tensor-core kernels' arithmetic: (dq, dk, dv) of q (B, T, nq,
    hd), k / v (B, T, nkv, hd), the forward's out and lse (B, nq, T) and
    dout, in q's dtype (fp32, before the one rounding, when ``cast`` is
    False). ``split_p`` feeds p to dV as hi + lo, two rounded terms (the
    forward's bf16 split), where the kernel rounds it once."""
    dt = q.dtype
    B, T, nq, hd = q.shape
    nkv = k.shape[2]
    group = nq // nkv
    rows, bq, bk = kernel.bwd_tiles(hd)
    pad = -(-T // 64) * 64 + 64   # room for every tile that crosses T

    def heads(x):   # (B, T, h, hd) -> (B, h, pad, hd) fp32, rows past T 0
        o = torch.zeros((B, x.shape[2], pad, hd))
        o[:, :, :T] = x.float().transpose(1, 2)
        return o

    qf, gf = heads(q), heads(dout)
    kf = heads(k).repeat_interleave(group, dim=1)   # q head h -> h // group
    vf = heads(v).repeat_interleave(group, dim=1)
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    scale_log2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    lse2 = torch.zeros((B, nq, pad))
    lse2[..., :T] = lse * torch.tensor(LOG2E, dtype=torch.float32)
    delta = torch.zeros((B, nq, pad))
    delta[..., :T] = (dout.float() * out.float()).sum(-1).transpose(1, 2)

    def p_ds(s, dp, t, keys, edge, t_end):
        """p and ds of a (queries t) x (keys) tile of scores s, dp; the
        mask (queries at or past ``t_end`` dead too) applies where
        ``edge`` (per query row or key column) is set."""
        p = torch.exp2(s * scale_log2 - lse2[:, :, t, None])
        live = (keys[None, :] <= t[:, None]) & (t < t_end)[:, None]
        if window > 0:
            live &= t[:, None] - keys[None, :] < window
        p = torch.where(edge & ~live, torch.zeros(()), p)
        return p, p * (dp - delta[:, :, t, None]) * scale

    def rounded(x):
        return x.to(dt).float()

    # dK / dV: per key block, the live query tiles in order
    dk_part = torch.zeros((B, nq, pad, hd))
    dv_part = torch.zeros((B, nq, pad, hd))
    for k0 in range(0, T, rows):
        keys = torch.arange(k0, k0 + rows)
        kw0 = k0 + 16 * ((keys - k0) // 16)   # each key's warp's first key
        dk_acc = torch.zeros((B, nq, rows, hd))
        dv_acc = torch.zeros((B, nq, rows, hd))
        for qt in kernel.dkdv_query_tiles(k0, T, window, hd):
            q0 = qt * bq
            t = torch.arange(q0, q0 + bq)
            edge = (q0 < kw0 + 15) | (q0 + bq > T)
            if window > 0:
                edge |= q0 + bq - 1 - kw0 >= window
            s = _products(qf[:, :, q0:q0 + bq], kf[:, :, k0:k0 + rows])
            dp = _products(gf[:, :, q0:q0 + bq], vf[:, :, k0:k0 + rows])
            p, ds = p_ds(s, dp, t, keys, edge[None, :], T)
            pt, dst = p.transpose(-1, -2), ds.transpose(-1, -2)
            if split_p:
                hi = rounded(pt)
                for kk in range(0, bq, 16):
                    g_kk = gf[:, :, q0 + kk:q0 + kk + 16]
                    dv_acc = dv_acc + hi[..., kk:kk + 16] @ g_kk
                    dv_acc = dv_acc + rounded(pt - hi)[..., kk:kk + 16] @ g_kk
            else:
                dv_acc = _accumulate(dv_acc, rounded(pt),
                                     gf[:, :, q0:q0 + bq])
            dk_acc = _accumulate(dk_acc, rounded(dst), qf[:, :, q0:q0 + bq])
        dk_part[:, :, k0:k0 + rows] = dk_acc
        dv_part[:, :, k0:k0 + rows] = dv_acc

    # dQ: per query block, the live key tiles in order
    dq = torch.zeros((B, nq, pad, hd))
    for q0 in range(0, T, rows):
        t = torch.arange(q0, q0 + rows)
        qw0 = q0 + 16 * ((t - q0) // 16)   # each row's warp's first row
        acc = torch.zeros((B, nq, rows, hd))
        for kt in kernel.dq_key_tiles(q0, T, window, hd):
            k0 = kt * bk
            keys = torch.arange(k0, k0 + bk)
            edge = k0 + bk - 1 > qw0
            if window > 0:
                edge |= qw0 + 15 - k0 >= window
            s = _products(qf[:, :, q0:q0 + rows], kf[:, :, k0:k0 + bk])
            dp = _products(gf[:, :, q0:q0 + rows], vf[:, :, k0:k0 + bk])
            _, ds = p_ds(s, dp, t, keys, edge[:, None], pad)   # rows past T
            # are dropped at the end
            acc = _accumulate(acc, rounded(ds), kf[:, :, k0:k0 + bk])
        dq[:, :, q0:q0 + rows] = acc

    def summed(part):   # a kv head's q heads in head order, from 0
        total = torch.zeros((B, nkv, pad, hd))
        for i in range(group):
            total = total + part.reshape(B, nkv, group, pad, hd)[:, :, i]
        return total

    dk = summed(dk_part) if group > 1 else dk_part
    dv = summed(dv_part) if group > 1 else dv_part
    grads = [x[:, :, :T].transpose(1, 2) for x in (dq, dk, dv)]
    return tuple(x.to(dt) for x in grads) if cast else tuple(grads)


def _inputs(seed, B, T, nq, nkv, hd, dtype):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s).astype(np.float32) for s in
              ((B, T, nq, hd), (B, T, nkv, hd), (B, T, nkv, hd),
               (B, T, nq, hd))]
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _jax_vjp(q, k, v, g, window):
    jd = JDT[q.dtype]
    args = [jnp.asarray(t.float().numpy()).astype(jd) for t in (q, k, v)]
    _, vjp = jax.vjp(lambda a, b, c: blockwise_attention(a, b, c,
                                                         window=window),
                     *args)
    grads = vjp(jnp.asarray(g.float().numpy()).astype(jd))
    return [np.asarray(x, np.float32) for x in grads]


# (B, T, nq, nkv, hd, window, dtype): GQA, MQA, MHA; ragged T = 1, 17,
# 70, 150; windows 1, 5 and T - 1; hd 32 and 64 (64-row query tiles, A
# fragments in registers), 128 (32-row query tiles) and 256 (32-row
# blocks, the head dim split over two warps)
CASES = [
    (2, 70, 4, 2, 64, 0, torch.bfloat16),      # GQA, two 64-row tiles
    (1, 70, 4, 1, 32, 5, torch.bfloat16),      # MQA, window 5, hd 32
    (2, 17, 4, 4, 32, 0, torch.float16),       # MHA, T = 17
    (2, 1, 6, 2, 64, 0, torch.bfloat16),       # T = 1
    (1, 70, 6, 3, 64, 1, torch.float16),       # window 1
    (1, 70, 4, 2, 32, 69, torch.bfloat16),     # window T - 1
    (2, 17, 14, 2, 64, 16, torch.bfloat16),    # Qwen2's group of 7
    (1, 150, 4, 2, 64, 40, torch.bfloat16),    # three key blocks
    (1, 70, 4, 1, 128, 0, torch.bfloat16),     # hd 128
    (1, 70, 2, 1, 256, 20, torch.float16),     # hd 256
]
IDS = [f"B{c[0]}-T{c[1]}-{c[2]}x{c[3]}-hd{c[4]}-w{c[5]}-"
       f"{str(c[6]).split('.')[-1]}" for c in CASES]


@pytest.fixture(autouse=True)
def _no_launches():
    kernel.reset_launches()
    yield
    assert kernel.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}


def _model_case(B, T, nq, nkv, hd, window, dtype, **kw):
    q, k, v, g = _inputs(T + nq + hd + window, B, T, nq, nkv, hd, dtype)
    out, lse = ref.attention_lse_ref(q, k, v, window=window)
    return (q, k, v, out, lse, g), bwd_model(q, k, v, out, lse, g, window,
                                             **kw)


@pytest.mark.parametrize("B,T,nq,nkv,hd,window,dtype", CASES, ids=IDS)
def test_model_matches_blockwise_attention_vjp(B, T, nq, nkv, hd, window,
                                               dtype):
    (q, k, v, _, _, g), got = _model_case(B, T, nq, nkv, hd, window, dtype)
    want = _jax_vjp(q, k, v, g, window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        np.testing.assert_allclose(a.float().numpy(), b, err_msg=name, **TOL)


@pytest.mark.parametrize("B,T,nq,nkv,hd,window,dtype", CASES, ids=IDS)
def test_model_matches_attention_bwd_ref(B, T, nq, nkv, hd, window, dtype):
    args, got = _model_case(B, T, nq, nkv, hd, window, dtype)
    want = ref.attention_bwd_ref(*args, window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype == dtype
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_one_split_of_p_moves_the_model_off_the_reference(dtype):
    """The reference rounds p once (``pb``) before dV; the kernel does
    the same, so before the last rounding its dV differs from the
    reference's only by the order of fp32 sums. Fed as hi + lo (the
    forward's bf16 split) p is closer to fp32, and dV moves off the
    reference's by the rounding of p: far more than the sum order."""
    B, T, nq, nkv, hd, window = 2, 70, 4, 2, 64, 0
    q, k, v, g = _inputs(5, B, T, nq, nkv, hd, dtype)
    out, lse = ref.attention_lse_ref(q, k, v)
    # the reference's dV before its cast: p rounded once, fp32 sums
    group = nq // nkv
    s = torch.einsum("btngh,bsnh->bngts",
                     q.float().reshape(B, T, nkv, group, hd),
                     k.float()) * hd ** -0.5
    mask = ref.attention_mask(T, T, window)
    s = torch.where(mask, s, torch.full((), ref.NEG_INF))
    p = torch.exp(s - lse.reshape(B, nkv, group, T)[..., None])
    want = torch.einsum("bngts,btngh->bsnh", p.to(dtype).float(),
                        g.float().reshape(B, T, nkv, group, hd))
    once = bwd_model(q, k, v, out, lse, g, cast=False)[2]
    split = bwd_model(q, k, v, out, lse, g, split_p=True, cast=False)[2]
    err_once = (once - want).abs().mean().item()
    err_split = (split - want).abs().mean().item()
    assert err_split > 20 * err_once, (err_once, err_split)


def _visits(tiles_of, T, window, hd, block, tile, owner_is_key):
    """(T, T) count of the visits each (query, key) pair gets from the
    blocks of ``block`` rows and their tiles of ``tile`` rows."""
    n = np.zeros((T, T), np.int64)
    for r0 in range(0, T, block):
        own = slice(r0, min(r0 + block, T))
        for i in tiles_of(r0, T, window, hd):
            other = slice(i * tile, min((i + 1) * tile, T))
            if owner_is_key:
                n[other, own] += 1
            else:
                n[own, other] += 1
    return n


@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("T,window", [
    (1, 0), (17, 0), (70, 0), (70, 1), (70, 5), (70, 69), (300, 64),
    (512, 0), (1280, 1024), (1000, 2048), (333, 31),
])
def test_schedules_visit_every_live_pair_once(hd, T, window):
    """``dkdv_query_tiles`` and ``dq_key_tiles`` (the CUDA loop bounds)
    visit every live (query, key) pair exactly once, and no tile that
    holds no live pair for its block."""
    rows, bq, bk = kernel.bwd_tiles(hd)
    t, s = np.arange(T)[:, None], np.arange(T)[None, :]
    live = s <= t
    if window > 0:
        live &= t - s < window
    for tiles_of, tile, owner_is_key in (
            (kernel.dkdv_query_tiles, bq, True),
            (kernel.dq_key_tiles, bk, False)):
        n = _visits(tiles_of, T, window, hd, rows, tile, owner_is_key)
        assert (n[live] == 1).all()
        assert n.max() <= 1
        for r0 in range(0, T, rows):   # every visited tile holds live work
            own = slice(r0, min(r0 + rows, T))
            for i in tiles_of(r0, T, window, hd):
                other = slice(i * tile, min((i + 1) * tile, T))
                block = live[other, own] if owner_is_key else live[own, other]
                assert block.any(), (r0, i)


def test_bwd_tiles_and_instances():
    assert kernel.bwd_tiles(32) == (64, 64, 64)
    assert kernel.bwd_tiles(64) == (64, 64, 64)
    assert kernel.bwd_tiles(128) == (64, 32, 64)
    assert kernel.bwd_tiles(256) == (32, 32, 32)
    with pytest.raises(ValueError, match="head dim"):
        kernel.bwd_tiles(16)
    inst = kernel.bwd_instances()
    assert len(inst) == len(set(inst)) == 30
    assert kernel.bwd_route(torch.bfloat16).startswith("tensor cores")
    assert kernel.bwd_route(torch.float32) == "cuda cores"


def test_bwd_kernels_are_the_source_kernels():
    """Every device kernel that ``kernel.bwd_instances`` names is a
    ``__global__`` of the backward's source, and every backward
    ``__global__`` there is named: the list the card's build check
    compares ``ptxas`` with is the source's."""
    import re
    from pathlib import Path

    src = (Path(kernel.__file__).resolve().parents[2] / "csrc"
           / "flash_attention.cu").read_text()
    found = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(bwd_\w+)\(",
        src))
    named = {name for name, _, _ in kernel.bwd_instances()}
    assert found == named
