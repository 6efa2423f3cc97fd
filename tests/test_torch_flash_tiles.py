"""A model, in PyTorch on the CPU, of the arithmetic of the port's two
flash-attention routes (``src/repro_torch/csrc/flash_attention.cu``),
held against the JAX package's Pallas kernel (interpret mode), its naive
oracle and the port's plain version.

The bf16 / fp16 route runs on the tensor cores: 64-row query tiles in
16-row warps, 64-key tiles (32 at hd 256), fp32 scores scaled after the
dot, a tile-wise online softmax in exp2, P rounded to fp16 before PV,
or for bf16 split into hi + lo bf16 terms (one bf16 rounding breaks the
half tolerance: ``test_one_bf16_rounding_of_p_breaks_the_tolerance``),
and the causal / window mask applied only on tiles a warp's rows cross
at the diagonal (causal instances only), the window's edge or S; a
non-causal instance visits every key tile from the window's near edge
to S. The fp32 route
scales q first, masks every tile and keeps P in fp32, on 64- or 32-row
query tiles (``kernel.fp32_query_tile``). The CUDA kernels themselves
are held against the plain version on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jref
from repro.models.layers.attention import blockwise_attention
from repro_torch.kernels.flash_attention import kernel, ref

HALF = dict(rtol=1e-2, atol=2e-3)   # the port's half tolerance (chip_smoke.py)
FP32 = dict(rtol=2e-4, atol=3e-5)   # tests/test_kernels.py's fp32 tolerance
NEG_INF = -1e30
LOG2E = 1.4426950408889634
JDT = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def tile_model(q, k, v, window=0, *, causal=True, block_q=64,
               tensor_cores=True, split_p=None):
    """The kernel's arithmetic, tile by tile: q (B, T, nq, hd), k / v
    (B, S, nkv, hd) -> (B, T, nq, hd) in q's dtype. ``causal`` picks the
    kernel's instance; ``split_p`` (the kernel's choice when None: bf16
    only) feeds P to PV as hi + lo."""
    if split_p is None:
        split_p = q.dtype == torch.bfloat16
    B, T, nq, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    bk = 64 if hd <= 128 else 32
    Tp, Sp = -(-T // block_q) * block_q, -(-S // bk) * bk
    group = nq // nkv

    def padded(x, n):   # (B, L, h, hd) -> (B, h, n, hd), rows past L zero
        out = torch.zeros((B, x.shape[2], n, hd))
        out[:, :, :x.shape[1]] = x.float().transpose(1, 2)
        return out

    qf = padded(q, Tp)
    kf = padded(k, Sp).repeat_interleave(group, dim=1)   # head h -> h // group
    vf = padded(v, Sp).repeat_interleave(group, dim=1)
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    if tensor_cores:
        scores = qf @ kf.transpose(-1, -2)          # scaled after the dot
        scale_log2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    else:
        scores = (qf * scale) @ kf.transpose(-1, -2)
    out = torch.zeros((B, nq, Tp, hd))
    for qt in range(Tp // block_q):
        q0 = qt * block_q
        q_last = min(q0 + block_q, T) - 1
        kt_hi = min(Sp // bk, q_last // bk + 1) if causal else Sp // bk
        kt_lo = max(0, q0 - window + 1) // bk if window > 0 else 0
        rows = torch.arange(q0, q0 + block_q)
        r0 = q0 + 16 * ((rows - q0) // 16)         # each warp's first row
        m = torch.full((B, nq, block_q), NEG_INF)
        l = torch.zeros((B, nq, block_q))
        o = torch.zeros((B, nq, block_q, hd))
        for kt in range(kt_lo, kt_hi):
            k0 = kt * bk
            keys = torch.arange(k0, k0 + bk)
            s = scores[:, :, q0:q0 + block_q, k0:k0 + bk]
            live = (keys[None] < S).expand(block_q, bk).clone()
            if causal:
                live = live & (keys[None] <= rows[:, None])
            if window > 0:
                live &= rows[:, None] - keys[None] < window
            masked = ~live
            if tensor_cores:
                edge = torch.full(r0.shape, k0 + bk > S)
                if causal:
                    edge |= k0 + bk - 1 > r0
                if window > 0:
                    edge |= r0 + 15 - k0 >= window
                masked &= edge[:, None]
            s = s.masked_fill(masked, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            vt = vf[:, :, k0:k0 + bk]
            if tensor_cores:
                alpha = torch.exp2((m - m_new) * scale_log2)
                p = torch.exp2((s - m_new[..., None]) * scale_log2)
                hi = p.to(q.dtype).float()
                pv = hi @ vt
                if split_p:
                    pv = pv + (p - hi).to(q.dtype).float() @ vt
            else:
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                pv = p @ vt
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + pv
            m = m_new
        if tensor_cores:
            inv = torch.where(l > 0, 1.0 / l, torch.zeros(()))
            out[:, :, q0:q0 + block_q] = o * inv[..., None]
        else:
            out[:, :, q0:q0 + block_q] = o / l.clamp_min(1e-30)[..., None]
    return out[:, :, :T].transpose(1, 2).to(q.dtype)


def masked_first_rows(T, window, hd, block_q=64):
    """Rows whose first visited key tile holds no live key for them."""
    bk = 64 if hd <= 128 else 32
    n = 0
    for t in range(T):
        q0 = t // block_q * block_q
        kt_lo = max(0, q0 - window + 1) // bk
        n += (kt_lo + 1) * bk - 1 < t - window + 1
    return n


def _qkv(seed, B, T, nq, nkv, hd, S=None):
    rng = np.random.default_rng(seed)
    S = T if S is None else S
    return (rng.normal(size=(B, T, nq, hd)).astype(np.float32),
            rng.normal(size=(B, S, nkv, hd)).astype(np.float32),
            rng.normal(size=(B, S, nkv, hd)).astype(np.float32))


def _both(arrays, dtype):
    """The same values as torch tensors and JAX arrays of ``dtype``."""
    ts = [torch.from_numpy(a).to(dtype) for a in arrays]
    js = [jnp.asarray(t.float().numpy()).astype(JDT[dtype]) for t in ts]
    return ts, js


def _close(got, want, tol):
    if isinstance(want, torch.Tensor):
        want = want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.fixture(autouse=True)
def _no_launches():
    kernel.reset_launches()
    yield
    assert kernel.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("B,T,nq,nkv,hd,window", [
    (2, 128, 14, 2, 64, 0),     # GQA 7:1, Qwen2's group
    (2, 128, 4, 1, 128, 64),    # MQA, window 64
    (2, 128, 4, 4, 32, 0),      # MHA, hd 32
    (1, 128, 4, 1, 256, 64),    # hd 256: 32-key tiles, Q from shared memory
    (1, 192, 8, 8, 64, 64),     # MHA, window 64
])
def test_tensor_core_model_matches_pallas(dtype, B, T, nq, nkv, hd, window):
    (tq, tk, tv), (jq, jk, jv) = _both(
        _qkv(T + 3 * nq + nkv + hd + window, B, T, nq, nkv, hd), dtype)
    got = tile_model(tq, tk, tv, window)
    assert got.dtype == dtype and got.shape == tq.shape
    _close(got, jflash(jq, jk, jv, causal=True, window=window,
                       block_q=64, block_k=64), HALF)
    _close(got, jref(jq, jk, jv, causal=True, window=window), HALF)
    _close(got, ref.attention_ref(tq, tk, tv, window=window), HALF)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("T,nq,nkv,hd,window", [
    (100, 6, 2, 64, 0),        # ragged T: a part query tile and key tile
    (77, 6, 2, 32, 24),
    (1, 4, 1, 64, 0),
    (300, 14, 2, 64, 64),      # window 64: first visited tiles all masked
    (300, 4, 1, 256, 64),      # the same on 32-key tiles
    (333, 4, 4, 128, 0),
])
def test_tensor_core_model_ragged_and_windowed(dtype, T, nq, nkv, hd, window):
    """Shapes the Pallas kernel does not tile, against its naive oracle
    and the port's plain version."""
    (tq, tk, tv), (jq, jk, jv) = _both(
        _qkv(T * 7 + hd + window, 2, T, nq, nkv, hd), dtype)
    got = tile_model(tq, tk, tv, window)
    _close(got, jref(jq, jk, jv, causal=True, window=window), HALF)
    _close(got, ref.attention_ref(tq, tk, tv, window=window), HALF)


@pytest.mark.parametrize("hd", [64, 256])
def test_rows_whose_first_tile_is_masked_are_exact(hd):
    """With window 64 some rows see only masked keys in their first
    visited tile: p = 1 there, wiped by the next tile's alpha = 0. Those
    rows come out as the oracle's, well inside the half tolerance."""
    T, window = 300, 64
    assert masked_first_rows(T, window, hd) > 0
    (tq, tk, tv), (jq, jk, jv) = _both(_qkv(hd, 1, T, 2, 1, hd),
                                       torch.bfloat16)
    got = tile_model(tq, tk, tv, window).float()
    want = ref.attention_ref(tq.float(), tk.float(), tv.float(),
                             window=window)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-2, atol=2e-3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "fp16"])
def test_tensor_core_model_matches_the_model_blockwise_attention(dtype):
    """Scores scaled after the dot and P cast to v's dtype before PV are
    the JAX model's blockwise_attention: the two agree at the half
    tolerance (bf16's hi + lo P is closer to the fp32 P still)."""
    (tq, tk, tv), (jq, jk, jv) = _both(_qkv(31, 2, 256, 14, 2, 64), dtype)
    got = tile_model(tq, tk, tv)
    want = blockwise_attention(jq, jk, jv, causal=True, q_chunk=64,
                               kv_chunk=64)
    _close(got, want, HALF)


def test_one_bf16_rounding_of_p_breaks_the_tolerance():
    """Why bf16 P is split: rounded once to bf16 (8 significant bits), P
    moves outputs of rows with few live keys past atol 2e-3 + rtol 1e-2
    near zero; as hi + lo it stays well inside, like fp16's one rounding
    (11 bits)."""
    (tq, tk, tv), (jq, jk, jv) = _both(_qkv(1, 2, 128, 14, 2, 64),
                                       torch.bfloat16)
    want = ref.attention_ref(tq, tk, tv).float()

    def worst(got):
        return ((got.float() - want).abs()
                / (HALF["atol"] + HALF["rtol"] * want.abs())).max().item()

    assert worst(tile_model(tq, tk, tv, split_p=False)) > 1.0
    assert worst(tile_model(tq, tk, tv)) < 0.9
    (hq, hk, hv), _ = _both(_qkv(1, 2, 128, 14, 2, 64),
                            torch.float16)
    want = ref.attention_ref(hq, hk, hv).float()
    assert worst(tile_model(hq, hk, hv)) < 0.5


@pytest.mark.parametrize("B,T,nq,sm,tile", [
    (1, 1280, 4, 132, 32),     # Gemma3 local / global: 80 blocks
    (4, 1024, 14, 132, 64),    # Qwen2 prefill: 896 blocks
    (2, 512, 32, 132, 64),     # Zamba2 shared block: 512 blocks
    (2, 512, 8, 132, 32),      # MQA: 128 blocks
    (2, 100, 4, 132, 32),
    (1, 64 * 264, 1, 132, 64),  # exactly two blocks an SM
    (1, 64 * 263, 1, 132, 32),
])
def test_fp32_query_tile(B, T, nq, sm, tile):
    assert kernel.fp32_query_tile(B, T, nq, sm) == tile


@pytest.mark.parametrize("T,nq,nkv,hd,window", [
    (1280, 4, 1, 256, 1024),   # Gemma3's local layer, cut to fit the CPU
    (200, 4, 1, 256, 0),
    (100, 4, 2, 32, 0),
    (300, 8, 1, 64, 40),
])
def test_fp32_query_tile_keeps_each_row(T, nq, nkv, hd, window):
    """32-row query tiles visit other key tiles than 64-row ones, but
    the extra tiles are wholly masked for the rows that see them (p = 0,
    alpha = 1; or p = 1 wiped by alpha = 0): every row comes out the
    same to the bit, and within the fp32 tolerance of the oracle."""
    if T > 1000:   # one head of the layer is enough to hold its tiling
        nq = nkv
    q, k, v = (torch.from_numpy(a) for a in _qkv(T + hd, 1, T, nq, nkv, hd))
    a = tile_model(q, k, v, window, block_q=64, tensor_cores=False)
    b = tile_model(q, k, v, window, block_q=32, tensor_cores=False)
    assert torch.equal(a, b)
    want = jref(*(jnp.asarray(x.numpy()) for x in (q, k, v)), causal=True,
                window=window)
    _close(a, want, FP32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("T,S,nq,nkv,hd,window", [
    (100, 150, 4, 4, 64, 0),    # Whisper's cross attention, ragged
    (130, 70, 4, 2, 128, 0),    # more queries than keys
    (150, 150, 4, 1, 256, 40),  # window: later keys all live
])
def test_non_causal_instances(dtype, T, S, nq, nkv, hd, window):
    """The non-causal instances of both routes, tile by tile, against
    the plain version with ``causal=False``: every key tile to S (the S
    edge and the window's edge masked only), the fp32 route's 64- and
    32-row query tiles bit-equal."""
    q, k, v = (torch.from_numpy(a).to(dtype) for a in
               _qkv(T + S + hd, 1, T, nq, nkv, hd, S=S))
    want = ref.attention_ref(q, k, v, causal=False, window=window)
    if dtype == torch.float32:
        got = tile_model(q, k, v, window, causal=False, tensor_cores=False)
        b = tile_model(q, k, v, window, causal=False, block_q=32,
                       tensor_cores=False)
        assert torch.equal(got, b)
        _close(got, want, FP32)
    else:
        _close(tile_model(q, k, v, window, causal=False), want, HALF)
