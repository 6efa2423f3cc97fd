"""A model, in PyTorch on the CPU, of the arithmetic of the port's
attention backward on the tensor cores (``flash_attn_bwd``,
``src/repro_torch/csrc/flash_attention.cu``: bf16 / fp16 on
``mma.sync.m16n8k16``, fp32 on ``mma.sync.m16n8k8`` TF32 in three
passes), held against ``jax.vjp`` of the JAX model's
``blockwise_attention`` (its custom VJP) and against the port's plain
``attention_bwd_ref``.

The model follows the kernels block by block: a dK / dV block owns
``kernel.bwd_tiles(hd)[0]`` keys of S and visits the query tiles of
``kernel.dkdv_query_tiles``; a dQ block owns as many queries of T and
visits the key tiles of ``kernel.dq_key_tiles`` (the same plan in every
dtype), causal (the decoders, S == T) or not (the encoder-decoder's
encoder and cross attention, any S). p = exp2(s * scale * log2 e - lse *
log2 e) with s the unscaled fp32 dot, masked (p = 0) only on the tiles
where a warp's 16 rows cross the diagonal (causal only), the window's
edge, T (dK / dV) or S (dQ); ds = p (dp - delta) scale. bf16 /
fp16: every product takes operands rounded to the input dtype and sums
in fp32, one 16-wide k-step at a time, in the kernels' tile and k-step
order; p enters dV rounded once, as the reference's ``pb``, and ds
enters dQ and dK rounded once, as its ``dsb``. fp32: every operand, p
and ds included, is split into hi = tf32(v) and lo = tf32(v - hi)
(``cvt.rna.tf32``) and each 8-wide k-step adds lo.hi, then hi.lo, then
hi.hi to the fp32 accumulators (``mma3``), the k-steps that take p or ds
from the accumulators in the kernels' permuted order (column 2t at k t,
2t + 1 at k t + 4). With GQA the dK / dV partials of each q head are
summed in head order before the one rounding. The CUDA kernels are held
against the plain version on the card by ``chip_smoke.py`` phase 1.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers.attention import blockwise_attention
from repro_torch.kernels.flash_attention import kernel, ref

# tests/test_torch_flash_bwd.py's tolerances: bf16 the reference's bf16
# attention tolerance (fp16 is held to the same), fp32 rtol / atol 1e-5
TOL = {torch.bfloat16: dict(rtol=5e-2, atol=5e-2),
       torch.float16: dict(rtol=5e-2, atol=5e-2),
       torch.float32: dict(rtol=1e-5, atol=1e-5)}
LOG2E = 1.4426950408889634
JDT = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16,
       torch.float32: jnp.float32}
# acc_frag_split's k order in an 8-wide k-step fed from the accumulators
PERM8 = [0, 2, 4, 6, 1, 3, 5, 7]


def tf32(a: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 as cvt.rna.tf32.f32 does: the low 13 mantissa
    bits dropped, to nearest, ties away from zero (half an ulp added to
    the magnitude, then masked)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _step(acc, a, b, passes):
    """acc + a @ b for one k-step in fp32: the operands as they are
    (``passes`` 0: the half route, whose operands are the rounded
    values), or split into TF32 hi + lo and added as lo.hi, hi.lo, hi.hi
    (3), or hi.hi alone (1)."""
    if passes == 0:
        return acc + a @ b
    ah, bh = tf32(a), tf32(b)
    if passes == 3:
        acc = acc + tf32(a - ah) @ bh
        acc = acc + ah @ tf32(b - bh)
    return acc + ah @ bh


def _products(a, b, kw, passes):
    """a (..., m, hd) . b (..., n, hd)^T in fp32, one ``kw``-wide k-step
    at a time, in order."""
    acc = torch.zeros(a.shape[:-1] + (b.shape[-2],))
    for k0 in range(0, a.shape[-1], kw):
        acc = _step(acc, a[..., k0:k0 + kw],
                    b[..., k0:k0 + kw].transpose(-1, -2), passes)
    return acc


def _accumulate(acc, a, b, kw, passes):
    """acc (..., m, n) + a (..., m, K) @ b (..., K, n) in fp32, one
    ``kw``-wide k-step of K at a time, in order; a TF32 k-step (a taken
    from the accumulators) in ``PERM8`` order."""
    for k0 in range(0, a.shape[-1], kw):
        x, y = a[..., k0:k0 + kw], b[..., k0:k0 + kw, :]
        if passes:
            x, y = x[..., PERM8], y[..., PERM8, :]
        acc = _step(acc, x, y, passes)
    return acc


def bwd_model(q, k, v, out, lse, dout, window=0, *, causal=True,
              split_p=False, cast=True, passes=3):
    """The tile kernels' arithmetic: (dq, dk, dv) of q (B, T, nq, hd),
    k / v (B, S, nkv, hd), the forward's out and lse (B, nq, T) and
    dout, causal or not, in q's dtype (fp32, before the one rounding,
    when ``cast`` is False). ``split_p`` feeds bf16 / fp16 p to dV as hi + lo, two rounded
    terms (the forward's bf16 split), where the kernel rounds it once.
    fp32 takes 8-wide k-steps of ``passes`` TF32 products (the kernel's
    3, or 1 to show what one pass would give)."""
    dt = q.dtype
    kw, passes = (8, passes) if dt == torch.float32 else (16, 0)
    B, T, nq, hd = q.shape
    S, nkv = k.shape[1], k.shape[2]
    group = nq // nkv
    rows, bq, bk = kernel.bwd_tiles(hd)
    # room for every tile that crosses T or S
    pad = -(-max(T, S) // 64) * 64 + 64

    def heads(x):   # (B, n, h, hd) -> (B, h, pad, hd) fp32, rows past n 0
        o = torch.zeros((B, x.shape[2], pad, hd))
        o[:, :, :x.shape[1]] = x.float().transpose(1, 2)
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

    def p_ds(s, dp, t, keys, edge, t_end, s_end):
        """p and ds of a (queries t) x (keys) tile of scores s, dp; the
        mask (queries at or past ``t_end`` and keys at or past ``s_end``
        dead too) applies where ``edge`` (per query row or key column)
        is set."""
        p = torch.exp2(s * scale_log2 - lse2[:, :, t, None])
        live = (t < t_end)[:, None] & (keys < s_end)[None, :]
        if causal:
            live &= keys[None, :] <= t[:, None]
        if window > 0:
            live &= t[:, None] - keys[None, :] < window
        p = torch.where(edge & ~live, torch.zeros(()), p)
        return p, p * (dp - delta[:, :, t, None]) * scale

    def rounded(x):
        return x.to(dt).float()

    # dK / dV: per key block, the live query tiles in order
    dk_part = torch.zeros((B, nq, pad, hd))
    dv_part = torch.zeros((B, nq, pad, hd))
    for k0 in range(0, S, rows):
        keys = torch.arange(k0, k0 + rows)
        kw0 = k0 + 16 * ((keys - k0) // 16)   # each key's warp's first key
        dk_acc = torch.zeros((B, nq, rows, hd))
        dv_acc = torch.zeros((B, nq, rows, hd))
        for qt in kernel.dkdv_query_tiles(k0, T, window, hd, S=S,
                                          causal=causal):
            q0 = qt * bq
            t = torch.arange(q0, q0 + bq)
            edge = ((q0 < kw0 + 15) & causal) | (q0 + bq > T)
            if window > 0:
                edge |= q0 + bq - 1 - kw0 >= window
            s = _products(qf[:, :, q0:q0 + bq], kf[:, :, k0:k0 + rows], kw,
                          passes)
            dp = _products(gf[:, :, q0:q0 + bq], vf[:, :, k0:k0 + rows], kw,
                           passes)
            # keys past S are never stored
            p, ds = p_ds(s, dp, t, keys, edge[None, :], T, pad)
            pt, dst = p.transpose(-1, -2), ds.transpose(-1, -2)
            if split_p:
                hi = rounded(pt)
                for kk in range(0, bq, 16):
                    g_kk = gf[:, :, q0 + kk:q0 + kk + 16]
                    dv_acc = dv_acc + hi[..., kk:kk + 16] @ g_kk
                    dv_acc = dv_acc + rounded(pt - hi)[..., kk:kk + 16] @ g_kk
            else:
                dv_acc = _accumulate(dv_acc, rounded(pt),
                                     gf[:, :, q0:q0 + bq], kw, passes)
            dk_acc = _accumulate(dk_acc, rounded(dst), qf[:, :, q0:q0 + bq],
                                 kw, passes)
        dk_part[:, :, k0:k0 + rows] = dk_acc
        dv_part[:, :, k0:k0 + rows] = dv_acc

    # dQ: per query block, the live key tiles in order
    dq = torch.zeros((B, nq, pad, hd))
    for q0 in range(0, T, rows):
        t = torch.arange(q0, q0 + rows)
        qw0 = q0 + 16 * ((t - q0) // 16)   # each row's warp's first row
        acc = torch.zeros((B, nq, rows, hd))
        for kt in kernel.dq_key_tiles(q0, T, window, hd, S=S, causal=causal):
            k0 = kt * bk
            keys = torch.arange(k0, k0 + bk)
            edge = ((k0 + bk - 1 > qw0) & causal) | (k0 + bk > S)
            if window > 0:
                edge |= qw0 + 15 - k0 >= window
            s = _products(qf[:, :, q0:q0 + rows], kf[:, :, k0:k0 + bk], kw,
                          passes)
            dp = _products(gf[:, :, q0:q0 + rows], vf[:, :, k0:k0 + bk], kw,
                           passes)
            _, ds = p_ds(s, dp, t, keys, edge[:, None], pad, S)   # rows
            # past T are dropped at the end
            acc = _accumulate(acc, rounded(ds), kf[:, :, k0:k0 + bk], kw,
                              passes)
        dq[:, :, q0:q0 + rows] = acc

    def summed(part):   # a kv head's q heads in head order, from 0
        total = torch.zeros((B, nkv, pad, hd))
        for i in range(group):
            total = total + part.reshape(B, nkv, group, pad, hd)[:, :, i]
        return total

    dk = summed(dk_part) if group > 1 else dk_part
    dv = summed(dv_part) if group > 1 else dv_part
    grads = [x[:, :, :n].transpose(1, 2)
             for x, n in ((dq, T), (dk, S), (dv, S))]
    return tuple(x.to(dt) for x in grads) if cast else tuple(grads)


def _inputs(seed, B, T, nq, nkv, hd, dtype, S=None):
    rng = np.random.default_rng(seed)
    S = T if S is None else S
    arrays = [rng.normal(size=s).astype(np.float32) for s in
              ((B, T, nq, hd), (B, S, nkv, hd), (B, S, nkv, hd),
               (B, T, nq, hd))]
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _jax_vjp(q, k, v, g, window, causal=True):
    jd = JDT[q.dtype]
    args = [jnp.asarray(t.float().numpy()).astype(jd) for t in (q, k, v)]
    _, vjp = jax.vjp(lambda a, b, c: blockwise_attention(
        a, b, c, causal=causal, window=window), *args)
    grads = vjp(jnp.asarray(g.float().numpy()).astype(jd))
    return [np.asarray(x, np.float32) for x in grads]


# (B, T, nq, nkv, hd, window, dtype): GQA, MQA, MHA; ragged T = 1, 17,
# 70, 150; windows 1, 5 and T - 1; hd 32 and 64 (64-row query tiles, A
# fragments in registers in bf16 / fp16), 128 (32-row query tiles) and
# 256 (32-row blocks, the head dim split over two warps); fp32 at each
# head dim
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
    (2, 70, 4, 2, 64, 0, torch.float32),       # GQA, two 64-row tiles
    (1, 70, 4, 1, 32, 5, torch.float32),       # MQA, window 5, hd 32
    (2, 17, 4, 4, 32, 0, torch.float32),       # MHA, T = 17
    (2, 1, 6, 2, 64, 0, torch.float32),        # T = 1
    (2, 17, 14, 2, 64, 16, torch.float32),     # Qwen2's group of 7
    (1, 150, 4, 2, 64, 40, torch.float32),     # three key blocks
    (1, 70, 4, 1, 128, 1, torch.float32),      # hd 128, window 1
    (1, 70, 2, 1, 256, 20, torch.float32),     # hd 256, MQA
    (1, 100, 4, 1, 256, 0, torch.float32),     # hd 256, four key blocks
]
# non-causal (B, T, S, nq, nkv, hd, window, dtype): Whisper's shapes cut
# down (an encoder layer T == S; the cross attention, T < S), T > S,
# ragged S past a key tile, one-sided windows with T <= S (every query
# keeps a live key), hd 32 to 256, every dtype
NONCAUSAL = [
    (2, 70, 70, 4, 4, 64, 0, torch.bfloat16),     # an encoder layer
    (1, 30, 150, 4, 4, 64, 0, torch.bfloat16),    # cross attention, T < S
    (1, 150, 45, 4, 2, 32, 0, torch.float16),     # T > S, GQA
    (1, 40, 90, 4, 1, 128, 7, torch.bfloat16),    # window 7, hd 128
    (1, 20, 70, 2, 1, 256, 0, torch.float16),     # hd 256
    (2, 70, 70, 4, 4, 64, 0, torch.float32),      # an encoder layer
    (1, 30, 150, 4, 4, 64, 0, torch.float32),     # cross attention, T < S
    (1, 150, 45, 4, 2, 32, 0, torch.float32),     # T > S, GQA
    (1, 40, 90, 4, 1, 128, 7, torch.float32),     # window 7, hd 128
    (1, 20, 70, 2, 1, 256, 3, torch.float32),     # hd 256, window 3
]


def _dt(d):
    return str(d).split(".")[-1]


# the causal cases keep their names from before the non-causal ones came
ALL = ([pytest.param(B, T, T, nq, nkv, hd, w, True, dt,
                     id=f"B{B}-T{T}-{nq}x{nkv}-hd{hd}-w{w}-{_dt(dt)}")
        for B, T, nq, nkv, hd, w, dt in CASES]
       + [pytest.param(B, T, S, nq, nkv, hd, w, False, dt,
                       id=f"noncausal-B{B}-T{T}-S{S}-{nq}x{nkv}-hd{hd}-w{w}-"
                          f"{_dt(dt)}")
          for B, T, S, nq, nkv, hd, w, dt in NONCAUSAL])
ARGS = "B,T,S,nq,nkv,hd,window,causal,dtype"


@pytest.fixture(autouse=True)
def _no_launches():
    kernel.reset_launches()
    yield
    assert kernel.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these small CPU tensors: under a parallel
    test run, torch's default of a thread a core in every worker made a
    float64 ``gradcheck`` here take minutes instead of seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model_case(B, T, S, nq, nkv, hd, window, causal, dtype, **kw):
    seed = T + nq + hd + window + (0 if causal else S)
    q, k, v, g = _inputs(seed, B, T, nq, nkv, hd, dtype, S=S)
    out, lse = ref.attention_lse_ref(q, k, v, causal=causal, window=window)
    return (q, k, v, out, lse, g), bwd_model(q, k, v, out, lse, g, window,
                                             causal=causal, **kw)


@pytest.mark.parametrize(ARGS, ALL)
def test_model_matches_blockwise_attention_vjp(B, T, S, nq, nkv, hd, window,
                                               causal, dtype):
    (q, k, v, _, _, g), got = _model_case(B, T, S, nq, nkv, hd, window,
                                          causal, dtype)
    want = _jax_vjp(q, k, v, g, window, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        np.testing.assert_allclose(a.float().numpy(), b, err_msg=name,
                                   **TOL[dtype])


@pytest.mark.parametrize(ARGS, ALL)
def test_model_matches_attention_bwd_ref(B, T, S, nq, nkv, hd, window,
                                         causal, dtype):
    args, got = _model_case(B, T, S, nq, nkv, hd, window, causal, dtype)
    want = ref.attention_bwd_ref(*args, causal=causal, window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype == dtype
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   err_msg=name, **TOL[dtype])


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


def _violation(got, want, tol):
    """max |got - want| / (atol + rtol |want|): at most 1 where
    ``assert_allclose`` passes."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(got - want)
                  / (tol["atol"] + tol["rtol"] * np.abs(want))).max())


def test_one_tf32_pass_breaks_the_tolerance():
    """One TF32 pass a product (operands rounded to 10-bit mantissas)
    moves the fp32 gradients far past rtol / atol 1e-5 of the reference's
    VJP at the Qwen2 head dim; the kernels' three passes stay inside."""
    B, T, nq, nkv, hd, window = 1, 150, 4, 2, 64, 0
    q, k, v, g = _inputs(11, B, T, nq, nkv, hd, torch.float32)
    out, lse = ref.attention_lse_ref(q, k, v)
    want = _jax_vjp(q, k, v, g, window)
    tol = TOL[torch.float32]
    for passes, ok in ((3, True), (1, False)):
        got = bwd_model(q, k, v, out, lse, g, window, passes=passes)
        worst = max(_violation(a.numpy(), b, tol) for a, b in zip(got, want))
        assert (worst < 1.0) if ok else (worst > 5.0), (passes, worst)


def _visits(tiles_of, T, S, window, hd, block, tile, owner_is_key):
    """(T, S) count of the visits each (query, key) pair gets from the
    blocks of ``block`` rows (keys of S when ``owner_is_key``, else
    queries of T) and their tiles of ``tile`` rows."""
    n = np.zeros((T, S), np.int64)
    own_n, other_n = (S, T) if owner_is_key else (T, S)
    for r0 in range(0, own_n, block):
        own = slice(r0, min(r0 + block, own_n))
        for i in tiles_of(r0, window):
            other = slice(i * tile, min((i + 1) * tile, other_n))
            if owner_is_key:
                n[other, own] += 1
            else:
                n[own, other] += 1
    return n


# the causal cases with S == T keep their names from before the others
SCHEDULES = [pytest.param(T, T, w, True, id=f"{T}-{w}") for T, w in [
    (1, 0), (17, 0), (70, 0), (70, 1), (70, 5), (70, 69), (300, 64),
    (512, 0), (1280, 1024), (1000, 2048), (333, 31),
]] + [pytest.param(T, S, w, c, id=f"{'' if c else 'non'}causal-T{T}-S{S}-w{w}")
      for T, S, w, c in [
    (1536, 1536, 0, False), (448, 1536, 0, False), (1536, 448, 0, False),
    (70, 70, 5, False), (17, 300, 64, False), (333, 100, 31, False),
    (300, 17, 0, False), (100, 333, 31, True), (333, 100, 31, True),
    (70, 1, 0, False), (1, 70, 0, True),
]]


@pytest.mark.parametrize("hd", [32, 64, 128, 256])
@pytest.mark.parametrize("T,S,window,causal", SCHEDULES)
def test_schedules_visit_every_live_pair_once(hd, T, S, window, causal):
    """``dkdv_query_tiles`` and ``dq_key_tiles`` (the CUDA loop bounds)
    visit every live (query, key) pair exactly once, and no tile that
    holds no live pair for its block, causal or not, at any T and S; a
    block whose keys no query reaches visits nothing."""
    rows, bq, bk = kernel.bwd_tiles(hd)
    t, s = np.arange(T)[:, None], np.arange(S)[None, :]
    live = s <= t if causal else np.ones((T, S), bool)
    if window > 0:
        live &= t - s < window
    kw = dict(S=S, causal=causal)
    for tiles_of, tile, owner_is_key in (
            (lambda r0, w: kernel.dkdv_query_tiles(r0, T, w, hd, **kw), bq,
             True),
            (lambda r0, w: kernel.dq_key_tiles(r0, T, w, hd, **kw), bk,
             False)):
        n = _visits(tiles_of, T, S, window, hd, rows, tile, owner_is_key)
        assert (n[live] == 1).all()
        assert n.max() <= 1
        own_n, other_n = (S, T) if owner_is_key else (T, S)
        for r0 in range(0, own_n, rows):   # every visited tile holds live
            own = slice(r0, min(r0 + rows, own_n))   # work
            for i in tiles_of(r0, window):
                other = slice(i * tile, min((i + 1) * tile, other_n))
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
    # 2 common kernels a dtype, and 2 tile kernels a dtype at 4 head dims,
    # each causal and not
    assert len(inst) == len(set(inst)) == 3 * (2 + 2 * 4 * 2) == 54
    assert {c for name, _, hd, c in inst
            if name in kernel.BWD_COMMON_KERNELS} == {None}
    assert kernel.bwd_route(torch.bfloat16).startswith("tensor cores")
    assert kernel.bwd_route(torch.float32) == \
        "tensor cores (mma.sync, 3 x TF32)"
    assert kernel.BWD_TILE_KERNELS[torch.float32] == (
        "bwd_dkdv_split_kernel", "bwd_dq_split_kernel")


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
    named = {name for name, _, _, _ in kernel.bwd_instances()}
    assert found == named


def test_the_tf32_helpers_live_in_one_header():
    """``tf32``, ``split``, ``mma_tf32`` and ``mma3`` are defined once, in
    ``csrc/mma_tf32.cuh``, which both the SSD scan and the attention
    backward include."""
    import re

    from repro_torch.kernels import _build

    header = _build.CSRC / "mma_tf32.cuh"
    assert header in _build.headers()
    defs = r"__device__ __forceinline__ \w+ (tf32|split|mma_tf32|mma3)\("
    assert sorted(set(re.findall(defs, header.read_text()))) == [
        "mma3", "mma_tf32", "split", "tf32"]
    for name in ("ssd_chunk", "flash_attention"):
        src = _build.sources(name)[0].read_text()
        assert '#include "mma_tf32.cuh"' in src
        assert not re.findall(defs, src), name
        assert str(header) not in _build.nvcc_command(name, Path("x.so"))


def test_library_path_hashes_the_headers(tmp_path, monkeypatch):
    """A library's build directory keys on its source and on every
    header in ``csrc``: an edited header builds anew, and the header is
    never handed to nvcc as a source of its own."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "lib_a.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    first = _build.library_path("lib_a")
    assert _build.library_path("lib_a") == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = _build.library_path("lib_a")
    assert second != first and second.parent.parent == _build.BUILD_ROOT
    (tmp_path / "other.cuh").write_text("// new header\n")
    assert _build.library_path("lib_a") != second
    cmd = _build.nvcc_command("lib_a", second)
    assert cmd[-1] == str(tmp_path / "lib_a.cu")
    assert not any(c.endswith(".cuh") for c in cmd)
