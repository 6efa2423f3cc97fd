"""The attention backward of the port against the reference model's:
``attention_bwd_ref`` and ``FlashAttentionFn``'s CPU backward held
against ``jax.vjp`` of ``repro.models.layers.attention.
blockwise_attention`` (its custom VJP) on the same seeded numpy inputs;
``gradcheck`` in float64; the forward's logsumexp against float64 numpy;
the wrappers' checks.

On the CPU the wrappers run their plain versions; an autouse fixture
checks that no kernel launched. The CUDA kernels are held against these
plain versions on the card by ``chip_smoke.py`` phase 1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers.attention import blockwise_attention
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention import ref as faref

# fp32: rtol 1e-5, and atol 1e-5 rather than 1e-6: gradients of size up
# to 14 are sums of up to 600 products taken in another order than the
# reference's tiles, and elements that cancel to ~1e-7 (dq of the first
# rows, where ds = p (dp - delta) nearly vanishes) differ by up to 6.7e-6
# (5e-7 of the largest element). bf16: p and ds rounded to bf16 at the
# same points in both, sums in other orders, gradients rounded once (the
# reference's bf16 attention tolerance, tests/test_kernels.py).
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}

# (B, T, nq, nkv, hd, window, dtype): GQA, MQA, MHA, windows 0 and 8,
# T not a multiple of the reference's 512-row chunk (one tile there).
CASES = [
    (2, 40, 4, 2, 32, 0, "float32"),
    (2, 40, 4, 2, 32, 8, "float32"),
    (1, 600, 4, 1, 64, 8, "float32"),
    (1, 77, 6, 6, 64, 0, "float32"),
    (2, 33, 14, 2, 64, 0, "float32"),
    (1, 70, 6, 2, 64, 8, "bfloat16"),
    (2, 64, 4, 4, 32, 0, "bfloat16"),
    (1, 50, 4, 1, 64, 0, "bfloat16"),
]


@pytest.fixture(autouse=True)
def _no_launches():
    fa.reset_launches()
    yield
    assert fa.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}


def _inputs(B, T, nq, nkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, nq, hd)).astype(np.float32)
    k = rng.normal(size=(B, T, nkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, T, nkv, hd)).astype(np.float32)
    g = rng.normal(size=(B, T, nq, hd)).astype(np.float32)
    return q, k, v, g


def _jax_vjp(q, k, v, g, window, dtype):
    jd = getattr(jnp, dtype)
    out, vjp = jax.vjp(lambda a, b, c: blockwise_attention(a, b, c,
                                                           window=window),
                       *(jnp.asarray(x, jd) for x in (q, k, v)))
    grads = vjp(jnp.asarray(g, jd))
    return (np.asarray(out, np.float32),
            [np.asarray(x, np.float32) for x in grads])


def _t(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("B,T,nq,nkv,hd,window,dtype", CASES)
def test_bwd_ref_matches_blockwise_attention_vjp(B, T, nq, nkv, hd, window,
                                                 dtype):
    q, k, v, g = _inputs(B, T, nq, nkv, hd)
    want_out, want = _jax_vjp(q, k, v, g, window, dtype)
    tq, tk, tv, tg = (_t(x, dtype) for x in (q, k, v, g))
    out, lse = faref.attention_lse_ref(tq, tk, tv, window=window)
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == (B, nq, T)
    np.testing.assert_allclose(out.float().numpy(), want_out, **TOL[dtype])
    got = faref.attention_bwd_ref(tq, tk, tv, out, lse, tg, window=window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == tq.dtype
        np.testing.assert_allclose(a.float().numpy(), b, err_msg=name,
                                   **TOL[dtype])


@pytest.mark.parametrize("B,T,nq,nkv,hd,window,dtype", CASES)
def test_flash_attention_fn_cpu_backward_matches_vjp(B, T, nq, nkv, hd,
                                                     window, dtype):
    """The differentiable entry point the model trains through: on CPU
    tensors its forward is ``attention_lse_ref`` and its backward
    ``attention_bwd_ref``, through the kernels' wrappers."""
    q, k, v, g = _inputs(B, T, nq, nkv, hd, seed=1)
    want_out, want = _jax_vjp(q, k, v, g, window, dtype)
    leaves = [_t(x, dtype).requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention_train(*leaves, window=window)
    out.backward(_t(g, dtype))
    np.testing.assert_allclose(out.detach().float().numpy(), want_out,
                               **TOL[dtype])
    for name, a, b in zip(("dq", "dk", "dv"), leaves, want):
        np.testing.assert_allclose(a.grad.float().numpy(), b, err_msg=name,
                                   **TOL[dtype])
    # the plain entry point gives the same values on the CPU
    plain = [_t(x, dtype).requires_grad_() for x in (q, k, v)]
    ops.attention_train_ref(*plain, window=window).backward(_t(g, dtype))
    for a, b in zip(leaves, plain):
        assert torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("nq,nkv", [(4, 2), (2, 2)])
def test_gradcheck_float64(window, nq, nkv):
    """The plain forward and backward form a consistent VJP (float64, no
    rounding points): finite differences agree."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(size=s)).requires_grad_()
               for s in ((2, 9, nq, 8), (2, 9, nkv, 8), (2, 9, nkv, 8)))
    assert torch.autograd.gradcheck(
        lambda a, b, c: ops.attention_train_ref(a, b, c, window=window),
        (q, k, v), eps=1e-6, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("window", [0, 1, 5])
def test_lse_matches_float64_logsumexp(window):
    q, k, v, _ = _inputs(2, 19, 6, 3, 32, seed=4)
    out, lse = fa.flash_attention(_t(q, "float32"), _t(k, "float32"),
                                  _t(v, "float32"), window=window,
                                  return_lse=True)
    B, T, nq, hd = q.shape
    group = nq // k.shape[2]
    kk = np.repeat(k.astype(np.float64), group, axis=2)
    s = np.einsum("bthd,bshd->bhts", q.astype(np.float64), kk) * hd ** -0.5
    t, sk = np.arange(T)[:, None], np.arange(T)[None, :]
    live = sk <= t
    if window:
        live &= t - sk < window
    s = np.where(live, s, -np.inf)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-6, atol=1e-6)
    ref_out = faref.attention_ref(_t(q, "float32"), _t(k, "float32"),
                                  _t(v, "float32"), window=window)
    np.testing.assert_allclose(out.numpy(), ref_out.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_bwd_wrapper_checks():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 8, 4, 2, 32))
    out, lse = fa.flash_attention(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="T == S"):
        fa.flash_attention_bwd(q, k[:, :6].contiguous(), v[:, :6].contiguous(),
                               out, lse, g)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, k, v, out, lse[:, :3].contiguous(), g)
    with pytest.raises(ValueError, match="dout"):
        fa.flash_attention_bwd(q, k, v, out, lse, g.to(torch.bfloat16))
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_bwd(q, k, v, out, lse, g, window=-1)
    with pytest.raises(ValueError, match="head dim"):
        bad = torch.zeros(1, 8, 4, 16)
        fa.flash_attention_bwd(bad, bad[:, :, :2].contiguous(),
                               bad[:, :, :2].contiguous(), bad,
                               torch.zeros(1, 4, 8), bad)
