"""The port's flash-attention kernel against the JAX package's Pallas
kernel (interpret mode, as tests/test_kernels.py runs it), its naive
oracle and the model's blockwise attention.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is held against that version on the card by
chip_smoke.py. The same seeded numpy data goes through both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jref
from repro.models.layers.attention import blockwise_attention
from repro_torch.kernels.flash_attention import kernel, ops, ref

FP32 = dict(rtol=2e-4, atol=3e-5)     # tests/test_kernels.py's fp32 tolerance
HALF = dict(rtol=5e-2, atol=5e-2)     # its bf16 tolerance


@pytest.fixture(autouse=True)
def _no_launches():
    """No test here reaches the card: every wrapper call stays on its
    plain version and leaves the launch count at zero."""
    kernel.reset_launches()
    yield
    assert kernel.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}


def _qkv(seed, B, T, nq, nkv, hd, S=None):
    rng = np.random.default_rng(seed)
    S = T if S is None else S
    return (rng.normal(size=(B, T, nq, hd)).astype(np.float32),
            rng.normal(size=(B, S, nkv, hd)).astype(np.float32),
            rng.normal(size=(B, S, nkv, hd)).astype(np.float32))


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("T,nq,nkv,hd", [
    (128, 4, 4, 64),    # MHA
    (128, 8, 2, 64),    # GQA 4:1
    (128, 14, 2, 64),   # GQA 7:1 (Qwen2's group)
    (256, 4, 1, 128),   # MQA, bigger head
])
@pytest.mark.parametrize("window", [0, 64])
def test_flash_attention_matches_pallas(T, nq, nkv, hd, window):
    q, k, v = _qkv(T * 31 + nq * 7 + nkv + window, 2, T, nq, nkv, hd)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=window,
                             block_q=64, block_k=64))
    oracle = np.asarray(jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=window))
    tq, tk, tv = _torch(q, k, v)
    for got in (ops.flash_attention(tq, tk, tv, window=window),
                ref.attention_ref(tq, tk, tv, window=window)):
        assert got.dtype == torch.float32 and got.shape == tq.shape
        np.testing.assert_allclose(got.numpy(), want, **FP32)
        np.testing.assert_allclose(got.numpy(), oracle, **FP32)


def test_flash_attention_bf16():
    q, k, v = _qkv(11, 2, 128, 4, 2, 64)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jflash(*jb, block_q=64, block_k=64), np.float32)
    got = kernel.flash_attention(*_torch(q, k, v, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **HALF)


@pytest.mark.parametrize("T,window", [(100, 0), (77, 24), (1, 0)])
def test_flash_attention_ragged_t(T, window):
    """The Pallas kernel needs T % 256 == 0; the port's takes any T, so
    a ragged T is held against the naive oracle."""
    q, k, v = _qkv(T + window, 2, T, 6, 2, 32)
    want = np.asarray(jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, window=window))
    got = kernel.flash_attention(*_torch(q, k, v), window=window)
    np.testing.assert_allclose(got.numpy(), want, **FP32)


def test_flash_attention_gemma_local_head():
    """hd 256, MQA and a window shorter than T: Gemma3's local layer."""
    q, k, v = _qkv(5, 1, 96, 4, 1, 256)
    want = np.asarray(jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, window=32))
    got = kernel.flash_attention(*_torch(q, k, v), window=32)
    np.testing.assert_allclose(got.numpy(), want, **FP32)


def test_flash_matches_model_blockwise():
    """The port's kernel and the JAX model's pure-jnp blockwise path
    agree (the check tests/test_kernels.py makes of the Pallas kernel)."""
    q, k, v = _qkv(9, 2, 256, 6, 2, 64)
    want = np.asarray(blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_chunk=64, kv_chunk=64))
    got = kernel.flash_attention(*_torch(q, k, v))
    np.testing.assert_allclose(got.numpy(), want, **FP32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,S,nq,nkv,window", [
    (32, 64, 4, 4, 0),     # fewer queries than keys (cross attention)
    (32, 50, 6, 2, 0),     # ragged S: one 50-key tile in Pallas
    (64, 64, 4, 1, 16),    # window: later keys all live, earlier 15
])
def test_non_causal_matches_pallas(T, S, nq, nkv, window, dtype):
    """``causal=False``: the encoder's and the cross attention's route,
    against the Pallas kernel with ``causal=False`` in interpret mode and
    its naive oracle; fp32 at tests/test_kernels.py's 2e-4, bf16 at its
    5e-2."""
    q, k, v = _qkv(T + 3 * S + window, 2, T, nq, nkv, 32, S=S)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want = np.asarray(jflash(jq, jk, jv, causal=False, window=window,
                             block_q=64, block_k=64), np.float32)
    oracle = np.asarray(jref(jq, jk, jv, causal=False, window=window),
                        np.float32)
    tq, tk, tv = _torch(q, k, v, dtype=getattr(torch, dtype))
    got = kernel.flash_attention(tq, tk, tv, causal=False, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = FP32 if dtype == "float32" else HALF
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    np.testing.assert_allclose(got.float().numpy(), oracle, **tol)


@pytest.mark.parametrize("T,S,window", [(100, 33, 0), (70, 90, 24)])
def test_non_causal_ragged_and_lse(T, S, window):
    """Ragged T and S the Pallas kernel cannot tile, against the naive
    oracle; the lse output of the non-causal route against the plain
    forward's, and the causal one differs."""
    q, k, v = _qkv(T * 5 + S + window, 2, T, 6, 3, 64, S=S)
    want = np.asarray(jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=False, window=window))
    tq, tk, tv = _torch(q, k, v)
    got, lse = kernel.flash_attention(tq, tk, tv, causal=False,
                                      window=window, return_lse=True)
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    out_ref, lse_ref = ref.attention_lse_ref(tq, tk, tv, causal=False,
                                             window=window)
    np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), **FP32)
    np.testing.assert_allclose(out_ref.numpy(), want, **FP32)
    causal = kernel.flash_attention(tq, tk, tv, window=window)
    assert not np.allclose(causal.numpy(), want, **FP32)


def test_non_causal_mask_is_one_sided():
    """``attention_mask`` follows the Pallas mask: without ``causal``
    every key is live but for the window's lower edge."""
    m = ref.attention_mask(4, 6, 2, causal=False)
    want = np.array([[1, 1, 1, 1, 1, 1], [1, 1, 1, 1, 1, 1],
                     [0, 1, 1, 1, 1, 1], [0, 0, 1, 1, 1, 1]], bool)
    np.testing.assert_array_equal(m.numpy(), want)
    np.testing.assert_array_equal(ref.attention_mask(3, 3, 0).numpy(),
                                  np.tril(np.ones((3, 3), bool)))
    assert ref.attention_mask(3, 5, 0, causal=False).all()


def test_flash_attention_rejects_what_the_kernel_does_not_take():
    q, k, v = _torch(*_qkv(1, 1, 8, 4, 2, 32))
    with pytest.raises(ValueError, match="head dim"):
        kernel.flash_attention(q[..., :16].contiguous(),
                               k[..., :16].contiguous(),
                               v[..., :16].contiguous())
    with pytest.raises(ValueError, match="group"):
        kernel.flash_attention(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(TypeError):
        kernel.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.flash_attention(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="window"):
        kernel.flash_attention(q, k, v, window=-1)
