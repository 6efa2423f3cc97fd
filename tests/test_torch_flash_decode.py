"""The port's flash-decode kernel against the JAX package's Pallas
kernel (interpret mode, as tests/test_kernels_extra.py runs it) and the
model's ``decode_attention`` over the ring's live slots.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is held against that version on the card by
chip_smoke.py. The same seeded numpy data goes through both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_decode.kernel import flash_decode as jdecode
from repro.models.cache import cache_valid_mask as jvalid
from repro.models.layers.attention import decode_attention as jattn
from repro_torch.kernels.flash_decode import kernel, ops, ref
from repro_torch.models.cache import cache_valid_mask
from repro_torch.models.layers.attention import decode_attention

FP32 = dict(rtol=2e-4, atol=2e-5)     # tests/test_kernels_extra.py's tolerance
HALF = dict(rtol=5e-2, atol=5e-2)


@pytest.fixture(autouse=True)
def _no_launches():
    """No test here reaches the card: every wrapper call stays on its
    plain version and leaves the launch count at zero."""
    kernel.reset_launches()
    yield
    assert kernel.LAUNCHES == {"flash_decode": 0}


def _qkv(seed, B, S, nq, nkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, 1, nq, hd)).astype(np.float32),
            rng.normal(size=(B, S, nkv, hd)).astype(np.float32),
            rng.normal(size=(B, S, nkv, hd)).astype(np.float32))


@pytest.mark.parametrize("S,nq,nkv,hd,block", [
    (128, 8, 2, 32, 32),
    (256, 4, 4, 64, 64),    # MHA
    (128, 8, 1, 64, 128),   # MQA
    (128, 14, 2, 64, 64),   # Qwen2's 7:1 group
])
@pytest.mark.parametrize("pos", [5, 127, 400])
def test_flash_decode_matches_pallas(S, nq, nkv, hd, block, pos):
    q, k, v = _qkv(S + nq * 13 + pos, 2, S, nq, nkv, hd)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(jdecode(jq, jk, jv, jnp.int32(pos), block_s=block))
    model = np.asarray(jattn(jq, jk, jv, jvalid(S, jnp.int32(pos), 2)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    outs = [ops.flash_decode(tq, tk, tv, pos),
            kernel.flash_decode(tq, tk, tv, torch.tensor(pos)),
            ref.flash_decode_ref(tq, tk, tv, pos),
            decode_attention(tq, tk, tv, cache_valid_mask(S, pos, 2))]
    for got in outs:
        assert got.shape == tq.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **FP32)
        np.testing.assert_allclose(got.numpy(), model, **FP32)


@pytest.mark.parametrize("S,pos", [(200, 77), (200, 199), (600, 1279)])
def test_flash_decode_any_cache_length(S, pos):
    """The decoder's caches are min(length, window) long; the Pallas
    kernel needs S % block == 0, so a ragged S (and a wrapped ring) is
    held against the model's decode_attention."""
    q, k, v = _qkv(S + pos, 2, S, 8, 2, 64)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(jattn(jq, jk, jv, jvalid(S, jnp.int32(pos), 2)))
    got = kernel.flash_decode(*(torch.from_numpy(a) for a in (q, k, v)), pos)
    np.testing.assert_allclose(got.numpy(), want, **FP32)


def test_flash_decode_bf16():
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((2, 1, 4, 64), (2, 128, 2, 64), (2, 128, 2, 64)))
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want_kernel = np.asarray(jdecode(*jb, jnp.int32(64), block_s=64),
                             np.float32)
    want_model = np.asarray(jattn(*jb, jvalid(128, jnp.int32(64), 2)),
                            np.float32)
    got = kernel.flash_decode(*(torch.from_numpy(a).to(torch.bfloat16)
                                for a in (q, k, v)), 64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want_kernel, **HALF)
    # the plain version casts p to bf16 before PV, as decode_attention
    np.testing.assert_allclose(got.float().numpy(), want_model, **HALF)


@pytest.mark.parametrize("pos", [0, 5, 15, 16, 40])
def test_cache_valid_mask_matches_reference(pos):
    want = np.asarray(jvalid(16, jnp.int32(pos), 3))
    for p in (pos, torch.tensor(pos, dtype=torch.int32)):
        got = cache_valid_mask(16, p, 3)
        assert got.shape == (3, 16)
        np.testing.assert_array_equal(got.numpy(), want)


def test_flash_decode_rejects_what_the_kernel_does_not_take():
    tq, tk, tv = (torch.from_numpy(a) for a in _qkv(1, 1, 16, 4, 2, 32))
    with pytest.raises(ValueError, match="1 position"):
        kernel.flash_decode(torch.cat([tq, tq], 1), tk, tv, 3)
    with pytest.raises(ValueError, match="one position"):
        kernel.flash_decode(tq, tk, tv, torch.tensor([1, 2]))
    with pytest.raises(TypeError):
        kernel.flash_decode(tq, tk.double(), tv, 3)
