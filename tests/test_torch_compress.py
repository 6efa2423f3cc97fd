"""The port's quantized transport against the JAX package's: codes and
scales bit for bit, error-feedback residuals, and byte accounting."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import compress as jc
from repro_torch.core import compress as tc
from repro_torch.utils.dtypes import host_array


@pytest.mark.parametrize("p,block", [(1, 2048), (5003, 2048), (4096, 1024),
                                     (300, 128), (20000, 2048)])
def test_compress_update_bit_identical(p, block):
    rng = np.random.default_rng(p + block)
    v = (rng.normal(size=(p,)) * rng.uniform(0.01, 50)).astype(np.float32)
    v[: min(p, 7)] = 0.0   # an all-zero stretch takes the scale floor
    want = jc.compress_update(v, block)
    got = tc.compress_update(v, block)
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.scales, want.scales)
    assert got.codes.dtype == np.int8 and got.scales.dtype == np.float32
    assert got.dim == want.dim and got.nbytes == want.nbytes
    q, s = tc._quantize_np(v, block)
    jq, js = jc._quantize_np(v, block)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(got.dequantize(), want.dequantize())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_quantize_matches_jax(dtype):
    rng = np.random.default_rng(3)
    v = rng.normal(size=(5000,)).astype(np.float32)
    jv = jnp.asarray(v).astype(dtype)
    tv = torch.from_numpy(v).to(getattr(torch, dtype))
    jq, js = jc.quantize(jv, 1024)
    tq, ts = tc.quantize(tv, 1024)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tc.dequantize(tq, ts, 1024).numpy(),
                               np.asarray(jc.dequantize(jq, js, 1024)),
                               rtol=0, atol=0)


def test_error_feedback_residuals_match_over_rounds():
    rng = np.random.default_rng(11)
    jef = jc.ErrorFeedbackCompressor(block=512)
    tef = tc.ErrorFeedbackCompressor(block=512)
    for _ in range(3):
        for cid in ("a", "b"):
            u = rng.normal(size=(3001,)).astype(np.float32)
            want = jef.compress_update(cid, u)
            got = tef.compress_update(cid, u)
            np.testing.assert_array_equal(got.codes, want.codes)
            np.testing.assert_array_equal(got.scales, want.scales)
            np.testing.assert_array_equal(
                np.asarray(tef._residual[cid]),
                np.asarray(jef._residual[cid]))


def test_error_feedback_compress_matches_jax():
    """The device-side ``compress`` (torch quantize) carries the same
    residual as the JAX one."""
    rng = np.random.default_rng(12)
    jef = jc.ErrorFeedbackCompressor(block=256)
    tef = tc.ErrorFeedbackCompressor(block=256)
    for _ in range(3):
        u = rng.normal(size=(1000,)).astype(np.float32)
        jq, js = jef.compress("c", jnp.asarray(u))
        tq, ts = tef.compress("c", torch.from_numpy(u))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_allclose(tef._residual["c"].numpy(),
                                   np.asarray(jef._residual["c"]),
                                   rtol=0, atol=1e-7)


@pytest.mark.parametrize("p,block", [(1, 2048), (2048, 2048), (2049, 2048),
                                     (22_750_000, 2048), (300, 128)])
def test_compressed_bytes_equal(p, block):
    assert tc.compressed_bytes(p, block) == jc.compressed_bytes(p, block)
    assert tc.compression_ratio(p, block) == jc.compression_ratio(p, block)


def test_compressed_block_container():
    rng = np.random.default_rng(2)
    cus = [tc.compress_update(rng.normal(size=(700,)).astype(np.float32), 256)
           for _ in range(3)]
    blk = tc.CompressedBlock(codes=np.stack([c.codes for c in cus]),
                             scales=np.stack([c.scales for c in cus]), dim=700)
    jblk = jc.CompressedBlock(codes=blk.codes, scales=blk.scales, dim=700)
    assert (blk.rows, blk.block, blk.nbytes) == (jblk.rows, jblk.block,
                                                 jblk.nbytes)
    np.testing.assert_array_equal(blk.dequantize(), jblk.dequantize())


def test_compress_update_takes_tensors():
    """A client may hand the port a tensor: it quantizes like the numpy
    vector it holds."""
    v = np.random.default_rng(4).normal(size=(999,)).astype(np.float32)
    a = tc.compress_update(torch.from_numpy(v), 128)
    b = jc.compress_update(v, 128)
    np.testing.assert_array_equal(a.codes, b.codes)
    np.testing.assert_array_equal(a.scales, b.scales)


@pytest.mark.parametrize("words", [False, True], ids=["ml_dtypes", "BF16"])
def test_bf16_arrays_quantize_like_jax(words):
    """A bf16 ndarray, as a JAX caller holds it (ml_dtypes) or as the
    port's store keeps it (``BF16`` words), quantizes through the module
    functions and the error-feedback compressor as the reference
    quantizes the same values."""
    rng = np.random.default_rng(21)
    v = rng.normal(size=(3000,)).astype(ml_dtypes.bfloat16)
    arr = host_array(v) if words else v
    jq, js = jc.quantize(jnp.asarray(v), 512)
    tq, ts = tc.quantize(arr, 512)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    want = jc.compress_update(v, 512)
    for got in (tc.compress_update(arr, 512),
                tc.ErrorFeedbackCompressor(block=512).compress_update("c", arr)):
        np.testing.assert_array_equal(got.codes, want.codes)
        np.testing.assert_array_equal(got.scales, want.scales)
        assert got.dim == want.dim
    jq, js = jc.ErrorFeedbackCompressor(block=512).compress("c", jnp.asarray(v))
    tq, ts = tc.ErrorFeedbackCompressor(block=512).compress("c", arr)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
