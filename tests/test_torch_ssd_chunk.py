"""The port's SSD chunked-scan kernel against the JAX package's: its plain
version against ``ssd_scan`` (the Pallas kernel in interpret mode, as
tests/test_kernels_extra.py runs it) and the per-lane oracle
``ssd_chunk_ref``, on the same seeded numpy data.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is held against that version on the card by
chip_smoke.py (phase 1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk.ops import ssd_scan as jssd_scan
from repro.kernels.ssd_chunk.ref import ssd_chunk_ref as jssd_chunk_ref
from repro_torch.kernels.ssd_chunk import kernel, ops, ref

FP32 = dict(rtol=1e-4, atol=1e-4)    # tests/test_kernels_extra.py:47-48
BF16 = dict(rtol=5e-2, atol=5e-2)    # tests/test_kernels_extra.py:76


@pytest.fixture(autouse=True)
def _no_launches():
    """No test here reaches the card: every wrapper call stays on its
    plain version and leaves the launch count at zero."""
    kernel.reset_launches()
    yield
    assert kernel.LAUNCHES == {"ssd_chunk": 0, "ssd_chunk_bwd": 0}


def _inputs(seed, B, T, H, N, P, lam_scale=0.1):
    rng = np.random.default_rng(seed)
    lam = -np.abs(rng.normal(size=(B, T, H))).astype(np.float32) * lam_scale
    Bm = rng.normal(size=(B, T, N)).astype(np.float32)
    Cm = rng.normal(size=(B, T, N)).astype(np.float32)
    xdt = rng.normal(size=(B, T, H, P)).astype(np.float32)
    return lam, Bm, Cm, xdt


def _lanes(lam, Bm, Cm, xdt, L):
    """The (b, h) lanes as ssd_chunk_ref takes them: (nc, L, ...)."""
    B, T, H = lam.shape
    N, P = Bm.shape[-1], xdt.shape[-1]
    for b in range(B):
        for h in range(H):
            yield b, h, (lam[b, :, h].reshape(-1, L),
                         Bm[b].reshape(-1, L, N), Cm[b].reshape(-1, L, N),
                         xdt[b, :, h].reshape(-1, L, P))


@pytest.mark.parametrize("B,T,H,N,P,L", [
    (1, 32, 1, 8, 8, 8),        # tests/test_kernels_extra.py:24-28
    (2, 64, 3, 8, 16, 16),
    (2, 128, 2, 16, 32, 32),
    (2, 60, 3, 8, 16, 16),      # ragged: 60 % 16 != 0, one chunk of 60
    (1, 40, 2, 16, 8, 32),      # ragged: L = T = 40
    (2, 24, 2, 8, 8, 32),       # T < chunk: L = T
])
def test_ssd_scan_matches_pallas(B, T, H, N, P, L):
    lam, Bm, Cm, xdt = _inputs(T * 7 + H, B, T, H, N, P)
    want = np.asarray(jssd_scan(*(jnp.asarray(a) for a in (lam, Bm, Cm, xdt)),
                                chunk=L))
    args = [torch.from_numpy(a) for a in (lam, Bm, Cm, xdt)]
    outs = [ops.ssd_scan(*args, chunk=L), kernel.ssd_chunk(*args, chunk=L),
            ref.ssd_scan_ref(*args, chunk=L)]
    for got in outs:
        assert got.shape == (B, T, H, P) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **FP32)
    Lc = ref.chunk_len(T, L)
    for b, h, lane in _lanes(lam, Bm, Cm, xdt, Lc):
        yr, _ = jssd_chunk_ref(*(jnp.asarray(a) for a in lane),
                               jnp.zeros((N, P)))
        np.testing.assert_allclose(outs[0][b, :, h].numpy(),
                                   np.asarray(yr).reshape(T, P), **FP32)


@pytest.mark.parametrize("nc,L,N,P", [(1, 16, 8, 8), (4, 16, 8, 16),
                                      (3, 24, 16, 32)])
def test_ssd_chunk_ref_matches_reference(nc, L, N, P):
    """The per-lane oracle, from a nonzero carried state: outputs and the
    final state."""
    rng = np.random.default_rng(nc * 100 + L)
    lam = -np.abs(rng.normal(size=(nc, L))).astype(np.float32) * 0.1
    Bm, Cm = (rng.normal(size=(nc, L, N)).astype(np.float32) for _ in range(2))
    xdt = rng.normal(size=(nc, L, P)).astype(np.float32)
    h0 = rng.normal(size=(N, P)).astype(np.float32)
    jy, jh = jssd_chunk_ref(*(jnp.asarray(a) for a in (lam, Bm, Cm, xdt, h0)))
    y, h = ref.ssd_chunk_ref(*(torch.from_numpy(a)
                               for a in (lam, Bm, Cm, xdt, h0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **FP32)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **FP32)


def test_ssd_scan_bf16_inputs():
    """tests/test_kernels_extra.py:52-77: B, C and x in bf16, lam fp32."""
    B, T, H, N, P, L = 1, 64, 2, 8, 16, 8
    lam, Bm, Cm, xdt = _inputs(11, B, T, H, N, P, lam_scale=0.05)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (Bm, Cm, xdt)]
    want = np.asarray(jssd_scan(jnp.asarray(lam), *jb, chunk=L))
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (Bm, Cm, xdt)]
    got = kernel.ssd_chunk(torch.from_numpy(lam), *tb, chunk=L)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **BF16)
    # the same bf16 values upcast: the plain version is the fp32 scan
    up = ref.ssd_scan_ref(torch.from_numpy(lam), *(t.float() for t in tb),
                          chunk=L)
    np.testing.assert_allclose(got.numpy(), up.numpy(), **FP32)


@pytest.mark.parametrize("kind", ["underflow", "zero"])
def test_ssd_scan_extreme_decays(kind):
    """lam <= -50 (every decay but the diagonal underflows) and lam = 0
    (no decay): finite, and as the reference's."""
    B, T, H, N, P, L = 2, 48, 2, 8, 8, 16
    lam, Bm, Cm, xdt = _inputs(13, B, T, H, N, P)
    lam = lam * 10.0 - 50.0 if kind == "underflow" else np.zeros_like(lam)
    want = np.asarray(jssd_scan(*(jnp.asarray(a) for a in (lam, Bm, Cm, xdt)),
                                chunk=L))
    got = kernel.ssd_chunk(*(torch.from_numpy(a) for a in (lam, Bm, Cm, xdt)),
                           chunk=L)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    if kind == "underflow":   # only s = t survives: y_t = (C_t . B_t) x_t
        diag = np.einsum("btn,btn->bt", Cm, Bm)[..., None, None] * xdt
        np.testing.assert_allclose(got.numpy(), diag, **FP32)


@pytest.mark.parametrize("T,chunk,L", [(1024, 256, 256), (600, 256, 600),
                                       (64, 256, 64), (300, 256, 300),
                                       (4096, 256, 256), (48, 16, 16)])
def test_chunk_len_falls_back_to_the_whole_sequence(T, chunk, L):
    assert ref.chunk_len(T, chunk) == L


def test_ssd_chunk_rejects_what_the_kernel_does_not_take():
    lam, Bm, Cm, xdt = (torch.from_numpy(a)
                        for a in _inputs(1, 1, 16, 2, 8, 8))
    with pytest.raises(ValueError, match="state"):
        kernel.ssd_chunk(lam, torch.zeros(1, 16, 129), torch.zeros(1, 16, 129),
                         xdt)
    with pytest.raises(ValueError, match="head dim"):
        kernel.ssd_chunk(lam, Bm, Cm, torch.zeros(1, 16, 2, 65))
    with pytest.raises(ValueError, match="match"):
        kernel.ssd_chunk(lam, Bm[:, :8].contiguous(), Cm[:, :8].contiguous(),
                         xdt)
    with pytest.raises(TypeError):
        kernel.ssd_chunk(lam, Bm.to(torch.bfloat16), Cm, xdt)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.ssd_chunk(lam, Bm, Cm, xdt.transpose(2, 3).contiguous()
                         .transpose(2, 3))
    with pytest.raises(ValueError, match="chunk"):
        kernel.ssd_chunk(lam, Bm, Cm, xdt, chunk=0)
