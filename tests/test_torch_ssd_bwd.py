"""The SSD scan's backward in the port against the JAX package: the plain
backward ``ssd_scan_bwd_ref`` (what the CPU path runs, and what the CUDA
kernel ``ssd_chunk_bwd`` is held against on the card by chip_smoke.py's
phase 1) against ``torch.autograd`` of the plain forward and against
``jax.vjp`` of the reference's per-lane oracle ``ssd_chunk_ref``, on the
same seeded numpy data; ``SSDScanFn``'s routes on the CPU; the wrapper's
checks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk.ref import ssd_chunk_ref as jssd_chunk_ref
from repro_torch.kernels.ssd_chunk import kernel, ops, ref

FP32 = dict(rtol=1e-4, atol=1e-4)    # tests/test_kernels_extra.py:47-48


@pytest.fixture(autouse=True)
def _no_launches():
    """No test here reaches the card: every wrapper call stays on its
    plain version and leaves the launch counts at zero."""
    kernel.reset_launches()
    yield
    assert kernel.LAUNCHES == {"ssd_chunk": 0, "ssd_chunk_bwd": 0}


def _inputs(seed, B, T, H, N, P):
    """Seeded inputs; lam on multiples of 2^-8, so that every fp32 prefix
    sum of it is exact in any order (the JAX reference sums lam in fp32,
    the port in float64)."""
    rng = np.random.default_rng(seed)
    lam = -np.abs(rng.normal(size=(B, T, H))).astype(np.float32) * 0.1
    lam = np.round(lam * 256.0).astype(np.float32) / 256.0
    Bm = rng.normal(size=(B, T, N)).astype(np.float32)
    Cm = rng.normal(size=(B, T, N)).astype(np.float32)
    xdt = rng.normal(size=(B, T, H, P)).astype(np.float32)
    dy = rng.normal(size=(B, T, H, P)).astype(np.float32)
    return lam, Bm, Cm, xdt, dy


def _jax_vjp_lanes(lam, Bm, Cm, xdt, dy, L):
    """The gradients of every (b, h) lane from jax.vjp of the per-lane
    oracle (zero cotangent for the final state); B and C summed over the
    heads, as they are shared."""
    B, T, H = lam.shape
    N, P = Bm.shape[-1], xdt.shape[-1]
    dlam = np.zeros_like(lam)
    dB, dC = np.zeros_like(Bm), np.zeros_like(Cm)
    dx = np.zeros_like(xdt)
    for b in range(B):
        for h in range(H):
            args = (jnp.asarray(lam[b, :, h].reshape(-1, L)),
                    jnp.asarray(Bm[b].reshape(-1, L, N)),
                    jnp.asarray(Cm[b].reshape(-1, L, N)),
                    jnp.asarray(xdt[b, :, h].reshape(-1, L, P)))
            _, vjp = jax.vjp(
                lambda la, bb, cc, xx: jssd_chunk_ref(la, bb, cc, xx,
                                                      jnp.zeros((N, P))),
                *args)
            g = vjp((jnp.asarray(dy[b, :, h].reshape(-1, L, P)),
                     jnp.zeros((N, P))))
            dlam[b, :, h] = np.asarray(g[0]).reshape(T)
            dB[b] += np.asarray(g[1]).reshape(T, N)
            dC[b] += np.asarray(g[2]).reshape(T, N)
            dx[b, :, h] = np.asarray(g[3]).reshape(T, P)
    return dlam, dB, dC, dx


@pytest.mark.parametrize("B,T,H,N,P,chunk", [
    (2, 64, 3, 8, 16, 16),      # four chunks
    (1, 96, 2, 16, 8, 32),      # three chunks
    (2, 32, 2, 8, 8, 32),       # one chunk
    (1, 40, 2, 16, 8, 32),      # ragged: L = T = 40
    (1, 75, 3, 5, 7, 25),       # odd N, P and H; three chunks of 25
])
def test_bwd_ref_matches_autograd_and_jax_vjp(B, T, H, N, P, chunk):
    lam, Bm, Cm, xdt, dy = _inputs(T * 5 + N, B, T, H, N, P)
    got = ref.ssd_scan_bwd_ref(*(torch.from_numpy(a) for a in
                                 (lam, Bm, Cm, xdt, dy)), chunk=chunk)
    names = ("dlam", "dBm", "dCm", "dxdt")
    shapes = [lam.shape, Bm.shape, Cm.shape, xdt.shape]
    for name, g, shape in zip(names, got, shapes):
        assert g.shape == shape and g.dtype == torch.float32, name
    # torch.autograd of the plain forward
    leaves = [torch.from_numpy(a).requires_grad_() for a in
              (lam, Bm, Cm, xdt)]
    y = ref.ssd_scan_ref(*leaves, chunk=chunk)
    auto = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    for name, g, a in zip(names, got, auto):
        np.testing.assert_allclose(g.numpy(), a.numpy(), err_msg=name, **FP32)
    # jax.vjp of the reference's scan, lane by lane
    L = ref.chunk_len(T, chunk)
    for name, g, w in zip(names, got,
                          _jax_vjp_lanes(lam, Bm, Cm, xdt, dy, L)):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **FP32)


def test_dlam_of_one_chunk_starts_from_an_exact_zero():
    """Within one chunk with no state before or after it, dlam_0 is 0:
    every score pair (s < t) lies on one side of step 0, and the closed
    form takes no sum that would cancel to its rounding."""
    lam, Bm, Cm, xdt, dy = _inputs(7, 2, 48, 3, 8, 8)
    dlam = ref.ssd_scan_bwd_ref(*(torch.from_numpy(a) for a in
                                  (lam, Bm, Cm, xdt, dy)), chunk=64)[0]
    assert torch.equal(dlam[:, 0], torch.zeros_like(dlam[:, 0]))
    assert torch.all(dlam[:, 1:].abs() > 0)


def test_scan_fn_routes_to_the_plain_versions_on_cpu():
    """On CPU tensors the kernels' wrappers are the plain versions:
    ``ssd_scan_train`` (forward ``ssd_chunk``, backward
    ``ssd_chunk_bwd``) gives the bits of ``ssd_scan_train_ref``, and
    launches nothing (the fixture)."""
    lam, Bm, Cm, xdt, dy = _inputs(11, 2, 48, 3, 8, 16)
    outs = []
    for fn in (ops.ssd_scan_train, ops.ssd_scan_train_ref):
        leaves = [torch.from_numpy(a).requires_grad_() for a in
                  (lam, Bm, Cm, xdt)]
        y = fn(*leaves, chunk=16)
        outs.append((y,) + torch.autograd.grad(y, leaves,
                                               torch.from_numpy(dy)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    args = [torch.from_numpy(a) for a in (lam, Bm, Cm, xdt)]
    y, saved = kernel.ssd_chunk(*args, chunk=16, return_saved=True)
    assert saved is None and torch.equal(y, outs[1][0].detach())
    got = kernel.ssd_chunk_bwd(*args, torch.from_numpy(dy), chunk=16)
    for a, b in zip(got, outs[1][1:]):
        assert torch.equal(a, b)
    assert kernel.bwd_device_kernels(48, 16) == 6
    assert kernel.bwd_device_kernels(40, 16) == 4   # one chunk of 40


def test_bwd_takes_non_contiguous_dy():
    lam, Bm, Cm, xdt, dy = _inputs(13, 1, 32, 2, 8, 8)
    args = [torch.from_numpy(a) for a in (lam, Bm, Cm, xdt)]
    wide = torch.zeros((1, 32, 2, 16))
    wide[..., :8] = torch.from_numpy(dy)
    strided = wide[..., :8]
    assert not strided.is_contiguous()
    got = kernel.ssd_chunk_bwd(*args, strided, chunk=16)
    want = ref.ssd_scan_bwd_ref(*args, torch.from_numpy(dy), chunk=16)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("which", ["lam", "Bm", "Cm", "xdt", "dy"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float64])
def test_bwd_takes_fp32_only(which, dtype):
    """The model feeds the scan fp32; a half (or double) input to the
    backward raises, on any device, before any work."""
    arrays = dict(zip(("lam", "Bm", "Cm", "xdt", "dy"),
                      _inputs(17, 1, 32, 2, 8, 8)))
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    if which in ("Bm", "Cm", "xdt") and dtype != torch.float64:
        # the forward's dtype check wants B, C and x in one type
        for k in ("Bm", "Cm", "xdt"):
            t[k] = t[k].to(dtype)
    else:
        t[which] = t[which].to(dtype)
    with pytest.raises(TypeError):
        kernel.ssd_chunk_bwd(t["lam"], t["Bm"], t["Cm"], t["xdt"], t["dy"],
                             chunk=16)


def test_bwd_checks_dy_shape():
    lam, Bm, Cm, xdt, dy = _inputs(19, 1, 32, 2, 8, 8)
    args = [torch.from_numpy(a) for a in (lam, Bm, Cm, xdt)]
    with pytest.raises(ValueError):
        kernel.ssd_chunk_bwd(*args, torch.from_numpy(dy)[:, :16], chunk=16)
