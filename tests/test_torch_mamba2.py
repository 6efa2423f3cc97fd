"""The port's Mamba2 layer against the JAX package's
(``repro.models.layers.mamba2``): ``group_norm``, the causal conv, the
chunked forward (through the SSD wrapper, which runs its plain version
on the CPU) and the recurrent decode step, on the same seeded numpy data
at 1e-5 in fp32.

An autouse fixture checks that no kernel launched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import mamba2 as jm
from repro.models.layers.norms import group_norm as jgroup_norm
from repro_torch.kernels.ssd_chunk import kernel as sk
from repro_torch.kernels.ssd_chunk.ref import ssd_scan_ref
from repro_torch.models.layers import mamba2 as tm
from repro_torch.models.layers.norms import group_norm

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = ("w_in", "conv_w", "dt_bias", "a_log", "d_skip", "norm_scale",
          "w_out")
DIMS = dict(d_model=32, d_inner=64, n_heads=4, head_dim=16, state=8,
            conv_width=4)


@pytest.fixture(autouse=True)
def _no_launches():
    sk.reset_launches()
    yield
    assert sk.LAUNCHES == {"ssd_chunk": 0, "ssd_chunk_bwd": 0}


def _params(seed, chunk, dtype=jnp.float32):
    """JAX-initialised parameters with the zero / constant ones drawn
    at random too, so every field is exercised; and the port's module
    holding the same values."""
    jd = jm.Mamba2Dims(chunk=chunk, **DIMS)
    p = jm.init_mamba2(jax.random.PRNGKey(seed), jd, dtype)
    rng = np.random.default_rng(seed)
    p = p._replace(
        dt_bias=jnp.asarray(rng.normal(size=(jd.n_heads,)) - 3.0, jnp.float32),
        a_log=jnp.asarray(rng.normal(size=(jd.n_heads,)) * 0.5, jnp.float32),
        d_skip=jnp.asarray(rng.normal(size=(jd.n_heads,)), jnp.float32),
        norm_scale=jnp.asarray(rng.normal(size=(jd.d_inner,)) * 0.1, dtype))
    td = tm.Mamba2Dims(*jd)
    cell = tm.Mamba2(td, torch.float32, device="cpu")
    for name in FIELDS:
        getattr(cell, name).copy_(
            torch.from_numpy(np.array(getattr(p, name), np.float32)))
    return jd, p, td, cell


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [1, 4, 16])
def test_group_norm_matches_reference(dtype, groups):
    """Population variance, fp32 compute, (1 + scale), cast back."""
    rng = np.random.default_rng(groups)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.normal(size=(64,)).astype(np.float32) * 0.1
    want = np.asarray(jgroup_norm(jnp.asarray(x).astype(dtype),
                                  jnp.asarray(scale), groups), np.float32)
    tdt = getattr(torch, dtype)
    got = group_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(scale),
                     groups)
    assert got.dtype == tdt
    tol = LAYER_TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_group_norm_uses_the_population_variance():
    """Groups of two values a, b normalise to -1, +1 (ddof 0); the
    unbiased estimate would give -0.707, +0.707."""
    x = torch.tensor([[1.0, 3.0, -2.0, 6.0]])
    got = group_norm(x, torch.zeros(4), n_groups=2, eps=0.0)
    np.testing.assert_allclose(got.numpy(), [[-1.0, 1.0, -1.0, 1.0]],
                               rtol=1e-6)


@pytest.mark.parametrize("W,T", [(4, 9), (2, 1), (4, 3)])
def test_causal_conv_matches_reference(W, T):
    rng = np.random.default_rng(W * 10 + T)
    xbc = rng.normal(size=(2, T, 24)).astype(np.float32)
    w = rng.normal(size=(W, 24)).astype(np.float32) * 0.3
    want = np.asarray(jm._causal_conv(jnp.asarray(xbc), jnp.asarray(w)))
    got = tm._causal_conv(torch.from_numpy(xbc), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)


@pytest.mark.parametrize("T,chunk", [(32, 8), (24, 8), (20, 8), (5, 16)])
def test_mamba2_forward_matches_reference(T, chunk):
    """Chunked (T % chunk == 0) and the L = T fallback (20 % 8, 5 < 16)."""
    jd, p, td, cell = _params(T + chunk, chunk)
    x = np.random.default_rng(T).normal(size=(2, T, DIMS["d_model"])) \
        .astype(np.float32)
    want = np.asarray(jm.mamba2_forward(p, jd, jnp.asarray(x)))
    got = tm.mamba2_forward(cell, td, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **LAYER_TOL)
    plain = tm.mamba2_forward(cell, td, torch.from_numpy(x), ssd=ssd_scan_ref)
    np.testing.assert_allclose(plain.numpy(), want, **LAYER_TOL)


def test_mamba2_decode_steps_match_reference_and_forward():
    """Each recurrent step equals the reference's, the cache is updated
    in place (same tensors, same values as the reference's new cache),
    and the steps reproduce the chunked forward."""
    jd, p, td, cell = _params(7, 8)
    B, T = 2, 12
    x = np.random.default_rng(8).normal(size=(B, T, DIMS["d_model"])) \
        .astype(np.float32)
    jc = jm.init_mamba2_cache(B, jd, jnp.float32)
    cache = tm.init_mamba2_cache(B, td, torch.float32)
    conv, state = cache.conv, cache.state
    ys = []
    for t in range(T):
        jc, jy = jm.mamba2_decode_step(p, jd, jc, jnp.asarray(x[:, t:t + 1]))
        cache, y = tm.mamba2_decode_step(cell, td, cache,
                                         torch.from_numpy(x[:, t:t + 1]))
        assert cache.conv is conv and cache.state is state
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **LAYER_TOL)
        np.testing.assert_allclose(state.numpy(), np.asarray(jc.state),
                                   **LAYER_TOL)
        np.testing.assert_allclose(conv.numpy(), np.asarray(jc.conv),
                                   **LAYER_TOL)
        ys.append(y)
    full = tm.mamba2_forward(cell, td, torch.from_numpy(x))
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_mamba2_module_shapes_and_dtypes():
    """The reference's shapes; dt_bias, a_log and d_skip stay fp32 in a
    bf16 layer (repro/models/layers/mamba2.py:65-67)."""
    jd = jm.Mamba2Dims(chunk=8, **DIMS)
    ref = jm.init_mamba2(jax.random.PRNGKey(0), jd, jnp.bfloat16)
    cell = tm.Mamba2(tm.Mamba2Dims(*jd), torch.bfloat16, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    for name in FIELDS:
        want = getattr(ref, name)
        got = getattr(cell, name)
        assert tuple(got.shape) == want.shape, name
        assert str(got.dtype).split(".")[1] == str(want.dtype), name
    assert [n for n, _ in cell.named_parameters()] == list(FIELDS)
