"""The port's order-statistic kernels and robust fusions against the JAX
package's: the plain versions against the Pallas kernels (interpret mode,
as tests/test_kernels.py runs them), the CPU wrappers, the dense-parity
harness, and every robust fusion's dense ``fuse``.

On the CPU the wrappers run their plain PyTorch versions; the CUDA
kernels are held against those versions on the card by chip_smoke.py.
The same seeded numpy data goes through both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fusion import get_fusion as j_get_fusion
from repro.core.fusion.robust import carve_merge as j_carve_merge
from repro.kernels.robust_fusion import kernel as jkernel
from repro.kernels.robust_fusion import ops as jops
from repro.kernels.robust_fusion import ref as jref
from repro_torch.core.fusion import get_fusion
from repro_torch.core.fusion.robust import carve_merge
from repro_torch.core.local import LocalEngine
from repro_torch.kernels import _build
from repro_torch.kernels.robust_fusion import kernel, ops, ref


@pytest.fixture(autouse=True)
def _no_launches():
    """No test here reaches the card: every wrapper call stays on its
    plain version and leaves the launch counts at zero."""
    kernel.reset_launches()
    yield
    assert kernel.LAUNCHES == {"topk_carve": 0, "trimmed_mean": 0,
                               "coord_median": 0}


# -- plain versions and CPU wrappers against the Pallas kernels ---------------


@pytest.mark.parametrize("n,p", [(3, 64), (8, 1025), (17, 4096), (33, 100)])
def test_coordmedian_matches_pallas(n, p):
    u = np.random.default_rng(n * 7919 + p).normal(size=(n, p)) \
        .astype(np.float32)
    want = np.asarray(jkernel.coordmedian_pallas(jnp.asarray(u)))
    tu = torch.from_numpy(u)
    for got in (kernel.coord_median(tu), ref.coordmedian_ref(tu)):
        assert got.dtype == torch.float32 and got.shape == (p,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # an even-n median is (a + b) * 0.5 of the two middles, as jnp.median
    np.testing.assert_array_equal(
        ref.coordmedian_ref(tu).numpy(),
        np.asarray(jref.coordmedian_ref(jnp.asarray(u))))


@pytest.mark.parametrize("n,trim", [(9, 0), (9, 2), (20, 5)])
def test_trimmedmean_matches_pallas(n, trim):
    u = np.random.default_rng(n * 31 + trim).normal(size=(n, 513)) \
        .astype(np.float32)
    want = np.asarray(jkernel.trimmedmean_pallas(jnp.asarray(u), trim))
    tu = torch.from_numpy(u)
    for got in (kernel.trimmed_mean(tu, trim), ref.trimmedmean_ref(tu, trim)):
        assert got.dtype == torch.float32 and got.shape == (513,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _carry(k_cap, p, rng, fill):
    """An ascending carry with ``fill`` real values per column, the rest
    sentinels, as the reference's buffers hold mid-stream."""
    real = np.sort(rng.normal(size=(2 * k_cap, p)).astype(np.float32), 0)
    topk = real[k_cap:].copy()
    botk = real[:k_cap].copy()
    topk[: k_cap - fill] = -np.inf
    botk[fill:] = np.inf
    return rng.normal(size=(p,)).astype(np.float32), topk, botk


@pytest.mark.parametrize("c,p,k_cap,fill", [
    (6, 257, 3, 0),      # fresh carry
    (5, 1025, 4, 2),     # half-filled carry
    (1, 64, 1, 1),       # K = 1, one row
    (14, 300, 23, 10),   # the CNN4.6 CoordMedian capacity
])
def test_topk_carve_matches_pallas(c, p, k_cap, fill):
    rng = np.random.default_rng(c * 1000 + p + k_cap)
    block = rng.normal(size=(c, p)).astype(np.float32)
    block[:, ::9] = block[0, ::9]            # ties across rows
    block[0, ::13] = np.inf
    block[-1, ::11] = -np.inf
    valid = np.ones((c,), np.float32)
    valid[1::3] = 0.0                        # ragged validity
    ssum, topk, botk = _carry(k_cap, p, rng, fill)
    want = jkernel.topk_carve_pallas(*map(jnp.asarray,
                                          (block, valid, ssum, topk, botk)))
    args = tuple(map(torch.from_numpy, (block, valid, ssum, topk, botk)))
    for got in (kernel.topk_carve(*args), ref.topk_carve_ref(*args),
                carve_merge(*args)):
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-5)
    # the CPU path returns fresh tensors and leaves the carry as it was
    np.testing.assert_array_equal(args[3].numpy(), topk)
    jm = j_carve_merge(*map(jnp.asarray, (block, valid, ssum, topk, botk)))
    np.testing.assert_array_equal(carve_merge(*args)[1].numpy(),
                                  np.asarray(jm[1]))


def test_topk_carve_keeps_nan_as_the_reference_sorts_it():
    """jnp.sort puts NaN after every number: a NaN enters topk and never
    botk, and ssum carries it; the plain version agrees bit for bit."""
    rng = np.random.default_rng(3)
    block = rng.normal(size=(4, 40)).astype(np.float32)
    block[2, ::3] = np.nan
    valid = np.ones((4,), np.float32)
    ssum, topk, botk = _carry(2, 40, rng, 1)
    want = jkernel.topk_carve_pallas(
        *map(jnp.asarray, (block, valid, ssum, topk, botk)))
    got = kernel.topk_carve(*map(torch.from_numpy,
                                 (block, valid, ssum, topk, botk)))
    for i in (1, 2):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    assert np.isnan(got[1].numpy()[-1, ::3]).all()
    assert not np.isnan(got[2].numpy()).any()
    np.testing.assert_array_equal(np.isnan(got[0].numpy()),
                                  np.isnan(np.asarray(want[0])))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_inputs_match_pallas_in_fp32(dtype):
    """bf16 / fp16 blocks: both packages widen to fp32 before sorting."""
    rng = np.random.default_rng(11)
    u32 = rng.normal(size=(9, 333)).astype(np.float32)
    tu = torch.from_numpy(u32).to(dtype)
    ju = jnp.asarray(tu.float().numpy())     # the same rounded values
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    np.testing.assert_allclose(
        kernel.coord_median(tu).numpy(),
        np.asarray(jkernel.coordmedian_pallas(ju.astype(jdt))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        kernel.trimmed_mean(tu, 2).numpy(),
        np.asarray(jkernel.trimmedmean_pallas(ju.astype(jdt), 2)),
        rtol=1e-5, atol=1e-5)
    ssum, topk, botk = _carry(3, 333, rng, 0)
    valid = np.ones((9,), np.float32)
    want = jkernel.topk_carve_pallas(ju.astype(jdt), *map(
        jnp.asarray, (valid, ssum, topk, botk)))
    got = kernel.topk_carve(tu, *map(torch.from_numpy,
                                     (valid, ssum, topk, botk)))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("n,trim,chunk", [(11, 2, 3), (11, 5, 4), (16, 0, 8),
                                          (10, 4, 1)])
def test_carve_stream_dense_harness_matches(n, trim, chunk):
    u = np.random.default_rng(n + trim).normal(size=(n, 130)) \
        .astype(np.float32)
    want = np.asarray(jops.carve_stream_dense(jnp.asarray(u), trim,
                                              chunk=chunk))
    tu = torch.from_numpy(u)
    for use_kernel in (True, False):
        got = ops.carve_stream_dense(tu, trim, chunk=chunk,
                                     use_kernel=use_kernel)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            got.numpy(), ref.trimmedmean_ref(tu, trim).numpy(),
            rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="too large"):
        ops.carve_stream_dense(tu, n // 2 + (n % 2), chunk=chunk)


# -- wrapper contracts --------------------------------------------------------


def _bad_carve_inputs():
    b = torch.zeros((3, 8))
    v = torch.ones(3)
    s = torch.zeros(8)
    t = torch.zeros((2, 8))
    return [
        (TypeError, b.double(), v, s, t, t),            # block dtype
        (TypeError, b.to(torch.int32), v, s, t, t),
        (TypeError, b, v.double(), s, t, t),            # carry not fp32
        (TypeError, b, v, s, t.half(), t),
        (ValueError, b[0], v, s, t, t),                 # not (c, P)
        (ValueError, b, torch.ones(2), s, t, t),        # valid shape
        (ValueError, b, v, torch.zeros(7), t, t),       # ssum shape
        (ValueError, b, v, s, torch.zeros((0, 8)), torch.zeros((0, 8))),
        (ValueError, b, v, s, t, torch.zeros((3, 8))),  # botk != topk
        (ValueError, torch.zeros((8, 3)).t(), v, s, t, t),   # not contiguous
        (ValueError, b, v, s, torch.zeros((8, 2)).t(), t),
        (ValueError, *(x.to("meta") for x in (b, v, s, t, t))),
    ]


@pytest.mark.parametrize("case", range(len(_bad_carve_inputs())))
def test_topk_carve_rejects_bad_inputs(case):
    exc, *args = _bad_carve_inputs()[case]
    with pytest.raises(exc):
        kernel.topk_carve(*args)


def _bad_dense_inputs():
    u = torch.zeros((5, 8))
    return [
        (TypeError, u.double(), 1),
        (TypeError, u.to(torch.int64), 1),
        (ValueError, u[0], 1),                  # not (n, P)
        (ValueError, torch.zeros((8, 5)).t(), 1),  # not contiguous
        (ValueError, u.to("meta"), 1),
        (ValueError, u, 3),                     # 2 * trim >= n
        (ValueError, u, -1),
    ]


@pytest.mark.parametrize("case", range(len(_bad_dense_inputs())))
def test_dense_kernels_reject_bad_inputs(case):
    exc, u, trim = _bad_dense_inputs()[case]
    with pytest.raises(exc):
        kernel.trimmed_mean(u, trim)
    if trim == 1:   # the median takes no trim: the same input checks
        with pytest.raises(exc):
            kernel.coord_median(u)
    with pytest.raises(ValueError):
        kernel.coord_median(torch.zeros((0, 4)))


def test_nvcc_command_targets_hopper_without_running():
    out = _build.library_path("robust_fusion")
    cmd = _build.nvcc_command("robust_fusion", out)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert str(out) in cmd and cmd[-1].endswith("csrc/robust_fusion.cu")
    assert out.parent.parent == _build.BUILD_ROOT
    assert out != _build.library_path("fused_fusion")


def test_cuda_source_is_64bit_atomic_free_and_names_its_tpu_kernels():
    """Review guard on the kernel source, which only the card compiles:
    device-memory offsets are formed in 64 bits, no atomics, and the
    header names the three TPU kernels it replaces."""
    src = _build.sources("robust_fusion")[0].read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert "atomic" not in code
    assert "int64_t rows, int64_t P" in code and "i * P + p" in code
    for name in ("topk_carve_pallas", "trimmedmean_pallas",
                 "coordmedian_pallas"):
        assert name in src
    for entry in ("robust_topk_carve", "robust_trimmed_mean",
                  "robust_coord_median", "robust_dense_route"):
        assert f" {entry}(" in code


# -- every robust fusion's dense fuse -----------------------------------------


ROBUST = ["coordmedian", "trimmedmean", "krum", "zeno", "geomedian"]


@pytest.mark.parametrize("pair", [("kernel", "pallas"), ("torch", "jnp")],
                         ids=lambda p: p[0])
@pytest.mark.parametrize("n", [7, 12])
@pytest.mark.parametrize("name", ROBUST)
def test_robust_dense_fuse_matches(name, n, pair):
    from repro.core.local import LocalEngine as JLocalEngine

    rng = np.random.default_rng(n * 17 + len(name))
    u = rng.normal(size=(n, 301)).astype(np.float32)
    w = rng.uniform(1, 5, size=(n,)).astype(np.float32)
    got = LocalEngine(strategy=pair[0], device="cpu").fuse(
        get_fusion(name), u, w)
    want = JLocalEngine(strategy=pair[1]).fuse(j_get_fusion(name), u, w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [{}, {"m": 3}, {"n_byzantine": 3, "m": 2}])
def test_krum_duplicate_rows_select_like_lax_top_k(kw):
    """Duplicate client rows tie on their Krum scores; a stable sort
    breaks the tie toward the lower index, as jax.lax.top_k does."""
    rng = np.random.default_rng(5)
    u = rng.normal(size=(9, 64)).astype(np.float32)
    u[4] = u[1]
    u[7] = u[1]
    u[8] = u[2]
    tf, jf = get_fusion("krum", **kw), j_get_fusion("krum", **kw)
    gram = u @ u.T
    np.testing.assert_array_equal(
        tf.select_from_gram(torch.from_numpy(gram)).numpy(),
        np.asarray(jf.select_from_gram(jnp.asarray(gram))))
    np.testing.assert_allclose(
        tf.fuse(torch.from_numpy(u), None).numpy(),
        np.asarray(jf.fuse(jnp.asarray(u), None)), rtol=1e-5, atol=1e-6)


def test_zeno_duplicate_rows_and_val_grad_clone():
    rng = np.random.default_rng(6)
    u = rng.normal(size=(8, 48)).astype(np.float32)
    u[5] = u[0]
    u[6] = u[0]
    g = rng.normal(size=(48,)).astype(np.float32)
    for kw in ({}, {"n_suspect": 3}):
        base, jbase = get_fusion("zeno", **kw), j_get_fusion("zeno", **kw)
        ours = base.with_val_grad(g)            # an ndarray, as JAX holds it
        theirs = jbase.with_val_grad(jnp.asarray(g))
        assert base._g_val is None and isinstance(ours._g_val, torch.Tensor)
        np.testing.assert_allclose(
            ours.fuse(torch.from_numpy(u), None).numpy(),
            np.asarray(theirs.fuse(jnp.asarray(u), None)),
            rtol=1e-5, atol=1e-6)
        # no g_val bound: the self-referential mean
        np.testing.assert_allclose(
            base.fuse(torch.from_numpy(u), None).numpy(),
            np.asarray(jbase.fuse(jnp.asarray(u), None)),
            rtol=1e-5, atol=1e-6)
    legacy = get_fusion("zeno")
    legacy.set_val_grad(torch.from_numpy(g))
    np.testing.assert_allclose(
        legacy.fuse(torch.from_numpy(u), None).numpy(),
        get_fusion("zeno").with_val_grad(g).fuse(torch.from_numpy(u),
                                                 None).numpy(),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kw", [{}, {"iters": 3, "smooth": 1e-3}])
def test_geomedian_matches(kw):
    rng = np.random.default_rng(7)
    u = rng.normal(size=(10, 77)).astype(np.float32)
    u[3] = u[4]
    w = rng.uniform(1, 4, size=(10,)).astype(np.float32)
    np.testing.assert_allclose(
        get_fusion("geomedian", **kw).fuse(torch.from_numpy(u),
                                           torch.from_numpy(w)).numpy(),
        np.asarray(j_get_fusion("geomedian", **kw).fuse(jnp.asarray(u),
                                                        jnp.asarray(w))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,beta", [(4, 0.5), (5, 0.5), (3, 0.4), (2, 0.5),
                                    (48, 0.1), (48, 0.2)])
def test_trim_counts_match(n, beta):
    assert get_fusion("trimmedmean", beta=beta).trim_count(n) == \
        j_get_fusion("trimmedmean", beta=beta).trim_count(n)
    assert get_fusion("coordmedian").trim_count(n) == \
        j_get_fusion("coordmedian").trim_count(n)
    for name in ("trimmedmean", "coordmedian"):
        f, jf = get_fusion(name), j_get_fusion(name)
        assert f.state_signature(300, n) == jf.state_signature(300, n)
        assert f.state_nbytes(300, n) == jf.state_nbytes(300, n)
