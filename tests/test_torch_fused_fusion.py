"""The port's fused weighted-sum kernels against the JAX package's Pallas
kernels (interpret mode, as tests/test_kernels.py runs them).

On the CPU the port's wrappers run their plain PyTorch versions; the CUDA
kernels themselves are held against those versions on the card by
chip_smoke.py. The same seeded numpy data goes through both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_fusion import kernel as jkernel
from repro.kernels.fused_fusion import ops as jops
from repro.kernels.fused_fusion import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels.fused_fusion import kernel, ops, ref
from repro_torch.utils import device

TOL = {np.float32: 2e-5, "bfloat16": 2e-2, np.float16: 2e-2}


def _pair(u32: np.ndarray, dtype):
    """The same fp32 numpy data rounded to ``dtype`` on both sides."""
    if dtype == "bfloat16":
        return (jnp.asarray(u32).astype(jnp.bfloat16),
                torch.from_numpy(u32).to(torch.bfloat16))
    return jnp.asarray(u32.astype(dtype)), torch.from_numpy(u32.astype(dtype))


def _quantized(n, p, block, rng):
    """Random (codes, scales, weights) with Pq padded to the block."""
    n_blocks = -(-p // block)
    codes = rng.integers(-127, 128, size=(n, n_blocks * block), dtype=np.int8)
    codes[:, p:] = 0
    scales = rng.uniform(1e-4, 1e-2, size=(n, n_blocks)).astype(np.float32)
    w = rng.uniform(1, 4, size=(n,)).astype(np.float32)
    return codes, scales, w


@pytest.fixture(autouse=True)
def _no_launches():
    """No test here reaches the card: every wrapper call stays on its
    plain version and leaves the launch counts at zero."""
    kernel.reset_launches()
    yield
    assert kernel.LAUNCHES == {"weighted_sum": 0, "weighted_sum_dequant": 0}


@pytest.mark.parametrize("n,p", [(1, 16), (3, 127), (8, 1024), (37, 5003),
                                 (65, 2048), (256, 301)])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16", np.float16])
def test_weighted_sum_matches_pallas(n, p, dtype):
    rng = np.random.default_rng(n * 7919 + p)
    u32 = rng.normal(size=(n, p)).astype(np.float32)
    w = rng.uniform(1, 4, size=(n,)).astype(np.float32)
    ju, tu = _pair(u32, dtype)
    want = np.asarray(jkernel.weighted_sum_pallas(ju, jnp.asarray(w)))
    tw = torch.from_numpy(w)
    tol = TOL[dtype]
    for got in (kernel.weighted_sum(tu, tw), ref.weighted_sum_ref(tu, tw)):
        assert got.dtype == torch.float32 and got.shape == (p,)
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * 10)
    np.testing.assert_allclose(
        ref.weighted_sum_ref(tu, tw).numpy(),
        np.asarray(jref.weighted_sum_ref(ju, jnp.asarray(w))),
        rtol=tol, atol=tol * 10)


@pytest.mark.parametrize("n,p,block", [
    (1, 128, 128),
    (5, 5003, 2048),
    (37, 4096, 2048),
    (65, 300, 128),
    (256, 1024, 256),
])
def test_weighted_sum_dequant_matches_pallas(n, p, block):
    codes, scales, w = _quantized(n, p, block,
                                  np.random.default_rng(n * 1000 + p))
    want = np.asarray(jkernel.weighted_sum_dequant_pallas(
        jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(w), block=block))
    tq, ts, tw = map(torch.from_numpy, (codes, scales, w))
    got = kernel.weighted_sum_dequant(tq, ts, tw, block=block)
    assert got.shape == (codes.shape[1],) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(
        ref.weighted_sum_dequant_ref(tq, ts, tw, block=block).numpy(),
        np.asarray(jref.weighted_sum_dequant_ref(
            jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(w),
            block=block)),
        rtol=2e-5, atol=1e-4)


def test_ops_match_pallas_ops():
    rng = np.random.default_rng(5)
    u = rng.normal(size=(9, 333)).astype(np.float32)
    w = rng.uniform(1, 9, size=(9,)).astype(np.float32)
    tu, tw = torch.from_numpy(u), torch.from_numpy(w)
    np.testing.assert_allclose(
        ops.fedavg_fused(tu, tw).numpy(),
        np.asarray(jops.fedavg_fused(jnp.asarray(u), jnp.asarray(w))),
        rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(
        ops.iteravg_fused(tu).numpy(),
        np.asarray(jops.iteravg_fused(jnp.asarray(u))), rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(
        ref.fedavg_ref(tu, tw).numpy(),
        np.asarray(jref.fedavg_ref(jnp.asarray(u), jnp.asarray(w))),
        rtol=2e-5, atol=1e-6)
    codes, scales, wq = _quantized(9, 3000, 1024, rng)
    np.testing.assert_allclose(
        ops.fedavg_fused_dequant(*map(torch.from_numpy, (codes, scales, wq)),
                                 block=1024).numpy(),
        np.asarray(jops.fedavg_fused_dequant(
            jnp.asarray(codes), jnp.asarray(scales), jnp.asarray(wq),
            block=1024)),
        rtol=2e-5, atol=1e-5)


def _bad_wsum_inputs():
    u = torch.zeros((4, 8))
    w = torch.ones(4)
    return [
        (TypeError, u.double(), w),                 # dtype not taken
        (TypeError, u.to(torch.int32), w),
        (TypeError, u, w.double()),                 # weights not fp32
        (ValueError, u[0], w),                      # not (n, P)
        (ValueError, u, torch.ones(3)),             # weights shape
        (ValueError, torch.zeros((8, 4)).t(), w),   # not contiguous
        (ValueError, u, torch.ones(8)[::2]),
        (ValueError, u.to("meta"), w.to("meta")),   # neither CPU nor CUDA
    ]


@pytest.mark.parametrize("case", range(len(_bad_wsum_inputs())))
def test_weighted_sum_rejects_bad_inputs(case):
    exc, u, w = _bad_wsum_inputs()[case]
    with pytest.raises(exc):
        kernel.weighted_sum(u, w)


def _bad_dequant_inputs():
    q = torch.zeros((3, 256), dtype=torch.int8)
    s = torch.ones((3, 2))
    w = torch.ones(3)
    return [
        (TypeError, q.float(), s, w, 128),          # codes not int8
        (TypeError, q, s.double(), w, 128),
        (TypeError, q, s, w.half(), 128),
        (ValueError, q, s, w, 100),                 # width not a block multiple
        (ValueError, q, torch.ones((3, 3)), w, 128),  # scales shape
        (ValueError, q, s, torch.ones(2), 128),
        (ValueError, torch.zeros((256, 3), dtype=torch.int8).t(), s, w, 128),
    ]


@pytest.mark.parametrize("case", range(len(_bad_dequant_inputs())))
def test_weighted_sum_dequant_rejects_bad_inputs(case):
    exc, q, s, w, block = _bad_dequant_inputs()[case]
    with pytest.raises(exc):
        kernel.weighted_sum_dequant(q, s, w, block=block)


def _dequant_cover(plan, n, Pq):
    """The kernel's index map under ``plan``: the rows of each split, and
    for each thread of the grid (one row per (tile, thread)) the columns
    of its DQ_VECTORS vectors of DQ_VEC, -1 where past Pq."""
    splits = [np.arange(y * plan.rows_per_split,
                        min(n, (y + 1) * plan.rows_per_split))
              for y in range(plan.splits)]
    x = np.arange(plan.blocks)[:, None, None, None]
    t = np.arange(256)[None, :, None, None]
    v = np.arange(kernel.DQ_VECTORS)[None, None, :, None]
    e = np.arange(kernel.DQ_VEC)[None, None, None, :]
    cols = (x * kernel.DQ_BLOCK_COLS + t // 32 * kernel.DQ_WARP_COLS
            + v * 32 * kernel.DQ_VEC + t % 32 * kernel.DQ_VEC + e)
    cols = cols.reshape(plan.blocks * 256, kernel.DQ_VECTORS, kernel.DQ_VEC)
    return splits, np.where(cols < Pq, cols, -1)


@pytest.mark.parametrize("n", [1, 2, 7, 48, 65])
@pytest.mark.parametrize("Pq,blk", [
    (384, 128), (2048 * 37, 2048), (2048 * 3, 2048), (16 * 7, 16),
    (128 * 37, 128), (6 * 1001, 6), (3 * 5, 3), (16, 16)])
@pytest.mark.parametrize("sms,aligned", [(132, True), (8, True),
                                         (132, False)])
def test_dequant_plan_covers_each_row_and_column_once(n, Pq, blk, sms,
                                                      aligned):
    plan = kernel.dequant_plan(n, Pq, blk, sms, aligned=aligned)
    splits, cols = _dequant_cover(plan, n, Pq)
    # rows: the splits partition [0, n), none empty
    assert all(len(r) for r in splits)
    np.testing.assert_array_equal(np.concatenate(splits), np.arange(n))
    # columns: every column of [0, Pq) once, nothing past it stored
    live = cols[cols >= 0]
    np.testing.assert_array_equal(np.sort(live), np.arange(Pq))
    # a vector is whole or past Pq on the vector routes
    whole = (cols >= 0).all(2) | (cols < 0).all(2)
    assert plan.scale == "element" or whole.all()
    # where the scale is formed once, its columns share one block
    if plan.scale == "thread":
        b = np.where(cols >= 0, cols // blk, -1).reshape(len(cols), -1)
        first = b[:, :1]
        assert ((b == first) | (b < 0)).all()
    if plan.scale == "vector":
        b = np.where(cols >= 0, cols // blk, -1)
        assert ((b == b[:, :, :1]) | (b < 0)).all()
    want = ("element" if not aligned or blk % kernel.DQ_VEC
            else "thread" if blk % kernel.DQ_WARP_COLS == 0 else "vector")
    assert plan.scale == want
    # thin grids split rows towards two blocks an SM
    assert plan.blocks == -(-Pq // kernel.DQ_BLOCK_COLS)
    if plan.blocks >= 2 * sms or n == 1:
        assert plan.splits == 1
    else:
        assert 2 * plan.blocks * plan.splits >= min(2 * sms, plan.blocks * n)


def test_dequant_plan_of_the_compressed_resnet50_block():
    """The main path's shape: one tile per 4096 columns, no split, the
    scale formed once a row for a thread."""
    assert kernel.dequant_plan(2, 22_751_232, 2048, 132) == (
        "thread", 5555, 1, 2)
    assert kernel.dequant_plan(65, 384, 128, 132) == ("vector", 1, 65, 1)


def test_wrappers_read_the_sm_count_of_utils_device():
    assert kernel.sm_count is device.sm_count
    assert not hasattr(kernel, "_SM_COUNT")


def test_nvcc_command_targets_hopper_without_running():
    out = _build.library_path("fused_fusion")
    cmd = _build.nvcc_command("fused_fusion", out)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("arch=compute_90a,code=sm_90a") - 1] == "-gencode"
    assert str(out) in cmd and cmd[-1].endswith("csrc/fused_fusion.cu")
    assert {"-shared", "-O3", "-std=c++17", "-fPIC"} <= set(cmd)
    # the build directory lies inside the checkout and keys on the sources
    assert out.parent.parent == _build.BUILD_ROOT
    assert _build.BUILD_ROOT.parts[-2:] == ("build", "repro_torch")


def test_cuda_source_is_64bit_and_atomic_free():
    """Review guard on the kernel source, which only the card compiles:
    row offsets are formed in 64 bits and no atomics are used, so sums
    repeat bit for bit."""
    src = _build.sources("fused_fusion")[0].read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert "atomic" not in code
    assert "int64_t n, int64_t P" in code and "i * P + c0" in code
    assert "weighted_sum_pallas" in src and "weighted_sum_dequant_pallas" in src
    # the dequant kernel: 64-bit row offsets, one 4-byte code load and one
    # 16-byte store a vector, in the layout dequant_plan assumes
    assert "int64_t n, int64_t Pq" in code and "i * Pq + c0" in code
    assert "reinterpret_cast<const char4*>(row) + v * 32" in code
    assert "st.global.v4.f32" in code and "store_float4(dst + c, acc[v])" in code
    for name, value in (("kDqVec", kernel.DQ_VEC),
                        ("kDqVectors", kernel.DQ_VECTORS)):
        assert f"constexpr int {name} = {value};" in code
