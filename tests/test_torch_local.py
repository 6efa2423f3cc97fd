"""The port's LocalEngine against the JAX package's, for every fusion the
port has: strategy ``kernel`` against ``pallas`` and ``torch`` against
``jnp``, on the same seeded numpy inputs (CPU; the kernel strategy runs
the kernels' plain versions here). The order-statistic streams have
their own file, ``test_torch_robust_stream.py``."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.compress import compress_update as j_compress_update
from repro.core.fusion import REGISTRY as J_REGISTRY
from repro.core.fusion import get_fusion as j_get_fusion
from repro.core.local import LocalEngine as JLocalEngine
from repro_torch.core.compress import CompressedBlock, compress_update
from repro_torch.core.fusion import REGISTRY, FusionAlgorithm, get_fusion
from repro_torch.core.local import LocalEngine
from repro_torch.kernels.fused_fusion import kernel
from repro_torch.utils import jitcache

FUSIONS = sorted(REGISTRY)
SUM_FAMILY = [name for name in FUSIONS if REGISTRY[name].reducible]
PAIRS = [("kernel", "pallas"), ("torch", "jnp")]
RTOL, ATOL = 2e-5, 1e-6


def _engines(pair, **kw):
    ours, theirs = pair
    return (LocalEngine(strategy=ours, device="cpu", **kw),
            JLocalEngine(strategy=theirs, **kw))


def _data(n, p, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, p)).astype(np.float32),
            rng.uniform(1, 5, size=(n,)).astype(np.float32))


def _blocks(u, w, chunk, scale=None):
    for lo in range(0, u.shape[0], chunk):
        if scale is None:
            yield u[lo:lo + chunk], w[lo:lo + chunk]
        else:
            yield u[lo:lo + chunk], w[lo:lo + chunk], scale[lo:lo + chunk]


def _close(got, want):
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_fusion_registry_is_the_sum_family():
    """The registry is the JAX package's, name for name, and the sum
    family within it is the same set with the same capability flags."""
    assert FUSIONS == sorted(J_REGISTRY)
    assert SUM_FAMILY == ["clippedavg", "fedadam", "fedavg", "fedavgm",
                          "gradavg", "iteravg"]
    for name in FUSIONS:
        ours, theirs = get_fusion(name), j_get_fusion(name)
        assert type(ours).__name__ == type(theirs).__name__
        for flag in ("reducible", "coordinatewise", "weighted",
                     "streamable"):
            assert getattr(ours, flag) == getattr(theirs, flag), (name, flag)


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[0])
@pytest.mark.parametrize("name", FUSIONS)
def test_dense_fuse(name, pair):
    """Dense fuse at a non-power-of-two client count, two rounds so the
    server optimizers' state advances on both sides."""
    ours, theirs = _engines(pair)
    tf, jf = get_fusion(name), j_get_fusion(name)
    for seed in (1, 2):
        u, w = _data(13, 517, seed)
        _close(ours.fuse(tf, u, w), theirs.fuse(jf, u, w))
    _close(ours.fuse(tf, torch.from_numpy(u), None),
           theirs.fuse(jf, u, None))


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[0])
@pytest.mark.parametrize("name", ["fedavg", "iteravg", "clippedavg",
                                  "fedadam"])
def test_memory_capped_fuse(name, pair):
    u, w = _data(10, 300, 3)
    ours, theirs = _engines(pair, memory_cap_bytes=300 * 4 * 3)
    _close(ours.fuse(get_fusion(name), u, w),
           theirs.fuse(j_get_fusion(name), u, w))
    assert ours.is_warm(get_fusion(name), 10, 300, np.float32)


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[0])
@pytest.mark.parametrize("name", SUM_FAMILY)
def test_stream_ragged_final_block(name, pair):
    u, w = _data(13, 301, 4)
    ours, theirs = _engines(pair)
    got, rep = ours.fuse_stream(get_fusion(name), _blocks(u, w, 4))
    want, jrep = theirs.fuse_stream(j_get_fusion(name), _blocks(u, w, 4))
    _close(got, want)
    for field in ("n_rows", "n_blocks", "chunk_rows", "ingest_bytes"):
        assert getattr(rep, field) == getattr(jrep, field), field
    _close(rep.acc_wsum, jrep.acc_wsum)
    assert rep.acc_tot == pytest.approx(jrep.acc_tot, rel=1e-6)
    # the same key again: a warm step, no build
    builds = jitcache.trace_count()
    again, rep2 = ours.fuse_stream(get_fusion(name), _blocks(u, w, 4))
    assert rep2.compile_seconds == 0.0 and ours.last_compile_seconds == 0.0
    assert jitcache.trace_count() == builds
    if name not in ("fedavgm", "fedadam"):
        np.testing.assert_array_equal(again.numpy(), got.numpy())


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[0])
def test_stream_scales_and_pinned_chunk(pair):
    """Per-row staleness scales multiply the effective weights; a pinned
    chunk_rows keys one step for a round of undersized blocks."""
    u, w = _data(11, 257, 5)
    scale = np.linspace(0.5, 1.0, 11).astype(np.float32)
    for name in ("fedavg", "iteravg"):
        ours, theirs = _engines(pair)
        got, rep = ours.fuse_stream(get_fusion(name),
                                    _blocks(u, w, 3, scale), chunk_rows=5)
        want, jrep = theirs.fuse_stream(j_get_fusion(name),
                                        _blocks(u, w, 3, scale), chunk_rows=5)
        _close(got, want)
        assert (rep.chunk_rows, rep.n_blocks) == (jrep.chunk_rows,
                                                  jrep.n_blocks) == (5, 4)


def _compressed_blocks(u, w, chunk, block, make):
    for lo in range(0, u.shape[0], chunk):
        cus = [make(row, block) for row in u[lo:lo + chunk]]
        yield (np.stack([c.codes for c in cus]),
               np.stack([c.scales for c in cus]), cus[0].dim), \
            w[lo:lo + chunk]


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[0])
@pytest.mark.parametrize("name", ["fedavg", "iteravg", "clippedavg",
                                  "fedavgm"])
def test_compressed_stream(name, pair):
    from repro.core.compress import CompressedBlock as JBlock

    u, w = _data(11, 700, 6)
    ours, theirs = _engines(pair)
    got, rep = ours.fuse_stream(
        get_fusion(name),
        ((CompressedBlock(*p), wb) for p, wb in
         _compressed_blocks(u, w, 4, 256, compress_update)))
    want, jrep = theirs.fuse_stream(
        j_get_fusion(name),
        ((JBlock(*p), wb) for p, wb in
         _compressed_blocks(u, w, 4, 256, j_compress_update)))
    _close(got, want)
    assert rep.ingest_bytes == jrep.ingest_bytes
    assert (rep.n_rows, rep.n_blocks, rep.chunk_rows) == \
        (jrep.n_rows, jrep.n_blocks, jrep.chunk_rows)
    assert ours.is_warm_stream(get_fusion(name), 4, 700, np.int8, block=256)


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[0])
def test_mixed_dense_and_compressed_stream(pair):
    """Dense and compressed blocks of one round fold into one carry."""
    from repro.core.compress import CompressedBlock as JBlock

    u, w = _data(12, 513, 7)

    def blocks(block_cls, make):
        for i, lo in enumerate(range(0, 12, 3)):
            if i % 2:
                cus = [make(r, 128) for r in u[lo:lo + 3]]
                yield block_cls(np.stack([c.codes for c in cus]),
                                np.stack([c.scales for c in cus]),
                                513), w[lo:lo + 3]
            else:
                yield u[lo:lo + 3], w[lo:lo + 3]

    ours, theirs = _engines(pair)
    got, rep = ours.fuse_stream(get_fusion("fedavg"),
                                blocks(CompressedBlock, compress_update))
    want, jrep = theirs.fuse_stream(j_get_fusion("fedavg"),
                                    blocks(JBlock, j_compress_update))
    _close(got, want)
    assert rep.ingest_bytes == jrep.ingest_bytes and rep.n_blocks == 4


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[0])
def test_bf16_and_fp64_inputs(pair):
    """bf16 blocks fold in an fp32 carry; fp64 updates are computed in
    fp32, as the JAX package does with x64 off."""
    u, w = _data(9, 515, 8)
    u16 = u.astype(ml_dtypes.bfloat16)
    ours, theirs = _engines(pair)
    got, _ = ours.fuse_stream(get_fusion("fedavg"), _blocks(u16, w, 4))
    want, _ = theirs.fuse_stream(j_get_fusion("fedavg"), _blocks(u16, w, 4))
    _close(got, want)
    _close(ours.fuse(get_fusion("fedavg"), torch.from_numpy(u).bfloat16(), w),
           theirs.fuse(j_get_fusion("fedavg"), jnp.asarray(u16), w))
    u64 = u.astype(np.float64)
    got = ours.fuse(get_fusion("fedavg"), u64, w)
    _close(got, theirs.fuse(j_get_fusion("fedavg"), u64, w))


def test_kernel_strategy_routes_sum_family_through_kernel(monkeypatch):
    """The kernel strategy calls the kernel wrapper for the plain weighted
    sums (on CPU tensors the wrapper runs its plain version) and never for
    ClippedAvg, whose partial needs row norms."""
    calls = []
    real = kernel.weighted_sum

    def spy(u, w):
        calls.append(tuple(u.shape))
        return real(u, w)

    monkeypatch.setattr(kernel, "weighted_sum", spy)
    u, w = _data(6, 40, 9)
    eng = LocalEngine(strategy="kernel", device="cpu")
    eng.fuse_stream(get_fusion("fedavg"), _blocks(u, w, 4))
    assert calls == [(4, 40), (2, 40)]   # the ragged block is not padded
    calls.clear()
    eng.fuse(get_fusion("clippedavg"), u, w)
    LocalEngine(strategy="torch", device="cpu").fuse(get_fusion("fedavg"),
                                                     u, w)
    assert calls == []


def test_torch_strategy_pads_ragged_block_with_zero_weights():
    """IterAvg maps every weight to one: the torch strategy's padded rows
    must still carry weight 0."""
    u, w = _data(7, 33, 10)
    got, rep = LocalEngine(strategy="torch", device="cpu").fuse_stream(
        get_fusion("iteravg"), _blocks(u, w, 4))
    _close(got, u.mean(0))
    assert rep.acc_tot == 7.0


def test_engine_contracts():
    class Median(FusionAlgorithm):
        name = "median"

        def fuse(self, updates, weights):
            return updates.float().median(0).values

    u, w = _data(5, 8, 11)
    eng = LocalEngine(strategy="torch", device="cpu")
    with pytest.raises(ValueError, match="not streamable"):
        eng.fuse_stream(Median(), _blocks(u, w, 2))
    with pytest.raises(ValueError, match="empty block iterator"):
        eng.fuse_stream(get_fusion("fedavg"), iter(()))
    with pytest.raises(ValueError, match="exceeds chunk_rows"):
        eng.fuse_stream(get_fusion("fedavg"), _blocks(u, w, 3), chunk_rows=2)
    with pytest.raises(TypeError, match="numeric per-row scale"):
        eng.fuse_stream(get_fusion("fedavg"),
                        iter([(u, w, ["a"] * 5)]))
    with pytest.raises(MemoryError):
        LocalEngine(strategy="torch", device="cpu",
                    memory_cap_bytes=8).fuse(Median(), u, w)
    with pytest.raises(ValueError, match="strategy"):
        LocalEngine(strategy="pallas", device="cpu")
    _close(eng.fuse(Median(), u, w), np.median(u, 0))
