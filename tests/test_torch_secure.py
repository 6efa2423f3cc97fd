"""The port's secure aggregation against the JAX package's (CPU).

The port draws its pair masks from torch generators, so its masks are
not the reference's bits: parity is by property, the three cases of
``tests/test_substrate.py`` (the masks cancel in the plain sum, a masked
IterAvg equals the unmasked one, a single masked update hides its
value), run on the port, plus determinism, the service's refusal of a
non-reducible fusion in both packages, and a masked store round through
the port's service.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AggregationService as JService
from repro.core.secure import SecureMasking as JMasking
from repro_torch.core.fusion.averaging import IterAvg
from repro_torch.core.local import LocalEngine
from repro_torch.core.secure import SecureMasking
from repro_torch.core.service import AggregationService
from repro_torch.core.store import UpdateStore
from repro_torch.kernels.fused_fusion import kernel

RNG = np.random.default_rng(5)


@pytest.fixture(autouse=True)
def _no_launches():
    kernel.reset_launches()
    yield
    assert kernel.LAUNCHES == {"weighted_sum": 0, "weighted_sum_dequant": 0}


def test_pairwise_masks_cancel_in_sum():
    n, p = 6, 128
    sm = SecureMasking(n_clients=n, seed=9)
    vecs = [RNG.normal(size=(p,)).astype(np.float32) for _ in range(n)]
    masked = [sm.mask_update(i, v, device="cpu") for i, v in enumerate(vecs)]
    assert all(m.dtype == torch.float32 and m.device.type == "cpu"
               for m in masked)
    np.testing.assert_allclose(sum(masked).numpy(), sum(vecs),
                               rtol=1e-4, atol=1e-4)
    net = sum(sm.mask_for(i, p, device="cpu") for i in range(n))
    np.testing.assert_allclose(net.numpy(), 0.0, atol=1e-5)


def test_masked_iteravg_equals_unmasked():
    """IterAvg over masked updates == over raw updates (sum-reducible);
    the port's engine on the masked rows equals the reference's on the
    raw rows."""
    n, p = 5, 64
    sm = SecureMasking(n_clients=n, seed=1)
    u = RNG.normal(size=(n, p)).astype(np.float32)
    masked = torch.stack([sm.mask_update(i, u[i], device="cpu")
                          for i in range(n)])
    eng = LocalEngine(strategy="kernel", device="cpu")
    a = eng.fuse(IterAvg(), u, None).numpy()
    b = eng.fuse(IterAvg(), masked, None).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(b, u.astype(np.float64).mean(0), rtol=1e-3,
                               atol=1e-3)


def test_single_masked_update_hides_value():
    sm = SecureMasking(n_clients=4, seed=3, scale=10.0)
    masked = sm.mask_update(0, torch.zeros(64), device="cpu").numpy()
    assert np.abs(masked).mean() > 1.0   # far from the raw (zero) update
    # the reference's masked update hides it at the same scale
    ref = np.asarray(JMasking(n_clients=4, seed=3, scale=10.0).mask_update(
        0, jnp.zeros((64,), jnp.float32)))
    assert np.abs(ref).mean() > 1.0


@pytest.mark.parametrize("seed", [0, 3, 2**40])
def test_same_seed_gives_bit_equal_masks(seed):
    a = SecureMasking(n_clients=5, seed=seed, scale=0.5)
    b = SecureMasking(n_clients=5, seed=seed, scale=0.5)
    for client in range(5):
        assert torch.equal(a.mask_for(client, 257, device="cpu"),
                           b.mask_for(client, 257, device="cpu"))
    assert not torch.equal(
        a.mask_for(0, 257, device="cpu"),
        SecureMasking(n_clients=5, seed=seed + 1).mask_for(0, 257,
                                                           device="cpu"))
    # pair (i, j) is one stream: what 0 adds for the pair (0, 1), 1
    # subtracts
    two = SecureMasking(n_clients=2, seed=seed)
    assert torch.equal(two.mask_for(0, 33, device="cpu"),
                       -two.mask_for(1, 33, device="cpu"))


@pytest.mark.parametrize("fusion", ["krum", "coordmedian", "trimmedmean"])
def test_secure_needs_a_reducible_fusion_in_both_packages(fusion):
    with pytest.raises(ValueError, match="sum-reducible"):
        AggregationService(fusion=fusion, device="cpu",
                           secure=SecureMasking(n_clients=4))
    with pytest.raises(ValueError, match="sum-reducible"):
        JService(fusion=fusion, secure=JMasking(n_clients=4))
    masking = SecureMasking(n_clients=4)
    assert AggregationService(fusion="iteravg", device="cpu",
                              secure=masking).secure is masking


def test_secure_service_round_equals_unmasked_mean():
    """Eight clients write masked rows to the store of a ``secure=``
    IterAvg service; the streamed round (3-row blocks) equals the mean
    of the raw rows, and the reference's unmasked round on them."""
    n, p = 8, 300
    sm = SecureMasking(n_clients=n, seed=21)
    u = RNG.normal(size=(n, p)).astype(np.float32)
    store = UpdateStore()
    svc = AggregationService(fusion="iteravg", store=store, device="cpu",
                             secure=sm, stream_chunk_bytes=3 * 4 * p)
    for i in range(n):
        store.write(f"client{i:05d}", sm.mask_update(i, u[i], device="cpu"))
    fused, rep = svc.aggregate(from_store=True, expected_clients=n)
    assert rep.streamed and rep.n_clients == n
    want = u.astype(np.float64).mean(0)
    np.testing.assert_allclose(fused.numpy(), want, rtol=1e-3, atol=1e-3)
    jsvc = JService(fusion="iteravg", local_strategy="jnp",
                    secure=JMasking(n_clients=n, seed=21))
    jfused, _ = jsvc.aggregate(updates=list(u))
    np.testing.assert_allclose(fused.numpy(), np.asarray(jfused), rtol=1e-3,
                               atol=1e-3)
