"""The arithmetic of the dense order-statistic kernels, checked without a
card: a numpy model of each route of ``csrc/robust_fusion.cu`` against
the port's plain versions and the JAX package's Pallas kernels
(interpret mode, as tests/test_kernels.py runs them).

The register route (n <= 128) counts a column's NaNs and sorts it as
+inf, pads the column to a bucket NB and sorts it with Batcher's
odd-even merge network, comparators that only meet padding dropped. The warp route selects ranks by radix select,
one bit a pass, each of 32 lanes counting its rows (for n <= 1024 held
in registers, padded with the NaN key); a rank closes once
one candidate is left, and the trimmed mean adds the keys strictly
between its two selected ranks to the boundary ties, counted. The model
follows the kernel step for step (order keys, passes, tie counts, the
median's next key above, the lanes' fixed summation order), so a wrong
tie count or rank shows here; the kernel itself is held against the
plain versions on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.robust_fusion import kernel as jkernel
from repro.kernels.robust_fusion import ref as jref
from repro_torch.kernels.robust_fusion import kernel, ref

NAN_KEY = 0xFFFFFFFF
FULL = 0xFFFFFFFF
BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128)   # the register route's NB
LANES = 32
F32 = np.float32


@pytest.fixture(autouse=True)
def _no_launches():
    kernel.reset_launches()
    yield
    assert kernel.LAUNCHES == {"topk_carve": 0, "trimmed_mean": 0,
                               "coord_median": 0}


# -- the model ----------------------------------------------------------------


def order_key(x):
    """jnp.sort's order as unsigned 32-bit keys: -0 as +0, NaN largest."""
    x = np.asarray(x, F32)
    b = (x + F32(0)).view(np.uint32)          # -0 + 0 is +0
    sign = (b.view(np.int32) >> 31).view(np.uint32)
    k = b ^ (sign | np.uint32(0x80000000))
    return np.where(np.isnan(x), np.uint32(NAN_KEY), k).astype(np.uint32)


def key_value(k):
    k = np.asarray(k, np.uint32)
    bits = np.where(k & np.uint32(0x80000000), k & np.uint32(0x7FFFFFFF),
                    ~k).astype(np.uint32)
    return np.where(k == NAN_KEY, F32(np.nan), bits.view(F32)).astype(F32)


def network(nb):
    """The comparators of ``oe_sort<NB, 0, pow2_ceil(NB) - 1>``, in order,
    with those reaching slot NB or past it dropped."""
    out = []

    def merge(lo, hi, r):
        if 2 * r < hi - lo:
            merge(lo, hi, 2 * r)
            merge(lo + r, hi, 2 * r)
            out.extend((i, i + r) for i in range(lo + r, hi - r, 2 * r))
        else:
            out.append((lo, lo + r))

    def sort(lo, hi):
        if hi > lo:
            mid = lo + (hi - lo) // 2
            sort(lo, mid)
            sort(mid + 1, hi)
            merge(lo, hi, 1)

    sort(0, (1 << (nb - 1).bit_length()) - 1)
    return [(a, b) for a, b in out if b < nb]


def apply_network(keys, nb):
    """Sort (nb, ...) arrays (NaN-free) along axis 0 with the network."""
    k = keys.copy()
    for a, b in network(nb):
        lo, hi = np.minimum(k[a], k[b]), np.maximum(k[a], k[b])
        k[a], k[b] = lo, hi
    return k


@np.errstate(invalid="ignore")   # inf - inf is NaN, as on the card
def register_route(u, trim):
    """stat_reg_kernel over the columns of u (n, P); trim None = median.
    Each NaN is counted and sorted as +inf; the trimmed mean pads with
    +inf, the median with as many -inf as +inf (one more -inf for odd n)
    so that its middle values sit at slots NB / 2 - 1 and NB / 2."""
    n = u.shape[0]
    nb = next(b for b in BUCKETS if n <= b)
    low_pad = (nb - n + (n & 1)) // 2 if trim is None else 0
    v = np.full((nb, u.shape[1]), np.inf, F32)
    v[n: n + low_pad] = -np.inf
    v[:n] = u
    nans = np.isnan(v).sum(axis=0)
    v = apply_network(np.where(np.isnan(v), F32(np.inf), v), nb)
    if trim is None:
        mid = v[nb // 2] if n & 1 else (v[nb // 2 - 1] + v[nb // 2]) * F32(0.5)
        return np.where(nans > 0, F32(np.nan), mid).astype(F32)
    acc = np.zeros(u.shape[1], F32)
    for j in range(trim, n - trim):   # rank order
        acc = (acc + v[j]).astype(F32)
    return np.where(nans > trim, F32(np.nan),
                    acc / F32(n - 2 * trim)).astype(F32)


def by_lane(x):
    """(rows,) -> (rows / 32, 32): row i in lane i % 32, zero-padded."""
    x = np.asarray(x)
    return np.concatenate([x, np.zeros((-len(x)) % LANES, x.dtype)]) \
        .reshape(-1, LANES)


def warp_count(match):
    """Each lane counts its rows (lane, lane + 32, ...); the warp sums."""
    return int(by_lane(match.astype(np.int64)).sum(axis=0).sum())


def lane_keys(n):
    """Keys a lane holds in registers on the staged warp route (0: every
    pass reads shared memory)."""
    return 8 if n <= 256 else 16 if n <= 512 else 32 if n <= 1024 else 0


def warp_select(keys, ranks):
    """warp_select<NR>: (key, lt, eq) of each rank of one column. Where
    the lanes hold their keys in registers, the rows past n are the NaN
    key, visited by the counting passes like any other."""
    n = len(keys)
    counted = np.concatenate(
        [keys, np.full(max(0, LANES * lane_keys(n) - n), NAN_KEY, np.uint32)])
    prefix, mask = [0] * len(ranks), [0] * len(ranks)
    r, cand = list(ranks), [n] * len(ranks)
    for bit in range(31, -1, -1):
        if all(c <= 1 for c in cand):
            break
        b = 1 << bit
        for q in range(len(ranks)):
            if cand[q] <= 1:
                continue
            zeros = warp_count(((counted ^ np.uint32(prefix[q]))
                                & np.uint32(mask[q] | b)) == 0)
            if r[q] >= zeros:
                prefix[q] |= b
                r[q] -= zeros
                cand[q] -= zeros
            else:
                cand[q] = zeros
            mask[q] |= b
    for q in range(len(ranks)):
        if mask[q] != FULL:   # closed early: the one key under the prefix
            found = keys[((keys ^ np.uint32(prefix[q]))
                          & np.uint32(mask[q])) == 0]
            assert cand[q] == 1 and len(found) == 1
            prefix[q] = int(found[0])
    return [(np.uint32(prefix[q]), ranks[q] - r[q], cand[q])
            for q in range(len(ranks))]


def lane_sum(values, take):
    """Each lane sums its taken rows in row order, then the lanes combine
    in the kernel's butterfly order (xor 16, 8, 4, 2, 1)."""
    part = np.zeros(LANES, F32)
    for row in by_lane(np.where(take, values, F32(0)).astype(F32)):
        part = (part + row).astype(F32)   # + 0 for a row not taken: exact
    for o in (16, 8, 4, 2, 1):
        part = (part + part[np.arange(LANES) ^ o]).astype(F32)
    return part[0]


@np.errstate(invalid="ignore")
def warp_column(col, trim):
    """stat_warp_kernel for one column; trim None = median."""
    keys = order_key(col)
    n = len(keys)
    if trim is None:
        ((klo, lt, eq),) = warp_select(keys, [(n - 1) // 2])
        above = keys[keys > klo]
        nxt = above.min() if len(above) else np.uint32(NAN_KEY)
        a = key_value(klo)
        if keys.max() == NAN_KEY:
            return F32(np.nan)
        if n % 2:
            return a
        b = a if lt + eq > n // 2 else key_value(nxt)
        return F32((a + b) * F32(0.5))
    (klo, lt_lo, eq_lo), (khi, lt_hi, _) = warp_select(keys,
                                                       [trim, n - 1 - trim])
    vlo = key_value(klo)
    if klo == khi:
        return vlo
    between = lane_sum(key_value(keys), (keys > klo) & (keys < khi))
    take_lo, take_hi = F32(lt_lo + eq_lo - trim), F32(n - trim - lt_hi)
    return F32((between + take_lo * vlo + take_hi * key_value(khi))
               / F32(n - 2 * trim))


def warp_route(u, trim):
    return np.array([warp_column(u[:, p], trim) for p in range(u.shape[1])],
                    F32)


def kernel_model(u, trim):
    """The route the kernels take for n rows."""
    return register_route(u, trim) if u.shape[0] <= BUCKETS[-1] \
        else warp_route(u, trim)


# -- inputs -------------------------------------------------------------------


SPECIALS = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1.5, -1.5],
                    np.float32)


def columns(n, p, seed, mix):
    """(n, p) fp32: normal values, rounded in some columns so that ties
    fall on the selected ranks, and a share of inf, NaN, +-0 and repeats
    that grows with ``mix`` (0: none)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, p)).astype(F32)
    u[:, ::2] = np.round(u[:, ::2] * 2) / 2
    if mix:
        hit = rng.random((n, p)) < 0.08 * mix
        u[hit] = rng.choice(SPECIALS, size=int(hit.sum()))
    return u


def _refs(u, trim):
    t = torch.from_numpy(u)
    if trim is None:
        return ref.coordmedian_ref(t).numpy()
    return ref.trimmedmean_ref(t, trim).numpy()


def _tol(trim):
    return 1e-6 if trim is None else 1e-5


# -- the sorting network ------------------------------------------------------


@pytest.mark.parametrize("nb", BUCKETS)
def test_network_sorts(nb):
    """0-1 principle: a comparator network sorts every input iff it sorts
    every 0/1 input; exhaustive to NB = 16, sampled beyond (with keys
    drawn from a few values, so ties abound)."""
    rng = np.random.default_rng(nb)
    if nb <= 16:
        bits = np.arange(1 << nb, dtype=np.uint32)
        x = ((bits[None, :] >> np.arange(nb, dtype=np.uint32)[:, None]) & 1)
    else:
        x = (rng.random((nb, 20_000)) < rng.random(20_000)).astype(np.uint32)
    s = apply_network(x.astype(np.uint32), nb)
    assert np.all(s[:-1] <= s[1:])
    y = rng.integers(0, 5, size=(nb, 2000)).astype(np.uint32)
    np.testing.assert_array_equal(apply_network(y, nb), np.sort(y, axis=0))


def test_network_sizes_and_padding():
    """The comparator counts the kernel's source states, and padding a
    short column with the largest value leaves its n values sorted in
    slots [0, n): comparators that only meet padding are dropped safely."""
    assert len(network(48)) == 384 and len(network(64)) == 543
    rng = np.random.default_rng(1)
    for n in (1, 5, 33, 47, 97):
        nb = next(b for b in BUCKETS if n <= b)
        k = np.full((nb, 50), NAN_KEY, np.uint32)
        k[:n] = rng.integers(0, 1 << 32, size=(n, 50), dtype=np.uint32)
        np.testing.assert_array_equal(apply_network(k, nb)[:n],
                                      np.sort(k[:n], axis=0))


def test_order_key_is_jnp_sort_order():
    x = np.array([np.nan, np.inf, 1.5, 1e-45, 0.0, -0.0, -1e-45, -1.5,
                  -np.inf, -np.nan], F32)
    k = order_key(x)
    want = [NAN_KEY, 0xFF800000, 0xBFC00000, 0x80000001, 0x80000000,
            0x80000000, 0x7FFFFFFE, 0x403FFFFF, 0x007FFFFF, NAN_KEY]
    assert k.tolist() == want
    back = key_value(k)
    finite = ~np.isnan(x)
    np.testing.assert_array_equal(back[finite], np.where(x == 0, F32(0),
                                                         x)[finite])
    assert np.isnan(back[~finite]).all()


# -- both routes against the plain versions and the Pallas kernels -----------


@settings(max_examples=150, deadline=None)
@given(n=st.integers(1, 300), t=st.integers(0, 10_000),
       seed=st.integers(0, 2 ** 31 - 1), mix=st.integers(0, 3))
def test_routes_match_plain_versions(n, t, seed, mix):
    """Both routes at every n (the warp route's arithmetic does not depend
    on n being past the register threshold) against trimmedmean_ref and
    coordmedian_ref, NaN, infs, signed zeros and ties included."""
    u = columns(n, 5, seed, mix)
    trim = t % ((n - 1) // 2 + 1)
    for stat in (trim, None):
        want = _refs(u, stat)
        for route in (warp_route, kernel_model):
            np.testing.assert_allclose(route(u, stat), want, rtol=_tol(stat),
                                       atol=_tol(stat))
        if n <= BUCKETS[-1]:
            np.testing.assert_allclose(register_route(u, stat), want,
                                       rtol=_tol(stat), atol=_tol(stat))


@settings(max_examples=12, deadline=None)
@given(n=st.integers(1, 300), t=st.integers(0, 10_000),
       seed=st.integers(0, 2 ** 31 - 1), mix=st.integers(0, 3))
def test_routes_match_pallas(n, t, seed, mix):
    """The kernels' routes against trimmedmean_pallas and
    coordmedian_pallas. The Pallas median takes the middle of jnp.sort
    even when a NaN sorts last, while the port follows jnp.median (NaN
    for a column that holds one): columns with NaN go to jnp.median."""
    u = columns(n, 8, seed, mix)
    trim = t % ((n - 1) // 2 + 1)
    want = np.asarray(jkernel.trimmedmean_pallas(jnp.asarray(u), trim))
    np.testing.assert_allclose(kernel_model(u, trim), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(warp_route(u, trim), want, rtol=1e-5,
                               atol=1e-5)
    med = kernel_model(u, None)
    has_nan = np.isnan(u).any(axis=0)
    pallas = np.asarray(jkernel.coordmedian_pallas(jnp.asarray(u)))
    np.testing.assert_allclose(med[~has_nan], pallas[~has_nan], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        med[has_nan], np.asarray(jref.coordmedian_ref(jnp.asarray(u)))[has_nan],
        rtol=1e-6, atol=1e-6)


def _tie_cases():
    """Columns built so the selected ranks fall inside runs of ties."""
    cases = {}
    cases["all equal"] = np.full((9, 1), 2.5, F32)
    cases["ties across both boundaries"] = np.array(
        [[1], [1], [1], [2], [3], [3], [3], [3], [0]], F32)
    cases["one value between the boundary ties"] = np.array(
        [[5], [5], [5], [4], [7], [7], [7], [7], [7], [-1]], F32)
    cases["signed zeros tie"] = np.array([[0.0], [-0.0], [0.0], [-0.0], [1]],
                                         F32)
    cases["NaN trimmed away"] = np.array([[1], [2], [np.nan], [3], [4]], F32)
    cases["NaN in the kept ranks"] = np.array(
        [[1], [np.nan], [np.nan], [np.nan], [4]], F32)
    cases["all NaN"] = np.full((4, 1), np.nan, F32)
    cases["infinities"] = np.array(
        [[np.inf], [-np.inf], [np.inf], [1], [-np.inf], [np.inf]], F32)
    rng = np.random.default_rng(7)
    cases["300 rows of 3 values"] = rng.integers(-1, 2, (300, 3)).astype(F32)
    return cases


@pytest.mark.parametrize("name", list(_tie_cases()))
def test_tie_arithmetic(name):
    """Every trim of the column through both routes, and the median."""
    u = _tie_cases()[name]
    n = u.shape[0]
    top = (n - 1) // 2
    trims = range(top + 1) if n < 20 else (0, 1, 2, n // 10, top - 1, top)
    for trim in list(trims) + [None]:
        want = _refs(u, trim)
        np.testing.assert_allclose(warp_route(u, trim), want,
                                   rtol=_tol(trim), atol=_tol(trim))
        if n <= BUCKETS[-1]:
            np.testing.assert_allclose(register_route(u, trim), want,
                                       rtol=_tol(trim), atol=_tol(trim))
