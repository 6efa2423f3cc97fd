"""A CPU model of the SSD scan kernels' schedule, held against the JAX
package's ``ssd_scan`` (the Pallas kernel in interpret mode, as
tests/test_torch_ssd_chunk.py runs it) and its per-lane oracle
``ssd_chunk_ref``, at the reference tolerance rtol = atol = 1e-4.

The CUDA kernels (``src/repro_torch/csrc/ssd_chunk.cu``) run on the card
only. What this file models in plain PyTorch and numpy is their order of
work and their arithmetic:

* the state kernel, one block per (batch, chunk, pair of heads): each
  head's float64 prefix sum of the log-decays in the kernel's order
  (runs of ceil(L / 128) steps a thread, a Hillis-Steele warp scan of
  the runs, warp totals added in warp order), each prefix rounded to
  fp32 once; the chunk's state increment B^T (dec x) over 64-step tiles;
  the scores C B^T of each (row tile, column tile <= row tile) pair;
* the hand-off h_{c+1} = h_c exp(cum_last) + S_c in chunk order;
* the output kernel, one block per (64-row tile, chunk, batch, head
  tile): W = scores * 2^((cum_t - cum_s) log2 e) with the causal mask
  applied to the exponent, y += W x over the column tiles, then
  y += (exp(cum_t) C_t) h_c;
* every product as the tensor cores take fp32 operands: each operand
  split into hi = its TF32 rounding (cvt.rna: 10-bit mantissa, to
  nearest, ties away) and lo = the remainder rounded the same way,
  multiplied as lo.hi + hi.lo + hi.hi. One pass (hi.hi) alone leaves the
  tolerance at the Zamba2 widths, which a test below asserts, so the
  split cannot be dropped unnoticed.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk.ops import ssd_scan as jssd_scan
from repro.kernels.ssd_chunk.ref import ssd_chunk_ref as jssd_chunk_ref
from repro_torch.kernels.ssd_chunk import kernel, ref

TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_kernels_extra.py:47-48
R = 64                               # steps a row / column tile (kR)
THREADS = 256                        # a state block (kStateThreads)
LOG2E = np.float32(1.4426950408889634)
H100_SMS = 132


@pytest.fixture(autouse=True)
def _no_launches():
    kernel.reset_launches()
    yield
    assert kernel.LAUNCHES == {"ssd_chunk": 0, "ssd_chunk_bwd": 0}


def tf32(a: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 as cvt.rna.tf32.f32 does: the low 13 mantissa
    bits dropped, to nearest, ties away from zero (half an ulp added to
    the magnitude, then masked)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a @ b as the kernels multiply fp32 on the tensor cores: three TF32
    passes (lo.hi + hi.lo + hi.hi, fp32 accumulation), or one (hi.hi)."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def kernel_cum(lam: np.ndarray, nth: int) -> np.ndarray:
    """The state kernel's prefix sum of each row of lam (..., L) in its
    float64 order, by a group of ``nth`` threads, rounded to fp32."""
    L = lam.shape[-1]
    seg = -(-L // nth)
    v = np.zeros(lam.shape[:-1] + (nth * seg,), np.float64)
    v[..., :L] = lam.astype(np.float64)   # + 0.0 leaves a float64 sum as it is
    v = v.reshape(lam.shape[:-1] + (nth // 32, 32, seg))
    s = np.zeros(v.shape[:-1])
    for k in range(seg):                  # each thread's run, in order
        s = s + v[..., k]
    incl = s.copy()
    for off in (1, 2, 4, 8, 16):          # Hillis-Steele over the warp
        shifted = np.zeros_like(incl)
        shifted[..., off:] = incl[..., :-off]
        incl = np.where(np.arange(32) >= off, incl + shifted, incl)
    ex = np.zeros_like(incl)
    ex[..., 1:] = incl[..., :-1]
    tot = incl[..., 31]
    base = np.zeros_like(tot)
    for w in range(1, nth // 32):         # warp totals in warp order
        base[..., w] = base[..., w - 1] + tot[..., w - 1]
    run = base[..., None] + ex
    out = np.zeros(v.shape)
    for k in range(seg):
        run = run + v[..., k]
        out[..., k] = run
    return out.reshape(lam.shape[:-1] + (nth * seg,))[..., :L].astype(np.float32)


def model_scan(lam, Bm, Cm, xdt, chunk=256, passes=3, head_pair=None):
    """The kernels' schedule on fp32 tensors; returns y (B, T, H, P)."""
    B, T, H = lam.shape
    N, P = Bm.shape[-1], xdt.shape[-1]
    L = ref.chunk_len(T, chunk)
    nc, rt_n = T // L, -(-L // R)
    Lpad = rt_n * R
    kh = kernel.head_tile(B, nc, rt_n, H, H100_SMS) if head_pair is None else head_pair
    # state kernel, 1: the prefix sums, padded rows holding cum_last
    lam_c = lam.numpy().reshape(B, nc, L, H).transpose(0, 3, 1, 2)
    cum = torch.from_numpy(kernel_cum(lam_c, THREADS // kh))   # (B, H, nc, L)
    cl = cum[..., -1]
    cum = torch.cat([cum, cl[..., None].expand(B, H, nc, Lpad - L)], -1)

    def rows(a, c, t0, n):   # steps t0 .. t0 + n of chunk c, zero past L
        out = torch.zeros((B, n) + a.shape[2:], dtype=torch.float32)
        k = min(n, L - t0)
        out[:, :k] = a[:, c * L + t0:c * L + t0 + k]
        return out

    # state kernel, 2: S_c over 64-step tiles; the hand-off
    h = torch.zeros((B, H, N, P))
    starts = [h]
    for c in range(nc - 1):
        S = torch.zeros((B, H, N, P))
        for st in range(rt_n):
            s0 = st * R
            Bt, xt = rows(Bm, c, s0, R), rows(xdt, c, s0, R)    # (B, 64, N), (B, 64, H, P)
            dec = torch.exp(cl[:, :, c, None] - cum[:, :, c, s0:s0 + R])   # (B, H, 64)
            dec = torch.where(torch.arange(s0, s0 + R) < L, dec, torch.zeros(()))
            dx = xt.permute(0, 2, 1, 3) * dec[..., None]                  # (B, H, 64, P)
            S = S + mm(Bt.transpose(1, 2)[:, None], dx, passes)
        h = h * torch.exp(cl[:, :, c])[..., None, None] + S
        starts.append(h)

    # output kernel
    y = torch.zeros((B, T, H, P))
    causal = torch.ones((R, R), dtype=torch.bool).tril()
    for c in range(nc):
        for rt in range(rt_n):
            t0 = rt * R
            Ct = rows(Cm, c, t0, R)                                       # (B, 64, N)
            ct = cum[:, :, c, t0:t0 + R]                                  # (B, H, 64)
            acc = torch.zeros((B, H, R, P))
            for kt in range(rt + 1):
                s0 = kt * R
                cb = mm(Ct, rows(Bm, c, s0, R).transpose(1, 2), passes)   # (B, 64, 64)
                cs = cum[:, :, c, s0:s0 + R]
                d = (ct[..., :, None] - cs[..., None, :]) * LOG2E          # (B, H, t, s)
                live = (torch.arange(t0, t0 + R) < L)[:, None].expand(R, R)
                if kt == rt:
                    live = live & causal
                d = torch.where(live, d, torch.full((), -math.inf))
                W = cb[:, None] * torch.exp2(d)
                xt = rows(xdt, c, s0, R).permute(0, 2, 1, 3)              # (B, H, 64, P)
                acc = acc + mm(W, xt, passes)
            if c > 0:
                eC = Ct[:, None] * torch.exp(ct)[..., None]                # (B, H, 64, N)
                acc = acc + mm(eC, starts[c], passes)
            k = min(R, L - t0)
            y[:, c * L + t0:c * L + t0 + k] = acc[:, :, :k].permute(0, 2, 1, 3)
    return y


def _inputs(seed, B, T, H, N, P, lam_kind="rand", grid=False):
    """Seeded inputs. With ``grid``, lam lies on multiples of 2^-8, so that
    every fp32 prefix sum of it is exact in any order: the JAX reference
    sums lam in fp32 and the port in float64 (ref.cumulative_decay), and
    at L = 600 those two roundings alone differ by 1.3x the tolerance."""
    rng = np.random.default_rng(seed)
    lam = -np.abs(rng.normal(size=(B, T, H))).astype(np.float32) * 0.1
    if grid:
        lam = np.round(lam * 256.0).astype(np.float32) / 256.0
    scale = 1.0
    if lam_kind == "-50":
        lam = lam * 10.0 - 50.0
    elif lam_kind == "0":
        lam = np.zeros_like(lam)
        scale = 0.25
    Bm = (rng.normal(size=(B, T, N)) * scale).astype(np.float32)
    Cm = (rng.normal(size=(B, T, N)) * scale).astype(np.float32)
    xdt = (rng.normal(size=(B, T, H, P)) * scale).astype(np.float32)
    return lam, Bm, Cm, xdt


def _jax_lanes(lam, Bm, Cm, xdt, L):
    """y of every (b, h) lane from the JAX per-lane oracle."""
    B, T, H = lam.shape
    N, P = Bm.shape[-1], xdt.shape[-1]
    y = np.zeros((B, T, H, P), np.float32)
    for b in range(B):
        for h in range(H):
            yr, _ = jssd_chunk_ref(jnp.asarray(lam[b, :, h].reshape(-1, L)),
                                   jnp.asarray(Bm[b].reshape(-1, L, N)),
                                   jnp.asarray(Cm[b].reshape(-1, L, N)),
                                   jnp.asarray(xdt[b, :, h].reshape(-1, L, P)),
                                   jnp.zeros((N, P)))
            y[b, :, h] = np.asarray(yr).reshape(T, P)
    return y


@pytest.mark.parametrize("B,T,H,N,P,chunk,lam_kind", [
    (2, 1024, 4, 64, 64, 256, "rand"),   # Zamba2-1.2B widths, 4 chunks
    (1, 600, 2, 64, 64, 256, "rand"),    # L = T = 600: one ragged chunk
    (1, 640, 3, 32, 32, 64, "rand"),     # 10 chunks, odd H (single heads)
    (1, 512, 2, 128, 40, 256, "rand"),   # N = 128, P < 64 (padded)
    (1, 512, 2, 64, 64, 256, "-50"),     # decays underflow
    (1, 512, 2, 64, 64, 256, "0"),       # no decay
])
def test_schedule_matches_pallas_and_oracle(B, T, H, N, P, chunk, lam_kind):
    # against the port's plain version, both rounding float64 prefix sums
    lam, Bm, Cm, xdt = _inputs(T + N + P, B, T, H, N, P, lam_kind)
    args = [torch.from_numpy(a) for a in (lam, Bm, Cm, xdt)]
    got = model_scan(*args, chunk=chunk).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref.ssd_scan_ref(*args, chunk=chunk).numpy(), **TOL)
    # against the JAX package, on lam whose prefix sums are exact
    lam, Bm, Cm, xdt = _inputs(T + N + P, B, T, H, N, P, lam_kind, grid=True)
    got = model_scan(*(torch.from_numpy(a) for a in (lam, Bm, Cm, xdt)),
                     chunk=chunk).numpy()
    assert np.all(np.isfinite(got))
    want = np.asarray(jssd_scan(*(jnp.asarray(a) for a in (lam, Bm, Cm, xdt)),
                                chunk=chunk))
    np.testing.assert_allclose(got, want, **TOL)
    L = ref.chunk_len(T, chunk)
    np.testing.assert_allclose(got, _jax_lanes(lam, Bm, Cm, xdt, L), **TOL)
    plain = ref.ssd_scan_ref(*(torch.from_numpy(a) for a in (lam, Bm, Cm, xdt)),
                             chunk=chunk).numpy()
    np.testing.assert_allclose(got, plain, **TOL)
    # the wrapper on CPU tensors is its plain version, and launches nothing
    cpu = kernel.ssd_chunk(*(torch.from_numpy(a) for a in (lam, Bm, Cm, xdt)),
                           chunk=chunk)
    assert torch.equal(cpu, torch.from_numpy(plain))


def _violation(got, want):
    return float(np.max(np.abs(got - want) / (TOL["atol"] + TOL["rtol"] * np.abs(want))))


def test_one_tf32_pass_breaks_the_tolerance():
    """One TF32 pass per product (operands rounded to 10-bit mantissas)
    moves y far past 1e-4 at the Zamba2 widths; three passes stay inside."""
    lam, Bm, Cm, xdt = _inputs(7, 1, 512, 2, 64, 64)
    args = [torch.from_numpy(a) for a in (lam, Bm, Cm, xdt)]
    plain = ref.ssd_scan_ref(*args).numpy()
    assert _violation(model_scan(*args).numpy(), plain) < 1.0
    assert _violation(model_scan(*args, passes=1).numpy(), plain) > 10.0


def test_head_pairs_and_single_heads_agree():
    """A state block takes two heads (128 threads a prefix sum) or one
    (256): the two orders give the same y within the tolerance."""
    lam, Bm, Cm, xdt = _inputs(3, 1, 768, 2, 32, 32)
    args = [torch.from_numpy(a) for a in (lam, Bm, Cm, xdt)]
    np.testing.assert_allclose(model_scan(*args, head_pair=1).numpy(),
                               model_scan(*args, head_pair=2).numpy(), **TOL)


@pytest.mark.parametrize("L,nth", [(256, 128), (256, 256), (600, 128), (1000, 256)])
def test_parallel_prefix_sum_rounds_once_like_the_plain_version(L, nth):
    """The kernel's float64 order differs from ref.cumulative_decay's
    sequential sum only in float64's last bits: after one rounding to
    fp32 at most a few decays in ten thousand move, by one fp32 ulp."""
    rng = np.random.default_rng(L + nth)
    lam = (-np.abs(rng.normal(size=(40, L))) * 0.1).astype(np.float32)
    got = kernel_cum(lam, nth)
    want = ref.cumulative_decay(torch.from_numpy(lam), 1).numpy()
    differ = got != want
    assert differ.mean() <= 1e-3
    ulp = np.spacing(np.abs(want))
    assert np.all(np.abs(got - want)[differ] <= ulp[differ])


@pytest.mark.parametrize("B,T,H,chunk,tile", [
    (4, 1024, 64, 256, 2),     # Zamba2-1.2B layer: 2,048 output blocks
    (2, 600, 64, 256, 2),      # L = T = 600: 10 row tiles a lane
    (4, 64, 64, 256, 1),       # T < chunk: 128 pairs would leave SMs idle
    (1, 4096, 1, 256, 1),      # one head
    (2, 512, 3, 256, 1),       # odd H
])
def test_head_tile(B, T, H, chunk, tile):
    L = ref.chunk_len(T, chunk)
    assert kernel.head_tile(B, T // L, -(-L // R), H, H100_SMS) == tile


@pytest.mark.parametrize("T,chunk,kernels", [(1024, 256, 3), (600, 256, 2),
                                             (64, 256, 2), (48, 16, 3)])
def test_device_kernels(T, chunk, kernels):
    assert kernel.device_kernels(T, chunk) == kernels


@pytest.mark.parametrize("N,pad", [(1, 16), (16, 16), (17, 32), (64, 64), (65, 128),
                                   (128, 128)])
def test_state_pad(N, pad):
    assert kernel.state_pad(N) == pad


def _chip_smoke():
    import importlib
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    return importlib.import_module("chip_smoke")


def test_least_work_counts_the_scores_once_per_batch_and_chunk():
    """chip_smoke.py's bound at the Zamba2-1.2B layer: per lane and chunk
    W x, C h and B^T x; C B^T once per (batch, chunk), not once a head."""
    B, T, H, N, P, L = 4, 1024, 64, 64, 64, 256
    nbytes, flops = _chip_smoke()._ssd_work(B, T, H, N, P, L, 4)
    tri = L * (L + 1) // 2
    lane_chunk = tri * 2 * P + 2 * (2 * L * N * P)
    assert flops == B * H * (T // L) * lane_chunk + B * (T // L) * tri * 2 * N
    assert round(flops / 1e9, 2) == 8.67
    assert nbytes == 4 * B * T * H + 2 * 4 * B * T * N + 2 * 4 * B * T * H * P


def test_sass_functions_splits_the_listing_by_kernel():
    sass = """
        Function : _ZN12_GLOBAL__N_114ssd_out_kernelIfLi64ELi2EEEvPKT_
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe40000000800 */
        /*0010*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
        /*0020*/              @!P0 BRA 0x100 ;
        /*0030*/                   NOP ;
        Function : _ZN12_GLOBAL__N_116ssd_state_kernelIfLi64ELi2EEEvPKf
        /*0000*/               @P1 LDS.128 R4, [R2] ;
    """
    assert _chip_smoke()._sass_functions(sass) == {
        "_ZN12_GLOBAL__N_114ssd_out_kernelIfLi64ELi2EEEvPKT_": ["LDC", "HMMA", "BRA"],
        "_ZN12_GLOBAL__N_116ssd_state_kernelIfLi64ELi2EEEvPKf": ["LDS"],
    }
