// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// ssd_chunk_fwd replaces repro/kernels/ssd_chunk/kernel.py
// ssd_chunk_pallas (the pallas_call at :65, body _ssd_kernel :23-56)
// together with its wrapper ssd_chunk/ops.py ssd_scan. For one
// (batch b, head h) lane and each chunk of L steps (T = nc * L):
//     cum_t = lam[b, 0, h] + ... + lam[b, t, h]      (from the chunk start)
//     y[t]  = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) x[s]
//             + exp(cum_t) (C_t . h)
//     h    <- h exp(cum_{L-1}) + sum_s exp(cum_{L-1} - cum_s) B_s^T x[s]
// lam (B, T, H) fp32; B, C (B, T, N), shared across the heads, and
// x (B, T, H, P) in fp32, bf16 or fp16; y (B, T, H, P) fp32; the
// (N, P) state h is fp32 and starts at 0.
//
// Bound: operations at the tensor cores' TF32 rate taken three times,
// then bytes. The least work counts C B^T once per (batch, chunk), since
// B and C are shared by the heads (L(L+1)/2 * 2N FLOPs), and per lane
// and chunk W x (L(L+1)/2 * 2P) and C h, B^T x (2LNP each), against
// 4 * H * P bytes of x and y a step: at the Zamba2-1.2B layer (B 4,
// T 1024, H 64, N = P = 64, L 256) 8.68 GFLOP against 137 MB. fp32
// inputs need fp32-accurate products: one TF32 pass (10-bit mantissas)
// leaves the 1e-4 tolerance, three (hi.hi + hi.lo + lo.hi, fp32
// accumulation) stay inside it (tests/test_torch_ssd_plan.py), so the
// floor is 8.68 GFLOP at 495 / 3 TFLOP/s = 0.053 ms (0.13 ms at the
// 67 TFLOP/s of the CUDA cores' FMAs; 0.041 ms by bytes). The design
// reads x twice (state pass and output pass): 0.061 ms of HBM time at
// that layer. What each part does:
//   * three kernels, so that chunks and heads spread over the card (the
//     chunked SSD splits the scan into work independent per (lane,
//     chunk) and a hand-off of the (N, P) state in chunk order):
//     - ssd_state_kernel, a block per (batch, chunk, pair of heads):
//       the float64 prefix sums into a workspace cum (B, H, nc, Lpad)
//       that the output kernel reads too; the chunk's state increment
//       S_c = B^T (exp(cum_last - cum_s) x) over 64-step tiles, into a
//       workspace of states (B, nc - 1, H, N_pad, 64) (12.6 MB at the
//       Zamba2 layer; the last chunk's is never needed); and the scores
//       C B^T of the chunk's tile pairs, into a workspace (B, nc,
//       RT (RT + 1) / 2, 64, 64), spread over the chunk's blocks. That
//       workspace grows with the square of L: 2.6 MB at the Zamba2
//       layer, but at L = T (a T that the chunk does not divide) it is
//       B * RT (RT + 1) / 2 * 16 KB, 0.54 GB at B 4, T 8191 and 8.6 GB
//       at T 32767, where a block per lane walking its chunks needs
//       only its own L x L scores. There the scores also fall to only
//       H / head tile state blocks of a batch row, each taking its tile
//       pairs one after another without a ring (at T 8191 and H 64,
//       258 pairs a block);
//     - ssd_handoff_kernel, a thread per state element of a lane: h_c
//       in chunk order, in place of S_{c-1};
//     - ssd_out_kernel, a block per (64-row tile, chunk, batch, pair of
//       heads): y of its rows from the column tiles s <= t and h_c.
//     At the Zamba2 layer 512 state blocks and 2,048 output blocks, where
//     a block per lane walking its chunks in order would make 256. An
//     L = T lane (one chunk) spreads the same way, a block per
//     64 rows. The wrapper allocates the workspaces; the kernels
//     allocate nothing;
//   * C B^T once per (batch, chunk, tile pair): the output blocks of
//     every head read the state kernel's scores tile and each warp
//     applies its own head's decay exp(cum_t - cum_s) (ex2.approx of the
//     difference in log2 units) while forming its A fragments;
//   * every product on the tensor cores: mma.sync.m16n8k8 TF32 with
//     fp32 accumulators, each operand split into hi = cvt.rna.tf32(v)
//     and lo = cvt.rna.tf32(v - hi) and multiplied as lo.hi + hi.lo +
//     hi.hi, each pass swept over all of a warp's tiles before the next
//     so that an accumulator's three products do not wait on each
//     other. W = scores * decay is formed in fp32 from the three-pass
//     scores and split again for W x. bf16 / fp16 inputs stay in their
//     type in shared memory and are widened as fragments are formed;
//     the wrapper pads their rows to 16 bytes;
//   * tiles are staged by 16-byte cp.async (4-byte copies for fp32 rows
//     that are not 16-byte multiples) into two-stage rings: the next
//     column tile (scores, x, cum; B and x in the state kernel) copies
//     while this one is multiplied, and the output kernel copies C and
//     h_c into the stages its last column tile leaves free. Shared
//     memory is padded for the fragment loads: rows read as A fragments
//     along k have a stride of 4 mod 32 words, rows read as B fragments
//     8 mod 32, so each fragment load is free of bank conflicts. An
//     output block of two heads takes 107 KB at fp32 N_pad 64, two
//     blocks an SM; each of its 4 warps owns two m-tiles of one head,
//     {0, 3} or {1, 2}, an even share of the causal triangle, so that
//     its x fragments serve both, and on the diagonal tile skips the
//     k-steps above its rows;
//   * the float64 prefix sum runs in parallel: each thread of a head's
//     group (128 threads for a pair of heads) sums a run of ceil(L / 128)
//     steps, a warp scans its runs with shuffles, the warps' totals are
//     added in warp order, and each thread re-walks its run, rounding
//     every prefix to fp32 once. Its float64 partials differ from the
//     sequential sum of ref.cumulative_decay in their last bits; on data
//     drawn as chip_smoke.py draws it that changed 0 of 262,144 fp32
//     decays at the Zamba2 layer's shape and 0 of 76,800 at L = 600
//     (tests/test_torch_ssd_plan.py models the order);
//   * the mask is applied before exp (a masked entry's exponent is
//     -inf, so exp gives 0): for s > t, cum_t - cum_s > 0 may overflow,
//     and inf * 0 would be NaN. Rows past L are zero-filled and never
//     stored;
//   * every sum runs in a fixed order (no atomics): the same inputs give
//     the same bits.
// N may be up to 128 (padded to 16, 32, 64 or 128) and P up to 64
// (padded to 64).
//
// The entry point returns the cudaGetLastError() of its launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "mma_tf32.cuh"   // tf32, split, mma_tf32, mma3

namespace {

constexpr int kR = 64;            // steps a row / column tile
constexpr int kPT = 64;           // P padded to one tile width
constexpr int kXS = kPT + 8;      // row stride of x and h tiles, in elements
constexpr int kCBS = kR + 4;      // row stride of the scores tile (4 mod 32)
constexpr int kStateThreads = 256;
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

enum DType : int64_t { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// Row stride (elements) of a tile whose fragments are read along its rows
// with 8 rows a warp (A fragments, and the scores' B operand): 4 mod 32
// words for fp32, 4 mod 32 words of packed pairs for bf16 / fp16; each
// row a multiple of 16 bytes.
template <typename T, int NT>
constexpr int row_stride() {
  return sizeof(T) == 4 ? NT + 4 : NT + 8;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared; src_bytes 0 zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Copy a (ROWS x COLS) tile whose row r starts at src + r * ld elements
// into shared memory at dst (row stride SS elements), in its own type;
// rows at or past vr and columns at or past vc are zero-filled. By
// cp.async, 16 bytes a copy when `vec` (vc and ld multiples of 16
// bytes, src 16-byte aligned), else 4 bytes a copy (fp32 only: the
// wrapper pads bf16 / fp16 rows to 16 bytes).
template <typename T, int NTH, int ROWS, int COLS, int SS>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, int64_t ld, int vr,
                                      int vc, bool vec, int tid) {
  if (vec) {
    constexpr int EPC = 16 / sizeof(T);   // elements a copy
    constexpr int CPR = COLS / EPC;
#pragma unroll 4
    for (int i = tid; i < ROWS * CPR; i += NTH) {
      const int r = i / CPR, c = (i % CPR) * EPC;
      const bool ok = r < vr && c < vc;
      cp_async16(smem_u32(dst + r * SS + c), ok ? src + r * ld + c : src, ok ? 16 : 0);
    }
    return;
  }
  if constexpr (sizeof(T) == 4) {
#pragma unroll 1
    for (int i = tid; i < ROWS * COLS; i += NTH) {
      const int r = i / COLS, c = i % COLS;
      const bool ok = r < vr && c < vc;
      cp_async4(smem_u32(dst + r * SS + c), ok ? src + r * ld + c : src, ok ? 4 : 0);
    }
  }
}

// cum[i] = lam[0] + ... + lam[i] over one chunk of one head (lam read
// `stride` floats apart), summed in float64 and rounded to fp32 once, by
// the NTH threads (tid 0 .. NTH - 1) of one group of the block: each
// thread sums a run of ceil(L / NTH) steps, a warp scans its runs with
// shuffles (Hillis-Steele), the warps' totals (wtot, one a warp of the
// group) are added in warp order, and each thread re-walks its run from
// its exclusive prefix. cum[L .. Lpad) get cum[L - 1]. Every thread of
// the group gets cum[L - 1]. With tile0 / tile1 set, the first two 64-step
// tiles of cum also go there. Every group of the block calls it together
// (it holds block-wide barriers).
template <int NTH>
__device__ float chunk_scan(const float* __restrict__ lam, int64_t stride, int L, int Lpad,
                            float* __restrict__ cum, double* wtot, float* last, float* tile0,
                            float* tile1, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const int seg = (L + NTH - 1) / NTH;
  const int i0 = min(tid * seg, L), i1 = min(i0 + seg, L);
  double s = 0.0;
  for (int i = i0; i < i1; ++i) s += static_cast<double>(lam[i * stride]);
  double incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  double ex = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) ex = 0.0;
  if (lane == 31) wtot[warp] = incl;
  __syncthreads();
  double run = 0.0;
  for (int w = 0; w < warp; ++w) run += wtot[w];
  run += ex;
  auto put = [&](int i, float v) {
    cum[i] = v;
    if (tile0 != nullptr && i < kR) tile0[i] = v;
    if (tile1 != nullptr && i >= kR && i < 2 * kR) tile1[i - kR] = v;
  };
  for (int i = i0; i < i1; ++i) {
    run += static_cast<double>(lam[i * stride]);
    put(i, static_cast<float>(run));
  }
  if (i0 < L && i1 == L) *last = static_cast<float>(run);
  __syncthreads();
  const float cl = *last;
  for (int i = L + tid; i < Lpad; i += NTH) put(i, cl);
  __syncthreads();   // cum is visible to the block; *last is free
  return cl;
}

// ---------------------------------------------------------------------------
// ssd_state_kernel: the prefix sums, the scores and each chunk's state
// increment
// ---------------------------------------------------------------------------

template <typename T, int NT, int KH>
struct StateCfg {
  static constexpr int BSS = NT + 8;                // B tile row stride (read along columns)
  static constexpr int CSS = row_stride<T, NT>();   // C / B row stride for the scores
  static constexpr int MTOT = NT / 16;              // m-tiles of the state's rows
  static constexpr int WM = MTOT < 2 ? MTOT : 2;    // warps along the rows
  static constexpr int WN = 8 / WM;                 // warps along P
  static constexpr int MT = MTOT / WM;              // m-tiles a warp
  static constexpr int NW = 8 / WN;                 // 8-column n-tiles a warp, a head
  static constexpr int B_BYTES = kR * BSS * sizeof(T);
  static constexpr int X_BYTES = KH * kR * kXS * sizeof(T);
  static constexpr int STAGE = B_BYTES + X_BYTES + KH * kR * 4;   // B, x and cum of KH heads
  // float64 warp totals, `last` of each head, then the two-stage ring
  static constexpr int BYTES = 96 + 2 * STAGE;
};

// grid (nc, H / KH, B), 256 threads: one block per (batch b, chunk c,
// KH heads h0 ..), each head's prefix sum taken by 256 / KH threads.
//  1. the float64 prefix sum of the chunk into cum_ws (B, H, nc, Lpad);
//  2. but for the lane's last chunk, the state increments S_c = B^T
//     (dec x) (dec_s = exp(cum_last - cum_s)) of the KH heads over
//     64-step tiles, into slot c of h_ws (B, nc - 1, H, N_pad, 64); the
//     first two tiles' B and x copy while the prefix sum runs. Warp w
//     holds state rows of m-tiles (w % WM) * MT .. and P columns of
//     n-tiles (w / WM) * NW .. of every head, so its B^T fragments serve
//     all KH heads;
//  3. the scores C B^T of the chunk's (row tile, column tile <= row tile)
//     pairs, shared by every head: pair p falls to the block of head tile
//     p % (H / KH), into cb_ws (B, nc, RT (RT + 1) / 2, 64, 64).
template <typename T, int NT, int KH>
__global__ void __launch_bounds__(kStateThreads)
    ssd_state_kernel(const float* __restrict__ lam, const T* __restrict__ Bm,
                     const T* __restrict__ Cm, const T* __restrict__ x,
                     float* __restrict__ cum_ws, float* __restrict__ cb_ws,
                     float* __restrict__ h_ws, int T_len, int H, int N, int P, int L, int nc,
                     bool vec_b, bool vec_x) {
  using S = StateCfg<T, NT, KH>;
  constexpr int GT = kStateThreads / KH;   // threads of a head's prefix sum
  extern __shared__ float4 smem_raw[];
  char* base = reinterpret_cast<char*>(smem_raw);
  double* wtot = reinterpret_cast<double*>(base);        // [8]
  float* last = reinterpret_cast<float*>(base + 64);     // [KH]
  char* ring = base + 96;
  auto bst = [&](int st) { return reinterpret_cast<T*>(ring + (st & 1) * S::STAGE); };
  auto xst = [&](int st, int j) {
    return reinterpret_cast<T*>(ring + (st & 1) * S::STAGE + S::B_BYTES) + j * kR * kXS;
  };
  auto cst = [&](int st, int j) {
    return reinterpret_cast<float*>(ring + (st & 1) * S::STAGE + S::B_BYTES + S::X_BYTES) +
           j * kR;
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int c = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int h0 = hq * KH;
  const int wm = warp % S::WM, wn = warp / S::WM;
  const int tpc = (L + kR - 1) / kR;                       // tiles a chunk
  const int Lpad = tpc * kR;
  const int64_t row0 = static_cast<int64_t>(b) * T_len + static_cast<int64_t>(c) * L;
  // cum of head h0 + j of this chunk starts at cum0 + j * nc * Lpad
  float* cum0 = cum_ws + ((static_cast<int64_t>(b) * H + h0) * nc + c) * Lpad;
  const int64_t cum_head = static_cast<int64_t>(nc) * Lpad;
  const int64_t xld = static_cast<int64_t>(H) * P;
  const bool state = c < nc - 1;   // the last chunk's increment is never needed

  auto issue = [&](int st, bool with_cum) {   // B, x (and cum) of tile st
    const int s0 = st * kR;
    const int64_t r = row0 + s0;
    const int vr = min(kR, L - s0);
    stage<T, kStateThreads, kR, NT, S::BSS>(bst(st), Bm + r * N, N, vr, N, vec_b, tid);
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      stage<T, kStateThreads, kR, kPT, kXS>(xst(st, j), x + r * xld + (h0 + j) * P, xld, vr, P,
                                           vec_x, tid);
      if (with_cum)
        stage<float, kStateThreads, 1, kR, kR>(cst(st, j), cum0 + j * cum_head + s0, 0, 1, kR,
                                               true, tid);
    }
    cp_async_commit();
  };

  if (state) {
    issue(0, false);
    if (tpc > 1) issue(1, false);
  }
  const int js = tid / GT;   // the head this thread's group sums
  chunk_scan<GT>(lam + row0 * H + h0 + js, H, L, Lpad, cum0 + js * cum_head,
                 wtot + js * (GT / 32), last + js, state ? cst(0, js) : nullptr,
                 state && tpc > 1 ? cst(1, js) : nullptr, tid % GT);

  if (state) {
    float acc[S::MT][KH * S::NW][4];
#pragma unroll
    for (int mi = 0; mi < S::MT; ++mi)
#pragma unroll
      for (int nj = 0; nj < KH * S::NW; ++nj)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.f;
    for (int st = 0; st < tpc; ++st) {
      if (st + 1 < tpc) cp_async_wait<1>();
      else cp_async_wait<0>();
      __syncthreads();   // tile st landed
      const T* bt = bst(st);
      if (tid < KH * kR) {   // cum of the tile, made dec_s in place
        const int j = tid / kR, sl = tid % kR;
        float* d = cst(st, j) + sl;
        *d = st * kR + sl < L ? expf(last[j] - *d) : 0.f;   // last: cum_last of head j
      }
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < kR / 8; ++kk) {
        const int sa = kk * 8 + t4, sb = sa + 4;
        uint32_t ah[S::MT][4], al[S::MT][4], bh[KH * S::NW][2], bl[KH * S::NW][2];
#pragma unroll
        for (int mi = 0; mi < S::MT; ++mi) {   // A = B^T: A[n][s] = B[s][n]
          const int n = (wm * S::MT + mi) * 16 + g;
          split(to_f32(bt[sa * S::BSS + n]), ah[mi][0], al[mi][0]);
          split(to_f32(bt[sa * S::BSS + n + 8]), ah[mi][1], al[mi][1]);
          split(to_f32(bt[sb * S::BSS + n]), ah[mi][2], al[mi][2]);
          split(to_f32(bt[sb * S::BSS + n + 8]), ah[mi][3], al[mi][3]);
        }
#pragma unroll
        for (int j = 0; j < KH; ++j) {
          const T* xt = xst(st, j);
          const float* dec = cst(st, j);
          const float da = dec[sa], db = dec[sb];
#pragma unroll
          for (int nj = 0; nj < S::NW; ++nj) {
            const int p = (wn * S::NW + nj) * 8 + g;
            split(to_f32(xt[sa * kXS + p]) * da, bh[j * S::NW + nj][0], bl[j * S::NW + nj][0]);
            split(to_f32(xt[sb * kXS + p]) * db, bh[j * S::NW + nj][1], bl[j * S::NW + nj][1]);
          }
        }
        mma3(acc, ah, al, bh, bl);
      }
      __syncthreads();   // every warp is done with stage st
      if (st + 2 < tpc) issue(st + 2, true);
    }
#pragma unroll
    for (int j = 0; j < KH; ++j) {
      float* hp = h_ws + ((static_cast<int64_t>(b) * (nc - 1) + c) * H + h0 + j) * (NT * kPT);
#pragma unroll
      for (int mi = 0; mi < S::MT; ++mi)
#pragma unroll
        for (int nj = 0; nj < S::NW; ++nj) {
          const int n = (wm * S::MT + mi) * 16 + g, p = (wn * S::NW + nj) * 8 + 2 * t4;
          const float* v = acc[mi][j * S::NW + nj];
          *reinterpret_cast<float2*>(hp + n * kPT + p) = make_float2(v[0], v[1]);
          *reinterpret_cast<float2*>(hp + (n + 8) * kPT + p) = make_float2(v[2], v[3]);
        }
    }
  }

  // the scores; the ring is free once every warp is past the last tile
  const int pairs = tpc * (tpc + 1) / 2;
  T* ct = reinterpret_cast<T*>(ring);
  T* bt = reinterpret_cast<T*>(ring + S::STAGE);
  for (int pr = hq; pr < pairs; pr += H / KH) {
    int rt = 0;
    while ((rt + 1) * (rt + 2) / 2 <= pr) ++rt;
    const int kt = pr - rt * (rt + 1) / 2;
    __syncthreads();
    stage<T, kStateThreads, kR, NT, S::CSS>(ct, Cm + (row0 + rt * kR) * N, N,
                                            min(kR, L - rt * kR), N, vec_b, tid);
    stage<T, kStateThreads, kR, NT, S::CSS>(bt, Bm + (row0 + kt * kR) * N, N,
                                            min(kR, L - kt * kR), N, vec_b, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * 4;   // 4 n-tiles a warp
    float sacc[1][4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[0][j][e] = 0.f;
#pragma unroll 2
    for (int k = 0; k < NT / 8; ++k) {
      const int ka = k * 8 + t4, kb = ka + 4;
      uint32_t ah[1][4], al[1][4], bh[4][2], bl[4][2];
      split(to_f32(ct[(m0 + g) * S::CSS + ka]), ah[0][0], al[0][0]);
      split(to_f32(ct[(m0 + g + 8) * S::CSS + ka]), ah[0][1], al[0][1]);
      split(to_f32(ct[(m0 + g) * S::CSS + kb]), ah[0][2], al[0][2]);
      split(to_f32(ct[(m0 + g + 8) * S::CSS + kb]), ah[0][3], al[0][3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int sr = (n0 + j) * 8 + g;
        split(to_f32(bt[sr * S::CSS + ka]), bh[j][0], bl[j][0]);
        split(to_f32(bt[sr * S::CSS + kb]), bh[j][1], bl[j][1]);
      }
      mma3(sacc, ah, al, bh, bl);
    }
    float* out = cb_ws + ((static_cast<int64_t>(b) * nc + c) * pairs + pr) * (kR * kR);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = (n0 + j) * 8 + 2 * t4;
      *reinterpret_cast<float2*>(out + (m0 + g) * kR + col) =
          make_float2(sacc[0][j][0], sacc[0][j][1]);
      *reinterpret_cast<float2*>(out + (m0 + g + 8) * kR + col) =
          make_float2(sacc[0][j][2], sacc[0][j][3]);
    }
  }
}

// grid (N_pad * 64 / 256, H, B), 256 threads: the hand-off of the state
// from chunk to chunk, one thread per state element of a lane, in chunk
// order and in place: slot c of h_ws holds S_c and becomes h_{c+1} =
// h_c exp(cum_last of chunk c) + S_c, from h_0 = 0.
__global__ void __launch_bounds__(kStateThreads)
    ssd_handoff_kernel(const float* __restrict__ cum_ws, float* __restrict__ h_ws, int H,
                       int L, int nc, int elems) {
  const int i = blockIdx.x * kStateThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int Lpad = (L + kR - 1) / kR * kR;
  const float* cum = cum_ws + (static_cast<int64_t>(b) * H + h) * nc * Lpad + L - 1;
  float* hp = h_ws + (static_cast<int64_t>(b) * (nc - 1) * H + h) * elems + i;
  const int64_t slot = static_cast<int64_t>(H) * elems;
  float state = 0.f;
  for (int c = 0; c + 1 < nc; ++c) {
    state = fmaf(state, expf(cum[static_cast<int64_t>(c) * Lpad]), hp[c * slot]);
    hp[c * slot] = state;
  }
}

// ---------------------------------------------------------------------------
// ssd_out_kernel: y for a 64-row tile of one chunk and HT heads
// ---------------------------------------------------------------------------

template <typename T, int NT, int HT>
struct OutCfg {
  static constexpr int NTH = 128;                  // 4 warps
  static constexpr int MPW = HT;                   // m-tiles (16 rows) a warp
  static constexpr int CSS = row_stride<T, NT>();  // C tile row stride
  static constexpr int C_BYTES = kR * CSS * sizeof(T);
  static constexpr int CB_STAGE = kR * kCBS * 4;   // scores of a column tile
  static constexpr int X_STAGE = HT * kR * kXS * sizeof(T);   // x of a column tile
  static constexpr int H_BYTES = HT * NT * kXS * 4;           // h_c, fp32
  // the x ring, which C and h_c take over once the last tile is read
  static constexpr int U_BYTES =
      2 * X_STAGE > C_BYTES + H_BYTES ? 2 * X_STAGE : C_BYTES + H_BYTES;
  static constexpr int CUM_STAGE = HT * kR * 4;
  static constexpr int BYTES = 2 * CB_STAGE + U_BYTES + 2 * CUM_STAGE;
  // C fits the scores stage and h_c the x stage that the last column tile
  // leaves free (fp32, N_pad <= 64): both copy while that tile is used
  static constexpr bool EARLY = C_BYTES <= CB_STAGE && H_BYTES <= X_STAGE;
};

// The m-tile (16 rows of the 64-row tile) of warp i of a one-head block:
// 0, 1, 3, 2, so that warps 0 and 2 (and 1 and 3) hold m-tiles whose
// causal work on the diagonal tile adds up the same.
__device__ __forceinline__ int warp_mtile(int i) { return i < 2 ? i : 5 - i; }

// grid (RT * HG * B * nc), HG = H / HT, 128 threads; the RT row tiles of
// one (chunk, batch, head tile) are neighbours, the last first, so that
// they read each column tile's x from L2. Warp w owns head h0 + w % HT
// and HT m-tiles of the row tile: for one head the m-tile warp_mtile(w),
// for two the pair {0, 3} or {1, 2} (w / 2 = 0 or 1), an even share of
// the causal triangle, whose B fragments (x) it then reuses twice. It
// owns all 64 (padded) P columns: lane l holds accumulator rows g = l / 4
// and g + 8 of each m-tile, columns 2 (l % 4) and + 1 of each 8-wide
// n-tile (the m16n8 C layout). Column tiles (the scores from the state
// kernel, x, cum) run through a two-stage ring: tile kt + 1 copies while
// tile kt is multiplied; on the diagonal tile a warp skips the k-steps
// wholly above its rows. C and h_c copy into the stages the last column
// tile leaves free where they fit (OutCfg::EARLY), else into the ring
// once it is done.
template <typename T, int NT, int HT>
__global__ void __launch_bounds__(128, 1)
    ssd_out_kernel(const T* __restrict__ Cm, const T* __restrict__ x,
                   const float* __restrict__ cum_ws, const float* __restrict__ cb_ws,
                   const float* __restrict__ h_ws, float* __restrict__ y, int B, int T_len,
                   int H, int N, int P, int L, int nc, bool vec_b, bool vec_x) {
  using S = OutCfg<T, NT, HT>;
  extern __shared__ float4 smem_raw[];
  char* base = reinterpret_cast<char*>(smem_raw);
  float* cbring = reinterpret_cast<float*>(base);                    // [2][kR][kCBS] scores
  char* u = base + 2 * S::CB_STAGE;                                  // [2][HT][kR][kXS] x
  float* cring = reinterpret_cast<float*>(u + S::U_BYTES);           // [2][HT][kR] cum
  auto xst = [&](int st) { return reinterpret_cast<T*>(u + st * S::X_STAGE); };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int HG = H / HT;
  const int RT = (L + kR - 1) / kR, Lpad = RT * kR;
  const int pairs = RT * (RT + 1) / 2;
  int64_t lin = blockIdx.x;
  const int rt = RT - 1 - static_cast<int>(lin % RT);
  lin /= RT;
  const int hg = static_cast<int>(lin % HG);
  lin /= HG;
  const int b = static_cast<int>(lin % B);
  const int c = static_cast<int>(lin / B);
  const int h0 = hg * HT, t0 = rt * kR;
  const int64_t row0 = static_cast<int64_t>(b) * T_len + static_cast<int64_t>(c) * L;
  const int64_t xld = static_cast<int64_t>(H) * P;
  const int hh = warp % HT, wi = warp / HT;
  // the warp's m-tiles, and its rows in the tile: [i][e] = 16 mt[i] + 8 e + g
  int mt[S::MPW], rows[S::MPW][2];
  bool ok[S::MPW][2];
  float ct[S::MPW][2];
  // cum of (b, head h0 + j, chunk c) starts at cum_c + j * nc * Lpad
  const float* cum_c = cum_ws + (static_cast<int64_t>(b) * H + h0) * nc * Lpad +
                       static_cast<int64_t>(c) * Lpad;
  const int64_t cum_head = static_cast<int64_t>(nc) * Lpad;
  const float* cb_c = cb_ws + (static_cast<int64_t>(b) * nc + c) * pairs * (kR * kR);
#pragma unroll
  for (int i = 0; i < S::MPW; ++i) {
    mt[i] = S::MPW == 1 ? warp_mtile(wi) : (i == 0 ? wi : 3 - wi);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      rows[i][e] = 16 * mt[i] + 8 * e + g;
      ok[i][e] = t0 + rows[i][e] < L;
      ct[i][e] = cum_c[hh * cum_head + t0 + rows[i][e]];   // padded rows hold cum_last
    }
  }

  auto issue = [&](int kt) {   // scores, x and cum of column tile kt into stage kt % 2
    const int s0 = kt * kR;
    const int vr = min(kR, L - s0);
    const int st = kt & 1;
    stage<float, S::NTH, kR, kR, kCBS>(cbring + st * kR * kCBS,
                                       cb_c + (rt * (rt + 1) / 2 + kt) * (kR * kR), kR, kR, kR,
                                       true, tid);
#pragma unroll
    for (int j = 0; j < HT; ++j) {
      stage<T, S::NTH, kR, kPT, kXS>(xst(st) + j * kR * kXS, x + (row0 + s0) * xld + (h0 + j) * P,
                                     xld, vr, P, vec_x, tid);
      stage<float, S::NTH, 1, kR, kR>(cring + (st * HT + j) * kR, cum_c + j * cum_head + s0, 0,
                                      1, kR, true, tid);
    }
    cp_async_commit();
  };

  // C [kR][CSS] and h_c [HT][NT][kXS]: in stage (rt + 1) % 2 of the
  // scores and x rings when they fit, else in the ring after the loop
  T* cs = S::EARLY ? reinterpret_cast<T*>(cbring + ((rt + 1) & 1) * kR * kCBS)
                   : reinterpret_cast<T*>(u);
  float* hbuf = S::EARLY ? reinterpret_cast<float*>(xst((rt + 1) & 1))
                         : reinterpret_cast<float*>(u + S::C_BYTES);
  auto issue_ch = [&]() {
    if (c > 0) {
      const float* hsrc =
          h_ws + ((static_cast<int64_t>(b) * (nc - 1) + c - 1) * H + h0) * (NT * kPT);
#pragma unroll
      for (int j = 0; j < HT; ++j)
        stage<float, S::NTH, NT, kPT, kXS>(hbuf + j * NT * kXS, hsrc + j * (NT * kPT), kPT, NT,
                                           kPT, true, tid);
      stage<T, S::NTH, kR, NT, S::CSS>(cs, Cm + (row0 + t0) * N, N, min(kR, L - t0), N, vec_b,
                                       tid);
    }
    cp_async_commit();   // empty for chunk 0, which starts from h = 0
  };

  issue(0);
  if (rt >= 1) issue(1);
  else if (S::EARLY) issue_ch();

  float acc[S::MPW][8][4];
#pragma unroll
  for (int i = 0; i < S::MPW; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (int kt = 0; kt <= rt; ++kt) {
    const int st = kt & 1;
    if (kt < rt || S::EARLY) cp_async_wait<1>();   // a later group may fly
    else cp_async_wait<0>();
    __syncthreads();   // column tile kt landed
    // y += W x, W = scores * exp(cum_t - cum_s), s <= t
    const float* cbt = cbring + st * kR * kCBS;
    const T* xt = xst(st) + hh * kR * kXS;
    const float* cst = cring + (st * HT + hh) * kR;
    // one k-step of 8 columns; on the diagonal tile the causal mask
    auto kstep = [&](int kk, auto diag_tag) {
      constexpr bool kDiag = decltype(diag_tag)::value;
      const int sa = kk * 8 + t4, sb = sa + 4;
      const float csa = cst[sa], csb = cst[sb];
      uint32_t ah[S::MPW][4], al[S::MPW][4], bh[8][2], bl[8][2];
      bool live[S::MPW];
#pragma unroll
      for (int i = 0; i < S::MPW; ++i) {
        // on the diagonal tile, an m-tile wholly above this k-step adds nothing
        live[i] = !kDiag || kk * 8 <= 16 * mt[i] + 15;
        // the mask selects the exponent before exp: a masked entry's is -inf
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = rows[i][e & 1], sc = e < 2 ? sa : sb;
          const float d = ok[i][e & 1] && (!kDiag || sc <= r)
                              ? (ct[i][e & 1] - (e < 2 ? csa : csb)) * kLog2e
                              : -INFINITY;
          split(cbt[r * kCBS + sc] * exp2_approx(d), ah[i][e], al[i][e]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = j * 8 + g;
        split(to_f32(xt[sa * kXS + p]), bh[j][0], bl[j][0]);
        split(to_f32(xt[sb * kXS + p]), bh[j][1], bl[j][1]);
      }
      if constexpr (kDiag && S::MPW > 1) mma3(acc, ah, al, bh, bl, live);
      else mma3(acc, ah, al, bh, bl);
    };
    if (kt < rt) {
#pragma unroll 2
      for (int kk = 0; kk < kR / 8; ++kk) kstep(kk, std::false_type());
    } else {   // k-steps past this warp's last row add nothing
      for (int kk = 0; kk < 2 * mt[S::MPW - 1] + 2; ++kk) kstep(kk, std::true_type());
    }
    __syncthreads();   // every warp is done with stage st
    if (kt + 2 <= rt) issue(kt + 2);
    else if (S::EARLY && kt + 1 == rt) issue_ch();
  }

  if (c > 0) {   // y += exp(cum_t) C_t . h_c
    if (!S::EARLY) issue_ch();
    cp_async_wait<0>();
    __syncthreads();
    float ex[S::MPW][2];
#pragma unroll
    for (int i = 0; i < S::MPW; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) ex[i][e] = expf(ct[i][e]);
    const float* ht = hbuf + hh * NT * kXS;
#pragma unroll 1
    for (int k = 0; k < NT / 8; ++k) {
      const int ka = k * 8 + t4, kb = ka + 4;
      uint32_t ah[S::MPW][4], al[S::MPW][4], bh[8][2], bl[8][2];
#pragma unroll
      for (int i = 0; i < S::MPW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split(to_f32(cs[rows[i][e & 1] * S::CSS + (e < 2 ? ka : kb)]) * ex[i][e & 1],
                ah[i][e], al[i][e]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = j * 8 + g;
        split(ht[ka * kXS + p], bh[j][0], bl[j][0]);
        split(ht[kb * kXS + p], bh[j][1], bl[j][1]);
      }
      mma3(acc, ah, al, bh, bl);
    }
  }

  const int h = h0 + hh;
#pragma unroll
  for (int i = 0; i < S::MPW; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (!ok[i][e]) continue;
      float* yr = y + ((row0 + t0 + rows[i][e]) * H + h) * static_cast<int64_t>(P);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = j * 8 + 2 * t4;
        if (p >= P) continue;
        const float v0 = acc[i][j][2 * e], v1 = acc[i][j][2 * e + 1];
        if ((P & 1) == 0) {
          *reinterpret_cast<float2*>(yr + p) = make_float2(v0, v1);
        } else {
          yr[p] = v0;
          if (p + 1 < P) yr[p + 1] = v1;
        }
      }
    }
}

// ---------------------------------------------------------------------------
// the backward: gradients of the scan on the tensor cores, fp32
// ---------------------------------------------------------------------------
//
// ssd_chunk_bwd computes what jax.vjp of the reference's chunk_step gives
// (repro/models/layers/mamba2.py:120-136; kernels/ssd_chunk/ref.py
// ssd_scan_bwd_ref holds the closed form). Per lane and chunk, with cum
// the forward's fp32 prefix sums, h the chunk-start state (the forward's
// h_ws), G the gradient of the chunk-end state and e_s = exp(cum_last -
// cum_s):
//     dx_s  = sum_{t>=s} (C_t . B_s) exp(cum_t - cum_s) dy_t + e_s G^T B_s
//     dC_t  = sum_{s<=t} exp(cum_t - cum_s) (dy_t . x_s) B_s + exp(cum_t) h dy_t
//     dB_s  = sum_{t>=s} exp(cum_t - cum_s) (dy_t . x_s) C_t + e_s G x_s
//     G_{c-1} = exp(cum_last) G_c + sum_t exp(cum_t) C_t (x) dy_t
// and dlam from per-step sums of the score terms (Z_ts = (dy_t . x_s)
// (C_t . B_s) exp(cum_t - cum_s), s < t), of the inter-chunk term iota_t
// and of the state term sigma_s, scanned in float64 as ref.py scans them.
//
// Bound: operations. C B^T once per (batch, chunk) and, per lane and
// chunk, dy x^T, W^T dy, Q B and Q^T C over the causal triangle
// (L(L+1)/2 * 2K each) and four (N, P) products a step: 25.8 GFLOP at the
// Zamba2-1.2B layer (B 4, T 1024, H 64, N = P = 64, L 256) against 207 MB
// of inputs and outputs, 0.156 ms at the TF32 rate taken three times,
// 0.385 ms at the 67 TFLOP/s of the CUDA cores' FMAs. The design:
//   * every product on the tensor cores, as the forward takes them:
//     mma.sync.m16n8k8 TF32, each fp32 operand split into hi + lo and
//     multiplied as lo.hi + hi.lo + hi.hi, each pass swept over all of a
//     warp's n-tiles before the next (mma_tf32.cuh mma3). The split is
//     split_rz, three instructions: on sm_90a cvt.rna.tf32 is no single
//     SASS instruction (a compare, an add, a mask and a select), and with
//     it the splits took most of the issue slots. W = (C B^T) E and
//     Q = D E (D = dy x^T, E_ts = exp(cum_t - cum_s)) are formed in fp32
//     from the accumulators and split again before their products;
//   * C B^T is not formed at all: the forward's state kernel already
//     wrote the scores of every (batch, chunk, tile pair) to cb_ws, which
//     ssd_chunk(..., return_saved=True) hands on with the prefix sums and
//     states. A warp reads its part of the pair's tile from L2 into
//     registers before it forms D, so the load hides behind D's
//     products. (At L = T the workspace grows with L^2, 0.54 GB at B 4,
//     T 8191; under remat it lives one layer at a time);
//   * D stays formed twice, once in a row and once in a column kernel:
//     of the row kernel's two products and the column kernel's three, one
//     each is D (2 of the 5 tile-pair products; one for all of them would
//     need either dC's partials per column tile summed across blocks or
//     dx's and dB's per row tile, 168 MB of round trips at the Zamba2
//     layer). The column kernel forms D^T = x dy^T with the first two
//     passes swapped, so that every entry of D takes its products in the
//     row kernel's order, and both kernels form W = CB * E and take
//     Z = D * W into their sums by the same instructions: the row sums and
//     the column sums of Z add the same terms;
//   * the accumulator of D (rows g, g + 8; columns 2t, 2t + 1 of each
//     8-wide n-tile) is read as the A fragment of the next product's
//     k-step in a permuted k order (slot t <-> column 2t, slot t + 4 <->
//     2t + 1), so Q and W go from accumulator to product without shared
//     memory, and the B operand (B, C or dy rows of the k-step) is read
//     in the same permuted order;
//   * ssd_bwd_row_kernel, a block of 4 warps per (64-row tile, head,
//     batch, chunk), the tiles with the most column tiles first: warp w
//     owns rows 16w .. 16w + 15 and all 64 columns; per column tile s <=
//     t, D (dy fragments against x), Q and the row sums of Z, dC += Q B;
//     then, for c > 0, dC += exp(cum_t) h_c dy_t and iota. On the diagonal
//     tile a warp forms only the n-tiles at or left of its rows;
//   * ssd_bwd_col_kernel, the same grid per 64-column tile: warp w owns
//     steps s = 16w .. 16w + 15; per row tile t >= s, from the last to
//     the diagonal one, D^T (x fragments against dy), W^T and Q^T and the
//     column sums of Z, dx += W^T dy, dB += Q^T C; then, for c < nc - 1,
//     the state terms of G_c (G^T B_s and G x_s) and sigma. On the
//     diagonal tile a warp forms only the n-tiles at or below its steps;
//   * registers set the pace of both: a warp forms D (D^T) 32 columns
//     (steps) at a time (16 at N_pad 128), each part's accumulator turned
//     into the next products' A fragments before the next part is formed,
//     and runs an N-wide product over groups of 4 n-tiles, so that no
//     instance spills and ptxas keeps room to schedule (with all 64
//     columns at once the column kernel sat at ptxas' 255-register cap);
//   * ssd_bwd_state_kernel, a block per (batch, chunk >= 1, head): the
//     increment sum_t exp(cum_t) C_t (x) dy_t on the tensor cores over
//     64-step tiles; ssd_bwd_handoff_kernel hands G back chunk by chunk,
//     ssd_bwd_dlam_kernel scans the per-step sums into dlam in float64,
//     ssd_bwd_headsum_kernel sums the per-head partials of dB and dC in
//     head order. Six kernels (four for one chunk);
//   * tiles are staged by cp.async (16-byte copies, 4-byte for rows that
//     are not 16-byte multiples) through two-stage rings: the next column
//     (row) tile's x and B (dy and C) and prefix sums copy while this one
//     is multiplied. Shared rows have a stride of 4 mod 32 words where
//     fragments read them along k or in the permuted order (8 mod 32 in
//     the state kernel, which reads them across k), so those loads are
//     free of bank conflicts. A row or column block takes 87.5 KB at
//     N_pad 64, two blocks an SM.
// No float atomics: every sum runs in a fixed order (a lane's columns in
// order, then its quad by xor shuffles; the tiles in order), so two calls
// give the same bits. Every exponent is cum_t - cum_s with s <= t (the
// mask chosen before exp), cum_last - cum_s or cum_t, all <= 0 for decays
// lam <= 0: exp(-cum) is never formed. Rows past L and columns past N or
// P are zero-filled and never stored.

// threads of the dlam and head-sum blocks, and of a row / column block
constexpr int kBT = 256;
constexpr int kPairThreads = 128;
constexpr int kFS = kPT + 4;   // row stride of a 64-wide fp32 tile (4 mod 32)

template <int NT>
struct BwdCfg {
  static constexpr int NS = NT + 4;               // row stride of a B / C tile (4 mod 32)
  static constexpr int NJ = NT / 8;               // 8-wide n-tiles of an N-wide output
  // an N-wide product runs over groups of at most 4 n-tiles, so that
  // its B fragments (4 registers an n-tile) take at most 16 registers
  static constexpr int NG = NJ < 4 ? NJ : 4;      // n-tiles a group
  static constexpr int NGRP = NJ / NG;            // groups
  static constexpr int FT = kR * kFS;             // floats of a 64 x 64 tile
  static constexpr int NTILE = kR * NS;           // floats of a (64, N_pad) tile
  static constexpr int STAGE = FT + NTILE + kR;   // x or dy, B or C, and cum of a tile
  // the fixed 64 x 64 tile (dy of the rows, x of the columns) and the ring
  static constexpr int PAIR_BYTES = (FT + 2 * STAGE) * 4;
  static_assert(NT * kFS <= STAGE, "h_c / G_c fits a stage");
  // n-tiles of D (D^T) a warp forms at once: half its 64 columns, a
  // quarter at N_pad 128, whose dB / dC accumulators take 64 registers
  static constexpr int JH = NT >= 128 ? 2 : 4;
  // the state kernel: C and dy read across k (8 mod 32 words)
  static constexpr int SCS = NT + 8;
  static constexpr int SDS = kPT + 8;
  static constexpr int SSTAGE = kR * SCS + kR * SDS + kR;
  static constexpr int STATE_BYTES = 2 * SSTAGE * 4;
  static constexpr int MTOT = NT / 16;            // m-tiles of the state's rows
  static constexpr int WM = MTOT < 2 ? MTOT : 2;  // warps along the rows
  static constexpr int WN = 8 / WM;               // warps along P
  static constexpr int MT = MTOT / WM;            // m-tiles a warp
  static constexpr int NW = 8 / WN;               // n-tiles a warp
};

// The sum over the 4 lanes of a quad (one accumulator row), in a fixed
// order; every one of them gets it.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// grid (nc - 1, H, B), kStateThreads: the increment R = sum_t exp(cum_t)
// C_t (x) dy_t of chunk c = blockIdx.x + 1 of lane (b, h), into slot c - 1
// of g_ws, as R[n][p] = sum_t (exp(cum_t) C[t][n]) dy[t][p] over 64-step
// tiles through a two-stage ring. Warp w holds rows of m-tiles (w % WM) *
// MT .. and columns of n-tiles (w / WM) * NW .., as ssd_state_kernel.
template <int NT>
__global__ void __launch_bounds__(kStateThreads)
    ssd_bwd_state_kernel(const float* __restrict__ Cm, const float* __restrict__ dy,
                         const float* __restrict__ cum_ws, float* __restrict__ g_ws, int T_len,
                         int H, int N, int P, int L, int nc, bool vec_b, bool vec_x) {
  using S = BwdCfg<NT>;
  extern __shared__ float4 smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  auto cst = [&](int st) { return ring + (st & 1) * S::SSTAGE; };
  auto dst = [&](int st) { return ring + (st & 1) * S::SSTAGE + kR * S::SCS; };
  auto est = [&](int st) { return ring + (st & 1) * S::SSTAGE + kR * (S::SCS + S::SDS); };
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp % S::WM, wn = warp / S::WM;
  const int c = blockIdx.x + 1, h = blockIdx.y, b = blockIdx.z;
  const int RT = (L + kR - 1) / kR, Lpad = RT * kR;
  const int64_t row0 = static_cast<int64_t>(b) * T_len + static_cast<int64_t>(c) * L;
  const int64_t xld = static_cast<int64_t>(H) * P;
  const float* cum = cum_ws + ((static_cast<int64_t>(b) * H + h) * nc + c) * Lpad;

  auto issue = [&](int st) {
    const int t0 = st * kR, vt = min(kR, L - t0);
    stage<float, kStateThreads, kR, NT, S::SCS>(cst(st), Cm + (row0 + t0) * N, N, vt, N, vec_b,
                                                tid);
    stage<float, kStateThreads, kR, kPT, S::SDS>(dst(st), dy + (row0 + t0) * xld + h * P, xld,
                                                 vt, P, vec_x, tid);
    stage<float, kStateThreads, 1, kR, kR>(est(st), cum + t0, 0, 1, kR, true, tid);
    cp_async_commit();
  };
  issue(0);
  if (RT > 1) issue(1);

  float acc[S::MT][S::NW][4];
#pragma unroll
  for (int mi = 0; mi < S::MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < S::NW; ++nj)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.f;
  for (int st = 0; st < RT; ++st) {
    if (st + 1 < RT) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();   // tile st landed
    if (tid < kR) {    // cum of the tile, made exp(cum_t) in place; 0 past L
      float* e = est(st) + tid;
      *e = st * kR + tid < L ? expf(*e) : 0.f;
    }
    __syncthreads();
    const float* ct = cst(st);
    const float* dt = dst(st);
    const float* et = est(st);
#pragma unroll 2
    for (int kk = 0; kk < kR / 8; ++kk) {
      const int ta = kk * 8 + t4, tb = ta + 4;
      const float ea = et[ta], eb = et[tb];
      uint32_t ah[S::MT][4], al[S::MT][4], bh[S::NW][2], bl[S::NW][2];
#pragma unroll
      for (int mi = 0; mi < S::MT; ++mi) {   // A[n][t] = exp(cum_t) C[t][n]
        const int n = (wm * S::MT + mi) * 16 + g;
        split_rz(ct[ta * S::SCS + n] * ea, ah[mi][0], al[mi][0]);
        split_rz(ct[ta * S::SCS + n + 8] * ea, ah[mi][1], al[mi][1]);
        split_rz(ct[tb * S::SCS + n] * eb, ah[mi][2], al[mi][2]);
        split_rz(ct[tb * S::SCS + n + 8] * eb, ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int nj = 0; nj < S::NW; ++nj) {
        const int p = (wn * S::NW + nj) * 8 + g;
        split_rz(dt[ta * S::SDS + p], bh[nj][0], bl[nj][0]);
        split_rz(dt[tb * S::SDS + p], bh[nj][1], bl[nj][1]);
      }
      mma3(acc, ah, al, bh, bl);
    }
    __syncthreads();   // every warp is done with stage st
    if (st + 2 < RT) issue(st + 2);
  }
  float* out = g_ws + ((static_cast<int64_t>(b) * (nc - 1) + c - 1) * H + h) * (NT * kPT);
#pragma unroll
  for (int mi = 0; mi < S::MT; ++mi)
#pragma unroll
    for (int nj = 0; nj < S::NW; ++nj) {
      const int n = (wm * S::MT + mi) * 16 + g, p = (wn * S::NW + nj) * 8 + 2 * t4;
      const float* v = acc[mi][nj];
      *reinterpret_cast<float2*>(out + n * kPT + p) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(out + (n + 8) * kPT + p) = make_float2(v[2], v[3]);
    }
}

// grid (N_pad * 64 / 256, H, B), 256 threads: G from the last chunk back,
// one thread per state element of a lane, in place: slot c of g_ws holds
// the increment of chunk c + 1 and becomes G_c = exp(cum_last of chunk
// c + 1) G_{c+1} + that increment, from G_{nc-1} = 0.
__global__ void __launch_bounds__(kStateThreads)
    ssd_bwd_handoff_kernel(const float* __restrict__ cum_ws, float* __restrict__ g_ws, int H,
                           int L, int nc, int elems) {
  const int i = blockIdx.x * kStateThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int Lpad = (L + kR - 1) / kR * kR;
  const float* cum = cum_ws + (static_cast<int64_t>(b) * H + h) * nc * Lpad + L - 1;
  float* gp = g_ws + (static_cast<int64_t>(b) * (nc - 1) * H + h) * elems + i;
  const int64_t slot = static_cast<int64_t>(H) * elems;
  float g = 0.f;
  for (int c = nc - 2; c >= 0; --c) {
    g = fmaf(g, expf(cum[static_cast<int64_t>(c + 1) * Lpad]), gp[c * slot]);
    gp[c * slot] = g;
  }
}

// The 64-step tile, head, batch row and chunk that block blockIdx.x of a
// row or column kernel takes (grid RT * H * B * nc); tiles run in the
// order of their work, the largest first: the row kernel's from the
// last, the column kernel's from the first.
struct TileIdx {
  int tile, h, b, c;
};
__device__ __forceinline__ TileIdx tile_index(int RT, int H, int B, bool last_first) {
  int64_t lin = blockIdx.x;
  TileIdx r;
  const int k = static_cast<int>(lin % RT);
  r.tile = last_first ? RT - 1 - k : k;
  lin /= RT;
  r.h = static_cast<int>(lin % H);
  lin /= H;
  r.b = static_cast<int>(lin % B);
  r.c = static_cast<int>(lin / B);
  return r;
}

// A fragments of one k-step from the accumulator of an 8-wide n-tile, in
// the permuted k order: slot t4 holds column 2 t4, slot t4 + 4 column
// 2 t4 + 1 (the B operand's rows are read in the same order).
__device__ __forceinline__ void acc_to_a(const float (&v)[4], uint32_t (&ah)[4],
                                         uint32_t (&al)[4]) {
  split_rz(v[0], ah[0], al[0]);   // (g, 2t)
  split_rz(v[2], ah[1], al[1]);   // (g + 8, 2t)
  split_rz(v[1], ah[2], al[2]);   // (g, 2t + 1)
  split_rz(v[3], ah[3], al[3]);   // (g + 8, 2t + 1)
}

// Row kernel: rows t of one 64-step tile of one head, 4 warps, warp w on
// rows 16w .. 16w + 15. Per column tile s <= t (x, B and cum through the
// ring; the pair's scores from cb_ws into registers): D = dy x^T, W =
// CB E and Q = D E (E masked before exp), the row sums of Z = D W (s <
// t), dC += Q B. Then, for c > 0, dC += exp(cum_t) h_c dy_t and iota_t =
// exp(cum_t) C_t . h_c dy_t. Writes dC's per-head partial (B, T, H, N) and
// planes 0 (sum_s Z) and 1 (iota) of part_ws.
template <int NT>
__global__ void __launch_bounds__(kPairThreads, 2)
    ssd_bwd_row_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                       const float* __restrict__ x, const float* __restrict__ dy,
                       const float* __restrict__ cum_ws, const float* __restrict__ cb_ws,
                       const float* __restrict__ h_ws, float* __restrict__ dC_part,
                       float* __restrict__ part_ws, int B, int T_len, int H, int N, int P, int L,
                       int nc, bool vec_b, bool vec_x) {
  using S = BwdCfg<NT>;
  extern __shared__ float4 smem_raw[];
  float* dys = reinterpret_cast<float*>(smem_raw);   // dy of the rows [kR][kFS]
  float* ring = dys + S::FT;                          // [2] x: x [kR][kFS], B [kR][NS], cum [kR]
  auto xst = [&](int st) { return ring + (st & 1) * S::STAGE; };
  auto bst = [&](int st) { return ring + (st & 1) * S::STAGE + S::FT; };
  auto cst = [&](int st) { return ring + (st & 1) * S::STAGE + S::FT + S::NTILE; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int RT = (L + kR - 1) / kR, Lpad = RT * kR, pairs = RT * (RT + 1) / 2;
  const TileIdx ix = tile_index(RT, H, B, true);
  const int h = ix.h, b = ix.b, c = ix.c, rt = ix.tile;
  const int t0 = rt * kR, vt = min(kR, L - t0);
  const int64_t row0 = static_cast<int64_t>(b) * T_len + static_cast<int64_t>(c) * L;
  const int64_t xld = static_cast<int64_t>(H) * P;
  const int64_t lane_off = ((static_cast<int64_t>(b) * H + h) * nc + c) * Lpad;
  const float* cum = cum_ws + lane_off;
  const float* cb_row = cb_ws + ((static_cast<int64_t>(b) * nc + c) * pairs + rt * (rt + 1) / 2) *
                                    (kR * kR);
  // this warp's rows of the tile: rr[e] = 16 warp + 8 e + g
  int rr[2];
  bool ok[2];
  float ct[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    rr[e] = 16 * warp + 8 * e + g;
    ok[e] = rr[e] < vt;
    ct[e] = cum[t0 + rr[e]];   // padded rows hold cum_last
  }

  auto issue = [&](int kt) {   // x, B and cum of column tile kt into stage kt % 2
    const int s0 = kt * kR, vs = min(kR, L - s0);
    stage<float, kPairThreads, kR, kPT, kFS>(xst(kt), x + (row0 + s0) * xld + h * P, xld, vs, P,
                                             vec_x, tid);
    stage<float, kPairThreads, kR, NT, S::NS>(bst(kt), Bm + (row0 + s0) * N, N, vs, N, vec_b,
                                              tid);
    stage<float, kPairThreads, 1, kR, kR>(cst(kt), cum + s0, 0, 1, kR, true, tid);
    cp_async_commit();
  };
  stage<float, kPairThreads, kR, kPT, kFS>(dys, dy + (row0 + t0) * xld + h * P, xld, vt, P, vec_x,
                                           tid);
  issue(0);   // dy joins column tile 0's group
  if (rt >= 1) issue(1);

  float dc[S::NGRP][1][S::NG][4];   // n-tile jj in dc[jj / NG][0][jj % NG]
#pragma unroll
  for (int gi = 0; gi < S::NGRP; ++gi)
#pragma unroll
    for (int j = 0; j < S::NG; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) dc[gi][0][j][q] = 0.f;
  float rz[2] = {0.f, 0.f};
  const float* dyw = dys + (16 * warp + g) * kFS;   // this warp's rows of dy

  // one column tile, JH n-tiles (8 JH columns s) at a time, so that D's
  // accumulator takes 4 JH registers; on the diagonal only the n-tiles at
  // or left of the warp's rows
  auto pair = [&](int kt, auto diag_tag) {
    constexpr bool kDiag = decltype(diag_tag)::value;
    const int nj = kDiag ? 2 * warp + 2 : 8;   // n-tiles 0 .. nj - 1
    const float* xt = xst(kt);
    const float* bt = bst(kt);
    const float* cs = cst(kt);
    const float* cbt = cb_row + kt * (kR * kR);
#pragma unroll 1
    for (int jb = 0; jb < nj; jb += S::JH) {
      const int nl = kDiag ? min(S::JH, nj - jb) : S::JH;   // live n-tiles
      // their scores at the accumulator's places, loaded ahead of D
      float2 cbv[S::JH][2];
#pragma unroll
      for (int jl = 0; jl < S::JH; ++jl)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          cbv[jl][e] = !kDiag || jl < nl
                           ? __ldg(reinterpret_cast<const float2*>(cbt + rr[e] * kR +
                                                                   8 * (jb + jl) + 2 * t4))
                           : make_float2(0.f, 0.f);
      // D = dy x^T: A = dy (rows t, k = p), B = x (k = p, n = s)
      float d[1][S::JH][4];
#pragma unroll
      for (int jl = 0; jl < S::JH; ++jl)
#pragma unroll
        for (int q = 0; q < 4; ++q) d[0][jl][q] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < kPT / 8; ++kk) {
        const int pa = kk * 8 + t4;
        uint32_t ah[1][4], al[1][4], bh[S::JH][2], bl[S::JH][2];
        split_rz(dyw[pa], ah[0][0], al[0][0]);
        split_rz(dyw[8 * kFS + pa], ah[0][1], al[0][1]);
        split_rz(dyw[pa + 4], ah[0][2], al[0][2]);
        split_rz(dyw[8 * kFS + pa + 4], ah[0][3], al[0][3]);
#pragma unroll
        for (int jl = 0; jl < S::JH; ++jl) {
          if (kDiag && jl >= nl) continue;
          const float* xr = xt + (8 * (jb + jl) + g) * kFS + pa;
          split_rz(xr[0], bh[jl][0], bl[jl][0]);
          split_rz(xr[4], bh[jl][1], bl[jl][1]);
        }
        mma3_cols(d, ah, al, bh, bl, 0, nl);
      }
      // W = CB E, Q = D E, the row sums of Z = D W (s < t); dC += Q B,
      // k-step j the 8 columns of n-tile j in the permuted order
#pragma unroll
      for (int jl = 0; jl < S::JH; ++jl) {
        if (kDiag && jl >= nl) continue;
        const int j = jb + jl;
        const float2 csv = *reinterpret_cast<const float2*>(cs + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int s = 8 * j + 2 * t4 + q;
            const bool live = ok[e] && (!kDiag || s <= rr[e]);
            const float ex =
                exp2_approx(live ? (ct[e] - (q ? csv.y : csv.x)) * kLog2e : -INFINITY);
            const float w = (q ? cbv[jl][e].y : cbv[jl][e].x) * ex;
            const float dv = d[0][jl][2 * e + q];
            if (!kDiag || s < rr[e]) rz[e] += dv * w;
            d[0][jl][2 * e + q] = dv * ex;
          }
        uint32_t ah[1][4], al[1][4];
        acc_to_a(d[0][jl], ah[0], al[0]);
        const float* br = bt + (8 * j + 2 * t4) * S::NS + g;
#pragma unroll
        for (int gi = 0; gi < S::NGRP; ++gi) {
          uint32_t bh[S::NG][2], bl[S::NG][2];
#pragma unroll
          for (int jj = 0; jj < S::NG; ++jj) {
            const int n = 8 * (gi * S::NG + jj);
            split_rz(br[n], bh[jj][0], bl[jj][0]);
            split_rz(br[S::NS + n], bh[jj][1], bl[jj][1]);
          }
          mma3(dc[gi], ah, al, bh, bl);
        }
      }
    }
  };

  for (int kt = 0; kt <= rt; ++kt) {
    if (kt < rt) cp_async_wait<1>();   // a later group may fly
    else cp_async_wait<0>();
    __syncthreads();                   // column tile kt landed
    if (kt < rt) pair(kt, std::false_type());
    else pair(kt, std::true_type());
    __syncthreads();                   // every warp is done with stage kt
    if (kt + 2 <= rt) issue(kt + 2);
  }

  float io[2] = {0.f, 0.f};
  if (c > 0) {   // dC += exp(cum_t) h_c dy_t; iota_t = exp(cum_t) C_t . h_c dy_t
    float* hs = ring;              // h_c [NT][kFS], in stage 0
    float* cs = ring + S::STAGE;   // C of the rows [kR][NS], in stage 1
    stage<float, kPairThreads, NT, kPT, kFS>(
        hs, h_ws + ((static_cast<int64_t>(b) * (nc - 1) + c - 1) * H + h) * (NT * kPT), kPT, NT,
        kPT, true, tid);
    stage<float, kPairThreads, kR, NT, S::NS>(cs, Cm + (row0 + t0) * N, N, vt, N, vec_b, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // v = dy h^T: A = dy (k = p), B(k = p, n) = h[n][p]
    float v[S::NGRP][1][S::NG][4];
#pragma unroll
    for (int gi = 0; gi < S::NGRP; ++gi)
#pragma unroll
      for (int j = 0; j < S::NG; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) v[gi][0][j][q] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < kPT / 8; ++kk) {
      const int pa = kk * 8 + t4;
      uint32_t ah[1][4], al[1][4];
      split_rz(dyw[pa], ah[0][0], al[0][0]);
      split_rz(dyw[8 * kFS + pa], ah[0][1], al[0][1]);
      split_rz(dyw[pa + 4], ah[0][2], al[0][2]);
      split_rz(dyw[8 * kFS + pa + 4], ah[0][3], al[0][3]);
#pragma unroll
      for (int gi = 0; gi < S::NGRP; ++gi) {
        uint32_t bh[S::NG][2], bl[S::NG][2];
#pragma unroll
        for (int jj = 0; jj < S::NG; ++jj) {
          const float* hr = hs + (8 * (gi * S::NG + jj) + g) * kFS + pa;
          split_rz(hr[0], bh[jj][0], bl[jj][0]);
          split_rz(hr[4], bh[jj][1], bl[jj][1]);
        }
        mma3(v[gi], ah, al, bh, bl);
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float ec = ok[e] ? expf(ct[e]) : 0.f;
      const float* cr = cs + rr[e] * S::NS + 2 * t4;
#pragma unroll
      for (int jj = 0; jj < S::NJ; ++jj)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float vv = v[jj / S::NG][0][jj % S::NG][2 * e + q];
          float& acc = dc[jj / S::NG][0][jj % S::NG][2 * e + q];
          acc = fmaf(ec, vv, acc);
          io[e] = fmaf(cr[8 * jj + q], vv, io[e]);
        }
      io[e] = quad_sum(io[e]) * ec;
    }
  }

  const int64_t plane = static_cast<int64_t>(B) * H * nc * Lpad;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float rzs = quad_sum(rz[e]);
    if (!ok[e]) continue;
    const int t = t0 + rr[e];
    if (t4 == 0) {
      part_ws[lane_off + t] = rzs;
      part_ws[plane + lane_off + t] = io[e];
    }
    float* out = dC_part + ((row0 + t) * H + h) * N;
#pragma unroll
    for (int jj = 0; jj < S::NJ; ++jj) {
      const int n = 8 * jj + 2 * t4;
      if (n >= N) continue;
      const float* v = dc[jj / S::NG][0][jj % S::NG];
      if ((N & 1) == 0) {
        *reinterpret_cast<float2*>(out + n) = make_float2(v[2 * e], v[2 * e + 1]);
      } else {
        out[n] = v[2 * e];
        if (n + 1 < N) out[n + 1] = v[2 * e + 1];
      }
    }
  }
}

// Column kernel: steps s of one 64-step tile of one head, 4 warps, warp w
// on steps 16w .. 16w + 15. Per row tile t >= s, the last first (dy, C
// and cum through the ring; the pair's scores from cb_ws into
// registers): D^T = x dy^T
// (the first two passes swapped, so each entry is the row kernel's D),
// W^T, Q^T and the column sums of Z as the row kernel forms them,
// dx += W^T dy and dB += Q^T C. Then, for c < nc - 1, dx += e_s G_c^T
// B_s, dB += e_s G_c x_s and sigma. Writes dx (B, T, H, P), dB's
// per-head partial (B, T, H, N) and planes 2 (sum_t Z) and 3 (sigma) of
// part_ws.
template <int NT>
__global__ void __launch_bounds__(kPairThreads, 2)
    ssd_bwd_col_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                       const float* __restrict__ x, const float* __restrict__ dy,
                       const float* __restrict__ cum_ws, const float* __restrict__ cb_ws,
                       const float* __restrict__ g_ws, float* __restrict__ dx,
                       float* __restrict__ dB_part, float* __restrict__ part_ws, int B, int T_len,
                       int H, int N, int P, int L, int nc, bool vec_b, bool vec_x) {
  using S = BwdCfg<NT>;
  extern __shared__ float4 smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);   // x of the steps [kR][kFS]
  float* ring = xs + S::FT;                          // [2] x: dy [kR][kFS], C [kR][NS], cum [kR]
  auto dst = [&](int i) { return ring + (i & 1) * S::STAGE; };
  auto cst = [&](int i) { return ring + (i & 1) * S::STAGE + S::FT; };
  auto mst = [&](int i) { return ring + (i & 1) * S::STAGE + S::FT + S::NTILE; };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int RT = (L + kR - 1) / kR, Lpad = RT * kR, pairs = RT * (RT + 1) / 2;
  const TileIdx ix = tile_index(RT, H, B, false);
  const int h = ix.h, b = ix.b, c = ix.c, st = ix.tile;
  const int s0 = st * kR, vs = min(kR, L - s0);
  const int64_t row0 = static_cast<int64_t>(b) * T_len + static_cast<int64_t>(c) * L;
  const int64_t xld = static_cast<int64_t>(H) * P;
  const int64_t lane_off = ((static_cast<int64_t>(b) * H + h) * nc + c) * Lpad;
  const float* cum = cum_ws + lane_off;
  const float* cb_c = cb_ws + (static_cast<int64_t>(b) * nc + c) * pairs * (kR * kR);
  // this warp's steps of the tile: rr[e] = 16 warp + 8 e + g
  int rr[2];
  bool ok[2];
  float cs[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    rr[e] = 16 * warp + 8 * e + g;
    ok[e] = rr[e] < vs;
    cs[e] = cum[s0 + rr[e]];
  }
  const int n_rt = RT - st;   // row tiles RT - 1 down to st

  // the row tiles from the last to the diagonal one
  auto row_of = [&](int i) { return RT - 1 - i; };
  auto issue = [&](int i) {   // dy, C and cum of row tile row_of(i) into stage i % 2
    const int t0 = row_of(i) * kR, vt = min(kR, L - t0);
    stage<float, kPairThreads, kR, kPT, kFS>(dst(i), dy + (row0 + t0) * xld + h * P, xld, vt, P,
                                             vec_x, tid);
    stage<float, kPairThreads, kR, NT, S::NS>(cst(i), Cm + (row0 + t0) * N, N, vt, N, vec_b,
                                              tid);
    stage<float, kPairThreads, 1, kR, kR>(mst(i), cum + t0, 0, 1, kR, true, tid);
    cp_async_commit();
  };
  stage<float, kPairThreads, kR, kPT, kFS>(xs, x + (row0 + s0) * xld + h * P, xld, vs, P, vec_x,
                                           tid);
  issue(0);   // x joins row tile RT - 1's group
  if (n_rt > 1) issue(1);

  float dxa[1][8][4];
  float dba[S::NGRP][1][S::NG][4];   // n-tile jj in dba[jj / NG][0][jj % NG]
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) dxa[0][j][q] = 0.f;
#pragma unroll
  for (int gi = 0; gi < S::NGRP; ++gi)
#pragma unroll
    for (int j = 0; j < S::NG; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) dba[gi][0][j][q] = 0.f;
  float cz[2] = {0.f, 0.f};
  const float* xw = xs + (16 * warp + g) * kFS;   // this warp's steps of x

  // one row tile, JH n-tiles (8 JH steps t) at a time, so that D^T's
  // accumulator takes 4 JH registers; on the diagonal only the n-tiles at
  // or below the warp's steps
  auto pair = [&](int i, auto diag_tag) {
    constexpr bool kDiag = decltype(diag_tag)::value;
    const int rt = row_of(i), vt = min(kR, L - rt * kR);
    const int j0 = kDiag ? 2 * warp : 0;   // n-tiles j0 .. 7
    const float* dt = dst(i);
    const float* ctl = cst(i);
    const float* mt = mst(i);
    const float* cbt = cb_c + (rt * (rt + 1) / 2 + st) * (kR * kR);
#pragma unroll 1
    for (int jb = j0 & ~(S::JH - 1); jb < 8; jb += S::JH) {
      const int l0 = kDiag ? max(0, j0 - jb) : 0;   // first live n-tile
      // their scores at the accumulator's places, CB[t][s], loaded ahead
      // of D^T
      float cbv[S::JH][4];
#pragma unroll
      for (int jl = 0; jl < S::JH; ++jl)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int q = 0; q < 2; ++q)
            cbv[jl][2 * e + q] = !kDiag || jl >= l0
                                     ? __ldg(cbt + (8 * (jb + jl) + 2 * t4 + q) * kR + rr[e])
                                     : 0.f;
      // D^T = x dy^T: A = x (rows s, k = p), B = dy (k = p, n = t)
      float d[1][S::JH][4];
#pragma unroll
      for (int jl = 0; jl < S::JH; ++jl)
#pragma unroll
        for (int q = 0; q < 4; ++q) d[0][jl][q] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < kPT / 8; ++kk) {
        const int pa = kk * 8 + t4;
        uint32_t ah[1][4], al[1][4], bh[S::JH][2], bl[S::JH][2];
        split_rz(xw[pa], ah[0][0], al[0][0]);
        split_rz(xw[8 * kFS + pa], ah[0][1], al[0][1]);
        split_rz(xw[pa + 4], ah[0][2], al[0][2]);
        split_rz(xw[8 * kFS + pa + 4], ah[0][3], al[0][3]);
#pragma unroll
        for (int jl = 0; jl < S::JH; ++jl) {
          if (kDiag && jl < l0) continue;
          const float* dr = dt + (8 * (jb + jl) + g) * kFS + pa;
          split_rz(dr[0], bh[jl][0], bl[jl][0]);
          split_rz(dr[4], bh[jl][1], bl[jl][1]);
        }
        mma3_cols<false>(d, ah, al, bh, bl, l0, S::JH);
      }
      // W^T, Q^T, the column sums of Z (t > s); dx += W^T dy, dB += Q^T C,
      // k-step j the 8 rows t of n-tile j in the permuted order
#pragma unroll
      for (int jl = 0; jl < S::JH; ++jl) {
        if (kDiag && jl < l0) continue;
        const int j = jb + jl;
        const float2 ctv = *reinterpret_cast<const float2*>(mt + 8 * j + 2 * t4);
        float w[4];
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int t = 8 * j + 2 * t4 + q;
            const bool live = ok[e] && t < vt && (!kDiag || rr[e] <= t);
            const float ex =
                exp2_approx(live ? ((q ? ctv.y : ctv.x) - cs[e]) * kLog2e : -INFINITY);
            const float wv = cbv[jl][2 * e + q] * ex;
            const float dv = d[0][jl][2 * e + q];
            if (!kDiag || rr[e] < t) cz[e] += dv * wv;
            w[2 * e + q] = wv;
            d[0][jl][2 * e + q] = dv * ex;
          }
        const int ta = 8 * j + 2 * t4;
        {
          uint32_t ah[1][4], al[1][4], bh[8][2], bl[8][2];
          acc_to_a(w, ah[0], al[0]);
          const float* dr = dt + ta * kFS + g;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            split_rz(dr[8 * jj], bh[jj][0], bl[jj][0]);
            split_rz(dr[kFS + 8 * jj], bh[jj][1], bl[jj][1]);
          }
          mma3(dxa, ah, al, bh, bl);
        }
        {
          uint32_t ah[1][4], al[1][4];
          acc_to_a(d[0][jl], ah[0], al[0]);
          const float* cr = ctl + ta * S::NS + g;
#pragma unroll
          for (int gi = 0; gi < S::NGRP; ++gi) {
            uint32_t bh[S::NG][2], bl[S::NG][2];
#pragma unroll
            for (int jj = 0; jj < S::NG; ++jj) {
              const int n = 8 * (gi * S::NG + jj);
              split_rz(cr[n], bh[jj][0], bl[jj][0]);
              split_rz(cr[S::NS + n], bh[jj][1], bl[jj][1]);
            }
            mma3(dba[gi], ah, al, bh, bl);
          }
        }
      }
    }
  };

  for (int i = 0; i < n_rt; ++i) {
    if (i + 1 < n_rt) cp_async_wait<1>();   // a later group may fly
    else cp_async_wait<0>();
    __syncthreads();                        // row tile row_of(i) landed
    if (i == n_rt - 1) pair(i, std::true_type());
    else pair(i, std::false_type());
    __syncthreads();                        // every warp is done with stage i
    if (i + 2 < n_rt) issue(i + 2);
  }

  float sg[2] = {0.f, 0.f};
  if (c < nc - 1) {   // the state terms of G_c
    float* gs = ring;              // G_c [NT][kFS], in stage 0
    float* bs = ring + S::STAGE;   // B of the steps [kR][NS], in stage 1
    stage<float, kPairThreads, NT, kPT, kFS>(
        gs, g_ws + ((static_cast<int64_t>(b) * (nc - 1) + c) * H + h) * (NT * kPT), kPT, NT, kPT,
        true, tid);
    stage<float, kPairThreads, kR, NT, S::NS>(bs, Bm + (row0 + s0) * N, N, vs, N, vec_b, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // bg = B_s G: A = B (rows s, k = n), B(k = n, n = p) = G[n][p]
    float bg[1][8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) bg[0][j][q] = 0.f;
    const float* bw = bs + (16 * warp + g) * S::NS;
#pragma unroll 1
    for (int kk = 0; kk < NT / 8; ++kk) {
      const int na = kk * 8 + t4;
      uint32_t ah[1][4], al[1][4], bh[8][2], bl[8][2];
      split_rz(bw[na], ah[0][0], al[0][0]);
      split_rz(bw[8 * S::NS + na], ah[0][1], al[0][1]);
      split_rz(bw[na + 4], ah[0][2], al[0][2]);
      split_rz(bw[8 * S::NS + na + 4], ah[0][3], al[0][3]);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        split_rz(gs[na * kFS + 8 * jj + g], bh[jj][0], bl[jj][0]);
        split_rz(gs[(na + 4) * kFS + 8 * jj + g], bh[jj][1], bl[jj][1]);
      }
      mma3(bg, ah, al, bh, bl);
    }
    // u = x_s G^T: A = x (k = p), B(k = p, n) = G[n][p]
    float u[S::NGRP][1][S::NG][4];
#pragma unroll
    for (int gi = 0; gi < S::NGRP; ++gi)
#pragma unroll
      for (int j = 0; j < S::NG; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) u[gi][0][j][q] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < kPT / 8; ++kk) {
      const int pa = kk * 8 + t4;
      uint32_t ah[1][4], al[1][4];
      split_rz(xw[pa], ah[0][0], al[0][0]);
      split_rz(xw[8 * kFS + pa], ah[0][1], al[0][1]);
      split_rz(xw[pa + 4], ah[0][2], al[0][2]);
      split_rz(xw[8 * kFS + pa + 4], ah[0][3], al[0][3]);
#pragma unroll
      for (int gi = 0; gi < S::NGRP; ++gi) {
        uint32_t bh[S::NG][2], bl[S::NG][2];
#pragma unroll
        for (int jj = 0; jj < S::NG; ++jj) {
          const float* gr = gs + (8 * (gi * S::NG + jj) + g) * kFS + pa;
          split_rz(gr[0], bh[jj][0], bl[jj][0]);
          split_rz(gr[4], bh[jj][1], bl[jj][1]);
        }
        mma3(u[gi], ah, al, bh, bl);
      }
    }
    const float last = cum[L - 1];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float es = ok[e] ? expf(last - cs[e]) : 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          dxa[0][jj][2 * e + q] = fmaf(es, bg[0][jj][2 * e + q], dxa[0][jj][2 * e + q]);
      const float* br = bw + 8 * e * S::NS + 2 * t4;
#pragma unroll
      for (int jj = 0; jj < S::NJ; ++jj)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float uv = u[jj / S::NG][0][jj % S::NG][2 * e + q];
          float& acc = dba[jj / S::NG][0][jj % S::NG][2 * e + q];
          acc = fmaf(es, uv, acc);
          sg[e] = fmaf(br[8 * jj + q], uv, sg[e]);
        }
      sg[e] = quad_sum(sg[e]) * es;
    }
  }

  const int64_t plane = static_cast<int64_t>(B) * H * nc * Lpad;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float czs = quad_sum(cz[e]);
    if (!ok[e]) continue;
    const int s = s0 + rr[e];
    if (t4 == 0) {
      part_ws[2 * plane + lane_off + s] = czs;
      part_ws[3 * plane + lane_off + s] = sg[e];
    }
    float* xo = dx + ((row0 + s) * H + h) * static_cast<int64_t>(P);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int p = 8 * jj + 2 * t4;
      if (p >= P) continue;
      if ((P & 1) == 0) {
        *reinterpret_cast<float2*>(xo + p) = make_float2(dxa[0][jj][2 * e], dxa[0][jj][2 * e + 1]);
      } else {
        xo[p] = dxa[0][jj][2 * e];
        if (p + 1 < P) xo[p + 1] = dxa[0][jj][2 * e + 1];
      }
    }
    float* bo = dB_part + ((row0 + s) * H + h) * N;
#pragma unroll
    for (int jj = 0; jj < S::NJ; ++jj) {
      const int n = 8 * jj + 2 * t4;
      if (n >= N) continue;
      const float* v = dba[jj / S::NG][0][jj % S::NG];
      if ((N & 1) == 0) {
        *reinterpret_cast<float2*>(bo + n) = make_float2(v[2 * e], v[2 * e + 1]);
      } else {
        bo[n] = v[2 * e];
        if (n + 1 < N) bo[n + 1] = v[2 * e + 1];
      }
    }
  }
}

// The sum of v over the block's kBT threads, in a fixed order (a warp's
// butterfly, then the warps in order); every thread gets it.
__device__ __forceinline__ double block_sum(double v, double* wred) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();   // wred is free
  if (lane == 0) wred[warp] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < kBT / 32; ++w) s += wred[w];
  return s;
}

// grid (nc, H, B), kBT threads: dlam of chunk c of lane (b, h). With a_t
// = iota_t, b_t = sum_s Z_ts - sum_t' Z_t't (planes 0 - 2) and sigma_t
// (plane 3), in float64: dlam_0 = sum_t a_t + gh, and for i >= 1 dlam_i =
// sum_{t>=i} (a_t + b_t) + sum_{s<i} sigma_s + gh, gh = exp(cum_last)
// <G_c, h_c>. Each thread scans a run of ceil(L / kBT) steps; a warp's
// runs are scanned with shuffles and the warps' totals added in order
// (as chunk_scan), so the sums' order is fixed.
__global__ void __launch_bounds__(kBT)
    ssd_bwd_dlam_kernel(const float* __restrict__ cum_ws, const float* __restrict__ part_ws,
                        const float* __restrict__ g_ws, const float* __restrict__ h_ws,
                        float* __restrict__ dlam, int B, int T_len, int H, int L, int nc,
                        int elems) {
  __shared__ double wred[kBT / 32], wab[kBT / 32], wsg[kBT / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Lpad = (L + kR - 1) / kR * kR;
  const int64_t lane_off = ((static_cast<int64_t>(b) * H + h) * nc + c) * Lpad;
  const int64_t plane = static_cast<int64_t>(B) * H * nc * Lpad;
  const float* rowz = part_ws + lane_off;
  const float* iota = rowz + plane;
  const float* colz = rowz + 2 * plane;
  const float* sig = rowz + 3 * plane;
  double gh = 0.0;
  if (c > 0 && c < nc - 1) {   // h_0 = 0 and G_{nc-1} = 0
    const float* gp = g_ws + ((static_cast<int64_t>(b) * (nc - 1) + c) * H + h) * elems;
    const float* hp = h_ws + ((static_cast<int64_t>(b) * (nc - 1) + c - 1) * H + h) * elems;
    double s = 0.0;
    for (int i = tid; i < elems; i += kBT) s += static_cast<double>(gp[i]) * hp[i];
    gh = static_cast<double>(expf(cum_ws[lane_off + L - 1])) * block_sum(s, wred);
  }
  const int seg = (L + kBT - 1) / kBT;
  const int i0 = min(tid * seg, L), i1 = min(i0 + seg, L);
  double ab = 0.0, sg = 0.0, bb = 0.0;
  for (int t = i0; t < i1; ++t) {
    const double bt = static_cast<double>(rowz[t]) - static_cast<double>(colz[t]);
    ab += static_cast<double>(iota[t]) + bt;
    sg += static_cast<double>(sig[t]);
    bb += bt;
  }
  double iab = ab, isg = sg;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double va = __shfl_up_sync(0xffffffffu, iab, off);
    const double vs = __shfl_up_sync(0xffffffffu, isg, off);
    if (lane >= off) {
      iab += va;
      isg += vs;
    }
  }
  double run_ab = __shfl_up_sync(0xffffffffu, iab, 1);
  double run_sg = __shfl_up_sync(0xffffffffu, isg, 1);
  if (lane == 0) run_ab = run_sg = 0.0;
  if (lane == 31) {
    wab[warp] = iab;
    wsg[warp] = isg;
  }
  const double tot_b = block_sum(bb, wred);   // its barriers publish wab and wsg
  double tot_ab = 0.0;
  for (int w = 0; w < kBT / 32; ++w) {
    if (w < warp) {
      run_ab += wab[w];
      run_sg += wsg[w];
    }
    tot_ab += wab[w];
  }
  float* out = dlam + (static_cast<int64_t>(b) * T_len + static_cast<int64_t>(c) * L) * H + h;
  for (int t = i0; t < i1; ++t) {
    const double v = (t == 0 ? tot_ab - tot_b : tot_ab - run_ab) + run_sg + gh;
    out[static_cast<int64_t>(t) * H] = static_cast<float>(v);
    run_ab += static_cast<double>(iota[t]) +
              (static_cast<double>(rowz[t]) - static_cast<double>(colz[t]));
    run_sg += static_cast<double>(sig[t]);
  }
}

// grid (ceil(B T N / 256), 2), 256 threads: dB (blockIdx.y 0) or dC (1)
// of one (b, t, n) each, the per-head partials (B, T, H, N) summed in
// head order.
__global__ void __launch_bounds__(kBT)
    ssd_bwd_headsum_kernel(const float* __restrict__ dB_part, const float* __restrict__ dC_part,
                           float* __restrict__ dB, float* __restrict__ dC, int64_t rows, int H,
                           int N) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBT + threadIdx.x;
  if (i >= rows * N) return;
  const int64_t r = i / N, n = i % N;
  const float* src = (blockIdx.y == 0 ? dB_part : dC_part) + r * H * N + n;
  float s = 0.f;
  for (int h = 0; h < H; ++h) s += src[static_cast<int64_t>(h) * N];
  (blockIdx.y == 0 ? dB : dC)[i] = s;
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

struct Args {
  const float* lam;
  const void *Bm, *Cm, *x;
  float *y, *cum_ws, *cb_ws, *h_ws;
  int B, T, H, N, P, L, nc;
  bool vec_b, vec_x;
  cudaStream_t st;
};

// Raise a kernel's dynamic shared memory limit once per device and
// template instance (the flags and results are the caller's statics);
// later launches take the first call's result without a driver call.
template <typename K>
cudaError_t allow_smem(K kern, int smem, std::once_flag* flags, cudaError_t* results) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(flags[dev], [&] {
    results[dev] = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  });
  return results[dev];
}

template <typename T, int NT, int HT>
cudaError_t launch_out(const Args& a) {
  using S = OutCfg<T, NT, HT>;
  static std::once_flag flags[kMaxDevices];
  static cudaError_t results[kMaxDevices];
  auto kern = ssd_out_kernel<T, NT, HT>;
  cudaError_t err = allow_smem(kern, S::BYTES, flags, results);
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>((a.L + kR - 1) / kR) * a.nc * a.B * (a.H / HT);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(blocks), S::NTH, S::BYTES, a.st>>>(
      static_cast<const T*>(a.Cm), static_cast<const T*>(a.x), a.cum_ws, a.cb_ws, a.h_ws, a.y,
      a.B, a.T, a.H, a.N, a.P, a.L, a.nc, a.vec_b, a.vec_x);
  return cudaGetLastError();
}

template <typename T, int NT, int KH>
cudaError_t launch_state(const Args& a) {
  using S = StateCfg<T, NT, KH>;
  static std::once_flag flags[kMaxDevices];
  static cudaError_t results[kMaxDevices];
  auto kern = ssd_state_kernel<T, NT, KH>;
  cudaError_t err = allow_smem(kern, S::BYTES, flags, results);
  if (err != cudaSuccess) return err;
  kern<<<dim3(static_cast<unsigned>(a.nc), static_cast<unsigned>(a.H / KH),
              static_cast<unsigned>(a.B)),
         kStateThreads, S::BYTES, a.st>>>(
      a.lam, static_cast<const T*>(a.Bm), static_cast<const T*>(a.Cm),
      static_cast<const T*>(a.x), a.cum_ws, a.cb_ws, a.h_ws, a.T, a.H, a.N, a.P, a.L, a.nc,
      a.vec_b, a.vec_x);
  return cudaGetLastError();
}

// The three kernels; the state kernel and the output kernel take the same
// head tile (2 heads a block, or 1).
template <typename T, int NT>
cudaError_t launch(const Args& a, int head_tile) {
  cudaError_t err = head_tile == 2 ? launch_state<T, NT, 2>(a) : launch_state<T, NT, 1>(a);
  if (err != cudaSuccess) return err;
  if (a.nc > 1) {
    constexpr int elems = NT * kPT;
    ssd_handoff_kernel<<<dim3(elems / kStateThreads, static_cast<unsigned>(a.H),
                              static_cast<unsigned>(a.B)),
                         kStateThreads, 0, a.st>>>(a.cum_ws, a.h_ws, a.H, a.L, a.nc, elems);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return head_tile == 2 ? launch_out<T, NT, 2>(a) : launch_out<T, NT, 1>(a);
}

template <typename T>
cudaError_t dispatch_n(const Args& a, int head_tile) {
  if (a.N <= 16) return launch<T, 16>(a, head_tile);
  if (a.N <= 32) return launch<T, 32>(a, head_tile);
  if (a.N <= 64) return launch<T, 64>(a, head_tile);
  return launch<T, 128>(a, head_tile);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

struct BwdArgs {
  const float *Bm, *Cm, *x, *dy, *cum_ws, *cb_ws, *h_ws;
  float *dlam, *dB, *dC, *dx, *g_ws, *part_ws, *dB_part, *dC_part;
  int B, T, H, N, P, L, nc;
  bool vec_b, vec_x;
  cudaStream_t st;
};

// The backward's kernels in order: the increments and the reverse
// hand-off of G (two chunks or more), the row and column kernels, dlam,
// and the head sums of dB and dC.
template <int NT>
cudaError_t launch_bwd(const BwdArgs& a) {
  using S = BwdCfg<NT>;
  static std::once_flag flags[3][kMaxDevices];
  static cudaError_t results[3][kMaxDevices];
  constexpr int elems = NT * kPT;
  cudaError_t err;
  if (a.nc > 1) {
    auto state = ssd_bwd_state_kernel<NT>;
    err = allow_smem(state, S::STATE_BYTES, flags[0], results[0]);
    if (err != cudaSuccess) return err;
    state<<<dim3(static_cast<unsigned>(a.nc - 1), static_cast<unsigned>(a.H),
                 static_cast<unsigned>(a.B)),
            kStateThreads, S::STATE_BYTES, a.st>>>(a.Cm, a.dy, a.cum_ws, a.g_ws, a.T, a.H, a.N,
                                                   a.P, a.L, a.nc, a.vec_b, a.vec_x);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ssd_bwd_handoff_kernel<<<dim3(elems / kStateThreads, static_cast<unsigned>(a.H),
                                  static_cast<unsigned>(a.B)),
                             kStateThreads, 0, a.st>>>(a.cum_ws, a.g_ws, a.H, a.L, a.nc, elems);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int64_t blocks = static_cast<int64_t>((a.L + kR - 1) / kR) * a.H * a.B * a.nc;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto row = ssd_bwd_row_kernel<NT>;
  err = allow_smem(row, S::PAIR_BYTES, flags[1], results[1]);
  if (err != cudaSuccess) return err;
  row<<<static_cast<unsigned>(blocks), kPairThreads, S::PAIR_BYTES, a.st>>>(
      a.Bm, a.Cm, a.x, a.dy, a.cum_ws, a.cb_ws, a.h_ws, a.dC_part, a.part_ws, a.B, a.T, a.H, a.N,
      a.P, a.L, a.nc, a.vec_b, a.vec_x);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto col = ssd_bwd_col_kernel<NT>;
  err = allow_smem(col, S::PAIR_BYTES, flags[2], results[2]);
  if (err != cudaSuccess) return err;
  col<<<static_cast<unsigned>(blocks), kPairThreads, S::PAIR_BYTES, a.st>>>(
      a.Bm, a.Cm, a.x, a.dy, a.cum_ws, a.cb_ws, a.g_ws, a.dx, a.dB_part, a.part_ws, a.B, a.T, a.H,
      a.N, a.P, a.L, a.nc, a.vec_b, a.vec_x);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_dlam_kernel<<<dim3(static_cast<unsigned>(a.nc), static_cast<unsigned>(a.H),
                             static_cast<unsigned>(a.B)),
                        kBT, 0, a.st>>>(a.cum_ws, a.part_ws, a.g_ws, a.h_ws, a.dlam, a.B, a.T,
                                        a.H, a.L, a.nc, elems);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t rows = static_cast<int64_t>(a.B) * a.T;
  const int64_t sum_blocks = (rows * a.N + kBT - 1) / kBT;
  if (sum_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ssd_bwd_headsum_kernel<<<dim3(static_cast<unsigned>(sum_blocks), 2), kBT, 0, a.st>>>(
      a.dB_part, a.dC_part, a.dB, a.dC, rows, a.H, a.N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// lam (B, T, H) fp32; Bm, Cm (B, T, N) and x (B, T, H, P) row-major of
// `dtype`; y (B, T, H, P) fp32. Workspaces, fp32, 16-byte aligned, with
// nc = T / L chunks, Lpad = L rounded up to 64, RT = Lpad / 64 and N_pad
// = N rounded up to 16, 32, 64 or 128: cum_ws (B, H, nc, Lpad), cb_ws
// (B, nc, RT (RT + 1) / 2, 64, 64) and, when nc > 1, h_ws (B, nc - 1, H,
// N_pad, 64). 1 <= N <= 128, 1 <= P <= 64, head_tile 1 or 2 dividing
// H (at most 2 when N > 64). Three kernels on `stream` (two when nc = 1).
int ssd_chunk_fwd(const void* lam, const void* Bm, const void* Cm, const void* x, void* y,
                  void* cum_ws, void* cb_ws, void* h_ws, int64_t B, int64_t T_len, int64_t H,
                  int64_t N, int64_t P, int64_t L, int64_t head_tile, int64_t dtype,
                  void* stream) {
  if (B <= 0 || B > 65535 || T_len <= 0 || T_len > 0x7fffffffLL || H <= 0 || H > 65535 ||
      N < 1 || N > 128 || P < 1 || P > kPT || L <= 0 || T_len % L != 0 ||
      T_len / L > 0x7fffffffLL || (head_tile != 1 && head_tile != 2) ||
      H % head_tile != 0 || !aligned16(cum_ws) || !aligned16(cb_ws) ||
      (T_len > L && (h_ws == nullptr || !aligned16(h_ws))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t elem = dtype == kF32 ? 4 : 2;
  const int64_t epc = 16 / elem;   // elements a 16-byte copy
  const bool vec_b = N % epc == 0 && aligned16(Bm) && aligned16(Cm);
  const bool vec_x = P % epc == 0 && aligned16(x);
  if (elem == 2 && !(vec_b && vec_x)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const float*>(lam),
         Bm,
         Cm,
         x,
         static_cast<float*>(y),
         static_cast<float*>(cum_ws),
         static_cast<float*>(cb_ws),
         static_cast<float*>(h_ws),
         static_cast<int>(B),
         static_cast<int>(T_len),
         static_cast<int>(H),
         static_cast<int>(N),
         static_cast<int>(P),
         static_cast<int>(L),
         static_cast<int>(T_len / L),
         vec_b,
         vec_x,
         static_cast<cudaStream_t>(stream)};
  const int ht = static_cast<int>(head_tile);
  switch (dtype) {
    case kF32: return static_cast<int>(dispatch_n<float>(a, ht));
    case kBF16: return static_cast<int>(dispatch_n<__nv_bfloat16>(a, ht));
    case kF16: return static_cast<int>(dispatch_n<__half>(a, ht));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The gradients of ssd_chunk_fwd's y against dy (B, T, H, P), all fp32
// and row-major: Bm, Cm (B, T, N) and x (B, T, H, P) as the forward took
// them, and the forward's cum_ws, cb_ws and (when nc > 1) h_ws, holding
// its prefix sums, scores and chunk-start states. Outputs dlam (B, T, H),
// dBm, dCm (B, T, N), dx (B, T, H, P). Workspaces, fp32: g_ws (B, nc - 1,
// H, N_pad, 64) when nc > 1 (16-byte aligned), part_ws (4, B, H, nc,
// Lpad), dB_part and dC_part (B, T, H, N). 1 <= N <= 128, 1 <= P <= 64.
// Six kernels on `stream` (four when nc = 1).
int ssd_chunk_bwd(const void* Bm, const void* Cm, const void* x, const void* dy,
                  const void* cum_ws, const void* cb_ws, const void* h_ws, void* dlam, void* dBm,
                  void* dCm, void* dx, void* g_ws, void* part_ws, void* dB_part, void* dC_part,
                  int64_t B, int64_t T_len, int64_t H, int64_t N, int64_t P, int64_t L,
                  void* stream) {
  if (B <= 0 || B > 65535 || T_len <= 0 || T_len > 0x7fffffffLL || H <= 0 || H > 65535 ||
      N < 1 || N > 128 || P < 1 || P > kPT || L <= 0 || T_len % L != 0 ||
      !aligned16(cum_ws) || !aligned16(cb_ws) ||
      (T_len > L && (h_ws == nullptr || g_ws == nullptr || !aligned16(h_ws) ||
                     !aligned16(g_ws))))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_b = N % 4 == 0 && aligned16(Bm) && aligned16(Cm);
  const bool vec_x = P % 4 == 0 && aligned16(x) && aligned16(dy);
  BwdArgs a{static_cast<const float*>(Bm),
            static_cast<const float*>(Cm),
            static_cast<const float*>(x),
            static_cast<const float*>(dy),
            static_cast<const float*>(cum_ws),
            static_cast<const float*>(cb_ws),
            static_cast<const float*>(h_ws),
            static_cast<float*>(dlam),
            static_cast<float*>(dBm),
            static_cast<float*>(dCm),
            static_cast<float*>(dx),
            static_cast<float*>(g_ws),
            static_cast<float*>(part_ws),
            static_cast<float*>(dB_part),
            static_cast<float*>(dC_part),
            static_cast<int>(B),
            static_cast<int>(T_len),
            static_cast<int>(H),
            static_cast<int>(N),
            static_cast<int>(P),
            static_cast<int>(L),
            static_cast<int>(T_len / L),
            vec_b,
            vec_x,
            static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (N <= 16) err = launch_bwd<16>(a);
  else if (N <= 32) err = launch_bwd<32>(a);
  else if (N <= 64) err = launch_bwd<64>(a);
  else err = launch_bwd<128>(a);
  return static_cast<int>(err);
}

}  // extern "C"
