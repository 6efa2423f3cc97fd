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
// Bound: operations. Per lane and chunk the causal C B^T and W x take
// L(L+1)/2 * 2 * (N + P) FLOPs and C h, B^T x 4 * L * N * P, against
// 4 * H * P bytes of x and y per step: at the Zamba2-1.2B layer (L = 256,
// N = P = 64) about 100 FLOPs per byte, so the fp32 rate on the CUDA
// cores is the limit. What the design does about it (a first, simple
// kernel; tensor cores come later):
//   * the TPU's sequential grid over chunks has no Hopper counterpart:
//     one block of 256 threads owns one lane and loops over its chunks,
//     the (N, P) state carried in shared memory (16 KB at N = P = 64);
//   * the TPU holds the whole (L x L) decay tile (256 KB at L = 256);
//     here the chunk is cut into 64-step row tiles against 64-step
//     column tiles s <= t, as flash attention does, and tiles above the
//     diagonal are skipped. Each thread owns a 4 x 4 micro-tile of the
//     scores and of y, fed by 16-byte shared loads;
//   * any L: cum is scanned once per chunk into a small workspace in
//     device memory ((B * H, L) fp32, written and read by the same
//     block), so a row tile of L = 1000 reads its own cum and that of
//     each column tile; ragged tails are zero-filled in shared memory.
//     The prefix sums are taken in float64 and rounded to fp32 once (as
//     in the plain version): at |cum| ~ 20 (L = 256) two fp32 orders of
//     addition moved a y of magnitude ~1 by 2e-4, past the 1e-4
//     tolerance, and the decays exp(cum_t - cum_s) now carry one
//     rounding whatever the order;
//   * the mask is applied before exp: for s > t, cum_t - cum_s > 0 may
//     overflow to inf, and inf * 0 would be NaN;
//   * B and C are read through the batch index, never copied per head;
//   * the state update B^T x is accumulated while the last row tile
//     walks every column tile, so B and x are read once for it;
//   * every sum runs in a fixed order (no atomics): the same inputs give
//     the same bits.
// N may be up to 128 (padded to 16, 32, 64 or 128 in shared memory) and
// P up to 64 (padded to 64).
//
// The kernel allocates nothing; the entry point returns the
// cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kR = 64;        // steps per row / column tile
constexpr int kRP = kR + 4;   // padded row of a transposed tile
constexpr int kPT = 64;       // P padded to one tile width

enum DType : int64_t { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// Shared-memory layout in floats; every array starts on 16 bytes.
template <int NT>
struct Smem {
  static constexpr int CT = 0;                  // [NT][kRP] C of the row tile, transposed
  static constexpr int BT = CT + NT * kRP;      // [NT][kRP] B of the column tile, transposed
  static constexpr int XS = BT + NT * kRP;      // [kR][kPT] x of the column tile
  static constexpr int WT = XS + kR * kPT;      // [kR][kRP] W transposed: WT[s][t]
  static constexpr int HS = WT + kR * kRP;      // [NT][kPT] the carried state
  static constexpr int CUM_R = HS + NT * kPT;   // [kR] cum of the row tile
  static constexpr int CUM_C = CUM_R + kR;      // [kR] cum of the column tile
  static constexpr int DEC = CUM_C + kR;        // [kR] exp(cum_last - cum_s)
  static constexpr int FLOATS = DEC + kR;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// grid (B * H); blockDim 256 = 16 row groups x 16 column groups. Thread
// (ty, tx) owns steps ty*4 .. ty*4+3 of a row tile against steps
// tx*4 .. tx*4+3 of a column tile (scores) and columns tx*4 .. tx*4+3 of
// P (y), and state rows ty*NR .. ty*NR+NR-1 by columns tx*4 .. tx*4+3.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ lam, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, const T* __restrict__ x,
                 float* __restrict__ y, float* cum_ws, int64_t T_len, int H,
                 int N, int P, int64_t L) {
  using S = Smem<NT>;
  constexpr int NR = NT / 16;
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* cT = sm + S::CT;
  float* bT = sm + S::BT;
  float* xs = sm + S::XS;
  float* wT = sm + S::WT;
  float* hs = sm + S::HS;
  float* cum_r = sm + S::CUM_R;
  float* cum_c = sm + S::CUM_C;
  float* dec = sm + S::DEC;

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int64_t g = blockIdx.x;               // lane = b * H + h
  const int64_t b = g / H;
  const int h = static_cast<int>(g % H);
  float* cum = cum_ws + g * L;
  const int64_t nc = T_len / L;
  const int64_t n_tiles = (L + kR - 1) / kR;

  for (int idx = tid; idx < NT * kPT; idx += kThreads) hs[idx] = 0.f;

  for (int64_t c = 0; c < nc; ++c) {
    const int64_t tc = b * T_len + c * L;     // row of step 0 in (B * T)

    // cum over the chunk: 256 steps at a time are staged in shared
    // memory (in wT, free here), then one thread adds them in float64
    // and rounds each prefix to fp32 once, as the plain version does, so
    // the two agree whatever order a scan would add the steps in
    double run = 0.0;
    for (int64_t i0 = 0; i0 < L; i0 += kThreads) {
      const int64_t i = i0 + tid;
      wT[tid] = i < L ? lam[(tc + i) * H + h] : 0.f;
      __syncthreads();
      if (tid == 0) {
        const int n = static_cast<int>(L - i0 < kThreads ? L - i0 : kThreads);
        for (int k = 0; k < n; ++k) {
          run += static_cast<double>(wT[k]);
          cum[i0 + k] = static_cast<float>(run);
        }
      }
      __syncthreads();   // wT is reused; cum is visible to the block
    }
    const float cum_last = cum[L - 1];

    for (int64_t rt = 0; rt < n_tiles; ++rt) {
      const int64_t t0 = rt * kR;
      const bool last = rt == n_tiles - 1;
      __syncthreads();   // the previous row tile is done with cT, cum_r
      for (int idx = tid; idx < kR * NT; idx += kThreads) {
        const int r = idx / NT, n = idx % NT;
        const int64_t t = t0 + r;
        float v = 0.f;
        if (t < L && n < N) v = to_f32(Cm[(tc + t) * N + n]);
        cT[n * kRP + r] = v;
      }
      if (tid < kR) cum_r[tid] = t0 + tid < L ? cum[t0 + tid] : 0.f;

      float acc[4][4], sacc[NR][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;

      for (int64_t kt = 0; kt <= rt; ++kt) {
        const int64_t s0 = kt * kR;
        __syncthreads();   // the previous column tile is fully read
        for (int idx = tid; idx < kR * NT; idx += kThreads) {
          const int r = idx / NT, n = idx % NT;
          const int64_t s = s0 + r;
          float v = 0.f;
          if (s < L && n < N) v = to_f32(Bm[(tc + s) * N + n]);
          bT[n * kRP + r] = v;
        }
        for (int idx = tid; idx < kR * kPT; idx += kThreads) {
          const int r = idx / kPT, p = idx % kPT;
          const int64_t s = s0 + r;
          float v = 0.f;
          if (s < L && p < P) v = to_f32(x[((tc + s) * H + h) * P + p]);
          xs[r * kPT + p] = v;
        }
        if (tid < kR) {
          const int64_t s = s0 + tid;
          const float cs = s < L ? cum[s] : cum_last;
          cum_c[tid] = cs;
          dec[tid] = s < L ? expf(cum_last - cs) : 0.f;
        }
        __syncthreads();

        // scores: sc[i][j] = C_t . B_s
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
        for (int n = 0; n < NT; ++n) {
          const float4 a = ld4(cT + n * kRP + ty * 4);
          const float4 bb = ld4(bT + n * kRP + tx * 4);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], bv[j], sc[i][j]);
        }
        // W = scores * exp(cum_t - cum_s) where s <= t, else 0: the mask
        // selects before exp is taken, so no inf ever meets a 0
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int64_t t = t0 + ty * 4 + i;
            const int64_t s = s0 + tx * 4 + j;
            w[i] = (s <= t && t < L)
                       ? sc[i][j] * expf(cum_r[ty * 4 + i] - cum_c[tx * 4 + j])
                       : 0.f;
          }
          *reinterpret_cast<float4*>(wT + (tx * 4 + j) * kRP + ty * 4) =
              make_float4(w[0], w[1], w[2], w[3]);
        }
        __syncthreads();

        // y += W x
#pragma unroll 4
        for (int s = 0; s < kR; ++s) {
          const float4 wv = ld4(wT + s * kRP + ty * 4);
          const float4 xv = ld4(xs + s * kPT + tx * 4);
          const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
          const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wa[i], xa[j], acc[i][j]);
        }
        // the last row tile walks every column tile: accumulate the
        // chunk's state increment sum_s exp(cum_last - cum_s) B_s^T x_s
        if (last) {
#pragma unroll 4
          for (int s = 0; s < kR; ++s) {
            const float d = dec[s];
            const float4 xv = ld4(xs + s * kPT + tx * 4);
            const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int i = 0; i < NR; ++i) {
              const float bd = bT[(ty * NR + i) * kRP + s] * d;
#pragma unroll
              for (int j = 0; j < 4; ++j) sacc[i][j] = fmaf(bd, xa[j], sacc[i][j]);
            }
          }
        }
      }

      // the carried state: y += exp(cum_t) (C_t . h)
      {
        float ch[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ch[i][j] = 0.f;
#pragma unroll 8
        for (int n = 0; n < NT; ++n) {
          const float4 a = ld4(cT + n * kRP + ty * 4);
          const float4 hv = ld4(hs + n * kPT + tx * 4);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float hv4[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) ch[i][j] = fmaf(av[i], hv4[j], ch[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = expf(cum_r[ty * 4 + i]);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(e, ch[i][j], acc[i][j]);
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t t = t0 + ty * 4 + i;
        if (t >= L) continue;
        float* row = y + ((tc + t) * H + h) * P;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx * 4 + j;
          if (p < P) row[p] = acc[i][j];
        }
      }

      if (last) {
        __syncthreads();   // every thread has read the old state
        const float e_last = expf(cum_last);
#pragma unroll
        for (int i = 0; i < NR; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float* hp = hs + (ty * NR + i) * kPT + tx * 4 + j;
            *hp = fmaf(*hp, e_last, sacc[i][j]);
          }
        __syncthreads();   // the new state, before the next chunk reads it
      }
    }
  }
}

template <typename T, int NT>
cudaError_t launch(const float* lam, const void* Bm, const void* Cm,
                   const void* x, float* y, float* ws, int64_t B,
                   int64_t T_len, int64_t H, int64_t N, int64_t P, int64_t L,
                   cudaStream_t st) {
  const size_t smem = sizeof(float) * Smem<NT>::FLOATS;
  auto kern = ssd_chunk_kernel<T, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(B * H));
  kern<<<grid, kThreads, smem, st>>>(
      lam, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const T*>(x), y, ws, T_len, static_cast<int>(H),
      static_cast<int>(N), static_cast<int>(P), L);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(const float* lam, const void* Bm, const void* Cm,
                       const void* x, float* y, float* ws, int64_t B,
                       int64_t T_len, int64_t H, int64_t N, int64_t P,
                       int64_t L, cudaStream_t st) {
  if (N <= 16) return launch<T, 16>(lam, Bm, Cm, x, y, ws, B, T_len, H, N, P, L, st);
  if (N <= 32) return launch<T, 32>(lam, Bm, Cm, x, y, ws, B, T_len, H, N, P, L, st);
  if (N <= 64) return launch<T, 64>(lam, Bm, Cm, x, y, ws, B, T_len, H, N, P, L, st);
  return launch<T, 128>(lam, Bm, Cm, x, y, ws, B, T_len, H, N, P, L, st);
}

}  // namespace

extern "C" {

// lam (B, T, H) fp32; Bm, Cm (B, T, N) and x (B, T, H, P) row-major of
// `dtype`; y (B, T, H, P) fp32; ws (B * H, L) fp32 scratch. 1 <= N <= 128,
// 1 <= P <= 64, T a multiple of the chunk length L.
int ssd_chunk_fwd(const void* lam, const void* Bm, const void* Cm,
                  const void* x, void* y, void* ws, int64_t B, int64_t T_len,
                  int64_t H, int64_t N, int64_t P, int64_t L, int64_t dtype,
                  void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || N < 1 || N > 128 || P < 1 ||
      P > kPT || L <= 0 || T_len % L != 0 || B * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lam);
  float* yo = static_cast<float*>(y);
  float* w = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(
          dispatch_n<float>(l, Bm, Cm, x, yo, w, B, T_len, H, N, P, L, st));
    case kBF16:
      return static_cast<int>(dispatch_n<__nv_bfloat16>(l, Bm, Cm, x, yo, w, B,
                                                        T_len, H, N, P, L, st));
    case kF16:
      return static_cast<int>(
          dispatch_n<__half>(l, Bm, Cm, x, yo, w, B, T_len, H, N, P, L, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
