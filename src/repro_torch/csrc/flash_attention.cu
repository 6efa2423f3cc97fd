// Causal GQA flash attention (prefill) for Hopper (sm_90a).
//
// flash_attn_fwd replaces repro/kernels/flash_attention/kernel.py
// flash_attention (the pallas_call at :116, body _flash_kernel :26-76):
//     out[b, t, h] = softmax_s(q[b, t, h] * hd^-0.5 . k[b, s, h / group])
//                    . v[b, s, h / group]
// over the keys s that are live for query t: s <= t, and t - s < window
// when window > 0. q (B, T, nq, hd), k / v (B, S, nkv, hd)
// row-major in fp32, bf16 or fp16; out (B, T, nq, hd) in q's dtype.
//
// Numerics follow the TPU kernel, not the model's blockwise path: q, k
// and v are upcast to fp32 and q is scaled BEFORE the dot; the online
// softmax (running max m, denominator l, fp32 accumulator) is fp32, with
// the -1e30 sentinel of the reference. A row whose first live tile holds
// only masked keys accumulates p = exp(-1e30 - -1e30) = 1 there, and the
// next tile's alpha = exp(-1e30 - m) = 0 wipes it, as on the TPU; with
// -inf that would be NaN. Out-of-range key rows are zero-filled in
// shared memory, so they add 0, never NaN.
//
// Bound: operations. Causal attention does 4 * hd FLOPs per live score
// against 2 * (nq + nkv) * hd bytes of q, k, v and out per token, so at
// the Qwen2 / Gemma3 prefill shapes the FLOPs dominate in every dtype.
// What the design does about it (a first, simple kernel; tensor cores,
// wgmma and TMA are left for later work):
//   * one block of 256 threads owns a BQ = 64-row query tile of one
//     (batch, q head); the kv head is h / group, so K / V are never
//     duplicated (GQA, any group, including Qwen2's 7);
//   * K / V tiles of BK keys (64, or 32 at hd 256 so the tiles fit the
//     227 KB of shared memory) are staged in shared memory as fp32, K
//     transposed, so each thread's 4 x KN score micro-tile and 4 x hd/16
//     output micro-tile read 16-byte vectors: two shared loads feed 16
//     FMAs in both products;
//   * the online softmax state lives in registers; row max and sum are
//     reduced over the 16 threads of a row with warp shuffles;
//   * tiles that are fully masked (above the causal diagonal, or wholly
//     before the window) are never loaded: the key loop runs over the
//     live tile range only, and later query tiles launch first to even
//     out the causal triangle;
//   * ragged T and S are masked in the kernel (no shape is refused).
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
constexpr int kBQ = 64;
constexpr float kNegInf = -1e30f;

enum DType : int64_t { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

template <int HD>
struct Cfg {
  static constexpr int BK = HD <= 128 ? 64 : 32;   // keys per tile
  static constexpr int KN = BK / 16;               // keys per thread (scores)
  static constexpr int DPT = HD / 16;              // dims per thread (output)
  static constexpr int VW = DPT < 4 ? DPT : 4;     // vector width of a dim run
  static constexpr int NC = DPT / VW;              // dim runs per thread
  static constexpr int QP = kBQ + 4;               // padded row: qT, pT
  static constexpr int KP = BK + 4;                // padded row: kT
  static constexpr int SMEM_FLOATS = HD * QP + HD * KP + BK * HD + BK * QP;
};

// N floats from shared memory as one 8- or 16-byte load.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[N]) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

// grid (ceil(T / BQ), nq, B); blockDim 256 = 16 row groups x 16 columns.
// Thread (ty, tx) owns query rows ty*4 .. ty*4+3 of the tile, keys
// tx*KN .. tx*KN+KN-1 of each key tile, and output dims
// c*16*VW + tx*VW + e (c < NC, e < VW).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int64_t T_len,
                 int64_t S_len, int nq, int nkv, int64_t window,
                 float scale) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK, KN = C::KN, DPT = C::DPT, VW = C::VW, NC = C::NC;
  constexpr int QP = C::QP, KP = C::KP;
  extern __shared__ float4 smem_raw[];
  float* qT = reinterpret_cast<float*>(smem_raw);   // [HD][QP], scaled q
  float* kT = qT + HD * QP;                          // [HD][KP]
  float* vs = kT + HD * KP;                          // [BK][HD]
  float* pT = vs + BK * HD;                          // [BK][QP]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int qt = gridDim.x - 1 - blockIdx.x;         // late tiles first
  const int h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int group = nq / nkv;
  const int kvh = h / group;
  const int64_t q0 = static_cast<int64_t>(qt) * kBQ;
  const int64_t q_last = min(q0 + kBQ, T_len) - 1;

  // q tile, transposed and scaled; rows past T are zero
  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int64_t t = q0 + r;
    float x = 0.f;
    if (t < T_len) x = to_f32(q[((b * T_len + t) * nq + h) * HD + d]) * scale;
    qT[d * QP + r] = x;
  }

  // live key tiles: [kt_lo, kt_hi)
  const int64_t n_kt = (S_len + BK - 1) / BK;
  const int64_t kt_hi = min(n_kt, q_last / BK + 1);
  int64_t kt_lo = 0;
  if (window > 0) {
    const int64_t first = q0 - window + 1;  // first key the first row sees
    if (first > 0) kt_lo = first / BK;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  for (int64_t kt = kt_lo; kt < kt_hi; ++kt) {
    const int64_t k0 = kt * BK;
    __syncthreads();   // previous tile's kT / vs / pT fully read
    for (int idx = tid; idx < BK * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD;
      const int64_t s = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (s < S_len) {
        const int64_t off = ((b * S_len + s) * nkv + kvh) * HD + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      kT[d * KP + j] = kx;
      vs[j * HD + d] = vx;
    }
    __syncthreads();

    // scores: s[i][jj] = q[row i] . k[key jj]
    float sc[4][KN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < KN; ++jj) sc[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], kb[KN];
      load_vec<4>(qT + d * QP + ty * 4, qa);
      load_vec<KN>(kT + d * KP + tx * KN, kb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < KN; ++jj) sc[i][jj] = fmaf(qa[i], kb[jj], sc[i][jj]);
    }

    // mask, online softmax, P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t t = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < KN; ++jj) {
        const int64_t s = k0 + tx * KN + jj;
        bool live = s < S_len && s <= t;
        if (window > 0) live = live && (t - s < window);
        if (!live) sc[i][jj] = kNegInf;
        mx = fmaxf(mx, sc[i][jj]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < KN; ++jj) {
        sc[i][jj] = expf(sc[i][jj] - m_new);
        rs += sc[i][jj];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int jj = 0; jj < KN; ++jj)
      *reinterpret_cast<float4*>(pT + (tx * KN + jj) * QP + ty * 4) =
          make_float4(sc[0][jj], sc[1][jj], sc[2][jj], sc[3][jj]);
    __syncthreads();

    // acc[i][dims] += sum_j p[i][j] * v[j][dims]
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pa[4];
      load_vec<4>(pT + j * QP + ty * 4, pa);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float vb[VW];
        load_vec<VW>(vs + j * HD + c * 16 * VW + tx * VW, vb);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < VW; ++e)
            acc[i][c * VW + e] = fmaf(pa[i], vb[e], acc[i][c * VW + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t t = q0 + ty * 4 + i;
    if (t >= T_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* row = out + ((b * T_len + t) * nq + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        row[c * 16 * VW + tx * VW + e] = from_f32<T>(acc[i][c * VW + e] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int64_t B, int64_t T_len, int64_t S_len, int64_t nq,
                   int64_t nkv, int64_t window, float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * Cfg<HD>::SMEM_FLOATS;
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((T_len + kBQ - 1) / kBQ),
                  static_cast<unsigned>(nq), static_cast<unsigned>(B));
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), T_len, S_len, static_cast<int>(nq),
      static_cast<int>(nkv), window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* out,
                        int64_t B, int64_t T_len, int64_t S_len, int64_t nq,
                        int64_t nkv, int64_t hd, int64_t window, float scale,
                        cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, T_len, S_len, nq, nkv, window, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, out, B, T_len, S_len, nq, nkv, window, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, out, B, T_len, S_len, nq, nkv, window, scale, st);
    case 256:
      return launch<T, 256>(q, k, v, out, B, T_len, S_len, nq, nkv, window, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, T, nq, hd), k / v (B, S, nkv, hd), out (B, T, nq, hd), all
// row-major of `dtype`; hd in {32, 64, 128, 256}; nq a multiple of nkv;
// window 0 = none.
int flash_attn_fwd(const void* q, const void* k, const void* v, void* out,
                   int64_t B, int64_t T_len, int64_t S_len, int64_t nq,
                   int64_t nkv, int64_t hd, int64_t dtype, int64_t window,
                   void* stream) {
  if (B <= 0 || T_len <= 0 || S_len <= 0 || nkv <= 0 || nq % nkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = static_cast<float>(pow(static_cast<double>(hd), -0.5));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(dispatch_hd<float>(q, k, v, out, B, T_len, S_len, nq, nkv,
                                                 hd, window, scale, st));
    case kBF16:
      return static_cast<int>(dispatch_hd<__nv_bfloat16>(q, k, v, out, B, T_len, S_len,
                                                         nq, nkv, hd, window, scale, st));
    case kF16:
      return static_cast<int>(dispatch_hd<__half>(q, k, v, out, B, T_len, S_len, nq,
                                                  nkv, hd, window, scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
