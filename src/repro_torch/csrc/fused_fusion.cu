// Weighted-sum fusion kernels for Hopper (sm_90a).
//
// fused_wsum replaces repro/kernels/fused_fusion/kernel.py
// weighted_sum_pallas:
//     out[p] = sum_i w[i] * u[i, p]   (u fp32 / bf16 / fp16, fp32 accumulator)
// fused_wsum_dequant replaces weighted_sum_dequant_pallas:
//     out[p] = sum_i w[i] * s[i, p / blk] * q[i, p]   (q int8, s fp32)
//
// Bound: device-memory bytes. Each element read feeds 2 FLOPs, far below
// the card's ~20 FLOP/byte fp32 knee, so the least time is the bytes of
// one pass over the inputs at the HBM rate. What the design does about
// it: one pass over the input, coalesced loads and 16-byte stores of
// the sums, the fp32 accumulator in registers, and no padded copy of the
// input: rows at or beyond n are never read and the ragged column tail
// takes a scalar path. fused_wsum: neighbouring threads own neighbouring
// 16-byte column vectors of a row. fused_wsum_dequant, whose fp32 output
// is 4x its int8 input: every warp store writes 512 contiguous bytes
// (whole sectors) and every warp load reads 128 (see kDqVec below).
//
// When the column tiles alone give too few blocks to fill the card, the
// wrapper splits the rows over gridDim.y: each split writes its partial
// sums to a (splits, P) fp32 workspace and a second kernel adds the
// splits in a fixed order -- no atomics, so results repeat bit for bit.
//
// All index arithmetic is 64-bit: a dense round can hold more than 2^31
// elements. The kernels allocate nothing; every entry point returns the
// cudaGetLastError() of its launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum DType : int64_t { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// VEC elements of T make one 16-byte load: 4 fp32 or 8 bf16 / fp16.
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

// This thread's VEC column sums, as 16-byte stores when the vector is
// whole and VECTOR holds (the row length is a multiple of VEC, so every
// row of the 16-byte aligned output or workspace starts aligned).
template <int VEC, bool VECTOR>
__device__ __forceinline__ void store_sums(float* dst, int64_t c0, int64_t P,
                                           const float (&acc)[VEC]) {
  if (VECTOR && c0 + VEC <= P) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4)
      *reinterpret_cast<float4*>(dst + c0 + k) =
          make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (c0 + k < P) dst[c0 + k] = acc[k];
  }
}

// Rows [r0, r1) of one split, columns [c0, c0 + VEC) of this thread.
template <typename T, bool VECTOR>
__global__ void __launch_bounds__(kThreads)
wsum_kernel(const T* __restrict__ u, const float* __restrict__ w,
            float* __restrict__ out, int64_t n, int64_t P,
            int64_t rows_per_split) {
  constexpr int VEC = Vec<T>::N;
  const int64_t c0 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  if (c0 >= P) return;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_per_split;
  const int64_t r1 = min(n, r0 + rows_per_split);
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;

  if (VECTOR && c0 + VEC <= P) {
    // P % VEC == 0 and u is 16-byte aligned: every row start is aligned
#pragma unroll 4
    for (int64_t i = r0; i < r1; ++i) {
      const float wi = w[i];
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(u + i * P + c0));
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] = fmaf(wi, to_f32(v[k]), acc[k]);
    }
  } else {
    for (int64_t i = r0; i < r1; ++i) {
      const float wi = w[i];
      const T* row = u + i * P;
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        if (c0 + k < P) acc[k] = fmaf(wi, to_f32(row[c0 + k]), acc[k]);
    }
  }
  store_sums<VEC, VECTOR>(out + static_cast<int64_t>(blockIdx.y) * P, c0, P,
                          acc);
}

// The dequant kernel's layout: a lane owns kDqVec adjacent columns per
// vector (one 4-byte load of codes, one 16-byte store of sums) and
// kDqVectors such vectors, 32 * kDqVec columns apart, so every warp load
// reads 128 contiguous bytes, every warp store writes 512 (whole 32-byte
// sectors), and a thread has kDqVectors independent loads a row in
// flight. A warp covers kDqWarpCols columns, a block kDqBlockCols.
constexpr int kDqVec = 4;
constexpr int kDqVectors = 4;
constexpr int kDqWarpCols = 32 * kDqVec * kDqVectors;
constexpr int kDqBlockCols = kThreads / 32 * kDqWarpCols;

// Where w[i] * s[i, b] is formed: once per row for the thread (blk a
// multiple of kDqWarpCols, so a warp's columns share one quantization
// block), once per row and vector (blk a multiple of kDqVec), or per
// element (any blk, codes read a byte at a time).
enum DqScale : int { kScaleThread = 0, kScaleVector = 1, kScaleElement = 2 };

// One 16-byte store. Written as a float4 assignment, the first vector's
// store left the compiler as four 4-byte stores (its sums did not sit in
// an aligned register quad); a PTX vector store cannot be split.
__device__ __forceinline__ void store_float4(float* p, const float (&v)[4]) {
  asm volatile("st.global.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3])
               : "memory");
}

template <int SCALE>
__global__ void __launch_bounds__(kThreads)
wsum_dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                    const float* __restrict__ w, float* __restrict__ out,
                    int64_t n, int64_t Pq, int64_t blk,
                    int64_t rows_per_split) {
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kDqBlockCols +
                     (threadIdx.x / 32) * kDqWarpCols +
                     (threadIdx.x % 32) * kDqVec;
  if (c0 >= Pq) return;
  const int64_t nb = Pq / blk;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows_per_split;
  const int64_t r1 = min(n, r0 + rows_per_split);
  float acc[kDqVectors][kDqVec];
#pragma unroll
  for (int v = 0; v < kDqVectors; ++v)
#pragma unroll
    for (int e = 0; e < kDqVec; ++e) acc[v][e] = 0.f;

  if (SCALE != kScaleElement) {
    // Pq is a multiple of kDqVec here, so a vector is whole or past Pq;
    // one past Pq reads no codes and takes the last block's scale
    int64_t b[kDqVectors];
#pragma unroll
    for (int v = 0; v < kDqVectors; ++v)
      b[v] = SCALE == kScaleThread ? c0 / blk
                                   : min((c0 + v * 32 * kDqVec) / blk, nb - 1);
    for (int64_t i = r0; i < r1; ++i) {
      const float wi = w[i];
      const int8_t* row = q + i * Pq + c0;
      const float* srow = s + i * nb;
      char4 code[kDqVectors];
#pragma unroll
      for (int v = 0; v < kDqVectors; ++v)
        code[v] = c0 + v * 32 * kDqVec < Pq
                      ? __ldg(reinterpret_cast<const char4*>(row) + v * 32)
                      : make_char4(0, 0, 0, 0);
      const float ws0 = wi * srow[b[0]];
#pragma unroll
      for (int v = 0; v < kDqVectors; ++v) {
        const float ws = SCALE == kScaleThread ? ws0 : wi * srow[b[v]];
        acc[v][0] = fmaf(ws, static_cast<float>(code[v].x), acc[v][0]);
        acc[v][1] = fmaf(ws, static_cast<float>(code[v].y), acc[v][1]);
        acc[v][2] = fmaf(ws, static_cast<float>(code[v].z), acc[v][2]);
        acc[v][3] = fmaf(ws, static_cast<float>(code[v].w), acc[v][3]);
      }
    }
  } else {
    for (int64_t i = r0; i < r1; ++i) {
      const float wi = w[i];
      const int8_t* row = q + i * Pq;
      const float* srow = s + i * nb;
#pragma unroll
      for (int v = 0; v < kDqVectors; ++v)
#pragma unroll
        for (int e = 0; e < kDqVec; ++e) {
          const int64_t c = c0 + v * 32 * kDqVec + e;
          if (c < Pq)
            acc[v][e] = fmaf(wi * srow[c / blk], static_cast<float>(row[c]),
                             acc[v][e]);
        }
    }
  }
  float* dst = out + static_cast<int64_t>(blockIdx.y) * Pq;
#pragma unroll
  for (int v = 0; v < kDqVectors; ++v) {
    const int64_t c = c0 + v * 32 * kDqVec;
    if (SCALE != kScaleElement) {
      if (c < Pq) store_float4(dst + c, acc[v]);
    } else {
#pragma unroll
      for (int e = 0; e < kDqVec; ++e)
        if (c + e < Pq) dst[c + e] = acc[v][e];
    }
  }
}

// out[p] = sum_{k < splits} ws[k, p], in split order.
__global__ void __launch_bounds__(kThreads)
reduce_splits_kernel(const float* __restrict__ ws, float* __restrict__ out,
                     int64_t splits, int64_t P) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= P) return;
  float acc = 0.f;
  for (int64_t k = 0; k < splits; ++k) acc += ws[k * P + p];
  out[p] = acc;
}

inline dim3 grid_for(int64_t cols, int vec, int64_t splits) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * vec;
  return dim3(static_cast<unsigned>((cols + per_block - 1) / per_block),
              static_cast<unsigned>(splits));
}

// With splits > 1 the partial kernel writes `ws` and this folds it into
// `out`; with one split the partial kernel already wrote `out`.
inline cudaError_t finish_splits(float* ws, float* out, int64_t splits,
                                 int64_t P, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const unsigned blocks = static_cast<unsigned>((P + kThreads - 1) / kThreads);
  reduce_splits_kernel<<<blocks, kThreads, 0, stream>>>(ws, out, splits, P);
  return cudaGetLastError();
}

template <typename T>
void launch_wsum(const void* u, const float* w, float* dst, int64_t n,
                 int64_t P, int64_t splits, int64_t rows_per_split,
                 bool vectorized, cudaStream_t stream) {
  const dim3 grid = grid_for(P, Vec<T>::N, splits);
  const T* up = static_cast<const T*>(u);
  if (vectorized)
    wsum_kernel<T, true><<<grid, kThreads, 0, stream>>>(up, w, dst, n, P,
                                                        rows_per_split);
  else
    wsum_kernel<T, false><<<grid, kThreads, 0, stream>>>(up, w, dst, n, P,
                                                         rows_per_split);
}

}  // namespace

extern "C" {

// u (n, P) row-major of `dtype`; w (n,) fp32; out (P,) fp32; ws
// (splits, P) fp32 scratch, unused when splits == 1; out and ws 16-byte
// aligned. `vectorized`
// promises P % (16 / itemsize) == 0 and a 16-byte aligned u.
int fused_wsum(const void* u, const void* w, void* out, void* ws, int64_t n,
               int64_t P, int64_t dtype, int64_t splits,
               int64_t rows_per_split, int64_t vectorized, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  float* outp = static_cast<float*>(out);
  float* wsp = static_cast<float*>(ws);
  float* dst = splits == 1 ? outp : wsp;
  switch (dtype) {
    case kF32:
      launch_wsum<float>(u, wp, dst, n, P, splits, rows_per_split, vectorized, st);
      break;
    case kBF16:
      launch_wsum<__nv_bfloat16>(u, wp, dst, n, P, splits, rows_per_split,
                                 vectorized, st);
      break;
    case kF16:
      launch_wsum<__half>(u, wp, dst, n, P, splits, rows_per_split, vectorized, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(finish_splits(wsp, outp, splits, P, st));
}

// q (n, Pq) int8 row-major; s (n, Pq / blk) fp32; w (n,) fp32; out (Pq,)
// fp32; ws (splits, Pq) fp32 scratch, unused when splits == 1; out and
// ws 16-byte aligned.
// `vectorized` promises Pq % 4 == 0 and a 4-byte aligned q.
int fused_wsum_dequant(const void* q, const void* s, const void* w, void* out,
                       void* ws, int64_t n, int64_t Pq, int64_t blk,
                       int64_t splits, int64_t rows_per_split,
                       int64_t vectorized, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(s);
  const float* wp = static_cast<const float*>(w);
  float* outp = static_cast<float*>(out);
  float* wsp = static_cast<float*>(ws);
  float* dst = splits == 1 ? outp : wsp;
  const dim3 grid = grid_for(Pq, kDqVec * kDqVectors, splits);
  if (vectorized && blk % kDqWarpCols == 0)
    wsum_dequant_kernel<kScaleThread><<<grid, kThreads, 0, st>>>(
        qp, sp, wp, dst, n, Pq, blk, rows_per_split);
  else if (vectorized && blk % kDqVec == 0)
    wsum_dequant_kernel<kScaleVector><<<grid, kThreads, 0, st>>>(
        qp, sp, wp, dst, n, Pq, blk, rows_per_split);
  else
    wsum_dequant_kernel<kScaleElement><<<grid, kThreads, 0, st>>>(
        qp, sp, wp, dst, n, Pq, blk, rows_per_split);
  return static_cast<int>(finish_splits(wsp, outp, splits, Pq, st));
}

}  // extern "C"
