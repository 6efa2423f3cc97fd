// Order-statistic fusion kernels for Hopper (sm_90a).
//
// robust_topk_carve replaces repro/kernels/robust_fusion/kernel.py
// topk_carve_pallas: merge a (c, P) block into the carried running sum
// ssum (P,) and the ascending per-coordinate buffers topk (K, P) (the K
// largest values seen) and botk (K, P) (the K smallest). Rows with
// valid == 0 never enter.
// robust_trimmed_mean replaces trimmedmean_pallas and robust_coord_median
// replaces coordmedian_pallas: per coordinate, sort the n client values,
// then the mean of ranks [trim, n - trim), or the middle value (the mean
// of the two middle values, (a + b) * 0.5, for even n; NaN when the
// coordinate holds a NaN, as jnp.median).
//
// Order. Every comparison is jnp.sort's: NaN after every number, -0
// equal to +0, and equal values kept in input order (a stable sort). So
// the carve buffers equal the reference's bit for bit, NaN included, and
// the dense kernels select the values the reference's sort selects.
//
// What bounds them: device-memory bytes. The carve reads the block and
// reads and writes its carry once, c*P*b + 8*P + 16*K*P + 4*c bytes; the
// dense kernels read the matrix once, n*P*b + 4*P bytes. Their compare
// counts stay far below the fp32 rate at the main path's shapes.
//
// What the designs do about it. The TPU kernels load an (n, 1024) strip
// into VMEM and sort it whole; on Hopper one thread owns one column,
// neighbouring threads neighbouring columns, so every load and store of
// a row or buffer row is coalesced, and no padded copy is made: rows at
// or beyond the block's are never read.
//   * Carve: one pass over the block. For K <= 32 the column's K top
//     and K bottom values live in registers, in a window of KM >= K slots
//     (compile-time KM, so the insertion merge is unrolled and branch
//     free; topk's K slots sit at the top of the window over -inf, botk's
//     at the bottom over +inf, and only those K are written back). For
//     K > 32 the merge works in the (K, P) buffers themselves, in place.
//     The carry is updated in place: the caller must not alias it.
//   * Dense, first path: a block stages an (n, TILE) fp32 strip in
//     shared memory, TILE columns sized from n against the 227 KB a
//     block can hold (TILE <= 256, a multiple of 32; conflict-free, as
//     thread t touches bank t % 32 only), and each thread insertion-sorts
//     its column there.
//   * Dense, second path (n too large for a 32-column tile): each thread
//     selects its column's order statistics by a radix select over a
//     32-bit order key, straight from device memory, one bit a pass
//     (about 32 passes per selected rank). No scratch, and no limit on n.
//
// All index arithmetic that reaches device memory is 64-bit. The kernels
// allocate nothing and use no atomics; every entry point returns the
// cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSelectThreads = 64;
constexpr int kMaxTile = 256;
constexpr int kMinTile = 32;

enum DType : int64_t { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// a sorts strictly before b in jnp.sort's order.
__device__ __forceinline__ bool before(float a, float b) {
  return a < b || (is_nan(b) && !is_nan(a));
}

// A 32-bit key whose unsigned order is jnp.sort's order: -0 maps to +0,
// every NaN to the largest key.
__device__ __forceinline__ uint32_t order_key(float f) {
  if (is_nan(f)) return 0xFFFFFFFFu;
  uint32_t b = __float_as_uint(f);
  if (f == 0.f) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  if (k == 0xFFFFFFFFu) return __uint_as_float(0x7FC00000u);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// ---------------------------------------------------------------- carve

// Insert x into the ascending top window t and drop its smallest value.
// x goes after the kept values equal to it, as in a stable sort of
// [topk; block] whose last KM values are kept.
template <int KM>
__device__ __forceinline__ void top_insert(float (&t)[KM], float x) {
#pragma unroll
  for (int j = 0; j < KM - 1; ++j)
    t[j] = !before(x, t[j + 1]) ? t[j + 1] : (!before(x, t[j]) ? x : t[j]);
  t[KM - 1] = !before(x, t[KM - 1]) ? x : t[KM - 1];
}

// Insert x into the ascending bottom window b and drop its largest value
// (the first KM values of a stable sort of [botk; block]).
template <int KM>
__device__ __forceinline__ void bot_insert(float (&b)[KM], float x) {
#pragma unroll
  for (int j = KM - 1; j > 0; --j)
    b[j] = before(x, b[j - 1]) ? b[j - 1] : (before(x, b[j]) ? x : b[j]);
  b[0] = before(x, b[0]) ? x : b[0];
}

// K <= KM: the column's buffers in registers.
template <typename T, int KM>
__global__ void __launch_bounds__(kThreads)
carve_reg_kernel(const T* __restrict__ u, const float* __restrict__ valid,
                 float* __restrict__ ssum, float* __restrict__ topk,
                 float* __restrict__ botk, int64_t rows, int64_t P,
                 int64_t K) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= P) return;
  const int pad = KM - static_cast<int>(K);
  float t[KM], b[KM];
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    t[j] = j >= pad ? topk[(j - pad) * P + p] : -INFINITY;
    b[j] = j < K ? botk[j * P + p] : INFINITY;
  }
  float acc = 0.f;
  for (int64_t i = 0; i < rows; ++i) {
    if (!(__ldg(valid + i) > 0.f)) continue;
    const float x = to_f32(u[i * P + p]);
    acc += x;
    top_insert<KM>(t, x);
    bot_insert<KM>(b, x);
  }
  ssum[p] = ssum[p] + acc;
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    if (j >= pad) topk[(j - pad) * P + p] = t[j];
    if (j < K) botk[j * P + p] = b[j];
  }
}

// K > 32: the insertion merge in the (K, P) buffers, element j of the
// column at [j * P + p] (coalesced across the warp's columns).
template <typename T>
__global__ void __launch_bounds__(kThreads)
carve_mem_kernel(const T* __restrict__ u, const float* __restrict__ valid,
                 float* __restrict__ ssum, float* __restrict__ topk,
                 float* __restrict__ botk, int64_t rows, int64_t P,
                 int64_t K) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= P) return;
  float* tc = topk + p;
  float* bc = botk + p;
  float tmin = tc[0];
  float bmax = bc[(K - 1) * P];
  float acc = 0.f;
  for (int64_t i = 0; i < rows; ++i) {
    if (!(__ldg(valid + i) > 0.f)) continue;
    const float x = to_f32(u[i * P + p]);
    acc += x;
    if (!before(x, tmin)) {
      int64_t j = 0;
      while (j + 1 < K && !before(x, tc[(j + 1) * P])) {
        tc[j * P] = tc[(j + 1) * P];
        ++j;
      }
      tc[j * P] = x;
      tmin = tc[0];
    }
    if (before(x, bmax)) {
      int64_t j = K - 1;
      while (j > 0 && before(x, bc[(j - 1) * P])) {
        bc[j * P] = bc[(j - 1) * P];
        --j;
      }
      bc[j * P] = x;
      bmax = bc[(K - 1) * P];
    }
  }
  ssum[p] = ssum[p] + acc;
}

template <typename T, int KM>
void launch_carve_reg(const void* u, const float* v, float* s, float* t,
                      float* b, int64_t rows, int64_t P, int64_t K,
                      cudaStream_t st) {
  const unsigned grid = static_cast<unsigned>((P + kThreads - 1) / kThreads);
  carve_reg_kernel<T, KM><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(u), v, s, t, b, rows, P, K);
}

template <typename T>
void launch_carve(const void* u, const float* v, float* s, float* t,
                  float* b, int64_t rows, int64_t P, int64_t K,
                  cudaStream_t st) {
  if (K <= 1) return launch_carve_reg<T, 1>(u, v, s, t, b, rows, P, K, st);
  if (K <= 2) return launch_carve_reg<T, 2>(u, v, s, t, b, rows, P, K, st);
  if (K <= 4) return launch_carve_reg<T, 4>(u, v, s, t, b, rows, P, K, st);
  if (K <= 8) return launch_carve_reg<T, 8>(u, v, s, t, b, rows, P, K, st);
  if (K <= 16) return launch_carve_reg<T, 16>(u, v, s, t, b, rows, P, K, st);
  if (K <= 24) return launch_carve_reg<T, 24>(u, v, s, t, b, rows, P, K, st);
  if (K <= 32) return launch_carve_reg<T, 32>(u, v, s, t, b, rows, P, K, st);
  const unsigned grid = static_cast<unsigned>((P + kThreads - 1) / kThreads);
  carve_mem_kernel<T><<<grid, kThreads, 0, st>>>(static_cast<const T*>(u), v,
                                                 s, t, b, rows, P, K);
}

// ---------------------------------------------------------------- dense

// The statistic of one sorted column, element i at col[i * stride]:
// the median (NaN if the column holds one, which sorts last), or the
// mean of ranks [trim, n - trim) summed in rank order.
template <bool MEDIAN>
__device__ __forceinline__ float sorted_stat(const float* col, int stride,
                                             int n, int trim) {
  if (MEDIAN) {
    const float last = col[(n - 1) * stride];
    if (is_nan(last)) return last;
    const int mid = n / 2;
    if (n % 2) return col[mid * stride];
    return (col[(mid - 1) * stride] + col[mid * stride]) * 0.5f;
  }
  float acc = 0.f;
  for (int i = trim; i < n - trim; ++i) acc += col[i * stride];
  return acc / static_cast<float>(n - 2 * trim);
}

// First path: the block's (n, TILE) strip in shared memory, thread t's
// column at strip[i * TILE + t]; stable insertion sort per thread.
template <typename T, bool MEDIAN>
__global__ void __launch_bounds__(kMaxTile)
sorted_stat_smem_kernel(const T* __restrict__ u, float* __restrict__ out,
                        int n, int64_t P, int trim) {
  extern __shared__ float strip[];
  const int tile = blockDim.x;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * tile + threadIdx.x;
  if (p >= P) return;   // each thread touches its own column only
  float* col = strip + threadIdx.x;
#pragma unroll 4
  for (int i = 0; i < n; ++i)
    col[i * tile] = to_f32(u[static_cast<int64_t>(i) * P + p]);
  for (int i = 1; i < n; ++i) {
    const float x = col[i * tile];
    int j = i;
    while (j > 0 && before(x, col[(j - 1) * tile])) {
      col[j * tile] = col[(j - 1) * tile];
      --j;
    }
    col[j * tile] = x;
  }
  out[p] = sorted_stat<MEDIAN>(col, tile, n, trim);
}

// The order key of rank r (0-based) in column p: radix select, one bit
// a pass from the top.
template <typename T>
__device__ uint32_t select_key(const T* __restrict__ u, int64_t p, int64_t n,
                               int64_t P, int64_t r) {
  uint32_t prefix = 0u, mask = 0u;
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t m = mask | (1u << bit);
    int64_t cnt = 0;   // keys that match the prefix with this bit 0
#pragma unroll 4
    for (int64_t i = 0; i < n; ++i)
      cnt += (order_key(to_f32(u[i * P + p])) & m) == prefix;
    if (r >= cnt) {
      prefix |= 1u << bit;
      r -= cnt;
    }
    mask = m;
  }
  return prefix;
}

// Second path: order statistics selected straight from device memory.
template <typename T, bool MEDIAN>
__global__ void __launch_bounds__(kSelectThreads)
sorted_stat_select_kernel(const T* __restrict__ u, float* __restrict__ out,
                          int64_t n, int64_t P, int64_t trim) {
  const int64_t p =
      static_cast<int64_t>(blockIdx.x) * kSelectThreads + threadIdx.x;
  if (p >= P) return;
  const int64_t lo_rank = MEDIAN ? (n - 1) / 2 : trim;
  const int64_t hi_rank = MEDIAN ? n / 2 : n - 1 - trim;
  const uint32_t klo = select_key(u, p, n, P, lo_rank);
  // one pass: how many keys are <= klo, the next key above it, and
  // whether a NaN (the largest key) is present
  int64_t le_lo = 0;
  uint32_t next = 0xFFFFFFFFu, kmax = 0u;
#pragma unroll 4
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t k = order_key(to_f32(u[i * P + p]));
    le_lo += k <= klo;
    if (k > klo && k < next) next = k;
    kmax = k > kmax ? k : kmax;
  }
  if (MEDIAN) {
    if (kmax == 0xFFFFFFFFu) {
      out[p] = key_value(kmax);
      return;
    }
    const float a = key_value(klo);
    if (lo_rank == hi_rank) {
      out[p] = a;
      return;
    }
    const float b = le_lo > hi_rank ? a : key_value(next);
    out[p] = (a + b) * 0.5f;
    return;
  }
  const float vlo = key_value(klo);
  if (le_lo >= n - trim) {   // ranks [trim, n - trim) all hold klo
    out[p] = vlo;
    return;
  }
  const uint32_t khi = select_key(u, p, n, P, hi_rank);
  float between = 0.f;
  int64_t lt_hi = 0;
#pragma unroll 4
  for (int64_t i = 0; i < n; ++i) {
    const float x = to_f32(u[i * P + p]);
    const uint32_t k = order_key(x);
    lt_hi += k < khi;
    if (k > klo && k < khi) between += x;
  }
  const float take_lo = static_cast<float>(le_lo - trim);
  const float take_hi = static_cast<float>(n - trim - lt_hi);
  out[p] = (between + take_lo * vlo + take_hi * key_value(khi)) /
           static_cast<float>(n - 2 * trim);
}

int max_smem_per_block() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 48 * 1024;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 48 * 1024;
  return bytes;
}

// Columns per block of the shared-memory path for n rows, or 0 when
// not even kMinTile columns fit.
int64_t tile_for(int64_t n) {
  const int64_t cols = max_smem_per_block() / (4 * (n > 0 ? n : 1));
  const int64_t tile = (cols < kMaxTile ? cols : kMaxTile) / 32 * 32;
  return tile >= kMinTile ? tile : 0;
}

template <typename T, bool MEDIAN>
cudaError_t launch_stat(const void* u, float* out, int64_t n, int64_t P,
                        int64_t trim, cudaStream_t st) {
  const T* up = static_cast<const T*>(u);
  const int64_t tile = tile_for(n);
  if (tile > 0) {
    const size_t smem = static_cast<size_t>(4 * n * tile);
    cudaError_t err = cudaFuncSetAttribute(
        sorted_stat_smem_kernel<T, MEDIAN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const unsigned grid = static_cast<unsigned>((P + tile - 1) / tile);
    sorted_stat_smem_kernel<T, MEDIAN>
        <<<grid, static_cast<unsigned>(tile), smem, st>>>(
        up, out, static_cast<int>(n), P, static_cast<int>(trim));
  } else {
    const unsigned grid =
        static_cast<unsigned>((P + kSelectThreads - 1) / kSelectThreads);
    sorted_stat_select_kernel<T, MEDIAN><<<grid, kSelectThreads, 0, st>>>(
        up, out, n, P, trim);
  }
  return cudaGetLastError();
}

template <bool MEDIAN>
int dispatch_stat(const void* u, void* out, int64_t n, int64_t P,
                  int64_t trim, int64_t dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (dtype) {
    case kF32:
      return static_cast<int>(launch_stat<float, MEDIAN>(u, o, n, P, trim, st));
    case kBF16:
      return static_cast<int>(
          launch_stat<__nv_bfloat16, MEDIAN>(u, o, n, P, trim, st));
    case kF16:
      return static_cast<int>(launch_stat<__half, MEDIAN>(u, o, n, P, trim, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// u (rows, P) row-major of `dtype`; valid (rows,) fp32; ssum (P,), topk
// and botk (K, P) fp32, updated in place. K >= 1.
int robust_topk_carve(const void* u, const void* valid, void* ssum,
                      void* topk, void* botk, int64_t rows, int64_t P,
                      int64_t K, int64_t dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(valid);
  float* s = static_cast<float*>(ssum);
  float* t = static_cast<float*>(topk);
  float* b = static_cast<float*>(botk);
  switch (dtype) {
    case kF32:
      launch_carve<float>(u, v, s, t, b, rows, P, K, st);
      break;
    case kBF16:
      launch_carve<__nv_bfloat16>(u, v, s, t, b, rows, P, K, st);
      break;
    case kF16:
      launch_carve<__half>(u, v, s, t, b, rows, P, K, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// u (n, P) row-major of `dtype`; out (P,) fp32. 0 <= trim, 2 * trim < n.
int robust_trimmed_mean(const void* u, void* out, int64_t n, int64_t P,
                        int64_t trim, int64_t dtype, void* stream) {
  return dispatch_stat<false>(u, out, n, P, trim, dtype, stream);
}

// u (n, P) row-major of `dtype`; out (P,) fp32. n >= 1.
int robust_coord_median(const void* u, void* out, int64_t n, int64_t P,
                        int64_t dtype, void* stream) {
  return dispatch_stat<true>(u, out, n, P, 0, dtype, stream);
}

// Columns per block of the dense kernels' shared-memory path for n rows
// on the current device, 0 where they take the radix-select path.
int64_t robust_dense_tile(int64_t n) { return tile_for(n); }

}  // extern "C"
