// Order-statistic fusion kernels for Hopper (sm_90a).
//
// robust_topk_carve replaces repro/kernels/robust_fusion/kernel.py
// topk_carve_pallas: merge a (c, P) block into the carried running sum
// ssum (P,) and the ascending per-coordinate buffers topk (K, P) (the K
// largest values seen) and botk (K, P) (the K smallest). A row with
// valid == 0 adds nothing to ssum and enters as the reference masks it,
// -inf for topk and +inf for botk: so it changes only a botk that holds
// a NaN, whose last NaN it displaces.
// robust_trimmed_mean replaces trimmedmean_pallas and robust_coord_median
// replaces coordmedian_pallas: per coordinate, order the n client values,
// then the mean of ranks [trim, n - trim), or the middle value (the mean
// of the two middle values, (a + b) * 0.5, for even n; NaN when the
// coordinate holds a NaN, as jnp.median).
//
// Order. Every comparison is jnp.sort's: NaN after every number, -0
// equal to +0, and equal values kept in input order (a stable sort). So
// the carve buffers equal the reference's bit for bit, NaN included, and
// the dense kernels select the values the reference's sort selects: the
// register route sorts fp32 values with each NaN counted and replaced by
// +inf, the warp route compares 32-bit order keys (order_key) whose
// unsigned order is jnp.sort's.
//
// What bounds them. The carve: device-memory bytes; it reads the block
// and reads and writes its carry once, c*P*b + 8*P + 16*K*P + 4*c bytes.
// The dense kernels read the matrix once, n*P*b + 4*P bytes, but their
// compare work per column grows faster than n: at small n the bytes
// bound them, at larger n the compares (and for the warp route the
// instructions each pass issues).
//
// What the designs do about it. The TPU kernels load an (n, 1024) strip
// into VMEM and sort it whole. On Hopper:
//   * Carve: one thread per column, neighbouring threads on neighbouring
//     columns, one pass over the block. For K <= 32 the column's K top
//     and K bottom values live in registers, in a window of KM >= K slots
//     (compile-time KM, so the insertion merge is unrolled and branch
//     free; topk's K slots sit at the top of the window over -inf, botk's
//     at the bottom over +inf, and only those K are written back). Each
//     thread loads 4 rows before it inserts them, and the next 4 while
//     it inserts, so several rows are in flight. The windows hold order
//     keys, and a value enters with two integer min / max a slot (t[j] =
//     max(t[j], min(x, t[j + 1]))), in place of the ~10 instructions of
//     an fp32 compare in jnp.sort's order. The key is one-to-one except
//     that -0 shares +0's key and all NaNs share one, which a stable sort
//     tells apart by input order; so a warp that meets a -0 or a NaN, in
//     its carry or its valid rows, takes the exact route of fp32 compares
//     from that row group on. For
//     K > 32 the merge works in the (K, P) buffers themselves, in place.
//     The carry is updated in place: the caller must not alias it.
//   * Dense, register route (n <= 128): one thread per column, so every
//     row load is coalesced across the warp. The thread issues its n
//     loads at once, pads the column to a compile-time bucket NB in {8,
//     16, 24, 32, 48, 64, 96, 128} and sorts it by Batcher's odd-even
//     merge network, fully unrolled and branch free (comparators that
//     only meet padding are dropped: 384 at NB = 48). The values stay in
//     registers: no shared memory, no divergence, no run-time index. At
//     n = 48 that is 768 fp32 min / max per column against 192 bytes
//     read, and it overlaps the loads only in part. The network compares
//     fp32 values rather than integer order keys because fp32 min / max
//     issue faster on Hopper.
//   * Dense, warp route (n > 128, no upper limit): one warp per column, a
//     block of 8 warps on 8 adjacent columns so that each row it reads is
//     a whole 32-byte sector. The block stages its (n, 8) keys in shared
//     memory once where 32 * n bytes fit (n <= ~7,200 in 227 KB); past
//     that each pass re-reads device memory. For n <= 1024 each lane then
//     lifts its rows into registers (8, 16 or 32 keys, fully unrolled),
//     which takes the shared loads and the loop control out of every
//     pass. The ranks are found by one radix select, one bit a pass, each
//     pass serving both of the trimmed mean's ranks; a rank stops once
//     one candidate is left, so spread data take far fewer than the 32
//     passes that ties take. Each lane counts its rows and the warp sums
//     the counts with __reduce_add_sync, so there are no atomics and no
//     block barrier per pass. A column's data are read from device memory
//     once, by 32 lanes instead of one thread. At mid n (a few keys a
//     lane) the instructions each pass issues bound it, not the bytes.
//
// All index arithmetic that reaches device memory is 64-bit. The kernels
// allocate nothing and use no atomics; every entry point returns the
// cudaGetLastError() of its launch, and a refused launch is never retried
// on another route.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kNanKey = 0xFFFFFFFFu;   // every NaN; also the padding

enum DType : int64_t { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ bool is_nan(float x) { return x != x; }

// a sorts strictly before b in jnp.sort's order.
__device__ __forceinline__ bool before(float a, float b) {
  return a < b || (is_nan(b) && !is_nan(a));
}

// A 32-bit key whose unsigned order is jnp.sort's order: -0 maps to +0
// (-0 + 0 is +0), every NaN to the largest key.
__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t b = __float_as_uint(__fadd_rn(f, 0.f));
  const uint32_t k =
      b ^ (static_cast<uint32_t>(static_cast<int32_t>(b) >> 31) | 0x80000000u);
  return is_nan(f) ? kNanKey : k;
}

__device__ __forceinline__ float key_value(uint32_t k) {
  if (k == kNanKey) return __uint_as_float(0x7FC00000u);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// ---------------------------------------------------------------- carve

constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kCarveGroup = 4;   // rows a thread loads before it inserts them

// The values order keys cannot carry through the carve exactly: -0 shares
// +0's key and every NaN one key, while the carve keeps their bits in
// input order, as a stable sort does.
__device__ __forceinline__ bool keyless(float f) {
  return is_nan(f) || __float_as_uint(f) == 0x80000000u;
}

// order_key and key_value for the values keyless() passes (no -0, no
// NaN): the key's unsigned order is their fp32 order.
__device__ __forceinline__ uint32_t plain_key(uint32_t bits) {
  return bits ^
         (static_cast<uint32_t>(static_cast<int32_t>(bits) >> 31) | 0x80000000u);
}

__device__ __forceinline__ uint32_t plain_bits(uint32_t k) {
  return k ^
         (static_cast<uint32_t>(static_cast<int32_t>(~k) >> 31) | 0x80000000u);
}

// The exact route. Insert x into the ascending top window t (fp32 bits)
// and drop its smallest value. x goes after the kept values equal to it,
// as in a stable sort of [topk; block] whose last KM values are kept.
template <int KM>
__device__ __forceinline__ void top_insert(uint32_t (&t)[KM], float x) {
#pragma unroll
  for (int j = 0; j < KM - 1; ++j) {
    const float a = __uint_as_float(t[j]), b = __uint_as_float(t[j + 1]);
    t[j] = __float_as_uint(!before(x, b) ? b : (!before(x, a) ? x : a));
  }
  const float a = __uint_as_float(t[KM - 1]);
  t[KM - 1] = __float_as_uint(!before(x, a) ? x : a);
}

// Insert x into the ascending bottom window b and drop its largest value
// (the first KM values of a stable sort of [botk; block]).
template <int KM>
__device__ __forceinline__ void bot_insert(uint32_t (&b)[KM], float x) {
#pragma unroll
  for (int j = KM - 1; j > 0; --j) {
    const float a = __uint_as_float(b[j - 1]), c = __uint_as_float(b[j]);
    b[j] = __float_as_uint(before(x, a) ? a : (before(x, c) ? x : c));
  }
  const float c = __uint_as_float(b[0]);
  b[0] = __float_as_uint(before(x, c) ? x : c);
}

// The fast route: the same insertions on order keys, two integer min /
// max a slot. Exact when no key stands for two values.
template <int KM>
__device__ __forceinline__ void top_insert_key(uint32_t (&t)[KM], uint32_t x) {
#pragma unroll
  for (int j = 0; j < KM - 1; ++j) t[j] = max(t[j], min(x, t[j + 1]));
  t[KM - 1] = max(t[KM - 1], x);
}

template <int KM>
__device__ __forceinline__ void bot_insert_key(uint32_t (&b)[KM], uint32_t x) {
#pragma unroll
  for (int j = KM - 1; j > 0; --j) b[j] = min(b[j], max(x, b[j - 1]));
  b[0] = min(b[0], x);
}

// plain_key is one-to-one on all 32-bit patterns and plain_bits undoes
// it, so a window turned into keys and back keeps its bits, -0 and NaN
// payloads included.
template <int KM>
__device__ __forceinline__ void to_keys(uint32_t (&t)[KM]) {
#pragma unroll
  for (int j = 0; j < KM; ++j) t[j] = plain_key(t[j]);
}

template <int KM>
__device__ __forceinline__ void to_bits(uint32_t (&t)[KM]) {
#pragma unroll
  for (int j = 0; j < KM; ++j) t[j] = plain_bits(t[j]);
}

// Issue the loads of rows [i0, i0 + kCarveGroup) of column p (those
// below `rows`); returns the rows' validity, bit g for row i0 + g. Nothing
// here waits for the row values.
template <typename T>
__device__ __forceinline__ unsigned load_rows(const T* __restrict__ u,
                                              const float* __restrict__ valid,
                                              int64_t rows, int64_t P,
                                              int64_t p, int64_t i0,
                                              float (&x)[kCarveGroup]) {
  unsigned in = 0;
#pragma unroll
  for (int g = 0; g < kCarveGroup; ++g) {
    const int64_t i = i0 + g;
    x[g] = i < rows ? to_f32(u[i * P + p]) : 0.f;
    if (i < rows && __ldg(valid + i) > 0.f) in |= 1u << g;
  }
  return in;
}

// K <= KM: the column's buffers in registers, KM slots a window, held as
// order keys. A warp inserts on the fast route until a lane meets a
// keyless value in its carry or, group by group, among its valid rows;
// it then turns its windows back into fp32 bits and takes the exact
// route for the rest of the block. Every choice is warp-wide
// (__any_sync), so the warp never diverges on it. The loads of the first
// row group are issued with the carry's, and each later group's while
// the one before it is inserted. Two blocks an SM bound the registers at
// 128: with no bound ptxas holds KM = 16 to 64 registers and spills.
template <typename T, int KM>
__global__ void __launch_bounds__(kThreads, 2)
carve_reg_kernel(const T* __restrict__ u, const float* __restrict__ valid,
                 float* __restrict__ ssum, float* __restrict__ topk,
                 float* __restrict__ botk, int64_t rows, int64_t P,
                 int64_t K) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const unsigned lanes = __ballot_sync(kFull, p < P);
  if (p >= P) return;
  const int pad = KM - static_cast<int>(K);
  uint32_t t[KM], b[KM];   // order keys on the fast route, fp32 bits on the exact
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    t[j] = __float_as_uint(j >= pad ? topk[(j - pad) * P + p] : -INFINITY);
    b[j] = __float_as_uint(j < K ? botk[j * P + p] : INFINITY);
  }
  float x[kCarveGroup];
  unsigned in = load_rows<T>(u, valid, rows, P, p, 0, x);
  bool odd = false;
#pragma unroll
  for (int j = 0; j < KM; ++j)
    odd |= keyless(__uint_as_float(t[j])) | keyless(__uint_as_float(b[j]));
  to_keys<KM>(t);
  to_keys<KM>(b);
  bool exact = false;
  float acc = 0.f;
  for (int64_t i0 = 0; i0 < rows; i0 += kCarveGroup) {
#pragma unroll
    for (int g = 0; g < kCarveGroup; ++g)
      odd |= ((in >> g) & 1u) && keyless(x[g]);
    if (!exact && __any_sync(lanes, odd)) {
      exact = true;
      to_bits<KM>(t);
      to_bits<KM>(b);
    }
    odd = false;
    float xn[kCarveGroup];
    const unsigned in_next =
        load_rows<T>(u, valid, rows, P, p, i0 + kCarveGroup, xn);
    if (exact) {
      // a row at a time from the front of the group, so that the long
      // insertion is not unrolled kCarveGroup times
#pragma unroll 1
      for (; in; in >>= 1) {
        if (in & 1u) {
          acc += x[0];
          top_insert<KM>(t, x[0]);
          bot_insert<KM>(b, x[0]);
        }
#pragma unroll
        for (int k = 0; k < kCarveGroup - 1; ++k) x[k] = x[k + 1];
      }
    } else {
#pragma unroll
      for (int g = 0; g < kCarveGroup; ++g) {
        if (!((in >> g) & 1u)) continue;
        acc += x[g];
        const uint32_t k = plain_key(__float_as_uint(x[g]));
        top_insert_key<KM>(t, k);
        bot_insert_key<KM>(b, k);
      }
    }
#pragma unroll
    for (int g = 0; g < kCarveGroup; ++g) x[g] = xn[g];
    in = in_next;
  }
  ssum[p] = ssum[p] + acc;
  if (!exact) {
    to_bits<KM>(t);
    to_bits<KM>(b);
  } else {
    // The masked rows enter botk as +inf, after the valid rows: +inf ties
    // only with +inf and precedes only NaN, so where it enters changes
    // no bit. The fast route's windows hold no NaN, so it skips this;
    // after KM the window holds no NaN either. Counting them here, not
    // in the loop, keeps the fast route's registers.
    int n = 0;
#pragma unroll 1
    for (int64_t i = 0; i < rows && n < KM; ++i) {
      if (__ldg(valid + i) > 0.f) continue;
      bot_insert<KM>(b, INFINITY);
      ++n;
    }
  }
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    if (j >= pad) topk[(j - pad) * P + p] = __uint_as_float(t[j]);
    if (j < K) botk[j * P + p] = __uint_as_float(b[j]);
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
  auto bot_in = [&](float x) {
    int64_t j = K - 1;
    while (j > 0 && before(x, bc[(j - 1) * P])) {
      bc[j * P] = bc[(j - 1) * P];
      --j;
    }
    bc[j * P] = x;
    bmax = bc[(K - 1) * P];
  };
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
    if (before(x, bmax)) bot_in(x);
  }
  ssum[p] = ssum[p] + acc;
  // the masked rows enter botk as +inf, after the valid rows (where it
  // enters changes no bit, as in carve_reg_kernel): each one displaces
  // the last NaN while there is one
  for (int64_t i = 0; i < rows && before(INFINITY, bmax); ++i)
    if (!(__ldg(valid + i) > 0.f)) bot_in(INFINITY);
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

constexpr int kRegMax = 128;                // largest n of the register route
constexpr int kRegThreads = 128;
constexpr int kWarps = 8;                   // columns (a warp each) per block
constexpr int kWarpThreads = 32 * kWarps;

enum Route : int64_t { kRegister = 0, kWarpStaged = 1, kWarpStreamed = 2 };

__host__ __device__ constexpr int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Compare-exchange, the smaller value to slot a (a < b). Slots at or past
// NB would hold padding, +inf, the largest value, and no comparator moves
// it, so comparators that reach them are dropped. The values hold no NaN.
template <int NB>
__device__ __forceinline__ void cx(float (&v)[NB], int a, int b) {
  if (b < NB) {
    const float x = v[a], y = v[b];
    v[a] = fminf(x, y);
    v[b] = fmaxf(x, y);
  }
}

// Batcher's odd-even merge of slots [LO, HI] (inclusive), comparing slots
// R apart; the network of slots [0, pow2_ceil(NB)) with every comparator
// past NB dropped sorts NB values (384 comparators at NB = 48, 543 at 64;
// tests/test_torch_robust_select.py models it).
template <int NB, int LO, int HI, int R>
__device__ __forceinline__ void oe_merge(float (&v)[NB]) {
  if constexpr (2 * R < HI - LO) {
    oe_merge<NB, LO, HI, 2 * R>(v);
    oe_merge<NB, LO + R, HI, 2 * R>(v);
#pragma unroll
    for (int i = LO + R; i < HI - R; i += 2 * R) cx<NB>(v, i, i + R);
  } else {
    cx<NB>(v, LO, LO + R);
  }
}

template <int NB, int LO, int HI>
__device__ __forceinline__ void oe_sort(float (&v)[NB]) {
  if constexpr (HI > LO) {
    constexpr int MID = LO + (HI - LO) / 2;
    oe_sort<NB, LO, MID>(v);
    oe_sort<NB, MID + 1, HI>(v);
    oe_merge<NB, LO, HI, 1>(v);
  }
}

// Register route (n <= kRegMax): one thread per column, neighbouring
// threads on neighbouring columns. The column's n values, each NaN
// counted and replaced by +inf, padded to NB, are sorted in registers by
// a fully unrolled network; ranks are read from compile-time slots, so
// the array never leaves the register file. In jnp.sort's order the NaNs
// are the column's last `nans` ranks, so the median is NaN when nans > 0
// and the trimmed mean when nans > trim; every other kept rank holds the
// sorted value (a NaN's +inf sorts at or above every real value). The
// trimmed mean pads with +inf and sums slots [trim, n - trim). The median
// pads with as many -inf as +inf (one more -inf for odd n), so its middle
// values sit at slots NB / 2 - 1 and NB / 2 whatever n is, and the
// compiler drops every comparator outside their cone.
template <typename T, bool MEDIAN, int NB>
__global__ void __launch_bounds__(kRegThreads)
stat_reg_kernel(const T* __restrict__ u, float* __restrict__ out, int n,
                int64_t P, int trim) {
  const int64_t p =
      static_cast<int64_t>(blockIdx.x) * kRegThreads + threadIdx.x;
  if (p >= P) return;
  const int low_pad = MEDIAN ? (NB - n + (n & 1)) / 2 : 0;
  float v[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j)   // every load issued before any compare
    v[j] = j < n ? to_f32(u[static_cast<int64_t>(j) * P + p])
                 : j < n + low_pad ? -INFINITY : INFINITY;
  int nans = 0;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    nans += is_nan(v[j]);
    v[j] = is_nan(v[j]) ? INFINITY : v[j];
  }
  oe_sort<NB, 0, pow2_ceil(NB) - 1>(v);
  if (MEDIAN) {
    const float mid = n & 1 ? v[NB / 2] : (v[NB / 2 - 1] + v[NB / 2]) * 0.5f;
    out[p] = nans > 0 ? __uint_as_float(0x7FC00000u) : mid;
    return;
  }
  float acc = 0.f;   // the kept ranks, summed in rank order
#pragma unroll
  for (int j = 0; j < NB; ++j)
    if (j >= trim && j < n - trim) acc += v[j];
  out[p] = nans > trim ? __uint_as_float(0x7FC00000u)
                       : acc / static_cast<float>(n - 2 * trim);
}

// The warp's sum of a per-lane count. With 32-bit rows the sum fits in
// 32 bits; with 64-bit rows it is taken in 16-bit halves, which cannot
// wrap over 32 lanes.
template <typename I>
__device__ __forceinline__ I warp_count(uint32_t c) {
  if constexpr (sizeof(I) == 4) {
    return static_cast<I>(__reduce_add_sync(kFull, c));
  } else {
    const uint32_t lo = __reduce_add_sync(kFull, c & 0xFFFFu);
    const uint32_t hi = __reduce_add_sync(kFull, c >> 16);
    return (static_cast<I>(hi) << 16) + lo;
  }
}

// A lane's keys of the warp's column, rows lane, lane + 32, ...: each(f)
// calls f(key, valid) on every one. RowKeys reads them (shared or device
// memory) on every visit; LaneKeys holds KPL of them in registers, fully
// unrolled, rows past n as the NaN key with valid false. A padding key has
// every bit set, so it never counts as a 0 bit in a select pass.
template <typename I, typename KeyAt>
struct RowKeys {
  const KeyAt& key_at;
  I n;
  int lane;
  template <typename F>
  __device__ __forceinline__ void each(F&& f) const {
#pragma unroll 4
    for (I i = lane; i < n; i += 32) f(key_at(i), true);
  }
};

template <int KPL>
struct LaneKeys {
  uint32_t k[KPL];
  int n, lane;
  template <typename F>
  __device__ __forceinline__ void each(F&& f) const {
#pragma unroll
    for (int j = 0; j < KPL; ++j) f(k[j], lane + 32 * j < n);
  }
};

// The key of a rank (0-based) in the warp's column, with how many keys
// lie below it (lt) and equal it (eq).
template <typename I>
struct Selected {
  uint32_t key;
  I lt, eq;
};

// Radix select of NR ranks at once, one bit a pass from the top: each
// pass visits every key once and counts, for each rank still open, the
// keys that match its prefix with the bit at 0. Each lane counts its rows
// and the warp sums the counts: no atomics, no barrier. A rank closes
// once one candidate is left (one more pass then finds it); ties run all
// 32 passes.
template <int NR, typename I, typename Keys>
__device__ __forceinline__ void warp_select(const Keys& keys, I n,
                                            const I (&rank)[NR],
                                            Selected<I> (&sel)[NR]) {
  uint32_t prefix[NR], mask[NR];
  I r[NR], cand[NR];
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    prefix[q] = mask[q] = 0u;
    r[q] = rank[q];
    cand[q] = n;
  }
  for (int bit = 31; bit >= 0; --bit) {
    bool open = false;
#pragma unroll
    for (int q = 0; q < NR; ++q) open |= cand[q] > 1;
    if (!open) break;
    const uint32_t b = 1u << bit;
    uint32_t c[NR];
#pragma unroll
    for (int q = 0; q < NR; ++q) c[q] = 0u;
    keys.each([&](uint32_t k, bool) {
#pragma unroll
      for (int q = 0; q < NR; ++q)
        if (((k ^ prefix[q]) & (mask[q] | b)) == 0u) ++c[q];
    });
#pragma unroll
    for (int q = 0; q < NR; ++q) {
      if (cand[q] <= 1) continue;
      const I zeros = warp_count<I>(c[q]);
      if (r[q] >= zeros) {
        prefix[q] |= b;
        r[q] -= zeros;
        cand[q] -= zeros;
      } else {
        cand[q] = zeros;
      }
      mask[q] |= b;
    }
  }
  bool seek = false;   // a rank closed early: its one key under the prefix
#pragma unroll
  for (int q = 0; q < NR; ++q) seek |= mask[q] != kFull;
  if (seek) {
    uint32_t found[NR];
#pragma unroll
    for (int q = 0; q < NR; ++q) found[q] = 0u;
    keys.each([&](uint32_t k, bool valid) {
#pragma unroll
      for (int q = 0; q < NR; ++q)
        if (valid && ((k ^ prefix[q]) & mask[q]) == 0u) found[q] = k;
    });
#pragma unroll
    for (int q = 0; q < NR; ++q)
      if (mask[q] != kFull) prefix[q] = __reduce_max_sync(kFull, found[q]);
  }
#pragma unroll
  for (int q = 0; q < NR; ++q) sel[q] = {prefix[q], rank[q] - r[q], cand[q]};
}

// The statistic of the warp's column from its keys; lane 0 writes it.
template <bool MEDIAN, typename I, typename Keys>
__device__ __forceinline__ void warp_stat(const Keys& keys, I n, I trim,
                                          int lane, float* out) {
  if (MEDIAN) {
    const I ranks[1] = {(n - 1) / 2};
    Selected<I> sel[1];
    warp_select<1, I>(keys, n, ranks, sel);
    const Selected<I>& lo = sel[0];
    // one pass: the next key above lo and whether a NaN is present
    uint32_t next = kNanKey, kmax = 0u;
    keys.each([&](uint32_t k, bool valid) {
      if (!valid) return;
      if (k > lo.key) next = min(next, k);
      kmax = max(kmax, k);
    });
    next = __reduce_min_sync(kFull, next);
    kmax = __reduce_max_sync(kFull, kmax);
    if (lane != 0) return;
    const float a = key_value(lo.key);
    if (kmax == kNanKey) {
      *out = key_value(kmax);
    } else if (n % 2) {
      *out = a;
    } else {   // the upper middle is lo's tie or the next key
      const float b = lo.lt + lo.eq > n / 2 ? a : key_value(next);
      *out = (a + b) * 0.5f;
    }
    return;
  }
  const I ranks[2] = {trim, n - 1 - trim};
  Selected<I> sel[2];
  warp_select<2, I>(keys, n, ranks, sel);
  const Selected<I>&lo = sel[0], &hi = sel[1];
  const float vlo = key_value(lo.key);
  if (lo.key == hi.key) {   // ranks [trim, n - trim) all hold that key
    if (lane == 0) *out = vlo;
    return;
  }
  // the keys strictly between the two, each lane in row order, then the
  // lanes in a fixed butterfly order; the boundary ties by their counts
  float between = 0.f;
  keys.each([&](uint32_t k, bool valid) {
    if (valid && k > lo.key && k < hi.key) between += key_value(k);
  });
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) between += __shfl_xor_sync(kFull, between, o);
  if (lane != 0) return;
  const float take_lo = static_cast<float>(lo.lt + lo.eq - trim);
  const float take_hi = static_cast<float>(n - trim - hi.lt);
  *out = (between + take_lo * vlo + take_hi * key_value(hi.key)) /
         static_cast<float>(n - 2 * trim);
}

// Warp route (n > kRegMax): one warp per column, a block of kWarps warps
// on kWarps adjacent columns. STAGED: the block first stores its (n,
// kWarps) keys in shared memory, column c at keys[c * stride + row] with
// stride = 4 (mod 32), so both the staging stores (4 rows x 8 columns a
// warp) and each warp's reads of its column are free of bank conflicts.
// With KPL > 0 (n <= 32 * KPL) each lane then lifts its rows into
// registers and every pass runs there, fully unrolled; otherwise every
// pass reads shared memory. Not STAGED: every pass reads device memory
// (the block's columns share each row's sector).
template <typename T, bool MEDIAN, bool STAGED, int KPL>
__global__ void __launch_bounds__(kWarpThreads)
stat_warp_kernel(const T* __restrict__ u, float* __restrict__ out, int64_t n,
                 int64_t P, int64_t trim, int64_t stride) {
  extern __shared__ uint32_t keys[];
  using I = typename std::conditional<STAGED, int, int64_t>::type;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kWarps;
  const int lane = threadIdx.x & 31;
  const int64_t p = p0 + (threadIdx.x >> 5);
  if constexpr (STAGED) {
    const int c = threadIdx.x % kWarps;   // a thread stages one column
    if (p0 + c < P) {
      uint32_t* dst = keys + c * stride;
      const T* src = u + p0 + c;
#pragma unroll 8
      for (int64_t i = threadIdx.x / kWarps; i < n;
           i += kWarpThreads / kWarps)
        dst[i] = order_key(to_f32(src[i * P]));
    }
    __syncthreads();
  }
  if (p >= P) return;   // warp-uniform; no barrier follows
  const uint32_t* col = keys + (threadIdx.x >> 5) * stride;
  const I rows = static_cast<I>(n), t = static_cast<I>(trim);
  if constexpr (KPL > 0) {
    LaneKeys<KPL> lk;
    lk.n = static_cast<int>(n);
    lk.lane = lane;
#pragma unroll
    for (int j = 0; j < KPL; ++j)
      lk.k[j] = lane + 32 * j < lk.n ? col[lane + 32 * j] : kNanKey;
    warp_stat<MEDIAN, I>(lk, rows, t, lane, out + p);
  } else {
    const T* src = u + p;
    const auto key_at = [&](I i) -> uint32_t {
      if constexpr (STAGED) return col[i];
      else return order_key(to_f32(src[static_cast<int64_t>(i) * P]));
    };
    warp_stat<MEDIAN, I>(RowKeys<I, decltype(key_at)>{key_at, rows, lane},
                         rows, t, lane, out + p);
  }
}

int max_smem_per_block() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 48 * 1024;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 48 * 1024;
  return bytes;
}

// Keys per staged column: n rounded up to 32, plus 4 (see stat_warp_kernel).
int64_t staged_stride(int64_t n) { return (n + 31) / 32 * 32 + 4; }

// The route n takes on the current device, and its parameters: for the
// register route NB; for the staged warp route the block's shared bytes
// and the keys each lane holds in registers (0: passes over shared
// memory); nothing for the streamed warp route.
Route route_for(int64_t n, int64_t (&param)[2]) {
  param[0] = param[1] = 0;
  if (n <= kRegMax) {
    param[0] = n <= 8 ? 8 : n <= 16 ? 16 : n <= 24 ? 24 : n <= 32 ? 32
             : n <= 48 ? 48 : n <= 64 ? 64 : n <= 96 ? 96 : 128;
    return kRegister;
  }
  const int64_t bytes = 4 * kWarps * staged_stride(n);
  if (bytes > max_smem_per_block()) return kWarpStreamed;
  param[0] = bytes;
  param[1] = n <= 256 ? 8 : n <= 512 ? 16 : n <= 1024 ? 32 : 0;
  return kWarpStaged;
}

template <typename T, bool MEDIAN, int NB>
void launch_reg(const T* u, float* out, int64_t n, int64_t P, int64_t trim,
                cudaStream_t st) {
  const unsigned grid =
      static_cast<unsigned>((P + kRegThreads - 1) / kRegThreads);
  stat_reg_kernel<T, MEDIAN, NB><<<grid, kRegThreads, 0, st>>>(
      u, out, static_cast<int>(n), P, static_cast<int>(trim));
}

template <typename T, bool MEDIAN, int KPL>
cudaError_t launch_staged(const T* u, float* out, int64_t n, int64_t P,
                          int64_t trim, int64_t smem, cudaStream_t st) {
  const auto kernel = stat_warp_kernel<T, MEDIAN, true, KPL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((P + kWarps - 1) / kWarps);
  kernel<<<grid, kWarpThreads, static_cast<size_t>(smem), st>>>(
      u, out, n, P, trim, staged_stride(n));
  return cudaGetLastError();
}

template <typename T, bool MEDIAN>
cudaError_t launch_stat(const void* u, float* out, int64_t n, int64_t P,
                        int64_t trim, cudaStream_t st) {
  const T* up = static_cast<const T*>(u);
  int64_t param[2];
  const Route route = route_for(n, param);
  if (route == kRegister) {
    switch (param[0]) {
      case 8: launch_reg<T, MEDIAN, 8>(up, out, n, P, trim, st); break;
      case 16: launch_reg<T, MEDIAN, 16>(up, out, n, P, trim, st); break;
      case 24: launch_reg<T, MEDIAN, 24>(up, out, n, P, trim, st); break;
      case 32: launch_reg<T, MEDIAN, 32>(up, out, n, P, trim, st); break;
      case 48: launch_reg<T, MEDIAN, 48>(up, out, n, P, trim, st); break;
      case 64: launch_reg<T, MEDIAN, 64>(up, out, n, P, trim, st); break;
      case 96: launch_reg<T, MEDIAN, 96>(up, out, n, P, trim, st); break;
      default: launch_reg<T, MEDIAN, 128>(up, out, n, P, trim, st); break;
    }
    return cudaGetLastError();
  }
  if (route == kWarpStaged) {
    switch (param[1]) {
      case 8:
        return launch_staged<T, MEDIAN, 8>(up, out, n, P, trim, param[0], st);
      case 16:
        return launch_staged<T, MEDIAN, 16>(up, out, n, P, trim, param[0], st);
      case 32:
        return launch_staged<T, MEDIAN, 32>(up, out, n, P, trim, param[0], st);
      default:
        return launch_staged<T, MEDIAN, 0>(up, out, n, P, trim, param[0], st);
    }
  }
  const unsigned grid = static_cast<unsigned>((P + kWarps - 1) / kWarps);
  stat_warp_kernel<T, MEDIAN, false, 0><<<grid, kWarpThreads, 0, st>>>(
      up, out, n, P, trim, 0);
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

// The route of the dense kernels for n rows on the current device: 0 the
// register route (param = {NB, 0}), 1 the warp route staged in shared
// memory (param = {the block's bytes, keys a lane holds in registers or
// 0}), 2 the warp route streamed from device memory (param = {0, 0}).
int64_t robust_dense_route(int64_t n, int64_t* param) {
  int64_t p[2];
  const Route route = route_for(n, p);
  param[0] = p[0];
  param[1] = p[1];
  return static_cast<int64_t>(route);
}

}  // extern "C"
