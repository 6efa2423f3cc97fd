// Causal GQA flash attention (prefill) for Hopper (sm_90a).
//
// flash_attn_fwd replaces repro/kernels/flash_attention/kernel.py
// flash_attention (the pallas_call at :116, body _flash_kernel :26-76):
//     out[b, t, h] = softmax_s(q[b, t, h] . k[b, s, h / group] * hd^-0.5)
//                    . v[b, s, h / group]
// over the keys s that are live for query t: s <= t, and t - s < window
// when window > 0. q (B, T, nq, hd), k / v (B, S, nkv, hd) row-major in
// fp32, bf16 or fp16; out (B, T, nq, hd) in q's dtype. The kv head is
// h / group, so K / V are never duplicated (GQA of any group, MQA, MHA).
// Ragged T and S are masked in the kernel: no shape is refused.
//
// Bound: operations. Causal attention does 4 * hd FLOPs per live score
// against 2 * (nq + nkv) * hd bytes of q, k, v and out per token, so at
// the Qwen2 / Gemma3 / Zamba2 prefill shapes the FLOPs dominate in every
// dtype. Two routes, by dtype:
//
// bf16 / fp16: tensor cores (flash_half_kernel). FlashAttention-2 on
// mma.sync.m16n8k16 with fp32 accumulators:
//   * 4 warps own a BQ = 64-row query tile of one (batch, q head), 16
//     rows a warp; the late query tiles of every head, which hold the
//     most live keys, launch first, to even out the causal triangle;
//   * K / V tiles of BK keys (64; 32 at hd 256, so that two blocks fit
//     an SM) stay in their storage dtype in shared memory, fed by a
//     two-stage ring of 16-byte cp.async.cg copies: the next tile loads
//     while this one is multiplied. Rows are XOR-swizzled in 16-byte
//     chunks, so every ldmatrix is free of bank conflicts;
//   * S = Q K^T takes Q fragments from registers (loaded once with
//     ldmatrix; at hd 256 they would push O past the register file, so
//     there Q stays in shared memory and is loaded per k-step) and K
//     fragments by ldmatrix.x4; O += P V takes P from the S accumulators,
//     rescaled and rounded to bf16 / fp16 in registers (FA2's
//     accumulator-to-A-fragment reuse), and V by ldmatrix.x4.trans;
//   * the online softmax (m, l) is fp32 in registers; row maxima are
//     reduced over the 4 lanes of an accumulator row with shuffles, row
//     sums once at the end. The causal / window mask is applied only on
//     tiles that cross the diagonal, the window's edge or S.
//   Numerics: scores are fp32 dot products scaled after the dot (the
//   reference model's order, repro/models/layers/attention.py
//   blockwise_attention; the Pallas kernel scales q first, which would
//   round q * scale to bf16 at hd 32 and 128), and l sums the fp32
//   probabilities. fp16 P enters the PV product rounded to fp16, as the
//   model's `p.astype(v_blk.dtype)` does; bf16 P enters as hi + lo, two
//   bf16 terms (kSplitP below), since one bf16 rounding of P breaks the
//   port's half tolerance.
//
// fp32: CUDA cores (flash_f32_kernel), the TPU kernel's numerics: q, k
// and v in fp32, q scaled BEFORE the dot, p in fp32. TF32 would round
// the inputs to 10 mantissa bits, past the fp32 tolerance. 4 BQ threads,
// 4 rows each, own a BQ-row query tile (64, or 32 when 64-row tiles
// would put fewer than two blocks on an SM: the slowest block, the one
// with the most live key tiles, then does half the work; a row's
// arithmetic is the same for both), with q staged transposed and scaled. K / V tiles of BK keys (64, 32 at
// hd 256) arrive by cp.async into one buffer each, so K's next tile
// loads during this tile's softmax and PV and V's next tile during the
// next tile's scores; each thread's score (keys 16 apart) and output
// micro-tiles read 16-byte vectors free of bank conflicts. Row max and
// sum are reduced over the 16 threads of a row with shuffles.
//
// Both routes keep the reference's -1e30 sentinel: a masked score is
// -1e30, and the running max starts there. A row whose first live tile
// holds only masked keys gets p = exp(-1e30 - -1e30) = 1 there, and the
// next tile's alpha = exp(-1e30 - m) = 0 wipes it, as on the TPU (with
// -inf that would be NaN). Key rows past S are zero-filled in shared
// memory, so they add 0, never NaN. Tiles wholly masked (above the
// diagonal, or wholly before the window) are never loaded.
//
// The kernels allocate nothing; the entry point returns the
// cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

enum DType : int64_t { kF32 = 0, kBF16 = 1, kF16 = 2 };

// The (query tile, head, batch) of this block in a (n_qt, nq, B) grid,
// taken in the order blocks are dispatched so that the latest query
// tiles of every head, the ones with the most live key tiles, run first.
struct TileIdx {
  int qt, h;
  int64_t b;
};
__device__ __forceinline__ TileIdx tile_index() {
  const int64_t lin = blockIdx.x + static_cast<int64_t>(gridDim.x) *
                                       (blockIdx.y + static_cast<int64_t>(gridDim.y) * blockIdx.z);
  const int64_t heads = static_cast<int64_t>(gridDim.y) * gridDim.z;
  const int64_t hb = lin % heads;
  return {static_cast<int>(gridDim.x - 1 - lin / heads), static_cast<int>(hb % gridDim.y),
          hb / gridDim.y};
}

// ---------------------------------------------------------------------------
// bf16 / fp16 route: tensor cores
// ---------------------------------------------------------------------------

constexpr int kHalfThreads = 128;   // 4 warps
constexpr int kHalfBQ = 64;         // 16 query rows a warp

template <int HD>
struct HalfCfg {
  static constexpr int BK = HD <= 128 ? 64 : 32;   // keys per tile
  static constexpr int C = HD / 8;                 // 16-byte chunks a row
  static constexpr int KS = HD / 16;               // k-steps of Q K^T
  static constexpr int NT = BK / 8;                // key n-tiles of S
  static constexpr int DT = HD / 8;                // dim n-tiles of O
  static constexpr bool Q_IN_REGS = HD <= 128;
  static constexpr int TILE_BYTES = BK * HD * 2;   // one K or V tile
  static constexpr int SMEM_BYTES = kHalfBQ * HD * 2 + 4 * TILE_BYTES;
};

// Physical 16-byte chunk of (row, chunk) in a tile of C chunks a row:
// any 8 consecutive rows at one logical chunk land on 8 distinct bank
// groups (rows of >= 128 bytes XOR the row's low 3 bits; 64-byte rows,
// two to 128 bytes, XOR bits 1-2).
template <int C>
__device__ __forceinline__ int swz(int row, int chunk) {
  if constexpr (C >= 8) {
    return chunk ^ (row & 7);
  } else {
    static_assert(C == 4, "hd 32 rows are 4 chunks");
    return chunk ^ ((row >> 1) & 3);
  }
}

template <int C>
__device__ __forceinline__ uint32_t tile_addr(uint32_t base, int row, int chunk) {
  return base + static_cast<uint32_t>((row * C + swz<C>(row, chunk)) * 16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a (16 x 16, row) . b (16 x 8, col), fp32 accumulators.
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&d)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to the storage type, the first in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 x = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// bf16 rounds P to 8 significant bits, and one rounding moves an output
// of a row with few live keys by up to 2^-9 * p * |v|: past the half
// tolerance (rtol 1e-2, atol 2e-3) near zero. So bf16 P enters PV as
// hi + lo, both bf16 (hi = P rounded, lo = the rest rounded: 16 bits),
// in two products; fp16 P, 11 bits, enters once.
template <typename T>
constexpr bool kSplitP = false;
template <>
constexpr bool kSplitP<__nv_bfloat16> = true;

// Copy rows [0, rows) of a (rows x HD) tile whose row r starts at
// src + r * stride elements (rows at or past `valid` are zero-filled)
// into the swizzled tile at `dst`, 16 bytes a thread per step.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* __restrict__ src,
                                          int64_t stride, int valid, int tid) {
  constexpr int C = HD / 8;
  static_assert(ROWS * C % kHalfThreads == 0, "whole steps");
#pragma unroll
  for (int it = 0; it < ROWS * C / kHalfThreads; ++it) {
    const int i = it * kHalfThreads + tid;
    const int r = i / C, c = i % C;
    const bool ok = r < valid;
    const T* p = ok ? src + r * stride + c * 8 : src;
    cp_async16(tile_addr<C>(dst, r, c), p, ok ? 16 : 0);
  }
}

// grid (ceil(T / 64), nq, B), 128 threads, late tiles first (tile_index).
// Warp w owns query rows
// q0 + 16w .. q0 + 16w + 15; lane l holds accumulator rows g = l / 4
// and g + 8 of the warp's 16, columns 2 (l % 4) and 2 (l % 4) + 1 of
// each 8-wide n-tile (the m16n8 C layout).
template <typename T, int HD>
__global__ void __launch_bounds__(kHalfThreads)
flash_half_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int T_len, int S_len,
                  int nq, int nkv, int window, float scale_log2) {
  using Cf = HalfCfg<HD>;
  constexpr int BK = Cf::BK, C = Cf::C, KS = Cf::KS, NT = Cf::NT, DT = Cf::DT;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sKV = sQ + kHalfBQ * HD * 2;   // K0, V0, K1, V1

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const TileIdx ti = tile_index();
  const int qt = ti.qt, h = ti.h;
  const int64_t b = ti.b;
  const int kvh = h / (nq / nkv);
  const int q0 = qt * kHalfBQ;
  const int q_last = min(q0 + kHalfBQ, T_len) - 1;
  const int64_t q_stride = static_cast<int64_t>(nq) * HD;    // between positions
  const int64_t kv_stride = static_cast<int64_t>(nkv) * HD;
  const T* q_base = q + ((b * T_len + q0) * nq + h) * HD;
  const T* k_base = k + (b * S_len * nkv + kvh) * HD;
  const T* v_base = v + (b * S_len * nkv + kvh) * HD;

  // live key tiles [kt_lo, kt_hi)
  const int n_kt = (S_len + BK - 1) / BK;
  const int kt_hi = min(n_kt, q_last / BK + 1);
  int kt_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / BK;

  load_tile<T, HD, kHalfBQ>(sQ, q_base, q_stride, T_len - q0, tid);
  cp_async_commit();
  if (kt_lo < kt_hi) {
    const int k0 = kt_lo * BK;
    load_tile<T, HD, BK>(sKV, k_base + k0 * kv_stride, kv_stride, S_len - k0, tid);
    load_tile<T, HD, BK>(sKV + Cf::TILE_BYTES, v_base + k0 * kv_stride, kv_stride,
                         S_len - k0, tid);
  }
  cp_async_commit();

  // this warp's rows and the lane's two accumulator rows
  const int r0 = q0 + warp * 16;
  const int g = lane >> 2, cq = lane & 3;
  const int t_lo = r0 + g, t_hi = r0 + g + 8;

  uint32_t qf[Cf::Q_IN_REGS ? KS : 1][4];
  if constexpr (Cf::Q_IN_REGS) {   // Q fragments, loaded once
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldmatrix_x4(qf[ks], tile_addr<C>(sQ, warp * 16 + (lane & 15), ks * 2 + (lane >> 4)));
  }
  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;   // l: this lane's part

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) {   // the next tile loads while this one is multiplied
      const int k1 = (kt + 1) * BK;
      const uint32_t nxt = sKV + (stage ^ 1) * 2 * Cf::TILE_BYTES;
      load_tile<T, HD, BK>(nxt, k_base + k1 * kv_stride, kv_stride, S_len - k1, tid);
      load_tile<T, HD, BK>(nxt + Cf::TILE_BYTES, v_base + k1 * kv_stride, kv_stride,
                           S_len - k1, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t sK = sKV + stage * 2 * Cf::TILE_BYTES;
    const uint32_t sV = sK + Cf::TILE_BYTES;

    // S = Q K^T (unscaled fp32 dot products)
    float s[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      if constexpr (Cf::Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[ks][e];
      } else {
        ldmatrix_x4(a, tile_addr<C>(sQ, warp * 16 + (lane & 15), ks * 2 + (lane >> 4)));
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, tile_addr<C>(sK, np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                     ks * 2 + ((lane >> 3) & 1)));
        mma16816<T>(s[2 * np], a, bk[0], bk[1]);
        mma16816<T>(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // mask, only where the tile crosses the diagonal, the window or S
    const int k0 = kt * BK;
    const bool edge = k0 + BK - 1 > r0 || k0 + BK > S_len ||
                      (window > 0 && r0 + 15 - k0 >= window);
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nt * 8 + cq * 2 + (e & 1);
          const int t = e < 2 ? t_lo : t_hi;
          bool live = key < S_len && key <= t;
          if (window > 0) live = live && t - key < window;
          if (!live) s[nt][e] = kNegInf;
        }
    }

    // online softmax: row maxima over the 4 lanes of a row
    float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      mx_lo = fmaxf(mx_lo, fmaxf(s[nt][0], s[nt][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    // differences before the scale, so that -1e30 - -1e30 is exactly 0
    const float alpha_lo = exp2f((m_lo - mx_lo) * scale_log2);
    const float alpha_hi = exp2f((m_hi - mx_hi) * scale_log2);
    m_lo = mx_lo;
    m_hi = mx_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] = exp2f((s[nt][0] - mx_lo) * scale_log2);
      s[nt][1] = exp2f((s[nt][1] - mx_lo) * scale_log2);
      s[nt][2] = exp2f((s[nt][2] - mx_hi) * scale_log2);
      s[nt][3] = exp2f((s[nt][3] - mx_hi) * scale_log2);
      sum_lo += s[nt][0] + s[nt][1];
      sum_hi += s[nt][2] + s[nt][3];
    }
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      o[dt][0] *= alpha_lo;
      o[dt][1] *= alpha_lo;
      o[dt][2] *= alpha_hi;
      o[dt][3] *= alpha_hi;
    }

    // O += P V, P rounded to the storage type in registers (bf16: P as
    // hi + lo, two products)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4], a_lo[4];   // A fragment e: rows g / g + 8 of n-tile 2kk + e / 2
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[2 * kk + (e >> 1)][(e & 1) * 2];
        const float y = s[2 * kk + (e >> 1)][(e & 1) * 2 + 1];
        a[e] = pack2<T>(x, y);
        if constexpr (kSplitP<T>)
          a_lo[e] = pack2<T>(x - __uint_as_float(a[e] << 16),
                             y - __uint_as_float(a[e] & 0xffff0000u));
      }
#pragma unroll
      for (int np = 0; np < DT / 2; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, tile_addr<C>(sV, kk * 16 + (lane & 15), np * 2 + (lane >> 4)));
        mma16816<T>(o[2 * np], a, bv[0], bv[1]);
        mma16816<T>(o[2 * np + 1], a, bv[2], bv[3]);
        if constexpr (kSplitP<T>) {
          mma16816<T>(o[2 * np], a_lo, bv[0], bv[1]);
          mma16816<T>(o[2 * np + 1], a_lo, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();   // this stage is free for the tile after next
  }

  if (kt_lo >= kt_hi) {   // no live tile: Q's copies may still be in flight
    cp_async_wait<0>();
    __syncthreads();
  }
  // row sums over the 4 lanes of a row, then out = O / l through this
  // warp's own rows of the Q tile, stored 16 bytes a lane
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;
  const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
  unsigned char* tile = smem;
  const int row_lo = warp * 16 + g, row_hi = row_lo + 8;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    *reinterpret_cast<uint32_t*>(tile + (row_lo * C + swz<C>(row_lo, dt)) * 16 + cq * 4) =
        pack2<T>(o[dt][0] * inv_lo, o[dt][1] * inv_lo);
    *reinterpret_cast<uint32_t*>(tile + (row_hi * C + swz<C>(row_hi, dt)) * 16 + cq * 4) =
        pack2<T>(o[dt][2] * inv_hi, o[dt][3] * inv_hi);
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < C / 2; ++it) {   // 16 rows x C chunks, 32 lanes
    const int i = it * 32 + lane;
    const int r = warp * 16 + i / C, c = i % C;
    const int t = q0 + r;
    if (t < T_len) {
      const uint4 x = *reinterpret_cast<const uint4*>(tile + (r * C + swz<C>(r, c)) * 16);
      *reinterpret_cast<uint4*>(out + ((b * T_len + t) * nq + h) * HD + c * 8) = x;
    }
  }
}

template <typename T, int HD>
cudaError_t launch_half(const void* q, const void* k, const void* v, void* out, int64_t B,
                        int64_t T_len, int64_t S_len, int64_t nq, int64_t nkv,
                        int64_t window, float scale, cudaStream_t st) {
  constexpr int smem = HalfCfg<HD>::SMEM_BYTES;
  auto kern = flash_half_kernel<T, HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((T_len + kHalfBQ - 1) / kHalfBQ),
                  static_cast<unsigned>(nq), static_cast<unsigned>(B));
  kern<<<grid, kHalfThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<int>(T_len), static_cast<int>(S_len),
      static_cast<int>(nq), static_cast<int>(nkv), static_cast<int>(window),
      scale * kLog2e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 route: CUDA cores
// ---------------------------------------------------------------------------

template <int HD, int BQ>
struct Cfg {
  static constexpr int NT = 4 * BQ;                // threads: 16 per 4 rows
  static constexpr int BK = HD <= 128 ? 64 : 32;   // keys per tile
  static constexpr int RPT = 4;                    // query rows per thread
  static constexpr int KN = BK / 16;               // keys per thread (scores)
  static constexpr int DPT = HD / 16;              // dims per thread (output)
  static constexpr int VW = DPT < 4 ? DPT : 4;     // vector width of a dim run
  static constexpr int NC = DPT / VW;              // dim runs per thread
  static constexpr int QP = BQ + 4;                // padded row: qT, pT
  static constexpr int KP = HD + 4;                // padded row: K
  static constexpr int SMEM_FLOATS = HD * QP + BK * KP + BK * HD + BK * QP;
};

// N floats from / to shared memory as one 8- or 16-byte access.
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

// cp.async ROWS rows of HD floats (row r at src + r * stride; rows at or
// past `valid` zero-filled) into shared rows of PITCH floats.
template <int HD, int ROWS, int PITCH, int NT>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* __restrict__ src,
                                              int64_t stride, int64_t valid, int tid) {
  constexpr int C = HD / 4;   // 16-byte chunks a row
  static_assert(ROWS * C % NT == 0, "whole steps");
#pragma unroll
  for (int it = 0; it < ROWS * C / NT; ++it) {
    const int i = it * NT + tid;
    const int r = i / C, c = i % C;
    const bool ok = r < valid;
    cp_async16(smem_u32(dst + r * PITCH + c * 4), ok ? src + r * stride + c * 4 : src,
               ok ? 16 : 0);
  }
}

// grid (ceil(T / BQ), nq, B), late tiles first (tile_index); blockDim
// 4 BQ = BQ / 4 row groups x 16 columns. Thread (ty, tx) owns query rows
// ty*RPT .. ty*RPT+RPT-1 of the tile,
// keys tx + 16 jj (jj < KN) of each key tile, and output dims
// c*16*VW + tx*VW + e (c < NC, e < VW). K and V arrive by cp.async, one
// buffer each: K's next tile loads during this tile's softmax and PV,
// V's next tile during the next tile's scores.
template <int HD, int BQ>
__global__ void __launch_bounds__(4 * BQ)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int64_t T_len,
                 int64_t S_len, int nq, int nkv, int64_t window, float scale) {
  using C = Cfg<HD, BQ>;
  constexpr int NT = C::NT, BK = C::BK, RPT = C::RPT, KN = C::KN, DPT = C::DPT,
                VW = C::VW, NC = C::NC;
  constexpr int QP = C::QP, KP = C::KP;
  extern __shared__ float4 smem_raw[];
  float* qT = reinterpret_cast<float*>(smem_raw);   // [HD][QP], scaled q
  float* ks = qT + HD * QP;                          // [BK][KP]
  float* vs = ks + BK * KP;                          // [BK][HD]
  float* pT = vs + BK * HD;                          // [BK][QP]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const TileIdx ti = tile_index();
  const int qt = ti.qt, h = ti.h;
  const int64_t b = ti.b;
  const int group = nq / nkv;
  const int kvh = h / group;
  const int64_t q0 = static_cast<int64_t>(qt) * BQ;
  const int64_t q_last = min(q0 + BQ, T_len) - 1;
  const int64_t kv_stride = static_cast<int64_t>(nkv) * HD;
  const float* k_base = k + (b * S_len * nkv + kvh) * HD;
  const float* v_base = v + (b * S_len * nkv + kvh) * HD;

  // live key tiles: [kt_lo, kt_hi)
  const int64_t n_kt = (S_len + BK - 1) / BK;
  const int64_t kt_hi = min(n_kt, q_last / BK + 1);
  int64_t kt_lo = 0;
  if (window > 0) {
    const int64_t first = q0 - window + 1;  // first key the first row sees
    if (first > 0) kt_lo = first / BK;
  }
  if (kt_lo < kt_hi) {
    const int64_t k0 = kt_lo * BK;
    load_rows_f32<HD, BK, KP, NT>(ks, k_base + k0 * kv_stride, kv_stride, S_len - k0, tid);
    cp_async_commit();
    load_rows_f32<HD, BK, HD, NT>(vs, v_base + k0 * kv_stride, kv_stride, S_len - k0, tid);
    cp_async_commit();
  }

  // q tile, transposed and scaled; rows past T are zero
  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    const int64_t t = q0 + r;
    float x = 0.f;
    if (t < T_len) x = q[((b * T_len + t) * nq + h) * HD + d] * scale;
    qT[d * QP + r] = x;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  for (int64_t kt = kt_lo; kt < kt_hi; ++kt) {
    const int64_t k0 = kt * BK;
    const bool more = kt + 1 < kt_hi;
    cp_async_wait<1>();   // K of this tile (its V may still be landing)
    __syncthreads();

    // scores: s[i][jj] = q[row i] . k[key tx + 16 jj], summed over d in order
    float sc[RPT][KN];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int jj = 0; jj < KN; ++jj) sc[i][jj] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float qa[4][RPT];
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) load_vec<RPT>(qT + (d + dd) * QP + ty * RPT, qa[dd]);
#pragma unroll
      for (int jj = 0; jj < KN; ++jj) {
        float kb[4];
        load_vec<4>(ks + (tx + 16 * jj) * KP + d, kb);
#pragma unroll
        for (int dd = 0; dd < 4; ++dd)
#pragma unroll
          for (int i = 0; i < RPT; ++i) sc[i][jj] = fmaf(qa[dd][i], kb[dd], sc[i][jj]);
      }
    }
    __syncthreads();   // every thread is done with K
    if (more) {
      const int64_t k1 = k0 + BK;
      load_rows_f32<HD, BK, KP, NT>(ks, k_base + k1 * kv_stride, kv_stride, S_len - k1, tid);
      cp_async_commit();
    }

    // mask, online softmax, P to shared memory
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int64_t t = q0 + ty * RPT + i;
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < KN; ++jj) {
        const int64_t s = k0 + tx + 16 * jj;
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
    for (int jj = 0; jj < KN; ++jj) {
      *reinterpret_cast<float4*>(pT + (tx + 16 * jj) * QP + ty * RPT) =
          make_float4(sc[0][jj], sc[1][jj], sc[2][jj], sc[3][jj]);
    }
    if (more) cp_async_wait<1>(); else cp_async_wait<0>();   // V of this tile
    __syncthreads();

    // acc[i][dims] += sum_j p[i][j] * v[j][dims]
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pa[RPT];
      load_vec<RPT>(pT + j * QP + ty * RPT, pa);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float vb[VW];
        load_vec<VW>(vs + j * HD + c * 16 * VW + tx * VW, vb);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int e = 0; e < VW; ++e)
            acc[i][c * VW + e] = fmaf(pa[i], vb[e], acc[i][c * VW + e]);
      }
    }
    __syncthreads();   // every thread is done with V and P
    if (more) {
      const int64_t k1 = k0 + BK;
      load_rows_f32<HD, BK, HD, NT>(vs, v_base + k1 * kv_stride, kv_stride, S_len - k1, tid);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int64_t t = q0 + ty * RPT + i;
    if (t >= T_len) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* row = out + ((b * T_len + t) * nq + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < VW; ++e) row[c * 16 * VW + tx * VW + e] = acc[i][c * VW + e] / denom;
  }
}

template <int HD, int BQ>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, int64_t B,
                       int64_t T_len, int64_t S_len, int64_t nq, int64_t nkv,
                       int64_t window, float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * Cfg<HD, BQ>::SMEM_FLOATS;
  auto kern = flash_f32_kernel<HD, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((T_len + BQ - 1) / BQ),
                  static_cast<unsigned>(nq), static_cast<unsigned>(B));
  kern<<<grid, Cfg<HD, BQ>::NT, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), T_len, S_len,
      static_cast<int>(nq), static_cast<int>(nkv), window, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* out, int64_t B,
                         int64_t T_len, int64_t S_len, int64_t nq, int64_t nkv,
                         int64_t window, int64_t block_q, float scale, cudaStream_t st) {
  if (block_q == 64)
    return launch_f32<HD, 64>(q, k, v, out, B, T_len, S_len, nq, nkv, window, scale, st);
  if (block_q == 32)
    return launch_f32<HD, 32>(q, k, v, out, B, T_len, S_len, nq, nkv, window, scale, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_half(const void* q, const void* k, const void* v, void* out, int64_t B,
                          int64_t T_len, int64_t S_len, int64_t nq, int64_t nkv,
                          int64_t hd, int64_t window, float scale, cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch_half<T, 32>(q, k, v, out, B, T_len, S_len, nq, nkv, window, scale, st);
    case 64:
      return launch_half<T, 64>(q, k, v, out, B, T_len, S_len, nq, nkv, window, scale, st);
    case 128:
      return launch_half<T, 128>(q, k, v, out, B, T_len, S_len, nq, nkv, window, scale, st);
    case 256:
      return launch_half<T, 256>(q, k, v, out, B, T_len, S_len, nq, nkv, window, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_f32_hd(const void* q, const void* k, const void* v, void* out,
                            int64_t B, int64_t T_len, int64_t S_len, int64_t nq,
                            int64_t nkv, int64_t hd, int64_t window, int64_t block_q,
                            float scale, cudaStream_t st) {
  switch (hd) {
    case 32:
      return dispatch_f32<32>(q, k, v, out, B, T_len, S_len, nq, nkv, window, block_q, scale, st);
    case 64:
      return dispatch_f32<64>(q, k, v, out, B, T_len, S_len, nq, nkv, window, block_q, scale, st);
    case 128:
      return dispatch_f32<128>(q, k, v, out, B, T_len, S_len, nq, nkv, window, block_q, scale,
                               st);
    case 256:
      return dispatch_f32<256>(q, k, v, out, B, T_len, S_len, nq, nkv, window, block_q, scale,
                               st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, T, nq, hd), k / v (B, S, nkv, hd), out (B, T, nq, hd), all
// row-major of `dtype`, 16-byte aligned; hd in {32, 64, 128, 256}; nq a
// multiple of nkv; window 0 = none. block_q: the fp32 route's query
// tile, 64 or 32; the bf16 / fp16 route takes 64 only.
int flash_attn_fwd(const void* q, const void* k, const void* v, void* out, int64_t B,
                   int64_t T_len, int64_t S_len, int64_t nq, int64_t nkv, int64_t hd,
                   int64_t dtype, int64_t window, int64_t block_q, void* stream) {
  if (B <= 0 || T_len <= 0 || S_len <= 0 || nkv <= 0 || nq % nkv != 0 || window < 0 ||
      T_len > INT32_MAX || S_len > INT32_MAX || window > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = static_cast<float>(pow(static_cast<double>(hd), -0.5));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return static_cast<int>(dispatch_f32_hd(q, k, v, out, B, T_len, S_len, nq, nkv, hd,
                                              window, block_q, scale, st));
    case kBF16:
      if (block_q != kHalfBQ) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(dispatch_half<__nv_bfloat16>(q, k, v, out, B, T_len, S_len, nq,
                                                           nkv, hd, window, scale, st));
    case kF16:
      if (block_q != kHalfBQ) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(dispatch_half<__half>(q, k, v, out, B, T_len, S_len, nq, nkv,
                                                    hd, window, scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
