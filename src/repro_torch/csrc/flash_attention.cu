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
// lse: when the caller passes a (B, nq, T) fp32 buffer, each route also
// writes the rows' logsumexp of the scaled scores, max + log(sum), the
// sum floored at 1e-30 (blockwise_attention's `lse`), for the backward.
// Each kernel is instantiated with and without that store (template
// flag LSE); the serving path passes null and runs the instance
// without it, the same code as before the flag. One instance with a
// runtime null check instead timed 10-13% slower on the H100 at the
// Qwen2 prefill and Zamba2 shared-block shapes in bf16.
//
// flash_attn_bwd is the backward of the reference model's
// blockwise_attention custom VJP (repro/models/layers/attention.py
// :217-303; no Pallas kernel computes it): with p = exp(s * scale - lse)
// recomputed from the saved lse and delta = rowsum(dO * O),
//     dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta) * scale,
//     dQ = dS K,    dK = dS^T Q,
// p and dS rounded to the input dtype before the products they feed
// (the reference's pb / dsb, :258-266), every sum in fp32. T == S.
// Bound: operations. At 10 * hd FLOPs a live score (S recomputed, dV,
// dP, dQ, dK) against ~5 * (nq + nkv) * hd * 2 bytes a token, the
// Qwen2 training layer (4, 512, 14 / 2, 64) needs 4.7 GFLOP and 17 MB.
// This first design runs on the CUDA cores for every dtype (fp32 FMAs;
// p and dS rounded through the storage type), four kernels a call, no
// float atomics, so two calls are bitwise equal:
//   1. bwd_delta_kernel: delta per (b, t, h), one warp a row;
//   2. bwd_dkdv_kernel: one 256-thread block per (b, q head, key tile of
//      BT keys) holds K, V of its tile and loops over the live query
//      tiles (causal, window), recomputing S and dP on a 16 x 16 thread
//      grid and accumulating dK, dV in registers; with GQA it writes
//      fp32 partials per q head, else dk / dv directly;
//   3. bwd_dq_kernel: one block per (b, q head, query tile) holds Q, dO,
//      recomputes S, dP, dS over the live key tiles, accumulates dQ;
//   4. bwd_group_sum_kernel (GQA only): dk, dv = the partials of a kv
//      head's q heads summed in head order, cast to the input dtype.
// S and dP are computed twice (in 2 and 3): 14 * hd FLOPs a live score
// against the 10 of the bound. Tensor cores (wgmma + TMA) come later.
//
// The kernels allocate nothing; each entry point returns the
// cudaGetLastError() of its launches.

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
template <typename T, int HD, bool LSE>
__global__ void __launch_bounds__(kHalfThreads)
flash_half_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
                  int T_len, int S_len, int nq, int nkv, int window, float scale,
                  float scale_log2) {
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
  if (LSE && cq == 0) {   // m is the max of the unscaled scores
    float* row = lse + (b * nq + h) * static_cast<int64_t>(T_len);
    if (t_lo < T_len) row[t_lo] = m_lo * scale + logf(fmaxf(l_lo, 1e-30f));
    if (t_hi < T_len) row[t_hi] = m_hi * scale + logf(fmaxf(l_hi, 1e-30f));
  }
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
cudaError_t launch_half(const void* q, const void* k, const void* v, void* out, float* lse,
                        int64_t B, int64_t T_len, int64_t S_len, int64_t nq, int64_t nkv,
                        int64_t window, float scale, cudaStream_t st) {
  constexpr int smem = HalfCfg<HD>::SMEM_BYTES;
  // the serving path (no lse) runs an instance without the store
  auto kern = lse != nullptr ? flash_half_kernel<T, HD, true> : flash_half_kernel<T, HD, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((T_len + kHalfBQ - 1) / kHalfBQ),
                  static_cast<unsigned>(nq), static_cast<unsigned>(B));
  kern<<<grid, kHalfThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, static_cast<int>(T_len), static_cast<int>(S_len),
      static_cast<int>(nq), static_cast<int>(nkv), static_cast<int>(window), scale,
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
template <int HD, int BQ, bool LSE>
__global__ void __launch_bounds__(4 * BQ)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int64_t T_len, int64_t S_len, int nq, int nkv,
                 int64_t window, float scale) {
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
    if (LSE && tx == 0)   // q was scaled: m is in scaled units
      lse[(b * nq + h) * T_len + t] = m[i] + logf(denom);
    float* row = out + ((b * T_len + t) * nq + h) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < VW; ++e) row[c * 16 * VW + tx * VW + e] = acc[i][c * VW + e] / denom;
  }
}

template <int HD, int BQ>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out, float* lse,
                       int64_t B, int64_t T_len, int64_t S_len, int64_t nq, int64_t nkv,
                       int64_t window, float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * Cfg<HD, BQ>::SMEM_FLOATS;
  auto kern = lse != nullptr ? flash_f32_kernel<HD, BQ, true> : flash_f32_kernel<HD, BQ, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((T_len + BQ - 1) / BQ),
                  static_cast<unsigned>(nq), static_cast<unsigned>(B));
  kern<<<grid, Cfg<HD, BQ>::NT, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, T_len, S_len,
      static_cast<int>(nq), static_cast<int>(nkv), window, scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* out, float* lse,
                         int64_t B,
                         int64_t T_len, int64_t S_len, int64_t nq, int64_t nkv,
                         int64_t window, int64_t block_q, float scale, cudaStream_t st) {
  if (block_q == 64)
    return launch_f32<HD, 64>(q, k, v, out, lse, B, T_len, S_len, nq, nkv, window, scale, st);
  if (block_q == 32)
    return launch_f32<HD, 32>(q, k, v, out, lse, B, T_len, S_len, nq, nkv, window, scale, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_half(const void* q, const void* k, const void* v, void* out, float* lse,
                          int64_t B,
                          int64_t T_len, int64_t S_len, int64_t nq, int64_t nkv,
                          int64_t hd, int64_t window, float scale, cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch_half<T, 32>(q, k, v, out, lse, B, T_len, S_len, nq, nkv, window, scale,
                                  st);
    case 64:
      return launch_half<T, 64>(q, k, v, out, lse, B, T_len, S_len, nq, nkv, window, scale,
                                  st);
    case 128:
      return launch_half<T, 128>(q, k, v, out, lse, B, T_len, S_len, nq, nkv, window, scale,
                                  st);
    case 256:
      return launch_half<T, 256>(q, k, v, out, lse, B, T_len, S_len, nq, nkv, window, scale,
                                  st);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_f32_hd(const void* q, const void* k, const void* v, void* out,
                            float* lse, int64_t B, int64_t T_len, int64_t S_len, int64_t nq,
                            int64_t nkv, int64_t hd, int64_t window, int64_t block_q,
                            float scale, cudaStream_t st) {
  switch (hd) {
    case 32:
      return dispatch_f32<32>(q, k, v, out, lse, B, T_len, S_len, nq, nkv, window, block_q,
                                scale, st);
    case 64:
      return dispatch_f32<64>(q, k, v, out, lse, B, T_len, S_len, nq, nkv, window, block_q,
                                scale, st);
    case 128:
      return dispatch_f32<128>(q, k, v, out, lse, B, T_len, S_len, nq, nkv, window, block_q,
                                 scale, st);
    case 256:
      return dispatch_f32<256>(q, k, v, out, lse, B, T_len, S_len, nq, nkv, window, block_q,
                                 scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// backward: CUDA cores, every dtype
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

// x rounded to the storage type (the reference's astype), back in fp32
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f<T>(from_f<T>(x)); }

constexpr int kBwdThreads = 256;   // a 16 x 16 thread grid

template <int HD>
struct BwdCfg {
  static constexpr int BT = HD <= 128 ? 64 : 32;   // rows of a query or key tile
  static constexpr int R = BT / 16;                // tile rows a thread owns
  static constexpr int DC = HD / 16;               // dims a thread owns
  static constexpr int P = HD + 1;                 // pitch of a (BT x HD) tile
  static constexpr int PT = BT + 1;                // pitch of a (BT x BT) tile
  static constexpr int TILE = BT * P;              // floats of a (BT x HD) tile
  // dK / dV blocks: K, V, Q, dO, P, dS, lse, delta
  static constexpr int DKDV_FLOATS = 4 * TILE + 2 * BT * PT + 2 * BT;
  // dQ blocks: Q, dO, K, V, dS, lse, delta
  static constexpr int DQ_FLOATS = 4 * TILE + BT * PT + 2 * BT;
};

// rows [0, BT) of a (rows x HD) slice whose row r starts at src + r *
// stride, as fp32 at pitch HD + 1; rows at or past `valid` are zero
template <typename T, int HD, int BT>
__device__ __forceinline__ void load_rows_bwd(float* dst, const T* __restrict__ src,
                                              int64_t stride, int valid, int tid) {
  for (int i = tid; i < BT * HD; i += kBwdThreads) {
    const int r = i / HD, d = i % HD;
    dst[r * (HD + 1) + d] = r < valid ? to_f<T>(src[r * stride + d]) : 0.f;
  }
}

// delta[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d] in fp32, one warp
// a row (lanes over d, a butterfly sum: a fixed order)
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                 float* __restrict__ delta, int64_t rows, int T_len, int nq, int hd) {
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kBwdThreads + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + row * hd;
  const T* g = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_f<T>(g[d]), to_f<T>(o[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int64_t h = row % nq, bt = row / nq;   // row = (b * T + t) * nq + h
    const int64_t t = bt % T_len, b = bt / T_len;
    delta[(b * nq + h) * T_len + t] = acc;
  }
}

// Scores of one (query tile q0, key tile k0) pair on the 16 x 16 grid:
// thread (ty, tx) owns queries q0 + ty + 16 a and keys k0 + tx + 16 c.
// Two passes, so that only one R x R accumulator is live beside the
// caller's: S = Q K^T gives p = exp(s * scale - lse) (0 where masked),
// kept unrounded in sS (and, when sPr is given, rounded to the storage
// type in sPr); then dP = dO V^T gives ds = p * (dp - delta) * scale,
// stored rounded in sS. Each thread reads back only what it wrote, so
// the passes need no barrier; the caller syncs before reading sS / sPr.
// The two tile kernels declare two blocks an SM: without it ptxas holds
// the hd-64 instances to 64 registers (four blocks) and spills.
template <typename T, int HD>
__device__ __forceinline__ void tile_p_ds(const float* sQ, const float* sdO, const float* sK,
                                          const float* sV, const float* sL, const float* sD,
                                          float* sPr, float* sS, int q0, int k0, int T_len,
                                          int window, float scale, int ty, int tx) {
  using C = BwdCfg<HD>;
  constexpr int R = C::R, P = C::P, PT = C::PT;
  float acc[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < R; ++c) acc[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qa[R], kb[R];
#pragma unroll
    for (int a = 0; a < R; ++a) qa[a] = sQ[(ty + 16 * a) * P + d];
#pragma unroll
    for (int c = 0; c < R; ++c) kb[c] = sK[(tx + 16 * c) * P + d];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < R; ++c) acc[a][c] = fmaf(qa[a], kb[c], acc[a][c]);
  }
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = ty + 16 * a, t = q0 + i;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int j = tx + 16 * c, key = k0 + j;
      bool live = t < T_len && key < T_len && key <= t;
      if (window > 0) live = live && t - key < window;
      const float p = live ? expf(acc[a][c] * scale - sL[i]) : 0.f;
      sS[i * PT + j] = p;
      if (sPr != nullptr) sPr[i * PT + j] = round_to<T>(p);
      acc[a][c] = 0.f;
    }
  }
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float ga[R], vb[R];
#pragma unroll
    for (int a = 0; a < R; ++a) ga[a] = sdO[(ty + 16 * a) * P + d];
#pragma unroll
    for (int c = 0; c < R; ++c) vb[c] = sV[(tx + 16 * c) * P + d];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < R; ++c) acc[a][c] = fmaf(ga[a], vb[c], acc[a][c]);
  }
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = ty + 16 * a;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      float* at = sS + i * PT + tx + 16 * c;
      *at = round_to<T>(*at * (acc[a][c] - sD[i]) * scale);
    }
  }
}

// grid (ceil(T / BT), nq, B): the block of key tile blockIdx.x of q head
// h. dK, dV of its BT keys accumulate in registers over the live query
// tiles: thread (ty, tx) owns keys ty + 16 a and dims tx + 16 c.
template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads, 2)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                float* __restrict__ work, int T_len, int nq, int nkv, int window,
                float scale) {
  using C = BwdCfg<HD>;
  constexpr int BT = C::BT, R = C::R, DC = C::DC, P = C::P, PT = C::PT;
  extern __shared__ float4 smem_bwd[];
  float* sK = reinterpret_cast<float*>(smem_bwd);
  float* sV = sK + C::TILE;
  float* sQ = sV + C::TILE;
  float* sdO = sQ + C::TILE;
  float* sP = sdO + C::TILE;
  float* sS = sP + BT * PT;   // dS
  float* sL = sS + BT * PT;
  float* sD = sL + BT;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int kt = blockIdx.x, h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int kvh = h / (nq / nkv);
  const int k0 = kt * BT;
  const int64_t q_stride = static_cast<int64_t>(nq) * HD;
  const int64_t kv_stride = static_cast<int64_t>(nkv) * HD;
  load_rows_bwd<T, HD, BT>(sK, k + (b * T_len + k0) * kv_stride + kvh * HD, kv_stride,
                           T_len - k0, tid);
  load_rows_bwd<T, HD, BT>(sV, v + (b * T_len + k0) * kv_stride + kvh * HD, kv_stride,
                           T_len - k0, tid);

  // live query tiles: from the diagonal to the window's far edge
  const int n_t = (T_len + BT - 1) / BT;
  int qt_hi = n_t;
  if (window > 0) qt_hi = min(n_t, (k0 + BT - 2 + window) / BT + 1);

  float acc_k[R][DC], acc_v[R][DC];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc_k[a][c] = acc_v[a][c] = 0.f;

  const float* lse_row = lse + (b * nq + h) * static_cast<int64_t>(T_len);
  const float* delta_row = delta + (b * nq + h) * static_cast<int64_t>(T_len);
  for (int qt = kt; qt < qt_hi; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();   // the previous tile's Q, dO, P, dS are consumed
    load_rows_bwd<T, HD, BT>(sQ, q + (b * T_len + q0) * q_stride + h * HD, q_stride,
                             T_len - q0, tid);
    load_rows_bwd<T, HD, BT>(sdO, dout + (b * T_len + q0) * q_stride + h * HD, q_stride,
                             T_len - q0, tid);
    for (int i = tid; i < BT; i += kBwdThreads) {
      const bool ok = q0 + i < T_len;
      sL[i] = ok ? lse_row[q0 + i] : 0.f;
      sD[i] = ok ? delta_row[q0 + i] : 0.f;
    }
    __syncthreads();

    tile_p_ds<T, HD>(sQ, sdO, sK, sV, sL, sD, sP, sS, q0, k0, T_len, window, scale, ty,
                     tx);
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q over the tile's queries, in order
#pragma unroll 2
    for (int i = 0; i < BT; ++i) {
      float pa[R], sa[R], gb[DC], qb[DC];
#pragma unroll
      for (int a = 0; a < R; ++a) {
        pa[a] = sP[i * PT + ty + 16 * a];
        sa[a] = sS[i * PT + ty + 16 * a];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        gb[c] = sdO[i * P + tx + 16 * c];
        qb[c] = sQ[i * P + tx + 16 * c];
      }
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          acc_v[a][c] = fmaf(pa[a], gb[c], acc_v[a][c]);
          acc_k[a][c] = fmaf(sa[a], qb[c], acc_k[a][c]);
        }
    }
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= T_len) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = tx + 16 * c;
      if (work == nullptr) {   // one q head a kv head: the final values
        const int64_t at = ((b * T_len + key) * nkv + kvh) * HD + d;
        dk[at] = from_f<T>(acc_k[a][c]);
        dv[at] = from_f<T>(acc_v[a][c]);
      } else {   // this q head's fp32 partials, (2, B, S, nq, HD)
        const int64_t at = ((b * T_len + key) * nq + h) * HD + d;
        work[at] = acc_k[a][c];
        work[at + static_cast<int64_t>(gridDim.z) * T_len * nq * HD] = acc_v[a][c];
      }
    }
  }
}

// grid (ceil(T / BT), nq, B), late query tiles first: the block of one
// query tile of q head h. dQ accumulates in registers over the live key
// tiles: thread (ty, tx) owns queries ty + 16 a and dims tx + 16 c.
template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads, 2)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, int T_len, int nq, int nkv,
              int window, float scale) {
  using C = BwdCfg<HD>;
  constexpr int BT = C::BT, R = C::R, DC = C::DC, P = C::P, PT = C::PT;
  extern __shared__ float4 smem_bwd[];
  float* sQ = reinterpret_cast<float*>(smem_bwd);
  float* sdO = sQ + C::TILE;
  float* sK = sdO + C::TILE;
  float* sV = sK + C::TILE;
  float* sS = sV + C::TILE;
  float* sL = sS + BT * PT;
  float* sD = sL + BT;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int kvh = h / (nq / nkv);
  const int q0 = qt * BT;
  const int q_last = min(q0 + BT, T_len) - 1;
  const int64_t q_stride = static_cast<int64_t>(nq) * HD;
  const int64_t kv_stride = static_cast<int64_t>(nkv) * HD;
  load_rows_bwd<T, HD, BT>(sQ, q + (b * T_len + q0) * q_stride + h * HD, q_stride,
                           T_len - q0, tid);
  load_rows_bwd<T, HD, BT>(sdO, dout + (b * T_len + q0) * q_stride + h * HD, q_stride,
                           T_len - q0, tid);
  const float* lse_row = lse + (b * nq + h) * static_cast<int64_t>(T_len);
  const float* delta_row = delta + (b * nq + h) * static_cast<int64_t>(T_len);
  for (int i = tid; i < BT; i += kBwdThreads) {
    const bool ok = q0 + i < T_len;
    sL[i] = ok ? lse_row[q0 + i] : 0.f;
    sD[i] = ok ? delta_row[q0 + i] : 0.f;
  }

  // live key tiles [kt_lo, kt_hi), as the forward's
  const int kt_hi = q_last / BT + 1;
  int kt_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / BT;

  float acc[R][DC];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();   // the previous tile's K, dS are consumed
    load_rows_bwd<T, HD, BT>(sK, k + (b * T_len + k0) * kv_stride + kvh * HD, kv_stride,
                             T_len - k0, tid);
    load_rows_bwd<T, HD, BT>(sV, v + (b * T_len + k0) * kv_stride + kvh * HD, kv_stride,
                             T_len - k0, tid);
    __syncthreads();

    tile_p_ds<T, HD>(sQ, sdO, sK, sV, sL, sD, nullptr, sS, q0, k0, T_len, window, scale, ty,
                     tx);
    __syncthreads();

    // dQ += dS K over the tile's keys, in order
#pragma unroll 2
    for (int j = 0; j < BT; ++j) {
      float sa[R], kb[DC];
#pragma unroll
      for (int a = 0; a < R; ++a) sa[a] = sS[(ty + 16 * a) * PT + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) kb[c] = sK[j * P + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[a][c] = fmaf(sa[a], kb[c], acc[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int t = q0 + ty + 16 * a;
    if (t >= T_len) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dq[((b * T_len + t) * nq + h) * HD + tx + 16 * c] = from_f<T>(acc[a][c]);
  }
}

// dk, dv (B, S, nkv, HD) = the fp32 partials of each kv head's q heads,
// summed in head order, cast to the input dtype
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
bwd_group_sum_kernel(const float* __restrict__ work, T* __restrict__ dk, T* __restrict__ dv,
                     int64_t n, int nkv, int group, int hd) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBwdThreads + threadIdx.x;
  if (i >= n) return;   // i = ((b * S + s) * nkv + kvh) * hd + d
  const int64_t d = i % hd, bsk = i / hd;
  const int64_t kvh = bsk % nkv, bs = bsk / nkv;
  const int64_t nq = static_cast<int64_t>(nkv) * group;
  const float* src = work + (bs * nq + kvh * group) * hd + d;
  const int64_t half = n * group;   // the dV partials follow the dK ones
  float sk = 0.f, sv = 0.f;
  for (int j = 0; j < group; ++j) {
    sk += src[j * hd];
    sv += src[half + j * hd];
  }
  dk[i] = from_f<T>(sk);
  dv[i] = from_f<T>(sv);
}

template <typename T, int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* out,
                       const void* dout, const float* lse, void* dq, void* dk, void* dv,
                       float* delta, float* work, int64_t B, int64_t T_len, int64_t nq,
                       int64_t nkv, int64_t window, float scale, cudaStream_t st) {
  using C = BwdCfg<HD>;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const int64_t rows = B * T_len * nq;
  bwd_delta_kernel<T><<<static_cast<unsigned>((rows * 32 + kBwdThreads - 1) / kBwdThreads),
                        kBwdThreads, 0, st>>>(static_cast<const T*>(out), gt, delta, rows,
                                              static_cast<int>(T_len), static_cast<int>(nq),
                                              HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid(static_cast<unsigned>((T_len + C::BT - 1) / C::BT),
                  static_cast<unsigned>(nq), static_cast<unsigned>(B));
  const int smem_kv = static_cast<int>(sizeof(float) * C::DKDV_FLOATS);
  auto kern_kv = bwd_dkdv_kernel<T, HD>;
  err = cudaFuncSetAttribute(kern_kv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return err;
  kern_kv<<<grid, kBwdThreads, smem_kv, st>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), work,
      static_cast<int>(T_len), static_cast<int>(nq), static_cast<int>(nkv),
      static_cast<int>(window), scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int smem_q = static_cast<int>(sizeof(float) * C::DQ_FLOATS);
  auto kern_q = bwd_dq_kernel<T, HD>;
  err = cudaFuncSetAttribute(kern_q, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return err;
  kern_q<<<grid, kBwdThreads, smem_q, st>>>(
      qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), static_cast<int>(T_len),
      static_cast<int>(nq), static_cast<int>(nkv), static_cast<int>(window), scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || work == nullptr) return err;

  const int64_t n = B * T_len * nkv * HD;
  bwd_group_sum_kernel<T><<<static_cast<unsigned>((n + kBwdThreads - 1) / kBwdThreads),
                            kBwdThreads, 0, st>>>(work, static_cast<T*>(dk),
                                                  static_cast<T*>(dv), n,
                                                  static_cast<int>(nkv),
                                                  static_cast<int>(nq / nkv), HD);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const void* q, const void* k, const void* v, const void* out,
                         const void* dout, const float* lse, void* dq, void* dk, void* dv,
                         float* delta, float* work, int64_t B, int64_t T_len, int64_t nq,
                         int64_t nkv, int64_t hd, int64_t window, float scale,
                         cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch_bwd<T, 32>(q, k, v, out, dout, lse, dq, dk, dv, delta, work, B, T_len, nq,
                               nkv, window, scale, st);
    case 64:
      return launch_bwd<T, 64>(q, k, v, out, dout, lse, dq, dk, dv, delta, work, B, T_len, nq,
                               nkv, window, scale, st);
    case 128:
      return launch_bwd<T, 128>(q, k, v, out, dout, lse, dq, dk, dv, delta, work, B, T_len,
                                nq, nkv, window, scale, st);
    case 256:
      return launch_bwd<T, 256>(q, k, v, out, dout, lse, dq, dk, dv, delta, work, B, T_len,
                                nq, nkv, window, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, T, nq, hd), k / v (B, S, nkv, hd), out (B, T, nq, hd), all
// row-major of `dtype`, 16-byte aligned; hd in {32, 64, 128, 256}; nq a
// multiple of nkv; window 0 = none. block_q: the fp32 route's query
// tile, 64 or 32; the bf16 / fp16 route takes 64 only. lse: null, or
// (B, nq, T) fp32 for the rows' logsumexp.
int flash_attn_fwd(const void* q, const void* k, const void* v, void* out, void* lse_out,
                   int64_t B,
                   int64_t T_len, int64_t S_len, int64_t nq, int64_t nkv, int64_t hd,
                   int64_t dtype, int64_t window, int64_t block_q, void* stream) {
  if (B <= 0 || T_len <= 0 || S_len <= 0 || nkv <= 0 || nq % nkv != 0 || window < 0 ||
      T_len > INT32_MAX || S_len > INT32_MAX || window > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = static_cast<float>(pow(static_cast<double>(hd), -0.5));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  switch (dtype) {
    case kF32:
      return static_cast<int>(dispatch_f32_hd(q, k, v, out, lse, B, T_len, S_len, nq, nkv, hd,
                                              window, block_q, scale, st));
    case kBF16:
      if (block_q != kHalfBQ) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(dispatch_half<__nv_bfloat16>(q, k, v, out, lse, B, T_len, S_len,
                                                           nq, nkv, hd, window, scale, st));
    case kF16:
      if (block_q != kHalfBQ) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(dispatch_half<__half>(q, k, v, out, lse, B, T_len, S_len, nq,
                                                    nkv, hd, window, scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward of flash_attn_fwd (T == S): q, dq (B, T, nq, hd); k, v,
// dk, dv (B, T, nkv, hd); out, dout (B, T, nq, hd), all of `dtype`; lse
// (B, nq, T) fp32 from flash_attn_fwd; delta (B, nq, T) fp32 scratch;
// work: null when nq == nkv, else (2, B, T, nq, hd) fp32 scratch for the
// per-q-head dK / dV partials.
int flash_attn_bwd(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const void* lse, void* dq, void* dk, void* dv,
                   void* delta, void* work, int64_t B, int64_t T_len, int64_t nq,
                   int64_t nkv, int64_t hd, int64_t dtype, int64_t window, void* stream) {
  if (B <= 0 || T_len <= 0 || nkv <= 0 || nq % nkv != 0 || window < 0 ||
      T_len > INT32_MAX || window > INT32_MAX || (nq != nkv && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = static_cast<float>(pow(static_cast<double>(hd), -0.5));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* w = nq == nkv ? nullptr : static_cast<float*>(work);
  switch (dtype) {
    case kF32:
      return static_cast<int>(dispatch_bwd<float>(q, k, v, out, dout, l, dq, dk, dv, dl, w, B,
                                                  T_len, nq, nkv, hd, window, scale, st));
    case kBF16:
      return static_cast<int>(dispatch_bwd<__nv_bfloat16>(q, k, v, out, dout, l, dq, dk, dv,
                                                          dl, w, B, T_len, nq, nkv, hd,
                                                          window, scale, st));
    case kF16:
      return static_cast<int>(dispatch_bwd<__half>(q, k, v, out, dout, l, dq, dk, dv, dl, w,
                                                   B, T_len, nq, nkv, hd, window, scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
