// GQA flash attention (prefill, encoder, cross attention) for Hopper
// (sm_90a).
//
// flash_attn_fwd replaces repro/kernels/flash_attention/kernel.py
// flash_attention (the pallas_call at :116, body _flash_kernel :26-76):
//     out[b, t, h] = softmax_s(q[b, t, h] . k[b, s, h / group] * hd^-0.5)
//                    . v[b, s, h / group]
// over the keys s that are live for query t: s <= t when causal (the
// decoders' self-attention), every s < S when not (the encoder-decoder's
// encoder and its cross attention of T decoder positions over S encoder
// frames); and with window > 0 also t - s < window, one-sided as in the
// Pallas kernel (non-causal, every key after t stays live). q (B, T, nq,
// hd), k / v (B, S, nkv, hd) row-major in fp32, bf16 or fp16; out (B, T,
// nq, hd) in q's dtype. The kv head is h / group, so K / V are never
// duplicated (GQA of any group, MQA, MHA). Ragged T and S are masked in
// the kernel: no shape is refused.
//
// causal is a template flag of both routes (CAUSAL), not a runtime
// branch: it sets the last live key tile (the diagonal's, or S's) and
// whether a tile's edge test and mask look at the diagonal; a non-causal
// instance holds no diagonal test at all. (A uniform runtime branch, the
// lse store's, cost the forward 10-13%; see LSE below.)
//
// Bound: operations. Attention does 4 * hd FLOPs per live score against
// 2 * (nq + nkv) * hd bytes of q, k, v and out per token, so at the
// Qwen2 / Gemma3 / Zamba2 prefill shapes and Whisper's encoder and cross
// attention the FLOPs dominate in every dtype. Two routes, by dtype:
//
// bf16 / fp16: tensor cores (flash_half_kernel). FlashAttention-2 on
// mma.sync.m16n8k16 with fp32 accumulators:
//   * 4 warps own a BQ = 64-row query tile of one (batch, q head), 16
//     rows a warp; the late query tiles of every head, which hold the
//     most live keys, launch first, to even out the causal triangle
//     (non-causal, every tile holds all S keys and the order evens out
//     nothing);
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
//     tiles that cross the diagonal (causal only), the window's edge or
//     S.
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
// memory, so they add 0, never NaN (non-causal with no window, no row is
// wholly masked, and only S's edge tile is masked). Tiles wholly masked
// (above the diagonal, or wholly before the window) are never loaded.
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
// (the reference's pb / dsb, :258-266), every sum in fp32, over the live
// (t, s) pairs of the forward: any T and S, causal or not, with the same
// one-sided window. causal is a template flag of the four tile kernels,
// as in the forward (CAUSAL): a non-causal instance holds no diagonal
// test, its dK / dV blocks visit query tiles from 0 and its dQ blocks key
// tiles up to the last of S. Q, dO, lse and delta count rows to T; K, V,
// dK, dV and the partials to S. A key that no live query reaches gets
// dK = dV = 0.
// Bound: operations. Five products of 2 * hd FLOPs a live score (S
// recomputed, dV, dP, dQ, dK) against ~5 * (nq + nkv) * hd * 2 bytes a
// token: the Qwen2 training layer (4, 512, 14 / 2, 64) needs 4.7 GFLOP,
// 4.8 us at 989 TFLOP/s in bf16 (fp32: 70 us at the CUDA cores' 67
// TFLOP/s, 44 us at a third of mma.sync TF32's measured 323), and 17 MB,
// 5.0 us at 3.35 TB/s. Four
// kernels a call, no float atomics, so two calls are bitwise equal:
//   1. bwd_delta_kernel: delta per (b, t, h), 16-byte loads, up to a warp
//      a row;
//   2. dK / dV: one block per (key tile of S, q head, batch) holds K, V
//      of its keys and loops over the live query tiles (from the diagonal,
//      or 0 when not causal, to the window's far edge), accumulating dK,
//      dV; with GQA it writes fp32 partials per q head, else dk / dv
//      directly;
//   3. dQ: one block per (query tile of T, q head, batch), late tiles
//      first, holds Q, dO and loops over the live key tiles (from the
//      window's near edge to the diagonal, or to S's last tile when not
//      causal), accumulating dQ;
//   4. bwd_group_sum_kernel (GQA only): dk, dv = the partials of a kv
//      head's q heads summed in head order, cast to the input dtype.
// S and dP are computed in both 2 and 3: 7 products a live score
// against the bound's 5. Computing them once needs dQ summed across the
// key-tile blocks (float atomics, or semaphores that order the adds),
// which would give up bitwise-equal calls or serialise the blocks.
//
// bf16 / fp16 (bwd_dkdv_mma_kernel, bwd_dq_mma_kernel): FlashAttention-2's
// backward on mma.sync.m16n8k16 with fp32 accumulators, 4 warps a block,
// 16 rows (keys in 2, queries in 3) a warp:
//   * the block's own rows (K, V in 2; Q, dO in 3) stay in their storage
//     dtype in swizzled shared memory, loaded once with cp.async; at hd
//     <= 64 their A fragments are loaded once into registers, above that
//     per k-step by ldmatrix;
//   * the streamed tiles (Q, dO, lse, delta in 2; K, V in 3) arrive
//     through a two-stage cp.async ring: the next tile loads while this
//     one is multiplied;
//   * 2 computes S^T = K Q^T and dP^T = V dO^T, 3 computes S = Q K^T and
//     dP = dO V^T (B fragments by ldmatrix), into fp32 accumulators; p
//     and ds are formed in registers, rounded to the storage type and fed
//     straight from the accumulators as A fragments (the forward's
//     accumulator-to-A reuse) into dV += pb^T dO and dK += dsb^T Q (2)
//     or dQ += dsb K (3), with dO, Q and K by ldmatrix.trans;
//   * the mask is applied only on tiles a warp's rows cross at the
//     diagonal (causal only), the window's edge, T or S (masked p = 0);
//   * at hd 256 dK + dV of 16 keys would take 256 fp32 registers a
//     thread, so two warps share each 16-row group and split the head
//     dim: both compute the group's S and dP, each accumulates half of
//     the dims (blocks of 32 rows, 32-row streamed tiles).
//   Each product's operands are the bf16 / fp16 values the reference
//   feeds its einsums; p enters dV rounded once, as the reference's pb
//   (not the forward's hi + lo split). Only the order of the fp32 sums
//   differs.
//
// fp32 (bwd_dkdv_split_kernel, bwd_dq_split_kernel): the same blocks,
// loop bounds, cp.async ring and masks (and warps, but at hd 256) on
// mma.sync.m16n8k8 TF32. One TF32 pass rounds each operand to 10
// mantissa bits, about 10x past the fp32 tolerance; so every operand, p
// and ds included, is split into hi = cvt.rna.tf32(v) and lo =
// cvt.rna.tf32(v - hi) and multiplied as lo.hi + hi.lo + hi.hi into the
// fp32 accumulators (mma_tf32.cuh, as the SSD scan does): as exact as
// fp32 FMAs, at a third of the TF32 rate (tests/test_torch_flash_bwd_
// tiles.py models it). What differs from the half kernels:
//   * tiles stay fp32 in shared memory at a row pitch of hd + 4 words,
//     filled by 16-byte cp.async; ldmatrix has no transposed form for
//     32-bit elements, so fragments are 32-bit shared loads, and the
//     pitch keeps a warp's load on 32 distinct banks whether it reads a
//     tile along its rows (K, V as A; Q, dO, K, V as the B of S, dP) or
//     across them (dO, Q, K as the B of dV, dK, dQ);
//   * the m16n8k8 A layout takes columns t and t + 4 where the C layout
//     holds 2t and 2t + 1, so p and ds enter as A fragments with each
//     8-wide k-step permuted (column 2t at k t, 2t + 1 at k t + 4) and
//     the B rows read in the same order: no shuffle, no shared-memory
//     round trip; only the fp32 sum order within a k-step moves;
//   * every fragment is split as it is loaded, each three-pass sweep
//     covering up to 8 n-tiles, so that an accumulator's three products
//     stand apart;
//   * at hd 256 four warps (not two) share each 16-row group and split
//     the head dim, 8 warps a block: dK + dV of 64 dims are 64 fp32
//     registers a thread, where 128 spilled. They also split the
//     streamed tile's columns: each computes S and dP (products over all
//     256 dims, 2/3 of the three-pass work there) for a quarter of them
//     and hands its p / ds fragments to the others through shared
//     memory, a float4 a lane an n-tile, instead of all four computing
//     all of them;
//   * fp32 doubles the tiles' bytes: at hd 64 a block takes 105 KB (two
//     an SM), at hd 128 and 256 136-208 KB (one), with the ring's two
//     stages kept.
//
// The kernels allocate nothing; each entry point returns the
// cudaGetLastError() of its launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "mma_tf32.cuh"   // tf32, split, mma_tf32, mma3

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
template <typename T, int HD, bool LSE, bool CAUSAL>
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

  // live key tiles [kt_lo, kt_hi): up to the diagonal when causal, to S
  // otherwise; from the window's near edge
  const int n_kt = (S_len + BK - 1) / BK;
  const int kt_hi = CAUSAL ? min(n_kt, q_last / BK + 1) : n_kt;
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

    // mask, only where the tile crosses the diagonal (causal), the
    // window or S
    const int k0 = kt * BK;
    const bool edge = (CAUSAL && k0 + BK - 1 > r0) || k0 + BK > S_len ||
                      (window > 0 && r0 + 15 - k0 >= window);
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nt * 8 + cq * 2 + (e & 1);
          const int t = e < 2 ? t_lo : t_hi;
          bool live = key < S_len && (!CAUSAL || key <= t);
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
                        int64_t window, bool causal, float scale, cudaStream_t st) {
  constexpr int smem = HalfCfg<HD>::SMEM_BYTES;
  // the serving path (no lse) runs an instance without the store
  auto kern = causal ? (lse != nullptr ? flash_half_kernel<T, HD, true, true>
                                       : flash_half_kernel<T, HD, false, true>)
                     : (lse != nullptr ? flash_half_kernel<T, HD, true, false>
                                       : flash_half_kernel<T, HD, false, false>);
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
template <int HD, int BQ, bool LSE, bool CAUSAL>
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

  // live key tiles: [kt_lo, kt_hi), as the tensor-core route's
  const int64_t n_kt = (S_len + BK - 1) / BK;
  const int64_t kt_hi = CAUSAL ? min(n_kt, q_last / BK + 1) : n_kt;
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
        bool live = s < S_len && (!CAUSAL || s <= t);
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
                       int64_t window, bool causal, float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * Cfg<HD, BQ>::SMEM_FLOATS;
  auto kern = causal ? (lse != nullptr ? flash_f32_kernel<HD, BQ, true, true>
                                       : flash_f32_kernel<HD, BQ, false, true>)
                     : (lse != nullptr ? flash_f32_kernel<HD, BQ, true, false>
                                       : flash_f32_kernel<HD, BQ, false, false>);
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
                         int64_t window, bool causal, int64_t block_q, float scale,
                         cudaStream_t st) {
  if (block_q == 64)
    return launch_f32<HD, 64>(q, k, v, out, lse, B, T_len, S_len, nq, nkv, window, causal,
                              scale, st);
  if (block_q == 32)
    return launch_f32<HD, 32>(q, k, v, out, lse, B, T_len, S_len, nq, nkv, window, causal,
                              scale, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_half(const void* q, const void* k, const void* v, void* out, float* lse,
                          int64_t B,
                          int64_t T_len, int64_t S_len, int64_t nq, int64_t nkv,
                          int64_t hd, int64_t window, bool causal, float scale,
                          cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch_half<T, 32>(q, k, v, out, lse, B, T_len, S_len, nq, nkv, window, causal,
                                scale, st);
    case 64:
      return launch_half<T, 64>(q, k, v, out, lse, B, T_len, S_len, nq, nkv, window, causal,
                                scale, st);
    case 128:
      return launch_half<T, 128>(q, k, v, out, lse, B, T_len, S_len, nq, nkv, window, causal,
                                 scale, st);
    case 256:
      return launch_half<T, 256>(q, k, v, out, lse, B, T_len, S_len, nq, nkv, window, causal,
                                 scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_f32_hd(const void* q, const void* k, const void* v, void* out,
                            float* lse, int64_t B, int64_t T_len, int64_t S_len, int64_t nq,
                            int64_t nkv, int64_t hd, int64_t window, bool causal,
                            int64_t block_q, float scale, cudaStream_t st) {
  switch (hd) {
    case 32:
      return dispatch_f32<32>(q, k, v, out, lse, B, T_len, S_len, nq, nkv, window, causal,
                              block_q, scale, st);
    case 64:
      return dispatch_f32<64>(q, k, v, out, lse, B, T_len, S_len, nq, nkv, window, causal,
                              block_q, scale, st);
    case 128:
      return dispatch_f32<128>(q, k, v, out, lse, B, T_len, S_len, nq, nkv, window, causal,
                               block_q, scale, st);
    case 256:
      return dispatch_f32<256>(q, k, v, out, lse, B, T_len, S_len, nq, nkv, window, causal,
                               block_q, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// backward: delta and group sum (every dtype)
// ---------------------------------------------------------------------------

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

constexpr int kBwdThreads = 256;

// sum of the products of the 16 / sizeof(T) elements of two 16-byte
// vectors, added to acc in element order, in fp32
template <typename T>
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b, float acc);
template <>
__device__ __forceinline__ float dot16<float>(const uint4& a, const uint4& b, float acc) {
  acc = fmaf(__uint_as_float(a.x), __uint_as_float(b.x), acc);
  acc = fmaf(__uint_as_float(a.y), __uint_as_float(b.y), acc);
  acc = fmaf(__uint_as_float(a.z), __uint_as_float(b.z), acc);
  return fmaf(__uint_as_float(a.w), __uint_as_float(b.w), acc);
}
template <>
__device__ __forceinline__ float dot16<__nv_bfloat16>(const uint4& a, const uint4& b,
                                                      float acc) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(__uint_as_float(x[i] << 16), __uint_as_float(y[i] << 16), acc);
    acc = fmaf(__uint_as_float(x[i] & 0xffff0000u), __uint_as_float(y[i] & 0xffff0000u), acc);
  }
  return acc;
}
template <>
__device__ __forceinline__ float dot16<__half>(const uint4& a, const uint4& b, float acc) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __half22float2(*reinterpret_cast<const __half2*>(&x[i]));
    const float2 w = __half22float2(*reinterpret_cast<const __half2*>(&y[i]));
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}

// delta[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d] in fp32: a row is
// L = min(32, hd / V) consecutive lanes, each summing its 16-byte vectors
// of V elements (lane j takes vectors j, j + L, ...), then a butterfly
// over the L lanes (a fixed order). Bound: bytes.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                 float* __restrict__ delta, int64_t rows, int T_len, int nq, int hd) {
  constexpr int V = 16 / sizeof(T);
  const int vecs = hd / V, lanes = min(32, vecs);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBwdThreads + threadIdx.x;
  const int64_t row = i / lanes;   // every lane of a warp reaches the butterfly
  const int sub = static_cast<int>(i % lanes);
  float acc = 0.f;
  if (row < rows) {
    const uint4* o = reinterpret_cast<const uint4*>(out + row * hd);
    const uint4* g = reinterpret_cast<const uint4*>(dout + row * hd);
    for (int c = sub; c < vecs; c += lanes) acc = dot16<T>(g[c], o[c], acc);
  }
  for (int off = lanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (sub == 0 && row < rows) {
    const int64_t h = row % nq, bt = row / nq;   // row = (b * T + t) * nq + h
    const int64_t t = bt % T_len, b = bt / T_len;
    delta[(b * nq + h) * T_len + t] = acc;
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

// ---------------------------------------------------------------------------
// backward, bf16 / fp16: tensor cores
// ---------------------------------------------------------------------------

// 16 rows a warp, 4 warps a block; DSPLIT warps share a 16-row group and
// split the head dim between them (2 at hd 256, where one warp's dK + dV
// would not fit its registers).
template <int HD>
struct BwdMmaCfg {
  static constexpr int DSPLIT = HD == 256 ? 2 : 1;
  static constexpr int ROWS = 16 * (kHalfThreads / 32) / DSPLIT;   // keys (dK / dV), queries (dQ)
  static constexpr int BQ = HD <= 64 ? 64 : 32;    // query tile a dK / dV block streams
  static constexpr int BK = HD <= 128 ? 64 : 32;   // key tile a dQ block streams
  static constexpr bool IN_REGS = HD <= 64;        // the block's own A fragments in registers
  static constexpr int C = HD / 8;                 // 16-byte chunks a row
  static constexpr int KS = HD / 16;               // k-steps over the head dim
  static constexpr int DW = HD / DSPLIT / 8;       // dim n-tiles a warp accumulates
  static constexpr int OWN_BYTES = ROWS * HD * 2;  // K or V (dK / dV), Q or dO (dQ)
  // dK / dV: K, V, then two stages of (Q, dO, lse, delta)
  static constexpr int Q_TILE = BQ * HD * 2;
  static constexpr int Q_STAGE = 2 * Q_TILE + 2 * BQ * 4;
  static constexpr int DKDV_SMEM = 2 * OWN_BYTES + 2 * Q_STAGE;
  // dQ: Q, dO, then two stages of (K, V)
  static constexpr int K_TILE = BK * HD * 2;
  static constexpr int DQ_SMEM = 2 * OWN_BYTES + 4 * K_TILE;
  static_assert(DW % 2 == 0 && BQ % 16 == 0 && BK % 16 == 0, "whole ldmatrix.x4 steps");
};

// 4 bytes global -> shared; src_bytes 0 zero-fills.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// The A fragment (16 rows x 16 k) at k-step kk of a warp's accumulator
// tile acc[2 kk], acc[2 kk + 1] (16 rows x 8 columns each, the m16n8 C
// layout), rounded to the storage type: the C layout of two n-tiles is
// the A layout of one k-step.
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack2<T>(lo[0], lo[1]);
  a[1] = pack2<T>(lo[2], lo[3]);
  a[2] = pack2<T>(hi[0], hi[1]);
  a[3] = pack2<T>(hi[2], hi[3]);
}

// grid (ceil(S / ROWS), nq, B), early tiles first (the first key tiles
// of every head, the ones with the most live query tiles when causal, are
// dispatched first): the block of one key tile of q head h. Warp w owns keys k0 + 16 (w / DSPLIT) .. + 15 and accumulates
// dK, dV over its share of the dims; lane l holds key rows g = l / 4 and
// g + 8 of the warp's 16, query / dim columns 2 (l % 4), 2 (l % 4) + 1 of
// each 8-wide n-tile.
template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(kHalfThreads, 2)
bwd_dkdv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                    float* __restrict__ work, int T_len, int S_len, int nq, int nkv,
                    int window, float scale, float scale_log2) {
  using Cf = BwdMmaCfg<HD>;
  constexpr int C = Cf::C, KS = Cf::KS, BQ = Cf::BQ, NT = BQ / 8, DW = Cf::DW;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + Cf::OWN_BYTES;
  const uint32_t sRing = sV + Cf::OWN_BYTES;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, cq = lane & 3;
  const int rg = warp / Cf::DSPLIT;                  // this warp's 16-key group
  const int dc0 = (warp % Cf::DSPLIT) * DW;   // its first dim chunk (8 dims a chunk)
  // block lin of the grid takes key tile lin / (nq B): 32-bit indices,
  // offsets rather than pointers (the parameters stay in the constant
  // bank), so that the hd-256 instance fits its registers
  const unsigned heads = gridDim.y * gridDim.z;
  const unsigned lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int h = static_cast<int>(lin % heads % gridDim.y);
  const int b = static_cast<int>(lin % heads / gridDim.y);
  const int kvh = h / (nq / nkv);
  const int k0 = static_cast<int>(lin / heads) * Cf::ROWS;
  const int kw0 = k0 + rg * 16;
  const int64_t q_stride = static_cast<int64_t>(nq) * HD;
  const int64_t kv_stride = static_cast<int64_t>(nkv) * HD;
  const int64_t q_off = (static_cast<int64_t>(b) * T_len * nq + h) * HD;   // (b, 0, h)
  const int64_t l_off = (static_cast<int64_t>(b) * nq + h) * T_len;        // (b, h, 0)

  const int64_t kv_off = ((static_cast<int64_t>(b) * S_len + k0) * nkv + kvh) * HD;
  load_tile<T, HD, Cf::ROWS>(sK, k + kv_off, kv_stride, S_len - k0, tid);
  load_tile<T, HD, Cf::ROWS>(sV, v + kv_off, kv_stride, S_len - k0, tid);
  cp_async_commit();

  // live query tiles [qt_lo, qt_hi): from the diagonal (0 when not
  // causal) to the window's far edge (kernel.py dkdv_query_tiles)
  const int n_qt = (T_len + BQ - 1) / BQ;
  const int qt_lo = CAUSAL ? k0 / BQ : 0;
  int qt_hi = n_qt;
  if (window > 0) {
    // the window's far edge seen from the block's last row (causal: past
    // S that adds at most a tile the mask empties) or from its last key
    // before S. The causal bound is the one from before the flag: with
    // the clamp, the hd-256 causal instance spilled 20 bytes at 255
    // registers (250 without)
    const int last = CAUSAL ? k0 + Cf::ROWS : min(k0 + Cf::ROWS, S_len);
    qt_hi = min(n_qt, (last - 2 + window) / BQ + 1);
  }

  // Q, dO, lse and delta of query tile qt into a ring stage; rows past T
  // are zero
  auto load_stage = [&](int qt, int stage) {
    const int q0 = qt * BQ;
    const uint32_t base = sRing + stage * Cf::Q_STAGE;
    load_tile<T, HD, BQ>(base, q + q_off + q0 * q_stride, q_stride, T_len - q0, tid);
    load_tile<T, HD, BQ>(base + Cf::Q_TILE, dout + q_off + q0 * q_stride, q_stride,
                         T_len - q0, tid);
    if (tid < 2 * BQ) {
      const int i = tid % BQ;
      const float* src = (tid < BQ ? lse : delta) + l_off;
      const bool ok = q0 + i < T_len;
      cp_async4(base + 2 * Cf::Q_TILE + tid * 4, ok ? src + q0 + i : src, ok ? 4 : 0);
    }
  };
  if (qt_lo < qt_hi) load_stage(qt_lo, 0);
  cp_async_commit();

  uint32_t kf[Cf::IN_REGS ? KS : 1][4], vf[Cf::IN_REGS ? KS : 1][4];
  if constexpr (Cf::IN_REGS) {   // K, V fragments, loaded once
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      ldmatrix_x4(kf[ks], tile_addr<C>(sK, rg * 16 + (lane & 15), ks * 2 + (lane >> 4)));
      ldmatrix_x4(vf[ks], tile_addr<C>(sV, rg * 16 + (lane & 15), ks * 2 + (lane >> 4)));
    }
  }
  float acc_k[DW][4], acc_v[DW][4];
#pragma unroll
  for (int i = 0; i < DW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int stage = (qt - qt_lo) & 1;
    if (qt + 1 < qt_hi) {   // the next tile loads while this one is multiplied
      load_stage(qt + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t sQ = sRing + stage * Cf::Q_STAGE;
    const uint32_t sG = sQ + Cf::Q_TILE;
    const float* sL = reinterpret_cast<const float*>(smem + 2 * Cf::OWN_BYTES +
                                                     stage * Cf::Q_STAGE + 2 * Cf::Q_TILE);
    const float* sD = sL + BQ;
    const int q0 = qt * BQ;

    // S^T = K Q^T, dP^T = V dO^T: this warp's 16 keys x BQ queries, fp32
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ak[4], av[4];
      if constexpr (Cf::IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ak[e] = kf[ks][e];
          av[e] = vf[ks][e];
        }
      } else {
        ldmatrix_x4(ak, tile_addr<C>(sK, rg * 16 + (lane & 15), ks * 2 + (lane >> 4)));
        ldmatrix_x4(av, tile_addr<C>(sV, rg * 16 + (lane & 15), ks * 2 + (lane >> 4)));
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int r = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int ch = ks * 2 + ((lane >> 3) & 1);
        uint32_t bq[4], bg[4];
        ldmatrix_x4(bq, tile_addr<C>(sQ, r, ch));
        ldmatrix_x4(bg, tile_addr<C>(sG, r, ch));
        mma16816<T>(st[2 * np], ak, bq[0], bq[1]);
        mma16816<T>(st[2 * np + 1], ak, bq[2], bq[3]);
        mma16816<T>(dpt[2 * np], av, bg[0], bg[1]);
        mma16816<T>(dpt[2 * np + 1], av, bg[2], bg[3]);
      }
    }

    // p = exp(s * scale - lse) in st, ds = p (dp - delta) scale in dpt;
    // masked (p = 0) only where the tile crosses the diagonal (causal),
    // the window's edge or T for this warp's keys (keys past S are never
    // stored)
    const bool edge = (CAUSAL && q0 < kw0 + 15) || q0 + BQ > T_len ||
                      (window > 0 && q0 + BQ - 1 - kw0 >= window);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int j = nt * 8 + cq * 2;   // the lane's two query columns
      const float2 l2 = *reinterpret_cast<const float2*>(sL + j);
      const float2 d2 = *reinterpret_cast<const float2*>(sD + j);
      const float la = l2.x * kLog2e, lb = l2.y * kLog2e;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(st[nt][e] * scale_log2 - ((e & 1) ? lb : la));
        if (edge) {
          const int key = kw0 + g + ((e >> 1) << 3);
          const int t = q0 + j + (e & 1);
          bool live = t < T_len && (!CAUSAL || key <= t);
          if (window > 0) live = live && t - key < window;
          if (!live) p = 0.f;
        }
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - ((e & 1) ? d2.y : d2.x)) * scale;
      }
    }

    // dV += pb^T dO, dK += dsb^T Q over this warp's dims, pb and dsb the
    // accumulators rounded to T; dO and Q by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ap[4], as[4];
      acc_to_a<T>(ap, st[2 * kk], st[2 * kk + 1]);
      acc_to_a<T>(as, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < DW / 2; ++np) {
        const int r = kk * 16 + (lane & 15);
        const int ch = dc0 + np * 2 + (lane >> 4);
        uint32_t bg[4], bq[4];
        ldmatrix_x4_trans(bg, tile_addr<C>(sG, r, ch));
        ldmatrix_x4_trans(bq, tile_addr<C>(sQ, r, ch));
        mma16816<T>(acc_v[2 * np], ap, bg[0], bg[1]);
        mma16816<T>(acc_v[2 * np + 1], ap, bg[2], bg[3]);
        mma16816<T>(acc_k[2 * np], as, bq[0], bq[1]);
        mma16816<T>(acc_k[2 * np + 1], as, bq[2], bq[3]);
      }
    }
    __syncthreads();   // this stage is free for the tile after next
  }

  const int64_t half = static_cast<int64_t>(gridDim.z) * S_len * nq * HD;
  const int64_t bt = static_cast<int64_t>(b) * S_len;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw0 + g + 8 * r;
    if (key >= S_len) continue;
#pragma unroll
    for (int dn = 0; dn < DW; ++dn) {
      const int d = (dc0 + dn) * 8 + cq * 2;
      if (work == nullptr) {   // one q head a kv head: the final values
        const int64_t at = ((bt + key) * nkv + kvh) * HD + d;
        *reinterpret_cast<uint32_t*>(dk + at) = pack2<T>(acc_k[dn][2 * r], acc_k[dn][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + at) = pack2<T>(acc_v[dn][2 * r], acc_v[dn][2 * r + 1]);
      } else {   // this q head's fp32 partials, (2, B, S, nq, HD)
        const int64_t at = ((bt + key) * nq + h) * HD + d;
        *reinterpret_cast<float2*>(work + at) = make_float2(acc_k[dn][2 * r], acc_k[dn][2 * r + 1]);
        *reinterpret_cast<float2*>(work + half + at) =
            make_float2(acc_v[dn][2 * r], acc_v[dn][2 * r + 1]);
      }
    }
  }
}

// grid (ceil(T / ROWS), nq, B), late query tiles first (when causal they
// hold the most live key tiles): the block of one query tile of q head h. Warp w owns queries q0 + 16 (w / DSPLIT) .. +
// 15 and accumulates dQ over its share of the dims; lane l holds query
// rows g and g + 8, key / dim columns 2 (l % 4), 2 (l % 4) + 1.
template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(kHalfThreads, 2)
bwd_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq, int T_len, int S_len,
                  int nq, int nkv, int window, float scale, float scale_log2) {
  using Cf = BwdMmaCfg<HD>;
  constexpr int C = Cf::C, KS = Cf::KS, BK = Cf::BK, NT = BK / 8, DW = Cf::DW;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sG = sQ + Cf::OWN_BYTES;
  const uint32_t sRing = sG + Cf::OWN_BYTES;   // K0, V0, K1, V1

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, cq = lane & 3;
  const int rg = warp / Cf::DSPLIT;
  const int dc0 = (warp % Cf::DSPLIT) * DW;
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int kvh = h / (nq / nkv);
  const int q0 = qt * Cf::ROWS;
  const int q_last = min(q0 + Cf::ROWS, T_len) - 1;
  const int qw0 = q0 + rg * 16;
  const int64_t q_stride = static_cast<int64_t>(nq) * HD;
  const int64_t kv_stride = static_cast<int64_t>(nkv) * HD;
  const T* k_base = k + (b * S_len * nkv + kvh) * HD;
  const T* v_base = v + (b * S_len * nkv + kvh) * HD;

  load_tile<T, HD, Cf::ROWS>(sQ, q + ((b * T_len + q0) * nq + h) * HD, q_stride, T_len - q0,
                             tid);
  load_tile<T, HD, Cf::ROWS>(sG, dout + ((b * T_len + q0) * nq + h) * HD, q_stride,
                             T_len - q0, tid);
  cp_async_commit();

  // live key tiles [kt_lo, kt_hi), as the forward's: from the window's
  // near edge to the diagonal, or to S's last tile when not causal
  // (kernel.py dq_key_tiles)
  const int n_kt = (S_len + BK - 1) / BK;
  const int kt_hi = CAUSAL ? min(n_kt, q_last / BK + 1) : n_kt;
  int kt_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / BK;

  auto load_stage = [&](int kt, int stage) {
    const int kk0 = kt * BK;
    const uint32_t base = sRing + stage * 2 * Cf::K_TILE;
    load_tile<T, HD, BK>(base, k_base + kk0 * kv_stride, kv_stride, S_len - kk0, tid);
    load_tile<T, HD, BK>(base + Cf::K_TILE, v_base + kk0 * kv_stride, kv_stride, S_len - kk0,
                         tid);
  };
  if (kt_lo < kt_hi) load_stage(kt_lo, 0);
  cp_async_commit();

  // lse (in log2 units) and delta of the lane's two rows; 0 past T
  const int t_lo = qw0 + g, t_hi = t_lo + 8;
  const float* lse_row = lse + (b * nq + h) * static_cast<int64_t>(T_len);
  const float* delta_row = delta + (b * nq + h) * static_cast<int64_t>(T_len);
  const float l_lo = t_lo < T_len ? lse_row[t_lo] * kLog2e : 0.f;
  const float l_hi = t_hi < T_len ? lse_row[t_hi] * kLog2e : 0.f;
  const float d_lo = t_lo < T_len ? delta_row[t_lo] : 0.f;
  const float d_hi = t_hi < T_len ? delta_row[t_hi] : 0.f;

  uint32_t qf[Cf::IN_REGS ? KS : 1][4], gf[Cf::IN_REGS ? KS : 1][4];
  if constexpr (Cf::IN_REGS) {   // Q, dO fragments, loaded once
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      ldmatrix_x4(qf[ks], tile_addr<C>(sQ, rg * 16 + (lane & 15), ks * 2 + (lane >> 4)));
      ldmatrix_x4(gf[ks], tile_addr<C>(sG, rg * 16 + (lane & 15), ks * 2 + (lane >> 4)));
    }
  }
  float acc[DW][4];
#pragma unroll
  for (int i = 0; i < DW; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) {
      load_stage(kt + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t sK = sRing + stage * 2 * Cf::K_TILE;
    const uint32_t sV = sK + Cf::K_TILE;

    // S = Q K^T, dP = dO V^T: this warp's 16 queries x BK keys, fp32
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t aq[4], ag[4];
      if constexpr (Cf::IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          aq[e] = qf[ks][e];
          ag[e] = gf[ks][e];
        }
      } else {
        ldmatrix_x4(aq, tile_addr<C>(sQ, rg * 16 + (lane & 15), ks * 2 + (lane >> 4)));
        ldmatrix_x4(ag, tile_addr<C>(sG, rg * 16 + (lane & 15), ks * 2 + (lane >> 4)));
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        const int r = np * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int ch = ks * 2 + ((lane >> 3) & 1);
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, tile_addr<C>(sK, r, ch));
        ldmatrix_x4(bv, tile_addr<C>(sV, r, ch));
        mma16816<T>(s[2 * np], aq, bk[0], bk[1]);
        mma16816<T>(s[2 * np + 1], aq, bk[2], bk[3]);
        mma16816<T>(dp[2 * np], ag, bv[0], bv[1]);
        mma16816<T>(dp[2 * np + 1], ag, bv[2], bv[3]);
      }
    }

    // ds = p (dp - delta) scale in s; masked (p = 0) only where the tile
    // crosses the diagonal (causal), the window's edge or S for this
    // warp's rows
    const int k0 = kt * BK;
    const bool edge = (CAUSAL && k0 + BK - 1 > qw0) || k0 + BK > S_len ||
                      (window > 0 && qw0 + 15 - k0 >= window);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nt][e] * scale_log2 - (e < 2 ? l_lo : l_hi));
        if (edge) {
          const int key = k0 + nt * 8 + cq * 2 + (e & 1);
          const int t = e < 2 ? t_lo : t_hi;
          bool live = key < S_len && (!CAUSAL || key <= t);
          if (window > 0) live = live && t - key < window;
          if (!live) p = 0.f;
        }
        s[nt][e] = p * (dp[nt][e] - (e < 2 ? d_lo : d_hi)) * scale;
      }

    // dQ += dsb K over this warp's dims, K by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a<T>(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < DW / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, tile_addr<C>(sK, kk * 16 + (lane & 15), dc0 + np * 2 + (lane >> 4)));
        mma16816<T>(acc[2 * np], a, bk[0], bk[1]);
        mma16816<T>(acc[2 * np + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();   // this stage is free for the tile after next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = (r ? t_hi : t_lo);
    if (t >= T_len) continue;
#pragma unroll
    for (int dn = 0; dn < DW; ++dn) {
      const int d = (dc0 + dn) * 8 + cq * 2;
      *reinterpret_cast<uint32_t*>(dq + ((b * T_len + t) * nq + h) * HD + d) =
          pack2<T>(acc[dn][2 * r], acc[dn][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, fp32: tensor cores in three TF32 passes
// ---------------------------------------------------------------------------

// The half route's plan (BwdMmaCfg: rows, tiles, loop bounds, and its
// warps but at hd 256) on fp32 tiles at a row pitch of HD + 4 words, 4
// mod 32: a warp's fragment
// load touches 32 distinct banks both when it reads along the rows (rows
// g, columns t: frag_a_split, frag_b_rows) and across them (rows 2t and
// 2t + 1, columns g: frag_b_cols).
template <int HD>
struct BwdSplitCfg {
  using M = BwdMmaCfg<HD>;
  static constexpr int P = HD + 4;                   // row pitch, in floats
  // M::ROWS rows a block in 16-row groups; at hd 256 four warps share each
  // group and split the head dim (8 warps a block), so that dK + dV take
  // 64 fp32 accumulators a thread: with two, as the half kernels split
  // it, they take 128 and the dK / dV instance spilled at 255 registers
  static constexpr int DSPLIT = HD == 256 ? 4 : 1;
  static constexpr int THREADS = 32 * (M::ROWS / 16) * DSPLIT;
  // blocks an SM that __launch_bounds__ asks for: 2 of 4 warps, as the half
  // kernels, or 1 of 8; both leave ptxas 255 registers (without it, it
  // held the hd-32 dK / dV instance to 168 and spilled)
  static constexpr int MIN_BLOCKS = THREADS == 128 ? 2 : 1;
  static constexpr int DW = HD / DSPLIT / 8;         // dim n-tiles a warp accumulates
  static constexpr int NC = DW < 8 ? DW : 8;         // dim n-tiles a three-pass sweep
  static constexpr int OWN = M::ROWS * P;            // K or V (dK / dV), Q or dO (dQ)
  // The warps of a row group each compute S and dP for 1 / DSPLIT of the
  // streamed tile's n-tiles and hand their p / ds fragments to the
  // others through XCH floats a row group: a float4 a lane an n-tile, p
  // and ds (dK / dV) or ds alone (dQ).
  static constexpr int GROUPS = M::ROWS / 16;
  static constexpr int XCH_KV = DSPLIT > 1 ? M::BQ / 8 * 2 * 128 : 0;
  static constexpr int XCH_Q = DSPLIT > 1 ? M::BK / 8 * 128 : 0;
  // dK / dV: K, V, two stages of (Q, dO, lse, delta), the hand-off
  static constexpr int Q_TILE = M::BQ * P;
  static constexpr int Q_STAGE = 2 * Q_TILE + 2 * M::BQ;
  static constexpr int DKDV_SMEM = 4 * (2 * OWN + 2 * Q_STAGE + GROUPS * XCH_KV);
  // dQ: Q, dO, two stages of (K, V), the hand-off
  static constexpr int K_TILE = M::BK * P;
  static constexpr int DQ_SMEM = 4 * (2 * OWN + 4 * K_TILE + GROUPS * XCH_Q);
  static_assert(DW % NC == 0 && M::BQ / 8 % DSPLIT == 0 && M::BK / 8 % DSPLIT == 0,
                "whole sweeps and shares");
  static_assert(DKDV_SMEM <= 232448 && DQ_SMEM <= 232448, "a block fits an SM");
};

// The A fragment (rows r0 .. r0 + 15, k columns c0 .. c0 + 7) of a
// row-major fp32 tile at pitch P, split hi / lo.
template <int P>
__device__ __forceinline__ void frag_a_split(uint32_t (&hi)[1][4], uint32_t (&lo)[1][4],
                                             const float* tile, int r0, int c0, int g, int t) {
  const float* p = tile + (r0 + g) * P + c0 + t;
  split(p[0], hi[0][0], lo[0][0]);
  split(p[8 * P], hi[0][1], lo[0][1]);
  split(p[4], hi[0][2], lo[0][2]);
  split(p[8 * P + 4], hi[0][3], lo[0][3]);
}

// B fragments of NJ n-tiles read along the tile's rows: n is row n0 + 8 j
// + g, k column c0 + t or c0 + t + 4 (K in S = Q K^T, Q in S^T = K Q^T).
template <int P, int NJ>
__device__ __forceinline__ void frag_b_rows(uint32_t (&hi)[NJ][2], uint32_t (&lo)[NJ][2],
                                            const float* tile, int n0, int c0, int g, int t) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float* p = tile + (n0 + 8 * j + g) * P + c0 + t;
    split(p[0], hi[j][0], lo[j][0]);
    split(p[4], hi[j][1], lo[j][1]);
  }
}

// B fragments of NJ n-tiles read across the tile's rows: k is a row, n
// column n0 + 8 j + g, in acc_frag_split's k order (k t at row r0 + 2t,
// k t + 4 at row r0 + 2t + 1; K in dQ += dS K, dO and Q in dV and dK).
template <int P, int NJ>
__device__ __forceinline__ void frag_b_cols(uint32_t (&hi)[NJ][2], uint32_t (&lo)[NJ][2],
                                            const float* tile, int r0, int n0, int g, int t) {
  const float* p = tile + (r0 + 2 * t) * P + n0 + g;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    split(p[8 * j], hi[j][0], lo[j][0]);
    split(p[P + 8 * j], hi[j][1], lo[j][1]);
  }
}

// The A fragment of one k-step from an m16n8 accumulator tile c (rows g,
// g + 8; columns 2t, 2t + 1), split hi / lo: column 2t stands at k t and
// 2t + 1 at k t + 4, so the C layout is the A layout with no shuffle, and
// frag_b_cols reads the B rows in the same order. The fp32 sums of the
// k-step run in that order.
__device__ __forceinline__ void acc_frag_split(uint32_t (&hi)[1][4], uint32_t (&lo)[1][4],
                                               const float (&c)[4]) {
  split(c[0], hi[0][0], lo[0][0]);
  split(c[2], hi[0][1], lo[0][1]);
  split(c[1], hi[0][2], lo[0][2]);
  split(c[3], hi[0][3], lo[0][3]);
}

// The fp32 dK / dV: bwd_dkdv_mma_kernel's blocks, ring and mask (see
// there; BwdSplitCfg for the warps at hd 256), every product on
// mma.sync.m16n8k8 TF32 as lo.hi + hi.lo + hi.hi (mma3), p and ds fed
// from the fp32 accumulators unrounded.
template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(BwdSplitCfg<HD>::THREADS, BwdSplitCfg<HD>::MIN_BLOCKS)
bwd_dkdv_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ work,
                      int T_len, int S_len, int nq, int nkv, int window, float scale,
                      float scale_log2) {
  static_assert(std::is_same<T, float>::value, "the fp32 route");
  using Cf = BwdMmaCfg<HD>;
  using Sp = BwdSplitCfg<HD>;
  constexpr int P = Sp::P, BQ = Cf::BQ, NT = BQ / 8, DW = Sp::DW, NC = Sp::NC;
  constexpr int NS = NT / Sp::DSPLIT;   // query n-tiles of S^T this warp computes
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + Sp::OWN;
  float* sRing = sV + Sp::OWN;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, cq = lane & 3;
  const int rg = warp / Sp::DSPLIT;
  const int ws = warp % Sp::DSPLIT;   // this warp's share: dims and query n-tiles
  const int dc0 = ws * DW;
  float* sX = sRing + 2 * Sp::Q_STAGE + rg * Sp::XCH_KV;   // this row group's hand-off
  const unsigned heads = gridDim.y * gridDim.z;
  const unsigned lin = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int h = static_cast<int>(lin % heads % gridDim.y);
  const int b = static_cast<int>(lin % heads / gridDim.y);
  const int kvh = h / (nq / nkv);
  const int k0 = static_cast<int>(lin / heads) * Cf::ROWS;
  const int kw0 = k0 + rg * 16;
  const int64_t q_stride = static_cast<int64_t>(nq) * HD;
  const int64_t kv_stride = static_cast<int64_t>(nkv) * HD;
  const int64_t q_off = (static_cast<int64_t>(b) * T_len * nq + h) * HD;   // (b, 0, h)
  const int64_t l_off = (static_cast<int64_t>(b) * nq + h) * T_len;        // (b, h, 0)

  const int64_t kv_off = ((static_cast<int64_t>(b) * S_len + k0) * nkv + kvh) * HD;
  load_rows_f32<HD, Cf::ROWS, P, Sp::THREADS>(sK, k + kv_off, kv_stride, S_len - k0, tid);
  load_rows_f32<HD, Cf::ROWS, P, Sp::THREADS>(sV, v + kv_off, kv_stride, S_len - k0, tid);
  cp_async_commit();

  // live query tiles [qt_lo, qt_hi) (kernel.py dkdv_query_tiles)
  const int n_qt = (T_len + BQ - 1) / BQ;
  const int qt_lo = CAUSAL ? k0 / BQ : 0;
  int qt_hi = n_qt;
  if (window > 0) {
    const int last = CAUSAL ? k0 + Cf::ROWS : min(k0 + Cf::ROWS, S_len);
    qt_hi = min(n_qt, (last - 2 + window) / BQ + 1);
  }

  auto load_stage = [&](int qt, int stage) {
    const int q0 = qt * BQ;
    float* base = sRing + stage * Sp::Q_STAGE;
    load_rows_f32<HD, BQ, P, Sp::THREADS>(base, q + q_off + q0 * q_stride, q_stride,
                                           T_len - q0, tid);
    load_rows_f32<HD, BQ, P, Sp::THREADS>(base + Sp::Q_TILE, dout + q_off + q0 * q_stride,
                                           q_stride, T_len - q0, tid);
    if (tid < 2 * BQ) {
      const int i = tid % BQ;
      const float* src = (tid < BQ ? lse : delta) + l_off;
      const bool ok = q0 + i < T_len;
      cp_async4(smem_u32(base + 2 * Sp::Q_TILE + tid), ok ? src + q0 + i : src, ok ? 4 : 0);
    }
  };
  if (qt_lo < qt_hi) load_stage(qt_lo, 0);
  cp_async_commit();

  float acc_k[DW / NC][1][NC][4], acc_v[DW / NC][1][NC][4];
#pragma unroll
  for (int c = 0; c < DW / NC; ++c)
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[c][0][i][e] = acc_v[c][0][i][e] = 0.f;

  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int stage = (qt - qt_lo) & 1;
    if (qt + 1 < qt_hi) {   // the next tile loads while this one is multiplied
      load_stage(qt + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sQ = sRing + stage * Sp::Q_STAGE;
    const float* sG = sQ + Sp::Q_TILE;
    const float* sL = sG + Sp::Q_TILE;
    const float* sD = sL + BQ;
    const int q0 = qt * BQ;

    // S^T = K Q^T, dP^T = V dO^T: this warp's 16 keys x its NS query
    // n-tiles (all BQ queries unless DSPLIT warps share the keys)
    float st[1][NS][4], dpt[1][NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[0][i][e] = dpt[0][i][e] = 0.f;
#pragma unroll 1
    for (int ks = 0; ks < HD / 8; ++ks) {
      uint32_t ah[1][4], al[1][4], bh[NS][2], bl[NS][2];
      frag_a_split<P>(ah, al, sK, rg * 16, ks * 8, g, cq);
      frag_b_rows<P, NS>(bh, bl, sQ, ws * NS * 8, ks * 8, g, cq);
      mma3(st, ah, al, bh, bl);
      frag_a_split<P>(ah, al, sV, rg * 16, ks * 8, g, cq);
      frag_b_rows<P, NS>(bh, bl, sG, ws * NS * 8, ks * 8, g, cq);
      mma3(dpt, ah, al, bh, bl);
    }

    // p = exp(s * scale - lse) in st, ds = p (dp - delta) scale in dpt,
    // both fp32; masked (p = 0) only where the tile crosses the diagonal
    // (causal), the window's edge or T for this warp's keys
    const bool edge = (CAUSAL && q0 < kw0 + 15) || q0 + BQ > T_len ||
                      (window > 0 && q0 + BQ - 1 - kw0 >= window);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      const int j = (ws * NS + nt) * 8 + cq * 2;   // the lane's two query columns
      const float2 l2 = *reinterpret_cast<const float2*>(sL + j);
      const float2 d2 = *reinterpret_cast<const float2*>(sD + j);
      const float la = l2.x * kLog2e, lb = l2.y * kLog2e;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(st[0][nt][e] * scale_log2 - ((e & 1) ? lb : la));
        if (edge) {
          const int key = kw0 + g + ((e >> 1) << 3);
          const int t = q0 + j + (e & 1);
          bool live = t < T_len && (!CAUSAL || key <= t);
          if (window > 0) live = live && t - key < window;
          if (!live) p = 0.f;
        }
        st[0][nt][e] = p;
        dpt[0][nt][e] = p * (dpt[0][nt][e] - ((e & 1) ? d2.y : d2.x)) * scale;
      }
    }
    if constexpr (Sp::DSPLIT > 1) {   // hand the row group's p, ds around
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        float* x = sX + (ws * NS + nt) * 256 + lane * 4;
        *reinterpret_cast<float4*>(x) = make_float4(st[0][nt][0], st[0][nt][1],
                                                    st[0][nt][2], st[0][nt][3]);
        *reinterpret_cast<float4*>(x + 128) = make_float4(
            dpt[0][nt][0], dpt[0][nt][1], dpt[0][nt][2], dpt[0][nt][3]);
      }
      __syncthreads();
    }

    // dV += p^T dO, dK += ds^T Q over this warp's dims: a k-step of 8
    // queries a query n-tile of p / ds; dO and Q read across rows
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      float pk[4], dk4[4];   // p and ds of query n-tile kk
      if constexpr (Sp::DSPLIT > 1) {
        const float4 x = *reinterpret_cast<const float4*>(sX + kk * 256 + lane * 4);
        const float4 y = *reinterpret_cast<const float4*>(sX + kk * 256 + 128 + lane * 4);
        pk[0] = x.x; pk[1] = x.y; pk[2] = x.z; pk[3] = x.w;
        dk4[0] = y.x; dk4[1] = y.y; dk4[2] = y.z; dk4[3] = y.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pk[e] = st[0][kk][e];
          dk4[e] = dpt[0][kk][e];
        }
      }
      uint32_t ah[1][4], al[1][4];
      acc_frag_split(ah, al, pk);
#pragma unroll
      for (int c = 0; c < DW / NC; ++c) {
        uint32_t bh[NC][2], bl[NC][2];
        frag_b_cols<P, NC>(bh, bl, sG, kk * 8, (dc0 + c * NC) * 8, g, cq);
        mma3(acc_v[c], ah, al, bh, bl);
      }
      acc_frag_split(ah, al, dk4);
#pragma unroll
      for (int c = 0; c < DW / NC; ++c) {
        uint32_t bh[NC][2], bl[NC][2];
        frag_b_cols<P, NC>(bh, bl, sQ, kk * 8, (dc0 + c * NC) * 8, g, cq);
        mma3(acc_k[c], ah, al, bh, bl);
      }
    }
    __syncthreads();   // this stage is free for the tile after next
  }

  const int64_t half = static_cast<int64_t>(gridDim.z) * S_len * nq * HD;
  const int64_t bt = static_cast<int64_t>(b) * S_len;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw0 + g + 8 * r;
    if (key >= S_len) continue;
#pragma unroll
    for (int dn = 0; dn < DW; ++dn) {
      const int d = (dc0 + dn) * 8 + cq * 2;
      const float2 xk = make_float2(acc_k[dn / NC][0][dn % NC][2 * r],
                                    acc_k[dn / NC][0][dn % NC][2 * r + 1]);
      const float2 xv = make_float2(acc_v[dn / NC][0][dn % NC][2 * r],
                                    acc_v[dn / NC][0][dn % NC][2 * r + 1]);
      if (work == nullptr) {   // one q head a kv head: the final values
        const int64_t at = ((bt + key) * nkv + kvh) * HD + d;
        *reinterpret_cast<float2*>(dk + at) = xk;
        *reinterpret_cast<float2*>(dv + at) = xv;
      } else {   // this q head's fp32 partials, (2, B, S, nq, HD)
        const int64_t at = ((bt + key) * nq + h) * HD + d;
        *reinterpret_cast<float2*>(work + at) = xk;
        *reinterpret_cast<float2*>(work + half + at) = xv;
      }
    }
  }
}

// The fp32 dQ: bwd_dq_mma_kernel's blocks, ring and mask (see there;
// BwdSplitCfg for the warps at hd 256), every product in three TF32
// passes, ds fed unrounded.
template <typename T, int HD, bool CAUSAL>
__global__ void __launch_bounds__(BwdSplitCfg<HD>::THREADS, BwdSplitCfg<HD>::MIN_BLOCKS)
bwd_dq_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int T_len, int S_len,
                    int nq, int nkv, int window, float scale, float scale_log2) {
  static_assert(std::is_same<T, float>::value, "the fp32 route");
  using Cf = BwdMmaCfg<HD>;
  using Sp = BwdSplitCfg<HD>;
  constexpr int P = Sp::P, BK = Cf::BK, NT = BK / 8, DW = Sp::DW, NC = Sp::NC;
  constexpr int NS = NT / Sp::DSPLIT;   // key n-tiles of S this warp computes
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sG = sQ + Sp::OWN;
  float* sRing = sG + Sp::OWN;   // K0, V0, K1, V1

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, cq = lane & 3;
  const int rg = warp / Sp::DSPLIT;
  const int ws = warp % Sp::DSPLIT;   // this warp's share: dims and key n-tiles
  const int dc0 = ws * DW;
  float* sX = sRing + 4 * Sp::K_TILE + rg * Sp::XCH_Q;   // this row group's hand-off
  const int qt = gridDim.x - 1 - blockIdx.x, h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int kvh = h / (nq / nkv);
  const int q0 = qt * Cf::ROWS;
  const int q_last = min(q0 + Cf::ROWS, T_len) - 1;
  const int qw0 = q0 + rg * 16;
  const int64_t q_stride = static_cast<int64_t>(nq) * HD;
  const int64_t kv_stride = static_cast<int64_t>(nkv) * HD;
  const T* k_base = k + (b * S_len * nkv + kvh) * HD;
  const T* v_base = v + (b * S_len * nkv + kvh) * HD;

  load_rows_f32<HD, Cf::ROWS, P, Sp::THREADS>(sQ, q + ((b * T_len + q0) * nq + h) * HD,
                                               q_stride, T_len - q0, tid);
  load_rows_f32<HD, Cf::ROWS, P, Sp::THREADS>(sG, dout + ((b * T_len + q0) * nq + h) * HD,
                                               q_stride, T_len - q0, tid);
  cp_async_commit();

  // live key tiles [kt_lo, kt_hi) (kernel.py dq_key_tiles)
  const int n_kt = (S_len + BK - 1) / BK;
  const int kt_hi = CAUSAL ? min(n_kt, q_last / BK + 1) : n_kt;
  int kt_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_lo = (q0 - window + 1) / BK;

  auto load_stage = [&](int kt, int stage) {
    const int kk0 = kt * BK;
    float* base = sRing + stage * 2 * Sp::K_TILE;
    load_rows_f32<HD, BK, P, Sp::THREADS>(base, k_base + kk0 * kv_stride, kv_stride,
                                           S_len - kk0, tid);
    load_rows_f32<HD, BK, P, Sp::THREADS>(base + Sp::K_TILE, v_base + kk0 * kv_stride,
                                           kv_stride, S_len - kk0, tid);
  };
  if (kt_lo < kt_hi) load_stage(kt_lo, 0);
  cp_async_commit();

  // lse (in log2 units) and delta of the lane's two rows; 0 past T
  const int t_lo = qw0 + g, t_hi = t_lo + 8;
  const float* lse_row = lse + (b * nq + h) * static_cast<int64_t>(T_len);
  const float* delta_row = delta + (b * nq + h) * static_cast<int64_t>(T_len);
  const float l_lo = t_lo < T_len ? lse_row[t_lo] * kLog2e : 0.f;
  const float l_hi = t_hi < T_len ? lse_row[t_hi] * kLog2e : 0.f;
  const float d_lo = t_lo < T_len ? delta_row[t_lo] : 0.f;
  const float d_hi = t_hi < T_len ? delta_row[t_hi] : 0.f;

  float acc[DW / NC][1][NC][4];
#pragma unroll
  for (int c = 0; c < DW / NC; ++c)
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][0][i][e] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) {
      load_stage(kt + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sK = sRing + stage * 2 * Sp::K_TILE;
    const float* sV = sK + Sp::K_TILE;

    // S = Q K^T, dP = dO V^T: this warp's 16 queries x its NS key n-tiles
    // (all BK keys unless DSPLIT warps share the queries)
    float s[1][NS][4], dp[1][NS][4];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[0][i][e] = dp[0][i][e] = 0.f;
#pragma unroll 1
    for (int ks = 0; ks < HD / 8; ++ks) {
      uint32_t ah[1][4], al[1][4], bh[NS][2], bl[NS][2];
      frag_a_split<P>(ah, al, sQ, rg * 16, ks * 8, g, cq);
      frag_b_rows<P, NS>(bh, bl, sK, ws * NS * 8, ks * 8, g, cq);
      mma3(s, ah, al, bh, bl);
      frag_a_split<P>(ah, al, sG, rg * 16, ks * 8, g, cq);
      frag_b_rows<P, NS>(bh, bl, sV, ws * NS * 8, ks * 8, g, cq);
      mma3(dp, ah, al, bh, bl);
    }

    // ds = p (dp - delta) scale in s, fp32; masked (p = 0) only where the
    // tile crosses the diagonal (causal), the window's edge or S for this
    // warp's rows
    const int k0 = kt * BK;
    const bool edge = (CAUSAL && k0 + BK - 1 > qw0) || k0 + BK > S_len ||
                      (window > 0 && qw0 + 15 - k0 >= window);
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[0][nt][e] * scale_log2 - (e < 2 ? l_lo : l_hi));
        if (edge) {
          const int key = k0 + (ws * NS + nt) * 8 + cq * 2 + (e & 1);
          const int t = e < 2 ? t_lo : t_hi;
          bool live = key < S_len && (!CAUSAL || key <= t);
          if (window > 0) live = live && t - key < window;
          if (!live) p = 0.f;
        }
        s[0][nt][e] = p * (dp[0][nt][e] - (e < 2 ? d_lo : d_hi)) * scale;
      }
    if constexpr (Sp::DSPLIT > 1) {   // hand the row group's ds around
#pragma unroll
      for (int nt = 0; nt < NS; ++nt)
        *reinterpret_cast<float4*>(sX + (ws * NS + nt) * 128 + lane * 4) =
            make_float4(s[0][nt][0], s[0][nt][1], s[0][nt][2], s[0][nt][3]);
      __syncthreads();
    }

    // dQ += ds K over this warp's dims: a k-step of 8 keys a key n-tile of
    // ds; K read across rows
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      float d4[4];   // ds of key n-tile kk
      if constexpr (Sp::DSPLIT > 1) {
        const float4 x = *reinterpret_cast<const float4*>(sX + kk * 128 + lane * 4);
        d4[0] = x.x; d4[1] = x.y; d4[2] = x.z; d4[3] = x.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) d4[e] = s[0][kk][e];
      }
      uint32_t ah[1][4], al[1][4];
      acc_frag_split(ah, al, d4);
#pragma unroll
      for (int c = 0; c < DW / NC; ++c) {
        uint32_t bh[NC][2], bl[NC][2];
        frag_b_cols<P, NC>(bh, bl, sK, kk * 8, (dc0 + c * NC) * 8, g, cq);
        mma3(acc[c], ah, al, bh, bl);
      }
    }
    __syncthreads();   // this stage is free for the tile after next
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = (r ? t_hi : t_lo);
    if (t >= T_len) continue;
#pragma unroll
    for (int dn = 0; dn < DW; ++dn) {
      const int d = (dc0 + dn) * 8 + cq * 2;
      *reinterpret_cast<float2*>(dq + ((b * T_len + t) * nq + h) * HD + d) =
          make_float2(acc[dn / NC][0][dn % NC][2 * r], acc[dn / NC][0][dn % NC][2 * r + 1]);
    }
  }
}

// the route's dK / dV and dQ kernels: fp32 in three TF32 passes, bf16 /
// fp16 on their own type, both on the tensor cores; the dK / dV grid over
// S's key blocks, the dQ grid over T's query blocks
template <typename T, int HD, bool CAUSAL>
cudaError_t launch_tiles(const T* q, const T* k, const T* v, const T* dout, const float* lse,
                         const float* delta, T* dq, T* dk, T* dv, float* work, int64_t B,
                         int64_t T_len, int64_t S_len, int64_t nq, int64_t nkv, int64_t window,
                         float scale, cudaStream_t st) {
  using Cf = BwdMmaCfg<HD>;
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int smem_kv = kSplit ? BwdSplitCfg<HD>::DKDV_SMEM : Cf::DKDV_SMEM;
  constexpr int smem_q = kSplit ? BwdSplitCfg<HD>::DQ_SMEM : Cf::DQ_SMEM;
  auto kern_kv = [] {
    if constexpr (kSplit) return bwd_dkdv_split_kernel<T, HD, CAUSAL>;
    else return bwd_dkdv_mma_kernel<T, HD, CAUSAL>;
  }();
  auto kern_q = [] {
    if constexpr (kSplit) return bwd_dq_split_kernel<T, HD, CAUSAL>;
    else return bwd_dq_mma_kernel<T, HD, CAUSAL>;
  }();
  constexpr int threads = kSplit ? BwdSplitCfg<HD>::THREADS : kHalfThreads;
  const dim3 grid_kv(static_cast<unsigned>((S_len + Cf::ROWS - 1) / Cf::ROWS),
                     static_cast<unsigned>(nq), static_cast<unsigned>(B));
  const dim3 grid_q(static_cast<unsigned>((T_len + Cf::ROWS - 1) / Cf::ROWS),
                    static_cast<unsigned>(nq), static_cast<unsigned>(B));
  const float scale_log2 = scale * kLog2e;
  cudaError_t err =
      cudaFuncSetAttribute(kern_kv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return err;
  kern_kv<<<grid_kv, threads, smem_kv, st>>>(
      q, k, v, dout, lse, delta, dk, dv, work, static_cast<int>(T_len),
      static_cast<int>(S_len), static_cast<int>(nq), static_cast<int>(nkv),
      static_cast<int>(window), scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = cudaFuncSetAttribute(kern_q, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return err;
  kern_q<<<grid_q, threads, smem_q, st>>>(
      q, k, v, dout, lse, delta, dq, static_cast<int>(T_len), static_cast<int>(S_len),
      static_cast<int>(nq), static_cast<int>(nkv), static_cast<int>(window), scale,
      scale_log2);
  return cudaGetLastError();
}

// delta over T's rows, then the route's tile kernels (kernel.py
// BWD_TILE_KERNELS) of the causal or the non-causal instance, then the
// group sum over S's rows when nq > nkv
template <typename T, int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* out,
                       const void* dout, const float* lse, void* dq, void* dk, void* dv,
                       float* delta, float* work, int64_t B, int64_t T_len, int64_t S_len,
                       int64_t nq, int64_t nkv, int64_t window, bool causal, float scale,
                       cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const int64_t rows = B * T_len * nq;
  const int64_t lanes = std::min<int64_t>(32, HD * static_cast<int64_t>(sizeof(T)) / 16);
  bwd_delta_kernel<T><<<static_cast<unsigned>((rows * lanes + kBwdThreads - 1) / kBwdThreads),
                        kBwdThreads, 0, st>>>(static_cast<const T*>(out), gt, delta, rows,
                                              static_cast<int>(T_len), static_cast<int>(nq),
                                              HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto tiles = causal ? launch_tiles<T, HD, true> : launch_tiles<T, HD, false>;
  err = tiles(qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), static_cast<T*>(dk),
              static_cast<T*>(dv), work, B, T_len, S_len, nq, nkv, window, scale, st);
  if (err != cudaSuccess || work == nullptr) return err;

  const int64_t n = B * S_len * nkv * HD;
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
                         float* delta, float* work, int64_t B, int64_t T_len, int64_t S_len,
                         int64_t nq, int64_t nkv, int64_t hd, int64_t window, bool causal,
                         float scale, cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch_bwd<T, 32>(q, k, v, out, dout, lse, dq, dk, dv, delta, work, B, T_len,
                               S_len, nq, nkv, window, causal, scale, st);
    case 64:
      return launch_bwd<T, 64>(q, k, v, out, dout, lse, dq, dk, dv, delta, work, B, T_len,
                               S_len, nq, nkv, window, causal, scale, st);
    case 128:
      return launch_bwd<T, 128>(q, k, v, out, dout, lse, dq, dk, dv, delta, work, B, T_len,
                                S_len, nq, nkv, window, causal, scale, st);
    case 256:
      return launch_bwd<T, 256>(q, k, v, out, dout, lse, dq, dk, dv, delta, work, B, T_len,
                                S_len, nq, nkv, window, causal, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, T, nq, hd), k / v (B, S, nkv, hd), out (B, T, nq, hd), all
// row-major of `dtype`, 16-byte aligned; hd in {32, 64, 128, 256}; nq a
// multiple of nkv; window 0 = none; causal 1 (keys s <= t) or 0 (every
// key). block_q: the fp32 route's query tile, 64 or 32; the bf16 /
// fp16 route takes 64 only. lse: null, or (B, nq, T) fp32 for the rows'
// logsumexp.
int flash_attn_fwd(const void* q, const void* k, const void* v, void* out, void* lse_out,
                   int64_t B,
                   int64_t T_len, int64_t S_len, int64_t nq, int64_t nkv, int64_t hd,
                   int64_t dtype, int64_t window, int64_t causal, int64_t block_q,
                   void* stream) {
  if (B <= 0 || T_len <= 0 || S_len <= 0 || nkv <= 0 || nq % nkv != 0 || window < 0 ||
      T_len > INT32_MAX || S_len > INT32_MAX || window > INT32_MAX ||
      (causal != 0 && causal != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = static_cast<float>(pow(static_cast<double>(hd), -0.5));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  const bool is_causal = causal == 1;
  switch (dtype) {
    case kF32:
      return static_cast<int>(dispatch_f32_hd(q, k, v, out, lse, B, T_len, S_len, nq, nkv, hd,
                                              window, is_causal, block_q, scale, st));
    case kBF16:
      if (block_q != kHalfBQ) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(dispatch_half<__nv_bfloat16>(q, k, v, out, lse, B, T_len, S_len,
                                                           nq, nkv, hd, window, is_causal,
                                                           scale, st));
    case kF16:
      if (block_q != kHalfBQ) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(dispatch_half<__half>(q, k, v, out, lse, B, T_len, S_len, nq,
                                                    nkv, hd, window, is_causal, scale,
                                                    st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward of flash_attn_fwd, at its T, S, causal and window: q, dq
// (B, T, nq, hd); k, v, dk, dv (B, S, nkv, hd); out, dout (B, T, nq, hd),
// all of `dtype`; lse (B, nq, T) fp32 from flash_attn_fwd; delta (B, nq,
// T) fp32 scratch; work: null when nq == nkv, else (2, B, S, nq, hd) fp32
// scratch for the per-q-head dK / dV partials; causal 1 or 0.
int flash_attn_bwd(const void* q, const void* k, const void* v, const void* out,
                   const void* dout, const void* lse, void* dq, void* dk, void* dv,
                   void* delta, void* work, int64_t B, int64_t T_len, int64_t S_len,
                   int64_t nq, int64_t nkv, int64_t hd, int64_t dtype, int64_t window,
                   int64_t causal, void* stream) {
  if (B <= 0 || T_len <= 0 || S_len <= 0 || nkv <= 0 || nq % nkv != 0 || window < 0 ||
      T_len > INT32_MAX || S_len > INT32_MAX || window > INT32_MAX ||
      (causal != 0 && causal != 1) || (nq != nkv && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale = static_cast<float>(pow(static_cast<double>(hd), -0.5));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* w = nq == nkv ? nullptr : static_cast<float*>(work);
  const bool is_causal = causal == 1;
  switch (dtype) {
    case kF32:
      return static_cast<int>(dispatch_bwd<float>(q, k, v, out, dout, l, dq, dk, dv, dl, w, B,
                                                  T_len, S_len, nq, nkv, hd, window,
                                                  is_causal, scale, st));
    case kBF16:
      return static_cast<int>(dispatch_bwd<__nv_bfloat16>(q, k, v, out, dout, l, dq, dk, dv,
                                                          dl, w, B, T_len, S_len, nq, nkv, hd,
                                                          window, is_causal, scale, st));
    case kF16:
      return static_cast<int>(dispatch_bwd<__half>(q, k, v, out, dout, l, dq, dk, dv, dl, w,
                                                   B, T_len, S_len, nq, nkv, hd, window,
                                                   is_causal, scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
