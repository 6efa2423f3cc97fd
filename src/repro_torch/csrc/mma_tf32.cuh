// fp32 products on Hopper's tensor cores in three TF32 passes, shared by
// ssd_chunk.cu and flash_attention.cu.
//
// One TF32 pass (mma.sync.m16n8k8 .tf32) rounds each operand to a 10-bit
// mantissa, which leaves the fp32 tolerances of both kernels. Split each
// operand into hi = cvt.rna.tf32(v) and lo = cvt.rna.tf32(v - hi) (about
// 21 bits together) and take lo.hi + hi.lo + hi.hi into fp32
// accumulators: the dropped lo.lo term is below fp32's own rounding, so
// the product is as exact as fp32 FMAs (tests/test_torch_ssd_plan.py and
// tests/test_torch_flash_bwd_tiles.py model it on the CPU).
//
// m16n8k8 fragments, g = lane / 4, t = lane % 4:
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// v = hi + lo to about 21 bits: hi is v rounded to TF32 (10-bit
// mantissa, to nearest, ties away), lo the remainder rounded likewise.
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(v - __uint_as_float(hi));
}

// The same split in three instructions, for finite v: hi is v rounded as
// cvt.rna rounds it (half a TF32 ulp added to the magnitude's bits, then
// the low 13 bits masked), lo = v - hi exactly, handed over as it is:
// mma.sync reads only the top 19 bits of a .tf32 operand, so lo enters
// the product truncated to TF32 (error at most 2^-21 |v|, against 2^-22
// for a rounded lo). On sm_90a cvt.rna.tf32.f32 is no single SASS
// instruction, so split takes more than these three. The SSD backward,
// whose products are mostly splits, uses this one
// (tests/test_torch_ssd_bwd_plan.py models it and holds it to the
// backward's tolerance). The SSD forward and the fp32 attention backward
// keep split: whether they would stay within their tolerances on the
// card with split_rz has not been checked.
__device__ __forceinline__ void split_rz(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a (16 x 8, row) . b (8 x 8, col), TF32 in, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[i][j] += a[i] . b[j] for MI m-tiles by NJ n-tiles in three TF32
// passes, the small terms first: lo.hi over every tile, then hi.lo, then
// hi.hi, so that each accumulator's three products stand MI * NJ
// instructions apart instead of waiting on each other.
template <int MI, int NJ>
__device__ __forceinline__ void mma3(float (&d)[MI][NJ][4], const uint32_t (&ah)[MI][4],
                                     const uint32_t (&al)[MI][4], const uint32_t (&bh)[NJ][2],
                                     const uint32_t (&bl)[NJ][2]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(d[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(d[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) mma_tf32(d[i][j], ah[i], bh[j][0], bh[j][1]);
}

// The same over the n-tiles j0 <= j < j1 only (runtime bounds: the causal
// part of a diagonal tile). With kAloFirst false the first two passes
// swap (hi.lo, lo.hi, hi.hi): B A^T then takes each accumulator's products
// in the order A B^T takes them, so the transposed product comes out with
// the same sums.
template <bool kAloFirst = true, int MI, int NJ>
__device__ __forceinline__ void mma3_cols(float (&d)[MI][NJ][4], const uint32_t (&ah)[MI][4],
                                          const uint32_t (&al)[MI][4],
                                          const uint32_t (&bh)[NJ][2],
                                          const uint32_t (&bl)[NJ][2], int j0, int j1) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (j >= j0 && j < j1) {
        if (kAloFirst) mma_tf32(d[i][j], al[i], bh[j][0], bh[j][1]);
        else mma_tf32(d[i][j], ah[i], bl[j][0], bl[j][1]);
      }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (j >= j0 && j < j1) {
        if (kAloFirst) mma_tf32(d[i][j], ah[i], bl[j][0], bl[j][1]);
        else mma_tf32(d[i][j], al[i], bh[j][0], bh[j][1]);
      }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (j >= j0 && j < j1) mma_tf32(d[i][j], ah[i], bh[j][0], bh[j][1]);
}

// The same, skipping the m-tiles with live[i] false.
template <int MI, int NJ>
__device__ __forceinline__ void mma3(float (&d)[MI][NJ][4], const uint32_t (&ah)[MI][4],
                                     const uint32_t (&al)[MI][4], const uint32_t (&bh)[NJ][2],
                                     const uint32_t (&bl)[NJ][2], const bool (&live)[MI]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (live[i]) mma_tf32(d[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (live[i]) mma_tf32(d[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (live[i]) mma_tf32(d[i][j], ah[i], bh[j][0], bh[j][1]);
}

}  // namespace
