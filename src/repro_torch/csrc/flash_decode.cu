// One-token GQA attention over a ring KV cache (decode) for Hopper (sm_90a).
//
// flash_decode_fwd replaces repro/kernels/flash_decode/kernel.py
// flash_decode (the pallas_call at :88, body _decode_kernel :26-61):
//     out[b, h] = softmax_s(q[b, h] . k[b, s, h / group] * hd^-0.5)
//                 . v[b, s, h / group]
// over the live ring slots s: slot s is live when s <= pos or the ring
// has wrapped (pos >= S), with pos (the position of the token just
// written) read from device memory, so a decode step never waits on the
// host. q (B, 1, nq, hd), caches (B, S, nkv, hd) row-major in fp32, bf16
// or fp16, 16-byte aligned; out (B, 1, nq, hd) in q's dtype. Scores are
// fp32 and scaled AFTER the dot, the probabilities stay fp32 through the
// PV product, as in the TPU kernel.
//
// Bound: device-memory bytes. Each live cache element feeds 2 * group
// FLOPs, far below the card's FLOP/byte knee, so the least time is one
// pass over the live slots of k and v; at serving sizes (3 MB at the
// Qwen2 step) that is about a microsecond, so launches, dependent
// round trips, idle SMs and the instructions a row costs set the time.
// What the design does about it:
//   * ONE launch. Each (b, kv head) and tile of `head_tile` of its q
//     heads is a thread-block cluster of `splits` CTAs (1, 2, 4 or 8).
//     The host picks both from the shapes alone (kernel.py split_plan,
//     head_tile): splits so that the grid holds about one CTA per SM,
//     then head tiles halved while the grid stays within the SMs, so a
//     thin grid (Qwen2's 8 kv heads, Gemma3's 1) spreads over more SMs,
//     each tile reading the same kv rows (from L2 after the first). Each
//     CTA reads pos, counts the live slots and takes its contiguous share
//     [rank * ceil(nlive / splits), ...) of them: no CTA is launched for
//     a dead slot, and none reads one;
//   * 16-byte loads: a lane copies 16 bytes of a key / value row, so
//     LPR = min(32, hd * elem / 16) lanes cover a row and a warp takes
//     32 / LPR rows at once (4 rows of a bf16 hd-64 cache). The copies go
//     by cp.async (LDGSTS, L1 bypassed) into a ring of 3-4 stages of
//     2 rows a lane, each thread reading back only its own pieces, so no
//     barrier guards the ring and 4-6 rows a lane are in flight while a
//     stage is computed;
//   * each lane holds its slice of q for every head of the tile in
//     registers; the dots are reduced over the row's lanes by shuffles,
//     and every lane group runs its own online softmax (m, l and the acc
//     slice) in registers, one kv row serving all the tile's heads. The
//     heads are computed without branches (a head past the group has q =
//     0), so the compiler interleaves their dot and shuffle chains;
//     scores are kept in log2 units (scale2 = hd^-0.5 * log2 e, applied
//     after the dot), so each exponential is one ex2.approx;
//   * the merge: lane groups by shuffles, warps through shared memory in
//     warp order, then each CTA writes its (m, l, acc) partial straight
//     into rank 0's shared memory (distributed shared memory) and, after
//     the cluster barrier, rank 0 merges the partials in rank order and
//     writes out in q's dtype. Every merge is in a fixed order, so results
//     repeat bit for bit. No workspace, no atomics, no second launch.
// Empty shares (pos < splits - 1) and masked rows keep the reference's
// -1e30 sentinel, never -inf: a CTA with no live slot has m = -1e30 and
// l = 0, so its merge weight 2^(-1e30 - M) is 0, and 2^(m - M) with m =
// M = -1e30 is 1, not the NaN that -inf - -inf gives.
//
// The kernel allocates nothing and the launch path neither syncs nor
// reads back: the dynamic shared memory limit (the ring alone is 48-96
// KB) is raised once per kernel and device. The entry point returns the
// cudaError_t of its launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 8;        // a portable cluster
constexpr int kMaxDevices = 64;
constexpr float kNeg = -1e30f;       // the reference's mask value

enum DType : int64_t { kF32 = 0, kBF16 = 1, kF16 = 2 };

// 16 bytes of T as N floats
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // element 2i is the low half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Vec16<__half> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[i] & 0xffffu)));
      f[2 * i + 1] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[i] >> 16)));
    }
  }
};

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(static_cast<const uint4*>(p));
}

// 2^x by the SFU alone (ex2.approx: relative error ~2^-22, far inside
// the fp32 tolerance; exp2f adds range fix-ups no input here needs)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros and
// reads nothing
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

// The cluster barrier in two halves: arrive, and later wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A CTA's schedule for element type T, head dim HD and GT q heads a tile.
template <typename T, int HD, int GT>
struct Plan {
  static constexpr int VEC = Vec16<T>::N;                 // elements a load
  static constexpr int ROW_VECS = HD / VEC;               // loads a row
  static constexpr int LPR = ROW_VECS < 32 ? ROW_VECS : 32;   // lanes a row
  static constexpr int CH = ROW_VECS / LPR;               // loads a lane a row
  static constexpr int EPL = CH * VEC;                    // elements a lane
  static constexpr int RPW = 32 / LPR;                    // rows a warp-load
  static constexpr int U = 2;                             // rows a lane a stage
  static constexpr int STAGE_BYTES = U * CH * 2 * kThreads * 16;
  static constexpr int STAGES = CH == 1 ? 4 : 3;          // the cp.async ring
  static constexpr int ROWS = U * kWarps * RPW;           // rows a CTA a stage
  // the ring: [STAGES][U][CH][k, v][kThreads] 16-byte pieces, each
  // thread's own; after the loop the same bytes hold the warp partials
  // acc [kWarps][GT][HD], m / l [kWarps][GT]
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int PART_BYTES = kWarps * GT * (HD + 2) * 4;
  static constexpr int LOCAL_BYTES = RING_BYTES > PART_BYTES ? RING_BYTES : PART_BYTES;
  // then the cluster's slots, read on rank 0: acc [splits][GT][HD], m / l
  // [splits][GT][2]
  static constexpr int SLOT_FLOATS = GT * (HD + 2);
  static constexpr size_t smem_bytes(int64_t splits) {
    return LOCAL_BYTES + sizeof(float) * SLOT_FLOATS * splits;
  }
  static_assert(HD % VEC == 0 && ROW_VECS % LPR == 0 && STAGES >= 3, "plan");
};

__device__ __forceinline__ int live_slots(const int* pos, int S) {
  const int p = *pos;
  return p >= S ? S : p + 1;
}

// grid (splits * B * nkv * n_gt), clusters of (splits, 1, 1), kThreads
// threads, Plan::smem_bytes(splits) of dynamic shared memory. Scores are
// kept in log2 units (scale2 = hd^-0.5 * log2 e, applied after the dot)
// so that every exponential is one ex2.approx.
template <typename T, int HD, int GT>
__global__ void __launch_bounds__(kThreads, 1)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ pos,
              T* __restrict__ out, int S, int nkv, int group, int n_gt,
              float scale2) {
  using P = Plan<T, HD, GT>;
  constexpr int EPL = P::EPL, VEC = P::VEC, LPR = P::LPR, U = P::U, CH = P::CH;
  constexpr int NS = P::STAGES;
  extern __shared__ float4 smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_raw);
  const uint4* ring = reinterpret_cast<const uint4*>(smem);
  float* w_acc = reinterpret_cast<float*>(smem);        // [kWarps][GT][HD]
  float* w_m = w_acc + kWarps * GT * HD;                // [kWarps][GT]
  float* w_l = w_m + kWarps * GT;                       // [kWarps][GT]
  float* slots = reinterpret_cast<float*>(smem + P::LOCAL_BYTES);

  // arrive now, wait before the first write into rank 0's shared memory:
  // by then every CTA of the cluster has started
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  // 32-bit index math: 64-bit division is a subroutine call
  const int tile = static_cast<int>(blockIdx.x) / splits;   // bk * n_gt + t
  const int bk = tile / n_gt;                           // b * nkv + kvh
  const int g0 = (tile - bk * n_gt) * GT;
  const int gn = min(GT, group - g0);                   // live heads of the tile
  const int b = bk / nkv;
  const int kvh = bk - b * nkv;
  const int64_t head0 = static_cast<int64_t>(bk) * group + g0;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int lr = lane % LPR, rg = lane / LPR;

  // q first: its loads need no position
  float qr[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (g < gn) {
        Vec16<T>::unpack(load16(q + (head0 + g) * HD + (c * LPR + lr) * VEC),
                         &qr[g][c * VEC]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qr[g][c * VEC + e] = 0.f;
      }
    }
  }

  // this CTA's share of the live slots
  const int nlive = live_slots(pos, S);
  const int share = (nlive + splits - 1) / splits;
  const int lo = min(nlive, rank * share);
  const int hi = min(nlive, lo + share);

  const int64_t stride = static_cast<int64_t>(nkv) * HD;   // one slot
  const int64_t off0 = (static_cast<int64_t>(b) * S * nkv + kvh) * HD + lr * VEC;
  const T* kb = k + off0;
  const T* vb = v + off0;
  const uint32_t ring0 = smem_addr(smem);
  // stage `it`'s rows into ring slot it % NS, zeros past hi
  auto copy_stage = [&](int it) {
    const int slot = it % NS;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = lo + it * P::ROWS + (u * kWarps + warp) * P::RPW + rg;
      const bool ok = row < hi;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int64_t off = ok ? row * stride + c * LPR * VEC : 0;
        const int piece = (((slot * U + u) * CH + c) * 2) * kThreads + tid;
        cp_async16(ring0 + piece * 16, kb + off, ok ? 16 : 0);
        cp_async16(ring0 + (piece + kThreads) * 16, vb + off, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  const int n_it = (hi - lo + P::ROWS - 1) / P::ROWS;
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) copy_stage(s);

  float m[GT], l[GT], acc[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int it = 0; it < n_it; ++it) {
    copy_stage(it + NS - 1);       // into the slot consumed last step
    cp_async_wait<NS - 1>();       // this thread's pieces of stage it
    const int slot = it % NS;
    bool ok[U];
    float s[U][GT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = lo + it * P::ROWS + (u * kWarps + warp) * P::RPW + rg < hi;
      float kf[EPL];
#pragma unroll
      for (int c = 0; c < CH; ++c)
        Vec16<T>::unpack(ring[(((slot * U + u) * CH + c) * 2) * kThreads + tid],
                         &kf[c * VEC]);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qr[g][e], kf[e], dot);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        s[u][g] = ok[u] ? dot * scale2 : kNeg;
      }
    }
    // online softmax; s becomes p
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      const float alpha = exp2_approx(m[g] - mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][g] = ok[u] ? exp2_approx(s[u][g] - mx) : 0.f;
        sum += s[u][g];
      }
      l[g] = fmaf(l[g], alpha, sum);
      m[g] = mx;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[EPL];
#pragma unroll
      for (int c = 0; c < CH; ++c)
        Vec16<T>::unpack(ring[(((slot * U + u) * CH + c) * 2 + 1) * kThreads + tid],
                         &vf[c * VEC]);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(s[u][g], vf[e], acc[g][e]);
      }
    }
  }
  cp_async_wait<0>();

  // lane groups of the warp, by shuffles (xor over the row-group bits)
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], o);
      const float mx = fmaxf(m[g], mo);
      const float a = exp2_approx(m[g] - mx), bo = exp2_approx(mo - mx);
      l[g] = fmaf(lo_, bo, l[g] * a);
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        acc[g][e] = fmaf(ao, bo, acc[g][e] * a);
      }
      m[g] = mx;
    }
  }
  __syncthreads();   // every thread's ring pieces are in: the bytes are free
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float* dst = w_acc + (warp * GT + g) * HD + lr * VEC;
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int e = 0; e < VEC; ++e) dst[c * LPR * VEC + e] = acc[g][c * VEC + e];
      if (lr == 0) {
        w_m[warp * GT + g] = m[g];
        w_l[warp * GT + g] = l[g];
      }
    }
  }
  __syncthreads();

  // the CTA's warps in warp order, written straight into rank 0's slot
  // for this rank (distributed shared memory)
  cluster_wait();
  float* r0 = cluster.map_shared_rank(slots, 0);
  float* r0_ml = r0 + splits * GT * HD;
  for (int idx = tid; idx < gn * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    float M = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, w_m[w * GT + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = exp2_approx(w_m[w * GT + g] - M);
      L = fmaf(w_l[w * GT + g], e, L);
      A = fmaf(w_acc[(w * GT + g) * HD + d], e, A);
    }
    r0[(rank * GT + g) * HD + d] = A;
    if (d == 0) {
      r0_ml[(rank * GT + g) * 2] = M;
      r0_ml[(rank * GT + g) * 2 + 1] = L;
    }
  }
  cluster_arrive_release();
  cluster_wait();

  // rank 0: the cluster's CTAs in rank order, from its own shared memory
  if (rank == 0) {
    const float* s_ml = slots + splits * GT * HD;
    for (int idx = tid; idx < gn * HD; idx += kThreads) {
      const int g = idx / HD, d = idx % HD;
      float M = kNeg;
      for (int r = 0; r < splits; ++r) M = fmaxf(M, s_ml[(r * GT + g) * 2]);
      float L = 0.f, A = 0.f;
      for (int r = 0; r < splits; ++r) {
        const float e = exp2_approx(s_ml[(r * GT + g) * 2] - M);
        L = fmaf(s_ml[(r * GT + g) * 2 + 1], e, L);
        A = fmaf(slots[(r * GT + g) * HD + d], e, A);
      }
      out[(head0 + g) * HD + d] = from_f32<T>(A / fmaxf(L, 1e-30f));
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  void* out;
  int64_t B, S, nkv, group, splits, head_tile;
  cudaStream_t stream;
};

// Raise the kernel's dynamic shared memory limit once per device, where
// it needs more than the default 48 KB.
template <typename K>
cudaError_t allow_smem(K kern, size_t smem, std::once_flag* flags, cudaError_t* results) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::call_once(flags[dev], [&] {
    results[dev] = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  });
  return results[dev];
}

// Launch the kernel, or with `clusters` set, report how many of its
// clusters fit on the device at once.
template <typename T, int HD, int GT>
cudaError_t run(const Args& a, int* clusters) {
  using P = Plan<T, HD, GT>;
  static std::once_flag flags[kMaxDevices];
  static cudaError_t results[kMaxDevices];
  auto kern = decode_kernel<T, HD, GT>;
  cudaError_t err = allow_smem(kern, P::smem_bytes(kMaxSplits), flags, results);
  if (err != cudaSuccess) return err;
  const int64_t n_gt = (a.group + GT - 1) / GT;
  const int64_t blocks = a.splits * a.B * a.nkv * n_gt;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = P::smem_bytes(a.splits);
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(a.splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
  const float scale2 =
      static_cast<float>(pow(static_cast<double>(HD), -0.5) * 1.4426950408889634);
  return cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(a.q),
                            static_cast<const T*>(a.k), static_cast<const T*>(a.v),
                            a.pos, static_cast<T*>(a.out), static_cast<int>(a.S),
                            static_cast<int>(a.nkv), static_cast<int>(a.group),
                            static_cast<int>(n_gt), scale2);
}

template <typename T, int HD>
cudaError_t dispatch_gt(const Args& a, int* clusters) {
  switch (a.head_tile) {
    case 1: return run<T, HD, 1>(a, clusters);
    case 2: return run<T, HD, 2>(a, clusters);
    case 4: return run<T, HD, 4>(a, clusters);
    case 8: return run<T, HD, 8>(a, clusters);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_hd(const Args& a, int64_t hd, int* clusters) {
  switch (hd) {
    case 32: return dispatch_gt<T, 32>(a, clusters);
    case 64: return dispatch_gt<T, 64>(a, clusters);
    case 128: return dispatch_gt<T, 128>(a, clusters);
    case 256: return dispatch_gt<T, 256>(a, clusters);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const Args& a, int64_t hd, int64_t dtype, int* clusters) {
  if (a.B < 0 || a.S <= 0 || a.S > 0x7fffffff || a.nkv <= 0 || a.group <= 0 || a.splits < 1 ||
      a.splits > kMaxSplits || (a.splits & (a.splits - 1)) != 0 ||
      a.nkv * a.group > 0x7fffffff)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case kF32: return dispatch_hd<float>(a, hd, clusters);
    case kBF16: return dispatch_hd<__nv_bfloat16>(a, hd, clusters);
    case kF16: return dispatch_hd<__half>(a, hd, clusters);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, 1, nq, hd) with nq = nkv * group; k / v caches (B, S, nkv, hd);
// pos a device int32; out (B, 1, nq, hd), all row-major of `dtype` and
// 16-byte aligned; splits in {1, 2, 4, 8} CTAs a cluster, head_tile in
// {1, 2, 4, 8} q heads of one kv head a cluster.
int flash_decode_fwd(const void* q, const void* k, const void* v, const void* pos,
                     void* out, int64_t B, int64_t S, int64_t nkv, int64_t group,
                     int64_t hd, int64_t dtype, int64_t splits, int64_t head_tile,
                     void* stream) {
  const Args a{q, k, v, static_cast<const int*>(pos), out, B, S, nkv, group, splits,
               head_tile, static_cast<cudaStream_t>(stream)};
  if (B == 0) return static_cast<int>(cudaSuccess);
  return static_cast<int>(dispatch(a, hd, dtype, nullptr));
}

// How many clusters of `splits` CTAs of the kernel for (hd, dtype,
// head_tile) fit on the current device at once
// (cudaOccupancyMaxActiveClusters), into *clusters; returns the
// cudaError_t.
int flash_decode_max_active_clusters(int64_t hd, int64_t dtype, int64_t head_tile,
                                     int64_t splits, void* clusters) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, 1, head_tile, splits,
               head_tile, nullptr};
  return static_cast<int>(dispatch(a, hd, dtype, static_cast<int*>(clusters)));
}

}  // extern "C"
