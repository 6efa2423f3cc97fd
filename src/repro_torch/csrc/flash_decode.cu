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
// or fp16; out (B, 1, nq, hd) in q's dtype. Scores are fp32 and scaled
// AFTER the dot, the probabilities stay fp32 through the PV product, as
// in the TPU kernel.
//
// Bound: device-memory bytes. Each live cache element feeds 2 * group
// FLOPs, far below the card's FLOP/byte knee, so the least time is one
// pass over the live slots of k and v. What the design does about it:
//   * the TPU grid (B * nkv, S / 512) walks the sequence in order on one
//     core; on Hopper that would leave 8 blocks for Qwen2's B = 4, nkv = 2
//     on 132 SMs. Here the sequence is split into chunks of 64 slots (32
//     at hd 256) and every (b, kv head, chunk) is a block: a partial
//     pass writes each chunk's (m, l, unnormalised acc) to a workspace
//     and a combine pass merges the chunks of each (b, q head) in a fixed
//     order -- no atomics, so results repeat bit for bit;
//   * chunks wholly past pos (the ring not yet wrapped) are not read:
//     both passes compute the live chunk count from pos;
//   * one block serves all `group` q heads of its kv head, so each cache
//     row is read once for the group (no GQA duplication): a warp reads
//     a key row coalesced and reduces its dots with shuffles; the chunk
//     of v is staged once in shared memory as fp32;
//   * any S is taken (the decoder's ring caches are min(length, window)
//     long); masked slots inside a live chunk are simply not summed,
//     which equals the reference's -1e30 mask since every live chunk
//     holds a live slot.
//
// The kernels allocate nothing (the wrapper passes the workspace); the
// entry point returns the cudaGetLastError() of its launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

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

__device__ __forceinline__ int64_t live_slots(const int* pos, int64_t S) {
  const int64_t p = *pos;
  return p >= S ? S : p + 1;
}

// grid (n_chunks, B * nkv); dynamic shared memory: q (group, HD), scores
// (group, chunk), v (chunk, HD), all fp32.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ pos,
                      float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                      int64_t S, int nkv, int group, int chunk, float scale) {
  constexpr int PER_LANE = HD / 32;
  extern __shared__ float4 smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);   // [group][HD]
  float* ss = qs + group * HD;                       // [group][chunk]
  float* vs = ss + group * chunk;                    // [chunk][HD]

  const int64_t nlive = live_slots(pos, S);
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * chunk;
  if (c0 >= nlive) return;                           // dead chunk: never read
  const int n_here = static_cast<int>(min(static_cast<int64_t>(chunk), nlive - c0));
  const int64_t bk = blockIdx.y;                     // b * nkv + kv head
  const int64_t b = bk / nkv;
  const int kvh = static_cast<int>(bk % nkv);
  const int nq = nkv * group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int idx = tid; idx < group * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    qs[idx] = to_f32(q[(b * nq + kvh * group + g) * HD + d]);
  }
  for (int idx = tid; idx < n_here * HD; idx += kThreads) {
    const int j = idx / HD, d = idx % HD;
    vs[idx] = to_f32(v[((b * S + c0 + j) * nkv + kvh) * HD + d]);
  }
  __syncthreads();

  // scores: a warp per key row, lanes over the head dim
  for (int j = warp; j < n_here; j += kWarps) {
    const T* krow = k + ((b * S + c0 + j) * nkv + kvh) * HD;
    float kr[PER_LANE];
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) kr[e] = to_f32(krow[lane + 32 * e]);
    for (int g = 0; g < group; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e) dot = fmaf(qs[g * HD + lane + 32 * e], kr[e], dot);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) ss[g * chunk + j] = dot * scale;
    }
  }
  __syncthreads();

  // chunk softmax: a warp per q head
  const int64_t slot = (bk * gridDim.x + blockIdx.x) * group;
  for (int g = warp; g < group; g += kWarps) {
    float mx = -INFINITY;
    for (int j = lane; j < n_here; j += 32) mx = fmaxf(mx, ss[g * chunk + j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int j = lane; j < n_here; j += 32) {
      const float p = expf(ss[g * chunk + j] - mx);
      ss[g * chunk + j] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      ws_ml[2 * (slot + g)] = mx;
      ws_ml[2 * (slot + g) + 1] = sum;
    }
  }
  __syncthreads();

  // unnormalised acc[g][d] = sum_j p[g][j] * v[j][d]
  for (int idx = tid; idx < group * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    float acc = 0.f;
    for (int j = 0; j < n_here; ++j) acc = fmaf(ss[g * chunk + j], vs[j * HD + d], acc);
    ws_acc[(slot + g) * HD + d] = acc;
  }
}

// grid (B * nkv * group); blockDim HD: merge the live chunks of one
// (b, q head) in chunk order.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
decode_combine_kernel(const float* __restrict__ ws_acc,
                      const float* __restrict__ ws_ml, const int* __restrict__ pos,
                      T* __restrict__ out, int64_t S, int group, int chunk,
                      int n_chunks) {
  const int64_t nlive = live_slots(pos, S);
  const int used = static_cast<int>((nlive + chunk - 1) / chunk);
  const int64_t bkg = blockIdx.x;
  const int64_t bk = bkg / group;
  const int g = static_cast<int>(bkg % group);
  const int d = threadIdx.x;
  float M = -INFINITY;
  for (int c = 0; c < used; ++c)
    M = fmaxf(M, ws_ml[2 * ((bk * n_chunks + c) * group + g)]);
  float L = 0.f, acc = 0.f;
  for (int c = 0; c < used; ++c) {
    const int64_t slot = (bk * n_chunks + c) * group + g;
    const float w = expf(ws_ml[2 * slot] - M);
    L = fmaf(ws_ml[2 * slot + 1], w, L);
    acc = fmaf(ws_acc[slot * HD + d], w, acc);
  }
  // out is (B, nq, HD): q head h = kvh * group + g, so the flat index
  // (b * nkv + kvh) * group + g is b * nq + h
  out[bkg * HD + d] = from_f32<T>(acc / fmaxf(L, 1e-30f));
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pos,
                   void* out, float* ws_acc, float* ws_ml, int64_t B, int64_t S,
                   int64_t nkv, int64_t group, int64_t chunk, int64_t n_chunks,
                   cudaStream_t st) {
  const float scale = static_cast<float>(pow(static_cast<double>(HD), -0.5));
  const size_t smem = sizeof(float) * (group * HD + group * chunk + chunk * HD);
  auto part = decode_partial_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        part, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  part<<<dim3(static_cast<unsigned>(n_chunks), static_cast<unsigned>(B * nkv)),
         kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      pos, ws_acc, ws_ml, S, static_cast<int>(nkv), static_cast<int>(group),
      static_cast<int>(chunk), scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T, HD><<<static_cast<unsigned>(B * nkv * group), HD, 0, st>>>(
      ws_acc, ws_ml, pos, static_cast<T*>(out), S, static_cast<int>(group),
      static_cast<int>(chunk), static_cast<int>(n_chunks));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, const int* pos,
                        void* out, float* ws_acc, float* ws_ml, int64_t B, int64_t S,
                        int64_t nkv, int64_t group, int64_t hd, int64_t chunk,
                        int64_t n_chunks, cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, pos, out, ws_acc, ws_ml, B, S, nkv, group, chunk, n_chunks, st);
    case 64:
      return launch<T, 64>(q, k, v, pos, out, ws_acc, ws_ml, B, S, nkv, group, chunk, n_chunks, st);
    case 128:
      return launch<T, 128>(q, k, v, pos, out, ws_acc, ws_ml, B, S, nkv, group, chunk, n_chunks, st);
    case 256:
      return launch<T, 256>(q, k, v, pos, out, ws_acc, ws_ml, B, S, nkv, group, chunk, n_chunks, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, 1, nq, hd) with nq = nkv * group; k / v caches (B, S, nkv, hd);
// pos a device int32; out (B, 1, nq, hd), all row-major of `dtype`;
// ws_acc (B * nkv, n_chunks, group, hd) and ws_ml (B * nkv, n_chunks,
// group, 2) fp32 scratch with n_chunks = ceil(S / chunk).
int flash_decode_fwd(const void* q, const void* k, const void* v, const void* pos,
                     void* out, void* ws_acc, void* ws_ml, int64_t B, int64_t S,
                     int64_t nkv, int64_t group, int64_t hd, int64_t dtype,
                     int64_t chunk, int64_t n_chunks, void* stream) {
  if (B <= 0 || S <= 0 || nkv <= 0 || group <= 0 || chunk <= 0 ||
      n_chunks != (S + chunk - 1) / chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  float* wa = static_cast<float*>(ws_acc);
  float* wm = static_cast<float*>(ws_ml);
  switch (dtype) {
    case kF32:
      return static_cast<int>(dispatch_hd<float>(q, k, v, p, out, wa, wm, B, S, nkv,
                                                 group, hd, chunk, n_chunks, st));
    case kBF16:
      return static_cast<int>(dispatch_hd<__nv_bfloat16>(q, k, v, p, out, wa, wm, B, S,
                                                         nkv, group, hd, chunk, n_chunks,
                                                         st));
    case kF16:
      return static_cast<int>(dispatch_hd<__half>(q, k, v, p, out, wa, wm, B, S, nkv,
                                                  group, hd, chunk, n_chunks, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
