// Top-k window extraction (K4) for Hopper (sm_90a): phase 2 of the
// two-phase exact top-k (evaluation/evaluator.py exact_topk_2phase).
//
// Replaces the two TPU designs of one function in scripts/profile_eval.py:
//   * pallas_extract         (profile_eval.py:264) -- a one-hot matmul in VMEM
//   * pallas_extract_slices  (profile_eval.py:361) -- dynamic slices in VMEM
// and the one-hot einsum of heat_tpu/evaluation/evaluator.py:129-138, which
// is their package counterpart:
//
//   out[r, j, :] = sim[r, widx[r, j] * w : (widx[r, j] + 1) * w]
//
// A window id outside [0, n_cols / w) gives a row of -FLT_MAX (the
// finfo(f32).min that masks a score everywhere else), so it never ranks.
//
// What bounds it on the H100: bytes of the selected windows, nothing else.
// It is a pure copy. At the eval tile (512 rows, k = 50, w = 128) it reads
// and writes 512 x 50 x 512 B = 13 MB; at a B = 8192 request with k = 20,
// 84 MB each way. The TPU needed the one-hot matmul because its gathers pay
// per index; it streams the whole (rows, n_cols) tile through the MXU to
// pick k windows. Here a window is 512 contiguous bytes.
//
// What the design does about it:
//   * One warp per (row, candidate) pair. A 128-float window is one
//     coalesced 512 B access by the warp's 32 lanes, 16 B (float4) each.
//   * Only the k selected windows of a row are read: kw x 512 B, not the
//     row's n_cols x 4 B.
//   * widx is read once per warp (one 4 B load broadcast to the lanes).
//   * Any window width: a float4 path when w % 4 == 0 and the pointers are
//     16-byte aligned, a scalar path otherwise; lanes stride over wider
//     windows.
//
// Contract (checked by heat_tpu_torch/ops/cuda/topk.py): sim f32 row-major
// (rows, n_cols) with n_cols % w == 0, widx int32 row-major (rows, kw), out
// f32 (rows, kw, w). Makes `device` current (launch.cuh), launches on the
// given stream, does not synchronise, allocates nothing, may be captured in
// a CUDA graph and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

template <typename V>
__device__ __forceinline__ V vfill(float x);
template <>
__device__ __forceinline__ float4 vfill<float4>(float x) {
  return make_float4(x, x, x, x);
}
template <>
__device__ __forceinline__ float vfill<float>(float x) {
  return x;
}

// Warp g of the grid copies pair g = r * kw + j. In units of V (float4 or
// float): a window holds wv units and a row n_cols_v units.
template <typename V>
__global__ void window_extract_kernel(const V* __restrict__ sim,
                                      const int32_t* __restrict__ widx,
                                      V* __restrict__ out, int64_t pairs,
                                      int kw, int64_t n_cols_v, int wv,
                                      int64_t nw) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t g = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       g < pairs; g += warps) {
    const int64_t r = g / kw;
    const int64_t win = widx[g];
    V* dst = out + g * wv;
    if (win >= 0 && win < nw) {
      const V* src = sim + r * n_cols_v + win * wv;
      for (int c = lane; c < wv; c += 32) dst[c] = src[c];
    } else {
      const V fill = vfill<V>(-FLT_MAX);
      for (int c = lane; c < wv; c += 32) dst[c] = fill;
    }
  }
}

int grid_for(int64_t pairs) {
  const int64_t blocks = (pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  // A grid-stride loop covers the rest: 132 SMs x 16 blocks of 8 warps
  // keeps every SM's 64 warp slots full at any size.
  const int64_t cap = 132 * 16;
  return static_cast<int>(blocks < cap ? blocks : cap);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int heat_window_extract_f32(const float* sim, int64_t rows,
                                       int64_t n_cols, const int32_t* widx,
                                       int kw, int w, float* out,
                                       int device, void* stream) {
  heat::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const int64_t pairs = rows * kw;
  if (pairs == 0 || w == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nw = n_cols / w;
  if (w % 4 == 0 && aligned16(sim) && aligned16(out)) {
    window_extract_kernel<float4><<<grid_for(pairs), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(sim), widx,
        reinterpret_cast<float4*>(out), pairs, kw, n_cols / 4, w / 4, nw);
  } else {
    window_extract_kernel<float><<<grid_for(pairs), kThreads, 0, s>>>(
        sim, widx, out, pairs, kw, n_cols, w, nw);
  }
  return static_cast<int>(cudaGetLastError());
}
