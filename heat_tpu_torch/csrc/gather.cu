// Row gather (K2) and fused history-mean gather (K1) for Hopper (sm_90a).
//
// Replaces the Pallas kernels of heat_tpu/ops/pallas/gather.py:
//   * heat_gather_rows_f32    <- gather_rows          (gather.py:80)
//   * heat_history_mean_f32   <- history_mean_gather  (gather.py:141)
//
// What bounds them on the H100: bytes. Both kernels do no arithmetic worth
// counting (K1 does one add per 4 bytes read); each is a stream of random
// row reads from a table that lives in device memory. At the config0
// step K2 moves 147,456 rows of 256 B (about 38 MB read + 38 MB written) and
// K1 reads up to 8192 x 100 rows of 256 B (about 210 MB) and writes 2 MB.
//
// What the design does about it:
//   * A row is read by neighbouring threads as 16-byte float4 loads, so one
//     row of width 64 is one 256-byte coalesced access by 16 threads.
//   * K1 keeps the running sum in registers and never writes the (B, H, d)
//     gather to device memory; only the (B, d) means leave the kernel.
//   * K1 reads only the valid prefix h < len[b] of each history. Masked
//     slots are never read (the Pallas kernel and XLA read all H slots).
//   * Ids are loaded by the threads that use them; there is no scalar
//     prefetch and no DMA window (those were the TPU's constraints).
//   * Any width d: a float4 path when d % 4 == 0 and the pointers are
//     16-byte aligned, a scalar path otherwise. No d % 128 restriction.
//
// Contract (checked by the Python wrappers in heat_tpu_torch/ops/cuda):
// f32 tables, int32 ids, contiguous row-major arrays, ids in [0, n_rows).
// An id outside that range is not read: K2 writes a zero row for it and
// K1 leaves it out of the sum. Each entry point launches on the given
// stream, does not synchronise, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void vadd(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void vadd(float& a, float b) { a += b; }

__device__ __forceinline__ void vdiv(float4& a, float s) {
  a.x = a.x / s;
  a.y = a.y / s;
  a.z = a.z / s;
  a.w = a.w / s;
}
__device__ __forceinline__ void vdiv(float& a, float s) { a = a / s; }

template <typename V>
__device__ __forceinline__ V vzero();
template <>
__device__ __forceinline__ float4 vzero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <>
__device__ __forceinline__ float vzero<float>() {
  return 0.f;
}

int grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  // Grid-stride loops cover the rest; 132 SMs x 16 blocks keeps the card
  // full without a grid dimension overflow at any size.
  const int64_t cap = 132 * 16;
  return static_cast<int>(blocks < cap ? blocks : cap);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// out[j, c] = table[ids[j], c], in units of V (float4 or float).
// Element e of the flat (m, dv) output is handled by one thread; the dv
// threads of a row are neighbours, so each row is one coalesced access.
template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ table,
                                   const int32_t* __restrict__ ids,
                                   V* __restrict__ out, int64_t n_rows,
                                   int64_t m, int dv) {
  const int64_t total = m * dv;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t j = e / dv;
    const int c = static_cast<int>(e - j * dv);
    const int64_t id = ids[j];
    out[e] = (id >= 0 && id < n_rows) ? table[id * dv + c] : vzero<V>();
  }
}

// out[b] = sum_{h < min(len[b], H)} table[his_ids[b, h]] / max(len[b], 1).
// A group of G threads (a power of two <= 32, so a group never straddles a
// warp) owns one sample; thread t of the group owns columns t, t+G, ...
// The sum runs in f32 in history order and is divided once at the end,
// the single terminal rounding of models/aggregator.py history_mean.
template <typename V>
__global__ void history_mean_kernel(const V* __restrict__ table,
                                    const int32_t* __restrict__ his_ids,
                                    const int32_t* __restrict__ lens,
                                    V* __restrict__ out, int64_t n_rows,
                                    int64_t batch, int his, int dv,
                                    int group) {
  const int64_t groups_per_block = blockDim.x / group;
  const int t = threadIdx.x % group;
  for (int64_t b = blockIdx.x * groups_per_block + threadIdx.x / group;
       b < batch; b += (int64_t)gridDim.x * groups_per_block) {
    const int len = lens[b];
    const int n = len < 0 ? 0 : (len < his ? len : his);
    const float denom = static_cast<float>(len > 1 ? len : 1);
    const int32_t* row_ids = his_ids + b * his;
    for (int c = t; c < dv; c += group) {
      V acc = vzero<V>();
      for (int h = 0; h < n; ++h) {
        const int64_t id = row_ids[h];
        if (id >= 0 && id < n_rows) vadd(acc, table[id * dv + c]);
      }
      vdiv(acc, denom);
      out[b * dv + c] = acc;
    }
  }
}

int group_for(int dv) {
  int g = 1;
  while (g < dv && g < 32) g <<= 1;
  return g;
}

}  // namespace

extern "C" int heat_gather_rows_f32(const float* table, int64_t n_rows, int d,
                                    const int32_t* ids, int64_t m, float* out,
                                    void* stream) {
  if (m == 0 || d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && aligned16(table) && aligned16(out)) {
    const int dv = d / 4;
    gather_rows_kernel<float4><<<grid_for(m * dv), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(table), ids,
        reinterpret_cast<float4*>(out), n_rows, m, dv);
  } else {
    gather_rows_kernel<float><<<grid_for(m * d), kThreads, 0, s>>>(
        table, ids, out, n_rows, m, d);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int heat_history_mean_f32(const float* table, int64_t n_rows, int d,
                                     const int32_t* his_ids,
                                     const int32_t* lens, int64_t batch,
                                     int his, float* out, void* stream) {
  if (batch == 0 || d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && aligned16(table) && aligned16(out);
  const int dv = vec ? d / 4 : d;
  const int group = group_for(dv);
  const int64_t per_block = kThreads / group;
  const int blocks = grid_for(((batch + per_block - 1) / per_block) * kThreads);
  if (vec) {
    history_mean_kernel<float4><<<blocks, kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(table), his_ids, lens,
        reinterpret_cast<float4*>(out), n_rows, batch, his, dv, group);
  } else {
    history_mean_kernel<float><<<blocks, kThreads, 0, s>>>(
        table, his_ids, lens, out, n_rows, batch, his, dv, group);
  }
  return static_cast<int>(cudaGetLastError());
}
