// Row gather (K2), fused history-mean gather (K1) and block gather (S2) for
// Hopper (sm_90a), each for f32 and bf16 tables.
//
// Replaces the Pallas kernels
//   * heat_gather_rows_{f32,bf16}    <- heat_tpu/ops/pallas/gather.py:80
//                                       gather_rows
//   * heat_history_mean_{f32,bf16}   <- heat_tpu/ops/pallas/gather.py:141
//                                       history_mean_gather
//   * heat_gather_blocks_{f32,bf16}  <- scripts/profile_exact_ceiling.py:125
//                                       gather_blocks (_multi_row_kernel)
// The Pallas kernels take f32 only (XLA ran the bf16 tables); here the
// kernels are the path, so each has a bf16 instance.
//
// What bounds them on the H100: bytes. None does arithmetic worth counting
// (K1 does one add per element read); each is a stream of random row reads
// from a table in device memory. At the config0 step K2 moves 147,456 f32
// rows of 256 B (about 38 MB read + 38 MB written) and K1 reads up to
// 8192 x 100 rows (about 210 MB in f32, half that in bf16) and writes 2 MB.
// S2 at its measuring shape moves 65,536 f32 rows of 512 B (34 MB each way)
// as 65,536 / r blocks of r contiguous rows.
//
// What the design does about it:
//   * A row is read by neighbouring threads as 16-byte loads (4 f32 or
//     8 bf16), so one f32 row of width 64 is one 256-byte coalesced access
//     by 16 threads, and one bf16 row of width 64 a 128-byte access by 8.
//   * K1 keeps the running sum in f32 registers, whatever the table's
//     type, and never writes the (B, H, d) gather to device memory; only
//     the (B, d) means leave the kernel, rounded once to the output type.
//   * K1 reads only the valid prefix h < len[b] of each history. Masked
//     slots are never read (the Pallas kernel and XLA read all H slots).
//   * S2's block of r rows is r * d contiguous elements: it is copied by
//     as many threads as it has 16-byte vectors (a warp covers 512 B), with
//     the copy loop of K2. The TPU kernel's 1,024 ids staged in SMEM and
//     its 256-deep window of r-row DMAs are not carried over: the many
//     blocks in flight keep the loads outstanding.
//   * Ids are loaded by the threads that use them; there is no scalar
//     prefetch (that was the TPU's constraint).
//   * Any width d: the 16-byte path when a row is a whole number of
//     vectors and the pointers are 16-byte aligned, an element-wise path
//     otherwise. No d % 128 restriction. Offsets are 64-bit.
//
// Contract (checked by the Python wrappers in heat_tpu_torch/ops/cuda):
// f32 or bf16 tables, int32 ids, contiguous row-major arrays, ids in
// [0, n_rows). An id outside that range is not read: K2 and S2 write zeros
// for it and K1 leaves it out of the sum. Each entry point makes `device`
// current (launch.cuh), launches on the given stream, does not synchronise,
// allocates nothing, may be captured in a CUDA graph and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;

// N elements of T moved as one access of at most 16 bytes.
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Vec {
  T v[N];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
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

// out[j, c] = table[ids[j], c], in units of V (a 16-byte vector or one
// element). Unit e of the flat (m, dv) output is handled by one thread; the
// dv threads of a row are neighbours, so each row is one coalesced access.
// With a "row" of r * d elements this is S2's block copy.
template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ table,
                                   const int32_t* __restrict__ ids,
                                   V* __restrict__ out, int64_t n_rows,
                                   int64_t m, int64_t dv) {
  const int64_t total = m * dv;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t j = e / dv;
    const int64_t c = e - j * dv;
    const int64_t id = ids[j];
    V v = V();
    if (id >= 0 && id < n_rows) v = table[id * dv + c];
    out[e] = v;
  }
}

// The copy of m rows of `width` elements of T each, 16 bytes a thread where
// the rows allow it.
template <typename T>
int launch_gather(const T* table, int64_t n_rows, int64_t width,
                  const int32_t* ids, int64_t m, T* out, cudaStream_t s) {
  constexpr int kPer = 16 / sizeof(T);
  if (m == 0 || width == 0) return 0;
  if (width % kPer == 0 && aligned16(table) && aligned16(out)) {
    using V = Vec<T, kPer>;
    const int64_t dv = width / kPer;
    gather_rows_kernel<V><<<grid_for(m * dv), kThreads, 0, s>>>(
        reinterpret_cast<const V*>(table), ids, reinterpret_cast<V*>(out),
        n_rows, m, dv);
  } else {
    using V = Vec<T, 1>;
    gather_rows_kernel<V><<<grid_for(m * width), kThreads, 0, s>>>(
        reinterpret_cast<const V*>(table), ids, reinterpret_cast<V*>(out),
        n_rows, m, width);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[b] = sum_{h < min(len[b], H)} table[his_ids[b, h]] / max(len[b], 1).
// A group of G threads (a power of two <= 32, so a group never straddles a
// warp) owns one sample; thread t of the group owns vectors t, t+G, ... of
// N elements each. Each element is cast to the output type O first (exact
// from bf16 to f32; the rounding of the rows to the compute type from f32
// to bf16), the sum runs in f32 in history order, and is divided and
// rounded once at the end: the single terminal rounding of
// models/aggregator.py history_mean_fused.
template <typename T, typename O, int N>
__global__ void history_mean_kernel(const Vec<T, N>* __restrict__ table,
                                    const int32_t* __restrict__ his_ids,
                                    const int32_t* __restrict__ lens,
                                    Vec<O, N>* __restrict__ out,
                                    int64_t n_rows, int64_t batch, int his,
                                    int dv, int group) {
  const int64_t groups_per_block = blockDim.x / group;
  const int t = threadIdx.x % group;
  for (int64_t b = blockIdx.x * groups_per_block + threadIdx.x / group;
       b < batch; b += (int64_t)gridDim.x * groups_per_block) {
    const int len = lens[b];
    const int n = len < 0 ? 0 : (len < his ? len : his);
    const float denom = static_cast<float>(len > 1 ? len : 1);
    const int32_t* row_ids = his_ids + b * his;
    for (int c = t; c < dv; c += group) {
      float acc[N];
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] = 0.f;
      for (int h = 0; h < n; ++h) {
        const int64_t id = row_ids[h];
        if (id < 0 || id >= n_rows) continue;
        const Vec<T, N> v = table[id * dv + c];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          acc[i] += to_float(from_float<O>(to_float(v.v[i])));
        }
      }
      Vec<O, N> o;
#pragma unroll
      for (int i = 0; i < N; ++i) o.v[i] = from_float<O>(acc[i] / denom);
      out[b * dv + c] = o;
    }
  }
}

int group_for(int dv) {
  int g = 1;
  while (g < dv && g < 32) g <<= 1;
  return g;
}

template <typename T, typename O, int N>
void launch_mean_n(const T* table, int64_t n_rows, int d,
                   const int32_t* his_ids, const int32_t* lens, int64_t batch,
                   int his, O* out, cudaStream_t s) {
  const int dv = d / N;
  const int group = group_for(dv);
  const int64_t per_block = kThreads / group;
  const int blocks =
      grid_for(((batch + per_block - 1) / per_block) * kThreads);
  history_mean_kernel<T, O, N><<<blocks, kThreads, 0, s>>>(
      reinterpret_cast<const Vec<T, N>*>(table), his_ids, lens,
      reinterpret_cast<Vec<O, N>*>(out), n_rows, batch, his, dv, group);
}

template <typename T, typename O>
int launch_mean(const T* table, int64_t n_rows, int d, const int32_t* his_ids,
                const int32_t* lens, int64_t batch, int his, O* out,
                cudaStream_t s) {
  constexpr int kPer = 16 / sizeof(T);
  if (batch == 0 || d == 0) return 0;
  if (d % kPer == 0 && aligned16(table) && aligned16(out)) {
    launch_mean_n<T, O, kPer>(table, n_rows, d, his_ids, lens, batch, his, out,
                              s);
  } else {
    launch_mean_n<T, O, 1>(table, n_rows, d, his_ids, lens, batch, his, out,
                           s);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int history_mean(const T* table, int64_t n_rows, int d, const int32_t* his_ids,
                 const int32_t* lens, int64_t batch, int his, void* out,
                 int out_bf16, cudaStream_t s) {
  if (out_bf16) {
    return launch_mean<T, __nv_bfloat16>(table, n_rows, d, his_ids, lens,
                                         batch, his,
                                         static_cast<__nv_bfloat16*>(out), s);
  }
  return launch_mean<T, float>(table, n_rows, d, his_ids, lens, batch, his,
                               static_cast<float*>(out), s);
}

}  // namespace

extern "C" int heat_gather_rows_f32(const float* table, int64_t n_rows, int d,
                                    const int32_t* ids, int64_t m, float* out,
                                    int device, void* stream) {
  heat::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  return launch_gather<float>(table, n_rows, d, ids, m, out,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int heat_gather_rows_bf16(const void* table, int64_t n_rows, int d,
                                     const int32_t* ids, int64_t m, void* out,
                                     int device, void* stream) {
  heat::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  // A copy of bits: bf16 elements move as 16-bit integers.
  return launch_gather<uint16_t>(static_cast<const uint16_t*>(table), n_rows,
                                 d, ids, m, static_cast<uint16_t*>(out),
                                 static_cast<cudaStream_t>(stream));
}

// out[k * r : (k + 1) * r] = table[ids[k] * r : (ids[k] + 1) * r]: the table
// as n_blocks blocks of block_elems = r * d contiguous elements.
extern "C" int heat_gather_blocks_f32(const float* table, int64_t n_blocks,
                                      int64_t block_elems, const int32_t* ids,
                                      int64_t m, float* out, int device,
                                      void* stream) {
  heat::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  return launch_gather<float>(table, n_blocks, block_elems, ids, m, out,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int heat_gather_blocks_bf16(const void* table, int64_t n_blocks,
                                       int64_t block_elems, const int32_t* ids,
                                       int64_t m, void* out, int device,
                                       void* stream) {
  heat::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  return launch_gather<uint16_t>(static_cast<const uint16_t*>(table), n_blocks,
                                 block_elems, ids, m,
                                 static_cast<uint16_t*>(out),
                                 static_cast<cudaStream_t>(stream));
}

// out is f32, or bf16 when out_bf16 != 0; the rows are cast to that type
// before the f32 sum.
extern "C" int heat_history_mean_f32(const float* table, int64_t n_rows, int d,
                                     const int32_t* his_ids,
                                     const int32_t* lens, int64_t batch,
                                     int his, void* out, int out_bf16,
                                     int device, void* stream) {
  heat::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  return history_mean<float>(table, n_rows, d, his_ids, lens, batch, his, out,
                             out_bf16, static_cast<cudaStream_t>(stream));
}

extern "C" int heat_history_mean_bf16(const void* table, int64_t n_rows, int d,
                                      const int32_t* his_ids,
                                      const int32_t* lens, int64_t batch,
                                      int his, void* out, int out_bf16,
                                      int device, void* stream) {
  heat::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  return history_mean<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(table), n_rows, d, his_ids, lens,
      batch, his, out, out_bf16, static_cast<cudaStream_t>(stream));
}
