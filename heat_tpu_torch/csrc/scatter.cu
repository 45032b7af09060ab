// Row scatters for Hopper (sm_90a): the duplicate-safe in-place row
// scatter-add (K3) and the in-place row scatter-set (S1), each for f32 and
// bf16 tables (heat_*_f32, heat_*_bf16; the Pallas kernels take f32 only
// and XLA ran the bf16 tables).
//
// K3 replaces the Pallas kernel heat_tpu/ops/pallas/scatter.py:89
// scatter_add_rows: table[ids[k]] += deltas[k], in place, with the sentinel
// id == n_rows (weight-0 padding) skipped. The Pallas kernel requires
// unique ids; this one does not: every element is added with an f32
// atomicAdd, so repeated ids (a batch holds repeated users and items)
// combine correctly. On unique ids the result is the Pallas contract.
//
// S1 replaces the Pallas kernel scripts/profile_scatter_pallas.py:65
// pallas_scatter_set: table[ids[k]] = rows[k], in place, every id outside
// [0, n_rows) skipped (JAX's mode="drop"). It is the write of the
// sort-dedup update path (heat_tpu/train/scatter.py:388-390, 353, 369-370,
// 411) and of the write-backs (train_step.py:405-409, scatter.py:159-160).
// Callers pass unique ids, or repeats whose rows are identical; a repeated
// id with differing rows gets, element by element, one of its rows.
//
// What bounds them on the H100: bytes, and for K3 atomic throughput in L2.
// At the config0 step K3 reads 139,264 delta rows of 256 B (about 36 MB)
// and performs 8.9M f32 atomic adds into a 23 MB accumulator that fits the
// 50 MB L2 cache. At the huge-table step S1 writes 32,768 rows of 256 B
// (8 MB) at random places in a 4.1 GB table: every row is a fresh
// 256-byte line set in device memory, so its cost is rows, not bandwidth.
//
// What the design does about it:
//   * Element e of the flat (m, d) source array is one thread, so the d
//     threads of a row read the source row and write the table row as one
//     coalesced run of neighbouring addresses. S1 moves float4s when
//     d % 4 == 0 and the pointers are 16-byte aligned (a 64-wide row is one
//     256-byte access by 16 threads), floats otherwise.
//   * The TPU design of S1 (a 256-deep window of row DMAs issued from ids
//     staged in SMEM, 1024-id tiles) is not carried over: on Hopper the
//     many blocks in flight keep the row writes outstanding.
//   * K3's atomics resolve in L2; the accumulator rows that a batch
//     touches stay resident there between the adds.
//   * Ids outside [0, n_rows) are skipped before any access, so padding
//     never touches a real row.
//   * Offsets are 64-bit: id * d reaches 1.07e9 at 16M x 64 and passes
//     2^31 at larger tables.
//
// The order in which K3's atomics land changes from run to run, so sums
// over a repeated id differ from a sequential sum in the last bits (the
// tests allow rtol 1e-5 for that reason). S1 moves bits and is exact.
//
// bf16: K3 adds bf16 deltas into a bf16 table with the native
// atomicAdd(__nv_bfloat162) of sm_90 where d is even (two elements an
// atomic; each element is atomic on its own, which is all a sum needs),
// and with atomicAdd(__nv_bfloat16) otherwise. Every add rounds to bf16,
// so over a repeated id the result depends on the order: it lies within
// (occurrences of the row) x (one bf16 ulp of the largest partial sum) of
// the exact sum. On unique ids it is the one correctly rounded add. S1
// copies bf16 rows as 16-byte vectors of 8 where d % 8 == 0.
//
// Each entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// table[ids[k], c] += deltas[k, c], in units of A: float, __nv_bfloat16 or
// __nv_bfloat162 (d is then the count of pairs in a row).
template <typename A>
__global__ void scatter_add_rows_kernel(A* __restrict__ table,
                                        const int32_t* __restrict__ ids,
                                        const A* __restrict__ deltas,
                                        int64_t n_rows, int64_t m, int d) {
  const int64_t total = m * d;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t k = e / d;
    const int64_t id = ids[k];
    if (id < 0 || id >= n_rows) continue;
    const int c = static_cast<int>(e - k * d);
    atomicAdd(table + id * d + c, deltas[e]);
  }
}

// table[ids[k], c] = rows[k, c], in units of V (a 16-byte vector or one
// element).
template <typename V>
__global__ void scatter_set_rows_kernel(V* __restrict__ table,
                                        const int32_t* __restrict__ ids,
                                        const V* __restrict__ rows,
                                        int64_t n_rows, int64_t m, int dv) {
  const int64_t total = m * dv;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t k = e / dv;
    const int64_t id = ids[k];
    if (id < 0 || id >= n_rows) continue;
    const int c = static_cast<int>(e - k * dv);
    table[id * dv + c] = rows[e];
  }
}

template <typename T>
int launch_set(T* table, int64_t n_rows, int d, const int32_t* ids,
               const T* rows, int64_t m, cudaStream_t s) {
  constexpr int kPer = 16 / sizeof(T);
  if (m == 0 || d == 0) return 0;
  if (d % kPer == 0 && aligned16(table) && aligned16(rows)) {
    const int dv = d / kPer;
    scatter_set_rows_kernel<float4><<<grid_for(m * dv), kThreads, 0, s>>>(
        reinterpret_cast<float4*>(table), ids,
        reinterpret_cast<const float4*>(rows), n_rows, m, dv);
  } else {
    scatter_set_rows_kernel<T><<<grid_for(m * d), kThreads, 0, s>>>(
        table, ids, rows, n_rows, m, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int heat_scatter_add_rows_f32(float* table, int64_t n_rows, int d,
                                         const int32_t* ids,
                                         const float* deltas, int64_t m,
                                         void* stream) {
  if (m == 0 || d == 0) return 0;
  scatter_add_rows_kernel<float><<<grid_for(m * d), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      table, ids, deltas, n_rows, m, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int heat_scatter_add_rows_bf16(void* table, int64_t n_rows, int d,
                                          const int32_t* ids,
                                          const void* deltas, int64_t m,
                                          void* stream) {
  if (m == 0 || d == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned4 =
      ((reinterpret_cast<uintptr_t>(table) |
        reinterpret_cast<uintptr_t>(deltas)) & 3u) == 0;
  if (d % 2 == 0 && aligned4) {
    const int dp = d / 2;
    scatter_add_rows_kernel<__nv_bfloat162>
        <<<grid_for(m * dp), kThreads, 0, s>>>(
            static_cast<__nv_bfloat162*>(table), ids,
            static_cast<const __nv_bfloat162*>(deltas), n_rows, m, dp);
  } else {
    scatter_add_rows_kernel<__nv_bfloat16>
        <<<grid_for(m * d), kThreads, 0, s>>>(
            static_cast<__nv_bfloat16*>(table), ids,
            static_cast<const __nv_bfloat16*>(deltas), n_rows, m, d);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int heat_scatter_set_rows_f32(float* table, int64_t n_rows, int d,
                                         const int32_t* ids, const float* rows,
                                         int64_t m, void* stream) {
  return launch_set<float>(table, n_rows, d, ids, rows, m,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int heat_scatter_set_rows_bf16(void* table, int64_t n_rows, int d,
                                          const int32_t* ids, const void* rows,
                                          int64_t m, void* stream) {
  // A copy of bits: bf16 elements move as 16-bit integers.
  return launch_set<uint16_t>(static_cast<uint16_t*>(table), n_rows, d, ids,
                              static_cast<const uint16_t*>(rows), m,
                              static_cast<cudaStream_t>(stream));
}
