// Duplicate-safe in-place row scatter-add (K3) for Hopper (sm_90a).
//
// Replaces the Pallas kernel heat_tpu/ops/pallas/scatter.py:89
// scatter_add_rows: table[ids[k]] += deltas[k], in place, with the sentinel
// id == n_rows (weight-0 padding) skipped. The Pallas kernel requires
// unique ids; this one does not: every element is added with an f32
// atomicAdd, so repeated ids (a batch holds repeated users and items)
// combine correctly. On unique ids the result is the Pallas contract.
//
// What bounds it on the H100: bytes and atomic throughput in L2. At the
// config0 step it reads 139,264 delta rows of 256 B (about 36 MB) and
// performs 8.9M f32 atomic adds into a 23 MB accumulator that fits the
// 50 MB L2 cache.
//
// What the design does about it:
//   * Element e of the flat (m, d) delta array is one thread, so the d
//     threads of a row read the delta row and update the table row as one
//     coalesced run of neighbouring addresses.
//   * The atomics resolve in L2; the accumulator rows that a batch
//     touches stay resident there between the adds.
//   * Ids outside [0, n_rows) are skipped before any access, so padding
//     never touches a real row.
//
// The order in which atomics land changes from run to run, so sums over a
// repeated id differ from a sequential sum in the last bits (the tests
// allow rtol 1e-5 for that reason).
//
// The entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void scatter_add_rows_kernel(float* __restrict__ table,
                                        const int32_t* __restrict__ ids,
                                        const float* __restrict__ deltas,
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

}  // namespace

extern "C" int heat_scatter_add_rows_f32(float* table, int64_t n_rows, int d,
                                         const int32_t* ids,
                                         const float* deltas, int64_t m,
                                         void* stream) {
  if (m == 0 || d == 0) return 0;
  const int64_t total = m * d;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 16;
  if (blocks > cap) blocks = cap;
  scatter_add_rows_kernel<<<static_cast<int>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      table, ids, deltas, n_rows, m, d);
  return static_cast<int>(cudaGetLastError());
}
