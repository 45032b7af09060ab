// Row scatters for Hopper (sm_90a): the duplicate-safe in-place row
// scatter-add (K3) and the in-place row scatter-set (S1), each for f32 and
// bf16 tables (heat_*_f32, heat_*_bf16), and each with a second entry that
// computes the SGD update's rows inside the kernel (heat_*_update_*).
//
// K3 replaces the Pallas kernel heat_tpu/ops/pallas/scatter.py:89
// scatter_add_rows: table[ids[k]] += deltas[k], in place, with the sentinel
// id == n_rows (weight-0 padding) skipped. The Pallas kernel requires
// unique ids; this one does not: repeated ids (a batch holds repeated users
// and items) combine correctly. On unique ids the result is the Pallas
// contract.
//
// S1 replaces the Pallas kernel scripts/profile_scatter_pallas.py:65
// pallas_scatter_set: table[ids[k]] = rows[k], in place, every id outside
// [0, n_rows) skipped (JAX's mode="drop"). Callers pass unique ids, or
// repeats whose rows are identical; a repeated id with differing rows gets,
// vector by vector, one of its rows.
//
// What bounds them on the H100. Both are bytes: ids and source rows read
// once, each distinct table row written once (and read once by an add). At
// the shapes of the training step that is 1-36 MB, microseconds of device
// time, so what a caller pays is launches: its own, and those of the
// elementwise passes that prepare the source rows. For K3 the second limit
// is the rate at which L2 serialises atomic operations.
//
// What the design does about it:
//   * The update entries fuse the passes that the JAX package leaves to XLA
//     around its scatters (heat_tpu/train/scatter.py:161-167, :380-390,
//     :395-401): clip, l2, the product with lr and the rounding to the
//     table's type happen in registers, between the load of the raw f32 (or
//     bf16) gradient rows and the reduction or store. lr is read through a
//     pointer (it lives on the device), so no host value is needed. One
//     launch replaces three to five, and the (M, d) intermediates are never
//     written.
//   * K3 adds with vector reductions: one red.global.add.v4.f32 per four f32
//     elements, one red.global.add.noftz.v4.bf16x2 per eight bf16 elements
//     (sm_90, PTX 8.1), where d and the pointers allow 16-byte accesses;
//     atomicAdd on __nv_bfloat162 where only pairs fit, on single elements
//     otherwise (odd d, the (N, 1) touched table, unaligned views). `red`
//     rather than `atom`: no thread needs the old value, and a reduction
//     without a return is fire-and-forget: the warp does not wait for L2's
//     answer. A vector reduction is one L2 operation where four scalar ones
//     stood; each element is still atomic on its own, which is all a sum
//     needs.
//   * S1 stores 16 bytes a thread and converts in registers where the
//     source rows have the other type (f32 rows into a bf16 table round to
//     nearest even, as a cast does; bf16 into f32 is exact), so no cast pass
//     runs before it. Rows of the table's own type move as bits. (An
//     evict-first hint on the stores, st.global.cs, was tried for tables far
//     larger than L2 and changed nothing under graph replay at 16M x 64.)
//   * Unit e of the flat (m, d / N) array of N-element vectors is one
//     thread, so the threads of a row are neighbours and a row is one
//     coalesced run. Ids outside [0, n_rows) are skipped before any access.
//     Offsets are 64-bit: id * d passes 2^31 at 16M x 64 and above.
//
// The two update formulas of the add differ in the order of clip and l2, as
// they do in the JAX package, and are kept apart:
//   clip first (per-occurrence `direct` mode; l2 against the forward-pass
//   rows):           inc = -lr * (clamp(g, -c, c) + l2 * float(rows[k]))
//   l2 first (sort-dedup batch mode; l2 against the table's own row, the
//   product taken in the table's type; ids must be unique when l2 != 0,
//   since the row is read while other rows are added to):
//                    inc = -lr * clamp(g + T(l2 * table[id]), -c, c)
// and the set's:     row = base - lr * clamp(g + l2 * base, -c, c).
// All arithmetic is f32 with explicit __fmul_rn / __fadd_rn / __fsub_rn (no
// FMA contraction can move the last bit) and one rounding to the table's
// type (__float2bfloat16_rn), so on unique ids each update entry is
// bit-equal to the PyTorch expressions it replaces.
//
// The order in which K3's reductions land changes from run to run, so sums
// over a repeated id differ from a sequential sum in the last bits (f32:
// within occurrences x 2^-24 of the sum of magnitudes). Every bf16 add
// rounds to bf16, so over a repeated id the result lies within (occurrences
// of the row) x (half a bf16 ulp of the largest partial sum) of the exact
// sum; on unique ids it is the one correctly rounded add. S1 is exact.
//
// Each entry point makes `device` current (launch.cuh), launches on the
// given stream, does not synchronise, allocates nothing, may be captured in
// a CUDA graph, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;

int grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  // Grid-stride loops cover the rest; 132 SMs x 16 blocks keeps the card
  // full without a grid dimension overflow at any size.
  const int64_t cap = 132 * 16;
  return static_cast<int>(blocks < cap ? blocks : cap);
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Elements a thread handles: a 16-byte vector of the table where d and
// every pointer allow it (4 f32, 8 bf16), a bf16 pair where only that fits,
// else one. `a` and `b` are the source arrays (either may be null); their
// elements are f32 or bf16, so 16-byte alignment of their base covers every
// vector load of up to 8 elements' stride.
template <typename T>
int width_for(int d, const void* table, const void* a, const void* b) {
  constexpr int kFull = 16 / sizeof(T);
  if (d % kFull == 0 && aligned(table, 16) && aligned(a, 16) && aligned(b, 16)) {
    return kFull;
  }
  if (sizeof(T) == 2 && d % 2 == 0 && aligned(table, 4) && aligned(a, 8) &&
      aligned(b, 8)) {
    return 2;
  }
  return 1;
}

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
  return __float2bfloat16_rn(x);
}

// N elements of S, loaded and stored as one access of up to 16 bytes (a
// 32-byte pack of 8 floats is two).
template <typename S, int N>
struct alignas(sizeof(S) * N < 16 ? sizeof(S) * N : 16) Pack {
  S v[N];
};

template <typename S, int N>
__device__ __forceinline__ void load_pack(const void* p, int64_t off,
                                          float (&x)[N]) {
  const Pack<S, N> v =
      *reinterpret_cast<const Pack<S, N>*>(static_cast<const S*>(p) + off);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = to_float(v.v[i]);
}

// x = float(p[off : off + N]), the array being bf16 or f32.
template <int N>
__device__ __forceinline__ void load_rows(const void* p, bool bf16,
                                          int64_t off, float (&x)[N]) {
  if (bf16) {
    load_pack<__nv_bfloat16, N>(p, off, x);
  } else {
    load_pack<float, N>(p, off, x);
  }
}

// min(max(x, -c), c) as torch.clamp computes it (a NaN stays a NaN).
__device__ __forceinline__ float clamp(float x, float c) {
  return x < -c ? -c : (x > c ? c : x);
}

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x at the lower address
  return *reinterpret_cast<const uint32_t*>(&v);
}

// p[0 : N] += T(x[0 : N]), every element atomically.
template <typename T, int N>
struct RedAdd {
  static __device__ __forceinline__ void run(T* p, const float (&x)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) atomicAdd(p + i, from_float<T>(x[i]));
  }
};
template <>
struct RedAdd<float, 4> {
  static __device__ __forceinline__ void run(float* p, const float (&x)[4]) {
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
                 :
                 : "l"(__cvta_generic_to_global(p)), "f"(x[0]), "f"(x[1]),
                   "f"(x[2]), "f"(x[3])
                 : "memory");
  }
};
template <>
struct RedAdd<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void run(__nv_bfloat16* p,
                                             const float (&x)[8]) {
    asm volatile("red.global.add.noftz.v4.bf16x2 [%0], {%1, %2, %3, %4};"
                 :
                 : "l"(__cvta_generic_to_global(p)),
                   "r"(bf16x2_bits(x[0], x[1])), "r"(bf16x2_bits(x[2], x[3])),
                   "r"(bf16x2_bits(x[4], x[5])), "r"(bf16x2_bits(x[6], x[7]))
                 : "memory");
  }
};
template <>
struct RedAdd<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void run(__nv_bfloat16* p,
                                             const float (&x)[2]) {
    atomicAdd(reinterpret_cast<__nv_bfloat162*>(p),
              __floats2bfloat162_rn(x[0], x[1]));
  }
};

// p[0 : N] = T(x[0 : N]) as one store.
template <typename T, int N>
__device__ __forceinline__ void store_pack(T* p, const float (&x)[N]) {
  Pack<T, N> o;
#pragma unroll
  for (int i = 0; i < N; ++i) o.v[i] = from_float<T>(x[i]);
  *reinterpret_cast<Pack<T, N>*>(p) = o;
}

// How the add's increment is made from the source rows.
enum AddMode {
  kAsIs = 0,        // inc = src (the plain scatter-add)
  kClipScale = 1,   // inc = -lr * clamp(g)
  kClipThenL2 = 2,  // inc = -lr * (clamp(g) + l2 * rows[k])
  kL2ThenClip = 3,  // inc = -lr * clamp(g + T(l2 * table[id]))
};

struct UpdateArgs {
  const void* src;    // (m, d) deltas or gradient rows
  const void* rows;   // (m, d) forward-pass rows (kClipThenL2) or base (set)
  const float* lr;    // device scalar
  float clip, l2;
  int src_bf16, rows_bf16;
};

// table[ids[k], cN : cN + N] += inc[k, cN : cN + N]; dv = d / N vectors a row.
template <typename T, int N, int MODE>
__global__ void scatter_add_kernel(T* __restrict__ table,
                                   const int32_t* __restrict__ ids,
                                   const UpdateArgs a, int64_t n_rows,
                                   int64_t m, int dv) {
  const int64_t total = m * dv;
  const float neg_lr = MODE == kAsIs ? 0.f : -(*a.lr);
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t k = e / dv;
    const int64_t id = ids[k];
    if (id < 0 || id >= n_rows) continue;
    T* dst = table + (id * dv + (e - k * dv)) * N;
    float x[N];
    load_rows<N>(a.src, a.src_bf16, e * N, x);
    if (MODE == kClipThenL2) {
      float r[N];
      load_rows<N>(a.rows, a.rows_bf16, e * N, r);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        x[i] = __fadd_rn(clamp(x[i], a.clip), __fmul_rn(a.l2, r[i]));
      }
    } else if (MODE == kL2ThenClip) {
      float r[N];
      load_pack<T, N>(dst, 0, r);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float term = to_float(from_float<T>(__fmul_rn(a.l2, r[i])));
        x[i] = clamp(__fadd_rn(x[i], term), a.clip);
      }
    } else if (MODE == kClipScale) {
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = clamp(x[i], a.clip);
    }
    if (MODE != kAsIs) {
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = __fmul_rn(x[i], neg_lr);
    }
    RedAdd<T, N>::run(dst, x);
  }
}

// table[ids[k]] = T(src[k]) (UPDATE false: a conversion in registers), or
// T(base - lr * clamp(g + l2 * base)) with base = rows[k], g = src[k].
template <typename T, int N, bool UPDATE>
__global__ void scatter_set_kernel(T* __restrict__ table,
                                   const int32_t* __restrict__ ids,
                                   const UpdateArgs a, int64_t n_rows,
                                   int64_t m, int dv) {
  const int64_t total = m * dv;
  const float lr = UPDATE ? *a.lr : 0.f;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t k = e / dv;
    const int64_t id = ids[k];
    if (id < 0 || id >= n_rows) continue;
    float x[N];
    load_rows<N>(a.src, a.src_bf16, e * N, x);
    if (UPDATE) {
      float base[N];
      load_rows<N>(a.rows, a.rows_bf16, e * N, base);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float g = x[i];
        if (a.l2 != 0.f) g = __fadd_rn(g, __fmul_rn(a.l2, base[i]));
        x[i] = __fsub_rn(base[i], __fmul_rn(lr, clamp(g, a.clip)));
      }
    }
    store_pack<T, N>(table + (id * dv + (e - k * dv)) * N, x);
  }
}

// table[ids[k], c] = rows[k, c] for rows of the table's own type, in units
// of V (a 16-byte vector or one element): a copy of bits.
template <typename V>
__global__ void scatter_copy_kernel(V* __restrict__ table,
                                    const int32_t* __restrict__ ids,
                                    const V* __restrict__ rows,
                                    int64_t n_rows, int64_t m, int dv) {
  const int64_t total = m * dv;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t k = e / dv;
    const int64_t id = ids[k];
    if (id < 0 || id >= n_rows) continue;
    table[id * dv + (e - k * dv)] = rows[e];
  }
}

template <typename T, int MODE>
int launch_add(T* table, int64_t n_rows, int d, const int32_t* ids,
               const UpdateArgs& a, int64_t m, cudaStream_t s) {
  if (m == 0 || d == 0) return 0;
  const int n = width_for<T>(d, table, a.src, a.rows);
  const int grid = grid_for(m * (d / n));
  if (n == 16 / sizeof(T)) {
    scatter_add_kernel<T, 16 / sizeof(T), MODE>
        <<<grid, kThreads, 0, s>>>(table, ids, a, n_rows, m, d / n);
  } else if (n == 2) {
    scatter_add_kernel<T, 2, MODE>
        <<<grid, kThreads, 0, s>>>(table, ids, a, n_rows, m, d / 2);
  } else {
    scatter_add_kernel<T, 1, MODE>
        <<<grid, kThreads, 0, s>>>(table, ids, a, n_rows, m, d);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int add_rows(void* table, int64_t n_rows, int d, const int32_t* ids,
             const void* deltas, int64_t m, int device, void* stream) {
  heat::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  UpdateArgs a{};
  a.src = deltas;
  a.src_bf16 = sizeof(T) == 2;
  return launch_add<T, kAsIs>(static_cast<T*>(table), n_rows, d, ids, a, m,
                              static_cast<cudaStream_t>(stream));
}

template <typename T>
int add_update(void* table, int64_t n_rows, int d, const int32_t* ids,
               const void* grads, int grads_bf16, const void* rows,
               int rows_bf16, int64_t m, const float* lr, float clip, float l2,
               int clip_first, int device, void* stream) {
  heat::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  T* t = static_cast<T*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  UpdateArgs a{grads, nullptr, lr, clip, l2, grads_bf16, rows_bf16};
  if (l2 == 0.f) return launch_add<T, kClipScale>(t, n_rows, d, ids, a, m, s);
  if (!clip_first) return launch_add<T, kL2ThenClip>(t, n_rows, d, ids, a, m, s);
  if (rows == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  a.rows = rows;
  return launch_add<T, kClipThenL2>(t, n_rows, d, ids, a, m, s);
}

template <typename T, bool UPDATE>
int launch_set(T* table, int64_t n_rows, int d, const int32_t* ids,
               const UpdateArgs& a, int64_t m, cudaStream_t s) {
  if (m == 0 || d == 0) return 0;
  const int n = width_for<T>(d, table, a.src, a.rows);
  const int grid = grid_for(m * (d / n));
  if (n == 16 / sizeof(T)) {
    scatter_set_kernel<T, 16 / sizeof(T), UPDATE><<<grid, kThreads, 0, s>>>(
        table, ids, a, n_rows, m, d / n);
  } else if (n == 2) {
    scatter_set_kernel<T, 2, UPDATE><<<grid, kThreads, 0, s>>>(
        table, ids, a, n_rows, m, d / 2);
  } else {
    scatter_set_kernel<T, 1, UPDATE><<<grid, kThreads, 0, s>>>(
        table, ids, a, n_rows, m, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// U: the table's element as bits (float, or uint16_t for bf16).
template <typename U>
int launch_copy(U* table, int64_t n_rows, int d, const int32_t* ids,
                const U* rows, int64_t m, cudaStream_t s) {
  constexpr int kPer = 16 / sizeof(U);
  if (m == 0 || d == 0) return 0;
  if (d % kPer == 0 && aligned(table, 16) && aligned(rows, 16)) {
    const int dv = d / kPer;
    scatter_copy_kernel<float4><<<grid_for(m * dv), kThreads, 0, s>>>(
        reinterpret_cast<float4*>(table), ids,
        reinterpret_cast<const float4*>(rows), n_rows, m, dv);
  } else {
    scatter_copy_kernel<U><<<grid_for(m * d), kThreads, 0, s>>>(
        table, ids, rows, n_rows, m, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// T: the table's element; U: the same as bits.
template <typename T, typename U>
int set_rows(void* table, int64_t n_rows, int d, const int32_t* ids,
             const void* rows, int rows_bf16, int64_t m, int device,
             void* stream) {
  heat::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((rows_bf16 != 0) == (sizeof(T) == 2)) {
    return launch_copy<U>(static_cast<U*>(table), n_rows, d, ids,
                          static_cast<const U*>(rows), m, s);
  }
  UpdateArgs a{};
  a.src = rows;
  a.src_bf16 = rows_bf16;
  return launch_set<T, false>(static_cast<T*>(table), n_rows, d, ids, a, m,
                              s);
}

template <typename T>
int set_update(void* table, int64_t n_rows, int d, const int32_t* ids,
               const void* base, int base_bf16, const float* summed,
               int64_t m, const float* lr, float clip, float l2, int device,
               void* stream) {
  heat::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const UpdateArgs a{summed, base, lr, clip, l2, 0, base_bf16};
  return launch_set<T, true>(static_cast<T*>(table), n_rows, d, ids, a, m,
                             static_cast<cudaStream_t>(stream));
}

}  // namespace

#define HEAT_SCATTER_ENTRIES(SUFFIX, T, U)                                     \
  extern "C" int heat_scatter_add_rows_##SUFFIX(                               \
      void* table, int64_t n_rows, int d, const int32_t* ids,                  \
      const void* deltas, int64_t m, int device, void* stream) {               \
    return add_rows<T>(table, n_rows, d, ids, deltas, m, device, stream);      \
  }                                                                            \
  extern "C" int heat_scatter_add_update_##SUFFIX(                             \
      void* table, int64_t n_rows, int d, const int32_t* ids,                  \
      const void* grads, int grads_bf16, const void* rows, int rows_bf16,      \
      int64_t m, const float* lr, float clip, float l2, int clip_first,        \
      int device, void* stream) {                                              \
    return add_update<T>(table, n_rows, d, ids, grads, grads_bf16, rows,       \
                         rows_bf16, m, lr, clip, l2, clip_first, device,       \
                         stream);                                              \
  }                                                                            \
  extern "C" int heat_scatter_set_rows_##SUFFIX(                               \
      void* table, int64_t n_rows, int d, const int32_t* ids,                  \
      const void* rows, int rows_bf16, int64_t m, int device, void* stream) {  \
    return set_rows<T, U>(table, n_rows, d, ids, rows, rows_bf16, m, device,   \
                          stream);                                             \
  }                                                                            \
  extern "C" int heat_scatter_set_update_##SUFFIX(                             \
      void* table, int64_t n_rows, int d, const int32_t* ids,                  \
      const void* base, int base_bf16, const float* summed, int64_t m,         \
      const float* lr, float clip, float l2, int device, void* stream) {       \
    return set_update<T>(table, n_rows, d, ids, base, base_bf16, summed, m,    \
                         lr, clip, l2, device, stream);                        \
  }

HEAT_SCATTER_ENTRIES(f32, float, float)
HEAT_SCATTER_ENTRIES(bf16, __nv_bfloat16, uint16_t)
