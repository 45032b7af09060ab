// Row gather (K2, with its multi-table entry), fused history-mean gather
// (K1) and block gather (S2) for Hopper (sm_90a), each for f32 and bf16
// tables.
//
// Replaces the Pallas kernels
//   * heat_gather_rows_{f32,bf16},   <- heat_tpu/ops/pallas/gather.py:80
//     heat_gather_rows_multi            gather_rows
//   * heat_history_mean_{f32,bf16}   <- heat_tpu/ops/pallas/gather.py:141
//                                       history_mean_gather
//   * heat_gather_blocks_{f32,bf16}  <- scripts/profile_exact_ceiling.py:125
//                                       gather_blocks (_multi_row_kernel)
// The Pallas kernels take f32 only (XLA ran the bf16 tables); here the
// kernels are the path, so each has a bf16 instance.
//
// What bounds them on the H100. None does arithmetic worth counting (K1
// does one add per element read); each is a stream of random row reads of
// 128 or 256 bytes.
//   * K1 by the latency of those reads, unless enough of them are in
//     flight: then by bytes, from the 50 MB L2 when the table fits it (the
//     91,599 x 64 table is 11.7 MB in bf16 and 23.4 MB in f32, and each row
//     is read about 50 times a launch), from device memory when it does not
//     (the 6,000,000 x 64 table). With one dependent row read a thread in
//     flight and 32,768 threads, a (4,096, 100) chunk took longer than a
//     batch of twice the samples and twice the bytes: latency, not bytes.
//   * K2 by bytes at the step's larger shapes (131,072 rows: 0.76 of the
//     memory rate) and by the launch itself at the smaller ones (512 rows
//     are 64 KB): the step pays for the number of launches, not for the
//     body.
//
// What the design does about it:
//   * A row is read by neighbouring threads as 16-byte loads (4 f32 or
//     8 bf16), so one f32 row of width 64 is one 256-byte coalesced access
//     by 16 threads, and one bf16 row of width 64 a 128-byte access by 8.
//   * K1, loads in flight: a sample is owned by a team of G x S lanes of one
//     warp, G lanes across the row's vectors and S history slots side by
//     side (lane group s takes slots s, s + S, s + 2S, ...). A lane first
//     reads the ids of U = 4 of its slots, then starts their 4 row loads,
//     then adds: 4 S rows of a sample are in flight, and 64 registers a
//     thread leave room for 1,024 threads an SM (8 loads a lane needed
//     96-126 registers, halved the threads and measured slower at every
//     shape). The S partial sums meet in a butterfly of __shfl_xor_sync.
//     bf16 rows cost arithmetic, not bytes, once the loads overlap: an
//     element is widened by one operation and added by one; only f32
//     rows pooled in bf16 are rounded on the way.
//   * K1, the split (pick_split): S = 1 when the B samples x G lanes alone
//     fill the card's 132 x 2,048 = 270,336 threads (the whole table of
//     pools, a step over the large tables); else the smallest of 2 and 4
//     that does, at most 32 / G (4 in bf16 and 2 in f32 at d = 64) and at
//     most 4: a (4,096, 100) chunk or a serving request is short of
//     threads, not of work a thread.
//   * K1, the order of the sum is fixed: lane group s adds its slots in
//     history order into one f32 accumulator, and the butterfly adds the S
//     accumulators pairwise (f32 addition commutes, so every lane holds the
//     same bits). It depends on min(len, H) and S only, never on b, the
//     grid or the unroll: with one S a user's mean has the same bits
//     wherever it
//     stands in whatever batch. Two values of S agree to the rounding of an
//     f32 sum: at most H * 2^-24 * sum|x| / len apart before the final
//     rounding.
//   * K1 keeps the running sum in f32 registers, whatever the table's
//     type, and never writes the (B, H, d) gather to device memory; only
//     the (B, d) means leave the kernel, rounded once to the output type.
//     It reads only the valid prefix h < len[b] of each history. Masked
//     slots are never read (the Pallas kernel and XLA read all H slots).
//   * K1 reads a sample's history through `rows` where given: sample b
//     pools his_ids[rows[b]], so the callers' gathers of the (B, H) ids and
//     (B,) lengths are gone. It writes into the caller's buffer, so the
//     pools of every user are one launch and no copy.
//   * The multi-table entry takes up to 8 (table, ids, out) segments as
//     kernel parameters (a struct by value, no device-side table) and
//     gives each block one segment, found from a prefix of the segments'
//     blocks: no warp diverges on a segment's types. The cast to the output
//     type happens in the copy (bf16 to f32 exact; f32 to bf16 round to
//     nearest even), so a step's row reads and their casts are one launch.
//   * S2's block of r rows is r * d contiguous elements: it is copied by
//     as many threads as it has 16-byte vectors (a warp covers 512 B), with
//     the copy loop of K2. The TPU kernel's 1,024 ids staged in SMEM and
//     its 256-deep window of r-row DMAs are not carried over: the many
//     blocks in flight keep the loads outstanding.
//   * Ids are loaded by the threads that use them; there is no scalar
//     prefetch (that was the TPU's constraint).
//   * Any width d: the 16-byte path when a row is a whole number of
//     vectors and the pointers are aligned, an element-wise path
//     otherwise. No d % 128 restriction. Offsets are 64-bit.
//
// Contract (checked by the Python wrappers in heat_tpu_torch/ops/cuda):
// f32 or bf16 tables, int32 ids, contiguous row-major arrays, ids in
// [0, n_rows). An id outside that range is not read: K2 and S2 write zeros
// for it and K1 leaves it out of the sum; a `rows` entry outside the
// history table pools to zero. Each entry point makes `device` current
// (launch.cuh), launches on the given stream, does not synchronise,
// allocates nothing, may be captured in a CUDA graph and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// x in the type O: nothing for T = O (bf16 rows copied as 16-bit words
// included), exact from bf16 to f32, round to nearest even from f32 to bf16.
template <typename O, typename T>
__device__ __forceinline__ O cast(T x) {
  if constexpr (std::is_same<T, O>::value) {
    return x;
  } else {
    return from_float<O>(to_float(x));
  }
}

int grid_for(int64_t work) {
  int64_t blocks = (work + kThreads - 1) / kThreads;
  // Grid-stride loops cover the rest; 132 SMs x 16 blocks keeps the card
  // full without a grid dimension overflow at any size.
  const int64_t cap = 132 * 16;
  return static_cast<int>(blocks < cap ? blocks : cap);
}

bool aligned_to(const void* p, size_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
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
  if (width % kPer == 0 && aligned_to(table, 16) && aligned_to(out, 16)) {
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

// A segment of the multi-table gather: m rows of d elements from a table of
// n_rows rows, cast to the output's type.
struct Segment {
  const void* table;
  const int32_t* ids;
  void* out;
  int64_t n_rows;
  int64_t m;
  int d;
  int table_bf16;
  int out_bf16;
  int vec;  // elements a thread moves: 8 or 4 on the aligned path, else 1
};

constexpr int kMaxSegments = 8;

struct MultiArgs {
  Segment seg[kMaxSegments];
  // Blocks [first_block[i], first_block[i + 1]) work on segment i.
  int first_block[kMaxSegments + 1];
  int n;
};

// out[j, :] = O(table[ids[j], :]) for one segment, N elements a thread, by
// the `blocks` blocks of the grid that own it (`block` counts from the
// segment's first).
template <typename T, typename O, int N>
__device__ __forceinline__ void copy_segment(const Segment& sg, int block,
                                             int blocks) {
  const Vec<T, N>* table = static_cast<const Vec<T, N>*>(sg.table);
  Vec<O, N>* out = static_cast<Vec<O, N>*>(sg.out);
  const int64_t dv = sg.d / N;
  const int64_t total = sg.m * dv;
  for (int64_t e = block * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)blocks * blockDim.x) {
    const int64_t j = e / dv;
    const int64_t c = e - j * dv;
    const int64_t id = sg.ids[j];
    Vec<O, N> o;
    if (id >= 0 && id < sg.n_rows) {
      const Vec<T, N> v = table[id * dv + c];
#pragma unroll
      for (int i = 0; i < N; ++i) o.v[i] = cast<O>(v.v[i]);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) o.v[i] = static_cast<O>(0.0f);
    }
    out[e] = o;
  }
}

template <typename T, typename O, int N>
__device__ __forceinline__ void copy_segment_n(const Segment& sg, int block,
                                               int blocks) {
  if (sg.vec == N) {
    copy_segment<T, O, N>(sg, block, blocks);
  } else {
    copy_segment<T, O, 1>(sg, block, blocks);
  }
}

__global__ void gather_rows_multi_kernel(const __grid_constant__ MultiArgs a) {
  int i = 0;
  while (i + 1 < a.n && (int)blockIdx.x >= a.first_block[i + 1]) ++i;
  const Segment& sg = a.seg[i];
  const int block = blockIdx.x - a.first_block[i];
  const int blocks = a.first_block[i + 1] - a.first_block[i];
  // Uniform over the block: its threads take one branch together.
  if (sg.table_bf16) {
    if (sg.out_bf16) {  // a copy of bits
      copy_segment_n<uint16_t, uint16_t, 8>(sg, block, blocks);
    } else {
      copy_segment_n<__nv_bfloat16, float, 4>(sg, block, blocks);
    }
  } else {
    if (sg.out_bf16) {
      copy_segment_n<float, __nv_bfloat16, 4>(sg, block, blocks);
    } else {
      copy_segment_n<float, float, 4>(sg, block, blocks);
    }
  }
}

// out[b] = sum_{h < min(len[r], H)} table[his_ids[r, h]] / max(len[r], 1),
// r = rows[b] (b itself without `rows`; a row outside [0, n_users) gives 0).
// A team of G x S lanes of one warp owns a sample: lane (s, t) owns vectors
// t, t + G, ... of N elements each and the history slots s, s + S, ... .
// G is a power of two <= 32 and G * S <= 32, so a team never straddles a
// warp; with S > 1 a row has at most G vectors. Each element is cast to the
// output type O first (exact from bf16 to f32; the rounding of the rows to
// the compute type from f32 to bf16: cast<O> does only that one rounding,
// the other three pairs of types need none). A lane adds its slots
// in history order in f32, kLoadsInFlight row loads started before the first
// add; a slot that is masked or out of range is neither loaded nor added
// (adding its zeros would change no bit: a sum that starts at +0 never
// becomes -0). The S partial sums are added by a butterfly, and the sum is
// divided and rounded once at the end: the single terminal rounding of
// models/aggregator.py history_mean_fused.
// Row loads a lane starts before its first add. 4 with 1,024 threads an SM
// (64 registers a thread) measured ahead of 8 with 512 at every shape: the
// loads in flight an SM are the same, and more samples are.
constexpr int kLoadsInFlight = 4;

template <typename T, typename O, int N, int S>
__global__ void __launch_bounds__(kThreads, 4)
history_mean_kernel(const Vec<T, N>* __restrict__ table,
                    const int32_t* __restrict__ his_ids,
                    const int32_t* __restrict__ lens,
                    const int32_t* __restrict__ rows,
                    Vec<O, N>* __restrict__ out, int64_t n_rows,
                    int64_t n_users, int64_t batch, int his, int dv,
                    int group) {
  const int team = group * S;
  const int64_t teams_per_block = blockDim.x / team;
  const int in_team = threadIdx.x % team;
  const int t = in_team % group;
  const int s = in_team / group;
  // The loop's bound is the same for every lane of a warp (its first
  // team's sample), so that the shuffles below are met by all 32.
  const int warp_first = (threadIdx.x / 32) * (32 / team);
  // Ids are int32: one unsigned compare tells 0 <= id < n_rows.
  const uint32_t id_limit =
      n_rows < INT32_MAX ? static_cast<uint32_t>(n_rows) : 0x80000000u;
  for (int64_t b0 = blockIdx.x * teams_per_block + warp_first; b0 < batch;
       b0 += (int64_t)gridDim.x * teams_per_block) {
    const int64_t b = b0 + (threadIdx.x % 32) / team;
    int len = 0;
    int64_t r = -1;
    if (b < batch) {
      r = rows ? static_cast<int64_t>(rows[b]) : b;
      if (r >= 0 && r < n_users) len = lens[r];
    }
    const int n = len < 0 ? 0 : (len < his ? len : his);
    const float denom = static_cast<float>(len > 1 ? len : 1);
    const int32_t* row_ids = his_ids + (n > 0 ? r : 0) * his;
    for (int c0 = 0; c0 < dv; c0 += group) {
      const int c = c0 + t;
      const bool mine = c < dv;
      float acc[N];
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] = 0.f;
      constexpr int U = kLoadsInFlight;
      for (int h0 = s; h0 < n; h0 += S * U) {
        uint32_t id[U];
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int h = h0 + u * S;
          id[u] = h < n ? static_cast<uint32_t>(row_ids[h]) : 0xffffffffu;
          ok[u] = mine && id[u] < id_limit;
        }
        Vec<T, N> v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (ok[u]) v[u] = table[static_cast<int64_t>(id[u]) * dv + c];
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (ok[u]) {
#pragma unroll
            for (int i = 0; i < N; ++i) {
              acc[i] += to_float(cast<O>(v[u].v[i]));
            }
          }
        }
      }
      if constexpr (S > 1) {
#pragma unroll
        for (int step = S / 2; step >= 1; step /= 2) {
#pragma unroll
          for (int i = 0; i < N; ++i) {
            acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], step * group);
          }
        }
      }
      if (mine && s == 0 && b < batch) {
        Vec<O, N> o;
#pragma unroll
        for (int i = 0; i < N; ++i) o.v[i] = from_float<O>(acc[i] / denom);
        out[b * dv + c] = o;
      }
    }
  }
}

int group_for(int dv) {
  int g = 1;
  while (g < dv && g < 32) g <<= 1;
  return g;
}

// Threads the card holds at once: 132 SMs x 2,048.
constexpr int64_t kCardThreads = 132 * 2048;

// Over how many lanes a history is split (the source note): 1 when the
// samples alone fill the card, else the smallest of 2 and 4 that does, at
// most 32 / group. `asked` (1, 2 or 4) overrides the rule up to that limit.
int pick_split(int64_t batch, int group, int asked) {
  int most = 32 / group;
  if (most > 4) most = 4;
  if (asked > 0) return asked < most ? asked : most;
  int split = 1;
  while (split < most && batch * group * split < kCardThreads) split <<= 1;
  return split;
}

struct MeanArgs {
  int64_t n_rows;
  int d;
  const int32_t* his_ids;
  const int32_t* lens;
  const int32_t* rows;
  int64_t n_users;
  int64_t batch;
  int his;
  int split;
  cudaStream_t stream;
};

template <typename T, typename O, int N, int S>
void launch_mean_s(const T* table, O* out, const MeanArgs& a, int dv,
                   int group) {
  const int64_t per_block = kThreads / (group * S);
  const int blocks =
      grid_for(((a.batch + per_block - 1) / per_block) * kThreads);
  history_mean_kernel<T, O, N, S><<<blocks, kThreads, 0, a.stream>>>(
      reinterpret_cast<const Vec<T, N>*>(table), a.his_ids, a.lens, a.rows,
      reinterpret_cast<Vec<O, N>*>(out), a.n_rows, a.n_users, a.batch, a.his,
      dv, group);
}

template <typename T, typename O, int N>
void launch_mean_n(const T* table, O* out, const MeanArgs& a) {
  const int dv = a.d / N;
  const int group = group_for(dv);
  switch (pick_split(a.batch, group, a.split)) {
    case 4:
      launch_mean_s<T, O, N, 4>(table, out, a, dv, group);
      break;
    case 2:
      launch_mean_s<T, O, N, 2>(table, out, a, dv, group);
      break;
    default:
      launch_mean_s<T, O, N, 1>(table, out, a, dv, group);
  }
}

template <typename T, typename O>
int launch_mean(const T* table, O* out, const MeanArgs& a) {
  constexpr int kPer = 16 / sizeof(T);
  if (a.batch == 0 || a.d == 0) return 0;
  if (a.d % kPer == 0 && aligned_to(table, 16) &&
      aligned_to(out, kPer * sizeof(O) < 16 ? kPer * sizeof(O) : 16)) {
    launch_mean_n<T, O, kPer>(table, out, a);
  } else {
    launch_mean_n<T, O, 1>(table, out, a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int history_mean(const T* table, void* out, int out_bf16, const MeanArgs& a) {
  if (out_bf16) {
    return launch_mean<T, __nv_bfloat16>(
        table, static_cast<__nv_bfloat16*>(out), a);
  }
  return launch_mean<T, float>(table, static_cast<float*>(out), a);
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

// One launch for up to 8 row gathers. `segments` is a host array of 8
// int64 fields a segment: table, n_rows, d, table_bf16, ids, m, out,
// out_bf16 (the three pointers as integers). They travel to the kernel as
// its parameters; nothing is copied to the device beforehand.
extern "C" int heat_gather_rows_multi(const int64_t* segments, int n_segments,
                                      int device, void* stream) {
  if (n_segments < 1 || n_segments > kMaxSegments) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  heat::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  MultiArgs a = {};
  a.n = n_segments;
  for (int i = 0; i < n_segments; ++i) {
    const int64_t* f = segments + 8 * i;
    Segment& sg = a.seg[i];
    sg.table = reinterpret_cast<const void*>(static_cast<uintptr_t>(f[0]));
    sg.n_rows = f[1];
    sg.d = static_cast<int>(f[2]);
    sg.table_bf16 = f[3] != 0;
    sg.ids = reinterpret_cast<const int32_t*>(static_cast<uintptr_t>(f[4]));
    sg.m = f[5];
    sg.out = reinterpret_cast<void*>(static_cast<uintptr_t>(f[6]));
    sg.out_bf16 = f[7] != 0;
    const size_t in_size = sg.table_bf16 ? 2 : 4;
    const size_t out_size = sg.out_bf16 ? 2 : 4;
    // 16 bytes of the wider type a thread: 8 elements bf16 to bf16, else 4.
    const int vec = in_size == 2 && out_size == 2 ? 8 : 4;
    const bool whole = sg.d % vec == 0 && aligned_to(sg.table, vec * in_size) &&
                       aligned_to(sg.out, vec * out_size);
    sg.vec = whole ? vec : 1;
    a.first_block[i + 1] =
        a.first_block[i] + grid_for(sg.m * (sg.d / sg.vec));
  }
  const int blocks = a.first_block[n_segments];
  if (blocks == 0) return 0;
  gather_rows_multi_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// out is f32, or bf16 when out_bf16 != 0; the rows are cast to that type
// before the f32 sum. rows: (batch,) indices into the (n_users, his)
// history table, or null for batch == n_users histories in order. split:
// the lanes a history is split over (1, 2, 4), or 0 to pick from the work.
extern "C" int heat_history_mean_f32(const float* table, int64_t n_rows, int d,
                                     const int32_t* his_ids,
                                     const int32_t* lens, const int32_t* rows,
                                     int64_t n_users, int64_t batch, int his,
                                     void* out, int out_bf16, int split,
                                     int device, void* stream) {
  heat::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const MeanArgs a{n_rows,  d,     his_ids, lens,  rows,
                   n_users, batch, his,     split,
                   static_cast<cudaStream_t>(stream)};
  return history_mean<float>(table, out, out_bf16, a);
}

extern "C" int heat_history_mean_bf16(const void* table, int64_t n_rows, int d,
                                      const int32_t* his_ids,
                                      const int32_t* lens, const int32_t* rows,
                                      int64_t n_users, int64_t batch, int his,
                                      void* out, int out_bf16, int split,
                                      int device, void* stream) {
  heat::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  const MeanArgs a{n_rows,  d,     his_ids, lens,  rows,
                   n_users, batch, his,     split,
                   static_cast<cudaStream_t>(stream)};
  return history_mean<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(table),
                                     out, out_bf16, a);
}
