// Block gather (S2) for Hopper (sm_90a), for f32 and bf16 tables.
//
// Replaces the Pallas kernel
//   * heat_gather_blocks_{f32,bf16}  <- scripts/profile_exact_ceiling.py:125
//                                       gather_blocks (_multi_row_kernel)
// out[k * r : (k + 1) * r] = table[ids[k] * r : (ids[k] + 1) * r]: the table
// as n_blocks blocks of block_elems = r * d contiguous elements, each id
// one block. The Pallas kernel is f32 only; the copy moves bits, so one
// kernel serves both types.
//
// What bounds it on the H100: bytes. Nothing is computed; the ids are read
// once, each distinct block once and every output block written once (at
// the measuring script's shapes, 65,536 rows of width 128 from a
// 91,600-row table, about 57.8 MB in f32 at every r: 3.35 TB/s gives
// 0.0172 ms). A block is 512 B to 8 KB there (r = 1 to 16, f32; half that
// in bf16), so the copy is a stream of contiguous transfers of a few KB
// each, and the card needs about 25 KB in flight an SM to keep device
// memory busy.
//
// What the design does about it. The TPU kernel stages 1,024 ids in SMEM
// and keeps a window of 256 r-row DMAs in flight. Hopper's counterpart of
// a DMA is the bulk-copy engine (cp.async.bulk), and that is the main
// path (blocks_bulk_kernel):
//   * A persistent grid: one CTA an SM (the SM count is read at the first
//     launch outside a capture and kept), kWarps = 8 warps a CTA, and each
//     warp an independent pipeline over a contiguous share of the blocks,
//     so that a CTA's output is one contiguous range.
//   * A warp's ids are staged in shared memory kIdChunk at a time; the next
//     chunk is fetched into registers (kIdsPerLane a lane) while the warp
//     works through the one in shared memory.
//   * Each warp owns a ring of `stages` stages in dynamic shared memory; a
//     stage holds `group` consecutive blocks of the output (a power of two
//     up to 32, so that a stage is about kStageTarget bytes: 8 blocks of
//     512 B, 2 of 2 KB, 1 of 8 KB). Lane i of the warp issues
//     cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes for
//     block i of a stage, after lane 0 has armed the stage's full barrier
//     with mbarrier.arrive.expect_tx for the bytes of its in-range blocks.
//   * Once the barrier's phase has completed, lane 0 writes the stage out
//     as ONE cp.async.bulk.global.shared::cta.bulk_group store (the group's
//     blocks are contiguous in the output), with an L2 policy that evicts
//     the output's lines first (the table's blocks repeat: at the script's
//     shapes half the ids fall on a block read before), and commits it.
//   * A stage is refilled only after cp.async.bulk.wait_group.read says
//     its store has read it; loads run `stages - kStores` stages ahead of
//     the stores, kStores = 1 store may still read its stage. No thread
//     holds a byte of a block in a register.
//   * The ring size: the stages of all warps fill at most kSmemBig of
//     dynamic shared memory (set once with cudaFuncSetAttribute at the
//     first launch outside a capture; a first launch inside a capture takes
//     the default 48 KB, too little for two stages a warp, and then the
//     warp path), at most kMaxStages a warp: 8 warps x 6 stages of 4 KB
//     (205 KB with the ids) at r <= 8 in f32, 8 x 3 of 8 KB at r = 16.
//   * How those were chosen: variants of this file built with other values
//     of the constants below and timed against each other, on an NVIDIA
//     H100 80GB HBM3 at 700 W, `graph_ms` at the script's shapes
//     (f32 r = 1, 4, 16 on one table: 46.9 MB, half of it in L2). 4 warps,
//     1 store, 4 KB, no hint: 22.75 / 22.96 / 22.23 us; 8 warps: 22.51 /
//     22.36 / 22.62; with the hint: 20.43 / 20.74 / 20.73 (the design
//     this replaces, K2's copy loop: about 22.7). 2 or 4 stores in flight,
//     stages of 2 or 8 KB, 12 or 16 warps: no better. Read from device
//     memory (sets of copies turned over) every variant lies within 4% of
//     the warp path (f32 23.9-24.7 us against 23.4-24.2).
//   * An id outside [0, n_blocks) is not read: the warp writes zeros into
//     its part of the stage (then fence.proxy.async, so that the bulk store
//     sees them) and the barrier expects no bytes for it.
// The bulk engine takes only 16-byte aligned addresses and sizes that are
// multiples of 16. Anything else (a block of r * d * size bytes that is not
// a multiple of 16, or a table or output that does not start on 16 bytes)
// takes the second path, blocks_warp_kernel, checked before the launch, and
// so does a block too large for two stages a warp (above 14,008 bytes with
// the attribute set, plan_bulk):
// one warp a turn over up to 32 blocks (as many as keep kLoadsInFlight
// loads a lane busy), lane i loading the id of block i and the lanes
// reading them by __shfl_sync; each lane starts kLoadsInFlight = 4
// independent ld.global.nc loads of the widest vector (16, 8, 4 or 2
// bytes) that the addresses and the block size allow before its first
// streaming store (__stcs); 2 or 8 loads measured slower in f32 and from
// device memory (2 up to 5% faster on the bf16 table in L2). The warp path
// is not chosen for small blocks: where it beats the bulk path (by 16-30%
// on the 23.4 MB bf16 table, r = 1 to 16) the table sits in L2, which the
// kernel cannot see; at r = 1 in f32 and read from device memory the two
// paths lie within 4% either way (the variants' measurements, as above).
//
// Contract: f32 or bf16 tables, int32 ids, contiguous row-major arrays. An
// id outside [0, n_blocks) gives a block of zeros. m == 0 launches nothing;
// offsets are 64-bit. Each entry point makes `device` current
// (launch.cuh), launches on the given stream, does not synchronise,
// allocates nothing, may be captured in a CUDA graph and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "launch.cuh"

namespace {

// The tunables, each chosen by the measurements in the header comment.
constexpr int kWarps = 8;           // warps (pipelines) of a CTA
constexpr int kStores = 1;          // a warp's stores in flight
constexpr int kStageTarget = 4096;  // bytes of a stage, about
constexpr int kMaxStages = 8;  // of a warp's ring
constexpr int kIdsPerLane = 8;
constexpr int kIdChunk = 32 * kIdsPerLane;  // ids a warp stages at a time
constexpr int kSmemDefault = 48 * 1024;     // without the attribute
constexpr int kSmemBig = 227 * 1024;        // the most a CTA can have
constexpr int kWarpThreads = 256;           // warp path: threads a CTA
constexpr int kLoadsInFlight = 4;           // warp path: a lane's loads in
                                            // flight
constexpr unsigned kAll = 0xffffffffu;

bool aligned_to(const void* p, size_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// ---- the bulk path ------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Orders this thread's generic-proxy accesses to shared memory before the
// async proxy's (the bulk copies).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// An L2 policy that evicts the output's lines first, so that the table's
// blocks, which repeat, stay in L2 (what __stcs does on the warp path).
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint "
      "[%0], [%1], %2, %3;\n" ::"l"(dst),
      "r"(src), "r"(bytes), "l"(policy)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed stores still read
// shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fetch_ids(const int32_t* __restrict__ ids,
                                          int64_t first, int64_t end,
                                          int lane,
                                          int32_t (&v)[kIdsPerLane]) {
#pragma unroll
  for (int i = 0; i < kIdsPerLane; ++i) {
    const int64_t j = first + i * 32 + lane;
    v[i] = j < end ? __ldg(ids + j) : -1;
  }
}

// Shared memory of a CTA: the warps' rings (kWarps x stages x stage
// bytes), then their full barriers (kWarps x stages), then their staged
// ids (kWarps x kIdChunk).
__global__ void __launch_bounds__(kWarps * 32, 1)
    blocks_bulk_kernel(const char* __restrict__ table,
                       const int32_t* __restrict__ ids, char* __restrict__ out,
                       int64_t n_blocks, int64_t m, uint32_t block_bytes,
                       int group, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t stage_bytes = block_bytes * group;
  unsigned char* ring = smem + (size_t)warp * stages * stage_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
                       smem + (size_t)kWarps * stages * stage_bytes) +
                   warp * stages;
  int32_t* s_ids = reinterpret_cast<int32_t*>(
                       smem + (size_t)kWarps * stages * stage_bytes +
                       (size_t)kWarps * stages * sizeof(uint64_t)) +
                   warp * kIdChunk;

  // This warp's units (groups of `group` consecutive blocks).
  const int64_t units = (m + group - 1) / group;
  const int64_t pipes = (int64_t)gridDim.x * kWarps;
  const int64_t pipe = (int64_t)blockIdx.x * kWarps + warp;
  const int64_t u0 = units * pipe / pipes;
  const int64_t n = units * (pipe + 1) / pipes - u0;
  if (n <= 0) return;
  const int64_t blk_begin = u0 * group;
  const int64_t blk_end = m < (u0 + n) * group ? m : (u0 + n) * group;

  if (lane == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(smem_u32(bars + s), 1);
    mbar_init_fence();
  }
  int32_t next[kIdsPerLane];
  fetch_ids(ids, blk_begin, blk_end, lane, next);
#pragma unroll
  for (int i = 0; i < kIdsPerLane; ++i) s_ids[i * 32 + lane] = next[i];
  int64_t chunk = blk_begin;  // the first block of the ids in s_ids
  fetch_ids(ids, chunk + kIdChunk, blk_end, lane, next);
  __syncwarp();

  // Loads of unit j into stage s: lane i < count takes block i.
  auto issue = [&](int64_t j, int s) {
    const int64_t first = (u0 + j) * group;
    if (first >= chunk + kIdChunk) {  // the next chunk of ids
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kIdsPerLane; ++i) s_ids[i * 32 + lane] = next[i];
      chunk += kIdChunk;
      __syncwarp();
      fetch_ids(ids, chunk + kIdChunk, blk_end, lane, next);
    }
    const int64_t left = blk_end - first;
    const int count = left < group ? static_cast<int>(left) : group;
    const int32_t id = lane < count ? s_ids[first - chunk + lane] : -1;
    const bool ok = lane < count && id >= 0 && id < n_blocks;
    const unsigned in = __ballot_sync(kAll, ok);
    unsigned bad = __ballot_sync(kAll, lane < count && !ok);
    unsigned char* stage = ring + (size_t)s * stage_bytes;
    const uint32_t bar = smem_u32(bars + s);
    if (bad) {  // zeros for the ids outside the table, written by the warp
      while (bad) {
        const int b = __ffs(bad) - 1;
        bad &= bad - 1;
        uint4* z = reinterpret_cast<uint4*>(stage + (size_t)b * block_bytes);
        for (uint32_t c = lane; c < block_bytes / 16; c += 32) {
          z[c] = make_uint4(0, 0, 0, 0);
        }
      }
      fence_proxy_async();
    }
    __syncwarp();
    if (lane == 0) mbar_expect_tx(bar, __popc(in) * block_bytes);
    __syncwarp();
    if (ok) {
      bulk_load(smem_u32(stage + (size_t)lane * block_bytes),
                table + (int64_t)id * block_bytes, block_bytes, bar);
    }
  };

  // Loads run `ahead` units ahead of the stores, and kStores stores may
  // still read their stages when one is refilled.
  const int ahead = stages - kStores;
  const uint64_t policy = evict_first_policy();
  for (int64_t j = 0; j < ahead && j < n; ++j) issue(j, static_cast<int>(j));
  for (int64_t k = 0; k < n; ++k) {
    const int s = static_cast<int>(k % stages);
    if (lane == 0) {
      mbar_wait(smem_u32(bars + s), static_cast<uint32_t>((k / stages) & 1));
      fence_proxy_async();
      const int64_t first = (u0 + k) * group;
      const int64_t left = blk_end - first;
      const int64_t count = left < group ? left : group;
      bulk_store(out + first * block_bytes,
                 smem_u32(ring + (size_t)s * stage_bytes),
                 static_cast<uint32_t>(count * block_bytes), policy);
    }
    const int64_t j = k + ahead;  // into the stage of unit k - kStores
    if (j < n) {
      if (lane == 0 && j >= stages) bulk_wait_read<kStores>();
      __syncwarp();
      issue(j, static_cast<int>(j % stages));
    }
  }
  if (lane == 0) bulk_wait_read<0>();  // the ring outlives its last store
}

struct BulkPlan {
  int group;
  int stages;
  size_t smem;
};

// The ring for blocks of `block_bytes` within `cap` bytes of shared
// memory; false where not even two stages of one block fit.
bool plan_bulk(int64_t block_bytes, int64_t cap, BulkPlan* p) {
  int group = 1;
  while (group < 32 && 2 * group * block_bytes <= kStageTarget) group *= 2;
  const int64_t stage = group * block_bytes;
  const int64_t fixed = (int64_t)kWarps * kIdChunk * sizeof(int32_t);
  int64_t stages = (cap - fixed) / (kWarps * (stage + (int64_t)sizeof(uint64_t)));
  if (stages > kMaxStages) stages = kMaxStages;
  if (stages < kStores + 1) return false;
  p->group = group;
  p->stages = static_cast<int>(stages);
  p->smem = static_cast<size_t>(
      kWarps * stages * (stage + (int64_t)sizeof(uint64_t)) + fixed);
  return true;
}

// ---- the warp path ------------------------------------------------------

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ uint4 zero<uint4>() {
  return make_uint4(0, 0, 0, 0);
}
template <>
__device__ __forceinline__ uint2 zero<uint2>() {
  return make_uint2(0, 0);
}
template <>
__device__ __forceinline__ unsigned int zero<unsigned int>() {
  return 0u;
}
template <>
__device__ __forceinline__ unsigned short zero<unsigned short>() {
  return 0;
}

// A turn of a warp copies `per` consecutive blocks of `bv` vectors V
// (per * bv <= 32 * kLoadsInFlight when per > 1): lane i holds the id of
// block i of the turn.
template <typename V>
__global__ void __launch_bounds__(kWarpThreads)
    blocks_warp_kernel(const V* __restrict__ table,
                       const int32_t* __restrict__ ids, V* __restrict__ out,
                       int64_t n_blocks, int64_t m, int64_t bv, int per) {
  constexpr int U = kLoadsInFlight;
  const int lane = threadIdx.x & 31;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t k0 = (((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5) *
                    per;
       k0 < m; k0 += warps * per) {
    const int64_t left = m - k0;
    const int count = left < per ? static_cast<int>(left) : per;
    int32_t my_id = lane < count ? __ldg(ids + k0 + lane) : -1;
    const int64_t total = count * bv;
    V* dst = out + k0 * bv;
    for (int64_t e0 = 0; e0 < total; e0 += 32 * U) {
      V v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t e = e0 + u * 32 + lane;
        int b = 0;
        int64_t c = e;
        if (per > 1) {  // total is at most 32 * U here: 32-bit division
          b = static_cast<int>(static_cast<uint32_t>(e) /
                               static_cast<uint32_t>(bv));
          if (b > 31) b = 31;
          c = e - (int64_t)b * bv;
        }
        const int32_t id = __shfl_sync(kAll, my_id, b);
        v[u] = zero<V>();
        if (e < total && id >= 0 && id < n_blocks) {
          v[u] = __ldg(table + (int64_t)id * bv + c);  // ld.global.nc
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t e = e0 + u * 32 + lane;
        if (e < total) __stcs(dst + e, v[u]);
      }
    }
  }
}

template <typename V>
void launch_warp(const void* table, const int32_t* ids, void* out,
                 int64_t n_blocks, int64_t m, int64_t block_bytes, int sms,
                 cudaStream_t s) {
  const int64_t bv = block_bytes / (int64_t)sizeof(V);
  int64_t per = 32 * kLoadsInFlight / bv;
  if (per < 1) per = 1;
  if (per > 32) per = 32;
  const int64_t turns = (m + per - 1) / per;
  const int64_t warps_per_cta = kWarpThreads / 32;
  int64_t grid = (turns + warps_per_cta - 1) / warps_per_cta;
  const int64_t cap = (int64_t)sms * (2048 / kWarpThreads);
  if (grid > cap) grid = cap;
  blocks_warp_kernel<V><<<static_cast<int>(grid), kWarpThreads, 0, s>>>(
      static_cast<const V*>(table), ids, static_cast<V*>(out), n_blocks, m,
      bv, static_cast<int>(per));
}

// ---- the launch ---------------------------------------------------------

constexpr int kMaxDevices = 64;
constexpr int kFallbackSms = 132;  // an H100 SXM, before the count is read

// Per device: its SM count once read (0 before), and whether the bulk
// kernel's shared-memory attribute is set.
std::atomic<int> g_sms[kMaxDevices];
std::atomic<int> g_big[kMaxDevices];

int launch_blocks(const void* table, int64_t n_blocks, int64_t block_bytes,
                  const int32_t* ids, int64_t m, void* out, int device,
                  cudaStream_t s) {
  if (m == 0 || block_bytes == 0) return 0;
  cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
  if (cudaStreamIsCapturing(s, &capture) != cudaSuccess) {
    cudaGetLastError();
    capture = cudaStreamCaptureStatusActive;  // assume the worst
  }
  const bool eager = capture == cudaStreamCaptureStatusNone;
  const bool cached = device >= 0 && device < kMaxDevices;
  int sms = cached ? g_sms[device].load() : 0;
  bool big = cached && g_big[device].load() != 0;
  if (eager && (sms == 0 || !big)) {  // once a device, never in a capture
    cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(blocks_bulk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBig);
    if (err != cudaSuccess) return static_cast<int>(err);
    big = true;
    if (cached) {
      g_sms[device].store(sms);
      g_big[device].store(1);
    }
  }
  if (sms <= 0) sms = kFallbackSms;

  const bool bulk_takes = block_bytes % 16 == 0 && aligned_to(table, 16) &&
                          aligned_to(out, 16) &&
                          block_bytes <= 0xffffffffLL / 32;
  BulkPlan plan;
  if (bulk_takes &&
      plan_bulk(block_bytes, big ? kSmemBig : kSmemDefault, &plan)) {
    const int64_t units = (m + plan.group - 1) / plan.group;
    int64_t grid = (units + kWarps - 1) / kWarps;
    if (grid > sms) grid = sms;
    blocks_bulk_kernel<<<static_cast<int>(grid), kWarps * 32, plan.smem, s>>>(
        static_cast<const char*>(table), ids, static_cast<char*>(out),
        n_blocks, m, static_cast<uint32_t>(block_bytes), plan.group,
        plan.stages);
  } else {
    const uintptr_t bits = reinterpret_cast<uintptr_t>(table) |
                           reinterpret_cast<uintptr_t>(out) |
                           static_cast<uintptr_t>(block_bytes);
    if (bits % 16 == 0) {
      launch_warp<uint4>(table, ids, out, n_blocks, m, block_bytes, sms, s);
    } else if (bits % 8 == 0) {
      launch_warp<uint2>(table, ids, out, n_blocks, m, block_bytes, sms, s);
    } else if (bits % 4 == 0) {
      launch_warp<unsigned int>(table, ids, out, n_blocks, m, block_bytes,
                                sms, s);
    } else {
      launch_warp<unsigned short>(table, ids, out, n_blocks, m, block_bytes,
                                  sms, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out[k * r : (k + 1) * r] = table[ids[k] * r : (ids[k] + 1) * r]: the table
// as n_blocks blocks of block_elems = r * d contiguous elements.
extern "C" int heat_gather_blocks_f32(const float* table, int64_t n_blocks,
                                      int64_t block_elems, const int32_t* ids,
                                      int64_t m, float* out, int device,
                                      void* stream) {
  heat::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  return launch_blocks(table, n_blocks, block_elems * 4, ids, m, out, device,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int heat_gather_blocks_bf16(const void* table, int64_t n_blocks,
                                       int64_t block_elems, const int32_t* ids,
                                       int64_t m, void* out, int device,
                                       void* stream) {
  heat::DeviceGuard guard(device);
  if (guard.error()) return guard.error();
  return launch_blocks(table, n_blocks, block_elems * 2, ids, m, out, device,
                       static_cast<cudaStream_t>(stream));
}
