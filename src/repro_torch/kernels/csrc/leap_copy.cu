// Block and run copies for leap migration on Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/leap_copy.py:
//   copy_blocks_pallas    pool[dst[i]] = pool[src[i]]             (in place)
//   copy_runs_pallas      pool[dst[i]:+run] = pool[src[i]:+run]   (in place)
//   gather_blocks_pallas  out[i] = pool[idx[i]]        (pack a staging buffer)
//   scatter_blocks_pallas pool[idx[i]] = blocks[i]     (unpack it, in place)
// Three of them are one kernel body, move_lanes_kernel: lane i moves
// `lane_bytes` bytes from src_base + s_i * slot_bytes to dst_base + d_i *
// slot_bytes, where s_i is src_idx[i] (or i when src_idx is null) and d_i is
// dst_idx[i] (or i).  copy_blocks and copy_runs pass the pool as both bases;
// scatter reads lane i of the buffer and writes the pool at idx.  The gather
// (gather_blocks_pallas, leap_copy.py:40) has a kernel of its own,
// gather_bulk_kernel, below; move_lanes_kernel serves it only for operands
// that are not 16-byte aligned.
//
// Bound: bytes moved.  Each lane is read once and written once, and there is
// no arithmetic, so the card's memory rate (3.35 TB/s on an H100 SXM) is the
// only limit: for the gather 2 * K * slot_bytes + 8 K bytes (the ids).
//
// move_lanes_kernel: a 2-D grid, lanes on x and chunks of a lane on y, so a
// 64 KiB slot spreads over several CTAs and a tick's lanes fill all SMs.
// Each thread moves 16-byte uint4 words, UNROLL of them loaded before any is
// stored, so several loads are in flight per thread.  When either base or
// the slot size is not 16-byte aligned, the same kernel runs on single bytes.
// The kernel works on bytes, so one kernel serves every dtype.
//
// gather_bulk_kernel: a persistent TMA bulk-copy pipeline.  At one drain
// area (256 lanes of 64 KiB, 0.0100 ms at the bound) move_lanes_kernel is
// one wave of 1,024 short-lived CTAs whose threads each load, wait, then
// store, and it lost to index_select there.  Here one CTA of one warp runs
// on each SM (grid = min(SMs, tiles)).  Each lane is cut into equal tiles of
// at most kMaxTile bytes (four of 16 KiB for a 64 KiB slot, so every tile
// starts on a 16 KiB boundary), and the CTAs take an even split of the
// tiles.  One thread issues everything: cp.async.bulk loads from the pool
// into a ring of kStages shared-memory stages, each completing on its own
// mbarrier, and cp.async.bulk stores from a landed stage to the output, one
// bulk group each.  A stage is reloaded once `cp.async.bulk.wait_group.read`
// shows that its store has read it (kStoresReading stores behind the
// newest), so the loads of later tiles stay in flight while earlier tiles
// drain, and reads and writes overlap from the start.  No thread holds data
// in registers.  The loads carry an L2 evict-first policy: the pool's bytes
// are read once, and L2 keeps the output's lines instead.  The slot ids of
// the next 32 lanes are loaded once, one a thread, and shuffled to the
// issuing thread, so no copy waits on an id load after the first.  Timed
// against this design on the card (scripts/tune_gather.py; PERF.md has the
// numbers): loads without the L2 policy and tiles of 4 KiB are slower; a
// smaller ring or 32 KiB tiles move little.  An even split of the output in
// 16-byte units, which starts most tiles off a 128-byte line, was slower in
// an earlier probe and is not kept.  Resources:
// 196,704 bytes of dynamic shared memory (the ring and its barriers), so one
// CTA an SM; 38 registers and no spill (`-Xptxas -v` under CUDA 12.8;
// kernels/_build.py keeps the log, chip_smoke.py prints it).  The bulk
// copies need 16-byte-aligned addresses and sizes, the test that also
// picks move_lanes_kernel's uint4 words; operands that fail it take
// move_lanes_kernel's byte instance.  That choice is made from the
// operands, never after a failure: a refused shared-memory size or launch
// is returned as an error.
//
// move_shard_lanes_kernel: K1 and K2 over a pool held as one tensor a region
// (a state placed on a region mesh).  The same grid and the same words as
// move_lanes_kernel, but the two bases become a table of shard base
// pointers: lane i reads flat slot f = src[i] at base[f / S] + (f % S) *
// slot_bytes and writes lane_bytes to base[g / S] + (g % S) * slot_bytes for
// g = dst[i], where S is the slots a region (a shard's sink row, its last,
// is never addressed).  One launch moves the one-tensor kernel's bytes
// whatever the regions of the lanes, where a static loop over the regions
// would read or write every region.  The table (at most kMaxShards
// pointers) is a kernel parameter passed by value, so a captured graph node
// holds it and nothing is allocated.  A shard on another card is reached
// through its device pointer, a remote access over NVLink once peer access
// is on (leap_enable_peer_access).  A lane of K2 (lane_bytes = run *
// slot_bytes) never crosses a region: the host checks S % run == 0 and
// run-aligned starts.  Its zero instance writes zeros to the destinations
// and reads nothing (the megastep's zero phase).  Bound: bytes, as
// move_lanes_kernel; the 16-byte words need every base and the slot size
// 16-byte aligned, else the byte instance runs.
//
// Order.  A TPU grid runs in order; CTAs here do not.  copy_blocks and
// copy_runs need no order: the host (leap_copy.check_copy_plan) checks that
// lanes do not overlap and that no destination is a source.  scatter_blocks
// keeps the TPU's "last grid step wins" for duplicate ids on the device: the
// CTAs of lane i scan idx[i+1:] and skip the lane if any later lane has the
// same id, so exactly one lane writes each slot.  The scan is O(K) per CTA
// and reads ids that sit in L2; K is at most a tick's budget on the
// migration path.  Slot ids are int64, read from device memory by each CTA.
// The gather writes each output lane once, so duplicate ids need nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr unsigned kMaxChunksY = 65535;

template <typename T, bool kLastWins>
__global__ void __launch_bounds__(kThreads)
move_lanes_kernel(const char* __restrict__ src_base, char* __restrict__ dst_base,
                  const long long* __restrict__ src_idx,
                  const long long* __restrict__ dst_idx, long long n_lanes,
                  long long slot_bytes, long long lane_words) {
  const long long lane = blockIdx.x;
  const long long d = dst_idx ? dst_idx[lane] : lane;
  if (kLastWins) {
    int later = 0;
    for (long long j = lane + 1 + threadIdx.x; j < n_lanes; j += kThreads)
      later |= dst_idx[j] == d;
    if (__syncthreads_or(later)) return;  // a later lane writes this slot
  }
  const long long s = src_idx ? src_idx[lane] : lane;
  const T* from = reinterpret_cast<const T*>(src_base + s * slot_bytes);
  T* to = reinterpret_cast<T*>(dst_base + d * slot_bytes);
  const long long step = (long long)gridDim.y * kThreads * kUnroll;
  for (long long base = (long long)blockIdx.y * kThreads * kUnroll + threadIdx.x;
       base < lane_words; base += step) {
    T buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i < lane_words) buf[u] = from[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i < lane_words) to[i] = buf[u];
    }
  }
}

template <typename T, bool kLastWins>
int launch(const char* src, char* dst, const long long* src_idx, const long long* dst_idx,
           long long n_lanes, long long slot_bytes, long long lane_bytes,
           cudaStream_t stream) {
  const long long words = lane_bytes / (long long)sizeof(T);
  const long long per_cta = (long long)kThreads * kUnroll;
  long long chunks = (words + per_cta - 1) / per_cta;
  if (chunks > kMaxChunksY) chunks = kMaxChunksY;
  if (chunks < 1) chunks = 1;
  dim3 grid((unsigned)n_lanes, (unsigned)chunks);
  move_lanes_kernel<T, kLastWins><<<grid, kThreads, 0, stream>>>(
      src, dst, src_idx, dst_idx, n_lanes, slot_bytes, words);
  return (int)cudaGetLastError();
}

bool aligned16(const void* a, const void* b, long long bytes) {
  return reinterpret_cast<uintptr_t>(a) % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0 &&
         bytes % 16 == 0;
}

template <bool kLastWins>
int move_lanes(const void* src, void* dst, const void* src_idx, const void* dst_idx,
               long long n_lanes, long long slot_bytes, long long lane_bytes,
               void* stream) {
  if (n_lanes <= 0 || lane_bytes <= 0) return 0;
  if (n_lanes > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  const long long* si = static_cast<const long long*>(src_idx);
  const long long* di = static_cast<const long long*>(dst_idx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (aligned16(s, d, slot_bytes) && lane_bytes % 16 == 0)
    return launch<uint4, kLastWins>(s, d, si, di, n_lanes, slot_bytes, lane_bytes, st);
  return launch<unsigned char, kLastWins>(s, d, si, di, n_lanes, slot_bytes, lane_bytes, st);
}

// -- K1 and K2 over region shards: a table of shard base pointers ----------------

constexpr int kMaxShards = 64;

struct ShardTable {
  char* base[kMaxShards];
};

template <typename T, bool kZero>
__global__ void __launch_bounds__(kThreads)
move_shard_lanes_kernel(const ShardTable shards, const long long* __restrict__ src_idx,
                        const long long* __restrict__ dst_idx, long long slots_per_region,
                        long long slot_bytes, long long lane_words) {
  const long long lane = blockIdx.x;
  const long long g = dst_idx[lane];
  T* to = reinterpret_cast<T*>(shards.base[g / slots_per_region] +
                               (g % slots_per_region) * slot_bytes);
  const long long step = (long long)gridDim.y * kThreads * kUnroll;
  const long long first = (long long)blockIdx.y * kThreads * kUnroll + threadIdx.x;
  if (kZero) {
    const T zero{};
    for (long long base = first; base < lane_words; base += step) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + (long long)u * kThreads;
        if (i < lane_words) to[i] = zero;
      }
    }
    return;
  }
  const long long f = src_idx[lane];
  const T* from = reinterpret_cast<const T*>(shards.base[f / slots_per_region] +
                                             (f % slots_per_region) * slot_bytes);
  for (long long base = first; base < lane_words; base += step) {
    T buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i < lane_words) buf[u] = from[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      if (i < lane_words) to[i] = buf[u];
    }
  }
}

template <typename T, bool kZero>
int launch_shards(const ShardTable& shards, const long long* src_idx, const long long* dst_idx,
                  long long n_lanes, long long slots_per_region, long long slot_bytes,
                  long long lane_bytes, cudaStream_t stream) {
  const long long words = lane_bytes / (long long)sizeof(T);
  const long long per_cta = (long long)kThreads * kUnroll;
  long long chunks = (words + per_cta - 1) / per_cta;
  if (chunks > kMaxChunksY) chunks = kMaxChunksY;
  if (chunks < 1) chunks = 1;
  dim3 grid((unsigned)n_lanes, (unsigned)chunks);
  move_shard_lanes_kernel<T, kZero><<<grid, kThreads, 0, stream>>>(
      shards, src_idx, dst_idx, slots_per_region, slot_bytes, words);
  return (int)cudaGetLastError();
}

template <bool kZero>
int move_shard_lanes(const void* const* bases, int n_shards, const void* src_idx,
                     const void* dst_idx, long long n_lanes, long long slots_per_region,
                     long long slot_bytes, long long lane_bytes, void* stream) {
  if (n_lanes <= 0 || lane_bytes <= 0) return 0;
  if (n_lanes > 0x7fffffffLL || n_shards < 1 || n_shards > kMaxShards || slots_per_region < 1)
    return (int)cudaErrorInvalidValue;
  ShardTable shards = {};
  bool words = slot_bytes % 16 == 0 && lane_bytes % 16 == 0;
  for (int r = 0; r < n_shards; ++r) {
    shards.base[r] = static_cast<char*>(const_cast<void*>(bases[r]));
    words = words && reinterpret_cast<uintptr_t>(bases[r]) % 16 == 0;
  }
  const long long* si = static_cast<const long long*>(src_idx);
  const long long* di = static_cast<const long long*>(dst_idx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (words)
    return launch_shards<uint4, kZero>(shards, si, di, n_lanes, slots_per_region, slot_bytes,
                                       lane_bytes, st);
  return launch_shards<unsigned char, kZero>(shards, si, di, n_lanes, slots_per_region,
                                             slot_bytes, lane_bytes, st);
}

// -- the gather: a persistent TMA bulk-copy pipeline ---------------------------

constexpr int kStages = 12;         // ring stages a CTA
constexpr int kMaxTile = 16384;     // bytes a stage holds
constexpr int kStoresReading = 2;   // stores that may still read the ring at a reload
constexpr int kGatherSmem = kStages * kMaxTile + kStages * 8;  // the ring, then its barriers

// The pool's bytes are read once: L2 keeps them last, so that it holds the
// output's lines instead
__device__ __forceinline__ unsigned long long read_once_policy() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void bulk_load(unsigned stage, const char* from, unsigned bytes,
                                          unsigned bar, unsigned long long policy) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;"
      :: "r"(stage), "l"(from), "r"(bytes), "r"(bar), "l"(policy) : "memory");
}

__device__ __forceinline__ void wait_landed(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void bulk_store(char* to, unsigned stage, unsigned bytes) {
  // the landed bytes were seen through the barrier; order them before the
  // store's read of the ring, which the async proxy makes
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(to), "r"(stage), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Each lane is cut into `pieces` tiles of `tile` bytes, the last one shorter;
// tile j of the output is piece j % pieces of lane j / pieces.
__global__ void __launch_bounds__(32, 1)
gather_bulk_kernel(const char* __restrict__ pool, char* __restrict__ out,
                   const long long* __restrict__ idx, long long n_lanes, long long slot_bytes,
                   long long tile, long long pieces) {
  extern __shared__ __align__(128) unsigned char smem[];
  const unsigned ring = (unsigned)__cvta_generic_to_shared(smem);
  const unsigned bars = ring + kStages * kMaxTile;
  const bool leader = threadIdx.x == 0;
  const unsigned long long policy = read_once_policy();
  // this CTA's tiles: [first, first + n), an even split of all of them
  const long long tiles = n_lanes * pieces, g = gridDim.x, c = blockIdx.x;
  const long long q = tiles / g, r = tiles % g;
  const long long first = c * q + (c < r ? c : r), n = q + (c < r ? 1 : 0);
  if (leader) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bars + 8 * s), "r"(1)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // this CTA's tile i: its lane, its offset in the lane and its size
  struct Tile {
    long long lane, within;
    unsigned bytes;
  };
  auto tile_at = [&](long long i) {
    const long long j = first + i, lane = j / pieces, within = (j - lane * pieces) * tile;
    return Tile{lane, within, (unsigned)(slot_bytes - within < tile ? slot_bytes - within : tile)};
  };
  // the ids of lanes [win, win + 32), one a thread
  long long win = first / pieces;
  long long id = win + threadIdx.x < n_lanes ? idx[win + threadIdx.x] : 0;
  // every thread runs the loops (the shuffle needs the whole warp); the
  // leader alone issues the copies and waits on them
  auto load = [&](long long i) {  // tile i into stage i % kStages
    const Tile t = tile_at(i);
    if (t.lane - win >= 32) {
      win = t.lane;
      id = win + threadIdx.x < n_lanes ? idx[win + threadIdx.x] : 0;
    }
    const long long slot = __shfl_sync(0xffffffffu, id, (int)(t.lane - win));
    const int s = (int)(i % kStages);
    if (leader)
      bulk_load(ring + s * kMaxTile, pool + slot * slot_bytes + t.within, t.bytes, bars + 8 * s,
                policy);
  };
  for (long long i = 0; i < n && i < kStages; ++i) load(i);
  for (long long i = 0; i < n; ++i) {
    if (leader) {
      const Tile t = tile_at(i);
      const int s = (int)(i % kStages);
      wait_landed(bars + 8 * s, (unsigned)(i / kStages) & 1);
      bulk_store(out + t.lane * slot_bytes + t.within, ring + s * kMaxTile, t.bytes);
    }
    // tile i + kStages - kStoresReading takes the stage of tile i -
    // kStoresReading once that tile's store has read it
    const long long next = i + kStages - kStoresReading;
    if (i >= kStoresReading && next < n) {
      if (leader) asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(kStoresReading) : "memory");
      load(next);
    }
  }
  if (leader) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");  // the bytes are out
}

constexpr int kMaxDevices = 64;

int gather_bulk(const char* pool, char* out, const long long* idx, long long n_lanes,
                long long slot_bytes, cudaStream_t stream) {
  // per device, read once: the SM count and the opt-in to the ring's size
  static int sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(gather_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kGatherSmem);
    if (err != cudaSuccess) return (int)err;
    sms[dev] = n;
  }
  // equal tiles of at most kMaxTile bytes, in 16-byte units, none empty
  long long pieces = (slot_bytes + kMaxTile - 1) / kMaxTile;
  const long long tile = ((slot_bytes + pieces - 1) / pieces + 15) / 16 * 16;
  pieces = (slot_bytes + tile - 1) / tile;
  const long long tiles = n_lanes * pieces;
  const unsigned grid = (unsigned)(tiles < sms[dev] ? tiles : sms[dev]);
  gather_bulk_kernel<<<grid, 32, kGatherSmem, stream>>>(pool, out, idx, n_lanes, slot_bytes,
                                                         tile, pieces);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point returns a cudaError_t (0 on success).

// Copies n_lanes lanes of lane_bytes each inside the pool; lane i starts at
// slot src[i] and lands at slot dst[i].  copy_blocks passes lane_bytes ==
// slot_bytes, copy_runs passes lane_bytes == run * slot_bytes.
extern "C" int leap_copy_lanes(void* pool, const void* src, const void* dst,
                               long long n_lanes, long long slot_bytes,
                               long long lane_bytes, void* stream) {
  return move_lanes<false>(pool, pool, src, dst, n_lanes, slot_bytes, lane_bytes, stream);
}

// out[i] = pool[idx[i]] for n_lanes slots of slot_bytes each: the bulk-copy
// pipeline when both bases and the slot size are 16-byte aligned, else
// move_lanes_kernel's byte instance.
extern "C" int leap_gather_blocks(void* out, const void* pool, const void* idx,
                                  long long n_lanes, long long slot_bytes, void* stream) {
  if (n_lanes <= 0 || slot_bytes <= 0) return 0;
  if (aligned16(out, pool, slot_bytes))
    return gather_bulk(static_cast<const char*>(pool), static_cast<char*>(out),
                       static_cast<const long long*>(idx), n_lanes, slot_bytes,
                       static_cast<cudaStream_t>(stream));
  return move_lanes<false>(pool, out, idx, nullptr, n_lanes, slot_bytes, slot_bytes, stream);
}

// pool[idx[i]] = blocks[i]; of lanes with equal ids the last one wins.
extern "C" int leap_scatter_blocks(void* pool, const void* blocks, const void* idx,
                                   long long n_lanes, long long slot_bytes, void* stream) {
  return move_lanes<true>(blocks, pool, nullptr, idx, n_lanes, slot_bytes, slot_bytes, stream);
}

// K1 and K2 over region shards: lane i copies lane_bytes from flat slot
// src[i] to flat slot dst[i], flat slot f being slot f % slots_per_region of
// shard f / slots_per_region, whose base is bases[f / slots_per_region]
// (bases: a host array of n_shards device pointers, at most 64).  With src
// null the lanes' destinations are zeroed instead.
extern "C" int leap_copy_shards(const void* const* bases, int n_shards, const void* src,
                                const void* dst, long long n_lanes, long long slots_per_region,
                                long long slot_bytes, long long lane_bytes, void* stream) {
  if (src == nullptr)
    return move_shard_lanes<true>(bases, n_shards, nullptr, dst, n_lanes, slots_per_region,
                                  slot_bytes, lane_bytes, stream);
  return move_shard_lanes<false>(bases, n_shards, src, dst, n_lanes, slots_per_region,
                                 slot_bytes, lane_bytes, stream);
}

// Lets kernels on `device` reach memory of `peer` (a region shard on another
// card); returns cudaErrorPeerAccessUnsupported when the two cannot reach
// each other, and 0 when access is on, already or now.  The current device
// is left as it was.
extern "C" int leap_enable_peer_access(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  int was = 0;
  err = cudaGetDevice(&was);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the (not sticky) error the call recorded
    err = cudaSuccess;
  }
  const cudaError_t back = cudaSetDevice(was);
  return (int)(err != cudaSuccess ? err : back);
}
