// Block and run copies for leap migration on Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/leap_copy.py:
//   copy_blocks_pallas    pool[dst[i]] = pool[src[i]]             (in place)
//   copy_runs_pallas      pool[dst[i]:+run] = pool[src[i]:+run]   (in place)
//   gather_blocks_pallas  out[i] = pool[idx[i]]        (pack a staging buffer)
//   scatter_blocks_pallas pool[idx[i]] = blocks[i]     (unpack it, in place)
// All four are one kernel body: lane i moves `lane_bytes` bytes from
// src_base + s_i * slot_bytes to dst_base + d_i * slot_bytes, where s_i is
// src_idx[i] (or i when src_idx is null) and d_i is dst_idx[i] (or i).
// copy_blocks and copy_runs pass the pool as both bases; gather reads the
// pool at idx and writes lane i of the buffer; scatter the reverse.
//
// Bound: bytes moved.  Each lane is read once and written once, and there is
// no arithmetic, so the card's memory rate (3.35 TB/s on an H100 SXM) is the
// only limit.  Design: a 2-D grid, lanes on x and chunks of a lane on y, so
// a 64 KiB slot spreads over several CTAs and a tick's lanes fill all SMs.
// Each thread moves 16-byte uint4 words, UNROLL of them loaded before any is
// stored, so several loads are in flight per thread.  When either base or
// the slot size is not 16-byte aligned, the same kernel runs on single bytes.
// The kernel works on bytes, so one kernel serves every dtype.
//
// Order.  A TPU grid runs in order; CTAs here do not.  copy_blocks and
// copy_runs need no order: the host (leap_copy.check_copy_plan) checks that
// lanes do not overlap and that no destination is a source.  scatter_blocks
// keeps the TPU's "last grid step wins" for duplicate ids on the device: the
// CTAs of lane i scan idx[i+1:] and skip the lane if any later lane has the
// same id, so exactly one lane writes each slot.  The scan is O(K) per CTA
// and reads ids that sit in L2; K is at most a tick's budget on the
// migration path.  Slot ids are int64, read from device memory by each CTA.

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
  const bool vec = (reinterpret_cast<uintptr_t>(s) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(d) % 16 == 0) && (slot_bytes % 16 == 0) &&
                   (lane_bytes % 16 == 0);
  if (vec) return launch<uint4, kLastWins>(s, d, si, di, n_lanes, slot_bytes, lane_bytes, st);
  return launch<unsigned char, kLastWins>(s, d, si, di, n_lanes, slot_bytes, lane_bytes, st);
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

// out[i] = pool[idx[i]] for n_lanes slots of slot_bytes each.
extern "C" int leap_gather_blocks(void* out, const void* pool, const void* idx,
                                  long long n_lanes, long long slot_bytes, void* stream) {
  return move_lanes<false>(pool, out, idx, nullptr, n_lanes, slot_bytes, slot_bytes, stream);
}

// pool[idx[i]] = blocks[i]; of lanes with equal ids the last one wins.
extern "C" int leap_scatter_blocks(void* pool, const void* blocks, const void* idx,
                                   long long n_lanes, long long slot_bytes, void* stream) {
  return move_lanes<true>(blocks, pool, nullptr, idx, n_lanes, slot_bytes, slot_bytes, stream);
}
