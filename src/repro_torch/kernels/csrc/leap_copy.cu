// In-place intra-pool lane copies for leap migration on Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/leap_copy.py:
//   copy_blocks_pallas  pool[dst[i]] = pool[src[i]]               (one slot)
//   copy_runs_pallas    pool[dst[i]:+run] = pool[src[i]:+run]     (one run)
// Both are the same function here: lane i moves `lane_bytes` bytes from
// byte offset src[i] * slot_bytes to dst[i] * slot_bytes of the flat pool.
//
// Bound: bytes moved.  Each lane is read once and written once, and there is
// no arithmetic, so the card's memory rate (3.35 TB/s on an H100 SXM) is the
// only limit.  Design: a 2-D grid, lanes on x and chunks of a lane on y, so
// a 64 KiB slot spreads over several CTAs and a tick's lanes fill all SMs.
// Each thread moves 16-byte uint4 words, UNROLL of them loaded before any is
// stored, so several loads are in flight per thread.  When the pool base or
// the slot size is not 16-byte aligned, the same kernel runs on single bytes.
// The kernel works on bytes, so one kernel serves every dtype.
//
// Contract (checked on the host by leap_copy.check_copy_plan before launch):
// lanes do not overlap and no destination is a source, so CTAs may run in
// any order.  Slot ids are int64, read from device memory by each CTA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr unsigned kMaxChunksY = 65535;

template <typename T>
__global__ void __launch_bounds__(kThreads)
copy_lanes_kernel(char* __restrict__ pool, const long long* __restrict__ src,
                  const long long* __restrict__ dst, long long slot_bytes,
                  long long lane_words) {
  const long long lane = blockIdx.x;
  const T* from = reinterpret_cast<const T*>(pool + src[lane] * slot_bytes);
  T* to = reinterpret_cast<T*>(pool + dst[lane] * slot_bytes);
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

template <typename T>
int launch(char* pool, const long long* src, const long long* dst, long long n_lanes,
           long long slot_bytes, long long lane_bytes, cudaStream_t stream) {
  const long long words = lane_bytes / (long long)sizeof(T);
  const long long per_cta = (long long)kThreads * kUnroll;
  long long chunks = (words + per_cta - 1) / per_cta;
  if (chunks > kMaxChunksY) chunks = kMaxChunksY;
  if (chunks < 1) chunks = 1;
  dim3 grid((unsigned)n_lanes, (unsigned)chunks);
  copy_lanes_kernel<T><<<grid, kThreads, 0, stream>>>(pool, src, dst, slot_bytes, words);
  return (int)cudaGetLastError();
}

}  // namespace

// Copies n_lanes lanes of lane_bytes each; lane i starts at slot src[i] and
// lands at slot dst[i].  copy_blocks passes lane_bytes == slot_bytes,
// copy_runs passes lane_bytes == run * slot_bytes.  Returns a cudaError_t.
extern "C" int leap_copy_lanes(void* pool, const void* src, const void* dst,
                               long long n_lanes, long long slot_bytes,
                               long long lane_bytes, void* stream) {
  if (n_lanes <= 0 || lane_bytes <= 0) return 0;
  if (n_lanes > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  char* p = static_cast<char*>(pool);
  const long long* s = static_cast<const long long*>(src);
  const long long* d = static_cast<const long long*>(dst);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = (reinterpret_cast<uintptr_t>(p) % 16 == 0) && (slot_bytes % 16 == 0) &&
                   (lane_bytes % 16 == 0);
  if (vec) return launch<uint4>(p, s, d, n_lanes, slot_bytes, lane_bytes, st);
  return launch<unsigned char>(p, s, d, n_lanes, slot_bytes, lane_bytes, st);
}
