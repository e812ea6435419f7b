// Access-heat decay + accumulate for closed-loop tiering on Hopper (sm_90a),
// with the samples binned by tile.
//
// Replaces the TPU kernel src/repro/kernels/heat_scan.py::heat_scan_pallas:
//   heat[i] = heat[i] * decay + sum(w[k] for k with ids[k] == i)
// over a flat fp32 plane of L entries; ids outside [0, L) are inert lanes.
//
// Bound: bytes.  The function needs about 8 bytes per heat entry plus 12
// per sample (about 1 MiB at L = 131072, well under a microsecond at
// 3.35 TB/s).  The TPU kernel compares every sample with every entry of its
// tile, O(K * L) compares, which a TPU's vector unit does densely; on this
// card that work, not memory, would set the time.  So each CTA owns a tile
// of 1024 entries (256 threads x 4) and bins the samples first:
//
// 1. Filter.  The CTA streams the K sample ids once, coalesced, 256 at a
//    time (four such chunks loaded at once), and keeps those that fall in
//    its tile, compacted into shared memory in sample order: a warp ballot
//    and a block-wide prefix over the warps' counts, no atomics.
// 2. Accumulate.  Each thread sums, for each of its 4 entries, the weights
//    of the compacted samples that hit it, in sample order: each warp walks
//    only the buffered samples that hit its 128 entries, found by a ballot.
//    A tile that receives more samples than its buffer holds folds the
//    buffer in and refills it, in rounds, so any K is taken and the order
//    is kept.
// 3. Write.  heat * decay + acc, the tile read and written as 16-byte
//    vectors (the read starts before the filter, so that it overlaps it).
//
// The work is O(L + K * CTAs) instead of O(K * L).  A CTA whose tile takes
// every sample makes one pass over them per warp, 32 at a time, plus a few
// instructions per sample in the warp that owns its entry.  Sums run in
// sample order from zero, and the multiply and the add are rounded
// separately (no FMA contraction), as the plain version does them, so the
// plane is bit-identical from run to run (the tiering thresholds and the
// chaos determinism checks compare it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;
constexpr int kTileEntries = kThreads * kPerThread;
constexpr int kBatch = 4;     // chunks of kThreads samples loaded at once
constexpr int kBuf = 2048;    // compacted samples a tile holds

// acc[e] += w of every buffered sample that hits entry tid * 4 + e, in
// sample order.  Warp `warp` owns the tile's entries [128 warp, 128 warp +
// 128): it reads the buffer 32 samples at a time, and a ballot names the
// samples that hit its entries, which it then walks in order, each handed
// by a shuffle to the lane that owns its entry.  A warp so passes over the
// buffer once and spends work only on its own hits.
__device__ __forceinline__ void fold(const unsigned short* loc, const float* w, int n, int lane,
                                     int warp, float acc[kPerThread]) {
  for (int base = 0; base < n; base += 32) {
    const int k = base + lane;
    const int at = k < n ? (int)loc[k] : -1;
    const float x = k < n ? w[k] : 0.0f;
    const bool ours = k < n && at / (32 * kPerThread) == warp;
    unsigned hits = __ballot_sync(0xffffffffu, ours);
    while (hits) {  // the same in every lane
      const int j = __ffs(hits) - 1;
      hits &= hits - 1;
      const int e = __shfl_sync(0xffffffffu, at, j);
      const float xj = __shfl_sync(0xffffffffu, x, j);
      const int d = e - (warp * 32 + lane) * kPerThread;  // 0..3 in the owning lane
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) acc[i] = d == i ? __fadd_rn(acc[i], xj) : acc[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
heat_scan_kernel(float* __restrict__ heat, const long long* __restrict__ ids,
                 const float* __restrict__ w, long long n_heat, long long n_samples,
                 float decay) {
  __shared__ unsigned short s_loc[kBuf];  // offset of the sample's entry in the tile
  __shared__ float s_w[kBuf];
  __shared__ int s_warp[kWarps];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const long long lo = (long long)blockIdx.x * kTileEntries;
  const long long n_tile = min((long long)kTileEntries, n_heat - lo);
  const long long mine = lo + (long long)tid * kPerThread;

  float h[kPerThread];
  const bool vec = (reinterpret_cast<uintptr_t>(heat) % 16 == 0) && mine + kPerThread <= n_heat;
  if (vec) {
    const float4 v = *reinterpret_cast<const float4*>(heat + mine);
    h[0] = v.x;
    h[1] = v.y;
    h[2] = v.z;
    h[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e) h[e] = mine + e < n_heat ? heat[mine + e] : 0.0f;
  }

  float acc[kPerThread] = {0.0f, 0.0f, 0.0f, 0.0f};
  int count = 0;  // samples in the buffer: the same in every thread
  for (long long base = 0; base < n_samples; base += (long long)kBatch * kThreads) {
    long long id[kBatch];
    float wk[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const long long k = base + r * kThreads + tid;
      id[r] = k < n_samples ? __ldg(ids + k) : -1;
      wk[r] = k < n_samples ? __ldg(w + k) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      if (base + r * kThreads >= n_samples) break;  // the same for the whole CTA
      if (count > kBuf - kThreads) {  // this chunk might not fit: fold the buffer in
        fold(s_loc, s_w, count, lane, warp, acc);
        count = 0;
        __syncthreads();  // every thread has read the buffer before it is refilled
      }
      const long long off = id[r] - lo;
      const bool hit = off >= 0 && off < n_tile;  // ids outside [0, L) never hit
      const unsigned mask = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_warp[warp] = __popc(mask);
      __syncthreads();
      int at = count, total = 0;
#pragma unroll
      for (int x = 0; x < kWarps; ++x) {
        const int c = s_warp[x];
        at += x < warp ? c : 0;
        total += c;
      }
      if (hit) {
        at += __popc(mask & ((1u << lane) - 1u));  // earlier lanes of this warp
        s_loc[at] = (unsigned short)off;
        s_w[at] = wk[r];
      }
      count += total;
      __syncthreads();  // the chunk is in the buffer; s_warp may be rewritten
    }
  }
  fold(s_loc, s_w, count, lane, warp, acc);

#pragma unroll
  for (int e = 0; e < kPerThread; ++e) h[e] = __fadd_rn(__fmul_rn(h[e], decay), acc[e]);
  if (vec) {
    *reinterpret_cast<float4*>(heat + mine) = make_float4(h[0], h[1], h[2], h[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kPerThread; ++e)
      if (mine + e < n_heat) heat[mine + e] = h[e];
  }
}

}  // namespace

// In place on heat[0:n_heat]; ids and w hold n_samples entries.  One CTA
// per tile of 1024 entries.  Returns a cudaError_t.
extern "C" int leap_heat_scan(void* heat, const void* ids, const void* w, long long n_heat,
                              long long n_samples, float decay, void* stream) {
  if (n_heat <= 0) return 0;
  const long long n_tiles = (n_heat + kTileEntries - 1) / kTileEntries;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  heat_scan_kernel<<<(unsigned)n_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(heat), static_cast<const long long*>(ids),
      static_cast<const float*>(w), n_heat, n_samples, decay);
  return (int)cudaGetLastError();
}
