// Access-heat decay + accumulate for closed-loop tiering on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/heat_scan.py::heat_scan_pallas:
//   heat[i] = heat[i] * decay + sum(w[k] for k with ids[k] == i)
// over a flat fp32 plane of L entries; ids >= L are inert lanes.
//
// Bound: by bytes the function needs about 8 bytes per heat entry plus
// 12 per sample (about 1 MiB at L = 131072, well under a microsecond at
// 3.35 TB/s).  This design does O(K * L) integer compares instead, so at
// tick-sized K it is bound by those compares, not by memory.  It keeps the
// Pallas kernel's tile ownership: each thread owns one heat entry, the
// samples are staged through shared memory in chunks that every thread of
// the CTA reads as broadcasts, and each thread sums the weights that match
// its entry in sample order.  No global atomics are used, so the plane is
// bit-identical from run to run (the tiering thresholds and the chaos
// determinism checks compare against it).  The multiply and the add are
// rounded separately (no FMA contraction), as the plain version does them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;  // samples staged in shared memory at a time

__global__ void __launch_bounds__(kThreads)
heat_scan_kernel(float* __restrict__ heat, const long long* __restrict__ ids,
                 const float* __restrict__ w, long long n_heat, long long n_samples,
                 float decay) {
  __shared__ long long s_ids[kChunk];
  __shared__ float s_w[kChunk];
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  float acc = 0.0f;
  for (long long base = 0; base < n_samples; base += kChunk) {
    const int n = (int)min((long long)kChunk, n_samples - base);
    __syncthreads();  // the previous chunk is fully read
    for (int k = threadIdx.x; k < n; k += kThreads) {
      s_ids[k] = ids[base + k];
      s_w[k] = w[base + k];
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      if (s_ids[k] == i) acc = __fadd_rn(acc, s_w[k]);
    }
  }
  if (i < n_heat) heat[i] = __fadd_rn(__fmul_rn(heat[i], decay), acc);
}

}  // namespace

// In place on heat[0:n_heat]; ids and w hold n_samples entries.  Returns a
// cudaError_t.
extern "C" int leap_heat_scan(void* heat, const void* ids, const void* w, long long n_heat,
                              long long n_samples, float decay, void* stream) {
  if (n_heat <= 0) return 0;
  const long long blocks = (n_heat + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  heat_scan_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(heat), static_cast<const long long*>(ids),
      static_cast<const float*>(w), n_heat, n_samples, decay);
  return (int)cudaGetLastError();
}
