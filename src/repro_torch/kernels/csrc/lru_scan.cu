// RG-LRU linear-recurrence scan on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/lru_scan.py::lru_scan_pallas:
//   h_t = a_t * h_{t-1} + b_t   over t = 0 .. T-1, from h_{-1} = h0,
// for a, b, out [B, T, R] (float32 or bfloat16, out in the input type) and
// h0 [B, R] float32 (the wrapper casts it, as the Pallas kernel does).
//
// Bound: bytes.  The function reads a and b once and writes out once, and
// does 2 flops per element.  The recurrence is sequential in t and
// independent across (b, r), so one thread owns one channel and carries h in
// a float32 register through all T steps; the TPU grid's sequential time
// axis becomes that loop.  Neighbouring threads own neighbouring r, so every
// load and store of a warp is one coalesced row segment.  Each step rounds
// the multiply and the add separately (__fmul_rn, __fadd_rn: no FMA
// contraction), the order of the plain version, so float32 results equal it
// bit for bit, and bfloat16 outputs round the same float32 value to nearest
// even.  No atomics: a run repeats itself bit for bit.
//
// Latency is what limits this design: at the serving shapes (B = 8,
// R = 4096) there are only 32,768 threads.  So the loads of the next kDepth
// steps of a and b are issued before the dependent chain of the current
// kDepth steps runs on values already in registers (double buffering in
// registers), keeping 2 * kDepth loads a thread in flight.  a and b are read
// once and out is written once, so both go through the streaming cache
// operators (evict first).  Splitting T across CTAs (a chunked two-pass
// scan) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDepth = 8;  // time steps of a and b loaded ahead of the chain

__device__ __forceinline__ float load(const float* p) { return __ldcs(p); }

__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ void store(float* p, float v) { __stcs(p, v); }

__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// Steps t0 .. t0 + kDepth - 1 of one channel; steps at or past n_t read 0.
template <typename T>
__device__ __forceinline__ void load_steps(const T* __restrict__ a, const T* __restrict__ b,
                                           long long base, long long t0, long long n_t,
                                           long long n_r, float* av, float* bv) {
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    const bool live = t0 + k < n_t;
    const long long off = base + (t0 + k) * n_r;
    av[k] = live ? load(a + off) : 0.0f;
    bv[k] = live ? load(b + off) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, const float* __restrict__ h0,
                T* __restrict__ out, long long n_t, long long n_r) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_r) return;
  const long long batch = blockIdx.y;
  const long long base = batch * n_t * n_r + r;  // element (batch, 0, r)
  float h = h0[batch * n_r + r];
  float a_cur[kDepth], b_cur[kDepth], a_next[kDepth], b_next[kDepth];
  load_steps(a, b, base, 0, n_t, n_r, a_cur, b_cur);
  for (long long t0 = 0; t0 < n_t; t0 += kDepth) {
    load_steps(a, b, base, t0 + kDepth, n_t, n_r, a_next, b_next);  // in flight meanwhile
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      if (t0 + k < n_t) {
        h = __fadd_rn(__fmul_rn(a_cur[k], h), b_cur[k]);
        store(out + base + (t0 + k) * n_r, h);
      }
    }
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      a_cur[k] = a_next[k];
      b_cur[k] = b_next[k];
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, const void* h0, void* out, long long n_b,
           long long n_t, long long n_r, cudaStream_t stream) {
  const dim3 grid((unsigned)((n_r + kThreads - 1) / kThreads), (unsigned)n_b);
  lru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const float*>(h0),
      static_cast<T*>(out), n_t, n_r);
  return (int)cudaGetLastError();
}

// Steps t0, t0 - 1, .., t0 - kDepth + 1 of one channel for the backward: g_t,
// a_t and h_{t-1} (h0 at t = 0); steps below 0 read 0.
template <typename T>
__device__ __forceinline__ void load_steps_rev(const T* __restrict__ g, const T* __restrict__ a,
                                               const T* __restrict__ h, float h0, long long base,
                                               long long t0, long long n_r, float* gv,
                                               float* av, float* hv) {
#pragma unroll
  for (int k = 0; k < kDepth; ++k) {
    const long long t = t0 - k;
    const long long off = base + t * n_r;
    gv[k] = t >= 0 ? load(g + off) : 0.0f;
    av[k] = t >= 0 ? load(a + off) : 0.0f;
    hv[k] = t > 0 ? load(h + off - n_r) : (t == 0 ? h0 : 0.0f);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lru_scan_bwd_kernel(const T* __restrict__ g, const T* __restrict__ a, const T* __restrict__ h,
                    const float* __restrict__ h0, T* __restrict__ da, T* __restrict__ db,
                    float* __restrict__ dh0, long long n_t, long long n_r) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_r) return;
  const long long batch = blockIdx.y;
  const long long base = batch * n_t * n_r + r;  // element (batch, 0, r)
  const float h_init = h0[batch * n_r + r];
  float lam = 0.0f, a_next = 0.0f;  // lambda_T and a_T: the carry past the end
  float g_cur[kDepth], a_cur[kDepth], h_cur[kDepth];
  float g_next[kDepth], a_next_v[kDepth], h_next[kDepth];
  load_steps_rev(g, a, h, h_init, base, n_t - 1, n_r, g_cur, a_cur, h_cur);
  for (long long t0 = n_t - 1; t0 >= 0; t0 -= kDepth) {
    load_steps_rev(g, a, h, h_init, base, t0 - kDepth, n_r, g_next, a_next_v, h_next);
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const long long t = t0 - k;
      if (t >= 0) {
        lam = __fadd_rn(g_cur[k], __fmul_rn(a_next, lam));
        store(db + base + t * n_r, lam);
        store(da + base + t * n_r, __fmul_rn(lam, h_cur[k]));
        a_next = a_cur[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      g_cur[k] = g_next[k];
      a_cur[k] = a_next_v[k];
      h_cur[k] = h_next[k];
    }
  }
  dh0[batch * n_r + r] = __fmul_rn(a_next, lam);
}

template <typename T>
int launch_bwd(const void* g, const void* a, const void* h, const void* h0, void* da, void* db,
               void* dh0, long long n_b, long long n_t, long long n_r, cudaStream_t stream) {
  const dim3 grid((unsigned)((n_r + kThreads - 1) / kThreads), (unsigned)n_b);
  lru_scan_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(a), static_cast<const T*>(h),
      static_cast<const float*>(h0), static_cast<T*>(da), static_cast<T*>(db),
      static_cast<float*>(dh0), n_t, n_r);
  return (int)cudaGetLastError();
}

bool bad_shape(long long n_b, long long n_t, long long n_r) {
  return n_b < 1 || n_t < 1 || n_r < 1 || n_b > 65535 ||
         (n_r + kThreads - 1) / kThreads > 0x7fffffffLL;
}

}  // namespace

// a, b, out: [n_b, n_t, n_r] contiguous, dtype 0 = float32, 1 = bfloat16;
// h0: [n_b, n_r] contiguous float32.  Returns a cudaError_t.
extern "C" int leap_lru_scan(const void* a, const void* b, const void* h0, void* out,
                             long long n_b, long long n_t, long long n_r, int dtype,
                             void* stream) {
  if (bad_shape(n_b, n_t, n_r)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, h0, out, n_b, n_t, n_r, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, h0, out, n_b, n_t, n_r, s);
  return (int)cudaErrorInvalidValue;
}

// The backward.  g (the gradient of out), a, h (the forward's out), da, db:
// [n_b, n_t, n_r] contiguous, dtype 0 = float32, 1 = bfloat16; h0, dh0:
// [n_b, n_r] contiguous float32.  Returns a cudaError_t.
extern "C" int leap_lru_scan_bwd(const void* g, const void* a, const void* h, const void* h0,
                                 void* da, void* db, void* dh0, long long n_b, long long n_t,
                                 long long n_r, int dtype, void* stream) {
  if (bad_shape(n_b, n_t, n_r)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(g, a, h, h0, da, db, dh0, n_b, n_t, n_r, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(g, a, h, h0, da, db, dh0, n_b, n_t, n_r, s);
  return (int)cudaErrorInvalidValue;
}
