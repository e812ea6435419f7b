// Paged flash-decode attention over a leap block table on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attn.py::paged_decode_pallas.
// One decode token per sequence: for sequence b and kv head h, the G query
// rows of the head's group attend over the first len[b] tokens of the
// sequence, whose KV lives in pool slots named by the block table:
//
//   token p lives in slot tables[b, p / BLK] at row p % BLK;
//   slot s holds [2 (K, V), BLK, KVH, HD] dense, at kv + s * slot_stride.
//
// slot_stride is free, so the kernel reads one layer of a pool whose slots
// hold every layer ([S, L, 2, BLK, KVH, HD]) in place, through the strided
// per-layer view, without copying it.  Scores are scaled by 1/sqrt(HD) (the
// wrapper passes the fp32 scale), optionally tanh-softcapped, and the fp32
// partials (out = acc / l, m, l) are written so that shards combine with a
// log-sum-exp merge.
//
// Bound: bytes.  The function reads sum(len) * KVH * HD * 2 (K and V) pool
// elements and does 4 flops per element pair and query row, about G flops per
// byte in bf16: far below the card's balance point.  This first design keeps
// to what is simple and right: one CTA per (b, kv head) walks the sequence in
// tiles of 64 tokens.  In each tile, threads 0..63 each load one token's K row
// as 16-byte vectors and score it against the G query rows held in shared
// memory; threads 64..127 each stage one token's V row into shared memory.
// One warp per query row then folds the tile into an fp32 online softmax
// (m, l in shared memory), and every thread updates its fixed share of the
// [G, HD] accumulator from the tile's probabilities and V rows.  The TPU
// grid's sequential j axis becomes that loop inside the CTA.  No atomics: a
// run repeats itself bit for bit.  Positions at or past len[b] are never
// read, so table entries beyond the sequence may hold anything.
//
// With B * KVH CTAs (64 at the serving shapes) the grid covers under half of
// the 132 SMs; a split over tiles merged by combine_partials is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;  // tokens per tile: kThreads / 2
constexpr int kMaxG = 16;  // query rows per kv head
constexpr int kPad = 4;    // floats of padding per staged V row (keeps 16-byte rows)

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,          // [B, KVH, G, HD]
                    const T* __restrict__ kv,         // slot s at kv + s * slot_stride
                    const int* __restrict__ tables,   // [B, MAXB]
                    const int* __restrict__ lens,     // [B]
                    T* __restrict__ out,              // [B, KVH, G, HD]
                    float* __restrict__ m_out,        // [B, KVH, G]
                    float* __restrict__ l_out,        // [B, KVH, G]
                    int kvh, int g, int blk, int maxb, long long slot_stride, float softcap,
                    float scale) {
  constexpr int VEC = 16 / sizeof(T);                         // elements per 16-byte load
  constexpr int NV = HD / VEC;                                // loads per row
  constexpr int PER = (kMaxG * HD + kThreads - 1) / kThreads;  // accumulators per thread
  __shared__ __align__(16) float q_s[kMaxG][HD];
  __shared__ float s_s[kMaxG][kTile];
  __shared__ __align__(16) float v_s[kTile][HD + kPad];
  __shared__ float m_s[kMaxG], l_s[kMaxG], a_s[kMaxG];

  const int b = blockIdx.x / kvh;
  const int h = blockIdx.x % kvh;
  const int tid = threadIdx.x;
  const int len = min(lens[b], maxb * blk);  // the plain version sees MAXB * BLK tokens
  const int* tab = tables + (long long)b * maxb;
  const long long row_stride = (long long)kvh * HD;         // token to token in a page
  const long long half_stride = (long long)blk * row_stride;  // K half to V half
  const long long bh = (long long)b * kvh + h;

  const T* qp = q + bh * g * HD;
  for (int i = tid; i < g * HD; i += kThreads) q_s[i / HD][i % HD] = to_float(qp[i]) * scale;
  if (tid < g) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.0f;
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int base = 0; base < len; base += kTile) {
    const int t = tid % kTile;
    const int pos = base + t;
    const bool valid = pos < len;
    if (tid < kTile) {
      // scores of token pos against each query row
      float s[kMaxG];
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) s[gi] = 0.0f;
      if (valid) {
        const T* kp = kv + (long long)tab[pos / blk] * slot_stride +
                      (long long)(pos % blk) * row_stride + (long long)h * HD;
#pragma unroll
        for (int vi = 0; vi < NV; ++vi) {
          float kf[VEC];
          load_vec(kp + vi * VEC, kf);
#pragma unroll
          for (int gi = 0; gi < kMaxG; ++gi) {
            if (gi < g) {
#pragma unroll
              for (int e = 0; e < VEC; ++e) s[gi] = fmaf(q_s[gi][vi * VEC + e], kf[e], s[gi]);
            }
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < kMaxG; ++gi) {
        if (gi < g) {
          float x = s[gi];
          if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
          s_s[gi][t] = valid ? x : -INFINITY;
        }
      }
    } else {
      // stage token pos's V row (zeros past the end, so that 0 * v stays 0)
      float* vrow = v_s[t];
      if (valid) {
        const T* vp = kv + (long long)tab[pos / blk] * slot_stride + half_stride +
                      (long long)(pos % blk) * row_stride + (long long)h * HD;
#pragma unroll
        for (int vi = 0; vi < NV; ++vi) load_vec(vp + vi * VEC, vrow + vi * VEC);
      } else {
#pragma unroll
        for (int d = 0; d < HD; ++d) vrow[d] = 0.0f;
      }
    }
    __syncthreads();

    // online softmax: one warp per query row folds the tile's scores in
    for (int gi = warp; gi < g; gi += kThreads / 32) {
      const float x0 = s_s[gi][lane], x1 = s_s[gi][lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[gi];
      const float m_new = fmaxf(m_old, mx);  // finite: the tile's first token is valid
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      s_s[gi][lane] = p0;
      s_s[gi][lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {  // every lane has read m_old: the shuffles above wait for all
        const float alpha = expf(m_old - m_new);
        a_s[gi] = alpha;
        l_s[gi] = l_s[gi] * alpha + sum;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();

    // acc[g, d] = acc[g, d] * alpha[g] + sum_t p[g, t] * v[t, d]
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < g * HD) {
        const int gi = idx / HD, d = idx % HD;
        float pv = 0.0f;
#pragma unroll 8
        for (int tt = 0; tt < kTile; ++tt) pv = fmaf(s_s[gi][tt], v_s[tt][d], pv);
        acc[i] = acc[i] * a_s[gi] + pv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < g * HD) out[bh * g * HD + idx] = from_float<T>(acc[i] / l_s[idx / HD]);
  }
  if (tid < g) {
    m_out[bh * g + tid] = m_s[tid];
    l_out[bh * g + tid] = l_s[tid];
  }
}

template <typename T, int HD>
int launch(const void* q, const void* kv, const void* tables, const void* lens, void* out,
           void* m, void* l, long long b, long long kvh, long long g, long long blk,
           long long maxb, long long slot_stride, float softcap, float scale,
           cudaStream_t stream) {
  paged_decode_kernel<T, HD><<<(unsigned)(b * kvh), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<T*>(out), static_cast<float*>(m),
      static_cast<float*>(l), (int)kvh, (int)g, (int)blk, (int)maxb, slot_stride, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, KVH, G, HD] and the pool share one dtype: 0 = float32, 1 = bfloat16.
// tables [B, MAXB] and lens [B] are int32, lens >= 1; every table entry below
// ceil(lens / BLK) is a valid slot.  out [B, KVH, G, HD] in q's dtype, m and
// l [B, KVH, G] float32.  Every pointer 16-byte aligned where it is read as
// vectors (q, kv); slot_stride in elements.  Returns a cudaError_t.
extern "C" int leap_paged_decode(const void* q, const void* kv, const void* tables,
                                 const void* lens, void* out, void* m, void* l, long long b,
                                 long long kvh, long long g, long long hd, long long blk,
                                 long long maxb, long long slot_stride, float softcap,
                                 float scale, int dtype, void* stream) {
  if (b <= 0 || kvh <= 0) return 0;
  if (g < 1 || g > kMaxG || blk < 1 || maxb < 1 || b * kvh > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LEAP_PAGED_DECODE_CASE(CODE, T, HD)                                                \
  if (dtype == CODE && hd == HD)                                                           \
    return launch<T, HD>(q, kv, tables, lens, out, m, l, b, kvh, g, blk, maxb, slot_stride, \
                         softcap, scale, s);
  LEAP_PAGED_DECODE_CASE(0, float, 16)
  LEAP_PAGED_DECODE_CASE(0, float, 64)
  LEAP_PAGED_DECODE_CASE(0, float, 128)
  LEAP_PAGED_DECODE_CASE(1, __nv_bfloat16, 16)
  LEAP_PAGED_DECODE_CASE(1, __nv_bfloat16, 64)
  LEAP_PAGED_DECODE_CASE(1, __nv_bfloat16, 128)
#undef LEAP_PAGED_DECODE_CASE
  return (int)cudaErrorInvalidValue;
}
