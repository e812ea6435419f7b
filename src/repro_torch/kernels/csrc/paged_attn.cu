// Paged flash-decode attention over a leap block table on Hopper (sm_90a),
// split over the sequence (flash-decoding).
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
// partials (out = acc / l, m, l) of the whole sequence are returned, so that
// shards combine with a log-sum-exp merge.
//
// Bound: bytes.  The function reads sum(len) * KVH * HD * 2 (K and V) pool
// elements and does 4 flops per element pair and query row, about G flops
// per byte in bf16: far below the card's balance point, and far below what
// wgmma's 64-row tiles would pay for at G <= 16.  So the kernel stays on the
// CUDA cores, and its design keeps the SMs busy and the latency chain short:
//
// - Grid (B * KVH, n_split).  Split j of sequence b covers tokens
//   [64 j, 64 j + 64).  n_split comes from MAXB * BLK, so the host needs
//   neither lens nor a sync; a CTA whose split starts at or past len[b]
//   exits at once.  A long sequence spreads over many SMs instead of one.
//   (Splits of 32 tokens make more CTAs than fit at once; splits of 128
//   double each CTA's compute.  64 measured fastest on an H100.)
// - The q rows and the table entries are loaded beside lens[b], before the
//   CTA knows whether it has work, so one memory round trip serves all three.
// - Each CTA (128 threads) walks its split in tiles of TILE tokens through
//   a two-stage ring in shared memory filled with 16-byte cp.async copies:
//   the next tile's K and V rows are in flight while the current one is
//   scored.  Rows past len are zero-filled (source size 0), never read.
// - Scores: a thread per (token, query row); the lanes of a row are tokens,
//   so their q reads are broadcasts, and K rows are stored swizzled (16-byte
//   piece p of row t at p ^ (t & 7)), so their reads hit distinct banks.
//   The same lanes fold the row's scores into an fp32 online softmax with
//   shuffles, so a tile costs two barriers.  P . V: a thread per (pair of
//   columns, group of tokens) keeps the sums of every query row, so each V
//   element is read from shared memory once; the groups' sums are added in
//   group order at the end.  The per-row work is sized by GM, 4 where G
//   fits in 4 (granite) and 16 above, not always by the largest G.
// - Merge in the same launch.  A sequence with one live split writes its
//   result directly.  Otherwise each split writes its partials (acc / l,
//   m, l) to scratch, and the last CTA of each (b, kv head), found by an
//   acquire-release atomic ticket that it returns to zero, merges them with
//   combine_partials' formula in split order: a warp per query row finds m*
//   and the weights, 32 splits at a time, while each thread loads its
//   outputs of the splits, which it then sums in order.  Every CTA's
//   arithmetic is fixed by its split alone, so a run repeats itself bit for
//   bit, whichever CTA comes last.  Positions at or past len[b] and table
//   entries past the sequence are never used to address the pool.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSplit = 64;           // tokens per split
constexpr int kMaxG = 16;            // query rows per kv head (the kernels' GM is 4 or 16)
constexpr int kMaxHalfBytes = 8192;  // one stage's K (or V) rows in shared memory

template <typename T, int HD>
struct Geometry {
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  static constexpr int kNV = HD / kVec;        // copies per row (a power of two)
  static constexpr int kRowBytes = HD * (int)sizeof(T);
  static constexpr int kTile = kMaxHalfBytes / kRowBytes < 32 ? kMaxHalfBytes / kRowBytes : 32;
  // K rows are stored with piece p of row t at p ^ (t & kSwz): eight
  // neighbouring rows then read one piece each from distinct banks
  static constexpr int kSwz = (kNV < 8 ? kNV : 8) - 1;
  // P . V: a thread per (pair of columns, token group)
  static constexpr int kPairs = HD / 2;
  static constexpr int kGroups = kThreads / kPairs < 4 ? kThreads / kPairs : 4;
  static_assert(kSplit % kTile == 0 && (kNV & (kNV - 1)) == 0, "tile shape");
  static_assert(kTile % kGroups == 0, "token groups");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void smem_vec(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void smem_vec(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
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

// max and sum over aligned groups of W lanes (W a power of two up to 32)
template <int W = 32>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
template <int W = 32>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The kernel's body; GM (4 or 16) bounds G and sizes the per-row work.
template <typename T, int HD, int GM>
__device__ __forceinline__ void paged_decode_split(
    const T* __restrict__ q,         // [B, KVH, G, HD]
    const T* __restrict__ kv,        // slot s at kv + s * slot_stride
    const int* __restrict__ tables,  // [B, MAXB]
    const int* __restrict__ lens,    // [B]
    T* __restrict__ out,             // [B, KVH, G, HD]
    float* __restrict__ m_out,       // [B, KVH, G]
    float* __restrict__ l_out,       // [B, KVH, G]
    float* __restrict__ part_o,      // [B * KVH, n_split, G, HD]
    float* __restrict__ part_ml,     // [B * KVH, n_split, G, 2]
    int* __restrict__ tickets,       // [B * KVH], zero between launches
    int kvh, int g, int blk, int maxb, int n_split, long long slot_stride, float softcap,
    float scale) {
  using Geo = Geometry<T, HD>;
  constexpr int VEC = Geo::kVec, NV = Geo::kNV, TILE = Geo::kTile, SWZ = Geo::kSwz;
  constexpr int PAIRS = Geo::kPairs, GROUPS = Geo::kGroups;
  constexpr int PER = (GM * HD + kThreads - 1) / kThreads;  // outputs per thread
  // the ring; after the loop it holds the token groups' P . V sums
  __shared__ __align__(16) T kv_s[2][2][TILE][HD];  // [stage][K, V][token][HD]
  static_assert(sizeof(kv_s) >= sizeof(float) * GROUPS * GM * HD, "room for the group sums");
  float(*red_s)[GM][HD] = reinterpret_cast<float(*)[GM][HD]>(&kv_s[0][0][0][0]);
  __shared__ __align__(16) float q_s[GM][HD];
  __shared__ __align__(16) float p_s[TILE][GM];  // the tile's probabilities, token-major
  __shared__ long long row_s[kSplit];  // each token's K row, in elements from kv
  __shared__ float m_s[GM], l_s[GM], a_s[GM];
  __shared__ float w_s[GM][32];  // the merge's weights, 32 splits at a time
  __shared__ int last_s;

  const long long bh = blockIdx.x;  // b * kvh + h
  const int b = (int)(bh / kvh), h = (int)(bh % kvh);
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int cap = maxb * blk;  // the plain version sees MAXB * BLK tokens
  const int first = split * kSplit;
  // loaded beside lens[b], before the CTA knows whether it has work: the
  // table entry of this thread's token (reading the table is always in
  // bounds; the entry is used only below len) and its share of q
  const int pos = first + tid;
  int entry = 0;
  if (tid < kSplit && pos < cap) entry = tables[(long long)b * maxb + pos / blk];
  const long long gh = bh * g;  // first query row of this (b, kv head)
  float qv[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int idx = tid + k * kThreads;
    qv[k] = idx < g * HD ? to_float(q[gh * HD + idx]) : 0.0f;
  }
  const int len = min(lens[b], cap);
  const int n_live = max(1, (len + kSplit - 1) / kSplit);
  if (split >= n_live) return;  // the same for the whole CTA
  const int n_tok = min(kSplit, len - first);  // <= 0 only for len <= 0

  const long long row_stride = (long long)kvh * HD;           // token to token in a page
  const long long half_stride = (long long)blk * row_stride;  // K half to V half
  if (tid < kSplit)
    row_s[tid] = tid < n_tok ? (long long)entry * slot_stride + (long long)(pos % blk) * row_stride +
                                   (long long)h * HD
                             : -1;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int idx = tid + k * kThreads;
    if (idx < g * HD) q_s[idx / HD][idx % HD] = qv[k] * scale;
  }
  if (tid < g) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  for (int i = tid; i < TILE * GM; i += kThreads) p_s[i / GM][i % GM] = 0.0f;  // rows >= g stay 0
  __syncthreads();

  // K and V rows of tile `tile` into ring stage `stage`, 16 bytes a copy;
  // consecutive threads copy consecutive pieces of a row
  auto load_tile = [&](int tile, int stage) {
    for (int c = tid; c < 2 * TILE * NV; c += kThreads) {
      const int half = c / (TILE * NV);
      const int t = (c / NV) % TILE, piece = c % NV;
      const long long row = row_s[tile * TILE + t];
      const T* src = row < 0 ? kv : kv + row + half * half_stride + piece * VEC;
      const int at = half == 0 ? piece ^ (t & SWZ) : piece;  // K swizzled, V plain
      cp_async16(&kv_s[stage][half][t][at * VEC], src, row < 0 ? 0 : 16);
    }
    cp_async_commit();
  };

  // P . V partial sums of this thread's column pair over its token group,
  // for every query row
  const int dp = tid % PAIRS, tg = tid / PAIRS;
  const bool pv_thread = tg < GROUPS;
  float acc[GM][2];
#pragma unroll
  for (int gi = 0; gi < GM; ++gi) acc[gi][0] = acc[gi][1] = 0.0f;

  const int n_tiles = n_tok > 0 ? (n_tok + TILE - 1) / TILE : 0;
  if (n_tiles > 0) load_tile(0, 0);
  if (n_tiles > 1) load_tile(1, 1);
  const int t = tid % TILE;  // this thread's token in a tile, for the scores
  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & 1;
    if (i == 0 && n_tiles > 1)
      cp_async_wait<1>();  // tile 0 has landed; tile 1 stays in flight
    else
      cp_async_wait<0>();
    __syncthreads();  // tile i is visible, and every thread is done with tile i - 1
    if (i >= 1 && i + 1 < n_tiles) load_tile(i + 1, (i + 1) & 1);  // in flight meanwhile

    // scores, folded into the online softmax by the TILE lanes of each query
    // row; the lanes of a row are tokens, so their q reads are broadcasts
    const bool valid = i * TILE + t < n_tok;
    for (int base = 0; base < g; base += kThreads / TILE) {  // the same trips in every lane
      const int gi = base + tid / TILE;
      const bool row = gi < g;
      float s = -INFINITY;
      if (row && valid) {
        float dot = 0.0f;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          float kf[VEC], qf[VEC];
          smem_vec(&kv_s[stage][0][t][(v ^ (t & SWZ)) * VEC], kf);
#pragma unroll
          for (int e = 0; e < VEC; e += 4) smem_vec(&q_s[gi][v * VEC + e], qf + e);
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot = fmaf(qf[e], kf[e], dot);
        }
        s = softcap > 0.0f ? softcap * tanhf(dot / softcap) : dot;
      }
      const float m_old = row ? m_s[gi] : 0.0f;
      const float m_new = fmaxf(m_old, row_max<TILE>(s));  // finite: the tile's first token is valid
      const float p = expf(s - m_new);
      if (row) p_s[t][gi] = p;
      const float sum = row_sum<TILE>(p);
      if (row && t == 0) {  // every lane of the row has read m_old: the shuffles wait for all
        const float alpha = expf(m_old - m_new);
        a_s[gi] = alpha;
        l_s[gi] = l_s[gi] * alpha + sum;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();

    // acc[g] = acc[g] * alpha[g] + sum over the group's tokens of p[g, t] v[t];
    // rows past len were zero-filled, so 0 * v stays 0
    if (pv_thread) {
#pragma unroll
      for (int gi = 0; gi < GM; ++gi) {
        if (gi < g) {
          const float alpha = a_s[gi];
          acc[gi][0] *= alpha;
          acc[gi][1] *= alpha;
        }
      }
#pragma unroll 2
      for (int tt = tg; tt < TILE; tt += GROUPS) {
        const float2 v = pair(&kv_s[stage][1][tt][2 * dp]);
#pragma unroll
        for (int g4 = 0; g4 < GM; g4 += 4) {
          if (g4 < g) {
            float p[4];
            smem_vec(&p_s[tt][g4], p);  // a broadcast: the warp shares tt
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[g4 + e][0] = fmaf(p[e], v.x, acc[g4 + e][0]);
              acc[g4 + e][1] = fmaf(p[e], v.y, acc[g4 + e][1]);
            }
          }
        }
      }
    }
  }
  __syncthreads();  // the ring is free for the group sums

  // the token groups' sums, added in group order
  if (pv_thread) {
#pragma unroll
    for (int gi = 0; gi < GM; ++gi) {
      if (gi < g) {
        red_s[tg][gi][2 * dp] = acc[gi][0];
        red_s[tg][gi][2 * dp + 1] = acc[gi][1];
      }
    }
  }
  __syncthreads();
  float o[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int idx = tid + k * kThreads;
    o[k] = 0.0f;
    if (idx < g * HD) {
#pragma unroll
      for (int x = 0; x < GROUPS; ++x) o[k] += red_s[x][idx / HD][idx % HD];
      o[k] /= l_s[idx / HD];
    }
  }

  if (n_live == 1) {  // the whole sequence in this CTA: the result itself
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int idx = tid + k * kThreads;
      if (idx < g * HD) out[gh * HD + idx] = from_float<T>(o[k]);
    }
    if (tid < g) {
      m_out[gh + tid] = m_s[tid];
      l_out[gh + tid] = l_s[tid];
    }
    return;
  }

  // this split's partials, then a ticket: the last split of (b, h) merges
  const long long part = (bh * n_split + split) * g;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int idx = tid + k * kThreads;
    if (idx < g * HD) part_o[part * HD + idx] = o[k];
  }
  if (tid < g) {
    part_ml[2 * (part + tid)] = m_s[tid];
    part_ml[2 * (part + tid) + 1] = l_s[tid];
  }
  __syncthreads();
  if (tid == 0) {
    // release: the CTA's partials (ordered before by the barrier) are
    // visible on the card before its ticket; acquire: the last CTA sees
    // every other split's partials
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(tickets + bh)
                 : "memory");
    const bool last = prev == n_live - 1;
    if (last) tickets[bh] = 0;  // ready for the next launch
    last_s = last;
  }
  __syncthreads();
  if (!last_s) return;

  // combine_partials, in split order: m* = max m_j, w_j = l_j exp(m_j - m*),
  // l* = sum w_j, out = sum out_j w_j / l*.  The loads bypass L1 (__ldcg):
  // other SMs wrote the partials.  Each thread loads its outputs of the
  // first PRE splits while a warp per query row finds m* and the weights of
  // 32 splits at a time; every thread then sums its outputs in split order.
  constexpr int PRE = 32 / PER < 1 ? 1 : 32 / PER;  // at most 32 registers
  const float2* ml = reinterpret_cast<const float2*>(part_ml) + bh * n_split * g;
  const float* po = part_o + bh * n_split * g * HD;
  float pre[PER][PRE];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int idx = tid + k * kThreads;
#pragma unroll
    for (int j = 0; j < PRE; ++j)
      pre[k][j] = idx < g * HD && j < n_live ? __ldcg(po + (long long)j * g * HD + idx) : 0.0f;
  }
  for (int gi = warp; gi < g; gi += kThreads / 32) {
    const float2 head = lane < n_live ? __ldcg(&ml[lane * g + gi]) : make_float2(-INFINITY, 0.0f);
    float mx = head.x;
    for (int j = 32 + lane; j < n_live; j += 32) mx = fmaxf(mx, __ldcg(&ml[j * g + gi]).x);
    mx = row_max(mx);
    w_s[gi][lane] = lane < n_live ? head.y * expf(head.x - mx) : 0.0f;
    if (lane == 0) m_s[gi] = mx;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) o[k] = 0.0f;
  float l_star = 0.0f;  // threads tid < g: query row tid's
  for (int j0 = 0; j0 < n_live; j0 += 32) {
    if (j0 > 0) {
      __syncthreads();  // every thread is done with the last 32 weights
      for (int gi = warp; gi < g; gi += kThreads / 32) {
        const int j = j0 + lane;
        const float2 mlj = j < n_live ? __ldcg(&ml[j * g + gi]) : make_float2(-INFINITY, 0.0f);
        w_s[gi][lane] = j < n_live ? mlj.y * expf(mlj.x - m_s[gi]) : 0.0f;
      }
    }
    __syncthreads();
    const int nj = min(32, n_live - j0);
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int idx = tid + k * kThreads;
      if (idx < g * HD) {
        const float* wr = w_s[idx / HD];
        int jj = 0;
        if (j0 == 0) {
#pragma unroll
          for (int j = 0; j < PRE; ++j)
            if (j < nj) o[k] = fmaf(pre[k][j], wr[j], o[k]);
          jj = min(PRE, nj);
        }
        for (; jj < nj; ++jj)
          o[k] = fmaf(__ldcg(po + (long long)(j0 + jj) * g * HD + idx), wr[jj], o[k]);
      }
    }
    if (tid < g)
      for (int jj = 0; jj < nj; ++jj) l_star += w_s[tid][jj];
  }
  if (tid < g) {
    m_out[gh + tid] = m_s[tid];
    l_out[gh + tid] = l_star;
    l_s[tid] = l_star;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int idx = tid + k * kThreads;
    if (idx < g * HD) out[gh * HD + idx] = from_float<T>(o[k] / l_s[idx / HD]);
  }
}

#define LEAP_PAGED_DECODE_PARAMS                                                              \
  const T *__restrict__ q, const T *__restrict__ kv, const int *__restrict__ tables,          \
      const int *__restrict__ lens, T *__restrict__ out, float *__restrict__ m_out,           \
      float *__restrict__ l_out, float *__restrict__ part_o, float *__restrict__ part_ml,     \
      int *__restrict__ tickets, int kvh, int g, int blk, int maxb, int n_split,              \
      long long slot_stride, float softcap, float scale
#define LEAP_PAGED_DECODE_ARGS                                                                  \
  q, kv, tables, lens, out, m_out, l_out, part_o, part_ml, tickets, kvh, g, blk, maxb, n_split, \
      slot_stride, softcap, scale

// G <= 4 (granite: 32 query heads over 8 kv heads): ptxas's own register
// budget keeps every value in registers and several CTAs on each SM
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) paged_decode_g4_kernel(LEAP_PAGED_DECODE_PARAMS) {
  paged_decode_split<T, HD, 4>(LEAP_PAGED_DECODE_ARGS);
}

// G in 5..16 (qwen2_7b: 7): without a floor on CTAs an SM, ptxas spills a
// few bytes to reach a step of occupancy; with it, nothing spills
template <typename T, int HD, int GM>
__global__ void __launch_bounds__(kThreads, 1) paged_decode_wide_kernel(LEAP_PAGED_DECODE_PARAMS) {
  paged_decode_split<T, HD, GM>(LEAP_PAGED_DECODE_ARGS);
}

#undef LEAP_PAGED_DECODE_PARAMS
#undef LEAP_PAGED_DECODE_ARGS

template <typename T, int HD, int GM>
int launch(const void* q, const void* kv, const void* tables, const void* lens, void* out,
           void* m, void* l, void* part_o, void* part_ml, void* tickets, long long b,
           long long kvh, long long g, long long blk, long long maxb, long long n_split,
           long long slot_stride, float softcap, float scale, cudaStream_t stream) {
  const dim3 grid((unsigned)(b * kvh), (unsigned)n_split);
  const auto kernel = [] {
    if constexpr (GM == 4)
      return paged_decode_g4_kernel<T, HD>;
    else
      return paged_decode_wide_kernel<T, HD, GM>;
  }();
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<T*>(out), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(part_o), static_cast<float*>(part_ml),
      static_cast<int*>(tickets), (int)kvh, (int)g, (int)blk, (int)maxb, (int)n_split,
      slot_stride, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, KVH, G, HD] and the pool share one dtype: 0 = float32, 1 = bfloat16.
// tables [B, MAXB] and lens [B] are int32, lens >= 1; every table entry below
// ceil(lens / BLK) is a valid slot.  out [B, KVH, G, HD] in q's dtype, m and
// l [B, KVH, G] float32.  Scratch: part_o [B * KVH, n_split, G, HD] and
// part_ml [B * KVH, n_split, G, 2] float32, any contents; tickets [B * KVH]
// int32, zero, which the kernel leaves zero.  The grid is (B * KVH,
// n_split); n_split splits of 64 tokens must cover MAXB * BLK.  Every
// pointer 16-byte aligned where it is read as vectors (q, kv, part_ml);
// slot_stride in elements.  Returns a cudaError_t.
extern "C" int leap_paged_decode(const void* q, const void* kv, const void* tables,
                                 const void* lens, void* out, void* m, void* l, void* part_o,
                                 void* part_ml, void* tickets, long long b, long long kvh,
                                 long long g, long long hd, long long blk, long long maxb,
                                 long long n_split, long long slot_stride, float softcap,
                                 float scale, int dtype, void* stream) {
  if (b <= 0 || kvh <= 0) return 0;
  if (g < 1 || g > kMaxG || blk < 1 || maxb < 1 || b * kvh > 0x7fffffffLL ||
      maxb * blk > 0x7fffffffLL - kSplit || n_split * kSplit < maxb * blk ||
      n_split > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // G <= 4 takes the small instance, any larger G the one sized for 16
  const int gm = g <= 4 ? 4 : 16;
#define LEAP_PAGED_DECODE_GM(T, HD, GM)                                                        \
  if (gm == GM)                                                                                \
    return launch<T, HD, GM>(q, kv, tables, lens, out, m, l, part_o, part_ml, tickets, b, kvh, \
                             g, blk, maxb, n_split, slot_stride, softcap, scale, s);
#define LEAP_PAGED_DECODE_CASE(CODE, T, HD) \
  if (dtype == CODE && hd == HD) {          \
    LEAP_PAGED_DECODE_GM(T, HD, 4)          \
    LEAP_PAGED_DECODE_GM(T, HD, 16)         \
  }
  LEAP_PAGED_DECODE_CASE(0, float, 16)
  LEAP_PAGED_DECODE_CASE(0, float, 64)
  LEAP_PAGED_DECODE_CASE(0, float, 128)
  LEAP_PAGED_DECODE_CASE(1, __nv_bfloat16, 16)
  LEAP_PAGED_DECODE_CASE(1, __nv_bfloat16, 64)
  LEAP_PAGED_DECODE_CASE(1, __nv_bfloat16, 128)
#undef LEAP_PAGED_DECODE_CASE
#undef LEAP_PAGED_DECODE_GM
  return (int)cudaErrorInvalidValue;
}
