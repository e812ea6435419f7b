// RG-LRU linear-recurrence scan on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/lru_scan.py::lru_scan_pallas:
//   h_t = a_t * h_{t-1} + b_t   over t = 0 .. T-1, from h_{-1} = h0,
// for a, b, out [B, T, R] (float32 or bfloat16, out in the input type) and
// h0 [B, R] float32 (the wrapper casts it, as the Pallas kernel does).
//
// Bound: bytes.  The function reads a and b once and writes out once, and
// does 2 flops an element.  The recurrence is sequential in t and
// independent across (b, r).  One thread owns one channel and carries h in
// a float32 register through all T steps, in order: each step rounds the
// multiply and the add separately (__fmul_rn, __fadd_rn: no FMA
// contraction), the order of the plain version, so float32 results equal
// it bit for bit and bfloat16 outputs round the same float32 value to
// nearest even.  No atomics: a run repeats itself bit for bit.  A chunked
// two-pass scan over T would fill the card another way, but the carry into
// a chunk would then be a product of decays plus a sum, a different
// rounding from the sequential chain, and the float32 output would no
// longer equal the plain version's.  So this kernel splits channels, never
// time.
//
// Why not registers.  At batch 1 (recurrentgemma_9b's 32k prefill, [1,
// 32768, 4096]) there are 4,096 chains, 31 an SM.  Moving 3.35 TB/s over a
// load latency of about a microsecond needs some 3 MB in flight, 25 KiB an
// SM: some 200 values a thread if each thread held its own loads in
// registers.  The earlier design (one thread a channel, 16 loads in flight
// in registers, 256 threads a CTA) put 16 CTAs on 16 SMs and ran at about
// 15% of the bound.
//
// The design.  A CTA owns tiles of (batch row, group of kCh channels), kCh
// = 32 to 256, one thread a channel.  The wrapper's plan (kernels/
// lru_scan.py plan_lru_scan) picks kCh and a grid of one CTA an SM:
// [1, 32768, 4096] runs 128 CTAs of one warp, [8, 2048, 4096] 128 CTAs of
// eight.  A persistent CTA walks an even split of the tiles, and each tile
// through time a stage at a time: a stage holds `rows` time rows of a and
// of b for the CTA's channels, about 32 KiB.  The stages live in a ring of
// 4 slots in shared memory (128 KiB, so one CTA holds an SM).  Copy route:
//   * tma: thread 0 issues the copies and computes too (no producer warp).
//     Before the CTA computes stage s it issues stage s + 2 into the slot
//     of stage s - 2: two 3-D tensor-map loads ([B, T, R] boxes of 1 x
//     rows x kCh, one for a and one for b) that complete on the slot's
//     mbarrier, with an L2 evict-first policy, since a and b are read once;
//     64 KiB of a and b are in flight an SM.  Each thread writes h_t over
//     a_t in the slot, and thread 0 stores the slot's box of h to out with
//     one tensor-map store (after a proxy fence and __syncthreads); the
//     stage s + 2 load waits until the store of stage s - 2 has read the
//     slot.  The tensor maps zero fill a load past the ragged R edge or the
//     tail of T, and a store writes nothing there.  They are encoded on the
//     host with cuTensorMapEncodeTiled, taken through
//     cudaGetDriverEntryPoint(ByVersion), so the library needs no -lcuda.
//     The route needs a, b, out and the row stride R * itemsize on 16
//     bytes.
//   * narrow: any alignment.  Each thread loads its own channel's rows of
//     the coming stage into the ring with streaming loads, zero past the
//     edges, then computes the current stage and stores its outputs with
//     streaming stores: a stage's loads are in flight together, one stage
//     at a time.
// The chain reads its rows from shared memory into registers eight at a
// time, the loads of the next eight issued before the chain of these runs,
// so a step costs about its multiply and add latency (some 8 cycles: 0.13
// ms for 32,768 steps, under the 0.48 ms byte bound of [1, 32768, 4096]
// f32).  scripts/tune_lru.py times the ring's variants.
//
// The backward (leap_lru_scan_bwd) is the adjoint of the same scan, which
// the JAX package gets from autodiff of its scan and has no TPU kernel for:
// from lambda_T = 0,
//   lambda_t = g_t + a_{t+1} * lambda_{t+1},  db_t = lambda_t,
//   da_t = lambda_t * h_{t-1} (h_{-1} = h0),  dh0 = a_0 * lambda_0,
// each multiply and add rounded on its own, in that order, with a float32
// carry: bit for bit the plain version (ref.lru_scan_bwd_ref).  Bound:
// bytes (g, a and h read once, da and db written once: five [B, T, R]
// tensors, 3 flops an element).  It is the forward's design walked
// backwards through time (plan: kernels/lru_scan.py plan_lru_scan_bwd): the
// same channel groups, one CTA an SM, and a 4-slot ring whose stage holds
// three boxes, rows [t0, t0 + rows) of g and a and rows [t0 - 1, t0 + rows -
// 1) of h, so that row k of h's box is the h_{t-1} that da_t needs.  Stage
// j of a tile starts at t0 = (steps - 1 - j) * rows: the ragged stage, at
// the top of time, is walked first, and the last one starts at t0 = 0,
// where h's box starts at t = -1, a row the tensor map fills with zeros
// and the kernel replaces by h0.  Each thread runs its channel's chain down
// the stage's rows, eight rows read ahead into registers, and carries
// lambda and a_{t+1} in registers from stage to stage; it writes db_t over
// g_t and da_t over h_{t-1} in the slot, and two tensor-map stores send
// both boxes out at t0.  dh0 is a plain store when a tile's walk ends.
// One thread a channel with its steps loaded ahead in its own registers, 256
// threads a CTA, would put a tensor-parallel position's [1, 1024, 2048] on 8
// SMs; this grid puts it on 64, 54% of its byte bound on an H100
// (scripts/tune_lru.py).

#include <cuda.h>  // CUtensorMap and the encoder's types; nothing of libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <initializer_list>

namespace {

// -- the forward: channel groups fed by a shared-memory ring ---------------------

constexpr int kMaxRows = 256;        // a tensor-map box dimension
constexpr int kMaxStages = 32;
constexpr int kAlign = 128;          // the ring's start and each box's stride
constexpr int kMaxSmem = 232448;     // 227 KB: what a block may opt in to
constexpr int kMaxDevices = 64;

struct Plan {
  long long n_b, n_t, n_r;
  long long groups;  // channel groups a batch row
  long long tiles;   // n_b * groups
  long long steps;   // stages a tile takes through time
  int rows;          // time rows a stage
  int stages;        // slots in the ring
  int box_stride;    // bytes from one box of a slot to the next (box bytes, rounded to kAlign)
};

template <typename T>
__device__ __forceinline__ T ldcs(const T* p);
template <>
__device__ __forceinline__ float ldcs(const float* p) { return __ldcs(p); }
template <>
__device__ __forceinline__ __nv_bfloat16 ldcs(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p)));
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero() { return __ushort_as_bfloat16(0); }

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T narrow_to(float v);
template <>
__device__ __forceinline__ float narrow_to(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow_to(float v) { return __float2bfloat16_rn(v); }

// a streaming store (st.global.cs: evict first), for the narrow route
__device__ __forceinline__ void stream_out(float* p, float v) { __stcs(p, v); }

__device__ __forceinline__ void stream_out(__nv_bfloat16* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p), __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// a and b are read once: L2 keeps them last
__device__ __forceinline__ unsigned long long read_once_policy() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// box (c0 channel, c1 time, c2 batch) of the tensor map into shared memory at
// dst, completing on the mbarrier at bar
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, unsigned bar, unsigned long long policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%2, %3, %4}], [%5], %6;"
      :: "r"(dst), "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(bar), "l"(policy)
      : "memory");
}

// the box at src in shared memory to (c0 channel, c1 time, c2 batch) of the
// tensor map, in the open bulk group; elements past the tensor's edges are
// not written
__device__ __forceinline__ void tma_store(const CUtensorMap* map, unsigned src, int c0, int c1,
                                          int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];"
               :: "l"(reinterpret_cast<unsigned long long>(map)), "r"(src), "r"(c0), "r"(c1),
                  "r"(c2)
               : "memory");
}

// closes the bulk group of the stores issued since the last one
__device__ __forceinline__ void commit_stores() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Waits for the phase of the mbarrier at bar; a copy that never lands (a
// transaction count the copies do not meet) traps after some 10 s instead
// of holding the card.
__device__ __forceinline__ void wait_landed(unsigned bar, unsigned parity) {
  unsigned done = 0;
  const long long start = clock64();
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && clock64() - start > 20000000000LL) __trap();
  }
}

// Where stage j of a CTA's walk lies: tile first + j / steps (its batch row
// and channel group), time step j % steps, ring slot j % stages and the
// slot's barrier parity.  next() moves to stage j + 1 without a division.
struct Cursor {
  long long batch, grp, tt;
  int slot;
  unsigned parity;

  __device__ __forceinline__ Cursor(long long first, const Plan& p)
      : batch(first / p.groups), grp(first % p.groups), tt(0), slot(0), parity(0) {}

  __device__ __forceinline__ void next(const Plan& p) {
    if (++tt == p.steps) {
      tt = 0;
      if (++grp == p.groups) {
        grp = 0;
        ++batch;
      }
    }
    if (++slot == p.stages) {
      slot = 0;
      parity ^= 1u;
    }
  }
};

// The chain over `rows` rows of one channel: a_k and b_k at sa[k * kCh] and
// sb[k * kCh] in shared memory, h_k handed to put(k, h_k).  Rows go into
// registers kGroup at a time, in two sets that take turns: the loads of the
// next group go out before the chain of this one runs, so the chain does
// not wait on shared memory.  Past the last whole group the loads read that
// group again (in bounds, unused).
constexpr int kGroup = 8;

template <typename T, int kCh, typename Put>
__device__ __forceinline__ float chain(const T* sa, const T* sb, int rows, float h, Put put) {
  const int whole = rows / kGroup;
  float a0[kGroup], b0[kGroup], a1[kGroup], b1[kGroup];
  auto fetch = [&](int grp, float* av, float* bv) {
    const int k0 = (grp < whole ? grp : whole - 1) * kGroup;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      av[i] = widen(sa[(k0 + i) * kCh]);
      bv[i] = widen(sb[(k0 + i) * kCh]);
    }
  };
  auto run = [&](int grp, const float* av, const float* bv) {
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      h = __fadd_rn(__fmul_rn(av[i], h), bv[i]);
      put(grp * kGroup + i, h);
    }
  };
  if (whole > 0) fetch(0, a0, b0);
  for (int grp = 0; grp < whole; grp += 2) {
    fetch(grp + 1, a1, b1);
    run(grp, a0, b0);
    if (grp + 1 == whole) break;
    fetch(grp + 2, a0, b0);
    run(grp + 1, a1, b1);
  }
  for (int k = whole * kGroup; k < rows; ++k) {
    h = __fadd_rn(__fmul_rn(widen(sa[k * kCh]), h), widen(sb[k * kCh]));
    put(k, h);
  }
  return h;
}

// kCh channels a CTA, one a thread; see the note at the head of the file
template <typename T, bool kTma, int kCh>
__global__ void __launch_bounds__(kCh)
lru_scan_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                const __grid_constant__ CUtensorMap map_out, const T* __restrict__ a,
                const T* __restrict__ b, const float* __restrict__ h0, T* __restrict__ out,
                const Plan p) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = (unsigned)__cvta_generic_to_shared(smem_raw);
  const unsigned ring = (raw + kAlign - 1) & ~(unsigned)(kAlign - 1);
  unsigned char* const ring_ptr = smem_raw + (ring - raw);
  const int slot_bytes = 2 * p.box_stride;
  const unsigned bars = ring + (unsigned)(p.stages * slot_bytes);
  const int me = threadIdx.x;
  const bool producer = kTma && me == 0;
  const CUtensorMap* const maps[2] = {&map_a, &map_b};
  // this CTA's tiles: [first, first + n), an even split of all of them
  const long long g = gridDim.x, c = blockIdx.x, q = p.tiles / g, rem = p.tiles % g;
  const long long first = c * q + (c < rem ? c : rem), n = q + (c < rem ? 1 : 0);
  const long long seq = n * p.steps;  // stages this CTA walks
  unsigned long long policy = 0;
  if (producer) {
    policy = read_once_policy();
#pragma unroll
    for (int i = 0; i < 2; ++i)
      asm volatile("prefetch.tensormap [%0];"
                   :: "l"(reinterpret_cast<unsigned long long>(maps[i])) : "memory");
    asm volatile("prefetch.tensormap [%0];"
                 :: "l"(reinterpret_cast<unsigned long long>(&map_out)) : "memory");
    for (int s = 0; s < p.stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bars + 8 * s), "r"(1)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  Cursor ahead_at(first, p), at(first, p);  // the next stage to issue; the stage to compute
  auto issue = [&]() {  // stage ahead_at into its slot
    const Cursor& u = ahead_at;
    const long long t0 = u.tt * p.rows;
    if constexpr (kTma) {
      if (producer) {
        const unsigned dst = ring + (unsigned)(u.slot * slot_bytes), bar = bars + 8 * u.slot;
        const unsigned bytes = 2u * (unsigned)(p.rows * kCh * (int)sizeof(T));
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(bar), "r"(bytes) : "memory");
#pragma unroll
        for (int i = 0; i < 2; ++i)
          tma_load(dst + i * p.box_stride, maps[i], (int)(u.grp * kCh), (int)t0, (int)u.batch,
                   bar, policy);
      }
    } else {
      T* sa = reinterpret_cast<T*>(ring_ptr + u.slot * slot_bytes) + me;
      T* sb = reinterpret_cast<T*>(ring_ptr + u.slot * slot_bytes + p.box_stride) + me;
      const long long ch = u.grp * kCh + me;
      const int rows = (int)(p.n_t - t0 < p.rows ? p.n_t - t0 : p.rows);
      const T* pa = a + (u.batch * p.n_t + t0) * p.n_r + ch;
      const T* pb = b + (u.batch * p.n_t + t0) * p.n_r + ch;
      const bool live = ch < p.n_r;
#pragma unroll 8
      for (int k = 0; k < p.rows; ++k) {
        const bool in = live && k < rows;
        sa[k * kCh] = in ? ldcs(pa + k * p.n_r) : zero<T>();
        sb[k * kCh] = in ? ldcs(pb + k * p.n_r) : zero<T>();
      }
    }
    ahead_at.next(p);
  };

  // stages in flight while one is computed; on the tma route one more slot
  // holds the stage whose store may still be reading it
  const long long ahead = kTma ? p.stages - 2 : p.stages - 1;
  for (long long j = 0; j < seq && j < ahead; ++j) issue();
  float h = 0.0f;
  for (long long j = 0; j < seq; ++j) {
    if (j + ahead < seq) {
      // the slot of stage j - 2 (tma) or j - 1 (narrow); the tma store of
      // stage j - 2, all but the latest bulk group, must have read it
      if (producer) asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      issue();
    }
    const long long t0 = at.tt * p.rows, ch = at.grp * kCh + me;
    const int rows = (int)(p.n_t - t0 < p.rows ? p.n_t - t0 : p.rows);
    T* sa = reinterpret_cast<T*>(ring_ptr + at.slot * slot_bytes) + me;
    const T* sb = reinterpret_cast<const T*>(ring_ptr + at.slot * slot_bytes + p.box_stride) + me;
    if constexpr (kTma) wait_landed(bars + 8 * at.slot, at.parity);
    if (ch < p.n_r) {
      if (at.tt == 0) h = h0[at.batch * p.n_r + ch];
      if constexpr (kTma) {
        // h_k takes a_k's place in the slot, read just before
        h = chain<T, kCh>(sa, sb, rows, h, [&](int k, float v) { sa[k * kCh] = narrow_to<T>(v); });
      } else {
        T* o = out + (at.batch * p.n_t + t0) * p.n_r + ch;
        h = chain<T, kCh>(sa, sb, rows, h,
                          [&](int k, float v) { stream_out(o + (long long)k * p.n_r, v); });
      }
    }
    if constexpr (kTma) {
      // the rows of h go out as one box; past R and T nothing is written
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (producer) {
        tma_store(&map_out, ring + (unsigned)(at.slot * slot_bytes), (int)(at.grp * kCh), (int)t0,
                  (int)at.batch);
        commit_stores();
      }
    } else {
      __syncthreads();  // every thread is done with this slot before it is refilled
    }
    at.next(p);
  }
  if (producer) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// cuTensorMapEncodeTiled, taken from the driver at run time
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// [n_b, n_t, n_r] elements of T at base, in boxes of 1 x rows x n_ch; OOB
// elements read as zero
template <typename T>
bool encode(CUtensorMap* map, const void* base, const Plan& p, int n_ch) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)p.n_r, (cuuint64_t)p.n_t, (cuuint64_t)p.n_b};
  const cuuint64_t strides[2] = {(cuuint64_t)(p.n_r * (long long)sizeof(T)),
                                 (cuuint64_t)(p.n_t * p.n_r * (long long)sizeof(T))};
  const cuuint32_t box[3] = {(cuuint32_t)n_ch, (cuuint32_t)p.rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, bool kTma, int kCh>
int launch(const void* a, const void* b, const void* h0, void* out, const Plan& p, int grid,
           int smem, cudaStream_t stream) {
  static bool opted[kMaxDevices];  // per device and instance: the opt-in to kMaxSmem
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(lru_scan_kernel<T, kTma, kCh>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted[dev] = true;
  }
  CUtensorMap maps[3] = {};
  if (kTma && !(encode<T>(&maps[0], a, p, kCh) && encode<T>(&maps[1], b, p, kCh) &&
                encode<T>(&maps[2], out, p, kCh)))
    return (int)cudaErrorInvalidValue;
  lru_scan_kernel<T, kTma, kCh><<<grid, kCh, smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const float*>(h0), static_cast<T*>(out), p);
  return (int)cudaGetLastError();
}

template <typename T, bool kTma>
int launch(const void* a, const void* b, const void* h0, void* out, const Plan& p, int warps,
           int grid, int smem, cudaStream_t stream) {
  switch (warps) {
    case 1: return launch<T, kTma, 32>(a, b, h0, out, p, grid, smem, stream);
    case 2: return launch<T, kTma, 64>(a, b, h0, out, p, grid, smem, stream);
    case 4: return launch<T, kTma, 128>(a, b, h0, out, p, grid, smem, stream);
    case 8: return launch<T, kTma, 256>(a, b, h0, out, p, grid, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// -- the backward: the same ring, walked down through time ---------------------

// The adjoint chain down rows rows - 1 .. 0 of one channel's stage: g_k, a_k
// and h_{k-1} at sg[k * kCh], sa[k * kCh] and sh[k * kCh], h_row0 in place
// of row 0's h; lam and a_next carry lambda and a of the row above in and
// out; lambda_k and da_k go to put(k, lambda_k, da_k).  Rows above the last
// whole group of kGroup run first, one at a time; then the whole groups go
// into registers a group at a time, in two sets that take turns, the loads
// of the group below issued before the chain of this one runs (below group
// 0 the loads read group 0 again: in bounds, unused).
template <typename T, int kCh, typename Put>
__device__ __forceinline__ void chain_rev(const T* sg, const T* sa, const T* sh, int rows,
                                          float h_row0, float& lam, float& a_next, Put put) {
  const int whole = rows / kGroup;
  for (int k = rows - 1; k >= whole * kGroup; --k) {
    const float hv = k == 0 ? h_row0 : widen(sh[k * kCh]);
    lam = __fadd_rn(widen(sg[k * kCh]), __fmul_rn(a_next, lam));
    put(k, lam, __fmul_rn(lam, hv));
    a_next = widen(sa[k * kCh]);
  }
  float g0[kGroup], a0[kGroup], h0v[kGroup], g1[kGroup], a1[kGroup], h1v[kGroup];
  auto fetch = [&](int grp, float* gv, float* av, float* hv) {
    const int k0 = (grp > 0 ? grp : 0) * kGroup;
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      gv[i] = widen(sg[(k0 + i) * kCh]);
      av[i] = widen(sa[(k0 + i) * kCh]);
      hv[i] = widen(sh[(k0 + i) * kCh]);
    }
    if (k0 == 0) hv[0] = h_row0;
  };
  auto run = [&](int grp, const float* gv, const float* av, const float* hv) {
#pragma unroll
    for (int i = kGroup - 1; i >= 0; --i) {
      lam = __fadd_rn(gv[i], __fmul_rn(a_next, lam));
      put(grp * kGroup + i, lam, __fmul_rn(lam, hv[i]));
      a_next = av[i];
    }
  };
  if (whole > 0) fetch(whole - 1, g0, a0, h0v);
  for (int grp = whole - 1; grp >= 0; grp -= 2) {
    fetch(grp - 1, g1, a1, h1v);
    run(grp, g0, a0, h0v);
    if (grp == 0) break;
    fetch(grp - 2, g0, a0, h0v);
    run(grp - 1, g1, a1, h1v);
  }
}

// kCh channels a CTA, one a thread; see the note at the head of the file.
// A slot holds g's box, a's and h's, each box_stride bytes apart.
template <typename T, bool kTma, int kCh>
__global__ void __launch_bounds__(kCh)
lru_scan_bwd_kernel(const __grid_constant__ CUtensorMap map_g,
                    const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_h,
                    const __grid_constant__ CUtensorMap map_da,
                    const __grid_constant__ CUtensorMap map_db, const T* __restrict__ g,
                    const T* __restrict__ a, const T* __restrict__ h,
                    const float* __restrict__ h0, T* __restrict__ da, T* __restrict__ db,
                    float* __restrict__ dh0, const Plan p) {
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = (unsigned)__cvta_generic_to_shared(smem_raw);
  const unsigned ring = (raw + kAlign - 1) & ~(unsigned)(kAlign - 1);
  unsigned char* const ring_ptr = smem_raw + (ring - raw);
  const int slot_bytes = 3 * p.box_stride;
  const unsigned bars = ring + (unsigned)(p.stages * slot_bytes);
  const int me = threadIdx.x;
  const bool producer = kTma && me == 0;
  const CUtensorMap* const maps[5] = {&map_g, &map_a, &map_h, &map_da, &map_db};
  const long long gr = gridDim.x, c = blockIdx.x, q = p.tiles / gr, rem = p.tiles % gr;
  const long long first = c * q + (c < rem ? c : rem), n = q + (c < rem ? 1 : 0);
  const long long seq = n * p.steps;  // stages this CTA walks
  unsigned long long policy = 0;
  if (producer) {
    policy = read_once_policy();
#pragma unroll
    for (int i = 0; i < 5; ++i)
      asm volatile("prefetch.tensormap [%0];"
                   :: "l"(reinterpret_cast<unsigned long long>(maps[i])) : "memory");
    for (int s = 0; s < p.stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bars + 8 * s), "r"(1)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  Cursor ahead_at(first, p), at(first, p);  // the next stage to issue; the stage to compute
  auto issue = [&]() {  // stage ahead_at into its slot
    const Cursor& u = ahead_at;
    const long long t0 = (p.steps - 1 - u.tt) * p.rows;
    if constexpr (kTma) {
      if (producer) {
        const unsigned dst = ring + (unsigned)(u.slot * slot_bytes), bar = bars + 8 * u.slot;
        // h's box at t0 - 1 lies wholly before the tensor only when a stage
        // is one row at t0 = 0; it is not loaded then (its row is h0's)
        const bool load_h = t0 + p.rows - 1 > 0;
        const unsigned box = (unsigned)(p.rows * kCh * (int)sizeof(T));
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(bar), "r"((load_h ? 3u : 2u) * box) : "memory");
        const int c0 = (int)(u.grp * kCh), b0 = (int)u.batch;
        tma_load(dst, &map_g, c0, (int)t0, b0, bar, policy);
        tma_load(dst + p.box_stride, &map_a, c0, (int)t0, b0, bar, policy);
        if (load_h) tma_load(dst + 2 * p.box_stride, &map_h, c0, (int)t0 - 1, b0, bar, policy);
      }
    } else {
      unsigned char* const slot = ring_ptr + u.slot * slot_bytes;
      T* sg = reinterpret_cast<T*>(slot) + me;
      T* sa = reinterpret_cast<T*>(slot + p.box_stride) + me;
      T* sh = reinterpret_cast<T*>(slot + 2 * p.box_stride) + me;
      const long long ch = u.grp * kCh + me;
      const int rows = (int)(p.n_t - t0 < p.rows ? p.n_t - t0 : p.rows);
      const long long off = (u.batch * p.n_t + t0) * p.n_r + ch;  // element (batch, t0, ch)
      const bool live = ch < p.n_r;
#pragma unroll 8
      for (int k = 0; k < p.rows; ++k) {
        const bool in = live && k < rows;
        sg[k * kCh] = in ? ldcs(g + off + k * p.n_r) : zero<T>();
        sa[k * kCh] = in ? ldcs(a + off + k * p.n_r) : zero<T>();
        sh[k * kCh] = in && t0 + k > 0 ? ldcs(h + off + (k - 1) * p.n_r) : zero<T>();
      }
    }
    ahead_at.next(p);
  };

  // as in the forward: stages in flight while one is computed, one more
  // slot on the tma route for the stage whose stores may still read it
  const long long ahead = kTma ? p.stages - 2 : p.stages - 1;
  for (long long j = 0; j < seq && j < ahead; ++j) issue();
  float lam = 0.0f, a_next = 0.0f;
  for (long long j = 0; j < seq; ++j) {
    if (j + ahead < seq) {
      if (producer) asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      issue();
    }
    const long long t0 = (p.steps - 1 - at.tt) * p.rows, ch = at.grp * kCh + me;
    const int rows = (int)(p.n_t - t0 < p.rows ? p.n_t - t0 : p.rows);
    unsigned char* const slot = ring_ptr + at.slot * slot_bytes;
    T* sg = reinterpret_cast<T*>(slot) + me;
    const T* sa = reinterpret_cast<const T*>(slot + p.box_stride) + me;
    T* sh = reinterpret_cast<T*>(slot + 2 * p.box_stride) + me;
    if constexpr (kTma) wait_landed(bars + 8 * at.slot, at.parity);
    if (ch < p.n_r) {
      if (at.tt == 0) lam = a_next = 0.0f;  // lambda_T and a_T: nothing past the end
      const float h_row0 = t0 == 0 ? h0[at.batch * p.n_r + ch] : widen(sh[0]);
      if constexpr (kTma) {
        // db_k over g_k and da_k over h_{k-1} in the slot, each read just before
        chain_rev<T, kCh>(sg, sa, sh, rows, h_row0, lam, a_next, [&](int k, float l, float d) {
          sg[k * kCh] = narrow_to<T>(l);
          sh[k * kCh] = narrow_to<T>(d);
        });
      } else {
        const long long off = (at.batch * p.n_t + t0) * p.n_r + ch;
        chain_rev<T, kCh>(sg, sa, sh, rows, h_row0, lam, a_next, [&](int k, float l, float d) {
          stream_out(db + off + (long long)k * p.n_r, l);
          stream_out(da + off + (long long)k * p.n_r, d);
        });
      }
      if (at.tt == p.steps - 1) dh0[at.batch * p.n_r + ch] = __fmul_rn(a_next, lam);
    }
    if constexpr (kTma) {
      // db's rows and da's go out as two boxes at t0, one bulk group
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncthreads();
      if (producer) {
        const unsigned src = ring + (unsigned)(at.slot * slot_bytes);
        const int c0 = (int)(at.grp * kCh), b0 = (int)at.batch;
        tma_store(&map_db, src, c0, (int)t0, b0);
        tma_store(&map_da, src + 2 * p.box_stride, c0, (int)t0, b0);
        commit_stores();
      }
    } else {
      __syncthreads();  // every thread is done with this slot before it is refilled
    }
    at.next(p);
  }
  if (producer) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <typename T, bool kTma, int kCh>
int launch_bwd(const void* g, const void* a, const void* h, const void* h0, void* da, void* db,
               void* dh0, const Plan& p, int grid, int smem, cudaStream_t stream) {
  static bool opted[kMaxDevices];  // per device and instance: the opt-in to kMaxSmem
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(lru_scan_bwd_kernel<T, kTma, kCh>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted[dev] = true;
  }
  CUtensorMap maps[5] = {};
  const void* bases[5] = {g, a, h, da, db};
  for (int i = 0; kTma && i < 5; ++i)
    if (!encode<T>(&maps[i], bases[i], p, kCh)) return (int)cudaErrorInvalidValue;
  lru_scan_bwd_kernel<T, kTma, kCh><<<grid, kCh, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], static_cast<const T*>(g),
      static_cast<const T*>(a), static_cast<const T*>(h), static_cast<const float*>(h0),
      static_cast<T*>(da), static_cast<T*>(db), static_cast<float*>(dh0), p);
  return (int)cudaGetLastError();
}

template <typename T, bool kTma>
int launch_bwd(const void* g, const void* a, const void* h, const void* h0, void* da, void* db,
               void* dh0, const Plan& p, int warps, int grid, int smem, cudaStream_t stream) {
  switch (warps) {
    case 1: return launch_bwd<T, kTma, 32>(g, a, h, h0, da, db, dh0, p, grid, smem, stream);
    case 2: return launch_bwd<T, kTma, 64>(g, a, h, h0, da, db, dh0, p, grid, smem, stream);
    case 4: return launch_bwd<T, kTma, 128>(g, a, h, h0, da, db, dh0, p, grid, smem, stream);
    case 8: return launch_bwd<T, kTma, 256>(g, a, h, h0, da, db, dh0, p, grid, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The plan's numbers checked again (kernels/lru_scan.py _plan): into p and
// the dynamic shared memory in smem, or false for what the kernels cannot
// run.  `boxes` input boxes a stage: 2 forward, 3 backward.
bool make_plan(long long n_b, long long n_t, long long n_r, int dtype, int warps, int rows,
               int stages, int grid, int tma, int boxes, Plan* p, int* smem) {
  const long long max_coord = 0x7fffffffLL;
  if (n_b < 1 || n_t < 1 || n_r < 1 || n_b > max_coord || n_t > max_coord || n_r > max_coord)
    return false;
  if (dtype != 0 && dtype != 1) return false;
  if ((warps != 1 && warps != 2 && warps != 4 && warps != 8) || rows < 1 || rows > kMaxRows ||
      stages < (tma ? 3 : 2) || stages > kMaxStages)
    return false;
  const long long itemsize = dtype == 0 ? 4 : 2, n_ch = 32LL * warps;
  p->n_b = n_b;
  p->n_t = n_t;
  p->n_r = n_r;
  p->groups = (n_r + n_ch - 1) / n_ch;
  p->tiles = n_b * p->groups;
  p->rows = rows;
  p->steps = (n_t + rows - 1) / rows;
  p->stages = stages;
  p->box_stride = (int)((rows * n_ch * itemsize + kAlign - 1) / kAlign * kAlign);
  const long long bytes = kAlign + (long long)stages * ((long long)boxes * p->box_stride + 8);
  if (bytes > kMaxSmem || grid < 1 || grid > p->tiles) return false;
  if (tma && (n_r * itemsize) % 16 != 0) return false;
  *smem = (int)bytes;
  return true;
}

bool on_16_bytes(std::initializer_list<const void*> ptrs) {
  for (const void* q : ptrs)
    if (reinterpret_cast<unsigned long long>(q) % 16 != 0) return false;
  return true;
}

}  // namespace

// The card's SM count, or minus the cudaError_t.
extern "C" int leap_sm_count(int device) {
  int n = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
  return err == cudaSuccess ? n : -(int)err;
}

// a, b, out: [n_b, n_t, n_r] contiguous, dtype 0 = float32, 1 = bfloat16;
// h0: [n_b, n_r] contiguous float32.  The plan (kernels/lru_scan.py
// plan_lru_scan): warps a CTA (32 channels each), time rows a stage, stages
// in the ring, CTAs, and the route (1 = tensor-map copies, 0 = narrow).  A
// plan the kernel cannot run returns cudaErrorInvalidValue.  Returns a
// cudaError_t.
extern "C" int leap_lru_scan(const void* a, const void* b, const void* h0, void* out,
                             long long n_b, long long n_t, long long n_r, int dtype, int warps,
                             int rows, int stages, int grid, int tma, void* stream) {
  Plan p;
  int smem = 0;
  if (!make_plan(n_b, n_t, n_r, dtype, warps, rows, stages, grid, tma, 2, &p, &smem) ||
      (tma && !on_16_bytes({a, b, out})))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tma ? launch<float, true>(a, b, h0, out, p, warps, grid, smem, s)
               : launch<float, false>(a, b, h0, out, p, warps, grid, smem, s);
  return tma ? launch<__nv_bfloat16, true>(a, b, h0, out, p, warps, grid, smem, s)
             : launch<__nv_bfloat16, false>(a, b, h0, out, p, warps, grid, smem, s);
}

// The backward.  g (the gradient of out), a, h (the forward's out), da, db:
// [n_b, n_t, n_r] contiguous, dtype 0 = float32, 1 = bfloat16; h0, dh0:
// [n_b, n_r] contiguous float32.  The plan (kernels/lru_scan.py
// plan_lru_scan_bwd) as leap_lru_scan takes it; the tma route needs g, a, h,
// da, db and the row stride on 16 bytes.  A plan the kernel cannot run
// returns cudaErrorInvalidValue.  Returns a cudaError_t.
extern "C" int leap_lru_scan_bwd(const void* g, const void* a, const void* h, const void* h0,
                                 void* da, void* db, void* dh0, long long n_b, long long n_t,
                                 long long n_r, int dtype, int warps, int rows, int stages,
                                 int grid, int tma, void* stream) {
  Plan p;
  int smem = 0;
  if (!make_plan(n_b, n_t, n_r, dtype, warps, rows, stages, grid, tma, 3, &p, &smem) ||
      (tma && !on_16_bytes({g, a, h, da, db})))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tma ? launch_bwd<float, true>(g, a, h, h0, da, db, dh0, p, warps, grid, smem, s)
               : launch_bwd<float, false>(g, a, h, h0, da, db, dh0, p, warps, grid, smem, s);
  return tma ? launch_bwd<__nv_bfloat16, true>(g, a, h, h0, da, db, dh0, p, warps, grid, smem, s)
             : launch_bwd<__nv_bfloat16, false>(g, a, h, h0, da, db, dh0, p, warps, grid, smem,
                                                s);
}
