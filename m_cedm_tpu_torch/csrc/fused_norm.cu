// K1: GroupNorm (+ per-sample FiLM) + SiLU on a (B, N, C) fp32 activation.
//
// Replaces m_cedm_tpu/pallas/fused_norm.py::_stats_kernel (pass 1) and
// ::_apply_kernel (pass 2); the paired-lane twins _stats4_kernel and
// _apply4_kernel in fused_norm_conv.py compute the same math on the TPU's
// (W/2, 2C) layout and map here too.
//
// Bound: device-memory bandwidth. Pass 1 reads x once; pass 2 reads x and
// writes y once (the flagship shape is 16 x 16384 x 64 fp32 = 64 MiB). The
// FLOP count is a few per element.
//
// Design: the TPU carried per-(B, C) sums across a sequential grid. Blocks on
// Hopper run in parallel and in no order, so pass 1 reduces a strip of rows
// inside each block (per-thread partials, then shared memory) and adds the
// block's partials into zeroed (B, C) buffers with fp32 atomicAdd: one atomic
// per channel per block. The order of those adds changes from run to run, so
// the sums differ from a sequential sum by rounding only. Pass 2 folds the
// group statistics into one per-channel scale/shift per block (shared memory)
// and then streams x with coalesced loads: consecutive threads touch
// consecutive channels of one row.
//
// bf16: both passes are templated on the activation type. The bf16
// instances read bf16 x, sum and normalize in fp32 (the per-(B, C) sums stay
// fp32) and round once, at pass 2's store: the rounding points of the Pallas
// kernels on bf16 input (_stats_kernel upcasts before its sums, _apply_kernel
// computes in fp32 and casts at the store). Bound: bytes, half of fp32's
// (8.4 MB of x read by pass 1 at the flagship shape, 16.8 MB moved by pass
// 2); the design is the fp32 one, one 2-byte element a thread per access.
//
// Backward: gn_silu_bwd_kernel, one cooperative launch. Replaces
// fused_norm.py::_grad_stats_kernel and ::_grad_apply_kernel (via
// _pallas_backward; the paired twins _grad_stats4_kernel and
// _grad_apply4_kernel of fused_norm_conv.py's _gnsp_bwd compute the same
// math). With xhat the normalized x, y = xhat * gamma + beta and
// dy = g * silu'(y):
//   dgamma = sum_n dy * xhat, dbeta = sum_n dy    per (B, C)
//   dx = rstd * (dy * gamma - m1 - xhat * m2), where m1 and m2 are the group
//        means of dy * gamma and dy * gamma * xhat.
// gamma is constant over n, so the sums behind m1 and m2 are gamma * dbeta
// and gamma * dgamma: they come from the (B, C) results. mean and rstd come
// from the forward's (sums, sumsq).
//
// Bound: device memory. x and g read once and dx written once are three
// tensors, 3 x 67.1 MB at the flagship's (16, 16384, 64): 0.060 ms at
// 3.35 TB/s. The TPU's grad-stats and grad-apply passes read x and g twice,
// five tensor passes (0.100 ms at best). dx needs the whole sample's dgamma
// and dbeta, so one pass must hold x and g on chip until those are known.
//
// Design: a persistent grid of two blocks an SM (one above 1024 channels),
// all co-resident: a cooperative launch, which fails rather than run a grid
// that is not. Each sample's N rows are cut into one slab per block
// (`slabs` runs of `rows`, the last ragged: the wrapper's plan). A block
// walks the samples in order with a ring of `stages` slabs of x and g in
// shared memory, and its warps have roles (below): a loader warp fills the
// ring with 16-byte cp.async (4-byte where C % 4 != 0) under an mbarrier a
// stage; four warps run pass A, four pass B, and one sync warp does the
// block's part of the hand-off between them:
//   pass A (sample b)  from the stage: xhat, y, dy, and per-channel sums of
//            dy * xhat and dy, each thread over its rows in order, then a
//            fixed butterfly over a warp's row slots and the warps in order;
//            the slab's 2C partials go to the stage
//   hand-off  the sync warp copies them to a (B, slabs, 2C) scratch buffer
//            and, after a fence, adds one to sample b's arrival counter.
//            Group k of sample b is summed over the slabs by the sync warp
//            of block (b * groups + k) % slabs once the counter is full, in
//            a fixed order (a fixed stride of slabs a lane, then the lanes
//            in order); it writes the group's dgamma, dbeta, and its m1 and
//            m2 as 64-bit words tagged in the high half
//   pass B (sample b)  once the sync warp has read the sample's tagged m1,
//            m2 into the stage (they trail pass A by `lag` samples): dx from
//            the same stage, written once with streaming stores.
// The ring keeps at least four stages: where a slab is larger than a stage
// (at res 128 a stage holds 49 of a slab's 63 rows; or a large N), its
// first `smem_rows` rows are in the stage and both passes read the rest
// from device memory. No value is summed by an atomic (only the counters
// are atomics), so the sums do not depend on which block arrives when, and
// two calls give the same bits. The caller zeroes the counters and the
// tagged words.
//
// bf16 backward: the same kernel on bf16 x and g (gn_silu_bwd_kernel<V,
// __nv_bfloat16>), the bf16 instance of _grad_stats_kernel and
// _grad_apply_kernel, which upcast x and g, compute in fp32 and round dx once
// at the store. The ring stages x and g as they are (16-byte cp.async, eight
// values; the instance takes C % 8 == 0), so a stage holds twice the rows;
// every value is widened to fp32 as it is read, dgamma, dbeta and the
// partials stay fp32, and dx is stored as bf16. Bound: bytes, 3 x 33.6 MB at
// the flagship's shape, 0.030 ms at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kStatsRows = 256;   // rows of x reduced by one pass-1 block
constexpr int kApplyRows = 64;    // rows of x normalized by one pass-2 block

// an activation element as fp32, and an fp32 value stored as one
__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
channel_stats_kernel(const T* __restrict__ x, float* __restrict__ sums,
                     float* __restrict__ sumsq, int n, int c) {
  __shared__ float red_s[kThreads];
  __shared__ float red_ss[kThreads];
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kStatsRows;
  const int row_end = min(row0 + kStatsRows, n);
  // `lanes` threads cover consecutive channels of one row; `rsteps` such
  // groups take every rsteps-th row. Wider rows go in chunks of kThreads.
  const int lanes = min(c, kThreads);
  const int rsteps = kThreads / lanes;
  const int lane = threadIdx.x % lanes, slot = threadIdx.x / lanes;
  const T* xb = x + (size_t)b * n * c;
  for (int c0 = 0; c0 < c; c0 += lanes) {
    const int ch = c0 + lane;
    float s = 0.f, ss = 0.f;
    if (slot < rsteps && ch < c) {
      for (int r = row0 + slot; r < row_end; r += rsteps) {
        const float v = load_f(xb + (size_t)r * c + ch);
        s += v;
        ss += v * v;
      }
    }
    red_s[threadIdx.x] = s;
    red_ss[threadIdx.x] = ss;
    __syncthreads();
    if (threadIdx.x < lanes && ch < c) {
      for (int k = 1; k < rsteps; ++k) {
        s += red_s[threadIdx.x + k * lanes];
        ss += red_ss[threadIdx.x + k * lanes];
      }
      atomicAdd(&sums[b * c + ch], s);
      atomicAdd(&sumsq[b * c + ch], ss);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_silu_apply_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const float* __restrict__ sums,
                     const float* __restrict__ sumsq, T* __restrict__ out,
                     int n, int c, int groups, float eps) {
  extern __shared__ float sm[];
  float* sa = sm;      // per-channel scale gamma * rstd
  float* sb = sm + c;  // per-channel shift beta - gamma * rstd * mean
  const int b = blockIdx.y;
  const int per = c / groups;
  const float cnt = (float)n * (float)per;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const int g0 = (ch / per) * per;
    float s = 0.f, ss = 0.f;
    for (int k = 0; k < per; ++k) {
      s += sums[b * c + g0 + k];
      ss += sumsq[b * c + g0 + k];
    }
    const float mean = s / cnt;
    const float var = fmaxf(ss / cnt - mean * mean, 0.f);
    const float a = gamma[b * c + ch] * rsqrtf(var + eps);
    sa[ch] = a;
    sb[ch] = beta[b * c + ch] - a * mean;
  }
  __syncthreads();
  const int row0 = blockIdx.x * kApplyRows;
  const size_t base = ((size_t)b * n + row0) * c;
  const int count = min(kApplyRows, n - row0) * c;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int ch = i % c;
    const float y = load_f(x + base + i) * sa[ch] + sb[ch];
    store_f(out + base + i, y / (1.f + expf(-y)));
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// Four warps for pass A, four for pass B, then a loader warp and a sync warp
constexpr int kBwdPass = 128;
constexpr int kBwdCompute = 2 * kBwdPass;
constexpr int kBwdThreads = kBwdCompute + 64;
constexpr int kBwdLoader = kBwdCompute / 32, kBwdSyncer = kBwdLoader + 1;  // warp index
// two blocks an SM up to kBwdWideC channels, one above (the wrapper's plan
// says the same): a block's dynamic shared memory at most, of an SM's 227 KB
constexpr int kBwdWideC = 1024;
constexpr int kBwdSmemBytes = 112 * 1024;
constexpr int kBwdWideSmemBytes = 220 * 1024;
constexpr int kBwdMaxC = 2048;
constexpr int kBwdMaxStages = 8;
// at least this many stages, even where a slab's rows then do not all fit
// in one (the rest come from device memory in both passes)
constexpr int kBwdMinStages = 4;
// pass B trails pass A by lag = min(kBwdMaxLag, stages - kBwdMinLead)
// samples; the other stages take the copies of the next samples
constexpr int kBwdMaxLag = 4;
constexpr int kBwdMinLead = 2;
// pass A's reduction scratch: two sums of up to 4 channels a thread
constexpr int kRedFloats = 8 * kBwdPass;

struct BwdArgs {
  const void *x, *g;  // (B, N, C) of the instance's element type
  const float *gamma, *beta, *sums, *sumsq;
  float *dgamma, *dbeta;
  void* dx;
  float* part;   // (B, slabs, row) per-slab partials, row = 2C padded to 4
  unsigned* count;          // (B,) arrivals, zeroed by the caller
  unsigned long long* mm;   // (B, 2, groups) m1, m2 as (1 << 32 | bits), zeroed
  int batch, n, c, groups;
  float eps;
  int slabs, rows, smem_rows, stages, lag, row, vec, esz;  // esz: bytes an element
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" :: "r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(__nv_bfloat16* smem, const __nv_bfloat16* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

// mbarriers: a phase completes when `count` arrivals are in; a waiter names
// the parity of the phase it waits for
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}"
               :: "r"(smem_addr(bar)) : "memory");
}

// one arrival once every cp.async this thread issued so far has landed
__device__ __forceinline__ void mbar_arrive_copies(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" :: "r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred P1;\n LAB_WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      " @P1 bra DONE;\n bra LAB_WAIT;\n DONE:\n}"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// pass A's warps alone
__device__ __forceinline__ void pass_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kBwdPass) : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(v) : "memory");
}

// V consecutive floats (V = 4: one 16-byte access)
template <int V>
__device__ __forceinline__ void load_v(const float* p, float* a) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
  } else {
    a[0] = *p;
  }
}

// V consecutive bf16 values widened (V = 4: one 8-byte access)
template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float* a) {
  if constexpr (V == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    a[0] = lo.x; a[1] = lo.y; a[2] = hi.x; a[3] = hi.y;
  } else {
    a[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void store_v_streaming(float* p, const float* a) {
  if constexpr (V == 4)
    __stcs(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
  else
    __stcs(p, a[0]);
}

// V values rounded once to bf16 (V = 4: one 8-byte store)
template <int V>
__device__ __forceinline__ void store_v_streaming(__nv_bfloat16* p, const float* a) {
  if constexpr (V == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    __stcs(reinterpret_cast<uint2*>(p), u);
  } else {
    *p = __float2bfloat16_rn(a[0]);
  }
}

// count floats from device to shared memory by the lanes of one warp
__device__ __forceinline__ void warp_copy_async(float* dst, const float* src, int count,
                                                int vec, int lane) {
  if (vec == 4) {
    for (int i = 4 * lane; i < count; i += 128) cp_async16(dst + i, src + i);
  } else {
    for (int i = lane; i < count; i += 32) cp_async4(dst + i, src + i);
  }
}

// count bf16 values by the lanes of one warp (the bf16 instance takes only
// 16-byte copies: count a multiple of 8, 16-byte aligned)
__device__ __forceinline__ void warp_copy_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int count, int, int lane) {
  for (int i = 8 * lane; i < count; i += 256) cp_async16(dst + i, src + i);
}

// dy = g * silu'(y) for y = xhat * gamma + beta
__device__ __forceinline__ float silu_grad(float gv, float y) {
  const float sig = __fdividef(1.f, 1.f + __expf(-y));
  return gv * sig * (1.f + y * (1.f - sig));
}

// A stage of the ring: the slab's first smem_rows rows of x, then of g; the
// sample's sums, sumsq, gamma and beta (copied with the slab) and its
// per-channel mean and rstd (computed once the stage has landed): 6C; the
// slab's partials (row); the sample's m1 and m2 per group (for pass B)
struct Stage {
  float *x, *g, *vec, *part, *mm;
};

// the floats of a stage's parts, each a multiple of 4 (16-byte aligned)
__host__ __device__ __forceinline__ long round4(long n) { return (n + 3) / 4 * 4; }

// the floats that hold `rows` rows of C elements of esz bytes
__host__ __device__ __forceinline__ long rows_floats(long rows, int c, int esz) {
  return round4((rows * c * esz + 3) / 4);
}

__device__ __forceinline__ size_t stage_floats(const BwdArgs& p) {
  return 2 * rows_floats(p.smem_rows, p.c, p.esz) + round4(6L * p.c) + p.row +
         round4(2L * p.groups);
}

__device__ __forceinline__ Stage stage_at(float* ring, const BwdArgs& p, int b) {
  const long buf = rows_floats(p.smem_rows, p.c, p.esz);
  float* base = ring + stage_floats(p) * (b % p.stages);
  float* vec = base + 2 * buf;
  float* part = vec + round4(6L * p.c);
  return Stage{base, base + buf, vec, part, part + p.row};
}

// the per-channel mean and rstd of a landed stage, from its sums (pass A's
// threads)
__device__ void stage_norm(float* vec, const BwdArgs& p, int tid) {
  const int c = p.c, per = c / p.groups;
  const float inv_cnt = 1.f / ((float)p.n * (float)per);
  for (int ch = tid; ch < c; ch += kBwdPass) {
    const int g0 = (ch / per) * per;
    float s = 0.f, ss = 0.f;
    for (int k = 0; k < per; ++k) {
      s += vec[g0 + k];
      ss += vec[c + g0 + k];
    }
    const float mean = s * inv_cnt;
    vec[4 * c + ch] = mean;
    vec[5 * c + ch] = rsqrtf(fmaxf(ss * inv_cnt - mean * mean, 0.f) + p.eps);
  }
}

// mean, rstd, gamma, beta of V channels from a stage's vectors
template <int V>
__device__ __forceinline__ void channel_coef(const float* vec, int c, int ch, float* mean,
                                             float* rstd, float* ga, float* be) {
  load_v<V>(vec + 4 * c + ch, mean);
  load_v<V>(vec + 5 * c + ch, rstd);
  load_v<V>(vec + 2 * c + ch, ga);
  load_v<V>(vec + 3 * c + ch, be);
}

// The rows of a pass: each of its threads (tid) takes V consecutive
// channels (its lane) of every slots-th row from its slot on; wider rows go
// in chunks of kBwdPass lanes.
struct Lanes {
  int lanes, per_chunk, slots, lane, slot;
  __device__ Lanes(int c, int v, int tid) {
    lanes = c / v;
    per_chunk = min(lanes, kBwdPass);
    slots = kBwdPass / per_chunk;
    lane = tid % per_chunk;
    slot = tid / per_chunk;
  }
};

// Pass A over one slab of `rows` rows (compute threads): out[0, c) = sum
// dy * xhat and out[c, 2c) = sum dy, in a fixed order: each thread over its
// rows in order; then, where a warp holds whole slots, a fixed butterfly over
// the warp's slots and the warps summed in order, else the slots summed in
// order. Rows below smem_rows come from the stage, the rest from xd / gd.
template <int V, typename T>
__device__ void grad_partials(const Stage& st, const T* xd, const T* gd, int rows,
                              const BwdArgs& p, float* red, float* out, int tid) {
  const int c = p.c;
  const T* sx = reinterpret_cast<const T*>(st.x);
  const T* sgt = reinterpret_cast<const T*>(st.g);
  const Lanes ln(c, V, tid);
  const int width = ln.per_chunk * V;  // channels of a chunk
  const bool shuffle = ln.per_chunk <= 32 && 32 % ln.per_chunk == 0;
  const int sets = shuffle ? kBwdPass / 32 : ln.slots;  // partial sets summed in order
  float* red_b = red + sets * width;
  for (int l0 = 0; l0 < ln.lanes; l0 += ln.per_chunk) {
    const int ch = (l0 + ln.lane) * V;
    float sg[V], sb[V];
#pragma unroll
    for (int v = 0; v < V; ++v) sg[v] = sb[v] = 0.f;
    if (ln.slot < ln.slots && ch < c) {
      float mean[V], rstd[V], ga[V], be[V];
      channel_coef<V>(st.vec, c, ch, mean, rstd, ga, be);
      for (int r = ln.slot; r < rows; r += ln.slots) {
        const size_t off = (size_t)r * c + ch;
        float xv[V], gv[V];
        load_v<V>((r < p.smem_rows ? sx : xd) + off, xv);
        load_v<V>((r < p.smem_rows ? sgt : gd) + off, gv);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float xhat = (xv[v] - mean[v]) * rstd[v];
          const float dy = silu_grad(gv[v], xhat * ga[v] + be[v]);
          sg[v] += dy * xhat;
          sb[v] += dy;
        }
      }
    }
    int set = ln.slot;
    if (shuffle) {
      for (int m = ln.per_chunk; m < 32; m *= 2) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          sg[v] += __shfl_xor_sync(0xffffffffu, sg[v], m);
          sb[v] += __shfl_xor_sync(0xffffffffu, sb[v], m);
        }
      }
      set = tid / 32;
    }
    if (ln.slot < ln.slots && (!shuffle || tid % 32 < ln.per_chunk)) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        red[set * width + ln.lane * V + v] = sg[v];
        red_b[set * width + ln.lane * V + v] = sb[v];
      }
    }
    pass_sync();
    for (int i = tid; i < 2 * width; i += kBwdPass) {
      const int e = i % width;
      const float* src = i < width ? red : red_b;
      if (l0 * V + e < c) {
        float t = 0.f;
#pragma unroll 8
        for (int k = 0; k < sets; ++k) t += src[k * width + e];
        out[(i < width ? 0 : c) + l0 * V + e] = t;
      }
    }
    pass_sync();
  }
}

// Pass B over one slab (compute threads): dx, with m1 and m2 of each
// channel's group from mm
template <int V, typename T>
__device__ void grad_apply(const Stage& st, const T* xd, const T* gd, T* dxd,
                           int rows, const BwdArgs& p, const float* mm, int tid) {
  const int c = p.c, per = c / p.groups;
  const T* sx = reinterpret_cast<const T*>(st.x);
  const T* sgt = reinterpret_cast<const T*>(st.g);
  const Lanes ln(c, V, tid);
  if (ln.slot >= ln.slots) return;
  for (int l0 = 0; l0 < ln.lanes; l0 += ln.per_chunk) {
    const int ch = (l0 + ln.lane) * V;
    if (ch >= c) break;
    float mean[V], rstd[V], ga[V], be[V], m1[V], m2[V];
    channel_coef<V>(st.vec, c, ch, mean, rstd, ga, be);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      m1[v] = mm[(ch + v) / per];
      m2[v] = mm[p.groups + (ch + v) / per];
    }
    for (int r = ln.slot; r < rows; r += ln.slots) {
      const size_t off = (size_t)r * c + ch;
      float xv[V], gv[V], d[V];
      load_v<V>((r < p.smem_rows ? sx : xd) + off, xv);
      load_v<V>((r < p.smem_rows ? sgt : gd) + off, gv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float xhat = (xv[v] - mean[v]) * rstd[v];
        const float dy = silu_grad(gv[v], xhat * ga[v] + be[v]);
        d[v] = rstd[v] * (dy * ga[v] - m1[v] - xhat * m2[v]);
      }
      store_v_streaming<V>(dxd + off, d);
    }
  }
}

// One warp sums group k of sample b over every slab's partials, in a fixed
// order (lane phase ph takes slabs ph, ph + phases, ... in order, 16 loads in
// flight, 32 bytes a lane; then the phases in order), and writes the
// group's dgamma, dbeta
// and its m1, m2 as tagged words. U floats a load (4 where the group's
// channels come in 16-byte runs).
template <int U>
__device__ void finish_group(const BwdArgs& p, int b, int k, int lane) {
  constexpr int kBatch = U == 4 ? 8 : 16;
  const int c = p.c, per = c / p.groups, g0 = k * per;
  const int units = 2 * per / U;  // of the group's dgamma, then dbeta
  const float* part = p.part + (size_t)b * p.slabs * p.row;
  float s1 = 0.f, s2 = 0.f;  // sum gamma * dbeta, sum gamma * dgamma (lane 0)
  for (int u0 = 0; u0 < units; u0 += 32) {
    const int uc = min(units - u0, 32), phases = 32 / uc;
    const int u = u0 + lane % uc, ph = lane / uc;
    const int off = u < per / U ? g0 + u * U : c + g0 + (u - per / U) * U;
    float acc[U] = {};
    if (ph < phases) {
      for (int s0 = ph; s0 < p.slabs; s0 += kBatch * phases) {
        float v[kBatch][U];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int s = s0 + q * phases;
          if constexpr (U == 4) {
            const float4 t = s < p.slabs
                                 ? __ldcg(reinterpret_cast<const float4*>(part + (size_t)s * p.row + off))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
            v[q][0] = t.x; v[q][1] = t.y; v[q][2] = t.z; v[q][3] = t.w;
          } else {
            v[q][0] = s < p.slabs ? __ldcg(part + (size_t)s * p.row + off) : 0.f;
          }
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
#pragma unroll
          for (int j = 0; j < U; ++j) acc[j] += v[q][j];
      }
    }
    // the phases in order: lane u of the chunk gathers them
    float tot[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      tot[j] = 0.f;
      for (int q = 0; q < phases; ++q)
        tot[j] += __shfl_sync(0xffffffffu, acc[j], lane % uc + q * uc);
    }
    if (ph == 0) {
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const int ch = (u < per / U ? u : u - per / U) * U + j;  // within the group
        if (u < per / U) p.dgamma[b * c + g0 + ch] = tot[j];
        else p.dbeta[b * c + g0 + ch] = tot[j];
      }
    }
    // lane 0 folds the chunk's units in order into s1, s2
    for (int q = 0; q < uc; ++q) {
      const int uq = u0 + q;
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const float t = __shfl_sync(0xffffffffu, tot[j], q);
        const int ch = (uq < per / U ? uq : uq - per / U) * U + j;
        const float ga = __ldg(p.gamma + b * c + g0 + ch);
        if (uq < per / U) s2 += ga * t;
        else s1 += ga * t;
      }
    }
  }
  if (lane == 0) {
    const float cnt = (float)p.n * (float)per;
    unsigned long long* mm = p.mm + (size_t)b * 2 * p.groups;
    store_relaxed(mm + k, (1ull << 32) | __float_as_uint(s1 / cnt));
    store_relaxed(mm + p.groups + k, (1ull << 32) | __float_as_uint(s2 / cnt));
  }
}

// The slab of sample b that block s owns: its first element in a (B, N, C)
// tensor
__device__ __forceinline__ size_t slab_offset(const BwdArgs& p, int b, int s) {
  return ((size_t)b * p.n + (size_t)s * p.rows) * p.c;
}

// The roles, each walking the samples in order (stage of sample b: b % S):
//   loader warp   waits for the stage to be free, copies x, g and the
//                 sample's vectors into it (cp.async; the stage's `full`
//                 barrier completes when they land)
//   pass A warps  the stage's mean and rstd, then pass A (its partials into
//                 the stage; `part`)
//   pass B warps  pass B once the sample's m1, m2 are in the stage (`coef`),
//                 which frees the stage (`empty`)
//   sync warp     per sample it: the partials to device memory, a fence and
//                 the arrival; then m1, m2 of sample it - lag read (waited
//                 for) into its stage; then its share of the finish: group k
//                 of sample f is summed by block (f * groups + k) % slabs,
//                 one sample after f's pass A where lag is two or more
// Pass A waits on nothing but the copies and pass B on nothing but m1, m2
// (A runs on while B waits), and every device-memory latency of the
// hand-off falls on the sync warp.
template <int V, typename T>
__global__ void __launch_bounds__(kBwdThreads, 2) gn_silu_bwd_kernel(const BwdArgs p) {
  extern __shared__ __align__(16) float sm[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(sm);
  const int S = p.stages;
  unsigned long long *full = bars, *part = bars + S, *coef = bars + 2 * S, *empty = bars + 3 * S;
  float* ring = sm + 8 * S;  // after the 4 S barriers
  float* red = ring + stage_floats(p) * S;
  const int c = p.c, s = blockIdx.x, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows = min(p.rows, p.n - s * p.rows), srows = min(rows, p.smem_rows);
  const T* px = static_cast<const T*>(p.x);
  const T* pg = static_cast<const T*>(p.g);
  if (threadIdx.x == 0) {
    for (int k = 0; k < S; ++k) {
      mbar_init(full + k, 32);
      mbar_init(part + k, 1);
      mbar_init(coef + k, 1);
      mbar_init(empty + k, kBwdPass / 32);
    }
  }
  __syncthreads();

  if (warp == kBwdLoader) {
    for (int b = 0; b < p.batch; ++b) {
      const int k = b % S;
      if (b >= S) mbar_wait(empty + k, (b / S - 1) & 1);
      const Stage st = stage_at(ring, p, b);
      const size_t off = slab_offset(p, b, s);
      warp_copy_async(reinterpret_cast<T*>(st.x), px + off, srows * c, p.vec, lane);
      warp_copy_async(reinterpret_cast<T*>(st.g), pg + off, srows * c, p.vec, lane);
      warp_copy_async(st.vec, p.sums + (size_t)b * c, c, p.vec, lane);
      warp_copy_async(st.vec + c, p.sumsq + (size_t)b * c, c, p.vec, lane);
      warp_copy_async(st.vec + 2 * c, p.gamma + (size_t)b * c, c, p.vec, lane);
      warp_copy_async(st.vec + 3 * c, p.beta + (size_t)b * c, c, p.vec, lane);
      mbar_arrive_copies(full + k);
    }
  } else if (warp == kBwdSyncer) {
    const int d = p.lag >= 2 ? 1 : 0;
    const int per = c / p.groups;
    for (int it = 0; it < p.batch + p.lag; ++it) {
      if (it < p.batch) {  // sample it's partials out, and its arrival
        const Stage st = stage_at(ring, p, it);
        mbar_wait(part + it % S, (it / S) & 1);
        float* dst = p.part + ((size_t)it * p.slabs + s) * p.row;
        for (int i = 4 * lane; i < p.row; i += 128)
          __stcg(reinterpret_cast<float4*>(dst + i), *reinterpret_cast<const float4*>(st.part + i));
        __syncwarp();
        if (lane == 0) {
          __threadfence();
          atomicAdd(p.count + it, 1u);
        }
      }
      if (it >= p.lag) {  // m1, m2 of sample it - lag into its stage
        const int b = it - p.lag;
        const Stage st = stage_at(ring, p, b);
        const unsigned long long* mm = p.mm + (size_t)b * 2 * p.groups;
        for (int i = lane; i < 2 * p.groups; i += 32) {
          unsigned long long w = load_relaxed(mm + i);
          while (!(w >> 32)) {
            __nanosleep(32);
            w = load_relaxed(mm + i);
          }
          st.mm[i] = __uint_as_float((unsigned)w);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(coef + b % S);
      }
      const int f = it - d;  // this block's groups of sample f
      if (f >= 0 && f < p.batch) {
        int k = (int)(((long)s - (long)f * p.groups) % p.slabs);
        if (k < 0) k += p.slabs;
        if (k < p.groups) {
          if (lane == 0)
            while (load_acquire(p.count + f) < (unsigned)p.slabs) __nanosleep(32);
          __syncwarp();
          for (; k < p.groups; k += p.slabs) {
            if (per % 4 == 0 && c % 4 == 0) finish_group<4>(p, f, k, lane);
            else finish_group<1>(p, f, k, lane);
          }
        }
      }
    }
  } else if (warp < kBwdPass / 32) {  // pass A of each sample
    for (int it = 0; it < p.batch; ++it) {
      const Stage st = stage_at(ring, p, it);
      const size_t off = slab_offset(p, it, s);
      mbar_wait(full + it % S, (it / S) & 1);
      stage_norm(st.vec, p, threadIdx.x);
      pass_sync();
      grad_partials<V>(st, px + off, pg + off, rows, p, red, st.part, threadIdx.x);
      if (threadIdx.x == 0) mbar_arrive(part + it % S);  // after its last barrier
    }
  } else {  // pass B of each sample; its stage is then free
    for (int b = 0; b < p.batch; ++b) {
      const Stage st = stage_at(ring, p, b);
      const size_t off = slab_offset(p, b, s);
      mbar_wait(coef + b % S, (b / S) & 1);
      grad_apply<V>(st, px + off, pg + off, static_cast<T*>(p.dx) + off, rows, p, st.mm,
                    threadIdx.x - kBwdPass);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + b % S);
    }
  }
}

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15u) == 0; }

// The ring of a plan: stages, the lag of pass B, the rows of a slab held in
// shared memory, and the block's dynamic shared memory in bytes (-1 if C
// is too wide).
long bwd_ring(int c, int groups, int rows, int esz, int* stages, int* lag, int* smem_rows) {
  // a stage: x and g rows (each part rounded to 4 floats, so 16 bytes of
  // slack for the two), then the vectors, partials and m1, m2
  const long vec_bytes = (round4(6L * c) + round4(2L * c) + round4(2L * groups)) * 4 + 32;
  const long fixed = kRedFloats * 4L + 32L * kBwdMaxStages;  // + a barrier set a stage
  const long budget = c > kBwdWideC ? kBwdWideSmemBytes : kBwdSmemBytes;
  const long ring = budget - fixed, row_bytes = 2L * esz * c;
  // whole slabs, or kBwdMinStages stages of a row at least where they fit
  long s = ring / (row_bytes * rows + vec_bytes);
  const long some = ring / (row_bytes + vec_bytes);
  if (s < kBwdMinStages) s = some < kBwdMinStages ? some : kBwdMinStages;
  s = s < 3 ? 3 : s > kBwdMaxStages ? kBwdMaxStages : s;
  if (c > kBwdMaxC || ring < s * vec_bytes) return -1;
  *stages = (int)s;
  *lag = (int)(s - kBwdMinLead < kBwdMaxLag ? s - kBwdMinLead : kBwdMaxLag);
  const long r = (ring / s - vec_bytes) / row_bytes;
  *smem_rows = (int)(r < rows ? r : rows);
  const long stage = 2 * rows_floats(*smem_rows, c, esz) + round4(6L * c) + round4(2L * c) +
                     round4(2L * groups);
  return 32L * s + 4L * stage * s + kRedFloats * 4L;
}

// Blocks of gn_silu_bwd_kernel<V, T> co-resident on one SM at `smem` bytes of
// dynamic shared memory (opted into first: above 48 KB a kernel must ask);
// the last answer is kept, since a train step asks with the same few sizes
template <int V, typename T>
int bwd_blocks_per_sm(long smem, int* per_sm) {
  static bool opted = false;
  static long last_smem = -1;
  static int last_per_sm = 0;
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        gn_silu_bwd_kernel<V, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBwdWideSmemBytes);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  if (smem != last_smem) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &last_per_sm, gn_silu_bwd_kernel<V, T>, kBwdThreads, (size_t)smem);
    if (e != cudaSuccess) return (int)e;
    last_smem = smem;
  }
  *per_sm = last_per_sm;
  return 0;
}

// The current device's SM count, and whether it takes cooperative launches
int bwd_device(int* sms, int* coop) {
  static int last_dev = -1, last_sms = 0, last_coop = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev != last_dev) {
    e = cudaDeviceGetAttribute(&last_coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&last_sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) last_dev = dev;
  }
  *sms = last_sms;
  *coop = last_coop;
  return (int)e;
}

// Checks the call and fills the kernel's arguments; a cudaError_t code.
// esz: bytes of an x, g and dx element (4: fp32; 2: bf16, which takes
// C % 8 == 0 and 16-byte aligned vectors and tensors).
int bwd_args(const void* x, const void* g, const float* gamma, const float* beta,
             const float* sums, const float* sumsq, float* dgamma, float* dbeta,
             void* dx, float* scratch, unsigned* sync, int b, int n, int c, int groups,
             float eps, int slabs, int rows, int esz, BwdArgs* p, long* smem) {
  if (b < 1 || n < 1 || c < 1 || groups < 1 || c % groups || rows < 1 || slabs < 1 ||
      (long)(slabs - 1) * rows >= n || (long)slabs * rows < n)
    return (int)cudaErrorInvalidValue;
  int stages = 0, lag = 0, smem_rows = 0;
  *smem = bwd_ring(c, groups, rows, esz, &stages, &lag, &smem_rows);
  if (*smem < 0) return (int)cudaErrorInvalidValue;
  const bool vec = c % 4 == 0 && aligned16(x) && aligned16(g) && aligned16(dx) &&
                   aligned16(gamma) && aligned16(beta) && aligned16(sums) && aligned16(sumsq);
  if (esz == 2 && (!vec || c % 8)) return (int)cudaErrorInvalidValue;
  *p = BwdArgs{x, g, gamma, beta, sums, sumsq, dgamma, dbeta, dx, scratch, sync,
               reinterpret_cast<unsigned long long*>(sync + (b + 1) / 2 * 2),
               b, n, c, groups, eps, slabs, rows, smem_rows, stages, lag,
               (2 * c + 3) / 4 * 4, vec ? 4 : 1, esz};
  return 0;
}

// The cooperative launch of gn_silu_bwd_kernel<4 or 1, T> on filled arguments
template <typename T>
int bwd_launch(const BwdArgs& p, long smem, int slabs, void* stream) {
  int coop = 0, sms = 0, per_sm = 0;
  int rc = bwd_device(&sms, &coop);
  if (rc) return rc;
  if (!coop) return (int)cudaErrorNotSupported;
  const bool vec = p.vec == 4;
  rc = vec ? bwd_blocks_per_sm<4, T>(smem, &per_sm) : bwd_blocks_per_sm<1, T>(smem, &per_sm);
  if (rc) return rc;
  if ((long)per_sm * sms < slabs) return (int)cudaErrorCooperativeLaunchTooLarge;
  BwdArgs q = p;
  void* args[] = {&q};
  const void* fn =
      vec ? (const void*)gn_silu_bwd_kernel<4, T> : (const void*)gn_silu_bwd_kernel<1, T>;
  const cudaError_t e = cudaLaunchCooperativeKernel(fn, dim3(slabs), dim3(kBwdThreads), args,
                                                    (size_t)smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// sums/sumsq must be zeroed (B, C) buffers; the kernel adds into them.
int mc_channel_stats(const float* x, float* sums, float* sumsq, int b, int n,
                     int c, void* stream) {
  dim3 grid((n + kStatsRows - 1) / kStatsRows, b);
  channel_stats_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, sums, sumsq, n, c);
  return (int)cudaGetLastError();
}

int mc_gn_silu(const float* x, const float* gamma, const float* beta,
               const float* sums, const float* sumsq, float* out, int b, int n,
               int c, int groups, float eps, void* stream) {
  dim3 grid((n + kApplyRows - 1) / kApplyRows, b);
  gn_silu_apply_kernel<<<grid, kThreads, 2 * c * sizeof(float),
                         (cudaStream_t)stream>>>(x, gamma, beta, sums, sumsq,
                                                 out, n, c, groups, eps);
  return (int)cudaGetLastError();
}

// The bf16 instances: x and out bf16; sums, sumsq, gamma, beta fp32.
int mc_channel_stats_bf16(const __nv_bfloat16* x, float* sums, float* sumsq, int b,
                          int n, int c, void* stream) {
  dim3 grid((n + kStatsRows - 1) / kStatsRows, b);
  channel_stats_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, sums, sumsq, n, c);
  return (int)cudaGetLastError();
}

int mc_gn_silu_bf16(const __nv_bfloat16* x, const float* gamma, const float* beta,
                    const float* sums, const float* sumsq, __nv_bfloat16* out, int b,
                    int n, int c, int groups, float eps, void* stream) {
  dim3 grid((n + kApplyRows - 1) / kApplyRows, b);
  gn_silu_apply_kernel<<<grid, kThreads, 2 * c * sizeof(float),
                         (cudaStream_t)stream>>>(x, gamma, beta, sums, sumsq,
                                                 out, n, c, groups, eps);
  return (int)cudaGetLastError();
}

// The backward's launch for slabs of `rows` rows at C channels in `groups`
// groups on the current card: ring stages, the lag of pass B, slab rows held
// in shared memory, a block's dynamic shared memory, and the co-resident
// blocks (per_sm on each of sms).
int mc_gn_silu_bwd_occupancy(int c, int groups, int rows, int* stages, int* lag,
                             int* smem_rows, int* smem_bytes, int* per_sm, int* sms) {
  if (c < 1 || groups < 1 || c % groups || rows < 1) return (int)cudaErrorInvalidValue;
  const long smem = bwd_ring(c, groups, rows, 4, stages, lag, smem_rows);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  *smem_bytes = (int)smem;
  int coop = 0;
  const int rc = bwd_device(sms, &coop);
  if (rc) return rc;
  return c % 4 == 0 ? bwd_blocks_per_sm<4, float>(smem, per_sm)
                    : bwd_blocks_per_sm<1, float>(smem, per_sm);
}

// x, g, dx (B, N, C); gamma, beta, sums, sumsq (the forward's statistics),
// dgamma, dbeta (B, C). Each sample's rows are cut into `slabs` slabs of
// `rows` rows (the last ragged), one per block. The caller allocates scratch
// (B * slabs * row floats, row = 2C rounded up to a multiple of 4) and zeroes
// sync (B rounded up to even, plus 4 * B * groups unsigned: the arrival
// counters, then m1 and m2 of each group as tagged 64-bit words). Returns a cudaError_t code; the
// launch is never shrunk to a non-cooperative one.
int mc_gn_silu_bwd(const float* x, const float* g, const float* gamma,
                   const float* beta, const float* sums, const float* sumsq,
                   float* dgamma, float* dbeta, float* dx, float* scratch,
                   unsigned* sync, int b, int n, int c, int groups, float eps,
                   int slabs, int rows, void* stream) {
  BwdArgs p;
  long smem = 0;
  const int rc = bwd_args(x, g, gamma, beta, sums, sumsq, dgamma, dbeta, dx, scratch, sync,
                          b, n, c, groups, eps, slabs, rows, 4, &p, &smem);
  return rc ? rc : bwd_launch<float>(p, smem, slabs, stream);
}

// The bf16 instance: x, g, dx bf16 (C % 8 == 0, 16-byte aligned); the rest as
// mc_gn_silu_bwd's.
int mc_gn_silu_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g, const float* gamma,
                        const float* beta, const float* sums, const float* sumsq,
                        float* dgamma, float* dbeta, __nv_bfloat16* dx, float* scratch,
                        unsigned* sync, int b, int n, int c, int groups, float eps,
                        int slabs, int rows, void* stream) {
  BwdArgs p;
  long smem = 0;
  const int rc = bwd_args(x, g, gamma, beta, sums, sumsq, dgamma, dbeta, dx, scratch, sync,
                          b, n, c, groups, eps, slabs, rows, 2, &p, &smem);
  return rc ? rc : bwd_launch<__nv_bfloat16>(p, smem, slabs, stream);
}

}  // extern "C"
