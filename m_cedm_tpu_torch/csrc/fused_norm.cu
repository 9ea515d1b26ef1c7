// K1: GroupNorm (+ per-sample FiLM) + SiLU on a (B, N, C) activation, fp32
// or bf16.
//
// Replaces m_cedm_tpu/pallas/fused_norm.py::_stats_kernel (pass 1) and
// ::_apply_kernel (pass 2); the paired-lane twins _stats4_kernel and
// _apply4_kernel in fused_norm_conv.py compute the same math on the TPU's
// (W/2, 2C) layout and map here too.
//
// Bound: device-memory bandwidth, a few FLOPs an element. Pass 1 reads x
// once; pass 2 reads x and writes y once. At the flagship's (16, 16384, 64)
// x is 67.1 MB in fp32 and 33.6 MB in bf16: pass 1 0.020 / 0.010 ms and
// pass 2 (134.2 / 67.1 MB moved) 0.040 / 0.020 ms at 3.35 TB/s; the apply's
// bf16 site at res 64, (16, 4096, 64), moves 16.8 MB, 0.005 ms. The main
// path runs pass 1 only at the 32x32 sites after an attention block, (16,
// 1024, 64) and (16, 1024, 128): 2.1 / 4.2 MB of bf16 x, 0.6 / 1.3 us of
// bytes, so one launch and one round trip to device memory set its time.
//
// Pass 1, channel_stats_kernel<V, T>: one launch, no atomics, the same bits
// on every call. A sample is one thread-block cluster of up to kStatsCluster
// blocks (4 at the 32x32 sites: kStatsMinRows rows a block at least), each a
// contiguous run of its rows (the launch plan:
// kernels/fused_norm.py::stats_plan). A thread takes V channels (one 16-byte
// load: 8 bf16 or 4 fp32 values; V = 1 where C % V != 0 or x is unaligned)
// of every slots-th row of its block, kStatsUnroll loads in flight, and sums
// them in row order; a fixed butterfly over a warp's row slots, then the
// warps in order in shared memory (the slots in order where a warp does not
// hold whole slots) give the block's partials. After a cluster barrier, rank
// 0 reads the ranks' partials over distributed shared memory in rank order
// and stores sums and sumsq: no buffer to zero first.
//
// Pass 2, gn_silu_apply_kernel<V, T>: about kApplyBlocksPerSm blocks an SM,
// each a contiguous run of one sample's rows (kernels/fused_norm.py::
// apply_plan). A thread owns one V-channel chunk for the whole call and
// takes every slots-th row of its block. Its rows come through a ring of
// kApplyStages 16-byte cp.async copies of its own in shared memory, which
// hold the copies in flight without registers: the first ones are issued
// before it folds its V scales a = gamma * rstd and shifts b = beta - a *
// mean from the group sums once, into registers; each slot read is refilled
// with the row kApplyStages on. y = x * a + b, then silu(y), leaves in one
// streaming 16-byte store. V = 1 loads its elements directly.
//
// bf16: the same two kernels on bf16 x. They sum and normalize in fp32 (the
// per-(B, C) sums stay fp32) and round once, at pass 2's store: the rounding
// points of the Pallas kernels on bf16 input (_stats_kernel upcasts before
// its sums, _apply_kernel computes in fp32 and casts at the store). The bf16
// apply takes SiLU as y / (1 + e^-y) by __expf and __fdividef, a few ulp of
// fp32 under the one bf16 rounding that follows; fp32 keeps expf and an IEEE
// divide.
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
// bf16 backward: gn_silu_bwd_cluster_kernel, one launch on thread-block
// clusters, written for Hopper (the fp32 kernel above is not instantiated
// for bf16). The bf16 instance of _grad_stats_kernel and _grad_apply_kernel
// (and the paired twins): x and g widened to fp32 as they are read; xhat, y
// and dy = g silu'(y) in fp32 (e^-y and the reciprocal one MUFU operation
// each, flushing subnormals); dgamma and dbeta fp32 sums per (B, C); m1 and
// m2 from them per group; dx rounded once to bf16 at the store. No value is
// summed by an atomic and two calls give the same bits. Bound: bytes, x and
// g read once and dx written once, 3 x 33.6 MB at the flagship's res 128,
// 0.030 ms at 3.35 TB/s (0.0075 at res 64).
//
// The earlier design, the fp32 kernel's bf16 instance, handed every sample
// through the whole grid in turn (one slab a block, a sync warp a block
// walking the samples through device-memory partials and arrival counters),
// about 3 us a sample of latency, plus a zeroed buffer a call. Here a
// sample's reduction is local and every sample's runs at once:
//   - the plan (csrc/k1_bwd_plan.h) gives each sample `blocks` blocks, a
//     power of two that fills the SMs at one block an SM (8 at B 16), cut
//     into clusters: the largest cluster whose launch takes the batch in the
//     fewest waves, asked of the card (cudaOccupancyMaxActiveClusters: 132
//     of 1, 66 of 2, 30 of 4, 15 of 8 on an H100). At B 16 that is 4
//     clusters of 2 a sample, 128 blocks in one wave. Where B needs more
//     than one wave the sample groups are persistent, group i taking samples
//     i, i + inflight, ... in order.
//   - a block takes a contiguous run of its sample's rows, in chunks of
//     32 KB of x and g, through one ring of `slots` chunk slots in shared
//     memory filled by one producer thread with bulk copies
//     (cp.async.bulk under full / empty mbarriers, csrc/tma_ring.cuh). The
//     last `slots` chunks of pass A stay in their slots for pass B, the
//     others are read again: pass A's copies of those at normal L2
//     priority, every other copy and store evict-first, and pass B reads
//     them again last-read first (an evict-last hint on the first read
//     left lines in L2 that slowed the train step's other kernels). At res 64 every row stays (4 of 4 chunks); at res 128
//     6 of 16. Shared memory of a block (k1_bwd_plan.h's layout) at res 128:
//     the slots 6 x 32 KB = 196,608 bytes, the partial sets 8 warps x 2 C
//     floats = 4,096, the block's partial and the sample's sums 512 each,
//     the groups' mean, rstd, m1, m2 256, the sample's sums, sums of
//     squares, gamma and beta 1,024, the barriers 128: 203,136 of the
//     232,448 a block may take; at res 64 (4 slots) 137,600.
//   - 8 compute warps in two groups that take alternate chunks, 8 channels
//     of a row a thread (16 warps above 1024 channels, so that a group's
//     threads hold a row of up to 2048: the kernel's two instances); pass A sums dy xhat and dy per channel, each thread
//     over its rows in order, a butterfly over a warp's row slots, the warps
//     in order into the block's partial.
//   - the hand-off: each rank's partial in its own shared memory; a
//     release-arrive on every rank's `ready` mbarrier, an acquire-wait on its
//     own, then every rank sums the ranks' partials over distributed shared
//     memory in rank order (the same bits on every rank), and arrives on
//     every rank's `done` barrier, which a rank waits on before its partial
//     is written again or it leaves. Where a sample spans clusters, rank 0 of
//     each writes its cluster's sums as 64-bit words tagged with the call's
//     epoch into device memory (`xchg`, kept by the caller and zeroed once
//     when allocated, an epoch no earlier call used), and every block sums
//     the sample's clusters in cluster order once each word carries the
//     epoch: one device-memory exchange a call, every sample at once, and
//     nothing zeroed: one device operation a call. The launch carries the
//     cooperative attribute beside the cluster dimension (the card takes
//     both), so the clusters that wait on each other are co-resident.
//   - pass B: dx from the same slots, written over x in the slot and stored
//     by one bulk copy a chunk; a slot is released once that copy has read
//     it.
// Measured on one H100 80GB HBM3 at 700 W (kernels/attention_sources.py
// --kernel k1bwdbf16, card clock, two rounds, the earlier design's source
// in the call; PERF.md section 6): res 128 / 64 at B 16 0.0569 /
// 0.0197-0.0199 ms against 0.0797-0.0811 / 0.0514-0.0518. The alternatives
// in the same call: every block a cluster of its own, the hand-off through
// device memory alone, 0.6022 / 0.2263 (not understood); two clusters of 4
// a sample in two waves 0.1222 / 0.0498-0.0503; one cluster of 8 a sample
// at two blocks an SM (16 KB chunks) 0.0806-0.0811 / 0.0318; 16 compute
// warps at C 64 0.0578-0.0579 / 0.0203-0.0204, 12 0.0569-0.0575 /
// 0.0197-0.0198; one group of 8 warps 0.0560-0.0561 / 0.0200-0.0201;
// chunks of 16 KB 0.0569-0.0571 / 0.0198-0.0199; pass A's copies of the
// rows read again evict-last 0.0577-0.0578 at res 128, evict-first
// 0.0604-0.0627. Diagnostics: with no copies 0.0429-0.0431, no stores
// 0.0438-0.0439, no pass-B arithmetic 0.0516-0.0519, no pass-A arithmetic
// 0.0557-0.0559: pass A waits on its bytes, pass B on its arithmetic (two
// MUFU operations an element) and its stores. Block by block
// (kernels/k1bwdbf16_trace.py, res 128): pass A ends at a median 24.8 us
// (the latest block 27.4), the hand-off at 30.2, pass B at 48.9.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "k1_bwd_plan.h"
#include "tma_ring.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kStatsThreads = 256;
constexpr int kStatsCluster = 8;  // blocks a sample at most: the portable cluster size
constexpr int kStatsMinRows = 256;  // rows a block at least, where a sample has them
constexpr int kStatsUnroll = 8;   // rows a thread loads before it adds them
constexpr int kApplyThreads = 256;
constexpr int kApplyBlocksPerSm = 4;
constexpr int kApplyStages = 6;   // a thread's 16-byte copies in flight

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15u) == 0; }

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

// close this thread's cp.async copies issued since the last commit into one
// group; wait until at most N of its groups are still in flight
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// an activation element as fp32, and an fp32 value stored as one
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// elements of T in one 16-byte vector
template <typename T>
constexpr int kVec = 16 / (int)sizeof(T);

// V values of T as loaded: one 16-byte word, or one element (V = 1)
template <typename T, int V>
struct Chunk {
  uint4 u;
};
template <typename T>
struct Chunk<T, 1> {
  T u;
};

// V values at p: for V > 1 one 16-byte load through the non-coherent path,
// not kept in L1 (p 16-byte aligned)
template <int V, typename T>
__device__ __forceinline__ Chunk<T, V> load_chunk(const T* p) {
  Chunk<T, V> k;
  if constexpr (V == 1) {
    k.u = *p;
  } else {
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(k.u.x), "=r"(k.u.y), "=r"(k.u.z), "=r"(k.u.w) : "l"(p));
  }
  return k;
}

template <int V, typename T>
__device__ __forceinline__ void widen(const Chunk<T, V>& k, float* a) {
  if constexpr (V == 1) {
    a[0] = to_f(k.u);
  } else {
    const unsigned w[4] = {k.u.x, k.u.y, k.u.z, k.u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 2) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        a[2 * i] = f.x;
        a[2 * i + 1] = f.y;
      } else {
        a[i] = __uint_as_float(w[i]);
      }
    }
  }
}

// V values stored at p, each rounded once to T (V > 1: one 16-byte
// streaming store, marked first to evict from L2)
template <int V, typename T>
__device__ __forceinline__ void store_chunk(T* p, const float* a) {
  if constexpr (V == 1) {
    store_f(p, a[0]);
  } else {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 2) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
        w[i] = *reinterpret_cast<const unsigned*>(&h);
      } else {
        w[i] = __float_as_uint(a[i]);
      }
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
}

// The first row of part i of n rows cut into `parts` contiguous parts (none
// empty where parts <= n)
__host__ __device__ __forceinline__ int part_begin(int i, int parts, int n) {
  return (int)((long long)i * n / parts);
}

// A block's threads over V-channel chunks: `lanes` consecutive chunks of a
// row (at most the block's threads; wider rows go in passes of `lanes`),
// `slots` rows at a time
struct FwdLanes {
  int lanes, slots;
  __host__ __device__ FwdLanes(int c, int v, int threads) {
    lanes = c / v < threads ? c / v : threads;
    slots = threads / lanes;
  }
};

// sums and sumsq of one sample's channels: see the header
template <int V, typename T>
__global__ void __launch_bounds__(kStatsThreads)
channel_stats_kernel(const T* __restrict__ x, float* __restrict__ sums,
                     float* __restrict__ sumsq, int n, int c) {
  __shared__ float red[2 * kStatsThreads * V];   // partial sets: sums, then squares
  __shared__ float part[2 * kStatsThreads * V];  // the block's partials of a pass
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ranks = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  const int row0 = part_begin(rank, ranks, n), row_end = part_begin(rank + 1, ranks, n);
  const FwdLanes ln(c, V, kStatsThreads);
  const int lane = threadIdx.x % ln.lanes, slot = threadIdx.x / ln.lanes;
  // a warp's slots summed by a butterfly where it holds whole slots
  const bool shuffle = ln.lanes <= 32 && 32 % ln.lanes == 0;
  const int sets = shuffle ? kStatsThreads / 32 : ln.slots;
  const int set = shuffle ? threadIdx.x / 32 : slot;
  const int width = ln.lanes * V;  // channels of a pass
  const int chunks = c / V;
  const T* xb = x + (size_t)b * n * c;
  for (int l0 = 0; l0 < chunks; l0 += ln.lanes) {
    const int ch = (l0 + lane) * V;
    const bool active = slot < ln.slots && ch < c;
    float s[V], ss[V];
#pragma unroll
    for (int v = 0; v < V; ++v) s[v] = ss[v] = 0.f;
    if (active) {
      for (int r = row0 + slot; r < row_end; r += kStatsUnroll * ln.slots) {
        Chunk<T, V> raw[kStatsUnroll];
#pragma unroll
        for (int u = 0; u < kStatsUnroll; ++u)
          if (r + u * ln.slots < row_end)
            raw[u] = load_chunk<V>(xb + (size_t)(r + u * ln.slots) * c + ch);
#pragma unroll
        for (int u = 0; u < kStatsUnroll; ++u) {
          if (r + u * ln.slots < row_end) {
            float a[V];
            widen(raw[u], a);
#pragma unroll
            for (int v = 0; v < V; ++v) {
              s[v] += a[v];
              ss[v] += a[v] * a[v];
            }
          }
        }
      }
    }
    if (shuffle) {
      for (int m = ln.lanes; m < 32; m *= 2) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          s[v] += __shfl_xor_sync(0xffffffffu, s[v], m);
          ss[v] += __shfl_xor_sync(0xffffffffu, ss[v], m);
        }
      }
    }
    if (active && (!shuffle || threadIdx.x % 32 < ln.lanes)) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        red[set * width + lane * V + v] = s[v];
        red[(sets + set) * width + lane * V + v] = ss[v];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * width; i += kStatsThreads) {
      const int e = i % width;
      const float* src = red + (i < width ? 0 : sets * width) + e;
      if (l0 * V + e < c) {
        float t = src[0];
        for (int k = 1; k < sets; ++k) t += src[k * width];
        part[i] = t;
      }
    }
    cluster.sync();  // every rank's partials are in its shared memory
    if (rank == 0) {
      for (int i = threadIdx.x; i < 2 * width; i += kStatsThreads) {
        const int e = i % width;
        if (l0 * V + e < c) {
          float t = part[i];
          for (int q = 1; q < ranks; ++q) t += cluster.map_shared_rank(part, q)[i];
          (i < width ? sums : sumsq)[(size_t)b * c + l0 * V + e] = t;
        }
      }
    }
    cluster.sync();  // rank 0 has read them: the next pass, or the exit, may follow
  }
}

// silu(y) for the instance of T: bf16 by __expf and __fdividef (one bf16
// rounding follows), fp32 by expf and an IEEE divide
template <typename T>
__device__ __forceinline__ float silu(float y) {
  if constexpr (sizeof(T) == 2)
    return __fdividef(y, 1.f + __expf(-y));
  else
    return y / (1.f + expf(-y));
}

// silu(x * a + b) over a contiguous run of one sample's rows: see the header
template <int V, typename T>
__global__ void __launch_bounds__(kApplyThreads, kApplyBlocksPerSm)
gn_silu_apply_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const float* __restrict__ sums,
                     const float* __restrict__ sumsq, T* __restrict__ out,
                     int n, int c, int groups, float eps) {
  const int b = blockIdx.y;
  const FwdLanes ln(c, V, kApplyThreads);
  const int lane = threadIdx.x % ln.lanes, slot = threadIdx.x / ln.lanes;
  if (slot >= ln.slots) return;
  // this thread's rows: first, first + slots, ... below row_end
  const int row_end = part_begin(blockIdx.x + 1, gridDim.x, n);
  const int first = part_begin(blockIdx.x, gridDim.x, n) + slot;
  const int per = c / groups;
  const float cnt = (float)n * (float)per;
  const size_t base = (size_t)b * n * c;
  const float *sb = sums + (size_t)b * c, *qb = sumsq + (size_t)b * c;
  const float *gb = gamma + (size_t)b * c, *bb = beta + (size_t)b * c;
  // each thread's ring of kApplyStages 16-byte slots (V > 1), consecutive
  // threads in consecutive slots
  __shared__ uint4 ring[V > 1 ? kApplyStages * kApplyThreads : 1];
  for (int l = lane; l < c / V; l += ln.lanes) {
    const int ch = l * V;
    const T* xc = x + base + ch;
    T* oc = out + base + ch;
    if constexpr (V > 1) {  // the first rows in flight while the scales are folded
#pragma unroll
      for (int s = 0; s < kApplyStages; ++s) {
        const int r = first + s * ln.slots;
        if (r < row_end) cp_async16(reinterpret_cast<T*>(ring + s * kApplyThreads + threadIdx.x), xc + (size_t)r * c);
        cp_async_commit();
      }
    }
    float a[V], sh[V];
    int g_prev = -1;
    float mean = 0.f, rstd = 0.f;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int g0 = (ch + v) / per * per;
      if (g0 != g_prev) {  // the group's mean and rstd, once a group
        float s = 0.f, ss = 0.f;
        for (int k = 0; k < per; ++k) {
          s += sb[g0 + k];
          ss += qb[g0 + k];
        }
        mean = s / cnt;
        rstd = rsqrtf(fmaxf(ss / cnt - mean * mean, 0.f) + eps);
        g_prev = g0;
      }
      a[v] = gb[ch + v] * rstd;
      sh[v] = bb[ch + v] - a[v] * mean;
    }
    int st = 0;
    for (int r = first; r < row_end; r += ln.slots) {
      Chunk<T, V> k;
      if constexpr (V > 1) {
        cp_async_wait<kApplyStages - 1>();  // row r's copy has landed
        k.u = ring[st * kApplyThreads + threadIdx.x];
      } else {
        k.u = xc[(size_t)r * c];
      }
      float y[V];
      widen(k, y);
#pragma unroll
      for (int v = 0; v < V; ++v) y[v] = silu<T>(y[v] * a[v] + sh[v]);
      store_chunk<V>(oc + (size_t)r * c, y);
      if constexpr (V > 1) {  // the slot, read into y, takes the row kApplyStages on
        const int r_next = r + kApplyStages * ln.slots;
        if (r_next < row_end)
          cp_async16(reinterpret_cast<T*>(ring + st * kApplyThreads + threadIdx.x), xc + (size_t)r_next * c);
        cp_async_commit();
        st = st + 1 == kApplyStages ? 0 : st + 1;
      }
    }
  }
}

// The statistics pass's blocks a sample, its cluster: the largest power of
// two up to kStatsCluster that leaves each block kStatsMinRows rows, or 1
int stats_cluster(int n) {
  int cl = kStatsCluster;
  while (cl > 1 && (long long)cl * kStatsMinRows > n) cl /= 2;
  return cl;
}

// The apply's blocks a sample on `sms` SMs: about kApplyBlocksPerSm blocks
// an SM over the batch, at most one per `slots` rows of the sample
int apply_blocks(int b, int n, int c, int v, int sms) {
  const FwdLanes ln(c, v, kApplyThreads);
  const long long want = ((long long)kApplyBlocksPerSm * sms + b - 1) / b;
  const long long cap = ((long long)n + ln.slots - 1) / ln.slots;
  return (int)(want < cap ? (want > 1 ? want : 1) : cap);
}

// The instance's V: one 16-byte vector of T where C takes whole vectors and
// the tensors are 16-byte aligned, else 1
template <typename T>
int fwd_vec(int c, const void* x, const void* out) {
  return c % kVec<T> == 0 && aligned16(x) && (out == nullptr || aligned16(out)) ? kVec<T> : 1;
}

template <int V, typename T>
int stats_launch(const T* x, float* sums, float* sumsq, int b, int n, int c, void* stream) {
  const int cl = stats_cluster(n);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, b);
  cfg.blockDim = dim3(kStatsThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, channel_stats_kernel<V, T>, x, sums, sumsq, n, c);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int stats_fwd(const T* x, float* sums, float* sumsq, int b, int n, int c, void* stream) {
  if (b < 1 || n < 1 || c < 1) return (int)cudaErrorInvalidValue;
  return fwd_vec<T>(c, x, nullptr) > 1 ? stats_launch<kVec<T>>(x, sums, sumsq, b, n, c, stream)
                                       : stats_launch<1>(x, sums, sumsq, b, n, c, stream);
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

// mbarriers (csrc/tma_ring.cuh): a phase completes when `count` arrivals are
// in; a waiter names the parity of the phase it waits for
using tma::mbar_arrive;
using tma::mbar_arrive_copies;
using tma::mbar_init;
using tma::mbar_wait;

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

template <int V>
__device__ __forceinline__ void store_v_streaming(float* p, const float* a) {
  if constexpr (V == 4)
    __stcs(reinterpret_cast<float4*>(p), make_float4(a[0], a[1], a[2], a[3]));
  else
    __stcs(p, a[0]);
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
// (the last answer kept; the forward's apply reads it too)
int device_info(int* sms, int* coop) {
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

template <typename T>
int apply_fwd(const T* x, const float* gamma, const float* beta, const float* sums,
              const float* sumsq, T* out, int b, int n, int c, int groups, float eps,
              void* stream) {
  if (b < 1 || n < 1 || c < 1 || groups < 1 || c % groups) return (int)cudaErrorInvalidValue;
  int sms = 0, coop = 0;
  const int rc = device_info(&sms, &coop);
  if (rc) return rc;
  const int v = fwd_vec<T>(c, x, out);
  const dim3 grid(apply_blocks(b, n, c, v, sms), b);
  if (v > 1)
    gn_silu_apply_kernel<kVec<T>><<<grid, kApplyThreads, 0, (cudaStream_t)stream>>>(
        x, gamma, beta, sums, sumsq, out, n, c, groups, eps);
  else
    gn_silu_apply_kernel<1><<<grid, kApplyThreads, 0, (cudaStream_t)stream>>>(
        x, gamma, beta, sums, sumsq, out, n, c, groups, eps);
  return (int)cudaGetLastError();
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
  int rc = device_info(&sms, &coop);
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


// ---------------------------------------------------------------------------
// bf16 backward: one launch on thread-block clusters (the header's note)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

struct ClusterArgs {
  const bf16 *x, *g;
  const float *gamma, *beta, *sums, *sumsq;
  float *dgamma, *dbeta;
  bf16* dx;
  unsigned long long* xchg;  // (B, clusters, 2C) tagged words where clusters > 1
  unsigned epoch;            // this call's tag
  int batch, n, c, groups;
  float eps;
  k1bwd::Plan pl;
};

// the kC compute threads alone (named barrier 1)
template <int kC>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kC) : "memory");
}

// 16 bytes of shared memory at a shared address (16-byte aligned)
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 u;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w) : "r"(addr));
  return u;
}

__device__ __forceinline__ void sts128(uint32_t addr, const uint4& u) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "r"(addr), "r"(u.x), "r"(u.y), "r"(u.z), "r"(u.w) : "memory");
}

// dy = g silu'(y) with the exponential and the reciprocal as one MUFU
// operation each (ex2 and rcp, flushing subnormals: e^-y under 2^-126
// leaves the sigmoid 1 either way)
__device__ __forceinline__ float dy_of(float gv, float y) {
  float e, sig;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(y * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(sig) : "f"(1.f + e));
  return gv * sig * (1.f + y * (1.f - sig));
}

__device__ __forceinline__ void widen8(const uint4& u, float* a) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    a[2 * i] = f.x;
    a[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 round8(const float* a) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a[2 * i], a[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The roles (see the header): warps 0 .. kC / 32 - 1 compute, the next warp
// (one thread) issues the copies. A block is rank `rank` of cluster `kc` of its sample
// group; group `grp` takes samples grp, grp + inflight, ... Its rows come in
// chunks through a ring of M slots: fill f into slot f % M, its full
// barrier's (f / M)-th phase; a sample's fills are pass A's chunks 0 ..
// chunks - 1, then the chunks read again, 0 .. again - 1.
template <int kC>
__global__ void __launch_bounds__(kC + 32, k1bwd::kBlocksPerSm)
gn_silu_bwd_cluster_kernel(const ClusterArgs p) {
  constexpr int kV = k1bwd::kVec;
  extern __shared__ __align__(128) unsigned char smem[];
  const k1bwd::Plan& pl = p.pl;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty = full + pl.slots;
  unsigned long long* ready = empty + pl.slots;  // the cluster's partials are in
  unsigned long long* done = ready + 1;          // the cluster has read this block's
  unsigned char* data = smem + pl.data_off;
  float* red = reinterpret_cast<float*>(smem + pl.red_off);
  float* part = reinterpret_cast<float*>(smem + pl.part_off);
  float* tot = reinterpret_cast<float*>(smem + pl.tot_off);
  float* gstat = reinterpret_cast<float*>(smem + pl.gstat_off);
  float* mm = reinterpret_cast<float*>(smem + pl.mm_off);
  float* vec = reinterpret_cast<float*>(smem + pl.vec_off);  // sums, sumsq, gamma, beta
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / pl.cluster;
  const int grp = cid / pl.clusters, kc = cid % pl.clusters;
  const int j = kc * pl.cluster + rank;  // the block's part of its sample
  const int c = p.c, n = p.n, cr = pl.chunk_rows;
  const int row0 = k1bwd::part_begin(j, pl.blocks, n);
  const int rows = k1bwd::part_begin(j + 1, pl.blocks, n) - row0;
  const int chunks = (rows + cr - 1) / cr, M = pl.slots;
  // the last `kept` chunks of pass A stay in their slots for pass B; the
  // first `again` are read again
  const int kept = chunks < M ? chunks : M, again = chunks - kept;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < pl.slots; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kC / 32 / k1bwd::kGroups);  // a group's warps
    }
    mbar_init(ready, pl.cluster);
    mbar_init(done, pl.cluster);
    tma::fence_barrier_init();
  }
  cluster.sync();  // every rank's barriers are set before any rank arrives on them
  const int half = pl.slot_bytes / 2;  // a slot: x's rows, then g's

  if (warp == kC / 32) {
    if (lane == 0) {
      const uint64_t keep = tma::policy_evict_normal(), once = tma::policy_evict_first();
      int f0 = 0;  // the ring's fills before this sample's
      for (int b = grp; b < p.batch; b += pl.inflight) {
        const size_t base = ((size_t)b * n + row0) * c;
        // chunk q into the slot of fill f, once fill f - slots is released
        auto load = [&](int f, int q, uint64_t pol) {
          const int s = f % M;
          if (f >= M) mbar_wait(empty + s, (f / M - 1) & 1);
          const int nr = min(cr, rows - q * cr);
          const unsigned bytes = (unsigned)(nr * c * 2);
          tma::mbar_expect_tx(full + s, 2 * bytes);
          unsigned char* dst = data + (size_t)s * pl.slot_bytes;
          tma::bulk_load(dst, p.x + base + (size_t)q * cr * c, bytes, full + s, pol);
          tma::bulk_load(dst + half, p.g + base + (size_t)q * cr * c, bytes, full + s, pol);
        };
        // pass A's copies of the chunks read again at normal L2 priority, the
        // others evicted first
        for (int q = 0; q < chunks; ++q) load(f0 + q, q, q < again ? keep : once);
        for (int j = 0; j < again; ++j) load(f0 + chunks + j, again - 1 - j, once);
        f0 += chunks + again;
      }
    }
    return;
  }

  // group gi takes chunks (pass B: visits) gi, gi + kGroups, ...; its thread
  // gt V channels (ch) of every rs-th row from its slot on
  constexpr int kG = k1bwd::kGroups, kGT = kC / kG;
  const int tid = threadIdx.x, lanes = pl.lanes, rs = pl.row_slots;
  const int gi = tid / kGT, gt = tid % kGT, gw = gt / 32;
  const int slot = gt / lanes, ch = (gt % lanes) * kV;
  const bool active = slot < rs;
  const bool shuffle = lanes <= 32 && 32 % lanes == 0;
  const int groups = p.groups, per = c / groups;
  const float cnt = (float)n * (float)per, inv_cnt = 1.f / cnt;
  const int w2 = 2 * c;
  const uint32_t data_addr = tma::smem_u32(data);
  const uint64_t once = tma::policy_evict_first();
  int f0 = 0;
  for (int b = grp, it = 0; b < p.batch; b += pl.inflight, ++it) {
    // the sample's sums, sumsq, gamma and beta into shared memory (their
    // loads issued together), then each group's mean and rstd in channel
    // order
    for (int i = tid; i < c; i += kC) {
      const size_t o = (size_t)b * c + i;
      const float s1 = __ldg(p.sums + o), s2 = __ldg(p.sumsq + o);
      const float s3 = __ldg(p.gamma + o), s4 = __ldg(p.beta + o);
      vec[i] = s1;
      vec[c + i] = s2;
      vec[2 * c + i] = s3;
      vec[3 * c + i] = s4;
    }
    consumer_sync<kC>();
    for (int k = tid; k < groups; k += kC) {
      float s = 0.f, ss = 0.f;
      for (int i = 0; i < per; ++i) {
        s += vec[k * per + i];
        ss += vec[c + k * per + i];
      }
      const float mean = s * inv_cnt;
      gstat[k] = mean;
      gstat[groups + k] = rsqrtf(fmaxf(ss * inv_cnt - mean * mean, 0.f) + p.eps);
    }
    consumer_sync<kC>();
    // xhat = x rstd - mean rstd
    float nmr[kV], rstd[kV], ga[kV], be[kV], sg[kV], sbv[kV];
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int k = (ch + v) / per;
      rstd[v] = gstat[groups + k];
      nmr[v] = -gstat[k] * rstd[v];
      ga[v] = vec[2 * c + ch + v];
      be[v] = vec[3 * c + ch + v];
      sg[v] = sbv[v] = 0.f;
    }

    // pass A: each thread over its rows in order, chunk by chunk (fill f0 + q)
    for (int q = gi; q < chunks; q += kG) {
      const int s = (f0 + q) % M;
      mbar_wait(full + s, ((f0 + q) / M) & 1);
      const uint32_t sx = data_addr + s * pl.slot_bytes, sgr = sx + half;
      const int nr = min(cr, rows - q * cr);
      if (active) {
        for (int r = slot; r < nr; r += rs) {
          float xv[kV], gv[kV];
          widen8(lds128(sx + 2 * (r * c + ch)), xv);
          widen8(lds128(sgr + 2 * (r * c + ch)), gv);
#pragma unroll
          for (int v = 0; v < kV; ++v) {
            const float xhat = fmaf(xv[v], rstd[v], nmr[v]);
            const float dy = dy_of(gv[v], xhat * ga[v] + be[v]);
            sg[v] += dy * xhat;
            sbv[v] += dy;
          }
        }
      }
      if (q < again) {  // a kept chunk's slot is released in pass B
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
      }
    }

    // the block's partials: a butterfly over a warp's row slots where it
    // holds whole slots, then the sets (warps, or slots) in order
    int set = gi * rs + slot;
    if (shuffle) {
      for (int m = lanes; m < 32; m *= 2) {
#pragma unroll
        for (int v = 0; v < kV; ++v) {
          sg[v] += __shfl_xor_sync(0xffffffffu, sg[v], m);
          sbv[v] += __shfl_xor_sync(0xffffffffu, sbv[v], m);
        }
      }
      set = warp;
    }
    if (active && (!shuffle || lane < lanes)) {
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        red[set * w2 + ch + v] = sg[v];
        red[set * w2 + c + ch + v] = sbv[v];
      }
    }
    consumer_sync<kC>();
    for (int i = tid; i < w2; i += kC) {
      float t = 0.f;
      for (int k = 0; k < pl.sets; ++k) t += red[k * w2 + i];
      part[i] = t;
    }
    consumer_sync<kC>();
    // the hand-off: each rank's partial to every rank, summed in rank order
    if (tid == 0) {
      tma::fence_acq_rel_cluster();
      for (int q = 0; q < pl.cluster; ++q) tma::mbar_arrive_rank(ready, q);
    }
    tma::mbar_wait_cluster(ready, it & 1);
    const uint32_t part_addr = tma::smem_u32(part);
    for (int i = 4 * tid; i < w2; i += 4 * kC) {
      float4 t = tma::ld_cluster_f4(tma::map_rank(part_addr + 4 * i, 0));
      for (int q = 1; q < pl.cluster; ++q) {
        const float4 u = tma::ld_cluster_f4(tma::map_rank(part_addr + 4 * i, q));
        t.x += u.x;
        t.y += u.y;
        t.z += u.z;
        t.w += u.w;
      }
      *reinterpret_cast<float4*>(tot + i) = t;
    }
    consumer_sync<kC>();
    if (tid == 0) {  // this block has read every rank's partial
      tma::fence_acq_rel_cluster();
      for (int q = 0; q < pl.cluster; ++q) tma::mbar_arrive_rank(done, q);
    }
    if (pl.clusters > 1) {
      // a sample over several clusters: rank 0 of each leaves its cluster's
      // sums as words tagged with the call's epoch; every block sums the
      // sample's clusters in cluster order
      unsigned long long* w = p.xchg + (size_t)b * pl.clusters * w2;
      const unsigned long long tag = (unsigned long long)p.epoch << 32;
      if (rank == 0)
        for (int i = tid; i < w2; i += kC)
          store_relaxed(w + (size_t)kc * w2 + i, tag | __float_as_uint(tot[i]));
      for (int i = tid; i < w2; i += kC) {
        float t = 0.f;
        for (int k = 0; k < pl.clusters; ++k) {
          unsigned long long u = load_relaxed(w + (size_t)k * w2 + i);
          while ((unsigned)(u >> 32) != p.epoch) {
            __nanosleep(32);
            u = load_relaxed(w + (size_t)k * w2 + i);
          }
          t += __uint_as_float((unsigned)u);
        }
        tot[i] = t;
      }
      consumer_sync<kC>();
    }
    // dgamma and dbeta by one block a sample; m1 and m2 of each group
    if (j == 0)
      for (int i = tid; i < w2; i += kC)
        (i < c ? p.dgamma : p.dbeta)[(size_t)b * c + (i < c ? i : i - c)] = tot[i];
    for (int k = tid; k < groups; k += kC) {
      float s1 = 0.f, s2 = 0.f;
      for (int i = 0; i < per; ++i) {
        const float gk = vec[2 * c + k * per + i];
        s1 += gk * tot[c + k * per + i];
        s2 += gk * tot[k * per + i];
      }
      mm[k] = s1 / cnt;
      mm[groups + k] = s2 / cnt;
    }
    consumer_sync<kC>();
    // dx = rstd (dy gamma - m1 - xhat m2) = dy (rstd gamma) + xhat (-rstd m2) - rstd m1
    float p1[kV], p2[kV], p3[kV];
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      p1[v] = rstd[v] * ga[v];
      p2[v] = -rstd[v] * mm[groups + (ch + v) / per];
      p3[v] = -rstd[v] * mm[(ch + v) / per];
    }

    // pass B: dx, rounded once, written over x in the slot and stored from
    // there by one bulk copy a chunk; the kept chunks first (their slots
    // then take the chunks read again: fills f0 + chunks ..), then the
    // chunks read again, the last read first (the likeliest still in L2). A
    // slot is released once the copy out of it has read it, a chunk later.
    bf16* dxb = p.dx + ((size_t)b * n + row0) * c;
    int prev = -1;
    for (int i = gi; i < chunks; i += kG) {
      const int q = i < kept ? again + i : chunks - 1 - i;
      const int f = i < kept ? f0 + q : f0 + chunks + (i - kept), s = f % M;
      if (i >= kept) mbar_wait(full + s, (f / M) & 1);
      const uint32_t sx = data_addr + s * pl.slot_bytes, sgr = sx + half;
      const int nr = min(cr, rows - q * cr);
      if (active) {
        for (int r = slot; r < nr; r += rs) {
          float xv[kV], gv[kV], d[kV];
          widen8(lds128(sx + 2 * (r * c + ch)), xv);
          widen8(lds128(sgr + 2 * (r * c + ch)), gv);
#pragma unroll
          for (int v = 0; v < kV; ++v) {
            const float xhat = fmaf(xv[v], rstd[v], nmr[v]);
            const float dy = dy_of(gv[v], xhat * ga[v] + be[v]);
            d[v] = fmaf(dy, p1[v], fmaf(xhat, p2[v], p3[v]));
          }
          sts128(sx + 2 * (r * c + ch), round8(d));
        }
      }
      // the group's rows of the chunk are in: one thread stores them, and
      // releases the previous chunk's slot (for the group's warps) once its
      // store has read it
      tma::fence_proxy_async_shared();
      tma::bar_sync(2 + gi, kGT);
      if (gt == 0) {
        tma::bulk_store(dxb + (size_t)q * cr * c, data + (size_t)s * pl.slot_bytes,
                        2 * nr * c, once);
        tma::store_commit();
        if (prev >= 0) {
          tma::store_wait_read<1>();
          tma::mbar_arrive_n(empty + prev, kGT / 32);
        }
        prev = s;
      }
    }
    if (gt == 0 && prev >= 0) {
      tma::store_wait_read<0>();
      tma::mbar_arrive_n(empty + prev, kGT / 32);
    }
    f0 += chunks + again;
    // every rank has read this block's partial: it may be written again, or
    // the block leave
    tma::mbar_wait_cluster(done, it & 1);
  }
}

// Clusters of 1, 2, 4 and 8 blocks of the bf16 backward's instance of kC
// compute threads the current card holds at once at the plan's shared memory
// budget (the last answer kept a device), after raising the kernel's dynamic
// shared memory cap
template <int kC>
int bwd_bf16_active(int* active) {
  static int last_dev = -1, last[4] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != last_dev) {
    e = cudaFuncSetAttribute(gn_silu_bwd_cluster_kernel<kC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, k1bwd::kSmemBudget);
    for (int i = 0; i < 4 && e == cudaSuccess; ++i) {
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = 1u << i;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(1u << i);
      cfg.blockDim = dim3(kC + 32);
      cfg.dynamicSmemBytes = k1bwd::kSmemBudget;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      e = cudaOccupancyMaxActiveClusters(&last[i], gn_silu_bwd_cluster_kernel<kC>, &cfg);
    }
    if (e != cudaSuccess) return (int)e;
    last_dev = dev;
  }
  for (int i = 0; i < 4; ++i) active[i] = last[i];
  return 0;
}

// The plan of a bf16 call on the current card, and the clusters its
// instance's launch may hold at once
int bwd_bf16_plan(int b, int n, int c, int groups, k1bwd::Plan* pl, int* active) {
  int sms = 0, coop = 0;
  int rc = device_info(&sms, &coop);
  if (rc == 0)
    rc = k1bwd::consumers_for(c) == k1bwd::kNarrowConsumers
             ? bwd_bf16_active<k1bwd::kNarrowConsumers>(active)
             : bwd_bf16_active<k1bwd::kWideConsumers>(active);
  if (rc) return rc;
  return k1bwd::plan(b, n, c, groups, sms, active, pl) ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x (B, N, C); sums and sumsq (B, C), written whole (no zeroing needed). One
// cluster launch; returns a cudaError_t code.
int mc_channel_stats(const float* x, float* sums, float* sumsq, int b, int n,
                     int c, void* stream) {
  return stats_fwd(x, sums, sumsq, b, n, c, stream);
}

// x and out (B, N, C); gamma, beta, sums, sumsq (B, C) fp32.
int mc_gn_silu(const float* x, const float* gamma, const float* beta,
               const float* sums, const float* sumsq, float* out, int b, int n,
               int c, int groups, float eps, void* stream) {
  return apply_fwd(x, gamma, beta, sums, sumsq, out, b, n, c, groups, eps, stream);
}

// The bf16 instances: x and out bf16; sums, sumsq, gamma, beta fp32.
int mc_channel_stats_bf16(const __nv_bfloat16* x, float* sums, float* sumsq, int b,
                          int n, int c, void* stream) {
  return stats_fwd(x, sums, sumsq, b, n, c, stream);
}

int mc_gn_silu_bf16(const __nv_bfloat16* x, const float* gamma, const float* beta,
                    const float* sums, const float* sumsq, __nv_bfloat16* out, int b,
                    int n, int c, int groups, float eps, void* stream) {
  return apply_fwd(x, gamma, beta, sums, sumsq, out, b, n, c, groups, eps, stream);
}

// The forward passes' launch plans at V channels a thread (1, or a 16-byte
// vector: 4 fp32, 8 bf16): the statistics pass's {blocks a sample (its
// cluster), lanes, slots} and the apply's {blocks a sample on the current
// card, lanes, slots, the card's SMs}, mirrored by kernels/fused_norm.py.
int mc_channel_stats_plan(int n, int c, int v, int* out) {
  if (n < 1 || c < 1 || v < 1 || c % v) return (int)cudaErrorInvalidValue;
  const FwdLanes ln(c, v, kStatsThreads);
  out[0] = stats_cluster(n);
  out[1] = ln.lanes;
  out[2] = ln.slots;
  return 0;
}

int mc_gn_silu_plan(int b, int n, int c, int v, int* out) {
  if (b < 1 || n < 1 || c < 1 || v < 1 || c % v) return (int)cudaErrorInvalidValue;
  int sms = 0, coop = 0;
  const int rc = device_info(&sms, &coop);
  if (rc) return rc;
  const FwdLanes ln(c, v, kApplyThreads);
  out[0] = apply_blocks(b, n, c, v, sms);
  out[1] = ln.lanes;
  out[2] = ln.slots;
  out[3] = sms;
  return 0;
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
  const int rc = device_info(sms, &coop);
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

// The bf16 backward (gn_silu_bwd_cluster_kernel): x, g, dx bf16 (C % 8 ==
// 0, C <= 2048, 16-byte aligned), gamma, beta, sums, sumsq, dgamma, dbeta
// fp32 (B, C). xchg: the plan's exchange words (mc_gn_silu_bwd_bf16_plan),
// kept by the caller from call to call, zeroed once when allocated, and
// `epoch` a tag no earlier call on them used (null and 0 where the plan
// has none). One launch; returns a cudaError_t code.
int mc_gn_silu_bwd_bf16(const bf16* x, const bf16* g, const float* gamma, const float* beta,
                        const float* sums, const float* sumsq, float* dgamma, float* dbeta,
                        bf16* dx, unsigned long long* xchg, unsigned epoch, int b, int n, int c,
                        int groups, float eps, void* stream) {
  ClusterArgs p{x, g, gamma, beta, sums, sumsq, dgamma, dbeta, dx, xchg, epoch,
                b, n, c, groups, eps, {}};
  int active[4];
  int rc = bwd_bf16_plan(b, n, c, groups, &p.pl, active);
  if (rc) return rc;
  if (!aligned16(x) || !aligned16(g) || !aligned16(dx)) return (int)cudaErrorInvalidValue;
  if (p.pl.clusters > 1 && (!xchg || epoch == 0)) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.pl.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // a sample over several clusters waits on the others: all co-resident
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.pl.grid);
  cfg.blockDim = dim3(p.pl.consumers + 32);
  cfg.dynamicSmemBytes = p.pl.smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = p.pl.clusters > 1 ? 2 : 1;
  const cudaError_t e =
      p.pl.consumers == k1bwd::kNarrowConsumers
          ? cudaLaunchKernelEx(&cfg, gn_silu_bwd_cluster_kernel<k1bwd::kNarrowConsumers>, p)
          : cudaLaunchKernelEx(&cfg, gn_silu_bwd_cluster_kernel<k1bwd::kWideConsumers>, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The bf16 backward's plan on the current card: out = {cluster, clusters,
// blocks, inflight, grid, waves, rows, chunk_rows, chunks, slots, lanes,
// row_slots, sets, slot_bytes, smem, xchg_words, consumers} (the fields of
// k1bwd::Plan), then the clusters of 1, 2, 4, 8 blocks the card holds at
// once and its SMs
int mc_gn_silu_bwd_bf16_plan(int b, int n, int c, int groups, long long* out) {
  k1bwd::Plan pl;
  int active[4];
  const int rc = bwd_bf16_plan(b, n, c, groups, &pl, active);
  if (rc) return rc;
  int sms = 0, coop = 0;
  device_info(&sms, &coop);
  const long long v[22] = {pl.cluster, pl.clusters, pl.blocks, pl.inflight, pl.grid,
                           pl.waves, pl.rows, pl.chunk_rows, pl.chunks, pl.slots, pl.lanes,
                           pl.row_slots, pl.sets, pl.slot_bytes, pl.smem, pl.xchg_words,
                           pl.consumers, active[0], active[1], active[2], active[3], sms};
  for (int i = 0; i < 22; ++i) out[i] = v[i];
  return 0;
}

}  // extern "C"
