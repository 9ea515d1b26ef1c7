// K4: fp32 softmax attention, softmax(q k^T / sqrt(D)) v, per head-batch,
// for (N, L, D) tensors with D = 64: the forward and its backward, on
// Hopper's tensor cores.
//
// Forward: replaces m_cedm_tpu/pallas/fused_attention.py::_fwd_kernel (via
// _pallas_fwd). The TPU kernel holds a whole head-batch and its (L, L) logits
// in VMEM and so refuses L above about 1600; this kernel never forms the
// (L, L) matrix and has no cap.
//
// Bound: at the flagship shape (N = 16, L = 1024) one call is 4.3 GFLOP on
// 12 MiB of q/k/v/o, about 350 FLOP per byte: arithmetic sets the time. On
// CUDA cores (67 TFLOP/s fp32) that is 0.064 ms; the card's arithmetic sits
// in its tensor cores (495 TFLOP/s TF32), which keep about 11 bits of each
// operand, too few for the 2e-5 the kernel is held to.
//
// 3xTF32. Every product of the kernels runs on mma.sync.m16n8k8 in TF32 with
// fp32 accumulation, each fp32 operand split as hi = tf32(x), lo = tf32(x -
// hi) and the product summed as lo*hi + hi*lo + hi*hi, small terms first:
// fp32 accuracy (the dropped lo*lo term is 2^-22 of the product) at three
// tensor-core products per fp32 product, a 0.026 ms bound at the flagship
// shape. The split rounds to nearest with cvt.rn.tf32.f32, one instruction
// on sm_90; ptxas expands cvt.rna (ties away from zero) into a finiteness
// test, an add and a select, and with it the forward took 0.124-0.128 ms
// against 0.087-0.088 (PERF.md section 6). The two differ only on exact ties,
// with the same bound. mma.sync and not wgmma: TF32 wgmma wants both operands
// K-major, and V as the B operand of P V is MN-major, so wgmma would need V
// transposed in shared memory (a later step).
//
// Tiling (flash-attention 2): a block of 4 warps owns 64 query rows, 16 per
// warp. q is held in registers as split A fragments for the whole walk; the
// keys and values stream through shared memory 64 rows at a time, in a ring
// of two stages filled by cp.async.cg (16 bytes a thread, zero-filled past
// L), so that tile j + 1 arrives while tile j is multiplied. A warp's S =
// q k^T is a 16 x 64 C fragment; the running max and sum are per row in
// registers (the max reduced over the four threads of a quad; the sum kept
// per thread and reduced once at the end), the output accumulator is 16 x 64
// per warp, rescaled by exp(m_old - m_new) in every fragment element of the
// row. Masked tail keys get s = -inf before the max; a tail query block
// stores nothing past L. scale = 1/8 is a power of two, so applying it to
// the dot is exact.
//
// From S to the A operand of P V: the C fragment of an m16n8 tile holds
// (g, 2t) and (g, 2t + 1) in thread (g = lane / 4, t = lane % 4), the TF32 A
// fragment of m16n8k8 wants (g, t) and (g, t + 4). No shuffle and no trip
// through shared memory: the sum over the 8 keys of a k-step may take them
// in any order, so k-index t stands for key 2t and k-index t + 4 for key
// 2t + 1. Then each thread's own C values are its A values, and the B
// fragment reads value rows 2t and 2t + 1 instead of t and t + 4.
//
// Shared memory rows are padded to 68 floats (68 = 4 mod 32): the B-fragment
// loads, b0 = (t, g) and b1 = (t + 4, g) of k^T ("col": key row g, width t)
// at bank 4g + t, and of V (row-major, key rows 2t / 2t + 1, width g) at
// bank 8t + g (+ 4), all fall on 32 distinct banks.
//
// Occupancy: 128 threads a block, at most 255 registers a thread (two blocks
// hold 256 * 255 of the SM's 65,536), and 2 stages * (k + v) * 64 * 68 * 4 B
// = 69,632 B of dynamic shared memory (two blocks take 139 KB of the SM's
// 228 KB). At N = 16, L = 1024 the grid is 16 x 16 = 256 blocks, all resident
// at once on the 132 SMs (two a SM).
//
// Backward: replaces m_cedm_tpu/pallas/fused_attention.py::_bwd_kernel (via
// _pallas_bwd). With P = softmax(s), s = q k^T / sqrt(D), g the output
// cotangent and o the forward output:
//   dv = P^T g;  dS = P * (g v^T - delta), delta_i = sum_d g_i o_i;
//   dq = dS k / sqrt(D);  dk = dS^T q / sqrt(D).
// The TPU kernel holds the (L, L) matrices of one head-batch in VMEM (4 MB
// each at L = 1024), which one SM's 227 KB of shared memory cannot. So the
// probabilities are rebuilt flash-style, tile by tile, from q, k and the saved
// log-sum-exp, and no (L, L) matrix exists. Two kernels, no atomics:
//   dq kernel    a block owns 64 query rows (q and g as split A fragments)
//                and walks every key tile: S = q k^T, P = exp(S / 8 - lse),
//                dP = g v^T, dS = P * (dP - delta), dq += dS k; it also
//                writes delta for the second kernel;
//   dk/dv kernel a block owns 64 key rows (k and v as split A fragments) and
//                walks every query tile: S^T = k q^T directly, so that P^T
//                lands in C layout with rows = keys, then dv += P^T g,
//                dP^T = v g^T, dk += dS^T q;
// so every dq, dk, dv is summed in registers and written once, in a fixed
// order: the result is bit-for-bit repeatable. Each recomputes S and dP, so
// the pair does 7 (L, L, D) products where the least work is 5; the price
// buys the absence of atomics on dq. Both run the same 3xTF32 mma.sync core
// on cp.async double-buffered tiles (k/v for the dq kernel, q/g with their
// lse and delta for the dk/dv kernel), with the same C-to-A key permutation
// for P^T and dS^T. A warp takes each 64-row tile 16 rows (two n-tiles) at a
// time, so that S and dP need 16 registers and leave room for two split
// operands (128 registers) and up to two accumulators (64).
//
// bf16: attention_fwd_bf16_kernel, attention_bwd_dq_bf16_kernel and
// attention_bwd_dkdv_bf16_kernel run every product on wgmma with bf16
// operands, P and dS split in three bf16 pieces; their note heads the bf16
// section below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_conv_tiles.cuh"

namespace {

constexpr int kD = 64;                 // head width
constexpr int kTile = 64;              // rows a block owns; rows per streamed tile
constexpr int kWarps = 4;              // 16 rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kStride = kD + 4;        // padded shared-memory row (floats)
constexpr int kTileFloats = kTile * kStride;
constexpr int kStages = 2;
constexpr int kKSteps = kD / 8;        // k-steps over the head width
constexpr int kNTiles = kTile / 8;     // 8-wide n-tiles over a 64-row tile

// ---------------------------------------------------------------------------
// 3xTF32 on mma.sync, cp.async
// ---------------------------------------------------------------------------

// an fp32 bit pattern with a 10-bit mantissa: on sm_90 one F2FP instruction,
// which leaves the 13 low bits zero
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rn.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo up to 2^-22 of x, both exact TF32 values
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// Split A fragment of an m16n8k8 product.
struct AFrag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void split_a(AFrag& a, float x0, float x1, float x2,
                                        float x3) {
  split(x0, a.hi[0], a.lo[0]);
  split(x1, a.hi[1], a.lo[1]);
  split(x2, a.hi[2], a.lo[2]);
  split(x3, a.hi[3], a.lo[3]);
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32, b given as its two fp32 values (rows t and t + 4 of
// the k-step, or the permuted rows 2t and 2t + 1)
__device__ __forceinline__ void mma3(float* c, const AFrag& a, float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(c, a.lo, bh0, bh1);
  mma_tf32(c, a.hi, bl0, bl1);
  mma_tf32(c, a.hi, bh0, bh1);
}

// The A fragment of the 8 keys of C tile `c` under the key permutation
// (k-index t = key 2t, k-index t + 4 = key 2t + 1): the thread's own values.
__device__ __forceinline__ void split_a_from_c(AFrag& a, const float* c) {
  split_a(a, c[0], c[2], c[1], c[3]);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(s), "l"(gmem), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// rows r0 .. r0 + 63 of one head-batch's (L, D) slice into a padded tile;
// rows past L are zero-filled (no bytes read)
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0, int L) {
#pragma unroll
  for (int i = 0; i < kTile * kD / 4 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / (kD / 4), c = (idx % (kD / 4)) * 4;
    const bool valid = r0 + r < L;
    cp_async16(dst + r * kStride + c, src + (size_t)(valid ? r0 + r : 0) * kD + c,
               valid);
  }
}

// The split A fragments of rows ra (g) and rb (g + 8) of an (L, D) slice for
// the 8 k-steps over the width; zero past L.
__device__ __forceinline__ void load_a(AFrag* a, const float* src, int ra, int rb,
                                       int L, int t) {
  const float* pa = src + (size_t)ra * kD;
  const float* pb = src + (size_t)rb * kD;
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    const int c = 8 * ks + t;
    split_a(a[ks], ra < L ? pa[c] : 0.f, rb < L ? pb[c] : 0.f,
            ra < L ? pa[c + 4] : 0.f, rb < L ? pb[c + 4] : 0.f);
  }
}

// c[j] += A (16 x 64 width) * tile^T for the NT n-tiles from nt0 (8 NT rows
// of the tile): the tile's rows are the product's columns ("col" B operand)
template <int NT>
__device__ __forceinline__ void mma_rows_t(float (*c)[4], const AFrag* a,
                                           const float* tile, int nt0, int g, int t) {
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* p = tile + (8 * (nt0 + j) + g) * kStride + 8 * ks + t;
      mma3(c[j], a[ks], p[0], p[4]);
    }
  }
}

// acc (16 x 64 width) += A * tile rows 8kk .. 8kk + 7 (row-major B operand,
// rows taken in the permuted order 2t, 2t + 1)
__device__ __forceinline__ void mma_rows(float (*acc)[4], const AFrag& a,
                                         const float* tile, int kk, int g, int t) {
  const float* p = tile + (8 * kk + 2 * t) * kStride + g;
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd) mma3(acc[nd], a, p[8 * nd], p[kStride + 8 * nd]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows ra (g) and rb (g + 8) of a 16 x 64 C accumulator, times mul, to an
// (L, D) slice
__device__ __forceinline__ void store_c(float* dst, const float (*acc)[4], int ra,
                                        int rb, int L, int t, float mul_a,
                                        float mul_b) {
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd) {
    const int c = 8 * nd + 2 * t;
    if (ra < L)
      *reinterpret_cast<float2*>(dst + (size_t)ra * kD + c) =
          make_float2(acc[nd][0] * mul_a, acc[nd][1] * mul_a);
    if (rb < L)
      *reinterpret_cast<float2*>(dst + (size_t)rb * kD + c) =
          make_float2(acc[nd][2] * mul_b, acc[nd][3] * mul_b);
  }
}

constexpr int kFwdSmem = kStages * 2 * kTileFloats * 4;
constexpr int kDkdvSmem = kStages * (2 * kTileFloats + 2 * kTile) * 4;

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 2)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int L, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;                          // [stage][64][68]
  float* sv = smem + kStages * kTileFloats;  // [stage][64][68]
  const size_t base = (size_t)blockIdx.y * L * kD;
  const float* kb = k + base;
  const float* vb = v + base;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ra = blockIdx.x * kTile + warp * 16 + g, rb = ra + 8;
  const int ntiles = (L + kTile - 1) / kTile;

  load_tile(sk, kb, 0, L);
  load_tile(sv, vb, 0, L);
  cp_commit();

  AFrag qa[kKSteps];
  load_a(qa, q + base, ra, rb, L, t);

  float acc[kD / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % kStages;
    if (j + 1 < ntiles) {
      load_tile(sk + (st ^ 1) * kTileFloats, kb, (j + 1) * kTile, L);
      load_tile(sv + (st ^ 1) * kTileFloats, vb, (j + 1) * kTile, L);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* ks_ = sk + st * kTileFloats;
    const float* vs_ = sv + st * kTileFloats;

    float s[kNTiles][4] = {};
    mma_rows_t<kNTiles>(s, qa, ks_, 0, g, t);  // S = q k^T

    // online softmax: rows g (elements 0, 1) and g + 8 (elements 2, 3)
    const int k0 = j * kTile;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = k0 + 8 * nt + 2 * t + (e & 1) < L;
        s[nt][e] = valid ? s[nt][e] * scale : -INFINITY;
        mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);  // finite: every tile has a key
      corr[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nd = 0; nd < kD / 8; ++nd) {
      acc[nd][0] *= corr[0];
      acc[nd][1] *= corr[0];
      acc[nd][2] *= corr[1];
      acc[nd][3] *= corr[1];
    }
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e / 2]);
        l[e / 2] += s[nt][e];
      }
    }

    // acc += P V, one k-step per 8 keys
#pragma unroll
    for (int kk = 0; kk < kNTiles; ++kk) {
      AFrag pa;
      split_a_from_c(pa, s[kk]);
      mma_rows(acc, pa, vs_, kk, g, t);
    }
    __syncthreads();
  }
  cp_wait<0>();

  const float la = quad_sum(l[0]), lb = quad_sum(l[1]);
  store_c(o + base, acc, ra, rb, L, t, 1.f / la, 1.f / lb);
  if (lse && t == 0) {
    if (ra < L) lse[(size_t)blockIdx.y * L + ra] = m[0] + logf(la);
    if (rb < L) lse[(size_t)blockIdx.y * L + rb] = m[1] + logf(lb);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 2)
attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ g, const float* __restrict__ lse,
                        float* __restrict__ delta, float* __restrict__ dq, int L,
                        float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sk = smem;
  float* sv = smem + kStages * kTileFloats;
  const size_t base = (size_t)blockIdx.y * L * kD;
  const float* kb = k + base;
  const float* vb = v + base;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;
  const int ra = blockIdx.x * kTile + warp * 16 + gr, rb = ra + 8;
  const int ntiles = (L + kTile - 1) / kTile;

  load_tile(sk, kb, 0, L);
  load_tile(sv, vb, 0, L);
  cp_commit();

  // delta_i = sum_d g_i o_i over the thread's 16 widths of each row, then
  // over the quad
  float dl[2] = {0.f, 0.f};
  {
    const float* ga = g + base + (size_t)ra * kD;
    const float* gb = g + base + (size_t)rb * kD;
    const float* oa = o + base + (size_t)ra * kD;
    const float* ob = o + base + (size_t)rb * kD;
#pragma unroll
    for (int c = t; c < kD; c += 4) {
      if (ra < L) dl[0] = fmaf(ga[c], oa[c], dl[0]);
      if (rb < L) dl[1] = fmaf(gb[c], ob[c], dl[1]);
    }
  }
  dl[0] = quad_sum(dl[0]);
  dl[1] = quad_sum(dl[1]);
  if (t == 0) {
    if (ra < L) delta[(size_t)blockIdx.y * L + ra] = dl[0];
    if (rb < L) delta[(size_t)blockIdx.y * L + rb] = dl[1];
  }
  const float lse_r[2] = {ra < L ? lse[(size_t)blockIdx.y * L + ra] : 0.f,
                          rb < L ? lse[(size_t)blockIdx.y * L + rb] : 0.f};

  AFrag qa[kKSteps], ga_[kKSteps];
  load_a(qa, q + base, ra, rb, L, t);
  load_a(ga_, g + base, ra, rb, L, t);

  float acc[kD / 8][4] = {};

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % kStages;
    if (j + 1 < ntiles) {
      load_tile(sk + (st ^ 1) * kTileFloats, kb, (j + 1) * kTile, L);
      load_tile(sv + (st ^ 1) * kTileFloats, vb, (j + 1) * kTile, L);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* ks_ = sk + st * kTileFloats;
    const float* vs_ = sv + st * kTileFloats;
    const int k0 = j * kTile;

#pragma unroll 1
    for (int nt0 = 0; nt0 < kNTiles; nt0 += 2) {
      float s[2][4] = {}, dp[2][4] = {};
      mma_rows_t<2>(s, qa, ks_, nt0, gr, t);    // S = q k^T
      mma_rows_t<2>(dp, ga_, vs_, nt0, gr, t);  // dP = g v^T
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool valid = k0 + 8 * (nt0 + jn) + 2 * t + (e & 1) < L;
          const float p = valid ? expf(s[jn][e] * scale - lse_r[e / 2]) : 0.f;
          s[jn][e] = p * (dp[jn][e] - dl[e / 2]);  // dS
        }
        AFrag da;
        split_a_from_c(da, s[jn]);
        mma_rows(acc, da, ks_, nt0 + jn, gr, t);  // dq += dS k
      }
    }
    __syncthreads();
  }
  cp_wait<0>();
  store_c(dq + base, acc, ra, rb, L, t, scale, scale);
}

__global__ void __launch_bounds__(kThreads, 2)
attention_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ g,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, float* __restrict__ dk,
                          float* __restrict__ dv, int L, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sq = smem;                                // [stage][64][68]
  float* sg = smem + kStages * kTileFloats;        // [stage][64][68]
  float* slse = smem + 2 * kStages * kTileFloats;  // [stage][64]
  float* sdl = slse + kStages * kTile;             // [stage][64]
  const size_t base = (size_t)blockIdx.y * L * kD;
  const float* qb = q + base;
  const float* gb = g + base;
  const float* lse_b = lse + (size_t)blockIdx.y * L;
  const float* dl_b = delta + (size_t)blockIdx.y * L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;
  const int ra = blockIdx.x * kTile + warp * 16 + gr, rb = ra + 8;  // key rows
  const int ntiles = (L + kTile - 1) / kTile;

  auto load = [&](int stage, int q0) {
    load_tile(sq + stage * kTileFloats, qb, q0, L);
    load_tile(sg + stage * kTileFloats, gb, q0, L);
    const int i = threadIdx.x % kTile;
    const bool valid = q0 + i < L;
    const int r = valid ? q0 + i : 0;
    if (threadIdx.x < kTile) cp_async4(slse + stage * kTile + i, lse_b + r, valid);
    else cp_async4(sdl + stage * kTile + i, dl_b + r, valid);
  };
  load(0, 0);
  cp_commit();

  AFrag ka[kKSteps], va[kKSteps];
  load_a(ka, k + base, ra, rb, L, t);
  load_a(va, v + base, ra, rb, L, t);

  float dka[kD / 8][4] = {}, dva[kD / 8][4] = {};

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % kStages;
    if (j + 1 < ntiles) load(st ^ 1, (j + 1) * kTile);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* qs_ = sq + st * kTileFloats;
    const float* gs_ = sg + st * kTileFloats;
    const float* ls_ = slse + st * kTile;
    const float* ds_ = sdl + st * kTile;
    const int q0 = j * kTile;

#pragma unroll 1
    for (int nt0 = 0; nt0 < kNTiles; nt0 += 2) {
      float s[2][4] = {}, dp[2][4] = {};
      mma_rows_t<2>(s, ka, qs_, nt0, gr, t);    // S^T = k q^T
      mma_rows_t<2>(dp, va, gs_, nt0, gr, t);   // dP^T = v g^T
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        // columns are queries: 2t, 2t + 1 of n-tile nt0 + jn
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * (nt0 + jn) + 2 * t + (e & 1);
          const float p = q0 + c < L ? expf(s[jn][e] * scale - ls_[c]) : 0.f;
          s[jn][e] = p;
          dp[jn][e] = p * (dp[jn][e] - ds_[c]);  // dS^T
        }
        AFrag pa;
        split_a_from_c(pa, s[jn]);
        mma_rows(dva, pa, gs_, nt0 + jn, gr, t);  // dv += P^T g
        split_a_from_c(pa, dp[jn]);
        mma_rows(dka, pa, qs_, nt0 + jn, gr, t);  // dk += dS^T q
      }
    }
    __syncthreads();
  }
  cp_wait<0>();
  store_c(dk + base, dka, ra, rb, L, t, scale, scale);
  store_c(dv + base, dva, ra, rb, L, t, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// bf16 on wgmma
// ---------------------------------------------------------------------------
//
// bf16 forward (attention_fwd_bf16_kernel): replaces
// m_cedm_tpu/pallas/fused_attention.py::_fwd_kernel (via _pallas_fwd) on bf16
// q, k, v, which upcasts them, runs both products and the softmax in fp32 and
// rounds the output once to bf16. bf16 backward (attention_bwd_dq_bf16_kernel,
// attention_bwd_dkdv_bf16_kernel): replaces _bwd_kernel (via _pallas_bwd) on
// bf16 q, k, v, g, which upcasts them, recomputes the softmax, forms every
// product in fp32 and rounds dq, dk and dv once.
//
// Bounds at the flagship shape (N = 16, L = 1024, D = 64), as PERF.md
// section 6 defines them: the least work that keeps fp32 accuracy, the
// products of two bf16 operands (S = q k^T, dP = g v^T) once and those with
// an fp32 operand (P V; dv = P^T g, dq = dS k, dk = dS^T q) as three bf16
// products (the split below), all at 989 TFLOP/s. Forward 4 bf16 products,
// 0.0087 ms; backward (5 products) 11, 0.0239 ms: operations, against 8.4
// MB (forward) and 18.9 MB (backward, dq, dk and dv included) of bf16
// operands and the fp32 o32 at 3.35 TB/s, 0.0025 and 0.0057 ms. (The
// TF32-split bound of the earlier kernels, a split product as two TF32
// products at 495: 0.0108 and 0.0304 ms.)
//
// Products. Every product is a wgmma m64n64k16 with bf16 operands and fp32
// accumulation. S = q k^T and dP = g v^T take their bf16 operands as they
// are: each product of two bf16 values is exact in fp32, as in TF32. The
// products with an fp32 operand (P V, P^T g, dS k, dS^T q) split P or dS in
// three bf16 pieces, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
// mid), and run three bf16 products against the bf16 operand, the small
// piece first. Rounding to nearest leaves a residual of at most half an ulp of
// the piece before, so each residual fits in the 8 bits of the next piece:
// hi + mid + lo is x exactly, since bf16 has fp32's exponent range (a
// residual below 2^-126 excepted, far under any tolerance here). The sum is
// then exact before the fp32 accumulation, where the two-TF32 split of the
// earlier kernels dropped x's last two bits. Counts: forward 1 + 3 = 4 bf16
// products for its 2 (L, L, D) products (2 a product: the bound's 0.0087
// ms); backward 2 + 3 (dq kernel) and 2 + 3 + 3 (dk/dv kernel) = 13 bf16
// products for its 7 (1.9 a product, 0.0282 ms at 989; the recomputed S and
// dP of the second kernel are 2 of the 13 above the bound's 11).
//
// Tiles. A block is one warpgroup (4 warps, 128 threads) that owns 64 rows:
// queries (forward, dq kernel) or keys (dk/dv kernel), the M = 64 of the
// products. Its own operand tiles (q; q and g; k and v) and the streamed
// 64-row tiles (k and v; q and g with their lse and delta) lie in shared
// memory as 64 rows of 64 bf16 values, 128 bytes a row, 16-byte chunk c of
// row r at c ^ (r & 7): wgmma's 128-byte swizzle on tiles that start on
// 1024-byte boundaries (bf16_conv_tiles.cuh's W rows). Each row is copied
// from device memory as it is, 16 bytes a cp.async (zero-filled past L),
// eight threads a row. The same tile serves both ways: as a K-major operand
// (the width D along its rows; the A and B of S = q k^T, the B of dP = g
// v^T, a k16 step 32 bytes along the rows) and as an MN-major B (the width
// as N; V of P V, k of dS k, g of P^T g, q of dS^T q, which wgmma takes by
// its transpose flag, a k16 step 16 rows on). So no operand is transposed in
// shared memory, which TF32 wgmma would need (it takes only K-major
// operands). The streamed tiles run in a ring (three stages in the forward,
// two in the backward kernels): the copies of a tile ahead are issued
// before this tile's products; the group wait, a proxy fence and a block
// barrier hand a tile to wgmma.
//
// From S to the next product. The fp32 accumulator of S (or S^T in the dk/dv
// kernel) holds, per thread, rows g and g + 8 of its warp's 16, columns 8 j +
// 2 t and 8 j + 2 t + 1: the very positions of the A fragment of the next
// product's k16 steps (a0..a3 = columns 16 kk + 2 t, + 1 and 16 kk + 8 + 2 t,
// + 1 of rows g and g + 8). P or dS is split there, packed as bf16 pairs, and
// fed to wgmma from registers: no trip through shared memory. The
// exponentials are 2^(s c - m c) with c = log2(e) / 8: one FFMA and one MUFU
// ex2 (within 2 ulp) where expf takes about eight instructions.
//
// Overlap. The forward issues tile j + 1's S product before tile j's
// exponentials and split, so that the tensor cores run it while the CUDA
// cores work (the running max and the output's rescale come first, from
// tile j's S alone; the rescale is skipped where no row of the warp moved
// its max). The dk/dv kernel issues dv's products before it forms and
// splits dS^T. The dq kernel overlaps only across blocks. Overlapping tile j
// + 1's softmax with P_j V_j as well (two sets of pieces, 220 registers)
// measured no faster (PERF.md section 6).
//
// Occupancy and the limits of the design it replaces (one TF32 mma.sync for
// q k^T with every B element a scalar 2-byte load widened to fp32; P V as two
// TF32 products at mma.sync's 319-325 TFLOP/s; no wgmma; 256 blocks of 4
// warps, two an SM):
//   - the products run on wgmma at the bf16 rate, B read by the tensor cores
//     through descriptors (no per-element loads), A from registers or
//     shared memory;
//   - the forward holds two S accumulators, the output's and P's three
//     pieces in 189 registers and 57 KB of shared memory: two blocks an SM;
//     where the grid has more blocks than that (N = 80), an instance held to
//     168 registers without spills, three an SM; the dq kernel at most 168
//     registers (148) and 49 KB, three an SM; the dk/dv kernel, with two
//     accumulators and two split operands, at most 255 (221) and 51 KB, two
//     an SM;
//   - the grid is 64-row blocks: 256 at N = 16 (all resident at once on the
//     132 SMs, one or two an SM), 1,280 at N = 80 (about three waves of 396
//     in the forward).
//     128-row blocks would give 128 at N = 16 and leave 4 SMs idle, with no
//     second block on an SM to hide a softmax behind.
//
// Determinism. As the fp32 pair: the dq kernel walks every key tile for its
// 64 queries and also writes delta; the dk/dv kernel walks every query tile
// for its 64 keys. Every sum is kept in registers and stored once, in a
// fixed order, with no atomics: dq, dk and dv repeat bit for bit.
//
// delta = rowsum(g * o) is taken against the forward's fp32 output o32:
// JAX's sum(dw * w) is g against the unrounded P V, and the rounded bf16
// output would move every row's delta by a bf16 rounding (1.3e-3 of scale at
// L = 256, tests/test_torch_bf16_backward.py).

using bf16 = __nv_bfloat16;

constexpr int kHTile = kTile * bf16t::kWRowBytes;  // 8,192 bytes: 64 rows x 128
constexpr int kHStages = 2;
constexpr int kHFwdStages = 3;  // the forward's ring: tile j + 2 in flight
constexpr int kHFwdSmem = 1024 + kHTile * (1 + 2 * kHFwdStages);        // q; k, v ring
constexpr int kHDqSmem = 1024 + kHTile * (2 + 2 * kHStages);            // q, g; k, v ring
constexpr int kHVecs = 2 * kTile * 4;                                   // lse, delta of a stage
constexpr int kHDkdvSmem = 1024 + kHTile * (2 + 2 * kHStages) + kHStages * kHVecs;
constexpr int kMnStep = 16 * bf16t::kWRowBytes >> 4;  // MN-major k16 step, descriptor units
constexpr int kKStep = 32 >> 4;                       // K-major k16 step

// rows r0 .. r0 + 63 of a bf16 (L, 64) slice into a swizzled tile at shared
// address dst; rows past L are zero-filled (no bytes read)
__device__ __forceinline__ void load_tile_sw(uint32_t dst, const bf16* src, int r0, int L) {
#pragma unroll
  for (int i = 0; i < kTile * 8 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx >> 3, c = idx & 7;
    const bool valid = r0 + r < L;
    bf16t::cp16(dst + bf16t::w_byte(r, c), src + (size_t)(valid ? r0 + r : 0) * kD + 8 * c,
                valid);
  }
}

// d = A x B^T (scale_d 0) or d += A x B^T (1), m64n64k16, both operands
// K-major in shared memory (descriptors of swizzled tiles): a k16 step of S =
// q k^T, dP = g v^T and their transposes
__device__ __forceinline__ void wg_mma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d = A B^T over the width (four k16 steps): A's and B's tiles K-major
__device__ __forceinline__ void product_t(float (&d)[32], uint32_t a_tile, uint32_t b_tile) {
  const uint64_t da = bf16t::wg_desc_k(a_tile), db = bf16t::wg_desc_k(b_tile);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) wg_mma_ss(d, da + kKStep * kk, db + kKStep * kk, kk);
}

// d += x B over a 64-row tile of B (MN-major), for one bf16 piece of x: the
// A fragments of its four k16 steps from registers
__device__ __forceinline__ void product_piece(float (&d)[32], const uint32_t (&x)[16],
                                              uint32_t b_tile) {
  const uint64_t db = bf16t::wg_desc(b_tile);
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    const uint32_t a[4] = {x[4 * kk], x[4 * kk + 1], x[4 * kk + 2], x[4 * kk + 3]};
    bf16t::wg_mma(d, a, db + kMnStep * kk);
  }
}

// d += x B for x split in three pieces: the small piece first
__device__ __forceinline__ void product_split(float (&d)[32], const uint32_t (&lo)[16],
                                              const uint32_t (&mid)[16],
                                              const uint32_t (&hi)[16], uint32_t b_tile) {
  product_piece(d, lo, b_tile);
  product_piece(d, mid, b_tile);
  product_piece(d, hi, b_tile);
}

// x = hi + mid + lo exactly, for the pair (x0, x1) packed as bf16 pairs
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = bf16t::pack2(x0, x1);
  const float2 h = bf16t::unpack2(hi);
  const float r0 = x0 - h.x, r1 = x1 - h.y;
  mid = bf16t::pack2(r0, r1);
  const float2 m = bf16t::unpack2(mid);
  lo = bf16t::pack2(r0 - m.x, r1 - m.y);
}

// a C accumulator (32 values: d[4 j + e] at row g + 8 (e >> 1), column 8 j +
// 2 t + (e & 1)) as the A fragments of four k16 steps, split in three
__device__ __forceinline__ void split_acc(const float (&x)[32], uint32_t (&hi)[16],
                                          uint32_t (&mid)[16], uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) split3(x[2 * i], x[2 * i + 1], hi[i], mid[i], lo[i]);
}

// Reads of the accumulator after wgmma.wait_group stay after it: the asm
// statements that wrote it return before the product is done.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// rows ra (g) and rb (g + 8) of a 64 x 64 C accumulator, times mul, rounded
// once to a bf16 (L, D) slice; and to an fp32 one when given
__device__ __forceinline__ void store_acc(bf16* dst, float* dst32, const float (&acc)[32],
                                          int ra, int rb, int L, int t, float mul_a,
                                          float mul_b) {
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 va = make_float2(acc[4 * j] * mul_a, acc[4 * j + 1] * mul_a);
    const float2 vb = make_float2(acc[4 * j + 2] * mul_b, acc[4 * j + 3] * mul_b);
    if (ra < L) {
      *reinterpret_cast<uint32_t*>(dst + (size_t)ra * kD + c) = bf16t::pack2(va.x, va.y);
      if (dst32) *reinterpret_cast<float2*>(dst32 + (size_t)ra * kD + c) = va;
    }
    if (rb < L) {
      *reinterpret_cast<uint32_t*>(dst + (size_t)rb * kD + c) = bf16t::pack2(vb.x, vb.y);
      if (dst32) *reinterpret_cast<float2*>(dst32 + (size_t)rb * kD + c) = vb;
    }
  }
}

// 2^x on the MUFU unit (ex2.approx.ftz: within 2 ulp; 0 for x below -126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// The forward in its order: S_0 first; then for each key tile j, the
// running max and the rescale of the output by tile j's S, tile j + 1's S
// product issued, tile j's exponentials and split while the tensor cores run
// it, then P_j V_j. A ring of three stages, so that tile j + 2's copies are in
// flight across a whole step. exp(x / 8 - m) is 2^(x c - m c), c = log2(e)
// / 8, one FFMA and one MUFU op. kMinBlocks: the blocks an SM that the
// registers allow (2: up to 255 a thread; 3: up to 168).
template <int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
attention_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ o32, float* __restrict__ lse, int L,
                          float scale) {
  extern __shared__ __align__(128) unsigned char sm_raw[];
  const uint32_t sq = bf16t::smem_addr(bf16t::align1024(sm_raw));
  const uint32_t sk = sq + kHTile;                    // [stage]
  const uint32_t sv = sk + kHFwdStages * kHTile;      // [stage]
  const size_t base = (size_t)blockIdx.y * L * kD;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kTile;
  const int ra = q0 + warp * 16 + g, rb = ra + 8;
  const int ntiles = (L + kTile - 1) / kTile;
  const float c = scale * kLog2e;

  load_tile_sw(sq, q + base, q0, L);
  load_tile_sw(sk, kb, 0, L);
  load_tile_sw(sv, vb, 0, L);
  bf16t::commit();
  if (ntiles > 1) {
    load_tile_sw(sk + kHTile, kb, kTile, L);
    load_tile_sw(sv + kHTile, vb, kTile, L);
  }
  bf16t::commit();
  bf16t::wait<1>();
  bf16t::fence_async_smem();
  __syncthreads();

  float s[32];  // S of the tile at hand, the raw dots (unscaled)
  bf16t::wg_fence();
  product_t(s, sq, sk);
  bf16t::wg_commit();
  bf16t::wg_wait<0>();
  fence_acc(s);

  float acc[32] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m: of the raw dots

  for (int j = 0; j < ntiles; ++j) {
    if (j + 2 < ntiles) {
      const int st2 = (j + 2) % kHFwdStages;
      load_tile_sw(sk + st2 * kHTile, kb, (j + 2) * kTile, L);
      load_tile_sw(sv + st2 * kHTile, vb, (j + 2) * kTile, L);
    }
    bf16t::commit();

    // the running max over tile j (rows g: e < 2, g + 8: e >= 2) and the
    // rescale of the output, before tile j + 1's product is issued
    const int k0 = j * kTile;
    if (k0 + kTile > L) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (k0 + 8 * (i / 4) + 2 * t + (i & 1) >= L) s[i] = -INFINITY;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);  // finite: every tile has a key
      corr[r] = ex2((m[r] - mx[r]) * c);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= corr[(i >> 1) & 1];
    }

    // tile j + 1 has landed (every thread's copies: the barrier)
    bf16t::wait<1>();
    bf16t::fence_async_smem();
    __syncthreads();
    float sn[32];
    bf16t::wg_fence();
    if (j + 1 < ntiles) {
      product_t(sn, sq, sk + ((j + 1) % kHFwdStages) * kHTile);  // S_{j+1}
      bf16t::wg_commit();
    }

    // P_j while the tensor cores run S_{j+1}
    const float mc[2] = {m[0] * c, m[1] * c};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = ex2(fmaf(s[i], c, -mc[(i >> 1) & 1]));
      l[(i >> 1) & 1] += s[i];
    }
    uint32_t ph[16], pm[16], pl[16];
    split_acc(s, ph, pm, pl);
    bf16t::wg_fence();
    product_split(acc, pl, pm, ph, sv + (j % kHFwdStages) * kHTile);  // acc += P_j V_j
    bf16t::wg_commit();
    bf16t::wg_wait<0>();
    fence_acc(acc);
    fence_acc(sn);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = sn[i];
    __syncthreads();  // every warp is done with tile j's stage before it is refilled
  }
  bf16t::wait<0>();

  const float la = quad_sum(l[0]), lb = quad_sum(l[1]);
  store_acc(o + base, o32 ? o32 + base : nullptr, acc, ra, rb, L, t, 1.f / la, 1.f / lb);
  if (lse && t == 0) {
    if (ra < L) lse[(size_t)blockIdx.y * L + ra] = m[0] * scale + logf(la);
    if (rb < L) lse[(size_t)blockIdx.y * L + rb] = m[1] * scale + logf(lb);
  }
}

__global__ void __launch_bounds__(kThreads, 3)
attention_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const float* __restrict__ o32,
                             const bf16* __restrict__ g, const float* __restrict__ lse,
                             float* __restrict__ delta, bf16* __restrict__ dq, int L,
                             float scale) {
  extern __shared__ __align__(128) unsigned char sm_raw[];
  const uint32_t sq = bf16t::smem_addr(bf16t::align1024(sm_raw));
  const uint32_t sg = sq + kHTile;
  const uint32_t sk = sg + kHTile;               // [stage]
  const uint32_t sv = sk + kHStages * kHTile;    // [stage]
  const size_t base = (size_t)blockIdx.y * L * kD;
  const bf16* kb = k + base;
  const bf16* vb = v + base;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * kTile;
  const int ra = q0 + warp * 16 + gr, rb = ra + 8;
  const int ntiles = (L + kTile - 1) / kTile;

  load_tile_sw(sq, q + base, q0, L);
  load_tile_sw(sg, g + base, q0, L);
  load_tile_sw(sk, kb, 0, L);
  load_tile_sw(sv, vb, 0, L);
  bf16t::commit();

  // delta_i = sum_d g_i o32_i over the thread's 16 widths of each row, then
  // over the quad
  float dl[2] = {0.f, 0.f};
  {
    const bf16* ga = g + base + (size_t)ra * kD;
    const bf16* gb = g + base + (size_t)rb * kD;
    const float* oa = o32 + base + (size_t)ra * kD;
    const float* ob = o32 + base + (size_t)rb * kD;
#pragma unroll
    for (int c = t; c < kD; c += 4) {
      if (ra < L) dl[0] = fmaf(__bfloat162float(ga[c]), oa[c], dl[0]);
      if (rb < L) dl[1] = fmaf(__bfloat162float(gb[c]), ob[c], dl[1]);
    }
  }
  dl[0] = quad_sum(dl[0]);
  dl[1] = quad_sum(dl[1]);
  if (t == 0) {
    if (ra < L) delta[(size_t)blockIdx.y * L + ra] = dl[0];
    if (rb < L) delta[(size_t)blockIdx.y * L + rb] = dl[1];
  }
  // P = exp(S / 8 - lse) = 2^(S c - lse log2(e)), c = log2(e) / 8
  const float c = scale * kLog2e;
  const float lse2[2] = {ra < L ? lse[(size_t)blockIdx.y * L + ra] * kLog2e : 0.f,
                         rb < L ? lse[(size_t)blockIdx.y * L + rb] * kLog2e : 0.f};

  float acc[32] = {};

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % kHStages;
    if (j + 1 < ntiles) {
      load_tile_sw(sk + (st ^ 1) * kHTile, kb, (j + 1) * kTile, L);
      load_tile_sw(sv + (st ^ 1) * kHTile, vb, (j + 1) * kTile, L);
    }
    bf16t::commit();
    bf16t::wait<1>();
    bf16t::fence_async_smem();
    __syncthreads();
    const uint32_t ks_ = sk + st * kHTile, vs_ = sv + st * kHTile;

    float s[32], dp[32];
    bf16t::wg_fence();
    product_t(s, sq, ks_);   // S = q k^T
    product_t(dp, sg, vs_);  // dP = g v^T
    bf16t::wg_commit();
    bf16t::wg_wait<0>();
    fence_acc(s);
    fence_acc(dp);

    const int k0 = j * kTile;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool valid = k0 + 8 * (i / 4) + 2 * t + (i & 1) < L;
      const float p = valid ? ex2(fmaf(s[i], c, -lse2[(i >> 1) & 1])) : 0.f;
      s[i] = p * (dp[i] - dl[(i >> 1) & 1]);  // dS
    }
    uint32_t hi[16], mid[16], lo[16];
    split_acc(s, hi, mid, lo);
    bf16t::wg_fence();
    product_split(acc, lo, mid, hi, ks_);  // dq += dS k
    bf16t::wg_commit();
    bf16t::wg_wait<0>();
    fence_acc(acc);
    __syncthreads();
  }
  bf16t::wait<0>();
  store_acc(dq + base, nullptr, acc, ra, rb, L, t, scale, scale);
}

__global__ void __launch_bounds__(kThreads, 2)
attention_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ g,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta, bf16* __restrict__ dk,
                               bf16* __restrict__ dv, int L, float scale) {
  extern __shared__ __align__(128) unsigned char sm_raw[];
  unsigned char* sm = bf16t::align1024(sm_raw);
  const uint32_t sk = bf16t::smem_addr(sm);
  const uint32_t sv = sk + kHTile;
  // the ring: [stage] q and g tiles (each on a 1024-byte boundary), then
  // [stage] lse[64] and delta[64]
  unsigned char* ring = sm + 2 * kHTile;
  float* vecs = reinterpret_cast<float*>(ring + kHStages * 2 * kHTile);
  const size_t base = (size_t)blockIdx.y * L * kD;
  const bf16* qb = q + base;
  const bf16* gb = g + base;
  const float* lse_b = lse + (size_t)blockIdx.y * L;
  const float* dl_b = delta + (size_t)blockIdx.y * L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;
  const int r0 = blockIdx.x * kTile;
  const int ra = r0 + warp * 16 + gr, rb = ra + 8;  // key rows
  const int ntiles = (L + kTile - 1) / kTile;
  const float c = scale * kLog2e;

  auto load = [&](int stage, int q0) {
    unsigned char* s = ring + stage * 2 * kHTile;
    load_tile_sw(bf16t::smem_addr(s), qb, q0, L);
    load_tile_sw(bf16t::smem_addr(s + kHTile), gb, q0, L);
    float* sl = vecs + stage * 2 * kTile;
    const int i = threadIdx.x % kTile;
    const bool valid = q0 + i < L;
    const int r = valid ? q0 + i : 0;
    if (threadIdx.x < kTile) cp_async4(sl + i, lse_b + r, valid);
    else cp_async4(sl + kTile + i, dl_b + r, valid);
  };
  load_tile_sw(sk, k + base, r0, L);
  load_tile_sw(sv, v + base, r0, L);
  load(0, 0);
  bf16t::commit();

  float dka[32] = {}, dva[32] = {};

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % kHStages;
    if (j + 1 < ntiles) load(st ^ 1, (j + 1) * kTile);
    bf16t::commit();
    bf16t::wait<1>();
    bf16t::fence_async_smem();
    __syncthreads();
    const uint32_t qs_ = bf16t::smem_addr(ring + st * 2 * kHTile), gs_ = qs_ + kHTile;
    const float* ls_ = vecs + st * 2 * kTile;
    const float* ds_ = ls_ + kTile;
    const int q0 = j * kTile;

    float s[32], dp[32];
    bf16t::wg_fence();
    product_t(s, sk, qs_);   // S^T = k q^T
    product_t(dp, sv, gs_);  // dP^T = v g^T
    bf16t::wg_commit();
    bf16t::wg_wait<0>();
    fence_acc(s);
    fence_acc(dp);

    // columns are queries: 8 (i / 4) + 2 t + (i & 1); P^T = 2^(S^T c - lse
    // log2(e)), c = log2(e) / 8
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i / 4) + 2 * t + (i & 1);
      s[i] = q0 + col < L ? ex2(fmaf(s[i], c, -ls_[col] * kLog2e)) : 0.f;
    }
    uint32_t hi[16], mid[16], lo[16];
    split_acc(s, hi, mid, lo);
    bf16t::wg_fence();
    product_split(dva, lo, mid, hi, gs_);  // dv += P^T g
    // dS^T, while the tensor cores run dv's products
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - ds_[8 * (i / 4) + 2 * t + (i & 1)]);
    uint32_t dhi[16], dmid[16], dlo[16];
    split_acc(dp, dhi, dmid, dlo);
    bf16t::wg_fence();
    product_split(dka, dlo, dmid, dhi, qs_);  // dk += dS^T q
    bf16t::wg_commit();
    bf16t::wg_wait<0>();
    fence_acc(dka);
    fence_acc(dva);
    __syncthreads();
  }
  bf16t::wait<0>();
  store_acc(dk + base, nullptr, dka, ra, rb, L, t, scale, scale);
  store_acc(dv + base, nullptr, dva, ra, rb, L, t, 1.f, 1.f);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// above 48 KB of dynamic shared memory a kernel must opt in, once per process
cudaError_t configure() {
  static cudaError_t err = [] {
    cudaError_t e = allow_smem(attention_fwd_kernel, kFwdSmem);
    if (e == cudaSuccess) e = allow_smem(attention_bwd_dq_kernel, kFwdSmem);
    if (e == cudaSuccess) e = allow_smem(attention_bwd_dkdv_kernel, kDkdvSmem);
    if (e == cudaSuccess) e = allow_smem(attention_fwd_bf16_kernel<2>, kHFwdSmem);
    if (e == cudaSuccess) e = allow_smem(attention_fwd_bf16_kernel<3>, kHFwdSmem);
    if (e == cudaSuccess) e = allow_smem(attention_bwd_dq_bf16_kernel, kHDqSmem);
    if (e == cudaSuccess) e = allow_smem(attention_bwd_dkdv_bf16_kernel, kHDkdvSmem);
    return e;
  }();
  return err;
}

}  // namespace

extern "C" {

// lse: (n, L) log-sum-exp of the scaled logits per row, or null
int mc_attention_fwd(const float* q, const float* k, const float* v, float* o,
                     float* lse, int n, int L, int d, float scale, void* stream) {
  if (d != kD) return (int)cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kTile - 1) / kTile, n);
  attention_fwd_kernel<<<grid, kThreads, kFwdSmem, (cudaStream_t)stream>>>(
      q, k, v, o, lse, L, scale);
  return (int)cudaGetLastError();
}

// The bf16 forward: q, k, v, o bf16 (16-byte aligned); o32 (the output in
// fp32, before its rounding; for the backward's delta) and lse fp32 or null.
int mc_attention_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, __nv_bfloat16* o, float* o32, float* lse,
                          int n, int L, int d, float scale, void* stream) {
  if (d != kD) return (int)cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kTile - 1) / kTile, n);
  // more blocks than two an SM hold: three an SM at 168 registers (one H100,
  // N = 80, L = 1024: 0.104 against 0.112 ms); else two, with the registers
  // to spare (N = 16: 0.0245 against 0.0252; PERF.md section 6)
  if ((long)grid.x * grid.y > 2L * bf16t::sm_count())
    attention_fwd_bf16_kernel<3><<<grid, kThreads, kHFwdSmem, (cudaStream_t)stream>>>(
        q, k, v, o, o32, lse, L, scale);
  else
    attention_fwd_bf16_kernel<2><<<grid, kThreads, kHFwdSmem, (cudaStream_t)stream>>>(
        q, k, v, o, o32, lse, L, scale);
  return (int)cudaGetLastError();
}

// o and lse from mc_attention_fwd; delta: (n, L) scratch
int mc_attention_bwd(const float* q, const float* k, const float* v,
                     const float* o, const float* g, const float* lse,
                     float* delta, float* dq, float* dk, float* dv, int n, int L,
                     int d, float scale, void* stream) {
  if (d != kD) return (int)cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kTile - 1) / kTile, n);
  cudaStream_t s = (cudaStream_t)stream;
  attention_bwd_dq_kernel<<<grid, kThreads, kFwdSmem, s>>>(q, k, v, o, g, lse, delta,
                                                           dq, L, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkdv_kernel<<<grid, kThreads, kDkdvSmem, s>>>(q, k, v, g, lse, delta,
                                                              dk, dv, L, scale);
  return (int)cudaGetLastError();
}

// The bf16 backward's two kernels apart: the dq kernel (which also writes
// delta, (n, L) fp32), then the dk/dv kernel (which reads it).
int mc_attention_bwd_dq_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                             const __nv_bfloat16* v, const float* o32,
                             const __nv_bfloat16* g, const float* lse, float* delta,
                             __nv_bfloat16* dq, int n, int L, int d, float scale,
                             void* stream) {
  if (d != kD) return (int)cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kTile - 1) / kTile, n);
  attention_bwd_dq_bf16_kernel<<<grid, kThreads, kHDqSmem, (cudaStream_t)stream>>>(
      q, k, v, o32, g, lse, delta, dq, L, scale);
  return (int)cudaGetLastError();
}

int mc_attention_bwd_dkdv_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                               const __nv_bfloat16* v, const __nv_bfloat16* g,
                               const float* lse, const float* delta, __nv_bfloat16* dk,
                               __nv_bfloat16* dv, int n, int L, int d, float scale,
                               void* stream) {
  if (d != kD) return (int)cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kTile - 1) / kTile, n);
  attention_bwd_dkdv_bf16_kernel<<<grid, kThreads, kHDkdvSmem, (cudaStream_t)stream>>>(
      q, k, v, g, lse, delta, dk, dv, L, scale);
  return (int)cudaGetLastError();
}

// The bf16 backward: q, k, v, g, dq, dk, dv bf16; o32 (the forward's fp32
// output) and lse from mc_attention_fwd_bf16; delta: (n, L) fp32 scratch.
int mc_attention_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, const float* o32, const __nv_bfloat16* g,
                          const float* lse, float* delta, __nv_bfloat16* dq,
                          __nv_bfloat16* dk, __nv_bfloat16* dv, int n, int L, int d,
                          float scale, void* stream) {
  const int rc = mc_attention_bwd_dq_bf16(q, k, v, o32, g, lse, delta, dq, n, L, d, scale,
                                          stream);
  if (rc != 0) return rc;
  return mc_attention_bwd_dkdv_bf16(q, k, v, g, lse, delta, dk, dv, n, L, d, scale, stream);
}

}  // extern "C"
