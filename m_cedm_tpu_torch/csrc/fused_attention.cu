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
// bf16 forward (attention_fwd_bf16_kernel): replaces the same _fwd_kernel on
// bf16 q, k, v, which upcasts them, runs both products and the softmax in
// fp32 and rounds the output once to bf16. Every bf16 value is exact in TF32
// (7 mantissa bits against 10) and the scale 1/8 is a power of two, so
// S = q k^T is exact in products with ONE TF32 mma.sync where 3xTF32 takes
// three; P V takes two (P split hi/lo, V exact): three products where the
// fp32 kernel takes six, with the output held to fp32 accuracy before its one
// rounding. Bound at the flagship shape: operations, 4.3 GFLOP at 1.5 TF32
// products per fp32 product (0.013 ms at 495 TFLOP/s) against 8.4 MB of bf16
// q/k/v/o (0.0025 ms). The tiling is the fp32 forward's; k and v stream
// through shared memory as bf16 (rows padded to 72 values, 36 words = 4 mod
// 32, so that the B-fragment reads, 2 bytes a thread, fall on distinct
// banks) and are widened to fp32 as each fragment is read; q is held as
// unsplit A fragments. The output is stored as bf16 pairs; where the caller
// trains, also as fp32 (`o32`), for the backward's delta.
//
// bf16 backward (attention_bwd_dq_bf16_kernel, attention_bwd_dkdv_bf16_kernel):
// replaces _bwd_kernel on bf16 q, k, v, g, which upcasts them, recomputes the
// softmax, forms every product in fp32 and rounds dq, dk and dv once. The
// kernels are the fp32 pair's, with bf16 tiles (the forward's 72-value rows)
// and exact A fragments: S = q k^T and dP = g v^T (both operands bf16) take
// ONE TF32 product where 3xTF32 takes three; dv += P^T g, dq += dS k and
// dk += dS^T q (P and dS fp32, split hi/lo; the bf16 operand exact) take two.
// delta = rowsum(g * o) is taken against the forward's fp32 output o32: JAX's
// sum(dw * w) is g against the unrounded P V, and the rounded bf16 output
// would move every row's delta by a bf16 rounding (1.3e-3 of scale at L =
// 256, tests/test_torch_bf16_backward.py). Bound at the flagship shape: 7
// (L, L, D) products, 2 exact and 5 at the two-product rate, 13.7 GFLOP at
// 1.7 TF32 products a product against 13.6 MB of bf16 q/k/v/g/dq/dk/dv and
// the fp32 o32: operations, 0.047 ms at 495 TFLOP/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
constexpr int kStrideH = kD + 8;  // padded bf16 row of the bf16 forward's tiles
constexpr int kTileHalves = kTile * kStrideH;
constexpr int kFwdSmemBf16 = kStages * 2 * kTileHalves * 2;
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
// bf16 forward
// ---------------------------------------------------------------------------

// a bf16 value's fp32 bit pattern, an exact TF32 operand
__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 h) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(h)) << 16;
}

__device__ __forceinline__ void cp_async16(__nv_bfloat16* smem, const __nv_bfloat16* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}

// rows r0 .. r0 + 63 of one head-batch's bf16 (L, D) slice into a padded
// tile, 8 values (16 bytes) a copy; rows past L are zero-filled
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int r0, int L) {
#pragma unroll
  for (int i = 0; i < kTile * kD / 8 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / (kD / 8), c = (idx % (kD / 8)) * 8;
    const bool valid = r0 + r < L;
    cp_async16(dst + r * kStrideH + c, src + (size_t)(valid ? r0 + r : 0) * kD + c,
               valid);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
attention_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o, float* __restrict__ o32,
                          float* __restrict__ lse, int L, float scale) {
  extern __shared__ __align__(16) __nv_bfloat16 hsmem[];
  __nv_bfloat16* sk = hsmem;                          // [stage][64][72]
  __nv_bfloat16* sv = hsmem + kStages * kTileHalves;  // [stage][64][72]
  const size_t base = (size_t)blockIdx.y * L * kD;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ra = blockIdx.x * kTile + warp * 16 + g, rb = ra + 8;
  const int ntiles = (L + kTile - 1) / kTile;

  load_tile(sk, kb, 0, L);
  load_tile(sv, vb, 0, L);
  cp_commit();

  // q's A fragments, exact in TF32: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
  uint32_t qa[kKSteps][4];
  {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    const __nv_bfloat16* pa = q + base + (size_t)ra * kD;
    const __nv_bfloat16* pb = q + base + (size_t)rb * kD;
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
      const int c = 8 * ks + t;
      qa[ks][0] = bf16_bits(ra < L ? pa[c] : zero);
      qa[ks][1] = bf16_bits(rb < L ? pb[c] : zero);
      qa[ks][2] = bf16_bits(ra < L ? pa[c + 4] : zero);
      qa[ks][3] = bf16_bits(rb < L ? pb[c + 4] : zero);
    }
  }

  float acc[kD / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % kStages;
    if (j + 1 < ntiles) {
      load_tile(sk + (st ^ 1) * kTileHalves, kb, (j + 1) * kTile, L);
      load_tile(sv + (st ^ 1) * kTileHalves, vb, (j + 1) * kTile, L);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const __nv_bfloat16* ks_ = sk + st * kTileHalves;
    const __nv_bfloat16* vs_ = sv + st * kTileHalves;

    // S = q k^T: one exact TF32 product a k-step (key row 8 nt + g, width t, t + 4)
    float s[kNTiles][4] = {};
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const __nv_bfloat16* p = ks_ + (8 * nt + g) * kStrideH + 8 * ks + t;
        mma_tf32(s[nt], qa[ks], bf16_bits(p[0]), bf16_bits(p[4]));
      }
    }

    // online softmax, as the fp32 forward
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
      mx[r] = quad_max(mx[r]);
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

    // acc += P V: P split (the key permutation of the fp32 forward), V exact;
    // the small product first
#pragma unroll
    for (int kk = 0; kk < kNTiles; ++kk) {
      AFrag pa;
      split_a_from_c(pa, s[kk]);
      const __nv_bfloat16* p = vs_ + (8 * kk + 2 * t) * kStrideH + g;
#pragma unroll
      for (int nd = 0; nd < kD / 8; ++nd) {
        const uint32_t b0 = bf16_bits(p[8 * nd]), b1 = bf16_bits(p[kStrideH + 8 * nd]);
        mma_tf32(acc[nd], pa.lo, b0, b1);
        mma_tf32(acc[nd], pa.hi, b0, b1);
      }
    }
    __syncthreads();
  }
  cp_wait<0>();

  const float la = quad_sum(l[0]), lb = quad_sum(l[1]);
  const float ia = 1.f / la, ib = 1.f / lb;
  __nv_bfloat16* ob = o + base;
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd) {
    const int c = 8 * nd + 2 * t;
    if (ra < L)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)ra * kD + c) =
          __floats2bfloat162_rn(acc[nd][0] * ia, acc[nd][1] * ia);
    if (rb < L)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)rb * kD + c) =
          __floats2bfloat162_rn(acc[nd][2] * ib, acc[nd][3] * ib);
  }
  if (o32) store_c(o32 + base, acc, ra, rb, L, t, ia, ib);
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
// bf16 backward
// ---------------------------------------------------------------------------

// The exact A fragments of rows ra (g) and rb (g + 8) of a bf16 (L, D) slice
// for the 8 k-steps over the width; zero past L.
__device__ __forceinline__ void load_a_exact(uint32_t (*a)[4], const __nv_bfloat16* src,
                                             int ra, int rb, int L, int t) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const __nv_bfloat16* pa = src + (size_t)ra * kD;
  const __nv_bfloat16* pb = src + (size_t)rb * kD;
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    const int c = 8 * ks + t;
    a[ks][0] = bf16_bits(ra < L ? pa[c] : zero);
    a[ks][1] = bf16_bits(rb < L ? pb[c] : zero);
    a[ks][2] = bf16_bits(ra < L ? pa[c + 4] : zero);
    a[ks][3] = bf16_bits(rb < L ? pb[c + 4] : zero);
  }
}

// c[j] += A (16 x 64 width, exact) * tile^T for the NT n-tiles from nt0, one
// TF32 product a k-step: both operands are bf16 values
template <int NT>
__device__ __forceinline__ void mma_rows_t_exact(float (*c)[4], uint32_t (*a)[4],
                                                 const __nv_bfloat16* tile, int nt0, int g,
                                                 int t) {
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const __nv_bfloat16* p = tile + (8 * (nt0 + j) + g) * kStrideH + 8 * ks + t;
      mma_tf32(c[j], a[ks], bf16_bits(p[0]), bf16_bits(p[4]));
    }
  }
}

// acc (16 x 64 width) += A (split) * bf16 tile rows 8kk .. 8kk + 7 in the
// permuted order 2t, 2t + 1: two products, the small one first
__device__ __forceinline__ void mma_rows_exact_b(float (*acc)[4], const AFrag& a,
                                                 const __nv_bfloat16* tile, int kk, int g,
                                                 int t) {
  const __nv_bfloat16* p = tile + (8 * kk + 2 * t) * kStrideH + g;
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd) {
    const uint32_t b0 = bf16_bits(p[8 * nd]), b1 = bf16_bits(p[kStrideH + 8 * nd]);
    mma_tf32(acc[nd], a.lo, b0, b1);
    mma_tf32(acc[nd], a.hi, b0, b1);
  }
}

// rows ra (g) and rb (g + 8) of a 16 x 64 C accumulator, times mul, rounded
// once to a bf16 (L, D) slice
__device__ __forceinline__ void store_c_bf16(__nv_bfloat16* dst, const float (*acc)[4],
                                             int ra, int rb, int L, int t, float mul) {
#pragma unroll
  for (int nd = 0; nd < kD / 8; ++nd) {
    const int c = 8 * nd + 2 * t;
    if (ra < L)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)ra * kD + c) =
          __floats2bfloat162_rn(acc[nd][0] * mul, acc[nd][1] * mul);
    if (rb < L)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)rb * kD + c) =
          __floats2bfloat162_rn(acc[nd][2] * mul, acc[nd][3] * mul);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
attention_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const float* __restrict__ o32,
                             const __nv_bfloat16* __restrict__ g,
                             const float* __restrict__ lse, float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int L, float scale) {
  extern __shared__ __align__(16) __nv_bfloat16 hsmem[];
  __nv_bfloat16* sk = hsmem;
  __nv_bfloat16* sv = hsmem + kStages * kTileHalves;
  const size_t base = (size_t)blockIdx.y * L * kD;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;
  const int ra = blockIdx.x * kTile + warp * 16 + gr, rb = ra + 8;
  const int ntiles = (L + kTile - 1) / kTile;

  load_tile(sk, kb, 0, L);
  load_tile(sv, vb, 0, L);
  cp_commit();

  // delta_i = sum_d g_i o32_i, as the fp32 kernel
  float dl[2] = {0.f, 0.f};
  {
    const __nv_bfloat16* ga = g + base + (size_t)ra * kD;
    const __nv_bfloat16* gb = g + base + (size_t)rb * kD;
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
  const float lse_r[2] = {ra < L ? lse[(size_t)blockIdx.y * L + ra] : 0.f,
                          rb < L ? lse[(size_t)blockIdx.y * L + rb] : 0.f};

  uint32_t qa[kKSteps][4], ga_[kKSteps][4];
  load_a_exact(qa, q + base, ra, rb, L, t);
  load_a_exact(ga_, g + base, ra, rb, L, t);

  float acc[kD / 8][4] = {};

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % kStages;
    if (j + 1 < ntiles) {
      load_tile(sk + (st ^ 1) * kTileHalves, kb, (j + 1) * kTile, L);
      load_tile(sv + (st ^ 1) * kTileHalves, vb, (j + 1) * kTile, L);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const __nv_bfloat16* ks_ = sk + st * kTileHalves;
    const __nv_bfloat16* vs_ = sv + st * kTileHalves;
    const int k0 = j * kTile;

#pragma unroll 1
    for (int nt0 = 0; nt0 < kNTiles; nt0 += 2) {
      float s[2][4] = {}, dp[2][4] = {};
      mma_rows_t_exact<2>(s, qa, ks_, nt0, gr, t);    // S = q k^T
      mma_rows_t_exact<2>(dp, ga_, vs_, nt0, gr, t);  // dP = g v^T
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
        mma_rows_exact_b(acc, da, ks_, nt0 + jn, gr, t);  // dq += dS k
      }
    }
    __syncthreads();
  }
  cp_wait<0>();
  store_c_bf16(dq + base, acc, ra, rb, L, t, scale);
}

constexpr int kDkdvSmemBf16 = kStages * 2 * kTileHalves * 2 + kStages * 2 * kTile * 4;

__global__ void __launch_bounds__(kThreads, 2)
attention_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               const __nv_bfloat16* __restrict__ g,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                               int L, float scale) {
  extern __shared__ __align__(16) __nv_bfloat16 hsmem[];
  __nv_bfloat16* sq = hsmem;                            // [stage][64][72]
  __nv_bfloat16* sg = hsmem + kStages * kTileHalves;    // [stage][64][72]
  float* slse = reinterpret_cast<float*>(hsmem + 2 * kStages * kTileHalves);  // [stage][64]
  float* sdl = slse + kStages * kTile;                                        // [stage][64]
  const size_t base = (size_t)blockIdx.y * L * kD;
  const __nv_bfloat16* qb = q + base;
  const __nv_bfloat16* gb = g + base;
  const float* lse_b = lse + (size_t)blockIdx.y * L;
  const float* dl_b = delta + (size_t)blockIdx.y * L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;
  const int ra = blockIdx.x * kTile + warp * 16 + gr, rb = ra + 8;  // key rows
  const int ntiles = (L + kTile - 1) / kTile;

  auto load = [&](int stage, int q0) {
    load_tile(sq + stage * kTileHalves, qb, q0, L);
    load_tile(sg + stage * kTileHalves, gb, q0, L);
    const int i = threadIdx.x % kTile;
    const bool valid = q0 + i < L;
    const int r = valid ? q0 + i : 0;
    if (threadIdx.x < kTile) cp_async4(slse + stage * kTile + i, lse_b + r, valid);
    else cp_async4(sdl + stage * kTile + i, dl_b + r, valid);
  };
  load(0, 0);
  cp_commit();

  uint32_t ka[kKSteps][4], va[kKSteps][4];
  load_a_exact(ka, k + base, ra, rb, L, t);
  load_a_exact(va, v + base, ra, rb, L, t);

  float dka[kD / 8][4] = {}, dva[kD / 8][4] = {};

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % kStages;
    if (j + 1 < ntiles) load(st ^ 1, (j + 1) * kTile);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const __nv_bfloat16* qs_ = sq + st * kTileHalves;
    const __nv_bfloat16* gs_ = sg + st * kTileHalves;
    const float* ls_ = slse + st * kTile;
    const float* ds_ = sdl + st * kTile;
    const int q0 = j * kTile;

#pragma unroll 1
    for (int nt0 = 0; nt0 < kNTiles; nt0 += 2) {
      float s[2][4] = {}, dp[2][4] = {};
      mma_rows_t_exact<2>(s, ka, qs_, nt0, gr, t);   // S^T = k q^T
      mma_rows_t_exact<2>(dp, va, gs_, nt0, gr, t);  // dP^T = v g^T
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * (nt0 + jn) + 2 * t + (e & 1);
          const float p = q0 + c < L ? expf(s[jn][e] * scale - ls_[c]) : 0.f;
          s[jn][e] = p;
          dp[jn][e] = p * (dp[jn][e] - ds_[c]);  // dS^T
        }
        AFrag pa;
        split_a_from_c(pa, s[jn]);
        mma_rows_exact_b(dva, pa, gs_, nt0 + jn, gr, t);  // dv += P^T g
        split_a_from_c(pa, dp[jn]);
        mma_rows_exact_b(dka, pa, qs_, nt0 + jn, gr, t);  // dk += dS^T q
      }
    }
    __syncthreads();
  }
  cp_wait<0>();
  store_c_bf16(dk + base, dka, ra, rb, L, t, scale);
  store_c_bf16(dv + base, dva, ra, rb, L, t, 1.f);
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
    if (e == cudaSuccess) e = allow_smem(attention_fwd_bf16_kernel, kFwdSmemBf16);
    if (e == cudaSuccess) e = allow_smem(attention_bwd_dq_bf16_kernel, kFwdSmemBf16);
    if (e == cudaSuccess) e = allow_smem(attention_bwd_dkdv_bf16_kernel, kDkdvSmemBf16);
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
  attention_fwd_bf16_kernel<<<grid, kThreads, kFwdSmemBf16, (cudaStream_t)stream>>>(
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

// The bf16 backward: q, k, v, g, dq, dk, dv bf16; o32 (the forward's fp32
// output) and lse from mc_attention_fwd_bf16; delta: (n, L) fp32 scratch.
int mc_attention_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, const float* o32, const __nv_bfloat16* g,
                          const float* lse, float* delta, __nv_bfloat16* dq,
                          __nv_bfloat16* dk, __nv_bfloat16* dv, int n, int L, int d,
                          float scale, void* stream) {
  if (d != kD) return (int)cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kTile - 1) / kTile, n);
  cudaStream_t s = (cudaStream_t)stream;
  attention_bwd_dq_bf16_kernel<<<grid, kThreads, kFwdSmemBf16, s>>>(q, k, v, o32, g, lse,
                                                                     delta, dq, L, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkdv_bf16_kernel<<<grid, kThreads, kDkdvSmemBf16, s>>>(q, k, v, g, lse,
                                                                       delta, dk, dv, L,
                                                                       scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
