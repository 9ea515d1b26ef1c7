// K5 kv_dots and K6 apply_dots: the two products of the OFormer's Galerkin
// linear attention, out = q (k^T v) / n, on (BH, N, D) operands, fp32, with
// any N and any D, E up to 128.
//
//   K5 kv_dots    (BH, N, D) x (BH, N, E) -> (BH, D, E) = sum_n k_n^T v_n
//                 replaces m_cedm_tpu/pallas/linear_attention.py::_kv_kernel
//   K6 apply_dots (BH, N, D) x (BH, D, E) -> (BH, N, E) = q @ dots
//                 replaces m_cedm_tpu/pallas/linear_attention.py::_apply_kernel
//
// The backward of each is made of the two (kernels/linear_attention.py), so
// an OFormer train step runs no other attention kernel.
//
// K5, on the tensor cores in 3xTF32 (as K6, below). Bound: at the OFormer's
// shapes (N = 16,384, D = E = 128, BH = 16 or 64) a call does 2 N D E = 537
// MFLOP per head-batch on 16 MB of operands. In fp32 on the CUDA cores
// (67 TFLOP/s) the operations set the bound (0.128 ms at BH 16, 0.513 at
// BH 64); in 3xTF32 (three TF32 products at 495 TFLOP/s, 0.052 / 0.208 ms)
// the bytes do: 0.080 / 0.322 ms at 3.35 TB/s.
// The GEMM: M = D (A = k^T, rows d, columns n), N = E (B = v, rows n,
// columns e), K = the N tokens. The TPU kernel runs N as a sequential grid
// axis that accumulates into one resident (D, E) block; Hopper's blocks run
// in no order and BH = 16 output tiles of 128 x 128 would leave most of the
// 132 SMs idle, so N is split across `splits` blocks per head-batch (the
// wrapper asks for about one block per SM in all); the partial tiles go to a
// (BH, splits, D, E) workspace and a second kernel sums them in a fixed
// order. No atomics, so the result does not change from run to run.
// A block of 16 warps owns the whole (D, E) tile: a warp owns 32 rows d
// (two m16 tiles) and 32 columns e (four n8 tiles), so each split A
// fragment feeds four n-tiles and each split B fragment two m-tiles. k and v
// stream through a two-stage cp.async ring of 64-row stages, the next stage
// arriving while this one is multiplied; rows are 136 floats (8 mod 32), so
// the A reads of k^T, (row d = g, column n = t) from a [n][d] stage at bank
// 8t + g, and the B reads of v, (row n = t, column e = g), fall on 32
// distinct banks. Each operand element is split in registers as it is read,
// once per warp that reads it (four for each). Rows past the split's end
// are zero-filled (no bytes read), and so are the columns past D and E up
// to the warp's tiles; D and E past the tiles the warps cover are not
// stored. Measured against this (kernels/attention_sources.py on sources
// this file no longer holds; PERF.md section 6): 8 warps a block
// of 32 x 64 tiles 1.2 times slower; the operands split once a block into
// fragment-order planes 20 % slower (the staging pass overlaps nothing at
// one block an SM); two blocks an SM of 8 warps, each owning half of E,
// 6-11 % slower; a third stage in the ring no faster (K5 does not wait on memory).
// kKvTempSteps = 8 (a stage's eight k-steps on the tensor cores per fp32
// add): 4.7-6.9e-7 of scale from float64 at the OFormer's shapes on the
// H100, against 2.2-10.6e-7 a k-step a partial, which was 15-17 % slower,
// and 5.5e-7 to 3.0e-6 for the fp32 CUDA-core kernel it replaced.
// Shared memory: 2 x 2 x 64 x 136 floats = 139 KB, one block per SM.
//
// K6, on the tensor cores in 3xTF32. Every product runs on
// mma.sync.m16n8k8 in TF32 with fp32 accumulation, each fp32 operand split
// as hi = tf32(x), lo = tf32(x - hi) and the product summed as lo*hi + hi*lo
// + hi*hi, small terms first: fp32 accuracy (the dropped lo*lo term is 2^-22
// of the product) at three tensor-core products per fp32 product, as in K4
// (csrc/fused_attention.cu, whose helpers are copied below). One pass of
// TF32 would be about 2e-4 of scale off, ten times the 2e-5 bound.
// Bound: bytes. At BH = 16 a call reads 134 MB of q and writes 134 MB: 0.080
// ms at 3.35 TB/s, against 0.052 ms for its 3 x 8.6 GFLOP of TF32 products at
// 495 TFLOP/s (0.128 ms for fp32 on the CUDA cores).
// Design: persistent blocks of 8 warps, each block walking the 64-row tiles
// of one head-batch (tile i, i + per_bh, ...), so the (D, E) factor is
// loaded, split into hi / lo planes and kept in shared memory once per
// block, not once per tile; its rows are padded to 136 floats (136 = 8 mod
// 32), so the B-fragment reads (row t, column g) fall on 32 distinct banks.
// q streams through a two-stage cp.async ring of 64 x 132-float rows (132 =
// 4 mod 32: the A-fragment reads (row g, column t) are conflict-free too),
// the next tile arriving while this one is multiplied. A warp owns 32 rows
// (two m16 tiles) and a quarter of the columns (four n8 tiles), so each
// split B fragment feeds two m-tiles; it splits its rows of q into A
// fragments in registers, k-step by k-step, and issues each of the three
// products over its eight tiles in turn, so that no product waits on the
// one before it. A k-step's three products go into a zeroed fragment that
// is then added to the fp32 accumulator: the tensor cores' additions, which
// do not round as fp32 does, stay within one k-step (2.2-2.4e-7 of scale
// from float64 at the OFormer's shapes, against 1.2-1.3e-6 when all 48
// products of a row accumulate on the tensor cores; PERF.md section 6).
// D and E are zero-padded to multiples of 8 in shared memory; rows past N
// are zero-filled and not stored. Shared memory: 2 x 128 x 136 + 2 x 64 x 132 floats = 202 KB, one
// block per SM; a head-batch gets the SM count over BH blocks (8 at BH = 16,
// 2 at BH = 64), at most one per tile.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kW = 128;        // widest D and E; shared rows are this wide

// K5
constexpr int kKvRows = 64;                 // k, v rows per stage (8 k-steps)
constexpr int kKvS = kW + 8;                // stage row stride (floats), 8 mod 32
constexpr int kKvThreads = 512;             // 16 warps: 4 along D x 4 along E
constexpr int kKvStage = 2 * kKvRows * kKvS;  // floats of one stage: k, then v
constexpr int kKvTempSteps = 8;             // k-steps summed on the tensor cores per fp32 add

// K6
constexpr int kRowsQ = 64;              // q rows per tile
constexpr int kFS = kW + 8;             // factor row stride (floats), 8 mod 32
constexpr int kQS = kW + 4;             // q row stride (floats), 4 mod 32
constexpr int kMTiles = 2;              // m16 tiles (16 rows each) a warp owns
constexpr int kRowGroups = kRowsQ / (16 * kMTiles);  // warps along a tile's rows
constexpr int kApplyThreads = 32 * kRowGroups * 4;   // times four column quarters of 32
constexpr int kQStage = kRowsQ * kQS;   // floats of one q stage
constexpr int kTempSteps = 1;           // k-steps summed on the tensor cores per fp32 add

// ---------------------------------------------------------------------------
// 3xTF32 on mma.sync and cp.async (as in csrc/fused_attention.cu)
// ---------------------------------------------------------------------------

// an fp32 bit pattern with a 10-bit mantissa, rounded to nearest (one F2FP
// instruction on sm_90, which leaves the 13 low bits zero)
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

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

// rows c0 .. c0 + kKvRows - 1 of one head-batch's k (N, D) and v (N, E) into
// a stage, k's columns up to dq and v's up to eq; zero past n1 and past D, E
// (no bytes read there)
__device__ __forceinline__ void load_kv(float* dst, const float* kb, const float* vb,
                                        int c0, int n1, int D, int E, int dq, int eq,
                                        bool vec_k, bool vec_v) {
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    const float* src = which ? vb : kb;
    const int width = which ? E : D, cols = which ? eq : dq;
    float* out = dst + which * kKvRows * kKvS;
    if (which ? vec_v : vec_k) {
      const int c4 = cols / 4;
      for (int idx = threadIdx.x; idx < kKvRows * c4; idx += kKvThreads) {
        const int r = idx / c4, c = 4 * (idx % c4);
        const bool valid = c0 + r < n1 && c < width;
        cp_async16(out + r * kKvS + c, valid ? src + (size_t)(c0 + r) * width + c : src,
                   valid);
      }
    } else {
      for (int idx = threadIdx.x; idx < kKvRows * cols; idx += kKvThreads) {
        const int r = idx / cols, c = idx % cols;
        const bool valid = c0 + r < n1 && c < width;
        cp_async4(out + r * kKvS + c, valid ? src + (size_t)(c0 + r) * width + c : src,
                  valid);
      }
    }
  }
}

// One block sums k_n^T v_n over rows [s * rows_per_split, ...) of head-batch
// blockIdx.y into part[bh, s] (or out, with one split).
__global__ void __launch_bounds__(kKvThreads, 1)
kv_dots_partial_kernel(const float* __restrict__ k, const float* __restrict__ v,
                       float* __restrict__ part, int N, int D, int E,
                       int rows_per_split, int vec_k, int vec_v) {
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.y, s = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wd = warp & 3, we = warp >> 2;  // rows 32 wd .., columns 32 we ..
  const float* kb = k + (size_t)bh * N * D;
  const float* vb = v + (size_t)bh * N * E;
  const int n0 = s * rows_per_split, n1 = min(N, n0 + rows_per_split);
  const int dq = (D + 15) & ~15, eq = (E + 7) & ~7;
  // the warp's m16 tiles that start below D and n8 tiles below E (warp-uniform)
  const int mts = min(2, max(0, (D - 32 * wd + 15) / 16));
  const int nts = min(4, max(0, eq / 8 - 4 * we));

  float acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  if (n0 < n1) load_kv(smem, kb, vb, n0, n1, D, E, dq, eq, vec_k, vec_v);
  cp_commit();
  for (int c0 = n0, it = 0; c0 < n1; c0 += kKvRows, ++it) {
    const int st = it & 1;
    if (c0 + kKvRows < n1)
      load_kv(smem + (st ^ 1) * kKvStage, kb, vb, c0 + kKvRows, n1, D, E, dq, eq,
              vec_k, vec_v);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    if (mts > 0 && nts > 0) {  // warp-uniform
      const float* sk = smem + st * kKvStage + t * kKvS + 32 * wd + g;
      const float* sv = smem + st * kKvStage + kKvRows * kKvS + t * kKvS + 32 * we + g;
      const int ksteps = (min(kKvRows, n1 - c0) + 7) / 8;
      for (int k0 = 0; k0 < ksteps; k0 += kKvTempSteps) {
        // kKvTempSteps k-steps into a zeroed partial, then one fp32 add
        float pt[2][4][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) pt[m][j][e] = 0.f;
#pragma unroll
        for (int ss = 0; ss < kKvTempSteps; ++ss) {
          if (k0 + ss >= ksteps) break;
          const int r = 8 * (k0 + ss) * kKvS;  // the k-step's first row
          // A = k^T: a0 (d = g, n = t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
          AFrag a[2];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            const float* pa = sk + r + 16 * m;
            split_a(a[m], pa[0], pa[8], pa[4 * kKvS], pa[4 * kKvS + 8]);
          }
          // B = v: b0 (n = t, e = g), b1 (t + 4, g)
          uint32_t bh_[4][2], bl_[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j < nts) {  // warp-uniform
              const float* pb = sv + r + 8 * j;
              split(pb[0], bh_[j][0], bl_[j][0]);
              split(pb[4 * kKvS], bh_[j][1], bl_[j][1]);
            }
          }
          // the three products, each over all the warp's tiles in turn
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int m = 0; m < 2; ++m)
              if (j < nts && m < mts) mma_tf32(pt[m][j], a[m].lo, bh_[j][0], bh_[j][1]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int m = 0; m < 2; ++m)
              if (j < nts && m < mts) mma_tf32(pt[m][j], a[m].hi, bl_[j][0], bl_[j][1]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int m = 0; m < 2; ++m)
              if (j < nts && m < mts) mma_tf32(pt[m][j], a[m].hi, bh_[j][0], bh_[j][1]);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][j][e] += pt[m][j][e];
      }
    }
    __syncthreads();  // the stage is read: the next copy may overwrite it
  }
  cp_wait<0>();

  // C fragment: (d = g, e = 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
  float* out = part + ((size_t)bh * gridDim.x + s) * D * E;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = 32 * wd + 16 * m + 8 * h + g;
      if (m >= mts || d >= D) continue;
      float* row = out + (size_t)d * E;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 32 * we + 8 * j + 2 * t;
        if (j >= nts || c >= E) continue;
        const float v0 = acc[m][j][2 * h], v1 = acc[m][j][2 * h + 1];
        if (E % 2 == 0) {
          *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
        } else {
          row[c] = v0;
          if (c + 1 < E) row[c + 1] = v1;
        }
      }
    }
  }
}

// out[bh] = sum over s of part[bh, s], in the order s = 0, 1, ...
__global__ void kv_dots_reduce_kernel(const float* __restrict__ part,
                                      float* __restrict__ out, int splits, int de) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= de) return;
  const float* p = part + (size_t)blockIdx.y * splits * de + idx;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += p[(size_t)i * de];
  out[(size_t)blockIdx.y * de + idx] = s;
}

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

// rows r0 .. r0 + 63 of one head-batch's (N, D) q into a stage, columns up
// to dp (D rounded up to 8); zero past N and past D (no bytes read)
__device__ __forceinline__ void load_q(float* dst, const float* qb, int r0, int N, int D,
                                       int dp, bool vec) {
  if (vec) {
    const int q4 = dp / 4;
    for (int idx = threadIdx.x; idx < kRowsQ * q4; idx += kApplyThreads) {
      const int r = idx / q4, c = 4 * (idx % q4);
      const bool valid = r0 + r < N && c < D;
      cp_async16(dst + r * kQS + c, valid ? qb + (size_t)(r0 + r) * D + c : qb, valid);
    }
  } else {
    for (int idx = threadIdx.x; idx < kRowsQ * dp; idx += kApplyThreads) {
      const int r = idx / dp, c = idx % dp;
      const bool valid = r0 + r < N && c < D;
      cp_async4(dst + r * kQS + c, valid ? qb + (size_t)(r0 + r) * D + c : qb, valid);
    }
  }
}

__global__ void __launch_bounds__(kApplyThreads, 1)
apply_dots_kernel(const float* __restrict__ q, const float* __restrict__ dots,
                  float* __restrict__ o, int N, int D, int E, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int dp = (D + 7) & ~7, ep = (E + 7) & ~7;
  float* fhi = smem;           // (dp, kFS): TF32 hi halves of the factor
  float* flo = smem + dp * kFS;  // (dp, kFS): lo halves
  float* sq = flo + dp * kFS;  // [stage][kRowsQ][kQS]
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp % kRowGroups, cq = warp / kRowGroups;  // row group, column quarter
  const int ntiles = (N + kRowsQ - 1) / kRowsQ;
  const float* qb = q + (size_t)bh * N * D;
  float* ob = o + (size_t)bh * N * E;
  // n8 tiles of this warp's quarter that hold columns below E
  const int nts = min(4, max(0, ep / 8 - 4 * cq));

  int tile = blockIdx.x;
  load_q(sq, qb, tile * kRowsQ, N, D, dp, vec);
  cp_commit();

  // the factor, split once per block; zero past D and E
  const float* db = dots + (size_t)bh * D * E;
  for (int idx = threadIdx.x; idx < dp * ep; idx += kApplyThreads) {
    const int d = idx / ep, e = idx % ep;
    uint32_t hi, lo;
    split(d < D && e < E ? db[d * E + e] : 0.f, hi, lo);
    fhi[d * kFS + e] = __uint_as_float(hi);
    flo[d * kFS + e] = __uint_as_float(lo);
  }

  for (int k = 0; tile < ntiles; tile += gridDim.x, ++k) {
    const int st = k & 1;
    if (tile + gridDim.x < ntiles)
      load_q(sq + (st ^ 1) * kQStage, qb, (tile + gridDim.x) * kRowsQ, N, D, dp, vec);
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    float acc[kMTiles][4][4];
#pragma unroll
    for (int m = 0; m < kMTiles; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
    if (nts > 0) {  // warp-uniform
      const float* qs = sq + st * kQStage + (16 * kMTiles * rg + g) * kQS + t;
      const int col0 = 32 * cq + g;
      for (int k0 = 0; k0 < dp; k0 += 8 * kTempSteps) {
        // kTempSteps k-steps into a zeroed partial, then one fp32 add into
        // acc: the tensor core's own additions stay short
        float part[kMTiles][4][4];
#pragma unroll
        for (int m = 0; m < kMTiles; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[m][j][e] = 0.f;
#pragma unroll
        for (int s = 0; s < kTempSteps; ++s) {
          const int kk = k0 + 8 * s;
          if (kk >= dp) break;
          AFrag a[kMTiles];
#pragma unroll
          for (int m = 0; m < kMTiles; ++m) {
            const float* p = qs + 16 * m * kQS + kk;
            split_a(a[m], p[0], p[8 * kQS], p[4], p[8 * kQS + 4]);
          }
          const float* ph = fhi + (kk + t) * kFS + col0;
          const float* pl = flo + (kk + t) * kFS + col0;
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (j < nts) {  // warp-uniform
              bh[j][0] = __float_as_uint(ph[8 * j]);
              bh[j][1] = __float_as_uint(ph[4 * kFS + 8 * j]);
              bl[j][0] = __float_as_uint(pl[8 * j]);
              bl[j][1] = __float_as_uint(pl[4 * kFS + 8 * j]);
            }
          }
          // the three products, each over all eight (m, j) tiles in turn, so
          // that no product waits on the one before it in the same tile
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int m = 0; m < kMTiles; ++m)
              if (j < nts) mma_tf32(part[m][j], a[m].lo, bh[j][0], bh[j][1]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int m = 0; m < kMTiles; ++m)
              if (j < nts) mma_tf32(part[m][j], a[m].hi, bl[j][0], bl[j][1]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int m = 0; m < kMTiles; ++m)
              if (j < nts) mma_tf32(part[m][j], a[m].hi, bh[j][0], bh[j][1]);
        }
#pragma unroll
        for (int m = 0; m < kMTiles; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][j][e] += part[m][j][e];
      }
    }

    // C fragment: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = tile * kRowsQ + 16 * kMTiles * rg + 16 * m + 8 * h + g;
        if (n >= N) continue;
        float* row = ob + (size_t)n * E;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 32 * cq + 8 * j + 2 * t;
          if (j >= nts || c >= E) continue;
          const float v0 = acc[m][j][2 * h], v1 = acc[m][j][2 * h + 1];
          if (E % 2 == 0) {
            *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
          } else {
            row[c] = v0;
            if (c + 1 < E) row[c + 1] = v1;
          }
        }
      }
    }
    __syncthreads();
  }
  cp_wait<0>();
}

size_t apply_smem(int d) {
  const int dp = (d + 7) & ~7;
  return (size_t)(2 * dp * kFS + 2 * kQStage) * sizeof(float);
}

bool widths_ok(int d, int e) { return d >= 1 && d <= kW && e >= 1 && e <= kW; }

}  // namespace

extern "C" {

// part: (bh, splits, d, e) scratch, or null when splits == 1 (the block then
// writes out directly); rows_per_split * splits >= n
int mc_kv_dots(const float* k, const float* v, float* out, float* part, int bh,
               int n, int d, int e, int splits, int rows_per_split, void* stream) {
  if (!widths_ok(d, e) || splits < 1 || (splits > 1 && !part) ||
      (long long)rows_per_split * splits < n)
    return (int)cudaErrorInvalidValue;
  static cudaError_t attr = cudaFuncSetAttribute(
      kv_dots_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(2 * kKvStage * sizeof(float)));
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t st = (cudaStream_t)stream;
  const int vec_k = d % 4 == 0 && (uintptr_t)k % 16 == 0;
  const int vec_v = e % 4 == 0 && (uintptr_t)v % 16 == 0;
  kv_dots_partial_kernel<<<dim3(splits, bh), kKvThreads, 2 * kKvStage * sizeof(float), st>>>(
      k, v, splits == 1 ? out : part, n, d, e, rows_per_split, vec_k, vec_v);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int de = d * e;
  kv_dots_reduce_kernel<<<dim3((de + 255) / 256, bh), 256, 0, st>>>(part, out,
                                                                    splits, de);
  return (int)cudaGetLastError();
}

int mc_apply_dots(const float* q, const float* dots, float* out, int bh, int n,
                  int d, int e, void* stream) {
  if (!widths_ok(d, e) || bh < 1 || n < 1) return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory a kernel must opt in, once per
  // process; the SM count sets the persistent grid
  static int sms = 0;
  static cudaError_t err = [] {
    int dev = 0;
    cudaError_t e2 = cudaGetDevice(&dev);
    if (e2 == cudaSuccess)
      e2 = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e2 == cudaSuccess)
      e2 = cudaFuncSetAttribute(apply_dots_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)apply_smem(kW));
    return e2;
  }();
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (n + kRowsQ - 1) / kRowsQ;
  const int per_bh = ntiles < sms / bh ? ntiles : (sms / bh > 0 ? sms / bh : 1);
  const bool vec = d % 4 == 0 && (uintptr_t)q % 16 == 0;
  apply_dots_kernel<<<dim3(per_bh, bh), kApplyThreads, apply_smem(d),
                      (cudaStream_t)stream>>>(q, dots, out, n, d, e, (int)vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
