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
// K5. Bound: at the OFormer's shapes (N = 16,384, D = E = 128, BH = 16 or 64)
// a call does 2 N D E = 537 MFLOP per head-batch on 16 MB of operands, about
// 32 FLOP per byte, above the H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s =
// 20): fp32 multiply-adds on the CUDA cores set the time. A register-blocked
// product: 256 threads as a 16 x 16 grid, each thread owning an 8 x 8 tile
// of the (D, E) output whose columns are the two float4 groups 4t.. and
// 64 + 4t.., so that a warp's shared-memory reads are broadcasts or
// contiguous 256-byte runs; operands are staged zero-padded to 128 columns.
// The TPU kernel runs N as a sequential grid axis that accumulates into one
// resident (D, E) block. Hopper's blocks run in no order, and there are only
// BH = 16 output tiles of 128 x 128 at the encoder's shape against 132 SMs,
// so N is split across `splits` blocks per head-batch: each stages 32 rows
// of k and v at a time; the partial tiles go to a (BH, splits, D, E)
// workspace and a second kernel sums them in a fixed order. No atomics, so
// the result does not change from run to run.
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
constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kChunk = 32;     // k, v rows per shared-memory stage (K5)

// K6
constexpr int kRowsQ = 64;              // q rows per tile
constexpr int kFS = kW + 8;             // factor row stride (floats), 8 mod 32
constexpr int kQS = kW + 4;             // q row stride (floats), 4 mod 32
constexpr int kMTiles = 2;              // m16 tiles (16 rows each) a warp owns
constexpr int kRowGroups = kRowsQ / (16 * kMTiles);  // warps along a tile's rows
constexpr int kApplyThreads = 32 * kRowGroups * 4;   // times four column quarters of 32
constexpr int kQStage = kRowsQ * kQS;   // floats of one q stage
constexpr int kTempSteps = 1;           // k-steps summed on the tensor cores per fp32 add

// column (or row) i of the thread's eight: 4t..4t+3, then 64+4t..64+4t+3
__device__ __forceinline__ int frag(int t, int i) {
  return i < 4 ? 4 * t + i : 64 + 4 * t + (i - 4);
}

__device__ __forceinline__ void load8(const float* row, int t, float* r) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * t);
  const float4 b = *reinterpret_cast<const float4*>(row + 64 + 4 * t);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

// eight values of row `dst` from the thread's columns, written inside [0, E)
__device__ __forceinline__ void store8(float* dst, int t, const float* r, int E) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = h * 64 + 4 * t;
    if (E % 4 == 0) {
      if (c < E)
        *reinterpret_cast<float4*>(dst + c) =
            make_float4(r[4 * h], r[4 * h + 1], r[4 * h + 2], r[4 * h + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < E) dst[c + j] = r[4 * h + j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
kv_dots_partial_kernel(const float* __restrict__ k, const float* __restrict__ v,
                       float* __restrict__ part, int N, int D, int E,
                       int rows_per_split) {
  __shared__ __align__(16) float sk[kChunk][kW];
  __shared__ __align__(16) float sv[kChunk][kW];
  const int bh = blockIdx.y, s = blockIdx.x;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* kb = k + (size_t)bh * N * D;
  const float* vb = v + (size_t)bh * N * E;
  const int n0 = s * rows_per_split, n1 = min(N, n0 + rows_per_split);
  // loader: thread -> one column, every second row of the stage
  const int col = threadIdx.x % kW, row0 = threadIdx.x / kW;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int c0 = n0; c0 < n1; c0 += kChunk) {
    __syncthreads();
    for (int r = row0; r < kChunk; r += kThreads / kW) {
      const int n = c0 + r;
      sk[r][col] = (n < n1 && col < D) ? kb[(size_t)n * D + col] : 0.f;
      sv[r][col] = (n < n1 && col < E) ? vb[(size_t)n * E + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kChunk; ++r) {
      float a[8], b[8];
      load8(sk[r], ty, a);
      load8(sv[r], tx, b);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  float* out = part + ((size_t)bh * gridDim.x + s) * D * E;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = frag(ty, i);
    if (d < D) store8(out + (size_t)d * E, tx, acc[i], E);
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
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(splits, bh);
  kv_dots_partial_kernel<<<grid, kThreads, 0, st>>>(k, v, splits == 1 ? out : part,
                                                    n, d, e, rows_per_split);
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
