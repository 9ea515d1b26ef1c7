// K5 kv_dots and K6 apply_dots: the two products of the OFormer's Galerkin
// linear attention, out = q (k^T v) / n, on (BH, N, D) operands, fp32 or
// bf16 (below), with any N and any D, E up to 128.
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
//
// The bf16 instances (the OFormer with trainer.precision bf16; the Pallas
// kernels on bf16 operands). A bf16 x bf16 product is exact in fp32, so no
// operand is split. Both are bound by bytes: at BH 16, N 16,384, D = E =
// 128 a call moves 134 MB (K5: k and v read; K6: q read, the output
// written), 0.040 ms at 3.35 TB/s, against 0.0087 ms for its 8.6 GFLOP at
// 989 TFLOP/s (64 FLOP a byte, the card's balance 295); 0.160 ms at BH 64.
// Two routes, chosen by shape alone (kernels/linear_attention.py::
// tma_route): D and E multiples of 8, whose rows TMA describes, take the
// TMA kernels; other widths the mma.sync kernels at the end of this note.
//
// On TMA (kv_dots_tma_kernel, apply_dots_tma_kernel<F>; csrc/tma_ring.cuh).
// A block is two consumer warpgroups and one producer warp. One thread of
// the producer keeps a ring of TMA tiles full (128-byte swizzled boxes of 64
// columns, 3-D tensor maps (width, N, BH) so that rows past a head-batch's
// N are zero-filled on loads and clipped on stores), each stage under a
// full barrier (the bytes it expects) and an empty one (one arrival a
// consumer warp); the consumers only multiply, on wgmma m64n64k16 with both
// operands in shared memory (bf16t::wg_mma_ss), fp32 accumulators in
// registers. Every product runs at every width: panels past D or E are
// zeroed once (the factor's past D and E as it is stored), so no wgmma
// waits on a branch.
// K6: persistent blocks, one an SM, each walking a contiguous run of the
// (head-batch, 128-row tile) space; warpgroup w multiplies rows 64 w .. of
// each tile (A = q, K-major) by the factor (B, MN-major: rows d of 64
// columns e, as a TMA box of the factor would lie). The factor, fp32 or
// bf16 (F), is rounded to bf16 to nearest even and written into that layout
// once per head-batch a block holds: the first before the ring's first
// copies are issued (issued behind them, its loads waited on the whole
// ring's fill: 0.058 against 0.053 ms at BH 16), the next loaded into
// registers as soon as the last is stored. The output is rounded once to
// bf16 into a staging tile of the warpgroup's (128-byte swizzle, kOutBufs
// tiles) and stored by TMA, one bulk group a tile, so stores overlap the
// next tile's products. Ring kApTmaStages = 4 tiles of 128 rows (128 KB).
// K5: one thread-block cluster a head-batch (one launch, no workspace).
// Rank r sums tokens r * rows .. (whole 64-token stages; a rank may be
// empty): per stage, four k16-steps summed on the tensor cores into a
// partial (the first with scale-d 0: A = k^T and B = v, both MN-major),
// then one fp32 add into its accumulator. Then each rank writes its (D, E)
// partial into its ring, and after a cluster barrier rank s reads rows D s
// / ranks .. of every rank's partial over distributed shared memory, sums
// them in rank order (the same bits on every call) and stores them. The
// cluster size (kernels/linear_attention.py::kv_cluster) is the largest
// power of two up to kKvTmaCluster whose BH clusters the card holds at
// once (cudaOccupancyMaxActiveClusters: on an H100 132 of 1 block, 66 of
// 2, 30 of 4, 15 of 8, so 4 at BH 16 and 2 at BH 64; 8 at BH 16 needed two
// waves, 0.067 against 0.051 ms), with kKvTmaMinRows tokens a block. Ring
// kKvTmaStages = 4 stages of 64 tokens of k and v (128 KB; six were
// slower).
//
// On mma.sync (widths not multiples of 8): every product one bf16
// mma.sync.m16n8k16 with fp32 accumulation.
// K5 bf16 (kv_dots_partial_bf16_kernel + kv_dots_reduce_kernel): bf16 k and
// v into fp32 partials and an fp32 result, with the fp32 kernel's split of N,
// warp tiles and fixed-order reduce (the same bits on a repeat). A = k^T
// and B = v both come from [n][row] stages by ldmatrix .trans; rows of 136
// bf16 (272 bytes, 4 words mod 32) keep each ldmatrix phase on 32 banks. A
// stage holds 64 tokens of k and of v (4 k16-steps, summed on the tensor
// cores into a zeroed partial, then one fp32 add: the chain kKvTempSteps
// keeps short for the fp32 kernel); element copies where the width is not a
// multiple of 8 (16-byte copies where it is); a three-stage cp.async ring
// (104 KB), one block of 16 warps an SM.
// K6 bf16 (apply_dots_bf16_kernel<F>): bf16 q, the (D, E) factor read as F
// (fp32, or bf16) and rounded to bf16 to nearest even as it is loaded, once
// per persistent block, held as bf16 rows of 136; q through a three-stage
// cp.async ring of 64-row tiles, A fragments by ldmatrix, B by ldmatrix
// .trans; each k16-step into a zeroed partial, then an fp32 add; the output
// rounded once to bf16 into the warp's own 32 x 32 block of a shared stage,
// then stored element by element (16 bytes a lane where E is a multiple of
// 8). The warps, tiles and persistent grid are the fp32 kernel's; shared
// memory 2 x (128 + 4 x 64) x 136 = 104 KB.
//
// Measured (kernels/attention_sources.py --kernel k5bf16 / k6bf16, called
// directly on the card's clock, one H100 80GB HBM3 at 700 W, D = E = 128;
// PERF.md section 6), BH 16 / 64 at N 16,384, then at N 8,192:
//   K6 TMA, fp32 factor  0.0567 / 0.2019, 0.0287 / 0.1061 ms
//      (mma.sync 0.0932 / 0.3122, 0.0536 / 0.1665; bf16 torch.bmm 0.0532 /
//      0.1935, 0.0292 / 0.1005; bound 0.0401 / 0.1603, 0.0200 / 0.0801)
//   K5 TMA, clusters 4 / 2  0.0516 / 0.1790, 0.0301 / 0.0955 ms
//      (mma.sync + reduce 0.0817 / 0.2986, 0.0453 / 0.1540; torch.bmm with
//      out_dtype float32 0.0591 / 0.1740, 0.0277 / 0.0913; bound 0.0404 /
//      0.1615, 0.0203 / 0.0814)
// K6 runs 1.04-1.06 times bf16 torch.bmm: without its products 0.0550,
// without its stores 0.0292 (the reads alone, 2.3 TB/s). K5's streaming
// matches the library's (0.0485 / 0.1729 without the cluster reduce's
// loads, sums and stores); that reduce, after the last stage, costs 3 / 6 us.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_conv_tiles.cuh"
#include "tma_ring.cuh"

namespace cg = cooperative_groups;

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

// the bf16 instances (K5 and K6 on bf16 operands)
constexpr int kBS = kW + 8;             // bf16 row stride of every stage: 272 bytes, 4 words mod 32
constexpr int kKvBf16Stages = 3;        // K5's cp.async ring
constexpr int kKvBf16Stage = 2 * kKvRows * kBS;  // bf16 elements of one stage: k, then v
constexpr int kKvBf16TempSteps = 4;     // k16-steps on the tensor cores per fp32 add (a stage)
constexpr int kApplyBf16Stages = 3;     // K6's cp.async ring
constexpr int kQBf16Stage = kRowsQ * kBS;  // bf16 elements of one q stage
constexpr int kApplyBf16TempSteps = 1;  // k16-steps on the tensor cores per fp32 add

// the bf16 instances on TMA and wgmma (widths multiples of 8)
constexpr int kPanel = 64;               // bf16 columns of a 128-byte swizzled row: a TMA box, a wgmma panel
constexpr int kPanelRow = 2 * kPanel;    // its bytes
constexpr int kPanels = kW / kPanel;     // panels of the widest D or E
constexpr int kConsumers = 2;            // consumer warpgroups a block
constexpr int kTmaThreads = 128 * kConsumers + 32;  // and one producer warp
constexpr int kKvTmaRows = 64;           // K5: tokens a stage, four k16-steps summed on the tensor cores per fp32 add
constexpr int kKvTmaStages = 4;          // K5's ring
constexpr int kKvTmaCluster = 8;         // K5: blocks a head-batch at most, the portable cluster size
constexpr int kKvTmaMinRows = 256;       // K5: tokens a block at least, where a head-batch has them
constexpr int kKvPartS = kW + 8;         // K5: fp32 row stride of a block's (D, E) partial
constexpr int kApTmaRows = 128;          // K6: q rows a tile, 64 for each consumer warpgroup
constexpr int kApTmaStages = 4;          // K6's ring
constexpr int kOutBufs = 2;              // K6: a warpgroup's staged output tiles, stores in flight
constexpr int kKvPanelBytes = kKvTmaRows * kPanelRow;            // 8 KB: 64 tokens x 64 columns
constexpr int kKvStageBytes = 2 * kPanels * kKvPanelBytes;       // k's panels, then v's: 32 KB
constexpr int kApPanelBytes = kApTmaRows * kPanelRow;            // 16 KB: 128 rows x 64 columns
constexpr int kApStageBytes = kPanels * kApPanelBytes;           // 32 KB
constexpr int kFacPanelBytes = kW * kPanelRow;                   // 16 KB: 128 rows d x 64 columns e
constexpr int kOutPanelBytes = 64 * kPanelRow;                   // 8 KB: a warpgroup's 64 rows x 64 columns
constexpr int kOutBufBytes = kPanels * kOutPanelBytes;           // 16 KB
static_assert(kW * kKvPartS * 4 <= kKvTmaStages * kKvStageBytes, "K5's partial fits its ring");

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
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

// ---------------------------------------------------------------------------
// bf16 instances: bf16 operands on mma.sync.m16n8k16, fp32 accumulators
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 b16 matrices; lane l gives the row address of matrix l / 8,
// row l % 8. Without .trans lane 4g + t receives row g, columns 2t, 2t + 1
// of each; with .trans, column g of rows 2t, 2t + 1.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c += a b: A 16 x 16 (a0 rows g, columns 2t..; a1 rows g + 8; a2, a3 the
// same at columns + 8), B 16 x 8 (b0 rows 2t, 2t + 1 of column g; b1 rows
// + 8), C as in the TF32 product
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ bf16 to_bf16(float x) { return __float2bfloat16_rn(x); }
__device__ __forceinline__ bf16 to_bf16(bf16 x) { return x; }

// rows r0 .. r0 + rows - 1 of an (N, width) bf16 matrix into shared rows of
// kBS elements, columns up to cols (width rounded up to 16); zero past n1
// and past width (no bytes read). vec: 16-byte copies (width % 8 == 0 and a
// 16-byte aligned base), else element by element, synchronously.
template <int kThreads>
__device__ __forceinline__ void load_rows_bf16(bf16* dst, const bf16* src, int r0, int rows,
                                               int n1, int width, int cols, bool vec) {
  if (vec) {
    const int c8 = cols / 8;
    for (int idx = threadIdx.x; idx < rows * c8; idx += kThreads) {
      const int r = idx / c8, c = 8 * (idx % c8);
      const bool valid = r0 + r < n1 && c < width;
      cp_async16(dst + r * kBS + c, valid ? src + (size_t)(r0 + r) * width + c : src, valid);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
      const int r = idx / cols, c = idx % cols;
      const bool valid = r0 + r < n1 && c < width;
      dst[r * kBS + c] = valid ? src[(size_t)(r0 + r) * width + c] : to_bf16(0.f);
    }
  }
}

// K5 bf16: one block sums k_n^T v_n over its split's rows of head-batch
// blockIdx.y into part[bh, s] (or out, with one split), as
// kv_dots_partial_kernel does, each product one bf16 mma.
__global__ void __launch_bounds__(kKvThreads, 1)
kv_dots_partial_bf16_kernel(const bf16* __restrict__ k, const bf16* __restrict__ v,
                            float* __restrict__ part, int N, int D, int E,
                            int rows_per_split, int vec_k, int vec_v) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int bh = blockIdx.y, s = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wd = warp & 3, we = warp >> 2;  // rows 32 wd .., columns 32 we ..
  const bf16* kb = k + (size_t)bh * N * D;
  const bf16* vb = v + (size_t)bh * N * E;
  const int n0 = s * rows_per_split, n1 = min(N, n0 + rows_per_split);
  const int dq = (D + 15) & ~15, eq = (E + 15) & ~15;
  // the warp's m16 tiles that start below D, and its pairs of n8 tiles below
  // E (warp-uniform)
  const int mts = min(2, max(0, (D - 32 * wd + 15) / 16));
  const int nps = min(2, max(0, (E - 32 * we + 15) / 16));
  const int stages = n1 > n0 ? (n1 - n0 + kKvRows - 1) / kKvRows : 0;
  // this lane's ldmatrix row: token (lane & 7) + 8 (lane >> 4) of a k-step
  // and column 8 ((lane >> 3) & 1) for A = k^T (matrices: d 0-7 / 8-15,
  // then tokens 8-15); token (lane & 7) + 8 ((lane >> 3) & 1) and column
  // 8 (lane >> 4) for B = v (matrices: tokens 0-7 / 8-15, then e + 8)
  const int a_off = ((lane & 7) + 8 * (lane >> 4)) * kBS + 32 * wd + 8 * ((lane >> 3) & 1);
  const int b_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * kBS + 32 * we + 8 * (lane >> 4);

  float acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  auto load = [&](int i) {
    bf16* st = smem + (i % kKvBf16Stages) * kKvBf16Stage;
    const int c0 = n0 + i * kKvRows;
    load_rows_bf16<kKvThreads>(st, kb, c0, kKvRows, n1, D, dq, vec_k);
    load_rows_bf16<kKvThreads>(st + kKvRows * kBS, vb, c0, kKvRows, n1, E, eq, vec_v);
  };
#pragma unroll
  for (int i = 0; i < kKvBf16Stages - 1; ++i) {
    if (i < stages) load(i);
    cp_commit();
  }
  for (int it = 0; it < stages; ++it) {
    if (it + kKvBf16Stages - 1 < stages) load(it + kKvBf16Stages - 1);
    cp_commit();
    cp_wait<kKvBf16Stages - 1>();
    __syncthreads();
    if (mts > 0 && nps > 0) {  // warp-uniform
      const bf16* sk = smem + (it % kKvBf16Stages) * kKvBf16Stage;
      const bf16* sv = sk + kKvRows * kBS;
      const int ksteps = (min(kKvRows, n1 - n0 - it * kKvRows) + 15) / 16;
      for (int k0 = 0; k0 < ksteps; k0 += kKvBf16TempSteps) {
        // kKvBf16TempSteps k-steps into a zeroed partial, then one fp32 add
        float pt[2][4][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) pt[m][j][e] = 0.f;
#pragma unroll
        for (int ss = 0; ss < kKvBf16TempSteps; ++ss) {
          if (k0 + ss >= ksteps) break;
          const int r = 16 * (k0 + ss) * kBS;  // the k-step's first token
          uint32_t a[2][4], b[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m)
            if (m < mts) ldsm_x4_trans(a[m], sk + r + a_off + 16 * m);
#pragma unroll
          for (int p = 0; p < 2; ++p)
            if (p < nps) ldsm_x4_trans(b[p], sv + r + b_off + 16 * p);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int m = 0; m < 2; ++m)
              if (m < mts && j / 2 < nps)
                mma_bf16(pt[m][j], a[m], b[j / 2][2 * (j & 1)], b[j / 2][2 * (j & 1) + 1]);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][j][e] += pt[m][j][e];
      }
    }
    __syncthreads();  // the stage is read: a later copy may overwrite it
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
        if (j / 2 >= nps || c >= E) continue;
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

// K6 bf16: persistent blocks walking the 64-row tiles of one head-batch, as
// apply_dots_kernel does; the factor (fp32 or bf16, F) rounded to bf16 as
// it is loaded, once a block, and each product one bf16 mma. The output is
// rounded once to bf16, staged in shared memory by the warp that owns it
// and stored 16 bytes a lane (vec_o), else element by element.
template <typename F>
__global__ void __launch_bounds__(kApplyThreads, 1)
apply_dots_bf16_kernel(const bf16* __restrict__ q, const F* __restrict__ dots,
                       bf16* __restrict__ o, int N, int D, int E, int vec_q, int vec_o) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int dp = (D + 15) & ~15, ep = (E + 15) & ~15;
  bf16* fac = reinterpret_cast<bf16*>(smem_raw);      // (dp, kBS): the factor
  bf16* sq = fac + dp * kBS;                          // [stage][kRowsQ][kBS]
  bf16* so = sq + kApplyBf16Stages * kQBf16Stage;     // [kRowsQ][kBS]: output
  const int bh = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp % kRowGroups, cq = warp / kRowGroups;  // row group, column quarter
  const int ntiles = (N + kRowsQ - 1) / kRowsQ;
  const int mine = ntiles > (int)blockIdx.x
                       ? (ntiles - (int)blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const bf16* qb = q + (size_t)bh * N * D;
  bf16* ob = o + (size_t)bh * N * E;
  // pairs of n8 tiles of this warp's quarter that hold columns below E
  const int nps = min(2, max(0, (ep - 32 * cq) / 16));
  // this lane's ldmatrix rows: A = q (matrices: rows 0-7 / 8-15, then
  // columns + 8), B = the factor (rows d 0-7 / 8-15, then columns e + 8)
  const int a_off = (32 * rg + (lane & 7) + 8 * ((lane >> 3) & 1)) * kBS + 8 * (lane >> 4);
  const int b_off = ((lane & 7) + 8 * ((lane >> 3) & 1)) * kBS + 32 * cq + 8 * (lane >> 4);

  auto load = [&](int i) {
    const int tile = blockIdx.x + i * gridDim.x;
    load_rows_bf16<kApplyThreads>(sq + (i % kApplyBf16Stages) * kQBf16Stage, qb,
                                  tile * kRowsQ, kRowsQ, N, D, dp, vec_q);
  };
#pragma unroll
  for (int i = 0; i < kApplyBf16Stages - 1; ++i) {
    if (i < mine) load(i);
    cp_commit();
  }

  // the factor, rounded to bf16 once per block; zero past D and E
  const F* db = dots + (size_t)bh * D * E;
  for (int idx = threadIdx.x; idx < dp * ep; idx += kApplyThreads) {
    const int d = idx / ep, e = idx % ep;
    fac[d * kBS + e] = d < D && e < E ? to_bf16(db[d * E + e]) : to_bf16(0.f);
  }

  for (int it = 0; it < mine; ++it) {
    if (it + kApplyBf16Stages - 1 < mine) load(it + kApplyBf16Stages - 1);
    cp_commit();
    cp_wait<kApplyBf16Stages - 1>();
    __syncthreads();
    const int tile = blockIdx.x + it * gridDim.x;
    if (nps > 0) {  // warp-uniform
      const bf16* qs = sq + (it % kApplyBf16Stages) * kQBf16Stage;
      float acc[kMTiles][4][4];
#pragma unroll
      for (int m = 0; m < kMTiles; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
      for (int k0 = 0; k0 < dp; k0 += 16 * kApplyBf16TempSteps) {
        // kApplyBf16TempSteps k-steps into a zeroed partial, then one fp32
        // add into acc
        float part[kMTiles][4][4];
#pragma unroll
        for (int m = 0; m < kMTiles; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[m][j][e] = 0.f;
#pragma unroll
        for (int ss = 0; ss < kApplyBf16TempSteps; ++ss) {
          const int kk = k0 + 16 * ss;
          if (kk >= dp) break;
          uint32_t a[kMTiles][4], b[2][4];
#pragma unroll
          for (int m = 0; m < kMTiles; ++m) ldsm_x4(a[m], qs + a_off + 16 * m * kBS + kk);
#pragma unroll
          for (int p = 0; p < 2; ++p)
            if (p < nps) ldsm_x4_trans(b[p], fac + kk * kBS + b_off + 16 * p);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int m = 0; m < kMTiles; ++m)
              if (j / 2 < nps)
                mma_bf16(part[m][j], a[m], b[j / 2][2 * (j & 1)], b[j / 2][2 * (j & 1) + 1]);
        }
#pragma unroll
        for (int m = 0; m < kMTiles; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][j][e] += part[m][j][e];
      }
      // C fragment (g, 2t), (g, 2t + 1), (g + 8, ...), rounded once to bf16
      // into the warp's own 32 x 32 block of the output stage
#pragma unroll
      for (int m = 0; m < kMTiles; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j / 2 < nps) {
              const int r = 16 * kMTiles * rg + 16 * m + 8 * h + g;
              *reinterpret_cast<__nv_bfloat162*>(so + r * kBS + 32 * cq + 8 * j + 2 * t) =
                  __floats2bfloat162_rn(acc[m][j][2 * h], acc[m][j][2 * h + 1]);
            }
      __syncwarp();
      const int row0 = tile * kRowsQ + 16 * kMTiles * rg;
      if (vec_o) {
        // 32 rows x 4 chunks of 8 columns: a 16-byte store per chunk
#pragma unroll
        for (int i = lane; i < 16 * kMTiles * 4; i += 32) {
          const int r = i / 4, c = 32 * cq + 8 * (i % 4);
          if (row0 + r < N && c < E)
            *reinterpret_cast<int4*>(ob + (size_t)(row0 + r) * E + c) =
                *reinterpret_cast<const int4*>(so + (16 * kMTiles * rg + r) * kBS + c);
        }
      } else {
        for (int i = lane; i < 16 * kMTiles * 32; i += 32) {
          const int r = i / 32, c = 32 * cq + i % 32;
          if (row0 + r < N && c < E)
            ob[(size_t)(row0 + r) * E + c] = so[(16 * kMTiles * rg + r) * kBS + c];
        }
      }
    }
    __syncthreads();  // the stages are read: later copies may overwrite them
  }
  cp_wait<0>();
}

// ---------------------------------------------------------------------------
// bf16 instances on TMA and wgmma (the route where D and E are multiples of
// 8): a producer warp keeps a ring of TMA tiles full under full / empty
// mbarriers (csrc/tma_ring.cuh); two consumer warpgroups only multiply, on
// wgmma m64n64k16 with both operands in shared memory (128-byte swizzle)
// ---------------------------------------------------------------------------

// eight consecutive values of the factor as they are loaded, and as bf16
struct Fp32x8 {
  float4 a, b;
};

__device__ __forceinline__ uint4 load8(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ Fp32x8 load8(const float* p) {
  return {__ldg(reinterpret_cast<const float4*>(p)), __ldg(reinterpret_cast<const float4*>(p) + 1)};
}

__device__ __forceinline__ uint4 bf16x8(uint4 v) { return v; }

// rounded to bf16 to nearest even
__device__ __forceinline__ uint4 bf16x8(const Fp32x8& v) {
  return make_uint4(bf16t::pack2(v.a.x, v.a.y), bf16t::pack2(v.a.z, v.a.w),
                    bf16t::pack2(v.b.x, v.b.y), bf16t::pack2(v.b.z, v.b.w));
}

// One head-batch's (D, E) factor, rounded to bf16, into wgmma's MN-major B
// layout, by the consumers' threads (tid < 128 kConsumers) in two steps:
// `issue` loads a thread's chunks into registers (a chunk past D or E loads
// the factor's first chunk), `store` rounds them and writes panel e / 64,
// row d (128 bytes), 16-byte chunk (e % 64) / 8 at chunk ^ (d & 7), zero
// past D and E to the full kW x kW. A block issues a head-batch's loads
// before it needs them (the first before its ring's first copies, the next
// as soon as the last is stored), so the factor's latency is paid once, not
// once a chunk nor once a head-batch.
template <typename F>
struct FactorLoads {
  static constexpr int kRow = 8 * kPanels;                     // 16-byte chunks a row
  static constexpr int kPer = kW * kRow / (128 * kConsumers);  // chunks a thread
  decltype(load8(static_cast<const F*>(nullptr))) v[kPer];

  __device__ __forceinline__ void issue(const F* db, int D, int E, int tid) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int c = tid + r * 128 * kConsumers, d = c / kRow, e0 = 8 * (c % kRow);
      v[r] = load8(db + (d < D && e0 < E ? (size_t)d * E + e0 : 0));
    }
  }

  __device__ __forceinline__ void store(unsigned char* fac, int D, int E, int tid) const {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int c = tid + r * 128 * kConsumers, d = c / kRow, j = c % kRow;
      *reinterpret_cast<uint4*>(fac + (j / 8) * kFacPanelBytes + d * kPanelRow +
                                (((j % 8) ^ (d & 7)) << 4)) =
          d < D && 8 * j < E ? bf16x8(v[r]) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
};

// Zero the `bytes` at p (a multiple of 16) by threads tid < threads: ring
// panels that no TMA load fills (D or E at most 64), read by the products
// all the same
__device__ __forceinline__ void zero_smem(unsigned char* p, int bytes, int tid, int threads) {
  for (int i = 16 * tid; i < bytes; i += 16 * threads)
    *reinterpret_cast<uint4*>(p + i) = make_uint4(0u, 0u, 0u, 0u);
}

// K5 bf16 on TMA: one thread-block cluster a head-batch (blockIdx.y), one
// block a rank, each summing k_n^T v_n over its `rows` tokens (rank *
// rows ..) into a (D, E) partial in its shared memory; then rank s reads
// rows d = D s / ranks .. of every rank's partial over distributed shared
// memory, sums them in rank order and stores them.
// Consumer warpgroup w owns rows d 64 w .. 64 w + 63 and every column e,
// zero past D and E: every product runs at every width.
__global__ void __launch_bounds__(kTmaThreads, 1)
kv_dots_tma_kernel(const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, float* __restrict__ out, int N,
                   int D, int E, int rows) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = bf16t::align1024(smem_raw);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(ring + kKvTmaStages * kKvStageBytes);
  unsigned long long* empty = full + kKvTmaStages;
  float* part = reinterpret_cast<float*>(ring);  // after the sums: the block's (D, E) partial
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ranks = (int)cluster.num_blocks();
  const int bh = blockIdx.y;
  const int n0 = rank * rows, n1 = min(N, n0 + rows);
  const int stages = n1 > n0 ? (n1 - n0 + kKvTmaRows - 1) / kKvTmaRows : 0;
  const int dpanels = (D + kPanel - 1) / kPanel, epanels = (E + kPanel - 1) / kPanel;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kKvTmaStages; ++s) {
      tma::mbar_init(full + s, 1);
      tma::mbar_init(empty + s, 4 * kConsumers);
    }
    tma::fence_barrier_init();
  }
  if (warp < 4 * kConsumers) {
    for (int s = 0; s < kKvTmaStages; ++s) {
      unsigned char* st = ring + s * kKvStageBytes;
      if (dpanels < kPanels)
        zero_smem(st + kKvPanelBytes, kKvPanelBytes, threadIdx.x, 128 * kConsumers);
      if (epanels < kPanels)
        zero_smem(st + (2 * kPanels - 1) * kKvPanelBytes, kKvPanelBytes, threadIdx.x,
                  128 * kConsumers);
    }
    bf16t::fence_async_smem();
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {
    // the producer: stage i holds tokens n0 + 64 i .. of k (panels of D) and
    // v (panels of E); TMA zero-fills the tokens past N and the columns past
    // D and E
    if (lane == 0) {
      for (int i = 0; i < stages; ++i) {
        const int s = i % kKvTmaStages;
        if (i >= kKvTmaStages) tma::mbar_wait(empty + s, (i / kKvTmaStages - 1) & 1);
        unsigned char* st = ring + s * kKvStageBytes;
        const int c1 = n0 + i * kKvTmaRows;
        tma::mbar_expect_tx(full + s, (dpanels + epanels) * kKvPanelBytes);
        for (int p = 0; p < dpanels; ++p)
          tma::load_3d(st + p * kKvPanelBytes, &kmap, full + s, kPanel * p, c1, bh);
        for (int p = 0; p < epanels; ++p)
          tma::load_3d(st + (kPanels + p) * kKvPanelBytes, &vmap, full + s, kPanel * p, c1, bh);
      }
    }
    __syncwarp();
  } else {
    const int wg = warp / 4;
    float acc[kPanels][32];
#pragma unroll
    for (int pe = 0; pe < kPanels; ++pe)
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[pe][r] = 0.f;
    for (int i = 0; i < stages; ++i) {
      const int s = i % kKvTmaStages;
      tma::mbar_wait(full + s, (i / kKvTmaStages) & 1);
      // A = k^T (MN-major: panel wg of k, d contiguous), B = v (MN-major);
      // the stage's k16-steps summed on the tensor cores into tmp (the first
      // with scale-d 0), then one fp32 add
      const uint32_t st = tma::smem_u32(ring + s * kKvStageBytes);
      float tmp[kPanels][32];
      bf16t::wg_fence();
#pragma unroll
      for (int ks = 0; ks < kKvTmaRows / 16; ++ks) {
        const uint64_t da = bf16t::wg_desc(st + wg * kKvPanelBytes + ks * 16 * kPanelRow);
#pragma unroll
        for (int pe = 0; pe < kPanels; ++pe)
          bf16t::wg_mma_ss<1, 1>(
              tmp[pe], da,
              bf16t::wg_desc(st + (kPanels + pe) * kKvPanelBytes + ks * 16 * kPanelRow),
              ks > 0);
      }
      bf16t::wg_commit();
      bf16t::wg_wait<0>();
      if (lane == 0) tma::mbar_arrive(empty + s);
#pragma unroll
      for (int pe = 0; pe < kPanels; ++pe)
#pragma unroll
        for (int r = 0; r < 32; ++r) acc[pe][r] += tmp[pe][r];
    }
    // both warpgroups have read their last stage: the ring may hold the
    // partial. D fragment: d[4 j + e] at row g + 8 (e >> 1) of the warp's
    // 16, column 8 j + 2 t + (e & 1) of the panel
    tma::bar_sync(1, 128 * kConsumers);
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int pe = 0; pe < kPanels; ++pe)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = kPanel * wg + 16 * (warp % 4) + g + 8 * h;
          *reinterpret_cast<float2*>(part + d * kKvPartS + kPanel * pe + 8 * j + 2 * t) =
              make_float2(acc[pe][4 * j + 2 * h], acc[pe][4 * j + 2 * h + 1]);
        }
  }
  cluster.sync();  // every rank's partial is in its shared memory
  // this rank's rows of the result, four columns a step: every rank's
  // partial read over distributed shared memory (the loads of a step issued
  // together) and summed in rank order
  uint32_t src[kKvTmaCluster];
#pragma unroll
  for (int r = 0; r < kKvTmaCluster; ++r)
    src[r] = r < ranks ? tma::map_rank(tma::smem_u32(part), r) : 0u;
  const int d0 = (int)((long long)D * rank / ranks), d1 = (int)((long long)D * (rank + 1) / ranks);
  const int q4 = (d1 - d0) * E / 4;
  for (int i = threadIdx.x; i < q4; i += kTmaThreads) {
    const int d = d0 + 4 * i / E, e = 4 * i % E;
    const uint32_t off = (uint32_t)(d * kKvPartS + e) * sizeof(float);
    float4 x[kKvTmaCluster];
#pragma unroll
    for (int r = 0; r < kKvTmaCluster; ++r)
      if (r < ranks) x[r] = tma::ld_cluster_f4(src[r] + off);
    float4 sum = x[0];
#pragma unroll
    for (int r = 1; r < kKvTmaCluster; ++r)
      if (r < ranks) {
        sum.x += x[r].x;
        sum.y += x[r].y;
        sum.z += x[r].z;
        sum.w += x[r].w;
      }
    *reinterpret_cast<float4*>(out + ((size_t)bh * D + d) * E + e) = sum;
  }
  cluster.sync();  // every rank has read the others' partials: a block may exit
}

// K6 bf16 on TMA: persistent blocks, each walking a contiguous run of the
// (head-batch, 128-row tile) space; the factor (F: fp32 or bf16) rounded to
// bf16 into shared memory once per head-batch a block holds. Consumer
// warpgroup w multiplies rows 64 w .. 64 w + 63 of each tile (zero past D
// and E: every product runs at every width) and stores them by TMA from a
// staging tile of its own.
template <typename F>
__global__ void __launch_bounds__(kTmaThreads, 1)
apply_dots_tma_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap omap, const F* __restrict__ dots,
                      int BH, int N, int D, int E) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* fac = bf16t::align1024(smem_raw);       // kPanels factor panels
  unsigned char* ring = fac + kPanels * kFacPanelBytes;  // kApTmaStages q tiles
  unsigned char* outs = ring + kApTmaStages * kApStageBytes;  // [warpgroup][buffer]
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(outs + kConsumers * kOutBufs * kOutBufBytes);
  unsigned long long* empty = full + kApTmaStages;
  const int tiles = (N + kApTmaRows - 1) / kApTmaRows;
  const long long total = (long long)BH * tiles;
  const int first = (int)(total * blockIdx.x / gridDim.x);
  const int mine = (int)(total * (blockIdx.x + 1) / gridDim.x) - first;
  const int dpanels = (D + kPanel - 1) / kPanel, epanels = (E + kPanel - 1) / kPanel;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the first head-batch's factor, in shared memory before the ring's first
  // copies are issued: they would delay its loads behind theirs
  FactorLoads<F> fl;
  if (warp < 4 * kConsumers && mine > 0) {
    fl.issue(dots + (size_t)(first / tiles) * D * E, D, E, threadIdx.x);
    fl.store(fac, D, E, threadIdx.x);
    if ((long long)(first / tiles + 1) * tiles < first + mine)  // the block's next head-batch
      fl.issue(dots + (size_t)(first / tiles + 1) * D * E, D, E, threadIdx.x);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kApTmaStages; ++s) {
      tma::mbar_init(full + s, 1);
      tma::mbar_init(empty + s, 4 * kConsumers);
    }
    tma::fence_barrier_init();
  }
  if (warp < 4 * kConsumers) {
    if (dpanels < kPanels)
      for (int s = 0; s < kApTmaStages; ++s)
        zero_smem(ring + s * kApStageBytes + kApPanelBytes, kApPanelBytes, threadIdx.x,
                  128 * kConsumers);
    bf16t::fence_async_smem();  // the factor and the zeros, to wgmma
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {
    // the producer: q rows of tile u (panels of D); TMA zero-fills the rows
    // past N and the columns past D
    if (lane == 0) {
      for (int i = 0; i < mine; ++i) {
        const int s = i % kApTmaStages;
        if (i >= kApTmaStages) tma::mbar_wait(empty + s, (i / kApTmaStages - 1) & 1);
        const int u = first + i, bh = u / tiles, row0 = (u % tiles) * kApTmaRows;
        unsigned char* st = ring + s * kApStageBytes;
        tma::mbar_expect_tx(full + s, dpanels * kApPanelBytes);
        for (int p = 0; p < dpanels; ++p)
          tma::load_3d(st + p * kApPanelBytes, &qmap, full + s, kPanel * p, row0, bh);
      }
    }
    return;
  }

  const int tid = threadIdx.x, wg = warp / 4, wi = warp % 4, g = lane / 4, t = lane % 4;
  const bool leader = tid % 128 == 0;  // issues the warpgroup's stores
  const uint32_t f0 = tma::smem_u32(fac);
  int cur = first / tiles;
  for (int i = 0; i < mine; ++i) {
    const int u = first + i, bh = u / tiles, row0 = (u % tiles) * kApTmaRows;
    if (bh != cur) {
      // both warpgroups' products on the last factor are done
      tma::bar_sync(1, 128 * kConsumers);
      fl.store(fac, D, E, tid);
      bf16t::fence_async_smem();
      tma::bar_sync(1, 128 * kConsumers);
      cur = bh;
      if ((long long)(cur + 1) * tiles < first + mine)  // the block's next head-batch
        fl.issue(dots + (size_t)(cur + 1) * D * E, D, E, tid);
    }
    const int s = i % kApTmaStages;
    tma::mbar_wait(full + s, (i / kApTmaStages) & 1);
    // A = q (K-major: the warpgroup's 64 rows of each D panel), B = the factor
    // (MN-major)
    const uint32_t a0 = tma::smem_u32(ring + s * kApStageBytes) + wg * (kApPanelBytes / 2);
    float acc[kPanels][32];  // the first k16-step with scale-d 0
    bf16t::wg_fence();
#pragma unroll
    for (int ks = 0; ks < kW / 16; ++ks) {
      const uint64_t da = bf16t::wg_desc_k(a0 + (ks / 4) * kApPanelBytes + (ks % 4) * 32);
#pragma unroll
      for (int pe = 0; pe < kPanels; ++pe)
        bf16t::wg_mma_ss<0, 1>(acc[pe], da,
                               bf16t::wg_desc(f0 + pe * kFacPanelBytes + ks * 16 * kPanelRow),
                               ks > 0);
    }
    bf16t::wg_commit();
    bf16t::wg_wait<0>();
    if (lane == 0) tma::mbar_arrive(empty + s);

    // the output rounded once to bf16 into a staging tile (128-byte swizzle)
    // that the store of the tile kOutBufs back has finished reading
    unsigned char* so = outs + (wg * kOutBufs + i % kOutBufs) * kOutBufBytes;
    if (leader) tma::store_wait_read<kOutBufs - 1>();
    tma::bar_sync(2 + wg, 128);
#pragma unroll
    for (int pe = 0; pe < kPanels; ++pe)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wi + g + 8 * h;
          *reinterpret_cast<uint32_t*>(so + pe * kOutPanelBytes + r * kPanelRow +
                                       ((j ^ (r & 7)) << 4) + 4 * t) =
              bf16t::pack2(acc[pe][4 * j + 2 * h], acc[pe][4 * j + 2 * h + 1]);
        }
    bf16t::fence_async_smem();
    tma::bar_sync(2 + wg, 128);
    if (leader) {
      // rows past N and columns past E are clipped; a group a tile, empty
      // where the warpgroup's rows all lie past N
      if (row0 + 64 * wg < N)
        for (int pe = 0; pe < epanels; ++pe)
          tma::store_3d(&omap, so + pe * kOutPanelBytes, kPanel * pe, row0 + 64 * wg, bh);
      tma::store_commit();
    }
  }
  if (leader) tma::store_wait<0>();
}

size_t kv_bf16_smem() { return (size_t)kKvBf16Stages * kKvBf16Stage * sizeof(bf16); }

size_t apply_bf16_smem(int d) {
  const int dp = (d + 15) & ~15;
  return (size_t)(dp * kBS + (kApplyBf16Stages + 1) * kQBf16Stage) * sizeof(bf16);
}

size_t apply_smem(int d) {
  const int dp = (d + 7) & ~7;
  return (size_t)(2 * dp * kFS + 2 * kQStage) * sizeof(float);
}

bool widths_ok(int d, int e) { return d >= 1 && d <= kW && e >= 1 && e <= kW; }

size_t kv_tma_smem() {
  return 1024 + (size_t)kKvTmaStages * kKvStageBytes + 2 * kKvTmaStages * sizeof(unsigned long long);
}

size_t apply_tma_smem() {
  return 1024 + (size_t)kPanels * kFacPanelBytes + (size_t)kApTmaStages * kApStageBytes +
         (size_t)kConsumers * kOutBufs * kOutBufBytes +
         2 * kApTmaStages * sizeof(unsigned long long);
}

// the TMA route: whole 16-byte units a row and 16-byte aligned bases
bool tma_ok(int d, int e, const void* a, const void* b) {
  return widths_ok(d, e) && d % 8 == 0 && e % 8 == 0 && (uintptr_t)a % 16 == 0 &&
         (uintptr_t)b % 16 == 0;
}

// K5's tokens a cluster rank: whole stages, ranks * rows >= n
int kv_tma_rows(int n, int ranks) {
  return ((n + ranks - 1) / ranks + kKvTmaRows - 1) / kKvTmaRows * kKvTmaRows;
}

cudaLaunchConfig_t kv_tma_config(int ranks, int bh, cudaLaunchAttribute* attr, void* stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, bh);
  cfg.blockDim = dim3(kTmaThreads);
  cfg.dynamicSmemBytes = kv_tma_smem();
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t kv_tma_attr() {
  static cudaError_t e = cudaFuncSetAttribute(
      kv_dots_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_tma_smem());
  return e;
}

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

// the bf16 K5: bf16 k (bh, n, d) and v (bh, n, e), fp32 out and part, as
// mc_kv_dots
int mc_kv_dots_bf16(const void* k, const void* v, float* out, float* part, int bh,
                    int n, int d, int e, int splits, int rows_per_split, void* stream) {
  if (!widths_ok(d, e) || splits < 1 || (splits > 1 && !part) ||
      (long long)rows_per_split * splits < n)
    return (int)cudaErrorInvalidValue;
  static cudaError_t attr = cudaFuncSetAttribute(
      kv_dots_partial_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kv_bf16_smem());
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t st = (cudaStream_t)stream;
  const int vec_k = d % 8 == 0 && (uintptr_t)k % 16 == 0;
  const int vec_v = e % 8 == 0 && (uintptr_t)v % 16 == 0;
  kv_dots_partial_bf16_kernel<<<dim3(splits, bh), kKvThreads, kv_bf16_smem(), st>>>(
      (const bf16*)k, (const bf16*)v, splits == 1 ? out : part, n, d, e, rows_per_split,
      vec_k, vec_v);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int de = d * e;
  kv_dots_reduce_kernel<<<dim3((de + 255) / 256, bh), 256, 0, st>>>(part, out,
                                                                    splits, de);
  return (int)cudaGetLastError();
}

// the bf16 K6: bf16 q (bh, n, d), the factor (bh, d, e) fp32 (dots_bf16 0)
// or bf16 (1), bf16 out (bh, n, e)
int mc_apply_dots_bf16(const void* q, const void* dots, int dots_bf16, void* out, int bh,
                       int n, int d, int e, void* stream) {
  if (!widths_ok(d, e) || bh < 1 || n < 1) return (int)cudaErrorInvalidValue;
  static int sms = 0;
  static cudaError_t err = [] {
    int dev = 0;
    cudaError_t e2 = cudaGetDevice(&dev);
    if (e2 == cudaSuccess)
      e2 = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e2 == cudaSuccess)
      e2 = cudaFuncSetAttribute(apply_dots_bf16_kernel<float>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)apply_bf16_smem(kW));
    if (e2 == cudaSuccess)
      e2 = cudaFuncSetAttribute(apply_dots_bf16_kernel<bf16>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)apply_bf16_smem(kW));
    return e2;
  }();
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (n + kRowsQ - 1) / kRowsQ;
  const int per_bh = ntiles < sms / bh ? ntiles : (sms / bh > 0 ? sms / bh : 1);
  const int vec_q = d % 8 == 0 && (uintptr_t)q % 16 == 0;
  const int vec_o = e % 8 == 0 && (uintptr_t)out % 16 == 0;
  const dim3 grid(per_bh, bh);
  const size_t smem = apply_bf16_smem(d);
  cudaStream_t st = (cudaStream_t)stream;
  if (dots_bf16)
    apply_dots_bf16_kernel<bf16><<<grid, kApplyThreads, smem, st>>>(
        (const bf16*)q, (const bf16*)dots, (bf16*)out, n, d, e, vec_q, vec_o);
  else
    apply_dots_bf16_kernel<float><<<grid, kApplyThreads, smem, st>>>(
        (const bf16*)q, (const float*)dots, (bf16*)out, n, d, e, vec_q, vec_o);
  return (int)cudaGetLastError();
}

// the bf16 K5 on TMA: bf16 k (bh, n, d) and v (bh, n, e), d and e multiples
// of 8, 16-byte aligned; fp32 out (bh, d, e); one cluster of `ranks` blocks
// (1 to 8) a head-batch, one launch
int mc_kv_dots_bf16_tma(const void* k, const void* v, float* out, int bh, int n, int d, int e,
                        int ranks, void* stream) {
  if (!tma_ok(d, e, k, v) || (uintptr_t)out % 16 || bh < 1 || n < 1 || ranks < 1 ||
      ranks > kKvTmaCluster)
    return (int)cudaErrorInvalidValue;
  const cudaError_t attr = kv_tma_attr();
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap kmap, vmap;
  int rc = tma::encode_bf16_3d(&kmap, k, bh, n, d, kPanel, kKvTmaRows);
  if (rc == 0) rc = tma::encode_bf16_3d(&vmap, v, bh, n, e, kPanel, kKvTmaRows);
  if (rc != 0) return rc;
  cudaLaunchAttribute la[1];
  const cudaLaunchConfig_t cfg = kv_tma_config(ranks, bh, la, stream);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kv_dots_tma_kernel, kmap, vmap, out, n, d, e,
                                             kv_tma_rows(n, ranks));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// clusters of `ranks` blocks of the bf16 K5 on TMA that the card holds at
// once (cudaOccupancyMaxActiveClusters) into *active
int mc_kv_dots_bf16_tma_clusters(int ranks, int* active) {
  if (ranks < 1 || ranks > kKvTmaCluster) return (int)cudaErrorInvalidValue;
  const cudaError_t attr = kv_tma_attr();
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchAttribute la[1];
  const cudaLaunchConfig_t cfg = kv_tma_config(ranks, 1, la, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(active, kv_dots_tma_kernel, &cfg);
}

// the bf16 K6 on TMA: bf16 q (bh, n, d), the factor (bh, d, e) fp32
// (dots_bf16 0) or bf16 (1), bf16 out (bh, n, e); d and e multiples of 8,
// every base 16-byte aligned; one block an SM, at most one a tile
int mc_apply_dots_bf16_tma(const void* q, const void* dots, int dots_bf16, void* out, int bh,
                           int n, int d, int e, void* stream) {
  if (!tma_ok(d, e, q, out) || (uintptr_t)dots % 16 || bh < 1 || n < 1)
    return (int)cudaErrorInvalidValue;
  static int sms = 0;
  static cudaError_t err = [] {
    int dev = 0;
    cudaError_t e2 = cudaGetDevice(&dev);
    if (e2 == cudaSuccess)
      e2 = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e2 == cudaSuccess)
      e2 = cudaFuncSetAttribute(apply_dots_tma_kernel<float>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)apply_tma_smem());
    if (e2 == cudaSuccess)
      e2 = cudaFuncSetAttribute(apply_dots_tma_kernel<bf16>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)apply_tma_smem());
    return e2;
  }();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap qmap, omap;
  int rc = tma::encode_bf16_3d(&qmap, q, bh, n, d, kPanel, kApTmaRows);
  if (rc == 0) rc = tma::encode_bf16_3d(&omap, out, bh, n, e, kPanel, 64);
  if (rc != 0) return rc;
  const long long total = (long long)bh * ((n + kApTmaRows - 1) / kApTmaRows);
  const int grid = (int)(total < sms ? total : sms);
  cudaStream_t st = (cudaStream_t)stream;
  if (dots_bf16)
    apply_dots_tma_kernel<bf16><<<grid, kTmaThreads, apply_tma_smem(), st>>>(
        qmap, omap, (const bf16*)dots, bh, n, d, e);
  else
    apply_dots_tma_kernel<float><<<grid, kTmaThreads, apply_tma_smem(), st>>>(
        qmap, omap, (const float*)dots, bh, n, d, e);
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
