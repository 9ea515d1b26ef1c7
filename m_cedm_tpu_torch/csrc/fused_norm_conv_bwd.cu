// K2 and K3 backward: the gradients of
//
//   K2  out = conv3x3(act(x)) + bias [+ residual tail],  act(x) = silu(gn(x) *
//       gamma + beta), or act(x) = x in the linear mode
//   K3  out = conv3x3(upsample2x_nearest(act(x))) + bias
//
// NHWC fp32 in and out; conv weights HWIO (3, 3, C, O).
//
// Replaces m_cedm_tpu/pallas/fused_norm_conv.py::_gnsc_bwd_kernel_a (phase A
// of the K2 backward, via _bwd_phase_a / _pallas_gnsc_bwd and the paired
// _pallas_gnsc_bwd_paired, _block_bwd and _blockp_bwd) and
// ::_up_pair_bwd_kernel (K3, via _pallas_up_pair_bwd). The TPU runs one kernel
// per backward over a sequential (B, H / R) grid that carries dW, dbias,
// dgamma and dbeta in VMEM from step to step and emits da. Blocks on Hopper
// run in parallel and in no order, so the work splits into two kernels, each
// followed by a reduce of per-block partials in a fixed order:
//
//   dgrad  da = conv3x3^T(g) * silu'(a): a 3x3 conv of the cotangent g with
//          the mirrored taps and the transposed weight, zero outside the
//          image (the cotangent of SAME zero padding), then multiplied by
//          silu'(a) with a = xhat * gamma + beta recomputed from x and the
//          forward's saved statistics. The epilogue also reduces
//          dgamma = sum da * xhat and dbeta = sum da over the block's pixels
//          into a (2, B, tiles, C) scratch, which colsum_kernel adds in a
//          fixed order. Linear mode: da is the transposed conv itself. K3:
//          the tile runs at high resolution and the epilogue adds the two
//          high-res columns of each low-res pixel (lanes 4 apart in the
//          accumulator, one shuffle), writing a (B, H, W / 2, C) tensor; the
//          row pair and the GroupNorm / SiLU backward at low resolution
//          follow in PyTorch, as they follow in XLA on the TPU
//          (_pallas_up_pair_bwd).
//   wgrad  dW[tap] = sum over pixels of act(x) shifted by the tap, times g:
//          a (9 C x O) product that reduces over all B * H * W pixels
//          (262,144 at the flagship shape); dbias = sum g. Per-run partial
//          tiles go to a (B * runs, taps * C * O + O) scratch, and
//          colsum_kernel adds the runs in a fixed order, so dW and dbias
//          repeat bit for bit. The 1x1 projection skip's weight gradient is
//          the same kernel with one tap and no activation.
//
// dx then follows from da, gamma, dgamma, dbeta and the statistics in one
// elementwise PyTorch pass (_dx_from_da is XLA on the TPU as well).
//
// Bound. dgrad and wgrad each do the forward conv's 2 * 9 * C * O FLOPs per
// pixel (19.3 GFLOP each at the flagship shape, 64 -> 64 channels at 16 x 128
// x 128), about 150 FLOP per byte moved: arithmetic sets the time. On the
// CUDA cores (67 TFLOP/s fp32) that is 0.288 ms each; in 3xTF32 on the tensor
// cores (three TF32 products per fp32 product at 495 TFLOP/s) 0.117 ms, and
// TF32 mma.sync peaks at about 324 TFLOP/s on the H100 (0.18 ms).
//
// Both kernels run every product in 3xTF32 on mma.sync.m16n8k8, as the
// forward (csrc/fused_norm_conv.cu, whose helpers are copied below): each
// fp32 operand split once as hi = tf32(x), lo = tf32(x - hi) (cvt.rn) into a
// plane in shared memory whose layout makes each fragment one 16-byte load,
// the products summed lo*hi + hi*lo + hi*hi, a short run of k-steps on the
// tensor cores into a zeroed fragment before each fp32 add. Copies of raw
// operands run on cp.async while the tensor cores work.
//
// dgrad is the forward's implicit GEMM on g: M = the block's 8 x 16 pixels,
// N = 64 input channels of the forward, K = 9 taps x O cotangent channels,
// 8 warps of 2 m-tiles x 4 n-tiles, two blocks an SM (104 KB of shared
// memory, at most 128 registers). The cotangent needs no normalising pass:
// its halo'd 10 x 18 x 8 chunk rides on cp.async as it is and is only split.
// The weight chunk is staged already mirrored and transposed: row (tap,
// channel c) holds forward tap 8 - tap's eight cotangent channels of c, 32
// contiguous bytes of w, its two 16-byte halves swapped on bit 2 of c so
// that the split pass reads it without bank conflicts. Nine taps a partial
// (kTempSteps), as the forward.
//
// wgrad is a GEMM of M = C, N = O and K = the pixels. A block owns a run of
// 4 x 16 pixel tiles of one image, 32 input and 32 output channels, and all
// nine taps: 9 warps, warp w tap w, each 2 m-tiles (32 channels of act(x))
// x 4 n-tiles (32 channels of g) = 32 x 32 outputs. A k-step is eight pixels
// of a tile row; the shift of a tap moves the K index (the pixel), not M,
// so the forward's fragment-order planes do not carry over. Instead:
//   - act(x) is rebuilt once per halo'd 6 x 18 position and channel (one
//     expf each; K3 reads low-res pixel (Y / 2, X / 2), so the 4x tensor
//     never exists) into a plane that holds, per position and 16-channel
//     m-tile, lane group g's (hi c_g, hi c_g+8, lo c_g, lo c_g+8): the A
//     fragment of any tap at pixels t and t + 4 is two 16-byte loads at the
//     shifted positions. The eight 16-byte groups of a position are XOR
//     swizzled by the position's low two bits, so the four positions a
//     quarter warp reads fall on distinct banks.
//   - g is split once into B-fragment order, (k-step, n-tile, lane) ->
//     (hi b0, hi b1, lo b0, lo b1): each split g element feeds 9 taps x 2
//     m-tiles, read by the nine warps from the same plane.
//   - the raw x and g tiles of the next tile are fetched by cp.async into a
//     single raw stage while the warps multiply this tile (the split pass
//     empties the stage before the next copy is issued).
// Accumulators: 9 taps x 32 x 32 outputs is 32 floats a thread in 9 warps;
// the zeroed tensor-core partial is added every kWTempSteps k-steps of a
// tile (and at the tile's end) into the fp32 sum, which each thread keeps
// in its own slot of shared memory (36 KB), so registers hold only the
// partial and the fragments and two blocks fit an SM (106 KB each; at two
// 9-warp blocks one SM sub-partition holds five warps, which caps a thread
// at 96 registers). g is read once for every 32 input channels (twice at
// C = 64), from L2. dbias: the threads that split g each own one output
// channel and sum it in fp32; a fixed-order reduce at the end of the run.
// The 1x1 projection (one tap) spreads a tile's k-steps over the nine warps
// instead, and adds their sums in a fixed order at the end.
// Measured at the res-128 tail on an H100 (kernels/attention_sources.py
// --kernel k2bwd): wgrad 0.58-0.60 ms, dgrad 0.54-0.55; by its diagnostic
// variants about 0.32 ms of wgrad's are products (59 % of mma.sync's rate:
// a warp loads 4 KB of fragments per 24 products, as the forward) and 0.17
// the split pass, and dgrad's products about 0.33.
//
// At C <= 8 (conv_in, C = 4; 3 x 3, not K3) the fp32 wgrad_narrow_kernel
// runs instead (bf16: wgrad_narrow_bf16_kernel, below), on the CUDA cores:
// its 1.2 GFLOP at the flagship shape
// take 0.018 ms there against 0.021 ms for the 67 MB of g it must read, so
// bytes bound it, and a tensor-core block would compute 32 channel rows
// for 4 at the same per-tile cost of staging, barriers and copies (0.19 ms
// with 16-row blocks; the taps folded into M, 36 of 48 rows, 0.22; this
// kernel 0.09). Its partials go to the same scratch and reduce.
//
// mc_conv_wgrad_runs picks the runs per image to fill about two blocks an
// SM in one wave; the scratch is then (B * runs) x 9 C O floats (9.4 MB at
// the flagship's res-128 tail).
//
// bf16 (mc_conv_dgrad_bf16, mc_conv_wgrad_bf16, mc_gn_dx_bf16; the fp32
// kernels above are not shared with them). They replace _gnsc_bwd_kernel_a
// and _up_pair_bwd_kernel on a bf16 network, and round where those round:
//   - the activation is recomputed in fp32 and rounded to bf16 before its
//     products (here in the folded form x * (gamma rstd) + (beta - gamma
//     rstd mean), SiLU by __expf and a fast division: fp32 before the one
//     rounding, so a value may differ from the plain version's by one bf16
//     ulp, within the tolerances of the bf16 outputs);
//   - dW, dbias and the conv input's cotangent ds are sums in fp32 of bf16
//     products (exact in fp32);
//   - dgrad's act mode forms da = ds * silu'(a) and the dgamma, dbeta
//     partials in fp32 and stores da rounded to bf16 (the linear mode stores
//     ds rounded); K3's ds stays fp32 through its low-res tail;
//   - dx is formed from da in fp32 and rounded once (_dx_from_da).
// Bound at the res-128 tail: 19.3 GFLOP each of bf16 products for dgrad and
// wgrad, 0.020 ms at 989 TFLOP/s; the whole backward 0.039 ms (both
// products); the dx pass moves 100 MB (x, da, dx), 0.030 ms at 3.35 TB/s.
//
// An earlier design, the fp32 kernels templated onto bf16 mma.sync.m16n8k16,
// was held by wgrad's activation pass (each 32-channel slice of act(x)
// rebuilt for each 32-output slice over a 6 x 18 halo: about 3.4
// activations an element), and dx took four fp32 PyTorch passes. The
// design for Hopper, on the layout and helpers of csrc/bf16_conv_tiles.cuh
// (gnsc_bf16_kernel's):
//   dgrad_bf16_kernel  the forward's conv applied to g: persistent blocks
//     (one an SM) each walk a run of 16 x 16 (or 8 x 16) pixel tiles of one
//     64-channel N-block; the mirrored, transposed weights resident in
//     shared memory for the whole call, copied as they lie (HWIO rows
//     (tap, c) hold the 64 o of a K chunk: K-major B, wgmma's 128-byte
//     swizzle, no repack); wgmma m64n64k16 with A (g) by per-lane ldmatrix;
//     16-byte copies and stores. The epilogue reads x (copied while the
//     products run), forms da, and keeps the (dgamma, dbeta) partials in
//     registers until the block leaves an image; K3's also folds the 2 x 2
//     block of each low-res pixel (a shuffle for the columns, the row pair
//     between two warps) and writes the low-res fp32 da, replacing the
//     PyTorch fold and tail. dgrad_reduce_kernel adds the (block, image)
//     partials in block order.
//   wgrad_bf16_kernel  persistent blocks, one an SM, each a run of tiles for
//     a (64-channel C-block, 64-output O-block) pair, so an input element is
//     activated once a tile (1.27 times at 16 x 16, halo included, for every
//     output channel at O = 64), in place on the raw tile, 16 bytes a
//     thread-item. Three warpgroups, one a row of taps (96 accumulator
//     registers a thread), run wgmma m64n64k16 over the tile's rows, 48
//     products a warpgroup between two barriers: A = act(x)^T by ldmatrix
//     .trans rows (the tap's shift moves the rows, which the registers do
//     not care about), B = the g tile as 128-byte [pixel][output] rows in
//     the swizzle (N-contiguous). Per-run partials and colsum_kernel as the
//     fp32 kernel, so dW and dbias repeat bit for bit.
//   gn_dx_kernel  the dx pass in one elementwise kernel, 16 bytes of x and dx
//     a thread-item; K2's bf16 da, K3's fp32 low-res da. It replaces no
//     Pallas kernel: XLA fuses _dx_from_da into one pass on the TPU.
//   wgrad_narrow_bf16_kernel<C>  the wgrad at C <= 8 (conv_in; 3 x 3, not
//     K3, linear: the bf16 route refuses act), the same function as the
//     Pallas kernel's linear mode: dW[tap, c, o] = sum over (b, pixel) of
//     x_pad[b, pixel + tap, c] g[b, pixel, o] and dbias[o] = sum g, fp32
//     sums of exact bf16 products. The earlier design, the fp32 kernel's
//     bf16 instance, ran 2,304 fp32 FMAs a pixel on the CUDA cores, issue-
//     bound (0.092 ms bf16 against 0.090 fp32 at the flagship's conv_in).
//     As a GEMM it is tiny, D (9 C + 1 rows, O) = im2col(x)^T g over K =
//     B H W pixels (1.2 GFLOP, 0.002 ms on wgmma), so the 33.5 MB of g
//     bound it (0.0106 ms). Persistent blocks, one an SM along the pixels
//     for each 64-output panel, each a contiguous run of 8 x 16 pixel tiles;
//     a ring of kNbStages stages, three roles under full / empty mbarriers
//     (csrc/tma_ring.cuh): a producer warp brings the stage's g tile by TMA
//     (a 4-D box of 64 outputs x 16 x 8 pixels, 128-byte swizzle, zero past
//     the image and past O; 4-byte cp.async pairs, or element copies where O
//     is odd, into the same layout where O % 8 != 0 or g is unaligned); an
//     im2col warpgroup builds A, one 128-byte row of 64 values a pixel
//     (rows m = tap C + c, the ones row
//     9 C for dbias, zero past it; 16-byte chunk j at j ^ (pixel & 7), the
//     swizzle wgmma reads MN-major; two panels at C = 8), from the tile's
//     10 x 18 halo of x that it copies a stage ahead by cp.async (2 C bytes
//     a position); one warpgroup multiplies: wgmma m64n64k16 with both
//     operands in shared memory, A and B MN-major (bf16t::wg_mma_ss<1, 1>),
//     the stage's eight k16 steps into a partial, then one fp32 add into its
//     accumulator. No block-wide barrier a stage. A block's (9 C + 1) x 64
//     partial goes to the (rows, 9 C O + O) scratch, which colsum_kernel adds
//     in a fixed order: dW and dbias repeat bit for bit. Measured on one H100
//     80GB HBM3 at 700 W (attention_sources --kernel wgradnarrowbf16, card
//     clock, the earlier source in the call), with its reduce, C 4 / C 2 ->
//     64 at B 16, res 128: 0.0225-0.0226 / 0.0215-0.0217 ms against
//     0.0912-0.0914 / 0.0862-0.0864 (bf16 convolution_backward of dW and
//     dbias alone 0.1375 / 0.1349); a ring of 2 or 6 stages 0.0222 / 0.0226
//     (0.0217 / 0.0212 at C 2). With no products 0.0228, no g copies
//     0.0229, no im2col 0.0192, no reduce 0.0195: the im2col warpgroup and
//     the reduce (3 us) hold it, not bytes or products.
// Measured on one H100 (attention_sources --kernel k2bwdbf16; PERF.md
// section 6, NVIDIA H100 80GB HBM3 at 700 W): the res-128 identity tail
// 0.216-0.221 ms in all against 0.835-0.853 for the earlier design (wgrad
// 0.089, dgrad 0.094, dx 0.040); by diagnostic
// variants wgrad's activation pass is about 0.016 ms and its products 0.019,
// dgrad's products 0.021.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_conv_tiles.cuh"
#include "tma_ring.cuh"

namespace {

// ---------------------------------------------------------------------------
// 3xTF32 on mma.sync and cp.async (as in csrc/fused_norm_conv.cu)
// ---------------------------------------------------------------------------

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

struct AFrag {
  uint32_t hi[4], lo[4];
};

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

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// two consecutive elements (pair: one aligned access; two: the second exists)
__device__ __forceinline__ void load2(const float* p, bool pair, bool two, float& a,
                                      float& b) {
  if (pair) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a = v.x;
    b = v.y;
  } else {
    a = p[0];
    b = two ? p[1] : 0.f;
  }
}

__device__ __forceinline__ void store2(float* p, bool pair, bool two, float a, float b) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (two) p[1] = b;
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ void store_split(float* dst, float v0, float v1) {
  uint32_t h0, l0, h1, l1;
  split(v0, h0, l0);
  split(v1, h1, l1);
  *reinterpret_cast<uint4*>(dst) = make_uint4(h0, h1, l0, l1);
}

__device__ __forceinline__ float sigmoid(float y) { return 1.f / (1.f + expf(-y)); }

// per-channel mean and rstd of sample b from the (B, C) sums, as the forward
// folds them (variance E[x^2] - mean^2, clamped at 0)
__device__ __forceinline__ void mean_rstd(const float* sums, const float* sumsq,
                                          int b, int C, int ch, int groups,
                                          float cnt, float eps, float* mean,
                                          float* rstd) {
  const int per = C / groups;
  const int g0 = (ch / per) * per;
  float s = 0.f, ss = 0.f;
  for (int k = 0; k < per; ++k) {
    s += sums[b * C + g0 + k];
    ss += sumsq[b * C + g0 + k];
  }
  *mean = s / cnt;
  *rstd = rsqrtf(fmaxf(ss / cnt - *mean * *mean, 0.f) + eps);
}

bool aligned(const void* ptr, int bytes) {
  return ((uintptr_t)ptr & (uintptr_t)(bytes - 1)) == 0;
}



// out[s, k] = sum over i < n of part[s, i, k] for every slice s: each of
// kSumGroups threads of a column adds every kSumGroups-th row in order, then
// the groups' sums are added in order. A fixed order: no atomics. (As in
// csrc/narrow_conv.cu.)
constexpr int kSumGroups = 16;

__global__ void __launch_bounds__(32 * kSumGroups)
colsum_kernel(const float* __restrict__ part, float* __restrict__ out, int n, int K) {
  __shared__ float red[kSumGroups][33];
  const int kl = threadIdx.x % 32, grp = threadIdx.x / 32;
  const int k = blockIdx.x * 32 + kl;
  float acc = 0.f;
  if (k < K) {
    const float* p = part + (size_t)blockIdx.y * n * K + k;
#pragma unroll 4
    for (int i = grp; i < n; i += kSumGroups) acc += p[(size_t)i * K];
  }
  red[grp][kl] = acc;
  __syncthreads();
  if (grp == 0 && k < K) {
    float t = red[0][kl];
#pragma unroll
    for (int q = 1; q < kSumGroups; ++q) t += red[q][kl];
    out[(size_t)blockIdx.y * K + k] = t;
  }
}

// ---------------------------------------------------------------------------
// dgrad: the forward's implicit GEMM on the cotangent
// ---------------------------------------------------------------------------

constexpr int kTH = 8;           // pixel rows per block
constexpr int kTW = 16;          // pixel columns per block: one m16 tile a row
constexpr int kBC = 64;          // forward input channels (the GEMM's N) per block
constexpr int kCK = 8;           // cotangent channels per chunk: one k-step
constexpr int kWarps = 8;        // 4 row pairs x 2 channel halves
constexpr int kThreads = 32 * kWarps;
constexpr int kIH = kTH + 2;
constexpr int kIW = kTW + 2;
constexpr int kPos = kIH * kIW;  // halo'd tile positions
constexpr int kXS = 12;          // raw cotangent floats a position (8 used)
constexpr int kTempSteps = 9;    // k-steps summed on the tensor cores per fp32 add

// shared memory, in floats
constexpr int kRawG = kPos * kXS;         // one raw cotangent stage
constexpr int kRawW = 9 * kBC * kCK;      // one raw weight stage
constexpr int kSplitA = kPos * 16;        // the split cotangent plane
constexpr int kSplitB = 9 * 8 * 32 * 4;   // the split weight plane
constexpr int kDSmemFloats = 2 * (kRawG + kRawW) + kSplitA + kSplitB + 4 * kBC;
constexpr size_t kDSmemBytes = sizeof(float) * kDSmemFloats;

// pixel tiles per image of the dgrad kernel (h, w the cotangent's)
int dgrad_tiles(int h, int wd) { return ((h + kTH - 1) / kTH) * ((wd + kTW - 1) / kTW); }

enum DgradMode { kLinear = 0, kAct = 1, kUpFold = 2 };

struct DgradArgs {
  const void* g;       // (B, H, W, O) cotangent of the conv output
  const void* w;       // (3, 3, C, O) forward weight
  const void* x;       // (B, H, W, C) forward input (kAct); g, w, x of type T
  const float* gamma;  // (B, C) folded scale and shift (kAct)
  const float* beta;
  const float* sums;   // (B, C) the forward's channel sums of x (kAct)
  const float* sumsq;
  void* out;           // da (B, H, W, C) of type T; kUpFold: fp32 (B, H, W / 2, C)
  float* part;         // kAct: (2, B, tiles, C) per-block dgamma, dbeta
  int H, W, C, O, groups;
  float eps;
  int gvec, wvec, pair;  // 16-byte copies of g / w; 8-byte loads and stores
};

// Cotangent channels o0 .. o0 + 7 into one raw stage: the halo'd tile of g
// (zero outside the image and past O; no bytes are read there) and the
// weights of the nine transposed taps, row (tap, cc) = w[8 - tap][c0 + cc]
// [o0 .. o0 + 7] with its 16-byte halves swapped when bit 2 of cc is set.
__device__ __forceinline__ void dg_load_chunk(const DgradArgs& p, int q, float* rg,
                                              float* rw, int b, int ty0, int tx0,
                                              int c0, int tid) {
  const int o0 = q * kCK, O = p.O, C = p.C;
  const float* gb = static_cast<const float*>(p.g) + (size_t)b * p.H * p.W * O;
  const float* w = static_cast<const float*>(p.w);
  if (p.gvec) {
    for (int idx = tid; idx < kPos * 2; idx += kThreads) {
      const int h = idx & 1, pos = idx >> 1;
      const int y = ty0 - 1 + pos / kIW, x = tx0 - 1 + pos % kIW, o = o0 + 4 * h;
      const bool valid = y >= 0 && y < p.H && x >= 0 && x < p.W && o < O;
      cp_async16(rg + pos * kXS + 4 * h,
                 valid ? gb + ((size_t)y * p.W + x) * O + o : gb, valid);
    }
  } else {
    for (int idx = tid; idx < kPos * kCK; idx += kThreads) {
      const int k = idx % kCK, pos = idx / kCK;
      const int y = ty0 - 1 + pos / kIW, x = tx0 - 1 + pos % kIW, o = o0 + k;
      const bool valid = y >= 0 && y < p.H && x >= 0 && x < p.W && o < O;
      cp_async4(rg + pos * kXS + k,
                valid ? gb + ((size_t)y * p.W + x) * O + o : gb, valid);
    }
  }
  if (p.wvec) {
    for (int idx = tid; idx < 9 * kBC * 2; idx += kThreads) {
      const int h = idx & 1, row = idx >> 1;  // row = tap * kBC + cc
      const int tap = row / kBC, cc = row % kBC, c = c0 + cc, o = o0 + 4 * h;
      const bool valid = c < C && o < O;
      cp_async16(rw + row * kCK + 4 * (h ^ ((cc >> 2) & 1)),
                 valid ? w + ((size_t)(8 - tap) * C + c) * O + o : w, valid);
    }
  } else {
    for (int idx = tid; idx < 9 * kBC * kCK; idx += kThreads) {
      const int k = idx % kCK, row = idx / kCK;
      const int tap = row / kBC, cc = row % kBC, c = c0 + cc, o = o0 + k;
      const bool valid = c < C && o < O;
      cp_async4(rw + row * kCK + (k ^ (cc & 4)),
                valid ? w + ((size_t)(8 - tap) * C + c) * O + o : w, valid);
    }
  }
}

// The cotangent plane: position pos holds, at 4t for thread t of a quad,
// (hi o_t, hi o_t+4, lo o_t, lo o_t+4) (the A fragment's two k columns).
__device__ __forceinline__ void dg_split_g(const float* rg, float* sa, int tid) {
  for (int idx = tid; idx < kPos * 4; idx += kThreads) {
    const int t = idx & 3, pos = idx >> 2;
    store_split(sa + pos * 16 + 4 * t, rg[pos * kXS + t], rg[pos * kXS + t + 4]);
  }
}


// The weight plane in B-fragment order: (tap, n-tile, lane) holds (hi, lo) of
// b0 = W'[k = t][n = g] and b1 = W'[k = t + 4][n = g], W'[k][n] = the raw row
// (tap, n)'s entry k (its halves swapped back).
__device__ __forceinline__ void dg_split_w(const float* rw, float* sb, int tid) {
  for (int idx = tid; idx < 9 * 8 * 32; idx += kThreads) {
    const int lane = idx & 31, nt = (idx >> 5) & 7, tap = idx >> 8;
    const int g = lane >> 2, t = lane & 3;
    const int cc = 8 * nt + g, sw = cc & 4;
    const float* r = rw + (tap * kBC + cc) * kCK;
    store_split(sb + 4 * idx, r[t ^ sw], r[(t + 4) ^ sw]);
  }
}


// One chunk's nine taps on the warp's two m-tiles x four n-tiles:
// kTempSteps taps into a zeroed fragment, then one fp32 add into acc (the
// forward's mma_chunk<9>).
__device__ __forceinline__ void dg_mma_chunk(const float* sa, const float* sb,
                                             float (&acc)[2][4][4], int rg, int cq,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s0 = 0; s0 < 9; s0 += kTempSteps) {
    float part[2][4][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[m][j][e] = 0.f;
    // rolled: unrolled, ptxas hoists later taps' fragments and spills more
#pragma unroll 1
    for (int s = s0; s < s0 + kTempSteps && s < 9; ++s) {
      const int dy = s / 3, dx = s % 3;
      AFrag a[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* pa = sa + ((2 * rg + m + dy) * kIW + g + dx) * 16 + 4 * t;
        const float4 p0 = *reinterpret_cast<const float4*>(pa);           // pixel g
        const float4 p8 = *reinterpret_cast<const float4*>(pa + 8 * 16);  // pixel g + 8
        a[m].hi[0] = __float_as_uint(p0.x);
        a[m].hi[1] = __float_as_uint(p8.x);
        a[m].hi[2] = __float_as_uint(p0.y);
        a[m].hi[3] = __float_as_uint(p8.y);
        a[m].lo[0] = __float_as_uint(p0.z);
        a[m].lo[1] = __float_as_uint(p8.z);
        a[m].lo[2] = __float_as_uint(p0.w);
        a[m].lo[3] = __float_as_uint(p8.w);
      }
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 f = *reinterpret_cast<const float4*>(
            sb + ((s * 8 + 4 * cq + j) * 32 + lane) * 4);
        bh[j][0] = __float_as_uint(f.x);
        bh[j][1] = __float_as_uint(f.y);
        bl[j][0] = __float_as_uint(f.z);
        bl[j][1] = __float_as_uint(f.w);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_tf32(part[m][j], a[m].lo, bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_tf32(part[m][j], a[m].hi, bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_tf32(part[m][j], a[m].hi, bh[j][0], bh[j][1]);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] += part[m][j][e];
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 2) dgrad_kernel(const DgradArgs p) {
  extern __shared__ __align__(16) float smem[];
  // [2][kRawG] raw cotangent stages, [2][kRawW] raw weight stages
  float* rg = smem;
  float* rw = rg + 2 * kRawG;

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int tiles_w = (p.W + kTW - 1) / kTW;
  const int ty0 = (blockIdx.x / tiles_w) * kTH;
  const int tx0 = (blockIdx.x % tiles_w) * kTW;
  const int c0 = blockIdx.z * kBC;
  const int C = p.C;
  const int nq = (p.O + kCK - 1) / kCK;

  dg_load_chunk(p, 0, rg, rw, b, ty0, tx0, c0, tid);
  cp_commit();
  float* sa = smem + 2 * (kRawG + kRawW);  // the split cotangent plane
  float* sb = sa + kSplitA;                // the split weight plane
  float* s_mean = sb + kSplitB;            // [kBC] each: mean, rstd, gamma, beta (kAct)
  float* s_rstd = s_mean + kBC;
  float* s_gam = s_rstd + kBC;
  float* s_bet = s_gam + kBC;

  if (kMode == kAct && tid < kBC && c0 + tid < C) {
    const int ch = c0 + tid;
    const float cnt = (float)p.H * (float)p.W * (float)(C / p.groups);
    mean_rstd(p.sums, p.sumsq, b, C, ch, p.groups, cnt, p.eps, &s_mean[tid],
              &s_rstd[tid]);
    s_gam[tid] = p.gamma[b * C + ch];
    s_bet[tid] = p.beta[b * C + ch];
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int rg_ = warp & 3, cq = warp >> 2;  // row pair, channel half
  float acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  for (int q = 0; q < nq; ++q) {
    const int st = q & 1;
    if (q + 1 < nq)
      dg_load_chunk(p, q + 1, rg + (st ^ 1) * kRawG, rw + (st ^ 1) * kRawW, b, ty0,
                    tx0, c0, tid);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // chunk q has landed; every warp is done with q - 1's planes
    dg_split_g(rg + st * kRawG, sa, tid);
    dg_split_w(rw + st * kRawW, sb, tid);
    __syncthreads();
    dg_mma_chunk(sa, sb, acc, rg_, cq, lane);
  }
  cp_wait<0>();

  // C fragment (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) = pixels
  // tx0 + g (+ 8) of row 2 rg + m, channels 32 cq + 8 j + 2t (+ 1)
  const int g = lane >> 2, t = lane & 3;
  if (kMode == kUpFold) {
    // column x + 1 of pixel x lies 4 lanes on; even g store the pair sum
    // (tx0 is even, and so is W)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int y = ty0 + 2 * rg_ + m;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int k = 0; k < 2; ++k)
            v[j][k] = acc[m][j][2 * h + k] +
                      __shfl_down_sync(0xffffffffu, acc[m][j][2 * h + k], 4);
        const int x = tx0 + g + 8 * h;
        if ((g & 1) || y >= p.H || x >= p.W) continue;
        const size_t pix = ((size_t)b * p.H + y) * (p.W / 2) + x / 2;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + 32 * cq + 8 * j + 2 * t;
          if (c >= C) continue;
          store2(static_cast<float*>(p.out) + pix * C + c, p.pair, c + 1 < C, v[j][0],
                 v[j][1]);
        }
      }
    }
    return;
  }

  float pdg[4][2], pdb[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) pdg[j][0] = pdg[j][1] = pdb[j][0] = pdb[j][1] = 0.f;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int y = ty0 + 2 * rg_ + m;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = tx0 + g + 8 * h;
      if (y >= p.H || x >= p.W) continue;
      const size_t pix = ((size_t)b * p.H + y) * p.W + x;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = 32 * cq + 8 * j + 2 * t, c = c0 + cl;
        if (c >= C) continue;
        const bool two = c + 1 < C;
        float v0 = acc[m][j][2 * h], v1 = acc[m][j][2 * h + 1];
        if (kMode == kAct) {
          float x0, x1;
          load2(static_cast<const float*>(p.x) + pix * C + c, p.pair, two, x0, x1);
          const float xh0 = (x0 - s_mean[cl]) * s_rstd[cl];
          const float a0 = xh0 * s_gam[cl] + s_bet[cl];
          const float sg0 = sigmoid(a0);
          v0 *= sg0 * (1.f + a0 * (1.f - sg0));
          pdg[j][0] += v0 * xh0;
          pdb[j][0] += v0;
          if (two) {
            const float xh1 = (x1 - s_mean[cl + 1]) * s_rstd[cl + 1];
            const float a1 = xh1 * s_gam[cl + 1] + s_bet[cl + 1];
            const float sg1 = sigmoid(a1);
            v1 *= sg1 * (1.f + a1 * (1.f - sg1));
            pdg[j][1] += v1 * xh1;
            pdb[j][1] += v1;
          }
        }
        store2(static_cast<float*>(p.out) + pix * C + c, p.pair, two, v0, v1);
      }
    }
  }

  if (kMode == kAct) {
    // the warp's 32 pixels: sum over g (lane bits 2-4), then the four row
    // pairs in a fixed order; one partial per block and channel
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int sh = 4; sh < 32; sh <<= 1) {
          pdg[j][k] += __shfl_xor_sync(0xffffffffu, pdg[j][k], sh);
          pdb[j][k] += __shfl_xor_sync(0xffffffffu, pdb[j][k], sh);
        }
    __syncthreads();  // every warp is done reading the planes: reuse them
    float* red_g = sa;
    float* red_b = sa + 4 * kBC;
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          red_g[rg_ * kBC + 32 * cq + 8 * j + 2 * t + k] = pdg[j][k];
          red_b[rg_ * kBC + 32 * cq + 8 * j + 2 * t + k] = pdb[j][k];
        }
    }
    __syncthreads();
    if (tid < kBC && c0 + tid < C) {
      float sg = 0.f, sbt = 0.f;
      for (int r = 0; r < 4; ++r) {
        sg += red_g[r * kBC + tid];
        sbt += red_b[r * kBC + tid];
      }
      const size_t tiles = gridDim.x, row = (size_t)b * tiles + blockIdx.x;
      p.part[row * C + c0 + tid] = sg;
      p.part[((size_t)gridDim.y * tiles + row) * C + c0 + tid] = sbt;
    }
  }
}

// ---------------------------------------------------------------------------
// wgrad: M = input channels, N = output channels, K = pixels
// ---------------------------------------------------------------------------

constexpr int kWTH = 4;                        // pixel tile rows
constexpr int kWTW = 16;                       // and columns: a k-step is half a row
constexpr int kWIH = kWTH + 2, kWIW = kWTW + 2;
constexpr int kWPos = kWIH * kWIW;             // halo'd tile positions
constexpr int kWPix = kWTH * kWTW;
constexpr int kWSteps = kWPix / 8;             // k-steps a tile
constexpr int kWLH = kWTH / 2 + 2, kWLW = kWTW / 2 + 2;  // K3's low-res tile
constexpr int kWC = 32, kWO = 32;              // input / output channels a block
constexpr int kWWarps = 9;                     // one a tap
constexpr int kWThreads = 32 * kWWarps;
constexpr int kWRS = kWC + 8;                  // raw floats a position or pixel
constexpr int kWTempSteps = 8;                 // k-steps on the tensor cores per fp32 add

// shared memory, in floats
constexpr int kWRawX = kWPos * kWRS;           // raw x (or K3's low-res x), one stage
constexpr int kWRawG = kWPix * kWRS;           // raw g, one stage
constexpr int kWPlaneA = 2 * kWPos * 32;       // split act(x): [m-tile][position][8 x 4]
constexpr int kWPlaneB = kWSteps * 4 * 32 * 4; // split g: [k-step][n-tile][lane][4]
constexpr int kWAcc = kWWarps * 32 * 32;       // fp32 sums: [warp][8][lane][4]
constexpr int kWSmemFloats = kWRawX + kWRawG + kWPlaneA + kWPlaneB + kWAcc + 2 * kWC;
constexpr size_t kWSmemBytes = sizeof(float) * kWSmemFloats;
static_assert(kWSteps % kWTempSteps == 0, "partials tile a tile");
static_assert(kWPix / kWTW * 2 == kWSteps, "a k-step is half a tile row");

struct WgradArgs {
  const void* x;       // (B, Hin, Win, C) conv input before the activation
  const void* g;       // (B, H, W, O) cotangent of the conv output (x, g fp32 or bf16)
  const float* gamma;  // (B, C) folded scale and shift, unused when act == 0
  const float* beta;
  const float* sums;   // (B, C) the forward's channel sums of x
  const float* sumsq;
  float* part;         // (B * runs, taps * C * O [+ O]): per-run dW [, dbias]
  int H, W, C, O, groups;
  float eps;
  int act, taps, runs, bias, xvec, gvec, pair;
};

// The raw x and g tiles of tile (ty0, tx0) into the stage: x at the halo'd
// positions (K3: the low-res tile under them; one tap: the tile's own
// pixels only), channels c0 .. c0 + 31, and g at the tile's pixels,
// channels o0 .. o0 + 31; zero outside the image, past C and past O.
template <bool kUp>
__device__ __forceinline__ void wg_load_tile(const WgradArgs& p, float* rx, float* rgt,
                                             int b, int ty0, int tx0, int c0, int o0,
                                             int tid) {
  const int C = p.C, O = p.O;
  const int hin = kUp ? p.H / 2 : p.H, win = kUp ? p.W / 2 : p.W;
  const int cols = kUp ? kWLW : kWIW, npos = kUp ? kWLH * kWLW : kWPos;
  const int y0 = kUp ? ty0 / 2 - 1 : ty0 - 1, x0 = kUp ? tx0 / 2 - 1 : tx0 - 1;
  const bool one = p.taps == 1;
  const float* px_ = static_cast<const float*>(p.x);
  const float* xb = px_ + (size_t)b * hin * win * C;
  if (p.xvec) {
    for (int idx = tid; idx < npos * (kWC / 4); idx += kWThreads) {
      const int h = idx % (kWC / 4), pos = idx / (kWC / 4);
      const int iy = pos / cols, ix = pos % cols;
      const int y = y0 + iy, x = x0 + ix, c = c0 + 4 * h;
      const bool halo = one && (iy == 0 || iy == kWIH - 1 || ix == 0 || ix == kWIW - 1);
      const bool valid = !halo && y >= 0 && y < hin && x >= 0 && x < win && c < C;
      cp_async16(rx + pos * kWRS + 4 * h,
                 valid ? xb + ((size_t)y * win + x) * C + c : px_, valid);
    }
  } else {
    for (int idx = tid; idx < npos * kWC; idx += kWThreads) {
      const int k = idx % kWC, pos = idx / kWC;
      const int iy = pos / cols, ix = pos % cols;
      const int y = y0 + iy, x = x0 + ix, c = c0 + k;
      const bool halo = one && (iy == 0 || iy == kWIH - 1 || ix == 0 || ix == kWIW - 1);
      const bool valid = !halo && y >= 0 && y < hin && x >= 0 && x < win && c < C;
      cp_async4(rx + pos * kWRS + k,
                valid ? xb + ((size_t)y * win + x) * C + c : px_, valid);
    }
  }
  const float* gb = static_cast<const float*>(p.g) + (size_t)b * p.H * p.W * O;
  if (p.gvec) {
    for (int idx = tid; idx < kWPix * (kWO / 4); idx += kWThreads) {
      const int h = idx % (kWO / 4), px = idx / (kWO / 4);
      const int y = ty0 + px / kWTW, x = tx0 + px % kWTW, o = o0 + 4 * h;
      const bool valid = y < p.H && x < p.W && o < O;
      cp_async16(rgt + px * kWRS + 4 * h,
                 valid ? gb + ((size_t)y * p.W + x) * O + o : gb, valid);
    }
  } else {
    for (int idx = tid; idx < kWPix * kWO; idx += kWThreads) {
      const int k = idx % kWO, px = idx / kWO;
      const int y = ty0 + px / kWTW, x = tx0 + px % kWTW, o = o0 + k;
      const bool valid = y < p.H && x < p.W && o < O;
      cp_async4(rgt + px * kWRS + k,
                valid ? gb + ((size_t)y * p.W + x) * O + o : gb, valid);
    }
  }
}

// The split pass of one tile. act(x) at every halo'd position (zero outside
// the image, after the activation, and past C) into plane A: (m-tile mt,
// position P) holds at group slot g ^ 2 (P & 3) the values (hi, hi, lo, lo)
// of channels 16 mt + g and 16 mt + g + 8. g into plane B in fragment order;
// the threads below 256 each keep one output channel's sum of g in gsum.
template <bool kUp>
__device__ __forceinline__ void wg_split(const WgradArgs& p, const float* rx,
                                         const float* rgt, float* pa, float* pb,
                                         const float* s_a, const float* s_b, int ty0,
                                         int tx0, int c0, int tid, float& gsum) {
  const bool one = p.taps == 1;
  for (int idx = tid; idx < kWPos * 2 * 8; idx += kWThreads) {
    const int g = idx & 7, mt = (idx >> 3) & 1, pos = idx >> 4;
    const int iy = pos / kWIW, ix = pos % kWIW;
    if (one && (iy == 0 || iy == kWIH - 1 || ix == 0 || ix == kWIW - 1)) continue;
    const int y = ty0 - 1 + iy, x = tx0 - 1 + ix;
    float v0 = 0.f, v1 = 0.f;  // SAME zero padding of the ACTIVATED tensor
    if (y >= 0 && y < p.H && x >= 0 && x < p.W) {
      const int rpos = kUp ? ((y >> 1) - (ty0 / 2 - 1)) * kWLW + (x >> 1) - (tx0 / 2 - 1)
                           : pos;
      const int cl = 16 * mt + g;
      v0 = rx[rpos * kWRS + cl];
      v1 = rx[rpos * kWRS + cl + 8];
      if (p.act) {
        const float t0 = v0 * s_a[cl] + s_b[cl], t1 = v1 * s_a[cl + 8] + s_b[cl + 8];
        v0 = c0 + cl < p.C ? t0 * sigmoid(t0) : 0.f;
        v1 = c0 + cl + 8 < p.C ? t1 * sigmoid(t1) : 0.f;
      }
    }
    store_split(pa + (mt * kWPos + pos) * 32 + 4 * (g ^ ((pos & 3) << 1)), v0, v1);
  }
  if (tid < 256) {
    // entries (k-step, n-tile, lane) = tid + 256 i: each thread keeps one
    // n-tile and lane, so one output channel
    const int j = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < kWSteps / 2; ++i) {
      const int s = (tid >> 7) + 2 * i;
      const float v0 = rgt[(8 * s + t) * kWRS + 8 * j + g];
      const float v1 = rgt[(8 * s + t + 4) * kWRS + 8 * j + g];
      gsum += v0 + v1;
      store_split(pb + ((s * 4 + j) * 32 + lane) * 4, v0, v1);
    }
  }
}

// One k-step of one tap on the warp's 2 m-tiles x 4 n-tiles into part: the
// three products, each over the tiles in turn.
__device__ __forceinline__ void wg_mma_step(const float* pa, const float* pb,
                                            float (&part)[2][4][4], int s, int dy,
                                            int dx, int lane) {
  const int g = lane >> 2, t = lane & 3;
  // pixels t and t + 4 of the k-step: row s / 2, columns 8 (s & 1) + t (+ 4)
  const int p0 = ((s >> 1) + dy) * kWIW + 8 * (s & 1) + t + dx, p4 = p0 + 4;
  const int sw = 4 * (g ^ ((p0 & 3) << 1));  // p4 & 3 == p0 & 3
  AFrag a[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float4 f0 = *reinterpret_cast<const float4*>(pa + (m * kWPos + p0) * 32 + sw);
    const float4 f4 = *reinterpret_cast<const float4*>(pa + (m * kWPos + p4) * 32 + sw);
    a[m].hi[0] = __float_as_uint(f0.x);  // (c_g, pixel t)
    a[m].hi[1] = __float_as_uint(f0.y);  // (c_g+8, pixel t)
    a[m].hi[2] = __float_as_uint(f4.x);  // (c_g, pixel t + 4)
    a[m].hi[3] = __float_as_uint(f4.y);  // (c_g+8, pixel t + 4)
    a[m].lo[0] = __float_as_uint(f0.z);
    a[m].lo[1] = __float_as_uint(f0.w);
    a[m].lo[2] = __float_as_uint(f4.z);
    a[m].lo[3] = __float_as_uint(f4.w);
  }
  uint32_t bh[4][2], bl[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 f = *reinterpret_cast<const float4*>(pb + ((s * 4 + j) * 32 + lane) * 4);
    bh[j][0] = __float_as_uint(f.x);
    bh[j][1] = __float_as_uint(f.y);
    bl[j][0] = __float_as_uint(f.z);
    bl[j][1] = __float_as_uint(f.w);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int m = 0; m < 2; ++m) mma_tf32(part[m][j], a[m].lo, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int m = 0; m < 2; ++m) mma_tf32(part[m][j], a[m].hi, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int m = 0; m < 2; ++m) mma_tf32(part[m][j], a[m].hi, bh[j][0], bh[j][1]);
}

// sum += part in the thread's own fp32 slots ([8][lane][4] floats of its
// warp: entry 4 q + e of the flattened [m][j][e]), then part = 0
__device__ __forceinline__ void wg_flush(float* sacc, float (&part)[2][4][4], int lane) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float4* s = reinterpret_cast<float4*>(sacc + ((m * 4 + j) * 32 + lane) * 4);
      float4 v = *s;
      v.x += part[m][j][0];
      v.y += part[m][j][1];
      v.z += part[m][j][2];
      v.w += part[m][j][3];
      *s = v;
#pragma unroll
      for (int e = 0; e < 4; ++e) part[m][j][e] = 0.f;
    }
}

// The run's partial dW from the warps' fp32 sums in sacc ([warp][8][lane][4]
// floats, entry 4 q + e of the flattened [m][j][e]), and dbias from the sums
// of g: the threads below 256 each hold one output channel's in gsum (two
// threads 128 apart a channel, each over its lanes t = 0..3). red: kWO * 2
// free floats.
__device__ __forceinline__ void wg_store(const WgradArgs& p, float* sacc, float* red, int b,
                                         int run, int c0, int o0, int tid, float gsum) {
  const int C = p.C, O = p.O, warp = tid >> 5, lane = tid & 31;
  const bool one = p.taps == 1;
  float* my_acc = sacc + warp * 32 * 32;
  // the run's partial dW: entry (m, j, e) of a lane is channel c0 + 16 m + g
  // (+ 8 for e >= 2) and output o0 + 8 j + 2t (+ 1 for odd e)
  float* out = p.part + (size_t)(b * p.runs + run) *
                            ((size_t)p.taps * C * O + (p.bias ? O : 0));
  if (one) {
    // the nine warps' sums of the same outputs, added in warp order
    __syncthreads();
    if (tid < 2 * 4 * 32) {
      float4 v = *reinterpret_cast<const float4*>(sacc + tid * 4);
      for (int w = 1; w < kWWarps; ++w) {
        const float4 u = *reinterpret_cast<const float4*>(sacc + w * 1024 + tid * 4);
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      *reinterpret_cast<float4*>(sacc + tid * 4) = v;
    }
    __syncthreads();
  }
  if (!one || warp == 0) {
    const int g = lane >> 2, t = lane & 3;
    const int tap = one ? 0 : warp;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(my_acc + ((m * 4 + j) * 32 + lane) * 4);
        const int o = o0 + 8 * j + 2 * t;
        if (o >= O) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + 16 * m + g + 8 * h;
          if (c >= C) continue;
          float* dst = out + ((size_t)tap * C + c) * O + o;
          const float v0 = h ? v.z : v.x, v1 = h ? v.w : v.y;
          if (p.pair) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            dst[0] = v0;
            if (o + 1 < O) dst[1] = v1;
          }
        }
      }
  }
  if (p.bias && c0 == 0) {
    // the sums of one output channel are held by the lanes t = 0..3 of two
    // threads 128 apart; add them in a fixed order
    gsum += __shfl_xor_sync(0xffffffffu, gsum, 1);
    gsum += __shfl_xor_sync(0xffffffffu, gsum, 2);
    __syncthreads();
    if (tid < 256 && (tid & 3) == 0)
      red[(tid >> 7) * 32 + ((tid >> 5) & 3) * 8 + ((tid & 31) >> 2)] = gsum;
    __syncthreads();
    if (tid < kWO && o0 + tid < O) out[(size_t)p.taps * C * O + o0 + tid] = red[tid] + red[32 + tid];
  }
}

template <bool kUp>
__global__ void __launch_bounds__(kWThreads, 2) wgrad_kernel(const WgradArgs p) {
  extern __shared__ __align__(16) float smem[];
  float* rx = smem;              // raw x stage
  float* rgt = rx + kWRawX;      // raw g stage
  float* pa = rgt + kWRawG;      // split act(x)
  float* pb = pa + kWPlaneA;     // split g
  float* sacc = pb + kWPlaneB;   // fp32 sums, kWarps x 32 x 32
  float* s_a = sacc + kWAcc;     // [kWC] folded per-channel scale
  float* s_b = s_a + kWC;        // and shift

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C = p.C, O = p.O;
  const int oslices = (O + kWO - 1) / kWO, cslices = (C + kWC - 1) / kWC;
  int blk = blockIdx.x;
  const int o0 = (blk % oslices) * kWO;
  blk /= oslices;
  const int c0 = (blk % cslices) * kWC;
  blk /= cslices;
  const int run = blk % p.runs, b = blk / p.runs;
  const int tiles_w = (p.W + kWTW - 1) / kWTW;
  const int tiles = ((p.H + kWTH - 1) / kWTH) * tiles_w;
  const int per = (tiles + p.runs - 1) / p.runs;
  const int t_begin = run * per, t_end = min(tiles, t_begin + per);

  if (t_begin < t_end)
    wg_load_tile<kUp>(p, rx, rgt, b, (t_begin / tiles_w) * kWTH,
                      (t_begin % tiles_w) * kWTW, c0, o0, tid);
  cp_commit();

  if (p.act && tid < kWC) {
    // fold the statistics into one scale/shift per input channel
    float a = 0.f, sh = 0.f;
    if (c0 + tid < C) {
      const int hin = kUp ? p.H / 2 : p.H, win = kUp ? p.W / 2 : p.W;
      const float cnt = (float)hin * (float)win * (float)(C / p.groups);
      float mean, rstd;
      mean_rstd(p.sums, p.sumsq, b, C, c0 + tid, p.groups, cnt, p.eps, &mean, &rstd);
      a = p.gamma[b * C + c0 + tid] * rstd;
      sh = p.beta[b * C + c0 + tid] - a * mean;
    }
    s_a[tid] = a;
    s_b[tid] = sh;
  }
  float* my_acc = sacc + warp * 32 * 32;
  for (int i = lane * 4; i < 32 * 32; i += 32 * 4)
    *reinterpret_cast<float4*>(my_acc + i) = make_float4(0.f, 0.f, 0.f, 0.f);

  const bool one = p.taps == 1;
  const int dy = one ? 1 : warp / 3, dx = one ? 1 : warp % 3;
  float part[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[m][j][e] = 0.f;
  float gsum = 0.f;
  int kbase = 0;  // k-steps of the run before this tile

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int ty0 = (tile / tiles_w) * kWTH, tx0 = (tile % tiles_w) * kWTW;
    cp_wait<0>();
    __syncthreads();  // the tile has landed; every warp is done with the planes
    wg_split<kUp>(p, rx, rgt, pa, pb, s_a, s_b, ty0, tx0, c0, tid, gsum);
    __syncthreads();  // the planes are ready; the raw stage is free
    if (tile + 1 < t_end)
      wg_load_tile<kUp>(p, rx, rgt, b, ((tile + 1) / tiles_w) * kWTH,
                        ((tile + 1) % tiles_w) * kWTW, c0, o0, tid);
    cp_commit();
    const int nsteps = 2 * min(kWTH, p.H - ty0);  // rows past the image add nothing
    // a partial ends with its run of kWTempSteps k-steps of the tile, so it
    // is zero (not live) through the split pass
#pragma unroll 1
    for (int s0 = 0; s0 < nsteps; s0 += kWTempSteps) {
#pragma unroll 1
      for (int s = s0; s < min(s0 + kWTempSteps, nsteps); ++s) {
        if (one && (kbase + s) % kWWarps != warp) continue;  // one tap: round the warps
        wg_mma_step(pa, pb, part, s, dy, dx, lane);
      }
      wg_flush(my_acc, part, lane);
    }
    kbase += nsteps;
  }
  cp_wait<0>();

  wg_store(p, sacc, pa, b, run, c0, o0, tid, gsum);
}


// ---------------------------------------------------------------------------
// wgrad at C <= kNC (conv_in): bytes, not products, set its time
// ---------------------------------------------------------------------------

constexpr int kNC = 8;                         // the widest narrow C
constexpr int kNTH = 8;                        // pixel tile rows
constexpr int kNTW = 32;                       // and columns
constexpr int kNIH = kNTH + 2, kNIW = kNTW + 2;
constexpr int kNO = 64;                        // output channels a block
constexpr int kNGroups = kNTH / 2;             // pixel groups of two tile rows
constexpr int kNThreads = kNO * kNGroups;

// A thread owns one output channel and two rows of each tile of its run,
// with all 9 x CP weights of its channel in registers: it reads g once,
// coalesced across the warp (32 channels of one pixel), and slides a 3 x 3
// window of act(x) (CP channels a position, read from shared memory as a
// broadcast) along its rows. The four pixel groups' sums are added in a
// fixed order at the end of the run.
template <int CP, typename T>  // C rounded up to 4 or 8; T the element type
__global__ void __launch_bounds__(kNThreads) wgrad_narrow_kernel(const WgradArgs p) {
  __shared__ __align__(16) float xs[kNIH * kNIW * CP];  // act(x), the halo'd tile
  __shared__ float red[(9 * CP + 1) * kNO];             // the run's sums, then dbias
  __shared__ float s_a[kNC], s_b[kNC];
  const int tid = threadIdx.x, ol = tid % kNO, pg = tid / kNO;
  const int C = p.C, O = p.O;
  const int oblocks = (O + kNO - 1) / kNO;
  int blk = blockIdx.x;
  const int o = (blk % oblocks) * kNO + ol;
  blk /= oblocks;
  const int run = blk % p.runs, b = blk / p.runs;
  const int tiles_w = (p.W + kNTW - 1) / kNTW;
  const int tiles = ((p.H + kNTH - 1) / kNTH) * tiles_w;
  const int per = (tiles + p.runs - 1) / p.runs;
  if (p.act && tid < C) {
    const float cnt = (float)p.H * (float)p.W * (float)(C / p.groups);
    float mean, rstd;
    mean_rstd(p.sums, p.sumsq, b, C, tid, p.groups, cnt, p.eps, &mean, &rstd);
    s_a[tid] = p.gamma[b * C + tid] * rstd;
    s_b[tid] = p.beta[b * C + tid] - s_a[tid] * mean;
  }
  float acc[9][CP], gsum = 0.f;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int c = 0; c < CP; ++c) acc[t][c] = 0.f;
  const T* xb = static_cast<const T*>(p.x) + (size_t)b * p.H * p.W * C;
  const T* gb = static_cast<const T*>(p.g) + (size_t)b * p.H * p.W * O + o;
  for (int tile = run * per; tile < min(tiles, (run + 1) * per); ++tile) {
    const int ty0 = (tile / tiles_w) * kNTH, tx0 = (tile % tiles_w) * kNTW;
    __syncthreads();  // s_a / s_b are set; every thread is done with the last tile
    for (int idx = tid; idx < kNIH * kNIW * CP; idx += kNThreads) {
      const int c = idx % CP, pos = idx / CP;
      const int y = ty0 - 1 + pos / kNIW, x = tx0 - 1 + pos % kNIW;
      float v = 0.f;  // SAME zero padding of the ACTIVATED tensor
      if (y >= 0 && y < p.H && x >= 0 && x < p.W && c < C) {
        v = to_f(xb[((size_t)y * p.W + x) * C + c]);
        if (p.act) {  // fp32 only: the bf16 instance takes the linear mode
          const float t = v * s_a[c] + s_b[c];
          v = t * sigmoid(t);
        }
      }
      xs[idx] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int r = 2 * pg; r < 2 * pg + 2; ++r) {
      const int y = ty0 + r;
      if (y >= p.H) break;
      float win[3][3][CP];  // rows r .. r + 2 of the halo, columns x .. x + 2
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 1; dx < 3; ++dx)
#pragma unroll
          for (int c = 0; c < CP; ++c) win[dy][dx][c] = xs[((r + dy) * kNIW + dx - 1) * CP + c];
#pragma unroll
      for (int xx = 0; xx < kNTW; ++xx) {
        const int x = tx0 + xx;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int c = 0; c < CP; ++c) {
            win[dy][0][c] = win[dy][1][c];
            win[dy][1][c] = win[dy][2][c];
            win[dy][2][c] = xs[((r + dy) * kNIW + xx + 2) * CP + c];
          }
        const float gv = (x < p.W && o < O) ? to_f(gb[((size_t)y * p.W + x) * O]) : 0.f;
        gsum += gv;
#pragma unroll
        for (int t = 0; t < 9; ++t)
#pragma unroll
          for (int c = 0; c < CP; ++c) acc[t][c] = fmaf(win[t / 3][t % 3][c], gv, acc[t][c]);
      }
    }
  }
  // the pixel groups' sums, added in group order
  for (int q = 0; q < kNGroups; ++q) {
    __syncthreads();
    if (pg == q) {
#pragma unroll
      for (int t = 0; t < 9; ++t)
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          float* r = &red[(t * CP + c) * kNO + ol];
          *r = q ? *r + acc[t][c] : acc[t][c];
        }
      red[9 * CP * kNO + ol] = q ? red[9 * CP * kNO + ol] + gsum : gsum;
    }
  }
  __syncthreads();
  if (o < O) {
    float* out = p.part + (size_t)(b * p.runs + run) * ((size_t)9 * C * O + (p.bias ? O : 0));
    for (int k = pg; k < 9 * C; k += kNGroups) {
      const int t = k / C, c = k % C;
      out[(size_t)k * O + o] = red[(t * CP + c) * kNO + ol];
    }
    if (p.bias && pg == 0) out[(size_t)9 * C * O + o] = red[9 * CP * kNO + ol];
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// above 48 KB of dynamic shared memory a kernel must opt in, once per process
cudaError_t configure() {
  static cudaError_t err = [] {
    cudaError_t e = allow_smem(dgrad_kernel<kLinear>, kDSmemBytes);
    if (e == cudaSuccess) e = allow_smem(dgrad_kernel<kAct>, kDSmemBytes);
    if (e == cudaSuccess) e = allow_smem(dgrad_kernel<kUpFold>, kDSmemBytes);
    if (e == cudaSuccess) e = allow_smem(wgrad_kernel<false>, kWSmemBytes);
    if (e == cudaSuccess) e = allow_smem(wgrad_kernel<true>, kWSmemBytes);
    return e;
  }();
  return err;
}

// the fp32 dgrad launch (mc_conv_dgrad's arguments)
int conv_dgrad(const float* g, const float* w, const float* x, const float* gamma, const float* beta,
               const float* sums, const float* sumsq, void* out, float* dstats, float* part,
               int batch, int h, int wd, int c, int o, int groups, float eps, int mode,
               void* stream) {
  if (batch < 1 || h < 1 || wd < 1 || c < 1 || o < 1 || mode < kLinear ||
      mode > kUpFold || (mode == kUpFold && (wd % 2)) ||
      (mode == kAct && (!dstats || !part || groups < 1 || c % groups)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  // 16-byte copies: four values
  const int vec_o = 4;
  const bool pair = c % 2 == 0 && aligned(out, 8) && (mode != kAct || aligned(x, 8));
  DgradArgs p{g, w, x, gamma, beta, sums, sumsq, out, part, h, wd, c, o,
              groups, eps, o % vec_o == 0 && aligned(g, 16), o % vec_o == 0 && aligned(w, 16),
              (int)pair};
  const int tiles = dgrad_tiles(h, wd);
  dim3 grid(tiles, batch, (c + kBC - 1) / kBC);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kLinear) dgrad_kernel<kLinear><<<grid, kThreads, kDSmemBytes, s>>>(p);
  else if (mode == kAct) dgrad_kernel<kAct><<<grid, kThreads, kDSmemBytes, s>>>(p);
  else dgrad_kernel<kUpFold><<<grid, kThreads, kDSmemBytes, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || mode != kAct) return (int)err;
  colsum_kernel<<<dim3((c + 31) / 32, 2 * batch), 32 * kSumGroups, 0, s>>>(part, dstats,
                                                                         tiles, c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Pixel tiles per image of the dgrad kernel (which = 0; h, w the
// cotangent's) and of the wgrad kernel (which = 1; 2: its narrow-C form).
// The dgrad scratch is (2, batch, tiles, c).
int mc_conv_bwd_tiles(int h, int wd, int which) {
  if (which == 0) return dgrad_tiles(h, wd);
  if (which == 2) return ((h + kNTH - 1) / kNTH) * ((wd + kNTW - 1) / kNTW);
  return ((h + kWTH - 1) / kWTH) * ((wd + kWTW - 1) / kWTW);
}

bool wgrad_narrow(int c, int taps, int up) { return c <= kNC && taps == 9 && !up; }

// Pixel-tile runs per image for mc_conv_wgrad: about `blocks` blocks in all
// (one wave), at most one tile a run. The wgrad scratch is then (batch *
// runs, taps c o [+ o]) floats.
int mc_conv_wgrad_runs(int batch, int h, int wd, int c, int o, int taps, int up,
                       int blocks) {
  const bool narrow = wgrad_narrow(c, taps, up);
  const int per_run = narrow ? (o + kNO - 1) / kNO
                             : ((c + kWC - 1) / kWC) * ((o + kWO - 1) / kWO);
  const int tiles = mc_conv_bwd_tiles(h, wd, narrow ? 2 : 1);
  const int runs = blocks / (batch * per_run);
  return runs < 1 ? 1 : (runs > tiles ? tiles : runs);
}

// h, w: the cotangent's height and width (K3: the high resolution).
// mode 0: da = conv3x3^T(g) (linear); 1: da = conv3x3^T(g) * silu'(a), with
// dstats (2, batch, c) = (dgamma, dbeta) summed from the per-tile scratch
// part; 2: conv3x3^T(g) with column pairs added, out (B, h, w / 2, c).
int mc_conv_dgrad(const float* g, const float* w, const float* x,
                  const float* gamma, const float* beta, const float* sums,
                  const float* sumsq, float* out, float* dstats, float* part,
                  int batch, int h, int wd, int c, int o, int groups, float eps,
                  int mode, void* stream) {
  return conv_dgrad(g, w, x, gamma, beta, sums, sumsq, out, dstats, part, batch, h, wd, c,
                    o, groups, eps, mode, stream);
}

// h, w: the cotangent's (output's) height and width; x is (B, h, w, c), or
// (B, h / 2, w / 2, c) with up = 1. dwb: dW (taps, c, o), then dbias (o)
// when bias = 1; part: the (batch * runs, taps c o [+ o]) scratch, runs:
// pixel-tile runs per image (from mc_conv_wgrad_runs). At c <= 8 (3 x 3,
// not up) the narrow-C kernel runs, else the tensor-core one.
}  // extern "C"

// the fp32 wgrad launch (mc_conv_wgrad's arguments; the bf16 kernels are
// conv_wgrad_bf16's)
static int conv_wgrad(const float* x, const float* g, const float* gamma, const float* beta,
                      const float* sums, const float* sumsq, float* dwb, float* part, int batch,
                      int h, int wd, int c, int o, int groups, float eps, int act, int taps, int up,
                      int bias, int runs, void* stream) {
  const bool narrow_c = wgrad_narrow(c, taps, up);
  if (batch < 1 || h < 1 || wd < 1 || c < 1 || o < 1 || (taps != 9 && taps != 1) ||
      runs < 1 || runs > mc_conv_bwd_tiles(h, wd, narrow_c ? 2 : 1) ||
      (up && (h % 2 || wd % 2)) ||
      (up && taps != 9) || (act && (groups < 1 || c % groups)) || !dwb || !part)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  const size_t k = (size_t)taps * c * o + (bias ? o : 0);
  // 16-byte copies: four values
  const int vec = 4;
  WgradArgs p{x, g, gamma, beta, sums, sumsq, part, h, wd, c, o, groups, eps,
              act, taps, runs, bias, c % vec == 0 && aligned(x, 16),
              o % vec == 0 && aligned(g, 16), o % 2 == 0 && aligned(part, 8) && k % 2 == 0};
  cudaStream_t s = (cudaStream_t)stream;
  if (narrow_c) {
    dim3 grid(batch * runs * ((o + kNO - 1) / kNO));
    if (c <= 4) wgrad_narrow_kernel<4, float><<<grid, kNThreads, 0, s>>>(p);
    else wgrad_narrow_kernel<8, float><<<grid, kNThreads, 0, s>>>(p);
  } else {
    dim3 grid(batch * runs * ((c + kWC - 1) / kWC) * ((o + kWO - 1) / kWO));
    if (up) wgrad_kernel<true><<<grid, kWThreads, kWSmemBytes, s>>>(p);
    else wgrad_kernel<false><<<grid, kWThreads, kWSmemBytes, s>>>(p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  colsum_kernel<<<dim3((unsigned)((k + 31) / 32), 1), 32 * kSumGroups, 0, s>>>(
      part, dwb, batch * runs, (int)k);
  return (int)cudaGetLastError();
}

namespace {

// ---------------------------------------------------------------------------
// bf16: dgrad, wgrad and the dx pass, written for Hopper (header note)
// ---------------------------------------------------------------------------

using bf16t::bf16;

constexpr int kHW = 16;              // tile columns: one row of 16 pixels, one m16 / k16
constexpr int kHCh = bf16t::kRowCh;  // 64: channels a row, N of a product, K of a chunk
constexpr int kHCap = 232448;        // dynamic shared memory a block may take (H100)
constexpr int kHBigTileWaves = 1;    // 16-row tiles where they give this many a block
constexpr int kHWRows = 9 * kHCh;    // dgrad weight rows of one o-chunk: (tap, c)
constexpr int kHWChunk = kHWRows * bf16t::kWRowBytes;  // 73,728 bytes
constexpr int kWgWarps = 12;         // wgrad: three warpgroups, one a row of taps
constexpr int kWgThreads = 32 * kWgWarps;
constexpr int kBiasClasses = kWgThreads / 32;  // wgrad's dbias: pixel classes a tile
constexpr int kDxThreads = 256;      // the dx pass
constexpr int kDxItems = 4;          // 16-byte items a thread

// silu'(a) in fp32 with the fast exponential and division
__device__ __forceinline__ float silu_grad_fast(float a) {
  const float sg = __fdividef(1.f, 1.f + __expf(-a));
  return sg * (1.f + a * (1.f - sg));
}

__device__ __forceinline__ void bar_pair(int id) {
  asm volatile("bar.sync %0, 64;" :: "r"(id) : "memory");
}

// co-resident blocks an SM of `kernel` at `smem` bytes, asked once per
// instance (id) and KB; the dynamic shared memory cap is raised first
template <typename Kernel>
int blocks_per_sm_h(Kernel kernel, int id, int threads, int smem) {
  static int cache[16][kHCap / 1024 + 2] = {};
  static bool raised[16] = {};
  const int kb = (smem + 1023) / 1024;
  if (id < 0 || id >= 16 || kb > kHCap / 1024 + 1) return 0;
  int& n = cache[id][kb];
  if (!n) {
    if (!raised[id] && cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            kHCap) != cudaSuccess)
      return 0;
    raised[id] = true;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, kernel, threads, kb * 1024 < kHCap ? kb * 1024 : kHCap) != cudaSuccess)
      n = 0;
  }
  return n;
}

// ---- dgrad ----------------------------------------------------------------

struct DgradH {
  const bf16* g;       // (B, H, W, O) cotangent of the conv output
  const bf16* w;       // (3, 3, C, O) forward weight
  const bf16* x;       // (B, Hx, Wx, C): K2 the conv's input, K3 the low-res input
  const float* gamma;  // (B, C)
  const float* beta;
  const float* sums;   // (B, C) the forward's channel sums of x
  const float* sumsq;
  void* out;           // K2 (B, H, W, C) bf16 da or ds; K3 (B, H / 2, W / 2, C) fp32 da
  float* part;         // (2, B, grid x, C): dgamma, dbeta partials a block and image
  int B, H, W, C, O, groups;
  float eps;
  int gvec, wvec, xvec, ovec, pair;  // 16-byte copies of g / w / x, 16-byte and 8-byte stores
  // the plan (plan_dgrad_h): weights resident (else streamed a chunk a step),
  // o-chunks, tiles an image, byte offsets
  int resident, nq, tiles_y, tiles_x;
  int a_off, stage_bytes, s_off, v_off, red_off;
};

// The weight rows of o-chunk q for the N-block at c0 into W: row tap * 64 +
// cl is the transposed tap 8 - tap's row w[8 - tap][c0 + cl][64 q ..], 64
// cotangent channels (the product's K) as HWIO holds them: K-major B, copied
// as it lies into the 128-byte swizzle. Zero past C and O.
template <int kThr>
__device__ __forceinline__ void dg_load_w(const DgradH& p, unsigned char* W, int q, int c0,
                                          int tid) {
  const int o0 = q * kHCh;
  for (int idx = tid; idx < kHWRows * 8; idx += kThr) {
    const int row = idx >> 3, k = idx & 7, tap = row / kHCh, c = c0 + (row & (kHCh - 1));
    const bool ok = c < p.C;
    bf16t::copy8(W + bf16t::w_byte(row, k),
                 ok ? p.w + ((size_t)(8 - tap) * p.C + c) * p.O + o0 + 8 * k : p.w, ok,
                 o0 + 8 * k, p.O, p.wvec, p.w);
  }
}

// o-chunk q of the halo'd cotangent tile into A stage A: zero outside the
// image (the cotangent of SAME zero padding) and past O
template <int kTHt>
__device__ __forceinline__ void dg_load_a(const DgradH& p, unsigned char* A, int b, int ty0,
                                          int tx0, int q, int tid) {
  constexpr int kThr = 32 * kTHt, kCols = kHW + 2, kNPos = (kTHt + 2) * kCols;
  const int o0 = q * kHCh;
  const bf16* gb = p.g + (size_t)b * p.H * p.W * p.O;
  for (int idx = tid; idx < kNPos * 8; idx += kThr) {
    const int pos = idx >> 3, k = idx & 7;
    const int y = ty0 - 1 + pos / kCols, x = tx0 - 1 + pos % kCols, o = o0 + 8 * k;
    const bool in = y >= 0 && y < p.H && x >= 0 && x < p.W;
    bf16t::copy8(A + bf16t::a_byte(pos, k), in ? gb + ((size_t)y * p.W + x) * p.O + o : p.g,
                 in, o, p.O, p.gvec, p.g);
  }
}

// The epilogue's x: K2 tile row y's 16 pixels, K3 the low-res row y / 2
// under a warp pair's rows (8 pixels), channels c0 .. c0 + 63, into the
// warp's staging rows S; zero outside the image and past C
template <bool kUp>
__device__ __forceinline__ void dg_load_x_row(const DgradH& p, unsigned char* S, int b, int y,
                                              int tx0, int c0, int lane) {
  const int hx = kUp ? p.H / 2 : p.H, wx = kUp ? p.W / 2 : p.W;
  const int yx = kUp ? y >> 1 : y, x0 = kUp ? tx0 / 2 : tx0, npix = kUp ? kHW / 2 : kHW;
  for (int idx = lane; idx < npix * 8; idx += 32) {
    const int px = idx >> 3, k = idx & 7, x = x0 + px, c = c0 + 8 * k;
    const bool in = yx < hx && x < wx;
    bf16t::copy8(S + bf16t::a_byte(px, k),
                 in ? p.x + (((size_t)b * hx + yx) * wx + x) * p.C + c : p.x, in, c, p.C,
                 p.xvec, p.x);
  }
}

// mean, rstd, gamma, beta of image b's channels c0 .. c0 + 63 into v[4][64]
__device__ __forceinline__ void dg_stats(const DgradH& p, float* v, int b, int c0, int tid,
                                         bool up) {
  if (tid >= kHCh) return;
  const int ch = c0 + tid;
  float mean = 0.f, rstd = 0.f, gm = 0.f, bt = 0.f;
  if (ch < p.C) {
    const float cnt = (float)(up ? p.H / 2 : p.H) * (float)(up ? p.W / 2 : p.W) *
                      (float)(p.C / p.groups);
    mean_rstd(p.sums, p.sumsq, b, p.C, ch, p.groups, cnt, p.eps, &mean, &rstd);
    gm = p.gamma[b * p.C + ch];
    bt = p.beta[b * p.C + ch];
  }
  v[tid] = mean;
  v[kHCh + tid] = rstd;
  v[2 * kHCh + tid] = gm;
  v[3 * kHCh + tid] = bt;
}

// One o-chunk's products of the warpgroup's 64 pixels (four tile rows, one
// a warp) x 64 input channels: 9 taps x 4 k16 steps of wgmma m64n64k16, A
// (16 pixels x 16 cotangent channels a warp) by ldmatrix from the A stage,
// double buffered as the forward's mma_chunk_bf16; B the transposed taps'
// K-major weight rows through a descriptor, a k16 step 32 bytes along them.
__device__ __forceinline__ void dg_mma_chunk_h(uint32_t A, uint32_t W, float (&acc)[32],
                                               int r, int lane) {
  const int ri = lane & 7, mi = lane >> 3;
  const int px = ri + 8 * (mi & 1);    // the lane's A row: pixel of the tile row
  const uint32_t ak = (mi >> 1) << 4;  // and its 8-channel half of a k16 step
  auto row_of = [&](int tap) -> uint32_t {
    return A + ((r + tap / 3) * (kHW + 2) + px + tap % 3) * bf16t::kARowBytes + ak;
  };
  uint32_t a[2][4];
  uint32_t row = row_of(0);
  bf16t::ldsm_x4(row, a[0]);
#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const uint32_t next = tap + 1 < 9 ? row_of(tap + 1) : row;
    const uint64_t desc = bf16t::wg_desc_k(W + tap * kHCh * bf16t::kWRowBytes);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      bf16t::wg_fence();
      bf16t::wg_mma_kb(acc, a[kk & 1], desc + 2 * kk);  // + 32 bytes a k16 step
      bf16t::wg_commit();
      bf16t::wg_wait<1>();  // step i - 1 is done with the other buffer
      if (kk < 3)
        bf16t::ldsm_x4(row + 32 * (kk + 1), a[(kk + 1) & 1]);
      else if (tap + 1 < 9)
        bf16t::ldsm_x4(next, a[0]);
    }
    row = next;
  }
  bf16t::wg_wait<0>();
}

// Persistent blocks: blockIdx.y is the 64-channel N-block, blockIdx.x walks
// a contiguous run of the pixel tiles (image-major), each tile a step per
// o-chunk; warp w owns tile row w (16 pixels x 64 channels). A two-stage
// ring of cotangent tiles; the weights of every o-chunk resident for the
// whole call where they fit, else streamed a chunk a step (two slots).
// Epilogue, warp by warp as its products end:
//   kLinear  ds rounded to bf16 through the warp's staging rows, 16-byte stores;
//   kAct     da = ds * silu'(a), a from x (copied into the staging rows
//            while the products run) and the statistics in fp32; dgamma,
//            dbeta partials from the fp32 da; da rounded to bf16, stored so;
//   kUpFold  the column pair by one shuffle, the row pair from the odd warp
//            of each pair through its staging rows (a barrier of the two
//            warps), then the kAct epilogue at the low-res pixel, da fp32.
// The partials go out when the block leaves an image: summed over the
// warp's pixels, then over the warps in a fixed order, one row of the
// (2, B, grid x, C) scratch a block and image, which dgrad_reduce_kernel adds
// in block order.
template <int kMode, int kTHt>
__global__ void __launch_bounds__(32 * kTHt, 1) dgrad_bf16_kernel(const DgradH p) {
  constexpr int kWarps = kTHt, kThr = 32 * kWarps;
  constexpr bool kUp = kMode == kUpFold;
  extern __shared__ __align__(128) unsigned char sm_raw[];
  unsigned char* sm = bf16t::align1024(sm_raw);  // wgmma's 128-byte swizzle
  unsigned char* stage0 = sm + p.a_off;
  float* sv = reinterpret_cast<float*>(sm + p.v_off);     // [2][4][64] statistics
  float* red = reinterpret_cast<float*>(sm + p.red_off);  // [2][kWarps][64]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int c0 = blockIdx.y * kHCh;
  unsigned char* S = sm + p.s_off + warp * kHW * bf16t::kARowBytes;
  const int per_img = p.tiles_y * p.tiles_x;
  const int ntiles = p.B * per_img;
  const int t_begin = (int)((long long)blockIdx.x * ntiles / gridDim.x);
  const int t_end = (int)((long long)(blockIdx.x + 1) * ntiles / gridDim.x);
  const int steps = (t_end - t_begin) * p.nq;
  if (steps == 0) return;

  auto tile_of = [&](int tile, int& b, int& ty0, int& tx0) {
    b = tile / per_img;
    const int rem = tile - b * per_img;
    ty0 = (rem / p.tiles_x) * kTHt;
    tx0 = (rem % p.tiles_x) * kHW;
  };

  {
    int b, ty0, tx0;
    tile_of(t_begin, b, ty0, tx0);
    for (int q = 0; q < (p.resident ? p.nq : 1); ++q)
      dg_load_w<kThr>(p, sm + q * kHWChunk, q, c0, tid);
    dg_load_a<kTHt>(p, stage0, b, ty0, tx0, 0, tid);
    bf16t::commit();
  }

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float pdg[8][2], pdb[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) pdg[j][0] = pdg[j][1] = pdb[j][0] = pdb[j][1] = 0.f;
  int stats_b = -1;  // the image whose statistics slot stats_b & 1 holds

  for (int s = 0; s < steps; ++s) {
    const int tile = t_begin + s / p.nq, q = s % p.nq, st = s & 1;
    int b, ty0, tx0;
    tile_of(tile, b, ty0, tx0);
    // image b's statistics take slot b & 1: a warp still in the epilogue of
    // the last tile of image b - 1 reads the other one, and image b - 2's
    // last epilogue ended before the last barrier
    float* v = sv + (b & 1) * 4 * kHCh;
    bf16t::wait<0>();
    if (kMode != kLinear && b != stats_b) dg_stats(p, v, b, c0, tid, kUp);
    stats_b = b;
    bf16t::fence_async_smem();
    __syncthreads();  // step s is staged; every warp is done with step s - 1

    if (kMode != kLinear && q == 0 && !(kUp && (warp & 1)))
      dg_load_x_row<kUp>(p, S, b, ty0 + warp, tx0, c0, lane);
    bf16t::commit();
    if (s + 1 < steps) {
      int b1, ty1, tx1;
      tile_of(t_begin + (s + 1) / p.nq, b1, ty1, tx1);
      const int q1 = (s + 1) % p.nq;
      dg_load_a<kTHt>(p, stage0 + (st ^ 1) * p.stage_bytes, b1, ty1, tx1, q1, tid);
      if (!p.resident) dg_load_w<kThr>(p, sm + (st ^ 1) * kHWChunk, q1, c0, tid);
    }
    bf16t::commit();
    dg_mma_chunk_h(bf16t::smem_addr(stage0 + st * p.stage_bytes),
                   bf16t::smem_addr(sm) + (p.resident ? q : st) * kHWChunk, acc, warp, lane);
    if (q != p.nq - 1) continue;

    // accumulator entry 4 j + 2 h + e: pixel g + 8 h of tile row `warp`,
    // channel c0 + 8 j + 2 t4 + e
    const int y = ty0 + warp;
    if (kMode != kUpFold) {
      uint32_t xw[8][2];
      if (kMode == kAct) {
        bf16t::wait<1>();  // the warp's x row has landed (step s + 1's copies may not have)
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            xw[j][h] = *reinterpret_cast<const uint32_t*>(S + bf16t::a_byte(g + 8 * h, 0) +
                                                          2 * (8 * j + 2 * t4));
        __syncwarp();  // every lane has its x before any da lands over it
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = 8 * j + 2 * t4, c = c0 + cl;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = g + 8 * h;
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (kMode == kAct) {
            const float2 xv = bf16t::unpack2(xw[j][h]);
            const float xh0 = (xv.x - v[cl]) * v[kHCh + cl];
            const float xh1 = (xv.y - v[cl + 1]) * v[kHCh + cl + 1];
            v0 *= silu_grad_fast(xh0 * v[2 * kHCh + cl] + v[3 * kHCh + cl]);
            v1 *= silu_grad_fast(xh1 * v[2 * kHCh + cl + 1] + v[3 * kHCh + cl + 1]);
            if (y < p.H && tx0 + px < p.W) {
              if (c < p.C) {
                pdg[j][0] += v0 * xh0;
                pdb[j][0] += v0;
              }
              if (c + 1 < p.C) {
                pdg[j][1] += v1 * xh1;
                pdb[j][1] += v1;
              }
            }
          }
          // bf16: da (ds) rounded once; dgamma, dbeta above from the fp32 da
          *reinterpret_cast<uint32_t*>(S + bf16t::a_byte(px, 0) + 2 * cl) = bf16t::pack2(v0, v1);
          acc[4 * j + 2 * h] = acc[4 * j + 2 * h + 1] = 0.f;
        }
      }
      __syncwarp();
      bf16* out = static_cast<bf16*>(p.out);
      for (int idx = lane; idx < kHW * 8; idx += 32) {
        const int px = idx >> 3, k = idx & 7, x = tx0 + px, c = c0 + 8 * k;
        if (y >= p.H || x >= p.W || c >= p.C) continue;
        const uint4 val = *reinterpret_cast<const uint4*>(S + bf16t::a_byte(px, k));
        bf16* dst = out + (((size_t)b * p.H + y) * p.W + x) * p.C + c;
        if (p.ovec) {
          *reinterpret_cast<uint4*>(dst) = val;
        } else {
          const bf16* e = reinterpret_cast<const bf16*>(&val);
          for (int i = 0; i < 8 && c + i < p.C; ++i) dst[i] = e[i];
        }
      }
    } else {
      // column x + 1 of pixel x lies 4 lanes on (tx0 and W are even): lanes
      // of even g hold low-res pixel (g + 8 h) / 2 of the row's 8
      float vv[8][2][2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float a = acc[4 * j + 2 * h + e];
            vv[j][h][e] = a + __shfl_down_sync(0xffffffffu, a, 4);
            acc[4 * j + 2 * h + e] = 0.f;
          }
      const bool lead = (g & 1) == 0;
      // the odd warp's staging rows hold its row's column-folded sums,
      // [8 low-res pixels][64 channels] fp32, for the even warp
      float* F = reinterpret_cast<float*>(sm + p.s_off + (warp | 1) * kHW * bf16t::kARowBytes);
      if ((warp & 1) && lead) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(F + ((g >> 1) + 4 * h) * kHCh + 8 * j + 2 * t4) =
                make_float2(vv[j][h][0], vv[j][h][1]);
      }
      bar_pair(1 + (warp >> 1));
      if (!(warp & 1)) {
        bf16t::wait<1>();  // the low-res x row has landed
        __syncwarp();
        const int Y = y >> 1, hl = p.H / 2, wl = p.W / 2;
        float* out = static_cast<float*>(p.out);
        if (lead) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int cl = 8 * j + 2 * t4, c = c0 + cl;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int L = (g >> 1) + 4 * h, X = tx0 / 2 + L;
              const float2 f = *reinterpret_cast<const float2*>(F + L * kHCh + cl);
              float d0 = vv[j][h][0] + f.x, d1 = vv[j][h][1] + f.y;  // rows 2Y, 2Y + 1
              const float2 xv = bf16t::unpack2(*reinterpret_cast<const uint32_t*>(
                  S + bf16t::a_byte(L, 0) + 2 * cl));
              const float xh0 = (xv.x - v[cl]) * v[kHCh + cl];
              const float xh1 = (xv.y - v[cl + 1]) * v[kHCh + cl + 1];
              d0 *= silu_grad_fast(xh0 * v[2 * kHCh + cl] + v[3 * kHCh + cl]);
              d1 *= silu_grad_fast(xh1 * v[2 * kHCh + cl + 1] + v[3 * kHCh + cl + 1]);
              if (Y >= hl || X >= wl || c >= p.C) continue;
              pdg[j][0] += d0 * xh0;
              pdb[j][0] += d0;
              float* dst = out + (((size_t)b * hl + Y) * wl + X) * p.C + c;
              if (c + 1 < p.C) {
                pdg[j][1] += d1 * xh1;
                pdb[j][1] += d1;
              }
              if (p.pair) {
                *reinterpret_cast<float2*>(dst) = make_float2(d0, d1);
              } else {
                dst[0] = d0;
                if (c + 1 < p.C) dst[1] = d1;
              }
            }
          }
        }
      }
    }

    if (kMode == kLinear) continue;
    // the partials go out when the block leaves image b: sums over g (lane
    // bits 2-4), then the warps in a fixed order
    int bn = -1, tyn, txn;
    if (tile + 1 < t_end) tile_of(tile + 1, bn, tyn, txn);
    if (bn == b) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
#pragma unroll
        for (int sh = 4; sh < 32; sh <<= 1) {
          pdg[j][e] += __shfl_xor_sync(0xffffffffu, pdg[j][e], sh);
          pdb[j][e] += __shfl_xor_sync(0xffffffffu, pdb[j][e], sh);
        }
        if (g == 0) {
          red[warp * kHCh + 8 * j + 2 * t4 + e] = pdg[j][e];
          red[(kWarps + warp) * kHCh + 8 * j + 2 * t4 + e] = pdb[j][e];
        }
        pdg[j][e] = pdb[j][e] = 0.f;
      }
    __syncthreads();
    if (tid < kHCh && c0 + tid < p.C) {
      float sg = 0.f, sb = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        sg += red[w * kHCh + tid];
        sb += red[(kWarps + w) * kHCh + tid];
      }
      const size_t gx = gridDim.x;
      p.part[((size_t)b * gx + blockIdx.x) * p.C + c0 + tid] = sg;
      p.part[(((size_t)p.B + b) * gx + blockIdx.x) * p.C + c0 + tid] = sb;
    }
  }
  bf16t::wait<0>();
}

// (dgamma, dbeta)[b, c] = the sum over the dgrad blocks that covered image b
// of their partials, in block order (the tile partition of dgrad_bf16_kernel:
// block k walks tiles [k n / gx, (k + 1) n / gx))
__global__ void __launch_bounds__(kHCh) dgrad_reduce_kernel(const float* __restrict__ part,
                                                           float* __restrict__ out, int B,
                                                           int C, int gx, int per_img) {
  const int c = blockIdx.x * kHCh + threadIdx.x, b = blockIdx.y, s = blockIdx.z;
  if (c >= C) return;
  const long long ntiles = (long long)B * per_img;
  const long long lo = (long long)b * per_img, hi = lo + per_img;
  // the first block whose run can reach image b: k n / gx <= lo
  int k = (int)(lo * gx / ntiles);
  while (k > 0 && k * ntiles / gx > lo) --k;
  float acc = 0.f;
  for (; k < gx; ++k) {
    const long long t0 = k * ntiles / gx, t1 = (k + 1) * ntiles / gx;
    if (t0 >= hi) break;
    if (t0 == t1 || t1 <= lo) continue;
    acc += part[(((size_t)s * B + b) * gx + k) * C + c];
  }
  out[((size_t)s * B + b) * C + c] = acc;
}

// ---- wgrad ----------------------------------------------------------------

struct WgradH {
  const bf16* x;       // (B, Hx, Wx, C): the conv input before the activation (K3 low-res)
  const bf16* g;       // (B, H, W, O) cotangent of the conv output
  const float* gamma;  // (B, C), unused when act == 0
  const float* beta;
  const float* sums;   // (B, C) the forward's channel sums of x
  const float* sumsq;
  float* part;         // (grid x, taps C O [+ O]): a run's partial dW [, dbias]
  int B, H, W, C, O, groups;
  float eps;
  int act, taps, bias, xvec, gvec, pair;
  // the plan (plan_wgrad_h): tiles an image; byte offsets: the two g planes
  // from 0, g_bytes each, then the two x stages, x_bytes each
  int tiles_y, tiles_x, g_bytes, x_off, x_bytes, v_off, red_off;
};

// The raw tiles of tile (ty0, tx0) into a stage: x (K3: the low-res tile
// under it; one tap: the tile's own pixels) as [position][channel] rows,
// channels c0 .. c0 + 63, and g as 128-byte [pixel][output] rows in
// wgmma's swizzle, outputs o0 .. o0 + 63; zero outside the image and past
// C and O.
template <bool kUp, int kTHt>
__device__ __forceinline__ void wg_load_tile_h(const WgradH& p, unsigned char* G,
                                               unsigned char* X, int b, int ty0, int tx0,
                                               int c0, int o0, int tid) {
  constexpr int kCols = kUp ? kHW / 2 + 2 : kHW + 2;
  constexpr int kNPos = (kUp ? kTHt / 2 + 2 : kTHt + 2) * kCols;
  const int hx = kUp ? p.H / 2 : p.H, wx = kUp ? p.W / 2 : p.W;
  const int y0 = kUp ? ty0 / 2 - 1 : ty0 - 1, x0 = kUp ? tx0 / 2 - 1 : tx0 - 1;
  const bool one = p.taps == 1;
  const bf16* xb = p.x + (size_t)b * hx * wx * p.C;
  for (int idx = tid; idx < kNPos * 8; idx += kWgThreads) {
    const int pos = idx >> 3, k = idx & 7, iy = pos / kCols, ix = pos % kCols;
    const int y = y0 + iy, x = x0 + ix, c = c0 + 8 * k;
    const bool halo = one && (iy == 0 || iy == kTHt + 1 || ix == 0 || ix == kCols - 1);
    const bool in = !halo && y >= 0 && y < hx && x >= 0 && x < wx;
    bf16t::copy8(X + bf16t::a_byte(pos, k), in ? xb + ((size_t)y * wx + x) * p.C + c : p.x,
                 in, c, p.C, p.xvec, p.x);
  }
  const bf16* gb = p.g + (size_t)b * p.H * p.W * p.O;
  for (int idx = tid; idx < kTHt * kHW * 8; idx += kWgThreads) {
    const int px = idx >> 3, k = idx & 7;
    const int y = ty0 + px / kHW, x = tx0 + px % kHW, o = o0 + 8 * k;
    const bool in = y < p.H && x < p.W;
    bf16t::copy8(G + bf16t::w_byte(px, k), in ? gb + ((size_t)y * p.W + x) * p.O + o : p.g,
                 in, o, p.O, p.gvec, p.g);
  }
}

// GroupNorm and SiLU in fp32 on the x stage, in place, each value rounded
// once to bf16: the forward's activate_h, 16 bytes (8 channels) a
// thread-item on the items the thread copied itself. The scale and shift are
// folded, x * (gamma rstd) + (beta - gamma rstd mean) (zero past C, so those
// channels come out silu(0) = 0), SiLU by __expf and a fast division: fp32
// before the one rounding, so a value can differ from the plain version's
// by one bf16 ulp. Positions outside the image keep the copy's zeros.
template <bool kUp, int kTHt>
__device__ __forceinline__ void wg_activate(const WgradH& p, unsigned char* X, int ty0, int tx0,
                                            const float* s_sc, const float* s_sh, int c0,
                                            int tid) {
  constexpr int kCols = kUp ? kHW / 2 + 2 : kHW + 2;
  constexpr int kNPos = (kUp ? kTHt / 2 + 2 : kTHt + 2) * kCols;
  const int k = tid & 7;
  if (c0 + 8 * k >= p.C) return;
  const int hx = kUp ? p.H / 2 : p.H, wx = kUp ? p.W / 2 : p.W;
  const int y0 = kUp ? ty0 / 2 - 1 : ty0 - 1, x0 = kUp ? tx0 / 2 - 1 : tx0 - 1;
  float sc[8], sh[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sc[i] = s_sc[8 * k + i];
    sh[i] = s_sh[8 * k + i];
  }
#pragma unroll 2
  for (int pos = tid >> 3; pos < kNPos; pos += kWgThreads / 8) {
    const int y = y0 + pos / kCols, x = x0 + pos % kCols;
    if (y < 0 || y >= hx || x < 0 || x >= wx) continue;
    uint4* ptr = reinterpret_cast<uint4*>(X + bf16t::a_byte(pos, k));
    const uint4 raw = *ptr;
    const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lo = __uint_as_float(in[i] << 16), hi = __uint_as_float(in[i] & 0xffff0000u);
      o[i] = bf16t::pack2(bf16t::silu_fast(lo * sc[2 * i] + sh[2 * i]),
                          bf16t::silu_fast(hi * sc[2 * i + 1] + sh[2 * i + 1]));
    }
    *ptr = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// One tile's products of warpgroup wg: taps (wg, dx) for dx = 0, 1, 2, each
// a (64 channels x 64 outputs) sum over the tile's pixels, a k16 step a
// tile row: wgmma m64n64k16 into acc[dx], A = act(x)^T (warp wi: channels
// 16 wi .. + 15) by ldmatrix .trans from the x stage at the tap's shifted
// pixels (K3: low-res pixel (y / 2, x / 2)), B = the g rows of the tile row
// through a descriptor (N-contiguous, transposed). A rides a three-deep
// ring of fragments: step s + 2's is loaded once step s - 1 is done.
template <bool kUp>
__device__ __forceinline__ void wg_mma_tile(uint32_t X, uint32_t G, float (&acc)[3][32], int dy,
                                            int wi, int rows, int lane) {
  constexpr int kCols = kUp ? kHW / 2 + 2 : kHW + 2;
  const int ri = lane & 7, mi = lane >> 3;
  const int px = ri + 8 * (mi >> 1);                       // the lane's pixel row
  const uint32_t cb = 2 * (16 * wi + 8 * (mi & 1));        // and its 8 channels
  auto row_of = [&](int r, int dx) -> uint32_t {
    const int pos = kUp ? (((r + dy - 1) >> 1) + 1) * kCols + ((px + dx - 1) >> 1) + 1
                        : (r + dy) * kCols + px + dx;
    return X + pos * bf16t::kARowBytes + cb;
  };
  uint32_t a[3][4];
  bf16t::ldsm_x4_trans(row_of(0, 0), a[0]);
  bf16t::ldsm_x4_trans(row_of(0, 1), a[1]);
#pragma unroll 1
  for (int r = 0; r < rows; ++r) {
    const uint64_t desc = bf16t::wg_desc(G + r * kHW * bf16t::kWRowBytes);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      bf16t::wg_fence();
      bf16t::wg_mma(acc[dx], a[dx], desc);
      bf16t::wg_commit();
      bf16t::wg_wait<1>();  // step s - 1 is done with its buffer, (dx + 2) % 3
      const int r2 = dx == 0 ? r : r + 1, d2 = (dx + 2) % 3;  // step s + 2
      if (r2 < rows) bf16t::ldsm_x4_trans(row_of(r2, d2), a[(dx + 2) % 3]);
    }
  }
  bf16t::wg_wait<0>();
}

// The one-tap product (the 1x1 projection's weight): warpgroup wg takes
// the tile rows r = wg (mod 3), each a k16 step into acc
__device__ __forceinline__ void wg_mma_one(uint32_t X, uint32_t G, float (&acc)[32], int wg,
                                           int wi, int rows, int lane) {
  const int ri = lane & 7, mi = lane >> 3;
  const int px = ri + 8 * (mi >> 1);
  const uint32_t cb = 2 * (16 * wi + 8 * (mi & 1));
  uint32_t a[4];
#pragma unroll 1
  for (int r = wg; r < rows; r += 3) {
    bf16t::ldsm_x4_trans(X + ((r + 1) * (kHW + 2) + px + 1) * bf16t::kARowBytes + cb, a);
    bf16t::wg_fence();
    bf16t::wg_mma(acc, a, bf16t::wg_desc(G + r * kHW * bf16t::kWRowBytes));
    bf16t::wg_commit();
    bf16t::wg_wait<0>();
  }
}

// Persistent blocks: blockIdx.y is the (64-channel C-block, 64-output
// O-block) pair, blockIdx.x walks a contiguous run of the pixel tiles
// (image-major) and owns one row of the partial scratch. Each tile: its
// raw x and g tiles arrive by cp.async one tile ahead (two stages), the
// x stage is activated in place once (every input channel of the block
// against every output channel: no pass a second time for another O slice),
// then each warpgroup runs its three taps' products over the tile's rows.
// dbias (the C-block at 0): thread tid sums outputs 2 (tid % 32), + 1 over
// the pixels of class tid / 32 (of 12), in pixel order; the classes are
// added in order at the end.
template <bool kUp, int kTHt>
__global__ void __launch_bounds__(kWgThreads, 1) wgrad_bf16_kernel(const WgradH p) {
  extern __shared__ __align__(128) unsigned char sm_raw[];
  unsigned char* sm = bf16t::align1024(sm_raw);
  float* s_sc = reinterpret_cast<float*>(sm + p.v_off);  // [64] folded scale
  float* s_sh = s_sc + kHCh;                             // [64] and shift
  float* red = reinterpret_cast<float*>(sm + p.red_off);  // [kBiasClasses][64]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wi = warp & 3;
  const int ncb = (p.C + kHCh - 1) / kHCh;
  const int c0 = (blockIdx.y % ncb) * kHCh, o0 = (blockIdx.y / ncb) * kHCh;
  const int per_img = p.tiles_y * p.tiles_x;
  const int ntiles = p.B * per_img;
  const int t_begin = (int)((long long)blockIdx.x * ntiles / gridDim.x);
  const int t_end = (int)((long long)(blockIdx.x + 1) * ntiles / gridDim.x);
  const bool one = p.taps == 1, do_bias = p.bias && c0 == 0;

  auto tile_of = [&](int tile, int& b, int& ty0, int& tx0) {
    b = tile / per_img;
    const int rem = tile - b * per_img;
    ty0 = (rem / p.tiles_x) * kTHt;
    tx0 = (rem % p.tiles_x) * kHW;
  };
  if (t_begin < t_end) {
    int b, ty0, tx0;
    tile_of(t_begin, b, ty0, tx0);
    wg_load_tile_h<kUp, kTHt>(p, sm, sm + p.x_off, b, ty0, tx0, c0, o0, tid);
  }
  bf16t::commit();

  float acc[3][32];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[d][i] = 0.f;
  float gs0 = 0.f, gs1 = 0.f;
  int scale_b = -1;  // the image whose scale and shift s_sc / s_sh hold

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int st = (tile - t_begin) & 1;
    int b, ty0, tx0;
    tile_of(tile, b, ty0, tx0);
    unsigned char* G = sm + st * p.g_bytes;
    unsigned char* X = sm + p.x_off + st * p.x_bytes;
    bf16t::wait<0>();
    if (p.act && b != scale_b) {
      // every warp is past the last tile's activation pass (its barrier)
      if (tid < kHCh) {
        const int ch = c0 + tid;
        float sc = 0.f, sh = 0.f;
        if (ch < p.C) {
          const float cnt = (float)(kUp ? p.H / 2 : p.H) * (float)(kUp ? p.W / 2 : p.W) *
                            (float)(p.C / p.groups);
          float mean, rstd;
          mean_rstd(p.sums, p.sumsq, b, p.C, ch, p.groups, cnt, p.eps, &mean, &rstd);
          sc = p.gamma[b * p.C + ch] * rstd;
          sh = p.beta[b * p.C + ch] - sc * mean;
        }
        s_sc[tid] = sc;
        s_sh[tid] = sh;
      }
      scale_b = b;
      __syncthreads();
    }
    if (p.act) wg_activate<kUp, kTHt>(p, X, ty0, tx0, s_sc, s_sh, c0, tid);
    bf16t::fence_async_smem();
    __syncthreads();  // the tile is staged; every warp is done with the last one
    if (tile + 1 < t_end) {
      int b1, ty1, tx1;
      tile_of(tile + 1, b1, ty1, tx1);
      wg_load_tile_h<kUp, kTHt>(p, sm + (st ^ 1) * p.g_bytes, sm + p.x_off + (st ^ 1) * p.x_bytes,
                                b1, ty1, tx1, c0, o0, tid);
    }
    bf16t::commit();
    const int rows = min(kTHt, p.H - ty0);  // rows past the image add nothing
    if (do_bias) {
      const int op = tid & 31;
      for (int px = tid >> 5; px < rows * kHW; px += kBiasClasses) {
        const float2 f = bf16t::unpack2(*reinterpret_cast<const uint32_t*>(
            G + bf16t::w_byte(px, op >> 2) + 4 * (op & 3)));
        gs0 += f.x;
        gs1 += f.y;
      }
    }
    if (one)
      wg_mma_one(bf16t::smem_addr(X), bf16t::smem_addr(G), acc[0], wg, wi, rows, lane);
    else
      wg_mma_tile<kUp>(bf16t::smem_addr(X), bf16t::smem_addr(G), acc, wg, wi, rows, lane);
  }
  bf16t::wait<0>();

  float* out = p.part + (size_t)blockIdx.x * ((size_t)p.taps * p.C * p.O + (p.bias ? p.O : 0));
  const int g = lane >> 2, t4 = lane & 3;
  if (one) {
    // the three warpgroups' sums of the same outputs, added in order
    float* sacc = reinterpret_cast<float*>(sm);  // [2][32][128], over the g planes
    __syncthreads();
    if (wg > 0)
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[((wg - 1) * 32 + i) * 128 + (tid & 127)] = acc[0][i];
    __syncthreads();
    if (wg == 0)
#pragma unroll
      for (int i = 0; i < 32; ++i)
        acc[0][i] = (acc[0][i] + sacc[i * 128 + tid]) + sacc[(32 + i) * 128 + tid];
  }
  // entry 4 j + 2 h + e of acc[dx]: channel c0 + 16 wi + g + 8 h, output
  // o0 + 8 j + 2 t4 + e
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    if (one && (dx > 0 || wg > 0)) break;
    const int tap = one ? 0 : 3 * wg + dx;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int o = o0 + 8 * j + 2 * t4;
      if (o >= p.O) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + 16 * wi + g + 8 * h;
        if (c >= p.C) continue;
        float* dst = out + ((size_t)tap * p.C + c) * p.O + o;
        const float v0 = acc[dx][4 * j + 2 * h], v1 = acc[dx][4 * j + 2 * h + 1];
        if (p.pair) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (o + 1 < p.O) dst[1] = v1;
        }
      }
    }
  }
  if (do_bias) {
    red[(tid >> 5) * kHCh + 2 * (tid & 31)] = gs0;
    red[(tid >> 5) * kHCh + 2 * (tid & 31) + 1] = gs1;
    __syncthreads();
    if (tid < kHCh && o0 + tid < p.O) {
      float total = 0.f;
      for (int k = 0; k < kBiasClasses; ++k) total += red[k * kHCh + tid];
      out[(size_t)p.taps * p.C * p.O + o0 + tid] = total;
    }
  }
}

// ---- the dx pass ----------------------------------------------------------

// dx = rstd (da gamma - m1 - xhat m2), with m1, m2 the group means of
// da gamma and da gamma xhat from the (B, C) sums dgamma = sum da xhat and
// dbeta = sum da (_dx_from_da's identities), formed as _dx_from_da writes
// it: da (rstd gamma) - (x - mean) (rstd^2 m2) - rstd m1, in fp32, rounded
// once to bf16. x bf16; da bf16 (K2) or fp32 (K3's low-res tail). A block
// takes a slice of one image's elements, 8 channels (16 bytes of x and dx)
// a thread-item where C % 8 == 0, and first folds the image's per-channel
// factors into shared memory.
template <typename TDa>
__global__ void __launch_bounds__(kDxThreads) gn_dx_kernel(
    const bf16* __restrict__ x, const TDa* __restrict__ da, const float* __restrict__ gamma,
    const float* __restrict__ dstats, const float* __restrict__ sums,
    const float* __restrict__ sumsq, bf16* __restrict__ dx, int B, int N, int C, int groups,
    float eps, int vec) {
  extern __shared__ float coef[];  // [4][C]: rstd gamma, rstd^2 m2, rstd m1, mean
  const int b = blockIdx.y, tid = threadIdx.x;
  const int per = C / groups;
  const float cnt = (float)N * (float)per;
  for (int ch = tid; ch < C; ch += kDxThreads) {
    const int g0 = (ch / per) * per;
    float s = 0.f, ss = 0.f, m1 = 0.f, m2 = 0.f;
    for (int k = 0; k < per; ++k) {
      const int i = b * C + g0 + k;
      s += sums[i];
      ss += sumsq[i];
      m1 += gamma[i] * dstats[(size_t)B * C + i];  // gamma dbeta
      m2 += gamma[i] * dstats[i];                  // gamma dgamma
    }
    const float mean = s / cnt;
    const float rstd = rsqrtf(fmaxf(ss / cnt - mean * mean, 0.f) + eps);
    coef[ch] = rstd * gamma[b * C + ch];
    coef[C + ch] = rstd * rstd * (m2 / cnt);
    coef[2 * C + ch] = rstd * (m1 / cnt);
    coef[3 * C + ch] = mean;
  }
  __syncthreads();
  const size_t base = (size_t)b * N * C;
  auto one = [&](float xv, float dv, int c) {
    return dv * coef[c] - (xv - coef[3 * C + c]) * coef[C + c] - coef[2 * C + c];
  };
  if (vec) {
    const int items = N * (C / 8);
    for (int it = blockIdx.x * kDxThreads + tid; it < items; it += gridDim.x * kDxThreads) {
      const size_t e = base + (size_t)it * 8;
      const int c = (it % (C / 8)) * 8;
      const uint4 xr = *reinterpret_cast<const uint4*>(x + e);
      float dv[8];
      if constexpr (std::is_same<TDa, float>::value) {
        const float4 d0 = *reinterpret_cast<const float4*>(da + e);
        const float4 d1 = *reinterpret_cast<const float4*>(da + e + 4);
        dv[0] = d0.x; dv[1] = d0.y; dv[2] = d0.z; dv[3] = d0.w;
        dv[4] = d1.x; dv[5] = d1.y; dv[6] = d1.z; dv[7] = d1.w;
      } else {
        const uint4 dr = *reinterpret_cast<const uint4*>(da + e);
        const uint32_t dw[4] = {dr.x, dr.y, dr.z, dr.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = bf16t::unpack2(dw[i]);
          dv[2 * i] = f.x;
          dv[2 * i + 1] = f.y;
        }
      }
      const uint32_t xw[4] = {xr.x, xr.y, xr.z, xr.w};
      uint32_t o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 xv = bf16t::unpack2(xw[i]);
        o[i] = bf16t::pack2(one(xv.x, dv[2 * i], c + 2 * i), one(xv.y, dv[2 * i + 1], c + 2 * i + 1));
      }
      *reinterpret_cast<uint4*>(dx + e) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  } else {
    const int items = N * C;
    for (int it = blockIdx.x * kDxThreads + tid; it < items; it += gridDim.x * kDxThreads) {
      const size_t e = base + it;
      const float dv = to_f(da[e]);
      dx[e] = __float2bfloat16_rn(one(__bfloat162float(x[e]), dv, it % C));
    }
  }
}

// ---- plans and launches ---------------------------------------------------

// The launch plan of a bf16 dgrad call. Tile: 16 x 16 pixels (16 warps)
// where that gives kHBigTileWaves tiles a block on one wave and its layout
// fits, else 8 x 16 (8 warps). Weights resident when every o-chunk fits
// beside the rest, else streamed a chunk a step through two slots. Shared
// memory, in this order: weights, the two A stages, the staging rows (16
// a warp), the two statistics slots, the partials' reduction; + 1024 for
// the alignment.
struct PlanD {
  int th, resident, nq, nb, tiles_y, tiles_x, grid_x, bps, smem;
  int a_off, stage_bytes, s_off, v_off, red_off;
};

int layout_dgrad_h(int th, bool resident, int nq, PlanD& pl) {
  pl.stage_bytes = (th + 2) * (kHW + 2) * bf16t::kARowBytes;
  pl.a_off = (resident ? nq : 2) * kHWChunk;
  pl.s_off = pl.a_off + 2 * pl.stage_bytes;
  pl.v_off = pl.s_off + th * kHW * bf16t::kARowBytes;
  pl.red_off = pl.v_off + 2 * 4 * kHCh * 4;
  pl.smem = pl.red_off + 2 * th * kHCh * 4 + 1024;
  return pl.smem;
}

template <int kMode, int kTHt>
int dgrad_bps(int smem) {
  return blocks_per_sm_h(dgrad_bf16_kernel<kMode, kTHt>, kMode * 2 + (kTHt == 16), 32 * kTHt,
                         smem);
}

int dgrad_bps_of(int mode, int th, int smem) {
  if (mode == kLinear) return th == 16 ? dgrad_bps<kLinear, 16>(smem) : dgrad_bps<kLinear, 8>(smem);
  if (mode == kAct) return th == 16 ? dgrad_bps<kAct, 16>(smem) : dgrad_bps<kAct, 8>(smem);
  return th == 16 ? dgrad_bps<kUpFold, 16>(smem) : dgrad_bps<kUpFold, 8>(smem);
}

bool plan_dgrad_h(int mode, int batch, int h, int wd, int c, int o, PlanD& pl) {
  const int sms = bf16t::sm_count();
  pl.nq = (o + kHCh - 1) / kHCh;
  pl.nb = (c + kHCh - 1) / kHCh;
  const long long tiles16 = (long long)batch * ((h + 15) / 16) * ((wd + kHW - 1) / kHW);
  if (tiles16 * pl.nb >= (long long)kHBigTileWaves * sms &&
      layout_dgrad_h(16, true, pl.nq, pl) <= kHCap) {
    pl.th = 16;
    pl.resident = 1;
  } else {
    pl.th = 8;
    pl.resident = layout_dgrad_h(8, true, pl.nq, pl) <= kHCap;
    if (!pl.resident && layout_dgrad_h(8, false, pl.nq, pl) > kHCap) return false;
  }
  pl.tiles_y = (h + pl.th - 1) / pl.th;
  pl.tiles_x = (wd + kHW - 1) / kHW;
  pl.bps = dgrad_bps_of(mode, pl.th, pl.smem);
  if (pl.bps < 1) return false;
  const long long tiles = (long long)batch * pl.tiles_y * pl.tiles_x;
  const long long per_nb = (long long)sms * pl.bps / pl.nb;
  pl.grid_x = (int)(tiles < per_nb ? tiles : (per_nb < 1 ? 1 : per_nb));
  return true;
}

// The launch plan of a bf16 wgrad call on the tensor cores: 16 x 16 tiles
// where they give kHBigTileWaves tiles a block on one wave, else 8 x 16;
// one block an SM (three warpgroups, up to 96 accumulator registers a
// thread); a run of tiles a block. Shared memory: the two g planes, the two
// x stages, the scale and shift, dbias's reduction; + 1024.
struct PlanW {
  int th, tiles_y, tiles_x, grid_x, n_cb, n_ob, bps, smem;
  int g_bytes, x_off, x_bytes, v_off, red_off;
};

template <bool kUp, int kTHt>
int wgrad_bps(int smem) {
  return blocks_per_sm_h(wgrad_bf16_kernel<kUp, kTHt>, 6 + 2 * kUp + (kTHt == 16), kWgThreads,
                         smem);
}

bool plan_wgrad_h(bool up, int batch, int h, int wd, int c, int o, PlanW& pl) {
  const int sms = bf16t::sm_count();
  pl.n_cb = (c + kHCh - 1) / kHCh;
  pl.n_ob = (o + kHCh - 1) / kHCh;
  const long long tiles16 = (long long)batch * ((h + 15) / 16) * ((wd + kHW - 1) / kHW);
  pl.th = tiles16 * pl.n_cb * pl.n_ob >= (long long)kHBigTileWaves * sms ? 16 : 8;
  const int cols = up ? kHW / 2 + 2 : kHW + 2;
  pl.g_bytes = pl.th * kHW * bf16t::kWRowBytes;
  pl.x_bytes = (up ? pl.th / 2 + 2 : pl.th + 2) * cols * bf16t::kARowBytes;
  pl.x_off = 2 * pl.g_bytes;
  pl.v_off = pl.x_off + 2 * pl.x_bytes;
  pl.red_off = pl.v_off + 2 * kHCh * 4;
  pl.smem = pl.red_off + kBiasClasses * kHCh * 4 + 1024;
  pl.tiles_y = (h + pl.th - 1) / pl.th;
  pl.tiles_x = (wd + kHW - 1) / kHW;
  pl.bps = up ? (pl.th == 16 ? wgrad_bps<true, 16>(pl.smem) : wgrad_bps<true, 8>(pl.smem))
              : (pl.th == 16 ? wgrad_bps<false, 16>(pl.smem) : wgrad_bps<false, 8>(pl.smem));
  if (pl.bps < 1) return false;
  const long long tiles = (long long)batch * pl.tiles_y * pl.tiles_x;
  const long long per = (long long)sms * pl.bps / (pl.n_cb * pl.n_ob);
  pl.grid_x = (int)(tiles < per ? tiles : (per < 1 ? 1 : per));
  return true;
}

template <int kMode>
void launch_dgrad_h(const PlanD& pl, const DgradH& p, cudaStream_t s) {
  const dim3 grid(pl.grid_x, pl.nb);
  if (pl.th == 16) dgrad_bf16_kernel<kMode, 16><<<grid, 32 * 16, pl.smem, s>>>(p);
  else dgrad_bf16_kernel<kMode, 8><<<grid, 32 * 8, pl.smem, s>>>(p);
}

int dgrad_reduce(const float* part, float* dstats, int batch, int c, int gx, int per_img,
                 cudaStream_t s) {
  dgrad_reduce_kernel<<<dim3((c + kHCh - 1) / kHCh, batch, 2), kHCh, 0, s>>>(part, dstats, batch,
                                                                           c, gx, per_img);
  return (int)cudaGetLastError();
}

// mc_conv_dgrad_bf16's launch. Modes: kLinear ds, kAct da (bf16 out,
// dstats), kUpFold (h, w even; x low-res (B, h / 2, w / 2, c); out fp32 da
// of that shape, dstats). part: the (2, batch, grid x, c) scratch of the
// plan (mc_conv_bwd_bf16_plan).
int conv_dgrad_bf16(const bf16* g, const bf16* w, const bf16* x, const float* gamma,
                    const float* beta, const float* sums, const float* sumsq, void* out,
                    float* dstats, float* part, int batch, int h, int wd, int c, int o,
                    int groups, float eps, int mode, void* stream) {
  const bool stats = mode != kLinear;
  if (batch < 1 || h < 1 || wd < 1 || c < 1 || o < 1 || mode < kLinear ||
      mode > kUpFold || (mode == kUpFold && (h % 2 || wd % 2)) || !out ||
      (stats && (!x || !gamma || !beta || !sums || !sumsq || !dstats || !part || groups < 1 ||
                 c % groups)))
    return (int)cudaErrorInvalidValue;
  PlanD pl;
  if (!plan_dgrad_h(mode, batch, h, wd, c, o, pl)) return (int)cudaErrorInvalidConfiguration;
  const bool up = mode == kUpFold;
  DgradH p{g, w, x, gamma, beta, sums, sumsq, out, part, batch, h, wd, c, o, groups, eps,
           o % 8 == 0 && aligned(g, 16), o % 8 == 0 && aligned(w, 16),
           stats && c % 8 == 0 && aligned(x, 16), !up && c % 8 == 0 && aligned(out, 16),
           up && c % 2 == 0 && aligned(out, 8),
           pl.resident, pl.nq, pl.tiles_y, pl.tiles_x,
           pl.a_off, pl.stage_bytes, pl.s_off, pl.v_off, pl.red_off};
  const cudaStream_t s = (cudaStream_t)stream;
  if (mode == kLinear) launch_dgrad_h<kLinear>(pl, p, s);
  else if (mode == kAct) launch_dgrad_h<kAct>(pl, p, s);
  else launch_dgrad_h<kUpFold>(pl, p, s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !stats) return (int)err;
  return dgrad_reduce(part, dstats, batch, c, pl.grid_x, pl.tiles_y * pl.tiles_x, s);
}


// ---------------------------------------------------------------------------
// bf16 wgrad at C <= 8 (conv_in) on wgmma: wgrad_narrow_bf16_kernel (the
// header's note)
// ---------------------------------------------------------------------------

constexpr int kNbTH = 8, kNbTW = 16;            // a pixel tile: 8 rows x 16 columns
constexpr int kNbPix = kNbTH * kNbTW;           // 128 pixels: a stage's K
constexpr int kNbHaloW = kNbTW + 2;
constexpr int kNbHalo = (kNbTH + 2) * kNbHaloW;  // 180 positions of x
constexpr int kNbPanel = kNbPix * 128;          // 128 rows of 64 bf16: an A or g panel
constexpr int kNbStages = 4;                    // the ring's stages, where they fit
constexpr int kNbThreads = 128 + 128 + 32;      // products, im2col, producer

// panels of 64 rows of A: 9 C rows, and the ones row where there is a bias
__host__ __device__ constexpr int nb_panels(int c) { return (9 * c + 1 + 63) / 64; }
__host__ __device__ constexpr int nb_stage_bytes(int c) { return (nb_panels(c) + 1) * kNbPanel; }
// the stages from a 1024-byte boundary, the two x buffers, the barriers; +
// 1024 for the alignment
__host__ __device__ constexpr int nb_xbuf_bytes(int c) { return (kNbHalo * 2 * c + 15) / 16 * 16; }
__host__ __device__ constexpr int nb_stages(int c) {
  return (kHCap - 1024 - 2 * nb_xbuf_bytes(c) - 16 * kNbStages) / nb_stage_bytes(c) < kNbStages
             ? (kHCap - 1024 - 2 * nb_xbuf_bytes(c) - 16 * kNbStages) / nb_stage_bytes(c)
             : kNbStages;
}
__host__ __device__ constexpr int nb_smem(int c) {
  return 1024 + nb_stages(c) * nb_stage_bytes(c) + 2 * nb_xbuf_bytes(c) + 16 * nb_stages(c);
}

struct NarrowWb {
  const bf16* x;  // (B, H, W, C)
  const bf16* g;  // (B, H, W, O)
  float* part;    // (rows, 9 C O [+ O]): a block's partial dW [, dbias]
  int B, H, W, O, bias, tiles_x, tiles, tma, xvec, gpair, pair;
};

// x's C values at one position (0 outside the image) into xbuf: one cp.async
// of 2 C bytes where xvec (C 2, 4 or 8 on aligned x), else plain loads
template <int C>
__device__ __forceinline__ void nb_load_pos(bf16* dst, const bf16* src, bool in, bool xvec) {
  if constexpr (C == 2 || C == 4 || C == 8) {
    if (xvec) {
      const uint32_t d = bf16t::smem_addr(dst);
      const int n = in ? 2 * C : 0;
      if constexpr (C == 8)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" :: "r"(d), "l"(src), "r"(n)
                     : "memory");
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;"
                     :: "r"(d), "l"(src), "n"(2 * C), "r"(n) : "memory");
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) dst[c] = in ? src[c] : __float2bfloat16(0.f);
}

// The roles (see the header): warps 0-3 multiply, warps 4-7 build the
// im2col tile, warp 8 brings g. Block (run, o-panel) takes tiles part_begin
// (run) .. of the (image, tile row, tile column) order.
template <int C>
__global__ void __launch_bounds__(kNbThreads, 1)
wgrad_narrow_bf16_kernel(const __grid_constant__ CUtensorMap gmap, const NarrowWb p) {
  constexpr int kMP = nb_panels(C), kStage = nb_stage_bytes(C), kS = nb_stages(C);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = bf16t::align1024(smem_raw);
  bf16* xbuf = reinterpret_cast<bf16*>(ring + kS * kStage);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(ring + kS * kStage + 2 * nb_xbuf_bytes(C));
  unsigned long long* empty = full + kS;
  const int run = blockIdx.x, o0 = 64 * blockIdx.y, O = p.O;
  const int t0 = (int)((long long)run * p.tiles / gridDim.x);
  const int nt = (int)((long long)(run + 1) * p.tiles / gridDim.x) - t0;
  const int per_img = p.tiles / p.B;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      tma::mbar_init(full + s, 1 + 4);  // the producer and the im2col warps
      tma::mbar_init(empty + s, 4);     // the product warps
    }
    tma::fence_barrier_init();
  }
  __syncthreads();
  // tile i of the block: its image and first pixel
  auto tile_at = [&](int i, int& b, int& y0, int& x0) {
    const int t = t0 + i, r = t % per_img;
    b = t / per_img;
    y0 = (r / p.tiles_x) * kNbTH;
    x0 = (r % p.tiles_x) * kNbTW;
  };

  if (warp == 8) {  // g: a 128-pixel x 64-output box a stage
    for (int i = 0; i < nt; ++i) {
      const int s = i % kS;
      if (i >= kS) tma::mbar_wait(empty + s, (i / kS - 1) & 1);
      unsigned char* gs = ring + s * kStage + kMP * kNbPanel;
      int b, y0, x0;
      tile_at(i, b, y0, x0);
      if (p.tma) {
        if (lane == 0) {
          tma::mbar_expect_tx(full + s, kNbPanel);
          tma::load_4d(gs, &gmap, full + s, o0, x0, y0, b);
        }
      } else {  // rows TMA cannot describe: 4-byte cp.async pairs (O even), else
                // element loads; zero past the image and past O
        for (int idx = lane; idx < kNbPix * 8; idx += 32) {
          const int r = idx / 8, jj = idx % 8, py = y0 + r / kNbTW, px = x0 + r % kNbTW;
          const int o = o0 + 8 * jj;
          const bool in = py < p.H && px < p.W;
          const bf16* src = p.g + (((size_t)b * p.H + py) * p.W + px) * O + o;
          unsigned char* dst = gs + r * 128 + ((jj ^ (r & 7)) << 4);
          if (p.gpair) {
#pragma unroll
            for (int e = 0; e < 8; e += 2) {
              const bool v = in && o + e < O;
              asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                           :: "r"(bf16t::smem_addr(dst + 2 * e)), "l"(v ? src + e : p.g),
                              "r"(v ? 4 : 0) : "memory");
            }
          } else {
            __align__(16) bf16 v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e)
              v[e] = in && o + e < O ? src[e] : __float2bfloat16(0.f);
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
          }
        }
        asm volatile("cp.async.wait_all;" ::: "memory");
        bf16t::fence_async_smem();
        __syncwarp();
        if (lane == 0) tma::mbar_arrive(full + s);
      }
    }
  } else if (warp >= 4) {  // the im2col tile of each stage
    const int it = threadIdx.x - 128;
    auto issue_x = [&](int i) {
      int b, y0, x0;
      tile_at(i, b, y0, x0);
      bf16* xb = xbuf + (i & 1) * (nb_xbuf_bytes(C) / 2);
      for (int pos = it; pos < kNbHalo; pos += 128) {
        const int py = y0 - 1 + pos / kNbHaloW, px = x0 - 1 + pos % kNbHaloW;
        const bool in = py >= 0 && py < p.H && px >= 0 && px < p.W;
        nb_load_pos<C>(xb + pos * C,
                       in ? p.x + (((size_t)b * p.H + py) * p.W + px) * C : p.x, in, p.xvec);
      }
    };
    if (nt > 0) issue_x(0);
    bf16t::commit();
    const int r = it, ty = r / kNbTW, tx = r % kNbTW;
    for (int i = 0; i < nt; ++i) {
      tma::bar_sync(2, 128);  // the buffer the next copies go to is read
      if (i + 1 < nt) issue_x(i + 1);
      bf16t::commit();
      bf16t::wait<1>();
      tma::bar_sync(2, 128);  // tile i's x has landed, every thread's copies
      const int s = i % kS;
      if (i >= kS) tma::mbar_wait(empty + s, (i / kS - 1) & 1);
      int b, y0, x0;
      tile_at(i, b, y0, x0);
      const bool valid = y0 + ty < p.H && x0 + tx < p.W;
      const bf16* xb = xbuf + (i & 1) * (nb_xbuf_bytes(C) / 2);
      unsigned char* as = ring + s * kStage;
      const int p0 = ty * kNbHaloW + tx;  // the tile pixel's first halo position
      if constexpr (C % 2 == 0) {
        // rows m = tap C + c in 32-bit pairs (c even): word c / 2 of the tap's
        // position, C / 2 words a position (one 4-, 8- or 16-byte load)
        uint32_t v[9][C / 2];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const uint32_t* src = reinterpret_cast<const uint32_t*>(
              xb + (p0 + (tap / 3) * kNbHaloW + tap % 3) * C);
          if constexpr (C == 2) {
            v[tap][0] = src[0];
          } else if constexpr (C == 4) {
            const uint2 u = *reinterpret_cast<const uint2*>(src);
            v[tap][0] = u.x;
            v[tap][1] = u.y;
          } else if constexpr (C == 8) {
            const uint4 u = *reinterpret_cast<const uint4*>(src);
            v[tap][0] = u.x;
            v[tap][1] = u.y;
            v[tap][2] = u.z;
            v[tap][3] = u.w;
          } else {
#pragma unroll
            for (int k = 0; k < C / 2; ++k) v[tap][k] = src[k];
          }
        }
#pragma unroll
        for (int mp = 0; mp < kMP; ++mp)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            uint32_t w[4];
#pragma unroll
            for (int e2 = 0; e2 < 4; ++e2) {
              const int m = 64 * mp + 8 * jj + 2 * e2;
              const uint32_t val = m < 9 * C ? v[m / C][(m % C) / 2]
                                             : (m == 9 * C && p.bias ? 0x3F80u : 0u);
              w[e2] = valid ? val : 0u;
            }
            *reinterpret_cast<uint4*>(as + mp * kNbPanel + r * 128 + ((jj ^ (r & 7)) << 4)) =
                make_uint4(w[0], w[1], w[2], w[3]);
          }
      } else {
        const unsigned short* xs = reinterpret_cast<const unsigned short*>(xb);
        unsigned short v[9][C];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
#pragma unroll
          for (int c = 0; c < C; ++c) v[tap][c] = xs[(p0 + (tap / 3) * kNbHaloW + tap % 3) * C + c];
#pragma unroll
        for (int mp = 0; mp < kMP; ++mp)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            uint32_t w[4];
#pragma unroll
            for (int e2 = 0; e2 < 4; ++e2) {
              uint32_t h2[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int m = 64 * mp + 8 * jj + 2 * e2 + e;
                h2[e] = m < 9 * C ? v[m / C][m % C] : (m == 9 * C && p.bias ? 0x3F80u : 0u);
              }
              w[e2] = valid ? h2[0] | (h2[1] << 16) : 0u;
            }
            *reinterpret_cast<uint4*>(as + mp * kNbPanel + r * 128 + ((jj ^ (r & 7)) << 4)) =
                make_uint4(w[0], w[1], w[2], w[3]);
          }
      }
      bf16t::fence_async_smem();
      __syncwarp();
      if (lane == 0) tma::mbar_arrive(full + s);
    }
  } else {  // the products: D (9 C [+ 1] x 64) += A (im2col^T) x B (g), K = pixels
    float acc[kMP][32];
#pragma unroll
    for (int mp = 0; mp < kMP; ++mp)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[mp][e] = 0.f;
    for (int i = 0; i < nt; ++i) {
      const int s = i % kS;
      tma::mbar_wait(full + s, (i / kS) & 1);
      const uint32_t st = tma::smem_u32(ring + s * kStage);
      // the stage's eight k16-steps summed on the tensor cores into tmp (the
      // first with scale-d 0), then one fp32 add; A and B both MN-major
      float tmp[kMP][32];
      bf16t::wg_fence();
#pragma unroll
      for (int ks = 0; ks < kNbPix / 16; ++ks)
#pragma unroll
        for (int mp = 0; mp < kMP; ++mp)
          bf16t::wg_mma_ss<1, 1>(tmp[mp], bf16t::wg_desc(st + mp * kNbPanel + ks * 2048),
                                 bf16t::wg_desc(st + kMP * kNbPanel + ks * 2048), ks > 0);
      bf16t::wg_commit();
      bf16t::wg_wait<0>();
      __syncwarp();
      if (lane == 0) tma::mbar_arrive(empty + s);
#pragma unroll
      for (int mp = 0; mp < kMP; ++mp)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[mp][e] += tmp[mp][e];
    }
    // D fragment: acc[4 j + e] at row 16 warp + g + 8 (e >> 1), column 8 j +
    // 2 t + (e & 1); row m < 9 C is dW[m / C, m % C], row 9 C dbias
    const int gq = lane / 4, tq = lane % 4;
    const size_t K = (size_t)9 * C * O + (p.bias ? O : 0);
    float* out = p.part + (size_t)run * K;
#pragma unroll
    for (int mp = 0; mp < kMP; ++mp)
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = 64 * mp + 16 * warp + gq + 8 * h, o = o0 + 8 * jn + 2 * tq;
          if (m > 9 * C || (m == 9 * C && !p.bias) || o >= O) continue;
          float* dst = out + (size_t)m * O + o;
          const float a = acc[mp][4 * jn + 2 * h], b2 = acc[mp][4 * jn + 2 * h + 1];
          if (p.pair) {
            *reinterpret_cast<float2*>(dst) = make_float2(a, b2);
          } else {
            dst[0] = a;
            if (o + 1 < O) dst[1] = b2;
          }
        }
  }
}

// The launch of the narrow bf16 wgrad: `rows` persistent blocks along the
// pixels (about one an SM over the 64-output panels), each a contiguous run
// of the tiles; the shared memory of C
struct PlanNb {
  int rows, n_op, tiles_x, tiles, smem;
};

void plan_narrow_bf16(int batch, int h, int wd, int c, int o, PlanNb& pl) {
  const int sms = bf16t::sm_count();
  pl.n_op = (o + 63) / 64;
  pl.tiles_x = (wd + kNbTW - 1) / kNbTW;
  pl.tiles = batch * ((h + kNbTH - 1) / kNbTH) * pl.tiles_x;
  const int per = sms / pl.n_op > 0 ? sms / pl.n_op : 1;
  pl.rows = pl.tiles < per ? pl.tiles : per;
  pl.smem = nb_smem(c);
}

template <int C>
cudaError_t launch_narrow_bf16(const CUtensorMap& map, const NarrowWb& p, const PlanNb& pl,
                               cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgrad_narrow_bf16_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, nb_smem(C));
  if (attr != cudaSuccess) return attr;
  wgrad_narrow_bf16_kernel<C><<<dim3(pl.rows, pl.n_op), kNbThreads, pl.smem, s>>>(map, p);
  return cudaGetLastError();
}

// mc_conv_wgrad_bf16's narrow route (C <= 8, 3 x 3, linear): the kernel, then
// the fixed-order reduce of its (rows, 9 C O [+ O]) partials into dwb
int narrow_wgrad_bf16(const bf16* x, const bf16* g, float* dwb, float* part, int batch, int h,
                      int wd, int c, int o, int bias, int rows, cudaStream_t s) {
  if (batch < 1 || h < 1 || wd < 1 || c < 1 || c > kNC || o < 1 || !dwb || !part)
    return (int)cudaErrorInvalidValue;
  PlanNb pl;
  plan_narrow_bf16(batch, h, wd, c, o, pl);
  if (rows != pl.rows) return (int)cudaErrorInvalidValue;
  const size_t k = (size_t)9 * c * o + (bias ? o : 0);
  const int tma = o % 8 == 0 && aligned(g, 16);
  NarrowWb p{x, g, part, batch, h, wd, o, bias, pl.tiles_x, pl.tiles, tma,
             (c == 2 || c == 4 || c == 8) && aligned(x, 16), o % 2 == 0 && aligned(g, 4),
             o % 2 == 0 && aligned(part, 8)};
  CUtensorMap map = {};
  if (tma) {
    const int rc = tma::encode_bf16_4d(&map, g, batch, h, wd, o, 64, kNbTW, kNbTH);
    if (rc) return rc;
  }
  cudaError_t err;
  switch (c) {
    case 1: err = launch_narrow_bf16<1>(map, p, pl, s); break;
    case 2: err = launch_narrow_bf16<2>(map, p, pl, s); break;
    case 3: err = launch_narrow_bf16<3>(map, p, pl, s); break;
    case 4: err = launch_narrow_bf16<4>(map, p, pl, s); break;
    case 5: err = launch_narrow_bf16<5>(map, p, pl, s); break;
    case 6: err = launch_narrow_bf16<6>(map, p, pl, s); break;
    case 7: err = launch_narrow_bf16<7>(map, p, pl, s); break;
    default: err = launch_narrow_bf16<8>(map, p, pl, s); break;
  }
  if (err != cudaSuccess) return (int)err;
  colsum_kernel<<<dim3((unsigned)((k + 31) / 32), 1), 32 * kSumGroups, 0, s>>>(part, dwb, rows,
                                                                             (int)k);
  return (int)cudaGetLastError();
}

// mc_conv_wgrad_bf16's launch: wgrad_narrow_bf16_kernel at c <= 8 (3 x 3,
// not up; linear only), else wgrad_bf16_kernel; rows = the plan's blocks
// along the pixels; then the fixed-order reduce of the (rows, taps c o [+ o])
// scratch.
int conv_wgrad_bf16(const bf16* x, const bf16* g, const float* gamma, const float* beta,
                    const float* sums, const float* sumsq, float* dwb, float* part, int batch,
                    int h, int wd, int c, int o, int groups, float eps, int act, int taps,
                    int up, int bias, int rows, void* stream) {
  if (wgrad_narrow(c, taps, up))
    return act ? (int)cudaErrorInvalidValue
               : narrow_wgrad_bf16(x, g, dwb, part, batch, h, wd, c, o, bias, rows,
                                   (cudaStream_t)stream);
  if (batch < 1 || h < 1 || wd < 1 || c < 1 || o < 1 ||
      (taps != 9 && taps != 1) || (up && (h % 2 || wd % 2 || taps != 9)) ||
      (act && (groups < 1 || c % groups || !gamma || !beta || !sums || !sumsq)) ||
      (taps == 1 && act) || !dwb || !part)
    return (int)cudaErrorInvalidValue;
  PlanW pl;
  if (!plan_wgrad_h(up, batch, h, wd, c, o, pl)) return (int)cudaErrorInvalidConfiguration;
  if (rows != pl.grid_x) return (int)cudaErrorInvalidValue;
  const size_t k = (size_t)taps * c * o + (bias ? o : 0);
  WgradH p{x, g, gamma, beta, sums, sumsq, part, batch, h, wd, c, o, groups, eps,
           act, taps, bias, c % 8 == 0 && aligned(x, 16), o % 8 == 0 && aligned(g, 16),
           o % 2 == 0 && aligned(part, 8) && k % 2 == 0,
           pl.tiles_y, pl.tiles_x, pl.g_bytes, pl.x_off, pl.x_bytes, pl.v_off, pl.red_off};
  const dim3 grid(pl.grid_x, pl.n_cb * pl.n_ob);
  const cudaStream_t s = (cudaStream_t)stream;
  if (up && pl.th == 16) wgrad_bf16_kernel<true, 16><<<grid, kWgThreads, pl.smem, s>>>(p);
  else if (up) wgrad_bf16_kernel<true, 8><<<grid, kWgThreads, pl.smem, s>>>(p);
  else if (pl.th == 16) wgrad_bf16_kernel<false, 16><<<grid, kWgThreads, pl.smem, s>>>(p);
  else wgrad_bf16_kernel<false, 8><<<grid, kWgThreads, pl.smem, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  colsum_kernel<<<dim3((unsigned)((k + 31) / 32), 1), 32 * kSumGroups, 0, s>>>(part, dwb, rows,
                                                                             (int)k);
  return (int)cudaGetLastError();
}

int gn_dx_bf16(const bf16* x, const void* da, const float* gamma, const float* dstats,
               const float* sums, const float* sumsq, bf16* dx, int batch, int n, int c,
               int groups, float eps, int da_fp32, void* stream) {
  if (batch < 1 || n < 1 || c < 1 || groups < 1 || c % groups || 4 * c * 4 > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const int vec = c % 8 == 0 && aligned(x, 16) && aligned(dx, 16) && aligned(da, 16);
  const long long items = (long long)n * (vec ? c / 8 : c);
  const long long per_block = (long long)kDxThreads * kDxItems;
  const dim3 grid((unsigned)((items + per_block - 1) / per_block), batch);
  const size_t smem = 4 * (size_t)c * sizeof(float);
  const cudaStream_t s = (cudaStream_t)stream;
  if (da_fp32)
    gn_dx_kernel<float><<<grid, kDxThreads, smem, s>>>(x, static_cast<const float*>(da), gamma,
                                                        dstats, sums, sumsq, dx, batch, n, c,
                                                        groups, eps, vec);
  else
    gn_dx_kernel<bf16><<<grid, kDxThreads, smem, s>>>(x, static_cast<const bf16*>(da), gamma,
                                                       dstats, sums, sumsq, dx, batch, n, c,
                                                       groups, eps, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int mc_conv_wgrad(const float* x, const float* g, const float* gamma,
                  const float* beta, const float* sums, const float* sumsq,
                  float* dwb, float* part, int batch, int h, int wd, int c, int o,
                  int groups, float eps, int act, int taps, int up, int bias,
                  int runs, void* stream) {
  return conv_wgrad(x, g, gamma, beta, sums, sumsq, dwb, part, batch, h, wd, c, o, groups,
                    eps, act, taps, up, bias, runs, stream);
}

// The bf16 wgrad: x and g bf16; the vectors, dwb and part fp32; part the
// (rows, taps c o [+ o]) scratch of mc_conv_bwd_bf16_plan(1, ...). At c <= 8
// (wgrad_narrow_bf16_kernel) it takes the linear mode only (act = 0).
int mc_conv_wgrad_bf16(const bf16* x, const bf16* g, const float* gamma, const float* beta,
                       const float* sums, const float* sumsq, float* dwb, float* part,
                       int batch, int h, int wd, int c, int o, int groups, float eps, int act,
                       int taps, int up, int bias, int rows, void* stream) {
  return conv_wgrad_bf16(x, g, gamma, beta, sums, sumsq, dwb, part, batch, h, wd, c, o,
                         groups, eps, act, taps, up, bias, rows, stream);
}

// The bf16 dgrad: g, w, x bf16; h, w the cotangent's (K3: the high
// resolution). mode 0: ds = conv3x3^T(g), out bf16 (B, h, w, c); 1: da = ds
// * silu'(a), out bf16, dstats (2, batch, c) = (dgamma, dbeta); 2 (K3): x
// low-res, the 2 x 2 fold of ds, then mode 1 at low resolution, out fp32
// (B, h / 2, w / 2, c), dstats. part: the (2, batch, rows, c) scratch of
// mc_conv_bwd_bf16_plan(0, ...).
int mc_conv_dgrad_bf16(const bf16* g, const bf16* w, const bf16* x, const float* gamma,
                       const float* beta, const float* sums, const float* sumsq, void* out,
                       float* dstats, float* part, int batch, int h, int wd, int c, int o,
                       int groups, float eps, int mode, void* stream) {
  return conv_dgrad_bf16(g, w, x, gamma, beta, sums, sumsq, out, dstats, part, batch, h, wd, c,
                         o, groups, eps, mode, stream);
}

// dgrad's fixed-order reduce of its (2, batch, rows, c) partials into
// dstats (2, batch, c), per_img its pixel tiles an image (for timing alone)
int mc_conv_dgrad_bf16_reduce(const float* part, float* dstats, int batch, int c, int rows,
                              int per_img, void* stream) {
  if (batch < 1 || c < 1 || rows < 1 || per_img < 1) return (int)cudaErrorInvalidValue;
  return dgrad_reduce(part, dstats, batch, c, rows, per_img, (cudaStream_t)stream);
}

// The plan of a bf16 backward call (which 0: dgrad, mode 1, or 2 with up;
// 1: wgrad with taps 9 or 1): out = {tile rows, weights resident, blocks,
// dynamic shared memory bytes, scratch rows}. The narrow-C wgrad (c <= 8)
// gives {0, 0, blocks, its shared memory, its blocks along the pixels}.
// Returns a cudaError_t.
int mc_conv_bwd_bf16_plan(int which, int up, int batch, int h, int wd, int c, int o, int taps,
                          int* out) {
  if (batch < 1 || h < 1 || wd < 1 || c < 1 || o < 1) return (int)cudaErrorInvalidValue;
  int vals[5];
  if (which == 0) {
    PlanD pl;
    if (!plan_dgrad_h(up ? kUpFold : kAct, batch, h, wd, c, o, pl))
      return (int)cudaErrorInvalidConfiguration;
    const int v[5] = {pl.th, pl.resident, pl.grid_x * pl.nb, pl.smem, pl.grid_x};
    for (int i = 0; i < 5; ++i) vals[i] = v[i];
  } else if (wgrad_narrow(c, taps, up)) {
    PlanNb pl;
    plan_narrow_bf16(batch, h, wd, c, o, pl);
    const int v[5] = {0, 0, pl.rows * pl.n_op, pl.smem, pl.rows};
    for (int i = 0; i < 5; ++i) vals[i] = v[i];
  } else {
    PlanW pl;
    if (!plan_wgrad_h(up, batch, h, wd, c, o, pl)) return (int)cudaErrorInvalidConfiguration;
    const int v[5] = {pl.th, 0, pl.grid_x * pl.n_cb * pl.n_ob, pl.smem, pl.grid_x};
    for (int i = 0; i < 5; ++i) vals[i] = v[i];
  }
  for (int i = 0; i < 5; ++i) out[i] = vals[i];
  return (int)cudaSuccess;
}

// The dx pass of the bf16 backward: x bf16 (B, n, c), da bf16 or, with
// da_fp32, fp32 of x's shape, dstats (2, B, c) = (dgamma, dbeta), the
// forward's sums; dx bf16.
int mc_gn_dx_bf16(const bf16* x, const void* da, const float* gamma, const float* dstats,
                  const float* sums, const float* sumsq, bf16* dx, int batch, int n, int c,
                  int groups, float eps, int da_fp32, void* stream) {
  return gn_dx_bf16(x, da, gamma, dstats, sums, sumsq, dx, batch, n, c, groups, eps, da_fp32,
                    stream);
}


// out[s, k] = sum over i < n of part[s, i, k] for s < slices, in a fixed
// order (the reduce the entry points above launch after their kernels),
// for timing it alone
int mc_colsum(const float* part, float* out, int n, int k, int slices, void* stream) {
  if (n < 1 || k < 1 || slices < 1) return (int)cudaErrorInvalidValue;
  colsum_kernel<<<dim3((unsigned)((k + 31) / 32), slices), 32 * kSumGroups, 0,
                  (cudaStream_t)stream>>>(part, out, n, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
