// K2 and K3: GroupNorm (+FiLM) + SiLU + 3x3 SAME conv, with the ADM
// residual-block tail fused into the epilogue. NHWC fp32 in and out.
//
//   K2  out = conv3x3(silu(gn(x) * gamma + beta)) + bias [+ residual]
//   K3  out = conv3x3(upsample2x_nearest(silu(gn(x) * gamma + beta))) + bias
//
// Replaces m_cedm_tpu/pallas/fused_norm_conv.py::_gnsc_kernel (K2; paired
// twin _pallas_gnsc_paired) and ::_gnsc_up_kernel (K3; paired twin
// _gnsc_up_pair_kernel). Options of the TPU kernel carried over: identity
// residual, identity_up (nearest-upsampled low-res residual), proj (1x1
// projection of the residual plus its bias), per-(B, O) sum and sum of
// squares of the fp32 result (emit_stats), chained input statistics, and the
// linear mode act=0 (a plain conv3x3: the down blocks' conv0; conv_in and
// the out conv, with C <= 8 or O <= 8, go to csrc/narrow_conv.cu).
//
// Bound. At the flagship shape (16 x 128 x 128, 64 -> 64 channels) one call
// is 19.3 GFLOP against about 0.2 GB of activations moved (0.06 ms at 3.35
// TB/s), about 150 FLOP per byte: arithmetic sets the time. In fp32 on the
// CUDA cores (67 TFLOP/s) that is 0.288 ms. On the tensor cores in 3xTF32
// (three TF32 products per fp32 product at 495 TFLOP/s) it is 0.117 ms, still
// set by the operations; the down blocks' conv0 (16 x 64 x 64) is a quarter
// of that.
//
// 3xTF32 (as csrc/fused_attention.cu and csrc/linear_attention.cu, whose
// helpers are copied below). Every product runs on mma.sync.m16n8k8 in TF32
// with fp32 accumulation, each fp32 operand split as hi = tf32(x), lo =
// tf32(x - hi) (cvt.rn, one instruction on sm_90) and the product summed as
// lo*hi + hi*lo + hi*hi, small terms first: fp32 accuracy (the dropped lo*lo
// term is 2^-22 of the product). One TF32 pass would be about 3e-4 of scale
// off, fifteen times the 2e-5 bound (tests/test_torch_tf32_split.py).
//
// The implicit GEMM: M = the block's pixels, N = 64 output channels, K = 9
// taps x C input channels (576, or 1,152 for the decoder's concat conv0),
// then Cr more for the 1x1 projection skip, which runs on the same core, in
// the same arithmetic, into the same accumulators (as a one-tap conv on the
// tile's own pixels).
//
// Tile. A block of 8 warps owns an 8 x 16 pixel tile of one image and 64
// output channels; a warp owns two tile rows (two m16 tiles of 16 pixels)
// and 32 channels (four n8 tiles), so each split B fragment feeds two
// m-tiles and each split A fragment four n-tiles. 8 x 16 keeps enough blocks
// in flight at the small resolutions (128 at res 32, B = 16, for 132 SMs),
// and two blocks fit an SM (111 KB of shared memory and at most 128
// registers a thread each), so one block's staging pass overlaps the
// other's products. A larger tile would amortise the weight split over more
// pixels but leave res 32 with 64 blocks, and one block an SM. Measured
// against this (kernels/attention_sources.py on sources this file no longer
// holds; PERF.md section 6): one block an SM without spills
// was 18 % slower; warp specialisation (4, 6 or 8 producer warps copying
// and staging into double-buffered planes for 8 consumer warps, named
// barriers, one block an SM, a two- or four-stage ring) 13-36 % slower.
// The ceiling: TF32 mma.sync ran at most 324 TFLOP/s on the H100 (0.84 ns a
// product per SM; kernels/attention_sources.py --kernel mma), so the res-128
// tail's 28.3 million products alone take 0.18 ms; by diagnostic variants
// the kernel's 0.58 ms split into about 0.31 ms of products, 0.11 of the
// staging pass and 0.16 of copies, barriers and epilogue.
//
// Staging. The input channels stream 8 at a time (one k-step of the mma):
// the raw halo'd 10 x 18 x 8 input tile (for K3 the 6 x 10 low-res tile
// under it) and the raw 9 x 8 x 64 weight chunk are fetched by cp.async
// into a two-stage ring, so that the next chunk arrives while this one is
// multiplied. Then one pass over shared memory applies the GroupNorm affine
// and the SiLU (the activation cannot ride on the copy), writes zeros for
// positions outside the image AFTER the activation (SAME padding pads the
// activated tensor), and splits each operand once into hi/lo TF32 planes:
// an activated input element feeds 9 taps x 4 n-tiles of each warp that
// reads it, a weight element every pixel of the block, so neither is split
// again per fragment. The planes are stored in fragment order, so a
// fragment is one 16-byte load: an input position holds 16 floats, thread t
// of a quad finding (hi c_t, hi c_t+4, lo c_t, lo c_t+4) at 4t (a quarter
// warp's 16-byte loads cover two positions = 32 distinct banks); the
// weights hold, for each (tap, n-tile, lane), (hi b0, hi b1, lo b0, lo b1)
// (a warp reads 512 contiguous bytes). The raw stages are padded so that
// the split pass reads them without bank conflicts: 12 floats a position
// (eight positions' strides fall on distinct bank quads), 72 floats a
// weight row (8 mod 32).
// For K3 the tile is addressed at high resolution and each position reads
// low-res pixel (Y/2, X/2), so the 4x upsampled activation never reaches
// device memory; its group statistics are those of the low-res x, which
// nearest upsampling preserves. The GroupNorm statistics come in as per-(B,
// C) sums: chained from the producer's emit_stats, or from K1's pass 1.
//
// Accumulation. kTempSteps k-steps (taps) of the three products go into a
// zeroed fragment, which is then added to the fp32 accumulator, so the
// tensor cores' own additions, which do not round as fp32 does, stay short.
// kTempSteps = 9 (a chunk's nine taps on the tensor cores per fp32 add):
// 3.1-9.5e-7 of scale from float64 at the flagship's shapes on the H100,
// against 2.1-4.8e-7 a tap a partial, which was 11-13 % slower, and 5.9e-7 to
// 1.6e-6 for the fp32 CUDA-core kernel it replaced (PERF.md section 6). The
// taps run in a rolled loop: unrolled, ptxas hoisted the next taps'
// fragments past the 128-register cap and spilled 184 bytes (rolled, 132;
// 2-4 % faster).
//
// Epilogue: bias, residual and stores straight from the accumulator
// fragments, 8 bytes a thread (two adjacent channels of one pixel; a quad
// writes 32 contiguous bytes). Emitted statistics are reduced over the
// block (quad shuffles, then the four row pairs in a fixed order in shared
// memory) and added with fp32 atomicAdd, one per channel per block, so their
// summation order changes from run to run.
//
// Next: wgmma and TMA. TF32 wgmma wants both operands K-major in shared
// memory in its swizzled layout, and the tap shifts of an implicit conv move
// the A rows by one pixel per tap, so each tap would need its own swizzled
// copy of the tile, or an im2col stage. The backward kernels
// (csrc/fused_norm_conv_bwd.cu) run their products on the same 3xTF32
// mma.sync core, and so do both convs and the projection of K7
// (csrc/fused_block.cu, which carries its own copy of this core's helpers).
//
// bf16 (gnsc_bf16_kernel<kUp, kTH>, beside the fp32 kernel, whose code it
// leaves as it was). The Pallas kernel on a bf16 network (fused_norm_conv.py
// _gnsc_kernel): GroupNorm and SiLU in fp32, the activation rounded to bf16
// before the product, bf16 weights, fp32 accumulation; bias, residual and
// the 1x1 projection (bf16 operands) into the fp32 accumulator; emitted
// statistics from that fp32 accumulator; one rounding of the output to bf16
// at the store. Bound at the flagship's res-128 identity tail: 19.3 GFLOP at
// 989 TFLOP/s (0.020 ms) against 100.7 MB of bf16 activations (0.030 ms):
// bytes.
//
// The layout and the copy and product helpers are in bf16_conv_tiles.cuh.
// Persistent blocks, one wave (one block an SM, up to 227 KB of shared
// memory), each walking a contiguous run of the pixel tiles of one
// 64-output block, image by image; warp w owns tile row w (16 pixels x 64
// outputs), four rows a warpgroup.
// - Products: wgmma m64n64k16 (bf16 in, fp32 out), A from registers, B
//   from shared memory by descriptor. Each warp loads its A fragment (16
//   pixels x 16 channels) by ldmatrix with one row address a lane, double
//   buffered: a tap is another row, and K3 keeps the low-res plane (10 x 10
//   positions under a 16 x 16 output tile) with each lane pointing at pixel
//   (y / 2, x / 2). mma.sync m16n8k16 with B by ldmatrix .trans from the
//   same rows was measured first on the same layout: 0.110 ms at the
//   res-128 tail against 0.100 (kernels/attention_sources.py --kernel
//   k2bf16 on a source this file no longer holds, NVIDIA H100 80GB HBM3,
//   700.00 W), its products alone about 0.049 ms against 0.024:
//   ldmatrix's 256 bytes of shared memory a product against wgmma's 32.
// - Weights: the O-block's 9 x C x 64 conv weights (and the projection's
//   Cr x 64) are copied into shared memory ONCE per block, raw rows 16 bytes
//   a cp.async, into XOR-swizzled 128-byte rows, which is wgmma's 128-byte
//   swizzle: no repack pass. Weight bytes one call reads from L2 at the
//   res-128 identity tail (B = 16): 132 blocks x 73.7 KB = 9.7 MB, where each
//   of the 2,048 blocks of 8 x 16 pixels re-staged them (151 MB, and 9,216
//   scalar repack entries a block). Where they do not fit (C > 128, or
//   C = 128 with a projection) they stream a chunk a step through two
//   slots, still raw.
// - A: the tile's input as [position][channel] rows of 64 channels (144
//   bytes with padding). A step stages one 64-channel chunk (C = 64: the
//   whole input, where 16-channel chunks took four barrier rounds), 16 bytes
//   a cp.async, into a two-stage ring: step s + 1's copies are issued
//   before step s's products. The activation pass (GroupNorm and SiLU in
//   fp32, rounded once to bf16) works in place, 16 bytes (8 channels) a
//   thread-item, on the items the thread copied itself, so it starts as soon
//   as its own copies land: one block barrier a step.
// - Tile: 16 x 16 pixels and 16 warps (halo 18 x 18, each input byte
//   fetched 1.27 times) where that gives kBigTileWaves tiles a block or
//   more and its resident layout fits (res 128 and 64 at B = 16), else
//   8 x 16 pixels and 8 warps (1.41 times; res 32, and the 128-channel
//   input, whose 147 KB of weights leave no room for 16 x 16 stages).
//   Measured (attention_sources --kernel k2bf16, NVIDIA H100 80GB HBM3,
//   700.00 W): 8 x 16 everywhere 0.120 ms at the res-128 tail against
//   0.088; 8 x 16 at res 64 0.034 against 0.028; and, on a source this file
//   no longer holds, two independent 8 x 16 pipelines a block sharing the
//   weights (16 warps, named barriers) 0.095 against 0.088: the halo cost
//   more than the pipelines' overlap gave.
// - Epilogue, warp by warp as its products end: bias, residual (copied by
//   the warp into its own staging rows, 16 bytes a cp.async) and skip bias
//   added in fp32 to the accumulators, the statistics from those fp32
//   values (summed in registers over the block's tiles of one image, then
//   one atomicAdd a channel), one rounding to bf16 into the staging rows,
//   then 16-byte stores of whole pixel rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_conv_tiles.cuh"

namespace {

constexpr int kTH = 8;           // output rows per block
constexpr int kTW = 16;          // output columns per block: one m16 tile a row
constexpr int kBO = 64;          // output channels per block
constexpr int kCK = 8;           // input channels per chunk: one k-step
constexpr int kWarps = 8;        // 4 row pairs x 2 channel halves
constexpr int kThreads = 32 * kWarps;
constexpr int kIH = kTH + 2;     // halo'd tile rows
constexpr int kIW = kTW + 2;     // halo'd tile columns
constexpr int kPos = kIH * kIW;  // halo'd tile positions
constexpr int kLH = kTH / 2 + 2, kLW = kTW / 2 + 2;  // K3's low-res tile
constexpr int kXS = 12;          // raw input floats a position (8 used)
constexpr int kWS = kBO + 8;     // raw weight row stride, 8 mod 32
constexpr int kMaxC = 512;
constexpr int kTempSteps = 9;    // k-steps summed on the tensor cores per fp32 add

// shared memory, in floats
constexpr int kRawX = kPos * kXS;         // one raw input stage
constexpr int kRawW = 9 * kCK * kWS;      // one raw weight stage
constexpr int kSplitA = kPos * 16;        // the split input plane, fragment order
constexpr int kSplitB = 9 * 8 * 32 * 4;   // the split weight plane, fragment order
constexpr int kSmemFloats = 2 * (kRawX + kRawW) + kSplitA + kSplitB + 2 * kMaxC;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

enum ResMode { kResNone = 0, kResIdentity = 1, kResIdentityUp = 2, kResProj = 3 };

struct Args {
  const float* x;       // (B, Hin, Win, C): Hin = H (K2) or H / 2 (K3)
  const float* w;       // (3, 3, C, O)
  const float* bias;    // (O,) or null
  const float* gamma;   // (B, C) folded scale, unused when act == 0
  const float* beta;    // (B, C) folded shift
  const float* sums;    // (B, C) channel sums of x
  const float* sumsq;   // (B, C) channel sums of x^2
  const float* res;     // residual: (B, H, W, O) identity, (B, H/2, W/2, O)
                        // identity_up, (B, H, W, Cr) proj
  const float* skip_w;  // (Cr, O) proj weight
  const float* skip_b;  // (O,) proj bias or null
  float* out;           // (B, H, W, O)
  float* osums;         // (B, O) zeroed, or null: no stats emitted
  float* osumsq;
  int H, W, C, O, Cr, groups;
  float eps;
  int act, res_mode;
  int xvec, wvec, rvec, svec, pair;  // 16-byte copies of x / w / res / skip_w; 8-byte stores
};

__device__ __forceinline__ float silu(float y) { return y / (1.f + expf(-y)); }

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
// staging (thread tid of the block's kThreads)
// ---------------------------------------------------------------------------

// Chunk q of the K loop into one raw stage: q < nc is input channels 8q ..
// 8q + 7 of the conv (the halo'd tile, or K3's low-res tile, and the nine
// taps' weights); q >= nc is residual channels 8(q - nc) .. of the 1x1
// projection (the tile's own pixels, and the skip weight's rows). Zero-filled
// past the image, C (or Cr) and O; no bytes are read there.
template <bool kUp>
__device__ __forceinline__ void load_chunk(const Args& p, int q, int nc, float* rx,
                                           float* rw, int b, int ty0, int tx0, int o0,
                                           int tid) {
  const int O = p.O;
  if (q < nc) {
    const int c0 = q * kCK, C = p.C;
    const int hin = kUp ? p.H / 2 : p.H, win = kUp ? p.W / 2 : p.W;
    const int cols = kUp ? kLW : kIW, npos = kUp ? kLH * kLW : kPos;
    const int y0 = kUp ? ty0 / 2 - 1 : ty0 - 1, x0 = kUp ? tx0 / 2 - 1 : tx0 - 1;
    const float* xb = p.x + (size_t)b * hin * win * C;
    if (p.xvec) {
      for (int idx = tid; idx < npos * 2; idx += kThreads) {
        const int h = idx & 1, pos = idx >> 1;
        const int y = y0 + pos / cols, x = x0 + pos % cols, c = c0 + 4 * h;
        const bool valid = y >= 0 && y < hin && x >= 0 && x < win && c < C;
        cp_async16(rx + pos * kXS + 4 * h,
                   valid ? xb + ((size_t)y * win + x) * C + c : p.x, valid);
      }
    } else {
      for (int idx = tid; idx < npos * kCK; idx += kThreads) {
        const int ck = idx % kCK, pos = idx / kCK;
        const int y = y0 + pos / cols, x = x0 + pos % cols, c = c0 + ck;
        const bool valid = y >= 0 && y < hin && x >= 0 && x < win && c < C;
        cp_async4(rx + pos * kXS + ck,
                  valid ? xb + ((size_t)y * win + x) * C + c : p.x, valid);
      }
    }
    if (p.wvec) {
      for (int idx = tid; idx < 9 * kCK * (kBO / 4); idx += kThreads) {
        const int o4 = idx % (kBO / 4), row = idx / (kBO / 4);  // row = tap * kCK + ck
        const int tap = row / kCK, c = c0 + row % kCK, o = o0 + 4 * o4;
        const bool valid = c < C && o < O;
        cp_async16(rw + row * kWS + 4 * o4,
                   valid ? p.w + ((size_t)tap * C + c) * O + o : p.w, valid);
      }
    } else {
      for (int idx = tid; idx < 9 * kCK * kBO; idx += kThreads) {
        const int oo = idx % kBO, row = idx / kBO;
        const int tap = row / kCK, c = c0 + row % kCK, o = o0 + oo;
        const bool valid = c < C && o < O;
        cp_async4(rw + row * kWS + oo,
                  valid ? p.w + ((size_t)tap * C + c) * O + o : p.w, valid);
      }
    }
  } else {
    const int c0 = (q - nc) * kCK, Cr = p.Cr;
    const float* rb = p.res + (size_t)b * p.H * p.W * Cr;
    if (p.rvec) {
      for (int idx = tid; idx < kTH * kTW * 2; idx += kThreads) {
        const int h = idx & 1, pos = idx >> 1;
        const int y = ty0 + pos / kTW, x = tx0 + pos % kTW, c = c0 + 4 * h;
        const bool valid = y < p.H && x < p.W && c < Cr;
        cp_async16(rx + pos * kXS + 4 * h,
                   valid ? rb + ((size_t)y * p.W + x) * Cr + c : p.res, valid);
      }
    } else {
      for (int idx = tid; idx < kTH * kTW * kCK; idx += kThreads) {
        const int ck = idx % kCK, pos = idx / kCK;
        const int y = ty0 + pos / kTW, x = tx0 + pos % kTW, c = c0 + ck;
        const bool valid = y < p.H && x < p.W && c < Cr;
        cp_async4(rx + pos * kXS + ck,
                  valid ? rb + ((size_t)y * p.W + x) * Cr + c : p.res, valid);
      }
    }
    if (p.svec) {
      for (int idx = tid; idx < kCK * (kBO / 4); idx += kThreads) {
        const int o4 = idx % (kBO / 4), ck = idx / (kBO / 4);
        const int c = c0 + ck, o = o0 + 4 * o4;
        const bool valid = c < Cr && o < O;
        cp_async16(rw + ck * kWS + 4 * o4,
                   valid ? p.skip_w + (size_t)c * O + o : p.skip_w, valid);
      }
    } else {
      for (int idx = tid; idx < kCK * kBO; idx += kThreads) {
        const int oo = idx % kBO, ck = idx / kBO;
        const int c = c0 + ck, o = o0 + oo;
        const bool valid = c < Cr && o < O;
        cp_async4(rw + ck * kWS + oo,
                  valid ? p.skip_w + (size_t)c * O + o : p.skip_w, valid);
      }
    }
  }
}

__device__ __forceinline__ void store_split(float* dst, float v0, float v1) {
  uint32_t h0, l0, h1, l1;
  split(v0, h0, l0);
  split(v1, h1, l1);
  *reinterpret_cast<uint4*>(dst) = make_uint4(h0, h1, l0, l1);
}

// The conv chunk's input plane: (thread t of a position) channels c0 + t and
// c0 + t + 4, activated, zero outside the image and past C, split.
template <bool kUp>
__device__ __forceinline__ void split_x(const Args& p, const float* rx, float* sa,
                                        int c0, int ty0, int tx0, const float* s_a,
                                        const float* s_b, int tid) {
  for (int idx = tid; idx < kPos * 4; idx += kThreads) {
    const int t = idx & 3, pos = idx >> 2;
    const int y = ty0 - 1 + pos / kIW, x = tx0 - 1 + pos % kIW;
    float v0 = 0.f, v1 = 0.f;  // SAME zero padding of the ACTIVATED tensor
    if (y >= 0 && y < p.H && x >= 0 && x < p.W) {
      const int rpos = kUp ? ((y >> 1) - (ty0 / 2 - 1)) * kLW + (x >> 1) - (tx0 / 2 - 1)
                           : pos;
      v0 = rx[rpos * kXS + t];
      v1 = rx[rpos * kXS + t + 4];
      if (p.act) {
        const int ca = c0 + t, cb = ca + 4;
        v0 = ca < p.C ? silu(v0 * s_a[ca] + s_b[ca]) : 0.f;
        v1 = cb < p.C ? silu(v1 * s_a[cb] + s_b[cb]) : 0.f;
      }
    }
    store_split(sa + pos * 16 + 4 * t, v0, v1);
  }
}

// The projection chunk's plane: the tile's own pixels at the centre tap's
// positions (the halo is not read by a one-tap chunk).
__device__ __forceinline__ void split_r(const float* rx, float* sa, int tid) {
  for (int idx = tid; idx < kTH * kTW * 4; idx += kThreads) {
    const int t = idx & 3, pos = idx >> 2;
    const int spos = (pos / kTW + 1) * kIW + pos % kTW + 1;
    store_split(sa + spos * 16 + 4 * t, rx[pos * kXS + t], rx[pos * kXS + t + 4]);
  }
}

// Weights of kTaps taps in B-fragment order: (tap, n-tile, lane) holds
// (hi, lo) of b0 = w[k = t][n = g] and b1 = w[k = t + 4][n = g].
template <int kTaps>
__device__ __forceinline__ void split_w(const float* rw, float* sb, int tid) {
  for (int idx = tid; idx < kTaps * 8 * 32; idx += kThreads) {
    const int lane = idx & 31, nt = (idx >> 5) & 7, tap = idx >> 8;
    const int g = lane >> 2, t = lane & 3;
    const float* r = rw + (tap * kCK + t) * kWS + 8 * nt + g;
    store_split(sb + 4 * idx, r[0], r[4 * kWS]);
  }
}


// ---------------------------------------------------------------------------
// the products
// ---------------------------------------------------------------------------

// One chunk's k-steps (nine taps, or the projection's one at the centre) on
// the warp's two m-tiles x four n-tiles: kTempSteps taps into a zeroed
// fragment, then one fp32 add into acc.
template <int kTaps>
__device__ __forceinline__ void mma_chunk(const float* sa, const float* sb,
                                          float (&acc)[2][4][4], int rg, int cq,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s0 = 0; s0 < kTaps; s0 += kTempSteps) {
    float part[2][4][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[m][j][e] = 0.f;
    // rolled: unrolled, ptxas hoists later taps' fragments and spills more
#pragma unroll 1
    for (int s = s0; s < s0 + kTempSteps && s < kTaps; ++s) {
      const int tap = kTaps == 1 ? 4 : s;
      const int dy = tap / 3, dx = tap % 3;
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
            sb + (((kTaps == 1 ? 0 : s) * 8 + 4 * cq + j) * 32 + lane) * 4);
        bh[j][0] = __float_as_uint(f.x);
        bh[j][1] = __float_as_uint(f.y);
        bl[j][0] = __float_as_uint(f.z);
        bl[j][1] = __float_as_uint(f.w);
      }
      // the three products, each over all eight (m, j) tiles in turn, so
      // that no product waits on the one before it in the same tile
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

template <bool kUp>
__global__ void __launch_bounds__(kThreads, 2) gnsc_kernel(const Args p) {
  extern __shared__ __align__(16) float smem[];
  float* rx = smem;              // [2][kRawX] raw input (or residual) stages
  float* rw = rx + 2 * kRawX;    // [2][kRawW] raw weight stages
  float* sa = rw + 2 * kRawW;    // the split input plane
  float* sb = sa + kSplitA;      // the split weight plane
  float* s_a = sb + kSplitB;     // [kMaxC] folded per-channel scale
  float* s_b = s_a + kMaxC;      // and shift

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int tiles_w = (p.W + kTW - 1) / kTW;
  const int ty0 = (blockIdx.x / tiles_w) * kTH;
  const int tx0 = (blockIdx.x % tiles_w) * kTW;
  const int o0 = blockIdx.z * kBO;
  const int C = p.C, O = p.O;
  const int nc = (C + kCK - 1) / kCK;
  const int nq = nc + (p.res_mode == kResProj ? (p.Cr + kCK - 1) / kCK : 0);

  load_chunk<kUp>(p, 0, nc, rx, rw, b, ty0, tx0, o0, tid);
  cp_commit();

  if (p.act) {
    // fold the group statistics into one scale/shift per input channel
    const int hin = kUp ? p.H / 2 : p.H, win = kUp ? p.W / 2 : p.W;
    const int per = C / p.groups;
    const float cnt = (float)hin * (float)win * (float)per;
    for (int ch = tid; ch < C; ch += kThreads) {
      const int g0 = (ch / per) * per;
      float s = 0.f, ss = 0.f;
      for (int k = 0; k < per; ++k) {
        s += p.sums[b * C + g0 + k];
        ss += p.sumsq[b * C + g0 + k];
      }
      const float mean = s / cnt;
      const float var = fmaxf(ss / cnt - mean * mean, 0.f);
      const float a = p.gamma[b * C + ch] * rsqrtf(var + p.eps);
      s_a[ch] = a;
      s_b[ch] = p.beta[b * C + ch] - a * mean;
    }
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int rg = warp & 3, cq = warp >> 2;  // row pair, channel half
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
      load_chunk<kUp>(p, q + 1, nc, rx + (st ^ 1) * kRawX, rw + (st ^ 1) * kRawW, b,
                      ty0, tx0, o0, tid);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // chunk q has landed; every warp is done with q - 1's planes
    if (q < nc) {
      split_x<kUp>(p, rx + st * kRawX, sa, q * kCK, ty0, tx0, s_a, s_b, tid);
      split_w<9>(rw + st * kRawW, sb, tid);
    } else {
      split_r(rx + st * kRawX, sa, tid);
      split_w<1>(rw + st * kRawW, sb, tid);
    }
    __syncthreads();
    if (q < nc)
      mma_chunk<9>(sa, sb, acc, rg, cq, lane);
    else
      mma_chunk<1>(sa, sb, acc, rg, cq, lane);
  }
  cp_wait<0>();

  // epilogue: C fragment (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
  // = pixels tx0 + g (+ 8) of row 2 rg + m, channels 32 cq + 8 j + 2t (+ 1)
  const int g = lane >> 2, t = lane & 3;
  float ps[4][2], pss[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) ps[j][0] = ps[j][1] = pss[j][0] = pss[j][1] = 0.f;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int y = ty0 + 2 * rg + m;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = tx0 + g + 8 * h;
      if (y >= p.H || x >= p.W) continue;
      const size_t pix = ((size_t)b * p.H + y) * p.W + x;
      const float* rrow = nullptr;
      if (p.res_mode == kResIdentity) rrow = p.res + pix * O;
      if (p.res_mode == kResIdentityUp)
        rrow = p.res + (((size_t)b * (p.H / 2) + y / 2) * (p.W / 2) + x / 2) * O;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = o0 + 32 * cq + 8 * j + 2 * t;
        if (o >= O) continue;
        const bool two = o + 1 < O;
        float v0 = acc[m][j][2 * h], v1 = acc[m][j][2 * h + 1];
        if (p.bias) {
          v0 += p.bias[o];
          if (two) v1 += p.bias[o + 1];
        }
        if (rrow) {
          if (p.pair) {
            const float2 r = *reinterpret_cast<const float2*>(rrow + o);
            v0 += r.x;
            v1 += r.y;
          } else {
            v0 += rrow[o];
            if (two) v1 += rrow[o + 1];
          }
        }
        if (p.res_mode == kResProj && p.skip_b) {
          v0 += p.skip_b[o];
          if (two) v1 += p.skip_b[o + 1];
        }
        if (p.pair) {
          *reinterpret_cast<float2*>(p.out + pix * O + o) = make_float2(v0, v1);
        } else {
          p.out[pix * O + o] = v0;
          if (two) p.out[pix * O + o + 1] = v1;
        }
        ps[j][0] += v0;
        pss[j][0] += v0 * v0;
        if (two) {
          ps[j][1] += v1;
          pss[j][1] += v1 * v1;
        }
      }
    }
  }

  if (p.osums) {
    // the warp's 32 pixels: sum over g (lane bits 2-4), then the four row
    // pairs in a fixed order
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int sh = 4; sh < 32; sh <<= 1) {
          ps[j][k] += __shfl_xor_sync(0xffffffffu, ps[j][k], sh);
          pss[j][k] += __shfl_xor_sync(0xffffffffu, pss[j][k], sh);
        }
    __syncthreads();  // every warp is done reading the planes: reuse them
    float* red_s = sa;
    float* red_ss = sa + 4 * kBO;
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          red_s[rg * kBO + 32 * cq + 8 * j + 2 * t + k] = ps[j][k];
          red_ss[rg * kBO + 32 * cq + 8 * j + 2 * t + k] = pss[j][k];
        }
    }
    __syncthreads();
    if (tid < kBO && o0 + tid < O) {
      float s = 0.f, ss = 0.f;
      for (int r = 0; r < 4; ++r) {
        s += red_s[r * kBO + tid];
        ss += red_ss[r * kBO + tid];
      }
      atomicAdd(&p.osums[b * O + o0 + tid], s);
      atomicAdd(&p.osumsq[b * O + o0 + tid], ss);
    }
  }
}

bool aligned(const void* ptr, int bytes) {
  return ((uintptr_t)ptr & (uintptr_t)(bytes - 1)) == 0;
}

template <bool kUp>
int launch(const float* x, const float* w, const float* bias, const float* gamma,
           const float* beta, const float* sums, const float* sumsq,
           const float* res, const float* skip_w, const float* skip_b, float* out,
           float* osums, float* osumsq, int batch, int h, int wd, int c, int o,
           int cr, int groups, float eps, int act, int res_mode, void* stream) {
  if (c < 1 || o < 1 || c > kMaxC || (act && (groups < 1 || c % groups)))
    return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory a kernel must opt in, once per
  // process
  static cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(gnsc_kernel<kUp>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
    return e;
  }();
  if (attr != cudaSuccess) return (int)attr;
  const bool pair = o % 2 == 0 && aligned(out, 8) &&
                    (res_mode == kResProj || !res || aligned(res, 8));
  Args p{x, w, bias, gamma, beta, sums, sumsq, res, skip_w, skip_b, out,
         osums, osumsq, h, wd, c, o, cr, groups, eps, act, res_mode,
         c % 4 == 0 && aligned(x, 16), o % 4 == 0 && aligned(w, 16),
         cr % 4 == 0 && aligned(res, 16), o % 4 == 0 && aligned(skip_w, 16),
         (int)pair};
  dim3 grid(((h + kTH - 1) / kTH) * ((wd + kTW - 1) / kTW), batch,
            (o + kBO - 1) / kBO);
  gnsc_kernel<kUp><<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------

using bf16t::bf16;

constexpr int kCH = bf16t::kRowCh;  // channels a chunk: one A row, four k16 steps
constexpr int kBigTileWaves = 1;    // 16 x 16 tiles when they give this many a block
constexpr int kSmemCapH = 232448;   // dynamic shared memory a block may take on the H100
constexpr int kConvWRows = 9 * kCH;  // weight rows of one conv chunk (tap, channel)

// warps of a block for tiles of th rows: one tile row (16 pixels) x 64
// outputs a warp, four tile rows a warpgroup
__host__ __device__ constexpr int warps_bf16(int th) { return th; }

// rows (positions) of one A stage: the halo'd tile, or K3's low-res tile
// under it; a projection chunk takes the first th * 16 (the tile's pixels)
__host__ __device__ constexpr int a_positions(bool up, int th) {
  return up ? (th / 2 + 2) * (kTW / 2 + 2) : (th + 2) * (kTW + 2);
}

struct ArgsH {
  const bf16* x;        // (B, Hin, Win, C): Hin = H (K2) or H / 2 (K3)
  const bf16* w;        // (3, 3, C, O)
  const float* bias;    // (O,) or null
  const float* gamma;   // (B, C) folded scale, unused when act == 0
  const float* beta;    // (B, C)
  const float* sums;    // (B, C) channel sums of x (fp32)
  const float* sumsq;
  const bf16* res;      // as Args::res
  const bf16* skip_w;   // (Cr, O)
  const float* skip_b;  // (O,) or null
  bf16* out;            // (B, H, W, O)
  float* osums;         // (B, O) zeroed, or null
  float* osumsq;
  int B, H, W, C, O, Cr, groups;
  float eps;
  int act, res_mode;
  // 16-byte copies of x / w / the identity residual / the projected
  // residual / skip_w, and 16-byte output stores
  int xvec, wvec, idvec, rvec, svec, ovec;
  // the plan (plan_bf16): weights resident for the whole call (else streamed
  // a chunk a step), conv and all chunks, tiles per image, byte offsets
  int resident, nc, nq, tiles_y, tiles_x;
  int a_off, stage_bytes, r_off, s_off, red_off;
};

// Where chunk q's weight rows start in the resident plane: conv chunks
// (9 taps x 64 channels) first, then the projection's (64 channels).
__device__ __forceinline__ int w_row0(const ArgsH& p, int q) {
  return q < p.nc ? q * kConvWRows : p.nc * kConvWRows + (q - p.nc) * kCH;
}

// Chunk q's weights for the O-block at o0 into W (its first row): a conv
// chunk's row tap * 64 + cl is w[tap][64q + cl][o0 ..]; a projection chunk's
// row cl is skip_w[64(q - nc) + cl][o0 ..]. Zero past C (Cr) and O.
template <int kThr>
__device__ __forceinline__ void load_w_h(const ArgsH& p, unsigned char* W, int q, int o0,
                                         int tid) {
  if (q < p.nc) {
    const int c0 = q * kCH;
    for (int idx = tid; idx < kConvWRows * 8; idx += kThr) {
      const int row = idx >> 3, k = idx & 7, c = c0 + (row & (kCH - 1));
      const bool ok = c < p.C;
      bf16t::copy8(W + bf16t::w_byte(row, k),
                   ok ? p.w + ((size_t)(row / kCH) * p.C + c) * p.O + o0 + 8 * k : p.w,
                   ok, o0 + 8 * k, p.O, p.wvec, p.w);
    }
  } else {
    const int c0 = (q - p.nc) * kCH;
    for (int idx = tid; idx < kCH * 8; idx += kThr) {
      const int row = idx >> 3, k = idx & 7, c = c0 + row;
      const bool ok = c < p.Cr;
      bf16t::copy8(W + bf16t::w_byte(row, k),
                   ok ? p.skip_w + (size_t)c * p.O + o0 + 8 * k : p.skip_w, ok,
                   o0 + 8 * k, p.O, p.svec, p.skip_w);
    }
  }
}

// Step operands into A stage A (and, with streamed weights, the weight slot
// Wslot): conv chunk q < nc is input channels 64q .. 64q + 63 of the halo'd
// tile (K3: of the low-res tile under it), a projection chunk the residual's
// channels 64(q - nc) .. at the tile's own pixels. 16 bytes (8 channels) a
// copy, zero outside the image and past C (Cr); nothing read there.
template <bool kUp, int kTHt>
__device__ __forceinline__ void load_step_h(const ArgsH& p, unsigned char* A,
                                            unsigned char* Wslot, int b, int ty0, int tx0,
                                            int q, int o0, int tid) {
  constexpr int kThr = 32 * warps_bf16(kTHt);
  if (q < p.nc) {
    constexpr int kCols = kUp ? kTW / 2 + 2 : kTW + 2;
    constexpr int kNPos = a_positions(kUp, kTHt);
    const int c0 = q * kCH;
    const int hin = kUp ? p.H / 2 : p.H, win = kUp ? p.W / 2 : p.W;
    const int y0 = kUp ? ty0 / 2 - 1 : ty0 - 1, x0 = kUp ? tx0 / 2 - 1 : tx0 - 1;
    const bf16* xb = p.x + (size_t)b * hin * win * p.C;
    for (int idx = tid; idx < kNPos * 8; idx += kThr) {
      const int pos = idx >> 3, k = idx & 7;
      const int y = y0 + pos / kCols, x = x0 + pos % kCols, c = c0 + 8 * k;
      const bool in = y >= 0 && y < hin && x >= 0 && x < win;
      bf16t::copy8(A + bf16t::a_byte(pos, k),
                   in ? xb + ((size_t)y * win + x) * p.C + c : p.x, in, c, p.C, p.xvec,
                   p.x);
    }
  } else {
    const int c0 = (q - p.nc) * kCH;
    const bf16* rb = p.res + (size_t)b * p.H * p.W * p.Cr;
    for (int idx = tid; idx < kTHt * kTW * 8; idx += kThr) {
      const int pos = idx >> 3, k = idx & 7;
      const int y = ty0 + pos / kTW, x = tx0 + pos % kTW, c = c0 + 8 * k;
      const bool in = y < p.H && x < p.W;
      bf16t::copy8(A + bf16t::a_byte(pos, k),
                   in ? rb + ((size_t)y * p.W + x) * p.Cr + c : p.res, in, c, p.Cr, p.rvec,
                   p.res);
    }
  }
  if (!p.resident) load_w_h<kThr>(p, Wslot, q, o0, tid);
}

// The identity residual of tile row y (pixels tx0 .. tx0 + 15), output
// channels o0 .., into the warp's 16 staging rows S; identity_up: the low-res
// row under it (8 pixels) into rows 8 .. 15. The warp's own lanes copy what
// its epilogue reads, so a __syncwarp after the wait makes it visible.
__device__ __forceinline__ void load_res_row(const ArgsH& p, unsigned char* S, int b, int y,
                                             int tx0, int o0, int lane) {
  const bool up = p.res_mode == kResIdentityUp;
  const int hr = up ? p.H / 2 : p.H, wr = up ? p.W / 2 : p.W;
  const int yr = up ? y >> 1 : y, x0 = up ? tx0 / 2 : tx0, npix = up ? kTW / 2 : kTW;
  for (int idx = lane; idx < npix * 8; idx += 32) {
    const int px = idx >> 3, k = idx & 7, x = x0 + px, o = o0 + 8 * k;
    const bool in = yr < hr && x < wr;
    bf16t::copy8(S + bf16t::a_byte(up ? kTW / 2 + px : px, k),
                 in ? p.res + (((size_t)b * hr + yr) * wr + x) * p.O + o : p.res, in, o, p.O,
                 p.idvec, p.res);
  }
}

// GroupNorm and SiLU in fp32 on the conv chunk's A plane, in place, each
// value rounded once to bf16. Thread tid keeps 8-channel chunk tid & 7 (its
// scale and shift in registers; zero past C, so those channels come out
// silu(0) = 0) and walks every 32nd position: a quarter warp covers one
// position's 8 chunks, which lie in 8 distinct bank groups. Positions
// outside the image keep the zeros the copy wrote (SAME padding of the
// ACTIVATED tensor).
template <bool kUp, int kTHt>
__device__ __forceinline__ void activate_h(const ArgsH& p, unsigned char* A, int ty0,
                                           int tx0, int q, const float* s_sc,
                                           const float* s_sh, int tid) {
  constexpr int kThr = 32 * warps_bf16(kTHt);
  constexpr int kCols = kUp ? kTW / 2 + 2 : kTW + 2;
  constexpr int kNPos = a_positions(kUp, kTHt);
  const int k = tid & 7, c = q * kCH + 8 * k;
  if (c >= p.C) return;
  const int hin = kUp ? p.H / 2 : p.H, win = kUp ? p.W / 2 : p.W;
  const int y0 = kUp ? ty0 / 2 - 1 : ty0 - 1, x0 = kUp ? tx0 / 2 - 1 : tx0 - 1;
  float sc[8], sh[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    sc[i] = c + i < p.C ? s_sc[c + i] : 0.f;
    sh[i] = c + i < p.C ? s_sh[c + i] : 0.f;
  }
#pragma unroll 2
  for (int pos = tid >> 3; pos < kNPos; pos += kThr / 8) {
    const int y = y0 + pos / kCols, x = x0 + pos % kCols;
    if (y < 0 || y >= hin || x < 0 || x >= win) continue;
    uint4* ptr = reinterpret_cast<uint4*>(A + bf16t::a_byte(pos, k));
    const uint4 raw = *ptr;
    const uint32_t v[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lo = __uint_as_float(v[i] << 16), hi = __uint_as_float(v[i] & 0xffff0000u);
      o[i] = bf16t::pack2(bf16t::silu_fast(lo * sc[2 * i] + sh[2 * i]),
                          bf16t::silu_fast(hi * sc[2 * i + 1] + sh[2 * i + 1]));
    }
    *ptr = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// One chunk's products of the warpgroup's 64 pixels (four tile rows, one a
// warp) x 64 outputs: kTaps taps (9, or the projection's one) x 4 k16 steps
// of wgmma m64n64k16. The warp's A fragment (its tile row's 16 pixels x 16
// channels at the tap) comes by ldmatrix from the A stage at A, one row
// address a lane, into a double buffer: step i + 1's fragment is loaded
// while step i's product runs. (Four buffers and four products in flight
// were 9 % slower at the res-128 tail: the 16-warp instance spills at its
// 128 registers.) B is the chunk's weight rows at W, read by
// the tensor cores through a descriptor.
template <bool kUp, int kTaps>
__device__ __forceinline__ void mma_chunk_bf16(uint32_t A, uint32_t W, float (&acc)[32], int r,
                                               int lane) {
  constexpr int kCols = kUp ? kTW / 2 + 2 : kTW + 2;
  const int ri = lane & 7, mi = lane >> 3;
  const int px = ri + 8 * (mi & 1);    // the lane's A row: pixel of the tile row
  const uint32_t ak = (mi >> 1) << 4;  // and its 8-channel half of a k16 step
  auto row_of = [&](int tap) -> uint32_t {
    const int dy = tap / 3, dx = tap % 3;
    const int pos = kTaps == 1 ? r * kTW + px
                    : kUp     ? (((r + dy - 1) >> 1) + 1) * kCols + ((px + dx - 1) >> 1) + 1
                              : (r + dy) * kCols + px + dx;
    return A + pos * bf16t::kARowBytes + ak;
  };
  uint32_t a[2][4];
  uint32_t row = row_of(0);
  bf16t::ldsm_x4(row, a[0]);
#pragma unroll 1
  for (int tap = 0; tap < kTaps; ++tap) {
    const uint32_t next = tap + 1 < kTaps ? row_of(tap + 1) : row;
    const uint64_t desc = bf16t::wg_desc(W + tap * kCH * bf16t::kWRowBytes);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      bf16t::wg_fence();
      // the descriptor's address field counts 16 bytes: k16 step kk is 16
      // weight rows (2,048 bytes) on
      bf16t::wg_mma(acc, a[kk & 1], desc + kk * (16 * bf16t::kWRowBytes >> 4));
      bf16t::wg_commit();
      bf16t::wg_wait<1>();  // step i - 1 is done with the other buffer
      if (kk < 3)
        bf16t::ldsm_x4(row + 32 * (kk + 1), a[(kk + 1) & 1]);
      else if (tap + 1 < kTaps)
        bf16t::ldsm_x4(next, a[0]);
    }
    row = next;
  }
  bf16t::wg_wait<0>();
}

// Persistent blocks: blockIdx.y is the 64-output block, and blockIdx.x walks
// a contiguous run of that block's pixel tiles (image-major), each tile a
// run of steps, one per chunk (nq: the conv's C / 64, then the projection's
// Cr / 64). A two-stage ring: step s + 1's cp.async copies are issued before
// step s's activation pass and products. With resident weights (every chunk
// of the O-block, loaded once before the first step) a step copies only its
// A tile; else each step also copies its chunk's weights into its slot.
// Warp w owns tile row w: its 16 pixels x 64 outputs.
template <bool kUp, int kTHt>
__global__ void __launch_bounds__(32 * warps_bf16(kTHt), 1) gnsc_bf16_kernel(const ArgsH p) {
  constexpr int kWarps = warps_bf16(kTHt), kThr = 32 * kWarps;
  extern __shared__ __align__(128) unsigned char sm_raw[];
  // the plane starts on a 1024-byte boundary (wgmma's 128-byte swizzle)
  unsigned char* sm = bf16t::align1024(sm_raw);
  unsigned char* stage0 = sm + p.a_off;
  float* s_bias = reinterpret_cast<float*>(sm + p.s_off);  // [64] bias of the O-block
  float* s_skb = s_bias + kCH;                              // [64] and skip bias
  float* s_sc = s_skb + kCH;                                // [C] folded scale
  float* s_sh = s_sc + p.C;                                 // [C] folded shift
  float* red = reinterpret_cast<float*>(sm + p.red_off);    // [2][kWarps][64]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int o0 = blockIdx.y * kCH;
  // the warp's staging rows: its tile row's residual, then its output
  unsigned char* S = sm + p.r_off + warp * kTW * bf16t::kARowBytes;
  const int per_img = p.tiles_y * p.tiles_x;
  const int ntiles = p.B * per_img;
  const int t_begin = (int)((long long)blockIdx.x * ntiles / gridDim.x);
  const int t_end = (int)((long long)(blockIdx.x + 1) * ntiles / gridDim.x);
  const int steps = (t_end - t_begin) * p.nq;
  if (steps == 0) return;
  const bool emit = p.osums != nullptr;
  const unsigned w_slot = kConvWRows * bf16t::kWRowBytes;
  if (tid < kCH) {
    const int o = o0 + tid;
    s_bias[tid] = p.bias && o < p.O ? p.bias[o] : 0.f;
    s_skb[tid] = p.res_mode == kResProj && p.skip_b && o < p.O ? p.skip_b[o] : 0.f;
  }

  auto tile_of = [&](int tile, int& b, int& ty0, int& tx0) {
    b = tile / per_img;
    const int rem = tile - b * per_img;
    ty0 = (rem / p.tiles_x) * kTHt;
    tx0 = (rem % p.tiles_x) * kTW;
  };

  {
    int b, ty0, tx0;
    tile_of(t_begin, b, ty0, tx0);
    if (p.resident)
      for (int q = 0; q < p.nq; ++q)
        load_w_h<kThr>(p, sm + w_row0(p, q) * bf16t::kWRowBytes, q, o0, tid);
    load_step_h<kUp, kTHt>(p, stage0, sm, b, ty0, tx0, 0, o0, tid);
    bf16t::commit();
  }

  float acc[32];
  float ps[8][2], pss[8][2];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) ps[j][0] = ps[j][1] = pss[j][0] = pss[j][1] = 0.f;
  int scale_b = -1;  // the image whose GroupNorm scale and shift s_sc / s_sh hold

  for (int s = 0; s < steps; ++s) {
    const int tile = t_begin + s / p.nq, q = s % p.nq, st = s & 1;
    int b, ty0, tx0;
    tile_of(tile, b, ty0, tx0);
    unsigned char* A = stage0 + st * p.stage_bytes;
    // step s's copies have landed, this thread's at least: the activation
    // pass takes the same (position, chunk) items as the copy did, so it
    // needs no barrier before it, and a warp that is through with step s - 1
    // starts on it while others still run their products
    bf16t::wait<0>();
    if (p.act && q == 0 && b != scale_b) {
      // fold image b's group statistics into one scale and shift a channel
      // (every warp is past step s - 1's activation pass: the last barrier)
      const int hin = kUp ? p.H / 2 : p.H, win = kUp ? p.W / 2 : p.W;
      const int per = p.C / p.groups;
      const float cnt = (float)hin * (float)win * (float)per;
      for (int ch = tid; ch < p.C; ch += kThr) {
        const int g0 = (ch / per) * per;
        float sum = 0.f, ssq = 0.f;
        for (int k = 0; k < per; ++k) {
          sum += p.sums[b * p.C + g0 + k];
          ssq += p.sumsq[b * p.C + g0 + k];
        }
        const float mean = sum / cnt;
        const float var = fmaxf(ssq / cnt - mean * mean, 0.f);
        const float a = p.gamma[b * p.C + ch] * rsqrtf(var + p.eps);
        s_sc[ch] = a;
        s_sh[ch] = p.beta[b * p.C + ch] - a * mean;
      }
      scale_b = b;
      __syncthreads();
    }
    if (q < p.nc && p.act) activate_h<kUp, kTHt>(p, A, ty0, tx0, q, s_sc, s_sh, tid);
    bf16t::fence_async_smem();
    __syncthreads();  // step s is staged; every warp is done with step s - 1

    if (q == 0 && (p.res_mode == kResIdentity || p.res_mode == kResIdentityUp))
      load_res_row(p, S, b, ty0 + warp, tx0, o0, lane);
    bf16t::commit();
    if (s + 1 < steps) {
      const int tile1 = t_begin + (s + 1) / p.nq;
      int b1, ty1, tx1;
      tile_of(tile1, b1, ty1, tx1);
      load_step_h<kUp, kTHt>(p, stage0 + (st ^ 1) * p.stage_bytes, sm + (st ^ 1) * w_slot,
                             b1, ty1, tx1, (s + 1) % p.nq, o0, tid);
    }
    bf16t::commit();
    const uint32_t wbase = bf16t::smem_addr(sm) + (p.resident ? w_row0(p, q) * bf16t::kWRowBytes
                                                              : st * w_slot);
    if (q < p.nc)
      mma_chunk_bf16<kUp, 9>(bf16t::smem_addr(A), wbase, acc, warp, lane);
    else
      mma_chunk_bf16<kUp, 1>(bf16t::smem_addr(A), wbase, acc, warp, lane);
    if (q != p.nq - 1) continue;

    // epilogue, warp by warp as its products end: fp32 bias, residual and
    // skip bias on the accumulators (pixels g, g + 8 of tile row `warp`,
    // outputs 8 j + 2 t4, + 1), the statistics from those fp32 values, one
    // rounding to bf16 into the warp's staging rows; then 16-byte stores of
    // its 16 pixels
    bf16t::wait<1>();  // the warp's residual has landed (step s + 1's copies may not have)
    __syncwarp();
    const bool up_res = p.res_mode == kResIdentityUp;
    const bool id_res = p.res_mode == kResIdentity || up_res;
    const int y = ty0 + warp;
    uint32_t rw[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int px = g + 8 * h, rpos = up_res ? kTW / 2 + (px >> 1) : px;
        rw[j][h] = id_res ? *reinterpret_cast<const uint32_t*>(S + bf16t::a_byte(rpos, 0) +
                                                               2 * (8 * j + 2 * t4))
                          : 0u;
      }
    __syncwarp();  // every lane has its residual before any output lands over it
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ol = 8 * j + 2 * t4, o = o0 + ol;
      const float2 bb = *reinterpret_cast<const float2*>(s_bias + ol);
      const float2 kb = *reinterpret_cast<const float2*>(s_skb + ol);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int px = g + 8 * h;
        const bool in = y < p.H && tx0 + px < p.W;
        const float2 rr = bf16t::unpack2(rw[j][h]);
        float v0 = acc[4 * j + 2 * h] + bb.x, v1 = acc[4 * j + 2 * h + 1] + bb.y;
        v0 += rr.x;
        v1 += rr.y;
        v0 += kb.x;
        v1 += kb.y;
        if (in && o < p.O) {
          ps[j][0] += v0;
          pss[j][0] += v0 * v0;
        }
        if (in && o + 1 < p.O) {
          ps[j][1] += v1;
          pss[j][1] += v1 * v1;
        }
        *reinterpret_cast<uint32_t*>(S + bf16t::a_byte(px, 0) + 2 * ol) = bf16t::pack2(v0, v1);
        acc[4 * j + 2 * h] = acc[4 * j + 2 * h + 1] = 0.f;
      }
    }
    __syncwarp();
    for (int idx = lane; idx < kTW * 8; idx += 32) {
      const int px = idx >> 3, k = idx & 7, x = tx0 + px, o = o0 + 8 * k;
      if (y >= p.H || x >= p.W || o >= p.O) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(S + bf16t::a_byte(px, k));
      bf16* dst = p.out + (((size_t)b * p.H + y) * p.W + x) * p.O + o;
      if (p.ovec) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        const bf16* e = reinterpret_cast<const bf16*>(&v);
        for (int i = 0; i < 8 && o + i < p.O; ++i) dst[i] = e[i];
      }
    }
    // the statistics go out when the block leaves image b: sums over g (lane
    // bits 2-4), then the warps in a fixed order
    int bn = -1, tyn, txn;
    if (tile + 1 < t_end) tile_of(tile + 1, bn, tyn, txn);
    if (emit && bn != b) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int sh = 4; sh < 32; sh <<= 1) {
            ps[j][e] += __shfl_xor_sync(0xffffffffu, ps[j][e], sh);
            pss[j][e] += __shfl_xor_sync(0xffffffffu, pss[j][e], sh);
          }
          if (g == 0) {
            red[warp * kCH + 8 * j + 2 * t4 + e] = ps[j][e];
            red[(kWarps + warp) * kCH + 8 * j + 2 * t4 + e] = pss[j][e];
          }
          ps[j][e] = pss[j][e] = 0.f;
        }
      __syncthreads();
      if (tid < kCH && o0 + tid < p.O) {
        float sum = 0.f, ssq = 0.f;
        for (int w = 0; w < kWarps; ++w) {
          sum += red[w * kCH + tid];
          ssq += red[(kWarps + w) * kCH + tid];
        }
        atomicAdd(&p.osums[b * p.O + o0 + tid], sum);
        atomicAdd(&p.osumsq[b * p.O + o0 + tid], ssq);
      }
    }
  }
  bf16t::wait<0>();
}

// The launch plan of one bf16 call. Tile: 16 x 16 pixels where that gives at
// least kBigTileWaves tiles a block on a grid of one wave and its resident
// layout fits (the res-128 calls at B = 16: halo 1.27x), else 8 x 16 (halo
// 1.41x; more blocks at res 64 and 32). Weights resident when every chunk of
// the O-block fits beside the rest (C = 64 with Cr <= 128 at 16 x 16 rows;
// C <= 128 at 8 x 16), else streamed a chunk a step through two slots.
// Shared memory, in this order: weights, the two A stages, the staging rows
// (a warp's residual, then its output), bias, skip bias and the folded
// scale and shift, the statistics' reduction.
struct PlanH {
  int th, resident, nc, nq, tiles_y, tiles_x, n_ob, grid_x, bps, smem;
  int a_off, stage_bytes, r_off, s_off, red_off;
};

template <bool kUp, int kTHt>
cudaError_t allow_smem_bf16() {
  static cudaError_t e = cudaFuncSetAttribute(
      gnsc_bf16_kernel<kUp, kTHt>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCapH);
  return e;
}

// co-resident blocks an SM, asked once per KB of shared memory (rounded up)
template <bool kUp, int kTHt>
int blocks_per_sm_bf16(int smem) {
  static int cache[kSmemCapH / 1024 + 2] = {};
  const int kb = (smem + 1023) / 1024;
  int& n = cache[kb];
  if (!n && allow_smem_bf16<kUp, kTHt>() == cudaSuccess &&
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, gnsc_bf16_kernel<kUp, kTHt>, 32 * warps_bf16(kTHt),
          kb * 1024 < kSmemCapH ? kb * 1024 : kSmemCapH) != cudaSuccess)
    n = 0;
  return n;
}

int layout_bf16(bool up, int th, bool resident, int c, int nc, int nr, int act, bool emit,
                PlanH& pl) {
  const int w_bytes = (resident ? nc * kConvWRows + nr * kCH : 2 * kConvWRows) *
                      bf16t::kWRowBytes;
  pl.stage_bytes = a_positions(up, th) * bf16t::kARowBytes;
  pl.a_off = w_bytes;
  pl.r_off = pl.a_off + 2 * pl.stage_bytes;                // staging: a row a pixel
  pl.s_off = pl.r_off + th * kTW * bf16t::kARowBytes;      // bias, skip bias, scale, shift
  pl.red_off = pl.s_off + 2 * kCH * 4 + (act ? (2 * c * 4 + 15) / 16 * 16 : 0);
  // + 1024: the kernel starts its plane on a 1024-byte boundary
  pl.smem = pl.red_off + (emit ? 2 * warps_bf16(th) * kCH * 4 : 0) + 1024;
  return pl.smem;
}

template <bool kUp>
bool plan_bf16(int batch, int h, int wd, int c, int o, int cr, int act, int res_mode,
               bool emit, PlanH& pl) {
  const int sms = bf16t::sm_count();
  pl.nc = (c + kCH - 1) / kCH;
  const int nr = res_mode == kResProj ? (cr + kCH - 1) / kCH : 0;
  pl.nq = pl.nc + nr;
  pl.n_ob = (o + kCH - 1) / kCH;
  const long long tiles16 = (long long)batch * ((h + 15) / 16) * ((wd + kTW - 1) / kTW);
  if (tiles16 * pl.n_ob >= (long long)kBigTileWaves * sms &&
      layout_bf16(kUp, 16, true, c, pl.nc, nr, act, emit, pl) <= kSmemCapH) {
    pl.th = 16;
    pl.resident = 1;
  } else {
    pl.th = 8;
    pl.resident = layout_bf16(kUp, 8, true, c, pl.nc, nr, act, emit, pl) <= kSmemCapH;
    if (!pl.resident &&
        layout_bf16(kUp, 8, false, c, pl.nc, nr, act, emit, pl) > kSmemCapH)
      return false;
  }
  pl.tiles_y = (h + pl.th - 1) / pl.th;
  pl.tiles_x = (wd + kTW - 1) / kTW;
  pl.bps = pl.th == 16 ? blocks_per_sm_bf16<kUp, 16>(pl.smem)
                       : blocks_per_sm_bf16<kUp, 8>(pl.smem);
  if (pl.bps < 1) return false;
  const long long tiles = (long long)batch * pl.tiles_y * pl.tiles_x;
  const long long per_ob = (long long)sms * pl.bps / pl.n_ob;
  pl.grid_x = (int)(tiles < per_ob ? tiles : (per_ob < 1 ? 1 : per_ob));
  return true;
}

template <bool kUp>
int launch_bf16(const bf16* x, const bf16* w, const float* bias, const float* gamma,
                const float* beta, const float* sums, const float* sumsq, const bf16* res,
                const bf16* skip_w, const float* skip_b, bf16* out, float* osums,
                float* osumsq, int batch, int h, int wd, int c, int o, int cr, int groups,
                float eps, int act, int res_mode, void* stream) {
  if (c < 1 || o < 1 || c > kMaxC || (act && (groups < 1 || c % groups)) ||
      (res_mode == kResProj && cr < 1) || (kUp && (h % 2 || wd % 2)))
    return (int)cudaErrorInvalidValue;
  if (batch < 1 || h < 1 || wd < 1) return (int)cudaSuccess;
  PlanH pl;
  if (!plan_bf16<kUp>(batch, h, wd, c, o, cr, act, res_mode, osums != nullptr, pl))
    return (int)cudaErrorInvalidConfiguration;
  const bool idres = res_mode == kResIdentity || res_mode == kResIdentityUp;
  ArgsH p{x, w, bias, gamma, beta, sums, sumsq, res, skip_w, skip_b, out, osums, osumsq,
          batch, h, wd, c, o, cr, groups, eps, act, res_mode,
          c % 8 == 0 && aligned(x, 16), o % 8 == 0 && aligned(w, 16),
          idres && o % 8 == 0 && aligned(res, 16),
          res_mode == kResProj && cr % 8 == 0 && aligned(res, 16),
          res_mode == kResProj && o % 8 == 0 && aligned(skip_w, 16),
          o % 8 == 0 && aligned(out, 16),
          pl.resident, pl.nc, pl.nq, pl.tiles_y, pl.tiles_x,
          pl.a_off, pl.stage_bytes, pl.r_off, pl.s_off, pl.red_off};
  const dim3 grid(pl.grid_x, pl.n_ob);
  const cudaStream_t s = (cudaStream_t)stream;
  if (pl.th == 16)
    gnsc_bf16_kernel<kUp, 16><<<grid, 32 * warps_bf16(16), pl.smem, s>>>(p);
  else
    gnsc_bf16_kernel<kUp, 8><<<grid, 32 * warps_bf16(8), pl.smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// h, w are the OUTPUT height and width; x is (B, h, w, c).
int mc_gn_silu_conv(const float* x, const float* w, const float* bias,
                    const float* gamma, const float* beta, const float* sums,
                    const float* sumsq, const float* res, const float* skip_w,
                    const float* skip_b, float* out, float* osums, float* osumsq,
                    int batch, int h, int wd, int c, int o, int cr, int groups,
                    float eps, int act, int res_mode, void* stream) {
  return launch<false>(x, w, bias, gamma, beta, sums, sumsq, res, skip_w, skip_b,
                       out, osums, osumsq, batch, h, wd, c, o, cr, groups, eps,
                       act, res_mode, stream);
}

// h, w are the OUTPUT height and width; x is (B, h / 2, w / 2, c).
int mc_gn_silu_up_conv(const float* x, const float* w, const float* bias,
                       const float* gamma, const float* beta, const float* sums,
                       const float* sumsq, float* out, float* osums, float* osumsq,
                       int batch, int h, int wd, int c, int o, int groups,
                       float eps, void* stream) {
  return launch<true>(x, w, bias, gamma, beta, sums, sumsq, nullptr, nullptr,
                      nullptr, out, osums, osumsq, batch, h, wd, c, o, 0, groups,
                      eps, 1, kResNone, stream);
}

// The bf16 instances: x, w, res, skip_w and out bf16; bias, gamma, beta,
// sums, sumsq, skip_b, osums and osumsq fp32.
int mc_gn_silu_conv_bf16(const bf16* x, const bf16* w, const float* bias,
                         const float* gamma, const float* beta, const float* sums,
                         const float* sumsq, const bf16* res, const bf16* skip_w,
                         const float* skip_b, bf16* out, float* osums, float* osumsq,
                         int batch, int h, int wd, int c, int o, int cr, int groups,
                         float eps, int act, int res_mode, void* stream) {
  return launch_bf16<false>(x, w, bias, gamma, beta, sums, sumsq, res, skip_w, skip_b,
                            out, osums, osumsq, batch, h, wd, c, o, cr, groups, eps,
                            act, res_mode, stream);
}

int mc_gn_silu_up_conv_bf16(const bf16* x, const bf16* w, const float* bias,
                            const float* gamma, const float* beta, const float* sums,
                            const float* sumsq, bf16* out, float* osums, float* osumsq,
                            int batch, int h, int wd, int c, int o, int groups,
                            float eps, void* stream) {
  return launch_bf16<true>(x, w, bias, gamma, beta, sums, sumsq, nullptr, nullptr,
                           nullptr, out, osums, osumsq, batch, h, wd, c, o, 0, groups,
                           eps, 1, kResNone, stream);
}

// The bf16 kernels' plan for a call (up: K3), as launch_bf16 makes it: out
// = {tile rows, weights resident (1) or streamed (0), blocks (grid x times
// the O-blocks), dynamic shared memory bytes, co-resident blocks an SM}.
// Returns a cudaError_t.
int mc_gn_silu_conv_bf16_plan(int up, int batch, int h, int wd, int c, int o, int cr,
                              int act, int res_mode, int emit, int* out) {
  PlanH pl;
  const bool ok = up ? plan_bf16<true>(batch, h, wd, c, o, cr, 1, kResNone, emit, pl)
                     : plan_bf16<false>(batch, h, wd, c, o, cr, act, res_mode, emit, pl);
  if (!ok) return (int)cudaErrorInvalidConfiguration;
  const int vals[5] = {pl.th, pl.resident, pl.grid_x * pl.n_ob, pl.smem, pl.bps};
  for (int i = 0; i < 5; ++i) out[i] = vals[i];
  return (int)cudaSuccess;
}

}  // extern "C"
