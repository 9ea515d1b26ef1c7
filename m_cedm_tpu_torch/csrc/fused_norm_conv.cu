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
// copy of the tile, or an im2col stage; the backward kernels
// (csrc/fused_norm_conv_bwd.cu) and K7 (csrc/fused_block.cu) still run on the
// CUDA cores.
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // extern "C"
