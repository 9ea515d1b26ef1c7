// K7: the whole ADM residual block in one cooperative launch. NHWC fp32.
//
//   h   = conv3x3(silu(gn0(xin) * g0 + b0)) + bias0           (phase 0)
//   out = conv3x3(silu(gn1(h) * g1 + b1)) + bias1 + skip(xin)  (phase 1)
//
// xin is x, or the channel concat of x and x2 (a decoder block's trunk and
// encoder skip), never written to memory: channels < C1 are read from x,
// the rest from x2. skip is the identity or a 1x1 projection of xin plus its
// bias. With `up`, conv0 sees the nearest 2x upsample of the activated x
// (each output position reads low-res pixel (y/2, x/2)) and the skip path
// reads xin upsampled the same way. Optionally the per-(B, O) sum and sum of
// squares of the fp32 output are emitted for the next block's norm.
//
// Replaces m_cedm_tpu/pallas/fused_block.py::_mega_kernel (via
// _pallas_mega). That kernel keeps a whole sample's conv0 output in VMEM
// and relies on the TPU grid running in order, so that all of phase 0 and
// its statistics are done before phase 1 reads them. Neither holds here:
// one sample's conv0 output at res 128, O 64 is 4 MiB against an SM's
// 227 KB, and blocks run in no order.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel), a
// persistent grid sized from the occupancy query at the kernel's dynamic
// shared memory, and grid-wide barriers between the phases. A work item is
// one 8 x 16 output tile of one sample and 64 output channels; blocks walk
// the items with a grid stride.
//   phase 0   per item, conv0 of the activated xin (norm0 + SiLU applied
//             in the staging pass) on the conv core below; conv0 + bias0
//             goes to a workspace (B, H, W, O) in device memory (64 MiB at
//             the flagship's full-resolution blocks), and the tile's
//             per-channel sums to a partials buffer, one slot per item
//   sync, reduce  each (sample, channel) sums its tiles' partials in a fixed
//             order (one warp per pair, a fixed butterfly): norm1's
//             statistics, with no atomics, so K7 is deterministic
//   sync, phase 1  per item, conv1 of the activated workspace (norm1 + FiLM
//             + SiLU in the staging pass), then the skip: a projection is
//             one more one-tap pass over xin's channels into the same
//             accumulators; the identity is added in the epilogue; out is
//             written
//   (emit)    sync, the output's partials reduced the same way
// conv0's output thus never leaves the launch, and the concat is never made.
//
// The conv core is csrc/fused_norm_conv.cu's gnsc_kernel (its helpers are
// copied below, as every source here carries its own), so the header there
// says the rest in full. Every product runs on mma.sync.m16n8k8 in TF32 with
// fp32 accumulation as 3xTF32: each fp32 operand split as hi = tf32(x), lo =
// tf32(x - hi) (cvt.rn) and the product summed as lo*hi + hi*lo + hi*hi,
// fp32 accuracy. A block of 8 warps owns the item's 8 x 16 pixels and 64
// output channels; a warp two tile rows (two m16 tiles) and 32 channels
// (four n8 tiles). The input channels stream 8 at a time: the raw halo'd
// 10 x 18 x 8 tile (with `up`, the 6 x 10 low-res tile under it; for the
// projection the tile's own pixels) and the raw weight chunk come through a
// two-stage cp.async ring; one pass over shared memory applies the
// GroupNorm affine and the SiLU, writes zeros outside the image AFTER the
// activation (SAME padding pads the activated tensor), and splits each
// operand once into fragment-order hi/lo planes. kTempSteps taps of the
// three products go into a zeroed fragment before one fp32 add into the
// accumulator.
//
// Bound. At the identity block at res 128 (B 16, 64 -> 64) the two convs are
// 2 * 16 * 128^2 * 9 * 64 * 64 * 2 = 3.87e10 FLOP: 0.234 ms in 3xTF32 (three
// TF32 FLOPs per FLOP at 495 TFLOP/s), 0.58 ms at the fp32 CUDA cores' 67
// TFLOP/s, against about 0.04 ms of bytes (x in, out out) and about 0.045 ms
// for the workspace's round trip. So the products bound it; in practice the
// core's ceiling is mma.sync's TF32 rate (about 320 TFLOP/s on the H100),
// and each phase runs at about K2's rate: the block takes what K2 + K2 take.
// Shared memory is 109 KB a block (the ring, the planes and the folded
// scale and shift of up to 256 input channels) and at most 128 registers a
// thread, so two blocks share an SM, and one block's staging pass overlaps
// the other's products; the grid is then 264 blocks on 132 SMs. The grid
// barriers cost what one wave's tail costs: phase 0 ends when its last item
// does.
//
// Measured (kernels/attention_sources.py --kernel k7, one H100 at 700 W;
// PERF.md section 6): 1.15-1.18 ms at the identity block, against 1.13-1.16
// for K2 + K2 on the same inputs and 1.98-2.03 for this kernel's earlier
// form, which ran the same phases on the CUDA cores (K2's old fp32 FMA loop,
// 128 threads, static shared memory). Without the products the block takes
// 0.49 of that, without the split pass 0.82. ptxas spills about 512 bytes a
// thread at the 128-register cap, none of it inside the product loops.
// Tried and dropped: each phase's item in a __noinline__ function (12-120
// bytes of spills, 4-9 % slower); recomputing the item's indices at each
// use (300-324 bytes, 4 % slower); copying the block's next item's first
// chunk and folding its norm behind the last products (992-1060 bytes, 7-8 %
// slower); a tap a partial sum (kTempSteps = 1: 18-19 % slower). Keeping
// conv0's output on the chip (a cluster split, L2 residency) is not done:
// the workspace round trip is under a twentieth of the products.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_conv_tiles.cuh"
#include "k7_plan.h"
#include "tma_ring.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTH = 8;           // output rows per item
constexpr int kTW = 16;          // output columns per item: one m16 tile a row
constexpr int kBO = 64;          // output channels per item
constexpr int kCK = 8;           // input channels per chunk: one k-step
constexpr int kWarps = 8;        // 4 row pairs x 2 channel halves
constexpr int kThreads = 32 * kWarps;
constexpr int kIH = kTH + 2;     // halo'd tile rows
constexpr int kIW = kTW + 2;     // halo'd tile columns
constexpr int kPos = kIH * kIW;  // halo'd tile positions
constexpr int kLH = kTH / 2 + 2, kLW = kTW / 2 + 2;  // the up-block's low-res tile
constexpr int kXS = 12;          // raw input floats a position (8 used)
constexpr int kWS = kBO + 8;     // raw weight row stride, 8 mod 32
constexpr int kMaxC = 256;       // xin channels (C1 + C2, each at most 128)
constexpr int kTempSteps = 9;    // k-steps summed on the tensor cores per fp32 add

// shared memory, in floats
constexpr int kRawX = kPos * kXS;         // one raw input stage
constexpr int kRawW = 9 * kCK * kWS;      // one raw weight stage
constexpr int kSplitA = kPos * 16;        // the split input plane, fragment order
constexpr int kSplitB = 9 * 8 * 32 * 4;   // the split weight plane, fragment order
constexpr int kSmemFloats = 2 * (kRawX + kRawW) + kSplitA + kSplitB + 2 * kMaxC;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

struct Args {
  const float* x;        // (B, Hin, Win, C1): Hin = H, or H / 2 with up
  const float* x2;       // (B, Hin, Win, C2) or null
  const float* g0;       // (B, C) folded norm0 scale, C = C1 + C2
  const float* b0;       // (B, C) folded norm0 shift
  const float* sums0;    // (B, C) channel sums of xin over Hin * Win pixels
  const float* sumsq0;   // (B, C) channel sums of xin^2
  const float* w0;       // (3, 3, C, O)
  const float* bias0;    // (O,) or null
  const float* g1;       // (B, O) folded norm1 + FiLM scale
  const float* b1;       // (B, O) folded norm1 + FiLM shift
  const float* w1;       // (3, 3, O, O)
  const float* bias1;    // (O,) or null
  const float* skip_w;   // (C, O) 1x1 projection, or null: identity (C == O)
  const float* skip_b;   // (O,) or null
  float* ws;             // (B, H, W, O) conv0 output
  float* part_s;         // (B, tiles, O) per-tile channel sums
  float* part_ss;        // (B, tiles, O) per-tile channel sums of squares
  float* sums1;          // (B, O) conv0 output's channel sums
  float* sumsq1;
  float* out;            // (B, H, W, O)
  float* osums;          // (B, O) or null: no statistics emitted
  float* osumsq;
  int B, H, W, C1, C2, O, groups0, groups1;
  float eps;
  int xvec, wvec, pair;  // 16-byte copies of xin / of the weights and ws; 8-byte stores
};

struct Item {
  int b, tile, ty0, tx0, o0;
};

__device__ __forceinline__ float silu(float y) { return y / (1.f + expf(-y)); }

// xin at pixel (y, x) of sample bi at its own resolution (hin x win),
// channel c: x for c < C1, x2 for the rest
__device__ __forceinline__ const float* xin_at(const Args& p, int hin, int win, int bi,
                                               int y, int x, int c) {
  const size_t pix = ((size_t)bi * hin + y) * win + x;
  return c < p.C1 ? p.x + pix * p.C1 + c : p.x2 + pix * p.C2 + (c - p.C1);
}

__device__ __forceinline__ Item item_of(int i, int tiles_w, int n_tiles, int o_tiles) {
  Item it;
  it.o0 = (i % o_tiles) * kBO;
  const int rest = i / o_tiles;
  it.tile = rest % n_tiles;
  it.b = rest / n_tiles;
  it.ty0 = (it.tile / tiles_w) * kTH;
  it.tx0 = (it.tile % tiles_w) * kTW;
  return it;
}

// ---------------------------------------------------------------------------
// 3xTF32 on mma.sync and cp.async (as in csrc/fused_norm_conv.cu)
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

// Channels c0 .. c0 + 7 of a source at the npos positions of a (cols)-wide
// window whose first position is (y0, x0) of sample bi, into a raw stage;
// zero-filled outside the source and past its channels (no bytes are read
// there). The source (src_h x src_w pixels) is xin (kXin: channels < C1 from x,
// the rest from x2) or the workspace (O channels).
template <bool kXin>
__device__ __forceinline__ void load_pixels(const Args& p, int src_h, int src_w, int vec,
                                            int npos, int cols, int y0, int x0, int c0,
                                            float* rx, int bi, int tid) {
  const int C = kXin ? p.C1 + p.C2 : p.O;
  auto src = [&](int y, int x, int c) -> const float* {
    return kXin ? xin_at(p, src_h, src_w, bi, y, x, c)
                : p.ws + (((size_t)bi * src_h + y) * src_w + x) * p.O + c;
  };
  if (vec) {
    for (int idx = tid; idx < npos * 2; idx += kThreads) {
      const int h = idx & 1, pos = idx >> 1;
      const int y = y0 + pos / cols, x = x0 + pos % cols, c = c0 + 4 * h;
      const bool valid = y >= 0 && y < src_h && x >= 0 && x < src_w && c < C;
      cp_async16(rx + pos * kXS + 4 * h, valid ? src(y, x, c) : p.x, valid);
    }
  } else {
    for (int idx = tid; idx < npos * kCK; idx += kThreads) {
      const int ck = idx % kCK, pos = idx / kCK;
      const int y = y0 + pos / cols, x = x0 + pos % cols, c = c0 + ck;
      const bool valid = y >= 0 && y < src_h && x >= 0 && x < src_w && c < C;
      cp_async4(rx + pos * kXS + ck, valid ? src(y, x, c) : p.x, valid);
    }
  }
}

// Rows c0 .. c0 + 7 of the kTaps taps of w (kTaps, C, O) for output
// channels o0 .. o0 + 63 into a raw weight stage, row tap * kCK + ck.
template <int kTaps>
__device__ __forceinline__ void load_weights(const float* w, int C, int O, int wvec,
                                             int c0, float* rw, int o0, int tid) {
  if (wvec) {
    for (int idx = tid; idx < kTaps * kCK * (kBO / 4); idx += kThreads) {
      const int o4 = idx % (kBO / 4), row = idx / (kBO / 4);
      const int tap = row / kCK, c = c0 + row % kCK, o = o0 + 4 * o4;
      const bool valid = c < C && o < O;
      cp_async16(rw + row * kWS + 4 * o4, valid ? w + ((size_t)tap * C + c) * O + o : w,
                 valid);
    }
  } else {
    for (int idx = tid; idx < kTaps * kCK * kBO; idx += kThreads) {
      const int oo = idx % kBO, row = idx / kBO;
      const int tap = row / kCK, c = c0 + row % kCK, o = o0 + oo;
      const bool valid = c < C && o < O;
      cp_async4(rw + row * kWS + oo, valid ? w + ((size_t)tap * C + c) * O + o : w,
                valid);
    }
  }
}

// Chunk q of an item's K loop into one raw stage. Phase 0: input channels
// 8q .. 8q + 7 of conv0 over xin (the halo'd tile or, kUp, the low-res tile
// under it) and the nine taps' weights. Phase 1: q < nc, channels 8q .. of
// conv1 over the workspace; q >= nc, channels 8(q - nc) .. of the 1x1
// projection of xin (the tile's own pixels or, kUp, the low-res pixels under
// them) and the skip weight's rows.
template <bool kUp, int kPhase>
__device__ __forceinline__ void load_chunk(const Args& p, int q, int nc, float* rx,
                                           float* rw, const Item& it, int tid) {
  const int hin = kUp ? p.H / 2 : p.H, win = kUp ? p.W / 2 : p.W;
  const int C = p.C1 + p.C2;
  if (kPhase == 0) {
    const int c0 = q * kCK;
    if (kUp)
      load_pixels<true>(p, hin, win, p.xvec, kLH * kLW, kLW, it.ty0 / 2 - 1,
                        it.tx0 / 2 - 1, c0, rx, it.b, tid);
    else
      load_pixels<true>(p, hin, win, p.xvec, kPos, kIW, it.ty0 - 1, it.tx0 - 1, c0, rx,
                        it.b, tid);
    load_weights<9>(p.w0, C, p.O, p.wvec, c0, rw, it.o0, tid);
  } else if (q < nc) {
    const int c0 = q * kCK;
    load_pixels<false>(p, p.H, p.W, p.wvec, kPos, kIW, it.ty0 - 1, it.tx0 - 1, c0, rx,
                       it.b, tid);
    load_weights<9>(p.w1, p.O, p.O, p.wvec, c0, rw, it.o0, tid);
  } else {
    const int c0 = (q - nc) * kCK;
    if (kUp)
      load_pixels<true>(p, hin, win, p.xvec, (kTH / 2) * (kTW / 2), kTW / 2, it.ty0 / 2,
                        it.tx0 / 2, c0, rx, it.b, tid);
    else
      load_pixels<true>(p, hin, win, p.xvec, kTH * kTW, kTW, it.ty0, it.tx0, c0, rx,
                        it.b, tid);
    load_weights<1>(p.skip_w, C, p.O, p.wvec, c0, rw, it.o0, tid);
  }
}

__device__ __forceinline__ void store_split(float* dst, float v0, float v1) {
  uint32_t h0, l0, h1, l1;
  split(v0, h0, l0);
  split(v1, h1, l1);
  *reinterpret_cast<uint4*>(dst) = make_uint4(h0, h1, l0, l1);
}

// The conv chunk's input plane: (thread t of a position) channels c0 + t and
// c0 + t + 4, activated, zero outside the H x W image and past C, split.
template <bool kLo>
__device__ __forceinline__ void split_x(const float* rx, float* sa, int c0, int C, int H,
                                        int W, const Item& it, const float* s_a,
                                        const float* s_b, int tid) {
  for (int idx = tid; idx < kPos * 4; idx += kThreads) {
    const int t = idx & 3, pos = idx >> 2;
    const int y = it.ty0 - 1 + pos / kIW, x = it.tx0 - 1 + pos % kIW;
    float v0 = 0.f, v1 = 0.f;  // SAME zero padding of the ACTIVATED tensor
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const int rpos = kLo ? ((y >> 1) - (it.ty0 / 2 - 1)) * kLW + (x >> 1) -
                                 (it.tx0 / 2 - 1)
                           : pos;
      const int ca = c0 + t, cb = ca + 4;
      v0 = ca < C ? silu(rx[rpos * kXS + t] * s_a[ca] + s_b[ca]) : 0.f;
      v1 = cb < C ? silu(rx[rpos * kXS + t + 4] * s_a[cb] + s_b[cb]) : 0.f;
    }
    store_split(sa + pos * 16 + 4 * t, v0, v1);
  }
}

// The projection chunk's plane: the tile's own pixels (kLo: pixel (y, x)
// reads low-res pixel (y/2, x/2)) at the centre tap's positions.
template <bool kLo>
__device__ __forceinline__ void split_r(const float* rx, float* sa, int tid) {
  for (int idx = tid; idx < kTH * kTW * 4; idx += kThreads) {
    const int t = idx & 3, pos = idx >> 2;
    const int py = pos / kTW, px = pos % kTW;
    const int rpos = kLo ? (py >> 1) * (kTW / 2) + (px >> 1) : pos;
    store_split(sa + ((py + 1) * kIW + px + 1) * 16 + 4 * t, rx[rpos * kXS + t],
                rx[rpos * kXS + t + 4]);
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

// The group statistics of sample b (sums over cnt_pix pixels a channel)
// folded with its (B, C) gamma / beta into one scale and shift per channel.
__device__ __forceinline__ void fold(const float* sums, const float* sumsq,
                                     const float* gamma, const float* beta, int C,
                                     int groups, float cnt_pix, float eps, int b,
                                     float* s_a, float* s_b, int tid) {
  const int per = C / groups;
  const float cnt = cnt_pix * (float)per;
  for (int ch = tid; ch < C; ch += kThreads) {
    const int g0 = (ch / per) * per;
    float s = 0.f, ss = 0.f;
    for (int k = 0; k < per; ++k) {
      s += sums[b * C + g0 + k];
      ss += sumsq[b * C + g0 + k];
    }
    const float mean = s / cnt;
    const float var = fmaxf(ss / cnt - mean * mean, 0.f);
    const float a = gamma[b * C + ch] * rsqrtf(var + eps);
    s_a[ch] = a;
    s_b[ch] = beta[b * C + ch] - a * mean;
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

// The tile's per-channel sum and sum of squares (ps, pss: this thread's
// channels over its pixels) summed over the block in a fixed order (over g
// by shuffles, then the four row pairs in order in shared memory) and stored
// into the item's slot of the partials buffer.
__device__ __forceinline__ void store_partials(float (&ps)[4][2], float (&pss)[4][2],
                                               const Item& it, int n_tiles, int O,
                                               float* part_s, float* part_ss,
                                               float* smem) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp & 3, cq = warp >> 2, g = lane >> 2, t = lane & 3;
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
  float* red_s = smem + 2 * (kRawX + kRawW);
  float* red_ss = red_s + 4 * kBO;
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
  if (tid < kBO && it.o0 + tid < O) {
    float s = 0.f, ss = 0.f;
    for (int r = 0; r < 4; ++r) {
      s += red_s[r * kBO + tid];
      ss += red_ss[r * kBO + tid];
    }
    const size_t slot = ((size_t)it.b * n_tiles + it.tile) * O + it.o0 + tid;
    part_s[slot] = s;
    part_ss[slot] = ss;
  }
}

// dst[b, o] = sum over tiles of part[b, tile, o], tiles in a fixed order:
// one warp per (b, o), lane l summing tiles l, l + 32, ..., then a butterfly.
__device__ void reduce_partials(const float* part_s, const float* part_ss, int B,
                                int n_tiles, int O, float* dst_s, float* dst_ss) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * kWarps;
  for (int pair = warp; pair < B * O; pair += n_warps) {
    const int b = pair / O, o = pair % O;
    float sm = 0.f, ss = 0.f;
    for (int t = lane; t < n_tiles; t += 32) {
      const size_t slot = ((size_t)b * n_tiles + t) * O + o;
      sm += part_s[slot];
      ss += part_ss[slot];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sm += __shfl_xor_sync(0xffffffffu, sm, off);
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    if (lane == 0) {
      dst_s[pair] = sm;
      dst_ss[pair] = ss;
    }
  }
}

// One work item of phase kPhase: item i's K loop (chunk q + 1 is copied
// while chunk q is split and multiplied), then its epilogue. Phase 0 writes
// conv0 + bias0 to the workspace and its tile's partial statistics; phase
// 1 adds bias1 and the skip, writes out and, to emit statistics, the
// partials of out.
template <bool kUp, int kPhase>
__device__ __forceinline__ void run_item(const Args& p, int i) {
  extern __shared__ __align__(16) float smem[];
  float* rx = smem;              // [2][kRawX] raw input (or residual) stages
  float* rw = rx + 2 * kRawX;    // [2][kRawW] raw weight stages
  float* sa = rw + 2 * kRawW;    // the split input plane
  float* sb = sa + kSplitA;      // the split weight plane
  float* s_a = sb + kSplitB;     // [kMaxC] folded per-channel scale
  float* s_b = s_a + kMaxC;      // and shift
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = warp & 3, cq = warp >> 2;  // row pair, channel half
  const int H = p.H, W = p.W, O = p.O;
  const int hin = kUp ? H / 2 : H, win = kUp ? W / 2 : W;
  const int tiles_w = (W + kTW - 1) / kTW;
  const int n_tiles = ((H + kTH - 1) / kTH) * tiles_w;
  const Item it = item_of(i, tiles_w, n_tiles, (O + kBO - 1) / kBO);
  const int C = kPhase == 0 ? p.C1 + p.C2 : O;  // the conv's input channels
  const int nc = (C + kCK - 1) / kCK;
  const int nq = nc + (kPhase == 1 && p.skip_w ? (p.C1 + p.C2 + kCK - 1) / kCK : 0);

  load_chunk<kUp, kPhase>(p, 0, nc, rx, rw, it, tid);
  cp_commit();
  if (kPhase == 0)
    fold(p.sums0, p.sumsq0, p.g0, p.b0, C, p.groups0, (float)hin * (float)win, p.eps,
         it.b, s_a, s_b, tid);
  else
    fold(p.sums1, p.sumsq1, p.g1, p.b1, C, p.groups1, (float)H * (float)W, p.eps, it.b,
         s_a, s_b, tid);
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
      load_chunk<kUp, kPhase>(p, q + 1, nc, rx + (st ^ 1) * kRawX, rw + (st ^ 1) * kRawW,
                              it, tid);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // chunk q has landed; every warp is done with q - 1's planes
    if (q < nc) {
      split_x<kPhase == 0 && kUp>(rx + st * kRawX, sa, q * kCK, C, H, W, it, s_a, s_b, tid);
      split_w<9>(rw + st * kRawW, sb, tid);
    } else {
      split_r<kUp>(rx + st * kRawX, sa, tid);
      split_w<1>(rw + st * kRawW, sb, tid);
    }
    __syncthreads();
    if (q < nc)
      mma_chunk<9>(sa, sb, acc, rg, cq, lane);
    else
      mma_chunk<1>(sa, sb, acc, rg, cq, lane);
  }
  cp_wait<0>();

  // C fragment (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) = pixels
  // tx0 + g (+ 8) of row 2 rg + m, channels 32 cq + 8 j + 2t (+ 1)
  const int g = lane >> 2, t = lane & 3;
  const float* bias = kPhase == 0 ? p.bias0 : p.bias1;
  float* dst = kPhase == 0 ? p.ws : p.out;
  float ps[4][2], pss[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) ps[j][0] = ps[j][1] = pss[j][0] = pss[j][1] = 0.f;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int y = it.ty0 + 2 * rg + m;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = it.tx0 + g + 8 * h;
      if (y >= H || x >= W) continue;
      const size_t pix = ((size_t)it.b * H + y) * W + x;
      const int ys = kUp ? y >> 1 : y, xs = kUp ? x >> 1 : x;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = it.o0 + 32 * cq + 8 * j + 2 * t;
        if (o >= O) continue;
        const bool two = o + 1 < O;
        float v0 = acc[m][j][2 * h], v1 = acc[m][j][2 * h + 1];
        if (bias) {
          v0 += bias[o];
          if (two) v1 += bias[o + 1];
        }
        if (kPhase == 1 && p.skip_w) {
          if (p.skip_b) {
            v0 += p.skip_b[o];
            if (two) v1 += p.skip_b[o + 1];
          }
        } else if (kPhase == 1) {
          v0 += *xin_at(p, hin, win, it.b, ys, xs, o);
          if (two) v1 += *xin_at(p, hin, win, it.b, ys, xs, o + 1);
        }
        if (p.pair) {
          *reinterpret_cast<float2*>(dst + pix * O + o) = make_float2(v0, v1);
        } else {
          dst[pix * O + o] = v0;
          if (two) dst[pix * O + o + 1] = v1;
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
  if (kPhase == 0 || p.osums)
    store_partials(ps, pss, it, n_tiles, O, p.part_s, p.part_ss, smem);
}

// Two blocks an SM: 128 registers a thread and 109 KB of shared memory each.
template <bool kUp>
__global__ void __launch_bounds__(kThreads, 2) unet_block_kernel(const Args p) {
  cg::grid_group grid = cg::this_grid();
  const int n_tiles = ((p.H + kTH - 1) / kTH) * ((p.W + kTW - 1) / kTW);
  const int n_items = p.B * n_tiles * ((p.O + kBO - 1) / kBO);
  // phase 0: conv0 of the activated xin into the workspace
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) run_item<kUp, 0>(p, i);
  grid.sync();
  reduce_partials(p.part_s, p.part_ss, p.B, n_tiles, p.O, p.sums1, p.sumsq1);
  grid.sync();
  // phase 1: conv1 of the activated workspace, plus the skip path
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) run_item<kUp, 1>(p, i);
  if (p.osums) {
    grid.sync();
    reduce_partials(p.part_s, p.part_ss, p.B, n_tiles, p.O, p.osums, p.osumsq);
  }
}

// Blocks of the kernel that fit on one SM with its dynamic shared memory
// (opted into first: above 48 KB a kernel must ask, once per process).
template <bool kUp>
int blocks_per_sm(int* per_sm) {
  static int cached = 0;
  if (!cached) {
    cudaError_t e = cudaFuncSetAttribute(unet_block_kernel<kUp>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached, unet_block_kernel<kUp>,
                                                        kThreads, kSmemBytes);
    if (e != cudaSuccess) {
      cached = 0;
      return (int)e;
    }
  }
  *per_sm = cached;
  return 0;
}

int grid_limit(int up, int* per_sm, int* sms) {
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  const int rc = up ? blocks_per_sm<true>(per_sm) : blocks_per_sm<false>(per_sm);
  if (rc) return rc;
  return *per_sm < 1 ? (int)cudaErrorCooperativeLaunchTooLarge : 0;
}

bool aligned(const void* ptr, int bytes) {
  return ((uintptr_t)ptr & (uintptr_t)(bytes - 1)) == 0;
}


// ---------------------------------------------------------------------------
// bf16: unet_block_bf16_kernel<kUp, kM>, the route for the shapes
// TMA cannot describe (C1, C2 or O not a multiple of 8, an unaligned base,
// an identity skip with two inputs); the TMA route below takes the rest
// ---------------------------------------------------------------------------
//
// The Pallas kernel on a bf16 network (fused_block.py _mega_kernel): norm0
// from the chained statistics it is given, GroupNorm and SiLU in fp32 and
// the activation rounded once to bf16 (zero outside the image after the
// activation), conv0's bf16 products summed in fp32 with the fp32 bias0; h
// stored rounded to bf16, norm1's statistics from the fp32 sums before that
// rounding; norm1 + FiLM + SiLU of the rounded h in fp32, rounded once; the
// projection's bf16 products (skip_w in bf16) into the same fp32 sums, or
// the upcast identity added in fp32; the output rounded once to bf16, the
// emitted statistics from the fp32 sums.
//
// Bound at the identity block (B 16, 64 -> 64, res 128): the two convs'
// 3.87e10 FLOP at 989 TFLOP/s take 0.039 ms; x in and out out are 2 x 33.5
// MB (0.020 ms), 134 MB with the bf16 workspace's round trip (0.040 ms).
// So about 0.04 ms, products and bytes alike.
//
// Design: the fp32 kernel's schedule (one cooperative launch of a
// persistent grid, two grid barriers, per-tile partial statistics summed in
// a fixed order, so the kernel is deterministic) with gnsc_bf16_kernel's
// tiles (csrc/fused_norm_conv.cu; the layout and the copy and product
// helpers are bf16_conv_tiles.cuh's). A work item is one pixel tile of one
// sample, 8 kM rows x 16 columns, and 64 outputs, on 8 warps: warp w owns
// tile rows w and, with kM 2, w + 8; four warps make a warpgroup, whose 64
// pixels x 64 outputs a row set run on wgmma m64n64k16 (bf16 in, fp32 out),
// A (16 pixels x 16 channels a warp) by ldmatrix from 144-byte rows, B by
// descriptor from 128-byte XOR-swizzled weight rows on a 1024-byte
// boundary. With kM 2 (16 x 16 tiles) each warpgroup keeps two accumulators'
// product chains in flight, and the halo costs 1.27 times the tile's input
// against 1.41; it is taken where both phases' weights stay resident beside
// its stages (not the decoder's conv0 over 128 channels, 147 KB) and the
// tiles fill a wave. Input channels come 64 a chunk: the halo'd (8 kM + 2)
// x 18 tile (phase 0 with kUp: the low-res tile under it; a projection
// chunk: the tile's own pixels, with kUp each reading low-res pixel (y/2,
// x/2)), 16 bytes a cp.async into a two-stage ring; each thread applies
// GroupNorm and SiLU in place to
// the 16-byte pieces it copied, so no barrier waits between the copy and
// the activation. A decoder block's x and x2 are chunked apart (x's chunks,
// then x2's), so the concat is never made. Each block walks a contiguous
// run of pixel tiles of one 64-output block (the grid is a multiple of the
// output blocks), so a phase's weights for that block can stay in shared
// memory: every phase's weights that fit beside two stages are copied once
// when the phase starts; else they stream a chunk a step through two slots
// with the A tiles. The epilogue adds the bias (and skip bias, or the
// identity) to the fp32 sums, sums their statistics in registers over the
// block's run of tiles of one sample (one reduction over the block, in a
// fixed order, when the run leaves the sample), rounds the values into the
// warp's staging rows and stores each pixel row 16 bytes a lane. One block
// an SM (256 threads, up to 227 KB).

using bf16t::bf16;

constexpr int kCH = bf16t::kRowCh;                          // channels a chunk: one A row
// the widths, weight chunks, shared memory cap and tile rule that both bf16
// routes share: k7_plan.h, the TMA route's plan, a host compiler builds alone
using k7plan::kBigTileWaves;
using k7plan::kConvWBytes;    // a conv chunk's weights, 73,728
using k7plan::kProjWBytes;    // a projection chunk's, 8,192
using k7plan::kSmemCapH;
using k7plan::kVecBytes;      // bias, skip bias, scale, shift
using k7plan::pos_h;
using k7plan::rows_h;
static_assert(k7plan::kChunk == kCH && k7plan::kPixRow == bf16t::kWRowBytes &&
                  k7plan::kTileW == kTW && k7plan::kHaloW == kIW &&
                  k7plan::kMaxChannels == kMaxC,
              "k7_plan.h's widths are this source's");
constexpr int kRedBytes = 2 * kWarps * kCH * 4;             // the statistics' reduction
constexpr int kStagingBytes = kWarps * kTW * bf16t::kARowBytes;  // a warp's output row

// A tile of kM * 8 rows x 16 pixels (rows_h): warp w owns tile rows w + 8 m,
// m < kM. Positions of its halo'd A stage (pos_h) and of the up-block's
// low-res one, and bytes.
__host__ __device__ constexpr int lowpos_h(int km) { return (rows_h(km) / 2 + 2) * kLW; }
__host__ __device__ constexpr int stage_h(int km) { return pos_h(km) * bf16t::kARowBytes; }

struct ArgsH {
  const bf16* x;         // (B, Hin, Win, C1)
  const bf16* x2;        // (B, Hin, Win, C2) or null
  const float* g0;       // (B, C) folded norm0 scale, C = C1 + C2
  const float* b0;       // (B, C)
  const float* sums0;    // (B, C) xin's channel sums over Hin * Win pixels
  const float* sumsq0;
  const bf16* w0;        // (3, 3, C, O)
  const float* bias0;    // (O,) or null
  const float* g1;       // (B, O) folded norm1 + FiLM scale
  const float* b1;
  const bf16* w1;        // (3, 3, O, O)
  const float* bias1;
  const bf16* skip_w;    // (C, O) or null: identity (C == O)
  const float* skip_b;   // (O,) or null
  bf16* ws;              // (B, H, W, O) conv0's output, rounded
  float* part_s;         // (B, tiles, O) per-tile channel sums (fp32)
  float* part_ss;
  float* sums1;          // (B, O)
  float* sumsq1;
  bf16* out;             // (B, H, W, O)
  float* osums;          // (B, O) or null
  float* osumsq;
  int B, H, W, C1, C2, O, groups0, groups1;
  float eps;
  // 16-byte copies of x / x2 / the weights / ws; 16-byte stores of ws and out
  int xvec, x2vec, wvec, hvec, ovec;
  int res0, res1;        // phase 0's / phase 1's weights resident (else streamed)
  int n_ob;              // 64-output blocks; block i walks block i % n_ob
  int a_off, r_off, s_off, red_off;  // byte offsets in the 1024-aligned plane
};

// 64 channels of one source: channels c0 .. c0 + 63 of a source with cs
// channels a pixel, which are channels cb .. of the conv's input (the fold's
// and the weight rows' index)
struct Src {
  const bf16* p;
  int cs, c0, cb, vec;
};

struct Chunk {
  Src s;
  const bf16* w;  // the weights, (taps, wc, O)
  int wc, taps;
};

__device__ __forceinline__ int xin_chunks(const ArgsH& p) {
  return (p.C1 + kCH - 1) / kCH + (p.C2 + kCH - 1) / kCH;
}

// chunk j of xin: x's chunks, then x2's
__device__ __forceinline__ Src xin_chunk(const ArgsH& p, int j) {
  const int n1 = (p.C1 + kCH - 1) / kCH;
  if (j < n1) return Src{p.x, p.C1, j * kCH, j * kCH, p.xvec};
  const int c0 = (j - n1) * kCH;
  return Src{p.x2, p.C2, c0, p.C1 + c0, p.x2vec};
}

// Chunk q of a phase: phase 0, conv0 over xin's chunk q; phase 1, conv1 over
// the workspace's chunk q < nch, then the projection over xin's chunks
template <int kPhase>
__device__ __forceinline__ Chunk chunk_of(const ArgsH& p, int q) {
  const int C = p.C1 + p.C2;
  if (kPhase == 0) return Chunk{xin_chunk(p, q), p.w0, C, 9};
  const int nch = (p.O + kCH - 1) / kCH;
  if (q < nch) return Chunk{Src{p.ws, p.O, q * kCH, q * kCH, p.hvec}, p.w1, p.O, 9};
  return Chunk{xin_chunk(p, q - nch), p.skip_w, C, 1};
}

// The chunk's weight rows (tap * 64 + channel) for outputs o0 .. o0 + 63
// into W; zero past the source's channels and past O.
__device__ __forceinline__ void load_w_h(const ArgsH& p, const Chunk& ch, unsigned char* W,
                                         int o0, int tid) {
  for (int idx = tid; idx < ch.taps * kCH * 8; idx += kThreads) {
    const int row = idx >> 3, k = idx & 7;
    const int tap = row / kCH, cl = row % kCH;
    const bool ok = ch.s.c0 + cl < ch.s.cs;
    bf16t::copy8(W + bf16t::w_byte(row, k),
                 ok ? ch.w + ((size_t)tap * ch.wc + ch.s.cb + cl) * p.O + o0 + 8 * k : ch.w, ok,
                 o0 + 8 * k, p.O, p.wvec, ch.w);
  }
}

// The source's 64 channels at the npos positions of a (cols)-wide window
// whose first position is (y0, x0) of sample b (the source sh x sw pixels)
// into A stage A, 16 bytes a copy; zero outside the source and past its
// channels (nothing read there). Thread tid copies items tid, tid + 256, ...
// of (position, 8-channel piece): activate_h takes the same items.
__device__ __forceinline__ void load_a_h(const Src& s, int b, int sh, int sw, int npos, int cols,
                                         int y0, int x0, unsigned char* A, int tid) {
  const bf16* base = s.p + (size_t)b * sh * sw * s.cs;
  for (int idx = tid; idx < npos * 8; idx += kThreads) {
    const int pos = idx >> 3, k = idx & 7;
    const int y = y0 + pos / cols, x = x0 + pos % cols, c = s.c0 + 8 * k;
    const bool in = y >= 0 && y < sh && x >= 0 && x < sw;
    bf16t::copy8(A + bf16t::a_byte(pos, k), in ? base + ((size_t)y * sw + x) * s.cs + c : s.p,
                 in, c, s.cs, s.vec, s.p);
  }
}

// A projection chunk: the tile's own 8 kM x 16 pixels (kUp: pixel (y, x)
// reads low-res pixel (y/2, x/2)).
template <bool kUp, int kM>
__device__ __forceinline__ void load_a_proj(const ArgsH& p, const Src& s, int b, int ty0,
                                            int tx0, unsigned char* A, int tid) {
  const int hin = kUp ? p.H / 2 : p.H, win = kUp ? p.W / 2 : p.W;
  const bf16* base = s.p + (size_t)b * hin * win * s.cs;
  for (int idx = tid; idx < rows_h(kM) * kTW * 8; idx += kThreads) {
    const int pos = idx >> 3, k = idx & 7;
    const int y = ty0 + pos / kTW, x = tx0 + pos % kTW, c = s.c0 + 8 * k;
    const bool in = y < p.H && x < p.W;
    const int ys = kUp ? y >> 1 : y, xs = kUp ? x >> 1 : x;
    bf16t::copy8(A + bf16t::a_byte(pos, k), in ? base + ((size_t)ys * win + xs) * s.cs + c : s.p,
                 in, c, s.cs, s.vec, s.p);
  }
}

// GroupNorm (+ FiLM) and SiLU in fp32 on a conv chunk's A stage, in place,
// each value rounded once to bf16, on the items this thread copied. The
// scale and shift of channels past the source's are zero, so those come out
// silu(0) = 0; positions outside the image keep the copy's zeros (SAME
// padding of the ACTIVATED tensor).
__device__ __forceinline__ void activate_h(const Src& s, int sh, int sw, int npos, int cols,
                                           int y0, int x0, unsigned char* A, const float* s_sc,
                                           const float* s_sh, int tid) {
  const int k = tid & 7, cl = s.c0 + 8 * k;
  if (cl >= s.cs) return;
  const int cg = s.cb + 8 * k;
  float sc[8], sh_[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool ok = cl + i < s.cs;
    sc[i] = ok ? s_sc[cg + i] : 0.f;
    sh_[i] = ok ? s_sh[cg + i] : 0.f;
  }
#pragma unroll 2
  for (int pos = tid >> 3; pos < npos; pos += kThreads / 8) {
    const int y = y0 + pos / cols, x = x0 + pos % cols;
    if (y < 0 || y >= sh || x < 0 || x >= sw) continue;
    uint4* ptr = reinterpret_cast<uint4*>(A + bf16t::a_byte(pos, k));
    const uint4 raw = *ptr;
    const uint32_t v[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lo = __uint_as_float(v[i] << 16), hi = __uint_as_float(v[i] & 0xffff0000u);
      o[i] = bf16t::pack2(bf16t::silu_fast(lo * sc[2 * i] + sh_[2 * i]),
                          bf16t::silu_fast(hi * sc[2 * i + 1] + sh_[2 * i + 1]));
    }
    *ptr = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// One chunk's products of the warpgroup's kM x 64 pixels (tile rows r + 8 m
// of its four warps, one a warp) x 64 outputs: kTaps taps (9, or the
// projection's one) x 4 k16 steps of wgmma m64n64k16 into kM accumulators.
// A positions: the halo'd (8 kM + 2) x 18 tile; kLo, the low-res tile under
// it (lane pixel (y/2, x/2)); one tap, the tile's own pixels. A tap's A
// fragments (the warp's 16 pixels x 64 channels of each row) come by
// ldmatrix, and its 4 kM products are issued back to back as one group. kM
// 1: two fragment buffers, tap t + 1's loaded while tap t's products run;
// kM 2: one buffer, the two accumulators' chains in flight together. B is
// read through a descriptor.
template <int kTaps, bool kLo, int kM>
__device__ __forceinline__ void mma_chunk_h(uint32_t A, uint32_t W, float (&acc)[kM][32],
                                            int r, int lane) {
  constexpr int kCols = kLo ? kLW : kIW;
  constexpr int kBuf = kM == 1 ? 2 : 1;
  const int ri = lane & 7, mi = lane >> 3;
  const int px = ri + 8 * (mi & 1);    // the lane's A row: pixel of the tile row
  const uint32_t ak = (mi >> 1) << 4;  // and its 8-channel half of a k16 step
  auto load_tap = [&](int tap, uint32_t (&a)[kM][4][4]) {
    const int dy = tap / 3, dx = tap % 3;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int rr = r + 8 * m;
      const int pos = kTaps == 1 ? rr * kTW + px
                      : kLo     ? (((rr + dy - 1) >> 1) + 1) * kCols + ((px + dx - 1) >> 1) + 1
                                : (rr + dy) * kCols + px + dx;
      const uint32_t row = A + pos * bf16t::kARowBytes + ak;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) bf16t::ldsm_x4(row + 32 * kk, a[m][kk]);
    }
  };
  uint32_t a[kBuf][kM][4][4];
  load_tap(0, a[0]);
#pragma unroll
  for (int tap = 0; tap < kTaps; ++tap) {
    const uint64_t desc = bf16t::wg_desc(W + tap * kCH * bf16t::kWRowBytes);
    bf16t::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int m = 0; m < kM; ++m)
        // the descriptor's address counts 16 bytes: k16 step kk is 16
        // weight rows (2,048 bytes) on
        bf16t::wg_mma(acc[m], a[tap % kBuf][m][kk], desc + kk * (16 * bf16t::kWRowBytes >> 4));
    bf16t::wg_commit();
    if (tap + 1 < kTaps) {
      if (kBuf == 2) {
        bf16t::wg_wait<1>();  // tap t - 1's products are done with the other buffer
      } else {
        bf16t::wg_wait<0>();  // tap t's products are done with the buffer
      }
      load_tap(tap + 1, a[(tap + 1) % kBuf]);
    }
  }
  bf16t::wg_wait<0>();
}

// xin's channel c at pixel (y, x) of sample b (hin x win pixels), in fp32
__device__ __forceinline__ float xin_h(const ArgsH& p, int hin, int win, int b, int y, int x,
                                       int c) {
  const size_t pix = ((size_t)b * hin + y) * win + x;
  return __bfloat162float(c < p.C1 ? p.x[pix * p.C1 + c] : p.x2[pix * p.C2 + (c - p.C1)]);
}

// Phase kPhase over the block's pixel tiles [t_begin, t_end) at outputs o0
// .. o0 + 63: each tile a run of steps, one a chunk, through a two-stage
// ring (step s + 1's copies are issued before step s's products). Phase 0
// writes conv0 + bias0 rounded to the workspace and each tile's partial
// statistics; phase 1 adds bias1 and the skip, writes out and, to emit
// statistics, out's partials. Tiles of kM * 8 rows.
template <bool kUp, int kPhase, int kM>
__device__ __forceinline__ void run_phase_h(const ArgsH& p, unsigned char* sm, int t_begin,
                                            int t_end, int o0) {
  constexpr int kRows = rows_h(kM), kStage = stage_h(kM);
  unsigned char* stage0 = sm + p.a_off;
  float* s_bias = reinterpret_cast<float*>(sm + p.s_off);  // [64] bias of the O-block
  float* s_skb = s_bias + kCH;                              // [64] skip bias
  float* s_sc = s_skb + kCH;                                // [kMaxC] folded scale
  float* s_sh = s_sc + kMaxC;                               // [kMaxC] and shift
  float* red = reinterpret_cast<float*>(sm + p.red_off);    // [2][kWarps][64]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int H = p.H, W = p.W, O = p.O, C = p.C1 + p.C2;
  const int hin = kUp ? H / 2 : H, win = kUp ? W / 2 : W;
  const int tiles_w = (W + kTW - 1) / kTW;
  const int n_tiles = ((H + kRows - 1) / kRows) * tiles_w;
  const int nch = (O + kCH - 1) / kCH;
  const bool proj = p.skip_w != nullptr;
  const int nq = kPhase == 0 ? xin_chunks(p) : nch + (proj ? xin_chunks(p) : 0);
  const bool resident = kPhase == 0 ? p.res0 : p.res1;
  const int steps = (t_end - t_begin) * nq;
  if (steps == 0) return;
  const bool stats = kPhase == 0 || p.osums != nullptr;
  if (tid < kCH) {
    const int o = o0 + tid;
    const float* bias = kPhase == 0 ? p.bias0 : p.bias1;
    s_bias[tid] = bias && o < O ? bias[o] : 0.f;
    s_skb[tid] = kPhase == 1 && proj && p.skip_b && o < O ? p.skip_b[o] : 0.f;
  }
  auto tile_of = [&](int t, int& b, int& ty0, int& tx0) {
    b = t / n_tiles;
    const int rem = t - b * n_tiles;
    ty0 = (rem / tiles_w) * kRows;
    tx0 = (rem % tiles_w) * kTW;
  };
  // chunk q's weights: resident, conv chunks first, then the projection's;
  // streamed, the slot of step s
  auto w_at = [&](int q, int s) -> unsigned char* {
    if (!resident) return sm + (s & 1) * kConvWBytes;
    return sm + (kPhase == 0 || q < nch ? q * kConvWBytes
                                        : nch * kConvWBytes + (q - nch) * kProjWBytes);
  };
  auto load_step = [&](int s) {
    const int q = s % nq;
    int b, ty0, tx0;
    tile_of(t_begin + s / nq, b, ty0, tx0);
    unsigned char* A = stage0 + (s & 1) * kStage;
    const Chunk ch = chunk_of<kPhase>(p, q);
    if (ch.taps == 1)
      load_a_proj<kUp, kM>(p, ch.s, b, ty0, tx0, A, tid);
    else if (kPhase == 0 && kUp)
      load_a_h(ch.s, b, hin, win, lowpos_h(kM), kLW, ty0 / 2 - 1, tx0 / 2 - 1, A, tid);
    else
      load_a_h(ch.s, b, H, W, pos_h(kM), kIW, ty0 - 1, tx0 - 1, A, tid);
    if (!resident) load_w_h(p, ch, w_at(q, s), o0, tid);
  };

  if (resident)
    for (int q = 0; q < nq; ++q) load_w_h(p, chunk_of<kPhase>(p, q), w_at(q, 0), o0, tid);
  load_step(0);
  bf16t::commit();

  float acc[kM][32];
  float ps[8][2], pss[8][2];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) ps[j][0] = ps[j][1] = pss[j][0] = pss[j][1] = 0.f;
  int scale_b = -1;  // the sample whose folded scale and shift s_sc / s_sh hold

  for (int s = 0; s < steps; ++s) {
    const int tile = t_begin + s / nq, q = s % nq;
    int b, ty0, tx0;
    tile_of(tile, b, ty0, tx0);
    const Chunk ch = chunk_of<kPhase>(p, q);
    unsigned char* A = stage0 + (s & 1) * kStage;
    // step s's copies have landed, this thread's at least; the activation
    // pass takes the items this thread copied
    bf16t::wait<0>();
    if (q == 0 && b != scale_b) {
      // every warp is past step s - 1's activation pass (the last barrier)
      if (kPhase == 0)
        fold(p.sums0, p.sumsq0, p.g0, p.b0, C, p.groups0, (float)hin * (float)win, p.eps, b,
             s_sc, s_sh, tid);
      else
        fold(p.sums1, p.sumsq1, p.g1, p.b1, O, p.groups1, (float)H * (float)W, p.eps, b, s_sc,
             s_sh, tid);
      scale_b = b;
      __syncthreads();
    }
    if (ch.taps == 9) {
      if (kPhase == 0 && kUp)
        activate_h(ch.s, hin, win, lowpos_h(kM), kLW, ty0 / 2 - 1, tx0 / 2 - 1, A, s_sc,
                   s_sh, tid);
      else
        activate_h(ch.s, H, W, pos_h(kM), kIW, ty0 - 1, tx0 - 1, A, s_sc, s_sh, tid);
    }
    bf16t::fence_async_smem();
    __syncthreads();  // step s is staged; every warp is done with step s - 1
    if (s + 1 < steps) load_step(s + 1);  // into step s - 1's stage
    bf16t::commit();
    const uint32_t wb = bf16t::smem_addr(w_at(q, s)), ab = bf16t::smem_addr(A);
    if (ch.taps == 1)
      mma_chunk_h<1, false, kM>(ab, wb, acc, warp, lane);
    else if (kPhase == 0 && kUp)
      mma_chunk_h<9, true, kM>(ab, wb, acc, warp, lane);
    else
      mma_chunk_h<9, false, kM>(ab, wb, acc, warp, lane);
    if (q != nq - 1) continue;

    // epilogue, warp by warp as its products end: pixels g, g + 8 of tile
    // rows warp + 8 m, outputs 8 j + 2 t4 (+ 1); bias (and skip bias, or the
    // identity) added to the fp32 sums, their statistics summed in
    // registers, the values rounded once into the warp's staging rows S,
    // then stored a pixel row at a time
    bf16* dst0 = kPhase == 0 ? p.ws : p.out;
    unsigned char* S = sm + p.r_off + warp * kTW * bf16t::kARowBytes;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int y = ty0 + warp + 8 * m;
      float add[8][2][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ol = 8 * j + 2 * t4, o = o0 + ol;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = tx0 + g + 8 * h;
          add[j][h][0] = s_bias[ol] + s_skb[ol];
          add[j][h][1] = s_bias[ol + 1] + s_skb[ol + 1];
          if (kPhase == 1 && !proj && y < H && x < W && o < O) {
            const int ys = kUp ? y >> 1 : y, xs = kUp ? x >> 1 : x;
            add[j][h][0] += xin_h(p, hin, win, b, ys, xs, o);
            if (o + 1 < O) add[j][h][1] += xin_h(p, hin, win, b, ys, xs, o + 1);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ol = 8 * j + 2 * t4, o = o0 + ol;
        const bool two = o + 1 < O;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = g + 8 * h, x = tx0 + px;
          const float v0 = acc[m][4 * j + 2 * h] + add[j][h][0];
          const float v1 = acc[m][4 * j + 2 * h + 1] + add[j][h][1];
          acc[m][4 * j + 2 * h] = acc[m][4 * j + 2 * h + 1] = 0.f;
          *reinterpret_cast<uint32_t*>(S + bf16t::a_byte(px, 0) + 2 * ol) =
              bf16t::pack2(v0, v1);
          if (y >= H || x >= W || o >= O) continue;
          ps[j][0] += v0;
          pss[j][0] += v0 * v0;
          if (two) {
            ps[j][1] += v1;
            pss[j][1] += v1 * v1;
          }
        }
      }
      // the row's 16 pixels x 64 outputs from the warp's staging rows, 16
      // bytes a lane
      __syncwarp();
      for (int idx = lane; idx < kTW * 8; idx += 32) {
        const int px = idx >> 3, k = idx & 7, x = tx0 + px, o = o0 + 8 * k;
        if (y >= H || x >= W || o >= O) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(S + bf16t::a_byte(px, k));
        bf16* dst = dst0 + (((size_t)b * H + y) * W + x) * O + o;
        if (p.ovec) {
          *reinterpret_cast<uint4*>(dst) = v;
        } else {
          const bf16* e = reinterpret_cast<const bf16*>(&v);
          for (int i = 0; i < 8 && o + i < O; ++i) dst[i] = e[i];
        }
      }
      __syncwarp();
    }
    if (!stats) continue;
    // The statistics stay in registers over the block's run of tiles of
    // sample b; when the run leaves b (or ends) they are summed over g (lane
    // bits 2-4) by shuffles, then over the warps in order, into the slot of
    // the run's last tile of b; the run's other tiles of b get zeros. The
    // reduction over the slots sums them in a fixed order: deterministic.
    // (the slots are (B, tiles, O): tile t of the run is slot t)
    const size_t slot = (size_t)tile * O + o0 + tid;
    if (tile + 1 < t_end && (tile + 1) / n_tiles == b) {
      if (tid < kCH && o0 + tid < O) p.part_s[slot] = p.part_ss[slot] = 0.f;
      continue;
    }
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
    if (tid < kCH && o0 + tid < O) {
      float sum = 0.f, ssq = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        sum += red[w * kCH + tid];
        ssq += red[(kWarps + w) * kCH + tid];
      }
      p.part_s[slot] = sum;
      p.part_ss[slot] = ssq;
    }
  }
  bf16t::wait<0>();
}

// One block an SM (256 threads; shared memory up to 227 KB, registers up to
// 255 a thread). Block i walks output block i % n_ob over a contiguous run
// of the pixel tiles (kM * 8 rows x 16 columns), the same run in both
// phases.
template <bool kUp, int kM>
__global__ void __launch_bounds__(kThreads, 1) unet_block_bf16_kernel(const ArgsH p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(128) unsigned char smem_h[];
  unsigned char* sm = bf16t::align1024(smem_h);  // wgmma's 128-byte swizzle
  const int n_tiles = ((p.H + rows_h(kM) - 1) / rows_h(kM)) * ((p.W + kTW - 1) / kTW);
  const int ntiles = p.B * n_tiles, nb = gridDim.x / p.n_ob;
  const int rank = blockIdx.x / p.n_ob, o0 = (blockIdx.x % p.n_ob) * kCH;
  const int t_begin = (int)((long long)rank * ntiles / nb);
  const int t_end = (int)((long long)(rank + 1) * ntiles / nb);
  run_phase_h<kUp, 0, kM>(p, sm, t_begin, t_end, o0);
  grid.sync();
  reduce_partials(p.part_s, p.part_ss, p.B, n_tiles, p.O, p.sums1, p.sumsq1);
  grid.sync();
  run_phase_h<kUp, 1, kM>(p, sm, t_begin, t_end, o0);
  if (p.osums) {
    grid.sync();
    reduce_partials(p.part_s, p.part_ss, p.B, n_tiles, p.O, p.osums, p.osumsq);
  }
}

// The launch plan of one bf16 call. Tile: 16 x 16 pixels (kM 2) where that
// gives kBigTileWaves tiles a block or more and both phases' weights stay
// resident beside two of its A stages, else 8 x 16 (kM 1). Each phase's
// weights resident when they fit beside the two A stages and the rest,
// else streamed through two conv-chunk slots. Shared memory, in this
// order: weights, the A stages, the warps' output staging rows, bias / skip
// bias / scale / shift, the statistics' reduction, and 1024 bytes for the
// plane's alignment.
struct PlanH {
  int km, res0, res1, smem, bps, sms, blocks, n_ob, a_off, r_off, s_off, red_off;
};

template <bool kUp, int kM>
int blocks_per_sm_h(int smem) {
  static int cache[kSmemCapH / 1024 + 2] = {};
  static cudaError_t attr = cudaFuncSetAttribute(
      unet_block_bf16_kernel<kUp, kM>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCapH);
  const int kb = (smem + 1023) / 1024;
  int& n = cache[kb];
  if (!n && (attr != cudaSuccess ||
             cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &n, unet_block_bf16_kernel<kUp, kM>, kThreads,
                 kb * 1024 < kSmemCapH ? kb * 1024 : kSmemCapH) != cudaSuccess))
    n = 0;
  return n;
}

// The layout of tile kM's plan; false where it does not fit.
bool layout_h(int km, int all0, int all1, PlanH& pl) {
  const int stage = stage_h(km), rest = kStagingBytes + kVecBytes + kRedBytes + 1024;
  const int wmax = kSmemCapH - (2 * stage + rest);
  pl.km = km;
  pl.res0 = all0 <= wmax;
  pl.res1 = all1 <= wmax;
  const int w0b = pl.res0 ? all0 : 2 * kConvWBytes, w1b = pl.res1 ? all1 : 2 * kConvWBytes;
  const int wbytes = w0b > w1b ? w0b : w1b;
  if (wbytes > wmax) return false;
  pl.a_off = wbytes;
  pl.r_off = pl.a_off + 2 * stage;
  pl.s_off = pl.r_off + kStagingBytes;
  pl.red_off = pl.s_off + kVecBytes;
  pl.smem = pl.red_off + kRedBytes + 1024;
  return true;
}

int plan_h(bool up, int batch, int h, int wd, int c1, int c2, int o, bool proj, PlanH& pl) {
  const int ncx = (c1 + kCH - 1) / kCH + (c2 + kCH - 1) / kCH, nch = (o + kCH - 1) / kCH;
  const int all0 = ncx * kConvWBytes, all1 = nch * kConvWBytes + (proj ? ncx * kProjWBytes : 0);
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  pl.sms = bf16t::sm_count();
  pl.n_ob = nch;
  const long long tiles16 = (long long)batch * ((h + 15) / 16) * ((wd + kTW - 1) / kTW);
  const bool big = tiles16 * nch >= (long long)kBigTileWaves * pl.sms &&
                   layout_h(2, all0, all1, pl) && pl.res0 && pl.res1;
  if (!big && !layout_h(1, all0, all1, pl)) return (int)cudaErrorInvalidConfiguration;
  pl.bps = pl.km == 2 ? (up ? blocks_per_sm_h<true, 2>(pl.smem) : blocks_per_sm_h<false, 2>(pl.smem))
                      : (up ? blocks_per_sm_h<true, 1>(pl.smem) : blocks_per_sm_h<false, 1>(pl.smem));
  if (pl.bps < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long tiles = (long long)batch * ((h + rows_h(pl.km) - 1) / rows_h(pl.km)) *
                          ((wd + kTW - 1) / kTW);
  const long long cap = (long long)pl.bps * pl.sms / nch;  // blocks an output block
  pl.blocks = (int)((tiles < cap ? tiles : cap) * nch);
  return pl.blocks < nch ? (int)cudaErrorCooperativeLaunchTooLarge : 0;
}


// ---------------------------------------------------------------------------
// bf16 on TMA: unet_block_bf16_tma_kernel<kUp, kM, kWG> (the route where
// C1, C2 and O are multiples of 8, every base 16-byte aligned, and an
// identity skip has one input)
// ---------------------------------------------------------------------------
//
// The same function as unet_block_bf16_kernel above (its header), the same
// schedule (one cooperative launch; phase 0, a grid barrier, the per-tile
// partials summed in a fixed order, phase 1, and the optional emit; no
// atomics, the same bits on every call) and the same work items (8 kM x 16
// pixels of one sample and 64 outputs, a block walking a contiguous run of
// tiles of one output block). What changes is who does what, and when.
// unet_block_bf16_kernel runs everything in series in one block of 8
// warps: a step's copies are waited for, activated in place, a block
// barrier taken, and only then the products run, so that without its
// products it still takes 0.211 of its 0.266 ms at the res-128 identity
// block.
//
// Roles. Warpgroup 0 (128 threads) activates; kWG consumer warpgroups
// multiply and store, and their leaders (thread 0 of each) issue the TMA
// copies. A ring of `stages` A stages (as many as fit, 2 to kTmaStagesMax)
// under three mbarriers each: `full` (the TMA copy's bytes), `act` (warpgroup
// 0's warps have activated it) and `empty` (every consumer warp is done with
// it). No block-wide barrier remains in the step loop: a step is handed on by
// barriers alone, so warpgroup 0 activates step s + 1 while the consumers
// multiply step s. A leader issues step s + stages's copy into step s's stage
// once it is empty, the two leaders in turns (a copy's issue takes its
// thread 0.3-0.5 us; on warpgroup 0's thread 0 it held the activation
// behind it, and in one leader alone that warpgroup fell behind the other).
// Copies. The A stages arrive by cp.async.bulk.tensor from 4-D tensor maps
// over NHWC ((C, W, H, B), innermost first): the halo'd box (64, 18, 8 kM +
// 2, 1) at signed start coordinates (tx0 - 1, ty0 - 1), so TMA's zero fill
// past the bounds gives the raw halo (with kUp phase 0 reads x's low-res box
// (64, 10, 4 kM + 2, 1) under the tile); x and x2 have maps of their own, so
// the concat is never made, and ws has its own in phase 1. A projection
// chunk is the centre tap of the same halo'd box (its copy is 1.27 / 1.41
// times the pixels it needs; no map of its own). Rows are 128 bytes (a
// pixel's 64 channels) under the 128-byte swizzle: 16-byte chunk j of
// position p sits at j ^ (p & 7). The weights come by TMA too, 64 x 64 x 1
// boxes of (O, C, taps) maps, into wgmma's B layout as they are (the same
// swizzle), once a phase where they fit, else a chunk a step with its A
// stage (the 128 + 128 -> 128 case).
// Activation. Thread tid takes channel chunk c = tid & 7 at positions tid /
// 8, + 16, ...: the physical chunk is c ^ (p & 7), the scale and shift
// those of the un-swizzled channel (in registers for the step); GroupNorm
// (+ FiLM) and SiLU in fp32, rounded once; positions outside the image are
// written zero (TMA's zeros would activate to silu(shift)).
// Products. wgmma m64n64k16, A from registers by ldmatrix (a lane's row
// address applies the XOR), B by descriptor from the resident weights.
// Warpgroup w owns tile rows w * 8 kM / kWG .. (kA = 2 kM / kWG accumulators
// of four rows, a row a warp), so a warpgroup's rows are one TMA box.
// Epilogue. The identity's residual (x at the tile's own pixels, channels
// o0 .., with kUp the low-res pixels under them) is copied by TMA into the
// warpgroup's staging rows (kUp: a low-res buffer of its own) by the
// warpgroup's leader while the tile's last products run, once the last
// tile's store has read them; the fp32 sums plus bias, skip bias or
// residual are summed into the statistics (registers over the run of one
// sample's tiles, shuffles, the consumer warps in order, one slot a tile:
// unet_block_bf16_kernel's order), rounded once into the staging rows (the
// same swizzle) and stored by one cp.async.bulk.tensor of (64, 16, rows,
// 1), which clips the ragged edge: ws in phase 0, out in phase 1. Phase
// 0's stores are waited for complete (not only read) and fenced for the
// async proxy before the grid barrier, past which phase 1's TMA reads ws.
// Host. The plan is k7_plan.h's (plain C++, built alone by the CPU tests).
// Each call encodes its tensor maps (up to nine) by cuTensorMapEncodeTiled,
// as the K5 / K6 wrappers do.
//
// Shared memory of the flagship's 13 launches a forward (B 16, ch 64; of
// 232,448 bytes): the identity block at res 128 and 64, 16 x 16 tiles, 2
// stages of 41,984, 73,728 of resident weights, 32,768 of staging: 198,400;
// at res 32 (three launches), 8 x 16 (16 x 16 tiles would not fill a wave),
// 4 stages of 23,552: 192,256; the decoder's 64 + 64 -> 64 block with its
// projection at res 128, 64 and 32 (six), 8 x 16 (phase 0's 147,456 bytes
// of weights leave room for 2 stages of 23,552 only): 218,880; the up blocks
// to res 128 and 64, 16 x 16 with a low-res residual buffer of 8,192:
// 206,592. The 128 + 128 -> 128 case streams both phases' weights, 2 stages
// of 97,280: 218,880.
//
// Measured (kernels/attention_sources.py --kernel k7bf16, one H100 80GB
// HBM3 at 700 W; PERF.md section 6): see PERF.md for every launch kind. A
// block-0 clock64 trace of the identity block (8 x 16 tiles) reads a stage's
// activation at 2.6-3.0 us and a consumer step at 3.5-4.5 us (products
// 1.8-2.0, the epilogue and the copies' issue the rest), against 1.26 us of
// products at the tensor cores' peak. Tried and dropped, each by its
// variant: four consumer warpgroups of one accumulator at 16 x 16 tiles
// (k7bf16_wg_4: at 640 threads 96 registers a thread, 384-604 bytes of
// spills, 0.224 against 0.196 ms at the res-128 identity block);
// setmaxnreg moving warpgroup 0's registers to the consumers (ptxas still
// allocated the launch bounds' 168 and spilled more, 1.23-1.57 against
// 1.17-1.34 ms a forward in three calls); 8 x 16 tiles at
// the identity and up blocks (k7bf16_tiles_8: 0.158-0.166 against
// 0.146-0.153); one or four positions an activation pass (k7bf16_act_items_1
// / _4: within 1 %); the producer on warpgroup 0's thread 0, issuing
// between its activation passes (1.61 ms a forward: the polls slowed its
// warp's activation to 5.4 us a stage); the leaders claiming each copy by an
// atomic after one arrival a warpgroup (1.20 ms). The activation's SiLU
// takes the flush-to-zero MUFU forms (k7bf16_act_no_ftz: the same values,
// 1 % slower).

// The plan (tile, warpgroups, stages, residency, the shared memory's
// layout) is k7_plan.h's, with its ring sizes and the byte sizes below.
using k7plan::kBarBytes;      // the mbarriers
using k7plan::kPixRow;        // one position's 64 channels: a TMA row, 128 bytes
using k7plan::kTmaStagesMax;  // ring stages at most
using k7plan::kWideWG;        // consumer warpgroups at 16 x 16 tiles
using k7plan::PlanT;
using k7plan::resbuf_t;       // the up block's low-res residual under the tile
using k7plan::stage_t;        // a ring stage's A part
using k7plan::stg_t;          // the output staging of all warpgroups
constexpr int kActThreads = 128;  // warpgroup 0: the activation
// tma::mbar_wait with a suspend-time hint, so that a waiting warp sleeps on
// the barrier instead of taking issue slots from the warps that work, and a
// trap (a launch failure, which the wrapper raises) once a wait has lasted
// kWaitCycles, where a lost arrival would hang the card
constexpr unsigned kSuspendNs = 10000000;
constexpr long long kWaitCycles = 1ll << 34;
__device__ __forceinline__ void wait_t(unsigned long long* bar, unsigned parity) {
  long long t0 = -1;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred P1;\n mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2, %3;\n"
        " selp.b32 %0, 1, 0, P1;\n}"
        : "=r"(done) : "r"(tma::smem_u32(bar)), "r"(parity), "r"(kSuspendNs) : "memory");
    if (done) return;
    const long long t = clock64();
    if (t0 < 0) t0 = t;
    else if (t - t0 > kWaitCycles) __trap();
  }
}

struct alignas(64) MapsT {
  CUtensorMap xa, x2a, wsa;  // A stages: (64, 18, 8 kM + 2, 1) boxes (x's (64, 10, 4 kM + 2, 1) with kUp)
  CUtensorMap wss, outs;     // stores: (64, 16, rows a warpgroup, 1)
  CUtensorMap xr;            // the identity's residual: (64, 16, rows a warpgroup, 1) (kUp: (64, 8, half that, 1))
  CUtensorMap w0, w1, sk;    // weights (O, C, taps): (64, 64, 1) boxes
};

struct ArgsT {
  const float *g0, *b0, *sums0, *sumsq0, *bias0, *g1, *b1, *bias1, *skip_b;
  float *part_s, *part_ss, *sums1, *sumsq1, *osums, *osumsq;
  int B, H, W, C1, C2, O, groups0, groups1;
  float eps;
  int proj, res0, res1, stages, n_ob;
  int stage_bytes, ring_off, stg_off, rb_off, vec_off, red_off, bar_off;  // bytes in the plane
};

// 64 channels of a chunk: the A stage's map and whether it is x's low-res
// tile (kUp), the weights' map, channels c0 .. of a source of cs channels,
// which are the conv's input channels cb ..
struct ChunkT {
  const CUtensorMap *a, *w;
  int c0, cb, cs, taps;
  bool lo;
};

// chunk q of phase kPhase (chunk_of's order)
template <bool kUp, int kPhase>
__device__ __forceinline__ ChunkT chunk_t(const MapsT& mp, const ArgsT& p, int q) {
  const int nch = (p.O + kCH - 1) / kCH, n1 = (p.C1 + kCH - 1) / kCH;
  if (kPhase == 1 && q < nch) return ChunkT{&mp.wsa, &mp.w1, q * kCH, q * kCH, p.O, 9, false};
  const int j = kPhase == 0 ? q : q - nch;
  const bool two = j >= n1;
  const int c0 = (two ? j - n1 : j) * kCH;
  return ChunkT{two ? &mp.x2a : &mp.xa, kPhase == 0 ? &mp.w0 : &mp.sk, c0,
                two ? p.C1 + c0 : c0, two ? p.C2 : p.C1, kPhase == 0 ? 9 : 1, kUp};
}

// bf16t::silu_fast on the flush-to-zero forms of MUFU.EX2 and MUFU.RCP: the
// same values wherever neither exp(-y) nor 1 + exp(-y) is subnormal, without
// the subnormal fix-ups around each
__device__ __forceinline__ float silu_ftz(float y) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(y * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return y * r;
}

// GroupNorm (+ FiLM) and SiLU in fp32 on a conv chunk's A stage, in place,
// rounded once to bf16: thread tid (of warpgroup 0) takes channels c0 + 8c
// .. + 7, c = tid & 7, at positions tid / 8, + 16, ..., kActItems positions
// a pass (their loads first, no branch on the data: a pass's values are in
// flight together); the 128-byte swizzle keeps them in 16-byte chunk c ^
// (pos & 7) of the position's row, and the scale and shift are the
// un-swizzled channel's. Positions outside the image are written zero
// (SAME padding of the ACTIVATED tensor: TMA's zero fill would activate to
// silu(shift)); chunks past the source's channels stay TMA's zeros, and a
// chunk's channels past them take scale and shift 0.
constexpr int kActItems = 2;  // positions a thread activates a pass
template <bool kLo, int kM>
__device__ __forceinline__ void activate_t(unsigned char* A, const ChunkT& ch, int sh, int sw,
                                           int y0, int x0, const float* s_sc,
                                           const float* s_sh, int tid) {
  constexpr int kCols = kLo ? kLW : kIW;
  constexpr int kPos = kLo ? lowpos_h(kM) : pos_h(kM);
  constexpr int kStride = kActThreads / 8;  // positions apart
  const int c = tid & 7, cl = ch.c0 + 8 * c;
  if (cl >= ch.cs) return;
  float sc[8], sf[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool ok = cl + i < ch.cs;
    sc[i] = ok ? s_sc[ch.cb + 8 * c + i] : 0.f;
    sf[i] = ok ? s_sh[ch.cb + 8 * c + i] : 0.f;
  }
  for (int p0 = tid >> 3; p0 < kPos; p0 += kActItems * kStride) {
    uint4* ptr[kActItems];
    uint4 raw[kActItems];
    bool in[kActItems], has[kActItems];
#pragma unroll
    for (int k = 0; k < kActItems; ++k) {
      const int pos = p0 + k * kStride;
      has[k] = pos < kPos;
      const int pp = has[k] ? pos : p0;  // a pass's tail reads a position it has
      const int y = y0 + pp / kCols, x = x0 + pp % kCols;
      in[k] = y >= 0 && y < sh && x >= 0 && x < sw;
      ptr[k] = reinterpret_cast<uint4*>(A + pp * kPixRow + ((c ^ (pp & 7)) << 4));
      raw[k] = *ptr[k];
    }
#pragma unroll
    for (int k = 0; k < kActItems; ++k) {
      const uint32_t v[4] = {raw[k].x, raw[k].y, raw[k].z, raw[k].w};
      uint32_t o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float lo = __uint_as_float(v[i] << 16), hi = __uint_as_float(v[i] & 0xffff0000u);
        o[i] = bf16t::pack2(silu_ftz(lo * sc[2 * i] + sf[2 * i]),
                            silu_ftz(hi * sc[2 * i + 1] + sf[2 * i + 1]));
      }
      if (has[k])
        *ptr[k] = in[k] ? make_uint4(o[0], o[1], o[2], o[3]) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// One chunk's products of a warpgroup's kA x 64 pixels (rows r0 + 4 m + wi
// of the tile, one a warp) x 64 outputs, wgmma m64n64k16 into kA
// accumulators, A by ldmatrix from the swizzled stage (a lane's row address
// applies the XOR), B by descriptor: kTaps 9 (a conv) or 1 (the projection:
// the centre tap of the same halo'd tile, its one tap's weights). `hook`
// runs once tap hook_tap's products are issued.
template <int kTaps, bool kLo, int kA, int kWG, typename Hook>
__device__ __forceinline__ void mma_chunk_t(uint32_t A, uint32_t W, float (&acc)[kA][32],
                                            int r0, int wi, int lane, int hook_tap,
                                            Hook&& hook) {
  constexpr int kCols = kLo ? kLW : kIW;
  constexpr int kBuf = kA == 1 && kWG == 2 ? 2 : 1;
  const int ri = lane & 7, mi = lane >> 3;
  const int px = ri + 8 * (mi & 1);  // the lane's A row: pixel of the tile row
  const int half = mi >> 1;          // and its 8-channel half of a k16 step
  auto load_tap = [&](int tap, uint32_t (&a)[kA][4][4]) {
    const int dy = kTaps == 1 ? 1 : tap / 3, dx = kTaps == 1 ? 1 : tap % 3;
#pragma unroll
    for (int m = 0; m < kA; ++m) {
      const int rr = r0 + 4 * m + wi;
      const int pos = kLo ? (((rr + dy - 1) >> 1) + 1) * kCols + ((px + dx - 1) >> 1) + 1
                          : (rr + dy) * kCols + px + dx;
      const uint32_t row = A + pos * kPixRow;
      const int sw = pos & 7;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) bf16t::ldsm_x4(row + (((2 * kk + half) ^ sw) << 4), a[m][kk]);
    }
  };
  uint32_t a[kBuf][kA][4][4];
  load_tap(0, a[0]);
#pragma unroll
  for (int tap = 0; tap < kTaps; ++tap) {
    const uint64_t desc = bf16t::wg_desc(W + tap * kCH * kPixRow);
    bf16t::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int m = 0; m < kA; ++m)
        bf16t::wg_mma(acc[m], a[tap % kBuf][m][kk], desc + kk * (16 * kPixRow >> 4));
    bf16t::wg_commit();
    if (tap == hook_tap) {
      hook();
      __syncwarp();
    }
    if (tap + 1 < kTaps) {
      if (kBuf == 2) {
        bf16t::wg_wait<1>();
      } else {
        bf16t::wg_wait<0>();
      }
      load_tap(tap + 1, a[(tap + 1) % kBuf]);
    }
  }
  bf16t::wg_wait<0>();
}

// The mbarriers: full / act / empty a stage, the resident weights, and a
// warpgroup's staging free / residual landed
struct BarsT {
  unsigned long long *full, *act, *empty, *wfull, *sfree, *rfull;
  __device__ explicit BarsT(unsigned char* p) {
    full = reinterpret_cast<unsigned long long*>(p);
    act = full + kTmaStagesMax;
    empty = act + kTmaStagesMax;
    wfull = empty + kTmaStagesMax;
    sfree = wfull + 1;
    rfull = sfree + 4;
  }
};

// Warpgroup 0 in phase kPhase: the activation of each step's conv chunk
// (the fold of a new sample's norm first), each step handed on by `act`
// once its TMA copy is in (`full`). g0: the steps of the launch before this
// phase's (the ring's position).
template <bool kUp, int kPhase, int kM>
__device__ __forceinline__ void act_t(const MapsT& mp, const ArgsT& p, unsigned char* sm,
                                      int t_begin, int t_end, int g0) {
  const int tid = threadIdx.x, lane = tid & 31;
  const BarsT bar(sm + p.bar_off);
  unsigned char* ring = sm + p.ring_off;
  float* s_sc = reinterpret_cast<float*>(sm + p.vec_off) + 2 * kCH;
  float* s_sh = s_sc + kMaxC;
  const int H = p.H, W = p.W, O = p.O, C = p.C1 + p.C2, S = p.stages;
  const int hin = kUp ? H / 2 : H, win = kUp ? W / 2 : W;
  const int tiles_w = (W + kTW - 1) / kTW, n_tiles = ((H + rows_h(kM) - 1) / rows_h(kM)) * tiles_w;
  const int nch = (O + kCH - 1) / kCH, ncx = (p.C1 + kCH - 1) / kCH + (p.C2 + kCH - 1) / kCH;
  const int nq = kPhase == 0 ? ncx : nch + (p.proj ? ncx : 0);
  const int steps = (t_end - t_begin) * nq;
  int scale_b = -1;  // the sample whose folded scale and shift s_sc / s_sh hold
  for (int i = 0; i < steps; ++i) {
    const int g = g0 + i, slot = g % S;
    const int t = t_begin + i / nq, b = t / n_tiles, rem = t - b * n_tiles;
    const int ty0 = (rem / tiles_w) * rows_h(kM), tx0 = (rem % tiles_w) * kTW;
    const ChunkT ch = chunk_t<kUp, kPhase>(mp, p, i % nq);
    if (ch.taps == 9 && b != scale_b) {
      tma::bar_sync(1, kActThreads);  // every thread is done with the last scale
      // channels tid and tid + 128 (fold strides by 256)
      for (int half = 0; half < 2; ++half) {
        if (kPhase == 0)
          fold(p.sums0, p.sumsq0, p.g0, p.b0, C, p.groups0, (float)hin * (float)win, p.eps, b,
               s_sc, s_sh, tid + 128 * half);
        else
          fold(p.sums1, p.sumsq1, p.g1, p.b1, O, p.groups1, (float)H * (float)W, p.eps, b,
               s_sc, s_sh, tid + 128 * half);
      }
      tma::bar_sync(1, kActThreads);
      scale_b = b;
    }
    wait_t(bar.full + slot, (g / S) & 1);
    unsigned char* A = ring + slot * p.stage_bytes;
    if (ch.taps == 9) {
      if (ch.lo)
        activate_t<true, kM>(A, ch, hin, win, ty0 / 2 - 1, tx0 / 2 - 1, s_sc, s_sh, tid);
      else
        activate_t<false, kM>(A, ch, H, W, ty0 - 1, tx0 - 1, s_sc, s_sh, tid);
    }
    bf16t::fence_async_smem();  // before the stage's next TMA copy
    __syncwarp();
    if (lane == 0) tma::mbar_arrive(bar.act + slot);
  }
}

// The consumers in phase kPhase: warpgroup w (of kWG) owns tile rows w kRW ..
// (kA accumulators of four rows, a row a warp). Each step: wait for the
// stage's activation, the products, the stage handed back (`empty`); each
// tile's last step: the epilogue (bias, skip bias or the identity's
// residual, which the leader copied by TMA into the warpgroup's staging
// rows ahead of it; the statistics in registers; the values rounded once
// into the staging rows and stored by TMA by the leader). The leaders are
// also the producer: warpgroup 0's copies the phase's resident weights (on
// `wfull`) and its first `stages` steps when the phase starts; then step s +
// stages goes into step s's stage once every consumer warp has handed it
// back, copied by the leader of warpgroup s % kWG (in turns: a copy's issue
// costs its thread 0.3-0.5 us, PERF.md). g0 / k0: the launch's steps /
// tiles before this phase's; wpar: the parity of the resident weights'
// barrier.
template <bool kUp, int kPhase, int kM, int kWG>
__device__ __forceinline__ void mma_t(const MapsT& mp, const ArgsT& p, unsigned char* sm,
                                      int t_begin, int t_end, int o0, int g0, int k0,
                                      int wpar) {
  constexpr int kRW = rows_h(kM) / kWG, kA = kRW / 4, kCW = 4 * kWG;
  const int ctid = threadIdx.x - kActThreads, cw = ctid >> 5, w = cw >> 2, wi = cw & 3;
  const int lane = ctid & 31, g = lane >> 2, t4 = lane & 3;
  const bool leader = (ctid & 127) == 0;
  const BarsT bar(sm + p.bar_off);
  unsigned char* ring = sm + p.ring_off;
  const float* s_bias = reinterpret_cast<const float*>(sm + p.vec_off);
  const float* s_skb = s_bias + kCH;
  float* red = reinterpret_cast<float*>(sm + p.red_off);  // [2][kCW][64]
  unsigned char* S_w = sm + p.stg_off + w * kRW * kTW * kPixRow;
  unsigned char* R_w = kUp ? sm + p.rb_off + w * (kRW / 2) * (kTW / 2) * kPixRow : S_w;
  const CUtensorMap* dst_map = kPhase == 0 ? &mp.wss : &mp.outs;
  const int H = p.H, W = p.W, O = p.O, S = p.stages;
  const int tiles_w = (W + kTW - 1) / kTW, n_tiles = ((H + rows_h(kM) - 1) / rows_h(kM)) * tiles_w;
  const int nch = (O + kCH - 1) / kCH, ncx = (p.C1 + kCH - 1) / kCH + (p.C2 + kCH - 1) / kCH;
  const int nq = kPhase == 0 ? ncx : nch + (p.proj ? ncx : 0);
  const bool resident = kPhase == 0 ? p.res0 : p.res1;
  const bool res = kPhase == 1 && !p.proj;  // the identity's residual
  const bool stats = kPhase == 0 || p.osums != nullptr;
  const int steps = (t_end - t_begin) * nq;
  auto weights = [&](const ChunkT& ch, unsigned char* dst, unsigned long long* b) {
    for (int tap = 0; tap < ch.taps; ++tap)
      tma::load_3d(dst + tap * kCH * kPixRow, ch.w, b, o0, ch.cb, tap);
  };
  auto issue = [&](int i) {  // step i's copies into its stage, once it is empty
    const int g = g0 + i, slot = g % S;
    if (g >= S) wait_t(bar.empty + slot, (g / S - 1) & 1);
    const int t = t_begin + i / nq, b = t / n_tiles, rem = t - b * n_tiles;
    const int ty0 = (rem / tiles_w) * rows_h(kM), tx0 = (rem % tiles_w) * kTW;
    const ChunkT ch = chunk_t<kUp, kPhase>(mp, p, i % nq);
    unsigned char* st = ring + slot * p.stage_bytes;
    const int wbytes = resident ? 0 : ch.taps * kCH * kPixRow;
    tma::mbar_expect_tx(bar.full + slot, (ch.lo ? lowpos_h(kM) : pos_h(kM)) * kPixRow + wbytes);
    if (ch.lo)
      tma::load_4d(st, ch.a, bar.full + slot, ch.c0, tx0 / 2 - 1, ty0 / 2 - 1, b);
    else
      tma::load_4d(st, ch.a, bar.full + slot, ch.c0, tx0 - 1, ty0 - 1, b);
    if (!resident) weights(ch, st + stage_t(kM), bar.full + slot);
  };
  // ws from phase 0's TMA stores, read by TMA past the grid barrier
  if (leader && kPhase == 1) tma::fence_proxy_async_global();
  if (ctid == 0) {
    if (resident && steps > 0) {
      int bytes = 0;
      for (int q = 0; q < nq; ++q) bytes += chunk_t<kUp, kPhase>(mp, p, q).taps * kCH * kPixRow;
      tma::mbar_expect_tx(bar.wfull, bytes);
      for (int q = 0, off = 0; q < nq; ++q) {
        const ChunkT ch = chunk_t<kUp, kPhase>(mp, p, q);
        weights(ch, sm + off, bar.wfull);
        off += ch.taps * kCH * kPixRow;
      }
    }
    for (int i = 0; i < S && i < steps; ++i) issue(i);
  }
  __syncwarp();
  float acc[kA][32];
  float ps[8][2], pss[8][2];
#pragma unroll
  for (int m = 0; m < kA; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) ps[j][0] = ps[j][1] = pss[j][0] = pss[j][1] = 0.f;
  if (resident && steps > 0) wait_t(bar.wfull, wpar);

  for (int s = 0; s < steps; ++s) {
    const int gs = g0 + s, slot = gs % S, q = s % nq, tile = t_begin + s / nq;
    const int b = tile / n_tiles, rem = tile - b * n_tiles;
    const int ty0 = (rem / tiles_w) * rows_h(kM), tx0 = (rem % tiles_w) * kTW;
    const int y0 = ty0 + w * kRW;  // the warpgroup's first row
    const bool last = q == nq - 1;
    wait_t(bar.full + slot, (gs / S) & 1);
    wait_t(bar.act + slot, (gs / S) & 1);
    __syncwarp();
    unsigned char* A = ring + slot * p.stage_bytes;
    unsigned char* Wt;
    if (!resident)
      Wt = A + stage_t(kM);
    else
      Wt = sm + (kPhase == 0 || q < nch ? q * kConvWBytes
                                        : nch * kConvWBytes + (q - nch) * kProjWBytes);
    // the leader, while this tile's last products run (at their middle
    // tap where a residual follows, else at their last): the last tile's
    // store has read the staging rows, which take this tile's residual
    const int hook_tap = !last || (kPhase == 1 && q >= nch) ? 0 : res ? 4 : 8;
    auto hook = [&] {
      if (!leader || !last) return;
      tma::store_wait_read<0>();
      tma::mbar_arrive(bar.sfree + w);
      if (res && y0 >= H) {
        tma::mbar_arrive(bar.rfull + w);  // rows neither stored nor summed
      } else if (res) {
        tma::mbar_expect_tx(bar.rfull + w, (kUp ? kRW / 2 * (kTW / 2) : kRW * kTW) * kPixRow);
        if (kUp)
          tma::load_4d(R_w, &mp.xr, bar.rfull + w, o0, tx0 / 2, y0 / 2, b);
        else
          tma::load_4d(R_w, &mp.xr, bar.rfull + w, o0, tx0, y0, b);
      }
    };
    const uint32_t ab = bf16t::smem_addr(A), wb = bf16t::smem_addr(Wt);
    if (kPhase == 1 && q >= nch)
      mma_chunk_t<1, kUp, kA, kWG>(ab, wb, acc, w * kRW, wi, lane, hook_tap, hook);
    else if (kPhase == 0 && kUp)
      mma_chunk_t<9, true, kA, kWG>(ab, wb, acc, w * kRW, wi, lane, hook_tap, hook);
    else
      mma_chunk_t<9, false, kA, kWG>(ab, wb, acc, w * kRW, wi, lane, hook_tap, hook);
    bf16t::fence_async_smem();
    __syncwarp();
    if (lane == 0) tma::mbar_arrive(bar.empty + slot);
    // step s + stages's copy into this stage, by the leaders in turn
    if (leader && w == s % kWG && s + S < steps) issue(s + S);
    __syncwarp();
    if (!last) continue;

    // epilogue: pixels g, g + 8 of rows y0 + 4 m + wi, outputs 8 j + 2 t4
    // (+ 1); staging row sp = (4 m + wi) * 16 + px of the warpgroup's box,
    // 16-byte chunk j at j ^ (sp & 7) (TMA's 128-byte swizzle)
    const int k = k0 + s / nq;  // the launch's tiles before this one
    wait_t(bar.sfree + w, k & 1);
    if (res) wait_t(bar.rfull + w, (s / nq) & 1);
#pragma unroll
    for (int m = 0; m < kA; ++m) {
      const int lr = 4 * m + wi, y = y0 + lr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ol = 8 * j + 2 * t4, o = o0 + ol;
        const float add0 = s_bias[ol] + s_skb[ol], add1 = s_bias[ol + 1] + s_skb[ol + 1];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = g + 8 * h, x = tx0 + px, sp = lr * kTW + px;
          float v0 = acc[m][4 * j + 2 * h] + add0, v1 = acc[m][4 * j + 2 * h + 1] + add1;
          acc[m][4 * j + 2 * h] = acc[m][4 * j + 2 * h + 1] = 0.f;
          if (res) {
            const int rp = kUp ? (lr >> 1) * (kTW / 2) + (px >> 1) : sp;
            const float2 r = bf16t::unpack2(*reinterpret_cast<const uint32_t*>(
                R_w + rp * kPixRow + ((j ^ (rp & 7)) << 4) + 4 * t4));
            v0 += r.x;
            v1 += r.y;
          }
          *reinterpret_cast<uint32_t*>(S_w + sp * kPixRow + ((j ^ (sp & 7)) << 4) + 4 * t4) =
              bf16t::pack2(v0, v1);
          if (y >= H || x >= W || o >= O) continue;
          ps[j][0] += v0;
          pss[j][0] += v0 * v0;
          ps[j][1] += v1;
          pss[j][1] += v1 * v1;
        }
      }
    }
    bf16t::fence_async_smem();
    tma::bar_sync(3 + w, 128);  // the warpgroup's rows are staged
    if (leader) {
      if (y0 < H) tma::store_4d(dst_map, S_w, o0, tx0, y0, b);
      tma::store_commit();
    }
    if (!stats) continue;
    // the statistics as unet_block_bf16_kernel sums them: registers over the
    // block's run of tiles of sample b, then over g by shuffles, the
    // consumer warps in order, into the slot of the run's last tile of b
    const size_t slot_o = (size_t)tile * O + o0 + ctid;
    if (tile + 1 < t_end && (tile + 1) / n_tiles == b) {
      if (ctid < kCH && o0 + ctid < O) p.part_s[slot_o] = p.part_ss[slot_o] = 0.f;
      continue;
    }
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
          red[cw * kCH + 8 * j + 2 * t4 + e] = ps[j][e];
          red[(kCW + cw) * kCH + 8 * j + 2 * t4 + e] = pss[j][e];
        }
        ps[j][e] = pss[j][e] = 0.f;
      }
    tma::bar_sync(2, 128 * kWG);
    if (ctid < kCH && o0 + ctid < O) {
      float sum = 0.f, ssq = 0.f;
      for (int c = 0; c < kCW; ++c) {
        sum += red[c * kCH + ctid];
        ssq += red[(kCW + c) * kCH + ctid];
      }
      p.part_s[slot_o] = sum;
      p.part_ss[slot_o] = ssq;
    }
    tma::bar_sync(2, 128 * kWG);  // red is read: the next run may write it
  }
  if (leader) {
    // every store complete (phase 0's ws is read by TMA past the grid barrier)
    tma::store_wait<0>();
    tma::fence_proxy_async_global();
  }
}

// One phase: the bias of the output block, then the roles.
template <bool kUp, int kPhase, int kM, int kWG>
__device__ __forceinline__ void phase_t(const MapsT& mp, const ArgsT& p, unsigned char* sm,
                                        int t_begin, int t_end, int o0, int g0, int k0,
                                        int wpar) {
  const int tid = threadIdx.x;
  if (tid >= kActThreads && tid < kActThreads + kCH) {
    float* s_bias = reinterpret_cast<float*>(sm + p.vec_off);
    const int o = o0 + tid - kActThreads;
    const float* bias = kPhase == 0 ? p.bias0 : p.bias1;
    s_bias[tid - kActThreads] = bias && o < p.O ? bias[o] : 0.f;
    s_bias[kCH + tid - kActThreads] =
        kPhase == 1 && p.proj && p.skip_b && o < p.O ? p.skip_b[o] : 0.f;
  }
  __syncthreads();
  if (tid < kActThreads)
    act_t<kUp, kPhase, kM>(mp, p, sm, t_begin, t_end, g0);
  else
    mma_t<kUp, kPhase, kM, kWG>(mp, p, sm, t_begin, t_end, o0, g0, k0, wpar);
}

// One block an SM: warpgroup 0 (the producer thread and the activation) and
// kWG consumer warpgroups. Block i walks output block i % n_ob over a
// contiguous run of the pixel tiles (8 kM rows x 16 columns), the same run
// in both phases, as unet_block_bf16_kernel does.
template <bool kUp, int kM, int kWG>
__global__ void __launch_bounds__(128 * (kWG + 1), 1)
    unet_block_bf16_tma_kernel(const __grid_constant__ MapsT mp, const ArgsT p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(128) unsigned char smem_t[];
  unsigned char* sm = bf16t::align1024(smem_t);
  const int n_tiles = ((p.H + rows_h(kM) - 1) / rows_h(kM)) * ((p.W + kTW - 1) / kTW);
  const int ntiles = p.B * n_tiles, nb = gridDim.x / p.n_ob;
  const int rank = blockIdx.x / p.n_ob, o0 = (blockIdx.x % p.n_ob) * kCH;
  const int t_begin = (int)((long long)rank * ntiles / nb);
  const int t_end = (int)((long long)(rank + 1) * ntiles / nb);
  if (threadIdx.x == 0) {
    const BarsT bar(sm + p.bar_off);
    for (int s = 0; s < kTmaStagesMax; ++s) {
      tma::mbar_init(bar.full + s, 1);
      tma::mbar_init(bar.act + s, kActThreads / 32);
      tma::mbar_init(bar.empty + s, 4 * kWG);
    }
    tma::mbar_init(bar.wfull, 1);
    for (int w = 0; w < 4; ++w) {
      tma::mbar_init(bar.sfree + w, 1);
      tma::mbar_init(bar.rfull + w, 1);
    }
    tma::fence_barrier_init();
  }
  const int ncx = (p.C1 + kCH - 1) / kCH + (p.C2 + kCH - 1) / kCH;
  phase_t<kUp, 0, kM, kWG>(mp, p, sm, t_begin, t_end, o0, 0, 0, 0);
  grid.sync();
  if (threadIdx.x < kThreads) reduce_partials(p.part_s, p.part_ss, p.B, n_tiles, p.O, p.sums1, p.sumsq1);
  grid.sync();
  phase_t<kUp, 1, kM, kWG>(mp, p, sm, t_begin, t_end, o0, (t_end - t_begin) * ncx,
                           t_end - t_begin, p.res0 ? 1 : 0);
  if (p.osums) {
    grid.sync();
    if (threadIdx.x < kThreads)
      reduce_partials(p.part_s, p.part_ss, p.B, n_tiles, p.O, p.osums, p.osumsq);
  }
}

template <bool kUp, int kM, int kWG>
int blocks_per_sm_t(int smem) {
  static int cache[kSmemCapH / 1024 + 2] = {};
  static cudaError_t attr =
      cudaFuncSetAttribute(unet_block_bf16_tma_kernel<kUp, kM, kWG>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCapH);
  const int kb = (smem + 1023) / 1024;
  int& n = cache[kb];
  if (!n && (attr != cudaSuccess ||
             cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &n, unet_block_bf16_tma_kernel<kUp, kM, kWG>, 128 * (kWG + 1),
                 kb * 1024 < kSmemCapH ? kb * 1024 : kSmemCapH) != cudaSuccess))
    n = 0;
  return n;
}

// The TMA route's plan (k7_plan.h) on this card, at the blocks an SM the
// occupancy query gives the chosen kernel.
int plan_t(bool up, int batch, int h, int wd, int c1, int c2, int o, bool proj, PlanT& pl) {
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  if (!k7plan::choose_t(up, batch, h, wd, c1, c2, o, proj, bf16t::sm_count(), pl))
    return (int)cudaErrorInvalidConfiguration;
  pl.bps = pl.km == 2 ? (up ? blocks_per_sm_t<true, 2, kWideWG>(pl.smem)
                            : blocks_per_sm_t<false, 2, kWideWG>(pl.smem))
                      : (up ? blocks_per_sm_t<true, 1, 2>(pl.smem)
                            : blocks_per_sm_t<false, 1, 2>(pl.smem));
  if (pl.bps < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  return k7plan::grid_t(batch, h, wd, pl) ? 0 : (int)cudaErrorCooperativeLaunchTooLarge;
}

// an NHWC tensor's map, boxes of 64 channels x bw x bh pixels
int map4(CUtensorMap* m, const void* base, int n, int h, int w, int c, int bw, int bh) {
  return tma::encode_bf16_4d(m, base, n, h, w, c, kCH, bw, bh);
}

// a (taps, C, O) weight's map, boxes of 64 outputs x 64 channels x 1 tap
int map_w(CUtensorMap* m, const void* base, int taps, int c, int o) {
  return tma::encode_bf16_3d(m, base, taps, c, o, kCH, kCH);
}

}  // namespace

extern "C" {

// The co-resident blocks the launch may use: per_sm blocks on each of sms.
int mc_unet_block_occupancy(int up, int* per_sm, int* sms) {
  return grid_limit(up, per_sm, sms);
}

// h, w are the OUTPUT height and width (2x the input's with up). The caller
// allocates ws (B, h, w, o), part_s / part_ss (B, tiles, o) with tiles =
// ceil(h / 8) * ceil(w / 16), sums1 / sumsq1 (B, o), out (B, h, w, o), and,
// to emit statistics, osums / osumsq (B, o). Returns a cudaError_t code; the
// launch is never shrunk to a non-cooperative one.
int mc_unet_block(const float* x, const float* x2, const float* g0, const float* b0,
                  const float* sums0, const float* sumsq0, const float* w0,
                  const float* bias0, const float* g1, const float* b1,
                  const float* w1, const float* bias1, const float* skip_w,
                  const float* skip_b, float* ws, float* part_s, float* part_ss,
                  float* sums1, float* sumsq1, float* out, float* osums,
                  float* osumsq, int batch, int h, int wd, int c1, int c2, int o,
                  int groups0, int groups1, float eps, int up, void* stream) {
  const int c = c1 + c2;
  if (c1 < 1 || c2 < 0 || o < 1 || c > kMaxC || groups0 < 1 || groups1 < 1 ||
      c % groups0 || o % groups1 || (up && (h % 2 || wd % 2)) || (!skip_w && c != o))
    return (int)cudaErrorInvalidValue;
  const bool xvec = c1 % 4 == 0 && aligned(x, 16) &&
                    (c2 == 0 || (c2 % 4 == 0 && aligned(x2, 16)));
  const bool wvec = o % 4 == 0 && aligned(w0, 16) && aligned(w1, 16) &&
                    aligned(ws, 16) && (!skip_w || aligned(skip_w, 16));
  const bool pair = o % 2 == 0 && aligned(out, 8) && aligned(ws, 8);
  Args p{x, x2, g0, b0, sums0, sumsq0, w0, bias0, g1, b1, w1, bias1, skip_w,
         skip_b, ws, part_s, part_ss, sums1, sumsq1, out, osums, osumsq,
         batch, h, wd, c1, c2, o, groups0, groups1, eps,
         (int)xvec, (int)wvec, (int)pair};
  int per_sm = 0, sms = 0;
  const int rc = grid_limit(up, &per_sm, &sms);
  if (rc) return rc;
  const int items = batch * ((h + kTH - 1) / kTH) * ((wd + kTW - 1) / kTW) *
                    ((o + kBO - 1) / kBO);
  const int blocks = items < per_sm * sms ? items : per_sm * sms;
  void* args[] = {&p};
  const void* fn = up ? (const void*)unet_block_kernel<true>
                      : (const void*)unet_block_kernel<false>;
  const cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(blocks), dim3(kThreads), args, kSmemBytes, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The bf16 instance: x, x2, w0, w1, skip_w, ws and out bf16; g0, b0, sums,
// sumsq, the biases, g1, b1, skip_b, the partials and the statistics fp32.
// Buffers and shapes as mc_unet_block's.
int mc_unet_block_bf16(const bf16* x, const bf16* x2, const float* g0, const float* b0,
                       const float* sums0, const float* sumsq0, const bf16* w0,
                       const float* bias0, const float* g1, const float* b1, const bf16* w1,
                       const float* bias1, const bf16* skip_w, const float* skip_b, bf16* ws,
                       float* part_s, float* part_ss, float* sums1, float* sumsq1, bf16* out,
                       float* osums, float* osumsq, int batch, int h, int wd, int c1, int c2,
                       int o, int groups0, int groups1, float eps, int up, void* stream) {
  const int c = c1 + c2;
  if (c1 < 1 || c2 < 0 || o < 1 || c > kMaxC || groups0 < 1 || groups1 < 1 ||
      c % groups0 || o % groups1 || (up && (h % 2 || wd % 2)) || (!skip_w && c != o) ||
      (c2 > 0 && !x2))
    return (int)cudaErrorInvalidValue;
  if (batch < 1 || h < 1 || wd < 1) return (int)cudaSuccess;
  const bool proj = skip_w != nullptr;
  if (k7plan::tma_shape(c1, c2, o, proj) && aligned(x, 16) && (c2 == 0 || aligned(x2, 16)) &&
      aligned(w0, 16) && aligned(w1, 16) && (!proj || aligned(skip_w, 16)) && aligned(ws, 16) &&
      aligned(out, 16)) {
    PlanT pl;
    int rc = plan_t(up, batch, h, wd, c1, c2, o, proj, pl);
    if (rc) return rc;
    const int rows = rows_h(pl.km), rw = rows / pl.wg;
    const int hin = up ? h / 2 : h, win = up ? wd / 2 : wd;
    MapsT mp = {};
    rc = up ? map4(&mp.xa, x, batch, hin, win, c1, kLW, rows / 2 + 2)
            : map4(&mp.xa, x, batch, h, wd, c1, kIW, rows + 2);
    if (!rc && c2) rc = map4(&mp.x2a, x2, batch, h, wd, c2, kIW, rows + 2);
    if (!rc) rc = map4(&mp.wsa, ws, batch, h, wd, o, kIW, rows + 2);
    if (!rc) rc = map4(&mp.wss, ws, batch, h, wd, o, kTW, rw);
    if (!rc) rc = map4(&mp.outs, out, batch, h, wd, o, kTW, rw);
    if (!rc && !proj)
      rc = up ? map4(&mp.xr, x, batch, hin, win, c1, kTW / 2, rw / 2)
              : map4(&mp.xr, x, batch, h, wd, c1, kTW, rw);
    if (!rc) rc = map_w(&mp.w0, w0, 9, c, o);
    if (!rc) rc = map_w(&mp.w1, w1, 9, o, o);
    if (!rc && proj) rc = map_w(&mp.sk, skip_w, 1, c, o);
    if (rc) return rc;
    ArgsT p{g0, b0, sums0, sumsq0, bias0, g1, b1, bias1, skip_b, part_s, part_ss, sums1, sumsq1,
            osums, osumsq, batch, h, wd, c1, c2, o, groups0, groups1, eps, (int)proj, pl.res0,
            pl.res1, pl.stages, pl.n_ob, pl.stage_bytes, pl.ring_off, pl.stg_off, pl.rb_off,
            pl.vec_off, pl.red_off, pl.bar_off};
    void* args[] = {&mp, &p};
    const void* fn = pl.km == 2 ? (up ? (const void*)unet_block_bf16_tma_kernel<true, 2, kWideWG>
                                      : (const void*)unet_block_bf16_tma_kernel<false, 2, kWideWG>)
                                : (up ? (const void*)unet_block_bf16_tma_kernel<true, 1, 2>
                                      : (const void*)unet_block_bf16_tma_kernel<false, 1, 2>);
    const cudaError_t e = cudaLaunchCooperativeKernel(
        fn, dim3(pl.blocks), dim3(128 * (pl.wg + 1)), args, pl.smem, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  // the kept route (unet_block_bf16_kernel): shapes TMA cannot describe
  PlanH pl;
  const int rc = plan_h(up, batch, h, wd, c1, c2, o, proj, pl);
  if (rc) return rc;
  ArgsH p{x, x2, g0, b0, sums0, sumsq0, w0, bias0, g1, b1, w1, bias1, skip_w, skip_b, ws,
          part_s, part_ss, sums1, sumsq1, out, osums, osumsq,
          batch, h, wd, c1, c2, o, groups0, groups1, eps,
          c1 % 8 == 0 && aligned(x, 16), c2 % 8 == 0 && aligned(x2, 16),
          o % 8 == 0 && aligned(w0, 16) && aligned(w1, 16) && (!skip_w || aligned(skip_w, 16)),
          o % 8 == 0 && aligned(ws, 16), o % 8 == 0 && aligned(ws, 16) && aligned(out, 16),
          pl.res0, pl.res1, pl.n_ob, pl.a_off, pl.r_off, pl.s_off, pl.red_off};
  void* args[] = {&p};
  const void* fn = pl.km == 2 ? (up ? (const void*)unet_block_bf16_kernel<true, 2>
                                    : (const void*)unet_block_bf16_kernel<false, 2>)
                              : (up ? (const void*)unet_block_bf16_kernel<true, 1>
                                    : (const void*)unet_block_bf16_kernel<false, 1>);
  const cudaError_t e = cudaLaunchCooperativeKernel(fn, dim3(pl.blocks), dim3(kThreads), args,
                                                    pl.smem, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The bf16 instance's plan for an output (batch, h, wd, o) with 16-byte
// aligned bases: out = {phase 0's weights resident, phase 1's, dynamic
// shared memory bytes, co-resident blocks an SM, SMs, blocks, tile rows,
// route (1 TMA, 0 the kept unet_block_bf16_kernel), ring stages, consumer
// warpgroups}. Returns a cudaError_t.
int mc_unet_block_bf16_plan(int batch, int h, int wd, int c1, int c2, int o, int up, int proj,
                            int* out) {
  if (k7plan::tma_shape(c1, c2, o, proj != 0)) {
    PlanT pl;
    const int rc = plan_t(up, batch, h, wd, c1, c2, o, proj != 0, pl);
    if (rc) return rc;
    const int vals[10] = {pl.res0, pl.res1, pl.smem,       pl.bps,    pl.sms,
                          pl.blocks, rows_h(pl.km), 1, pl.stages, pl.wg};
    for (int i = 0; i < 10; ++i) out[i] = vals[i];
    return 0;
  }
  PlanH pl;
  const int rc = plan_h(up, batch, h, wd, c1, c2, o, proj != 0, pl);
  if (rc) return rc;
  const int vals[10] = {pl.res0, pl.res1, pl.smem, pl.bps, pl.sms, pl.blocks, rows_h(pl.km),
                        0, 2, 2};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return 0;
}

}  // extern "C"
