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
// bf16: unet_block_bf16_kernel<kUp>
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
constexpr int kConvWBytes = 9 * kCH * bf16t::kWRowBytes;    // a conv chunk's weights, 73,728
constexpr int kProjWBytes = kCH * bf16t::kWRowBytes;        // a projection chunk's, 8,192
constexpr int kVecBytes = (2 * kCH + 2 * kMaxC) * 4;        // bias, skip bias, scale, shift
constexpr int kRedBytes = 2 * kWarps * kCH * 4;             // the statistics' reduction
constexpr int kStagingBytes = kWarps * kTW * bf16t::kARowBytes;  // a warp's output row
constexpr int kSmemCapH = 232448;  // dynamic shared memory a block may take on the H100
constexpr int kBigTileWaves = 1;   // 16 x 16 tiles when they give this many a block

// A tile of kM * 8 rows x 16 pixels: warp w owns tile rows w + 8 m, m < kM.
// Rows of its halo'd A stage and of the up-block's low-res one, and bytes.
__host__ __device__ constexpr int rows_h(int km) { return 8 * km; }
__host__ __device__ constexpr int pos_h(int km) { return (rows_h(km) + 2) * kIW; }
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
  PlanH pl;
  const int rc = plan_h(up, batch, h, wd, c1, c2, o, skip_w != nullptr, pl);
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

// The bf16 instance's plan for an output (batch, h, wd, o): out = {phase 0's
// weights resident, phase 1's, dynamic shared memory bytes, co-resident
// blocks an SM, SMs, blocks, tile rows}. Returns a cudaError_t.
int mc_unet_block_bf16_plan(int batch, int h, int wd, int c1, int c2, int o, int up, int proj,
                            int* out) {
  PlanH pl;
  const int rc = plan_h(up, batch, h, wd, c1, c2, o, proj != 0, pl);
  if (rc) return rc;
  const int vals[7] = {pl.res0, pl.res1, pl.smem, pl.bps, pl.sms, pl.blocks, rows_h(pl.km)};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

}  // extern "C"
