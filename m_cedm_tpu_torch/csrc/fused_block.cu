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
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // extern "C"
