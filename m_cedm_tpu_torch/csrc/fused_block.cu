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
// persistent grid sized from the occupancy query, and grid-wide barriers
// between the phases. A work item is one 8 x 16 output tile of one sample and
// 64 output channels; blocks walk the items with a grid stride.
//   phase 0   per item, the halo'd input tile is built in shared memory 8
//             channels at a time with norm0 + SiLU applied on load (positions
//             outside the image are zero AFTER the activation: SAME padding
//             pads the activated tensor); conv0 + bias0 is a CUDA-core
//             implicit GEMM (the arithmetic of K2, csrc/fused_norm_conv.cu);
//             the tile goes to a workspace (B, H, W, O) in device memory
//             (64 MiB at the flagship's full-resolution blocks: one sample's
//             4 MiB fits the 50 MB L2, the batch does not), and the tile's
//             per-channel sums to a partials buffer, one slot per item
//   sync, reduce  each (sample, channel) sums its tiles' partials in a fixed
//             order (one warp per pair, a fixed butterfly): norm1's
//             statistics, with no atomics, so K7 is deterministic
//   sync, phase 1  per item, the workspace window with norm1 (+FiLM) + SiLU
//             on load, conv1 + bias1, then the skip: the identity re-reads x
//             (still in device memory), a projection is one more GEMM over
//             xin's channels against skip_w split at C1; out is written
//   (emit)    sync, the output's partials reduced the same way
// conv0's output thus never leaves the launch, and the concat is never made.
//
// Bound: fp32 FMA throughput. At the identity block at res 128 (B 16, 64 ->
// 64) the two convs are 2 * 16 * 128^2 * 9 * 64 * 64 * 2 = 3.87e10 FLOP,
// 0.58 ms at the H100's 67 TFLOP/s fp32, against about 0.04 ms of bytes (x
// in, out out). This design does not reach that bound: each of its convs
// runs K2's CUDA-core arithmetic, at about a third of the fp32 peak, and the
// whole block takes somewhat longer than K2 conv0 + K2 tail on the same
// inputs (chip_smoke.py phase 9 times the two side by side). Tensor cores
// (wgmma on TMA-fed tiles) and a split of the workspace across a cluster's
// shared memory, so that conv0's output never leaves the chip, are a later
// change's work.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTH = 8;         // output rows per item
constexpr int kTW = 16;        // output columns per item
constexpr int kBO = 64;        // output channels per item
constexpr int kCK = 8;         // input channels per shared-memory chunk
constexpr int kThreads = 128;  // 16 pixel groups x 8 channel groups
constexpr int kIH = kTH + 2;   // halo'd tile rows
constexpr int kIW = kTW + 2;   // halo'd tile columns
constexpr int kIWP = 19;       // odd row stride: conflict-free tile reads
constexpr int kMaxC = 256;     // xin channels (C1 + C2, each at most 128)

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
};

struct Smem {
  float in[kCK][kIH][kIWP];
  __align__(16) float w[kCK][9][kBO];
  float a[kMaxC];   // folded per-channel scale of the conv's input norm
  float sh[kMaxC];  // folded per-channel shift
};

struct Item {
  int b, tile, ty0, tx0, o0;
};

__device__ __forceinline__ float silu(float y) { return y / (1.f + expf(-y)); }

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

// GroupNorm statistics of sample b folded with its (B, C) gamma / beta into
// one scale and shift per channel; cnt pixels per channel.
__device__ void fold(Smem& s, const float* sums, const float* sumsq,
                     const float* gamma, const float* beta, int b, int C,
                     int groups, float cnt_pix, float eps) {
  const int per = C / groups;
  const float cnt = cnt_pix * (float)per;
  for (int ch = threadIdx.x; ch < C; ch += kThreads) {
    const int g0 = (ch / per) * per;
    float sm = 0.f, ss = 0.f;
    for (int k = 0; k < per; ++k) {
      sm += sums[b * C + g0 + k];
      ss += sumsq[b * C + g0 + k];
    }
    const float mean = sm / cnt;
    const float var = fmaxf(ss / cnt - mean * mean, 0.f);
    const float a = gamma[b * C + ch] * rsqrtf(var + eps);
    s.a[ch] = a;
    s.sh[ch] = beta[b * C + ch] - a * mean;
  }
}

// acc += conv3x3 over cin channels of the tile at (ty0, tx0); src(y, x, c)
// gives the activated input at an in-image position.
template <class Src>
__device__ void conv3x3_tile(float (&acc)[8][8], Smem& s, const Src& src, int cin,
                             const float* w, int O, const Item& it, int H, int W) {
  const int tid = threadIdx.x;
  const int pg = tid & 15, cg8 = tid >> 4;
  const int r = pg >> 1, cx = (pg & 1) * 8;
  for (int c0 = 0; c0 < cin; c0 += kCK) {
    __syncthreads();
    for (int idx = tid; idx < kIH * kIW * kCK; idx += kThreads) {
      const int ck = idx % kCK, pos = idx / kCK;
      const int iy = pos / kIW, ix = pos % kIW;
      const int y = it.ty0 - 1 + iy, x = it.tx0 - 1 + ix, c = c0 + ck;
      s.in[ck][iy][ix] = (y >= 0 && y < H && x >= 0 && x < W && c < cin)
                             ? src(y, x, c) : 0.f;
    }
    for (int idx = tid; idx < kCK * 9 * kBO; idx += kThreads) {
      const int o = idx % kBO, t = idx / kBO;
      const int tap = t % 9, ck = t / 9, c = c0 + ck;
      s.w[ck][tap][o] = (c < cin && it.o0 + o < O)
                            ? w[((size_t)tap * cin + c) * O + it.o0 + o] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int ck = 0; ck < kCK; ++ck) {
#pragma unroll
      for (int dr = 0; dr < 3; ++dr) {
        float a[10];
#pragma unroll
        for (int q = 0; q < 10; ++q) a[q] = s.in[ck][r + dr][cx + q];
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          const float4 w0 = *reinterpret_cast<const float4*>(&s.w[ck][dr * 3 + dc][cg8 * 8]);
          const float4 w1 = *reinterpret_cast<const float4*>(&s.w[ck][dr * 3 + dc][cg8 * 8 + 4]);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(a[j + dc], wv[i], acc[j][i]);
        }
      }
    }
  }
}

// acc += the 1x1 projection of the tile's own pixels; src(y, x, c) gives the
// raw input at an in-image position.
template <class Src>
__device__ void conv1x1_tile(float (&acc)[8][8], Smem& s, const Src& src, int cin,
                             const float* w, int O, const Item& it, int H, int W) {
  const int tid = threadIdx.x;
  const int pg = tid & 15, cg8 = tid >> 4;
  const int r = pg >> 1, cx = (pg & 1) * 8;
  for (int c0 = 0; c0 < cin; c0 += kCK) {
    __syncthreads();
    for (int idx = tid; idx < kTH * kTW * kCK; idx += kThreads) {
      const int ck = idx % kCK, pos = idx / kCK;
      const int iy = pos / kTW, ix = pos % kTW;
      const int y = it.ty0 + iy, x = it.tx0 + ix, c = c0 + ck;
      s.in[ck][iy][ix] = (y < H && x < W && c < cin) ? src(y, x, c) : 0.f;
    }
    for (int idx = tid; idx < kCK * kBO; idx += kThreads) {
      const int o = idx % kBO, ck = idx / kBO, c = c0 + ck;
      s.w[ck][0][o] = (c < cin && it.o0 + o < O) ? w[(size_t)c * O + it.o0 + o] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int ck = 0; ck < kCK; ++ck) {
      const float4 w0 = *reinterpret_cast<const float4*>(&s.w[ck][0][cg8 * 8]);
      const float4 w1 = *reinterpret_cast<const float4*>(&s.w[ck][0][cg8 * 8 + 4]);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float a = s.in[ck][r][cx + j];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(a, wv[i], acc[j][i]);
      }
    }
  }
}

// The tile's per-channel sum and sum of squares (ps, pss: this thread's 8
// channels over its 8 pixels) summed over the block in a fixed order and
// stored into the item's slot of the partials buffer.
__device__ void store_partials(Smem& s, const float (&ps)[8], const float (&pss)[8],
                               const Item& it, int n_tiles, int O, float* part_s,
                               float* part_ss) {
  const int tid = threadIdx.x;
  const int pg = tid & 15, cg8 = tid >> 4;
  __syncthreads();  // every read of s.w is done: reuse it
  float* red_s = &s.w[0][0][0];
  float* red_ss = red_s + 16 * kBO;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    red_s[pg * kBO + cg8 * 8 + i] = ps[i];
    red_ss[pg * kBO + cg8 * 8 + i] = pss[i];
  }
  __syncthreads();
  if (tid < kBO && it.o0 + tid < O) {
    float sm = 0.f, ss = 0.f;
    for (int q = 0; q < 16; ++q) {
      sm += red_s[q * kBO + tid];
      ss += red_ss[q * kBO + tid];
    }
    const size_t slot = ((size_t)it.b * n_tiles + it.tile) * O + it.o0 + tid;
    part_s[slot] = sm;
    part_ss[slot] = ss;
  }
}

// dst[b, o] = sum over tiles of part[b, tile, o], tiles in a fixed order:
// one warp per (b, o), lane l summing tiles l, l + 32, ..., then a butterfly.
__device__ void reduce_partials(const float* part_s, const float* part_ss, int B,
                                int n_tiles, int O, float* dst_s, float* dst_ss) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * (kThreads / 32);
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

// kMinBlocks caps the registers at 128 a thread, so that four blocks share an
// SM: the persistent grid then walks the flagship's 2048 items in four
// rounds, as K2's 2048 blocks run, where three blocks an SM took six.
constexpr int kMinBlocks = 4;

template <bool kUp>
__global__ void __launch_bounds__(kThreads, kMinBlocks) unet_block_kernel(const Args p) {
  __shared__ Smem s;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int pg = tid & 15, cg8 = tid >> 4;
  const int r = pg >> 1, cx = (pg & 1) * 8;
  const int H = p.H, W = p.W, O = p.O, C1 = p.C1, C2 = p.C2, C = C1 + C2;
  const int hin = kUp ? H / 2 : H, win = kUp ? W / 2 : W;
  const int tiles_w = (W + kTW - 1) / kTW;
  const int n_tiles = ((H + kTH - 1) / kTH) * tiles_w;
  const int o_tiles = (O + kBO - 1) / kBO;
  const int n_items = p.B * n_tiles * o_tiles;

  // xin at low-res pixel (ys, xs) of sample b, channel c < C
  auto xin = [&](int b, int ys, int xs, int c) -> float {
    const size_t pix = ((size_t)b * hin + ys) * win + xs;
    return c < C1 ? p.x[pix * C1 + c] : p.x2[pix * C2 + (c - C1)];
  };

  // phase 0: conv0 of the activated xin into the workspace
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const Item it = item_of(i, tiles_w, n_tiles, o_tiles);
    __syncthreads();  // the previous item is done with s.a / s.sh
    fold(s, p.sums0, p.sumsq0, p.g0, p.b0, it.b, C, p.groups0,
         (float)hin * (float)win, p.eps);
    float acc[8][8] = {};
    auto src = [&](int y, int x, int c) {
      const float v = kUp ? xin(it.b, y >> 1, x >> 1, c) : xin(it.b, y, x, c);
      return silu(v * s.a[c] + s.sh[c]);
    };
    conv3x3_tile(acc, s, src, C, p.w0, O, it, H, W);
    float ps[8] = {}, pss[8] = {};
    const int y = it.ty0 + r;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int x = it.tx0 + cx + j;
      if (y >= H || x >= W) continue;
      const size_t pix = ((size_t)it.b * H + y) * W + x;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int o = it.o0 + cg8 * 8 + q;
        if (o >= O) break;
        const float v = acc[j][q] + (p.bias0 ? p.bias0[o] : 0.f);
        p.ws[pix * O + o] = v;
        ps[q] += v;
        pss[q] += v * v;
      }
    }
    store_partials(s, ps, pss, it, n_tiles, O, p.part_s, p.part_ss);
  }
  grid.sync();
  reduce_partials(p.part_s, p.part_ss, p.B, n_tiles, O, p.sums1, p.sumsq1);
  grid.sync();

  // phase 1: conv1 of the activated workspace, plus the skip path
  for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
    const Item it = item_of(i, tiles_w, n_tiles, o_tiles);
    __syncthreads();
    fold(s, p.sums1, p.sumsq1, p.g1, p.b1, it.b, O, p.groups1,
         (float)H * (float)W, p.eps);
    float acc[8][8] = {};
    auto src = [&](int y, int x, int c) {
      const float v = p.ws[(((size_t)it.b * H + y) * W + x) * O + c];
      return silu(v * s.a[c] + s.sh[c]);
    };
    conv3x3_tile(acc, s, src, O, p.w1, O, it, H, W);
    if (p.skip_w) {
      auto raw = [&](int y, int x, int c) {
        return kUp ? xin(it.b, y >> 1, x >> 1, c) : xin(it.b, y, x, c);
      };
      conv1x1_tile(acc, s, raw, C, p.skip_w, O, it, H, W);
    }
    float ps[8] = {}, pss[8] = {};
    const int y = it.ty0 + r;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int x = it.tx0 + cx + j;
      if (y >= H || x >= W) continue;
      const size_t pix = ((size_t)it.b * H + y) * W + x;
      const int ys = kUp ? y >> 1 : y, xs = kUp ? x >> 1 : x;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int o = it.o0 + cg8 * 8 + q;
        if (o >= O) break;
        float v = acc[j][q];
        if (p.bias1) v += p.bias1[o];
        if (p.skip_w) {
          if (p.skip_b) v += p.skip_b[o];
        } else {
          v += xin(it.b, ys, xs, o);
        }
        p.out[pix * O + o] = v;
        ps[q] += v;
        pss[q] += v * v;
      }
    }
    if (p.osums) store_partials(s, ps, pss, it, n_tiles, O, p.part_s, p.part_ss);
  }
  if (p.osums) {
    grid.sync();
    reduce_partials(p.part_s, p.part_ss, p.B, n_tiles, O, p.osums, p.osumsq);
  }
}

// Blocks of the kernel that fit on one SM with its static shared memory.
template <bool kUp>
int blocks_per_sm(int* per_sm) {
  static int cached = 0;
  if (!cached) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cached, unet_block_kernel<kUp>, kThreads, 0);
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
  Args p{x, x2, g0, b0, sums0, sumsq0, w0, bias0, g1, b1, w1, bias1, skip_w,
         skip_b, ws, part_s, part_ss, sums1, sumsq1, out, osums, osumsq,
         batch, h, wd, c1, c2, o, groups0, groups1, eps};
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
      fn, dim3(blocks), dim3(kThreads), args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // extern "C"
