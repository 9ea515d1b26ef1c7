// K2's narrow-channel linear conv: out = conv3x3_same(x) + bias for NHWC
// tensors with few input channels (C <= 8: the U-Net's conv_in) or few output
// channels (O <= 8: its out conv), with the per-(B, O) sums of the output
// (emit_stats), and the out conv's backward (input and weight gradients).
//
// Replaces, for those shapes, the linear mode (act = 0) of
// m_cedm_tpu/pallas/fused_norm_conv.py::_gnsc_kernel (conv_in runs there as
// fused_block_paired(act=False, emit_stats=True)) and of its backward
// ::_gnsc_bwd_kernel_a; the JAX out conv is an XLA conv (paired_out_conv).
// csrc/fused_norm_conv.cu::gnsc_kernel tiles 64 output and 8 input channels:
// at O = 2 it does the work of a 64 -> 64 conv, at C = 4 half of each input
// chunk is padding.
//
// fp32. Bound: bytes. At the flagship shapes (16 x 128 x 128) conv_in reads
// 4 MB and writes 67 MB, the out conv reads 67 MB and writes 2 MB: about
// 0.021 ms at 3.35 TB/s each, against 0.009 ms (out conv) and 0.018 ms
// (conv_in) of fp32 multiply-adds at 67 TFLOP/s. So the design moves each
// byte once, coalesced, and keeps the multiply-adds on operands already in
// registers.
//
//   narrow O  (narrow_o_kernel)  a block owns a 16 x 32 pixel tile, a thread
//             one column of it and four rows, with all O (<= 8) outputs of
//             its four pixels in registers. The halo'd 18 x 34 input tile
//             streams through shared memory 16 channels (64 contiguous
//             bytes of a pixel) at a time, in a two-stage cp.async ring
//             (16-byte copies when C % 4 == 0), with that chunk's 9 x 16 x O
//             weights beside it; 105 KB, two blocks an SM. (8-channel chunks,
//             32 bytes of each 256-byte pixel at a time, were slower at
//             C = 64.) A thread reads six float4 rows of one column per
//             column tap and slides the three row taps over them; pixels are
//             padded to 20 floats (4 mod 8), so a quarter-warp's float4
//             reads fall on 32 distinct banks, and every thread reads the
//             same weights (a broadcast).
//   narrow C  (narrow_c_kernel)  a block owns an 8 x 16 pixel tile and 64
//             output channels, a thread four consecutive outputs (one
//             float4 of weights per tap and channel, and one float4 store
//             per pixel, so a warp writes 512 contiguous bytes) for one
//             column of 16 rows, four at a time. The whole halo'd input
//             tile (C <= 8) and the block's 9 x 8 x 64 weights sit in
//             shared memory.
//   statistics  each block sums its pixels' outputs (and their squares) per
//             channel in a fixed order and writes them to a (B, tiles, O)
//             scratch; colsum_kernel adds the tiles in a fixed order. No
//             atomics: the sums repeat bit for bit.
//   backward  (narrow O, the out conv in training) dgrad is the narrow-C
//             kernel run on the cotangent g (O channels in, C out) with the
//             mirrored taps and the transposed weight, zero outside the
//             image. wgrad: a block owns 32 input channels of a run of 8 x 32
//             pixel tiles of one image; a thread owns one channel, two tile
//             rows and all 9 x O weights of it, slides a 3 x 3 window of its
//             channel along the row in registers, and reads g as a broadcast.
//             Blocks write per-run partial dW and dbias; colsum_kernel adds
//             them in a fixed order, so dW repeats bit for bit.
//
// bf16 forward (the bf16 network's conv_in and out conv, and the out conv's
// dgrad in bf16 training): the Pallas kernel's arithmetic, bf16 products
// summed in fp32 (exact products), the fp32 bias added, the statistics taken
// from the fp32 values, the output rounded once to bf16. Bound: bytes, half
// of fp32's: conv_in writes 33.6 MB, the out conv reads 33.6 MB at the
// flagship shape, about 0.010 ms each at 3.35 TB/s; the products, an
// implicit GEMM (pixels M, outputs N, K = 9 taps x C, tap-major), are 0.003
// (conv_in, K 36 -> 48) and 0.002 ms (the out conv, the three row taps'
// outputs in N) of bf16 mma.sync.m16n8k16 at about 600 TFLOP/s, where fp32
// FMA on the CUDA cores would take 0.018 / 0.009 ms. Both kernels are
// persistent (a fixed number of blocks an SM walks the pixel tiles), load
// their weights once with 16-byte loads, keep the tiles in bf16 and stage
// them by 16-byte cp.async (element copies where C or the alignment does
// not allow them):
//
//   narrow C  (narrow_c_bf16_kernel<P, kFlip>; conv_in, and with kFlip the
//             dgrad on g with mirrored taps) a block owns 64 outputs and
//             walks 8 x 16 pixel tiles, a warp one 16-pixel row (one m16
//             tile) at a time. K is 9 P zero-padded to 16, P the staged
//             pixel's channels (C rounded up to even), so an A fragment's
//             k-pair is two channels of one tap at one pixel: a 4-byte read
//             of the staged tile. The B fragments (3 k steps x 8 n8 tiles at
//             C 4) stay in registers, read once by ldmatrix .trans from a
//             weight slab whose 16-byte chunks are XOR-swizzled by row
//             (unswizzled, the reads' 8-way bank conflicts across 16 warps
//             an SM took about 3 us a call on an H100). The 10-row halo'd
//             tile lands as the image
//             rows' raw bytes (W C % 8 == 0) in a two-stage ring, the next
//             tile's copy in flight while the weights load. The warp's 16 x
//             64 fp32 products go through shared memory (float4 units
//             XOR-swizzled by row, so the fragment writes and the row reads
//             are free of bank conflicts): a lane then adds the bias to 8
//             channels of a pixel, sums their statistics, rounds them and
//             writes one 16-byte store, and a warp four whole 512-byte runs.
//   narrow O  (narrow_o_bf16_kernel<kFold>; the out conv) a block walks 16
//             x 32 pixel tiles, a warp 8 rows x 16 pixels of one. The halo'd
//             18 x 34 tile streams 16 channels (32 bytes, two 16-byte halves
//             swizzled by pixel for ldmatrix) a stage through a three-stage
//             cp.async ring that runs on across tiles. A warp takes each
//             input row's A fragment (ldmatrix .x4) once per column tap. At
//             O <= 2 (kFold) N holds the three row taps' outputs, n = 2 dy +
//             o, so one product serves all three: 10 products a column tap
//             and chunk, each output row then adding its three row taps'
//             sums from three lanes; above, N is O padded to 8 and the A
//             fragment feeds the three output rows that read it (24
//             products). The weights sit in shared memory in fragment order
//             (one 8-byte read a lane and k step). The block's outputs are
//             packed through shared memory and leave as whole rows, 16 bytes
//             a store (at O 2 a tile row is 128 bytes).
//   statistics  per tile (and 64-output chunk) in a fixed order (each lane
//             over its pixels, a warp butterfly, the warps in turn) into the
//             (2, B, tiles, O) scratch, the tiles per image being
//             mc_narrow_conv_tiles'. conv_in finishes them in the same
//             launch: a cooperative launch whose blocks, after a grid-wide
//             barrier, add each output's tiles in a fixed order (16 lane
//             groups, then the groups in turn), one device operation in
//             all; the out conv, which emits none on the main path, leaves
//             them to colsum_kernel. The sums repeat bit for bit.
//
// bf16 wgrad (the out conv in bf16 training): narrow_wgrad_kernel<OP, bf16>
// widens x and g as it stages them and keeps its fp32 partials (dW and
// dbias fp32); with the dgrad above, the Pallas K2 backward's linear mode on
// a bf16 network (_bwd_phase_a with act = False). Bound: bytes, 33.6 MB of x
// read, 33.6 MB of dx written and 1 MB of g at the flagship shape, 0.020 ms
// at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include <cooperative_groups.h>

#include "bf16_conv_tiles.cuh"

namespace {

namespace cg = cooperative_groups;

using bf16 = __nv_bfloat16;

constexpr int kKC = 8;   // the widest narrow C
constexpr int kPS = 12;  // floats per staged pixel of the narrow-C tile: 8 + 4 of padding

// narrow O
constexpr int kOKC = 16;                         // input channels per staged chunk
constexpr int kOPS = kOKC + 4;                   // floats per staged pixel (4 mod 8)
constexpr int kOTH = 16, kOTW = 32;              // output tile
constexpr int kOIH = kOTH + 2, kOIW = kOTW + 2;  // halo'd tile
constexpr int kOThreads = 128;                   // 32 columns x 4 groups of 4 rows
constexpr int kOStageX = kOIH * kOIW * kOPS;     // floats of one staged x chunk
constexpr int kOStageW = 9 * kOKC * 8;           // floats of one staged weight chunk
constexpr int kOSmem = 2 * (kOStageX + kOStageW) * 4;

// narrow C
constexpr int kCTH = 16, kCTW = 8;
constexpr int kCIH = kCTH + 2, kCIW = kCTW + 2;
constexpr int kCRows = 4;       // rows a thread sums at a time
constexpr int kCO = 64;         // output channels per block
constexpr int kCThreads = 128;  // 16 groups of 4 outputs x 8 columns

// wgrad
constexpr int kWTH = 8, kWTW = 32;
constexpr int kWIH = kWTH + 2, kWIW = kWTW + 2;
constexpr int kWC = 32;         // input channels per block
constexpr int kWThreads = 128;  // 32 channels x 4 groups of 2 rows
constexpr int kWStageX = kWIH * kWIW * kWC;
constexpr int kWSmem = (kWStageX + kWTH * kWTW * 8) * 4;

// bf16 narrow C: 8 x 16 pixel tiles, a row one m16 tile; 64 outputs a block
constexpr int kBCTH = 8, kBCTW = 16;
constexpr int kBCIH = kBCTH + 2;
constexpr int kBCN = 64;
constexpr int kBCThreads = 128;        // 4 warps: tile rows w and w + 4
constexpr int kBCWarps = kBCThreads / 32;
constexpr int kBCBlocksPerSm = 4;      // persistent blocks an SM at P <= 4 (3 k steps)
constexpr int kBCBlocksPerSmWide = 2;  // at P 6 and 8 (4 and 5 k steps: more B registers)
__host__ __device__ constexpr int bc_blocks_per_sm(int pitch) {
  return pitch <= 4 ? kBCBlocksPerSm : kBCBlocksPerSmWide;
}
constexpr int kBCStages = 2;           // input tiles in the ring: the next tile's copy in flight
// elements of a staged row at pitch P (elements a pixel): 8 before the tile's
// first output pixel (its left halo pixel at 8 - P), 17 pixels after it,
// rounded up to 16-byte copies
__host__ __device__ constexpr int bc_row(int pitch) {
  return 8 + ((kBCTW + 1) * pitch + 7) / 8 * 8;
}
constexpr int kBCStageElems = kBCIH * bc_row(kKC);

// bf16 narrow O: 16 x 32 pixel tiles (narrow_o_kernel's, so
// mc_narrow_conv_tiles(h, w, 0) serves both), a warp 8 rows x 16 pixels
constexpr int kBOTH = 16, kBOTW = 32;
static_assert(kBOTH == kOTH && kBOTW == kOTW, "both narrow-O kernels share their tiles");
constexpr int kBOIH = kBOTH + 2, kBOIW = kBOTW + 2;
constexpr int kBOKC = 16;                               // channels a stage: one k16 step a tap
constexpr int kBOStages = 3;                            // ring depth
constexpr int kBOThreads = 128;                         // 2 x 2 warps of 8 x 16 pixels
constexpr int kBOBlocksPerSm = 2;                       // persistent blocks an SM
constexpr int kBOStageBytes = kBOIH * kBOIW * kBOKC * 2;  // 612 pixels x 32 bytes
constexpr int kBOMaxC = 512;
// dynamic shared memory at nkc 16-channel chunks and O outputs: the ring,
// the weights' fragments (3 or 9 k steps a chunk x 32 lanes x 8 bytes), the
// output tile, the sums
__host__ __device__ constexpr int bo_smem(int nkc, int o) {
  return kBOStages * kBOStageBytes + (o <= 2 ? 3 : 9) * nkc * 32 * 8 + kBOTH * kBOTW * o * 2 +
         2 * 4 * 8 * 4;
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

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Channels c0 .. c0 + nch - 1 of the halo'd (IH, IW) tile whose top-left
// output pixel is (ty0, tx0) into dst[(iy * IW + ix) * stride + k], zero
// outside the image and past C. vec: C % 4 == 0 and x 16-byte aligned.
template <int IH, int IW>
__device__ __forceinline__ void load_tile(float* dst, const float* xb, int ty0, int tx0,
                                          int H, int W, int C, int c0, int nch,
                                          int stride, bool vec, int tid, int nthreads) {
  if (vec) {
    const int q4 = nch / 4;
    for (int idx = tid; idx < IH * IW * q4; idx += nthreads) {
      const int k = idx % q4, pos = idx / q4;
      const int iy = pos / IW, ix = pos % IW;
      const int y = ty0 - 1 + iy, x = tx0 - 1 + ix, c = c0 + 4 * k;
      const bool valid = y >= 0 && y < H && x >= 0 && x < W && c < C;
      cp_async16(dst + pos * stride + 4 * k,
                 valid ? xb + ((size_t)y * W + x) * C + c : xb, valid);
    }
  } else {
    for (int idx = tid; idx < IH * IW * nch; idx += nthreads) {
      const int k = idx % nch, pos = idx / nch;
      const int iy = pos / IW, ix = pos % IW;
      const int y = ty0 - 1 + iy, x = tx0 - 1 + ix, c = c0 + k;
      const bool valid = y >= 0 && y < H && x >= 0 && x < W && c < C;
      cp_async4(dst + pos * stride + k, valid ? xb + ((size_t)y * W + x) * C + c : xb,
                valid);
    }
  }
}

// The bf16 tile of narrow_wgrad_kernel<OP, bf16>: the same layout in fp32,
// widened as it is staged (plain loads; 8 bytes, four channels, a load when
// vec: C % 4 == 0 and x 8-byte aligned).
template <int IH, int IW>
__device__ __forceinline__ void load_tile(float* dst, const __nv_bfloat16* xb, int ty0,
                                          int tx0, int H, int W, int C, int c0, int nch,
                                          int stride, bool vec, int tid, int nthreads) {
  if (vec) {
    const int q4 = nch / 4;
    for (int idx = tid; idx < IH * IW * q4; idx += nthreads) {
      const int k = idx % q4, pos = idx / q4;
      const int iy = pos / IW, ix = pos % IW;
      const int y = ty0 - 1 + iy, x = tx0 - 1 + ix, c = c0 + 4 * k;
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (y >= 0 && y < H && x >= 0 && x < W && c < C) {
        const uint2 u = *reinterpret_cast<const uint2*>(xb + ((size_t)y * W + x) * C + c);
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
        f = make_float4(lo.x, lo.y, hi.x, hi.y);
      }
      *reinterpret_cast<float4*>(dst + pos * stride + 4 * k) = f;
    }
  } else {
    for (int idx = tid; idx < IH * IW * nch; idx += nthreads) {
      const int k = idx % nch, pos = idx / nch;
      const int iy = pos / IW, ix = pos % IW;
      const int y = ty0 - 1 + iy, x = tx0 - 1 + ix, c = c0 + k;
      const bool valid = y >= 0 && y < H && x >= 0 && x < W && c < C;
      dst[pos * stride + k] =
          valid ? __bfloat162float(xb[((size_t)y * W + x) * C + c]) : 0.f;
    }
  }
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// OP floats from shared memory (OP = 1, 2, 4 or 8; aligned to their size)
template <int OP>
__device__ __forceinline__ void load_w(const float* p, float* w) {
  if constexpr (OP == 1) {
    w[0] = p[0];
  } else if constexpr (OP == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
#pragma unroll
    for (int h = 0; h < OP / 4; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(p + 4 * h);
      w[4 * h] = v.x; w[4 * h + 1] = v.y; w[4 * h + 2] = v.z; w[4 * h + 3] = v.w;
    }
  }
}

struct ConvArgs {
  const float* x;     // (B, H, W, C)
  const float* w;     // (3, 3, C, O); flip: the forward weight (3, 3, O, C)
  const float* bias;  // (O,) or null
  float* out;         // (B, H, W, O)
  float* part;        // (2, B, tiles, O) scratch for the statistics, or null
  int H, W, C, O, vec;
};

// ---------------------------------------------------------------------------
// narrow O: O <= OP <= 8, any C
// ---------------------------------------------------------------------------

template <int OP>
__global__ void __launch_bounds__(kOThreads) narrow_o_kernel(const ConvArgs p) {
  extern __shared__ __align__(16) float smem[];
  float* sx = smem;                 // [stage][18][34][12]
  float* sw = smem + 2 * kOStageX;  // [stage][9][kOKC][OP]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.y;
  const int tiles_w = (p.W + kOTW - 1) / kOTW;
  const int ty0 = (blockIdx.x / tiles_w) * kOTH, tx0 = (blockIdx.x % tiles_w) * kOTW;
  const int C = p.C, O = p.O;
  const float* xb = p.x + (size_t)b * p.H * p.W * C;
  const int nchunks = (C + kOKC - 1) / kOKC;

  auto load = [&](int stage, int c0) {
    load_tile<kOIH, kOIW>(sx + stage * kOStageX, xb, ty0, tx0, p.H, p.W, C, c0, kOKC,
                          kOPS, p.vec, tid, kOThreads);
    float* dw = sw + stage * kOStageW;
    for (int idx = tid; idx < 9 * kOKC * OP; idx += kOThreads) {
      const int o = idx % OP, t = idx / OP;
      const int ck = t % kOKC, tap = t / kOKC, c = c0 + ck;
      const bool valid = c < C && o < O;
      cp_async4(dw + idx, valid ? p.w + ((size_t)tap * C + c) * O + o : p.w, valid);
    }
  };

  float acc[4][OP];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int o = 0; o < OP; ++o) acc[j][o] = 0.f;

  load(0, 0);
  cp_commit();
  for (int k = 0; k < nchunks; ++k) {
    const int st = k & 1;
    if (k + 1 < nchunks) load(st ^ 1, (k + 1) * kOKC);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* xs = sx + st * kOStageX + (4 * warp * kOIW + lane) * kOPS;
    const float* ws = sw + st * kOStageW;
    const int nq = min(kOKC / 4, (C - k * kOKC + 3) / 4);  // float4 groups holding channels
    for (int c4 = 0; c4 < nq; ++c4) {
#pragma unroll
      for (int dc = 0; dc < 3; ++dc) {
        float4 xv[6];
#pragma unroll
        for (int r = 0; r < 6; ++r)
          xv[r] = *reinterpret_cast<const float4*>(xs + (r * kOIW + dc) * kOPS + 4 * c4);
#pragma unroll
        for (int dr = 0; dr < 3; ++dr) {
#pragma unroll
          for (int ci = 0; ci < 4; ++ci) {
            float wv[OP];
            load_w<OP>(ws + ((dr * 3 + dc) * kOKC + 4 * c4 + ci) * OP, wv);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float a = comp(xv[j + dr], ci);
#pragma unroll
              for (int o = 0; o < OP; ++o) acc[j][o] = fmaf(a, wv[o], acc[j][o]);
            }
          }
        }
      }
    }
    __syncthreads();
  }
  cp_wait<0>();

  float s[OP], ss[OP];
#pragma unroll
  for (int o = 0; o < OP; ++o) s[o] = ss[o] = 0.f;
  const int x = tx0 + lane;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int y = ty0 + 4 * warp + j;
    if (y >= p.H || x >= p.W) continue;
    float v[OP];
#pragma unroll
    for (int o = 0; o < OP; ++o) {
      v[o] = acc[j][o] + (p.bias && o < O ? p.bias[o] : 0.f);
      if (o < O) {
        s[o] += v[o];
        ss[o] += v[o] * v[o];
      }
    }
    float* dst = p.out + (((size_t)b * p.H + y) * p.W + x) * O;
    if (OP == O && OP == 2) {
      *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
    } else if (OP == O && OP >= 4) {
#pragma unroll
      for (int h = 0; h < OP / 4; ++h)
        *reinterpret_cast<float4*>(dst + 4 * h) =
            make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
    } else {
#pragma unroll
      for (int o = 0; o < OP; ++o)
        if (o < O) dst[o] = v[o];
    }
  }

  if (p.part) {
    // the block's sums in a fixed order: a butterfly over the warp's columns,
    // then the four warps in turn
    __shared__ float red[2][4][OP];
#pragma unroll
    for (int o = 0; o < OP; ++o) {
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1) {
        s[o] += __shfl_xor_sync(0xffffffffu, s[o], m);
        ss[o] += __shfl_xor_sync(0xffffffffu, ss[o], m);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int o = 0; o < OP; ++o) {
        red[0][warp][o] = s[o];
        red[1][warp][o] = ss[o];
      }
    }
    __syncthreads();
    if (tid < 2 * O) {
      const int which = tid / O, o = tid % O;
      const float t = red[which][0][o] + red[which][1][o] + red[which][2][o] + red[which][3][o];
      const size_t tiles = gridDim.x;
      p.part[(((size_t)which * gridDim.y + b) * tiles + blockIdx.x) * O + o] = t;
    }
  }
}

// ---------------------------------------------------------------------------
// narrow C: C <= 8, any O; kFlip: the dgrad of a narrow-O conv (fp32)
// ---------------------------------------------------------------------------

template <bool kFlip>
__global__ void __launch_bounds__(kCThreads) narrow_c_kernel(const ConvArgs p) {
  __shared__ __align__(16) float sx[kCIH * kCIW * kPS];
  __shared__ __align__(16) float sw[9 * kKC * kCO];  // [tap][c][64 outputs]
  __shared__ float red[2][kCTW][kCO];
  const int tid = threadIdx.x;
  const int og = tid % 16, col = tid / 16;
  const int b = blockIdx.y, o0 = blockIdx.z * kCO;
  const int tiles_w = (p.W + kCTW - 1) / kCTW;
  const int ty0 = (blockIdx.x / tiles_w) * kCTH, tx0 = (blockIdx.x % tiles_w) * kCTW;
  const int C = p.C, O = p.O;

  load_tile<kCIH, kCIW>(sx, p.x + (size_t)b * p.H * p.W * C, ty0, tx0, p.H, p.W, C, 0,
                        kKC, kPS, p.vec, tid, kCThreads);
  cp_commit();
  for (int idx = tid; idx < 9 * kKC * kCO; idx += kCThreads) {
    const int oo = idx % kCO, t = idx / kCO;
    const int c = t % kKC, tap = t / kKC, o = o0 + oo;
    float v = 0.f;
    if (c < C && o < O)
      // flip: tap (dr, dc) takes the forward weight of tap (2 - dr, 2 - dc)
      // with the channel axes swapped
      v = kFlip ? p.w[((size_t)(8 - tap) * O + o) * C + c] : p.w[((size_t)tap * C + c) * O + o];
    sw[idx] = v;
  }
  cp_wait<0>();
  __syncthreads();

  const int nq = (C + 3) / 4;
  const int ob = o0 + 4 * og;
  const int x = tx0 + col;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, ss[4] = {0.f, 0.f, 0.f, 0.f};
  float bv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) bv[i] = p.bias && ob + i < O ? p.bias[ob + i] : 0.f;

#pragma unroll 1
  for (int r0 = 0; r0 < kCTH; r0 += kCRows) {
    float acc[kCRows][4];
#pragma unroll
    for (int j = 0; j < kCRows; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    for (int c4 = 0; c4 < nq; ++c4) {
#pragma unroll
      for (int dc = 0; dc < 3; ++dc) {
        float4 xv[kCRows + 2];
#pragma unroll
        for (int r = 0; r < kCRows + 2; ++r)
          xv[r] = *reinterpret_cast<const float4*>(sx + ((r0 + r) * kCIW + col + dc) * kPS +
                                                   4 * c4);
#pragma unroll
        for (int dr = 0; dr < 3; ++dr) {
#pragma unroll
          for (int ci = 0; ci < 4; ++ci) {
            const float4 w4 = *reinterpret_cast<const float4*>(
                sw + ((dr * 3 + dc) * kKC + 4 * c4 + ci) * kCO + 4 * og);
#pragma unroll
            for (int j = 0; j < kCRows; ++j) {
              const float a = comp(xv[j + dr], ci);
              acc[j][0] = fmaf(a, w4.x, acc[j][0]);
              acc[j][1] = fmaf(a, w4.y, acc[j][1]);
              acc[j][2] = fmaf(a, w4.z, acc[j][2]);
              acc[j][3] = fmaf(a, w4.w, acc[j][3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kCRows; ++j) {
      const int y = ty0 + r0 + j;
      if (y >= p.H || x >= p.W) continue;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = acc[j][i] + bv[i];
        if (ob + i < O) {
          s[i] += v[i];
          ss[i] += v[i] * v[i];
        }
      }
      float* dst = p.out + (((size_t)b * p.H + y) * p.W + x) * O + ob;
      if (O % 4 == 0) {
        if (ob < O) *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (ob + i < O) dst[i] = v[i];
      }
    }
  }

  if (p.part) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      red[0][col][4 * og + i] = s[i];
      red[1][col][4 * og + i] = ss[i];
    }
    __syncthreads();
    const int which = tid / kCO, oo = tid % kCO;  // 128 threads: sums, then squares
    if (o0 + oo < O) {
      float t = 0.f;
#pragma unroll
      for (int c = 0; c < kCTW; ++c) t += red[which][c][oo];
      p.part[(((size_t)which * gridDim.y + b) * gridDim.x + blockIdx.x) * O + o0 + oo] = t;
    }
  }
}

// out[s, k] = sum over i < n of part[s, i, k] for every slice s: each of
// kSumGroups threads of a column adds every kSumGroups-th row in order, then
// the groups' sums are added in order. A fixed order: no atomics.
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
// wgrad for O <= OP <= 8
// ---------------------------------------------------------------------------

template <typename T>
struct WgradArgs {
  const T* x;   // (B, H, W, C) the forward input
  const T* g;   // (B, H, W, O) the output's cotangent
  float* part;  // (B * runs, 9 * C * O + O): per-run dW, then dbias
  int H, W, C, O, runs, vec;
};

template <int OP, typename T>
__global__ void __launch_bounds__(kWThreads) narrow_wgrad_kernel(const WgradArgs<T> p) {
  extern __shared__ __align__(16) float smem[];
  float* sx = smem;             // [10][34][32]
  float* sg = smem + kWStageX;  // [8 * 32 pixels][OP]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int run = blockIdx.x % p.runs, b = blockIdx.x / p.runs;
  const int c0 = blockIdx.y * kWC;
  const int C = p.C, O = p.O;
  const int nch = min(kWC, C - c0);
  const T* xb = p.x + (size_t)b * p.H * p.W * C;
  const T* gb = p.g + (size_t)b * p.H * p.W * O;
  const int tiles_w = (p.W + kWTW - 1) / kWTW;
  const int tiles = ((p.H + kWTH - 1) / kWTH) * tiles_w;
  const int per = (tiles + p.runs - 1) / p.runs;
  const bool bias_thread = blockIdx.y == 0 && tid == 0;

  float acc[9][OP], gsum[OP];
#pragma unroll
  for (int o = 0; o < OP; ++o) {
    gsum[o] = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t) acc[t][o] = 0.f;
  }

  for (int tile = run * per; tile < min(tiles, (run + 1) * per); ++tile) {
    const int ty0 = (tile / tiles_w) * kWTH, tx0 = (tile % tiles_w) * kWTW;
    __syncthreads();
    load_tile<kWIH, kWIW>(sx, xb, ty0, tx0, p.H, p.W, C, c0, nch, kWC, p.vec, tid,
                          kWThreads);
    for (int idx = tid; idx < kWTH * kWTW * OP; idx += kWThreads) {
      const int o = idx % OP, px = idx / OP;
      const int y = ty0 + px / kWTW, x = tx0 + px % kWTW;
      const bool valid = y < p.H && x < p.W && o < O;
      if constexpr (std::is_same<T, float>::value)
        cp_async4(sg + idx, valid ? gb + ((size_t)y * p.W + x) * O + o : gb, valid);
      else
        sg[idx] = valid ? to_f(gb[((size_t)y * p.W + x) * O + o]) : 0.f;
    }
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    if (lane < nch) {
#pragma unroll 1
      for (int rr = 0; rr < 2; ++rr) {
        const int r = 2 * warp + rr;
        // a 3 x 3 window of this thread's channel slides along the tile row
        float a[3][3];
#pragma unroll
        for (int dr = 0; dr < 3; ++dr) {
          a[dr][1] = sx[((r + dr) * kWIW + 0) * kWC + lane];
          a[dr][2] = sx[((r + dr) * kWIW + 1) * kWC + lane];
        }
#pragma unroll 4
        for (int q = 0; q < kWTW; ++q) {
#pragma unroll
          for (int dr = 0; dr < 3; ++dr) {
            a[dr][0] = a[dr][1];
            a[dr][1] = a[dr][2];
            a[dr][2] = sx[((r + dr) * kWIW + q + 2) * kWC + lane];
          }
          float gv[OP];
          load_w<OP>(sg + (r * kWTW + q) * OP, gv);
#pragma unroll
          for (int t = 0; t < 9; ++t)
#pragma unroll
            for (int o = 0; o < OP; ++o) acc[t][o] = fmaf(a[t / 3][t % 3], gv[o], acc[t][o]);
          if (bias_thread) {
#pragma unroll
            for (int o = 0; o < OP; ++o) gsum[o] += gv[o];
          }
        }
      }
    }
    if (bias_thread) {
      // rows 2..7 of the tile: warp 0 covers rows 0 and 1 only
      for (int px = 2 * kWTW; px < kWTH * kWTW; ++px) {
        float gv[OP];
        load_w<OP>(sg + px * OP, gv);
#pragma unroll
        for (int o = 0; o < OP; ++o) gsum[o] += gv[o];
      }
    }
  }

  // the four warps' sums for each (channel, tap, output), in warp order
  __syncthreads();
  float* red = smem;  // [4 warps][32 channels][9 * OP]
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int o = 0; o < OP; ++o) red[(warp * kWC + lane) * 9 * OP + t * OP + o] = acc[t][o];
  __syncthreads();
  float* out = p.part + ((size_t)b * p.runs + run) * (9 * C * O + O);
  for (int idx = tid; idx < nch * 9 * O; idx += kWThreads) {
    const int o = idx % O, t = (idx / O) % 9, cl = idx / (9 * O);
    const int k = (cl * 9 + t) * OP + o;
    const float v = red[k] + red[kWC * 9 * OP + k] + red[2 * kWC * 9 * OP + k] +
                    red[3 * kWC * 9 * OP + k];
    out[((size_t)t * C + c0 + cl) * O + o] = v;
  }
  if (bias_thread) {
#pragma unroll
    for (int o = 0; o < OP; ++o)
      if (o < O) out[(size_t)9 * C * O + o] = gsum[o];
  }
}

// ---------------------------------------------------------------------------
// bf16 forward on the tensor cores
// ---------------------------------------------------------------------------

struct NarrowArgs {
  const bf16* x;      // (B, H, W, C)
  const bf16* w;      // (3, 3, C, O); kFlip: the forward weight (3, 3, O, C)
  const float* bias;  // (O,) or null
  bf16* out;          // (B, H, W, O)
  float* ostats;      // (2, B, O) the output's sums and sums of squares, or null
  float* part;        // (2, B, tiles, O) scratch for the statistics, or null
  int B, H, W, C, O;
  int xvec;           // x staged by 16-byte cp.async
  int wvec;           // the weights staged by 16-byte loads
  int ovec;           // out written 16 bytes a store
  int tiles_w, tiles; // pixel tiles along a row, in an image
};

// d += a b: bf16 m16n8k16, fp32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t bits(bf16 v) { return __bfloat16_as_ushort(v); }

// float4 unit f (of 16) of row r of a warp's 16 x 64 fp32 tile: XOR-swizzled
// so that the C fragments' 8-byte writes (a half-warp: rows r..r+3, units 2j
// and 2j + 1) and the read-back's 16-byte reads (8 lanes: one row, units 2q
// or 2q + 1 of q = 0..7) each fall on 32 distinct banks
__device__ __forceinline__ int bc_unit(int r, int f) {
  return f ^ ((f >> 3) & 1) ^ ((r & 3) << 1);
}

// P: elements a staged pixel, C rounded up to even (C + (C & 1))
template <int P, bool kFlip>
__global__ void __launch_bounds__(kBCThreads, bc_blocks_per_sm(P))
    narrow_c_bf16_kernel(const NarrowArgs p) {
  constexpr int KS = (9 * P + 15) / 16, K = 9 * P, RS = bc_row(P), OFF = 8 - P;
  __shared__ __align__(16) bf16 s_x[kBCStages][kBCStageElems];
  __shared__ __align__(16) float s_c[kBCWarps][16 * kBCN];  // a warp's fp32 tile; first the weights
  __shared__ float s_red[2][2][kBCWarps][kBCN];  // [tile parity][sums, squares][warp][output]
  __shared__ float s_bias[kBCN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, q = lane & 7;
  const int n0 = blockIdx.y * kBCN;
  const int C = p.C, O = p.O, H = p.H, W = p.W;
  const int nvalid = min(kBCN, O - n0);
  const int items = p.B * p.tiles;

  // the halo'd tile of an item, rows ty0 - 1 .. ty0 + 8, into ring stage st
  auto stage_in = [&](int item, int st) {
    const int b = item / p.tiles, tile = item - b * p.tiles;
    const int ty0 = (tile / p.tiles_w) * kBCTH, tx0 = (tile % p.tiles_w) * kBCTW;
    bf16* dst = s_x[st];
    if (p.xvec) {
      // the image rows' raw elements tx0 C - 8 .. in 16-byte copies: a copy
      // lies wholly inside a row (W C % 8 == 0) or is zero-filled
      constexpr int nch = RS / 8;
      const int rowlen = W * C;
      for (int i = tid; i < kBCIH * nch; i += kBCThreads) {
        const int iy = i / nch, j = i - iy * nch;
        const int y = ty0 - 1 + iy, e0 = tx0 * C - 8 + 8 * j;
        const bool ok = y >= 0 && y < H && e0 >= 0 && e0 + 8 <= rowlen;
        bf16t::cp16(bf16t::smem_addr(dst + iy * RS + 8 * j),
                    ok ? p.x + ((size_t)b * H + y) * rowlen + e0 : p.x, ok);
      }
    } else {
      for (int i = tid; i < kBCIH * (kBCTW + 2) * P; i += kBCThreads) {
        const int c = i % P, pix = i / P;
        const int iy = pix / (kBCTW + 2), ix = pix - iy * (kBCTW + 2);
        const int y = ty0 - 1 + iy, x = tx0 - 1 + ix;
        bf16 v = __float2bfloat16_rn(0.f);
        if (y >= 0 && y < H && x >= 0 && x < W && c < C)
          v = p.x[(((size_t)b * H + y) * W + x) * C + c];
        dst[iy * RS + OFF + ix * P + c] = v;
      }
    }
  };
  int item = blockIdx.x;
  if (item < items) stage_in(item, 0);  // in flight while the weights load
  bf16t::commit();

  // the weights, once: the block's slab [16 KS rows k = tap P + c][64
  // outputs] (16-byte loads where aligned; kFlip: tap (dr, dc) takes the
  // forward weight of tap (2 - dr, 2 - dc), whose (64 outputs, C) values are
  // one contiguous run) into shared memory, zero where padding, then this
  // thread's B fragments by ldmatrix .trans
  // (row k's 16-byte chunk j at j ^ (k & 7), so the 8 rows an ldmatrix
  // phase reads fall on distinct banks)
  bf16* sw = reinterpret_cast<bf16*>(&s_c[0][0]);
  auto at = [](int k, int n) { return k * kBCN + (((n >> 3) ^ (k & 7)) << 3) + (n & 7); };
  const bool dense = nvalid == kBCN && P == C;  // the loads write every row below K whole
  for (int i = tid + (dense ? K * kBCN / 8 : 0); i < 16 * KS * kBCN / 8; i += kBCThreads)
    reinterpret_cast<uint4*>(sw)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (!dense) __syncthreads();
  if (!kFlip) {
    if (p.wvec) {  // O % 8 == 0: 8 outputs a load
      const int q8 = nvalid / 8;
      for (int i = tid; i < 9 * C * q8; i += kBCThreads) {
        const int j = i % q8, r = i / q8, c = r % C, tap = r / C;
        *reinterpret_cast<uint4*>(sw + at(tap * P + c, 8 * j)) =
            *reinterpret_cast<const uint4*>(p.w + (size_t)r * O + n0 + 8 * j);
      }
    } else {
      for (int i = tid; i < 9 * C * nvalid; i += kBCThreads) {
        const int n = i % nvalid, r = i / nvalid, c = r % C, tap = r / C;
        sw[at(tap * P + c, n)] = p.w[(size_t)r * O + n0 + n];
      }
    }
  } else {
    const int run = nvalid * C;
    if (p.wvec) {  // run and its offsets multiples of 8
      const int r8 = run / 8;
      for (int i = tid; i < 9 * r8; i += kBCThreads) {
        const int tap = i / r8, j = i - tap * r8;
        const uint4 v = *reinterpret_cast<const uint4*>(p.w + ((size_t)(8 - tap) * O + n0) * C +
                                                        8 * j);
        const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int n = (8 * j + u) / C, c = 8 * j + u - n * C;
          sw[at(tap * P + c, n)] = e[u];
        }
      }
    } else {
      for (int i = tid; i < 9 * run; i += kBCThreads) {
        const int tap = i / run, j = i - tap * run, n = j / C, c = j - n * C;
        sw[at(tap * P + c, n)] = p.w[((size_t)(8 - tap) * O + n0) * C + j];
      }
    }
  }
  if (tid < kBCN) s_bias[tid] = p.bias && n0 + tid < O ? p.bias[n0 + tid] : 0.f;
  __syncthreads();
  // b0 (k 2t, 2t + 1) and b1 (k 2t + 8, 2t + 9) of output 8 j + g, k step
  // s: lane l gives row 16 s + (l & 7) + 8 ((l >> 3) & 1) of output block
  // 2 jj + (l >> 4)
  uint32_t bw[KS][8][2];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t r[4];
      bf16t::ldsm_x4_trans(
          bf16t::smem_addr(sw + at(16 * s + (lane & 7) + 8 * ((lane >> 3) & 1),
                                   8 * (2 * jj + (lane >> 4)))),
          r);
      bw[s][2 * jj][0] = r[0];
      bw[s][2 * jj][1] = r[1];
      bw[s][2 * jj + 1][0] = r[2];
      bw[s][2 * jj + 1][1] = r[3];
    }
  }
  // this lane's A reads: k 16 s + 8 h + 2 t as an offset from its pixel
  // (-1: padding of K)
  int aoff[KS][2];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 16 * s + 8 * h + 2 * t, tap = k / P, c = k - tap * P;
      aoff[s][h] = k < K ? (tap / 3) * RS + (tap % 3) * P + c : -1;
    }
  }
  // the read-back's channels: 8 q .. 8 q + 7 of the block's 64
  float bv[8], sum[8], sq[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    bv[e] = s_bias[8 * q + e];
    sum[e] = sq[e] = 0.f;
  }
  __syncthreads();  // the slab is read: s_c holds the fp32 tiles from here on

  // the statistics of a tile, summed over the warps in turn into the (2, B,
  // tiles, O) scratch once the next tile's barrier has passed
  auto tile_sums = [&](int par, int b, int tile) {
    const int which = tid / kBCN, o = tid % kBCN;  // threads 0-127: sums, then squares
    if (which < 2 && n0 + o < O) {
      float a = s_red[par][which][0][o];
#pragma unroll
      for (int w = 1; w < kBCWarps; ++w) a += s_red[par][which][w][o];
      p.part[(((size_t)which * p.B + b) * p.tiles + tile) * O + n0 + o] = a;
    }
  };
  int prev_b = 0, prev_tile = 0;

  int last = -1;
  for (int i = 0; item < items; ++i, item += gridDim.x) {
    const int st = i & 1;
    if (item + (int)gridDim.x < items) stage_in(item + gridDim.x, st ^ 1);
    bf16t::commit();
    bf16t::wait<1>();
    __syncthreads();
    if (p.part && i > 0) tile_sums((i - 1) & 1, prev_b, prev_tile);
    const int b = item / p.tiles, tile = item - b * p.tiles;
    const int ty0 = (tile / p.tiles_w) * kBCTH, tx0 = (tile % p.tiles_w) * kBCTW;
    prev_b = b;
    prev_tile = tile;
    float* cs = s_c[warp];
#pragma unroll 1
    for (int u = warp; u < kBCTH && ty0 + u < H; u += kBCWarps) {
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      const bf16* px = s_x[st] + u * RS + OFF + g * P;  // pixel g; g + 8 is 8 P on
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        uint32_t a[4];
        a[0] = aoff[s][0] >= 0 ? lds32(px + aoff[s][0]) : 0u;
        a[1] = aoff[s][0] >= 0 ? lds32(px + 8 * P + aoff[s][0]) : 0u;
        a[2] = aoff[s][1] >= 0 ? lds32(px + aoff[s][1]) : 0u;
        a[3] = aoff[s][1] >= 0 ? lds32(px + 8 * P + aoff[s][1]) : 0u;
#pragma unroll
        for (int j = 0; j < 8; ++j) mma16816(acc[j], a, bw[s][j][0], bw[s][j][1]);
      }
      // the fragments (rows g and g + 8, outputs 8 j + 2 t, + 1) into the
      // warp's fp32 tile, then a lane reads 8 outputs of rows lane / 8 + 4 r
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int f = 2 * j + (t >> 1), w2 = 2 * (t & 1);
        *reinterpret_cast<float2*>(cs + g * kBCN + 4 * bc_unit(g, f) + w2) =
            make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(cs + (g + 8) * kBCN + 4 * bc_unit(g + 8, f) + w2) =
            make_float2(acc[j][2], acc[j][3]);
      }
      __syncwarp();
      bf16* orow = p.out + ((size_t)b * H + ty0 + u) * W * O + n0 + 8 * q;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int pr = (lane >> 3) + 4 * r, x = tx0 + pr;
        const float4 lo = *reinterpret_cast<const float4*>(cs + pr * kBCN + 4 * bc_unit(pr, 2 * q));
        const float4 hi =
            *reinterpret_cast<const float4*>(cs + pr * kBCN + 4 * bc_unit(pr, 2 * q + 1));
        float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        if (x < W) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            v[e] += bv[e];
            sum[e] += v[e];
            sq[e] += v[e] * v[e];
          }
          bf16* dst = orow + (size_t)x * O;
          if (p.ovec && n0 + 8 * q + 8 <= O) {
            *reinterpret_cast<uint4*>(dst) =
                make_uint4(bf16t::pack2(v[0], v[1]), bf16t::pack2(v[2], v[3]),
                           bf16t::pack2(v[4], v[5]), bf16t::pack2(v[6], v[7]));
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (n0 + 8 * q + e < O) dst[e] = __float2bfloat16_rn(v[e]);
          }
        }
      }
      __syncwarp();
    }
    if (p.part) {
      // the warp's sums of the tile: the lanes of a channel chunk in a
      // butterfly
#pragma unroll
      for (int e = 0; e < 8; ++e) {
#pragma unroll
        for (int m = 8; m <= 16; m <<= 1) {
          sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], m);
          sq[e] += __shfl_xor_sync(0xffffffffu, sq[e], m);
        }
        if (lane < 8) {
          s_red[i & 1][0][warp][8 * q + e] = sum[e];
          s_red[i & 1][1][warp][8 * q + e] = sq[e];
        }
        sum[e] = sq[e] = 0.f;
      }
    }
    __syncthreads();  // stage st is free again
    last = i;
  }
  if (p.part && last >= 0) tile_sums(last & 1, prev_b, prev_tile);
  bf16t::wait<0>();
  if (p.ostats) {
    // a cooperative launch: every tile's partials are written, (2, B, tiles,
    // O). A block adds 8 outputs of one (which, b) row: lane group gr = 4
    // warp + lane / 8 (of kGroups) and output 8 og + lane % 8 over the tiles
    // gr, gr + kGroups, ... in order, then the groups in turn
    constexpr int kGroups = 4 * kBCWarps;
    cg::this_grid().sync();
    float(*fin)[8] = reinterpret_cast<float(*)[8]>(&s_c[0][0]);
    const int ogroups = (O + 7) / 8, gr = 4 * warp + (lane >> 3);
    for (int k = blockIdx.y * gridDim.x + blockIdx.x; k < 2 * p.B * ogroups;
         k += gridDim.x * gridDim.y) {
      const int row = k / ogroups, o0 = 8 * (k - row * ogroups), o = o0 + q;
      float a = 0.f;
      if (o < O) {
        const float* src = p.part + (size_t)row * p.tiles * O + o;
#pragma unroll 8
        for (int tl = gr; tl < p.tiles; tl += kGroups) a += src[(size_t)tl * O];
      }
      fin[gr][q] = a;
      __syncthreads();
      if (tid < 8 && o0 + tid < O) {
        float s = fin[0][tid];
#pragma unroll
        for (int j = 1; j < kGroups; ++j) s += fin[j][tid];
        p.ostats[(size_t)row * O + o0 + tid] = s;
      }
      __syncthreads();
    }
  }
}

// kFold (O <= 2): N holds the three row taps' outputs (n = 2 dy + o), so
// one product of an input row serves all three; its output rows are summed
// from three lanes at the end of the tile
template <bool kFold>
__global__ void __launch_bounds__(kBOThreads, kBOBlocksPerSm)
    narrow_o_bf16_kernel(const NarrowArgs p) {
  extern __shared__ __align__(16) unsigned char bo_smem_raw[];
  constexpr int kSteps = kFold ? 3 : 9;  // k steps of a 16-channel chunk: column taps, or taps
  const int C = p.C, O = p.O, H = p.H, W = p.W;
  const int nkc = (C + kBOKC - 1) / kBOKC;
  // [stage][612 pixels][32 B], [nkc][kSteps][32 lanes], [16][32 pixels][O],
  // [2][4 warps][8]
  unsigned char* s_x = bo_smem_raw;
  uint2* s_w = reinterpret_cast<uint2*>(bo_smem_raw + kBOStages * kBOStageBytes);
  bf16* s_o = reinterpret_cast<bf16*>(s_w + kSteps * nkc * 32);
  float* s_red = reinterpret_cast<float*>(s_o + kBOTH * kBOTW * O);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wy = warp >> 1, wx = warp & 1;

  const int items = p.B * p.tiles;
  const int mine = items > (int)blockIdx.x ? (items - 1 - (int)blockIdx.x) / gridDim.x + 1 : 0;
  const int nsteps = mine * nkc;  // (item, 16-channel chunk) pairs, chunks inner
  // step s: channels 16 kc .. of the halo'd tile of this block's item s / nkc
  auto issue = [&](int s) {
    const int item = blockIdx.x + (s / nkc) * gridDim.x, kc = s % nkc;
    const int b = item / p.tiles, tile = item - b * p.tiles;
    const int ty0 = (tile / p.tiles_w) * kBOTH, tx0 = (tile % p.tiles_w) * kBOTW;
    unsigned char* dst = s_x + (s % kBOStages) * kBOStageBytes;
    const bf16* xb = p.x + (size_t)b * H * W * C;
    if (p.xvec) {  // C % 8 == 0: a pixel's 16 channels are two 16-byte copies
      for (int i = tid; i < kBOIH * kBOIW * 2; i += kBOThreads) {
        const int pix = i >> 1, h = i & 1, iy = pix / kBOIW, ix = pix - iy * kBOIW;
        const int y = ty0 - 1 + iy, x = tx0 - 1 + ix, c = kc * kBOKC + 8 * h;
        const bool ok = y >= 0 && y < H && x >= 0 && x < W && c < C;
        bf16t::cp16(bf16t::smem_addr(dst + pix * 32 + 16 * (h ^ ((pix >> 2) & 1))),
                    ok ? xb + ((size_t)y * W + x) * C + c : p.x, ok);
      }
    } else {
      for (int i = tid; i < kBOIH * kBOIW * kBOKC; i += kBOThreads) {
        const int pix = i >> 4, cc = i & 15, iy = pix / kBOIW, ix = pix - iy * kBOIW;
        const int y = ty0 - 1 + iy, x = tx0 - 1 + ix, c = kc * kBOKC + cc;
        bf16 v = __float2bfloat16_rn(0.f);
        if (y >= 0 && y < H && x >= 0 && x < W && c < C) v = xb[((size_t)y * W + x) * C + c];
        *reinterpret_cast<bf16*>(dst + pix * 32 + 16 * ((cc >> 3) ^ ((pix >> 2) & 1)) +
                                 2 * (cc & 7)) = v;
      }
    }
  };
  // the ring's first stages are in flight while the weights load
#pragma unroll
  for (int s = 0; s < kBOStages - 1; ++s) {
    if (s < nsteps) issue(s);
    bf16t::commit();
  }

  // the weights, once: slabs of (kc, tap) runs of 16 O values (16-byte loads
  // where C % 16 == 0) staged raw in the output tile's space, then
  // rearranged into fragments, b0 (k 2t, 2t + 1) and b1 (k 2t + 8, 2t + 9)
  // of output column g; padded channels and columns zero
  {
    const int per = 9 * kBOKC * O;
    const int group = max(1, kBOTH * kBOTW * O / per);
    bf16* raw = s_o;  // [(kc - k0) 9 + tap][16][O]
    for (int k0 = 0; k0 < nkc; k0 += group) {
      const int nk = min(group, nkc - k0);
      if (p.wvec) {
        const int q = 2 * O;  // 16-byte loads a run
        for (int i = tid; i < nk * 9 * q; i += kBOThreads) {
          const int j = i % q, r = i / q, tap = r % 9, kc = k0 + r / 9;
          *reinterpret_cast<uint4*>(raw + r * kBOKC * O + 8 * j) = *reinterpret_cast<const uint4*>(
              p.w + ((size_t)tap * C + kc * kBOKC) * O + 8 * j);
        }
      } else {
        for (int i = tid; i < nk * per; i += kBOThreads) {
          const int o = i % O, rest = i / O, cc = rest % kBOKC, r = rest / kBOKC;
          const int c = (k0 + r / 9) * kBOKC + cc;
          raw[i] = c < C ? p.w[((size_t)(r % 9) * C + c) * O + o] : __float2bfloat16_rn(0.f);
        }
      }
      __syncthreads();
      for (int i = tid; i < nk * kSteps * 32; i += kBOThreads) {
        const int l = i & 31, r = i >> 5, kcl = r / kSteps, st = r - kcl * kSteps;
        const int gg = l >> 2, tt = l & 3;
        // column gg: output gg of tap st, or (kFold) output gg & 1 of tap
        // (gg >> 1, st)
        const int tap = kFold ? (gg >> 1) * 3 + st : st, o = kFold ? gg & 1 : gg;
        const bool ok = kFold ? gg < 6 && o < O : gg < O;
        auto v = [&](int kk) -> uint32_t {
          return ok ? bits(raw[((kcl * 9 + tap) * kBOKC + kk) * O + o]) : 0u;
        };
        s_w[(k0 * kSteps + r) * 32 + l] = make_uint2(v(2 * tt) | (v(2 * tt + 1) << 16),
                                                     v(2 * tt + 8) | (v(2 * tt + 9) << 16));
      }
      __syncthreads();
    }
  }
  const float bias0 = p.bias && 2 * t < O ? p.bias[2 * t] : 0.f;
  const float bias1 = p.bias && 2 * t + 1 < O ? p.bias[2 * t + 1] : 0.f;

  // this lane's ldmatrix row: pixel (lane & 7) + 8 ((lane >> 3) & 1) of the
  // warp's 16, channel half lane >> 4 (a0: pixels 0-7, k 0-7; a1: 8-15;
  // a2, a3: k 8-15)
  const int lp = (lane & 7) + 8 * ((lane >> 3) & 1), lh = lane >> 4;
  // kFold: a sum per input row of the warp (10); else per output row (8)
  float acc[10][4];
  float sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
  for (int s = 0; s < nsteps; ++s) {
    bf16t::wait<kBOStages - 2>();
    __syncthreads();  // step s landed; step s - 1's stage is free
    if (s + kBOStages - 1 < nsteps) issue(s + kBOStages - 1);
    bf16t::commit();
    const int kc = s % nkc;
    if (kc == 0) {
#pragma unroll
      for (int r = 0; r < 10; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    }
    const uint32_t xs = bf16t::smem_addr(s_x + (s % kBOStages) * kBOStageBytes);
    // input row r of the warp feeds output rows r, r - 1, r - 2 (row taps 0,
    // 1, 2) at each column tap
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      uint2 bfr[3];
#pragma unroll
      for (int dy = 0; dy < (kFold ? 1 : 3); ++dy)
        bfr[dy] = s_w[(kc * kSteps + (kFold ? dx : dy * 3 + dx)) * 32 + lane];
#pragma unroll
      for (int r = 0; r < 10; ++r) {
        const int pix = (8 * wy + r) * kBOIW + 16 * wx + dx + lp;
        uint32_t a[4];
        bf16t::ldsm_x4(xs + pix * 32 + 16 * (lh ^ ((pix >> 2) & 1)), a);
        if (kFold) {
          mma16816(acc[r], a, bfr[0].x, bfr[0].y);
        } else {
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
            if (r - dy >= 0 && r - dy < 8) mma16816(acc[r - dy], a, bfr[dy].x, bfr[dy].y);
        }
      }
    }
    if (kc != nkc - 1) continue;

    // the tile's outputs: lane (g, t) holds outputs 2t, 2t + 1 of pixels g and
    // g + 8 of each of the warp's 8 rows (kFold: lanes t = 0, adding row tap
    // dy's sum from lane t = dy of input row r + dy)
    const int item = blockIdx.x + (s / nkc) * gridDim.x;
    const int b = item / p.tiles, tile = item - b * p.tiles;
    const int ty0 = (tile / p.tiles_w) * kBOTH, tx0 = (tile % p.tiles_w) * kBOTW;
    const int xa = tx0 + 16 * wx + g, o0 = 2 * t;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int ry = 8 * wy + r;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = acc[r][e];
        if (kFold) {
          v[e] += __shfl_down_sync(0xffffffffu, acc[r + 1][e], 1);
          v[e] += __shfl_down_sync(0xffffffffu, acc[r + 2][e], 2);
        }
        v[e] += e & 1 ? bias1 : bias0;
      }
      if (ty0 + ry < H) {
        if (xa < W) {
          sum[0] += v[0]; sq[0] += v[0] * v[0];
          sum[1] += v[1]; sq[1] += v[1] * v[1];
        }
        if (xa + 8 < W) {
          sum[0] += v[2]; sq[0] += v[2] * v[2];
          sum[1] += v[3]; sq[1] += v[3] * v[3];
        }
      }
      bf16* so = s_o + (ry * kBOTW + 16 * wx + g) * O + o0;
      if (o0 < O) {
        so[0] = __float2bfloat16_rn(v[0]);
        so[8 * O] = __float2bfloat16_rn(v[2]);
      }
      if (o0 + 1 < O) {
        so[1] = __float2bfloat16_rn(v[1]);
        so[8 * O + 1] = __float2bfloat16_rn(v[3]);
      }
    }
    if (p.part) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int m = 4; m <= 16; m <<= 1) {
          sum[k] += __shfl_xor_sync(0xffffffffu, sum[k], m);
          sq[k] += __shfl_xor_sync(0xffffffffu, sq[k], m);
        }
        if (g == 0) {
          s_red[warp * 8 + o0 + k] = sum[k];
          s_red[32 + warp * 8 + o0 + k] = sq[k];
        }
        sum[k] = sq[k] = 0.f;
      }
    }
    __syncthreads();
    bf16* ob = p.out + (size_t)b * H * W * O;
    if (p.ovec && tx0 + kBOTW <= W) {
      const int q = 4 * O;  // 16-byte stores a tile row: 32 pixels x O x 2 bytes
      for (int i = tid; i < kBOTH * q; i += kBOThreads) {
        const int ry = i / q, j = i - ry * q;
        if (ty0 + ry < H)
          *reinterpret_cast<uint4*>(ob + ((size_t)(ty0 + ry) * W + tx0) * O + 8 * j) =
              *reinterpret_cast<const uint4*>(s_o + ry * kBOTW * O + 8 * j);
      }
    } else {
      for (int i = tid; i < kBOTH * kBOTW * O; i += kBOThreads) {
        const int px = (i / O) % kBOTW, ry = i / (O * kBOTW);
        if (ty0 + ry < H && tx0 + px < W)
          ob[((size_t)(ty0 + ry) * W + tx0 + px) * O + i % O] = s_o[i];
      }
    }
    if (p.part && tid < 2 * O) {
      const int which = tid / O, o = tid - which * O;
      const float* rr = s_red + 32 * which;
      p.part[(((size_t)which * p.B + b) * p.tiles + tile) * O + o] =
          rr[o] + rr[8 + o] + rr[16 + o] + rr[24 + o];
    }
  }
  bf16t::wait<0>();
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// above 48 KB of dynamic shared memory a kernel must opt in, once per process
cudaError_t configure() {
  static cudaError_t err = [] {
    cudaError_t e = allow_smem(narrow_o_kernel<1>, kOSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_o_kernel<2>, kOSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_o_kernel<4>, kOSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_o_kernel<8>, kOSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_o_bf16_kernel<true>, bo_smem(kBOMaxC / kBOKC, 2));
    if (e == cudaSuccess) e = allow_smem(narrow_o_bf16_kernel<false>, bo_smem(kBOMaxC / kBOKC, 8));
    if (e == cudaSuccess) e = allow_smem(narrow_wgrad_kernel<1, float>, kWSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_wgrad_kernel<2, float>, kWSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_wgrad_kernel<4, float>, kWSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_wgrad_kernel<8, float>, kWSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_wgrad_kernel<1, bf16>, kWSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_wgrad_kernel<2, bf16>, kWSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_wgrad_kernel<4, bf16>, kWSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_wgrad_kernel<8, bf16>, kWSmem);
    return e;
  }();
  return err;
}

int tiles_of(int h, int wd, int th, int tw) { return ((h + th - 1) / th) * ((wd + tw - 1) / tw); }

bool vec_ok(const float* x, int c) { return c % 4 == 0 && (uintptr_t)x % 16 == 0; }
bool vec_ok(const bf16* x, int c) { return c % 4 == 0 && (uintptr_t)x % 8 == 0; }
bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// The bf16 launch plan: which kernel (0 narrow O, 1 narrow C), the pixel
// tiles of an image, the grid (persistent blocks along x; 64-output chunks
// along y), the dynamic shared memory and the blocks an SM it is sized for.
struct Bf16Plan {
  int which, tiles, grid_x, grid_y, smem, blocks_per_sm;
};

Bf16Plan bo_plan(int batch, int h, int wd, int c, int o) {
  const int tiles = tiles_of(h, wd, kBOTH, kBOTW);
  return {0, tiles, std::min(batch * tiles, kBOBlocksPerSm * bf16t::sm_count()), 1,
          bo_smem((c + kBOKC - 1) / kBOKC, o), kBOBlocksPerSm};
}

Bf16Plan bc_plan(int batch, int h, int wd, int c, int o) {
  const int tiles = tiles_of(h, wd, kBCTH, kBCTW), chunks = (o + kBCN - 1) / kBCN;
  const int bps = bc_blocks_per_sm(c + (c & 1));
  // at most bps blocks an SM in all: a cooperative launch needs them resident
  return {1, tiles, std::min(batch * tiles, std::max(1, bps * bf16t::sm_count() / chunks)),
          chunks, 0, bps};
}

Bf16Plan bf16_plan(int batch, int h, int wd, int c, int o) {
  return o <= 8 ? bo_plan(batch, h, wd, c, o) : bc_plan(batch, h, wd, c, o);
}

// narrow_c_bf16_kernel on p (C <= 8): the copy and store widths, then the
// instance of its pitch; with statistics a cooperative launch (the blocks
// finish the sums after a grid-wide barrier)
template <int P, bool kFlip>
cudaError_t launch_narrow_c_bf16(const NarrowArgs& p, dim3 grid, cudaStream_t st) {
  if (!p.ostats) {
    narrow_c_bf16_kernel<P, kFlip><<<grid, kBCThreads, 0, st>>>(p);
    return cudaGetLastError();
  }
  void* args[] = {const_cast<NarrowArgs*>(&p)};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)narrow_c_bf16_kernel<P, kFlip>, grid, dim3(kBCThreads), args, 0, st);
  const cudaError_t last = cudaGetLastError();  // read, so a refusal does not linger
  return e != cudaSuccess ? e : last;
}

template <bool kFlip>
cudaError_t launch_narrow_c_bf16(NarrowArgs p, cudaStream_t st) {
  const Bf16Plan pl = bc_plan(p.B, p.H, p.W, p.C, p.O);
  p.xvec = p.C % 2 == 0 && (p.W * p.C) % 8 == 0 && aligned16(p.x);
  p.ovec = p.O % 8 == 0 && aligned16(p.out);
  p.wvec = (kFlip ? (p.C * p.O) % 8 == 0 && (p.C * (p.O % kBCN)) % 8 == 0 : p.O % 8 == 0) &&
           aligned16(p.w);
  p.tiles_w = (p.W + kBCTW - 1) / kBCTW;
  p.tiles = pl.tiles;
  const dim3 grid(pl.grid_x, pl.grid_y);
  switch (p.C + (p.C & 1)) {
    case 2: return launch_narrow_c_bf16<2, kFlip>(p, grid, st);
    case 4: return launch_narrow_c_bf16<4, kFlip>(p, grid, st);
    case 6: return launch_narrow_c_bf16<6, kFlip>(p, grid, st);
    default: return launch_narrow_c_bf16<8, kFlip>(p, grid, st);
  }
}

// the forward: ostats and part as mc_narrow_conv's
int narrow_conv(const float* x, const float* w, const float* bias, float* out, float* ostats,
                float* part, int batch, int h, int wd, int c, int o, void* stream) {
  if (batch < 1 || h < 1 || wd < 1 || c < 1 || o < 1 || (c > kKC && o > 8) ||
      (!ostats) != (!part))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  ConvArgs p{x, w, bias, out, part, h, wd, c, o, (int)vec_ok(x, c)};
  const int which = o <= 8 ? 0 : 1;
  const int tiles = which ? tiles_of(h, wd, kCTH, kCTW) : tiles_of(h, wd, kOTH, kOTW);
  if (which == 0) {
    dim3 grid(tiles, batch);
    if (o <= 1) narrow_o_kernel<1><<<grid, kOThreads, kOSmem, st>>>(p);
    else if (o <= 2) narrow_o_kernel<2><<<grid, kOThreads, kOSmem, st>>>(p);
    else if (o <= 4) narrow_o_kernel<4><<<grid, kOThreads, kOSmem, st>>>(p);
    else narrow_o_kernel<8><<<grid, kOThreads, kOSmem, st>>>(p);
  } else {
    dim3 grid(tiles, batch, (o + kCO - 1) / kCO);
    narrow_c_kernel<false><<<grid, kCThreads, 0, st>>>(p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || !ostats) return (int)err;
  colsum_kernel<<<dim3((o + 31) / 32, 2 * batch), 32 * kSumGroups, 0, st>>>(part, ostats,
                                                                          tiles, o);
  return (int)cudaGetLastError();
}

int narrow_conv(const bf16* x, const bf16* w, const float* bias, bf16* out, float* ostats,
                float* part, int batch, int h, int wd, int c, int o, void* stream) {
  if (batch < 1 || h < 1 || wd < 1 || c < 1 || o < 1 || (c > kKC && o > 8) ||
      (o <= 8 && c > kBOMaxC) || (!ostats) != (!part))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  NarrowArgs p{x, w, bias, out, nullptr, part, batch, h, wd, c, o, 0, 0, 0, 0, 0};
  const Bf16Plan pl = bf16_plan(batch, h, wd, c, o);
  if (pl.which == 1) {  // the narrow-C kernel finishes its statistics itself
    p.ostats = ostats;
    return (int)launch_narrow_c_bf16<false>(p, st);
  }
  p.xvec = c % 8 == 0 && aligned16(x);
  p.wvec = c % kBOKC == 0 && aligned16(w);
  p.ovec = (o == 1 || o == 2 || o == 4 || o == 8) && (wd * o) % 8 == 0 && aligned16(out);
  p.tiles_w = (wd + kBOTW - 1) / kBOTW;
  p.tiles = pl.tiles;
  if (o <= 2) narrow_o_bf16_kernel<true><<<pl.grid_x, kBOThreads, pl.smem, st>>>(p);
  else narrow_o_bf16_kernel<false><<<pl.grid_x, kBOThreads, pl.smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || !ostats) return (int)err;
  colsum_kernel<<<dim3((o + 31) / 32, 2 * batch), 32 * kSumGroups, 0, st>>>(part, ostats,
                                                                          pl.tiles, o);
  return (int)cudaGetLastError();
}

// dgrad: the narrow-C kernel on g (o channels in, c out), weights mirrored
cudaError_t dgrad(const float* g, const float* w, float* dx, int batch, int h, int wd, int c,
                  int o, cudaStream_t st) {
  ConvArgs p{g, w, nullptr, dx, nullptr, h, wd, o, c, (int)vec_ok(g, o)};
  dim3 grid(tiles_of(h, wd, kCTH, kCTW), batch, (c + kCO - 1) / kCO);
  narrow_c_kernel<true><<<grid, kCThreads, 0, st>>>(p);
  return cudaGetLastError();
}

cudaError_t dgrad(const bf16* g, const bf16* w, bf16* dx, int batch, int h, int wd, int c,
                  int o, cudaStream_t st) {
  NarrowArgs p{g, w, nullptr, dx, nullptr, nullptr, batch, h, wd, o, c, 0, 0, 0, 0, 0};
  return launch_narrow_c_bf16<true>(p, st);
}

// the backward for either element type; arguments as mc_narrow_conv_bwd's
template <typename T>
int narrow_conv_bwd(const T* g, const T* x, const T* w, T* dx, float* dwb, float* part,
                    int batch, int h, int wd, int c, int o, int runs, void* stream) {
  if (batch < 1 || h < 1 || wd < 1 || c < 1 || o < 1 || o > 8 || runs < 1 || !dwb || !part)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (dx) {
    err = dgrad(g, w, dx, batch, h, wd, c, o, st);
    if (err != cudaSuccess) return (int)err;
  }
  WgradArgs<T> q{x, g, part, h, wd, c, o, runs, (int)vec_ok(x, c)};
  dim3 grid(batch * runs, (c + kWC - 1) / kWC);
  if (o <= 1) narrow_wgrad_kernel<1, T><<<grid, kWThreads, kWSmem, st>>>(q);
  else if (o <= 2) narrow_wgrad_kernel<2, T><<<grid, kWThreads, kWSmem, st>>>(q);
  else if (o <= 4) narrow_wgrad_kernel<4, T><<<grid, kWThreads, kWSmem, st>>>(q);
  else narrow_wgrad_kernel<8, T><<<grid, kWThreads, kWSmem, st>>>(q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int k = 9 * c * o + o;
  colsum_kernel<<<dim3((k + 31) / 32, 1), 32 * kSumGroups, 0, st>>>(part, dwb, batch * runs, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Pixel tiles per image of the forward (which = 0: narrow O, used when o <= 8,
// both element types; 1: the fp32 narrow-C kernel; 3: the bf16 narrow-C
// kernel) and of the wgrad kernel (2). The statistics scratch of the forward
// is (2, batch, tiles, o) floats.
int mc_narrow_conv_tiles(int h, int wd, int which) {
  if (which == 0) return tiles_of(h, wd, kOTH, kOTW);
  if (which == 1) return tiles_of(h, wd, kCTH, kCTW);
  if (which == 3) return tiles_of(h, wd, kBCTH, kBCTW);
  return tiles_of(h, wd, kWTH, kWTW);
}

// The bf16 forward's launch plan on the current device: out[6] = which
// kernel (0 narrow O, 1 narrow C), tiles per image, grid x (persistent
// blocks), grid y (64-output chunks), dynamic shared memory bytes, blocks an
// SM the grid is sized for.
int mc_narrow_conv_plan(int batch, int h, int wd, int c, int o, int* out) {
  if (batch < 1 || h < 1 || wd < 1 || c < 1 || o < 1 || (c > kKC && o > 8))
    return (int)cudaErrorInvalidValue;
  const Bf16Plan pl = bf16_plan(batch, h, wd, c, o);
  out[0] = pl.which;
  out[1] = pl.tiles;
  out[2] = pl.grid_x;
  out[3] = pl.grid_y;
  out[4] = pl.smem;
  out[5] = pl.blocks_per_sm;
  return 0;
}

// out = conv3x3_same(x) + bias for c <= 8 or o <= 8 (o <= 8 takes the
// narrow-O kernel). ostats: null, or (2, batch, o), the output's channel
// sums and sums of squares, with part the (2, batch, tiles, o) scratch.
int mc_narrow_conv(const float* x, const float* w, const float* bias, float* out,
                   float* ostats, float* part, int batch, int h, int wd, int c, int o,
                   void* stream) {
  return narrow_conv(x, w, bias, out, ostats, part, batch, h, wd, c, o, stream);
}

// The bf16 instance: x, w and out bf16; bias, ostats and part fp32 (tiles:
// mc_narrow_conv_tiles(h, wd, o <= 8 ? 0 : 3)); o <= 8 takes c <= 512.
int mc_narrow_conv_bf16(const bf16* x, const bf16* w, const float* bias, bf16* out,
                        float* ostats, float* part, int batch, int h, int wd, int c, int o,
                        void* stream) {
  return narrow_conv(x, w, bias, out, ostats, part, batch, h, wd, c, o, stream);
}

// The backward of out = conv3x3_same(x) + bias for o <= 8: dx (null: not
// computed) and dwb, dW (3, 3, c, o) followed by dbias (o,). part:
// (batch * runs, 9 c o + o) scratch; runs: pixel-tile runs per image.
int mc_narrow_conv_bwd(const float* g, const float* x, const float* w, float* dx,
                       float* dwb, float* part, int batch, int h, int wd, int c, int o,
                       int runs, void* stream) {
  return narrow_conv_bwd(g, x, w, dx, dwb, part, batch, h, wd, c, o, runs, stream);
}

// The bf16 instance: g, x, w and dx bf16; dwb and part fp32.
int mc_narrow_conv_bwd_bf16(const bf16* g, const bf16* x, const bf16* w, bf16* dx, float* dwb,
                            float* part, int batch, int h, int wd, int c, int o, int runs,
                            void* stream) {
  return narrow_conv_bwd(g, x, w, dx, dwb, part, batch, h, wd, c, o, runs, stream);
}

}  // extern "C"
