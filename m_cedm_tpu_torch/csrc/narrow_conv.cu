// K2's narrow-channel linear conv: out = conv3x3_same(x) + bias for NHWC fp32
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
// Bound: bytes. At the flagship shapes (16 x 128 x 128) conv_in reads 4 MB
// and writes 67 MB, the out conv reads 67 MB and writes 2 MB: about 0.021 ms
// at 3.35 TB/s each, against 0.009 ms (out conv) and 0.018 ms (conv_in) of
// fp32 multiply-adds at 67 TFLOP/s. So the design moves each byte once,
// coalesced, and keeps the multiply-adds on operands already in registers.
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
// bf16: both forward kernels are templated on the element type of x, w and
// out. The bf16 instances read bf16 x and w, widen them to fp32 as they
// stage them in shared memory (plain 8-byte loads, 4 channels at a time,
// where the fp32 instances copy with cp.async), multiply and add in fp32 on
// the CUDA cores (a product of two bf16 values is exact in fp32, so this is
// the Pallas kernel's bf16-product, fp32-accumulate arithmetic), add the fp32
// bias, sum the statistics from the fp32 values, and round once at the
// store. Bound: bytes, half of fp32's (conv_in writes 33.6 MB, the out conv
// reads 33.6 MB at the flagship shape: about 0.010 ms each at 3.35 TB/s).
//
// bf16 backward (the out conv in bf16 training): the same two kernels on
// bf16 g, x and w, the Pallas K2 backward's linear mode on a bf16 network
// (_bwd_phase_a with act = False: bf16 products summed in fp32, the input
// cotangent rounded once to bf16, dW and dbias fp32). dgrad is
// narrow_c_kernel<true, bf16> (widened as it stages, rounded at its store);
// narrow_wgrad_kernel<OP, bf16> widens x and g as it stages them and keeps
// its fp32 partials. Bound: bytes, 33.6 MB of x read, 33.6 MB of dx written
// and 1 MB of g at the flagship shape, 0.020 ms at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

// The bf16 tile: the same layout in fp32, widened as it is staged (plain
// loads; 8 bytes, four channels, a load when vec: C % 4 == 0 and x 8-byte
// aligned).
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

// n consecutive outputs of one pixel (n = 1, 2 or 4; dst aligned to n
// elements when vec), rounded once for bf16
__device__ __forceinline__ void store_out(float* dst, const float* v, int n, bool vec) {
  if (vec && n == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else if (vec && n == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int i = 0; i < n; ++i) dst[i] = v[i];
  }
}

__device__ __forceinline__ void store_out(__nv_bfloat16* dst, const float* v, int n,
                                          bool vec) {
  if (vec && n % 2 == 0) {
    for (int i = 0; i < n; i += 2)
      *reinterpret_cast<__nv_bfloat162*>(dst + i) = __floats2bfloat162_rn(v[i], v[i + 1]);
  } else {
    for (int i = 0; i < n; ++i) dst[i] = __float2bfloat16_rn(v[i]);
  }
}

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

template <typename T>
struct ConvArgsT {
  const T* x;         // (B, H, W, C)
  const T* w;         // (3, 3, C, O); flip: the forward weight (3, 3, O, C)
  const float* bias;  // (O,) or null
  T* out;             // (B, H, W, O)
  float* part;        // (2, B, tiles, O) scratch for the statistics, or null
  int H, W, C, O, vec;
};

// ---------------------------------------------------------------------------
// narrow O: O <= OP <= 8, any C
// ---------------------------------------------------------------------------

template <int OP, typename T>
__global__ void __launch_bounds__(kOThreads) narrow_o_kernel(const ConvArgsT<T> p) {
  extern __shared__ __align__(16) float smem[];
  float* sx = smem;                 // [stage][18][34][12]
  float* sw = smem + 2 * kOStageX;  // [stage][9][kOKC][OP]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.y;
  const int tiles_w = (p.W + kOTW - 1) / kOTW;
  const int ty0 = (blockIdx.x / tiles_w) * kOTH, tx0 = (blockIdx.x % tiles_w) * kOTW;
  const int C = p.C, O = p.O;
  const T* xb = p.x + (size_t)b * p.H * p.W * C;
  const int nchunks = (C + kOKC - 1) / kOKC;

  auto load = [&](int stage, int c0) {
    load_tile<kOIH, kOIW>(sx + stage * kOStageX, xb, ty0, tx0, p.H, p.W, C, c0, kOKC,
                          kOPS, p.vec, tid, kOThreads);
    float* dw = sw + stage * kOStageW;
    for (int idx = tid; idx < 9 * kOKC * OP; idx += kOThreads) {
      const int o = idx % OP, t = idx / OP;
      const int ck = t % kOKC, tap = t / kOKC, c = c0 + ck;
      const bool valid = c < C && o < O;
      if constexpr (std::is_same<T, float>::value)
        cp_async4(dw + idx, valid ? p.w + ((size_t)tap * C + c) * O + o : p.w, valid);
      else
        dw[idx] = valid ? to_f(p.w[((size_t)tap * C + c) * O + o]) : 0.f;
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
    T* dst = p.out + (((size_t)b * p.H + y) * p.W + x) * O;
    if constexpr (std::is_same<T, float>::value) {
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
    } else {
      store_out(dst, v, O < OP ? O : OP, OP == O && OP >= 2);
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
// narrow C: C <= 8, any O; kFlip: the dgrad of a narrow-O conv
// ---------------------------------------------------------------------------

template <bool kFlip, typename T>
__global__ void __launch_bounds__(kCThreads) narrow_c_kernel(const ConvArgsT<T> p) {
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
      v = to_f(kFlip ? p.w[((size_t)(8 - tap) * O + o) * C + c]
                     : p.w[((size_t)tap * C + c) * O + o]);
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
      T* dst = p.out + (((size_t)b * p.H + y) * p.W + x) * O + ob;
      if constexpr (std::is_same<T, float>::value) {
        if (O % 4 == 0) {
          if (ob < O) *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (ob + i < O) dst[i] = v[i];
        }
      } else if (ob < O) {
        store_out(dst, v, O - ob < 4 ? O - ob : 4, O % 4 == 0);
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// above 48 KB of dynamic shared memory a kernel must opt in, once per process
cudaError_t configure() {
  static cudaError_t err = [] {
    cudaError_t e = allow_smem(narrow_o_kernel<1, float>, kOSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_o_kernel<2, float>, kOSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_o_kernel<4, float>, kOSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_o_kernel<8, float>, kOSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_o_kernel<1, __nv_bfloat16>, kOSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_o_kernel<2, __nv_bfloat16>, kOSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_o_kernel<4, __nv_bfloat16>, kOSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_o_kernel<8, __nv_bfloat16>, kOSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_wgrad_kernel<1, float>, kWSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_wgrad_kernel<2, float>, kWSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_wgrad_kernel<4, float>, kWSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_wgrad_kernel<8, float>, kWSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_wgrad_kernel<1, __nv_bfloat16>, kWSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_wgrad_kernel<2, __nv_bfloat16>, kWSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_wgrad_kernel<4, __nv_bfloat16>, kWSmem);
    if (e == cudaSuccess) e = allow_smem(narrow_wgrad_kernel<8, __nv_bfloat16>, kWSmem);
    return e;
  }();
  return err;
}

int tiles_of(int h, int wd, int th, int tw) { return ((h + th - 1) / th) * ((wd + tw - 1) / tw); }

bool vec_ok(const float* x, int c) { return c % 4 == 0 && (uintptr_t)x % 16 == 0; }
bool vec_ok(const __nv_bfloat16* x, int c) { return c % 4 == 0 && (uintptr_t)x % 8 == 0; }

// the forward for either element type; ostats and part as mc_narrow_conv's
template <typename T>
int narrow_conv(const T* x, const T* w, const float* bias, T* out, float* ostats,
                float* part, int batch, int h, int wd, int c, int o, void* stream) {
  if (batch < 1 || h < 1 || wd < 1 || c < 1 || o < 1 || (c > kKC && o > 8) ||
      (!ostats) != (!part))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  ConvArgsT<T> p{x, w, bias, out, part, h, wd, c, o, (int)vec_ok(x, c)};
  const int which = o <= 8 ? 0 : 1;
  const int tiles = which ? tiles_of(h, wd, kCTH, kCTW) : tiles_of(h, wd, kOTH, kOTW);
  if (which == 0) {
    dim3 grid(tiles, batch);
    if (o <= 1) narrow_o_kernel<1, T><<<grid, kOThreads, kOSmem, st>>>(p);
    else if (o <= 2) narrow_o_kernel<2, T><<<grid, kOThreads, kOSmem, st>>>(p);
    else if (o <= 4) narrow_o_kernel<4, T><<<grid, kOThreads, kOSmem, st>>>(p);
    else narrow_o_kernel<8, T><<<grid, kOThreads, kOSmem, st>>>(p);
  } else {
    dim3 grid(tiles, batch, (o + kCO - 1) / kCO);
    narrow_c_kernel<false, T><<<grid, kCThreads, 0, st>>>(p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || !ostats) return (int)err;
  colsum_kernel<<<dim3((o + 31) / 32, 2 * batch), 32 * kSumGroups, 0, st>>>(part, ostats,
                                                                          tiles, o);
  return (int)cudaGetLastError();
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
    // dgrad: the narrow-C kernel on g (o channels in, c out), weights mirrored
    ConvArgsT<T> p{g, w, nullptr, dx, nullptr, h, wd, o, c, (int)vec_ok(g, o)};
    dim3 grid(tiles_of(h, wd, kCTH, kCTW), batch, (c + kCO - 1) / kCO);
    narrow_c_kernel<true, T><<<grid, kCThreads, 0, st>>>(p);
    err = cudaGetLastError();
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

// Pixel tiles per image of the forward (which = 0: narrow O, used when o <= 8;
// 1: narrow C) and of the wgrad kernel (2). The statistics scratch of the
// forward is (2, batch, tiles, o) floats.
int mc_narrow_conv_tiles(int h, int wd, int which) {
  if (which == 0) return tiles_of(h, wd, kOTH, kOTW);
  if (which == 1) return tiles_of(h, wd, kCTH, kCTW);
  return tiles_of(h, wd, kWTH, kWTW);
}

// out = conv3x3_same(x) + bias for c <= 8 or o <= 8 (o <= 8 takes the
// narrow-O kernel). ostats: null, or (2, batch, o), the output's channel
// sums and sums of squares, with part the (2, batch, tiles, o) scratch.
int mc_narrow_conv(const float* x, const float* w, const float* bias, float* out,
                   float* ostats, float* part, int batch, int h, int wd, int c, int o,
                   void* stream) {
  return narrow_conv(x, w, bias, out, ostats, part, batch, h, wd, c, o, stream);
}

// The bf16 instance: x, w and out bf16; bias, ostats and part fp32.
int mc_narrow_conv_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* bias,
                        __nv_bfloat16* out, float* ostats, float* part, int batch, int h,
                        int wd, int c, int o, void* stream) {
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
int mc_narrow_conv_bwd_bf16(const __nv_bfloat16* g, const __nv_bfloat16* x,
                            const __nv_bfloat16* w, __nv_bfloat16* dx, float* dwb, float* part,
                            int batch, int h, int wd, int c, int o, int runs, void* stream) {
  return narrow_conv_bwd(g, x, w, dx, dwb, part, batch, h, wd, c, o, runs, stream);
}

}  // extern "C"
