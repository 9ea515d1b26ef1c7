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
// linear mode act=0 (a plain conv3x3, used for conv_in, the down-block conv
// and the 2-channel out conv).
//
// Bound: fp32 FMA throughput. At the flagship shape (16 x 128 x 128, 64 -> 64
// channels) one call is 19.3 GFLOP against 128 MiB of activations moved, about
// 150 FLOP per byte, far above the H100's fp32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP per byte), so the multiply-adds set the time.
//
// Design: an implicit GEMM on CUDA cores in full fp32 (no TF32, which would
// keep only about three decimal digits). One block of 128 threads owns an
// 8 x 16 pixel tile of one image and 64 output channels; each thread holds an
// 8 pixel x 8 channel accumulator in registers. The input channels stream
// through shared memory 8 at a time as a halo'd 10 x 18 tile. The GroupNorm
// affine and the SiLU are applied while the tile is loaded, and positions
// outside the image are written as zeros AFTER the activation: SAME padding
// pads the activated tensor, not x. For K3 the tile is addressed at high
// resolution and each position reads low-res pixel (Y/2, X/2), so the 4x
// upsampled activation never reaches device memory; its group statistics are
// those of the low-res x, which nearest upsampling preserves. The GroupNorm
// statistics come in as per-(B, C) sums: chained from the producer's
// emit_stats, or from K1's pass 1. Emitted statistics are reduced per block
// in shared memory and added with fp32 atomicAdd, one per channel per block,
// so their summation order changes from run to run. Making this fast (TF32
// split products on wgmma, TMA-fed pipelines) is left to a later change.
#include <cuda_runtime.h>

namespace {

constexpr int kTH = 8;         // output rows per block
constexpr int kTW = 16;        // output columns per block
constexpr int kBO = 64;        // output channels per block
constexpr int kCK = 8;         // input channels per shared-memory chunk
constexpr int kThreads = 128;  // 16 pixel groups x 8 channel groups
constexpr int kIH = kTH + 2;   // halo'd tile rows
constexpr int kIW = kTW + 2;   // halo'd tile columns
constexpr int kIWP = 19;       // odd row stride: conflict-free tile reads
constexpr int kMaxC = 512;

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
};

__device__ __forceinline__ float silu(float y) { return y / (1.f + expf(-y)); }

template <bool kUp>
__global__ void __launch_bounds__(kThreads) gnsc_kernel(const Args p) {
  __shared__ float s_in[kCK][kIH][kIWP];
  __shared__ __align__(16) float s_w[kCK][9][kBO];
  __shared__ float s_a[kMaxC];
  __shared__ float s_b[kMaxC];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int tiles_w = (p.W + kTW - 1) / kTW;
  const int ty0 = (blockIdx.x / tiles_w) * kTH;
  const int tx0 = (blockIdx.x % tiles_w) * kTW;
  const int o0 = blockIdx.z * kBO;
  const int hin = kUp ? p.H / 2 : p.H;
  const int win = kUp ? p.W / 2 : p.W;
  const int C = p.C, O = p.O;

  if (p.act) {
    // fold the group statistics into one scale/shift per input channel
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

  // thread -> 8 consecutive pixels of one tile row x 8 consecutive channels
  const int pg = tid & 15, cg = tid >> 4;
  const int r = pg >> 1, cx = (pg & 1) * 8;
  float acc[8][8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i] = 0.f;

  const float* xb = p.x + (size_t)b * hin * win * C;
  for (int c0 = 0; c0 < C; c0 += kCK) {
    __syncthreads();
    for (int idx = tid; idx < kIH * kIW * kCK; idx += kThreads) {
      const int ck = idx % kCK, pos = idx / kCK;
      const int iy = pos / kIW, ix = pos % kIW;
      const int y = ty0 - 1 + iy, x = tx0 - 1 + ix, c = c0 + ck;
      float v = 0.f;  // SAME zero padding of the ACTIVATED tensor
      if (y >= 0 && y < p.H && x >= 0 && x < p.W && c < C) {
        const int ys = kUp ? (y >> 1) : y, xs = kUp ? (x >> 1) : x;
        v = xb[((size_t)ys * win + xs) * C + c];
        if (p.act) v = silu(v * s_a[c] + s_b[c]);
      }
      s_in[ck][iy][ix] = v;
    }
    for (int idx = tid; idx < kCK * 9 * kBO; idx += kThreads) {
      const int o = idx % kBO, t = idx / kBO;
      const int tap = t % 9, ck = t / 9, c = c0 + ck;
      s_w[ck][tap][o] = (c < C && o0 + o < O)
                            ? p.w[((size_t)tap * C + c) * O + o0 + o] : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int ck = 0; ck < kCK; ++ck) {
#pragma unroll
      for (int dr = 0; dr < 3; ++dr) {
        float a[10];
#pragma unroll
        for (int q = 0; q < 10; ++q) a[q] = s_in[ck][r + dr][cx + q];
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) {
          const float4 w0 = *reinterpret_cast<const float4*>(&s_w[ck][dr * 3 + dc][cg * 8]);
          const float4 w1 = *reinterpret_cast<const float4*>(&s_w[ck][dr * 3 + dc][cg * 8 + 4]);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(a[j + dc], wv[i], acc[j][i]);
        }
      }
    }
  }

  if (p.res_mode == kResProj) {
    // 1x1 skip projection of the residual: one more GEMM over Cr channels
    const float* rb = p.res + (size_t)b * p.H * p.W * p.Cr;
    for (int c0 = 0; c0 < p.Cr; c0 += kCK) {
      __syncthreads();
      for (int idx = tid; idx < kTH * kTW * kCK; idx += kThreads) {
        const int ck = idx % kCK, pos = idx / kCK;
        const int iy = pos / kTW, ix = pos % kTW;
        const int y = ty0 + iy, x = tx0 + ix, c = c0 + ck;
        s_in[ck][iy][ix] = (y < p.H && x < p.W && c < p.Cr)
                               ? rb[((size_t)y * p.W + x) * p.Cr + c] : 0.f;
      }
      for (int idx = tid; idx < kCK * kBO; idx += kThreads) {
        const int o = idx % kBO, ck = idx / kBO, c = c0 + ck;
        s_w[ck][0][o] = (c < p.Cr && o0 + o < O) ? p.skip_w[(size_t)c * O + o0 + o] : 0.f;
      }
      __syncthreads();
#pragma unroll 1
      for (int ck = 0; ck < kCK; ++ck) {
        const float4 w0 = *reinterpret_cast<const float4*>(&s_w[ck][0][cg * 8]);
        const float4 w1 = *reinterpret_cast<const float4*>(&s_w[ck][0][cg * 8 + 4]);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float a = s_in[ck][r][cx + j];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(a, wv[i], acc[j][i]);
        }
      }
    }
  }

  // epilogue: bias, residual, store, and this thread's share of the stats
  float ps[8], pss[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) ps[i] = pss[i] = 0.f;
  const int y = ty0 + r;
  const int ob = o0 + cg * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int x = tx0 + cx + j;
    if (y >= p.H || x >= p.W) continue;
    const size_t pix = ((size_t)b * p.H + y) * p.W + x;
    const float* rrow = nullptr;
    if (p.res_mode == kResIdentity) rrow = p.res + pix * O;
    if (p.res_mode == kResIdentityUp)
      rrow = p.res + (((size_t)b * (p.H / 2) + y / 2) * (p.W / 2) + x / 2) * O;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int o = ob + i;
      if (o >= O) break;
      float v = acc[j][i];
      if (p.bias) v += p.bias[o];
      if (rrow) v += rrow[o];
      if (p.res_mode == kResProj && p.skip_b) v += p.skip_b[o];
      p.out[pix * O + o] = v;
      ps[i] += v;
      pss[i] += v * v;
    }
  }

  if (p.osums) {
    __syncthreads();  // all reads of s_w are done: reuse it for the reduction
    float* red_s = &s_w[0][0][0];
    float* red_ss = red_s + 16 * kBO;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      red_s[pg * kBO + cg * 8 + i] = ps[i];
      red_ss[pg * kBO + cg * 8 + i] = pss[i];
    }
    __syncthreads();
    if (tid < kBO && o0 + tid < O) {
      float s = 0.f, ss = 0.f;
      for (int q = 0; q < 16; ++q) {
        s += red_s[q * kBO + tid];
        ss += red_ss[q * kBO + tid];
      }
      atomicAdd(&p.osums[b * O + o0 + tid], s);
      atomicAdd(&p.osumsq[b * O + o0 + tid], ss);
    }
  }
}

template <bool kUp>
int launch(const float* x, const float* w, const float* bias, const float* gamma,
           const float* beta, const float* sums, const float* sumsq,
           const float* res, const float* skip_w, const float* skip_b, float* out,
           float* osums, float* osumsq, int batch, int h, int wd, int c, int o,
           int cr, int groups, float eps, int act, int res_mode, void* stream) {
  Args p{x, w, bias, gamma, beta, sums, sumsq, res, skip_w, skip_b, out,
         osums, osumsq, h, wd, c, o, cr, groups, eps, act, res_mode};
  dim3 grid(((h + kTH - 1) / kTH) * ((wd + kTW - 1) / kTW), batch,
            (o + kBO - 1) / kBO);
  gnsc_kernel<kUp><<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
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
