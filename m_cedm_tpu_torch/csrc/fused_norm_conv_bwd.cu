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
// run in parallel and in no order, so the work splits into two kernels:
//
//   dgrad  da = conv3x3^T(g) * silu'(a): a 3x3 conv of the cotangent g with
//          the mirrored taps and the transposed weight, zero outside the
//          image (the cotangent of SAME zero padding), then multiplied by
//          silu'(a) with a = xhat * gamma + beta recomputed from x and the
//          forward's saved statistics. The epilogue also reduces
//          dgamma = sum da * xhat and dbeta = sum da per block and adds them
//          with one fp32 atomic per channel per block. Linear mode: da is the
//          transposed conv itself. K3: the tile runs at high resolution and
//          the epilogue adds the two high-res columns of each low-res pixel,
//          writing a (B, H, W / 2, C) tensor; the row pair and the GroupNorm /
//          SiLU backward at low resolution follow in PyTorch, as they follow
//          in XLA on the TPU (_pallas_up_pair_bwd).
//   wgrad  dW[tap] = sum over pixels of act(x) shifted by the tap, times g:
//          a (9 C x O) product that reduces over all B * H * W pixels
//          (262,144 at the flagship shape). A block owns 16 input channels,
//          64 output channels, all nine taps and a run of 8 x 16 pixel tiles
//          of one image. Per tile it rebuilds act(x) on the halo'd tile
//          from x (K3: from the low-res pixel (Y / 2, X / 2), so the 4x
//          tensor never exists) and stages g; each thread then slides a
//          3 x 3 window of one channel's activation along the tile rows in
//          registers against four of g's channels, 36 multiply-adds per
//          float4 of g read from shared memory. The block adds its partial
//          dW with fp32 atomics, one per weight per block; blocks of the
//          first channel slice also reduce dbias. The order of those atomic
//          adds changes from run to run: dW differs from a sequential sum by
//          rounding only. The 1x1 projection skip's weight gradient is the
//          same kernel with one tap and no activation.
//
// dx then follows from da, gamma, dgamma, dbeta and the statistics in one
// elementwise PyTorch pass (_dx_from_da is XLA on the TPU as well).
//
// Bound: fp32 FMA throughput, like the forward: dgrad and wgrad each do the
// forward conv's 2 * 9 * C * O multiply-adds per pixel (19.3 GFLOP each at the
// flagship shape, 64 -> 64 channels at 16 x 128 x 128). dgrad is the forward's
// implicit GEMM (8 x 16 pixel tile, 64 channels, 8 x 8 accumulator a thread);
// wgrad keeps 9 taps x 4 outputs a thread, so each act(x) or g element that
// a block loads feeds about 100 multiply-adds.
#include <cuda_runtime.h>

namespace {

constexpr int kTH = 8;         // rows of a pixel tile (dgrad and wgrad)
constexpr int kTW = 16;        // columns of a pixel tile
constexpr int kBC = 64;        // dgrad: output (forward input) channels per block
constexpr int kCK = 8;         // dgrad: cotangent channels per shared-memory chunk
constexpr int kThreads = 128;  // dgrad: 16 pixel groups x 8 channel groups
constexpr int kIH = kTH + 2;
constexpr int kIW = kTW + 2;
constexpr int kIWP = 19;       // odd row stride: conflict-free tile reads

constexpr int kWC = 16;        // wgrad: input channels per block
constexpr int kWO = 64;        // wgrad: output channels per block
constexpr int kWThreads = 256; // wgrad: 16 channels x 16 groups of 4 outputs

enum DgradMode { kLinear = 0, kAct = 1, kUpFold = 2 };

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

struct DgradArgs {
  const float* g;      // (B, H, W, O) cotangent of the conv output
  const float* w;      // (3, 3, C, O) forward weight
  const float* x;      // (B, H, W, C) forward input (kAct)
  const float* gamma;  // (B, C) folded scale and shift (kAct)
  const float* beta;
  const float* sums;   // (B, C) the forward's channel sums of x (kAct)
  const float* sumsq;
  float* out;          // da (B, H, W, C); kUpFold: (B, H, W / 2, C)
  float* dgamma;       // (B, C) zeroed (kAct)
  float* dbeta;
  int H, W, C, O, groups;
  float eps;
};

template <int kMode>
__global__ void __launch_bounds__(kThreads) dgrad_kernel(const DgradArgs p) {
  __shared__ float s_in[kCK][kIH][kIWP];
  __shared__ __align__(16) float s_w[kCK][9][kBC];
  __shared__ float s_mean[kBC], s_rstd[kBC], s_g[kBC], s_b[kBC];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int tiles_w = (p.W + kTW - 1) / kTW;
  const int ty0 = (blockIdx.x / tiles_w) * kTH;
  const int tx0 = (blockIdx.x % tiles_w) * kTW;
  const int c0 = blockIdx.z * kBC;
  const int C = p.C, O = p.O;

  if (kMode == kAct && tid < kBC && c0 + tid < C) {
    const int ch = c0 + tid;
    const float cnt = (float)p.H * (float)p.W * (float)(C / p.groups);
    mean_rstd(p.sums, p.sumsq, b, C, ch, p.groups, cnt, p.eps, &s_mean[tid],
              &s_rstd[tid]);
    s_g[tid] = p.gamma[b * C + ch];
    s_b[tid] = p.beta[b * C + ch];
  }

  const int pg = tid & 15, cg = tid >> 4;
  const int r = pg >> 1, cx = (pg & 1) * 8;
  float acc[8][8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i] = 0.f;

  const float* gb = p.g + (size_t)b * p.H * p.W * O;
  for (int o0 = 0; o0 < O; o0 += kCK) {
    __syncthreads();
    for (int idx = tid; idx < kIH * kIW * kCK; idx += kThreads) {
      const int ck = idx % kCK, pos = idx / kCK;
      const int iy = pos / kIW, ix = pos % kIW;
      const int y = ty0 - 1 + iy, x = tx0 - 1 + ix, o = o0 + ck;
      s_in[ck][iy][ix] = (y >= 0 && y < p.H && x >= 0 && x < p.W && o < O)
                             ? gb[((size_t)y * p.W + x) * O + o] : 0.f;
    }
    // transposed conv: tap (dr, dc) uses the forward weight of tap
    // (2 - dr, 2 - dc), i.e. index 8 - tap, with C and O swapped
    for (int idx = tid; idx < kCK * 9 * kBC; idx += kThreads) {
      const int cc = idx % kBC, t = idx / kBC;
      const int tap = t % 9, ck = t / 9, o = o0 + ck, c = c0 + cc;
      s_w[ck][tap][cc] = (o < O && c < C)
                             ? p.w[((size_t)(8 - tap) * C + c) * O + o] : 0.f;
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

  const int y = ty0 + r;
  const int cb = cg * 8;  // this thread's first channel, block-local
  if (kMode == kUpFold) {
    // the two high-res columns of one low-res pixel: j and j + 1 (tx0 + cx
    // is even, and so is W)
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const int x = tx0 + cx + j;
      if (y >= p.H || x >= p.W) continue;
      const size_t pix = ((size_t)b * p.H + y) * (p.W / 2) + x / 2;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = c0 + cb + i;
        if (c < C) p.out[pix * C + c] = acc[j][i] + acc[j + 1][i];
      }
    }
    return;
  }

  float pdg[8], pdb[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) pdg[i] = pdb[i] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int x = tx0 + cx + j;
    if (y >= p.H || x >= p.W) continue;
    const size_t pix = ((size_t)b * p.H + y) * p.W + x;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + cb + i;
      if (c >= C) break;
      float da = acc[j][i];
      if (kMode == kAct) {
        const int lc = cb + i;
        const float xhat = (p.x[pix * C + c] - s_mean[lc]) * s_rstd[lc];
        const float a = xhat * s_g[lc] + s_b[lc];
        const float sig = sigmoid(a);
        da *= sig * (1.f + a * (1.f - sig));
        pdg[i] += da * xhat;
        pdb[i] += da;
      }
      p.out[pix * C + c] = da;
    }
  }

  if (kMode == kAct) {
    __syncthreads();  // all reads of s_w are done: reuse it for the reduction
    float* red_g = &s_w[0][0][0];
    float* red_b = red_g + 16 * kBC;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      red_g[pg * kBC + cb + i] = pdg[i];
      red_b[pg * kBC + cb + i] = pdb[i];
    }
    __syncthreads();
    if (tid < kBC && c0 + tid < C) {
      float sg = 0.f, sb = 0.f;
      for (int q = 0; q < 16; ++q) {
        sg += red_g[q * kBC + tid];
        sb += red_b[q * kBC + tid];
      }
      atomicAdd(&p.dgamma[b * C + c0 + tid], sg);
      atomicAdd(&p.dbeta[b * C + c0 + tid], sb);
    }
  }
}

struct WgradArgs {
  const float* x;      // (B, Hin, Win, C) conv input before the activation
  const float* g;      // (B, H, W, O) cotangent of the conv output
  const float* gamma;  // (B, C) folded scale and shift, unused when act == 0
  const float* beta;
  const float* sums;   // (B, C) the forward's channel sums of x
  const float* sumsq;
  float* dw;           // (taps, C, O) zeroed
  float* dbias;        // (O,) zeroed, or null
  int H, W, C, O, groups;
  float eps;
  int act, taps, splits;  // taps: 9 (3x3) or 1 (1x1); splits: tile runs per image
};

template <bool kUp>
__global__ void __launch_bounds__(kWThreads) wgrad_kernel(const WgradArgs p) {
  __shared__ float s_a[kWC][kTH + 2][kTW + 2];          // act(x), halo'd tile
  __shared__ __align__(16) float s_gt[kTH * kTW][kWO];  // g, one row a pixel
  __shared__ float s_scale[kWC], s_shift[kWC];

  const int tid = threadIdx.x;
  const int otiles = (p.O + kWO - 1) / kWO;
  const int cslices = (p.C + kWC - 1) / kWC;
  int blk = blockIdx.x;
  const int run = blk % p.splits;
  blk /= p.splits;
  const int o0 = (blk % otiles) * kWO;
  blk /= otiles;
  const int c0 = (blk % cslices) * kWC;
  const int b = blk / cslices;
  const int hin = kUp ? p.H / 2 : p.H, win = kUp ? p.W / 2 : p.W;
  const int C = p.C, O = p.O;

  if (p.act && tid < kWC && c0 + tid < C) {
    // fold the statistics into one scale/shift per input channel
    const int ch = c0 + tid;
    const float cnt = (float)hin * (float)win * (float)(C / p.groups);
    float mean, rstd;
    mean_rstd(p.sums, p.sumsq, b, C, ch, p.groups, cnt, p.eps, &mean, &rstd);
    const float a = p.gamma[b * C + ch] * rstd;
    s_scale[tid] = a;
    s_shift[tid] = p.beta[b * C + ch] - a * mean;
  }

  // thread -> one input channel (tc) x 4 output channels (to), all taps
  const int tc = tid >> 4, to = tid & 15;
  const bool bias_thread = p.dbias && c0 == 0 && tc == 0;
  float acc[9][4], gsum[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    gsum[j] = 0.f;
#pragma unroll
    for (int t = 0; t < 9; ++t) acc[t][j] = 0.f;
  }
  const float* xb = p.x + (size_t)b * hin * win * C;
  const float* gb = p.g + (size_t)b * p.H * p.W * O;
  const int tiles_w = (p.W + kTW - 1) / kTW;
  const int tiles = ((p.H + kTH - 1) / kTH) * tiles_w;
  const int per = (tiles + p.splits - 1) / p.splits;

  for (int tile = run * per; tile < min(tiles, (run + 1) * per); ++tile) {
    const int ty0 = (tile / tiles_w) * kTH, tx0 = (tile % tiles_w) * kTW;
    __syncthreads();
    for (int idx = tid; idx < kWC * (kTH + 2) * (kTW + 2); idx += kWThreads) {
      const int cc = idx % kWC, pos = idx / kWC;
      const int iy = pos / (kTW + 2), ix = pos % (kTW + 2);
      const int y = ty0 - 1 + iy, x = tx0 - 1 + ix, c = c0 + cc;
      float v = 0.f;  // act(x) is zero outside the image (SAME padding)
      if (y >= 0 && y < p.H && x >= 0 && x < p.W && c < C) {
        const int yl = kUp ? y >> 1 : y, xl = kUp ? x >> 1 : x;
        v = xb[((size_t)yl * win + xl) * C + c];
        if (p.act) {
          const float t = v * s_scale[cc] + s_shift[cc];
          v = t * sigmoid(t);
        }
      }
      s_a[cc][iy][ix] = v;
    }
    for (int idx = tid; idx < kTH * kTW * kWO; idx += kWThreads) {
      const int oo = idx % kWO, px = idx / kWO;
      const int y = ty0 + px / kTW, x = tx0 + px % kTW, o = o0 + oo;
      s_gt[px][oo] = (y < p.H && x < p.W && o < O)
                         ? gb[((size_t)y * p.W + x) * O + o] : 0.f;
    }
    __syncthreads();
    if (p.taps == 9) {
#pragma unroll 1
      for (int r = 0; r < kTH; ++r) {
        // a 3x3 window of act(x) slides along the row in registers
        float a[3][3];
#pragma unroll
        for (int dr = 0; dr < 3; ++dr) {
          a[dr][1] = s_a[tc][r + dr][0];
          a[dr][2] = s_a[tc][r + dr][1];
        }
#pragma unroll
        for (int q = 0; q < kTW; ++q) {
#pragma unroll
          for (int dr = 0; dr < 3; ++dr) {
            a[dr][0] = a[dr][1];
            a[dr][1] = a[dr][2];
            a[dr][2] = s_a[tc][r + dr][q + 2];
          }
          const float4 g4 = *reinterpret_cast<const float4*>(&s_gt[r * kTW + q][to * 4]);
          const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
          for (int t = 0; t < 9; ++t)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[t][j] = fmaf(a[t / 3][t % 3], gv[j], acc[t][j]);
          if (bias_thread) {
#pragma unroll
            for (int j = 0; j < 4; ++j) gsum[j] += gv[j];
          }
        }
      }
    } else {
#pragma unroll 4
      for (int px = 0; px < kTH * kTW; ++px) {
        const float av = s_a[tc][px / kTW + 1][px % kTW + 1];
        const float4 g4 = *reinterpret_cast<const float4*>(&s_gt[px][to * 4]);
        acc[0][0] = fmaf(av, g4.x, acc[0][0]);
        acc[0][1] = fmaf(av, g4.y, acc[0][1]);
        acc[0][2] = fmaf(av, g4.z, acc[0][2]);
        acc[0][3] = fmaf(av, g4.w, acc[0][3]);
        if (bias_thread) {
          gsum[0] += g4.x; gsum[1] += g4.y; gsum[2] += g4.z; gsum[3] += g4.w;
        }
      }
    }
  }

  const int c = c0 + tc;
  if (c < C) {
    // constant indices into acc keep it in registers (a loop bound of
    // p.taps would move the whole array to local memory)
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      if (t >= p.taps) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = o0 + to * 4 + j;
        if (o < O) atomicAdd(&p.dw[((size_t)t * C + c) * O + o], acc[t][j]);
      }
    }
  }
  if (bias_thread) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int o = o0 + to * 4 + j;
      if (o < O) atomicAdd(&p.dbias[o], gsum[j]);
    }
  }
}

}  // namespace

extern "C" {

// h, w: the cotangent's height and width (K3: the high resolution).
// mode 0: da = conv3x3^T(g) (linear); 1: da = conv3x3^T(g) * silu'(a) with
// dgamma/dbeta (zeroed (B, C) buffers) reduced; 2: conv3x3^T(g) with column
// pairs added, out (B, h, w / 2, c).
int mc_conv_dgrad(const float* g, const float* w, const float* x,
                  const float* gamma, const float* beta, const float* sums,
                  const float* sumsq, float* out, float* dgamma, float* dbeta,
                  int batch, int h, int wd, int c, int o, int groups, float eps,
                  int mode, void* stream) {
  if (mode == kUpFold && (wd % 2)) return (int)cudaErrorInvalidValue;
  DgradArgs p{g, w, x, gamma, beta, sums, sumsq, out, dgamma, dbeta,
              h, wd, c, o, groups, eps};
  dim3 grid(((h + kTH - 1) / kTH) * ((wd + kTW - 1) / kTW), batch,
            (c + kBC - 1) / kBC);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kLinear) dgrad_kernel<kLinear><<<grid, kThreads, 0, s>>>(p);
  else if (mode == kAct) dgrad_kernel<kAct><<<grid, kThreads, 0, s>>>(p);
  else if (mode == kUpFold) dgrad_kernel<kUpFold><<<grid, kThreads, 0, s>>>(p);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// h, w: the cotangent's (output's) height and width; x is (B, h, w, c), or
// (B, h / 2, w / 2, c) with up = 1. dw (taps, c, o) and dbias (o) zeroed.
int mc_conv_wgrad(const float* x, const float* g, const float* gamma,
                  const float* beta, const float* sums, const float* sumsq,
                  float* dw, float* dbias, int batch, int h, int wd, int c,
                  int o, int groups, float eps, int act, int taps, int up,
                  int splits, void* stream) {
  if ((taps != 9 && taps != 1) || splits < 1 || (up && (h % 2 || wd % 2)))
    return (int)cudaErrorInvalidValue;
  WgradArgs p{x, g, gamma, beta, sums, sumsq, dw, dbias, h, wd, c, o, groups,
              eps, act, taps, splits};
  dim3 grid(batch * ((c + kWC - 1) / kWC) * ((o + kWO - 1) / kWO) * splits);
  cudaStream_t s = (cudaStream_t)stream;
  if (up) wgrad_kernel<true><<<grid, kWThreads, 0, s>>>(p);
  else wgrad_kernel<false><<<grid, kWThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
