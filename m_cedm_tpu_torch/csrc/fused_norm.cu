// K1: GroupNorm (+ per-sample FiLM) + SiLU on a (B, N, C) fp32 activation.
//
// Replaces m_cedm_tpu/pallas/fused_norm.py::_stats_kernel (pass 1) and
// ::_apply_kernel (pass 2); the paired-lane twins _stats4_kernel and
// _apply4_kernel in fused_norm_conv.py compute the same math on the TPU's
// (W/2, 2C) layout and map here too.
//
// Bound: device-memory bandwidth. Pass 1 reads x once; pass 2 reads x and
// writes y once (the flagship shape is 16 x 16384 x 64 fp32 = 64 MiB). The
// FLOP count is a few per element.
//
// Design: the TPU carried per-(B, C) sums across a sequential grid. Blocks on
// Hopper run in parallel and in no order, so pass 1 reduces a strip of rows
// inside each block (per-thread partials, then shared memory) and adds the
// block's partials into zeroed (B, C) buffers with fp32 atomicAdd: one atomic
// per channel per block. The order of those adds changes from run to run, so
// the sums differ from a sequential sum by rounding only. Pass 2 folds the
// group statistics into one per-channel scale/shift per block (shared memory)
// and then streams x with coalesced loads: consecutive threads touch
// consecutive channels of one row.
//
// Backward: replaces fused_norm.py::_grad_stats_kernel and ::_grad_apply_kernel
// (paired twins _grad_stats4_kernel and _grad_apply4_kernel). With xhat the
// normalized x, y = xhat * gamma + beta and dy = g * silu'(y):
//   grad-stats  dgamma = sum_n dy * xhat, dbeta = sum_n dy   per (B, C)
//   grad-apply  dx = rstd * (dy * gamma - m1 - xhat * m2), where m1 and m2 are
//               the group means of dy * gamma and dy * gamma * xhat.
// The TPU also accumulates s1 = sum dy * gamma and s2 = sum dy * gamma * xhat;
// gamma is constant over n, so s1 = gamma * dbeta and s2 = gamma * dgamma
// and the grad-apply pass forms m1 and m2 from dgamma and dbeta. Both passes
// read x and g once (the apply pass writes dx) and recompute xhat and y from
// the forward's saved statistics: bound by device memory, like the forward.
// The sums cross blocks as in pass 1: per-block partials, one atomic per
// channel per block.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStatsRows = 256;   // rows of x reduced by one pass-1 block
constexpr int kApplyRows = 64;    // rows of x normalized by one pass-2 block

__global__ void __launch_bounds__(kThreads)
channel_stats_kernel(const float* __restrict__ x, float* __restrict__ sums,
                     float* __restrict__ sumsq, int n, int c) {
  __shared__ float red_s[kThreads];
  __shared__ float red_ss[kThreads];
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kStatsRows;
  const int row_end = min(row0 + kStatsRows, n);
  // `lanes` threads cover consecutive channels of one row; `rsteps` such
  // groups take every rsteps-th row. Wider rows go in chunks of kThreads.
  const int lanes = min(c, kThreads);
  const int rsteps = kThreads / lanes;
  const int lane = threadIdx.x % lanes, slot = threadIdx.x / lanes;
  const float* xb = x + (size_t)b * n * c;
  for (int c0 = 0; c0 < c; c0 += lanes) {
    const int ch = c0 + lane;
    float s = 0.f, ss = 0.f;
    if (slot < rsteps && ch < c) {
      for (int r = row0 + slot; r < row_end; r += rsteps) {
        const float v = xb[(size_t)r * c + ch];
        s += v;
        ss += v * v;
      }
    }
    red_s[threadIdx.x] = s;
    red_ss[threadIdx.x] = ss;
    __syncthreads();
    if (threadIdx.x < lanes && ch < c) {
      for (int k = 1; k < rsteps; ++k) {
        s += red_s[threadIdx.x + k * lanes];
        ss += red_ss[threadIdx.x + k * lanes];
      }
      atomicAdd(&sums[b * c + ch], s);
      atomicAdd(&sumsq[b * c + ch], ss);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
gn_silu_apply_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const float* __restrict__ sums,
                     const float* __restrict__ sumsq, float* __restrict__ out,
                     int n, int c, int groups, float eps) {
  extern __shared__ float sm[];
  float* sa = sm;      // per-channel scale gamma * rstd
  float* sb = sm + c;  // per-channel shift beta - gamma * rstd * mean
  const int b = blockIdx.y;
  const int per = c / groups;
  const float cnt = (float)n * (float)per;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const int g0 = (ch / per) * per;
    float s = 0.f, ss = 0.f;
    for (int k = 0; k < per; ++k) {
      s += sums[b * c + g0 + k];
      ss += sumsq[b * c + g0 + k];
    }
    const float mean = s / cnt;
    const float var = fmaxf(ss / cnt - mean * mean, 0.f);
    const float a = gamma[b * c + ch] * rsqrtf(var + eps);
    sa[ch] = a;
    sb[ch] = beta[b * c + ch] - a * mean;
  }
  __syncthreads();
  const int row0 = blockIdx.x * kApplyRows;
  const size_t base = ((size_t)b * n + row0) * c;
  const int count = min(kApplyRows, n - row0) * c;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int ch = i % c;
    const float y = x[base + i] * sa[ch] + sb[ch];
    out[base + i] = y / (1.f + expf(-y));
  }
}

// per-channel mean, rstd, gamma, beta of sample b into shared memory
__device__ __forceinline__ void channel_norm(const float* sums, const float* sumsq,
                                             const float* gamma, const float* beta,
                                             int b, int n, int c, int groups,
                                             float eps, float* s_mean, float* s_rstd,
                                             float* s_g, float* s_b) {
  const int per = c / groups;
  const float cnt = (float)n * (float)per;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const int g0 = (ch / per) * per;
    float s = 0.f, ss = 0.f;
    for (int k = 0; k < per; ++k) {
      s += sums[b * c + g0 + k];
      ss += sumsq[b * c + g0 + k];
    }
    const float mean = s / cnt;
    s_mean[ch] = mean;
    s_rstd[ch] = rsqrtf(fmaxf(ss / cnt - mean * mean, 0.f) + eps);
    s_g[ch] = gamma[b * c + ch];
    s_b[ch] = beta[b * c + ch];
  }
}

// dy = g * silu'(y) for y = xhat * gamma + beta
__device__ __forceinline__ float silu_grad(float gv, float y) {
  const float sig = 1.f / (1.f + expf(-y));
  return gv * sig * (1.f + y * (1.f - sig));
}

__global__ void __launch_bounds__(kThreads)
gn_silu_grad_stats_kernel(const float* __restrict__ x, const float* __restrict__ g,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta,
                          const float* __restrict__ sums,
                          const float* __restrict__ sumsq,
                          float* __restrict__ dgamma, float* __restrict__ dbeta,
                          int n, int c, int groups, float eps) {
  extern __shared__ float sm[];
  float *s_mean = sm, *s_rstd = sm + c, *s_g = sm + 2 * c, *s_b = sm + 3 * c;
  float *red_g = sm + 4 * c, *red_b = red_g + kThreads;
  const int b = blockIdx.y;
  channel_norm(sums, sumsq, gamma, beta, b, n, c, groups, eps, s_mean, s_rstd,
               s_g, s_b);
  __syncthreads();
  const int row0 = blockIdx.x * kStatsRows;
  const int row_end = min(row0 + kStatsRows, n);
  const int lanes = min(c, kThreads);
  const int rsteps = kThreads / lanes;
  const int lane = threadIdx.x % lanes, slot = threadIdx.x / lanes;
  const size_t off = (size_t)b * n * c;
  for (int c0 = 0; c0 < c; c0 += lanes) {
    const int ch = c0 + lane;
    float sg = 0.f, sb = 0.f;
    if (slot < rsteps && ch < c) {
      const float mean = s_mean[ch], rstd = s_rstd[ch], ga = s_g[ch], be = s_b[ch];
      for (int r = row0 + slot; r < row_end; r += rsteps) {
        const size_t i = off + (size_t)r * c + ch;
        const float xhat = (x[i] - mean) * rstd;
        const float dy = silu_grad(g[i], xhat * ga + be);
        sg += dy * xhat;
        sb += dy;
      }
    }
    red_g[threadIdx.x] = sg;
    red_b[threadIdx.x] = sb;
    __syncthreads();
    if (threadIdx.x < lanes && ch < c) {
      for (int k = 1; k < rsteps; ++k) {
        sg += red_g[threadIdx.x + k * lanes];
        sb += red_b[threadIdx.x + k * lanes];
      }
      atomicAdd(&dgamma[b * c + ch], sg);
      atomicAdd(&dbeta[b * c + ch], sb);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
gn_silu_grad_apply_kernel(const float* __restrict__ x, const float* __restrict__ g,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta,
                          const float* __restrict__ sums,
                          const float* __restrict__ sumsq,
                          const float* __restrict__ dgamma,
                          const float* __restrict__ dbeta, float* __restrict__ dx,
                          int n, int c, int groups, float eps) {
  extern __shared__ float sm[];
  float *s_mean = sm, *s_rstd = sm + c, *s_g = sm + 2 * c, *s_b = sm + 3 * c;
  float *s_m1 = sm + 4 * c, *s_m2 = sm + 5 * c;
  const int b = blockIdx.y;
  channel_norm(sums, sumsq, gamma, beta, b, n, c, groups, eps, s_mean, s_rstd,
               s_g, s_b);
  const int per = c / groups;
  const float cnt = (float)n * (float)per;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const int g0 = (ch / per) * per;
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < per; ++k) {
      const float ga = gamma[b * c + g0 + k];
      s1 += ga * dbeta[b * c + g0 + k];
      s2 += ga * dgamma[b * c + g0 + k];
    }
    s_m1[ch] = s1 / cnt;
    s_m2[ch] = s2 / cnt;
  }
  __syncthreads();
  const int row0 = blockIdx.x * kApplyRows;
  const size_t base = ((size_t)b * n + row0) * c;
  const int count = min(kApplyRows, n - row0) * c;
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const int ch = i % c;
    const float rstd = s_rstd[ch], ga = s_g[ch];
    const float xhat = (x[base + i] - s_mean[ch]) * rstd;
    const float dy = silu_grad(g[base + i], xhat * ga + s_b[ch]);
    dx[base + i] = rstd * (dy * ga - s_m1[ch] - xhat * s_m2[ch]);
  }
}

}  // namespace

extern "C" {

// sums/sumsq must be zeroed (B, C) buffers; the kernel adds into them.
int mc_channel_stats(const float* x, float* sums, float* sumsq, int b, int n,
                     int c, void* stream) {
  dim3 grid((n + kStatsRows - 1) / kStatsRows, b);
  channel_stats_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, sums, sumsq, n, c);
  return (int)cudaGetLastError();
}

int mc_gn_silu(const float* x, const float* gamma, const float* beta,
               const float* sums, const float* sumsq, float* out, int b, int n,
               int c, int groups, float eps, void* stream) {
  dim3 grid((n + kApplyRows - 1) / kApplyRows, b);
  gn_silu_apply_kernel<<<grid, kThreads, 2 * c * sizeof(float),
                         (cudaStream_t)stream>>>(x, gamma, beta, sums, sumsq,
                                                 out, n, c, groups, eps);
  return (int)cudaGetLastError();
}

// dgamma/dbeta must be zeroed (B, C) buffers; sums/sumsq are the statistics
// the forward used
int mc_gn_silu_bwd(const float* x, const float* g, const float* gamma,
                   const float* beta, const float* sums, const float* sumsq,
                   float* dgamma, float* dbeta, float* dx, int b, int n, int c,
                   int groups, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid_s((n + kStatsRows - 1) / kStatsRows, b);
  gn_silu_grad_stats_kernel<<<grid_s, kThreads,
                              (4 * c + 2 * kThreads) * sizeof(float), s>>>(
      x, g, gamma, beta, sums, sumsq, dgamma, dbeta, n, c, groups, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_a((n + kApplyRows - 1) / kApplyRows, b);
  gn_silu_grad_apply_kernel<<<grid_a, kThreads, 6 * c * sizeof(float), s>>>(
      x, g, gamma, beta, sums, sumsq, dgamma, dbeta, dx, n, c, groups, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
