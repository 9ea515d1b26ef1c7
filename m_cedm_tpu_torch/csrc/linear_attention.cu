// K5 kv_dots and K6 apply_dots: the two products of the OFormer's Galerkin
// linear attention, out = q (k^T v) / n, on (BH, N, D) operands, fp32, with
// any N and any D, E up to 128.
//
//   K5 kv_dots    (BH, N, D) x (BH, N, E) -> (BH, D, E) = sum_n k_n^T v_n
//                 replaces m_cedm_tpu/pallas/linear_attention.py::_kv_kernel
//   K6 apply_dots (BH, N, D) x (BH, D, E) -> (BH, N, E) = q @ dots
//                 replaces m_cedm_tpu/pallas/linear_attention.py::_apply_kernel
//
// The backward of each is made of the two (kernels/linear_attention.py), so
// an OFormer train step runs no other attention kernel.
//
// Bound: at the OFormer's shapes (N = 16,384, D = E = 128, BH = 16 or 64) each
// call does 2 N D E = 537 MFLOP per head-batch on 16 MB of operands, about 32
// FLOP per byte, above the H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20):
// fp32 multiply-adds on the CUDA cores set the time.
//
// Design. Both kernels are a register-blocked product on CUDA cores: 256
// threads as a 16 x 16 grid, each thread owning a tile of the output whose
// columns are the two float4 groups 4t.. and 64 + 4t.., so that a warp's
// shared-memory reads are broadcasts or contiguous 256-byte runs. Operands
// are staged in shared memory zero-padded to 128 columns, so ragged N, D and
// E need no branch in the inner loop.
//
// K5: the TPU kernel runs N as a sequential grid axis that accumulates into
// one resident (D, E) block. Hopper's blocks run in no order, and there are
// only BH = 16 output tiles of 128 x 128 at the encoder's shape against 132
// SMs, so N is split across `splits` blocks per head-batch: each stages 32
// rows of k and v at a time and accumulates its own 8 x 8 register tile of
// the full (D, E) output; the partial tiles go to a (BH, splits, D, E)
// workspace and a second kernel sums them in a fixed order. No atomics, so
// the result does not change from run to run.
//
// K6: one block per (head-batch, 64-row tile of q). The whole (D, E) factor,
// 64 KB in fp32, and the q tile sit in 96 KB of dynamic shared memory (over
// the 48 KB default, so the launch opts in); each thread owns a 4 x 8 tile of
// the output.
#include <cuda_runtime.h>

namespace {

constexpr int kW = 128;        // widest D and E; shared rows are this wide
constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kChunk = 32;     // k, v rows per shared-memory stage (K5)
constexpr int kRowsQ = 64;     // q rows per block (K6)
constexpr size_t kApplySmem = (size_t)(kW * kW + kRowsQ * kW) * sizeof(float);

// column (or row) i of the thread's eight: 4t..4t+3, then 64+4t..64+4t+3
__device__ __forceinline__ int frag(int t, int i) {
  return i < 4 ? 4 * t + i : 64 + 4 * t + (i - 4);
}

__device__ __forceinline__ void load8(const float* row, int t, float* r) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * t);
  const float4 b = *reinterpret_cast<const float4*>(row + 64 + 4 * t);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

// eight values of row `dst` from the thread's columns, written inside [0, E)
__device__ __forceinline__ void store8(float* dst, int t, const float* r, int E) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = h * 64 + 4 * t;
    if (E % 4 == 0) {
      if (c < E)
        *reinterpret_cast<float4*>(dst + c) =
            make_float4(r[4 * h], r[4 * h + 1], r[4 * h + 2], r[4 * h + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c + j < E) dst[c + j] = r[4 * h + j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
kv_dots_partial_kernel(const float* __restrict__ k, const float* __restrict__ v,
                       float* __restrict__ part, int N, int D, int E,
                       int rows_per_split) {
  __shared__ __align__(16) float sk[kChunk][kW];
  __shared__ __align__(16) float sv[kChunk][kW];
  const int bh = blockIdx.y, s = blockIdx.x;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* kb = k + (size_t)bh * N * D;
  const float* vb = v + (size_t)bh * N * E;
  const int n0 = s * rows_per_split, n1 = min(N, n0 + rows_per_split);
  // loader: thread -> one column, every second row of the stage
  const int col = threadIdx.x % kW, row0 = threadIdx.x / kW;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int c0 = n0; c0 < n1; c0 += kChunk) {
    __syncthreads();
    for (int r = row0; r < kChunk; r += kThreads / kW) {
      const int n = c0 + r;
      sk[r][col] = (n < n1 && col < D) ? kb[(size_t)n * D + col] : 0.f;
      sv[r][col] = (n < n1 && col < E) ? vb[(size_t)n * E + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kChunk; ++r) {
      float a[8], b[8];
      load8(sk[r], ty, a);
      load8(sv[r], tx, b);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  float* out = part + ((size_t)bh * gridDim.x + s) * D * E;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = frag(ty, i);
    if (d < D) store8(out + (size_t)d * E, tx, acc[i], E);
  }
}

// out[bh] = sum over s of part[bh, s], in the order s = 0, 1, ...
__global__ void kv_dots_reduce_kernel(const float* __restrict__ part,
                                      float* __restrict__ out, int splits, int de) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= de) return;
  const float* p = part + (size_t)blockIdx.y * splits * de + idx;
  float s = 0.f;
  for (int i = 0; i < splits; ++i) s += p[(size_t)i * de];
  out[(size_t)blockIdx.y * de + idx] = s;
}

__global__ void __launch_bounds__(kThreads)
apply_dots_kernel(const float* __restrict__ q, const float* __restrict__ dots,
                  float* __restrict__ o, int N, int D, int E) {
  extern __shared__ __align__(16) float smem[];
  float* sd = smem;            // (D rounded up to 4, kW): the factor, zero-padded
  float* sq = smem + kW * kW;  // (kRowsQ, kW): the q tile, zero-padded
  const int bh = blockIdx.y, r0 = blockIdx.x * kRowsQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int dpad = (D + 3) & ~3;
  const float* db = dots + (size_t)bh * D * E;
  for (int idx = threadIdx.x; idx < dpad * kW; idx += kThreads) {
    const int d = idx / kW, e = idx % kW;
    sd[idx] = (d < D && e < E) ? db[d * E + e] : 0.f;
  }
  const float* qb = q + (size_t)bh * N * D;
  for (int idx = threadIdx.x; idx < kRowsQ * kW; idx += kThreads) {
    const int r = idx / kW, d = idx % kW, n = r0 + r;
    sq[idx] = (n < N && d < D) ? qb[(size_t)n * D + d] : 0.f;
  }
  __syncthreads();

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < dpad; d += 4) {
    float4 qa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qa[i] = *reinterpret_cast<const float4*>(sq + (4 * ty + i) * kW + d);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      float b[8];
      load8(sd + (d + dd) * kW, tx, b);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = dd == 0 ? qa[i].x : dd == 1 ? qa[i].y : dd == 2 ? qa[i].z : qa[i].w;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
      }
    }
  }

  float* ob = o + (size_t)bh * N * E;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = r0 + 4 * ty + i;
    if (n < N) store8(ob + (size_t)n * E, tx, acc[i], E);
  }
}

bool widths_ok(int d, int e) { return d >= 1 && d <= kW && e >= 1 && e <= kW; }

}  // namespace

extern "C" {

// part: (bh, splits, d, e) scratch, or null when splits == 1 (the block then
// writes out directly); rows_per_split * splits >= n
int mc_kv_dots(const float* k, const float* v, float* out, float* part, int bh,
               int n, int d, int e, int splits, int rows_per_split, void* stream) {
  if (!widths_ok(d, e) || splits < 1 || (splits > 1 && !part) ||
      (long long)rows_per_split * splits < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(splits, bh);
  kv_dots_partial_kernel<<<grid, kThreads, 0, st>>>(k, v, splits == 1 ? out : part,
                                                    n, d, e, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int de = d * e;
  kv_dots_reduce_kernel<<<dim3((de + 255) / 256, bh), 256, 0, st>>>(part, out,
                                                                    splits, de);
  return (int)cudaGetLastError();
}

int mc_apply_dots(const float* q, const float* dots, float* out, int bh, int n,
                  int d, int e, void* stream) {
  if (!widths_ok(d, e)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      apply_dots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kApplySmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + kRowsQ - 1) / kRowsQ, bh);
  apply_dots_kernel<<<grid, kThreads, kApplySmem, (cudaStream_t)stream>>>(q, dots, out,
                                                                         n, d, e);
  return (int)cudaGetLastError();
}

}  // extern "C"
