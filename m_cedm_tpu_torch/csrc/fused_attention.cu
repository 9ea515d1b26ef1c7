// K4: fp32 softmax attention, softmax(q k^T / sqrt(D)) v, per head-batch,
// for (N, L, D) tensors with D = 64: the forward and its backward.
//
// Forward: replaces m_cedm_tpu/pallas/fused_attention.py::_fwd_kernel. The TPU kernel
// holds a whole head-batch and its (L, L) logits in VMEM and so refuses L
// above about 1600; this kernel never forms the (L, L) matrix and has no cap.
//
// Bound: at the flagship shape (N = 16, L = 1024) one call is 4.3 GFLOP on
// 12 MiB of q/k/v/o, about 350 FLOP per byte, so fp32 arithmetic and the
// shared-memory reads that feed it set the time.
//
// Design: a tiled online softmax (the flash-attention recurrence) in fp32 on
// CUDA cores. One thread owns one query row: q and the output accumulator
// live in its registers. Keys and values stream through shared memory 64 rows
// at a time; every thread of the block reads the same key row at the same
// moment, so those reads are broadcasts. The running max and sum are updated
// once per chunk of 16 keys, and the output is divided by the sum once at the
// end. Only q, k, v and the output touch device memory, plus, when the
// caller asks for it, the per-row log-sum-exp of the scaled logits (N, L),
// which is all the backward needs to rebuild any probability.
//
// Backward: replaces m_cedm_tpu/pallas/fused_attention.py::_bwd_kernel. With
// w = softmax(s), s = q k^T / sqrt(D), g the output cotangent and o the
// forward output:
//   dv = w^T g;  dl = w * (g v^T - delta), delta_i = sum_d g_i o_i;
//   dq = dl k / sqrt(D);  dk = dl^T q / sqrt(D).
// The TPU kernel holds the (L, L) matrices of one head-batch in VMEM (4 MB
// each at L = 1024), which one SM's 227 KB of shared memory cannot. So the
// probabilities are rebuilt flash-style, tile by tile, from q, k and the saved
// log-sum-exp, and no (L, L) matrix exists. Two kernels, no atomics:
//   dq kernel    a block owns 64 query rows and walks every key tile; it also
//                writes delta for the second kernel;
//   dk/dv kernel a block owns 64 key rows and walks every query tile, so the
//                sums over queries stay in registers and every dk, dv is
//                written once, in a fixed order (deterministic).
// Each recomputes s and g v^T, so the pair does 7 (L, L, D) products where
// the least work is 5; the price buys the absence of atomics on dq. Four
// threads share a row, each holding 16 of its 64 widths (the float4 chunks
// k, k + 4, k + 8, k + 12, so that a warp's shared-memory reads are
// conflict-free); dot products finish with two warp shuffles.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kD = 64;       // head width
constexpr int kBQ = 64;      // queries per block, one per thread
constexpr int kBK = 64;      // keys per shared-memory tile
constexpr int kChunk = 16;   // keys per rescale of the running sums

__global__ void __launch_bounds__(kBQ)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int L, float scale) {
  __shared__ __align__(16) float sk[kBK][kD];
  __shared__ __align__(16) float sv[kBK][kD];
  const size_t base = (size_t)blockIdx.y * L * kD;
  const int row = blockIdx.x * kBQ + threadIdx.x;
  const bool valid = row < L;

  float qr[kD], acc[kD];
#pragma unroll
  for (int d = 0; d < kD; d += 4) {
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid) t = *reinterpret_cast<const float4*>(q + base + (size_t)row * kD + d);
    qr[d] = t.x; qr[d + 1] = t.y; qr[d + 2] = t.z; qr[d + 3] = t.w;
    acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < L; k0 += kBK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBK * kD / 4; idx += kBQ) {
      const int kr = idx / (kD / 4), d4 = idx % (kD / 4);
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + kr < L) {
        kv = reinterpret_cast<const float4*>(k + base + (size_t)(k0 + kr) * kD)[d4];
        vv = reinterpret_cast<const float4*>(v + base + (size_t)(k0 + kr) * kD)[d4];
      }
      reinterpret_cast<float4*>(&sk[kr][0])[d4] = kv;
      reinterpret_cast<float4*>(&sv[kr][0])[d4] = vv;
    }
    __syncthreads();
    const int nk = min(kBK, L - k0);
    for (int j0 = 0; j0 < nk; j0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < kD; d += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(&sk[j0 + jj][d]);
          dot = fmaf(qr[d], kk.x, dot);
          dot = fmaf(qr[d + 1], kk.y, dot);
          dot = fmaf(qr[d + 2], kk.z, dot);
          dot = fmaf(qr[d + 3], kk.w, dot);
        }
        // scale = 1/sqrt(64) is a power of two: exact either side of the dot
        s[jj] = (j0 + jj < nk) ? dot * scale : -INFINITY;
        cmax = fmaxf(cmax, s[jj]);
      }
      const float m_new = fmaxf(m, cmax);  // finite: every chunk has a key
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float pj = expf(s[jj] - m_new);
        l += pj;
#pragma unroll
        for (int d = 0; d < kD; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&sv[j0 + jj][d]);
          acc[d] = fmaf(pj, vv.x, acc[d]);
          acc[d + 1] = fmaf(pj, vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(pj, vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(pj, vv.w, acc[d + 3]);
        }
      }
      m = m_new;
    }
  }

  if (valid) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < kD; d += 4) {
      *reinterpret_cast<float4*>(o + base + (size_t)row * kD + d) =
          make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv,
                      acc[d + 3] * inv);
    }
    if (lse) lse[(size_t)blockIdx.y * L + row] = m + logf(l);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kRows = 64;               // rows (queries or keys) per block
constexpr int kSplit = 4;               // threads per row
constexpr int kBwdThreads = kRows * kSplit;
constexpr int kPart = kD / kSplit;      // widths per thread

// the 16 widths of thread slot `sl`: float4 chunks sl, sl + 4, sl + 8, sl + 12
__device__ __forceinline__ int width_of(int sl, int k) { return (sl + 4 * k) * 4; }

__device__ __forceinline__ void load_part(const float* row, int sl, float* r) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 t = *reinterpret_cast<const float4*>(row + width_of(sl, k));
    r[4 * k] = t.x; r[4 * k + 1] = t.y; r[4 * k + 2] = t.z; r[4 * k + 3] = t.w;
  }
}

__device__ __forceinline__ float dot_part(const float* r, const float* srow, int sl) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 t = *reinterpret_cast<const float4*>(srow + width_of(sl, k));
    s = fmaf(r[4 * k], t.x, s);
    s = fmaf(r[4 * k + 1], t.y, s);
    s = fmaf(r[4 * k + 2], t.z, s);
    s = fmaf(r[4 * k + 3], t.w, s);
  }
  // the four threads of a row are adjacent lanes
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

__device__ __forceinline__ void axpy_part(float a, const float* srow, int sl, float* acc) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 t = *reinterpret_cast<const float4*>(srow + width_of(sl, k));
    acc[4 * k] = fmaf(a, t.x, acc[4 * k]);
    acc[4 * k + 1] = fmaf(a, t.y, acc[4 * k + 1]);
    acc[4 * k + 2] = fmaf(a, t.z, acc[4 * k + 2]);
    acc[4 * k + 3] = fmaf(a, t.w, acc[4 * k + 3]);
  }
}

__device__ __forceinline__ void store_part(float* row, int sl, const float* r, float mul) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    *reinterpret_cast<float4*>(row + width_of(sl, k)) =
        make_float4(r[4 * k] * mul, r[4 * k + 1] * mul, r[4 * k + 2] * mul,
                    r[4 * k + 3] * mul);
}

// two (64, D) tiles of rows r0.. of a and b into shared memory, zero past L
__device__ __forceinline__ void load_tiles(const float* a, const float* b,
                                           float (*sa)[kD], float (*sb)[kD],
                                           int r0, int L) {
  for (int idx = threadIdx.x; idx < kRows * kD / 4; idx += kBwdThreads) {
    const int r = idx / (kD / 4), d4 = idx % (kD / 4);
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
    if (r0 + r < L) {
      av = reinterpret_cast<const float4*>(a + (size_t)(r0 + r) * kD)[d4];
      bv = reinterpret_cast<const float4*>(b + (size_t)(r0 + r) * kD)[d4];
    }
    reinterpret_cast<float4*>(&sa[r][0])[d4] = av;
    reinterpret_cast<float4*>(&sb[r][0])[d4] = bv;
  }
}

__global__ void __launch_bounds__(kBwdThreads)
attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ o,
                        const float* __restrict__ g, const float* __restrict__ lse,
                        float* __restrict__ delta, float* __restrict__ dq, int L,
                        float scale) {
  __shared__ __align__(16) float sk[kRows][kD];
  __shared__ __align__(16) float sv[kRows][kD];
  const size_t base = (size_t)blockIdx.y * L * kD;
  const int row = blockIdx.x * kRows + threadIdx.x / kSplit;
  const int sl = threadIdx.x % kSplit;
  const bool valid = row < L;
  float qr[kPart], gr[kPart], orow[kPart], acc[kPart];
#pragma unroll
  for (int i = 0; i < kPart; ++i) qr[i] = gr[i] = orow[i] = acc[i] = 0.f;
  if (valid) {
    load_part(q + base + (size_t)row * kD, sl, qr);
    load_part(g + base + (size_t)row * kD, sl, gr);
    load_part(o + base + (size_t)row * kD, sl, orow);
  }
  float dl = 0.f;
#pragma unroll
  for (int i = 0; i < kPart; ++i) dl = fmaf(gr[i], orow[i], dl);
  dl += __shfl_xor_sync(0xffffffffu, dl, 1);
  dl += __shfl_xor_sync(0xffffffffu, dl, 2);
  const float my_lse = valid ? lse[(size_t)blockIdx.y * L + row] : 0.f;
  if (valid && sl == 0) delta[(size_t)blockIdx.y * L + row] = dl;

  for (int k0 = 0; k0 < L; k0 += kRows) {
    __syncthreads();
    load_tiles(k + base, v + base, sk, sv, k0, L);
    __syncthreads();
    const int nk = min(kRows, L - k0);
    for (int j = 0; j < nk; ++j) {
      const float p = expf(dot_part(qr, sk[j], sl) * scale - my_lse);
      const float dp = dot_part(gr, sv[j], sl);
      axpy_part(p * (dp - dl), sk[j], sl, acc);
    }
  }
  if (valid) store_part(dq + base + (size_t)row * kD, sl, acc, scale);
}

__global__ void __launch_bounds__(kBwdThreads)
attention_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ g,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, float* __restrict__ dk,
                          float* __restrict__ dv, int L, float scale) {
  __shared__ __align__(16) float sq[kRows][kD];
  __shared__ __align__(16) float sg[kRows][kD];
  __shared__ float s_lse[kRows];
  __shared__ float s_delta[kRows];
  const size_t base = (size_t)blockIdx.y * L * kD;
  const int row = blockIdx.x * kRows + threadIdx.x / kSplit;
  const int sl = threadIdx.x % kSplit;
  const bool valid = row < L;
  float kr[kPart], vr[kPart], dkr[kPart], dvr[kPart];
#pragma unroll
  for (int i = 0; i < kPart; ++i) kr[i] = vr[i] = dkr[i] = dvr[i] = 0.f;
  if (valid) {
    load_part(k + base + (size_t)row * kD, sl, kr);
    load_part(v + base + (size_t)row * kD, sl, vr);
  }
  for (int q0 = 0; q0 < L; q0 += kRows) {
    __syncthreads();
    load_tiles(q + base, g + base, sq, sg, q0, L);
    if (threadIdx.x < kRows) {
      const int r = q0 + threadIdx.x;
      s_lse[threadIdx.x] = r < L ? lse[(size_t)blockIdx.y * L + r] : 0.f;
      s_delta[threadIdx.x] = r < L ? delta[(size_t)blockIdx.y * L + r] : 0.f;
    }
    __syncthreads();
    const int nq = min(kRows, L - q0);
    for (int i = 0; i < nq; ++i) {
      const float p = expf(dot_part(kr, sq[i], sl) * scale - s_lse[i]);
      const float dp = dot_part(vr, sg[i], sl);
      axpy_part(p, sg[i], sl, dvr);
      axpy_part(p * (dp - s_delta[i]), sq[i], sl, dkr);
    }
  }
  if (valid) {
    store_part(dk + base + (size_t)row * kD, sl, dkr, scale);
    store_part(dv + base + (size_t)row * kD, sl, dvr, 1.f);
  }
}

}  // namespace

extern "C" {

// lse: (n, L) log-sum-exp of the scaled logits per row, or null
int mc_attention_fwd(const float* q, const float* k, const float* v, float* o,
                     float* lse, int n, int L, int d, float scale, void* stream) {
  if (d != kD) return (int)cudaErrorInvalidValue;
  dim3 grid((L + kBQ - 1) / kBQ, n);
  attention_fwd_kernel<<<grid, kBQ, 0, (cudaStream_t)stream>>>(q, k, v, o, lse,
                                                               L, scale);
  return (int)cudaGetLastError();
}

// o and lse from mc_attention_fwd; delta: (n, L) scratch
int mc_attention_bwd(const float* q, const float* k, const float* v,
                     const float* o, const float* g, const float* lse,
                     float* delta, float* dq, float* dk, float* dv, int n, int L,
                     int d, float scale, void* stream) {
  if (d != kD) return (int)cudaErrorInvalidValue;
  dim3 grid((L + kRows - 1) / kRows, n);
  cudaStream_t s = (cudaStream_t)stream;
  attention_bwd_dq_kernel<<<grid, kBwdThreads, 0, s>>>(q, k, v, o, g, lse, delta,
                                                       dq, L, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkdv_kernel<<<grid, kBwdThreads, 0, s>>>(q, k, v, g, lse, delta,
                                                         dk, dv, L, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
