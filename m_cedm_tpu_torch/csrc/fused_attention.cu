// K4: fp32 softmax attention forward, softmax(q k^T / sqrt(D)) v, per
// head-batch, for (N, L, D) tensors with D = 64.
//
// Replaces m_cedm_tpu/pallas/fused_attention.py::_fwd_kernel. The TPU kernel
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
// end. Only q, k, v and the output touch device memory.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kD = 64;       // head width
constexpr int kBQ = 64;      // queries per block, one per thread
constexpr int kBK = 64;      // keys per shared-memory tile
constexpr int kChunk = 16;   // keys per rescale of the running sums

__global__ void __launch_bounds__(kBQ)
attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int L,
                     float scale) {
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
  }
}

}  // namespace

extern "C" {

int mc_attention_fwd(const float* q, const float* k, const float* v, float* o,
                     int n, int L, int d, float scale, void* stream) {
  if (d != kD) return (int)cudaErrorInvalidValue;
  dim3 grid((L + kBQ - 1) / kBQ, n);
  attention_fwd_kernel<<<grid, kBQ, 0, (cudaStream_t)stream>>>(q, k, v, o, L, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
