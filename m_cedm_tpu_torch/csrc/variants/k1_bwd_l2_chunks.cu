// K1's backward as two launches per chunk of samples: the alternative the
// cooperative kernel of ../fused_norm.cu was timed against. It is not built
// into the package; kernels/attention_sources.py builds it when it is given
// on the command line:
//
//   python -m m_cedm_tpu_torch.kernels.attention_sources --kernel k1bwd
//       m_cedm_tpu_torch/csrc/variants/k1_bwd_l2_chunks.cu
//
// The same mc_gn_silu_bwd entry point and math, from the same device code
// (included below): per chunk of samples whose x and g fit in about half of
// the H100's 50 MB L2 (3 samples at the flagship's res 128), a stats launch
// (pass A from device memory, fixed-order partials, the last block of a
// sample sums them and writes dgamma, dbeta, m1 and m2), then an apply
// launch (pass B, whose reads of x and g should hit L2). No block waits on
// another; the cost is 2 * ceil(B / chunk) launches and a second read of x
// and g, from L2 where the chunk fits.
#define mc_gn_silu_bwd mc_gn_silu_bwd_cooperative
#include "../fused_norm.cu"
#undef mc_gn_silu_bwd

namespace {

constexpr size_t kChunkBytes = size_t(24) << 20;  // x and g of one chunk

// a Stage with no slab rows (p.smem_rows is 0 here): the sample's vectors
// with its mean and rstd, room for its partials and m1, m2
__device__ Stage sample_stage(const BwdArgs& p, int b, float* sm) {
  const int c = p.c;
  for (int i = threadIdx.x; i < c; i += kBwdPass) {
    sm[i] = p.sums[b * c + i];
    sm[c + i] = p.sumsq[b * c + i];
    sm[2 * c + i] = p.gamma[b * c + i];
    sm[3 * c + i] = p.beta[b * c + i];
  }
  __syncthreads();
  stage_norm(sm, p, threadIdx.x);
  __syncthreads();
  float* part = sm + round4(6L * c);
  return Stage{nullptr, nullptr, sm, part, part + p.row};
}

template <int V>
__global__ void __launch_bounds__(kBwdPass) chunk_stats_kernel(const BwdArgs p, int b0) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int last;
  const int s = blockIdx.x, b = b0 + blockIdx.y;
  const int rows = min(p.rows, p.n - s * p.rows);
  const size_t off = slab_offset(p, b, s);
  const Stage st = sample_stage(p, b, sm);
  grad_partials<V>(st, p.x + off, p.g + off, rows, p, st.mm + round4(2L * p.groups),
                   p.part + ((size_t)b * p.slabs + s) * p.row, threadIdx.x);
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(p.count + b, 1u) == (unsigned)p.slabs - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  const int per = p.c / p.groups;
  for (int k = threadIdx.x / 32; k < p.groups; k += kBwdPass / 32) {
    if (per % 4 == 0 && p.c % 4 == 0) finish_group<4>(p, b, k, threadIdx.x % 32);
    else finish_group<1>(p, b, k, threadIdx.x % 32);
  }
}

template <int V>
__global__ void __launch_bounds__(kBwdPass) chunk_apply_kernel(const BwdArgs p, int b0) {
  extern __shared__ __align__(16) float sm[];
  const int s = blockIdx.x, b = b0 + blockIdx.y;
  const int rows = min(p.rows, p.n - s * p.rows);
  const size_t off = slab_offset(p, b, s);
  const Stage st = sample_stage(p, b, sm);
  const unsigned long long* mm = p.mm + (size_t)b * 2 * p.groups;
  for (int i = threadIdx.x; i < 2 * p.groups; i += kBwdPass)
    st.mm[i] = __uint_as_float((unsigned)load_relaxed(mm + i));  // set by the stats launch
  __syncthreads();
  grad_apply<V>(st, p.x + off, p.g + off, p.dx + off, rows, p, st.mm, threadIdx.x);
}

template <int V>
int launch_chunks(BwdArgs p, cudaStream_t stream) {
  p.smem_rows = 0;
  const size_t per_sample = (size_t)p.n * p.c * 8;
  const int chunk = (int)(kChunkBytes / per_sample > 0 ? kChunkBytes / per_sample : 1);
  const size_t smem_apply = (round4(6L * p.c) + p.row + round4(2L * p.groups)) * 4;
  const size_t smem_stats = smem_apply + kRedFloats * 4;
  if (smem_stats > 48 * 1024) return (int)cudaErrorInvalidValue;
  for (int b0 = 0; b0 < p.batch; b0 += chunk) {
    const dim3 grid(p.slabs, chunk < p.batch - b0 ? chunk : p.batch - b0);
    chunk_stats_kernel<V><<<grid, kBwdPass, smem_stats, stream>>>(p, b0);
    chunk_apply_kernel<V><<<grid, kBwdPass, smem_apply, stream>>>(p, b0);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

extern "C" int mc_gn_silu_bwd(const float* x, const float* g, const float* gamma,
                              const float* beta, const float* sums, const float* sumsq,
                              float* dgamma, float* dbeta, float* dx, float* scratch,
                              unsigned* sync, int b, int n, int c, int groups, float eps,
                              int slabs, int rows, void* stream) {
  BwdArgs p;
  long smem = 0;
  const int rc = bwd_args(x, g, gamma, beta, sums, sumsq, dgamma, dbeta, dx, scratch, sync,
                          b, n, c, groups, eps, slabs, rows, &p, &smem);
  if (rc) return rc;
  return p.vec == 4 ? launch_chunks<4>(p, (cudaStream_t)stream)
                    : launch_chunks<1>(p, (cudaStream_t)stream);
}
