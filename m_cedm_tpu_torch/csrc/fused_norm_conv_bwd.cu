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
// run in parallel and in no order, so the work splits into two kernels, each
// followed by a reduce of per-block partials in a fixed order:
//
//   dgrad  da = conv3x3^T(g) * silu'(a): a 3x3 conv of the cotangent g with
//          the mirrored taps and the transposed weight, zero outside the
//          image (the cotangent of SAME zero padding), then multiplied by
//          silu'(a) with a = xhat * gamma + beta recomputed from x and the
//          forward's saved statistics. The epilogue also reduces
//          dgamma = sum da * xhat and dbeta = sum da over the block's pixels
//          into a (2, B, tiles, C) scratch, which colsum_kernel adds in a
//          fixed order. Linear mode: da is the transposed conv itself. K3:
//          the tile runs at high resolution and the epilogue adds the two
//          high-res columns of each low-res pixel (lanes 4 apart in the
//          accumulator, one shuffle), writing a (B, H, W / 2, C) tensor; the
//          row pair and the GroupNorm / SiLU backward at low resolution
//          follow in PyTorch, as they follow in XLA on the TPU
//          (_pallas_up_pair_bwd).
//   wgrad  dW[tap] = sum over pixels of act(x) shifted by the tap, times g:
//          a (9 C x O) product that reduces over all B * H * W pixels
//          (262,144 at the flagship shape); dbias = sum g. Per-run partial
//          tiles go to a (B * runs, taps * C * O + O) scratch, and
//          colsum_kernel adds the runs in a fixed order, so dW and dbias
//          repeat bit for bit. The 1x1 projection skip's weight gradient is
//          the same kernel with one tap and no activation.
//
// dx then follows from da, gamma, dgamma, dbeta and the statistics in one
// elementwise PyTorch pass (_dx_from_da is XLA on the TPU as well).
//
// Bound. dgrad and wgrad each do the forward conv's 2 * 9 * C * O FLOPs per
// pixel (19.3 GFLOP each at the flagship shape, 64 -> 64 channels at 16 x 128
// x 128), about 150 FLOP per byte moved: arithmetic sets the time. On the
// CUDA cores (67 TFLOP/s fp32) that is 0.288 ms each; in 3xTF32 on the tensor
// cores (three TF32 products per fp32 product at 495 TFLOP/s) 0.117 ms, and
// TF32 mma.sync peaks at about 324 TFLOP/s on the H100 (0.18 ms).
//
// Both kernels run every product in 3xTF32 on mma.sync.m16n8k8, as the
// forward (csrc/fused_norm_conv.cu, whose helpers are copied below): each
// fp32 operand split once as hi = tf32(x), lo = tf32(x - hi) (cvt.rn) into a
// plane in shared memory whose layout makes each fragment one 16-byte load,
// the products summed lo*hi + hi*lo + hi*hi, a short run of k-steps on the
// tensor cores into a zeroed fragment before each fp32 add. Copies of raw
// operands run on cp.async while the tensor cores work.
//
// dgrad is the forward's implicit GEMM on g: M = the block's 8 x 16 pixels,
// N = 64 input channels of the forward, K = 9 taps x O cotangent channels,
// 8 warps of 2 m-tiles x 4 n-tiles, two blocks an SM (104 KB of shared
// memory, at most 128 registers). The cotangent needs no normalising pass:
// its halo'd 10 x 18 x 8 chunk rides on cp.async as it is and is only split.
// The weight chunk is staged already mirrored and transposed: row (tap,
// channel c) holds forward tap 8 - tap's eight cotangent channels of c, 32
// contiguous bytes of w, its two 16-byte halves swapped on bit 2 of c so
// that the split pass reads it without bank conflicts. Nine taps a partial
// (kTempSteps), as the forward.
//
// wgrad is a GEMM of M = C, N = O and K = the pixels. A block owns a run of
// 4 x 16 pixel tiles of one image, 32 input and 32 output channels, and all
// nine taps: 9 warps, warp w tap w, each 2 m-tiles (32 channels of act(x))
// x 4 n-tiles (32 channels of g) = 32 x 32 outputs. A k-step is eight pixels
// of a tile row; the shift of a tap moves the K index (the pixel), not M,
// so the forward's fragment-order planes do not carry over. Instead:
//   - act(x) is rebuilt once per halo'd 6 x 18 position and channel (one
//     expf each; K3 reads low-res pixel (Y / 2, X / 2), so the 4x tensor
//     never exists) into a plane that holds, per position and 16-channel
//     m-tile, lane group g's (hi c_g, hi c_g+8, lo c_g, lo c_g+8): the A
//     fragment of any tap at pixels t and t + 4 is two 16-byte loads at the
//     shifted positions. The eight 16-byte groups of a position are XOR
//     swizzled by the position's low two bits, so the four positions a
//     quarter warp reads fall on distinct banks.
//   - g is split once into B-fragment order, (k-step, n-tile, lane) ->
//     (hi b0, hi b1, lo b0, lo b1): each split g element feeds 9 taps x 2
//     m-tiles, read by the nine warps from the same plane.
//   - the raw x and g tiles of the next tile are fetched by cp.async into a
//     single raw stage while the warps multiply this tile (the split pass
//     empties the stage before the next copy is issued).
// Accumulators: 9 taps x 32 x 32 outputs is 32 floats a thread in 9 warps;
// the zeroed tensor-core partial is added every kWTempSteps k-steps of a
// tile (and at the tile's end) into the fp32 sum, which each thread keeps
// in its own slot of shared memory (36 KB), so registers hold only the
// partial and the fragments and two blocks fit an SM (106 KB each; at two
// 9-warp blocks one SM sub-partition holds five warps, which caps a thread
// at 96 registers). g is read once for every 32 input channels (twice at
// C = 64), from L2. dbias: the threads that split g each own one output
// channel and sum it in fp32; a fixed-order reduce at the end of the run.
// The 1x1 projection (one tap) spreads a tile's k-steps over the nine warps
// instead, and adds their sums in a fixed order at the end.
// Measured at the res-128 tail on an H100 (kernels/attention_sources.py
// --kernel k2bwd): wgrad 0.58-0.60 ms, dgrad 0.54-0.55; by its diagnostic
// variants about 0.32 ms of wgrad's are products (59 % of mma.sync's rate:
// a warp loads 4 KB of fragments per 24 products, as the forward) and 0.17
// the split pass, and dgrad's products about 0.33.
//
// At C <= 8 (conv_in, C = 4; 3 x 3, not K3) wgrad_narrow_kernel runs
// instead, in fp32 on the CUDA cores: its 1.2 GFLOP at the flagship shape
// take 0.018 ms there against 0.021 ms for the 67 MB of g it must read, so
// bytes bound it, and a tensor-core block would compute 32 channel rows
// for 4 at the same per-tile cost of staging, barriers and copies (0.19 ms
// with 16-row blocks; the taps folded into M, 36 of 48 rows, 0.22; this
// kernel 0.09). Its partials go to the same scratch and reduce.
//
// mc_conv_wgrad_runs picks the runs per image to fill about two blocks an
// SM in one wave; the scratch is then (B * runs) x 9 C O floats (9.4 MB at
// the flagship's res-128 tail).
//
// bf16 (mc_conv_dgrad_bf16, mc_conv_wgrad_bf16): the kernels' instances on
// bf16 x, g and w (template argument T), replacing _gnsc_bwd_kernel_a and
// _up_pair_bwd_kernel on a bf16 network, where they round at these points:
//   - the activation is recomputed in fp32 and rounded to bf16 before its
//     products: K2 in _act_from_x's form, ((x - mean) * rstd) * gamma + beta
//     then SiLU; K3 in _up_pair_bwd_kernel's folded form, x * (gamma * rstd)
//     + (beta - gamma * rstd * mean) then SiLU;
//   - dW, dbias and the conv input's cotangent ds are sums in fp32 of bf16
//     products (exact in fp32);
//   - dgrad's act mode forms da = ds * silu' and the dgamma, dbeta partials in
//     fp32 and stores da rounded to bf16 (the linear mode stores ds rounded);
//     the up-fold mode's ds stays fp32, as K3's does.
// Both take their products as bf16 mma.sync.m16n8k16 (one where 3xTF32 takes
// three TF32 products), from raw tiles staged as they are (16-byte cp.async,
// eight values, where C and O are multiples of 8): no split pass. dgrad
// (dgrad_kernel<mode, bf16>) reads A (pixel, o) and B (o, c) as 32-bit pairs,
// since o pairs lie together in g (NHWC) and in w (HWIO). wgrad
// (wgrad_bf16_kernel) contracts over pixels, the strided axis of both NHWC
// operands, so ldmatrix.trans builds its fragments from [pixel][channel]
// rows; its one pass over a tile is the activation. Bound at the res-128
// tail: 19.3 GFLOP each of bf16 products, 0.020 ms at 989 TFLOP/s (bytes:
// 0.010 ms).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ---------------------------------------------------------------------------
// 3xTF32 on mma.sync and cp.async (as in csrc/fused_norm_conv.cu)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rn.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo up to 2^-22 of x, both exact TF32 values
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

struct AFrag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

__device__ __forceinline__ void cp_async16(__nv_bfloat16* smem, const __nv_bfloat16* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// two consecutive elements (pair: one aligned access; two: the second exists)
__device__ __forceinline__ void load2(const float* p, bool pair, bool two, float& a,
                                      float& b) {
  if (pair) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a = v.x;
    b = v.y;
  } else {
    a = p[0];
    b = two ? p[1] : 0.f;
  }
}

__device__ __forceinline__ void load2(const __nv_bfloat16* p, bool pair, bool two, float& a,
                                      float& b) {
  if (pair) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    a = v.x;
    b = v.y;
  } else {
    a = __bfloat162float(p[0]);
    b = two ? __bfloat162float(p[1]) : 0.f;
  }
}

__device__ __forceinline__ void store2(float* p, bool pair, bool two, float a, float b) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
    if (two) p[1] = b;
  }
}

// rounded once to bf16
__device__ __forceinline__ void store2(__nv_bfloat16* p, bool pair, bool two, float a,
                                       float b) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16_rn(a);
    if (two) p[1] = __float2bfloat16_rn(b);
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ void store_split(float* dst, float v0, float v1) {
  uint32_t h0, l0, h1, l1;
  split(v0, h0, l0);
  split(v1, h1, l1);
  *reinterpret_cast<uint4*>(dst) = make_uint4(h0, h1, l0, l1);
}

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

bool aligned(const void* ptr, int bytes) {
  return ((uintptr_t)ptr & (uintptr_t)(bytes - 1)) == 0;
}



// out[s, k] = sum over i < n of part[s, i, k] for every slice s: each of
// kSumGroups threads of a column adds every kSumGroups-th row in order, then
// the groups' sums are added in order. A fixed order: no atomics. (As in
// csrc/narrow_conv.cu.)
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
// dgrad: the forward's implicit GEMM on the cotangent
// ---------------------------------------------------------------------------

constexpr int kTH = 8;           // pixel rows per block
constexpr int kTW = 16;          // pixel columns per block: one m16 tile a row
constexpr int kBC = 64;          // forward input channels (the GEMM's N) per block
constexpr int kCK = 8;           // cotangent channels per chunk: one k-step
constexpr int kWarps = 8;        // 4 row pairs x 2 channel halves
constexpr int kThreads = 32 * kWarps;
constexpr int kIH = kTH + 2;
constexpr int kIW = kTW + 2;
constexpr int kPos = kIH * kIW;  // halo'd tile positions
constexpr int kXS = 12;          // raw cotangent floats a position (8 used)
constexpr int kTempSteps = 9;    // k-steps summed on the tensor cores per fp32 add

// shared memory, in floats
constexpr int kRawG = kPos * kXS;         // one raw cotangent stage
constexpr int kRawW = 9 * kBC * kCK;      // one raw weight stage
constexpr int kSplitA = kPos * 16;        // the split cotangent plane
constexpr int kSplitB = 9 * 8 * 32 * 4;   // the split weight plane
constexpr int kDSmemFloats = 2 * (kRawG + kRawW) + kSplitA + kSplitB + 4 * kBC;
constexpr size_t kDSmemBytes = sizeof(float) * kDSmemFloats;

// pixel tiles per image of the dgrad kernel (h, w the cotangent's)
int dgrad_tiles(int h, int wd) { return ((h + kTH - 1) / kTH) * ((wd + kTW - 1) / kTW); }

enum DgradMode { kLinear = 0, kAct = 1, kUpFold = 2 };

struct DgradArgs {
  const void* g;       // (B, H, W, O) cotangent of the conv output
  const void* w;       // (3, 3, C, O) forward weight
  const void* x;       // (B, H, W, C) forward input (kAct); g, w, x of type T
  const float* gamma;  // (B, C) folded scale and shift (kAct)
  const float* beta;
  const float* sums;   // (B, C) the forward's channel sums of x (kAct)
  const float* sumsq;
  void* out;           // da (B, H, W, C) of type T; kUpFold: fp32 (B, H, W / 2, C)
  float* part;         // kAct: (2, B, tiles, C) per-block dgamma, dbeta
  int H, W, C, O, groups;
  float eps;
  int gvec, wvec, pair;  // 16-byte copies of g / w; 8-byte loads and stores
};

// Cotangent channels o0 .. o0 + 7 into one raw stage: the halo'd tile of g
// (zero outside the image and past O; no bytes are read there) and the
// weights of the nine transposed taps, row (tap, cc) = w[8 - tap][c0 + cc]
// [o0 .. o0 + 7] with its 16-byte halves swapped when bit 2 of cc is set.
__device__ __forceinline__ void dg_load_chunk(const DgradArgs& p, int q, float* rg,
                                              float* rw, int b, int ty0, int tx0,
                                              int c0, int tid) {
  const int o0 = q * kCK, O = p.O, C = p.C;
  const float* gb = static_cast<const float*>(p.g) + (size_t)b * p.H * p.W * O;
  const float* w = static_cast<const float*>(p.w);
  if (p.gvec) {
    for (int idx = tid; idx < kPos * 2; idx += kThreads) {
      const int h = idx & 1, pos = idx >> 1;
      const int y = ty0 - 1 + pos / kIW, x = tx0 - 1 + pos % kIW, o = o0 + 4 * h;
      const bool valid = y >= 0 && y < p.H && x >= 0 && x < p.W && o < O;
      cp_async16(rg + pos * kXS + 4 * h,
                 valid ? gb + ((size_t)y * p.W + x) * O + o : gb, valid);
    }
  } else {
    for (int idx = tid; idx < kPos * kCK; idx += kThreads) {
      const int k = idx % kCK, pos = idx / kCK;
      const int y = ty0 - 1 + pos / kIW, x = tx0 - 1 + pos % kIW, o = o0 + k;
      const bool valid = y >= 0 && y < p.H && x >= 0 && x < p.W && o < O;
      cp_async4(rg + pos * kXS + k,
                valid ? gb + ((size_t)y * p.W + x) * O + o : gb, valid);
    }
  }
  if (p.wvec) {
    for (int idx = tid; idx < 9 * kBC * 2; idx += kThreads) {
      const int h = idx & 1, row = idx >> 1;  // row = tap * kBC + cc
      const int tap = row / kBC, cc = row % kBC, c = c0 + cc, o = o0 + 4 * h;
      const bool valid = c < C && o < O;
      cp_async16(rw + row * kCK + 4 * (h ^ ((cc >> 2) & 1)),
                 valid ? w + ((size_t)(8 - tap) * C + c) * O + o : w, valid);
    }
  } else {
    for (int idx = tid; idx < 9 * kBC * kCK; idx += kThreads) {
      const int k = idx % kCK, row = idx / kCK;
      const int tap = row / kBC, cc = row % kBC, c = c0 + cc, o = o0 + k;
      const bool valid = c < C && o < O;
      cp_async4(rw + row * kCK + (k ^ (cc & 4)),
                valid ? w + ((size_t)(8 - tap) * C + c) * O + o : w, valid);
    }
  }
}

// The cotangent plane: position pos holds, at 4t for thread t of a quad,
// (hi o_t, hi o_t+4, lo o_t, lo o_t+4) (the A fragment's two k columns).
__device__ __forceinline__ void dg_split_g(const float* rg, float* sa, int tid) {
  for (int idx = tid; idx < kPos * 4; idx += kThreads) {
    const int t = idx & 3, pos = idx >> 2;
    store_split(sa + pos * 16 + 4 * t, rg[pos * kXS + t], rg[pos * kXS + t + 4]);
  }
}


// The weight plane in B-fragment order: (tap, n-tile, lane) holds (hi, lo) of
// b0 = W'[k = t][n = g] and b1 = W'[k = t + 4][n = g], W'[k][n] = the raw row
// (tap, n)'s entry k (its halves swapped back).
__device__ __forceinline__ void dg_split_w(const float* rw, float* sb, int tid) {
  for (int idx = tid; idx < 9 * 8 * 32; idx += kThreads) {
    const int lane = idx & 31, nt = (idx >> 5) & 7, tap = idx >> 8;
    const int g = lane >> 2, t = lane & 3;
    const int cc = 8 * nt + g, sw = cc & 4;
    const float* r = rw + (tap * kBC + cc) * kCK;
    store_split(sb + 4 * idx, r[t ^ sw], r[(t + 4) ^ sw]);
  }
}


// One chunk's nine taps on the warp's two m-tiles x four n-tiles:
// kTempSteps taps into a zeroed fragment, then one fp32 add into acc (the
// forward's mma_chunk<9>).
__device__ __forceinline__ void dg_mma_chunk(const float* sa, const float* sb,
                                             float (&acc)[2][4][4], int rg, int cq,
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s0 = 0; s0 < 9; s0 += kTempSteps) {
    float part[2][4][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[m][j][e] = 0.f;
    // rolled: unrolled, ptxas hoists later taps' fragments and spills more
#pragma unroll 1
    for (int s = s0; s < s0 + kTempSteps && s < 9; ++s) {
      const int dy = s / 3, dx = s % 3;
      AFrag a[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* pa = sa + ((2 * rg + m + dy) * kIW + g + dx) * 16 + 4 * t;
        const float4 p0 = *reinterpret_cast<const float4*>(pa);           // pixel g
        const float4 p8 = *reinterpret_cast<const float4*>(pa + 8 * 16);  // pixel g + 8
        a[m].hi[0] = __float_as_uint(p0.x);
        a[m].hi[1] = __float_as_uint(p8.x);
        a[m].hi[2] = __float_as_uint(p0.y);
        a[m].hi[3] = __float_as_uint(p8.y);
        a[m].lo[0] = __float_as_uint(p0.z);
        a[m].lo[1] = __float_as_uint(p8.z);
        a[m].lo[2] = __float_as_uint(p0.w);
        a[m].lo[3] = __float_as_uint(p8.w);
      }
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 f = *reinterpret_cast<const float4*>(
            sb + ((s * 8 + 4 * cq + j) * 32 + lane) * 4);
        bh[j][0] = __float_as_uint(f.x);
        bh[j][1] = __float_as_uint(f.y);
        bl[j][0] = __float_as_uint(f.z);
        bl[j][1] = __float_as_uint(f.w);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_tf32(part[m][j], a[m].lo, bh[j][0], bh[j][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_tf32(part[m][j], a[m].hi, bl[j][0], bl[j][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int m = 0; m < 2; ++m) mma_tf32(part[m][j], a[m].hi, bh[j][0], bh[j][1]);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][j][e] += part[m][j][e];
  }
}

// The bf16 dgrad: one bf16 mma.sync.m16n8k16 a k-step of 16 cotangent
// channels, its A and B fragments read as 32-bit pairs straight from the raw
// tiles (no split pass): A (pixel, o) is the cotangent, whose channel pairs
// lie together in NHWC; B (o, c) is the transposed weight, whose o pairs lie
// together in HWIO. A position of the halo'd cotangent tile and a weight row
// (tap, c) hold 16 values in 48 bytes, so the eight rows a fragment load
// touches start 12 words apart and a warp's 32 words fall on 32 banks.
constexpr int kCK16 = 16;   // cotangent channels a bf16 chunk
constexpr int kRS16 = 24;   // bf16 values a staged position or weight row
constexpr int kRawG16 = kPos * kRS16;
constexpr int kRawW16 = 9 * kBC * kRS16;
static_assert(2 * 2 * (kRawG16 + kRawW16) <= 4 * (2 * (kRawG + kRawW) + kSplitA + kSplitB),
              "the bf16 stages fit below the statistics of the fp32 layout");

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Cotangent channels o0 .. o0 + 15 into one raw bf16 stage: the halo'd tile
// of g (zero outside the image and past O) and the rows (tap, cc) = w[8 -
// tap][c0 + cc][o0 .. o0 + 15] of the nine transposed taps; two 16-byte
// copies a position or row where O % 8 == 0, element loads otherwise.
__device__ __forceinline__ void dg16_load_chunk(const DgradArgs& p, int q, __nv_bfloat16* rg,
                                                __nv_bfloat16* rw, int b, int ty0, int tx0,
                                                int c0, int tid) {
  const int o0 = q * kCK16, O = p.O, C = p.C;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const __nv_bfloat16* gb =
      static_cast<const __nv_bfloat16*>(p.g) + (size_t)b * p.H * p.W * O;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);
  for (int idx = tid; idx < kPos * 2; idx += kThreads) {
    const int h = idx & 1, pos = idx >> 1;
    const int y = ty0 - 1 + pos / kIW, x = tx0 - 1 + pos % kIW, o = o0 + 8 * h;
    const bool inside = y >= 0 && y < p.H && x >= 0 && x < p.W;
    const __nv_bfloat16* src = gb + ((size_t)y * p.W + x) * O + o;
    __nv_bfloat16* dst = rg + pos * kRS16 + 8 * h;
    if (p.gvec) {
      cp_async16(dst, inside && o < O ? src : gb, inside && o < O);
    } else {
      for (int k = 0; k < 8; ++k) dst[k] = inside && o + k < O ? src[k] : zero;
    }
  }
  for (int idx = tid; idx < 9 * kBC * 2; idx += kThreads) {
    const int h = idx & 1, row = idx >> 1;
    const int tap = row / kBC, c = c0 + row % kBC, o = o0 + 8 * h;
    const __nv_bfloat16* src = w + ((size_t)(8 - tap) * C + c) * O + o;
    __nv_bfloat16* dst = rw + row * kRS16 + 8 * h;
    if (p.wvec) {
      cp_async16(dst, c < C && o < O ? src : w, c < C && o < O);
    } else {
      for (int k = 0; k < 8; ++k) dst[k] = c < C && o + k < O ? src[k] : zero;
    }
  }
}

// One chunk's nine taps on the warp's two m-tiles (pixel rows 2 rg + m, the
// A rows pixels g and g + 8) x four n-tiles (input channels 32 cq + 8 j + g),
// summed into acc on the tensor cores.
__device__ __forceinline__ void dg16_mma_chunk(const __nv_bfloat16* rg,
                                               const __nv_bfloat16* rw,
                                               float (&acc)[2][4][4], int rgi, int cq,
                                               int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int s = 0; s < 9; ++s) {
    const int dy = s / 3, dx = s % 3;
    uint32_t a[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const __nv_bfloat16* p0 = rg + ((2 * rgi + m + dy) * kIW + g + dx) * kRS16 + 2 * t;
      const __nv_bfloat16* p8 = p0 + 8 * kRS16;
      a[m][0] = ld_pair(p0);
      a[m][1] = ld_pair(p8);
      a[m][2] = ld_pair(p0 + 8);
      a[m][3] = ld_pair(p8 + 8);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat16* pb = rw + (s * kBC + 32 * cq + 8 * j + g) * kRS16 + 2 * t;
      const uint32_t b0 = ld_pair(pb), b1 = ld_pair(pb + 8);
#pragma unroll
      for (int m = 0; m < 2; ++m) mma_bf16(acc[m][j], a[m], b0, b1);
    }
  }
}

template <int kMode, typename T>
__global__ void __launch_bounds__(kThreads, 2) dgrad_kernel(const DgradArgs p) {
  constexpr bool kExact = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  // fp32: [2][kRawG] raw cotangent stages, [2][kRawW] raw weight stages;
  // bf16: [2][kRawG16], then [2][kRawW16] bf16 values from the same start
  float* rg = smem;
  float* rw = rg + 2 * kRawG;
  __nv_bfloat16* rg16 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* rw16 = rg16 + 2 * kRawG16;

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int tiles_w = (p.W + kTW - 1) / kTW;
  const int ty0 = (blockIdx.x / tiles_w) * kTH;
  const int tx0 = (blockIdx.x % tiles_w) * kTW;
  const int c0 = blockIdx.z * kBC;
  const int C = p.C;
  const int nq = (p.O + kCK - 1) / kCK;

  const int nq16 = (p.O + kCK16 - 1) / kCK16;
  if (kExact) dg16_load_chunk(p, 0, rg16, rw16, b, ty0, tx0, c0, tid);
  else dg_load_chunk(p, 0, rg, rw, b, ty0, tx0, c0, tid);
  cp_commit();
  float* sa = smem + 2 * (kRawG + kRawW);  // the split cotangent plane
  float* sb = sa + kSplitA;                // the split weight plane
  float* s_mean = sb + kSplitB;            // [kBC] each: mean, rstd, gamma, beta (kAct)
  float* s_rstd = s_mean + kBC;
  float* s_gam = s_rstd + kBC;
  float* s_bet = s_gam + kBC;

  if (kMode == kAct && tid < kBC && c0 + tid < C) {
    const int ch = c0 + tid;
    const float cnt = (float)p.H * (float)p.W * (float)(C / p.groups);
    mean_rstd(p.sums, p.sumsq, b, C, ch, p.groups, cnt, p.eps, &s_mean[tid],
              &s_rstd[tid]);
    s_gam[tid] = p.gamma[b * C + ch];
    s_bet[tid] = p.beta[b * C + ch];
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int rg_ = warp & 3, cq = warp >> 2;  // row pair, channel half
  float acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  if (kExact) {
    for (int q = 0; q < nq16; ++q) {
      const int st = q & 1;
      if (q + 1 < nq16)
        dg16_load_chunk(p, q + 1, rg16 + (st ^ 1) * kRawG16, rw16 + (st ^ 1) * kRawW16, b,
                        ty0, tx0, c0, tid);
      cp_commit();
      cp_wait<1>();
      __syncthreads();  // chunk q has landed
      dg16_mma_chunk(rg16 + st * kRawG16, rw16 + st * kRawW16, acc, rg_, cq, lane);
      __syncthreads();  // every warp is done with stage st before it is refilled
    }
  } else {
    for (int q = 0; q < nq; ++q) {
      const int st = q & 1;
      if (q + 1 < nq)
        dg_load_chunk(p, q + 1, rg + (st ^ 1) * kRawG, rw + (st ^ 1) * kRawW, b, ty0,
                      tx0, c0, tid);
      cp_commit();
      cp_wait<1>();
      __syncthreads();  // chunk q has landed; every warp is done with q - 1's planes
      dg_split_g(rg + st * kRawG, sa, tid);
      dg_split_w(rw + st * kRawW, sb, tid);
      __syncthreads();
      dg_mma_chunk(sa, sb, acc, rg_, cq, lane);
    }
  }
  cp_wait<0>();

  // C fragment (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) = pixels
  // tx0 + g (+ 8) of row 2 rg + m, channels 32 cq + 8 j + 2t (+ 1)
  const int g = lane >> 2, t = lane & 3;
  if (kMode == kUpFold) {
    // column x + 1 of pixel x lies 4 lanes on; even g store the pair sum
    // (tx0 is even, and so is W)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int y = ty0 + 2 * rg_ + m;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int k = 0; k < 2; ++k)
            v[j][k] = acc[m][j][2 * h + k] +
                      __shfl_down_sync(0xffffffffu, acc[m][j][2 * h + k], 4);
        const int x = tx0 + g + 8 * h;
        if ((g & 1) || y >= p.H || x >= p.W) continue;
        const size_t pix = ((size_t)b * p.H + y) * (p.W / 2) + x / 2;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + 32 * cq + 8 * j + 2 * t;
          if (c >= C) continue;
          store2(static_cast<float*>(p.out) + pix * C + c, p.pair, c + 1 < C, v[j][0],
                 v[j][1]);
        }
      }
    }
    return;
  }

  float pdg[4][2], pdb[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) pdg[j][0] = pdg[j][1] = pdb[j][0] = pdb[j][1] = 0.f;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int y = ty0 + 2 * rg_ + m;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = tx0 + g + 8 * h;
      if (y >= p.H || x >= p.W) continue;
      const size_t pix = ((size_t)b * p.H + y) * p.W + x;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = 32 * cq + 8 * j + 2 * t, c = c0 + cl;
        if (c >= C) continue;
        const bool two = c + 1 < C;
        float v0 = acc[m][j][2 * h], v1 = acc[m][j][2 * h + 1];
        if (kMode == kAct) {
          float x0, x1;
          load2(static_cast<const T*>(p.x) + pix * C + c, p.pair, two, x0, x1);
          const float xh0 = (x0 - s_mean[cl]) * s_rstd[cl];
          const float a0 = xh0 * s_gam[cl] + s_bet[cl];
          const float sg0 = sigmoid(a0);
          v0 *= sg0 * (1.f + a0 * (1.f - sg0));
          pdg[j][0] += v0 * xh0;
          pdb[j][0] += v0;
          if (two) {
            const float xh1 = (x1 - s_mean[cl + 1]) * s_rstd[cl + 1];
            const float a1 = xh1 * s_gam[cl + 1] + s_bet[cl + 1];
            const float sg1 = sigmoid(a1);
            v1 *= sg1 * (1.f + a1 * (1.f - sg1));
            pdg[j][1] += v1 * xh1;
            pdb[j][1] += v1;
          }
        }
        // bf16: da stored rounded once (dgamma, dbeta above from the fp32 da)
        store2(static_cast<T*>(p.out) + pix * C + c, p.pair, two, v0, v1);
      }
    }
  }

  if (kMode == kAct) {
    // the warp's 32 pixels: sum over g (lane bits 2-4), then the four row
    // pairs in a fixed order; one partial per block and channel
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int sh = 4; sh < 32; sh <<= 1) {
          pdg[j][k] += __shfl_xor_sync(0xffffffffu, pdg[j][k], sh);
          pdb[j][k] += __shfl_xor_sync(0xffffffffu, pdb[j][k], sh);
        }
    __syncthreads();  // every warp is done reading the planes: reuse them
    float* red_g = sa;
    float* red_b = sa + 4 * kBC;
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          red_g[rg_ * kBC + 32 * cq + 8 * j + 2 * t + k] = pdg[j][k];
          red_b[rg_ * kBC + 32 * cq + 8 * j + 2 * t + k] = pdb[j][k];
        }
    }
    __syncthreads();
    if (tid < kBC && c0 + tid < C) {
      float sg = 0.f, sbt = 0.f;
      for (int r = 0; r < 4; ++r) {
        sg += red_g[r * kBC + tid];
        sbt += red_b[r * kBC + tid];
      }
      const size_t tiles = gridDim.x, row = (size_t)b * tiles + blockIdx.x;
      p.part[row * C + c0 + tid] = sg;
      p.part[((size_t)gridDim.y * tiles + row) * C + c0 + tid] = sbt;
    }
  }
}

// ---------------------------------------------------------------------------
// wgrad: M = input channels, N = output channels, K = pixels
// ---------------------------------------------------------------------------

constexpr int kWTH = 4;                        // pixel tile rows
constexpr int kWTW = 16;                       // and columns: a k-step is half a row
constexpr int kWIH = kWTH + 2, kWIW = kWTW + 2;
constexpr int kWPos = kWIH * kWIW;             // halo'd tile positions
constexpr int kWPix = kWTH * kWTW;
constexpr int kWSteps = kWPix / 8;             // k-steps a tile
constexpr int kWLH = kWTH / 2 + 2, kWLW = kWTW / 2 + 2;  // K3's low-res tile
constexpr int kWC = 32, kWO = 32;              // input / output channels a block
constexpr int kWWarps = 9;                     // one a tap
constexpr int kWThreads = 32 * kWWarps;
constexpr int kWRS = kWC + 8;                  // raw floats a position or pixel
constexpr int kWTempSteps = 8;                 // k-steps on the tensor cores per fp32 add

// shared memory, in floats
constexpr int kWRawX = kWPos * kWRS;           // raw x (or K3's low-res x), one stage
constexpr int kWRawG = kWPix * kWRS;           // raw g, one stage
constexpr int kWPlaneA = 2 * kWPos * 32;       // split act(x): [m-tile][position][8 x 4]
constexpr int kWPlaneB = kWSteps * 4 * 32 * 4; // split g: [k-step][n-tile][lane][4]
constexpr int kWAcc = kWWarps * 32 * 32;       // fp32 sums: [warp][8][lane][4]
constexpr int kWSmemFloats = kWRawX + kWRawG + kWPlaneA + kWPlaneB + kWAcc + 2 * kWC;
constexpr size_t kWSmemBytes = sizeof(float) * kWSmemFloats;
static_assert(kWSteps % kWTempSteps == 0, "partials tile a tile");
static_assert(kWPix / kWTW * 2 == kWSteps, "a k-step is half a tile row");

struct WgradArgs {
  const void* x;       // (B, Hin, Win, C) conv input before the activation
  const void* g;       // (B, H, W, O) cotangent of the conv output (x, g fp32 or bf16)
  const float* gamma;  // (B, C) folded scale and shift, unused when act == 0
  const float* beta;
  const float* sums;   // (B, C) the forward's channel sums of x
  const float* sumsq;
  float* part;         // (B * runs, taps * C * O [+ O]): per-run dW [, dbias]
  int H, W, C, O, groups;
  float eps;
  int act, taps, runs, bias, xvec, gvec, pair;
};

// The raw x and g tiles of tile (ty0, tx0) into the stage: x at the halo'd
// positions (K3: the low-res tile under them; one tap: the tile's own
// pixels only), channels c0 .. c0 + 31, and g at the tile's pixels,
// channels o0 .. o0 + 31; zero outside the image, past C and past O.
template <bool kUp>
__device__ __forceinline__ void wg_load_tile(const WgradArgs& p, float* rx, float* rgt,
                                             int b, int ty0, int tx0, int c0, int o0,
                                             int tid) {
  const int C = p.C, O = p.O;
  const int hin = kUp ? p.H / 2 : p.H, win = kUp ? p.W / 2 : p.W;
  const int cols = kUp ? kWLW : kWIW, npos = kUp ? kWLH * kWLW : kWPos;
  const int y0 = kUp ? ty0 / 2 - 1 : ty0 - 1, x0 = kUp ? tx0 / 2 - 1 : tx0 - 1;
  const bool one = p.taps == 1;
  const float* px_ = static_cast<const float*>(p.x);
  const float* xb = px_ + (size_t)b * hin * win * C;
  if (p.xvec) {
    for (int idx = tid; idx < npos * (kWC / 4); idx += kWThreads) {
      const int h = idx % (kWC / 4), pos = idx / (kWC / 4);
      const int iy = pos / cols, ix = pos % cols;
      const int y = y0 + iy, x = x0 + ix, c = c0 + 4 * h;
      const bool halo = one && (iy == 0 || iy == kWIH - 1 || ix == 0 || ix == kWIW - 1);
      const bool valid = !halo && y >= 0 && y < hin && x >= 0 && x < win && c < C;
      cp_async16(rx + pos * kWRS + 4 * h,
                 valid ? xb + ((size_t)y * win + x) * C + c : px_, valid);
    }
  } else {
    for (int idx = tid; idx < npos * kWC; idx += kWThreads) {
      const int k = idx % kWC, pos = idx / kWC;
      const int iy = pos / cols, ix = pos % cols;
      const int y = y0 + iy, x = x0 + ix, c = c0 + k;
      const bool halo = one && (iy == 0 || iy == kWIH - 1 || ix == 0 || ix == kWIW - 1);
      const bool valid = !halo && y >= 0 && y < hin && x >= 0 && x < win && c < C;
      cp_async4(rx + pos * kWRS + k,
                valid ? xb + ((size_t)y * win + x) * C + c : px_, valid);
    }
  }
  const float* gb = static_cast<const float*>(p.g) + (size_t)b * p.H * p.W * O;
  if (p.gvec) {
    for (int idx = tid; idx < kWPix * (kWO / 4); idx += kWThreads) {
      const int h = idx % (kWO / 4), px = idx / (kWO / 4);
      const int y = ty0 + px / kWTW, x = tx0 + px % kWTW, o = o0 + 4 * h;
      const bool valid = y < p.H && x < p.W && o < O;
      cp_async16(rgt + px * kWRS + 4 * h,
                 valid ? gb + ((size_t)y * p.W + x) * O + o : gb, valid);
    }
  } else {
    for (int idx = tid; idx < kWPix * kWO; idx += kWThreads) {
      const int k = idx % kWO, px = idx / kWO;
      const int y = ty0 + px / kWTW, x = tx0 + px % kWTW, o = o0 + k;
      const bool valid = y < p.H && x < p.W && o < O;
      cp_async4(rgt + px * kWRS + k,
                valid ? gb + ((size_t)y * p.W + x) * O + o : gb, valid);
    }
  }
}

// The split pass of one tile. act(x) at every halo'd position (zero outside
// the image, after the activation, and past C) into plane A: (m-tile mt,
// position P) holds at group slot g ^ 2 (P & 3) the values (hi, hi, lo, lo)
// of channels 16 mt + g and 16 mt + g + 8. g into plane B in fragment order;
// the threads below 256 each keep one output channel's sum of g in gsum.
template <bool kUp>
__device__ __forceinline__ void wg_split(const WgradArgs& p, const float* rx,
                                         const float* rgt, float* pa, float* pb,
                                         const float* s_a, const float* s_b, int ty0,
                                         int tx0, int c0, int tid, float& gsum) {
  const bool one = p.taps == 1;
  for (int idx = tid; idx < kWPos * 2 * 8; idx += kWThreads) {
    const int g = idx & 7, mt = (idx >> 3) & 1, pos = idx >> 4;
    const int iy = pos / kWIW, ix = pos % kWIW;
    if (one && (iy == 0 || iy == kWIH - 1 || ix == 0 || ix == kWIW - 1)) continue;
    const int y = ty0 - 1 + iy, x = tx0 - 1 + ix;
    float v0 = 0.f, v1 = 0.f;  // SAME zero padding of the ACTIVATED tensor
    if (y >= 0 && y < p.H && x >= 0 && x < p.W) {
      const int rpos = kUp ? ((y >> 1) - (ty0 / 2 - 1)) * kWLW + (x >> 1) - (tx0 / 2 - 1)
                           : pos;
      const int cl = 16 * mt + g;
      v0 = rx[rpos * kWRS + cl];
      v1 = rx[rpos * kWRS + cl + 8];
      if (p.act) {
        const float t0 = v0 * s_a[cl] + s_b[cl], t1 = v1 * s_a[cl + 8] + s_b[cl + 8];
        v0 = c0 + cl < p.C ? t0 * sigmoid(t0) : 0.f;
        v1 = c0 + cl + 8 < p.C ? t1 * sigmoid(t1) : 0.f;
      }
    }
    store_split(pa + (mt * kWPos + pos) * 32 + 4 * (g ^ ((pos & 3) << 1)), v0, v1);
  }
  if (tid < 256) {
    // entries (k-step, n-tile, lane) = tid + 256 i: each thread keeps one
    // n-tile and lane, so one output channel
    const int j = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < kWSteps / 2; ++i) {
      const int s = (tid >> 7) + 2 * i;
      const float v0 = rgt[(8 * s + t) * kWRS + 8 * j + g];
      const float v1 = rgt[(8 * s + t + 4) * kWRS + 8 * j + g];
      gsum += v0 + v1;
      store_split(pb + ((s * 4 + j) * 32 + lane) * 4, v0, v1);
    }
  }
}

// One k-step of one tap on the warp's 2 m-tiles x 4 n-tiles into part: the
// three products, each over the tiles in turn.
__device__ __forceinline__ void wg_mma_step(const float* pa, const float* pb,
                                            float (&part)[2][4][4], int s, int dy,
                                            int dx, int lane) {
  const int g = lane >> 2, t = lane & 3;
  // pixels t and t + 4 of the k-step: row s / 2, columns 8 (s & 1) + t (+ 4)
  const int p0 = ((s >> 1) + dy) * kWIW + 8 * (s & 1) + t + dx, p4 = p0 + 4;
  const int sw = 4 * (g ^ ((p0 & 3) << 1));  // p4 & 3 == p0 & 3
  AFrag a[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float4 f0 = *reinterpret_cast<const float4*>(pa + (m * kWPos + p0) * 32 + sw);
    const float4 f4 = *reinterpret_cast<const float4*>(pa + (m * kWPos + p4) * 32 + sw);
    a[m].hi[0] = __float_as_uint(f0.x);  // (c_g, pixel t)
    a[m].hi[1] = __float_as_uint(f0.y);  // (c_g+8, pixel t)
    a[m].hi[2] = __float_as_uint(f4.x);  // (c_g, pixel t + 4)
    a[m].hi[3] = __float_as_uint(f4.y);  // (c_g+8, pixel t + 4)
    a[m].lo[0] = __float_as_uint(f0.z);
    a[m].lo[1] = __float_as_uint(f0.w);
    a[m].lo[2] = __float_as_uint(f4.z);
    a[m].lo[3] = __float_as_uint(f4.w);
  }
  uint32_t bh[4][2], bl[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 f = *reinterpret_cast<const float4*>(pb + ((s * 4 + j) * 32 + lane) * 4);
    bh[j][0] = __float_as_uint(f.x);
    bh[j][1] = __float_as_uint(f.y);
    bl[j][0] = __float_as_uint(f.z);
    bl[j][1] = __float_as_uint(f.w);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int m = 0; m < 2; ++m) mma_tf32(part[m][j], a[m].lo, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int m = 0; m < 2; ++m) mma_tf32(part[m][j], a[m].hi, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int m = 0; m < 2; ++m) mma_tf32(part[m][j], a[m].hi, bh[j][0], bh[j][1]);
}

// sum += part in the thread's own fp32 slots ([8][lane][4] floats of its
// warp: entry 4 q + e of the flattened [m][j][e]), then part = 0
__device__ __forceinline__ void wg_flush(float* sacc, float (&part)[2][4][4], int lane) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float4* s = reinterpret_cast<float4*>(sacc + ((m * 4 + j) * 32 + lane) * 4);
      float4 v = *s;
      v.x += part[m][j][0];
      v.y += part[m][j][1];
      v.z += part[m][j][2];
      v.w += part[m][j][3];
      *s = v;
#pragma unroll
      for (int e = 0; e < 4; ++e) part[m][j][e] = 0.f;
    }
}

// The run's partial dW from the warps' fp32 sums in sacc ([warp][8][lane][4]
// floats, entry 4 q + e of the flattened [m][j][e]), and dbias from the sums
// of g: fp32, the threads below 256 each hold one output channel's in gsum
// (two threads 128 apart a channel, each over its lanes t = 0..3); bf16, the
// threads below kWO each hold one channel's whole sum. red: kWO * 2 free floats.
template <bool kBf16>
__device__ __forceinline__ void wg_store(const WgradArgs& p, float* sacc, float* red, int b,
                                         int run, int c0, int o0, int tid, float gsum) {
  const int C = p.C, O = p.O, warp = tid >> 5, lane = tid & 31;
  const bool one = p.taps == 1;
  float* my_acc = sacc + warp * 32 * 32;
  // the run's partial dW: entry (m, j, e) of a lane is channel c0 + 16 m + g
  // (+ 8 for e >= 2) and output o0 + 8 j + 2t (+ 1 for odd e)
  float* out = p.part + (size_t)(b * p.runs + run) *
                            ((size_t)p.taps * C * O + (p.bias ? O : 0));
  if (one) {
    // the nine warps' sums of the same outputs, added in warp order
    __syncthreads();
    if (tid < 2 * 4 * 32) {
      float4 v = *reinterpret_cast<const float4*>(sacc + tid * 4);
      for (int w = 1; w < kWWarps; ++w) {
        const float4 u = *reinterpret_cast<const float4*>(sacc + w * 1024 + tid * 4);
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      *reinterpret_cast<float4*>(sacc + tid * 4) = v;
    }
    __syncthreads();
  }
  if (!one || warp == 0) {
    const int g = lane >> 2, t = lane & 3;
    const int tap = one ? 0 : warp;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(my_acc + ((m * 4 + j) * 32 + lane) * 4);
        const int o = o0 + 8 * j + 2 * t;
        if (o >= O) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = c0 + 16 * m + g + 8 * h;
          if (c >= C) continue;
          float* dst = out + ((size_t)tap * C + c) * O + o;
          const float v0 = h ? v.z : v.x, v1 = h ? v.w : v.y;
          if (p.pair) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            dst[0] = v0;
            if (o + 1 < O) dst[1] = v1;
          }
        }
      }
  }
  if (p.bias && c0 == 0) {
    float total = gsum;
    if (!kBf16) {
      // the sums of one output channel are held by the lanes t = 0..3 of two
      // threads 128 apart; add them in a fixed order
      gsum += __shfl_xor_sync(0xffffffffu, gsum, 1);
      gsum += __shfl_xor_sync(0xffffffffu, gsum, 2);
      __syncthreads();
      if (tid < 256 && (tid & 3) == 0)
        red[(tid >> 7) * 32 + ((tid >> 5) & 3) * 8 + ((tid & 31) >> 2)] = gsum;
      __syncthreads();
      if (tid < kWO) total = red[tid] + red[32 + tid];
    }
    if (tid < kWO && o0 + tid < O) out[(size_t)p.taps * C * O + o0 + tid] = total;
  }
}

template <bool kUp>
__global__ void __launch_bounds__(kWThreads, 2) wgrad_kernel(const WgradArgs p) {
  extern __shared__ __align__(16) float smem[];
  float* rx = smem;              // raw x stage
  float* rgt = rx + kWRawX;      // raw g stage
  float* pa = rgt + kWRawG;      // split act(x)
  float* pb = pa + kWPlaneA;     // split g
  float* sacc = pb + kWPlaneB;   // fp32 sums, kWarps x 32 x 32
  float* s_a = sacc + kWAcc;     // [kWC] folded per-channel scale
  float* s_b = s_a + kWC;        // and shift

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C = p.C, O = p.O;
  const int oslices = (O + kWO - 1) / kWO, cslices = (C + kWC - 1) / kWC;
  int blk = blockIdx.x;
  const int o0 = (blk % oslices) * kWO;
  blk /= oslices;
  const int c0 = (blk % cslices) * kWC;
  blk /= cslices;
  const int run = blk % p.runs, b = blk / p.runs;
  const int tiles_w = (p.W + kWTW - 1) / kWTW;
  const int tiles = ((p.H + kWTH - 1) / kWTH) * tiles_w;
  const int per = (tiles + p.runs - 1) / p.runs;
  const int t_begin = run * per, t_end = min(tiles, t_begin + per);

  if (t_begin < t_end)
    wg_load_tile<kUp>(p, rx, rgt, b, (t_begin / tiles_w) * kWTH,
                      (t_begin % tiles_w) * kWTW, c0, o0, tid);
  cp_commit();

  if (p.act && tid < kWC) {
    // fold the statistics into one scale/shift per input channel
    float a = 0.f, sh = 0.f;
    if (c0 + tid < C) {
      const int hin = kUp ? p.H / 2 : p.H, win = kUp ? p.W / 2 : p.W;
      const float cnt = (float)hin * (float)win * (float)(C / p.groups);
      float mean, rstd;
      mean_rstd(p.sums, p.sumsq, b, C, c0 + tid, p.groups, cnt, p.eps, &mean, &rstd);
      a = p.gamma[b * C + c0 + tid] * rstd;
      sh = p.beta[b * C + c0 + tid] - a * mean;
    }
    s_a[tid] = a;
    s_b[tid] = sh;
  }
  float* my_acc = sacc + warp * 32 * 32;
  for (int i = lane * 4; i < 32 * 32; i += 32 * 4)
    *reinterpret_cast<float4*>(my_acc + i) = make_float4(0.f, 0.f, 0.f, 0.f);

  const bool one = p.taps == 1;
  const int dy = one ? 1 : warp / 3, dx = one ? 1 : warp % 3;
  float part[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[m][j][e] = 0.f;
  float gsum = 0.f;
  int kbase = 0;  // k-steps of the run before this tile

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int ty0 = (tile / tiles_w) * kWTH, tx0 = (tile % tiles_w) * kWTW;
    cp_wait<0>();
    __syncthreads();  // the tile has landed; every warp is done with the planes
    wg_split<kUp>(p, rx, rgt, pa, pb, s_a, s_b, ty0, tx0, c0, tid, gsum);
    __syncthreads();  // the planes are ready; the raw stage is free
    if (tile + 1 < t_end)
      wg_load_tile<kUp>(p, rx, rgt, b, ((tile + 1) / tiles_w) * kWTH,
                        ((tile + 1) % tiles_w) * kWTW, c0, o0, tid);
    cp_commit();
    const int nsteps = 2 * min(kWTH, p.H - ty0);  // rows past the image add nothing
    // a partial ends with its run of kWTempSteps k-steps of the tile, so it
    // is zero (not live) through the split pass
#pragma unroll 1
    for (int s0 = 0; s0 < nsteps; s0 += kWTempSteps) {
#pragma unroll 1
      for (int s = s0; s < min(s0 + kWTempSteps, nsteps); ++s) {
        if (one && (kbase + s) % kWWarps != warp) continue;  // one tap: round the warps
        wg_mma_step(pa, pb, part, s, dy, dx, lane);
      }
      wg_flush(my_acc, part, lane);
    }
    kbase += nsteps;
  }
  cp_wait<0>();

  wg_store<false>(p, sacc, pa, b, run, c0, o0, tid, gsum);
}


// ---------------------------------------------------------------------------
// wgrad in bf16: bf16 mma.sync.m16n8k16 with ldmatrix.trans fragments
// ---------------------------------------------------------------------------
//
// The same GEMM (M = 32 input channels, N = 32 output channels a block, K =
// the pixels; warp w tap w, or for one tap the k-steps dealt round the
// warps), one k-step a tile row of 16 pixels. Both operands lie in shared
// memory as [pixel][channel] rows of bf16 (40 values, 80 bytes, so the eight
// rows of an 8 x 8 matrix fall on distinct banks), and ldmatrix.trans turns
// each 8 x 8 block into the fragment that pairs two pixels of one channel:
// A (channel, pixel) from the activated tile at the tap's shifted pixels, B
// (pixel, o) from the raw cotangent tile. The activation pass (GroupNorm and
// SiLU in fp32, rounded to bf16; zero outside the image) is the only pass
// over a tile; the linear mode reads the raw x tile itself. Raw tiles are
// double-buffered, so tile i + 1 lands while tile i is multiplied; the sums
// stay in registers. Per-thread sums of g give dbias (threads below kWO, one
// output channel each, in pixel order).
constexpr int kW16Pos = kWPos * kWRS;  // bf16 values of an activated or raw x tile
constexpr int kW16Pix = kWPix * kWRS;  // of a raw g tile
constexpr size_t kW16SmemBytes =
    2 * (2 * (kW16Pos + kW16Pix) + kW16Pos) + 4 * (kWAcc + 4 * kWC);

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// The raw bf16 tiles of tile (ty0, tx0) into a stage, as wg_load_tile's fp32
// ones: kWRS values a position (pixel), 16 bytes (eight values) a copy where
// C (O) % 8 == 0, element loads otherwise; zero outside the image, past C
// and past O.
template <bool kUp>
__device__ __forceinline__ void wg_load_tile(const WgradArgs& p, __nv_bfloat16* rx,
                                             __nv_bfloat16* rgt, int b, int ty0, int tx0,
                                             int c0, int o0, int tid) {
  const int C = p.C, O = p.O;
  const int hin = kUp ? p.H / 2 : p.H, win = kUp ? p.W / 2 : p.W;
  const int cols = kUp ? kWLW : kWIW, npos = kUp ? kWLH * kWLW : kWPos;
  const int y0 = kUp ? ty0 / 2 - 1 : ty0 - 1, x0 = kUp ? tx0 / 2 - 1 : tx0 - 1;
  const bool one = p.taps == 1;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(p.x) + (size_t)b * hin * win * C;
  const int xper = p.xvec ? kWC / 8 : kWC;  // copies a position
  for (int idx = tid; idx < npos * xper; idx += kWThreads) {
    const int h = idx % xper, pos = idx / xper;
    const int iy = pos / cols, ix = pos % cols;
    const int y = y0 + iy, x = x0 + ix, c = c0 + (p.xvec ? 8 * h : h);
    const bool halo = one && (iy == 0 || iy == kWIH - 1 || ix == 0 || ix == kWIW - 1);
    const bool valid = !halo && y >= 0 && y < hin && x >= 0 && x < win && c < C;
    const __nv_bfloat16* src = xb + ((size_t)y * win + x) * C + c;
    if (p.xvec) cp_async16(rx + pos * kWRS + 8 * h, valid ? src : xb, valid);
    else rx[pos * kWRS + h] = valid ? *src : zero;
  }
  const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(p.g) + (size_t)b * p.H * p.W * O;
  const int gper = p.gvec ? kWO / 8 : kWO;
  for (int idx = tid; idx < kWPix * gper; idx += kWThreads) {
    const int h = idx % gper, px = idx / gper;
    const int y = ty0 + px / kWTW, x = tx0 + px % kWTW, o = o0 + (p.gvec ? 8 * h : h);
    const bool valid = y < p.H && x < p.W && o < O;
    const __nv_bfloat16* src = gb + ((size_t)y * p.W + x) * O + o;
    if (p.gvec) cp_async16(rgt + px * kWRS + 8 * h, valid ? src : gb, valid);
    else rgt[px * kWRS + h] = valid ? *src : zero;
  }
}

// The activated tile: act(x) at every halo'd position of the output tile (K3:
// of the upsampled low-res tile), zero outside the image and past C, rounded
// to bf16; K2 in _act_from_x's form, K3 in the folded form, two channels a
// thread-item.
template <bool kUp>
__device__ __forceinline__ void wg16_activate(const WgradArgs& p, const __nv_bfloat16* rx,
                                              __nv_bfloat16* act, const float* s_a,
                                              const float* s_b, const float* s_m,
                                              const float* s_r, int ty0, int tx0, int c0,
                                              int tid) {
  for (int idx = tid; idx < kWPos * kWC / 2; idx += kWThreads) {
    const int cl = 2 * (idx % (kWC / 2)), pos = idx / (kWC / 2);
    const int iy = pos / kWIW, ix = pos % kWIW;
    const int y = ty0 - 1 + iy, x = tx0 - 1 + ix;
    float v[2] = {0.f, 0.f};
    if (y >= 0 && y < p.H && x >= 0 && x < p.W) {
      const int rpos = kUp ? ((y >> 1) - (ty0 / 2 - 1)) * kWLW + (x >> 1) - (tx0 / 2 - 1)
                           : pos;
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(rx + rpos * kWRS + cl));
      const float xs[2] = {xv.x, xv.y};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int c = cl + k;
        const float t = kUp ? xs[k] * s_a[c] + s_b[c]
                            : ((xs[k] - s_m[c]) * s_r[c]) * s_a[c] + s_b[c];
        v[k] = c0 + c < p.C ? t * sigmoid(t) : 0.f;
      }
    }
    *reinterpret_cast<__nv_bfloat162*>(act + pos * kWRS + cl) = __floats2bfloat162_rn(v[0], v[1]);
  }
}

template <bool kUp>
__global__ void __launch_bounds__(kWThreads, 2) wgrad_bf16_kernel(const WgradArgs p) {
  extern __shared__ __align__(16) float smem[];
  __nv_bfloat16* rx = reinterpret_cast<__nv_bfloat16*>(smem);  // [2] raw x stages
  __nv_bfloat16* rgt = rx + 2 * kW16Pos;                        // [2] raw g stages
  __nv_bfloat16* act = rgt + 2 * kW16Pix;                       // the activated tile
  float* sacc = reinterpret_cast<float*>(act + kW16Pos);        // the warps' sums
  float* s_a = sacc + kWAcc;  // [kWC] K2: gamma, K3: the folded scale
  float* s_b = s_a + kWC;     // K2: beta, K3: the folded shift
  float* s_m = s_b + kWC;     // K2: mean
  float* s_r = s_m + kWC;     // K2: rstd

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int C = p.C, O = p.O;
  const int oslices = (O + kWO - 1) / kWO, cslices = (C + kWC - 1) / kWC;
  int blk = blockIdx.x;
  const int o0 = (blk % oslices) * kWO;
  blk /= oslices;
  const int c0 = (blk % cslices) * kWC;
  blk /= cslices;
  const int run = blk % p.runs, b = blk / p.runs;
  const int tiles_w = (p.W + kWTW - 1) / kWTW;
  const int tiles = ((p.H + kWTH - 1) / kWTH) * tiles_w;
  const int per = (tiles + p.runs - 1) / p.runs;
  const int t_begin = run * per, t_end = min(tiles, t_begin + per);

  if (t_begin < t_end)
    wg_load_tile<kUp>(p, rx, rgt, b, (t_begin / tiles_w) * kWTH,
                      (t_begin % tiles_w) * kWTW, c0, o0, tid);
  cp_commit();

  if (p.act && tid < kWC) {
    float a = 0.f, sh = 0.f, mean = 0.f, rstd = 0.f;
    if (c0 + tid < C) {
      const int hin = kUp ? p.H / 2 : p.H, win = kUp ? p.W / 2 : p.W;
      const float cnt = (float)hin * (float)win * (float)(C / p.groups);
      mean_rstd(p.sums, p.sumsq, b, C, c0 + tid, p.groups, cnt, p.eps, &mean, &rstd);
      a = p.gamma[b * C + c0 + tid];
      sh = p.beta[b * C + c0 + tid];
      if (kUp) {  // folded, as _up_pair_bwd_kernel
        sh -= a * rstd * mean;
        a *= rstd;
      }
    }
    s_a[tid] = a;
    s_b[tid] = sh;
    s_m[tid] = mean;
    s_r[tid] = rstd;
  }

  const bool one = p.taps == 1;
  const int dy = one ? 1 : warp / 3, dx = one ? 1 : warp % 3;
  const int mat = lane >> 3, mi = lane & 7;  // the ldmatrix row this lane addresses
  float acc[2][4][4] = {};
  float gsum = 0.f;
  int kbase = 0;  // k-steps of the run before this tile

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int st = (tile - t_begin) & 1;
    const int ty0 = (tile / tiles_w) * kWTH, tx0 = (tile % tiles_w) * kWTW;
    if (tile + 1 < t_end)
      wg_load_tile<kUp>(p, rx + (st ^ 1) * kW16Pos, rgt + (st ^ 1) * kW16Pix, b,
                        ((tile + 1) / tiles_w) * kWTH, ((tile + 1) % tiles_w) * kWTW, c0,
                        o0, tid);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // tile's raw stages have landed
    const __nv_bfloat16* xs = rx + st * kW16Pos;
    const __nv_bfloat16* gs = rgt + st * kW16Pix;
    if (p.act) {
      wg16_activate<kUp>(p, xs, act, s_a, s_b, s_m, s_r, ty0, tx0, c0, tid);
      __syncthreads();
      xs = act;
    }
    const int nsteps = min(kWTH, p.H - ty0);  // rows past the image add nothing
    if (tid < kWO) {
      for (int px = 0; px < nsteps * kWTW; ++px) gsum += to_f(gs[px * kWRS + tid]);
    }
#pragma unroll 1
    for (int s = 0; s < nsteps; ++s) {
      if (one && (kbase + s) % kWWarps != warp) continue;  // one tap: round the warps
      // A rows: pixel mi + 8 (mat >> 1) of row s shifted by the tap, channels
      // 16 m + 8 (mat & 1); B rows: pixel mi + 8 (mat & 1) of row s, outputs
      // 8 (2 jj + (mat >> 1))
      uint32_t a[2][4], bb[2][4];
      const int apos = (s + dy) * kWIW + mi + 8 * (mat >> 1) + dx;
#pragma unroll
      for (int m = 0; m < 2; ++m)
        ldsm_x4_trans(a[m], xs + apos * kWRS + 16 * m + 8 * (mat & 1));
      const int bpix = s * kWTW + mi + 8 * (mat & 1);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        ldsm_x4_trans(bb[jj], gs + bpix * kWRS + 8 * (2 * jj + (mat >> 1)));
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          mma_bf16(acc[m][2 * jj], a[m], bb[jj][0], bb[jj][1]);
          mma_bf16(acc[m][2 * jj + 1], a[m], bb[jj][2], bb[jj][3]);
        }
    }
    kbase += nsteps;
    __syncthreads();  // every warp is done with this tile's stages
  }
  cp_wait<0>();

  float* my_acc = sacc + warp * 32 * 32;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(my_acc + ((m * 4 + j) * 32 + lane) * 4) =
          make_float4(acc[m][j][0], acc[m][j][1], acc[m][j][2], acc[m][j][3]);
  wg_store<true>(p, sacc, s_a, b, run, c0, o0, tid, gsum);
}

// ---------------------------------------------------------------------------
// wgrad at C <= kNC (conv_in): bytes, not products, set its time
// ---------------------------------------------------------------------------

constexpr int kNC = 8;                         // the widest narrow C
constexpr int kNTH = 8;                        // pixel tile rows
constexpr int kNTW = 32;                       // and columns
constexpr int kNIH = kNTH + 2, kNIW = kNTW + 2;
constexpr int kNO = 64;                        // output channels a block
constexpr int kNGroups = kNTH / 2;             // pixel groups of two tile rows
constexpr int kNThreads = kNO * kNGroups;

// A thread owns one output channel and two rows of each tile of its run,
// with all 9 x CP weights of its channel in registers: it reads g once,
// coalesced across the warp (32 channels of one pixel), and slides a 3 x 3
// window of act(x) (CP channels a position, read from shared memory as a
// broadcast) along its rows. The four pixel groups' sums are added in a
// fixed order at the end of the run.
template <int CP, typename T>  // C rounded up to 4 or 8; T the element type
__global__ void __launch_bounds__(kNThreads) wgrad_narrow_kernel(const WgradArgs p) {
  __shared__ __align__(16) float xs[kNIH * kNIW * CP];  // act(x), the halo'd tile
  __shared__ float red[(9 * CP + 1) * kNO];             // the run's sums, then dbias
  __shared__ float s_a[kNC], s_b[kNC];
  const int tid = threadIdx.x, ol = tid % kNO, pg = tid / kNO;
  const int C = p.C, O = p.O;
  const int oblocks = (O + kNO - 1) / kNO;
  int blk = blockIdx.x;
  const int o = (blk % oblocks) * kNO + ol;
  blk /= oblocks;
  const int run = blk % p.runs, b = blk / p.runs;
  const int tiles_w = (p.W + kNTW - 1) / kNTW;
  const int tiles = ((p.H + kNTH - 1) / kNTH) * tiles_w;
  const int per = (tiles + p.runs - 1) / p.runs;
  if (p.act && tid < C) {
    const float cnt = (float)p.H * (float)p.W * (float)(C / p.groups);
    float mean, rstd;
    mean_rstd(p.sums, p.sumsq, b, C, tid, p.groups, cnt, p.eps, &mean, &rstd);
    s_a[tid] = p.gamma[b * C + tid] * rstd;
    s_b[tid] = p.beta[b * C + tid] - s_a[tid] * mean;
  }
  float acc[9][CP], gsum = 0.f;
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int c = 0; c < CP; ++c) acc[t][c] = 0.f;
  const T* xb = static_cast<const T*>(p.x) + (size_t)b * p.H * p.W * C;
  const T* gb = static_cast<const T*>(p.g) + (size_t)b * p.H * p.W * O + o;
  for (int tile = run * per; tile < min(tiles, (run + 1) * per); ++tile) {
    const int ty0 = (tile / tiles_w) * kNTH, tx0 = (tile % tiles_w) * kNTW;
    __syncthreads();  // s_a / s_b are set; every thread is done with the last tile
    for (int idx = tid; idx < kNIH * kNIW * CP; idx += kNThreads) {
      const int c = idx % CP, pos = idx / CP;
      const int y = ty0 - 1 + pos / kNIW, x = tx0 - 1 + pos % kNIW;
      float v = 0.f;  // SAME zero padding of the ACTIVATED tensor
      if (y >= 0 && y < p.H && x >= 0 && x < p.W && c < C) {
        v = to_f(xb[((size_t)y * p.W + x) * C + c]);
        if (p.act) {  // fp32 only: the bf16 instance takes the linear mode
          const float t = v * s_a[c] + s_b[c];
          v = t * sigmoid(t);
        }
      }
      xs[idx] = v;
    }
    __syncthreads();
#pragma unroll 1
    for (int r = 2 * pg; r < 2 * pg + 2; ++r) {
      const int y = ty0 + r;
      if (y >= p.H) break;
      float win[3][3][CP];  // rows r .. r + 2 of the halo, columns x .. x + 2
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 1; dx < 3; ++dx)
#pragma unroll
          for (int c = 0; c < CP; ++c) win[dy][dx][c] = xs[((r + dy) * kNIW + dx - 1) * CP + c];
#pragma unroll
      for (int xx = 0; xx < kNTW; ++xx) {
        const int x = tx0 + xx;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int c = 0; c < CP; ++c) {
            win[dy][0][c] = win[dy][1][c];
            win[dy][1][c] = win[dy][2][c];
            win[dy][2][c] = xs[((r + dy) * kNIW + xx + 2) * CP + c];
          }
        const float gv = (x < p.W && o < O) ? to_f(gb[((size_t)y * p.W + x) * O]) : 0.f;
        gsum += gv;
#pragma unroll
        for (int t = 0; t < 9; ++t)
#pragma unroll
          for (int c = 0; c < CP; ++c) acc[t][c] = fmaf(win[t / 3][t % 3][c], gv, acc[t][c]);
      }
    }
  }
  // the pixel groups' sums, added in group order
  for (int q = 0; q < kNGroups; ++q) {
    __syncthreads();
    if (pg == q) {
#pragma unroll
      for (int t = 0; t < 9; ++t)
#pragma unroll
        for (int c = 0; c < CP; ++c) {
          float* r = &red[(t * CP + c) * kNO + ol];
          *r = q ? *r + acc[t][c] : acc[t][c];
        }
      red[9 * CP * kNO + ol] = q ? red[9 * CP * kNO + ol] + gsum : gsum;
    }
  }
  __syncthreads();
  if (o < O) {
    float* out = p.part + (size_t)(b * p.runs + run) * ((size_t)9 * C * O + (p.bias ? O : 0));
    for (int k = pg; k < 9 * C; k += kNGroups) {
      const int t = k / C, c = k % C;
      out[(size_t)k * O + o] = red[(t * CP + c) * kNO + ol];
    }
    if (p.bias && pg == 0) out[(size_t)9 * C * O + o] = red[9 * CP * kNO + ol];
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// above 48 KB of dynamic shared memory a kernel must opt in, once per process
template <typename T>
cudaError_t configure_dgrad() {
  cudaError_t e = allow_smem(dgrad_kernel<kLinear, T>, kDSmemBytes);
  if (e == cudaSuccess) e = allow_smem(dgrad_kernel<kAct, T>, kDSmemBytes);
  if (e == cudaSuccess) e = allow_smem(dgrad_kernel<kUpFold, T>, kDSmemBytes);
  return e;
}

cudaError_t configure() {
  static cudaError_t err = [] {
    cudaError_t e = configure_dgrad<float>();
    if (e == cudaSuccess) e = configure_dgrad<__nv_bfloat16>();
    if (e == cudaSuccess) e = allow_smem(wgrad_kernel<false>, kWSmemBytes);
    if (e == cudaSuccess) e = allow_smem(wgrad_kernel<true>, kWSmemBytes);
    if (e == cudaSuccess) e = allow_smem(wgrad_bf16_kernel<false>, kW16SmemBytes);
    if (e == cudaSuccess) e = allow_smem(wgrad_bf16_kernel<true>, kW16SmemBytes);
    return e;
  }();
  return err;
}

// the dgrad launch for either element type (mc_conv_dgrad's arguments)
template <typename T>
int conv_dgrad(const T* g, const T* w, const T* x, const float* gamma, const float* beta,
               const float* sums, const float* sumsq, void* out, float* dstats, float* part,
               int batch, int h, int wd, int c, int o, int groups, float eps, int mode,
               void* stream) {
  if (batch < 1 || h < 1 || wd < 1 || c < 1 || o < 1 || mode < kLinear ||
      mode > kUpFold || (mode == kUpFold && (wd % 2)) ||
      (mode == kAct && (!dstats || !part || groups < 1 || c % groups)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  constexpr int esz = sizeof(T);
  // 16-byte copies: four fp32 or eight bf16 values
  const int vec_o = 16 / esz;
  const bool pair = c % 2 == 0 && aligned(out, mode == kUpFold ? 8 : 2 * esz) &&
                    (mode != kAct || aligned(x, 2 * esz));
  DgradArgs p{g, w, x, gamma, beta, sums, sumsq, out, part, h, wd, c, o,
              groups, eps, o % vec_o == 0 && aligned(g, 16), o % vec_o == 0 && aligned(w, 16),
              (int)pair};
  const int tiles = dgrad_tiles(h, wd);
  dim3 grid(tiles, batch, (c + kBC - 1) / kBC);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kLinear) dgrad_kernel<kLinear, T><<<grid, kThreads, kDSmemBytes, s>>>(p);
  else if (mode == kAct) dgrad_kernel<kAct, T><<<grid, kThreads, kDSmemBytes, s>>>(p);
  else dgrad_kernel<kUpFold, T><<<grid, kThreads, kDSmemBytes, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || mode != kAct) return (int)err;
  colsum_kernel<<<dim3((c + 31) / 32, 2 * batch), 32 * kSumGroups, 0, s>>>(part, dstats,
                                                                         tiles, c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Pixel tiles per image of the dgrad kernel (which = 0; h, w the
// cotangent's) and of the wgrad kernel (which = 1; 2: its narrow-C form).
// The dgrad scratch is (2, batch, tiles, c).
int mc_conv_bwd_tiles(int h, int wd, int which) {
  if (which == 0) return dgrad_tiles(h, wd);
  if (which == 2) return ((h + kNTH - 1) / kNTH) * ((wd + kNTW - 1) / kNTW);
  return ((h + kWTH - 1) / kWTH) * ((wd + kWTW - 1) / kWTW);
}

bool wgrad_narrow(int c, int taps, int up) { return c <= kNC && taps == 9 && !up; }

// Pixel-tile runs per image for mc_conv_wgrad: about `blocks` blocks in all
// (one wave), at most one tile a run. The wgrad scratch is then (batch *
// runs, taps c o [+ o]) floats.
int mc_conv_wgrad_runs(int batch, int h, int wd, int c, int o, int taps, int up,
                       int blocks) {
  const bool narrow = wgrad_narrow(c, taps, up);
  const int per_run = narrow ? (o + kNO - 1) / kNO
                             : ((c + kWC - 1) / kWC) * ((o + kWO - 1) / kWO);
  const int tiles = mc_conv_bwd_tiles(h, wd, narrow ? 2 : 1);
  const int runs = blocks / (batch * per_run);
  return runs < 1 ? 1 : (runs > tiles ? tiles : runs);
}

// h, w: the cotangent's height and width (K3: the high resolution).
// mode 0: da = conv3x3^T(g) (linear); 1: da = conv3x3^T(g) * silu'(a), with
// dstats (2, batch, c) = (dgamma, dbeta) summed from the per-tile scratch
// part; 2: conv3x3^T(g) with column pairs added, out (B, h, w / 2, c).
int mc_conv_dgrad(const float* g, const float* w, const float* x,
                  const float* gamma, const float* beta, const float* sums,
                  const float* sumsq, float* out, float* dstats, float* part,
                  int batch, int h, int wd, int c, int o, int groups, float eps,
                  int mode, void* stream) {
  return conv_dgrad(g, w, x, gamma, beta, sums, sumsq, out, dstats, part, batch, h, wd, c,
                    o, groups, eps, mode, stream);
}

// The bf16 instance: g, w, x bf16; out bf16 in modes 0 and 1 (da rounded
// once), fp32 in mode 2; the vectors, dstats and part fp32.
int mc_conv_dgrad_bf16(const __nv_bfloat16* g, const __nv_bfloat16* w,
                       const __nv_bfloat16* x, const float* gamma, const float* beta,
                       const float* sums, const float* sumsq, void* out, float* dstats,
                       float* part, int batch, int h, int wd, int c, int o, int groups,
                       float eps, int mode, void* stream) {
  return conv_dgrad(g, w, x, gamma, beta, sums, sumsq, out, dstats, part, batch, h, wd, c,
                    o, groups, eps, mode, stream);
}

// h, w: the cotangent's (output's) height and width; x is (B, h, w, c), or
// (B, h / 2, w / 2, c) with up = 1. dwb: dW (taps, c, o), then dbias (o)
// when bias = 1; part: the (batch * runs, taps c o [+ o]) scratch, runs:
// pixel-tile runs per image (from mc_conv_wgrad_runs). At c <= 8 (3 x 3,
// not up) the narrow-C kernel runs, else the tensor-core one.
}  // extern "C"

// the wgrad launch for either element type (mc_conv_wgrad's arguments)
template <typename T>
int conv_wgrad(const T* x, const T* g, const float* gamma, const float* beta,
               const float* sums, const float* sumsq, float* dwb, float* part, int batch,
               int h, int wd, int c, int o, int groups, float eps, int act, int taps, int up,
               int bias, int runs, void* stream) {
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  const bool narrow_c = wgrad_narrow(c, taps, up);
  if (batch < 1 || h < 1 || wd < 1 || c < 1 || o < 1 || (taps != 9 && taps != 1) ||
      runs < 1 || runs > mc_conv_bwd_tiles(h, wd, narrow_c ? 2 : 1) ||
      (up && (h % 2 || wd % 2)) ||
      (up && taps != 9) || (act && (groups < 1 || c % groups)) || !dwb || !part ||
      (kBf16 && narrow_c && act))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  const size_t k = (size_t)taps * c * o + (bias ? o : 0);
  // 16-byte copies: four fp32 or eight bf16 values
  const int vec = 16 / (int)sizeof(T);
  WgradArgs p{x, g, gamma, beta, sums, sumsq, part, h, wd, c, o, groups, eps,
              act, taps, runs, bias, c % vec == 0 && aligned(x, 16),
              o % vec == 0 && aligned(g, 16), o % 2 == 0 && aligned(part, 8) && k % 2 == 0};
  cudaStream_t s = (cudaStream_t)stream;
  if (narrow_c) {
    dim3 grid(batch * runs * ((o + kNO - 1) / kNO));
    if (c <= 4) wgrad_narrow_kernel<4, T><<<grid, kNThreads, 0, s>>>(p);
    else wgrad_narrow_kernel<8, T><<<grid, kNThreads, 0, s>>>(p);
  } else {
    dim3 grid(batch * runs * ((c + kWC - 1) / kWC) * ((o + kWO - 1) / kWO));
    if (kBf16 && up) wgrad_bf16_kernel<true><<<grid, kWThreads, kW16SmemBytes, s>>>(p);
    else if (kBf16) wgrad_bf16_kernel<false><<<grid, kWThreads, kW16SmemBytes, s>>>(p);
    else if (up) wgrad_kernel<true><<<grid, kWThreads, kWSmemBytes, s>>>(p);
    else wgrad_kernel<false><<<grid, kWThreads, kWSmemBytes, s>>>(p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  colsum_kernel<<<dim3((unsigned)((k + 31) / 32), 1), 32 * kSumGroups, 0, s>>>(
      part, dwb, batch * runs, (int)k);
  return (int)cudaGetLastError();
}

extern "C" {

int mc_conv_wgrad(const float* x, const float* g, const float* gamma,
                  const float* beta, const float* sums, const float* sumsq,
                  float* dwb, float* part, int batch, int h, int wd, int c, int o,
                  int groups, float eps, int act, int taps, int up, int bias,
                  int runs, void* stream) {
  return conv_wgrad(x, g, gamma, beta, sums, sumsq, dwb, part, batch, h, wd, c, o, groups,
                    eps, act, taps, up, bias, runs, stream);
}

// The bf16 instance: x and g bf16; the vectors, dwb and part fp32. At
// c <= 8 (the narrow-C kernel) it takes the linear mode only (act = 0).
int mc_conv_wgrad_bf16(const __nv_bfloat16* x, const __nv_bfloat16* g, const float* gamma,
                       const float* beta, const float* sums, const float* sumsq,
                       float* dwb, float* part, int batch, int h, int wd, int c, int o,
                       int groups, float eps, int act, int taps, int up, int bias,
                       int runs, void* stream) {
  return conv_wgrad(x, g, gamma, beta, sums, sumsq, dwb, part, batch, h, wd, c, o, groups,
                    eps, act, taps, up, bias, runs, stream);
}

}  // extern "C"
