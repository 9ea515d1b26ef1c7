// bf16 conv tiles on Hopper's tensor cores: the shared-memory layout and the
// copy and product helpers of gnsc_bf16_kernel (csrc/fused_norm_conv.cu),
// kept apart so that a bf16 instance of the K2/K3 backward
// (csrc/fused_norm_conv_bwd.cu) and the bf16 attention
// (csrc/fused_attention.cu) can stage their tiles the same way. Built for
// sm_90a; everything here is in namespace bf16t.
//
// Products: wgmma m64n64k16 with bf16 operands and fp32 accumulation.
//   A, 16 pixels x 16 channels a warp, stored [position][channel], comes
//     into registers by ldmatrix .x4 (four 8 x 8 matrices of 16-bit values;
//     lane l gives the 16-byte row address of row l & 7 of matrix l >> 3):
//     lane l points at pixel (l & 7) + 8 ((l >> 3) & 1) of the warp's 16,
//     channels 8 (l >> 4) .. + 7 of the k16 step, and the four registers are
//     the A fragment a0..a3. A tap of an implicit 3x3 conv is only another
//     row (position) per lane, and a nearest-upsampled operand (K3) is lane
//     pixel (y / 2, x / 2) of a low-resolution plane.
//   B, 16 channels x 64 outputs, stored [channel][output] as the weights
//     (3, 3, C, O) are, is read by the tensor cores through a descriptor.
//     No repack.
//
// Layout.
//   A rows (one activation position's 64 channels): 72 bf16 values, 144
//     bytes, the last 16 unused. 144 = 9 x 16 and 9 is odd, so the rows of 8
//     consecutive positions start in 8 distinct 16-byte bank groups: an
//     ldmatrix phase (8 lanes on 8 consecutive positions, one 16-byte chunk
//     each; K3's lanes repeat positions, which is a broadcast) and a 16-byte
//     pass over 8 consecutive positions at one chunk are conflict-free.
//   W rows (one input channel's 64 outputs at one tap): 128 bytes, 16-byte
//     chunk j stored at j ^ (row & 7) (XOR swizzle), which is wgmma's
//     128-byte swizzle on a plane that starts on a 1024-byte boundary; each
//     row is copied from device memory as it is, 16 bytes a cp.async.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf16t {

using bf16 = __nv_bfloat16;

constexpr int kRowCh = 64;                // channels (A) or outputs (W) a row
constexpr int kARow = 72;                 // bf16 values an A row, 8 of them padding
constexpr int kARowBytes = 2 * kARow;     // 144
constexpr int kWRowBytes = 2 * kRowCh;    // 128
constexpr int kWSwizzle = 7;              // W chunk j of row r at j ^ (r & kWSwizzle)

// byte offsets of 16-byte chunk `chunk` (8 channels) of an A or W row
__host__ __device__ __forceinline__ int a_byte(int pos, int chunk) {
  return pos * kARowBytes + (chunk << 4);
}
__host__ __device__ __forceinline__ int w_byte(int row, int chunk) {
  return row * kWRowBytes + ((chunk ^ (row & kWSwizzle)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// p moved up to the next 1024-byte boundary of shared memory, where wgmma's
// 128-byte swizzle starts its phase (a kernel asks for 1024 bytes more)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// the current device's SMs (132 where it cannot be read)
inline int sm_count() {
  static int n[16] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 16) return 132;
  if (!n[dev]) cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev);
  return n[dev] > 0 ? n[dev] : 132;
}

// 16 bytes global -> shared, zero-filled (and nothing read) when !valid
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// Eight consecutive values src[0..7] into 16 bytes of shared memory at dst:
// values i with !row_ok or e0 + i >= emax are zero. vec: one 16-byte
// cp.async (needs emax % 8 == 0 and 16-byte aligned rows); else plain loads.
__device__ __forceinline__ void copy8(unsigned char* dst, const bf16* src, bool row_ok,
                                      int e0, int emax, bool vec, const bf16* any) {
  if (vec) {
    const bool v = row_ok && e0 < emax;
    cp16(smem_addr(dst), v ? src : any, v);
  } else {
    __align__(16) bf16 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = row_ok && e0 + i < emax ? src[i] : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// ---- wgmma (sm_90a): 64 x 64 x 16 products of a warpgroup (4 warps) ----
// A from registers: warp w of the warpgroup gives rows 16 w .. 16 w + 15 as
// an m16n8k16 A fragment (ldsm_x4 above). B from shared memory by
// descriptor: 16 channels x 64 outputs of W rows (128-byte rows, the XOR
// swizzle above, which is wgmma's 128-byte swizzle when the plane starts on
// a 1024-byte boundary), N-contiguous ("MN-major", transposed B). D: 32 fp32
// registers a thread, d[4 j + e] at row g + 8 (e >> 1), output 8 j + 2 t +
// (e & 1) of the warp's 16 rows (g = lane / 4, t = lane % 4).

// Descriptor of a B operand starting at shared address `addr` (a multiple of
// 1024): 128-byte swizzle, 8-row groups 1024 bytes apart. The layout's other
// stride (between 64-output groups) is never used at N = 64; both strides
// are given as 1024.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}
// shared memory written by threads (st.shared, cp.async) made visible to
// wgmma's reads of it; then a barrier
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// d += A (registers) x B (descriptor), m64n64k16, bf16 in, fp32 out (scale-d
// true; A and B unscaled; B transposed: N-contiguous)
__device__ __forceinline__ void wg_mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The same product with B K-major (csrc/fused_norm_conv_bwd.cu's dgrad: W
// rows of 64 K values, the transposed weights as HWIO holds them): 128-byte
// swizzle, 8-row groups of N 1024 bytes apart (the stride), the leading
// offset unused (1); a k16 step is 32 bytes along the rows, which moves the
// start address and leaves the rows' swizzle phase (address bits 7-9) as it is.
__device__ __forceinline__ uint64_t wg_desc_k(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_mma_kb(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d = A x B (+ d where accumulate != 0), m64n64k16, both operands from
// shared memory by descriptor (csrc/linear_attention.cu's bf16 K5 and K6):
// kTA / kTB 0 for a K-major operand (wg_desc_k), 1 for an MN-major one
// (wg_desc), as TMA's 128-byte swizzle leaves a tile of 128-byte rows.
template <int kTA, int kTB>
__device__ __forceinline__ void wg_mma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTA), "n"(kTB));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// SiLU in fp32 with the fast exponential and division (two MUFU operations)
__device__ __forceinline__ float silu_fast(float y) {
  return __fdividef(y, 1.f + __expf(-y));
}

}  // namespace bf16t
