// A ring of tiles in shared memory filled by Hopper's Tensor Memory
// Accelerator (TMA): mbarriers, TMA loads and stores of 3-D and 4-D tensor
// maps, and the host-side encoding of those maps. Built for sm_90a;
// everything here is in namespace tma.
//
// The pattern (csrc/linear_attention.cu's bf16 K5 and K6): one producer
// thread waits on a stage's `empty` barrier, arms its `full` barrier with the
// bytes it expects (mbar_expect_tx) and issues the stage's TMA loads, which
// complete those bytes on `full`; consumers wait on `full`, read the stage
// (wgmma reads it through the async proxy) and arrive on `empty`. A phase of
// a barrier completes when its arrivals (and bytes) are in; a waiter names
// the parity of the phase it waits for, so the k-th use of a stage in a ring
// of S waits for parity (k / S) & 1. csrc/fused_norm.cu's fp32 backward
// takes the barriers with cp.async copies (mbar_arrive_copies); its bf16
// backward fills its ring with bulk copies of contiguous rows (bulk_load,
// with L2 policies), stores by bulk copies (bulk_store) and hands its
// partials between a cluster's blocks on remote barriers (mbar_arrive_rank,
// mbar_wait_cluster).
//
// Tensor maps are encoded on the host by cuTensorMapEncodeTiled, taken from
// libcuda at run time (cudaGetDriverEntryPoint), so a library built by nvcc
// with a plain C interface links no -lcuda; a kernel takes them as
// `__grid_constant__ const CUtensorMap` parameters. Boxes that reach past a
// tensor's bounds are zero-filled on loads (and their bytes still count on
// the barrier) and clipped on stores.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// the initialisations visible to the async proxy (TMA) and the cluster;
// then a block (or cluster) barrier before any use
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}"
               :: "r"(smem_u32(bar)) : "memory");
}

// `n` arrivals at once
__device__ __forceinline__ void mbar_arrive_n(unsigned long long* bar, unsigned n) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0], %1;\n}"
               :: "r"(smem_u32(bar)), "r"(n) : "memory");
}

// one arrival that also expects `bytes` of TMA transactions in this phase
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// one arrival once every cp.async this thread issued so far has landed
__device__ __forceinline__ void mbar_arrive_copies(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" :: "r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred P1;\n LAB_WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      " @P1 bra DONE;\n bra LAB_WAIT;\n DONE:\n}"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// a named barrier of `threads` threads (a multiple of 32); id 0 is
// __syncthreads()'s
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// ---- TMA ----

// the box of a 3-D tensor map at (c0, c1, c2), innermost first, into shared
// memory at dst (1024-byte aligned for the 128-byte swizzle); its bytes
// complete on bar
__device__ __forceinline__ void load_3d(void* dst, const CUtensorMap* map,
                                        unsigned long long* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(smem_u32(dst)), "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the box of a 4-D tensor map at (c0, c1, c2, c3), innermost first, as
// load_3d; coordinates may be negative, and the box's bytes past the bounds
// are zeros
__device__ __forceinline__ void load_4d(void* dst, const CUtensorMap* map,
                                        unsigned long long* bar, int c0, int c1, int c2,
                                        int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(smem_u32(dst)), "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3)
      : "memory");
}

// shared memory at src into the box of a 4-D tensor map at (c0, c1, c2, c3);
// the box's part past the bounds is not written
__device__ __forceinline__ void store_4d(const CUtensorMap* map, const void* src, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];"
      :: "l"(map), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// this thread's device-memory accesses ordered against its async-proxy (TMA)
// ones: after TMA stores have completed, before a grid barrier past which
// other blocks' TMA loads read the same memory (and after that barrier,
// before those loads)
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

// shared memory at src into the box of a 3-D tensor map at (c0, c1, c2);
// tracked by this thread's bulk groups
__device__ __forceinline__ void store_3d(const CUtensorMap* map, const void* src, int c0,
                                         int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];"
               :: "l"(map), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void store_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// at most N of this thread's store groups still read their shared memory
template <int N>
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(N) : "memory");
}

// at most N of this thread's store groups not yet complete
template <int N>
__device__ __forceinline__ void store_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" :: "n"(N) : "memory");
}

// ---- bulk copies of contiguous bytes (no tensor map) ----

// L2 policies for a copy's lines: kept as long as the cache can, at normal
// priority, or evicted first (data read once)
__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t policy_evict_normal() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// `bytes` (a multiple of 16) of device memory at src (16-byte aligned) into
// shared memory at dst (16-byte aligned) under L2 policy `policy`; the bytes
// complete on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

// `bytes` (a multiple of 16) of shared memory at src (16-byte aligned) into
// device memory at dst (16-byte aligned) under L2 policy `policy`; tracked
// by this thread's bulk groups (store_commit, store_wait_read)
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes,
                                           uint64_t policy) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;"
               :: "l"(dst), "r"(smem_u32(src)), "r"(bytes), "l"(policy) : "memory");
}

// this thread's shared-memory writes made visible to the async proxy (a
// bulk store's or wgmma's reads of them)
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- copies between the blocks of a cluster ----

// the shared::cluster address of this block's shared address `addr` in the
// block of cluster rank `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// four floats of another block's shared memory (a shared::cluster address).
// Volatile, so that it stays after the cluster barrier that makes them
// ready, without a memory clobber, so that the loads of a step issue
// together around the plain stores between them.
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr));
  return v;
}

// this thread's memory accesses so far ordered, at cluster scope, before its
// later ones (before a release-arrive that other blocks' reads depend on)
__device__ __forceinline__ void fence_acq_rel_cluster() {
  asm volatile("fence.acq_rel.cluster;" ::: "memory");
}

// one arrival, with release at cluster scope, on the barrier at this block's
// shared address `bar` in the block of cluster rank `rank` (the same offset
// in every block)
__device__ __forceinline__ void mbar_arrive_rank(unsigned long long* bar, int rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
               :: "r"(map_rank(smem_u32(bar), rank)) : "memory");
}

// mbar_wait with acquire at cluster scope: what other blocks of the cluster
// wrote before their arrivals is then visible
__device__ __forceinline__ void mbar_wait_cluster(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred P1;\n LAB_WAIT:\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
      " @P1 bra DONE;\n bra LAB_WAIT;\n DONE:\n}"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// ---- host: tensor maps ----

// libcuda's cuTensorMapEncodeTiled, or null where it cannot be had
inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p) : nullptr;
  }();
  return fn;
}

// A bf16 (B, rows, cols) row-major tensor at base as a 3-D map (cols, rows,
// B), boxes of box_cols x box_rows x 1 (box_cols * 2 = 128 bytes: one
// swizzled row), 128-byte swizzle, zero fill. cols % 8 == 0 and a 16-byte
// aligned base (TMA's 16-byte strides). Returns a cudaError_t code.
inline int encode_bf16_3d(CUtensorMap* map, const void* base, int batch, int rows, int cols,
                          int box_cols, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)cols * 2 * rows};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// A bf16 NHWC tensor (n, h, w, c) at base as a 4-D map (c, w, h, n), boxes
// of box_c x box_w x box_h x 1 (box_c * 2 = 128 bytes: one swizzled row a
// pixel), 128-byte swizzle, zero fill. c % 8 == 0 and a 16-byte aligned
// base. Returns a cudaError_t code.
inline int encode_bf16_4d(CUtensorMap* map, const void* base, int n, int h, int w, int c,
                          int box_c, int box_w, int box_h) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 2, (cuuint64_t)c * 2 * w,
                                 (cuuint64_t)c * 2 * w * h};
  const cuuint32_t box[4] = {(cuuint32_t)box_c, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace tma
