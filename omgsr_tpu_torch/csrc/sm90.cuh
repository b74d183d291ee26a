// Hopper (sm_90a) building blocks for the flash-attention kernels (the
// forward's flash_fwd_wgmma_kernel and flash_fwd_wide_wgmma_kernel, the
// backward's dQ and dK/dV kernels at every head dim) and the 3x3 convs
// (conv3x3_wgmma_kernel): one PTX instruction each, inline, plus the host
// side they share. Included by the .cu files of this directory.
//
//   * mbarrier: init, arrive, arrive with an expected transaction count, and a
//     wait on a phase parity (try_wait in a loop);
//   * clusters: the address of a variable in another CTA's shared memory
//     (mapa), asynchronous stores there that complete on its mbarriers
//     (st.async), arrivals on its mbarriers, waits that acquire at cluster
//     scope, and the cluster-wide barrier (the backward's D = 512 kernels share
//     their score products between the two CTAs of a pair);
//   * TMA: cp.async.bulk.tensor loads (completing on an mbarrier) and stores
//     (bulk groups), 3-D and 4-D, through a CUtensorMap passed as a
//     __grid_constant__ kernel parameter; fence.proxy.async for shared memory written by
//     threads and then read by TMA or wgmma;
//   * wgmma: the shared-memory matrix descriptor, fence / commit_group /
//     wait_group, and the products the kernels issue (m64n64k16 and
//     m64n128k16 with both operands in shared memory; m64n64k16,
//     m64n128k16 and m64n256k16 with A in registers and a transposed B);
//   * setmaxnreg, which moves registers from the producer warpgroup to the
//     consumer warpgroups;
//   * host: the 4-D tensor map of a (B, S, H, D) operand and the 3-D map of
//     any bf16 array with a contiguous innermost axis (cuTensorMapEncodeTiled,
//     fetched from the driver through the runtime, so that no library needs
//     -lcuda) and the once-per-device opt-in to more than 48 KiB of dynamic
//     shared memory.
//
// Tiles are stored as TMA writes them with CU_TENSOR_MAP_SWIZZLE_128B: rows of
// 128 bytes (64 bf16 values), the 16-byte chunks of row r permuted by r % 8, in
// 8-row atoms of 1024 bytes; every tile base is 1024-byte aligned. The
// hardware takes the swizzle phase of a row from its shared-memory address, so
// an operand may also start any whole number of 128-byte rows into a tile (the
// conv's tap shifts) with the descriptor's base-offset field left at 0:
// tools/probe_wgmma_offset.cu holds this on the card (setting the field to
// (address >> 7) & 7 instead gives wrong products).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace omgsr_sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarrier --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the other threads and to the async proxy.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
               : "memory");
}

// One arrival that also raises the phase's expected transaction count by `bytes`.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// Returns once the phase of parity `parity` (0 for the first, 1 for the second, ...) has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// ---- clusters: another CTA's shared memory and barriers -----------------------

// The shared::cluster address, in the cluster's CTA of rank `rank`, of the
// variable at this CTA's shared address `addr`.
__device__ __forceinline__ uint32_t mapa_shared(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// 16 bytes to a shared::cluster address (another CTA's shared memory), without
// waiting: the bytes count towards the transaction count of the mbarrier at
// shared::cluster address `bar` in that CTA.
__device__ __forceinline__ void st_async_v4(uint32_t addr, float a, float b, float c, float d, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(
                   addr),
               "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
               : "memory");
}

// One arrival on the mbarrier at shared::cluster address `bar` (another CTA's),
// releasing this thread's earlier memory accesses at cluster scope.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// mbar_wait with cluster-scope acquire: what the threads of another CTA wrote
// before their arrivals is visible once it returns.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Every thread of every CTA of the cluster arrives (release) and waits (acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// ---- TMA -------------------------------------------------------------------

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// The box at coordinates (c0, c1, c2, c3), innermost first, into shared memory at
// `dst`; its bytes count towards the transaction count of `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The same for a 3-D map; coordinates may be negative (elements outside the
// tensor read as zeros).
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The box at (c0, c1, c2, c3) from shared memory at `src` to global memory; elements
// outside the tensor are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit_group() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until the committed stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_group_read0() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy (TMA, wgmma) accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z),
               "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// A barrier over `count` threads (a multiple of 32) with id `id` (1..15; 0 is __syncthreads).
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Arrives at barrier `id` without waiting (the other `count` - 32k threads sync on it).
__device__ __forceinline__ void named_barrier_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand at shared
// address `addr`: start address, leading and stride byte offsets (all >> 4),
// layout type 1 (128B swizzle) in bits 62-63.
//   K-major (the reduction axis contiguous, Q and K here): LBO is not used for
//     swizzled layouts (set to 16 bytes), SBO = 1024, the step between 8-row atoms;
//     a k-step of 16 values moves the start address by 32 bytes inside the row.
//   MN-major (V as the B operand of P V, D contiguous): LBO = the step between
//     64-column boxes, SBO = 1024, the step between 8-row atoms along kv; a k-step
//     of 16 kv rows moves the start address by 2048 bytes.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo_bytes & 0x3FFFFu) >> 4) << 16) |
         ((uint64_t)((sbo_bytes & 0x3FFFFu) >> 4) << 32) | (1ull << 62);
}

// Orders register and shared-memory accesses before the wgmma that follow.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_group() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait_group() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses to an accumulator register across an
// asynchronous wgmma that writes it.
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_operand(r[i]);
}

// The same for the A fragments of K k-steps (four registers each).
template <int K>
__device__ __forceinline__ void fence_fragments(uint32_t (&f)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_operand(f[kk][e]);
}

// 2^x by the SFU (ex2.approx, flushing denormals; 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- registers ---------------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- the products --------------------------------------------------------------
// Accumulator layout (f32, m64nN): warp w of the warpgroup holds rows 16w..16w+15;
// for its n-tile j (8 columns), d[4j], d[4j+1] = (row g, columns 8j + 2t, +1) and
// d[4j+2], d[4j+3] = (row g + 8, the same columns), g = lane / 4, t = lane % 4. The
// A fragment from registers (m64k16 bf16) of warp w: a0 = (row g, k 2t, 2t+1),
// a1 = (row g + 8, k 2t, 2t+1), a2 / a3 = the same rows at k + 8. So the
// accumulator of n-tiles 2kk and 2kk+1, rounded to bf16 in pairs, is the A
// fragment of k-step kk of the next product.

// D (64 x 64, f32) += A (64 x 16) B (16 x 64), both bf16 from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 128, f32) += A (64 x 16) B (16 x 128), both bf16 from shared memory, K-major.
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, bf16 fragments in registers) B (16 x 64, bf16 from
// shared memory, MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_m64n64k16_tb(float (&d)[32], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D (64 x 128, f32) += A (64 x 16, bf16 fragments in registers) B (16 x 128, bf16 from
// shared memory, MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_m64n128k16_tb(float (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D (64 x 256, f32) += A (64 x 16, bf16 fragments in registers) B (16 x 256, bf16 from
// shared memory, MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_rs_m64n256k16_tb(float (&d)[128], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// ---- host ------------------------------------------------------------------

typedef CUresult (*TensorMapEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                         const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                         const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                         CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Error codes of the host side (CUDA's own codes stay below 1000).
constexpr int NO_ENCODE_ENTRY = 1000;     // the driver has no cuTensorMapEncodeTiled
constexpr int ENCODE_FAILED = 2000;       // + the driver's CUresult

// cuTensorMapEncodeTiled, fetched from the driver through the runtime once, so
// that the library needs no -lcuda.
inline TensorMapEncodeTiled encode_tiled() {
  static const TensorMapEncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<TensorMapEncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 (B, S, H, D) operand with element strides (sb, ss, sh) and a
// contiguous D axis, as a 4-D tensor map over (D, H, S, B), innermost first,
// whose box is 64 columns x `rows` rows of one (batch, head), 128-byte
// swizzled. Rows past S read as zeros; stores past S are dropped. The driver
// refuses (ENCODE_FAILED + its code) a base or a stride that is not a multiple
// of 16 bytes.
inline int encode_bshd(CUtensorMap* map, const void* ptr, int B, int S, int H, int D, long long sb,
                       long long ss, long long sh, int rows) {
  const TensorMapEncodeTiled fn = encode_tiled();
  if (fn == nullptr) return NO_ENCODE_ENTRY;
  // the stride of a dimension of extent 1 is never used: give it one the map takes
  if (H == 1) sh = D;
  if (S == 1) ss = sh * H;
  if (B == 1) sb = ss * S;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                        box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

// A bf16 array of extents (d0, d1, d2), innermost first, with element strides
// (s1, s2) for the two outer axes and a contiguous innermost axis, as a 3-D
// tensor map whose box is (b0, b1, b2) elements, 128-byte swizzled (b0 * 2 must
// be 128). Elements outside the array read as zeros; stores outside it are
// dropped.
inline int encode_3d(CUtensorMap* map, const void* ptr, long long d0, long long d1, long long d2,
                     long long s1, long long s2, int b0, int b1, int b2) {
  const TensorMapEncodeTiled fn = encode_tiled();
  if (fn == nullptr) return NO_ENCODE_ENTRY;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)s1 * 2, (cuuint64_t)s2 * 2};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, (cuuint32_t)b2};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                        box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

// The opt-in of one kernel to `bytes` of dynamic shared memory, once per device
// (not on every launch: the host's launch path is what a UNet stage at batch 1
// waits for). Each launcher keeps one SmemOptIn per kernel as a static.
struct SmemOptIn {
  static constexpr int MAX_DEVICES = 64;
  std::once_flag once[MAX_DEVICES];
  cudaError_t result[MAX_DEVICES];
};

inline int opt_in_smem(SmemOptIn& opt, const void* kernel, int bytes) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= SmemOptIn::MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  std::call_once(opt.once[dev], [&] {
    opt.result[dev] = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  });
  return (int)opt.result[dev];
}

}  // namespace omgsr_sm90
