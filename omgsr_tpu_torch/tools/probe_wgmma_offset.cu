// Probe of two facts the bf16 conv kernels (csrc/conv3x3.cu,
// conv3x3_wgmma_kernel) rest on, on one NVIDIA Hopper GPU:
//   (1) a 3-D TMA box of 64 channels x 66 pixels x 6 rows, 128-byte swizzled,
//       loaded at negative coordinates, lands pixel p = row * 66 + column at
//       p * 128 bytes with its 16-byte chunks permuted by p % 8, and pixels
//       outside the array read as zeros;
//   (2) wgmma m64n128k16 with its A operand starting p0 whole 128-byte rows into
//       that tile (a tap shift of the conv) multiplies the right rows when the
//       descriptor's base-offset field is 0, at every p0; the field set to
//       (address >> 7) & 7 is printed beside it.
//
//   mkdir -p omgsr_tpu_torch/build && nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O2 \
//       -o omgsr_tpu_torch/build/probe_wgmma_offset omgsr_tpu_torch/tools/probe_wgmma_offset.cu \
//       && omgsr_tpu_torch/build/probe_wgmma_offset
//
// Exits 1 if (1) fails or (2) fails with base offset 0.
#include <cuda_bf16.h>

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "../csrc/mma_bf16.cuh"
#include "../csrc/sm90.cuh"

using namespace omgsr_sm90;
using namespace omgsr_mma;

// The K-major 128-byte-swizzled descriptor of sm90.cuh with base-offset field `bo`.
__device__ __forceinline__ uint64_t desc_bo(uint32_t addr, int bo) {
  return wgmma_desc(addr, 16, 1024) | ((uint64_t)(bo & 7) << 49);
}
constexpr int HALO = 6 * 66 * 128;  // the box's bytes
constexpr int XS = 51200;           // its slot, 1024-byte aligned; the B tile follows
__global__ void probe(const __grid_constant__ CUtensorMap tm, const __nv_bfloat16* wt, __nv_bfloat16* halo_out,
                      float* d_out, int p0, int mode) {
  extern __shared__ uint8_t raw[];
  const uint32_t base = (smem_u32(raw) + 1023u) & ~1023u;
  const uint32_t bar = base + XS + 16384;
  uint8_t* gbase = raw + (base - smem_u32(raw));
  if (threadIdx.x == 0) { mbar_init(bar, 1); fence_barrier_init(); }
  __syncthreads();
  if (threadIdx.x == 0) { mbar_arrive_expect_tx(bar, HALO); tma_load_3d(base, &tm, bar, 64, -1, -1); }
  // B: 128 rows (n) x 64 k, swizzled by hand
  for (int i = threadIdx.x; i < 128 * 8; i += 128) {
    int r = i / 8, c = i % 8;
    *reinterpret_cast<uint4*>(gbase + XS + r * 128 + ((c ^ (r & 7)) << 4)) = *reinterpret_cast<const uint4*>(wt + r * 64 + c * 8);
  }
  fence_proxy_async();
  mbar_wait(bar, 0);
  __syncthreads();
  for (int i = threadIdx.x; i < HALO / 16; i += 128)
    reinterpret_cast<uint4*>(halo_out)[i] = *reinterpret_cast<const uint4*>(gbase + i * 16);
  float acc[64];
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  wgmma_fence();
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t a = base + p0 * 128 + ks * 32;
    uint64_t da = mode == 0 ? desc_bo(a, 0) : desc_bo(a, (a >> 7) & 7);
    wgmma_ss_m64n128k16(acc, da, wgmma_desc(base + XS + ks * 32, 16, 1024), 1);
  }
  wgmma_commit_group();
  wgmma_wait_group<0>();
  fence_operands(acc);
  int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  for (int j = 0; j < 16; ++j) {
    int r = warp * 16 + g, c = 8 * j + 2 * t;
    d_out[r * 128 + c] = acc[4 * j]; d_out[r * 128 + c + 1] = acc[4 * j + 1];
    d_out[(r + 8) * 128 + c] = acc[4 * j + 2]; d_out[(r + 8) * 128 + c + 1] = acc[4 * j + 3];
  }
}
int main() {
  const int C = 128, W = 70, H = 8;
  std::vector<__nv_bfloat16> x(C * W * H), wt(128 * 64);
  std::vector<float> xf(C * W * H), wf(128 * 64);
  srand(1);
  for (size_t i = 0; i < x.size(); ++i) { float v = (rand() % 17 - 8) / 8.f; x[i] = __float2bfloat16(v); xf[i] = v; }
  for (size_t i = 0; i < wt.size(); ++i) { float v = (rand() % 9 - 4) / 4.f; wt[i] = __float2bfloat16(v); wf[i] = v; }
  __nv_bfloat16 *dx, *dw, *dh; float* dd;
  cudaMalloc(&dx, x.size() * 2); cudaMalloc(&dw, wt.size() * 2); cudaMalloc(&dh, HALO); cudaMalloc(&dd, 64 * 128 * 4);
  cudaMemcpy(dx, x.data(), x.size() * 2, cudaMemcpyHostToDevice);
  cudaMemcpy(dw, wt.data(), wt.size() * 2, cudaMemcpyHostToDevice);
  CUtensorMap tm;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)C * W * 2};
  const cuuint32_t box[3] = {64, 66, 6}, es[3] = {1, 1, 1};
  CUresult r = encode_tiled()(&tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, dx, dims, strides, box, es,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  printf("encode %d\n", (int)r);
  const int smem = XS + 16384 + 64 + 1024;
  cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int p0s[] = {0, 1, 2, 66, 67, 68, 133, 200};
  int failed = 0;
  std::vector<__nv_bfloat16> halo(HALO / 2);
  std::vector<float> d(64 * 128);
  for (int mode = 0; mode < 2; ++mode) for (int p0 : p0s) {
    probe<<<1, 128, smem>>>(tm, dw, dh, dd, p0, mode);
    cudaError_t e = cudaDeviceSynchronize();
    if (e) { printf("err %s\n", cudaGetErrorString(e)); return 1; }
    cudaMemcpy(halo.data(), dh, HALO, cudaMemcpyDeviceToHost);
    cudaMemcpy(d.data(), dd, d.size() * 4, cudaMemcpyDeviceToHost);
    // halo check: pixel p = r*66 + c at coords (h = r - 1, w = c - 1), chunk lc at physical lc ^ (p & 7)
    int bad_halo = 0;
    std::vector<float> A(396 * 64);
    for (int p = 0; p < 396; ++p) for (int ch = 0; ch < 64; ++ch) {
      int rr = p / 66, cc = p % 66, h = rr - 1, w = cc - 1;
      float want = (h >= 0 && h < H && w >= 0 && w < W) ? xf[(h * W + w) * C + 64 + ch] : 0.f;
      int lc = ch / 8, phys = lc ^ (p & 7);
      float got = __bfloat162float(halo[p * 64 + phys * 8 + ch % 8]);
      A[p * 64 + ch] = got;
      if (got != want) ++bad_halo;
    }
    double maxerr = 0;
    for (int i = 0; i < 64; ++i) for (int n = 0; n < 128; ++n) {
      float ref = 0; for (int k = 0; k < 64; ++k) ref += A[(p0 + i) * 64 + k] * wf[n * 64 + k];
      maxerr = fmax(maxerr, fabs(ref - d[i * 128 + n]));
    }
    printf("base offset %s, A from row %d: halo mismatches %d, wgmma max err %g\n",
           mode ? "(address >> 7) & 7" : "0", p0, bad_halo, maxerr);
    if (bad_halo != 0 || (mode == 0 && maxerr != 0.0)) failed = 1;
  }
  printf(failed ? "FAILED\n" : "the halo and the products with base offset 0 held\n");
  return failed;
}
