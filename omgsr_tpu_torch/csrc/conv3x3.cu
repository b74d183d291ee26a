// 3x3 SAME convolution (stride 1, batch 1, NHWC) for Hopper (sm_90a), plain C
// interface: the plain conv with a bias + optional SiLU epilogue, and the
// resblock half y = conv3x3(silu(x * a + c)) + b [+ skip] that also emits
// per-channel sums of its output for the next GroupNorm.
//
// Replaces the Pallas TPU kernels omgsr_tpu/ops/conv3x3.py:_kernel (called
// from conv3x3_pallas) and :_kernel_rb (called from conv3x3_gn_fused).
//
// What differs from the TPU kernels, and why:
//   * The TPU kernel copied a stripe of bh + 2 pre-padded rows (all columns,
//     all input channels) into VMEM and issued nine (bh*W, C_in) x (C_in,
//     C_out) products. A block here has 110 KB of shared memory, not
//     megabytes, and the card wants hundreds of blocks in flight: one block
//     owns an output tile of 8 rows x 16 columns x BN output channels, walks
//     over C_in in chunks, and for each chunk stages the 10 x 18 halo tile of
//     x and the nine taps of its weight slice in shared memory.
//   * No padded copy of x is made in device memory: halo pixels outside the
//     image are written to shared memory as zeros. In the fused kernel the
//     GroupNorm+SiLU prologue silu(x * a + c) is applied (f32, rounded once
//     to the input type) while the tile is staged, on valid pixels only, so
//     the ring stays exactly zero: the graph pads after the activation.
//   * The TPU grid ran the stripes one after the other; blocks here run in
//     no order. Each block writes the sum and the sum of squares of its own
//     f32 outputs (bias and skip added, before the rounding of y) to its own
//     row of a (2, n_partials, C_out) buffer, reduced inside the block in a
//     fixed order. There are no atomics: the same input gives the same bits
//     on every run, and the caller adds the rows up.
//   * Weights are read as the port stores them: OIHW in channels_last memory,
//     which lies as (C_out, 3, 3, C_in), so for every tap the C_in values of
//     one output channel are contiguous: the "col" operand of mma.sync.
//
// Bound on this card: operations (2 * 9 * C_in * C_out * H * W flops against
// (C_in + C_out [+ C_out]) * H * W elements moved). Two kernels share the
// block layout:
//   * conv3x3_mma_kernel (bf16): tensor cores through mma.sync.m16n8k16 with
//     f32 accumulators, both operands through ldmatrix, described where it
//     is defined. wgmma, TMA and asynchronous staging are not used yet.
//   * conv3x3_fma_kernel (f32): plain f32 FMAs from shared memory. Exact for
//     f32 inputs, far from the tensor-core rate.
// Both are templated on FUSED: false is the plain conv (bias, optional SiLU),
// true the resblock half (prologue, bias, optional skip, optional sums).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace omgsr_mma;

constexpr int TH = 8;                    // output rows of a block
constexpr int TW = 16;                   // output columns of a block: one m16 tile is one row
constexpr int HALO_W = TW + 2;
constexpr int HALO_PIX = (TH + 2) * HALO_W;  // 180
constexpr int NT = 256;

__device__ __forceinline__ float silu(float h) { return h / (1.f + __expf(-h)); }

// ----------------------------------------------------------------------------
// bf16: tensor cores.
//
// 8 warps: warp_m = warp / 2 owns two output rows (two m16 tiles of 16
// pixels), warp_n = warp % 2 owns 64 of the block's BN = 128 output channels
// (eight n8 tiles), so a thread keeps 2 x 8 x 4 f32 accumulators. Per chunk
// of KC = 32 input channels the block stages Xs[180 halo pixels][KC] and
// Ws[9 taps][BN][KC], both with rows padded to 40 elements (80 bytes), which
// makes every ldmatrix phase hit 8 different 16-byte bank groups. For a tap
// (dy, dx) the A fragment of an output row is ldmatrix over 16 neighbouring
// halo pixels of row + dy starting at column dx; the B fragment is ldmatrix
// over 8 output channels of that tap, one call for both k-steps of the chunk.
// Shared memory: 14,400 + 92,160 + 4,096 (block reduction of the sums) =
// 110,656 bytes, two blocks per SM.
// ----------------------------------------------------------------------------

constexpr int BN = 128;
constexpr int KC = 32;
constexpr int LD = KC + 8;
constexpr int MMA_SMEM = (HALO_PIX * LD + 9 * BN * LD) * 2 + 4 * BN * 2 * 4;

template <bool FUSED>
__global__ void __launch_bounds__(NT, 2) conv3x3_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ bias, const float* __restrict__ gn_a,
    const float* __restrict__ gn_c, const __nv_bfloat16* __restrict__ skip,
    __nv_bfloat16* __restrict__ y, float* __restrict__ sums, int H, int W, int Cin, int Cout,
    int act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ws = Xs + HALO_PIX * LD;
  float* red = reinterpret_cast<float*>(Ws + 9 * BN * LD);  // [4 warp_m][BN][2]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int lrow = lane & 7;
  const int lmat = lane >> 3;
  const int warp_m = warp >> 1;
  const int warp_n = warp & 1;
  const int n0 = blockIdx.x * BN;
  const int w0 = blockIdx.y * TW;
  const int h0 = blockIdx.z * TH;
  const int v = tid & 3;  // this thread's 8-channel vector of a staged row (KC / 8 = 4 per row)

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += KC) {
    float a8[8], c8[8];
    if (FUSED) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        a8[i] = __ldg(gn_a + c0 + v * 8 + i);
        c8[i] = __ldg(gn_c + c0 + v * 8 + i);
      }
    }
    __syncthreads();  // the previous chunk's readers are done
    for (int pix = tid >> 2; pix < HALO_PIX; pix += NT / 4) {
      const int hr = pix / HALO_W;
      const int gh = h0 + hr - 1;
      const int gw = w0 + (pix - hr * HALO_W) - 1;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (gh >= 0 && gh < H && gw >= 0 && gw < W) {
        raw = *reinterpret_cast<const uint4*>(x + ((long long)gh * W + gw) * Cin + c0 + v * 8);
        if (FUSED) {
          uint32_t* r = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 f = unpack_bf16(r[i]);
            r[i] = pack_bf16(silu(f.x * a8[2 * i] + c8[2 * i]),
                             silu(f.y * a8[2 * i + 1] + c8[2 * i + 1]));
          }
        }
      }
      *reinterpret_cast<uint4*>(Xs + pix * LD + v * 8) = raw;
    }
    for (int row = tid >> 2; row < 9 * BN; row += NT / 4) {
      const int n = row / 9;
      const int tap = row - n * 9;
      *reinterpret_cast<uint4*>(Ws + (tap * BN + n) * LD + v * 8) = *reinterpret_cast<const uint4*>(
          w + ((long long)(n0 + n) * 9 + tap) * Cin + c0 + v * 8);
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
      // A: matrices (pixels 0..7, 8..15) x (k 0..7), then the same pixels x (k 8..15)
      uint32_t af[2][2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int pix = (warp_m * 2 + mt + dy) * HALO_W + dx + (lmat & 1) * 8 + lrow;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          ldmatrix_x4(af[mt][ks], Xs + pix * LD + ks * 16 + (lmat >> 1) * 8);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // B: matrices (k 0..7, 8..15) of k-step 0, then of k-step 1
        uint32_t bf[4];
        ldmatrix_x4(bf, Ws + (tap * BN + warp_n * 64 + j * 8 + lrow) * LD + lmat * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][j], af[mt][0], bf[0], bf[1]);
          mma_bf16(acc[mt][j], af[mt][1], bf[2], bf[3]);
        }
      }
    }
  }

  // epilogue: bias [SiLU | + skip] in f32, sums of the f32 values, y rounded once
  const bool emit = FUSED && sums != nullptr;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int nl = warp_n * 64 + j * 8 + 2 * tig;
    const float2 b2 = unpack_bf16(*reinterpret_cast<const uint32_t*>(bias + n0 + nl));
    float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gh = h0 + warp_m * 2 + mt;
        const int gw = w0 + g + half * 8;
        if (gh < H && gw < W) {
          float v0 = acc[mt][j][half * 2] + b2.x;
          float v1 = acc[mt][j][half * 2 + 1] + b2.y;
          const long long off = ((long long)gh * W + gw) * Cout + n0 + nl;
          if (FUSED) {
            if (skip != nullptr) {
              const float2 sk = unpack_bf16(*reinterpret_cast<const uint32_t*>(skip + off));
              v0 += sk.x;
              v1 += sk.y;
            }
            s0 += v0;
            s1 += v1;
            q0 += v0 * v0;
            q1 += v1 * v1;
          } else if (act) {
            v0 = silu(v0);
            v1 = silu(v1);
          }
          *reinterpret_cast<uint32_t*>(y + off) = pack_bf16(v0, v1);
        }
      }
    }
    if (emit) {
      // over the warp's 32 pixels: the 8 lanes that share tig
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, m);
        s1 += __shfl_xor_sync(0xffffffffu, s1, m);
        q0 += __shfl_xor_sync(0xffffffffu, q0, m);
        q1 += __shfl_xor_sync(0xffffffffu, q1, m);
      }
      if (g == 0) {
        float* r = red + (warp_m * BN + nl) * 2;
        r[0] = s0;
        r[1] = q0;
        r[2] = s1;
        r[3] = q1;
      }
    }
  }
  if (emit) {
    __syncthreads();
    if (tid < BN) {
      float s = 0.f, q = 0.f;
#pragma unroll
      for (int wm = 0; wm < 4; ++wm) {
        s += red[(wm * BN + tid) * 2];
        q += red[(wm * BN + tid) * 2 + 1];
      }
      const long long part = (long long)blockIdx.z * gridDim.y + blockIdx.y;
      const long long n_part = (long long)gridDim.y * gridDim.z;
      sums[part * Cout + n0 + tid] = s;
      sums[(n_part + part) * Cout + n0 + tid] = q;
    }
  }
}

// ----------------------------------------------------------------------------
// f32: FMAs from shared memory, the same 8 x 16 pixel tile by FBN = 64 output
// channels. Thread (tx = tid % 16, ty = tid / 16) owns output column ty of all
// 8 rows and channels 4 tx .. 4 tx + 3: 32 accumulators. Per chunk of FKC = 16
// input channels: Xs[180][FKC + 4] and Ws[9][FKC][FBN] (k-major, so the four
// channels of a thread are one float4). Shared memory 14,400 + 36,864 + 8,192
// = 59,456 bytes.
// ----------------------------------------------------------------------------

constexpr int FBN = 64;
constexpr int FKC = 16;
constexpr int FLD = FKC + 4;
constexpr int FMA_SMEM = (HALO_PIX * FLD + 9 * FKC * FBN + 16 * FBN * 2) * 4;

template <bool FUSED>
__global__ void __launch_bounds__(NT) conv3x3_fma_kernel(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ gn_a, const float* __restrict__ gn_c,
    const float* __restrict__ skip, float* __restrict__ y, float* __restrict__ sums, int H, int W,
    int Cin, int Cout, int act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Xs = reinterpret_cast<float*>(smem_raw);
  float* Ws = Xs + HALO_PIX * FLD;
  float* red = Ws + 9 * FKC * FBN;  // [16 ty][FBN][2]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n0 = blockIdx.x * FBN;
  const int w0 = blockIdx.y * TW;
  const int h0 = blockIdx.z * TH;
  const int v = tid & 3;  // this thread's 4-channel vector of a staged row (FKC / 4 = 4 per row)

  float acc[TH][4];
#pragma unroll
  for (int i = 0; i < TH; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += FKC) {
    float4 a4 = make_float4(1.f, 1.f, 1.f, 1.f), c4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (FUSED) {
      a4 = *reinterpret_cast<const float4*>(gn_a + c0 + v * 4);
      c4 = *reinterpret_cast<const float4*>(gn_c + c0 + v * 4);
    }
    __syncthreads();
    for (int pix = tid >> 2; pix < HALO_PIX; pix += NT / 4) {
      const int hr = pix / HALO_W;
      const int gh = h0 + hr - 1;
      const int gw = w0 + (pix - hr * HALO_W) - 1;
      float4 raw = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gh >= 0 && gh < H && gw >= 0 && gw < W) {
        raw = *reinterpret_cast<const float4*>(x + ((long long)gh * W + gw) * Cin + c0 + v * 4);
        if (FUSED) {
          raw.x = silu(raw.x * a4.x + c4.x);
          raw.y = silu(raw.y * a4.y + c4.y);
          raw.z = silu(raw.z * a4.z + c4.z);
          raw.w = silu(raw.w * a4.w + c4.w);
        }
      }
      *reinterpret_cast<float4*>(Xs + pix * FLD + v * 4) = raw;
    }
    for (int row = tid >> 2; row < 9 * FBN; row += NT / 4) {
      const int n = row / 9;
      const int tap = row - n * 9;
      const float4 wv = *reinterpret_cast<const float4*>(
          w + ((long long)(n0 + n) * 9 + tap) * Cin + c0 + v * 4);
      float* dst = Ws + (tap * FKC + v * 4) * FBN + n;
      dst[0] = wv.x;
      dst[FBN] = wv.y;
      dst[2 * FBN] = wv.z;
      dst[3 * FBN] = wv.w;
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3;
      const int dx = tap % 3;
      const float* xcol = Xs + (dy * HALO_W + ty + dx) * FLD;
#pragma unroll 4
      for (int k = 0; k < FKC; ++k) {
        const float4 wv = *reinterpret_cast<const float4*>(Ws + (tap * FKC + k) * FBN + tx * 4);
#pragma unroll
        for (int i = 0; i < TH; ++i) {
          const float xv = xcol[i * HALO_W * FLD + k];
          acc[i][0] += xv * wv.x;
          acc[i][1] += xv * wv.y;
          acc[i][2] += xv * wv.z;
          acc[i][3] += xv * wv.w;
        }
      }
    }
  }

  const bool emit = FUSED && sums != nullptr;
  const int n = n0 + tx * 4;
  const float4 b4 = *reinterpret_cast<const float4*>(bias + n);
  const int gw = w0 + ty;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < TH; ++i) {
    const int gh = h0 + i;
    if (gh < H && gw < W) {
      float o[4] = {acc[i][0] + b4.x, acc[i][1] + b4.y, acc[i][2] + b4.z, acc[i][3] + b4.w};
      const long long off = ((long long)gh * W + gw) * Cout + n;
      if (FUSED) {
        if (skip != nullptr) {
          const float4 sk = *reinterpret_cast<const float4*>(skip + off);
          o[0] += sk.x;
          o[1] += sk.y;
          o[2] += sk.z;
          o[3] += sk.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[e] += o[e];
          q[e] += o[e] * o[e];
        }
      } else if (act) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = silu(o[e]);
      }
      *reinterpret_cast<float4*>(y + off) = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
  if (emit) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      red[(ty * FBN + tx * 4 + e) * 2] = s[e];
      red[(ty * FBN + tx * 4 + e) * 2 + 1] = q[e];
    }
    __syncthreads();
    if (tid < FBN) {
      float ss = 0.f, qq = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        ss += red[(r * FBN + tid) * 2];
        qq += red[(r * FBN + tid) * 2 + 1];
      }
      const long long part = (long long)blockIdx.z * gridDim.y + blockIdx.y;
      const long long n_part = (long long)gridDim.y * gridDim.z;
      sums[part * Cout + n0 + tid] = ss;
      sums[(n_part + part) * Cout + n0 + tid] = qq;
    }
  }
}

template <bool FUSED>
int launch(const void* x, const void* w, const void* bias, const float* gn_a, const float* gn_c,
           const void* skip, void* y, float* sums, int dtype, int act, int H, int W, int Cin,
           int Cout, int n_partials, cudaStream_t stream) {
  if (H < 1 || W < 1 || Cin < 128 || Cout < 128 || Cin % 128 || Cout % 128) return -1;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  if (tiles_w > 65535 || tiles_h > 65535) return -1;
  if (FUSED && (gn_a == nullptr || gn_c == nullptr)) return -1;
  if (sums != nullptr && n_partials != tiles_w * tiles_h) return -2;
  if (dtype == 0) {
    cudaError_t err = cudaFuncSetAttribute(conv3x3_mma_kernel<FUSED>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, MMA_SMEM);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(Cout / BN, tiles_w, tiles_h);
    conv3x3_mma_kernel<FUSED><<<grid, NT, MMA_SMEM, stream>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const __nv_bfloat16*)bias, gn_a, gn_c,
        (const __nv_bfloat16*)skip, (__nv_bfloat16*)y, sums, H, W, Cin, Cout, act);
  } else if (dtype == 1) {
    cudaError_t err = cudaFuncSetAttribute(conv3x3_fma_kernel<FUSED>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, FMA_SMEM);
    if (err != cudaSuccess) return (int)err;
    dim3 grid(Cout / FBN, tiles_w, tiles_h);
    conv3x3_fma_kernel<FUSED><<<grid, NT, FMA_SMEM, stream>>>(
        (const float*)x, (const float*)w, (const float*)bias, gn_a, gn_c, (const float*)skip,
        (float*)y, sums, H, W, Cin, Cout, act);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Common to both entries. x (H, W, Cin) and y (H, W, Cout) contiguous NHWC
// at batch 1; w (Cout, 3, 3, Cin) contiguous (OIHW in channels_last memory);
// bias (Cout,); x, w, bias, skip and y share one type: dtype 0 = bf16
// (tensor-core kernel), 1 = f32 (FMA kernel). Cin and Cout are multiples of
// 128 and every pointer is 16-byte aligned. Returns 0, a CUDA error code, -1
// for an unsupported dtype or shape, -2 for a sums buffer of the wrong size.

// The number of rows of the sums buffer for an (H, W) image: one per tile.
extern "C" int conv3x3_partials(int H, int W) {
  return ((W + TW - 1) / TW) * ((H + TH - 1) / TH);
}

// y = conv3x3(x) + bias, then SiLU when act == 1.
extern "C" int conv3x3(const void* x, const void* w, const void* bias, void* y, int dtype, int act,
                       int H, int W, int Cin, int Cout, void* stream) {
  return launch<false>(x, w, bias, nullptr, nullptr, nullptr, y, nullptr, dtype, act, H, W, Cin,
                       Cout, 0, (cudaStream_t)stream);
}

// y = conv3x3(silu(x * gn_a + gn_c)) + bias [+ skip]; gn_a, gn_c (Cin,) f32;
// skip (H, W, Cout) or null; sums null or (2, n_partials, Cout) f32 with
// n_partials = conv3x3_partials(H, W): row p of sums[0] / sums[1] receives
// the per-channel sum / sum of squares of tile p's f32 outputs.
extern "C" int conv3x3_gn_fused(const void* x, const void* w, const void* bias, const float* gn_a,
                                const float* gn_c, const void* skip, void* y, float* sums,
                                int dtype, int H, int W, int Cin, int Cout, int n_partials,
                                void* stream) {
  return launch<true>(x, w, bias, gn_a, gn_c, skip, y, sums, dtype, 0, H, W, Cin, Cout,
                      n_partials, (cudaStream_t)stream);
}
