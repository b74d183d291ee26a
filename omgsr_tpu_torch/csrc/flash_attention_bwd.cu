// Flash-attention backward for Hopper (sm_90a), plain C interface: a dQ kernel
// and a dK/dV kernel.
//
// Replaces the Pallas TPU kernels omgsr_tpu/ops/flash_attention.py:
// _bwd_dq_kernel and _bwd_dkv_kernel (called from _backward, the custom_vjp of
// flash_attention_bshd). With the forward's f32 log-sum-exp L per query row:
//   P  = exp(scale * Q K^T - L)          (the softmax, recomputed, never stored)
//   D  = rowsum(dO * O)                  ("delta")
//   dS = P * (dO V^T - D)
//   dQ = scale * dS K     dK = scale * dS^T Q     dV = P^T dO
//
// What differs from the TPU kernels, and why:
//   * The TPU grids ran the streamed axis sequentially (kv for dQ, q for
//     dK/dV) and carried the accumulators in VMEM scratch between grid steps.
//     Blocks on a GPU run in no order, so one block owns one output tile and
//     loops over the streamed axis itself, the accumulators in registers: the
//     dQ kernels own q rows and loop over kv tiles, the dK/dV kernels own kv
//     rows and loop over q tiles (where its grid would leave SMs idle the
//     bf16 dK/dV kernel splits that loop into chunks and a second kernel adds
//     the chunks' partials).
//     Each output element is summed by one thread in one fixed order: there
//     are no atomics, and the same inputs give the same bits on every run.
//   * The TPU wrapper transposed (B,S,H,D) to (B*H,S,D), padded S to the block
//     size in device memory and computed delta with tensor code. Here the
//     kernels read (B,S,H,D) through the strides they are given (the bf16
//     kernels at D = 64 and 128 through TMA tensor maps built from them) and
//     mask the ragged ends themselves (kv columns >= Skv in the dQ kernels, q
//     rows >= Sq in the dK/dV kernels; rows that do not exist are never
//     stored), and delta is a prologue of the dQ kernels: the block that owns
//     a q tile reads the matching dO and O rows once and writes their sums to
//     a (B*H, Sq) f32 buffer that the dK/dV kernel, launched after it on the
//     same stream, reads.
//
// Bound on this card: operations. The dQ kernel does three products
// (6*B*H*Sq*Skv*D flops), the dK/dV kernel four (8*B*H*Sq*Skv*D), against
// inputs that are read once. Three pairs of kernels share the block layout
// above:
//   * flash_bwd_dq_kernel / flash_bwd_dkv_kernel (f32 inputs): plain f32 FMAs
//     from shared memory: 256 threads, every tile [64][D+4] f32, 4x4 register
//     micro-tiles for the score products and 4 x D/16 for the output products,
//     conflict-free float4 reads, as in the forward's f32 kernel. Exact for
//     f32, far from the tensor-core rate. Shared memory (dynamic, opt-in): dQ
//     kernel 4 tiles + one [64][68] score tile + 128 floats = 87,552 bytes
//     (D=64) or 153,088 (D=128); dK/dV kernel 4 tiles + two score tiles =
//     104,960 or 170,496 bytes.
//   * flash_bwd_dq_wgmma_kernel / flash_bwd_dkv_wgmma_kernel (bf16 inputs,
//     D = 64 and 128): Hopper's tensor-core path, TMA loads into a ring of
//     shared-memory stages guarded by mbarriers, wgmma products, a producer
//     warpgroup and two consumer warpgroups on a 128-row owned tile, and
//     where the grid would leave SMs idle a split of the q loop whose partials
//     flash_bwd_dkv_reduce_kernel adds in a fixed order; described where they
//     are defined.
//   * flash_bwd_dq_wide_kernel / flash_bwd_dkv_wide_kernel (bf16 inputs,
//     D = 512): tensor cores through mma.sync, the owned rows staged in shared
//     memory, the warps splitting score blocks and output columns; described
//     where they are defined.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using namespace omgsr_mma;
using namespace omgsr_sm90;

constexpr int NT = 256;

struct Strides {
  long long b, s, h;  // elements; the D axis is contiguous
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int N = 4;  // elements of one 16-byte vector
  __device__ static void load(const float* p, float* out) {
    const float4 raw = *reinterpret_cast<const float4*>(p);
    out[0] = raw.x;
    out[1] = raw.y;
    out[2] = raw.z;
    out[3] = raw.w;
  }
  __device__ static void store4(float* p, float a, float b, float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  }
};

// Stage a ROWS-row tile of a (rows, D) matrix with the given row stride into
// shared memory as f32 [ROWS][D+4], times `mul`; rows >= rows_valid become 0.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride,
                                          int rows_valid, float mul) {
  constexpr int N = Elem<T>::N;
  constexpr int VPR = D / N;
  constexpr int LD = D + 4;
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += NT) {
    const int r = idx / VPR;
    const int v = idx % VPR;
    float vals[N];
    if (r < rows_valid) {
      Elem<T>::load(src + (long long)r * row_stride + v * N, vals);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) vals[i] = 0.f;
    }
    float4* out = reinterpret_cast<float4*>(dst + r * LD + v * N);
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      out[i] = make_float4(vals[4 * i] * mul, vals[4 * i + 1] * mul, vals[4 * i + 2] * mul,
                           vals[4 * i + 3] * mul);
    }
  }
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// s[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over two [.][D+4] tiles.
template <int D, int I, int J>
__device__ __forceinline__ void tile_product(float (&s)[I][J], const float* A, const float* B,
                                             int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[I], bv[J];
#pragma unroll
    for (int i = 0; i < I; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < J; ++j)
      bv[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j)
        s[i][j] += av[i].x * bv[j].x + av[i].y * bv[j].y + av[i].z * bv[j].z + av[i].w * bv[j].w;
  }
}

// acc[i][.] += sum_c P[ty + 16 i][c] * M[c][g*64 + tx*4 .. +3]; P is a
// [.][C+4] score tile, M a [C][D+4] tile, acc covers D/64 column groups.
template <int D, int I, int C>
__device__ __forceinline__ void accumulate(float (&acc)[I][D / 16], const float* P, const float* M,
                                           int ty, int tx) {
  constexpr int LD = D + 4;
  constexpr int LS = C + 4;
  constexpr int DG = D / 64;
#pragma unroll 2
  for (int c = 0; c < C; c += 4) {
    float4 pv[I];
#pragma unroll
    for (int i = 0; i < I; ++i)
      pv[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * LS + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int g = 0; g < DG; ++g) {
        const float4 mv = *reinterpret_cast<const float4*>(M + (c + cc) * LD + g * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < I; ++i) {
          const float p = comp(pv[i], cc);
          acc[i][4 * g + 0] += p * mv.x;
          acc[i][4 * g + 1] += p * mv.y;
          acc[i][4 * g + 2] += p * mv.z;
          acc[i][4 * g + 3] += p * mv.w;
        }
      }
    }
  }
}

// Rows ty + 16 i of an output tile, times `mul`, to a contiguous (B,S,H,D)
// tensor; rows >= rows_valid are not stored.
template <typename T, int D, int I>
__device__ __forceinline__ void store_tile(T* base, long long row_stride, int rows_valid,
                                           const float (&acc)[I][D / 16], float mul, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const int row = ty + 16 * i;
    if (row < rows_valid) {
#pragma unroll
      for (int g = 0; g < D / 64; ++g)
        Elem<T>::store4(base + (long long)row * row_stride + g * 64 + tx * 4,
                        acc[i][4 * g + 0] * mul, acc[i][4 * g + 1] * mul, acc[i][4 * g + 2] * mul,
                        acc[i][4 * g + 3] * mul);
    }
  }
}

// ----------------------------------------------------------------------------
// dQ: one block = one (batch*head, TQ-row q tile); loops over TK-row kv tiles.
// Prologue: delta of the tile's rows, kept in shared memory and written out.
// ----------------------------------------------------------------------------
template <typename T, int D, int TQ, int TK>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, T* __restrict__ dq, int H, int Sq, int Skv, Strides qs, Strides ks,
    Strides vs, Strides os, Strides gs, float scale) {
  constexpr int LD = D + 4;
  constexpr int LS = TK + 4;
  constexpr int IQ = TQ / 16;   // q rows per thread
  constexpr int JK = TK / 16;   // kv columns per thread
  constexpr int TPR = NT / TQ;  // lanes that share one row in the delta prologue
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Gs = Qs + TQ * LD;  // dO
  float* Ks = Gs + TQ * LD;
  float* Vs = Ks + TK * LD;
  float* Ss = Vs + TK * LD;  // dS
  float* lse_s = Ss + TQ * LS;
  float* delta_s = lse_s + TQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * TQ;
  const int qvalid = min(TQ, Sq - q0);

  const T* k_base = k + b * ks.b + h * ks.h;
  const T* v_base = v + b * vs.b + h * vs.h;

  load_tile<T, D, TQ>(Qs, q + b * qs.b + h * qs.h + (long long)q0 * qs.s, qs.s, qvalid, scale);
  load_tile<T, D, TQ>(Gs, dout + b * gs.b + h * gs.h + (long long)q0 * gs.s, gs.s, qvalid, 1.f);
  __syncthreads();

  // delta = rowsum(dO * O) in f32; TPR neighbouring lanes share one row
  {
    constexpr int N = Elem<T>::N;
    const int row = tid / TPR;
    const int part = tid % TPR;
    float sum = 0.f;
    if (row < qvalid) {
      const T* o_row = o + b * os.b + h * os.h + (long long)(q0 + row) * os.s;
      for (int vv = part; vv < D / N; vv += TPR) {
        float vals[N];
        Elem<T>::load(o_row + vv * N, vals);
#pragma unroll
        for (int e = 0; e < N; ++e) sum += vals[e] * Gs[row * LD + vv * N + e];
      }
    }
#pragma unroll
    for (int off = 1; off < TPR; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (part == 0) {
      delta_s[row] = sum;
      lse_s[row] = 0.f;
      if (row < qvalid) {
        lse_s[row] = lse[(long long)bh * Sq + q0 + row];
        delta[(long long)bh * Sq + q0 + row] = sum;
      }
    }
  }

  float acc[IQ][D / 16];
#pragma unroll
  for (int i = 0; i < IQ; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  for (int kv0 = 0; kv0 < Skv; kv0 += TK) {
    const int kvalid = min(TK, Skv - kv0);
    __syncthreads();  // the previous tile's readers are done; lse_s/delta_s are written
    load_tile<T, D, TK>(Ks, k_base + (long long)kv0 * ks.s, ks.s, kvalid, 1.f);
    load_tile<T, D, TK>(Vs, v_base + (long long)kv0 * vs.s, vs.s, kvalid, 1.f);
    __syncthreads();

    // this thread owns q rows ty+16i and kv columns tx+16j
    float s[IQ][JK], dp[IQ][JK];
    tile_product<D, IQ, JK>(s, Qs, Ks, ty, tx);   // Q was staged times scale
    tile_product<D, IQ, JK>(dp, Gs, Vs, ty, tx);  // dO V^T
#pragma unroll
    for (int i = 0; i < IQ; ++i) {
      const int row = ty + 16 * i;
      const float l = lse_s[row];
      const float dl = delta_s[row];
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        const int col = tx + 16 * j;
        const float p = (col < kvalid) ? __expf(s[i][j] - l) : 0.f;
        Ss[row * LS + col] = p * (dp[i][j] - dl);
      }
    }
    __syncthreads();
    accumulate<D, IQ, TK>(acc, Ss, Ks, ty, tx);  // dQ += dS K
  }

  const long long o_ss = (long long)H * D;
  store_tile<T, D, IQ>(dq + ((long long)b * Sq + q0) * o_ss + (long long)h * D, o_ss, qvalid, acc,
                       scale, ty, tx);
}

// ----------------------------------------------------------------------------
// dK/dV: one block = one (batch*head, TKV-row kv tile); loops over TQ-row q
// tiles. The score tiles are held transposed (kv rows, q columns), so both
// output products have the shape of the forward's P V product.
// ----------------------------------------------------------------------------
template <typename T, int D, int TKV, int TQ>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int H, int Sq, int Skv, Strides qs, Strides ks,
    Strides vs, Strides gs, float scale) {
  constexpr int LD = D + 4;
  constexpr int LS = TQ + 4;
  constexpr int IK = TKV / 16;  // kv rows per thread
  constexpr int JQ = TQ / 16;   // q columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + TKV * LD;
  float* Qs = Vs + TKV * LD;
  float* Gs = Qs + TQ * LD;    // dO
  float* Ps = Gs + TQ * LD;    // P^T
  float* Ss = Ps + TKV * LS;   // dS^T
  float* lse_s = Ss + TKV * LS;
  float* delta_s = lse_s + TQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kv0 = blockIdx.x * TKV;
  const int kvalid = min(TKV, Skv - kv0);

  const T* q_base = q + b * qs.b + h * qs.h;
  const T* g_base = dout + b * gs.b + h * gs.h;

  load_tile<T, D, TKV>(Ks, k + b * ks.b + h * ks.h + (long long)kv0 * ks.s, ks.s, kvalid, 1.f);
  load_tile<T, D, TKV>(Vs, v + b * vs.b + h * vs.h + (long long)kv0 * vs.s, vs.s, kvalid, 1.f);

  float acc_k[IK][D / 16], acc_v[IK][D / 16];
#pragma unroll
  for (int i = 0; i < IK; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      acc_k[i][j] = 0.f;
      acc_v[i][j] = 0.f;
    }

  for (int q0 = 0; q0 < Sq; q0 += TQ) {
    const int qvalid = min(TQ, Sq - q0);
    __syncthreads();  // the previous tile's readers are done
    // Q is staged times scale: it gives the scaled scores, and dS^T (scale Q) is dK
    load_tile<T, D, TQ>(Qs, q_base + (long long)q0 * qs.s, qs.s, qvalid, scale);
    load_tile<T, D, TQ>(Gs, g_base + (long long)q0 * gs.s, gs.s, qvalid, 1.f);
    if (tid < TQ) {
      const bool ok = tid < qvalid;
      lse_s[tid] = ok ? lse[(long long)bh * Sq + q0 + tid] : 0.f;
      delta_s[tid] = ok ? delta[(long long)bh * Sq + q0 + tid] : 0.f;
    }
    __syncthreads();

    // this thread owns kv rows ty+16i and q columns tx+16j
    float st[IK][JQ], dpt[IK][JQ];
    tile_product<D, IK, JQ>(st, Ks, Qs, ty, tx);   // (scale Q K^T)^T
    tile_product<D, IK, JQ>(dpt, Vs, Gs, ty, tx);  // (dO V^T)^T
#pragma unroll
    for (int j = 0; j < JQ; ++j) {
      const int r = tx + 16 * j;
      const float l = lse_s[r];
      const float dl = delta_s[r];
#pragma unroll
      for (int i = 0; i < IK; ++i) {
        const int c = ty + 16 * i;
        const float p = (r < qvalid && c < kvalid) ? __expf(st[i][j] - l) : 0.f;
        Ps[c * LS + r] = p;
        Ss[c * LS + r] = p * (dpt[i][j] - dl);
      }
    }
    __syncthreads();
    accumulate<D, IK, TQ>(acc_v, Ps, Gs, ty, tx);  // dV += P^T dO
    accumulate<D, IK, TQ>(acc_k, Ss, Qs, ty, tx);  // dK += dS^T (scale Q)
  }

  const long long o_ss = (long long)H * D;
  const long long off = ((long long)b * Skv + kv0) * o_ss + (long long)h * D;
  store_tile<T, D, IK>(dk + off, o_ss, kvalid, acc_k, 1.f, ty, tx);
  store_tile<T, D, IK>(dv + off, o_ss, kvalid, acc_v, 1.f, ty, tx);
}

template <typename T, int D, int TQ, int TK>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, float* delta, void* dq, int B, int H, int Sq, int Skv,
              const long long* st, float scale, cudaStream_t stream) {
  constexpr int smem_bytes =
      (2 * (TQ + TK) * (D + 4) + TQ * (TK + 4) + 2 * TQ) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D, TQ, TK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + TQ - 1) / TQ, B * H);
  flash_bwd_dq_kernel<T, D, TQ, TK><<<grid, NT, smem_bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout, lse, delta, (T*)dq, H,
      Sq, Skv, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14]}, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D, int TKV, int TQ>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dk, void* dv, int B, int H, int Sq, int Skv,
               const long long* st, float scale, cudaStream_t stream) {
  constexpr int smem_bytes =
      (2 * (TKV + TQ) * (D + 4) + 2 * TKV * (TQ + 4) + 2 * TQ) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D, TKV, TQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Skv + TKV - 1) / TKV, B * H);
  flash_bwd_dkv_kernel<T, D, TKV, TQ><<<grid, NT, smem_bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, (T*)dk, (T*)dv, H, Sq,
      Skv, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, scale);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------------------
// bf16 path at D = 64 and 128: flash_bwd_dq_wgmma_kernel and
// flash_bwd_dkv_wgmma_kernel, built for Hopper like the forward's
// flash_fwd_wgmma_kernel (csrc/flash_attention_fwd.cu; helpers in sm90.cuh).
//
// What bounds them: operations (K2a 6, K2b 8 times B*H*Sq*Skv*D flops against
// inputs read once), so the design keeps the tensor cores fed:
//   * Block = a producer warpgroup and two consumer warpgroups (384
//     threads). The producer (setmaxnreg 24): one of its threads issues every
//     TMA load, through 4-D tensor maps over (D, H, S, B) with the caller's
//     strides, so packed and permuted operands go in without a copy; rows
//     past S read as zeros. The consumers (setmaxnreg 240) own 64 rows each,
//     so a block owns a 128-row tile and every streamed byte feeds 128 rows.
//     At D = 64 the dQ kernel takes three consumer warpgroups (setmaxnreg
//     160, 192-row tiles) where that cuts the waves of blocks times rows a
//     block (dq_warpgroups: q(1,4096,5,64) gives 110 blocks in one wave on
//     132 SMs, not 160 in two); the dK/dV kernel's two output accumulators
//     do not fit in 160 registers.
//   * Shared memory: the two owned tiles (Q and dO for dQ, K and V for dK/dV),
//     loaded once, and a ring of HSTAGES stages of two streamed tiles of 64
//     rows (K and V for dQ, Q and dO for dK/dV), all 128-byte swizzled as TMA
//     writes them; per stage a `full` mbarrier (the producer's
//     arrive.expect_tx, completed by the TMA bytes) and an `empty` one (one
//     arrival per working consumer warp once its last product on the stage
//     has retired).
//   * The score products by wgmma m64n64k16 with both operands in shared
//     memory (K-major); P and dS in registers, P = 2^(s * scale * log2(e) -
//     lse * log2(e)) by ex2.approx; the output products by wgmma m64nDk16
//     with P or dS rounded to bf16 as register A fragments (the accumulator
//     layout of a score tile is the A fragment layout) and the streamed tile
//     as the transposed (MN-major) B operand, as the forward does P V.
//   * dQ kernel (K2a): a block owns 128 (or 192) q rows of one (batch, head) and
//     streams K and V: S = Q K^T, dP = dO V^T, dS = P (dP - delta), dQ += dS K.
//     Its prologue is delta = rowsum(dO * O) of the owned rows, read from
//     device memory by the consumers while the first tiles load, written to
//     the (B*H, Sq) f32 buffer that the dK/dV kernel reads. kv columns past
//     Skv are masked on the last tile (P = 0); rows past Sq take lse = +inf,
//     so P = 0, and are never stored.
//   * dK/dV kernel (K2b): a block owns 128 kv rows and streams Q and dO, and
//     with them the lse and delta of the tile's q rows, which a second
//     producer warp reads from device memory into the stage (lse times log2(e),
//     +inf past Sq, so P = 0 there) before its arrival on `full`. The score
//     products are taken transposed, S^T = K Q^T and dP^T = V dO^T, so their
//     rows are kv rows and P^T and dS^T are the A fragments of dV += P^T dO
//     and dK += dS^T Q directly. At D = 128 the two f32 output accumulators
//     take 128 registers a thread; the streamed q tile is 64 rows so that the
//     score tiles, the fragments and the accumulators stay within 240.
//   * Short kv (the 77 text tokens of cross-attention): ceil(Skv / 128) * B * H
//     blocks would leave most of the SMs idle (or, past one wave, the last
//     wave part-empty), so the wrapper splits the q tiles into `splits`
//     contiguous chunks (blockIdx.z), chosen by
//     ops/flash_attention.dkv_splits(B, H, Sq, Skv, D, SMs). Each block then writes
//     its f32 partial dK and dV to a scratch buffer the wrapper allocates, and
//     flash_bwd_dkv_reduce_kernel adds the partials in the order of the chunks
//     and writes bf16. Both launches are made by the one C entry
//     (flash_attention_bwd_dkv_split).
// Deterministic: no atomics; each output element is summed by one thread in
// one order (chunk partials in chunk order), so a run gives the same bits
// every time. The price is the recomputation of S and dP in both kernels: 14
// units of B*H*Sq*Skv*D work where the three gradients need 10.
// ----------------------------------------------------------------------------

constexpr int HS = 64;                 // rows of a streamed tile (ops/flash_attention.Q_TILE_ROWS)
constexpr int HSTAGES = 4;             // ring of streamed tiles: 64 KiB at D = 64, 128 KiB at D = 128
constexpr int STREAM_BOX = HS * 128;   // bytes of one 64-column box of a streamed tile
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of a block that owns HO = 64 * (consumer warpgroups) rows.
template <int D, int HO>
struct BwdSmem {
  static constexpr int OWN_BOX = HO * 128;   // bytes of one 64-column box of an owned tile
  static constexpr int OWN = HO * D * 2;     // bytes of an owned tile
  static constexpr int STREAM = HS * D * 2;  // bytes of a streamed tile
  static constexpr int A = 0;                // owned: Q (dQ kernel) or K (dK/dV kernel)
  static constexpr int B = OWN;              // owned: dO or V
  // streamed, stage s: K (dQ kernel) or Q (dK/dV kernel), then V or dO
  __host__ __device__ static constexpr int S0(int s) { return 2 * OWN + 2 * STREAM * s; }
  __host__ __device__ static constexpr int S1(int s) { return 2 * OWN + 2 * STREAM * s + STREAM; }
  static constexpr int ROWS = 2 * OWN + 2 * STREAM * HSTAGES;  // dK/dV kernel: lse, delta of stage s (HS f32 each)
  static constexpr int BARS = ROWS + HSTAGES * 2 * HS * 4;      // own_full, full[HSTAGES], empty[HSTAGES]
  static constexpr int BYTES = BARS + 8 * (1 + 2 * HSTAGES) + 1024;  // + alignment slack
};

// C (64 x 64) = A B^T over D: A the warpgroup's 64 rows of an owned tile at
// a_wg (64-column boxes OWN_BOX bytes apart), B the 64 rows of a streamed tile
// at b_tile, both K-major; D/16 k-steps of 32 bytes inside each box.
template <int D, int OWN_BOX>
__device__ __forceinline__ void issue_abt(float (&c)[32], uint32_t a_wg, uint32_t b_tile) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t in_box = (ks & 3) * 32;
    wgmma_ss_m64n64k16(c, wgmma_desc(a_wg + (ks >> 2) * OWN_BOX + in_box, 16, 1024),
                       wgmma_desc(b_tile + (ks >> 2) * STREAM_BOX + in_box, 16, 1024), ks > 0);
  }
}

// C (64 x D) += A B: A (64 x 64) as bf16 fragments in registers, B a streamed
// tile (64 x D, D contiguous: MN-major, the transpose bit set); four k-steps of
// 16 rows (2048 bytes of the tile each).
template <int D>
__device__ __forceinline__ void issue_fb(float (&c)[D / 2], const uint32_t (&af)[4][4], uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < HS / 16; ++kk) {
    const uint64_t db = wgmma_desc(b_tile + kk * 2048, STREAM_BOX, 1024);
    if constexpr (D == 64) {
      wgmma_rs_m64n64k16_tb(c, af[kk], db, 1);
    } else {
      wgmma_rs_m64n128k16_tb(c, af[kk], db, 1);
    }
  }
}

// A 64 x 64 f32 accumulator rounded to bf16 as the A fragments of the next
// product: k-step kk = n-tiles 2kk and 2kk + 1.
__device__ __forceinline__ void pack_fragments(uint32_t (&f)[4][4], const float (&c)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    f[j >> 1][(j & 1) * 2 + 0] = pack_bf16(c[4 * j], c[4 * j + 1]);
    f[j >> 1][(j & 1) * 2 + 1] = pack_bf16(c[4 * j + 2], c[4 * j + 3]);
  }
}

// This thread's part of rowsum(dO * O) for one row: the 16-byte chunks tig,
// tig + 4, ... of the D/8 (the four lanes of a row take turns, so a warp reads
// whole rows); 0 for a row >= Sq.
template <int D>
__device__ __forceinline__ float row_dot_part(const __nv_bfloat16* o, const __nv_bfloat16* g,
                                              Strides os, Strides gs, int b, int h, int row, int Sq,
                                              int tig) {
  float sum = 0.f;
  if (row < Sq) {
    const __nv_bfloat16* o_row = o + b * os.b + h * os.h + (long long)row * os.s;
    const __nv_bfloat16* g_row = g + b * gs.b + h * gs.h + (long long)row * gs.s;
#pragma unroll
    for (int c = tig; c < D / 8; c += 4) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o_row + c * 8);
      const uint4 gv = *reinterpret_cast<const uint4*>(g_row + c * 8);
      const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w}, gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = unpack_bf16(ow[e]), d = unpack_bf16(gw[e]);
        sum += a.x * d.x + a.y * d.y;
      }
    }
  }
  return sum;
}

// NCW consumer warpgroups (2, or 3 at D = 64 where the registers allow and the
// grid of 128-row tiles would leave a partial second wave).
template <int D, int NCW>
__global__ void __launch_bounds__(128 * (NCW + 1), 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int H,
    int Sq, int Skv, Strides os, Strides gs, float scale) {
  constexpr int HO = 64 * NCW;
  using L = BwdSmem<D, HO>;
  constexpr int CB = D / 64;  // 64-column boxes of a tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t own_full = base + L::BARS;
  auto full = [&](int s) { return own_full + 8u * (1 + s); };
  auto empty = [&](int s) { return own_full + 8u * (1 + HSTAGES + s); };

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * HO;
  const int n_kv = (Skv + HS - 1) / HS;
  const int n_cw = min(NCW, (Sq - q0 + 63) / 64);  // consumer warpgroups that own a row < Sq

  if (tid == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < HSTAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * n_cw);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (tid == 0) {
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_do);
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      mbar_arrive_expect_tx(own_full, 2 * L::OWN);
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        tma_load_4d(base + L::A + c * L::OWN_BOX, &tm_q, own_full, c * 64, h, q0, b);
        tma_load_4d(base + L::B + c * L::OWN_BOX, &tm_do, own_full, c * 64, h, q0, b);
      }
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % HSTAGES;
        if (t >= HSTAGES) mbar_wait(empty(s), ((t / HSTAGES) - 1) & 1);
        mbar_arrive_expect_tx(full(s), 2 * L::STREAM);
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          tma_load_4d(base + L::S0(s) + c * STREAM_BOX, &tm_k, full(s), c * 64, h, t * HS, b);
          tma_load_4d(base + L::S1(s) + c * STREAM_BOX, &tm_v, full(s), c * 64, h, t * HS, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns q rows 64 cw .. 64 cw + 63 of the tile ----
    setmaxnreg_inc<NCW == 2 ? 240 : 160>();  // 128 * (24 + NCW * that) <= 65,536
    const int cw = wg - 1;
    if (cw >= n_cw) return;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    const int r_lo = q0 + cw * 64 + warp * 16 + g;  // this thread's rows r_lo, r_hi
    const int r_hi = r_lo + 8;

    // delta = rowsum(dO * O) in f32 while the first tiles load
    float dl_lo = row_dot_part<D>(o, dout, os, gs, b, h, r_lo, Sq, tig);
    float dl_hi = row_dot_part<D>(o, dout, os, gs, b, h, r_hi, Sq, tig);
    dl_lo += __shfl_xor_sync(0xffffffffu, dl_lo, 1);
    dl_lo += __shfl_xor_sync(0xffffffffu, dl_lo, 2);
    dl_hi += __shfl_xor_sync(0xffffffffu, dl_hi, 1);
    dl_hi += __shfl_xor_sync(0xffffffffu, dl_hi, 2);
    if (tig == 0) {
      if (r_lo < Sq) delta[(long long)bh * Sq + r_lo] = dl_lo;
      if (r_hi < Sq) delta[(long long)bh * Sq + r_hi] = dl_hi;
    }
    // lse in the base-2 domain; +inf past Sq makes P = 0 there
    const float inf = __int_as_float(0x7f800000u);
    const float l_lo = r_lo < Sq ? lse[(long long)bh * Sq + r_lo] * LOG2E : inf;
    const float l_hi = r_hi < Sq ? lse[(long long)bh * Sq + r_hi] * LOG2E : inf;
    const float scale_log2 = scale * LOG2E;

    const uint32_t q_wg = base + L::A + cw * 64 * 128;
    const uint32_t do_wg = base + L::B + cw * 64 * 128;
    float acc[D / 2], sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    uint32_t dsf[4][4];

    mbar_wait(own_full, 0);
    for (int t = 0; t < n_kv; ++t) {
      const int s = t % HSTAGES;
      mbar_wait(full(s), (t / HSTAGES) & 1);
      fence_operands(sc);
      fence_operands(dp);
      wgmma_fence();
      issue_abt<D, L::OWN_BOX>(sc, q_wg, base + L::S0(s));  // S = Q K^T
      wgmma_commit_group();
      issue_abt<D, L::OWN_BOX>(dp, do_wg, base + L::S1(s));  // dP = dO V^T
      wgmma_commit_group();
      wgmma_wait_group<1>();
      fence_operands(sc);
      const int kvalid = Skv - t * HS;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * tig;
        sc[4 * j] = fast_exp2(fmaf(sc[4 * j], scale_log2, -l_lo));
        sc[4 * j + 1] = fast_exp2(fmaf(sc[4 * j + 1], scale_log2, -l_lo));
        sc[4 * j + 2] = fast_exp2(fmaf(sc[4 * j + 2], scale_log2, -l_hi));
        sc[4 * j + 3] = fast_exp2(fmaf(sc[4 * j + 3], scale_log2, -l_hi));
        if (kvalid < HS) {  // the last tile: kv columns >= Skv
          if (col >= kvalid) sc[4 * j] = sc[4 * j + 2] = 0.f;
          if (col + 1 >= kvalid) sc[4 * j + 1] = sc[4 * j + 3] = 0.f;
        }
      }
      wgmma_wait_group<0>();
      fence_operands(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dp[4 * j] = sc[4 * j] * (dp[4 * j] - dl_lo);
        dp[4 * j + 1] = sc[4 * j + 1] * (dp[4 * j + 1] - dl_lo);
        dp[4 * j + 2] = sc[4 * j + 2] * (dp[4 * j + 2] - dl_hi);
        dp[4 * j + 3] = sc[4 * j + 3] * (dp[4 * j + 3] - dl_hi);
      }
      pack_fragments(dsf, dp);
      fence_fragments(dsf);
      fence_operands(acc);
      wgmma_fence();
      issue_fb<D>(acc, dsf, base + L::S0(s));  // dQ += dS K
      wgmma_commit_group();
      wgmma_wait_group<0>();
      fence_operands(acc);
      fence_fragments(dsf);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
    }

    // ---- epilogue: dQ = scale * acc, rows < Sq ----
    const long long o_ss = (long long)H * D;
    __nv_bfloat16* dq_base = dq + (long long)b * Sq * o_ss + (long long)h * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * tig;
      if (r_lo < Sq)
        *reinterpret_cast<uint32_t*>(dq_base + (long long)r_lo * o_ss + c) =
            pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);
      if (r_hi < Sq)
        *reinterpret_cast<uint32_t*>(dq_base + (long long)r_hi * o_ss + c) =
            pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
    }
  }
}

// splits == 1: dk, dv (B, Skv, H, D) bf16 are written directly. splits > 1:
// block (x, y, z) streams the z-th chunk of the q tiles and writes its f32
// partial dK (without the scale) and dV to partial[z][0 or 1][bh][kv][d].
template <int D>
__global__ void __launch_bounds__(384, 1) flash_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, float* __restrict__ partial, int H, int Sq, int Skv,
    float scale) {
  constexpr int HO = 128;  // two consumer warpgroups
  using L = BwdSmem<D, HO>;
  constexpr int CB = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* rows = reinterpret_cast<float*>(smem_raw + (base - raw) + L::ROWS);  // [stage][lse | delta][HS]
  const uint32_t own_full = base + L::BARS;
  auto full = [&](int s) { return own_full + 8u * (1 + s); };
  auto empty = [&](int s) { return own_full + 8u * (1 + HSTAGES + s); };

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kv0 = blockIdx.x * HO;
  const int splits = gridDim.z;
  const int n_q = (Sq + HS - 1) / HS;
  const int t_lo = (int)((long long)blockIdx.z * n_q / splits);  // this block's q tiles t_lo .. t_hi - 1
  const int n_t = (int)((long long)(blockIdx.z + 1) * n_q / splits) - t_lo;
  const int n_cw = Skv - kv0 > 64 ? 2 : 1;  // consumer warpgroups that own a row < Skv

  if (tid == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < HSTAGES; ++s) {
      mbar_init(full(s), 1 + 32);  // the TMA thread and the 32 lanes of the row warp
      mbar_init(empty(s), 4 * n_cw);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: thread 0 issues the TMA loads, warp 1 the lse and delta rows ----
    setmaxnreg_dec<24>();
    const int pw = tid >> 5;
    if (tid == 0) {
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_do);
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      mbar_arrive_expect_tx(own_full, 2 * L::OWN);
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        tma_load_4d(base + L::A + c * L::OWN_BOX, &tm_k, own_full, c * 64, h, kv0, b);
        tma_load_4d(base + L::B + c * L::OWN_BOX, &tm_v, own_full, c * 64, h, kv0, b);
      }
      for (int i = 0; i < n_t; ++i) {
        const int s = i % HSTAGES;
        if (i >= HSTAGES) mbar_wait(empty(s), ((i / HSTAGES) - 1) & 1);
        mbar_arrive_expect_tx(full(s), 2 * L::STREAM);
        const int r0 = (t_lo + i) * HS;
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          tma_load_4d(base + L::S0(s) + c * STREAM_BOX, &tm_q, full(s), c * 64, h, r0, b);
          tma_load_4d(base + L::S1(s) + c * STREAM_BOX, &tm_do, full(s), c * 64, h, r0, b);
        }
      }
    } else if (pw == 1) {
      const int lane = tid & 31;
      const float inf = __int_as_float(0x7f800000u);
      for (int i = 0; i < n_t; ++i) {
        const int s = i % HSTAGES;
        if (i >= HSTAGES) mbar_wait(empty(s), ((i / HSTAGES) - 1) & 1);
        float* lse_s = rows + s * 2 * HS;
#pragma unroll
        for (int r = lane; r < HS; r += 32) {
          const int q = (t_lo + i) * HS + r;
          const bool ok = q < Sq;
          lse_s[r] = ok ? lse[(long long)bh * Sq + q] * LOG2E : inf;
          lse_s[HS + r] = ok ? delta[(long long)bh * Sq + q] : 0.f;
        }
        mbar_arrive(full(s));  // releases this lane's rows to the consumers
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns kv rows 64 cw .. 64 cw + 63 of the tile ----
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    if (cw >= n_cw) return;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    const float scale_log2 = scale * LOG2E;
    const uint32_t k_wg = base + L::A + cw * 64 * 128;
    const uint32_t v_wg = base + L::B + cw * 64 * 128;

    float acc_k[D / 2], acc_v[D / 2], st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    uint32_t pf[4][4], dsf[4][4];

    mbar_wait(own_full, 0);
    for (int i = 0; i < n_t; ++i) {
      const int s = i % HSTAGES;
      mbar_wait(full(s), (i / HSTAGES) & 1);
      fence_operands(st);
      fence_operands(dpt);
      wgmma_fence();
      issue_abt<D, L::OWN_BOX>(st, k_wg, base + L::S0(s));  // S^T = K Q^T
      wgmma_commit_group();
      issue_abt<D, L::OWN_BOX>(dpt, v_wg, base + L::S1(s));  // dP^T = V dO^T
      wgmma_commit_group();
      // columns are q rows: this thread's 8j + 2 tig (+1), their lse and delta
      const float* lse_s = rows + s * 2 * HS;
      wgmma_wait_group<1>();
      fence_operands(st);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * tig);
        st[4 * j] = fast_exp2(fmaf(st[4 * j], scale_log2, -l.x));
        st[4 * j + 1] = fast_exp2(fmaf(st[4 * j + 1], scale_log2, -l.y));
        st[4 * j + 2] = fast_exp2(fmaf(st[4 * j + 2], scale_log2, -l.x));
        st[4 * j + 3] = fast_exp2(fmaf(st[4 * j + 3], scale_log2, -l.y));
      }
      pack_fragments(pf, st);
      wgmma_wait_group<0>();
      fence_operands(dpt);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(lse_s + HS + 8 * j + 2 * tig);
        dpt[4 * j] = st[4 * j] * (dpt[4 * j] - dl.x);
        dpt[4 * j + 1] = st[4 * j + 1] * (dpt[4 * j + 1] - dl.y);
        dpt[4 * j + 2] = st[4 * j + 2] * (dpt[4 * j + 2] - dl.x);
        dpt[4 * j + 3] = st[4 * j + 3] * (dpt[4 * j + 3] - dl.y);
      }
      pack_fragments(dsf, dpt);
      fence_fragments(pf);
      fence_fragments(dsf);
      fence_operands(acc_v);
      fence_operands(acc_k);
      wgmma_fence();
      issue_fb<D>(acc_v, pf, base + L::S1(s));   // dV += P^T dO
      issue_fb<D>(acc_k, dsf, base + L::S0(s));  // dK += dS^T Q
      wgmma_commit_group();
      wgmma_wait_group<0>();
      fence_operands(acc_v);
      fence_operands(acc_k);
      fence_fragments(pf);
      fence_fragments(dsf);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
    }

    // ---- epilogue: kv rows < Skv ----
    const int c_lo = kv0 + cw * 64 + warp * 16 + g;
    const int c_hi = c_lo + 8;
    if (splits == 1) {
      const long long o_ss = (long long)H * D;
      const long long off = (long long)b * Skv * o_ss + (long long)h * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = 8 * j + 2 * tig;
        if (c_lo < Skv) {
          *reinterpret_cast<uint32_t*>(dk + off + (long long)c_lo * o_ss + c) =
              pack_bf16(acc_k[4 * j] * scale, acc_k[4 * j + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + off + (long long)c_lo * o_ss + c) =
              pack_bf16(acc_v[4 * j], acc_v[4 * j + 1]);
        }
        if (c_hi < Skv) {
          *reinterpret_cast<uint32_t*>(dk + off + (long long)c_hi * o_ss + c) =
              pack_bf16(acc_k[4 * j + 2] * scale, acc_k[4 * j + 3] * scale);
          *reinterpret_cast<uint32_t*>(dv + off + (long long)c_hi * o_ss + c) =
              pack_bf16(acc_v[4 * j + 2], acc_v[4 * j + 3]);
        }
      }
    } else {
      const long long per = (long long)gridDim.y * Skv * D;  // elements of one partial dK or dV
      float* pk = partial + (2 * (long long)blockIdx.z) * per + (long long)bh * Skv * D;
      float* pv = pk + per;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int c = 8 * j + 2 * tig;
        if (c_lo < Skv) {
          *reinterpret_cast<float2*>(pk + (long long)c_lo * D + c) = make_float2(acc_k[4 * j], acc_k[4 * j + 1]);
          *reinterpret_cast<float2*>(pv + (long long)c_lo * D + c) = make_float2(acc_v[4 * j], acc_v[4 * j + 1]);
        }
        if (c_hi < Skv) {
          *reinterpret_cast<float2*>(pk + (long long)c_hi * D + c) =
              make_float2(acc_k[4 * j + 2], acc_k[4 * j + 3]);
          *reinterpret_cast<float2*>(pv + (long long)c_hi * D + c) =
              make_float2(acc_v[4 * j + 2], acc_v[4 * j + 3]);
        }
      }
    }
  }
}

// dK = scale * sum_z partial[z][0], dV = sum_z partial[z][1], the chunks added in
// order z = 0, 1, ... in f32, rounded to bf16 into (B, Skv, H, D); four
// elements a thread per step.
__global__ void __launch_bounds__(256) flash_bwd_dkv_reduce_kernel(
    const float* __restrict__ partial, __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    int splits, int BH, int H, int Skv, int D, float scale) {
  const long long per = (long long)BH * Skv * D;
  const long long n4 = 2 * per / 4;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = 4 * i;
    const int which = e >= per;  // 0: dK, 1: dV
    const long long r = e - which * per;
    const float* p = partial + which * per + r;
    float4 sum = *reinterpret_cast<const float4*>(p);
#pragma unroll 8  // loads issued ahead; the adds stay in chunk order
    for (int z = 1; z < splits; ++z) {
      const float4 x = *reinterpret_cast<const float4*>(p + 2 * per * z);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const float mul = which == 0 ? scale : 1.f;
    const int d = (int)(r % D);
    const long long row = r / D;  // bh * Skv + kv
    const int kv = (int)(row % Skv);
    const int bh = (int)(row / Skv);
    __nv_bfloat16* out = (which == 0 ? dk : dv) + (((long long)(bh / H) * Skv + kv) * H + bh % H) * D + d;
    *reinterpret_cast<uint2*>(out) =
        make_uint2(pack_bf16(sum.x * mul, sum.y * mul), pack_bf16(sum.z * mul, sum.w * mul));
  }
}

template <int D, int NCW>
int launch_dq_wgmma(const void* q, const void* k, const void* v, const void* o, const void* dout,
                    const float* lse, float* delta, void* dq, int B, int H, int Sq, int Skv,
                    const long long* st, float scale, cudaStream_t stream) {
  constexpr int HO = 64 * NCW;
  using L = BwdSmem<D, HO>;
  static SmemOptIn opt;
  int code = opt_in_smem(opt, (const void*)flash_bwd_dq_wgmma_kernel<D, NCW>, L::BYTES);
  if (code != 0) return code;
  CUtensorMap tq, tdo, tk, tv;
  code = encode_bshd(&tq, q, B, Sq, H, D, st[0], st[1], st[2], HO);
  if (code == 0) code = encode_bshd(&tk, k, B, Skv, H, D, st[3], st[4], st[5], HS);
  if (code == 0) code = encode_bshd(&tv, v, B, Skv, H, D, st[6], st[7], st[8], HS);
  if (code == 0) code = encode_bshd(&tdo, dout, B, Sq, H, D, st[12], st[13], st[14], HO);
  if (code != 0) return code;
  dim3 grid((Sq + HO - 1) / HO, B * H);
  flash_bwd_dq_wgmma_kernel<D, NCW><<<grid, 128 * (NCW + 1), L::BYTES, stream>>>(
      tq, tdo, tk, tv, (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, lse, delta,
      (__nv_bfloat16*)dq, H, Sq, Skv, Strides{st[9], st[10], st[11]}, Strides{st[12], st[13], st[14]},
      scale);
  return (int)cudaGetLastError();
}

// Three consumer warpgroups (192-row q tiles) at D = 64 where they take fewer
// waves of blocks times rows a block than two do on the current device's SMs
// (q(1,4096,5,64) on an H100's 132: 110 blocks in one wave instead of 160 in two).
int dq_warpgroups(int B, int H, int Sq, int D) {
  if (D != 64) return 2;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms < 1)
    return 2;
  const long long waves2 = ((long long)(Sq + 127) / 128 * B * H + sms - 1) / sms;
  const long long waves3 = ((long long)(Sq + 191) / 192 * B * H + sms - 1) / sms;
  return 3 * waves3 < 2 * waves2 ? 3 : 2;
}

template <int D>
int launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dk, void* dv, int B, int H, int Sq,
                     int Skv, const long long* st, float scale, int splits, float* partial,
                     cudaStream_t stream) {
  constexpr int HO = 128;  // ops/flash_attention.DKV_BLOCK_ROWS
  using L = BwdSmem<D, HO>;
  if (splits < 1 || splits > (Sq + HS - 1) / HS || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  static SmemOptIn opt;
  int code = opt_in_smem(opt, (const void*)flash_bwd_dkv_wgmma_kernel<D>, L::BYTES);
  if (code != 0) return code;
  CUtensorMap tq, tdo, tk, tv;
  code = encode_bshd(&tq, q, B, Sq, H, D, st[0], st[1], st[2], HS);
  if (code == 0) code = encode_bshd(&tk, k, B, Skv, H, D, st[3], st[4], st[5], HO);
  if (code == 0) code = encode_bshd(&tv, v, B, Skv, H, D, st[6], st[7], st[8], HO);
  if (code == 0) code = encode_bshd(&tdo, dout, B, Sq, H, D, st[9], st[10], st[11], HS);
  if (code != 0) return code;
  dim3 grid((Skv + HO - 1) / HO, B * H, splits);
  flash_bwd_dkv_wgmma_kernel<D><<<grid, 384, L::BYTES, stream>>>(
      tq, tdo, tk, tv, lse, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, partial, H, Sq, Skv, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long n4 = 2LL * B * H * Skv * D / 4;
  const int blocks = (int)((n4 + 255) / 256 < 4096 ? (n4 + 255) / 256 : 4096);
  flash_bwd_dkv_reduce_kernel<<<blocks, 256, 0, stream>>>(partial, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
                                                          splits, B * H, H, Skv, D, scale);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------------------
// bf16 path at D = 512 (the VAE mid block's single head). At this width a warp
// cannot keep 16 rows of operand fragments and a 16 x 512 accumulator in
// registers (the dK/dV kernel would need two), so the eight warps of a block
// split the work and exchange the score tiles through shared memory, as the
// forward's flash_fwd_wide_kernel does: the owned rows and the streamed tiles
// are staged as bf16 (rows padded by 16 bytes) and read by ldmatrix; the
// score products give each warp a 16 x 16 block (rows (warp % R) * 16, two
// n-tiles), whose P and dS are written as bf16 tiles; the output products
// give each warp 16 rows by a quarter or a half of D. Each output element is
// still summed by one thread in one fixed order: no atomics.
// ----------------------------------------------------------------------------

constexpr int WNT = 256;  // eight warps
constexpr int WQ = 64;    // q rows owned by a dQ block, streamed by a dK/dV block
constexpr int WK = 32;    // kv rows streamed by a dQ block, owned by a dK/dV block

template <int D>
constexpr int wide_dq_smem_bytes() {
  return (2 * WQ + 2 * WK) * (D + 8) * 2 + WQ * (WK + 8) * 2 + 2 * WQ * 4;
}

template <int D>
constexpr int wide_dkv_smem_bytes() {
  return (2 * WK + 2 * WQ) * (D + 8) * 2 + 2 * WK * (WQ + 8) * 2 + 2 * WQ * 4;
}

// dQ at D = 512: a block owns WQ = 64 q rows (Q and dO staged once) and streams
// WK = 32-row K and V tiles. Warp (rw, cw) = (warp % 4, warp / 4) makes the S
// and dP blocks of q rows rw*16.. and kv columns cw*16.., writes dS as bf16,
// and accumulates dQ for q rows rw*16.. and the columns cw*D/2.. (a 16 x 256
// f32 accumulator). Shared memory: Q and dO 64 x 520, K and V 32 x 520, dS
// 64 x 40 bf16, lse and delta 64 f32: 205,312 bytes at D = 512.
template <int D>
__global__ void __launch_bounds__(WNT, 1) flash_bwd_dq_wide_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int H, int Sq, int Skv, Strides qs,
    Strides ks, Strides vs, Strides os, Strides gs, float scale) {
  constexpr int LD = D + 8;
  constexpr int LP = WK + 8;
  constexpr int KS = D / 16;
  constexpr int NW = D / 16;  // n-tiles of a warp's half of D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Gs = Qs + WQ * LD;  // dO
  __nv_bfloat16* Ks = Gs + WQ * LD;
  __nv_bfloat16* Vs = Ks + WK * LD;
  __nv_bfloat16* Ds = Vs + WK * LD;  // dS
  float* lse_s = reinterpret_cast<float*>(Ds + WQ * LP);
  float* delta_s = lse_s + WQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int rw = warp & 3;
  const int cw = warp >> 2;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * WQ;
  const int qvalid = min(WQ, Sq - q0);

  const __nv_bfloat16* k_base = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* v_base = v + b * vs.b + h * vs.h;

  stage_rows_bf16<D, WQ, WNT>(Qs, q + b * qs.b + h * qs.h + (long long)q0 * qs.s, qs.s, qvalid);
  stage_rows_bf16<D, WQ, WNT>(Gs, dout + b * gs.b + h * gs.h + (long long)q0 * gs.s, gs.s, qvalid);
  __syncthreads();

  // delta = rowsum(dO * O) in f32; four neighbouring lanes share one row
  {
    const int row = tid >> 2;
    const int part = tid & 3;
    float sum = 0.f;
    if (row < qvalid) {
      const __nv_bfloat16* o_row = o + b * os.b + h * os.h + (long long)(q0 + row) * os.s;
      for (int vv = part; vv < D / 8; vv += 4) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o_row + vv * 8);
        const uint4 gv = *reinterpret_cast<const uint4*>(Gs + row * LD + vv * 8);
        const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w}, gw[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = unpack_bf16(ow[e]), c = unpack_bf16(gw[e]);
          sum += a.x * c.x + a.y * c.y;
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      delta_s[row] = sum;
      lse_s[row] = 0.f;
      if (row < qvalid) {
        lse_s[row] = lse[(long long)bh * Sq + q0 + row];
        delta[(long long)bh * Sq + q0 + row] = sum;
      }
    }
  }

  float acc[NW][4];
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kv0 = 0; kv0 < Skv; kv0 += WK) {
    const int kvalid = min(WK, Skv - kv0);
    __syncthreads();  // the previous tile's readers are done; lse_s / delta_s are written
    stage_rows_bf16<D, WK, WNT>(Ks, k_base + (long long)kv0 * ks.s, ks.s, kvalid);
    stage_rows_bf16<D, WK, WNT>(Vs, v_base + (long long)kv0 * vs.s, vs.s, kvalid);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for rows rw*16.. and kv columns cw*16..
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
    for (int ksi = 0; ksi < KS; ++ksi) {
      uint32_t qf[4], gf[4], kf[4], vf[4];
      ldmatrix_a(qf, Qs, LD, rw * 16, ksi * 16, lane);
      ldmatrix_a(gf, Gs, LD, rw * 16, ksi * 16, lane);
      ldmatrix_b2(kf, Ks, LD, cw * 16, ksi * 16, lane);
      ldmatrix_b2(vf, Vs, LD, cw * 16, ksi * 16, lane);
      mma_bf16(s[0], qf, kf[0], kf[1]);
      mma_bf16(s[1], qf, kf[2], kf[3]);
      mma_bf16(dp[0], gf, vf[0], vf[1]);
      mma_bf16(dp[1], gf, vf[2], vf[3]);
    }
    // dS = P (dP - delta), P = exp(scale S - lse); masked kv columns are 0
    {
      const int r = rw * 16 + g;
      const float l_lo = lse_s[r], l_hi = lse_s[r + 8];
      const float d_lo = delta_s[r], d_hi = delta_s[r + 8];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = cw * 16 + j * 8 + tig * 2;
        const bool ok0 = col < kvalid, ok1 = col + 1 < kvalid;
        const float p0 = ok0 ? __expf(s[j][0] * scale - l_lo) : 0.f;
        const float p1 = ok1 ? __expf(s[j][1] * scale - l_lo) : 0.f;
        const float p2 = ok0 ? __expf(s[j][2] * scale - l_hi) : 0.f;
        const float p3 = ok1 ? __expf(s[j][3] * scale - l_hi) : 0.f;
        *reinterpret_cast<uint32_t*>(Ds + r * LP + col) =
            pack_bf16(p0 * (dp[j][0] - d_lo), p1 * (dp[j][1] - d_lo));
        *reinterpret_cast<uint32_t*>(Ds + (r + 8) * LP + col) =
            pack_bf16(p2 * (dp[j][2] - d_hi), p3 * (dp[j][3] - d_hi));
      }
    }
    __syncthreads();

    // dQ += dS K over rows rw*16.. and columns cw*D/2..
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_a(af, Ds, LP, rw * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < NW; j += 2) {
        uint32_t kf[4];
        ldmatrix_b2_trans(kf, Ks, LD, kk * 16, cw * (D / 2) + j * 8, lane);
        mma_bf16(acc[j], af, kf[0], kf[1]);
        mma_bf16(acc[j + 1], af, kf[2], kf[3]);
      }
    }
  }

  const long long o_ss = (long long)H * D;
  __nv_bfloat16* dq_base = dq + (long long)b * Sq * o_ss + (long long)h * D;
  const int r_lo = q0 + rw * 16 + g, r_hi = r_lo + 8;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int c = cw * (D / 2) + j * 8 + tig * 2;
    if (r_lo < Sq)
      *reinterpret_cast<uint32_t*>(dq_base + (long long)r_lo * o_ss + c) =
          pack_bf16(acc[j][0] * scale, acc[j][1] * scale);
    if (r_hi < Sq)
      *reinterpret_cast<uint32_t*>(dq_base + (long long)r_hi * o_ss + c) =
          pack_bf16(acc[j][2] * scale, acc[j][3] * scale);
  }
}

// dK/dV at D = 512: a block owns WK = 32 kv rows (K and V staged once) and
// streams WQ = 64-row Q and dO tiles with their log-sum-exp and delta. Warp
// (rw, cw) = (warp % 2, warp / 2) makes the transposed score blocks S^T and
// dP^T of kv rows rw*16.. and q columns cw*16.., writes P^T and dS^T as bf16,
// and accumulates dV and dK for kv rows rw*16.. and the columns cw*D/4.. (two
// 16 x 128 f32 accumulators). Shared memory: K and V 32 x 520, Q and dO 64 x
// 520, P^T and dS^T 32 x 72 bf16, lse and delta 64 f32: 209,408 bytes at
// D = 512.
template <int D>
__global__ void __launch_bounds__(WNT, 1) flash_bwd_dkv_wide_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int H, int Sq, int Skv, Strides qs, Strides ks, Strides vs,
    Strides gs, float scale) {
  constexpr int LD = D + 8;
  constexpr int LP = WQ + 8;
  constexpr int KS = D / 16;
  constexpr int NW = D / 32;  // n-tiles of a warp's quarter of D
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + WK * LD;
  __nv_bfloat16* Qs = Vs + WK * LD;
  __nv_bfloat16* Gs = Qs + WQ * LD;  // dO
  __nv_bfloat16* Pt = Gs + WQ * LD;  // P^T
  __nv_bfloat16* Dt = Pt + WK * LP;  // dS^T
  float* lse_s = reinterpret_cast<float*>(Dt + WK * LP);
  float* delta_s = lse_s + WQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int rw = warp & 1;
  const int cw = warp >> 1;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kv0 = blockIdx.x * WK;
  const int kvalid = min(WK, Skv - kv0);

  const __nv_bfloat16* q_base = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* g_base = dout + b * gs.b + h * gs.h;

  stage_rows_bf16<D, WK, WNT>(Ks, k + b * ks.b + h * ks.h + (long long)kv0 * ks.s, ks.s, kvalid);
  stage_rows_bf16<D, WK, WNT>(Vs, v + b * vs.b + h * vs.h + (long long)kv0 * vs.s, vs.s, kvalid);

  float acc_k[NW][4], acc_v[NW][4];
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_k[j][e] = 0.f;
      acc_v[j][e] = 0.f;
    }

  const int c_lo = rw * 16 + g, c_hi = c_lo + 8;  // kv rows of this thread in the tile
  for (int q0 = 0; q0 < Sq; q0 += WQ) {
    const int qvalid = min(WQ, Sq - q0);
    __syncthreads();  // the previous tile's readers are done
    stage_rows_bf16<D, WQ, WNT>(Qs, q_base + (long long)q0 * qs.s, qs.s, qvalid);
    stage_rows_bf16<D, WQ, WNT>(Gs, g_base + (long long)q0 * gs.s, gs.s, qvalid);
    if (tid < WQ) {
      const bool ok = tid < qvalid;
      lse_s[tid] = ok ? lse[(long long)bh * Sq + q0 + tid] : 0.f;
      delta_s[tid] = ok ? delta[(long long)bh * Sq + q0 + tid] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for kv rows rw*16.. and q columns cw*16..
    float st[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float dpt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
    for (int ksi = 0; ksi < KS; ++ksi) {
      uint32_t kf[4], vf[4], qf[4], gf[4];
      ldmatrix_a(kf, Ks, LD, rw * 16, ksi * 16, lane);
      ldmatrix_a(vf, Vs, LD, rw * 16, ksi * 16, lane);
      ldmatrix_b2(qf, Qs, LD, cw * 16, ksi * 16, lane);
      ldmatrix_b2(gf, Gs, LD, cw * 16, ksi * 16, lane);
      mma_bf16(st[0], kf, qf[0], qf[1]);
      mma_bf16(st[1], kf, qf[2], qf[3]);
      mma_bf16(dpt[0], vf, gf[0], gf[1]);
      mma_bf16(dpt[1], vf, gf[2], gf[3]);
    }
    // P^T and dS^T; kv rows >= kvalid and q columns >= qvalid are 0
    {
      const bool lo_ok = c_lo < kvalid, hi_ok = c_hi < kvalid;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = cw * 16 + j * 8 + tig * 2;  // q column of this thread's first value
        const float l0 = lse_s[r], l1 = lse_s[r + 1];
        const float d0 = delta_s[r], d1 = delta_s[r + 1];
        const bool q0ok = r < qvalid, q1ok = r + 1 < qvalid;
        const float p0 = (q0ok && lo_ok) ? __expf(st[j][0] * scale - l0) : 0.f;
        const float p1 = (q1ok && lo_ok) ? __expf(st[j][1] * scale - l1) : 0.f;
        const float p2 = (q0ok && hi_ok) ? __expf(st[j][2] * scale - l0) : 0.f;
        const float p3 = (q1ok && hi_ok) ? __expf(st[j][3] * scale - l1) : 0.f;
        *reinterpret_cast<uint32_t*>(Pt + c_lo * LP + r) = pack_bf16(p0, p1);
        *reinterpret_cast<uint32_t*>(Pt + c_hi * LP + r) = pack_bf16(p2, p3);
        *reinterpret_cast<uint32_t*>(Dt + c_lo * LP + r) =
            pack_bf16(p0 * (dpt[j][0] - d0), p1 * (dpt[j][1] - d1));
        *reinterpret_cast<uint32_t*>(Dt + c_hi * LP + r) =
            pack_bf16(p2 * (dpt[j][2] - d0), p3 * (dpt[j][3] - d1));
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over kv rows rw*16.. and columns cw*D/4..
#pragma unroll
    for (int kk = 0; kk < WQ / 16; ++kk) {
      uint32_t pf[4], df[4];
      ldmatrix_a(pf, Pt, LP, rw * 16, kk * 16, lane);
      ldmatrix_a(df, Dt, LP, rw * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < NW; j += 2) {
        uint32_t gf[4], qf[4];
        ldmatrix_b2_trans(gf, Gs, LD, kk * 16, cw * (D / 4) + j * 8, lane);
        mma_bf16(acc_v[j], pf, gf[0], gf[1]);
        mma_bf16(acc_v[j + 1], pf, gf[2], gf[3]);
        ldmatrix_b2_trans(qf, Qs, LD, kk * 16, cw * (D / 4) + j * 8, lane);
        mma_bf16(acc_k[j], df, qf[0], qf[1]);
        mma_bf16(acc_k[j + 1], df, qf[2], qf[3]);
      }
    }
  }

  const long long o_ss = (long long)H * D;
  const long long base = (long long)b * Skv * o_ss + (long long)h * D;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int c = cw * (D / 4) + j * 8 + tig * 2;
    if (kv0 + c_lo < Skv) {
      *reinterpret_cast<uint32_t*>(dk + base + (long long)(kv0 + c_lo) * o_ss + c) =
          pack_bf16(acc_k[j][0] * scale, acc_k[j][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + (long long)(kv0 + c_lo) * o_ss + c) =
          pack_bf16(acc_v[j][0], acc_v[j][1]);
    }
    if (kv0 + c_hi < Skv) {
      *reinterpret_cast<uint32_t*>(dk + base + (long long)(kv0 + c_hi) * o_ss + c) =
          pack_bf16(acc_k[j][2] * scale, acc_k[j][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + (long long)(kv0 + c_hi) * o_ss + c) =
          pack_bf16(acc_v[j][2], acc_v[j][3]);
    }
  }
}

template <int D>
int launch_dq_wide(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, int B, int H, int Sq, int Skv,
                   const long long* st, float scale, cudaStream_t stream) {
  constexpr int smem_bytes = wide_dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_wide_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + WQ - 1) / WQ, B * H);
  flash_bwd_dq_wide_kernel<D><<<grid, WNT, smem_bytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, lse, delta, (__nv_bfloat16*)dq, H, Sq,
      Skv, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14]}, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_wide(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, int B, int H, int Sq,
                    int Skv, const long long* st, float scale, cudaStream_t stream) {
  constexpr int smem_bytes = wide_dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_wide_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Skv + WK - 1) / WK, B * H);
  flash_bwd_dkv_wide_kernel<D><<<grid, WNT, smem_bytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, lse, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, H, Sq, Skv,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout (B,Sq,H,D) and k, v (B,Skv,H,D) are read through element strides
// (batch, seq, head for each, in the order q, k, v, o, dout; the D axis is
// contiguous and every row start 16-byte aligned). lse is the forward's
// contiguous (B*H,Sq) f32 log-sum-exp. Writes dq, a contiguous (B,Sq,H,D), and
// delta, a contiguous (B*H,Sq) f32. dtype: 0 = bf16 (tensor-core kernels), 1 =
// f32 (FMA kernels); D: 64, 128 or 512. Returns 0, a CUDA error code, or -1 for
// an unsupported dtype / head dim.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const float* lse, float* delta, void* dq,
                                      int dtype, int B, int H, int Sq, int Skv, int D,
                                      const long long* strides, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define OMGSR_DQ(launcher) \
  return launcher(q, k, v, o, dout, lse, delta, dq, B, H, Sq, Skv, strides, scale, s)
  if (dtype == 0 && D == 64 && dq_warpgroups(B, H, Sq, D) == 3) OMGSR_DQ((launch_dq_wgmma<64, 3>));
  if (dtype == 0 && D == 64) OMGSR_DQ((launch_dq_wgmma<64, 2>));
  if (dtype == 0 && D == 128) OMGSR_DQ((launch_dq_wgmma<128, 2>));
  if (dtype == 0 && D == 512) OMGSR_DQ(launch_dq_wide<512>);
  if (dtype == 1 && D == 64) OMGSR_DQ((launch_dq<float, 64, 64, 64>));
  if (dtype == 1 && D == 128) OMGSR_DQ((launch_dq<float, 128, 64, 64>));
  if (dtype == 1 && D == 512) OMGSR_DQ((launch_dq<float, 512, 32, 16>));
#undef OMGSR_DQ
  return -1;
}

// Same operands, strides in the order q, k, v, dout; reads the delta that
// flash_attention_bwd_dq wrote. Writes dk and dv, contiguous (B,Skv,H,D).
// `splits` > 1 (bf16 at D = 64 and 128 only, at most ceil(Sq / 64)) splits the
// q loop into that many chunks, whose f32 partials go to `partial`, a
// contiguous f32 (splits, 2, B*H, Skv, D) scratch buffer, and are then added
// in chunk order by a second kernel launched on the same stream.
extern "C" int flash_attention_bwd_dkv_split(const void* q, const void* k, const void* v,
                                             const void* dout, const float* lse, const float* delta,
                                             void* dk, void* dv, int dtype, int B, int H, int Sq,
                                             int Skv, int D, const long long* strides, float scale,
                                             int splits, float* partial, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && D == 64)
    return launch_dkv_wgmma<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, strides, scale, splits,
                                partial, s);
  if (dtype == 0 && D == 128)
    return launch_dkv_wgmma<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, strides, scale,
                                 splits, partial, s);
  if (splits != 1) return -1;
#define OMGSR_DKV(launcher) \
  return launcher(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, strides, scale, s)
  if (dtype == 0 && D == 512) OMGSR_DKV(launch_dkv_wide<512>);
  if (dtype == 1 && D == 64) OMGSR_DKV((launch_dkv<float, 64, 64, 64>));
  if (dtype == 1 && D == 128) OMGSR_DKV((launch_dkv<float, 128, 64, 64>));
  if (dtype == 1 && D == 512) OMGSR_DKV((launch_dkv<float, 512, 16, 32>));
#undef OMGSR_DKV
  return -1;
}

// The same without a split of the q loop.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       void* dk, void* dv, int dtype, int B, int H, int Sq,
                                       int Skv, int D, const long long* strides, float scale,
                                       void* stream) {
  return flash_attention_bwd_dkv_split(q, k, v, dout, lse, delta, dk, dv, dtype, B, H, Sq, Skv, D, strides,
                                       scale, 1, nullptr, stream);
}
