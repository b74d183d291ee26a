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
//     kernels through TMA tensor maps built from them) and
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
//   * flash_bwd_dq_wide_wgmma_kernel / flash_bwd_dkv_wide_wgmma_kernel (bf16
//     inputs, D = 512): the same Hopper path on clusters of two CTAs that
//     share an owned tile and hand score tiles to each other through
//     distributed shared memory; described where they are defined.

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

// C (64 x D) += A B: A (64 x 64) as bf16 fragments in registers, B the D
// columns of a streamed tile from the box at b_tile on (64 rows, columns
// contiguous: MN-major, the transpose bit set); four k-steps of 16 rows (2048
// bytes of each box).
template <int D>
__device__ __forceinline__ void issue_fb(float (&c)[D / 2], const uint32_t (&af)[4][4], uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < HS / 16; ++kk) {
    const uint64_t db = wgmma_desc(b_tile + kk * 2048, STREAM_BOX, 1024);
    if constexpr (D == 64) {
      wgmma_rs_m64n64k16_tb(c, af[kk], db, 1);
    } else if constexpr (D == 128) {
      wgmma_rs_m64n128k16_tb(c, af[kk], db, 1);
    } else {
      static_assert(D == 256, "issue_fb: 64, 128 or 256 columns");
      wgmma_rs_m64n256k16_tb(c, af[kk], db, 1);
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
// bf16 path at D = 512 (the VAE mid block's single head):
// flash_bwd_dq_wide_wgmma_kernel and flash_bwd_dkv_wide_wgmma_kernel, built
// for Hopper on clusters of two CTAs.
//
// What bounds them: operations (K2a 6, K2b 8 times Sq*Skv*512 flops a head)
// and, with 64-row owned tiles, the L2 traffic of the streamed operands, which
// every owned tile reads in full. One CTA cannot hold the working set: a
// 64 x 512 f32 output tile is 128 KiB, half the register file (a consumer
// warpgroup owns at most 64 x 256 of one output), and the two owned 64 x 512
// bf16 tiles with two stages of the two streamed ones would take 384 KiB of
// shared memory against 227. So the two CTAs of a cluster (__cluster_dims__(2,
// 1, 1); the rank is blockIdx.x) share one 64-row owned tile and hand score
// tiles to each other through distributed shared memory by st.async: stores
// into the other CTA's shared memory that do not hold the sending thread and
// complete an mbarrier there; a second mbarrier gives a tile back once its
// readers are done (arrivals released, waits acquired, at cluster scope). The
// pair reads each streamed byte once. Each CTA has a producer warpgroup
// (setmaxnreg 24; one thread issues every TMA load through the 4-D tensor maps
// of the D = 64/128 kernels, 64-column boxes, 128-byte swizzled) and two
// consumer warpgroups (setmaxnreg 240), and a ring of two stages of streamed
// tiles with `full` and `empty` mbarriers as in the D = 64/128 kernels.
//   * dQ kernel (K2a): the two CTAs take different roles. CTA 0 holds Q and
//     streams K; its consumer 0 makes S = Q K^T (wgmma m64n64k16 over 32
//     k-steps, both operands from shared memory, K-major) and P. CTA 1 holds
//     dO and streams V; its consumer 0 makes dP = dO V^T and sends it (f32,
//     16 KiB a kv tile) into one of two slots of CTA 0, so it runs up to two
//     tiles ahead and CTA 0 seldom waits for it. CTA 0's consumer 0 forms
//     dS = P (dP - delta) and writes it in place of dP; both of CTA 0's
//     consumers own 256 columns of dQ (128 f32 registers) and add dS K over
//     those columns of the K tile (wgmma m64n256k16, dS rounded to bf16 as
//     register A fragments, K MN-major with the transpose bit set); consumer
//     0's product runs under its next S. delta = rowsum(dO * O) is the
//     prologue of CTA 0's consumers, read from device memory while the first
//     tiles load. kv columns past Skv are masked on the last tile; rows past
//     Sq take lse = +inf (P = 0) and are never stored. The dK/dV kernel's
//     symmetric split measured slower here, its exchange in the middle of
//     every kv tile.
//   * dK/dV kernel (K2b): each output needs both score products, so the CTAs
//     split the contraction instead: CTA c holds the columns 256 c .. 256 c +
//     255 of K and V (owned) and of Q and dO (streamed), and owns the same
//     columns of dK and dV. Its consumer 0 makes the partial S^T_c = K_c Q_c^T,
//     consumer 1 dP^T_c = V_c dO_c^T (transposed: rows are kv rows, as the
//     D = 64/128 kernel takes them); each sends its f32 partial to the other
//     CTA (float4 j of consumer thread t at (128 j + t) * 16 bytes) and adds
//     the other CTA's: S^T = S^T_c + S^T_(1-c), one f32 add, so both CTAs
//     hold the same bits. Consumer 0 forms P^T (the lse and delta of each q
//     tile are staged by the producer's second warp) and hands it to consumer
//     1 in place of the other CTA's partial; consumer 0 owns the CTA's 64 x 256
//     quarter of dV and adds P^T dO_c, consumer 1 dK's and adds dS^T Q_c (wgmma
//     m64n256k16). q columns past Sq take lse = +inf (P = 0); kv rows past Skv
//     are never stored. The exchange in the middle of every q tile is what
//     this kernel waits for most; remote stores with an arrival a thread, and
//     two chunks of 32 score columns with the first sent under the second's
//     product, measured slower than st.async of whole tiles.
// Shared memory a CTA: dQ 192 KiB of tiles and two 16 KiB dP slots, 230,472
// bytes with the barriers and the alignment slack; dK/dV 192 KiB of tiles, two
// 16 KiB exchange tiles and 1 KiB of lse / delta rows, 231,488 bytes (232,448
// allowed). No atomics: every output element is summed by one thread in one
// order, so a run gives the same bits every time.
// ----------------------------------------------------------------------------

constexpr int WD = 512;                   // the head dim
constexpr int WROWS = 64;                 // rows of every tile (ops/flash_attention.WIDE_BWD_ROWS)
constexpr int WCOLS = WD / 2;             // columns of a dK/dV CTA, of dQ a consumer (ops/flash_attention.WIDE_BWD_COLS)
constexpr int WBOX = WROWS * 128;         // one 64-column box of a tile: 8 KiB
constexpr int WTILE = WCOLS / 64 * WBOX;  // a dK/dV CTA's half of a 64-row tile: 32 KiB
constexpr int WSTAGES = 2;                // the ring of streamed tiles
constexpr int WX = 64 * 64 * 4;           // an exchanged 64 x 64 f32 score tile: 16 KiB
static_assert(WROWS == HS, "the wide kernels share issue_abt / issue_fb and their box stride");

// The dK/dV kernel's shared memory: this CTA's columns of K and V, of the ring of
// Q and dO tiles, the two exchange tiles and the lse / delta rows of each stage.
struct WideDkvSmem {
  static constexpr int A = 0;      // owned: K_c
  static constexpr int B = WTILE;  // owned: V_c
  // streamed, stage s: Q_c, then dO_c
  __host__ __device__ static constexpr int S0(int s) { return 2 * WTILE + 2 * WTILE * s; }
  __host__ __device__ static constexpr int S1(int s) { return S0(s) + WTILE; }
  static constexpr int XS = 2 * WTILE + 2 * WTILE * WSTAGES;  // the other CTA's partial S^T, then P^T
  static constexpr int XDP = XS + WX;                          // its partial dP^T
  static constexpr int ROWS = XDP + WX;                        // lse, delta of stage s
  static constexpr int BARS = ROWS + WSTAGES * 2 * WROWS * 4;
  // own_full, full[WSTAGES], empty[WSTAGES], xs_full, xdp_full, x_free; + alignment slack
  static constexpr int BYTES = BARS + 8 * (4 + 2 * WSTAGES) + 1024;
};

struct WideBars {
  uint32_t own_full;
  __device__ uint32_t full(int s) const { return own_full + 8u * (1 + s); }
  __device__ uint32_t empty(int s) const { return own_full + 8u * (1 + WSTAGES + s); }
  __device__ uint32_t xs_full() const { return own_full + 8u * (1 + 2 * WSTAGES); }
  __device__ uint32_t xdp_full() const { return xs_full() + 8u; }
  __device__ uint32_t x_free() const { return xs_full() + 16u; }
};

// The barriers of a CTA of the dK/dV kernel's pair; each `full` also waits for
// the 32 lanes of the producer warp that stages lse and delta.
__device__ __forceinline__ void wide_init(const WideBars& bar) {
  mbar_init(bar.own_full, 1);
  for (int s = 0; s < WSTAGES; ++s) {
    mbar_init(bar.full(s), 1 + 32);
    mbar_init(bar.empty(s), 8);  // every consumer warp of this CTA
  }
  mbar_init(bar.xs_full(), 1);   // this CTA's expect_tx; the other CTA's st.async bytes complete it
  mbar_init(bar.xdp_full(), 1);
  mbar_init(bar.x_free(), 256);  // every consumer thread of the other CTA
  fence_barrier_init();
}

// The producer's TMA thread: this CTA's columns (col0 ..) of the owned tiles
// at row r_own, then of the streamed tiles t = 0 .. n - 1 through the ring.
__device__ __forceinline__ void wide_produce(const WideBars& bar, uint32_t base, const CUtensorMap* own_a,
                                             const CUtensorMap* own_b, const CUtensorMap* str_a,
                                             const CUtensorMap* str_b, int col0, int h, int b, int r_own,
                                             int n) {
  using L = WideDkvSmem;
  prefetch_tensormap(own_a);
  prefetch_tensormap(own_b);
  prefetch_tensormap(str_a);
  prefetch_tensormap(str_b);
  mbar_arrive_expect_tx(bar.own_full, 2 * WTILE);
#pragma unroll
  for (int c = 0; c < WCOLS / 64; ++c) {
    tma_load_4d(base + L::A + c * WBOX, own_a, bar.own_full, col0 + 64 * c, h, r_own, b);
    tma_load_4d(base + L::B + c * WBOX, own_b, bar.own_full, col0 + 64 * c, h, r_own, b);
  }
  for (int t = 0; t < n; ++t) {
    const int s = t % WSTAGES;
    if (t >= WSTAGES) mbar_wait(bar.empty(s), ((t / WSTAGES) - 1) & 1);
    mbar_arrive_expect_tx(bar.full(s), 2 * WTILE);
#pragma unroll
    for (int c = 0; c < WCOLS / 64; ++c) {
      tma_load_4d(base + L::S0(s) + c * WBOX, str_a, bar.full(s), col0 + 64 * c, h, t * WROWS, b);
      tma_load_4d(base + L::S1(s) + c * WBOX, str_b, bar.full(s), col0 + 64 * c, h, t * WROWS, b);
    }
  }
}

// Shared address of float4 j of consumer thread ti in an exchange tile.
__device__ __forceinline__ uint32_t x_slot(uint32_t tile, int j, int ti) {
  return tile + (uint32_t)(j * 128 + ti) * 16u;
}

// One consumer's partial score tile of stream step t, c = A B^T over this
// CTA's 256 columns (16 k-steps of 32 bytes inside each 64-column box), then
// the pair's exchange: wait until the other CTA is done with what this thread
// sent at step t - 1, send c into its tile x_peer by st.async (completing its
// barrier full_peer), expect the other CTA's partial on this CTA's full_own,
// wait for it in this CTA's tile x_own and add it.
__device__ __forceinline__ void wide_scores(float (&c)[32], uint32_t a_tile, uint32_t b_tile, int t, int ti,
                                            uint32_t x_own, uint32_t x_peer, uint32_t full_own,
                                            uint32_t full_peer, uint32_t free_own) {
  // through an empty asm, so that the 32 descriptors are computed here and not kept over the loop
  asm volatile("" : "+r"(a_tile), "+r"(b_tile));
  fence_operands(c);
  wgmma_fence();
  issue_abt<WCOLS, WBOX>(c, a_tile, b_tile);
  wgmma_commit_group();
  wgmma_wait_group<0>();
  fence_operands(c);
  if (t > 0) mbar_wait_cluster(free_own, (t - 1) & 1);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    st_async_v4(x_slot(x_peer, j, ti), c[4 * j], c[4 * j + 1], c[4 * j + 2], c[4 * j + 3], full_peer);
  if (ti == 0) mbar_arrive_expect_tx(full_own, WX);
  mbar_wait_cluster(full_own, t & 1);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint4 v = ld_shared_v4(x_slot(x_own, j, ti));
    c[4 * j] += __uint_as_float(v.x);
    c[4 * j + 1] += __uint_as_float(v.y);
    c[4 * j + 2] += __uint_as_float(v.z);
    c[4 * j + 3] += __uint_as_float(v.w);
  }
}

// This consumer thread's 32 values into an exchange tile of its own CTA.
__device__ __forceinline__ void x_store(uint32_t tile, int ti, const float (&c)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    st_shared_v4(x_slot(tile, j, ti), make_uint4(__float_as_uint(c[4 * j]), __float_as_uint(c[4 * j + 1]),
                                                 __float_as_uint(c[4 * j + 2]), __float_as_uint(c[4 * j + 3])));
}

// The dQ kernel's shared memory, all 512 columns: the owned tile (Q in CTA 0,
// dO in CTA 1), a ring of two stages of the streamed tile (K or V) and, in CTA
// 0, two slots that CTA 1's dP lands in (then dS, for CTA 0's consumer 1).
struct WideDqSmem {
  static constexpr int TILE = WD / 64 * WBOX;  // a 64 x 512 tile: 64 KiB
  static constexpr int A = 0;
  __host__ __device__ static constexpr int S(int s) { return TILE + TILE * s; }
  __host__ __device__ static constexpr int XDP(int k) { return TILE + TILE * WSTAGES + WX * k; }
  static constexpr int BARS = TILE + TILE * WSTAGES + 2 * WX;
  // own_full, full[WSTAGES], empty[WSTAGES], xdp_full[2], x_free[2]; + alignment slack
  static constexpr int BYTES = BARS + 8 * (5 + 2 * WSTAGES) + 1024;
};

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(384, 1) flash_bwd_dq_wide_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int H,
    int Sq, int Skv, Strides os, Strides gs, float scale) {
  using L = WideDqSmem;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t own_full = base + L::BARS;
  auto full = [&](int s) { return own_full + 8u * (1 + s); };
  auto empty = [&](int s) { return own_full + 8u * (1 + WSTAGES + s); };
  auto xdp_full = [&](int k) { return own_full + 8u * (1 + 2 * WSTAGES + k); };
  auto x_free = [&](int k) { return own_full + 8u * (3 + 2 * WSTAGES + k); };

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int rank = blockIdx.x;  // the pair is the cluster along x: 0 makes S, P, dS and dQ; 1 makes dP
  const int bh = blockIdx.z;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.y * WROWS;
  const int n_kv = (Skv + WROWS - 1) / WROWS;

  if (tid == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), rank == 0 ? 8 : 4);  // the consumer warps that read the stage
    }
    for (int k = 0; k < 2; ++k) {
      mbar_init(xdp_full(k), 1);  // CTA 0: its expect_tx; CTA 1's st.async bytes complete it
      mbar_init(x_free(k), 128);  // CTA 1: every thread of CTA 0's consumer 1
    }
    fence_barrier_init();
  }
  cluster_sync();  // both CTAs' barriers exist before anything arrives on them

  if (wg == 0) {
    // ---- producer: the owned tile, then the streamed tiles, all 512 columns ----
    setmaxnreg_dec<24>();
    if (tid == 0) {
      const CUtensorMap* own = rank == 0 ? &tm_q : &tm_do;
      const CUtensorMap* str = rank == 0 ? &tm_k : &tm_v;
      prefetch_tensormap(own);
      prefetch_tensormap(str);
      mbar_arrive_expect_tx(own_full, L::TILE);
#pragma unroll
      for (int c = 0; c < WD / 64; ++c) tma_load_4d(base + L::A + c * WBOX, own, own_full, 64 * c, h, q0, b);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % WSTAGES;
        if (t >= WSTAGES) mbar_wait(empty(s), ((t / WSTAGES) - 1) & 1);
        mbar_arrive_expect_tx(full(s), L::TILE);
#pragma unroll
        for (int c = 0; c < WD / 64; ++c) tma_load_4d(base + L::S(s) + c * WBOX, str, full(s), 64 * c, h, t * WROWS, b);
      }
    }
  } else if (rank == 1) {
    // ---- CTA 1: consumer 0 makes dP = dO V^T of every kv tile and sends it to CTA 0 ----
    setmaxnreg_inc<240>();
    if (wg == 1) {
      const int ti = tid & 127;
      const int lane = tid & 31;
      uint32_t x_peer[2], full_peer[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        x_peer[k] = mapa_shared(base + L::XDP(k), 0);
        full_peer[k] = mapa_shared(xdp_full(k), 0);
      }
      float dp[32];
      mbar_wait(own_full, 0);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % WSTAGES;
        mbar_wait(full(s), (t / WSTAGES) & 1);
        uint32_t a_tile = base + L::A, b_tile = base + L::S(s);
        asm volatile("" : "+r"(a_tile), "+r"(b_tile));
        fence_operands(dp);
        wgmma_fence();
        issue_abt<WD, WBOX>(dp, a_tile, b_tile);
        wgmma_commit_group();
        wgmma_wait_group<0>();
        fence_operands(dp);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
        // into slot t % 2 of CTA 0 once its consumers are done with what went there at step t - 2
        const int k = t & 1;
        if (t >= 2) mbar_wait_cluster(x_free(k), ((t >> 1) - 1) & 1);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          st_async_v4(x_slot(x_peer[k], j, ti), dp[4 * j], dp[4 * j + 1], dp[4 * j + 2], dp[4 * j + 3],
                      full_peer[k]);
      }
    }
  } else {
    // ---- CTA 0: consumer 0 makes S, P and dS; consumer cw owns dQ's columns 256 cw .. ----
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int ti = tid & 127;
    const int warp = ti >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    const int r_lo = q0 + warp * 16 + g;  // this thread's rows r_lo, r_hi
    const int r_hi = r_lo + 8;

    // delta = rowsum(dO * O) in f32 while the first tiles load
    float dl_lo = row_dot_part<WD>(o, dout, os, gs, b, h, r_lo, Sq, tig);
    float dl_hi = row_dot_part<WD>(o, dout, os, gs, b, h, r_hi, Sq, tig);
    dl_lo += __shfl_xor_sync(0xffffffffu, dl_lo, 1);
    dl_lo += __shfl_xor_sync(0xffffffffu, dl_lo, 2);
    dl_hi += __shfl_xor_sync(0xffffffffu, dl_hi, 1);
    dl_hi += __shfl_xor_sync(0xffffffffu, dl_hi, 2);
    if (cw == 0 && tig == 0) {
      if (r_lo < Sq) delta[(long long)bh * Sq + r_lo] = dl_lo;
      if (r_hi < Sq) delta[(long long)bh * Sq + r_hi] = dl_hi;
    }
    // lse in the base-2 domain; +inf past Sq makes P = 0 there
    const float inf = __int_as_float(0x7f800000u);
    const float l_lo = r_lo < Sq ? lse[(long long)bh * Sq + r_lo] * LOG2E : inf;
    const float l_hi = r_hi < Sq ? lse[(long long)bh * Sq + r_hi] * LOG2E : inf;
    const float scale_log2 = scale * LOG2E;
    uint32_t free_peer[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) free_peer[k] = mapa_shared(x_free(k), 1);

    float acc[128], sc[32];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    uint32_t dsf[4][4];

    mbar_wait(own_full, 0);
    if (cw == 0) {
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % WSTAGES;
        const int k = t & 1;
        const uint32_t slot = base + L::XDP(k);
        // S = Q K^T, issued while the dQ product of tile t - 1 may still run (no fence on sc
        // here: an instruction defining it under that product makes ptxas serialise every wgmma)
        mbar_wait(full(s), (t / WSTAGES) & 1);
        uint32_t a_tile = base + L::A, b_tile = base + L::S(s);
        asm volatile("" : "+r"(a_tile), "+r"(b_tile));
        wgmma_fence();
        issue_abt<WD, WBOX>(sc, a_tile, b_tile);
        wgmma_commit_group();
        wgmma_wait_group<0>();
        fence_operands(sc);
        fence_operands(acc);
        fence_fragments(dsf);
        if (t > 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty((t - 1) % WSTAGES));  // the dQ product of tile t - 1 is done
        }
        // P = 2^(S scale log2(e) - lse log2(e)); kv columns >= Skv are 0
        const int kvalid = Skv - t * WROWS;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * tig;
          sc[4 * j] = fast_exp2(fmaf(sc[4 * j], scale_log2, -l_lo));
          sc[4 * j + 1] = fast_exp2(fmaf(sc[4 * j + 1], scale_log2, -l_lo));
          sc[4 * j + 2] = fast_exp2(fmaf(sc[4 * j + 2], scale_log2, -l_hi));
          sc[4 * j + 3] = fast_exp2(fmaf(sc[4 * j + 3], scale_log2, -l_hi));
          if (kvalid < WROWS) {
            if (col >= kvalid) sc[4 * j] = sc[4 * j + 2] = 0.f;
            if (col + 1 >= kvalid) sc[4 * j + 1] = sc[4 * j + 3] = 0.f;
          }
        }
        // dS = P (dP - delta) with CTA 1's dP of this tile, written in its place for consumer 1
        if (ti == 0) mbar_arrive_expect_tx(xdp_full(k), WX);
        mbar_wait_cluster(xdp_full(k), (t >> 1) & 1);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint4 v = ld_shared_v4(x_slot(slot, j, ti));
          sc[4 * j] *= __uint_as_float(v.x) - dl_lo;
          sc[4 * j + 1] *= __uint_as_float(v.y) - dl_lo;
          sc[4 * j + 2] *= __uint_as_float(v.z) - dl_hi;
          sc[4 * j + 3] *= __uint_as_float(v.w) - dl_hi;
        }
        x_store(slot, ti, sc);
        named_barrier_sync(1, 256);
        // dQ[:, 0 ..] += dS K over those columns of the K tile; left running under the next S
        pack_fragments(dsf, sc);
        fence_fragments(dsf);
        fence_operands(acc);
        wgmma_fence();
        issue_fb<WCOLS>(acc, dsf, base + L::S(s));
        wgmma_commit_group();
      }
      wgmma_wait_group<0>();
      fence_operands(acc);
    } else {
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % WSTAGES;
        const int k = t & 1;
        const uint32_t slot = base + L::XDP(k);
        named_barrier_sync(1, 256);  // dS of tile t is in slot k
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint4 v = ld_shared_v4(x_slot(slot, j, ti));
          sc[4 * j] = __uint_as_float(v.x);
          sc[4 * j + 1] = __uint_as_float(v.y);
          sc[4 * j + 2] = __uint_as_float(v.z);
          sc[4 * j + 3] = __uint_as_float(v.w);
        }
        mbar_arrive_cluster(free_peer[k]);  // this thread is done with slot k
        // dQ[:, 256 ..] += dS K over those columns of the K tile
        pack_fragments(dsf, sc);
        fence_fragments(dsf);
        fence_operands(acc);
        wgmma_fence();
        issue_fb<WCOLS>(acc, dsf, base + L::S(s) + (WCOLS / 64) * WBOX);
        wgmma_commit_group();
        wgmma_wait_group<0>();
        fence_operands(acc);
        fence_fragments(dsf);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
      }
    }

    // ---- epilogue: dQ = scale * acc, rows < Sq ----
    const long long o_ss = (long long)H * WD;
    __nv_bfloat16* dq_base = dq + (long long)b * Sq * o_ss + (long long)h * WD + WCOLS * cw;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 8 * j + 2 * tig;
      if (r_lo < Sq)
        *reinterpret_cast<uint32_t*>(dq_base + (long long)r_lo * o_ss + c) =
            pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale);
      if (r_hi < Sq)
        *reinterpret_cast<uint32_t*>(dq_base + (long long)r_hi * o_ss + c) =
            pack_bf16(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
    }
  }
  cluster_sync();  // neither CTA leaves while the other may still write to it or arrive on its barriers
}

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(384, 1) flash_bwd_dkv_wide_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int H, int Sq, int Skv, float scale) {
  using L = WideDkvSmem;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* rows = reinterpret_cast<float*>(smem_raw + (base - raw) + L::ROWS);  // [stage][lse | delta][WROWS]
  const WideBars bar{base + L::BARS};

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int rank = blockIdx.x;  // the pair is the cluster along x
  const int col0 = rank * WCOLS;
  const int bh = blockIdx.z;
  const int b = bh / H;
  const int h = bh % H;
  const int kv0 = blockIdx.y * WROWS;
  const int n_q = (Sq + WROWS - 1) / WROWS;

  if (tid == 0) wide_init(bar);
  cluster_sync();  // both CTAs' barriers exist before anything arrives on them

  if (wg == 0) {
    // ---- producer: thread 0 issues the TMA loads, warp 1 the lse and delta rows ----
    setmaxnreg_dec<24>();
    if (tid == 0) {
      wide_produce(bar, base, &tm_k, &tm_v, &tm_q, &tm_do, col0, h, b, kv0, n_q);
    } else if ((tid >> 5) == 1) {
      const int lane = tid & 31;
      const float inf = __int_as_float(0x7f800000u);
      for (int i = 0; i < n_q; ++i) {
        const int s = i % WSTAGES;
        if (i >= WSTAGES) mbar_wait(bar.empty(s), ((i / WSTAGES) - 1) & 1);
        float* lse_s = rows + s * 2 * WROWS;
#pragma unroll
        for (int r = lane; r < WROWS; r += 32) {
          const int q = i * WROWS + r;
          const bool ok = q < Sq;
          lse_s[r] = ok ? lse[(long long)bh * Sq + q] * LOG2E : inf;
          lse_s[WROWS + r] = ok ? delta[(long long)bh * Sq + q] : 0.f;
        }
        mbar_arrive(bar.full(s));  // releases this lane's rows to the consumers
      }
    }
  } else {
    // ---- consumers: 0 makes S^T and P^T and owns dV, 1 makes dP^T and dS^T and owns dK ----
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int ti = tid & 127;
    const int warp = ti >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    const float scale_log2 = scale * LOG2E;

    const uint32_t peer = rank ^ 1;
    const uint32_t x_own = base + (cw == 0 ? L::XS : L::XDP);
    const uint32_t full_own = cw == 0 ? bar.xs_full() : bar.xdp_full();
    const uint32_t x_peer = mapa_shared(x_own, peer);
    const uint32_t full_peer = mapa_shared(full_own, peer);
    const uint32_t free_peer = mapa_shared(bar.x_free(), peer);

    float acc[128], sc[32];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    uint32_t fr[4][4];

    mbar_wait(bar.own_full, 0);
    for (int i = 0; i < n_q; ++i) {
      const int s = i % WSTAGES;
      mbar_wait(bar.full(s), (i / WSTAGES) & 1);
      // S^T = K Q^T (consumer 0) or dP^T = V dO^T (consumer 1), both halves of D
      wide_scores(sc, base + (cw == 0 ? L::A : L::B), base + (cw == 0 ? L::S0(s) : L::S1(s)), i, ti, x_own,
                  x_peer, full_own, full_peer, bar.x_free());
      // columns are q rows: this thread's 8j + 2 tig (+1), their lse and delta
      const float* lse_s = rows + s * 2 * WROWS;
      if (cw == 0) {  // P^T, handed to consumer 1 in place of the other CTA's partial
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * tig);
          sc[4 * j] = fast_exp2(fmaf(sc[4 * j], scale_log2, -l.x));
          sc[4 * j + 1] = fast_exp2(fmaf(sc[4 * j + 1], scale_log2, -l.y));
          sc[4 * j + 2] = fast_exp2(fmaf(sc[4 * j + 2], scale_log2, -l.x));
          sc[4 * j + 3] = fast_exp2(fmaf(sc[4 * j + 3], scale_log2, -l.y));
        }
        x_store(x_own, ti, sc);
      }
      named_barrier_sync(1, 256);
      if (cw == 1) {  // dS^T = P^T (dP^T - delta)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint4 v = ld_shared_v4(x_slot(base + L::XS, j, ti));
          const float2 dl = *reinterpret_cast<const float2*>(lse_s + WROWS + 8 * j + 2 * tig);
          sc[4 * j] = __uint_as_float(v.x) * (sc[4 * j] - dl.x);
          sc[4 * j + 1] = __uint_as_float(v.y) * (sc[4 * j + 1] - dl.y);
          sc[4 * j + 2] = __uint_as_float(v.z) * (sc[4 * j + 2] - dl.x);
          sc[4 * j + 3] = __uint_as_float(v.w) * (sc[4 * j + 3] - dl.y);
        }
      }
      pack_fragments(fr, sc);
      fence_fragments(fr);
      fence_operands(acc);
      wgmma_fence();
      // dV_c += P^T dO_c (consumer 0), dK_c += dS^T Q_c (consumer 1)
      issue_fb<WCOLS>(acc, fr, base + (cw == 0 ? L::S1(s) : L::S0(s)));
      wgmma_commit_group();
      // this thread is done with both exchange tiles (measured faster here, under the product,
      // than before it, where the dQ kernel puts it)
      mbar_arrive_cluster(free_peer);
      wgmma_wait_group<0>();
      fence_operands(acc);
      fence_fragments(fr);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar.empty(s));  // this warp is done with stage s
    }

    // ---- epilogue: kv rows < Skv; dK = scale * acc ----
    const int c_lo = kv0 + warp * 16 + g;
    const int c_hi = c_lo + 8;
    const float mul = cw == 0 ? 1.f : scale;
    const long long o_ss = (long long)H * WD;
    __nv_bfloat16* out = (cw == 0 ? dv : dk) + (long long)b * Skv * o_ss + (long long)h * WD + col0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = 8 * j + 2 * tig;
      if (c_lo < Skv)
        *reinterpret_cast<uint32_t*>(out + (long long)c_lo * o_ss + c) =
            pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul);
      if (c_hi < Skv)
        *reinterpret_cast<uint32_t*>(out + (long long)c_hi * o_ss + c) =
            pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
    }
  }
  cluster_sync();  // neither CTA leaves while the other may still arrive on its barriers
}

int launch_dq_wide_wgmma(const void* q, const void* k, const void* v, const void* o, const void* dout,
                         const float* lse, float* delta, void* dq, int B, int H, int Sq, int Skv,
                         const long long* st, float scale, cudaStream_t stream) {
  using L = WideDqSmem;
  if ((Sq + WROWS - 1) / WROWS > 65535) return (int)cudaErrorInvalidValue;
  static SmemOptIn opt;
  int code = opt_in_smem(opt, (const void*)flash_bwd_dq_wide_wgmma_kernel, L::BYTES);
  if (code != 0) return code;
  CUtensorMap tq, tdo, tk, tv;
  code = encode_bshd(&tq, q, B, Sq, H, WD, st[0], st[1], st[2], WROWS);
  if (code == 0) code = encode_bshd(&tk, k, B, Skv, H, WD, st[3], st[4], st[5], WROWS);
  if (code == 0) code = encode_bshd(&tv, v, B, Skv, H, WD, st[6], st[7], st[8], WROWS);
  if (code == 0) code = encode_bshd(&tdo, dout, B, Sq, H, WD, st[12], st[13], st[14], WROWS);
  if (code != 0) return code;
  dim3 grid(2, (Sq + WROWS - 1) / WROWS, B * H);
  flash_bwd_dq_wide_wgmma_kernel<<<grid, 384, L::BYTES, stream>>>(
      tq, tdo, tk, tv, (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, lse, delta, (__nv_bfloat16*)dq, H,
      Sq, Skv, Strides{st[9], st[10], st[11]}, Strides{st[12], st[13], st[14]}, scale);
  return (int)cudaGetLastError();
}

int launch_dkv_wide_wgmma(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                          const float* delta, void* dk, void* dv, int B, int H, int Sq, int Skv,
                          const long long* st, float scale, cudaStream_t stream) {
  using L = WideDkvSmem;
  if ((Skv + WROWS - 1) / WROWS > 65535) return (int)cudaErrorInvalidValue;
  static SmemOptIn opt;
  int code = opt_in_smem(opt, (const void*)flash_bwd_dkv_wide_wgmma_kernel, L::BYTES);
  if (code != 0) return code;
  CUtensorMap tq, tdo, tk, tv;
  code = encode_bshd(&tq, q, B, Sq, H, WD, st[0], st[1], st[2], WROWS);
  if (code == 0) code = encode_bshd(&tk, k, B, Skv, H, WD, st[3], st[4], st[5], WROWS);
  if (code == 0) code = encode_bshd(&tv, v, B, Skv, H, WD, st[6], st[7], st[8], WROWS);
  if (code == 0) code = encode_bshd(&tdo, dout, B, Sq, H, WD, st[9], st[10], st[11], WROWS);
  if (code != 0) return code;
  dim3 grid(2, (Skv + WROWS - 1) / WROWS, B * H);
  flash_bwd_dkv_wide_wgmma_kernel<<<grid, 384, L::BYTES, stream>>>(
      tq, tdo, tk, tv, lse, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, H, Sq, Skv, scale);
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
  if (dtype == 0 && D == 512) OMGSR_DQ(launch_dq_wide_wgmma);
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
  if (dtype == 0 && D == 512) OMGSR_DKV(launch_dkv_wide_wgmma);
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
