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
//     loops over the streamed axis itself, the accumulators in registers:
//     flash_bwd_dq_kernel owns a 64-row q tile and loops over kv tiles,
//     flash_bwd_dkv_kernel owns a 64-row kv tile and loops over q tiles. Each
//     output element is summed by one thread in one fixed order: there are no
//     atomics, and the same inputs give the same bits on every run.
//   * The TPU wrapper transposed (B,S,H,D) to (B*H,S,D), padded S to the block
//     size in device memory and computed delta with tensor code. Here the
//     kernels read (B,S,H,D) through the strides they are given and mask the
//     ragged ends themselves (kv columns >= Skv in the dQ kernel, q rows >= Sq
//     in the dK/dV kernel; rows that do not exist are never stored), and delta
//     is a prologue of the dQ kernel: the block that owns a q tile has its dO
//     rows in shared memory, reads the matching O rows once, and writes the
//     64 sums to a (B*H, Sq) f32 buffer that the dK/dV kernel, launched after
//     it on the same stream, reads.
//
// Bound on this card: operations. The dQ kernel does three products
// (6*B*H*Sq*Skv*D flops), the dK/dV kernel four (8*B*H*Sq*Skv*D), against
// inputs that are read once. Two pairs of kernels share the block layout
// above:
//   * flash_bwd_dq_kernel / flash_bwd_dkv_kernel (f32 inputs): plain f32 FMAs
//     from shared memory: 256 threads, every tile [64][D+4] f32, 4x4 register
//     micro-tiles for the score products and 4 x D/16 for the output products,
//     conflict-free float4 reads, as in the forward's f32 kernel. Exact for
//     f32, far from the tensor-core rate. Shared memory (dynamic, opt-in): dQ
//     kernel 4 tiles + one [64][68] score tile + 128 floats = 87,552 bytes
//     (D=64) or 153,088 (D=128); dK/dV kernel 4 tiles + two score tiles =
//     104,960 or 170,496 bytes.
//   * flash_bwd_dq_mma_kernel / flash_bwd_dkv_mma_kernel (bf16 inputs): tensor
//     cores through mma.sync, described where they are defined. wgmma, TMA and
//     async copies are not used yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace omgsr_mma;

constexpr int BT = 64;  // rows of every tile of the D = 64 / 128 kernels, q and kv alike
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
// bf16 path: tensor cores through mma.sync.m16n8k16 (bf16 in, f32 accumulate),
// with the block layout of the kernels above. One block = 4 warps = a 64-row
// output tile; each warp owns 16 of its rows and keeps their operand
// fragments and their accumulators in registers. The streamed tiles (64 rows)
// are staged in shared memory as bf16 with rows padded by 16 bytes and read
// with ldmatrix: plain for the score products, where the tile is the "n x k"
// operand, and .trans for the output products, where the same tile is the
// "k x n" operand. The scores are made one 16 x 8 tile at a time and go
// straight into the A fragments of the output products (P and dS rounded to
// bf16 there; the exponent and dS itself are f32), so no score tile is ever
// written to shared memory.
// ----------------------------------------------------------------------------

// dQ: the warp's rows are q rows; K and V tiles are streamed.
// Shared memory: 2 * 64 * (D+8) * 2 bytes = 18,432 (D=64) or 34,816 (D=128).
template <int D>
__global__ void __launch_bounds__(MMA_NT) flash_bwd_dq_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int H, int Sq, int Skv, Strides qs,
    Strides ks, Strides vs, Strides os, Strides gs, float scale) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;  // k-steps of the score products
  constexpr int NO = D / 8;   // n-tiles of the accumulator
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BT * LD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int lrow = lane & 7;   // ldmatrix: row within the 8x8 matrix this lane addresses
  const int lmat = lane >> 3;  // ldmatrix: which of the four matrices
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BT + warp * 16;  // first q row of this warp
  const int r_lo = q0 + g, r_hi = q0 + g + 8;

  const __nv_bfloat16* k_base = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* v_base = v + b * vs.b + h * vs.h;

  uint32_t qf[KS][4], gf[KS][4];
  load_a_fragments<KS>(qf, q + b * qs.b + h * qs.h, qs.s, q0, Sq, g, tig);
  load_a_fragments<KS>(gf, dout + b * gs.b + h * gs.h, gs.s, q0, Sq, g, tig);

  // delta = rowsum(dO * O) in f32 over this thread's columns, then over the
  // four lanes that share a row
  float delta_lo = 0.f, delta_hi = 0.f;
  {
    uint32_t of[KS][4];
    load_a_fragments<KS>(of, o + b * os.b + h * os.h, os.s, q0, Sq, g, tig);
#pragma unroll
    for (int ksi = 0; ksi < KS; ++ksi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = unpack_bf16(gf[ksi][e]);
        const float2 c = unpack_bf16(of[ksi][e]);
        const float part = a.x * c.x + a.y * c.y;
        if (e & 1) delta_hi += part; else delta_lo += part;
      }
    delta_lo += __shfl_xor_sync(0xffffffffu, delta_lo, 1);
    delta_lo += __shfl_xor_sync(0xffffffffu, delta_lo, 2);
    delta_hi += __shfl_xor_sync(0xffffffffu, delta_hi, 1);
    delta_hi += __shfl_xor_sync(0xffffffffu, delta_hi, 2);
  }
  float lse_lo = 0.f, lse_hi = 0.f;
  if (r_lo < Sq) lse_lo = lse[(long long)bh * Sq + r_lo];
  if (r_hi < Sq) lse_hi = lse[(long long)bh * Sq + r_hi];
  if (tig == 0) {
    if (r_lo < Sq) delta[(long long)bh * Sq + r_lo] = delta_lo;
    if (r_hi < Sq) delta[(long long)bh * Sq + r_hi] = delta_hi;
  }

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kv0 = 0; kv0 < Skv; kv0 += BT) {
    const int kvalid = min(BT, Skv - kv0);
    __syncthreads();  // the previous tile's readers are done
    stage_tile_bf16<D>(Ks, k_base + (long long)kv0 * ks.s, ks.s, kvalid);
    stage_tile_bf16<D>(Vs, v_base + (long long)kv0 * vs.s, vs.s, kvalid);
    __syncthreads();

    // dS, one 16 x 8 tile (8 kv columns) at a time, as bf16 A fragments
    uint32_t dsf[BT / 16][4];
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ksi = 0; ksi < KS; ksi += 2) {
        // matrices: (d 0..7, d 8..15) of k-step ksi, then of k-step ksi+1
        uint32_t kf[4], vf[4];
        ldmatrix_x4(kf, Ks + (j * 8 + lrow) * LD + ksi * 16 + lmat * 8);
        mma_bf16(s, qf[ksi], kf[0], kf[1]);
        mma_bf16(s, qf[ksi + 1], kf[2], kf[3]);
        ldmatrix_x4(vf, Vs + (j * 8 + lrow) * LD + ksi * 16 + lmat * 8);
        mma_bf16(dp, gf[ksi], vf[0], vf[1]);
        mma_bf16(dp, gf[ksi + 1], vf[2], vf[3]);
      }
      const int col = j * 8 + tig * 2;
      const bool ok0 = col < kvalid, ok1 = col + 1 < kvalid;
      const float p0 = ok0 ? __expf(s[0] * scale - lse_lo) : 0.f;
      const float p1 = ok1 ? __expf(s[1] * scale - lse_lo) : 0.f;
      const float p2 = ok0 ? __expf(s[2] * scale - lse_hi) : 0.f;
      const float p3 = ok1 ? __expf(s[3] * scale - lse_hi) : 0.f;
      dsf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p0 * (dp[0] - delta_lo), p1 * (dp[1] - delta_lo));
      dsf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2 * (dp[2] - delta_hi), p3 * (dp[3] - delta_hi));
    }

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        // matrices: kv rows (0..7, 8..15) of k-step kk for n-tile j, then for n-tile j+1
        uint32_t kf[4];
        ldmatrix_x4_trans(kf, Ks + (kk * 16 + (lmat & 1) * 8 + lrow) * LD + (j + (lmat >> 1)) * 8);
        mma_bf16(acc[j], dsf[kk], kf[0], kf[1]);
        mma_bf16(acc[j + 1], dsf[kk], kf[2], kf[3]);
      }
    }
  }

  const long long o_ss = (long long)H * D;
  __nv_bfloat16* dq_base = dq + (long long)b * Sq * o_ss + (long long)h * D;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = j * 8 + tig * 2;
    if (r_lo < Sq)
      *reinterpret_cast<uint32_t*>(dq_base + (long long)r_lo * o_ss + c) =
          pack_bf16(acc[j][0] * scale, acc[j][1] * scale);
    if (r_hi < Sq)
      *reinterpret_cast<uint32_t*>(dq_base + (long long)r_hi * o_ss + c) =
          pack_bf16(acc[j][2] * scale, acc[j][3] * scale);
  }
}

// dK/dV: the warp's rows are kv rows, so the score tiles come out transposed
// (kv rows, q columns) as in the FMA kernel; Q and dO tiles are streamed, with
// the log-sum-exp and delta of their rows. Shared memory: 2 * 64 * (D+8) * 2
// + 512 bytes = 18,944 (D=64) or 35,328 (D=128).
template <int D>
__global__ void __launch_bounds__(MMA_NT) flash_bwd_dkv_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int H, int Sq, int Skv, Strides qs, Strides ks, Strides vs,
    Strides gs, float scale) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Gs = Qs + BT * LD;  // dO
  float* lse_s = reinterpret_cast<float*>(Gs + BT * LD);
  float* delta_s = lse_s + BT;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int lrow = lane & 7;
  const int lmat = lane >> 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kv0 = blockIdx.x * BT + warp * 16;  // first kv row of this warp
  const int c_lo = kv0 + g, c_hi = kv0 + g + 8;

  const __nv_bfloat16* q_base = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* g_base = dout + b * gs.b + h * gs.h;

  uint32_t kf[KS][4], vf[KS][4];
  load_a_fragments<KS>(kf, k + b * ks.b + h * ks.h, ks.s, kv0, Skv, g, tig);
  load_a_fragments<KS>(vf, v + b * vs.b + h * vs.h, vs.s, kv0, Skv, g, tig);

  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_k[j][e] = 0.f;
      acc_v[j][e] = 0.f;
    }

  for (int q0 = 0; q0 < Sq; q0 += BT) {
    const int qvalid = min(BT, Sq - q0);
    __syncthreads();  // the previous tile's readers are done
    stage_tile_bf16<D>(Qs, q_base + (long long)q0 * qs.s, qs.s, qvalid);
    stage_tile_bf16<D>(Gs, g_base + (long long)q0 * gs.s, gs.s, qvalid);
    if (tid < BT) {
      const bool ok = tid < qvalid;
      lse_s[tid] = ok ? lse[(long long)bh * Sq + q0 + tid] : 0.f;
      delta_s[tid] = ok ? delta[(long long)bh * Sq + q0 + tid] : 0.f;
    }
    __syncthreads();

    // P^T and dS^T, one 16 x 8 tile (8 q columns) at a time, as bf16 A fragments
    uint32_t pf[BT / 16][4], dsf[BT / 16][4];
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      float st[4] = {0.f, 0.f, 0.f, 0.f}, dpt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ksi = 0; ksi < KS; ksi += 2) {
        uint32_t qf[4], gf[4];
        ldmatrix_x4(qf, Qs + (j * 8 + lrow) * LD + ksi * 16 + lmat * 8);
        mma_bf16(st, kf[ksi], qf[0], qf[1]);
        mma_bf16(st, kf[ksi + 1], qf[2], qf[3]);
        ldmatrix_x4(gf, Gs + (j * 8 + lrow) * LD + ksi * 16 + lmat * 8);
        mma_bf16(dpt, vf[ksi], gf[0], gf[1]);
        mma_bf16(dpt, vf[ksi + 1], gf[2], gf[3]);
      }
      const int r = j * 8 + tig * 2;  // q row of this thread's first column
      const float l0 = lse_s[r], l1 = lse_s[r + 1];
      const float d0 = delta_s[r], d1 = delta_s[r + 1];
      const bool q0ok = r < qvalid, q1ok = r + 1 < qvalid;
      const bool lo_ok = c_lo < Skv, hi_ok = c_hi < Skv;
      const float p0 = (q0ok && lo_ok) ? __expf(st[0] * scale - l0) : 0.f;
      const float p1 = (q1ok && lo_ok) ? __expf(st[1] * scale - l1) : 0.f;
      const float p2 = (q0ok && hi_ok) ? __expf(st[2] * scale - l0) : 0.f;
      const float p3 = (q1ok && hi_ok) ? __expf(st[3] * scale - l1) : 0.f;
      pf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      dsf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p0 * (dpt[0] - d0), p1 * (dpt[1] - d1));
      dsf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2 * (dpt[2] - d0), p3 * (dpt[3] - d1));
    }

    // dV += P^T dO and dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        // matrices: q rows (0..7, 8..15) of k-step kk for n-tile j, then for n-tile j+1
        uint32_t gf[4], qf[4];
        const int off = (kk * 16 + (lmat & 1) * 8 + lrow) * LD + (j + (lmat >> 1)) * 8;
        ldmatrix_x4_trans(gf, Gs + off);
        mma_bf16(acc_v[j], pf[kk], gf[0], gf[1]);
        mma_bf16(acc_v[j + 1], pf[kk], gf[2], gf[3]);
        ldmatrix_x4_trans(qf, Qs + off);
        mma_bf16(acc_k[j], dsf[kk], qf[0], qf[1]);
        mma_bf16(acc_k[j + 1], dsf[kk], qf[2], qf[3]);
      }
    }
  }

  const long long o_ss = (long long)H * D;
  const long long base = (long long)b * Skv * o_ss + (long long)h * D;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = j * 8 + tig * 2;
    if (c_lo < Skv) {
      *reinterpret_cast<uint32_t*>(dk + base + (long long)c_lo * o_ss + c) =
          pack_bf16(acc_k[j][0] * scale, acc_k[j][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + (long long)c_lo * o_ss + c) =
          pack_bf16(acc_v[j][0], acc_v[j][1]);
    }
    if (c_hi < Skv) {
      *reinterpret_cast<uint32_t*>(dk + base + (long long)c_hi * o_ss + c) =
          pack_bf16(acc_k[j][2] * scale, acc_k[j][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + (long long)c_hi * o_ss + c) =
          pack_bf16(acc_v[j][2], acc_v[j][3]);
    }
  }
}

template <int D>
int launch_dq_mma(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const float* lse, float* delta, void* dq, int B, int H, int Sq, int Skv,
                  const long long* st, float scale, cudaStream_t stream) {
  constexpr int smem_bytes = 2 * BT * (D + 8) * (int)sizeof(__nv_bfloat16);
  dim3 grid((Sq + BT - 1) / BT, B * H);
  flash_bwd_dq_mma_kernel<D><<<grid, MMA_NT, smem_bytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, lse, delta, (__nv_bfloat16*)dq, H, Sq,
      Skv, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14]}, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_mma(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dk, void* dv, int B, int H, int Sq,
                   int Skv, const long long* st, float scale, cudaStream_t stream) {
  constexpr int smem_bytes =
      2 * BT * (D + 8) * (int)sizeof(__nv_bfloat16) + 2 * BT * (int)sizeof(float);
  dim3 grid((Skv + BT - 1) / BT, B * H);
  flash_bwd_dkv_mma_kernel<D><<<grid, MMA_NT, smem_bytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, lse, delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, H, Sq, Skv,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, scale);
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
  if (dtype == 0 && D == 64) OMGSR_DQ(launch_dq_mma<64>);
  if (dtype == 0 && D == 128) OMGSR_DQ(launch_dq_mma<128>);
  if (dtype == 0 && D == 512) OMGSR_DQ(launch_dq_wide<512>);
  if (dtype == 1 && D == 64) OMGSR_DQ((launch_dq<float, 64, 64, 64>));
  if (dtype == 1 && D == 128) OMGSR_DQ((launch_dq<float, 128, 64, 64>));
  if (dtype == 1 && D == 512) OMGSR_DQ((launch_dq<float, 512, 32, 16>));
#undef OMGSR_DQ
  return -1;
}

// Same operands, strides in the order q, k, v, dout; reads the delta that
// flash_attention_bwd_dq wrote. Writes dk and dv, contiguous (B,Skv,H,D).
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                       const void* dout, const float* lse, const float* delta,
                                       void* dk, void* dv, int dtype, int B, int H, int Sq,
                                       int Skv, int D, const long long* strides, float scale,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define OMGSR_DKV(launcher) \
  return launcher(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Skv, strides, scale, s)
  if (dtype == 0 && D == 64) OMGSR_DKV(launch_dkv_mma<64>);
  if (dtype == 0 && D == 128) OMGSR_DKV(launch_dkv_mma<128>);
  if (dtype == 0 && D == 512) OMGSR_DKV(launch_dkv_wide<512>);
  if (dtype == 1 && D == 64) OMGSR_DKV((launch_dkv<float, 64, 64, 64>));
  if (dtype == 1 && D == 128) OMGSR_DKV((launch_dkv<float, 128, 64, 64>));
  if (dtype == 1 && D == 512) OMGSR_DKV((launch_dkv<float, 512, 16, 32>));
#undef OMGSR_DKV
  return -1;
}
