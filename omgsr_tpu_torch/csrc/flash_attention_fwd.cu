// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel omgsr_tpu/ops/flash_attention.py:_fwd_kernel
// (called from _forward / flash_attention_bshd): softmax(q k^T * scale) v by
// the online-softmax recurrence over kv tiles, f32 accumulation, plus the f32
// log-sum-exp of every query row (the backward kernels need it).
//
// What differs from the TPU kernel, and why:
//   * The TPU grid ran the kv axis sequentially and carried (acc, m, l) in
//     VMEM scratch between grid steps. Blocks on a GPU run in no order, so
//     one block owns one (batch*head, 64-row q tile) and loops over the kv
//     tiles itself; (m, l) live in shared memory, the accumulator in
//     registers.
//   * The TPU wrapper transposed (B,S,H,D) to (B*H,S,D) and padded S to the
//     block size in device memory. Here the kernel reads the (B,S,H,D)
//     layout through the strides it is given and masks the ragged edges of
//     Sq and Skv itself, so no copy is made before or after the launch.
//
// Bound on this card: operations (4*B*H*Sq*Skv*D flops against ~1 byte per
// 2*Skv flops of input). Three kernels share the block layout above:
//   * flash_fwd_kernel (f32 inputs): plain f32 FMAs from
//     shared memory (both tiles staged as f32, register micro-tiles of
//     TQ/16 x TK/16 scores, conflict-free float4 reads). Exact for f32
//     inputs, far from the tensor-core rate. 256 threads; shared memory Q
//     [TQ][D+4], K and V [TK][D+4], scores [TQ][TK+4] f32, m/l/alpha [TQ]
//     each (dynamic, opt-in): TQ = TK = 64 at D = 64 and 128 (70,400 and
//     119,552 bytes); at D = 512 the tiles shrink to TQ = TK = 32 (203,136
//     bytes of the 232,448 a block may have).
//   * flash_fwd_mma_kernel (bf16 inputs, D = 64 and 128): tensor cores
//     through mma.sync, described where it is defined.
//   * flash_fwd_wide_kernel (bf16 inputs, D = 512, the VAE mid block's one
//     head): tensor cores through mma.sync with the scores and the output
//     split over eight warps, described where it is defined.
//   wgmma, TMA and double buffering are not used yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using namespace omgsr_mma;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr float NEG_INF = -1e30f;

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    float4 raw = *reinterpret_cast<const float4*>(p);
    out[0] = raw.x;
    out[1] = raw.y;
    out[2] = raw.z;
    out[3] = raw.w;
  }
};

// Stage a ROWS-row tile of a (rows, D) matrix with the given row stride into
// shared memory as f32 [ROWS][D+4], times `mul`; rows >= rows_valid become 0.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t row_stride,
                                          int rows_valid, float mul) {
  constexpr int N = Vec16<T>::N;
  constexpr int VPR = D / N;
  constexpr int LD = D + 4;
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += NT) {
    const int r = idx / VPR;
    const int v = idx % VPR;
    float vals[N];
    if (r < rows_valid) {
      Vec16<T>::load(src + (int64_t)r * row_stride + v * N, vals);
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

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

template <typename T, int D, int TQ, int TK>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int H, int Sq, int Skv,
    int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale) {
  constexpr int LD = D + 4;
  constexpr int LS = TK + 4;
  constexpr int DG = D / 64;    // float4 column groups per thread in the PV product
  constexpr int IQ = TQ / 16;   // q rows per thread
  constexpr int JK = TK / 16;   // kv columns per thread
  constexpr int TPR = NT / TQ;  // lanes that share one row in the softmax
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + TQ * LD;
  float* Vs = Ks + TK * LD;
  float* Ss = Vs + TK * LD;
  float* m_s = Ss + TQ * LS;
  float* l_s = m_s + TQ;
  float* a_s = l_s + TQ;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * TQ;

  const T* q_base = q + b * q_sb + h * q_sh + (int64_t)q0 * q_ss;
  const T* k_base = k + b * k_sb + h * k_sh;
  const T* v_base = v + b * v_sb + h * v_sh;

  load_tile<T, D, TQ>(Qs, q_base, q_ss, min(TQ, Sq - q0), scale);
  if (tid < TQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  float acc[IQ][4 * DG];
#pragma unroll
  for (int i = 0; i < IQ; ++i)
#pragma unroll
    for (int j = 0; j < 4 * DG; ++j) acc[i][j] = 0.f;

  for (int kv0 = 0; kv0 < Skv; kv0 += TK) {
    const int kvalid = min(TK, Skv - kv0);
    __syncthreads();  // the previous tile's readers of Ks/Vs/Ss are done
    load_tile<T, D, TK>(Ks, k_base + (int64_t)kv0 * k_ss, k_ss, kvalid, 1.f);
    load_tile<T, D, TK>(Vs, v_base + (int64_t)kv0 * v_ss, v_ss, kvalid, 1.f);
    __syncthreads();

    // S = (Q*scale) K^T; this thread owns rows ty+16i and columns tx+16j
    float s[IQ][JK];
#pragma unroll
    for (int i = 0; i < IQ; ++i)
#pragma unroll
      for (int j = 0; j < JK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[IQ], kv[JK];
#pragma unroll
      for (int i = 0; i < IQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < JK; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < IQ; ++i)
#pragma unroll
        for (int j = 0; j < JK; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y + qv[i].z * kv[j].z +
                     qv[i].w * kv[j].w;
    }
#pragma unroll
    for (int i = 0; i < IQ; ++i)
#pragma unroll
      for (int j = 0; j < JK; ++j) {
        const int col = tx + 16 * j;
        Ss[(ty + 16 * i) * LS + col] = (col < kvalid) ? s[i][j] : NEG_INF;
      }
    __syncthreads();

    // online softmax: TPR neighbouring lanes share one row
    {
      const int row = tid / TPR;
      const int part = tid % TPR;
      float* srow = Ss + row * LS;
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < TK / TPR; ++jj) mx = fmaxf(mx, srow[part + TPR * jj]);
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < TK / TPR; ++jj) {
        const float p = __expf(srow[part + TPR * jj] - m_new);
        srow[part + TPR * jj] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();  // every lane of the row has read m_old
      if (part == 0) {
        const float alpha = __expf(m_old - m_new);
        a_s[row] = alpha;
        l_s[row] = l_s[row] * alpha + sum;
        m_s[row] = m_new;
      }
    }
    __syncthreads();

    // acc = acc*alpha + P V; rows ty+16i, columns g*64 + tx*4 .. +3
#pragma unroll
    for (int i = 0; i < IQ; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4 * DG; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 2
    for (int c = 0; c < TK; c += 4) {
      float4 pv[IQ];
#pragma unroll
      for (int i = 0; i < IQ; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ss + (ty + 16 * i) * LS + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int g = 0; g < DG; ++g) {
          const float4 vv =
              *reinterpret_cast<const float4*>(Vs + (c + cc) * LD + g * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < IQ; ++i) {
            const float p = comp(pv[i], cc);
            acc[i][4 * g + 0] += p * vv.x;
            acc[i][4 * g + 1] += p * vv.y;
            acc[i][4 * g + 2] += p * vv.z;
            acc[i][4 * g + 3] += p * vv.w;
          }
        }
      }
    }
  }

  // l_s/m_s were last written before the barrier that precedes the final PV
  const int64_t o_ss = (int64_t)H * D;
  T* o_base = o + ((int64_t)b * Sq + q0) * o_ss + (int64_t)h * D;
#pragma unroll
  for (int i = 0; i < IQ; ++i) {
    const int row = ty + 16 * i;
    if (q0 + row < Sq) {
      const float inv = 1.f / l_s[row];
#pragma unroll
      for (int g = 0; g < DG; ++g)
        store4(o_base + (int64_t)row * o_ss + g * 64 + tx * 4, acc[i][4 * g + 0] * inv,
               acc[i][4 * g + 1] * inv, acc[i][4 * g + 2] * inv, acc[i][4 * g + 3] * inv);
    }
  }
  if (tid < TQ && q0 + tid < Sq) lse[(int64_t)bh * Sq + q0 + tid] = m_s[tid] + logf(l_s[tid]);
}

// ----------------------------------------------------------------------------
// bf16 path: tensor cores through mma.sync.m16n8k16 (bf16 in, f32 accumulate).
//
// One block = 4 warps = a 64-row q tile; each warp owns 16 q rows and keeps
// its Q fragments, the 16 x 64 score tile, the running (m, l) of its rows and
// the 16 x D accumulator in registers. K and V tiles (64 rows) are staged in
// shared memory as bf16 with rows padded by 16 bytes, which makes every
// ldmatrix phase hit 8 different 16-byte bank groups. K fragments come from
// ldmatrix, V fragments from ldmatrix.trans (V is the "k x n" operand and sits
// row-major in kv). P is rounded to bf16 for the second product, its row sum
// is taken in f32 before the rounding. Shared memory: 2 * 64 * (D+8) * 2
// bytes = 18,432 (D=64) or 34,816 (D=128).
// ----------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(MMA_NT) flash_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
    int H, int Sq, int Skv, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale) {
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;  // k-steps of the first product
  constexpr int NO = D / 8;   // n-tiles of the accumulator
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;    // row of the fragment (and row + 8)
  const int tig = lane & 3;   // column pair of the fragment
  const int lrow = lane & 7;  // ldmatrix: row within the 8x8 matrix this lane addresses
  const int lmat = lane >> 3; // ldmatrix: which of the four matrices
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ + warp * 16;  // first q row of this warp

  const __nv_bfloat16* k_base = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* v_base = v + b * v_sb + h * v_sh;

  // Q fragments of this warp's 16 rows, straight from global memory
  uint32_t qf[KS][4];
  load_a_fragments<KS>(qf, q + b * q_sb + h * q_sh, q_ss, q0, Sq, g, tig);

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;

  for (int kv0 = 0; kv0 < Skv; kv0 += BK) {
    const int kvalid = min(BK, Skv - kv0);
    __syncthreads();  // the previous tile's readers are done
    stage_tile_bf16<D>(Ks, k_base + (int64_t)kv0 * k_ss, k_ss, kvalid);
    stage_tile_bf16<D>(Vs, v_base + (int64_t)kv0 * v_ss, v_ss, kvalid);
    __syncthreads();

    // S = Q K^T: 8 n-tiles of 8 kv columns
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ks += 2) {
        // matrices: (d 0..7, d 8..15) of k-step ks, then of k-step ks+1
        uint32_t kf[4];
        ldmatrix_x4(kf, Ks + (j * 8 + lrow) * LD + ks * 16 + lmat * 8);
        mma_bf16(s[j], qf[ks], kf[0], kf[1]);
        mma_bf16(s[j], qf[ks + 1], kf[2], kf[3]);
      }
    }

    // scale, mask the ragged kv edge, row maxima (rows g and g+8)
    float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int col = j * 8 + tig * 2;
      s[j][0] = (col < kvalid) ? s[j][0] * scale : NEG_INF;
      s[j][1] = (col + 1 < kvalid) ? s[j][1] * scale : NEG_INF;
      s[j][2] = (col < kvalid) ? s[j][2] * scale : NEG_INF;
      s[j][3] = (col + 1 < kvalid) ? s[j][3] * scale : NEG_INF;
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float al_lo = __expf(m_lo - mn_lo), al_hi = __expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;

    // P = exp(S - m), its f32 row sums, and P as bf16 A fragments
    uint32_t pf[BK / 16][4];
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = __expf(s[j][0] - mn_lo), p1 = __expf(s[j][1] - mn_lo);
      const float p2 = __expf(s[j][2] - mn_hi), p3 = __expf(s[j][3] - mn_hi);
      sum_lo += p0 + p1;
      sum_hi += p2 + p3;
      pf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 1);
    sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 2);
    sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 1);
    sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 2);
    l_lo = l_lo * al_lo + sum_lo;
    l_hi = l_hi * al_hi + sum_hi;

    // acc = acc * alpha + P V
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= al_lo;
      acc[j][1] *= al_lo;
      acc[j][2] *= al_hi;
      acc[j][3] *= al_hi;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        // matrices: kv rows (0..7, 8..15) of k-step kk for n-tile j, then for n-tile j+1
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vs + (kk * 16 + (lmat & 1) * 8 + lrow) * LD + (j + (lmat >> 1)) * 8);
        mma_bf16(acc[j], pf[kk], vf[0], vf[1]);
        mma_bf16(acc[j + 1], pf[kk], vf[2], vf[3]);
      }
    }
  }

  const int64_t o_ss = (int64_t)H * D;
  __nv_bfloat16* o_base = o + (int64_t)b * Sq * o_ss + (int64_t)h * D;
  const int r_lo = q0 + g, r_hi = q0 + g + 8;
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = j * 8 + tig * 2;
    if (r_lo < Sq)
      *reinterpret_cast<uint32_t*>(o_base + (int64_t)r_lo * o_ss + c) =
          pack_bf16(acc[j][0] * inv_lo, acc[j][1] * inv_lo);
    if (r_hi < Sq)
      *reinterpret_cast<uint32_t*>(o_base + (int64_t)r_hi * o_ss + c) =
          pack_bf16(acc[j][2] * inv_hi, acc[j][3] * inv_hi);
  }
  if (tig == 0) {
    if (r_lo < Sq) lse[(int64_t)bh * Sq + r_lo] = m_lo + logf(l_lo);
    if (r_hi < Sq) lse[(int64_t)bh * Sq + r_hi] = m_hi + logf(l_hi);
  }
}

// ----------------------------------------------------------------------------
// bf16 path at D = 512 (the VAE mid block's single head): the same
// recurrence, tiles cut for the width. At D = 512 one warp cannot hold 16 q
// rows as flash_fwd_mma_kernel does (Q fragments 128 and the accumulator 256
// registers a thread), so the block's eight warps split the work and share
// what they must through shared memory:
//   * a block owns WQ = 64 q rows, staged once in shared memory with the
//     streamed K and V tiles of WK = 32 kv rows, all bf16 with rows padded by
//     16 bytes;
//   * scores: warp (rw, cw) = (warp % 4, warp / 4) computes the 16 x 16 block
//     of q rows rw*16.. and kv columns cw*16.. over the 32 k-steps of D, A
//     and B fragments by ldmatrix, and writes it scaled and masked as f32;
//   * the online softmax runs from shared memory, four lanes per row: the
//     row maxima, P = exp(S - m) rounded to bf16 into its own tile (row sums
//     taken in f32 before the rounding), and the running m, l and the
//     rescale factor of every row;
//   * output: warp (rw, cw) owns q rows rw*16.. and the D/2 = 256 columns
//     cw*256.., a 16 x 256 f32 accumulator (128 registers a thread); it reads
//     P by ldmatrix and V by ldmatrix.trans.
// Shared memory: Q 64 x 520, K and V 32 x 520 bf16, P 64 x 40 bf16, scores
// 64 x 36 f32, m / l / alpha 64 f32 each: 148,224 bytes at D = 512 (opt-in),
// so one block per SM; 4096 q rows give 64 blocks for 132 SMs.
// ----------------------------------------------------------------------------

constexpr int WQ = 64;    // q rows of a block
constexpr int WK = 32;    // kv rows of a streamed tile
constexpr int WNT = 256;  // eight warps

template <int D>
constexpr int wide_fwd_smem_bytes() {
  return (WQ + 2 * WK) * (D + 8) * 2 + WQ * (WK + 8) * 2 + WQ * (WK + 4) * 4 + 3 * WQ * 4;
}

template <int D>
__global__ void __launch_bounds__(WNT, 1) flash_fwd_wide_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
    int H, int Sq, int Skv, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
    int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale) {
  constexpr int LD = D + 8;     // bf16 row of a staged tile
  constexpr int LP = WK + 8;    // bf16 row of P
  constexpr int LSF = WK + 4;   // f32 row of the scores
  constexpr int KS = D / 16;    // k-steps of the score product
  constexpr int NW = D / 16;    // n-tiles of a warp's half of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + WQ * LD;
  __nv_bfloat16* Vs = Ks + WK * LD;
  __nv_bfloat16* Ps = Vs + WK * LD;
  float* Ss = reinterpret_cast<float*>(Ps + WQ * LP);
  float* m_s = Ss + WQ * LSF;
  float* l_s = m_s + WQ;
  float* a_s = l_s + WQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int rw = warp & 3;   // this warp's 16 rows
  const int cw = warp >> 2;  // this warp's kv columns (scores) and half of D (output)
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * WQ;

  const __nv_bfloat16* k_base = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* v_base = v + b * v_sb + h * v_sh;

  stage_rows_bf16<D, WQ, WNT>(Qs, q + b * q_sb + h * q_sh + (int64_t)q0 * q_ss, q_ss,
                              min(WQ, Sq - q0));
  if (tid < WQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  float acc[NW][4];
#pragma unroll
  for (int j = 0; j < NW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int kv0 = 0; kv0 < Skv; kv0 += WK) {
    const int kvalid = min(WK, Skv - kv0);
    __syncthreads();  // the previous tile's readers of Ks, Vs, Ps, a_s are done
    stage_rows_bf16<D, WK, WNT>(Ks, k_base + (int64_t)kv0 * k_ss, k_ss, kvalid);
    stage_rows_bf16<D, WK, WNT>(Vs, v_base + (int64_t)kv0 * v_ss, v_ss, kvalid);
    __syncthreads();

    // S = Q K^T for rows rw*16.. and kv columns cw*16.. (two n-tiles)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t af[4], bf[4];
      ldmatrix_a(af, Qs, LD, rw * 16, ks * 16, lane);
      ldmatrix_b2(bf, Ks, LD, cw * 16, ks * 16, lane);
      mma_bf16(s[0], af, bf[0], bf[1]);
      mma_bf16(s[1], af, bf[2], bf[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = cw * 16 + j * 8 + tig * 2;
      const int r = rw * 16 + g;
      *reinterpret_cast<float2*>(Ss + r * LSF + col) =
          make_float2(col < kvalid ? s[j][0] * scale : NEG_INF,
                      col + 1 < kvalid ? s[j][1] * scale : NEG_INF);
      *reinterpret_cast<float2*>(Ss + (r + 8) * LSF + col) =
          make_float2(col < kvalid ? s[j][2] * scale : NEG_INF,
                      col + 1 < kvalid ? s[j][3] * scale : NEG_INF);
    }
    __syncthreads();

    // online softmax: four neighbouring lanes share one row, WK / 4 columns each
    {
      const int row = tid >> 2;
      const int part = tid & 3;
      const float* srow = Ss + row * LSF;
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < WK / 4; ++jj) mx = fmaxf(mx, srow[part + 4 * jj]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < WK / 4; ++jj) {
        const float p = __expf(srow[part + 4 * jj] - m_new);
        Ps[row * LP + part + 4 * jj] = __float2bfloat16(p);
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();  // every lane of the row has read m_old
      if (part == 0) {
        const float alpha = __expf(m_old - m_new);
        a_s[row] = alpha;
        l_s[row] = l_s[row] * alpha + sum;
        m_s[row] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V over rows rw*16.. and columns cw*D/2..
    const float al_lo = a_s[rw * 16 + g], al_hi = a_s[rw * 16 + g + 8];
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      acc[j][0] *= al_lo;
      acc[j][1] *= al_lo;
      acc[j][2] *= al_hi;
      acc[j][3] *= al_hi;
    }
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk) {
      uint32_t pf[4];
      ldmatrix_a(pf, Ps, LP, rw * 16, kk * 16, lane);
#pragma unroll
      for (int j = 0; j < NW; j += 2) {
        uint32_t vf[4];
        ldmatrix_b2_trans(vf, Vs, LD, kk * 16, cw * (D / 2) + j * 8, lane);
        mma_bf16(acc[j], pf, vf[0], vf[1]);
        mma_bf16(acc[j + 1], pf, vf[2], vf[3]);
      }
    }
  }

  // l_s / m_s were last written before the barrier that precedes the final PV
  const int64_t o_ss = (int64_t)H * D;
  __nv_bfloat16* o_base = o + (int64_t)b * Sq * o_ss + (int64_t)h * D;
  const int r_lo = q0 + rw * 16 + g, r_hi = r_lo + 8;
  const float inv_lo = 1.f / l_s[rw * 16 + g], inv_hi = 1.f / l_s[rw * 16 + g + 8];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int c = cw * (D / 2) + j * 8 + tig * 2;
    if (r_lo < Sq)
      *reinterpret_cast<uint32_t*>(o_base + (int64_t)r_lo * o_ss + c) =
          pack_bf16(acc[j][0] * inv_lo, acc[j][1] * inv_lo);
    if (r_hi < Sq)
      *reinterpret_cast<uint32_t*>(o_base + (int64_t)r_hi * o_ss + c) =
          pack_bf16(acc[j][2] * inv_hi, acc[j][3] * inv_hi);
  }
  if (tid < WQ && q0 + tid < Sq) lse[(int64_t)bh * Sq + q0 + tid] = m_s[tid] + logf(l_s[tid]);
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
               int Sq, int Skv, const long long* st, float scale, cudaStream_t stream) {
  constexpr int smem_bytes = 2 * BK * (D + 8) * (int)sizeof(__nv_bfloat16);
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_mma_kernel<D><<<grid, MMA_NT, smem_bytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, lse, H, Sq, Skv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_wide(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                int Sq, int Skv, const long long* st, float scale, cudaStream_t stream) {
  constexpr int smem_bytes = wide_fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wide_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + WQ - 1) / WQ, B * H);
  flash_fwd_wide_kernel<D><<<grid, WNT, smem_bytes, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, lse, H, Sq, Skv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], scale);
  return (int)cudaGetLastError();
}

// The f32 FMA kernel with TQ q rows a block and TK kv rows a streamed tile.
template <typename T, int D, int TQ, int TK>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
           int Sq, int Skv, const long long* st, float scale, cudaStream_t stream) {
  constexpr int LD = D + 4;
  constexpr int smem_bytes =
      (TQ * LD + 2 * TK * LD + TQ * (TK + 4) + 3 * TQ) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D, TQ, TK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + TQ - 1) / TQ, B * H);
  flash_fwd_kernel<T, D, TQ, TK><<<grid, NT, smem_bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, H, Sq, Skv, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,Sq,H,D), k/v (B,Skv,H,D) read through element strides (batch, seq,
// head; the D axis is contiguous); o is a contiguous (B,Sq,H,D), lse a
// contiguous (B*H,Sq) f32. dtype: 0 = bf16 (tensor-core kernels), 1 = f32 (FMA
// kernel). D: 64, 128 or 512. Every row start must be 16-byte aligned. Returns
// 0, a CUDA error code, or -1 for an unsupported dtype / head dim.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int dtype, int B, int H, int Sq, int Skv, int D,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh, float scale,
                                   void* stream) {
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && D == 64) return launch_mma<64>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, s);
  if (dtype == 0 && D == 128) return launch_mma<128>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, s);
  if (dtype == 0 && D == 512) return launch_wide<512>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, s);
  if (dtype == 1 && D == 64)
    return launch<float, 64, 64, 64>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, s);
  if (dtype == 1 && D == 128)
    return launch<float, 128, 64, 64>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, s);
  if (dtype == 1 && D == 512)
    return launch<float, 512, 32, 32>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, s);
  return -1;
}
