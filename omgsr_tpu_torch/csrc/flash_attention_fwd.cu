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
//     one block owns one (batch*head, q tile) and loops over the kv
//     tiles itself; (m, l) live in shared memory, the accumulator in
//     registers.
//   * The TPU wrapper transposed (B,S,H,D) to (B*H,S,D) and padded S to the
//     block size in device memory. Here the kernel reads the (B,S,H,D)
//     layout through the strides it is given and masks the ragged edges of
//     Sq and Skv itself, so no copy is made before or after the launch.
//
// Bound on this card: operations (4*B*H*Sq*Skv*D flops against ~1 byte per
// 2*Skv flops of input). Three kernels:
//   * flash_fwd_kernel (f32 inputs): plain f32 FMAs from
//     shared memory (both tiles staged as f32, register micro-tiles of
//     TQ/16 x TK/16 scores, conflict-free float4 reads). Exact for f32
//     inputs, far from the tensor-core rate. 256 threads; shared memory Q
//     [TQ][D+4], K and V [TK][D+4], scores [TQ][TK+4] f32, m/l/alpha [TQ]
//     each (dynamic, opt-in): TQ = TK = 64 at D = 64 and 128 (70,400 and
//     119,552 bytes); at D = 512 the tiles shrink to TQ = TK = 32 (203,136
//     bytes of the 232,448 a block may have).
//   * flash_fwd_wgmma_kernel (bf16 inputs, D = 64 and 128): Hopper's
//     tensor-core path, TMA loads into a ring of shared-memory stages
//     guarded by mbarriers, wgmma products, a producer warpgroup and two
//     consumer warpgroups on a 128-row q tile; described where it is
//     defined.
//   * flash_fwd_wide_kernel (bf16 inputs, D = 512, the VAE mid block's one
//     head): tensor cores through mma.sync with the scores and the output
//     split over eight warps, described where it is defined; it stages its
//     tiles through registers, without TMA or wgmma.

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
// bf16 path at D = 64 and 128: flash_fwd_wgmma_kernel, built for Hopper.
//
// What bounds it: operations (4*Sq*Skv*D flops per head against 2*(Sq+2*Skv)*D
// bytes), so the design keeps the tensor cores fed:
//   * Block = three warpgroups (384 threads) on a 128-row q tile of one
//     (batch, head). Warpgroup 0 is the producer: after giving up registers
//     (setmaxnreg 24) one of its threads issues every TMA load. Warpgroups 1
//     and 2 are consumers (setmaxnreg 240), 64 q rows each; each kv tile staged
//     feeds all 128 q rows.
//   * Shared memory: the Q tile, loaded once, and a ring of STAGES stages of K
//     and V tiles of 128 kv rows, all as TMA writes them with the 128-byte
//     swizzle (a row of 64 bf16 per box; at D = 128 a tile is two boxes), tile
//     bases 1024-byte aligned. TMA reads q/k/v through 4-D tensor maps over
//     (D, H, S, B) with the caller's strides, so packed views go in without a
//     copy, and fills rows past S with zeros.
//   * Per stage a `full` mbarrier (the producer's arrive.expect_tx, completed
//     by the TMA bytes) and an `empty` mbarrier (one arrival per consumer warp
//     once its P V product on that stage has retired); the producer waits on
//     `empty` before it reloads a stage, so loads run STAGES - 1 tiles ahead.
//   * S = Q K^T by wgmma m64n128k16, both operands from shared memory (K-major),
//     D/16 k-steps; the online softmax in registers, in the base-2 domain
//     (scores times scale * log2(e), ex2.approx); kv columns past Skv are masked on
//     the last tile only (TMA's zero rows would score 0, not -inf).
//   * O += P V by wgmma m64nDk16: A = P rounded to bf16 in registers (the
//     accumulator layout of S is the A fragment layout, so no shuffle; the row
//     sums are taken in f32 before the rounding), B = V from shared memory with
//     the transpose bit (V lies (kv, D) with D contiguous: MN-major). O is
//     rescaled by alpha before the product is issued.
//   * Inside a consumer warpgroup, S of tile t and P V of tile t - 1 are
//     issued together and only S is waited for, so the softmax of tile t runs
//     while the tensor cores finish P V of tile t - 1; O is rescaled, and the
//     stage of tile t - 1 released, once that product has retired.
//   * The two consumer warpgroups take turns to issue their products (two
//     named barriers), so one's softmax runs while the other's products
//     occupy the tensor cores; the producer's loads overlap both. Without the turns both warpgroups, released by the same `full`
//     barrier, ran their products and their softmax at the same times.
//   * Epilogue: O / l rounded to bf16, staged into the warpgroup's own rows of
//     the Q tile (free once its last S product has retired) in the swizzled
//     layout and written by TMA stores, which drop rows >= Sq;
//     lse = m + log(l) into the f32 (B*H, Sq) buffer. A consumer warpgroup
//     whose 64 rows all lie past Sq exits at once.
// No atomics and no split over kv: every output element is summed by one
// thread in one order, so a run gives the same bits every time.
// ----------------------------------------------------------------------------

constexpr int HQ = 128;          // q rows of a block (two consumer warpgroups of 64)
constexpr int HK = 128;          // kv rows of a staged tile
constexpr int STAGES = 3;        // K/V ring: 112 KiB at D = 64, 225 KiB at D = 128
constexpr int HNT = 384;         // three warpgroups
constexpr int BOX_BYTES = 128 * 128;  // one 64-column box of 128 rows

template <int D>
struct HopperFwdSmem {
  static constexpr int TILE = HQ * D * 2;  // bytes of a 128-row tile (q or kv)
  static constexpr int Q = 0;
  __host__ __device__ static constexpr int K(int s) { return TILE * (1 + 2 * s); }
  __host__ __device__ static constexpr int V(int s) { return TILE * (2 + 2 * s); }
  static constexpr int BARS = TILE * (1 + 2 * STAGES);  // q_full, full[STAGES], empty[STAGES]
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

// S (64 x 128) = Q K^T for the warpgroup's 64 q rows at shared address q_wg,
// one kv tile at k_tile: D/16 k-steps of 32 bytes inside each 64-column box.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_wg, uint32_t k_tile) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t off = (ks >> 2) * BOX_BYTES + (ks & 3) * 32;
    wgmma_ss_m64n128k16(sc, wgmma_desc(q_wg + off, 16, 1024), wgmma_desc(k_tile + off, 16, 1024), ks > 0);
  }
}

// O (64 x D) += P V: 8 k-steps of 16 kv rows (2048 bytes of the tile each).
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&pf)[8][4], uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < HK / 16; ++kk) {
    const uint64_t dv = wgmma_desc(v_tile + kk * 2048, BOX_BYTES, 1024);
    if constexpr (D == 64) {
      wgmma_rs_m64n64k16_tb(acc, pf[kk], dv, 1);
    } else {
      wgmma_rs_m64n128k16_tb(acc, pf[kk], dv, 1);
    }
  }
}

// One online-softmax step on the scores of one kv tile (this thread's rows
// g and g + 8, columns 8j + 2 tig (+1)), in the base-2 domain: scale, mask the
// columns >= kvalid, new row maxima (m), rescale factors (al), P = 2^(s - m) in
// place, and l = l * al + rowsum(P) in f32.
__device__ __forceinline__ void online_softmax(float (&sc)[64], int kvalid, int tig, float scale_log2,
                                               float& m_lo, float& m_hi, float& l_lo, float& l_hi,
                                               float& al_lo, float& al_hi) {
#pragma unroll
  for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;
  if (kvalid < HK) {
    const float neg_inf = __int_as_float(0xff800000u);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int col = (i >> 2) * 8 + tig * 2 + (i & 1);
      if (col >= kvalid) sc[i] = neg_inf;
    }
  }
  float mx_lo = m_lo, mx_hi = m_hi;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx_lo = fmaxf(mx_lo, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
  al_lo = fast_exp2(m_lo - mx_lo);
  al_hi = fast_exp2(m_hi - mx_hi);
  m_lo = mx_lo;
  m_hi = mx_hi;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    sc[4 * j] = fast_exp2(sc[4 * j] - mx_lo);
    sc[4 * j + 1] = fast_exp2(sc[4 * j + 1] - mx_lo);
    sc[4 * j + 2] = fast_exp2(sc[4 * j + 2] - mx_hi);
    sc[4 * j + 3] = fast_exp2(sc[4 * j + 3] - mx_hi);
    sum_lo += sc[4 * j] + sc[4 * j + 1];
    sum_hi += sc[4 * j + 2] + sc[4 * j + 3];
  }
  sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 1);
  sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, 2);
  sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 1);
  sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, 2);
  l_lo = l_lo * al_lo + sum_lo;
  l_hi = l_hi * al_hi + sum_hi;
}

// P rounded to bf16 as the A fragments of P V: k-step kk = n-tiles 2kk, 2kk + 1.
__device__ __forceinline__ void pack_p(uint32_t (&pf)[8][4], const float (&sc)[64]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    pf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(HNT, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
    float* __restrict__ lse, int H, int Sq, int Skv, float scale_log2) {
  using L = HopperFwdSmem<D>;
  constexpr int CB = D / 64;  // 64-column boxes of a tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_full = base + L::BARS;
  auto full = [&](int s) { return q_full + 8u * (1 + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + STAGES + s); };

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * HQ;
  const int n_kv = (Skv + HK - 1) / HK;
  // consumer warpgroups that own a row < Sq (the second one owns none when the
  // tile holds at most 64 rows, e.g. Sq = 64)
  const int n_cw = Sq - q0 > 64 ? 2 : 1;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * n_cw);  // one arrival per working consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (tid == 0) {
      prefetch_tensormap(&tm_q);
      prefetch_tensormap(&tm_k);
      prefetch_tensormap(&tm_v);
      mbar_arrive_expect_tx(q_full, L::TILE);
#pragma unroll
      for (int c = 0; c < CB; ++c) tma_load_4d(base + L::Q + c * BOX_BYTES, &tm_q, q_full, c * 64, h, q0, b);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(empty(s), ((t / STAGES) - 1) & 1);
        mbar_arrive_expect_tx(full(s), 2 * L::TILE);
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          tma_load_4d(base + L::K(s) + c * BOX_BYTES, &tm_k, full(s), c * 64, h, t * HK, b);
          tma_load_4d(base + L::V(s) + c * BOX_BYTES, &tm_v, full(s), c * 64, h, t * HK, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns q rows 64 cw .. 64 cw + 63 of the tile ----
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    if (cw >= n_cw) return;  // no row of this warpgroup exists
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    const int r_lo = q0 + cw * 64 + warp * 16 + g;  // this thread's rows r_lo, r_lo + 8
    const uint32_t q_wg = base + L::Q + cw * 64 * 128;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const float neg_inf = __int_as_float(0xff800000u);
    float m_lo = neg_inf, m_hi = neg_inf, l_lo = 0.f, l_hi = 0.f;

    // Tile t's softmax runs while the tensor cores do P V of tile t - 1:
    // S(t) and PV(t-1) are issued together, S(t) is waited for alone.
    float sc[64];
    uint32_t pf[8][4];
    float al_lo, al_hi;
    // The two warpgroups take turns to issue their products (named barriers 1
    // and 2), so one's products run while the other does its softmax; with one
    // kv tile there is nothing to overlap. Warpgroup 0 goes first; each passes
    // the turn after each of its n_kv + 1 issues, the second one not after its
    // last, so every barrier ends balanced.
    const bool turns = n_cw == 2 && n_kv > 1;
    int turn = 0;
    auto my_turn = [&] {
      if (turns) named_barrier_sync(1 + cw, 256);
    };
    auto pass_turn = [&] {
      if (turns && (cw == 0 || ++turn < n_kv + 1)) named_barrier_arrive(2 - cw, 256);
    };
    if (turns && cw == 1) named_barrier_arrive(1, 256);
    mbar_wait(q_full, 0);
    mbar_wait(full(0), 0);
    my_turn();
    wgmma_fence();
    issue_qk<D>(sc, q_wg, base + L::K(0));
    wgmma_commit_group();
    pass_turn();
    wgmma_wait_group<0>();
    fence_operands(sc);
    online_softmax(sc, Skv, tig, scale_log2, m_lo, m_hi, l_lo, l_hi, al_lo, al_hi);
    pack_p(pf, sc);
    for (int t = 1; t < n_kv; ++t) {
      const int s = t % STAGES;
      const int sp = (t - 1) % STAGES;
      mbar_wait(full(s), (t / STAGES) & 1);
      fence_operands(acc);
      fence_fragments(pf);
      my_turn();
      wgmma_fence();
      issue_qk<D>(sc, q_wg, base + L::K(s));
      wgmma_commit_group();
      issue_pv<D>(acc, pf, base + L::V(sp));
      wgmma_commit_group();
      pass_turn();
      wgmma_wait_group<1>();  // S(t) has landed; PV(t-1) may still run
      fence_operands(sc);
      online_softmax(sc, Skv - t * HK, tig, scale_log2, m_lo, m_hi, l_lo, l_hi, al_lo, al_hi);
      wgmma_wait_group<0>();
      fence_operands(acc);
      fence_fragments(pf);  // the A fragments stay untouched until PV(t-1) has read them
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(sp));  // this warp is done with stage sp
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= al_lo;
        acc[4 * j + 1] *= al_lo;
        acc[4 * j + 2] *= al_hi;
        acc[4 * j + 3] *= al_hi;
      }
      pack_p(pf, sc);
    }
    {
      const int sp = (n_kv - 1) % STAGES;
      fence_operands(acc);
      fence_fragments(pf);
      my_turn();
      wgmma_fence();
      issue_pv<D>(acc, pf, base + L::V(sp));
      wgmma_commit_group();
      pass_turn();
      wgmma_wait_group<0>();
      fence_operands(acc);
      fence_fragments(pf);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(sp));
    }

    // ---- epilogue ----
    const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
    // this warpgroup's Q rows are free (its last S product has retired): stage
    // O there in the swizzled layout TMA reads, then store it by TMA
    const int rl = warp * 16 + g;  // row within the warpgroup's 64, and rl + 8
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const uint32_t box = q_wg + (j >> 3) * BOX_BYTES;
      const int chunk = j & 7;
      st_shared_u32(box + rl * 128 + ((chunk ^ (rl & 7)) << 4) + tig * 4,
                    pack_bf16(acc[4 * j] * inv_lo, acc[4 * j + 1] * inv_lo));
      st_shared_u32(box + (rl + 8) * 128 + ((chunk ^ ((rl + 8) & 7)) << 4) + tig * 4,
                    pack_bf16(acc[4 * j + 2] * inv_hi, acc[4 * j + 3] * inv_hi));
    }
    fence_proxy_async();
    named_barrier_sync(3 + cw, 128);
    if ((tid & 127) == 0) {
#pragma unroll
      for (int c = 0; c < CB; ++c) tma_store_4d(&tm_o, q_wg + c * BOX_BYTES, c * 64, h, q0 + cw * 64, b);
      bulk_commit_group();
      bulk_wait_group_read0();
    }
    if (tig == 0) {
      // lse = ln(sum exp(s*scale)) = (m2 + log2 l) * ln 2, m2 the base-2 row maximum
      const int r_hi = r_lo + 8;
      if (r_lo < Sq) lse[(int64_t)bh * Sq + r_lo] = (m_lo + log2f(l_lo)) * 0.69314718055994531f;
      if (r_hi < Sq) lse[(int64_t)bh * Sq + r_hi] = (m_hi + log2f(l_hi)) * 0.69314718055994531f;
    }
  }
}

// ----------------------------------------------------------------------------
// bf16 path at D = 512 (the VAE mid block's single head): the same
// recurrence, tiles cut for the width. At D = 512 one warp cannot hold 16 q
// rows of mma.sync fragments (Q fragments 128 and the accumulator 256
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

// ---- host side of flash_fwd_wgmma_kernel (tensor maps: sm90.cuh) ----

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                 int Sq, int Skv, const long long* st, float scale, cudaStream_t stream) {
  using L = HopperFwdSmem<D>;
  static SmemOptIn opt;
  int code = opt_in_smem(opt, (const void*)flash_fwd_wgmma_kernel<D>, L::BYTES);
  if (code != 0) return code;
  CUtensorMap tq, tk, tv, to;
  code = encode_bshd(&tq, q, B, Sq, H, D, st[0], st[1], st[2], HQ);
  if (code == 0) code = encode_bshd(&tk, k, B, Skv, H, D, st[3], st[4], st[5], HK);
  if (code == 0) code = encode_bshd(&tv, v, B, Skv, H, D, st[6], st[7], st[8], HK);
  const long long o_ss = (long long)H * D;
  if (code == 0) code = encode_bshd(&to, o, B, Sq, H, D, (long long)Sq * o_ss, o_ss, D, 64);
  if (code != 0) return code;
  dim3 grid((Sq + HQ - 1) / HQ, B * H);
  flash_fwd_wgmma_kernel<D><<<grid, HNT, L::BYTES, stream>>>(tq, tk, tv, to, lse, H, Sq, Skv,
                                                             scale * 1.4426950408889634f);
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
  if (dtype == 0 && D == 64)
    return launch_wgmma<64>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, s);
  if (dtype == 0 && D == 128)
    return launch_wgmma<128>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, s);
  if (dtype == 0 && D == 512) return launch_wide<512>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, s);
  if (dtype == 1 && D == 64)
    return launch<float, 64, 64, 64>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, s);
  if (dtype == 1 && D == 128)
    return launch<float, 128, 64, 64>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, s);
  if (dtype == 1 && D == 512)
    return launch<float, 512, 32, 32>(q, k, v, o, lse, B, H, Sq, Skv, st, scale, s);
  return -1;
}
