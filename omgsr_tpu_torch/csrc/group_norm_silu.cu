// Fused GroupNorm(+SiLU) over NHWC for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of omgsr_tpu/ops/fused_groupnorm.py
// (fused_group_norm_silu): _stats_kernel (per (batch, group) sum and sum of
// squares, f32) and _apply_kernel ((x-mean)*rsqrt(var+eps)*gamma+beta, then
// an optional SiLU, written in x's dtype).
//
// What differs from the TPU kernels, and why:
//   * The TPU stats kernel revisited one output block over a sequential grid
//     axis. Blocks on a GPU run in no order, so every block reduces its own
//     chunk of rows and writes one partial (sum, sumsq) per group; the apply
//     kernel adds the partials of its batch element in a fixed order before
//     it streams. No atomics anywhere and no zero-filled buffer: the result
//     is the same bits on every run.
//   * The TPU kernels mapped channels to groups with a (C, G) one-hot matrix
//     product, a layout device of its matrix unit. Here every thread owns
//     one vector of neighbouring channels for the whole kernel (thread x =
//     channel vector, thread y = row), so its group, and in the apply kernel
//     its folded per-channel scale and shift, are fixed in registers.
//
// Bound on this card: bytes (x read twice, y written once; nothing to keep
// on chip beyond the statistics). Both kernels move vectors of up to 16
// bytes. The stats kernel keeps four independent row loads in flight per
// thread and cuts the rows into enough chunks to fill the card; the apply
// kernel is a persistent one-wave grid, described where it is defined.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int NB>
struct RawVec;
template <>
struct RawVec<2> {
  using type = uint16_t;
};
template <>
struct RawVec<4> {
  using type = uint32_t;
};
template <>
struct RawVec<8> {
  using type = uint2;
};
template <>
struct RawVec<16> {
  using type = uint4;
};

// element storage: bf16 travels as its 16 bits, f32 as itself
template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  using storage = unsigned short;
  __device__ static float to_float(storage s) { return __bfloat162float(__ushort_as_bfloat16(s)); }
  __device__ static storage from_float(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
};
template <>
struct Elem<float> {
  using storage = float;
  __device__ static float to_float(storage s) { return s; }
  __device__ static storage from_float(float f) { return f; }
};

template <typename T, int VEC>
union Pack {
  typename RawVec<sizeof(T) * VEC>::type raw;
  typename Elem<T>::storage e[VEC];
};

// Block = (cvb channel vectors) x (k rows); a vector never straddles a group
// (VEC divides C/G) and a block column segment holds whole groups: W = C/G/VEC
// vectors per group, gpb groups per block, cvb = gpb * W. blockIdx = (row
// chunk, batch, column segment). partial: (B, nchunks, G, 2).
template <typename T, int VEC>
__global__ void __launch_bounds__(1024) gn_stats_kernel(const T* __restrict__ x,
                                                        float* __restrict__ partial, int R, int C,
                                                        int G, int chunk_rows, int W, int gpb,
                                                        int k) {
  __shared__ float sh_s[1024];
  __shared__ float sh_ss[1024];
  using Raw = typename RawVec<sizeof(T) * VEC>::type;
  const int tid = threadIdx.x;
  const int cvb = gpb * W;
  const int tc = tid % cvb;
  const int tr = tid / cvb;
  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  const int g0 = blockIdx.z * gpb;
  const int groups_here = min(gpb, G - g0);
  const int r0 = chunk * chunk_rows;
  const int r1 = min(R, r0 + chunk_rows);

  float s = 0.f, ss = 0.f;
  if (tr < k && tc < groups_here * W) {
    const T* col = x + (int64_t)b * R * C + ((int64_t)g0 * W + tc) * VEC;
#pragma unroll 4
    for (int r = r0 + tr; r < r1; r += k) {
      Pack<T, VEC> p;
      p.raw = *reinterpret_cast<const Raw*>(col + (int64_t)r * C);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = Elem<T>::to_float(p.e[e]);
        s += f;
        ss += f * f;
      }
    }
  }
  sh_s[tid] = s;
  sh_ss[tid] = ss;
  __syncthreads();
  if (tid < groups_here) {
    float a = 0.f, aa = 0.f;
    for (int row = 0; row < k; ++row)
      for (int w = 0; w < W; ++w) {
        a += sh_s[row * cvb + tid * W + w];
        aa += sh_ss[row * cvb + tid * W + w];
      }
    float* out = partial + (((int64_t)b * gridDim.x + chunk) * G + g0 + tid) * 2;
    out[0] = a;
    out[1] = aa;
  }
}

// The apply kernel. Before it streams, a block must add up all nchunks
// partials of its batch element; done with one lane per chunk, those reads
// lie 2G floats apart (a 32-byte sector for every 8 bytes), cost about as many
// L2 bytes over a grid of short-lived blocks as x and y themselves, and come
// one after the other before the first load of x. So:
//   * The grid is persistent, one wave (the wrapper sizes it by the SM count
//     and this kernel's occupancy), so the partials are folded once per
//     resident block: block (row block, batch, column segment) walks rows
//     blockIdx.x * k + tr, + gridDim.x * k, ... and a thread keeps one
//     vector of channels, with its scale and shift in registers, for the
//     whole kernel.
//   * Before the statistics exist, every thread already has its first
//     APPLY_UNROLL row vectors of x in flight; the fold runs under them.
//   * The fold reads the partials coalesced: thread t adds element t % 2G of
//     chunks t / 2G, + T / 2G, ... (T = the 2G-multiple of the block's
//     threads), four chunks in flight; the T / 2G sums of each element are
//     then added in order by one thread a group. Every block folds alike, in
//     a fixed order and without atomics: the same bits on every run.
//   * The stream keeps 2 * APPLY_UNROLL 16-byte loads a thread in flight: the
//     next batch of rows is loaded before the current one is computed and
//     stored. APPLY_UNROLL, the block size and the one-wave grid are what
//     tools/check_group_norm.py --sweep measured best on an H100 (PERF.md).
constexpr int APPLY_UNROLL = 4;
constexpr int APPLY_MAX_THREADS = 512;  // up to 128 registers a thread for the 2 * APPLY_UNROLL vectors

template <typename T, int VEC>
__global__ void __launch_bounds__(APPLY_MAX_THREADS) gn_apply_kernel(
    const T* __restrict__ x, const float* __restrict__ partial, const void* __restrict__ gamma,
    const void* __restrict__ beta, int affine_f32, T* __restrict__ y, int R, int C, int G,
    int nchunks, int cvb, int k, float eps, int apply_silu) {
  __shared__ float red[APPLY_MAX_THREADS];   // the fold's per-thread sums
  __shared__ float stat[APPLY_MAX_THREADS];  // mean[G], rstd[G]
  using Raw = typename RawVec<sizeof(T) * VEC>::type;
  constexpr int U = APPLY_UNROLL;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int tc = tid % cvb;
  const int tr = tid / cvb;
  const int cv = blockIdx.z * cvb + tc;
  const bool active = tr < k && cv * VEC < C;
  const int64_t step = (int64_t)gridDim.x * k;  // rows between a thread's vectors
  const int64_t rows = active ? R : 0;          // an idle thread loads and stores nothing
  const T* const xb = x + (int64_t)b * R * C + (int64_t)cv * VEC;
  T* const yb = y + (int64_t)b * R * C + (int64_t)cv * VEC;

  Raw cur[U];
  auto load = [&](Raw(&p)[U], int64_t r0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t r = r0 + u * step;
      if (r < rows) p[u] = *reinterpret_cast<const Raw*>(xb + r * C);
    }
  };
  int64_t r = (int64_t)blockIdx.x * k + tr;
  load(cur, r);

  // fold this batch element's partials (nchunks, G, 2) into mean and rstd per group
  const int gg = 2 * G;
  const int per = blockDim.x / gg;  // threads on each (group, sum) element
  float acc = 0.f;
  if (tid < per * gg) {
    const float* pb = partial + (int64_t)b * nchunks * gg + tid % gg;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    int c = tid / gg;
    for (; c + 3 * per < nchunks; c += 4 * per) {
      a0 += pb[(int64_t)c * gg];
      a1 += pb[(int64_t)(c + per) * gg];
      a2 += pb[(int64_t)(c + 2 * per) * gg];
      a3 += pb[(int64_t)(c + 3 * per) * gg];
    }
    for (; c < nchunks; c += per) a0 += pb[(int64_t)c * gg];
    acc = (a0 + a1) + (a2 + a3);
  }
  red[tid] = acc;
  __syncthreads();
  if (tid < G) {
    float s = 0.f, ss = 0.f;
    for (int j = 0; j < per; ++j) {
      s += red[j * gg + 2 * tid];
      ss += red[j * gg + 2 * tid + 1];
    }
    const float count = (float)R * (float)(C / G);
    const float mean = s / count;
    const float var = fmaxf(ss / count - mean * mean, 0.f);
    stat[tid] = mean;
    stat[G + tid] = rsqrtf(var + eps);
  }
  __syncthreads();
  if (!active) return;

  // y = x * scale + shift with the statistics folded into the affine
  const int cg = C / G;
  float scale[VEC], shift[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int c = cv * VEC + e;
    float ga, be;
    if (affine_f32) {
      ga = reinterpret_cast<const float*>(gamma)[c];
      be = reinterpret_cast<const float*>(beta)[c];
    } else {
      ga = Elem<T>::to_float(reinterpret_cast<const typename Elem<T>::storage*>(gamma)[c]);
      be = Elem<T>::to_float(reinterpret_cast<const typename Elem<T>::storage*>(beta)[c]);
    }
    const int g = c / cg;
    scale[e] = stat[G + g] * ga;
    shift[e] = be - stat[g] * scale[e];
  }

  while (r < R) {
    Raw next[U];
    load(next, r + U * step);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t ru = r + u * step;
      if (ru < R) {
        Pack<T, VEC> p, q;
        p.raw = cur[u];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float f = Elem<T>::to_float(p.e[e]) * scale[e] + shift[e];
          if (apply_silu) f = __fdividef(f, 1.f + __expf(-f));
          q.e[e] = Elem<T>::from_float(f);
        }
        *reinterpret_cast<Raw*>(yb + ru * C) = q.raw;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = next[u];
    r += U * step;
  }
}

// Threads of an apply block: cvb vectors by k rows, rounded up to whole warps,
// and at least one thread for each of the 2G (group, sum) elements of the
// fold; at most APPLY_MAX_THREADS.
int apply_threads(int cvb, int k, int G) {
  const int t = (cvb * k + 31) / 32 * 32;
  const int f = (2 * G + 31) / 32 * 32;
  return t > f ? t : f;
}

template <typename T, int VEC>
int launch_stats(const void* x, float* partial, int B, int R, int C, int G, int chunk_rows,
                 int nchunks, int gpb, int k, cudaStream_t stream) {
  const int W = C / G / VEC;
  const int threads = gpb * W * k;
  if (W < 1 || threads < 1 || threads > 1024) return -2;
  dim3 grid(nchunks, B, (G + gpb - 1) / gpb);
  gn_stats_kernel<T, VEC><<<grid, threads, 0, stream>>>((const T*)x, partial, R, C, G, chunk_rows,
                                                        W, gpb, k);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_apply(const void* x, const float* partial, const void* gamma, const void* beta,
                 int affine_f32, void* y, int B, int R, int C, int G, int nchunks, int cvb, int k,
                 int row_blocks, float eps, int apply_silu, cudaStream_t stream) {
  const int threads = apply_threads(cvb, k, G);
  if (C % VEC || cvb < 1 || k < 1 || threads > APPLY_MAX_THREADS || nchunks < 1 || row_blocks < 1) return -2;
  const int cv = C / VEC;
  dim3 grid(row_blocks, B, (cv + cvb - 1) / cvb);
  gn_apply_kernel<T, VEC><<<grid, threads, 0, stream>>>((const T*)x, partial, gamma, beta, affine_f32,
                                                         (T*)y, R, C, G, nchunks, cvb, k, eps, apply_silu);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int apply_blocks_per_sm(int cvb, int k, int G) {
  const int threads = apply_threads(cvb, k, G);
  if (cvb < 1 || k < 1 || threads > APPLY_MAX_THREADS) return -2;
  int blocks = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gn_apply_kernel<T, VEC>, threads, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace

#define DISPATCH_VEC(FN, ...)                                            \
  if (dtype == 0) {                                                      \
    if (vec == 8) return FN<__nv_bfloat16, 8>(__VA_ARGS__);              \
    if (vec == 4) return FN<__nv_bfloat16, 4>(__VA_ARGS__);              \
    if (vec == 2) return FN<__nv_bfloat16, 2>(__VA_ARGS__);              \
    if (vec == 1) return FN<__nv_bfloat16, 1>(__VA_ARGS__);              \
  } else if (dtype == 1) {                                               \
    if (vec == 4) return FN<float, 4>(__VA_ARGS__);                      \
    if (vec == 2) return FN<float, 2>(__VA_ARGS__);                      \
    if (vec == 1) return FN<float, 1>(__VA_ARGS__);                      \
  }                                                                      \
  return -1;

// x: contiguous (B, R, C) with R = H*W rows, aligned to vec elements;
// partial: (B, nchunks, G, 2) f32 with nchunks = ceil(R / chunk_rows).
// dtype: 0 = bf16, 1 = f32. vec must divide C/G. A block covers gpb whole
// groups by k rows: gpb * (C/G/vec) * k threads, at most 1024. Returns 0, a
// CUDA error code, -1 for an unsupported dtype / vec, -2 for a bad geometry.
extern "C" int group_norm_stats(const void* x, float* partial, int dtype, int vec, int B, int R,
                                int C, int G, int chunk_rows, int nchunks, int gpb, int k,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH_VEC(launch_stats, x, partial, B, R, C, G, chunk_rows, nchunks, gpb, k, s)
}

// y = [silu]((x - mean) * rstd * gamma + beta) with the statistics taken from
// `partial` (B, nchunks, G, 2) as group_norm_stats wrote it. vec must divide
// C (it need not divide C/G). A block covers cvb channel vectors by k rows
// (apply_threads: rounded up to whole warps, at least 2G threads, at most
// 512); grid (row_blocks, B, ceil(C / vec / cvb)), each block walking rows
// blockIdx.x * k + tr, + row_blocks * k, ... after folding all nchunks
// partials of its batch element. gamma and beta are (C,) in x's dtype, or
// f32 when affine_f32 is non-zero.
extern "C" int group_norm_apply(const void* x, const float* partial, const void* gamma,
                                const void* beta, int affine_f32, void* y, int dtype, int vec,
                                int B, int R, int C, int G, int nchunks, int cvb, int k,
                                int row_blocks, float eps, int apply_silu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  DISPATCH_VEC(launch_apply, x, partial, gamma, beta, affine_f32, y, B, R, C, G, nchunks, cvb, k,
               row_blocks, eps, apply_silu, s)
}

// The apply blocks of that geometry that fit on one SM of the current device
// at once (what a one-wave grid is sized by); a negative value on an error.
extern "C" int group_norm_apply_blocks_per_sm(int dtype, int vec, int cvb, int k, int G) {
  DISPATCH_VEC(apply_blocks_per_sm, cvb, k, G)
}
