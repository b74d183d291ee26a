// 3x3 SAME convolution (stride 1, batch 1, NHWC) for Hopper (sm_90a), plain C
// interface: the plain conv with a bias + optional SiLU epilogue, the
// resblock half y = conv3x3(silu(x * a + c)) + b [+ skip] that also emits
// per-channel sums of its output for the next GroupNorm, and the fold of
// those sums into the next GroupNorm's per-channel (scale, shift).
//
// Replaces the Pallas TPU kernels omgsr_tpu/ops/conv3x3.py:_kernel (called
// from conv3x3_pallas) and :_kernel_rb (called from conv3x3_gn_fused).
//
// What differs from the TPU kernels, and why:
//   * The TPU kernel copied a stripe of bh + 2 pre-padded rows (all columns,
//     all input channels) into VMEM and issued nine (bh*W, C_in) x (C_in,
//     C_out) products. A block here has at most 227 KB of shared memory, not
//     megabytes, and the card wants every SM busy: one block owns a tile of
//     output pixels by a slice of the output channels and walks over C_in in
//     chunks, staging the tile's halo of x and the taps of the weights.
//   * No padded copy of x is made in device memory: halo pixels outside the
//     image are zeros in shared memory. The GroupNorm+SiLU prologue
//     silu(x * a + c) is applied (f32, rounded once to the input type) once
//     per staged element, on valid pixels only, so the ring stays exactly
//     zero: the graph pads after the activation.
//   * The TPU grid ran the stripes one after the other; blocks here run in
//     no order. Each block writes the sum and the sum of squares of its own
//     f32 outputs (bias and skip added, before the rounding of y) to its own
//     row of a (2, n_partials, C_out) buffer, reduced inside the block in a
//     fixed order. There are no atomics: the same input gives the same bits
//     on every run. The caller folds the rows into the next GroupNorm's
//     affine (gn_fold_kernel, one launch, also in a fixed order).
//   * Weights are read as the port stores them: OIHW in channels_last memory,
//     which lies as (C_out, 3, 3, C_in), so for every tap the C_in values of
//     one output channel are contiguous: K-major for the tensor cores.
//
// Bound on this card: operations (2 * 9 * C_in * C_out * H * W flops against
// (C_in + C_out [+ C_out]) * H * W elements moved). The kernels:
//   * conv3x3_wgmma_kernel<MT, FUSED> (bf16, both functions): an implicit
//     GEMM (M = output pixels, N = output channels, K = 9 * C_in) on wgmma,
//     fed by TMA through a ring of shared-memory stages, described where it
//     is defined. FUSED = true is the resblock half (GroupNorm+SiLU prologue,
//     bias, optional skip, optional sums), false the plain conv (bias,
//     optional SiLU): the same body without the prologue, skip and sums.
//   * conv3x3_fma_kernel (f32, both functions): plain f32 FMAs from shared
//     memory. Exact for f32 inputs, far from the tensor-core rate. Templated
//     on FUSED: false is the plain conv (bias, optional SiLU), true the
//     resblock half (prologue, bias, optional skip, optional sums).
//   * gn_fold_kernel: the streamed sums -> (scale, shift), one block a group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using namespace omgsr_mma;
using namespace omgsr_sm90;

constexpr int TH = 8;                    // output rows of an f32 block
constexpr int TW = 16;                   // output columns of an f32 block
constexpr int HALO_W = TW + 2;
constexpr int HALO_PIX = (TH + 2) * HALO_W;  // 180
constexpr int NT = 256;

__device__ __forceinline__ float silu(float h) { return h / (1.f + __expf(-h)); }

// silu(h) from hh = h / 2, as hh * (1 + tanh(hh)) = h * sigmoid(h): one FMA
// and one SFU operation (tanh.approx, relative error below 2^-10.9), where
// h / (1 + exp(-h)) takes five instructions and two SFU operations. The bf16
// resblock half applies it to every staged element before rounding it to
// bf16; the error it adds (at most |hh| * 2^-10.9 of its f32 value) stays
// below the bf16 step except where silu(h) is small (h below -2), and
// check_conv3x3 holds the kernel's y and sums to the same bounds as before.
__device__ __forceinline__ float silu_half(float hh) {
  float t;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(t) : "f"(hh));
  return fmaf(hh, t, hh);
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

// ----------------------------------------------------------------------------
// bf16 convs on Hopper: conv3x3_wgmma_kernel<MT, FUSED>, the resblock half
// (FUSED = true) and the plain conv (FUSED = false) from one body.
//
// The conv is a GEMM with M = output pixels, N = output channels and K = 9 *
// C_in, run as nine shifted products per chunk of GKC = 64 input channels.
// What bounds it: operations, and with small tiles the L2 traffic of the
// weights, which every pixel tile reads in full. So:
//   * A tile is TH = 2 * MT output rows x GW = 64 columns (MT = 2: 256 pixels,
//     which reuse each staged weight tile; MT = 1 where 256-pixel tiles leave
//     SMs idle, e.g. the 64 x 64 mid blocks) by GBN = 128 output channels.
//     The grid is persistent: one block an SM walks its tiles (blockIdx.x, +
//     gridDim.x, ...), so the loads and the prologue of a block's next tile
//     run under the products and the epilogue of the current one.
//   * Three warpgroups: warpgroup 0's first warp issues the weights' TMA
//     loads (one thread), its other three warps apply the prologue (their
//     first thread also issues x's loads); warpgroups 1 and 2 run the
//     products, MT rows of 64 pixels each (an m64 tile is one output row, so
//     a tap shift is a shift along the tile's rows); setmaxnreg moves
//     registers from warpgroup 0 (104) to them (200).
//   * x reaches shared memory by TMA as the tile's halo, (TH + 2) rows x 66
//     columns x 64 channels, one 128-byte swizzled row per pixel, two slots;
//     pixels outside the image arrive as zeros (negative coordinates too).
//     The weights of one (chunk, tap), 128 output channels x 64 input
//     channels, are one 16 KiB TMA box; they stream through a ring of
//     W_STAGES slots (4 at MT = 2, 7 at MT = 1: what shared memory leaves).
//     Each slot has a `full` mbarrier (TMA bytes) and an `empty` one (one
//     arrival per consumer warp once its products on the slot have retired);
//     the producer runs W_STAGES weight tiles ahead, across tiles. x's loads
//     are issued apart from the weights', by the prologue: chunk k + 1 as
//     soon as chunk k is handed on and chunk k - 1's slot is free (issued
//     behind the weights they came late, and the products waited for the
//     prologue).
//   * The plain conv (FUSED = false) has no prologue: the consumers take each
//     chunk of x as TMA wrote it (the full barrier), whose zero fill outside
//     the image is the SAME padding; of the three prologue warps only the
//     first thread works, issuing x's loads two chunks ahead as the slots
//     come free. Its epilogue adds the bias and applies SiLU when asked
//     (f32, y rounded once), without skip or sums, and the shared memory of
//     the sums goes to the weight ring (5 slots at MT = 2, 8 at MT = 1).
//   * The prologue warps wait for a chunk's x, apply silu(x * a + c) in f32 to
//     every staged element of a pixel inside the image (once per element, not
//     once per tap; three instructions an element, silu_half), round it to
//     bf16 in place, and release the chunk to the
//     consumers through a third mbarrier (after fence.proxy.async, so the
//     tensor cores see their writes). The ring keeps TMA's zeros: the graph
//     pads after the activation. The next chunk's prologue runs under the
//     current chunk's products (tools/check_conv3x3.py --prologue-cost times
//     the kernel without the prologue's arithmetic; PERF.md holds it).
//   * Products: per (chunk, tap) and 16-channel k-step, one wgmma m64n128k16
//     per output row, A = the halo rows starting at pixel (row + dy) * 66 +
//     dx (a descriptor that starts any whole number of 128-byte rows into
//     the swizzled tile, base-offset field 0: see sm90.cuh), B = the weight
//     tile, K-major, f32 accumulators in registers (MT * 64 a thread). One
//     commit group per tap; the previous tap's slot is released once its
//     group has retired, so loads, the prologue and the products overlap.
//   * Epilogue, one 64-channel box at a time through each warpgroup's own
//     staging (MT rows x 64 pixels x 128 bytes): the skip box, if any,
//     arrives by TMA in the same swizzled layout; each thread adds bias and
//     skip to its accumulators in f32, takes the sums of the pixels inside
//     the image, and writes y rounded to bf16 over the skip's place (the
//     same addresses, so no barrier between the two); a TMA store writes the
//     box (dropping pixels outside the image) while the next one is made.
//     The channel sums go through warp shuffles and shared memory (two
//     buffers, by tile) in a fixed order to one row of the sums buffer per
//     pixel tile.
// Shared memory (MT = 2): 2 x 51,200 (x) + 4 x 16,384 (weights) + 2 x 16,384
// (staging) + 2 x 8,192 (sums) = 217,088 bytes + barriers.
// ----------------------------------------------------------------------------

constexpr int GW = 64;           // output columns of a tile: an m64 tile is one row
constexpr int GW_RED_WARPS = 8;  // consumer warps: rows of the sums' reduction
constexpr int GHW = GW + 2;      // halo columns
constexpr int GBN = 128;         // output channels of a tile
constexpr int GKC = 64;          // input channels of a chunk: one 128-byte row per pixel
constexpr int GNT = 384;         // three warpgroups
constexpr int PRO_THREADS = 96;  // warps 1-3: the prologue
constexpr int GBOX = GW * 128;   // a 64-pixel x 64-channel box of y or skip, one row

template <int MT, bool FUSED>
struct ConvSmem {
  static constexpr int TH = 2 * MT;
  static constexpr int HALO_PIX = (TH + 2) * GHW;
  static constexpr int X_BYTES = HALO_PIX * 128;
  static constexpr int X_SLOT = (X_BYTES + 1023) / 1024 * 1024;
  static constexpr int W_SLOT = GBN * 128;
  static constexpr int STAGE = MT * GBOX;  // a warpgroup's y / skip staging: MT rows x one 64-channel box
  // the sums' reduction [8 warps][GBN][2] f32; the plain conv has none
  static constexpr int RED = FUSED ? GW_RED_WARPS * GBN * 2 * 4 : 0;
  static constexpr int W_STAGES = (232448 - 1024 - 2 * X_SLOT - 2 * STAGE - 2 * RED - 256) / W_SLOT;
  __host__ __device__ static constexpr int X(int s) { return s * X_SLOT; }
  __host__ __device__ static constexpr int W(int s) { return 2 * X_SLOT + s * W_SLOT; }
  __host__ __device__ static constexpr int ST(int cw) { return 2 * X_SLOT + W_STAGES * W_SLOT + cw * STAGE; }
  __host__ __device__ static constexpr int R(int i) { return ST(2) + i * RED; }
  static constexpr int BARS = R(2);
  static constexpr int N_BARS = 8 + 2 * W_STAGES;  // x full/ready/empty, skip, weights full/empty
  static constexpr int BYTES = BARS + 8 * N_BARS + 1024;  // + alignment slack
  static_assert(W_STAGES >= 4, "a weight ring of four stages or more");
  static_assert(BYTES <= 232448, "shared memory of one block");
};

template <int MT, bool FUSED>
__global__ void __launch_bounds__(GNT, 1) conv3x3_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
    const __grid_constant__ CUtensorMap tm_skip, const __grid_constant__ CUtensorMap tm_y,
    const __nv_bfloat16* __restrict__ bias, const float* __restrict__ gn_a,
    const float* __restrict__ gn_c, float* __restrict__ sums, int H, int W, int Cin, int Cout,
    int has_skip, int act) {
  using L = ConvSmem<MT, FUSED>;
  constexpr int WS = L::W_STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t bars = base + L::BARS;
  auto x_full = [&](int s) { return bars + 8u * s; };
  auto x_ready = [&](int s) { return bars + 8u * (2 + s); };
  auto x_empty = [&](int s) { return bars + 8u * (4 + s); };
  auto skip_full = [&](int cw) { return bars + 8u * (6 + cw); };
  auto w_full = [&](int s) { return bars + 8u * (8 + s); };
  auto w_empty = [&](int s) { return bars + 8u * (8 + WS + s); };

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int tiles_w = (W + GW - 1) / GW;
  const int n_pix = tiles_w * ((H + L::TH - 1) / L::TH);  // pixel tiles: rows of the sums buffer
  const int n_tiles = n_pix * (Cout / GBN);
  const int n_chunks = Cin / GKC;
  // this block's tiles: blockIdx.x, + gridDim.x, ...; tile -> (pixel tile, channel tile)
  auto tile_origin = [&](int tile, int& w0, int& h0, int& n0) {
    const int pix = tile % n_pix;
    w0 = (pix % tiles_w) * GW;
    h0 = (pix / tiles_w) * L::TH;
    n0 = (tile / n_pix) * GBN;
  };

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(x_full(s), 1);
      mbar_init(x_ready(s), PRO_THREADS);
      mbar_init(x_empty(s), 8);  // one arrival per consumer warp
      mbar_init(skip_full(s), 1);
    }
    for (int s = 0; s < WS; ++s) {
      mbar_init(w_full(s), 1);
      mbar_init(w_empty(s), 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<104>();
    if (tid == 0) {
      // ---- producer: the weights WS taps ahead, tile after tile ----
      prefetch_tensormap(&tm_w);
      int gs = 0;  // steps of this block so far
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int w0, h0, n0;
        tile_origin(tile, w0, h0, n0);
        for (int c = 0; c < n_chunks; ++c) {
          for (int tap = 0; tap < 9; ++tap, ++gs) {
            const int s = gs % WS;
            if (gs >= WS) mbar_wait(w_empty(s), ((gs / WS) - 1) & 1);
            mbar_arrive_expect_tx(w_full(s), L::W_SLOT);
            tma_load_3d(base + L::W(s), &tm_w, w_full(s), c * GKC, tap, n0);
          }
        }
      }
    } else if (tid >= 32) {
      // ---- prologue (resblock half): thread pt applies silu(x * a + c) to the 16-byte
      // chunk lc (channels 8 lc .. 8 lc + 7 of the chunk) of staged pixels p = pt / 8 +
      // 12 i. Its first thread also loads x: chunk k + 1 as soon as chunk k is handed
      // on and the consumers are done with chunk k - 1, so a chunk's load and
      // prologue run under the products of the one before ----
      const int pt = tid - 32;
      const int lc = pt & 7;
      const int total = ((n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x) * n_chunks;
      auto load_x = [&](int k) {  // chunk k of this block's sequence
        const int xs = k & 1;
        if (k >= 2) mbar_wait(x_empty(xs), ((k >> 1) - 1) & 1);
        int w0, h0, n0;
        tile_origin((int)blockIdx.x + (k / n_chunks) * (int)gridDim.x, w0, h0, n0);
        mbar_arrive_expect_tx(x_full(xs), L::X_BYTES);
        tma_load_3d(base + L::X(xs), &tm_x, x_full(xs), (k % n_chunks) * GKC, w0 - 1, h0 - 1);
      };
      if constexpr (!FUSED) {
        // the plain conv: no arithmetic, and one thread keeps x's loads two chunks ahead
        if (pt == 0) {
          prefetch_tensormap(&tm_x);
          for (int k = 0; k < total; ++k) load_x(k);
        }
      } else {
        if (pt == 0) {
          prefetch_tensormap(&tm_x);
          if (total > 0) load_x(0);
        }
        int gc = 0;
        for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
          int w0, h0, n0;
          tile_origin(tile, w0, h0, n0);
          for (int c = 0; c < n_chunks; ++c, ++gc) {
            const int xs = gc & 1;
            float a8[8], c8[8];
            {
              const float4* pa = reinterpret_cast<const float4*>(gn_a + c * GKC + lc * 8);
              const float4* pc = reinterpret_cast<const float4*>(gn_c + c * GKC + lc * 8);
              const float4 a0 = __ldg(pa), a1 = __ldg(pa + 1), c0 = __ldg(pc), c1 = __ldg(pc + 1);
              // halved: the prologue computes silu from h / 2 = x * a / 2 + c / 2
              a8[0] = 0.5f * a0.x; a8[1] = 0.5f * a0.y; a8[2] = 0.5f * a0.z; a8[3] = 0.5f * a0.w;
              a8[4] = 0.5f * a1.x; a8[5] = 0.5f * a1.y; a8[6] = 0.5f * a1.z; a8[7] = 0.5f * a1.w;
              c8[0] = 0.5f * c0.x; c8[1] = 0.5f * c0.y; c8[2] = 0.5f * c0.z; c8[3] = 0.5f * c0.w;
              c8[4] = 0.5f * c1.x; c8[5] = 0.5f * c1.y; c8[6] = 0.5f * c1.z; c8[7] = 0.5f * c1.w;
            }
            mbar_wait(x_full(xs), (gc >> 1) & 1);
            const uint32_t xt = base + L::X(xs);
#pragma unroll 2
            for (int p = pt >> 3; p < L::HALO_PIX; p += PRO_THREADS / 8) {
              const int hr = p / GHW;
              const int gh = h0 - 1 + hr;
              const int gw = w0 - 1 + (p - hr * GHW);
              if (gh < 0 || gh >= H || gw < 0 || gw >= W) continue;  // the ring keeps TMA's zeros
              const uint32_t addr = xt + p * 128 + ((lc ^ (p & 7)) << 4);
              uint4 v = ld_shared_v4(addr);
              uint32_t* r = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float2 f = unpack_bf16(r[i]);
                r[i] = pack_bf16(silu_half(fmaf(f.x, a8[2 * i], c8[2 * i])),
                                 silu_half(fmaf(f.y, a8[2 * i + 1], c8[2 * i + 1])));
              }
              st_shared_v4(addr, v);
            }
            fence_proxy_async();  // the tensor cores read what these threads wrote
            mbar_arrive(x_ready(xs));
            if (pt == 0 && gc + 1 < total) load_x(gc + 1);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns output rows cw * MT .. cw * MT + MT - 1 of each tile ----
    setmaxnreg_inc<200>();
    const int cw = wg - 1;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    const uint32_t stage = base + L::ST(cw);  // [MT rows][64 px][128 B], one 64-channel box
    const bool emit = FUSED && sums != nullptr;
    int gc = 0, gs = 0, local = 0;  // chunks, steps and tiles of this block so far

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++local) {
      int w0, h0, n0;
      tile_origin(tile, w0, h0, n0);
      float acc[MT][64];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[mt][i] = 0.f;

      for (int t = 0; t < 9 * n_chunks; ++t, ++gs) {
        const int c = t / 9;
        const int tap = t - 9 * c;
        const int xs = (gc + c) & 1;
        const int s = gs % WS;
        // the resblock half waits for the prologue's writes, the plain conv for TMA's
        if (tap == 0) mbar_wait(FUSED ? x_ready(xs) : x_full(xs), ((gc + c) >> 1) & 1);
        mbar_wait(w_full(s), (gs / WS) & 1);
        const int dy = tap / 3;
        const int dx = tap - 3 * dy;
        const uint32_t xa = base + L::X(xs) + ((cw * MT + dy) * GHW + dx) * 128;
        const uint32_t wb = base + L::W(s);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_operands(acc[mt]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < GKC / 16; ++ks) {
          const uint64_t db = wgmma_desc(wb + ks * 32, 16, 1024);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            wgmma_ss_m64n128k16(acc[mt], wgmma_desc(xa + mt * GHW * 128 + ks * 32, 16, 1024), db, 1);
        }
        wgmma_commit_group();
        wgmma_wait_group<1>();  // the previous tap's products have retired
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_operands(acc[mt]);
        if (t > 0) {
          __syncwarp();
          if (lane == 0) {
            mbar_arrive(w_empty((gs - 1) % WS));
            if (tap == 0) mbar_arrive(x_empty((gc + c - 1) & 1));  // step t - 1 was its chunk's last tap
          }
        }
      }
      wgmma_wait_group<0>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_operands(acc[mt]);
      __syncwarp();
      if (lane == 0) {  // the tile's last step and chunk: the producer goes on with the next tile
        mbar_arrive(w_empty((gs - 1) % WS));
        mbar_arrive(x_empty((gc + n_chunks - 1) & 1));
      }
      gc += n_chunks;

      // ---- epilogue, one 64-channel box at a time through the warpgroup's staging ----
      const int row0 = h0 + cw * MT;
      float* const red = reinterpret_cast<float*>(gbase + L::R(local & 1));
#pragma unroll
      for (int cb = 0; cb < 2; ++cb) {
        if ((tid & 127) == 0) bulk_wait_group_read0();  // the staging's last store has read it
        named_barrier_sync(2 + cw, 128);
        if (FUSED && has_skip) {
          if ((tid & 127) == 0) {
            mbar_arrive_expect_tx(skip_full(cw), L::STAGE);
            tma_load_3d(stage, &tm_skip, skip_full(cw), n0 + 64 * cb, w0, row0);
          }
          mbar_wait(skip_full(cw), (2 * local + cb) & 1);
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = 8 * cb + jj;
          const int ch = 8 * j + 2 * tig;  // this thread's channels ch, ch + 1 of the tile's 128
          const float2 b2 = unpack_bf16(__ldg(reinterpret_cast<const unsigned int*>(bias + n0 + ch)));
          float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int px = warp * 16 + g + half * 8;
              const uint32_t addr = stage + (mt * GW + px) * 128 + ((jj ^ (px & 7)) << 4) + tig * 4;
              float v0 = acc[mt][4 * j + 2 * half] + b2.x;
              float v1 = acc[mt][4 * j + 2 * half + 1] + b2.y;
              if (FUSED && has_skip) {
                const float2 sk = unpack_bf16(ld_shared_u32(addr));
                v0 += sk.x;
                v1 += sk.y;
              }
              if (!FUSED && act) {
                v0 = silu(v0);
                v1 = silu(v1);
              }
              if (FUSED && row0 + mt < H && w0 + px < W) {
                s0 += v0;
                s1 += v1;
                q0 += v0 * v0;
                q1 += v1 * v1;
              }
              st_shared_u32(addr, pack_bf16(v0, v1));
            }
          }
          if (emit) {
            // over the warp's 16 pixels of each row: the 8 lanes that share tig
#pragma unroll
            for (int m = 4; m < 32; m <<= 1) {
              s0 += __shfl_xor_sync(0xffffffffu, s0, m);
              s1 += __shfl_xor_sync(0xffffffffu, s1, m);
              q0 += __shfl_xor_sync(0xffffffffu, q0, m);
              q1 += __shfl_xor_sync(0xffffffffu, q1, m);
            }
            if (g == 0)
              *reinterpret_cast<float4*>(red + ((cw * 4 + warp) * GBN + ch) * 2) = make_float4(s0, q0, s1, q1);
          }
        }
        fence_proxy_async();  // the TMA store reads what these threads wrote
        named_barrier_sync(2 + cw, 128);
        if ((tid & 127) == 0) {
          tma_store_3d(&tm_y, stage, n0 + 64 * cb, w0, row0);
          bulk_commit_group();
        }
      }
      if (emit) {
        // both warpgroups' partials of this tile are in red; the next tile writes the other buffer
        named_barrier_sync(1, 256);
        const int ct = tid - 128;
        if (ct < GBN) {
          float ss = 0.f, qq = 0.f;
#pragma unroll
          for (int r = 0; r < GW_RED_WARPS; ++r) {
            ss += red[(r * GBN + ct) * 2];
            qq += red[(r * GBN + ct) * 2 + 1];
          }
          const long long part = tile % n_pix;
          sums[part * Cout + n0 + ct] = ss;
          sums[((long long)n_pix + part) * Cout + n0 + ct] = qq;
        }
      }
    }
    if ((tid & 127) == 0) bulk_wait_group_read0();
  }
}

// ----------------------------------------------------------------------------
// gn_fold_kernel: per-tile channel sums (2, n_partials, C) -> the next
// GroupNorm's per-channel (scale, shift), one block of FOLD_NT threads a
// group. The group's sums are added in a fixed order (a strided loop, then a
// tree in shared memory); mean = sum / count, var = max(sumsq / count -
// mean^2, 0), scale = gamma * rsqrt(var + eps), shift = beta - mean * scale,
// all in f32 as the plain version (ops/conv3x3._affine_from_stacked_sums).
// Bound: bytes (2 * n_partials * C floats read once), a few microseconds at
// most; what it saves is the dozen tensor launches it replaces.
// ----------------------------------------------------------------------------

constexpr int FOLD_NT = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(FOLD_NT) gn_fold_kernel(
    const float* __restrict__ sums, const T* __restrict__ gamma, const T* __restrict__ beta,
    float* __restrict__ scale, float* __restrict__ shift, int n_partials, int C, int per,
    float count, float eps) {
  __shared__ float red_s[FOLD_NT], red_q[FOLD_NT];
  const int grp = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = n_partials * per;
  float s = 0.f, q = 0.f;
  for (int i = tid; i < n; i += FOLD_NT) {
    const int p = i / per;
    const long long off = (long long)p * C + grp * per + (i - p * per);
    s += sums[off];
    q += sums[(long long)n_partials * C + off];
  }
  red_s[tid] = s;
  red_q[tid] = q;
  __syncthreads();
#pragma unroll
  for (int m = FOLD_NT / 2; m > 0; m >>= 1) {
    if (tid < m) {
      red_s[tid] += red_s[tid + m];
      red_q[tid] += red_q[tid + m];
    }
    __syncthreads();
  }
  const float mean = red_s[0] / count;
  const float var = fmaxf(red_q[0] / count - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
  for (int ci = tid; ci < per; ci += FOLD_NT) {
    const int ch = grp * per + ci;
    const float sc = to_f32(gamma[ch]) * rstd;
    scale[ch] = sc;
    shift[ch] = to_f32(beta[ch]) - mean * sc;
  }
}

// ---- host side ----

template <int MT, bool FUSED>
int launch_wgmma(const void* x, const void* w, const void* bias, const float* gn_a, const float* gn_c,
                 const void* skip, void* y, float* sums, int act, int H, int W, int Cin, int Cout,
                 cudaStream_t stream) {
  using L = ConvSmem<MT, FUSED>;
  static SmemOptIn opt;
  int code = opt_in_smem(opt, (const void*)conv3x3_wgmma_kernel<MT, FUSED>, L::BYTES);
  if (code != 0) return code;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tx, tw, ts, ty;
  code = encode_3d(&tx, x, Cin, W, H, Cin, (long long)W * Cin, GKC, GHW, L::TH + 2);
  if (code == 0) code = encode_3d(&tw, w, Cin, 9, Cout, Cin, 9LL * Cin, GKC, 1, GBN);
  if (code == 0) code = encode_3d(&ty, y, Cout, W, H, Cout, (long long)W * Cout, 64, GW, MT);
  if (code == 0)
    code = encode_3d(&ts, skip != nullptr ? skip : y, Cout, W, H, Cout, (long long)W * Cout, 64, GW, MT);
  if (code != 0) return code;
  const long long tiles = (long long)((W + GW - 1) / GW) * ((H + L::TH - 1) / L::TH) * (Cout / GBN);
  if (tiles > 2147483647LL) return -1;
  // persistent: one block an SM, each walking its tiles blockIdx.x, + gridDim.x, ...
  const int grid = (int)(tiles < sms ? tiles : sms);
  conv3x3_wgmma_kernel<MT, FUSED><<<grid, GNT, L::BYTES, stream>>>(
      tx, tw, ts, ty, (const __nv_bfloat16*)bias, gn_a, gn_c, sums, H, W, Cin, Cout, skip != nullptr, act);
  return (int)cudaGetLastError();
}

// The bf16 kernels at a tile height of `tile_rows` (4 or 2) output rows.
template <bool FUSED>
int launch_wgmma_rows(int tile_rows, const void* x, const void* w, const void* bias, const float* gn_a,
                      const float* gn_c, const void* skip, void* y, float* sums, int act, int H, int W,
                      int Cin, int Cout, cudaStream_t stream) {
  if (tile_rows == 4)
    return launch_wgmma<2, FUSED>(x, w, bias, gn_a, gn_c, skip, y, sums, act, H, W, Cin, Cout, stream);
  if (tile_rows == 2)
    return launch_wgmma<1, FUSED>(x, w, bias, gn_a, gn_c, skip, y, sums, act, H, W, Cin, Cout, stream);
  return -1;
}

// The FMA kernels (f32): 8 x 16 pixel tiles.
template <bool FUSED>
int launch_fma(const float* x, const float* w, const float* bias, const float* gn_a, const float* gn_c,
               const float* skip, float* y, float* sums, int act, int H, int W, int Cin, int Cout,
               cudaStream_t stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  if (tiles_w > 65535 || tiles_h > 65535) return -1;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_fma_kernel<FUSED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, FMA_SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Cout / FBN, tiles_w, tiles_h);
  conv3x3_fma_kernel<FUSED><<<grid, NT, FMA_SMEM, stream>>>(x, w, bias, gn_a, gn_c, skip, y, sums, H, W,
                                                            Cin, Cout, act);
  return (int)cudaGetLastError();
}

bool shape_ok(int H, int W, int Cin, int Cout) {
  return H >= 1 && W >= 1 && Cin >= 128 && Cout >= 128 && Cin % 128 == 0 && Cout % 128 == 0;
}

}  // namespace

// Common to the conv entries. x (H, W, Cin) and y (H, W, Cout) contiguous NHWC
// at batch 1; w (Cout, 3, 3, Cin) contiguous (OIHW in channels_last memory);
// bias (Cout,); x, w, bias, skip and y share one type: dtype 0 = bf16
// (conv3x3_wgmma_kernel), 1 = f32 (conv3x3_fma_kernel). Cin and Cout are
// multiples of 128 and every pointer is 16-byte aligned. tile_rows: the bf16
// kernel's tile height, 4 or 2 (the wrapper's choice by the card's SM count,
// ops/conv3x3.gn_fused_tile_rows); the f32 kernel's tiles are 8 x 16
// (tile_rows unused). Returns 0, a CUDA error code, -1 for an unsupported
// dtype, shape or tile height, -2 for a sums buffer of the wrong size.

// The number of rows of the sums buffer of conv3x3_gn_fused for an (H, W)
// image: one per pixel tile (the bf16 kernel's tiles are `tile_rows` rows x
// 64 columns); -1 for a dtype or tile height the kernels do not take.
extern "C" int conv3x3_partials(int dtype, int H, int W, int tile_rows) {
  if (dtype == 0 && (tile_rows == 2 || tile_rows == 4)) return ((W + GW - 1) / GW) * ((H + tile_rows - 1) / tile_rows);
  if (dtype == 1) return ((W + TW - 1) / TW) * ((H + TH - 1) / TH);
  return -1;
}

// y = conv3x3(x) + bias, then SiLU when act == 1.
extern "C" int conv3x3(const void* x, const void* w, const void* bias, void* y, int dtype, int act,
                       int H, int W, int Cin, int Cout, int tile_rows, void* stream) {
  if (!shape_ok(H, W, Cin, Cout)) return -1;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_wgmma_rows<false>(tile_rows, x, w, bias, nullptr, nullptr, nullptr, y, nullptr, act, H, W,
                                    Cin, Cout, s);
  if (dtype == 1)
    return launch_fma<false>((const float*)x, (const float*)w, (const float*)bias, nullptr, nullptr, nullptr,
                             (float*)y, nullptr, act, H, W, Cin, Cout, s);
  return -1;
}

// y = conv3x3(silu(x * gn_a + gn_c)) + bias [+ skip]; gn_a, gn_c (Cin,) f32;
// skip (H, W, Cout) or null; sums null or (2, n_partials, Cout) f32 with
// n_partials = conv3x3_partials(dtype, H, W, tile_rows): row p of sums[0] /
// sums[1] receives the per-channel sum / sum of squares of tile p's f32
// outputs.
extern "C" int conv3x3_gn_fused(const void* x, const void* w, const void* bias, const float* gn_a,
                                const float* gn_c, const void* skip, void* y, float* sums,
                                int dtype, int H, int W, int Cin, int Cout, int n_partials,
                                int tile_rows, void* stream) {
  if (!shape_ok(H, W, Cin, Cout) || gn_a == nullptr || gn_c == nullptr) return -1;
  const int parts = conv3x3_partials(dtype, H, W, tile_rows);
  if (parts < 0) return -1;
  if (sums != nullptr && n_partials != parts) return -2;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_wgmma_rows<true>(tile_rows, x, w, bias, gn_a, gn_c, skip, y, sums, 0, H, W, Cin, Cout, s);
  return launch_fma<true>((const float*)x, (const float*)w, (const float*)bias, gn_a, gn_c, (const float*)skip,
                          (float*)y, sums, 0, H, W, Cin, Cout, s);
}

// The next GroupNorm's (scale, shift), (C,) f32 each, from sums (2, n_partials,
// C) f32 as conv3x3_gn_fused writes them: `groups` groups of C / groups
// channels over `count` = H * W * C / groups elements each; gamma, beta (C,)
// of type gdtype (0 = bf16, 1 = f32). Returns 0, a CUDA error code, or -1.
extern "C" int conv3x3_fold_sums(const float* sums, const void* gamma, const void* beta, float* scale,
                                 float* shift, int gdtype, int n_partials, int C, int groups,
                                 double count, float eps, void* stream) {
  if (n_partials < 1 || groups < 1 || C % groups || groups > 65535) return -1;
  const cudaStream_t s = (cudaStream_t)stream;
  if (gdtype == 0)
    gn_fold_kernel<__nv_bfloat16><<<groups, FOLD_NT, 0, s>>>(
        sums, (const __nv_bfloat16*)gamma, (const __nv_bfloat16*)beta, scale, shift, n_partials, C,
        C / groups, (float)count, eps);
  else if (gdtype == 1)
    gn_fold_kernel<float><<<groups, FOLD_NT, 0, s>>>(sums, (const float*)gamma, (const float*)beta, scale,
                                                     shift, n_partials, C, C / groups, (float)count, eps);
  else
    return -1;
  return (int)cudaGetLastError();
}
