// Fused packed-conv spiking rollout for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/fused_conv/kernel.py
// (fused_conv_rollout_pallas / _fused_conv_kernel): all T timesteps of one
// spiking conv layer in one launch.  Per output pixel and timestep it
// gathers the kh*kw receptive field of a 1-bit channel-packed spike plane
// (SAME or VALID, any stride, the zero halo read in the kernel),
// accumulates the 2/4/8-bit integer weight codes of every set spike bit
// into an int32 current, applies the shift-add LIF update with a
// per-channel threshold (soft or hard reset), masks channels >= n_out and
// writes the spikes back as LSB-first 32-channel words.
//
// What bounds it on the H100: at the served shapes (vgg9 and resnet18 at
// B=8, T=4) the layer moves 0.1-3 MB and needs ~0.01-0.3 G adds, so its
// bound is a microsecond or less; what held the first design back was
// latency: __dp4a on CUDA cores, one pixel at a time with T outside, every
// block decoding its whole weight tile to bytes, half the warps idle at
// 4x4 outputs and three F.pad copies a call in the wrapper.  The design:
//   * a warp owns a unit, 16 output pixels x 32 channels of one batch
//     element, for the whole rollout, its membranes in registers (nothing
//     downstream waits on a step, so no membrane scratch; the final v is
//     written once);
//   * each step of a unit is an implicit GEMM on int8 tensor cores
//     (mma.sync m16n8k32, int8_mma.cuh): rows the 16 pixels at one step,
//     columns 8 channels, depth one 32-channel spike word of one tap.  A
//     k-step's B fragments (4 x 8 channels) are decoded once from the
//     packed codes and used for up to kTr = 4 steps (rows (pixel, step),
//     16 accumulators); the chunk's step count is a template argument, so
//     the step loop has no branches;
//   * the A fragments are read from the caller's planes as they are: row
//     (pixel) p of tap (di, dj) reads the word at (oy*stride + di - pad_top,
//     ox*stride + dj - pad_left), zero outside the plane (a predicated
//     load), so stride 2, 1x1 taps and the asymmetric SAME pads need no
//     padded copy;
//   * a block (8 warps) holds units of one 32-channel group and stages the
//     group's packed codes once by cp.async, straight from the (c_out,
//     wpr) words at a stride of 4 mod 32 words a channel (the 8 channels
//     of a B fragment load in distinct banks), channels >= c_out as zero;
//     where the tile does not fit in shared memory, the codes are read
//     from L2 (channels clamped to c_out - 1, their results masked);
//   * the launch plan (kernels/fused_conv/ops.py `_conv_plan`) fills the
//     card: where the units are fewer than one wave of warps, a team of
//     2-8 warps splits each unit's k-steps and the partial sums meet in
//     the leader's registers through a shared-memory tile (red.shared),
//     as in fused_group.cu;
//   * the epilogue (int8_mma.cuh `lif_words`) runs LIF on the accumulator
//     lane map, masks n_out before the reset and completes each pixel's
//     32-channel word by two xor-shuffles over the quad; two lanes of the
//     quad store whole words.
//
// Geometry contract (enforced by kernels/fused_conv/ops.py): planes (T, B,
// H, W, wc) int32 with wc = cin_pad/32; weights (n_out, wpr) int32 with
// wpr = kh*kw*wc*bits; theta (n_out,) int32; outputs v (B, Ho*Wo, n_out)
// and spikes (T, B, Ho*Wo, ceil(n_out/32)) int32.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"
#include "smem_cap.cuh"

namespace {

constexpr int kWarps = 8;                // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kTr = 4;                   // steps a warp's accumulators hold
constexpr int kTileWords = kTr * 16 * 32;   // one team's K-split tile

struct Geom {
  int T, B, H, W, wc;          // input planes
  int Ho, Wo, kh, kw, stride, pad_top, pad_left;
  int n_out, wpr;              // output channels, code words per channel
  int tiles;                   // 16-pixel tiles of the output plane
  int ks;                      // warps per unit (1, 2, 4, 8)
  int blocks_per_group;
  int w_stride;                // staged words per channel, 0 = L2
  int leak_shift, v_reset, soft_reset;
};

// dynamic shared memory of a launch: the staged codes, then the K-split
// tiles of the 8 / ks teams
__host__ __device__ inline size_t smem_words(int wpr, int ks, int staged) {
  return (staged ? 32u * int8mma::staged_stride(wpr) : 0u) +
         (ks > 1 ? static_cast<size_t>(kWarps / ks) * kTileWords : 0u);
}

// the word offset, within one (step, batch element) plane, of this lane's
// pixel at input (y, x), and whether it lies inside the plane
struct Tap {
  int off_lo, off_hi;
  bool ok_lo, ok_hi;
};

__device__ __forceinline__ Tap tap_at(const Geom& g, int tap, int y_lo,
                                      int x_lo, int y_hi, int x_hi) {
  const int di = tap / g.kw;
  const int dj = tap - di * g.kw;
  Tap t;
  const int yl = y_lo + di, xl = x_lo + dj, yh = y_hi + di, xh = x_hi + dj;
  t.ok_lo = yl >= 0 && yl < g.H && xl >= 0 && xl < g.W;
  t.ok_hi = yh >= 0 && yh < g.H && xh >= 0 && xh < g.W;
  t.off_lo = (yl * g.W + xl) * g.wc;
  t.off_hi = (yh * g.W + xh) * g.wc;
  return t;
}

// The currents of NS <= kTr steps of one unit over the k-steps [k0, k1)
// ((tap, spike word q) pairs, tap-major as the codes are laid out): per
// k-step the B fragments of the 4 8-channel tiles are decoded once and
// used for all NS steps.
template <int BITS, int NS>
__device__ __forceinline__ void mma_ksteps(
    int (&acc)[kTr][4][4], const uint32_t* const (&rows)[4],
    const int32_t* __restrict__ plane, size_t step_words, int k0, int k1,
    const Geom& g, int y_lo, int x_lo, int y_hi, int x_hi, int tq) {
  const int wc = g.wc;
  int tap = k0 / wc;
  int q = k0 - tap * wc;
  Tap tp = tap_at(g, tap, y_lo, x_lo, y_hi, x_hi);
#pragma unroll 2
  for (int kk = k0; kk < k1; ++kk) {
    const int kb = kk * BITS;   // the k-step's first code word
    unsigned bf[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bf[j][0] = int8mma::codes_s8<BITS>(rows[j] + kb, 0, tq);
      bf[j][1] = int8mma::codes_s8<BITS>(rows[j] + kb, 1, tq);
    }
    const int32_t* pl = plane + tp.off_lo + q;
    const int32_t* ph = plane + tp.off_hi + q;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const unsigned lo =
          tp.ok_lo ? static_cast<unsigned>(__ldg(pl + i * step_words)) : 0u;
      const unsigned hi =
          tp.ok_hi ? static_cast<unsigned>(__ldg(ph + i * step_words)) : 0u;
      const unsigned a0 = int8mma::spikes_s8(lo, tq);
      const unsigned a1 = int8mma::spikes_s8(hi, tq);
      const unsigned a2 = int8mma::spikes_s8(lo, tq + 4);
      const unsigned a3 = int8mma::spikes_s8(hi, tq + 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int8mma::mma_s8(acc[i][j], a0, a1, a2, a3, bf[j][0], bf[j][1]);
      }
    }
    if (++q == wc) {
      q = 0;
      ++tap;
      tp = tap_at(g, tap, y_lo, x_lo, y_hi, x_hi);
    }
  }
}

__device__ __forceinline__ void team_barrier(int team, int warps) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "r"(warps * 32)
               : "memory");
}

template <int BITS, bool STAGED>
__global__ void __launch_bounds__(kThreads, 1)
fused_conv_kernel(const int32_t* __restrict__ planes,  // (T,B,H,W,wc)
                  const int32_t* __restrict__ w,       // (n_out, wpr)
                  const int32_t* __restrict__ theta,   // (n_out,)
                  int32_t* __restrict__ v_out,         // (B, Ho*Wo, n_out)
                  int32_t* __restrict__ s_out,         // (T,B,Ho*Wo,groups)
                  const __grid_constant__ Geom g) {
  extern __shared__ __align__(16) int32_t smem[];
  const int gr = blockIdx.x / g.blocks_per_group;   // 32-channel group
  const int bi = blockIdx.x - gr * g.blocks_per_group;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  uint32_t* const wsm = reinterpret_cast<uint32_t*>(smem);

  if (STAGED) {
    // the group's packed codes, once (in 16-byte pieces where the rows
    // are whole pieces); channels past n_out as zero
    const uint32_t* wq = reinterpret_cast<const uint32_t*>(w);
    if (g.wpr % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {
      const int v4 = g.wpr / 4;   // 16-byte pieces per channel row
      for (int i = threadIdx.x; i < 32 * v4; i += kThreads) {
        const int c = i / v4;
        const int x = (i - c * v4) * 4;
        const int ch = gr * 32 + c;
        uint32_t* d = wsm + c * g.w_stride + x;
        if (ch < g.n_out) {
          int8mma::cp_async16(d, wq + static_cast<size_t>(ch) * g.wpr + x);
        } else {
          *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
        }
      }
    } else {
      for (int i = threadIdx.x; i < 32 * g.wpr; i += kThreads) {
        const int c = i / g.wpr;
        const int x = i - c * g.wpr;
        const int ch = gr * 32 + c;
        uint32_t* d = wsm + c * g.w_stride + x;
        if (ch < g.n_out) {
          int8mma::cp_async4(d, wq + static_cast<size_t>(ch) * g.wpr + x);
        } else {
          *d = 0;
        }
      }
    }
    int8mma::cp_async_wait_all();
    __syncthreads();
  }

  // this warp's team and unit (a team idles whole, so its barriers hold)
  const int ks = g.ks;
  const int teams = kWarps / ks;
  const int team = warp / ks;
  const int trank = warp - team * ks;
  const int u = bi * teams + team;
  if (u >= g.tiles * g.B) return;
  const int b = u / g.tiles;
  const int tile = u - b * g.tiles;
  const bool leader = trank == 0;
  int32_t* const red =
      smem + (STAGED ? 32 * g.w_stride : 0) + team * kTileWords;

  // this lane's channel rows (one per 8-channel tile) of the codes
  const uint32_t* rows[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = j * 8 + gq;
    if (STAGED) {
      rows[j] = wsm + c * g.w_stride;
    } else {
      const int ch = min(gr * 32 + c, g.n_out - 1);
      rows[j] = reinterpret_cast<const uint32_t*>(w) +
                static_cast<size_t>(ch) * g.wpr;
    }
  }
  // this lane's pixels g and g+8 of the tile (clamped for loads), and the
  // input origin of their receptive fields
  const int npix = g.Ho * g.Wo;
  const int p_lo = tile * 16 + gq;
  const int p_hi = p_lo + 8;
  const int pl = min(p_lo, npix - 1);
  const int ph = min(p_hi, npix - 1);
  const int y_lo = (pl / g.Wo) * g.stride - g.pad_top;
  const int x_lo = (pl % g.Wo) * g.stride - g.pad_left;
  const int y_hi = (ph / g.Wo) * g.stride - g.pad_top;
  const int x_hi = (ph % g.Wo) * g.stride - g.pad_left;
  const int nk = g.kh * g.kw * g.wc;
  const int k0 = trank * nk / ks;
  const int k1 = (trank + 1) * nk / ks;
  const size_t plane_words = static_cast<size_t>(g.H) * g.W * g.wc;
  const size_t step_words = plane_words * g.B;
  const int groups = (g.n_out + 31) / 32;

  // thresholds of channels 2q, 2q+1 of each 8-tile, membranes (leader's)
  int th[4][2];
  bool live[4][2];
  int mem[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int ch = gr * 32 + j * 8 + tq * 2 + e;
      live[j][e] = ch < g.n_out;
      th[j][e] = live[j][e] && leader ? theta[ch] : 0;
    }
    mem[j][0] = mem[j][1] = mem[j][2] = mem[j][3] = 0;
  }

  for (int tg = 0; tg < g.T; tg += kTr) {
    int acc[kTr][4][4];
#pragma unroll
    for (int i = 0; i < kTr; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;
      }
    }
    // this warp's k-steps [k0, k1) for the min(kTr, T - tg) steps of this
    // chunk: a loop without per-step branches for each count
    const int ns = min(kTr, g.T - tg);
    const int32_t* plane =
        planes + (static_cast<size_t>(tg) * g.B + b) * plane_words;
    if (ns == 4) {
      mma_ksteps<BITS, 4>(acc, rows, plane, step_words, k0, k1, g, y_lo,
                          x_lo, y_hi, x_hi, tq);
    } else if (ns == 3) {
      mma_ksteps<BITS, 3>(acc, rows, plane, step_words, k0, k1, g, y_lo,
                          x_lo, y_hi, x_hi, tq);
    } else if (ns == 2) {
      mma_ksteps<BITS, 2>(acc, rows, plane, step_words, k0, k1, g, y_lo,
                          x_lo, y_hi, x_hi, tq);
    } else {
      mma_ksteps<BITS, 1>(acc, rows, plane, step_words, k0, k1, g, y_lo,
                          x_lo, y_hi, x_hi, tq);
    }
    if (ks > 1) {
      // the team's partial sums meet in the leader's registers: the
      // leader stores its own, the others add theirs (red.shared)
      if (leader) {
#pragma unroll
        for (int i = 0; i < kTr; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              red[((i * 4 + j) * 4 + e) * 32 + lane] = acc[i][j][e];
      }
      team_barrier(team, ks);
      if (!leader) {
#pragma unroll
        for (int i = 0; i < kTr; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              atomicAdd(&red[((i * 4 + j) * 4 + e) * 32 + lane],
                        acc[i][j][e]);
      }
      team_barrier(team, ks);
      if (leader) {
#pragma unroll
        for (int i = 0; i < kTr; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][j][e] = red[((i * 4 + j) * 4 + e) * 32 + lane];
      }
      // only the leader reads the tile, before its next chunk's store,
      // and the others add to it only after that store's barrier
    }
    if (!leader) continue;
    // the LIF scan over the chunk's steps, in registers; pack, store
#pragma unroll
    for (int i = 0; i < kTr; ++i) {
      if (tg + i >= g.T) break;   // uniform across the warp
      unsigned w_lo, w_hi;
      int8mma::lif_words(mem, acc[i], th, live, tq, g.leak_shift, g.v_reset,
                         g.soft_reset, w_lo, w_hi);
      const size_t base =
          (static_cast<size_t>(tg + i) * g.B + b) * npix;
      if (tq == 0 && p_lo < npix) {
        s_out[(base + p_lo) * groups + gr] = static_cast<int32_t>(w_lo);
      }
      if (tq == 1 && p_hi < npix) {
        s_out[(base + p_hi) * groups + gr] = static_cast<int32_t>(w_hi);
      }
    }
  }
  if (!leader) return;
  // the final membranes of the unit's live channels
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = e < 2 ? p_lo : p_hi;
      if (live[j][e & 1] && p < npix) {
        const int ch = gr * 32 + j * 8 + tq * 2 + (e & 1);
        v_out[(static_cast<size_t>(b) * npix + p) * g.n_out + ch] =
            mem[j][e];
      }
    }
  }
}

// the kernel's shared-memory cap is raised once per device (smem_cap.cuh)
template <int BITS, bool STAGED>
cudaError_t launch(const void* planes, const void* w, const void* theta,
                   void* v_out, void* s_out, const Geom& g, size_t smem,
                   int blocks, cudaStream_t stream) {
  static std::atomic<bool> cap_raised[smemcap::kDevices] = {};
  cudaError_t err = smemcap::raise(fused_conv_kernel<BITS, STAGED>, false,
                                   cap_raised);
  if (err != cudaSuccess) return err;
  fused_conv_kernel<BITS, STAGED><<<blocks, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(planes), static_cast<const int32_t*>(w),
      static_cast<const int32_t*>(theta), static_cast<int32_t*>(v_out),
      static_cast<int32_t*>(s_out), g);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_bits(const void* planes, const void* w, const void* theta,
                        void* v_out, void* s_out, const Geom& g, size_t smem,
                        int blocks, cudaStream_t stream) {
  return g.w_stride
             ? launch<BITS, true>(planes, w, theta, v_out, s_out, g, smem,
                                  blocks, stream)
             : launch<BITS, false>(planes, w, theta, v_out, s_out, g, smem,
                                   blocks, stream);
}

}  // namespace

// Dynamic shared memory of one block: the staged codes of one group (wpr
// words a channel, when `staged`) and the K-split tiles of teams of `ks`
// warps; kernels/fused_conv/ops.py `_conv_smem_bytes` must give the same.
extern "C" size_t fused_conv_smem_bytes(int wpr, int ks, int staged) {
  return smem_words(wpr, ks, staged) * sizeof(int32_t);
}

// ks: warps per unit (1, 2, 4 or 8); blocks_per_group: blocks of each
// 32-channel group (8 / ks units a block); staged: stage the group's codes
// in shared memory, else read them from L2.
extern "C" int fused_conv_launch(const void* planes, const void* w,
                                 const void* theta, void* v_out, void* s_out,
                                 int T, int B, int H, int W, int wc, int Ho,
                                 int Wo, int kh, int kw, int stride,
                                 int pad_top, int pad_left, int bits,
                                 int n_out, int ks, int blocks_per_group,
                                 int staged, int leak_shift, int v_reset,
                                 int soft_reset, void* stream) {
  const int groups = (n_out + 31) / 32;
  const int tiles = (Ho * Wo + 15) / 16;
  if (T < 1 || B < 1 || H < 1 || W < 1 || wc < 1 || Ho < 1 || Wo < 1 ||
      kh < 1 || kw < 1 || stride < 1 || n_out < 1 ||
      (ks != 1 && ks != 2 && ks != 4 && ks != 8) || blocks_per_group < 1 ||
      static_cast<long long>(blocks_per_group) * (kWarps / ks) <
          static_cast<long long>(tiles) * B ||
      static_cast<long long>(groups) * blocks_per_group > 0x7FFFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geom g;
  g.T = T;
  g.B = B;
  g.H = H;
  g.W = W;
  g.wc = wc;
  g.Ho = Ho;
  g.Wo = Wo;
  g.kh = kh;
  g.kw = kw;
  g.stride = stride;
  g.pad_top = pad_top;
  g.pad_left = pad_left;
  g.n_out = n_out;
  g.wpr = kh * kw * wc * bits;
  g.tiles = tiles;
  g.ks = ks;
  g.blocks_per_group = blocks_per_group;
  g.w_stride = staged ? int8mma::staged_stride(g.wpr) : 0;
  g.leak_shift = leak_shift;
  g.v_reset = v_reset;
  g.soft_reset = soft_reset;
  const size_t smem = fused_conv_smem_bytes(g.wpr, ks, staged);
  const int blocks = groups * blocks_per_group;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bits) {
    case 2:
      err = launch_bits<2>(planes, w, theta, v_out, s_out, g, smem, blocks,
                           st);
      break;
    case 4:
      err = launch_bits<4>(planes, w, theta, v_out, s_out, g, smem, blocks,
                           st);
      break;
    case 8:
      err = launch_bits<8>(planes, w, theta, v_out, s_out, g, smem, blocks,
                           st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* fused_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
