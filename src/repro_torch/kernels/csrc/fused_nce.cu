// Fused NCE (dense layer) spiking rollout for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/fused_nce/kernel.py
// (fused_nce_rollout_pallas / _fused_nce_kernel): all T timesteps of one
// spiking fully-connected layer in one launch.  Per row and timestep it
// accumulates the 2/4/8-bit integer weight codes of every set bit of the
// 1-bit packed input spikes into an int32 current, applies the shift-add
// LIF update with a per-channel threshold (soft or hard reset), masks
// neurons >= n_out and writes the spikes back as LSB-first 32-neuron words.
//
// What bounds it on the H100: at vgg9's fc1 (4096 -> 512, 8 rows, T=4) the
// layer reads ~1 MB of packed weights and needs ~10-20 M adds, so its
// bound is device-memory bytes (~0.3 us).  What held the first design back
// was parallelism and latency: 16 blocks, each staging and decoding 128 KB
// of codes serially, then one 8-row contraction per timestep.  The
// currents of all T steps do not depend on the membrane: they are one
// (T*m) x d_in x d_out integer product, and only the LIF scan over T is
// sequential.  The design:
//   * one thread-block cluster of S = 1-16 blocks (ops.py `_nce_plan`)
//     per (32-neuron group, chunk of rb batch rows); the cluster splits
//     the contraction: block s takes spike words [s*ks, (s+1)*ks), so fc1
//     at B=8 runs 16 groups x 8 = 128 blocks, each staging 32 neurons x
//     512 codes (8 KB at 4 bits) by cp.async;
//   * the block's rows are (t, row) pairs, local row t*rb + r, padded to
//     16; all T*rb rows' currents come from one int8 tensor-core product
//     (mma.sync m16n8k32, int8_mma.cuh): spike words expand to 0/1 s8 and
//     codes decode to signed s8 at fragment load, from shared memory;
//     warp w owns the 8-neuron tile w % 4 and half w / 4 of the block's
//     k-steps, for every row tile;
//   * the int32 partials (two halves per block) stay in shared memory;
//     after a cluster barrier, the epilogue (one warp per batch row, lanes
//     = neurons, rows dealt over the cluster's warps) sums the 2*S
//     partials of each (t, row) through distributed shared memory, runs
//     the LIF scan over T with the membrane in a register, masks n_out
//     before the reset, and __ballot_sync gives each output word;
//   * spike bits past d_in are masked where the spikes are staged, and
//     weight words past the row's end stage as zero, so both stay inert
//     as in the plain version (which unpacks d_in values).

#include <cooperative_groups.h>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplit = 16;   // blocks per cluster (non-portable above 8)
constexpr int kTileGroup = 4;   // row tiles a warp accumulates at once

struct Layout {
  int rows, rows_pad;   // local rows t*rb + r, and padded to 16
  int ks;               // spike words (k-steps) per block
  int sp_stride;        // staged spike words per row (odd: no conflicts)
  int w_stride;         // staged weight words per neuron (= 4 mod 32)
};

__host__ __device__ inline Layout make_layout(int T, int rb, int kwords,
                                              int split, int bits) {
  Layout l;
  l.rows = T * rb;
  l.rows_pad = (l.rows + 15) / 16 * 16;
  l.ks = (kwords + split - 1) / split;
  l.sp_stride = l.ks | 1;
  l.w_stride = l.ks * bits + ((4 - l.ks * bits) & 31);
  return l;
}

__host__ __device__ inline size_t smem_words(const Layout& l) {
  return static_cast<size_t>(l.rows_pad) * l.sp_stride + 32u * l.w_stride +
         2u * l.rows_pad * 32;
}

template <int BITS>
__global__ void __launch_bounds__(kThreads, 1)
fused_nce_kernel(const int32_t* __restrict__ spikes,  // (T, m, kwords)
                 const int32_t* __restrict__ w,       // (n, wpr)
                 const int32_t* __restrict__ theta,   // (n,)
                 int32_t* __restrict__ v_out,         // (m, n_pad)
                 int32_t* __restrict__ s_out,         // (T, m, n_pad/32)
                 int T, int m, int kwords, int d_in, int wpr, int n,
                 int n_pad, int rb, int leak_shift, int v_reset,
                 int soft_reset) {
  extern __shared__ __align__(16) int32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const Layout L = make_layout(T, rb, kwords, split, BITS);
  const int g = blockIdx.y;             // 32-neuron group
  const int r0 = blockIdx.z * rb;       // first batch row of the chunk
  const int q0 = rank * L.ks;           // first spike word of this block
  const int kw = max(0, min(L.ks, kwords - q0));
  int32_t* sp = smem;                                        // [row][ks]
  uint32_t* ws = reinterpret_cast<uint32_t*>(sp + L.rows_pad * L.sp_stride);
  int32_t* part = reinterpret_cast<int32_t*>(ws + 32 * L.w_stride);
  const int tid = threadIdx.x;

  // the group's codes for this block's k-steps, by cp.async; neurons past
  // n and words past the row's end stage as zero
  const int wk = L.ks * BITS;
  const int w0 = q0 * BITS;
  for (int i = tid; i < 32 * wk; i += kThreads) {
    const int c = i / wk;
    const int x = i - c * wk;
    const int ch = g * 32 + c;
    uint32_t* dst = ws + c * L.w_stride + x;
    if (ch < n && w0 + x < wpr) {
      int8mma::cp_async4(dst, w + static_cast<size_t>(ch) * wpr + w0 + x);
    } else {
      *dst = 0;
    }
  }
  // the chunk's spike words, bits past d_in masked off; padded rows zero
  const unsigned last_mask =
      (d_in & 31) ? (1u << (d_in & 31)) - 1u : 0xFFFFFFFFu;
  for (int i = tid; i < L.rows_pad * L.ks; i += kThreads) {
    const int j = i / L.ks;
    const int q = i - j * L.ks;
    const int t = j / rb;
    const int r = j - t * rb;
    unsigned s = 0;
    if (j < L.rows && q < kw && r0 + r < m) {
      const int qa = q0 + q;
      s = static_cast<unsigned>(
          spikes[(static_cast<size_t>(t) * m + r0 + r) * kwords + qa]);
      if (qa == kwords - 1) s &= last_mask;
    }
    sp[j * L.sp_stride + q] = static_cast<int32_t>(s);
  }
  int8mma::cp_async_wait_all();
  __syncthreads();

  // every row tile x (8-neuron tile, k half): one product into registers
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int j8 = warp & 3;
  const int half = warp >> 2;
  const int k_lo = half ? (kw + 1) / 2 : 0;
  const int k_hi = half ? kw : (kw + 1) / 2;
  const uint32_t* wrow = ws + (j8 * 8 + gq) * L.w_stride;
  int32_t* mine = part + half * L.rows_pad * 32;
  const int tiles = L.rows_pad / 16;
  for (int tg = 0; tg < tiles; tg += kTileGroup) {
    int acc[kTileGroup][4];
#pragma unroll
    for (int i = 0; i < kTileGroup; ++i) {
      acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0;
    }
    for (int q = k_lo; q < k_hi; ++q) {
      const unsigned b0 = int8mma::codes_s8<BITS>(wrow + q * BITS, 0, tq);
      const unsigned b1 = int8mma::codes_s8<BITS>(wrow + q * BITS, 1, tq);
#pragma unroll
      for (int i = 0; i < kTileGroup; ++i) {
        if (tg + i < tiles) {   // uniform across the warp
          const int row = (tg + i) * 16 + gq;
          const unsigned lo =
              static_cast<unsigned>(sp[row * L.sp_stride + q]);
          const unsigned hi =
              static_cast<unsigned>(sp[(row + 8) * L.sp_stride + q]);
          int8mma::mma_s8(acc[i], int8mma::spikes_s8(lo, tq),
                          int8mma::spikes_s8(hi, tq),
                          int8mma::spikes_s8(lo, tq + 4),
                          int8mma::spikes_s8(hi, tq + 4), b0, b1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTileGroup; ++i) {
      if (tg + i < tiles) {
        const int row = (tg + i) * 16 + gq;
        const int col = j8 * 8 + tq * 2;
        *reinterpret_cast<int2*>(&mine[row * 32 + col]) =
            make_int2(acc[i][0], acc[i][1]);
        *reinterpret_cast<int2*>(&mine[(row + 8) * 32 + col]) =
            make_int2(acc[i][2], acc[i][3]);
      }
    }
  }
  cluster.sync();   // every block's partials are complete

  // epilogue: one warp per batch row, lanes = the group's neurons
  const int ch = g * 32 + lane;
  const bool live = ch < n;
  const int th = live ? theta[ch] : 0;
  const int words_out = n_pad / 32;
  for (int r = rank * kWarps + warp; r < rb && r0 + r < m;
       r += split * kWarps) {
    int v = 0;
    for (int t = 0; t < T; ++t) {
      const int j = t * rb + r;
      int i_syn = 0;
      for (int s = 0; s < split; ++s) {
        const int32_t* p = cluster.map_shared_rank(part, s);
        i_syn += p[j * 32 + lane] + p[(L.rows_pad + j) * 32 + lane];
      }
      v = v - (v >> leak_shift) + i_syn;       // arithmetic shift: floor
      const bool fire = live && v >= th;
      const unsigned word = __ballot_sync(0xFFFFFFFFu, fire);
      if (fire) v = soft_reset ? v - th : v_reset;
      if (lane == 0) {
        s_out[(static_cast<size_t>(t) * m + r0 + r) * words_out + g] =
            static_cast<int32_t>(word);
      }
    }
    v_out[static_cast<size_t>(r0 + r) * n_pad + ch] = v;
  }
  cluster.sync();   // peers keep their partials until every block read them
}

template <int BITS>
cudaError_t launch(const void* spikes, const void* w, const void* theta,
                   void* v_out, void* s_out, int T, int m, int kwords,
                   int d_in, int wpr, int n, int n_pad, int rb, int split,
                   int leak_shift, int v_reset, int soft_reset,
                   cudaStream_t stream) {
  auto kern = fused_nce_kernel<BITS>;
  const size_t smem =
      smem_words(make_layout(T, rb, kwords, split, BITS)) * sizeof(int32_t);
  // the attributes on the current device are set only when the shared
  // memory changes (a launch is host-bound: each cudaFuncSetAttribute
  // costs microseconds)
  constexpr int kDevices = 16;
  static size_t set_smem[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices || smem != set_smem[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err != cudaSuccess) return err;
    if (dev < kDevices) set_smem[dev] = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, n_pad / 32, (m + rb - 1) / rb);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const int32_t*>(spikes),
      static_cast<const int32_t*>(w), static_cast<const int32_t*>(theta),
      static_cast<int32_t*>(v_out), static_cast<int32_t*>(s_out), T, m,
      kwords, d_in, wpr, n, n_pad, rb, leak_shift, v_reset, soft_reset);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block for (T, rb, kwords, split, bits);
// kernels/fused_nce/ops.py `_nce_smem_bytes` must give the same number.
extern "C" size_t fused_nce_smem_bytes(int T, int rb, int kwords, int split,
                                       int bits) {
  return smem_words(make_layout(T, rb, kwords, split, bits)) *
         sizeof(int32_t);
}

extern "C" int fused_nce_launch(const void* spikes, const void* w,
                                const void* theta, void* v_out, void* s_out,
                                int T, int m, int kwords, int d_in, int wpr,
                                int bits, int n, int n_pad, int rb, int split,
                                int leak_shift, int v_reset, int soft_reset,
                                void* stream) {
  if (T < 1 || m < 1 || rb < 1 || split < 1 || split > kMaxSplit ||
      n_pad % 32 || n_pad / 32 > 65535 || (m + rb - 1) / rb > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bits) {
    case 2:
      err = launch<2>(spikes, w, theta, v_out, s_out, T, m, kwords, d_in, wpr,
                      n, n_pad, rb, split, leak_shift, v_reset, soft_reset,
                      st);
      break;
    case 4:
      err = launch<4>(spikes, w, theta, v_out, s_out, T, m, kwords, d_in, wpr,
                      n, n_pad, rb, split, leak_shift, v_reset, soft_reset,
                      st);
      break;
    case 8:
      err = launch<8>(spikes, w, theta, v_out, s_out, T, m, kwords, d_in, wpr,
                      n, n_pad, rb, split, leak_shift, v_reset, soft_reset,
                      st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* fused_nce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
