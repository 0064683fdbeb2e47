// The K-split cluster product of a spiking dense layer (sm_90a), shared by
// fused_nce.cu (all T steps, then a LIF scan) and spike_matmul.cu (one
// step, then int32 currents).
//
// One thread-block cluster of S = 1-16 blocks (kernels/fused_nce/ops.py
// `_nce_plan`) per (32-neuron group, chunk of rb batch rows): the cluster
// splits the contraction, block s taking spike words [s*ks, (s+1)*ks).
// A block's rows are (t, row) pairs, local row t*rb + r, padded to 16;
// all T*rb rows' currents come from one int8 tensor-core product
// (mma.sync m16n8k32, int8_mma.cuh): spike words expand to 0/1 s8 and
// codes decode to signed s8 at fragment load, from shared memory; warp w
// owns the 8-neuron tile w % 4 and half w / 4 of the block's k-steps, for
// every row tile.  The int32 partials (two halves per block) stay in
// shared memory for the caller's epilogue, which sums the 2*S partials of
// each row through distributed shared memory (`sum_partials`) after a
// cluster barrier.  Spike bits past d_in are masked where the spikes are
// staged, and weight words past the row's end stage as zero, so both stay
// inert as in the plain versions (which unpack d_in values): the weights
// are read as `quantize` leaves them, (n, ceil(d_in*bits/32)) words.

#pragma once

#include <cooperative_groups.h>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"
#include "smem_cap.cuh"

namespace nceprod {

namespace cg = cooperative_groups;

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
  l.w_stride = int8mma::staged_stride(l.ks * bits);
  return l;
}

// Dynamic shared memory of one block, in words: the chunk's spike words,
// the group's codes for the block's k-steps, two int32 partial tiles.
__host__ __device__ inline size_t smem_words(const Layout& l) {
  return static_cast<size_t>(l.rows_pad) * l.sp_stride + 32u * l.w_stride +
         2u * l.rows_pad * 32;
}

// Stage this block's spikes and codes and run its share of the product.
// spikes (T, m, kwords), w (n, wpr); g the 32-neuron group, r0 the first
// batch row of the chunk, rank the block's rank in the cluster.  Returns
// the partial tiles: [half][local row][32 neurons] int32.
template <int BITS>
__device__ __forceinline__ int32_t* product(
    const int32_t* __restrict__ spikes, const int32_t* __restrict__ w,
    int32_t* smem, const Layout& L, int m, int kwords, int d_in, int wpr,
    int n, int rb, int g, int r0, int rank) {
  const int q0 = rank * L.ks;           // first spike word of this block
  const int kw = max(0, min(L.ks, kwords - q0));
  int32_t* sp = smem;                                        // [row][ks]
  uint32_t* ws = reinterpret_cast<uint32_t*>(sp + L.rows_pad * L.sp_stride);
  int32_t* part = reinterpret_cast<int32_t*>(ws + 32 * L.w_stride);
  const int tid = threadIdx.x;

  // the group's codes for this block's k-steps, by cp.async (16-byte
  // pieces where every row and this block's share of it are whole
  // pieces, which the staged stride, = 4 mod 32 words, keeps aligned);
  // neurons past n and words past the row's end stage as zero
  const int wk = L.ks * BITS;
  const int w0 = q0 * BITS;
  if (wpr % 4 == 0 && wk % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(w) & 15) == 0) {
    const int v4 = wk / 4;
    for (int i = tid; i < 32 * v4; i += kThreads) {
      const int c = i / v4;
      const int x = (i - c * v4) * 4;
      const int ch = g * 32 + c;
      uint32_t* dst = ws + c * L.w_stride + x;
      if (ch < n && w0 + x < wpr) {
        int8mma::cp_async16(dst, w + static_cast<size_t>(ch) * wpr + w0 + x);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
  } else {
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
  return part;
}

// The current of local row j, neuron `lane` of the group: the 2*split
// partials of the cluster's blocks, through distributed shared memory
// (after a cluster barrier that follows every block's `product`).
__device__ __forceinline__ int sum_partials(cg::cluster_group& cluster,
                                            int32_t* part, int rows_pad,
                                            int split, int j, int lane) {
  int i_syn = 0;
  for (int s = 0; s < split; ++s) {
    const int32_t* p = cluster.map_shared_rank(part, s);
    i_syn += p[j * 32 + lane] + p[(rows_pad + j) * 32 + lane];
  }
  return i_syn;
}

// Launch `kern` as (split, groups, row chunks) blocks in clusters of
// `split` along x.  The kernel's shared-memory cap is raised once per
// device (smem_cap.cuh; `cap_raised` is a static of the caller's).
template <typename Kern, typename... Args>
cudaError_t launch_cluster(Kern kern,
                           std::atomic<bool> (&cap_raised)[smemcap::kDevices],
                           size_t smem, int split, int groups, int chunks,
                           cudaStream_t stream, Args... args) {
  cudaError_t err = smemcap::raise(kern, true, cap_raised);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, groups, chunks);
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
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace nceprod
