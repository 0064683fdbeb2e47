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
//   * the int32 partials (two halves per block) stay in shared memory
//     (staging and product: nce_product.cuh, shared with spike_matmul.cu,
//     which is this product at T=1); after a cluster barrier, the
//     epilogue (one warp per batch row, lanes = neurons, rows dealt over
//     the cluster's warps) sums the 2*S
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

#include "nce_product.cuh"

namespace cg = cooperative_groups;

namespace {

using nceprod::kThreads;
using nceprod::kWarps;

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
  const nceprod::Layout L =
      nceprod::make_layout(T, rb, kwords, split, BITS);
  const int g = blockIdx.y;             // 32-neuron group
  const int r0 = blockIdx.z * rb;       // first batch row of the chunk
  int32_t* part = nceprod::product<BITS>(spikes, w, smem, L, m, kwords, d_in,
                                         wpr, n, rb, g, r0, rank);
  cluster.sync();   // every block's partials are complete

  // epilogue: one warp per batch row, lanes = the group's neurons
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ch = g * 32 + lane;
  const bool live = ch < n;
  const int th = live ? theta[ch] : 0;
  const int words_out = n_pad / 32;
  for (int r = rank * kWarps + warp; r < rb && r0 + r < m;
       r += split * kWarps) {
    int v = 0;
    for (int t = 0; t < T; ++t) {
      const int i_syn = nceprod::sum_partials(cluster, part, L.rows_pad,
                                              split, t * rb + r, lane);
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
  static std::atomic<bool> cap_raised[smemcap::kDevices] = {};
  const size_t smem =
      nceprod::smem_words(nceprod::make_layout(T, rb, kwords, split, BITS)) *
      sizeof(int32_t);
  return nceprod::launch_cluster(
      fused_nce_kernel<BITS>, cap_raised, smem, split, n_pad / 32,
      (m + rb - 1) / rb, stream, static_cast<const int32_t*>(spikes),
      static_cast<const int32_t*>(w), static_cast<const int32_t*>(theta),
      static_cast<int32_t*>(v_out), static_cast<int32_t*>(s_out), T, m,
      kwords, d_in, wpr, n, n_pad, rb, leak_shift, v_reset, soft_reset);
}

}  // namespace

// Dynamic shared memory of one block for (T, rb, kwords, split, bits);
// kernels/fused_nce/ops.py `_nce_smem_bytes` must give the same number.
extern "C" size_t fused_nce_smem_bytes(int T, int rb, int kwords, int split,
                                       int bits) {
  return nceprod::smem_words(
             nceprod::make_layout(T, rb, kwords, split, bits)) *
         sizeof(int32_t);
}

extern "C" int fused_nce_launch(const void* spikes, const void* w,
                                const void* theta, void* v_out, void* s_out,
                                int T, int m, int kwords, int d_in, int wpr,
                                int bits, int n, int n_pad, int rb, int split,
                                int leak_shift, int v_reset, int soft_reset,
                                void* stream) {
  if (T < 1 || m < 1 || rb < 1 || split < 1 || split > nceprod::kMaxSplit ||
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
