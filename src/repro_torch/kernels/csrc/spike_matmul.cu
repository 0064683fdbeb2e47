// Spike-driven accumulation (the NCE's AC unit) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/spike_matmul/kernel.py
// (spike_matmul_pallas / _spike_matmul_kernel): one timestep of
//     i[m, n] = sum_k s[m, k] * Wq[n, k]
// with s unpacked from 1-bit spike words and Wq signed 2/4/8-bit codes in
// offset-binary fields (code + 2^(bits-1)), int32 accumulation.
//
// What bounds it on the H100: one pass over the packed weights and spike
// words and one int32 write per output; at the NCE geometries (m = 8..64
// rows, 512..2048 outputs) the bytes are a few MB at most and the adds
// this data needs take under a microsecond at the int8 peak, so the
// kernel is bound by latency and by how many blocks it keeps busy.  The
// first design ran 16 blocks at vgg9's fc1 (one per 32 outputs and 8
// rows), each walking all 128 spike words on CUDA cores (__dp4a).  This
// one is fused_nce.cu's product at T=1 (nce_product.cuh, the same code):
//   * one thread-block cluster of S = 1-16 blocks (fused_nce/ops.py
//     `_nce_plan(1, ...)`) per (32-neuron group, chunk of rb <= 64 rows);
//     block s takes spike words [s*ks, (s+1)*ks), so fc1 (m=8, 4096 ->
//     512) runs 16 groups x 8 = 128 blocks and kernel_bench's NCE step
//     (m=64, 2048 -> 2048) 64 groups x 2 = 128;
//   * spikes expand to 0/1 s8 and codes decode to signed s8 at fragment
//     load from shared memory, into int8 tensor-core products (mma.sync
//     m16n8k32, int8_mma.cuh); the partials meet through distributed
//     shared memory after a cluster barrier;
//   * the epilogue gives one warp a row (lanes = the group's 32 outputs,
//     rows dealt over the cluster's warps) and stores it as coalesced
//     int32, straight into the caller's (m, n) output.
// The weights are read as `quantize` leaves them, (n, ceil(d_in*bits/32))
// words: words past a row's end stage as zero, and spike bits past d_in
// are masked, so both stay inert as in the plain version.

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
spike_matmul_kernel(const int32_t* __restrict__ spikes,  // (m, kwords)
                    const int32_t* __restrict__ w,       // (n, wpr)
                    int32_t* __restrict__ out,           // (m, n)
                    int m, int kwords, int d_in, int wpr, int n, int rb) {
  extern __shared__ __align__(16) int32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const nceprod::Layout L =
      nceprod::make_layout(1, rb, kwords, split, BITS);
  const int g = blockIdx.y;             // 32-neuron group
  const int r0 = blockIdx.z * rb;       // first row of the chunk
  int32_t* part = nceprod::product<BITS>(spikes, w, smem, L, m, kwords, d_in,
                                         wpr, n, rb, g, r0, rank);
  cluster.sync();   // every block's partials are complete

  // epilogue: one warp per row, lanes = the group's outputs
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ch = g * 32 + lane;
  for (int r = rank * kWarps + warp; r < rb && r0 + r < m;
       r += split * kWarps) {
    const int i_syn =
        nceprod::sum_partials(cluster, part, L.rows_pad, split, r, lane);
    if (ch < n) out[static_cast<size_t>(r0 + r) * n + ch] = i_syn;
  }
  cluster.sync();   // peers keep their partials until every block read them
}

template <int BITS>
cudaError_t launch(const void* spikes, const void* w, void* out, int m,
                   int kwords, int d_in, int wpr, int n, int rb, int split,
                   cudaStream_t stream) {
  static std::atomic<bool> cap_raised[smemcap::kDevices] = {};
  const size_t smem =
      nceprod::smem_words(nceprod::make_layout(1, rb, kwords, split, BITS)) *
      sizeof(int32_t);
  return nceprod::launch_cluster(
      spike_matmul_kernel<BITS>, cap_raised, smem, split, (n + 31) / 32,
      (m + rb - 1) / rb, stream, static_cast<const int32_t*>(spikes),
      static_cast<const int32_t*>(w), static_cast<int32_t*>(out), m, kwords,
      d_in, wpr, n, rb);
}

}  // namespace

// Dynamic shared memory of one block for (rb, kwords, split, bits);
// kernels/fused_nce/ops.py `_nce_smem_bytes` at T=1 must give the same.
extern "C" size_t spike_matmul_smem_bytes(int rb, int kwords, int split,
                                          int bits) {
  return nceprod::smem_words(
             nceprod::make_layout(1, rb, kwords, split, bits)) *
         sizeof(int32_t);
}

extern "C" int spike_matmul_launch(const void* spikes, const void* w,
                                   void* out, int m, int kwords, int d_in,
                                   int wpr, int bits, int n, int rb,
                                   int split, void* stream) {
  if (m < 1 || n < 1 || rb < 1 || split < 1 ||
      split > nceprod::kMaxSplit || (n + 31) / 32 > 65535 ||
      (m + rb - 1) / rb > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bits) {
    case 2:
      err = launch<2>(spikes, w, out, m, kwords, d_in, wpr, n, rb, split, st);
      break;
    case 4:
      err = launch<4>(spikes, w, out, m, kwords, d_in, wpr, n, rb, split, st);
      break;
    case 8:
      err = launch<8>(spikes, w, out, m, kwords, d_in, wpr, n, rb, split, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* spike_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
