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
// layer reads ~1 MB of packed weights and needs ~10-20 M adds, so the bound
// is device-memory bytes; with only 8 rows the real limit is parallelism
// (16 blocks of 32 neurons) and latency.  The design:
//   * one block per (32-neuron group, 8-row tile); T is a loop inside the
//     block and each row's membrane lives in the registers of the warp that
//     owns the row, for the whole rollout;
//   * each step's spike words of the block's rows are staged in shared
//     memory first (coalesced), so the accumulate never waits on a
//     dependent global load;
//   * the group's weights are staged once in shared memory, unpacked to
//     int8 codes laid out [k/4][32 neurons][4], and reused for all rows
//     and all T steps;
//   * the contraction is split across the block's 16 warps (spike word q
//     goes to warp q % 16); each lane expands the spike word's nibbles to
//     0/1 bytes and dot-products them with its neuron's codes (__dp4a),
//     the 16 partial currents meet in shared memory, and the owning warp
//     applies LIF, so __ballot_sync(v >= theta) is the packed output word
//     directly.
// Codes beyond d_in are staged as zero, so stray bits past d_in in the last
// spike word are inert, as in the plain version (which unpacks d_in bits).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;  // warps per block, each a slice of k
constexpr int kRows = 8;    // rows per block; warp r owns row r's membrane

__global__ void __launch_bounds__(kWarps * 32)
fused_nce_kernel(const int32_t* __restrict__ spikes,  // (T, m, kwords)
                 const int32_t* __restrict__ w,       // (n_pad, wpr)
                 const int32_t* __restrict__ theta,   // (n_pad,)
                 int32_t* __restrict__ v_out,         // (m, n_pad)
                 int32_t* __restrict__ s_out,         // (T, m, n_pad/32)
                 int T, int m, int kwords, int d_in, int wpr, int bits,
                 int n_pad, int n_out, int leak_shift, int v_reset,
                 int soft_reset) {
  extern __shared__ int32_t smem[];
  int32_t* partial = smem;                                // [warp][row][32]
  int32_t* srow = partial + kWarps * kRows * 32;          // [row][kwords]
  int32_t* codes = srow + kRows * kwords;                 // [k/4][32] x4
  int8_t* code_bytes = reinterpret_cast<int8_t*>(codes);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.x;
  const int row0 = blockIdx.y * kRows;

  // stage the group's codes once; k in [d_in, kwords*32) stays zero
  const int k_pad = kwords * 32;
  for (int i = d_in * 32 + threadIdx.x; i < k_pad * 32; i += blockDim.x) {
    const int k = i >> 5;
    code_bytes[((k >> 2) * 32 + (i & 31)) * 4 + (k & 3)] = 0;
  }
  const int vpw = 32 / bits;
  const unsigned fmask = (1u << bits) - 1u;
  const int bias = 1 << (bits - 1);
  for (int i = threadIdx.x; i < 32 * wpr; i += blockDim.x) {
    const int c = i & 31;
    const int j = i >> 5;
    const unsigned word =
        static_cast<unsigned>(w[static_cast<size_t>(g * 32 + c) * wpr + j]);
    for (int f = 0; f < vpw; ++f) {
      const int k = j * vpw + f;
      if (k < d_in) {
        code_bytes[((k >> 2) * 32 + c) * 4 + (k & 3)] = static_cast<int8_t>(
            static_cast<int>((word >> (f * bits)) & fmask) - bias);
      }
    }
  }
  __syncthreads();

  const int ch = g * 32 + lane;
  const int th = theta[ch];
  const bool live = ch < n_out;
  const int words_out = n_pad / 32;
  const int my_row = row0 + warp;              // the row this warp owns
  const bool owner = warp < kRows && my_row < m;
  int v = 0;

  for (int t = 0; t < T; ++t) {
    for (int i = threadIdx.x; i < kRows * kwords; i += blockDim.x) {
      const int r = i / kwords;
      srow[i] = row0 + r < m
          ? spikes[(static_cast<size_t>(t) * m + row0) * kwords + i] : 0;
    }
    __syncthreads();
    int acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0;
    for (int q = warp; q < kwords; q += kWarps) {
      const int32_t* base = codes + q * 8 * 32 + lane;
      int w4[8];                                 // this word's 32 codes
#pragma unroll
      for (int n = 0; n < 8; ++n) w4[n] = base[n * 32];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (row0 + r < m) {
          const unsigned s = static_cast<unsigned>(srow[r * kwords + q]);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            // nibble n -> four 0/1 bytes (no carries: the copies are apart)
            const unsigned nib = (s >> (4 * n)) & 0xFu;
            acc[r] = __dp4a(static_cast<int>((nib * 0x00204081u) &
                                             0x01010101u), w4[n], acc[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      partial[(warp * kRows + r) * 32 + lane] = acc[r];
    }
    __syncthreads();
    if (owner) {
      int i_syn = 0;
      for (int w2 = 0; w2 < kWarps; ++w2) {
        i_syn += partial[(w2 * kRows + warp) * 32 + lane];
      }
      v = v - (v >> leak_shift) + i_syn;       // arithmetic shift: floor
      const bool fire = live && v >= th;
      const unsigned word = __ballot_sync(0xffffffffu, fire);
      if (fire) v = soft_reset ? v - th : v_reset;
      if (lane == 0) {
        s_out[(static_cast<size_t>(t) * m + my_row) * words_out + g] =
            static_cast<int32_t>(word);
      }
    }
    __syncthreads();                   // partials and srow reused next step
  }
  if (owner) v_out[static_cast<size_t>(my_row) * n_pad + ch] = v;
}

}  // namespace

extern "C" size_t fused_nce_smem_bytes(int kwords) {
  return (static_cast<size_t>(kWarps) * kRows * 32 +
          static_cast<size_t>(kRows) * kwords) * sizeof(int32_t) +
         static_cast<size_t>(kwords) * 32 * 32;
}

extern "C" int fused_nce_launch(const void* spikes, const void* w,
                                const void* theta, void* v_out, void* s_out,
                                int T, int m, int kwords, int d_in, int wpr,
                                int bits, int n_pad, int n_out, int leak_shift,
                                int v_reset, int soft_reset, void* stream) {
  const size_t smem = fused_nce_smem_bytes(kwords);
  cudaError_t err = cudaFuncSetAttribute(
      fused_nce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_pad / 32, (m + kRows - 1) / kRows);
  fused_nce_kernel<<<grid, kWarps * 32, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(spikes), static_cast<const int32_t*>(w),
      static_cast<const int32_t*>(theta), static_cast<int32_t*>(v_out),
      static_cast<int32_t*>(s_out), T, m, kwords, d_in, wpr, bits, n_pad,
      n_out, leak_shift, v_reset, soft_reset);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_nce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
