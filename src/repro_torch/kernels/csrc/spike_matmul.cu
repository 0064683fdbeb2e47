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
// design:
//   * one block per (32-output group, 8-row tile); lane = output neuron,
//     so each output word of a warp is one coalesced 128-byte store; K is
//     a loop inside the block;
//   * the block's spike words are staged in shared memory chunk by chunk
//     (coalesced), the bits past d_in masked off there;
//   * the contraction is split over the block's 8 warps (spike word q to
//     warp q % 8); for each spike word a lane loads its neuron's `bits`
//     weight words with one or two vector loads, spreads the unsigned
//     fields to bytes once and reuses them for all 8 rows: each spike
//     nibble expands to four 0/1 bytes and meets four codes in one
//     __dp4a, as in fused_nce.cu; the offset 2^(bits-1) per set spike bit
//     comes off with one popcount per (row, spike word);
//   * the 8 partial sums of each output meet in shared memory.
// The wrapper pads each weight row to bits * kwords words, so every spike
// word meets whole weight words.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;    // warps per block, each a slice of k
constexpr int kRows = 8;     // rows per block
constexpr int kChunk = 128;  // spike words staged per pass

// four 4-bit fields (16 bits) -> four bytes
__device__ __forceinline__ unsigned spread4(unsigned x) {
  unsigned t = (x | (x << 8)) & 0x00FF00FFu;
  return (t | (t << 4)) & 0x0F0F0F0Fu;
}

// four 2-bit fields (8 bits) -> four bytes
__device__ __forceinline__ unsigned spread2(unsigned x) {
  unsigned t = (x | (x << 12)) & 0x000F000Fu;
  return (t | (t << 6)) & 0x03030303u;
}

// The 32 unsigned codes of spike word q for this lane's neuron, as eight
// words of four bytes (word n holds k = 4n .. 4n+3 of the spike word).
template <int BITS>
__device__ __forceinline__ void load_codes(const int32_t* __restrict__ wrow,
                                           int q, unsigned (&c)[8]) {
  if (BITS == 8) {
    const int4* p = reinterpret_cast<const int4*>(wrow + q * 8);
    const int4 a = p[0], b = p[1];
    c[0] = a.x; c[1] = a.y; c[2] = a.z; c[3] = a.w;
    c[4] = b.x; c[5] = b.y; c[6] = b.z; c[7] = b.w;
  } else if (BITS == 4) {
    const int4 a = *reinterpret_cast<const int4*>(wrow + q * 4);
    const unsigned wd[4] = {static_cast<unsigned>(a.x),
                            static_cast<unsigned>(a.y),
                            static_cast<unsigned>(a.z),
                            static_cast<unsigned>(a.w)};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      c[n] = spread4((wd[n >> 1] >> (16 * (n & 1))) & 0xFFFFu);
    }
  } else {
    const int2 a = *reinterpret_cast<const int2*>(wrow + q * 2);
    const unsigned wd[2] = {static_cast<unsigned>(a.x),
                            static_cast<unsigned>(a.y)};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      c[n] = spread2((wd[n >> 2] >> (8 * (n & 3))) & 0xFFu);
    }
  }
}

template <int BITS>
__global__ void __launch_bounds__(kWarps * 32)
spike_matmul_kernel(const int32_t* __restrict__ spikes,  // (m, kwords)
                    const int32_t* __restrict__ w,       // (n, BITS*kwords)
                    int32_t* __restrict__ out,           // (m, n)
                    int m, int n, int kwords, int d_in) {
  __shared__ unsigned srow[kRows][kChunk];
  __shared__ unsigned partial[kWarps][kRows][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  const int row0 = blockIdx.y * kRows;
  const bool live = col < n;
  const int32_t* wrow = w + static_cast<size_t>(live ? col : 0) * BITS *
                                kwords;
  const unsigned bias = 1u << (BITS - 1);
  const int tail = d_in & 31;  // valid bits of the last spike word, 0 = 32
  unsigned acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0u;

  for (int c0 = 0; c0 < kwords; c0 += kChunk) {
    const int cw = min(kChunk, kwords - c0);
    for (int i = threadIdx.x; i < kRows * kChunk; i += blockDim.x) {
      const int r = i / kChunk;
      const int q = i % kChunk;
      unsigned s = 0u;
      if (q < cw && row0 + r < m) {
        s = static_cast<unsigned>(
            spikes[static_cast<size_t>(row0 + r) * kwords + c0 + q]);
        if (tail && c0 + q == kwords - 1) s &= (1u << tail) - 1u;
      }
      srow[r][q] = s;
    }
    __syncthreads();
    for (int q = warp; q < cw; q += kWarps) {
      unsigned c[8];
      if (live) {
        load_codes<BITS>(wrow, c0 + q, c);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) c[j] = 0u;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const unsigned s = srow[r][q];
        unsigned a = acc[r] - bias * static_cast<unsigned>(__popc(s));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          // nibble j -> four 0/1 bytes (no carries: the copies are apart)
          const unsigned sb = (((s >> (4 * j)) & 0xFu) * 0x00204081u) &
                              0x01010101u;
          a = __dp4a(sb, c[j], a);
        }
        acc[r] = a;
      }
    }
    __syncthreads();                       // srow is restaged next pass
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) partial[warp][r][lane] = acc[r];
  __syncthreads();
  const int r = warp;                      // kWarps == kRows: warp r sums row r
  if (live && row0 + r < m) {
    unsigned sum = 0u;
#pragma unroll
    for (int w2 = 0; w2 < kWarps; ++w2) sum += partial[w2][r][lane];
    out[static_cast<size_t>(row0 + r) * n + col] = static_cast<int32_t>(sum);
  }
}

static_assert(kWarps == kRows, "the final reduction gives warp r row r");

}  // namespace

extern "C" int spike_matmul_launch(const void* spikes, const void* w,
                                   void* out, int m, int n, int kwords,
                                   int d_in, int bits, void* stream) {
  const dim3 grid((n + 31) / 32, (m + kRows - 1) / kRows);
  const dim3 block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* s = static_cast<const int32_t*>(spikes);
  const int32_t* wq = static_cast<const int32_t*>(w);
  int32_t* o = static_cast<int32_t*>(out);
  switch (bits) {
    case 2: spike_matmul_kernel<2><<<grid, block, 0, st>>>(s, wq, o, m, n,
                                                           kwords, d_in);
      break;
    case 4: spike_matmul_kernel<4><<<grid, block, 0, st>>>(s, wq, o, m, n,
                                                           kwords, d_in);
      break;
    case 8: spike_matmul_kernel<8><<<grid, block, 0, st>>>(s, wq, o, m, n,
                                                           kwords, d_in);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spike_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
