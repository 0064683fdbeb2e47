// Fused integer shift-add LIF step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/lif_step/kernel.py
// (lif_step_pallas / _lif_kernel): one elementwise pass over int32
//     v' = v - (v >> k) + i;  s = v' >= theta;
//     v' = soft ? v' - s * theta : (s ? v_reset : v')
// with `>>` the arithmetic shift (floor on negative membranes) and int32
// adds that wrap, as in the JAX package.
//
// Two entries share the arithmetic (lif1):
//
// * lif_step_launch writes s as an int32 plane, the JAX kernel's contract.
//   16 bytes of device memory per neuron (read v and i, write v' and s)
//   against a handful of integer operations: bytes-bound.  One
//   grid-stride pass, four neurons per thread with 16-byte loads and
//   stores (the wrapper hands over 16-byte aligned buffers), a scalar
//   tail, no shared memory.
//
// * lif_step_packed_launch writes the spikes already packed, the words
//   pack_bool makes of s (bit j of word w of row r is neuron 32*w + j of
//   that row, the bits past the row's end are 0, bit 31 is the int32
//   sign bit).  12 bytes per neuron plus 4 per word, and the step needs
//   no pack_bool pass over an int32 plane afterwards.  The grid walks
//   (row, word) pairs, one warp a word: lane j loads neuron 32*w + j
//   (a warp's loads of v and i are one coalesced 128-byte line each),
//   and the word is one __ballot_sync of the lanes' spikes, stored by
//   lane 0.  Chosen over four neurons a lane with 16-byte loads and an
//   8-lane __shfl_xor_sync assembly: at both served shapes the time is
//   the launch, not the bytes, a row whose width is not a multiple of 4
//   would break the 16-byte alignment of the next row, and a ballot needs
//   no lane arithmetic.  Lanes past the row's end still reach the ballot
//   (the loop bound is the same for the whole warp, there is no early
//   return), with their bit forced to 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void lif1(int v, int i, int k, int theta,
                                     int v_reset, int soft, int& v_out,
                                     int& s_out) {
  // unsigned adds: int32 wraparound, as XLA and torch compute it
  const unsigned u = static_cast<unsigned>(v) -
                     static_cast<unsigned>(v >> k) +
                     static_cast<unsigned>(i);
  int vn = static_cast<int>(u);
  const int s = vn >= theta;
  if (s) {
    vn = soft ? static_cast<int>(u - static_cast<unsigned>(theta)) : v_reset;
  }
  v_out = vn;
  s_out = s;
}

__global__ void lif_step_kernel(const int32_t* __restrict__ v,
                                const int32_t* __restrict__ i_syn,
                                int32_t* __restrict__ v_out,
                                int32_t* __restrict__ s_out, long long count,
                                int k, int theta, int v_reset, int soft) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long n4 = count / 4;
  const int4* v4 = reinterpret_cast<const int4*>(v);
  const int4* i4 = reinterpret_cast<const int4*>(i_syn);
  int4* vo4 = reinterpret_cast<int4*>(v_out);
  int4* so4 = reinterpret_cast<int4*>(s_out);
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < n4; e += stride) {
    const int4 a = v4[e];
    const int4 b = i4[e];
    int4 vo, so;
    lif1(a.x, b.x, k, theta, v_reset, soft, vo.x, so.x);
    lif1(a.y, b.y, k, theta, v_reset, soft, vo.y, so.y);
    lif1(a.z, b.z, k, theta, v_reset, soft, vo.z, so.z);
    lif1(a.w, b.w, k, theta, v_reset, soft, vo.w, so.w);
    vo4[e] = vo;
    so4[e] = so;
  }
  // the last count % 4 neurons
  const long long e = n4 * 4 + blockIdx.x * static_cast<long long>(
                                   blockDim.x) + threadIdx.x;
  if (e < count) {
    int vo, so;
    lif1(v[e], i_syn[e], k, theta, v_reset, soft, vo, so);
    v_out[e] = vo;
    s_out[e] = so;
  }
}

__global__ void lif_step_packed_kernel(const int32_t* __restrict__ v,
                                       const int32_t* __restrict__ i_syn,
                                       int32_t* __restrict__ v_out,
                                       int32_t* __restrict__ words, int rows,
                                       int n, int k, int theta, int v_reset,
                                       int soft) {
  const int lane = threadIdx.x & 31;
  const int nw = (n + 31) / 32;
  const long long total = static_cast<long long>(rows) * nw;
  const long long warps = static_cast<long long>(gridDim.x) *
                          (blockDim.x / 32);
  // warp-uniform: every lane of a warp walks the same (row, word) pairs
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x / 32) +
                     threadIdx.x / 32;
       g < total; g += warps) {
    const long long r = g / nw;
    const int col = static_cast<int>(g - r * nw) * 32 + lane;
    int fire = 0;
    if (col < n) {
      const long long e = r * n + col;
      int vo;
      lif1(v[e], i_syn[e], k, theta, v_reset, soft, vo, fire);
      v_out[e] = vo;
    }
    const unsigned word = __ballot_sync(0xffffffffu, fire);
    if (lane == 0) words[g] = static_cast<int32_t>(word);
  }
}

}  // namespace

extern "C" int lif_step_launch(const void* v, const void* i_syn, void* v_out,
                               void* s_out, long long count, int leak_shift,
                               int theta, int v_reset, int soft_reset,
                               void* stream) {
  const uintptr_t mis = (reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(i_syn) |
                         reinterpret_cast<uintptr_t>(v_out) |
                         reinterpret_cast<uintptr_t>(s_out)) & 15u;
  if (mis) return static_cast<int>(cudaErrorMisalignedAddress);
  constexpr int kThreads = 256;
  const long long want = (count / 4 + kThreads - 1) / kThreads;
  // enough blocks to fill the card; the grid-stride loop covers the rest
  const int blocks = static_cast<int>(want < 1 ? 1 : (want > 4096 ? 4096
                                                                 : want));
  lif_step_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(v), static_cast<const int32_t*>(i_syn),
      static_cast<int32_t*>(v_out), static_cast<int32_t*>(s_out), count,
      leak_shift, theta, v_reset, soft_reset);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int lif_step_packed_launch(const void* v, const void* i_syn,
                                      void* v_out, void* words, int rows,
                                      int n, int leak_shift, int theta,
                                      int v_reset, int soft_reset,
                                      void* stream) {
  // 4-byte loads: int32 alignment is all the entry needs
  const uintptr_t mis = (reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(i_syn) |
                         reinterpret_cast<uintptr_t>(v_out) |
                         reinterpret_cast<uintptr_t>(words)) & 3u;
  if (mis) return static_cast<int>(cudaErrorMisalignedAddress);
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kThreads = 256;
  constexpr int kWarps = kThreads / 32;
  const long long total = static_cast<long long>(rows) * ((n + 31) / 32);
  const long long want = (total + kWarps - 1) / kWarps;
  // one word a warp up to 4096 blocks; the warp-stride loop covers the rest
  const int blocks = static_cast<int>(want > 4096 ? 4096 : want);
  lif_step_packed_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(v), static_cast<const int32_t*>(i_syn),
      static_cast<int32_t*>(v_out), static_cast<int32_t*>(words), rows, n,
      leak_shift, theta, v_reset, soft_reset);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lif_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
