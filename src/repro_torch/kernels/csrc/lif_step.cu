// Fused integer shift-add LIF step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/lif_step/kernel.py
// (lif_step_pallas / _lif_kernel): one elementwise pass over int32
//     v' = v - (v >> k) + i;  s = v' >= theta;
//     v' = soft ? v' - s * theta : (s ? v_reset : v')
// with `>>` the arithmetic shift (floor on negative membranes) and int32
// adds that wrap, as in the JAX package.
//
// What bounds it on the H100: 16 bytes of device memory per neuron (read
// v and i, write v' and s) against a handful of integer operations, so it
// is bytes-bound.  The design: one grid-stride pass, four neurons per
// thread with 16-byte loads and stores where the buffers allow (the
// wrapper hands over fresh contiguous tensors), a scalar tail, and no
// shared memory.

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

extern "C" const char* lif_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
