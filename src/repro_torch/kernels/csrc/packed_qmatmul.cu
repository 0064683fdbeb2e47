// Packed low-bit weight matmul with in-register dequantization, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/packed_qmatmul/kernel.py
// (qmatmul_pallas / _qmatmul_kernel):
//     y[m, n] = sum_k x[m, k] * (scale[n, g(k)] * Wq[n, k])
// with Wq signed 2/4/8-bit codes in offset-binary fields of int32 words,
// one float32 scale per (row, group) (group_size = -1: one per row),
// float32 accumulation and one rounding to x's dtype at the end.
//
// What bounds it on the H100: on the served LM path M is small (8 slots
// at decode, a prompt at prefill), so every packed weight byte is used a
// few times at most and the bound is the packed weight bytes over the
// memory rate (olmo-1b at INT4: 537 MB, 0.16 ms per decode step).  The
// design streams the packed rows once and decodes each code once per 8
// rows of x:
//   * one warp owns 4 output rows (neurons); its lanes walk the packed
//     words of those rows, lane l taking words l, l+32, ..., so every
//     weight load of the warp is one coalesced 128-byte line;
//   * each code is decoded in registers (shift, mask, subtract 2^(bits-1)),
//     scaled by its group's scale (rounded to float32, as the reference
//     dequantizes), and multiplied into the 8 rows of x the block holds
//     (x is read in its own dtype, 4 values per load, from L1/L2);
//   * blocks of 4 warps cover 16 outputs; the grid's second axis walks x
//     in tiles of 8 rows; the 32 lanes' partial sums meet by shuffles.
// Tensor cores (wgmma) are later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // warps per block
constexpr int kNb = 4;     // output rows (neurons) per warp
constexpr int kMr = 8;     // rows of x per block

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ void load4(const float* p,
                                               float (&o)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                               float (&o)[4]) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    o[0] = __uint_as_float(v.x << 16);
    o[1] = __uint_as_float(v.x & 0xFFFF0000u);
    o[2] = __uint_as_float(v.y << 16);
    o[3] = __uint_as_float(v.y & 0xFFFF0000u);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

template <>
struct Io<__half> {
  static __device__ __forceinline__ void load4(const __half* p,
                                               float (&o)[4]) {
    const __half2* h = reinterpret_cast<const __half2*>(p);
    const float2 a = __half22float2(h[0]);
    const float2 b = __half22float2(h[1]);
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
  static __device__ __forceinline__ void store(__half* p, float v) {
    *p = __float2half_rn(v);
  }
};

template <typename T, int BITS, bool GROUPED>
__global__ void __launch_bounds__(kWarps * 32)
qmatmul_kernel(const T* __restrict__ x,          // (m, k_pad)
               const int32_t* __restrict__ w,    // (n, k_pad / vpw)
               const float* __restrict__ scale,  // (n, groups)
               T* __restrict__ out,              // (m, n)
               int m, int n, int k_pad, int gs, int groups) {
  constexpr int kVpw = 32 / BITS;
  constexpr unsigned kMask = (1u << BITS) - 1u;
  constexpr int kBias = 1 << (BITS - 1);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = (blockIdx.x * kWarps + warp) * kNb;
  const int row0 = blockIdx.y * kMr;
  const int rows = min(kMr, m - row0);
  const int wpr = k_pad / kVpw;

  const int32_t* wr[kNb];
  const float* sr[kNb];
  float s1[kNb];
  bool live[kNb];
#pragma unroll
  for (int nb = 0; nb < kNb; ++nb) {
    live[nb] = n0 + nb < n;
    const int nn = live[nb] ? n0 + nb : 0;
    wr[nb] = w + static_cast<size_t>(nn) * wpr;
    sr[nb] = scale + static_cast<size_t>(nn) * groups;
    s1[nb] = sr[nb][0];
  }
  float acc[kMr][kNb];
#pragma unroll
  for (int r = 0; r < kMr; ++r) {
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) acc[r][nb] = 0.f;
  }

  for (int j = lane; j < wpr; j += 32) {
    unsigned wd[kNb];
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
      wd[nb] = static_cast<unsigned>(__ldg(wr[nb] + j));
    }
    const int k0 = j * kVpw;
#pragma unroll
    for (int f4 = 0; f4 < kVpw / 4; ++f4) {
      float xv[kMr][4];
#pragma unroll
      for (int r = 0; r < kMr; ++r) {
        if (r < rows) {
          Io<T>::load4(x + static_cast<size_t>(row0 + r) * k_pad + k0 +
                           4 * f4, xv[r]);
        } else {
          xv[r][0] = xv[r][1] = xv[r][2] = xv[r][3] = 0.f;
        }
      }
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) {
        float s = s1[nb];
        if (GROUPED) {
          const int g = min((k0 + 4 * f4) / gs, groups - 1);
          s = __ldg(sr[nb] + g);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int code =
              static_cast<int>((wd[nb] >> (BITS * (4 * f4 + i))) & kMask) -
              kBias;
          const float wf = static_cast<float>(code) * s;  // dequant, fp32
#pragma unroll
          for (int r = 0; r < kMr; ++r) {
            acc[r][nb] = fmaf(xv[r][i], wf, acc[r][nb]);
          }
        }
      }
    }
  }

  // butterfly: every lane ends with all kMr * kNb sums; lane l writes sum l
#pragma unroll
  for (int r = 0; r < kMr; ++r) {
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
      float v = acc[r][nb];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
      }
      if (lane == r * kNb + nb && r < rows && live[nb]) {
        Io<T>::store(out + static_cast<size_t>(row0 + r) * n + n0 + nb, v);
      }
    }
  }
}

static_assert(kMr * kNb == 32, "one lane writes each of a warp's sums");

template <typename T, int BITS>
int launch_bits(const void* x, const void* w, const void* scale, void* out,
                int m, int n, int k_pad, int gs, int groups,
                cudaStream_t st) {
  const dim3 grid((n + kWarps * kNb - 1) / (kWarps * kNb),
                  (m + kMr - 1) / kMr);
  const dim3 block(kWarps * 32);
  const T* xp = static_cast<const T*>(x);
  const int32_t* wp = static_cast<const int32_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  T* op = static_cast<T*>(out);
  if (groups > 1) {
    qmatmul_kernel<T, BITS, true><<<grid, block, 0, st>>>(
        xp, wp, sp, op, m, n, k_pad, gs, groups);
  } else {
    qmatmul_kernel<T, BITS, false><<<grid, block, 0, st>>>(
        xp, wp, sp, op, m, n, k_pad, gs, groups);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_type(const void* x, const void* w, const void* scale, void* out,
                int m, int n, int k_pad, int bits, int gs, int groups,
                cudaStream_t st) {
  switch (bits) {
    case 2: return launch_bits<T, 2>(x, w, scale, out, m, n, k_pad, gs,
                                     groups, st);
    case 4: return launch_bits<T, 4>(x, w, scale, out, m, n, k_pad, gs,
                                     groups, st);
    case 8: return launch_bits<T, 8>(x, w, scale, out, m, n, k_pad, gs,
                                     groups, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (x and out)
extern "C" int packed_qmatmul_launch(const void* x, const void* w,
                                     const void* scale, void* out, int m,
                                     int n, int k_pad, int bits, int gs,
                                     int groups, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_type<float>(x, w, scale, out, m, n, k_pad, bits,
                                      gs, groups, st);
    case 1: return launch_type<__nv_bfloat16>(x, w, scale, out, m, n, k_pad,
                                              bits, gs, groups, st);
    case 2: return launch_type<__half>(x, w, scale, out, m, n, k_pad, bits,
                                       gs, groups, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* packed_qmatmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
