// One-token GQA decode attention over a sub-word packed KV cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/kv_attention/kernel.py
// (quant_kv_decode_attention_pallas / _kv_attn_kernel).  For each batch
// row b and KV head kh, with its G query heads:
//     k_j = bf16(code_k[j] * k_scale[j]),  v_j = bf16(code_v[j] * v_scale[j])
//     s_j = cap(scale * <bf16(q), k_j>)    for lo <= j < min(len_b, S)
//     o   = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-20)
// where lo = max(0, len_b - window) for a sliding window (0 = global),
// cap(s) = tanh(s / c) * c when a logit cap is set, and the codes are
// 2/4/8-bit offset-binary fields of int32 words along head_dim with one
// float32 scale per (position, head).  K and V are rounded to bfloat16
// after dequantization, as the reference's dequantize_kv does.
//
// What bounds it on the H100: each step reads the live part of the cache
// once (olmo-1b at INT4: 16 + 16 words per key and head, 8 B of scales)
// and does ~2 G * hd flops per key, far below the tensor-core rate, so it
// is bytes-bound.  The design:
//   * one block of 128 threads per (b, kv head); q's G x hd values sit in
//     shared memory (rounded to bfloat16 on the way in);
//   * keys are walked in tiles of 128, only over [lo, min(len, S)); in a
//     tile, thread t decodes key t's packed words in registers and forms
//     its G scores, the block reduces the tile's max and sum per head
//     (online softmax: running max m, running sum l, the accumulator
//     rescaled by exp(m_old - m_new)), and writes the probabilities to
//     shared memory;
//   * for the weighted sum, thread t owns dims t and t + 128 of every
//     query head and walks the tile's keys, decoding its V codes in
//     registers; neighbouring threads read neighbouring codes of one key,
//     so the V loads of a warp fall in one or two 32-byte sectors;
//   * the output is divided by max(l, 1e-20) and written in q's dtype.
// Splitting the keys of one (b, head) over several blocks (flash-decoding)
// is later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads per block = keys per tile
constexpr int kWarpsPB = kThreads / 32;
constexpr int kGMax = 8;       // query heads per KV head (GM <= kGMax)
constexpr int kHdMax = 256;    // head_dim
constexpr int kDpt = kHdMax / kThreads;  // dims per thread in the PV pass
constexpr float kNegInf = -2.0e38f;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// GM: the query heads per KV head this variant holds (1, 2 or 8), G <= GM
template <typename T, int BITS, int GM>
__global__ void __launch_bounds__(kThreads)
kv_attention_kernel(const T* __restrict__ q,          // (B, K, G, hd)
                    const int32_t* __restrict__ kp,   // (B, S, K, w)
                    const float* __restrict__ ks,     // (B, S, K)
                    const int32_t* __restrict__ vp,   // (B, S, K, w)
                    const float* __restrict__ vs,     // (B, S, K)
                    const int32_t* __restrict__ lens,  // (B,)
                    T* __restrict__ out,              // (B, K, G, hd)
                    int S, int K, int G, int hd, int window, int has_cap,
                    float scale, float cap) {
  constexpr int kVpw = 32 / BITS;
  constexpr unsigned kMask = (1u << BITS) - 1u;
  constexpr int kBias = 1 << (BITS - 1);
  __shared__ float q_s[GM][kHdMax];
  __shared__ float p_s[GM][kThreads];
  __shared__ float red[GM][kWarpsPB];

  const int b = blockIdx.x / K;
  const int kh = blockIdx.x % K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int w = (hd + kVpw - 1) / kVpw;   // packed words per (key, head)
  const size_t key_stride = static_cast<size_t>(K) * w;  // words
  const int32_t* kbase = kp + (static_cast<size_t>(b) * S * K + kh) * w;
  const int32_t* vbase = vp + (static_cast<size_t>(b) * S * K + kh) * w;
  const float* ksb = ks + static_cast<size_t>(b) * S * K + kh;
  const float* vsb = vs + static_cast<size_t>(b) * S * K + kh;

  const T* qb = q + (static_cast<size_t>(b) * K + kh) * G * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    q_s[i / hd][i % hd] = bf16_round(to_f32<T>(qb[i]));
  }
  const int len = lens[b];
  const int hi = min(len, S);
  const int lo = window > 0 ? max(0, len - window) : 0;

  float m_run[GM], l_run[GM], acc[GM][kDpt];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kDpt; ++i) acc[g][i] = 0.f;
  }
  __syncthreads();

  for (int j0 = lo; j0 < hi; j0 += kThreads) {
    const int n_keys = min(kThreads, hi - j0);
    // ---- scores: thread t takes key j0 + t -------------------------------
    float sc[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) sc[g] = 0.f;
    if (tid < n_keys) {
      const int j = j0 + tid;
      const int32_t* kw = kbase + static_cast<size_t>(j) * key_stride;
      const float kscale = ksb[static_cast<size_t>(j) * K];
      for (int c = 0; c < w; ++c) {
        const unsigned word = static_cast<unsigned>(kw[c]);
#pragma unroll
        for (int f = 0; f < kVpw; ++f) {
          const int d = c * kVpw + f;
          if (d < hd) {
            const int code =
                static_cast<int>((word >> (BITS * f)) & kMask) - kBias;
            const float kd = bf16_round(static_cast<float>(code) * kscale);
#pragma unroll
            for (int g = 0; g < GM; ++g) {
              if (g < G) sc[g] = fmaf(q_s[g][d], kd, sc[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float s = sc[g] * scale;
        if (has_cap) s = tanhf(s / cap) * cap;
        sc[g] = s;
      }
    } else {
#pragma unroll
      for (int g = 0; g < GM; ++g) sc[g] = kNegInf;
    }
    // ---- tile max per head -----------------------------------------------
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        float v = sc[g];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
        }
        if (lane == 0) red[g][warp] = v;
      }
    }
    __syncthreads();
    float m_new[GM], corr[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mt = kNegInf;
      if (g < G) {
#pragma unroll
        for (int i = 0; i < kWarpsPB; ++i) mt = fmaxf(mt, red[g][i]);
      }
      m_new[g] = fmaxf(m_run[g], mt);
      corr[g] = m_run[g] <= kNegInf / 2 ? 0.f : expf(m_run[g] - m_new[g]);
    }
    __syncthreads();                           // red is reused for sums
    // ---- probabilities and tile sums -------------------------------------
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        const float p = tid < n_keys ? expf(sc[g] - m_new[g]) : 0.f;
        p_s[g][tid] = p;
        float v = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v += __shfl_xor_sync(0xffffffffu, v, off);
        }
        if (lane == 0) red[g][warp] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g < G) {
        float st = 0.f;
#pragma unroll
        for (int i = 0; i < kWarpsPB; ++i) st += red[g][i];
        l_run[g] = l_run[g] * corr[g] + st;
        m_run[g] = m_new[g];
#pragma unroll
        for (int i = 0; i < kDpt; ++i) acc[g][i] *= corr[g];
      }
    }
    // ---- weighted sum of V: thread t owns dims t, t + 128 -----------------
    for (int jj = 0; jj < n_keys; ++jj) {
      const int j = j0 + jj;
      const int32_t* vw = vbase + static_cast<size_t>(j) * key_stride;
      const float vscale = vsb[static_cast<size_t>(j) * K];
#pragma unroll
      for (int i = 0; i < kDpt; ++i) {
        const int d = tid + i * kThreads;
        if (d < hd) {
          const unsigned word = static_cast<unsigned>(vw[d / kVpw]);
          const int code = static_cast<int>(
              (word >> (BITS * (d % kVpw))) & kMask) - kBias;
          const float vd = bf16_round(static_cast<float>(code) * vscale);
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            if (g < G) acc[g][i] = fmaf(p_s[g][jj], vd, acc[g][i]);
          }
        }
      }
    }
    __syncthreads();                           // p_s and red reused
  }

  T* ob = out + (static_cast<size_t>(b) * K + kh) * G * hd;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (g < G) {
      const float inv = 1.f / fmaxf(l_run[g], 1e-20f);
#pragma unroll
      for (int i = 0; i < kDpt; ++i) {
        const int d = tid + i * kThreads;
        if (d < hd) ob[g * hd + d] = from_f32<T>(acc[g][i] * inv);
      }
    }
  }
}

template <typename T>
int launch_type(const void* q, const void* kp, const void* ks,
                const void* vp, const void* vs, const void* lens, void* out,
                int B, int S, int K, int G, int hd, int bits, int window,
                int has_cap, float scale, float cap, cudaStream_t st) {
  const dim3 grid(B * K);
  const dim3 block(kThreads);
  const T* qq = static_cast<const T*>(q);
  const int32_t* kk = static_cast<const int32_t*>(kp);
  const float* kss = static_cast<const float*>(ks);
  const int32_t* vv = static_cast<const int32_t*>(vp);
  const float* vss = static_cast<const float*>(vs);
  const int32_t* ll = static_cast<const int32_t*>(lens);
  T* oo = static_cast<T*>(out);
#define KV_LAUNCH(B_, G_)                                                  \
  kv_attention_kernel<T, B_, G_><<<grid, block, 0, st>>>(                  \
      qq, kk, kss, vv, vss, ll, oo, S, K, G, hd, window, has_cap, scale, cap)
#define KV_LAUNCH_G(B_)                                                    \
  if (G <= 1) { KV_LAUNCH(B_, 1); } else if (G <= 2) { KV_LAUNCH(B_, 2); } \
  else { KV_LAUNCH(B_, 8); }
  switch (bits) {
    case 2: KV_LAUNCH_G(2); break;
    case 4: KV_LAUNCH_G(4); break;
    case 8: KV_LAUNCH_G(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef KV_LAUNCH_G
#undef KV_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (q and out)
extern "C" int kv_attention_launch(const void* q, const void* kp,
                                   const void* ks, const void* vp,
                                   const void* vs, const void* lens,
                                   void* out, int B, int S, int K, int G,
                                   int hd, int bits, int window, int has_cap,
                                   float scale, float cap, int dtype,
                                   void* stream) {
  if (G > kGMax || hd > kHdMax || B * K < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_type<float>(q, kp, ks, vp, vs, lens, out, B, S, K,
                                      G, hd, bits, window, has_cap, scale,
                                      cap, st);
    case 1: return launch_type<__nv_bfloat16>(q, kp, ks, vp, vs, lens, out,
                                              B, S, K, G, hd, bits, window,
                                              has_cap, scale, cap, st);
    case 2: return launch_type<__half>(q, kp, ks, vp, vs, lens, out, B, S, K,
                                       G, hd, bits, window, has_cap, scale,
                                       cap, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* kv_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
