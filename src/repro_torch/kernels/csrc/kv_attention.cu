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
// is bytes-bound (2.9 us for olmo-1b's 8 x 16 heads x 544 keys).  What
// keeps a kernel from that is latency: one block walking 544 keys with a
// dependent load per key takes ~270 us.  The design splits the keys and
// issues every load at once:
//   * one thread-block cluster of 2-8 blocks per (b, kv head) (ops.py,
//     _split: as many as keep the grid to 2 blocks of 8 warps per SM);
//     block r takes the r-th contiguous share of the live keys [lo, hi);
//   * a block copies its keys' packed K and V words and scales into shared
//     memory with cp.async (16-byte copies where the head's words allow),
//     all in flight together, in tiles of up to kTile keys;
//   * codes of at most 4 bits are dequantized through a per-key table of
//     the 2^bits bf16-rounded values, built once per tile;
//   * scores: a team of TS lanes (TS = the head's words / 4 rounded up to
//     a power of two) takes one key, each lane 4 consecutive words (one
//     16-byte shared-memory read); q sits in shared memory as
//     bf16-rounded float32, laid out [g][field][word]; four partial sums
//     per lane and a shuffle reduction finish each of the G dot products;
//   * the block's softmax is online over its tiles (running max m, sum l,
//     the accumulators rescaled by exp(m_old - m_new));
//   * P.V: warp w takes keys w, w + 8, ..., lane l dims l, l + 32, ... of
//     every query head, reading V words, values and probabilities from
//     shared memory; the warps' sums are added in order at the end;
//   * each block leaves (m, l, acc[G][hd]) in shared memory; block 0 of
//     the cluster merges the partials through distributed shared memory
//     (an empty split has m = -inf and l = 0 and weighs 0), divides by
//     max(l, 1e-20) and writes the output in q's dtype.  One launch, no
//     scratch in device memory.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // threads per block
constexpr int kWarpsPB = kThreads / 32;
constexpr int kSplitMax = 8;   // blocks per cluster: key splits
constexpr int kTile = 144;     // keys per shared-memory tile
constexpr int kGMax = 8;       // query heads per KV head (G <= GM <= kGMax)
constexpr int kHdMax = 256;    // head_dim
constexpr int kWMax = kHdMax * 8 / 32;   // words per (key, head), 8-bit
constexpr int kQMax = kHdMax + 16;       // q floats per head, word-padded
constexpr int kDpl = kHdMax / 32;        // dims per lane in P.V
constexpr float kNegInf = -2.0e38f;
// dynamic shared memory: K and V words, scales and (codes of at most 4
// bits) the dequantized values of each key of one tile, and the tile's
// scores / probabilities for each query head
__host__ __device__ constexpr int dyn_bytes(int w, int levels, int gm) {
  return (2 * (w + 1 + (levels ? levels + 1 : 0)) + gm) * kTile * 4;
}
constexpr int kDynMax = dyn_bytes(kWMax, 0, kGMax) > dyn_bytes(32, 16, kGMax)
                            ? dyn_bytes(kWMax, 0, kGMax)
                            : dyn_bytes(32, 16, kGMax);
static_assert(kDynMax >= kWarpsPB * kGMax * kHdMax * 4,
              "the warps' accumulators fit in the tile's shared memory");

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

// v rounded to the nearest bfloat16 (ties to even), for finite v, in
// integer ops (the conversion instructions issue at a quarter rate)
__device__ __forceinline__ float bf16_round(float v) {
  unsigned u = __float_as_uint(v);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}

// unsigned field u (< 2^23) minus the offset-binary bias, exactly, with no
// int-to-float conversion: 2^23 + u is a float whose low bits are u
template <int BITS>
__device__ __forceinline__ float field_code(unsigned u) {
  return __uint_as_float(0x4B000000u | u) - (8388608.f + (1 << (BITS - 1)));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

template <typename K>
cudaError_t set_smem_attrs(K kern, int dyn) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
}

// GM: the query heads per KV head this variant holds (1, 2, 4 or 8)
template <typename T, int BITS, int GM>
__global__ void __launch_bounds__(kThreads, 2)
kv_attention_kernel(const T* __restrict__ q,          // (B, K, G, hd)
                    const int32_t* __restrict__ kp,   // (B, S, K, w)
                    const float* __restrict__ ks,     // (B, S, K)
                    const int32_t* __restrict__ vp,   // (B, S, K, w)
                    const float* __restrict__ vs,     // (B, S, K)
                    const int32_t* __restrict__ lens,  // (B,)
                    T* __restrict__ out,              // (B, K, G, hd)
                    int S, int K, int G, int hd, int window, int has_cap,
                    float scale, float cap, int vec16) {
  constexpr int kVpw = 32 / BITS;
  constexpr unsigned kMask = (1u << BITS) - 1u;
  // codes of at most 4 bits read each key's values from a table of its
  // 2^bits bf16-rounded dequantized values (one shared-memory read a dim
  // instead of the dequantize-and-round arithmetic)
  constexpr bool kLut = BITS <= 4;
  constexpr int kLevels = kLut ? 1 << BITS : 1;
  constexpr int kLs = kLevels + 1;        // odd table stride: keys of one
                                          // warp start on different banks
  extern __shared__ __align__(16) int32_t dyn[];
  __shared__ __align__(16) float q_s[GM * kQMax];  // [g][field][word]
  __shared__ float red[GM][kWarpsPB];
  __shared__ float part_m[GM], part_l[GM];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int bh = blockIdx.x / n_split;
  const int b = bh / K;
  const int kh = bh % K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int w = (hd + kVpw - 1) / kVpw;   // packed words per (key, head)
  int32_t* ksm = dyn;                     // [kTile][w]
  int32_t* vsm = ksm + kTile * w;         // [kTile][w]
  float* kss = reinterpret_cast<float*>(vsm + kTile * w);  // [kTile]
  float* vss = kss + kTile;                                // [kTile]
  float* klut = vss + kTile;              // [kTile][kLevels]
  float* vlut = klut + (kLut ? kTile * kLs : 0);
  float (*p_s)[kTile] = reinterpret_cast<float (*)[kTile]>(
      vlut + (kLut ? kTile * kLs : 0));

  // q rounded to bf16, dim d = c * kVpw + f at [g][f][c]; zero past hd
  const T* qb = q + static_cast<size_t>(bh) * G * hd;
  for (int i = tid; i < G * kVpw * w; i += kThreads) {
    const int g = i / (kVpw * w);
    const int f = (i / w) % kVpw;
    const int c = i % w;
    const int d = c * kVpw + f;
    q_s[i] = d < hd ? bf16_round(to_f32<T>(qb[g * hd + d])) : 0.f;
  }

  const int len = lens[b];
  const int hi = min(len, S);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int live = max(0, hi - lo);
  const int per = (live + n_split - 1) / n_split;
  const int j_lo = lo + min(live, rank * per);
  const int j_hi = lo + min(live, (rank + 1) * per);

  // lanes in teams of ts, one key per team, 4 consecutive words a lane
  const int wq = (w + 3) / 4;
  int ts = 1;
  while (ts < wq) ts <<= 1;
  const int kpw = 32 / ts;                // keys per warp step
  const int team_key = lane / ts;
  const int c0 = 4 * (lane % ts);
  const int vshift = BITS * (lane % kVpw);  // lane's field in a V word

  float m_run[GM], l_run[GM], acc[GM][kDpl];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m_run[g] = kNegInf;
    l_run[g] = 0.f;
#pragma unroll
    for (int i = 0; i < kDpl; ++i) acc[g][i] = 0.f;
  }

  const size_t row_words = static_cast<size_t>(K) * w;   // key stride
  const size_t head0 = (static_cast<size_t>(b) * S) * K + kh;
  for (int j0 = j_lo; j0 < j_hi; j0 += kTile) {
    const int nk = min(kTile, j_hi - j0);
    __syncthreads();                      // the last tile is consumed
    // ---- every copy of the tile in flight at once -------------------------
    const int32_t* kg = kp + (head0 + static_cast<size_t>(j0) * K) * w;
    const int32_t* vg = vp + (head0 + static_cast<size_t>(j0) * K) * w;
    if (vec16) {                          // w % 4 == 0, 16-byte aligned
      const int cpk = w / 4;
      for (int i = tid; i < nk * cpk; i += kThreads) {
        const int jj = i / cpk, c = (i % cpk) * 4;
        const size_t src = jj * row_words + c;
        cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(
                       ksm + jj * w + c)), kg + src);
        cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(
                       vsm + jj * w + c)), vg + src);
      }
    } else {
      for (int i = tid; i < nk * w; i += kThreads) {
        const int jj = i / w, c = i % w;
        const size_t src = jj * row_words + c;
        cp_async4(static_cast<uint32_t>(__cvta_generic_to_shared(
                      ksm + jj * w + c)), kg + src);
        cp_async4(static_cast<uint32_t>(__cvta_generic_to_shared(
                      vsm + jj * w + c)), vg + src);
      }
    }
    for (int jj = tid; jj < nk; jj += kThreads) {
      const size_t si = head0 + static_cast<size_t>(j0 + jj) * K;
      cp_async4(static_cast<uint32_t>(__cvta_generic_to_shared(kss + jj)),
                ks + si);
      cp_async4(static_cast<uint32_t>(__cvta_generic_to_shared(vss + jj)),
                vs + si);
    }
    cp_async_wait_all();
    __syncthreads();
    if (kLut) {
      for (int i = tid; i < nk * kLevels; i += kThreads) {
        const int jj = i / kLevels, e = i % kLevels;
        const float c = field_code<BITS>(e);
        klut[jj * kLs + e] = bf16_round(c * kss[jj]);
        vlut[jj * kLs + e] = bf16_round(c * vss[jj]);
      }
      __syncthreads();
    }

    // ---- scores: a team per key, lanes over its words ----------------------
    for (int kb = warp * kpw; kb < nk; kb += kWarpsPB * kpw) {
      const int jj = kb + team_key;
      const bool ok = jj < nk;
      float sc[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) sc[g] = 0.f;
      if (ok && c0 < w) {
        const float kscale = kss[jj];
        const float* krow = klut + jj * kLs;
        unsigned wd[4];
        if (vec16) {                      // w % 4 == 0
          const uint4 t = *reinterpret_cast<const uint4*>(ksm + jj * w + c0);
          wd[0] = t.x; wd[1] = t.y; wd[2] = t.z; wd[3] = t.w;
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            wd[u] = c0 + u < w ? static_cast<unsigned>(ksm[jj * w + c0 + u])
                               : 0u;
          }
        }
        // the lane's 4 * kVpw key values first, then independent sums
        // per word, so the table reads overlap and the FMA chains are short
        float kd[4][kVpw];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int f = 0; f < kVpw; ++f) {
            const unsigned e = (wd[u] >> (BITS * f)) & kMask;
            kd[u][f] =
                kLut ? krow[e] : bf16_round(field_code<BITS>(e) * kscale);
          }
        }
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g >= G) continue;
          float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int f = 0; f < kVpw; ++f) {
            // q of dims (c0 + u) * kVpw + f, u < 4; zero past the words
            const float* qf = q_s + (g * kVpw + f) * w + c0;
            float qv[4];
            if (vec16) {
              const float4 t = *reinterpret_cast<const float4*>(qf);
              qv[0] = t.x; qv[1] = t.y; qv[2] = t.z; qv[3] = t.w;
            } else {
#pragma unroll
              for (int u = 0; u < 4; ++u) qv[u] = c0 + u < w ? qf[u] : 0.f;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              part[u] = fmaf(qv[u], kd[u][f], part[u]);
            }
          }
          sc[g] = (part[0] + part[1]) + (part[2] + part[3]);
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        for (int off = ts >> 1; off > 0; off >>= 1) {
          sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], off);
        }
      }
      if (ok && c0 == 0) {
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            float s = sc[g] * scale;
            if (has_cap) s = tanhf(s / cap) * cap;
            p_s[g][jj] = s;
          }
        }
      }
    }
    __syncthreads();

    // ---- online softmax over the tile: thread t holds keys t, t + 256, ... -
    constexpr int kKpt = (kTile + kThreads - 1) / kThreads;
    float sv[kKpt][GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float v = kNegInf;
#pragma unroll
      for (int h = 0; h < kKpt; ++h) {
        const int jj = tid + h * kThreads;
        sv[h][g] = jj < nk && g < G ? p_s[g][jj] : kNegInf;
        v = fmaxf(v, sv[h][g]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
      }
      if (lane == 0) red[g][warp] = v;
    }
    __syncthreads();
    float m_new[GM], corr[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mt = kNegInf;
#pragma unroll
      for (int i = 0; i < kWarpsPB; ++i) mt = fmaxf(mt, red[g][i]);
      m_new[g] = fmaxf(m_run[g], mt);
      corr[g] = m_run[g] <= kNegInf / 2 ? 0.f : expf(m_run[g] - m_new[g]);
    }
    __syncthreads();                      // red is reused for the sums
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float v = 0.f;
#pragma unroll
      for (int h = 0; h < kKpt; ++h) {
        const int jj = tid + h * kThreads;
        const float p = jj < nk && g < G ? expf(sv[h][g] - m_new[g]) : 0.f;
        if (g < G && jj < kTile) p_s[g][jj] = p;
        v += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
      }
      if (lane == 0) red[g][warp] = v;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float st = 0.f;
#pragma unroll
      for (int i = 0; i < kWarpsPB; ++i) st += red[g][i];
      l_run[g] = l_run[g] * corr[g] + st;
      m_run[g] = m_new[g];
#pragma unroll
      for (int i = 0; i < kDpl; ++i) acc[g][i] *= corr[g];
    }

    // ---- P.V from shared memory: warp w takes keys w, w + 8, ..., lane l
    // dims l, l + 32, ...; the warps' sums meet at the end ------------------
#pragma unroll 4
    for (int jj = warp; jj < nk; jj += kWarpsPB) {
      const int32_t* vrow = vsm + jj * w + lane / kVpw;
      const float* vtab = vlut + jj * kLs;
      const float vscale = vss[jj];
      float p[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) p[g] = g < G ? p_s[g][jj] : 0.f;
#pragma unroll
      for (int i = 0; i < kDpl; ++i) {
        if (lane + i * 32 < hd) {
          const unsigned e =
              (static_cast<unsigned>(vrow[i * 32 / kVpw]) >> vshift) & kMask;
          const float vd =
              kLut ? vtab[e] : bf16_round(field_code<BITS>(e) * vscale);
#pragma unroll
          for (int g = 0; g < GM; ++g) acc[g][i] = fmaf(p[g], vd, acc[g][i]);
        }
      }
    }
  }

  // ---- this block's partial, then block 0 merges the cluster's ------------
  // (the warps' accumulators [warp][g][d] reuse the tile's shared memory)
  __syncthreads();
  float* part_acc = reinterpret_cast<float*>(dyn);
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int i = 0; i < kDpl; ++i) {
      const int d = lane + i * 32;
      // slots g >= G of a rounded-up GM are not heads: (warp * G + g)
      // would land on the next warp's heads
      if (g < G && d < hd) part_acc[(warp * G + g) * hd + d] = acc[g][i];
    }
    if (tid == 0) {
      part_m[g] = m_run[g];
      part_l[g] = l_run[g];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += kThreads) {   // the warps' sum, in order
    float v = part_acc[i];
#pragma unroll
    for (int q = 1; q < kWarpsPB; ++q) v += part_acc[q * G * hd + i];
    part_acc[i] = v;
  }
  cluster.sync();
  if (rank == 0) {
    T* ob = out + static_cast<size_t>(bh) * G * hd;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) continue;
      // an empty split left m = -inf, l = 0 and acc = 0: weight 0
      float mr[kSplitMax], lr[kSplitMax], mx = kNegInf;
#pragma unroll
      for (int r = 0; r < kSplitMax; ++r) {
        mr[r] = r < n_split ? *cluster.map_shared_rank(&part_m[g], r)
                            : kNegInf;
        lr[r] = r < n_split ? *cluster.map_shared_rank(&part_l[g], r) : 0.f;
        mx = fmaxf(mx, mr[r]);
      }
      float wr[kSplitMax], l = 0.f;
#pragma unroll
      for (int r = 0; r < kSplitMax; ++r) {
        wr[r] = mr[r] <= kNegInf / 2 ? 0.f : expf(mr[r] - mx);
        l = fmaf(wr[r], lr[r], l);
      }
      const float inv = 1.f / fmaxf(l, 1e-20f);
      for (int d = tid; d < hd; d += kThreads) {
        float o = 0.f;
#pragma unroll
        for (int r = 0; r < kSplitMax; ++r) {
          if (r < n_split) {
            o = fmaf(wr[r], cluster.map_shared_rank(part_acc, r)[g * hd + d],
                     o);
          }
        }
        ob[g * hd + d] = from_f32<T>(o * inv);
      }
    }
  }
  cluster.sync();                   // peers keep their partials until read
}

template <typename T, int BITS, int GM>
int launch_cfg(const T* q, const int32_t* kp, const float* ks,
               const int32_t* vp, const float* vs, const int32_t* lens,
               T* out, int B, int S, int K, int G, int hd, int window,
               int has_cap, float scale, float cap, int vec16, int n_split,
               cudaStream_t st) {
  auto kern = kv_attention_kernel<T, BITS, GM>;
  static const cudaError_t set = set_smem_attrs(kern, kDynMax);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int w = (hd * BITS + 31) / 32;
  // the tile's data, or after the last tile the warps' accumulators
  const int dyn = max(dyn_bytes(w, BITS <= 4 ? 1 << BITS : 0, GM),
                      kWarpsPB * G * hd * 4);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * K * n_split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kern, q, kp, ks, vp, vs, lens, out, S, K, G, hd, window, has_cap,
      scale, cap, vec16));
}

template <typename T>
int launch_type(const void* q, const void* kp, const void* ks,
                const void* vp, const void* vs, const void* lens, void* out,
                int B, int S, int K, int G, int hd, int bits, int window,
                int has_cap, float scale, float cap, int vec16, int n_split,
                cudaStream_t st) {
  const T* qq = static_cast<const T*>(q);
  const int32_t* kk = static_cast<const int32_t*>(kp);
  const float* kss = static_cast<const float*>(ks);
  const int32_t* vv = static_cast<const int32_t*>(vp);
  const float* vss = static_cast<const float*>(vs);
  const int32_t* ll = static_cast<const int32_t*>(lens);
  T* oo = static_cast<T*>(out);
#define KV_LAUNCH(B_, G_)                                                  \
  return launch_cfg<T, B_, G_>(qq, kk, kss, vv, vss, ll, oo, B, S, K, G,  \
                               hd, window, has_cap, scale, cap, vec16,     \
                               n_split, st)
#define KV_LAUNCH_G(B_)                                                    \
  if (G <= 1) { KV_LAUNCH(B_, 1); } else if (G <= 2) { KV_LAUNCH(B_, 2); } \
  else if (G <= 4) { KV_LAUNCH(B_, 4); } else { KV_LAUNCH(B_, 8); }
  switch (bits) {
    case 2: KV_LAUNCH_G(2); break;
    case 4: KV_LAUNCH_G(4); break;
    case 8: KV_LAUNCH_G(8); break;
    default: break;
  }
#undef KV_LAUNCH_G
#undef KV_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (q and out).  vec16: the cache
// rows allow 16-byte copies (words per head a multiple of 4, 16-byte
// aligned bases).
extern "C" int kv_attention_launch(const void* q, const void* kp,
                                   const void* ks, const void* vp,
                                   const void* vs, const void* lens,
                                   void* out, int B, int S, int K, int G,
                                   int hd, int bits, int window, int has_cap,
                                   float scale, float cap, int dtype,
                                   int vec16, int n_split, void* stream) {
  if (G > kGMax || hd > kHdMax || B * K < 1 || n_split < 1 ||
      n_split > kSplitMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_type<float>(q, kp, ks, vp, vs, lens, out, B, S, K,
                                      G, hd, bits, window, has_cap, scale,
                                      cap, vec16, n_split, st);
    case 1: return launch_type<__nv_bfloat16>(q, kp, ks, vp, vs, lens, out,
                                              B, S, K, G, hd, bits, window,
                                              has_cap, scale, cap, vec16,
                                              n_split, st);
    case 2: return launch_type<__half>(q, kp, ks, vp, vs, lens, out, B, S, K,
                                       G, hd, bits, window, has_cap, scale,
                                       cap, vec16, n_split, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* kv_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
