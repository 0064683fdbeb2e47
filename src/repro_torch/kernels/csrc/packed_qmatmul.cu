// Packed low-bit weight matmul with in-kernel dequantization, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/packed_qmatmul/kernel.py
// (qmatmul_pallas / _qmatmul_kernel):
//     y[m, n] = sum_k x[m, k] * (scale[n, g(k)] * Wq[n, k])
// with Wq signed 2/4/8-bit codes in offset-binary fields of int32 words,
// one float32 scale per (row, group) (group_size = -1: one per row),
// float32 accumulation and one rounding to x's dtype at the end.
//
// Two variants; the wrapper (kernels/packed_qmatmul/ops.py, _variant)
// picks one by shape:
//
// * "mma", for M >= 64 with bf16/fp16 x and one scale per row or groups
//   that are multiples of the 64-wide K tile (every olmo-1b prefill).  At
//   M = 4096 a layer's linears are 550 GFLOP against 34 MB of packed
//   weights, so the bound is the tensor cores (0.56 ms a layer at 989
//   TFLOP/s).  The integer codes go to the tensor cores as bf16/fp16
//   values (-128..127 are exact in both) and the scale is applied in
//   float32 afterwards: per row in the epilogue, or per group by
//   total = fmaf(scale[n, g], partial, total) at each group boundary.
//   The products x * code are exact in float32, so this sums the same
//   values as the plain version in another order.  A block owns a
//   BM x BN output tile, one warpgroup (128 threads) per 64 rows: 128 x
//   256 (per-row scales only; the INT4-KV prefill's M = 4096) or 128 x
//   64 (olmo-1b's 2048 -> 8192 linears at M = 256), whichever is the
//   largest that still gives every SM a block, else 64 x 64 (ops.py,
//   _mma_tile):
//     - a ring in shared memory (4 stages, 8 for 64-wide tiles) of x
//       tiles (BM x 64, in the 128-byte swizzled K-major layout wgmma
//       reads) and raw packed word tiles (BN rows x 64 codes), filled by
//       TMA copies that thread 0 issues and that complete on one mbarrier
//       per stage, zeros past ragged M, N and K (rows of words that are
//       not 16-byte multiples come by 4-byte cp.async instead), so each
//       packed word is read from device memory once per BM rows of x;
//     - the block decodes the next tile's codes into a swizzled bf16/fp16
//       B tile (double-buffered) while the tensor cores work on this one;
//       4-bit codes by byte permutes and one packed subtraction per pair;
//     - each warpgroup issues wgmma.mma_async m64nBNk16 with both
//       operands in shared memory, four per K tile, accumulating in
//       float32 registers.
//   What limits it now (clock stamps of the main loop at M = 4096): the
//   decode of the next tile takes about twice the tensor cores' time for
//   this one, so they idle most of each K step (tools/kernel_probe.py).
// * "gemv", for M < 64 (decode, short prompts), float32 x, and any other
//   group size.  At M = 8 a layer is 34 MB of packed weights (10 us at
//   3.35 TB/s) against 0.54 G float32 FMAs (8 us at 67 TFLOP/s), so both
//   the memory system and the FMA pipes must be kept busy.  It keeps the
//   plain version's arithmetic: each code is dequantized in float32
//   (code * scale) and fmaf'd into 8 rows of x.
//     - a block owns 4 weight rows and 8 rows of x; its 1-8 warps split
//       the rows' packed words into contiguous shares (at least 4 words a
//       lane), lane l taking words l, l + 32, ... of its share, so each
//       warp load of a row is one 128-byte line and each warp load of x
//       (a word's columns) is contiguous;
//     - a lane requests all of its words for the 4 rows before using any
//       (one memory latency), streamed past L1, which keeps x: every
//       block of an SM reads the same 8 rows of x, each value serving the
//       4 weight rows;
//     - each warp's 32 sums are reduced and scattered in 31 shuffles and
//       the warps' added in order through shared memory.

#include <cuda.h>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

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

// two float32 values rounded to one packed 16-bit pair, low first
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// unsigned field u (< 2^23) minus the offset-binary bias, exactly, with no
// int-to-float conversion: 2^23 + u is a float whose low bits are u
template <int BITS>
__device__ __forceinline__ float field_code(unsigned u) {
  return __uint_as_float(0x4B000000u | u) - (8388608.f + (1 << (BITS - 1)));
}

// ---------------------------------------------------------------------------
// gemv variant
// ---------------------------------------------------------------------------

constexpr int kGvRows = 4;                   // weight rows per block
constexpr int kGvMt = 8;                     // rows of x per block
constexpr int kGvPasses = 4;                 // word passes loaded at once
constexpr int kGvWarpsMax = 8;               // warps per block (K split)

template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&o)[4]);
template <>
__device__ __forceinline__ void load4<float>(const float* p, float (&o)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
template <>
__device__ __forceinline__ void load4<__nv_bfloat16>(const __nv_bfloat16* p,
                                                     float (&o)[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  o[0] = __uint_as_float(v.x << 16);
  o[1] = __uint_as_float(v.x & 0xFFFF0000u);
  o[2] = __uint_as_float(v.y << 16);
  o[3] = __uint_as_float(v.y & 0xFFFF0000u);
}
template <>
__device__ __forceinline__ void load4<__half>(const __half* p,
                                              float (&o)[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&v.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&v.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// the 32 values v[i] summed over the warp's lanes, lane l returning sum l:
// at each step a lane keeps the half of its values its lane bit selects
// and adds its partner's copy of that half
__device__ __forceinline__ float warp_reduce_scatter(const float (&a)[8][4]) {
  float v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) v[i] = a[i / 4][i % 4];
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    const bool up = lane & s;
#pragma unroll
    for (int i = 0; i < s; ++i) {
      const float send = up ? v[i] : v[i + s];
      const float keep = up ? v[i + s] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, s);
    }
  }
  return v[0];
}

// one packed word, read once: streamed past L1, which keeps the rows of x
__device__ __forceinline__ unsigned load_word(const int32_t* p) {
  unsigned v;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// A block owns kGvRows weight rows and 8 rows of x; its 1-8 warps take
// contiguous shares of the rows' packed words, lane l words l, l + 32, ...
// of its share, so each warp load of a row's words is one 128-byte line
// and each warp load of x (the word's columns, 8 rows) is contiguous.  A
// lane's words for the 4 rows are all requested up front (up to 4 passes);
// x is read through L1 (every block of an SM reads the same 8 rows) and
// each value serves the 4 rows.
template <typename T, int BITS, bool GROUPED>
__global__ void __launch_bounds__(kGvWarpsMax * 32)
qmatmul_gemv_kernel(const T* __restrict__ x,          // (m, k_pad)
                    const int32_t* __restrict__ w,    // (n, wpr)
                    const float* __restrict__ scale,  // (n, groups)
                    T* __restrict__ out,              // (m, n)
                    int m, int n, int k_pad, int gs, int groups) {
  constexpr int kVpw = 32 / BITS;
  constexpr unsigned kMask = (1u << BITS) - 1u;
  __shared__ float red[kGvWarpsMax][kGvMt * kGvRows];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n0 = blockIdx.x * kGvRows;
  const int row0 = blockIdx.y * kGvMt;
  const int rows = min(kGvMt, m - row0);
  const int wpr = k_pad / kVpw;
  const int per = (wpr + n_warps - 1) / n_warps;
  const int j_hi = min(wpr, (warp + 1) * per);

  const int32_t* wr[kGvRows];
  const float* sr[kGvRows];
  float s1[kGvRows];
#pragma unroll
  for (int rr = 0; rr < kGvRows; ++rr) {
    const int nn = min(n0 + rr, n - 1);         // dead rows read row n-1
    wr[rr] = w + static_cast<size_t>(nn) * wpr;
    sr[rr] = scale + static_cast<size_t>(nn) * groups;
    s1[rr] = __ldg(sr[rr]);
  }
  const T* xr[kGvMt];
#pragma unroll
  for (int r = 0; r < kGvMt; ++r) {
    xr[r] = x + static_cast<size_t>(row0 + min(r, rows - 1)) * k_pad;
  }
  float acc[kGvMt][kGvRows];
#pragma unroll
  for (int r = 0; r < kGvMt; ++r) {
#pragma unroll
    for (int rr = 0; rr < kGvRows; ++rr) acc[r][rr] = 0.f;
  }

  // the lane's words of the 4 rows for up to kGvPasses passes are all
  // requested before any is used: one memory latency per group of passes
  for (int j0 = warp * per + lane; j0 < j_hi; j0 += 32 * kGvPasses) {
    unsigned wd[kGvPasses][kGvRows];
#pragma unroll
    for (int p = 0; p < kGvPasses; ++p) {
#pragma unroll
      for (int rr = 0; rr < kGvRows; ++rr) {
        wd[p][rr] = j0 + 32 * p < j_hi ? load_word(wr[rr] + j0 + 32 * p) : 0u;
      }
    }
#pragma unroll
    for (int p = 0; p < kGvPasses; ++p) {
      const int j = j0 + 32 * p;
      if (j >= j_hi) break;
#pragma unroll
      for (int f4 = 0; f4 < kVpw / 4; ++f4) {
        const int k0 = j * kVpw + 4 * f4;
        float xv[kGvMt][4];
#pragma unroll
        for (int r = 0; r < kGvMt; ++r) load4<T>(xr[r] + k0, xv[r]);
#pragma unroll
        for (int rr = 0; rr < kGvRows; ++rr) {
          float s = s1[rr];
          if (GROUPED) s = __ldg(sr[rr] + min(k0 / gs, groups - 1));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float code = field_code<BITS>(
                (wd[p][rr] >> (BITS * (4 * f4 + i))) & kMask);
            const float wf = code * s;          // dequant, fp32
#pragma unroll
            for (int r = 0; r < kGvMt; ++r) {
              acc[r][rr] = fmaf(xv[r][i], wf, acc[r][rr]);
            }
          }
        }
      }
    }
  }

  // each warp's 32 sums, reduced and scattered in 31 shuffles (lane l
  // ends with sum l), then the warps' added in order
  red[warp][lane] = warp_reduce_scatter(acc);
  __syncthreads();
  if (tid < kGvMt * kGvRows) {
    const int r = tid / kGvRows, rr = tid % kGvRows;
    float v = red[0][tid];
#pragma unroll
    for (int q = 1; q < n_warps; ++q) v += red[q][tid];
    if (r < rows && n0 + rr < n) {
      out[static_cast<size_t>(row0 + r) * n + n0 + rr] = from_f32<T>(v);
    }
  }
}

static_assert(kGvMt * kGvRows == 32, "one lane keeps each of a warp's sums");

template <typename T, int BITS, bool GROUPED>
int launch_gemv(const T* x, const int32_t* w, const float* scale, T* out,
                int m, int n, int k_pad, int gs, int groups,
                cudaStream_t st) {
  const int wpr = k_pad / (32 / BITS);
  const dim3 grid((n + kGvRows - 1) / kGvRows, (m + kGvMt - 1) / kGvMt);
  // the most warps (up to 8) that still give each lane 4 words of a row
  int warps = kGvWarpsMax;
  while (warps > 1 && wpr < warps * 128) warps >>= 1;
  qmatmul_gemv_kernel<T, BITS, GROUPED><<<grid, warps * 32, 0, st>>>(
      x, w, scale, out, m, n, k_pad, gs, groups);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// mma variant
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t set_smem_attrs(K kern, int dyn) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
}


constexpr int kMmBk = 64;                    // K tile: one 128-byte row

// cp.async ring depth: deeper for the 64-wide tiles of small grids, where
// few blocks must cover the memory latency alone
__host__ __device__ constexpr int mma_stages(int bn) {
  return bn == 64 ? 8 : 4;
}

// x ring, decoded B double buffer, packed word ring, alignment slack
__host__ __device__ constexpr int mma_smem(int bm, int bn, int bits) {
  return mma_stages(bn) * (bm * kMmBk * 2 + bn * kMmBk * bits / 8) +
         2 * bn * kMmBk * 2 + 1024;
}

// 8 codes (unsigned fields f of their word) as 16-bit values, packed in
// pairs, low first
template <typename T, int BITS>
__device__ __forceinline__ uint4 decode8(const unsigned (&f)[8]) {
  constexpr bool kMagic16 =
      BITS <= 4 || std::is_same<T, __half>::value;
  uint4 o;
  if constexpr (kMagic16) {
    // base + u is exact in the type's mantissa (bf16: 128 + u, u < 128;
    // fp16: 1024 + u, u < 1024); one packed subtraction of base + bias
    // leaves the code
    constexpr unsigned kBase = std::is_same<T, __half>::value ? 0x6400u
                                                              : 0x4300u;
    constexpr unsigned kSub = kBase + (1u << (BITS - 1));
    const unsigned sub = kSub | (kSub << 16);
    unsigned p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = (f[2 * i] | (f[2 * i + 1] << 16)) | (kBase | (kBase << 16));
    }
    if constexpr (std::is_same<T, __half>::value) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __half2 v = __hsub2(*reinterpret_cast<const __half2*>(&p[i]),
                                  *reinterpret_cast<const __half2*>(&sub));
        p[i] = *reinterpret_cast<const unsigned*>(&v);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 v =
            __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&p[i]),
                    *reinterpret_cast<const __nv_bfloat162*>(&sub));
        p[i] = *reinterpret_cast<const unsigned*>(&v);
      }
    }
    o.x = p[0]; o.y = p[1]; o.z = p[2]; o.w = p[3];
  } else {                                      // 8-bit codes in bf16
    o.x = pack2<T>(field_code<BITS>(f[0]), field_code<BITS>(f[1]));
    o.y = pack2<T>(field_code<BITS>(f[2]), field_code<BITS>(f[3]));
    o.z = pack2<T>(field_code<BITS>(f[4]), field_code<BITS>(f[5]));
    o.w = pack2<T>(field_code<BITS>(f[6]), field_code<BITS>(f[7]));
  }
  return o;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// generic-proxy writes to shared memory, made visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// the one arrival of a phase, announcing the bytes its copies will bring
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra WAIT;\nDONE:\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// one TMA copy of the 2-d box at (c0 innermost, c1) into shared memory,
// completing on the mbarrier; out-of-bounds elements arrive as zeros
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

// keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) asm volatile("" : "+f"(d[j]) :: "memory");
}

// shared-memory matrix descriptor of a K-major tile in the 128-byte
// swizzle: rows of 64 16-bit values (128 B), 8-row atoms 1024 B apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(1) << 16) |           // LBO (unused)
         (static_cast<uint64_t>(1024 >> 4) << 32) |   // SBO
         (static_cast<uint64_t>(1) << 62);            // 128-byte swizzle
}

// byte offset of 16-byte chunk c (0..7) of row r in a swizzled tile
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// the 8 4-bit codes of one word as 16-bit values, packed in pairs: the
// even and odd fields are split into bytes, each pair gathered by one byte
// permute into the low bits of its two halves, offset by the base and
// re-centred by one packed subtraction (see decode8)
template <typename T>
__device__ __forceinline__ uint4 decode_word4(unsigned v) {
  constexpr unsigned kBase = std::is_same<T, __half>::value ? 0x6400u
                                                            : 0x4300u;
  constexpr unsigned kSub = kBase + 8u;
  const unsigned sub = kSub | (kSub << 16);
  const unsigned ev = v & 0x0F0F0F0Fu;          // fields 0, 2, 4, 6
  const unsigned od = (v >> 4) & 0x0F0F0F0Fu;   // fields 1, 3, 5, 7
  unsigned p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned sel = i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12);
    p[i] = (__byte_perm(ev, od, sel) & 0x000F000Fu) | (kBase | (kBase << 16));
    if constexpr (std::is_same<T, __half>::value) {
      const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&p[i]),
                                *reinterpret_cast<const __half2*>(&sub));
      p[i] = *reinterpret_cast<const unsigned*>(&h);
    } else {
      const __nv_bfloat162 h =
          __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&p[i]),
                  *reinterpret_cast<const __nv_bfloat162*>(&sub));
      p[i] = *reinterpret_cast<const unsigned*>(&h);
    }
  }
  return make_uint4(p[0], p[1], p[2], p[3]);
}

template <typename T, int BN>
struct Wgmma;

template <>
struct Wgmma<__nv_bfloat16, 64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1)
        : "memory");
  }
};

template <>
struct Wgmma<__half, 64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1)
        : "memory");
  }
};

template <>
struct Wgmma<__nv_bfloat16, 256> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
          "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
          "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1)
        : "memory");
  }
};

template <>
struct Wgmma<__half, 256> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
          "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
          "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(1)
        : "memory");
  }
};

// BM rows of x (one warpgroup per 64) by BN output columns per block
template <typename T, int BITS, int BM, int BN, bool GROUPED>
__global__ void __launch_bounds__(BM * 2, 1)
qmatmul_mma_kernel(const __grid_constant__ CUtensorMap x_map,  // (m, ldx)
                   const __grid_constant__ CUtensorMap w_map,  // (n, wpr)
                   const int32_t* __restrict__ w,    // (n, wpr)
                   const float* __restrict__ scale,  // (n, groups)
                   T* __restrict__ out,              // (m, n)
                   int m, int n, int wpr, int k_tiles, int gs_tiles,
                   int groups, int w_tma) {
  constexpr int kVpw = 32 / BITS;
  constexpr int kWt = kMmBk / kVpw;             // words per row per tile
  constexpr int kWTile = BN * kWt * 4;          // bytes of a word tile
  constexpr int kBTile = BN * kMmBk * 2;        // bytes of a decoded tile
  constexpr int kAcc = BN / 2;                  // accumulators per thread
  constexpr unsigned kMask = (1u << BITS) - 1u;
  constexpr int kStages = mma_stages(BN);
  constexpr int kMmThreads = BM * 2;
  constexpr int kMmXTile = BM * kMmBk * 2;      // bytes of one x tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* xs = smem;                                    // [stages][x tile]
  uint8_t* bs = xs + kStages * kMmXTile;               // [2][B tile]
  uint8_t* ws = bs + 2 * kBTile;                         // [stages][words]
  __shared__ __align__(8) uint64_t full[kStages];  // stage s has landed

  const int tid = threadIdx.x;
  const int wg = tid >> 7;                      // warpgroup: rows wg*64..
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // tile kt into stage s: x (and, when the rows allow, the packed words)
  // by TMA, issued by thread 0 and completing on full[s]; otherwise the
  // words by 4-byte cp.async copies of every thread
  auto load_tile = [&](int kt, int s) {
    const uint32_t bar = smem_u32(&full[s]);
    if (tid == 0) {
      fence_proxy_async();          // the stage's last readers are done
      mbar_expect(bar, kMmXTile + (w_tma ? kWTile : 0));
      tma_load_2d(smem_u32(xs + s * kMmXTile), &x_map, kt * kMmBk, m0, bar);
      if (w_tma) {
        tma_load_2d(smem_u32(ws + s * kWTile), &w_map, kt * kWt, n0, bar);
      }
    }
    if (!w_tma) {
      const uint32_t wdst = smem_u32(ws + s * kWTile);
      for (int i = tid; i < BN * kWt; i += kMmThreads) {
        const int r = i / kWt, c = i % kWt;
        const int gw = kt * kWt + c;
        const bool ok = n0 + r < n && gw < wpr;
        const int32_t* src = ok ? w + static_cast<size_t>(n0 + r) * wpr + gw
                                : w;
        cp_async4(wdst + (r * kWt + c) * 4, src, ok);
      }
    }
  };
  // every copy of tile t (in stage t % kStages) has landed
  auto wait_tile = [&](int t) {
    mbar_wait(smem_u32(&full[t % kStages]), (t / kStages) & 1);
    cp_async_wait<kStages - 2>();
    __syncthreads();
  };

  // the codes of stage s's words as bf16/fp16 values into B tile buf,
  // K-major and swizzled; chunk (r, c) holds codes 8c..8c+7 of row r
  auto decode = [&](int s, int buf) {
    const uint32_t* wsrc = reinterpret_cast<const uint32_t*>(ws + s * kWTile);
    uint8_t* bdst = bs + buf * kBTile;
#pragma unroll
    for (int p = 0; p < BN * 8 / kMmThreads; ++p) {
      const int i = tid + p * kMmThreads;
      const int r = i >> 3, c = i & 7;
      if constexpr (BITS == 4) {
        *reinterpret_cast<uint4*>(bdst + sw128(r, c)) =
            decode_word4<T>(wsrc[r * kWt + c]);
        continue;
      }
      unsigned f[8];
      if constexpr (BITS == 8) {
        const uint2 v = *reinterpret_cast<const uint2*>(wsrc + r * kWt + 2 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          f[e] = (v.x >> (8 * e)) & kMask;
          f[4 + e] = (v.y >> (8 * e)) & kMask;
        }
      } else {
        const unsigned v = BITS == 4 ? wsrc[r * kWt + c]
                                     : wsrc[r * kWt + c / 2] >> (16 * (c & 1));
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = (v >> (BITS * e)) & kMask;
      }
      *reinterpret_cast<uint4*>(bdst + sw128(r, c)) = decode8<T, BITS>(f);
    }
  };

  float acc[kAcc];
  float tot[GROUPED ? kAcc : 1];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;
#pragma unroll
  for (int j = 0; j < (GROUPED ? kAcc : 1); ++j) tot[j] = 0.f;

  // this thread's accumulator coordinates: row in the block, column base
  const int lane = tid & 31;
  const int arow = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int acol = (lane & 3) * 2;              // + (j >> 2) * 8 + (j & 1)

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_tile(s, s);
    cp_async_commit();
  }
  wait_tile(0);
  decode(0, 0);

  const uint32_t xs_a = smem_u32(xs) + wg * 64 * 128;
  const uint32_t bs_a = smem_u32(bs);
  for (int kt = 0; kt < k_tiles; ++kt) {
    fence_proxy_async();
    __syncthreads();                // tile kt's x and decoded B are ready
    fence_acc(acc);
    wgmma_fence();
    const uint64_t da = sw128_desc(xs_a + (kt % kStages) * kMmXTile);
    const uint64_t db = sw128_desc(bs_a + (kt & 1) * kBTile);
#pragma unroll
    for (int kk = 0; kk < kMmBk / 16; ++kk) {   // 32 B per k16 step
      Wgmma<T, BN>::run(acc, da + 2 * kk, db + 2 * kk);
    }
    wgmma_commit();
    // refill the stage tile kt - 1 used (its wgmma finished before the
    // barrier above), then decode tile kt + 1 while the tensor cores run
    const int nxt = kt + kStages - 1;
    if (nxt < k_tiles) load_tile(nxt, nxt % kStages);
    cp_async_commit();
    if (kt + 1 < k_tiles) {
      wait_tile(kt + 1);
      decode((kt + 1) % kStages, (kt + 1) & 1);
    }
    wgmma_wait0();
    fence_acc(acc);
    if (GROUPED && ((kt + 1) % gs_tiles == 0 || kt + 1 == k_tiles)) {
      const int g = kt / gs_tiles;
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        const int col = n0 + acol + (j >> 2) * 8 + (j & 1);
        const float sc =
            col < n ? __ldg(scale + static_cast<size_t>(col) * groups + g)
                    : 0.f;
        tot[j] = fmaf(sc, acc[j], tot[j]);
        acc[j] = 0.f;
      }
    }
  }

  // epilogue: scale per row (or the group totals), one rounding, store.
  // Register j holds row arow + 8 * ((j >> 1) & 1), column
  // acol + (j >> 2) * 8 + (j & 1).
  const bool pairs = (n & 1) == 0;
#pragma unroll
  for (int q = 0; q < kAcc / 4; ++q) {
    const int col = n0 + acol + q * 8;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + arow + 8 * h;
      const int j = 4 * q + 2 * h;
      if (row >= m) continue;
      float v0, v1;
      if (GROUPED) {
        v0 = tot[j];
        v1 = tot[j + 1];
      } else {
        v0 = col < n ? acc[j] * __ldg(scale + col) : 0.f;
        v1 = col + 1 < n ? acc[j + 1] * __ldg(scale + col + 1) : 0.f;
      }
      T* o = out + static_cast<size_t>(row) * n + col;
      if (pairs && col + 1 < n) {
        *reinterpret_cast<uint32_t*>(o) = pack2<T>(v0, v1);
      } else {
        if (col < n) o[0] = from_f32<T>(v0);
        if (col + 1 < n) o[1] = from_f32<T>(v1);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's tensor-map encoder, found through the runtime (no link
// against libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a row-major (rows, cols) tensor with row stride ld elements, copied in
// boxes of box_rows x box_cols
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int elem,
              const void* base, int rows, int cols, int ld, int box_rows,
              int box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int BITS, int BM, int BN, bool GROUPED>
int launch_mma_cfg(const T* x, const int32_t* w, const float* scale, T* out,
                   int m, int n, int ldx, int wpr, int k_tiles, int gs_tiles,
                   int groups, int w_vec16, cudaStream_t st) {
  constexpr int kSmem = mma_smem(BM, BN, BITS);
  constexpr int kWt = kMmBk * BITS / 32;
  auto kern = qmatmul_mma_kernel<T, BITS, BM, BN, GROUPED>;
  static const cudaError_t set = set_smem_attrs(kern, kSmem);
  if (set != cudaSuccess) return static_cast<int>(set);
  CUtensorMap x_map, w_map;
  const CUtensorMapDataType xt = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!make_map(&x_map, xt, 2, x, m, ldx, ldx, BM, kMmBk,
                CU_TENSOR_MAP_SWIZZLE_128B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the words by TMA when their rows are 16-byte multiples, else cp.async
  const int w_tma = w_vec16;
  if (!w_tma) {
    w_map = x_map;                              // unused
  } else if (!make_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, w, n, wpr,
                       wpr, BN, kWt, CU_TENSOR_MAP_SWIZZLE_NONE)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  kern<<<grid, BM * 2, kSmem, st>>>(x_map, w_map, w, scale, out, m, n, wpr,
                                    k_tiles, gs_tiles, groups, w_tma);
  return static_cast<int>(cudaGetLastError());
}

// the launch's integer arguments, as the wrapper passes them
struct Args {
  int m, n, k_pad, gs, groups, variant, tile_m, tile_n, ldx, vec;
};

template <typename T, int BITS>
int launch_bits(const void* x, const void* w, const void* scale, void* out,
                const Args& a, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const int32_t* wp = static_cast<const int32_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  T* op = static_cast<T*>(out);
  const bool grouped = a.groups > 1;
  if (a.variant == 0) {
    return grouped
        ? launch_gemv<T, BITS, true>(xp, wp, sp, op, a.m, a.n, a.k_pad, a.gs,
                                     a.groups, st)
        : launch_gemv<T, BITS, false>(xp, wp, sp, op, a.m, a.n, a.k_pad,
                                      a.gs, a.groups, st);
  }
  if constexpr (std::is_same<T, float>::value) {
    return static_cast<int>(cudaErrorInvalidValue);  // mma: 16-bit x only
  } else {
    const int wpr = a.k_pad / (32 / BITS);
    const int k_tiles = (a.k_pad + kMmBk - 1) / kMmBk;
    const int gs_tiles = grouped ? a.gs / kMmBk : k_tiles;
    if (grouped && a.gs % kMmBk) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
#define QMM_MMA(BM_, BN_, G_)                                              \
  return launch_mma_cfg<T, BITS, BM_, BN_, G_>(                            \
      xp, wp, sp, op, a.m, a.n, a.ldx, wpr, k_tiles, gs_tiles, a.groups,   \
      a.vec, st)
    const int tile = a.tile_m * 1000 + a.tile_n;
    if (tile == 128256 && !grouped) QMM_MMA(128, 256, false);
    if (tile == 128064) {
      if (grouped) QMM_MMA(128, 64, true);
      QMM_MMA(128, 64, false);
    }
    if (tile == 64064) {
      if (grouped) QMM_MMA(64, 64, true);
      QMM_MMA(64, 64, false);
    }
#undef QMM_MMA
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_type(const void* x, const void* w, const void* scale, void* out,
                int bits, const Args& a, cudaStream_t st) {
  switch (bits) {
    case 2: return launch_bits<T, 2>(x, w, scale, out, a, st);
    case 4: return launch_bits<T, 4>(x, w, scale, out, a, st);
    case 8: return launch_bits<T, 8>(x, w, scale, out, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (x and out).  variant: 0 gemv,
// 1 mma (tile_m x tile_n: 128 x 256, 128 x 64 or 64 x 64
// outputs per block; x rows ldx apart, ldx a multiple of 8).  vec (mma):
// the packed rows allow 16-byte copies (words per row a multiple of 4,
// 16-byte aligned base).
extern "C" int packed_qmatmul_launch(const void* x, const void* w,
                                     const void* scale, void* out, int m,
                                     int n, int k_pad, int bits, int gs,
                                     int groups, int dtype, int variant,
                                     int tile_m, int tile_n, int ldx,
                                     int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Args a{m, n, k_pad, gs, groups, variant, tile_m, tile_n, ldx, vec};
  switch (dtype) {
    case 0: return launch_type<float>(x, w, scale, out, bits, a, st);
    case 1: return launch_type<__nv_bfloat16>(x, w, scale, out, bits, a, st);
    case 2: return launch_type<__half>(x, w, scale, out, bits, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* packed_qmatmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
