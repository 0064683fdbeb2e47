// Fused packed-conv spiking rollout for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/fused_conv/kernel.py
// (fused_conv_rollout_pallas / _fused_conv_kernel): all T timesteps of one
// spiking conv layer in one launch.  Per output pixel and timestep it
// gathers the kh*kw receptive field of a 1-bit channel-packed spike plane,
// accumulates the 2/4/8-bit integer weight codes of every set spike bit
// into an int32 current, applies the shift-add LIF update with a
// per-channel threshold (soft or hard reset), masks channels >= n_out and
// writes the spikes back as LSB-first 32-channel words.
//
// What bounds it on the H100: at the vgg9 shapes the layer moves a few MB
// (mostly the int32 membrane it must return) and needs ~0.1-0.3 G adds, so
// the bound is device-memory bytes (3.35 TB/s); the accumulate of a binary
// spike times an int code is an add, not a product, and the tensor cores
// have nothing to multiply.  The design therefore:
//   * keeps T as a loop inside the block, with the membrane of each
//     (pixel, channel) in a register for the whole rollout, so no per-step
//     current or membrane ever reaches device memory;
//   * stages the block's 32-channel weight tile once in shared memory,
//     unpacked to int8 codes, and reuses it for all T steps and all pixels
//     of the tile (the Pallas weights stayed resident across T the same
//     way).  Layout [k/4][32 channels][4]: lane c reads the four codes of
//     k..k+3 for its channel as one 32-bit word, and the 32 lanes read 32
//     consecutive words (no bank conflict);
//   * maps the 32 lanes of a warp to 32 consecutive output channels: every
//     lane reads the same spike word (a broadcast), expands each 4-bit
//     nibble to four 0/1 bytes and dot-products them with its four codes
//     (__dp4a), eight branch-free steps per word; __ballot_sync(v >= theta)
//     over the warp is then exactly the packed spike word, pack_bool's
//     layout, with no re-pack pass.
//
// Geometry contract (enforced by kernels/fused_conv/ops.py): the plane
// arrives pre-padded to the gather footprint, (T, B, Hp, Wp, wc) int32
// with wc = cin_pad/32; weights are (n_pad, kh*kw*cin_pad*bits/32) int32
// with n_pad a multiple of 32; theta is (n_pad,) int32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                      // warps per block
constexpr int kPixPerWarp = 4;                 // membranes held per lane
constexpr int kTile = kWarps * kPixPerWarp;    // output pixels per block

__global__ void __launch_bounds__(kWarps * 32)
fused_conv_kernel(const int32_t* __restrict__ planes,  // (T,B,Hp,Wp,wc)
                  const int32_t* __restrict__ w,       // (n_pad, wpr)
                  const int32_t* __restrict__ theta,   // (n_pad,)
                  int32_t* __restrict__ v_out,         // (B, Ho*Wo, n_pad)
                  int32_t* __restrict__ s_out,         // (T,B,Ho*Wo,n_pad/32)
                  int T, int B, int Hp, int Wp, int wc, int Ho, int Wo,
                  int kh, int kw, int stride, int bits, int n_pad,
                  int n_out, int leak_shift, int v_reset, int soft_reset) {
  extern __shared__ int32_t codes[];           // [k/4][32 channels] x4
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.x;                    // 32-channel group
  const int tile = blockIdx.y;                 // pixel tile
  const int b = blockIdx.z;                    // batch element

  // stage the group's weights once: packed words -> int8 codes
  const int K = kh * kw * wc * 32;
  const int vpw = 32 / bits;
  const int wpr = K / vpw;                     // packed words per channel
  const unsigned fmask = (1u << bits) - 1u;
  const int bias = 1 << (bits - 1);
  for (int i = threadIdx.x; i < 32 * wpr; i += blockDim.x) {
    const int c = i & 31;                      // lane-fast: no bank conflict
    const int j = i >> 5;
    const unsigned word =
        static_cast<unsigned>(w[static_cast<size_t>(g * 32 + c) * wpr + j]);
    for (int f = 0; f < vpw; ++f) {
      const int k = j * vpw + f;
      reinterpret_cast<int8_t*>(codes)[((k >> 2) * 32 + c) * 4 + (k & 3)] =
          static_cast<int8_t>(static_cast<int>((word >> (f * bits)) & fmask) -
                              bias);
    }
  }
  __syncthreads();

  const int ch = g * 32 + lane;
  const int th = theta[ch];
  const bool live = ch < n_out;
  const int npix = Ho * Wo;
  const int words_out = n_pad / 32;
  const size_t plane_words = static_cast<size_t>(Hp) * Wp * wc;
  const int tap_stride = wc * 8 * 32;          // code words per tap

  int v[kPixPerWarp];
#pragma unroll
  for (int p = 0; p < kPixPerWarp; ++p) v[p] = 0;

  for (int t = 0; t < T; ++t) {
    const int32_t* plane =
        planes + (static_cast<size_t>(t) * B + b) * plane_words;
#pragma unroll
    for (int p = 0; p < kPixPerWarp; ++p) {
      const int pix = tile * kTile + warp * kPixPerWarp + p;
      if (pix < npix) {                        // uniform across the warp
        const int oh = pix / Wo;
        const int ow = pix - oh * Wo;
        int acc = 0;
        for (int di = 0; di < kh; ++di) {
          const int32_t* row =
              plane + (static_cast<size_t>(oh * stride + di) * Wp +
                       ow * stride) * wc;
          for (int dj = 0; dj < kw; ++dj) {
            const int32_t* px = row + dj * wc;
            const int32_t* tap = codes + (di * kw + dj) * tap_stride + lane;
            for (int q = 0; q < wc; ++q) {
              const unsigned s = static_cast<unsigned>(__ldg(px + q));
              const int32_t* base = tap + q * 8 * 32;
#pragma unroll
              for (int n = 0; n < 8; ++n) {
                // nibble n -> four 0/1 bytes (the shifted copies of the
                // nibble do not overlap, so the product has no carries)
                const unsigned nib = (s >> (4 * n)) & 0xFu;
                const int ones = static_cast<int>((nib * 0x00204081u) &
                                                  0x01010101u);
                acc = __dp4a(ones, base[n * 32], acc);
              }
            }
          }
        }
        int vv = v[p];
        vv = vv - (vv >> leak_shift) + acc;    // arithmetic shift: floor
        const bool fire = live && vv >= th;
        const unsigned word = __ballot_sync(0xffffffffu, fire);
        if (fire) vv = soft_reset ? vv - th : v_reset;
        v[p] = vv;
        if (lane == 0) {
          s_out[((static_cast<size_t>(t) * B + b) * npix + pix) * words_out +
                g] = static_cast<int32_t>(word);
        }
      }
    }
  }

#pragma unroll
  for (int p = 0; p < kPixPerWarp; ++p) {
    const int pix = tile * kTile + warp * kPixPerWarp + p;
    if (pix < npix) {
      v_out[(static_cast<size_t>(b) * npix + pix) * n_pad + ch] = v[p];
    }
  }
}

}  // namespace

extern "C" size_t fused_conv_smem_bytes(int kh, int kw, int wc) {
  return static_cast<size_t>(kh) * kw * wc * 32 * 32;
}

extern "C" int fused_conv_launch(const void* planes, const void* w,
                                 const void* theta, void* v_out, void* s_out,
                                 int T, int B, int Hp, int Wp, int wc, int Ho,
                                 int Wo, int kh, int kw, int stride, int bits,
                                 int n_pad, int n_out, int leak_shift,
                                 int v_reset, int soft_reset, void* stream) {
  const size_t smem = fused_conv_smem_bytes(kh, kw, wc);
  cudaError_t err = cudaFuncSetAttribute(
      fused_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_pad / 32, (Ho * Wo + kTile - 1) / kTile, B);
  fused_conv_kernel<<<grid, kWarps * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(planes), static_cast<const int32_t*>(w),
      static_cast<const int32_t*>(theta), static_cast<int32_t*>(v_out),
      static_cast<int32_t*>(s_out), T, B, Hp, Wp, wc, Ho, Wo, kh, kw, stride,
      bits, n_pad, n_out, leak_shift, v_reset, soft_reset);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
