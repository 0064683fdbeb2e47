// Fused multi-layer spiking rollout (a fusion group) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/fused_group/kernel.py
// (fused_group_rollout_pallas / _fused_group_kernel): all T timesteps of a
// chain of stride-1 SAME spiking convs with interleaved max pools in one
// launch.  Per timestep each conv member gathers its k*k receptive field of
// the 1-bit channel-packed input plane, accumulates the 2/4/8-bit integer
// weight codes of every set spike bit into an int32 current, applies the
// shift-add LIF update on its own membrane with a per-channel threshold
// (soft or hard reset), masks channels >= n_out, and hands the packed spike
// words to the next member; a pool member ORs the words of each window.
// Only the chain's input plane is read from, and its final plane written
// to, device memory; the inter-member planes never leave the chip.
//
// What bounds it on the H100: the function moves ~1-3 MB (full-width vgg9
// or a resnet18 body at B=8, T=4: planes in, packed weights, the last
// member's int32 membrane out) and needs ~0.3-1 G adds, so its bound is
// under a microsecond, device-memory bytes for the resnet18 bodies and
// the adds for the vgg9 chain.  The real limit of this design is latency
// and parallelism: each member must see the whole previous plane, so a
// batch element's chain runs serially on one cluster.
// The design:
//   * one thread-block cluster of kClusterCTAs blocks per batch element
//     (grid (kClusterCTAs, B)); T and the member chain are loops inside;
//   * every block of the cluster holds the whole current plane in shared
//     memory as packed 1-bit words, a ping-pong pair of buffers, each plane
//     stored with the zero halo its consumer needs (SAME padding of a
//     conv), so a member reads spike words with no bounds checks;
//   * a conv member's work is (kPix pixels, 32-channel group) warp tasks,
//     dealt round-robin over all warps of the cluster; the 32 lanes of a
//     warp map to 32 consecutive output channels, so
//     __ballot_sync(v >= theta), masked by n_out before the reset, is the
//     LSB-first packed word.  Each lane decodes its codes for a spike word
//     once and uses them for the task's kPix pixels, whose accumulate
//     chains are independent.  Lanes 0..kClusterCTAs-1 store each word
//     into the next plane of every block of the cluster through
//     distributed shared memory, and a cluster barrier separates the
//     members;
//   * a pool member is computed by every block on its own copy (a bitwise
//     OR of the window's words), since it is tiny;
//   * each member's int32 membrane lives in a global scratch the wrapper
//     allocates (L2-resident at these sizes); a (pixel, channel) entry is
//     always owned by the same lane, so it needs no synchronisation.  It is
//     not read at t = 0 (the rollout starts from 0).  The last conv
//     member's scratch is the returned membrane;
//   * the accumulate expands each spike nibble to four 0/1 bytes and
//     dot-products them (__dp4a) with four unsigned code fields spread to
//     bytes, read straight from the packed words; the codes are offset
//     binary (code + 2^(bits-1)), so the sum subtracts 2^(bits-1) once per
//     set spike bit.  Weights come from global memory in a [group][word]
//     [lane] layout the wrapper prepares, so a warp's 32 loads are one
//     128-byte line.
//
// Geometry contract (enforced by kernels/fused_group/ops.py): geom rows are
// ints, 8 per member, ("conv" = 0, bits, k, cin_pad, h, w, n_pad, n_out) or
// ("pool" = 1, window, h, w, c_pad, 0, 0, 0), with h/w the member's input
// dims; channels chain 32-padded; the plane is (T, B, H, W, cin_pad/32)
// int32; per conv member the weights are (n_pad/32, k*k*cin_pad*bits/32,
// 32) int32 and theta (n_pad,) int32, each concatenated over the members.

#include <cooperative_groups.h>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kClusterCTAs = 8;   // blocks per batch element (portable max)
constexpr int kWarps = 16;        // warps per block
constexpr int kPix = 4;           // output pixels per warp task
constexpr int kMaxMembers = 16;
constexpr int kGeomInts = 8;

struct Member {
  int conv;          // 1 conv, 0 pool
  int k;             // conv kernel size | pool window
  int h, w;          // input plane dims (a conv's output dims too)
  int wc_in;         // input words per pixel
  int n_pad, n_out;  // conv: padded and real output channels
  int lo;            // zero halo before row/column 0 of the stored input
  int hp, wp;        // stored input plane dims, halo included
  long long w_off, th_off, v_off;  // conv: offsets into w, theta, vmem
};

struct Chain {
  int n;
  Member m[kMaxMembers];
};

template <int BITS>
__device__ __forceinline__ unsigned spread_fields(unsigned e) {
  // four BITS-wide unsigned fields (LSB first) -> one field per byte
  if (BITS == 4) {
    e = (e | (e << 8)) & 0x00FF00FFu;
    return (e | (e << 4)) & 0x0F0F0F0Fu;
  }
  if (BITS == 2) {
    e = (e | (e << 12)) & 0x000F000Fu;
    return (e | (e << 6)) & 0x03030303u;
  }
  return e;
}

template <int BITS>
__global__ void __cluster_dims__(kClusterCTAs, 1, 1)
__launch_bounds__(kWarps * 32)
fused_group_kernel(const int32_t* __restrict__ planes,  // (T,B,H0,W0,wc0)
                   const int32_t* __restrict__ w,       // convs' weights
                   const int32_t* __restrict__ theta,   // convs' thresholds
                   int32_t* __restrict__ vmem,          // convs' membranes
                   int32_t* __restrict__ s_out,         // (T,B,Hf*Wf,wcf)
                   const Chain chain, int buf_words, int T, int B,
                   int leak_shift, int v_reset, int soft_reset) {
  extern __shared__ int32_t smem[];
  int32_t* const buf[2] = {smem, smem + buf_words};
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int gwarp = rank * kWarps + (threadIdx.x >> 5);
  constexpr int kAllWarps = kClusterCTAs * kWarps;
  constexpr unsigned kFieldMask =
      BITS == 8 ? 0xFFFFFFFFu : (1u << (4 * (BITS & 7))) - 1u;
  constexpr int kBias = 1 << (BITS - 1);

  // lane r < kClusterCTAs stores the warp's words into block r's planes
  int32_t* peer[2] = {nullptr, nullptr};
  if (lane < kClusterCTAs) {
    peer[0] = cluster.map_shared_rank(buf[0], lane);
    peer[1] = cluster.map_shared_rank(buf[1], lane);
  }
  cluster.sync();  // every block of the cluster runs before any remote store

  const Member first = chain.m[0];
  const size_t in_words = static_cast<size_t>(first.h) * first.w *
                          first.wc_in;
  for (int t = 0; t < T; ++t) {
    // the step's input plane, with member 0's zero halo, into buf[0]
    {
      const int32_t* src = planes + (static_cast<size_t>(t) * B + b) *
                                        in_words;
      const int total = first.hp * first.wp * first.wc_in;
      for (int i = threadIdx.x; i < total; i += blockDim.x) {
        const int q = i % first.wc_in;
        const int px = i / first.wc_in;
        const int y = px / first.wp - first.lo;
        const int x = px % first.wp - first.lo;
        buf[0][i] = (y >= 0 && y < first.h && x >= 0 && x < first.w)
                        ? src[(y * first.w + x) * first.wc_in + q]
                        : 0;
      }
      __syncthreads();
    }

    int cur = 0;
    for (int mi = 0; mi < chain.n; ++mi) {
      const Member m = chain.m[mi];
      const bool last = mi == chain.n - 1;
      const Member nx = chain.m[last ? mi : mi + 1];
      const int oh = m.conv ? m.h : m.h / m.k;
      const int ow = m.conv ? m.w : m.w / m.k;
      const int owc = m.conv ? m.n_pad / 32 : m.wc_in;
      const int32_t* src = buf[cur];
      int32_t* dst = buf[cur ^ 1];

      if (!last && nx.lo > 0) {
        // zero the next plane's halo; its interior is written in full
        // below (by this block or its peers: disjoint words)
        const int total = nx.hp * nx.wp * owc;
        for (int i = threadIdx.x; i < total; i += blockDim.x) {
          const int px = i / owc;
          const int y = px / nx.wp - nx.lo;
          const int x = px % nx.wp - nx.lo;
          if (y < 0 || y >= oh || x < 0 || x >= ow) dst[i] = 0;
        }
      }

      if (m.conv) {
        const int groups = m.n_pad / 32;
        const int npix = m.h * m.w;
        const int tiles = (npix + kPix - 1) / kPix;
        const int wpr = m.k * m.k * m.wc_in * BITS;  // words per channel
        int32_t* vp = vmem + m.v_off + static_cast<size_t>(b) * npix *
                                           m.n_pad;
        const int32_t* thp = theta + m.th_off;
        for (int task = gwarp; task < tiles * groups; task += kAllWarps) {
          const int tile = task / groups;
          const int g = task - tile * groups;
          const int ch = g * 32 + lane;
          const int32_t* wrow =
              w + m.w_off + static_cast<size_t>(g) * wpr * 32 + lane;
          // the stored-plane offset of each pixel's receptive field; a
          // pixel past the plane's end repeats the last one, unstored
          int base[kPix];
#pragma unroll
          for (int j = 0; j < kPix; ++j) {
            const int p = min(tile * kPix + j, npix - 1);
            const int y = p / m.w;
            base[j] = (y * m.wp + p - y * m.w) * m.wc_in;
          }
          unsigned usum[kPix];
          int nset[kPix];
#pragma unroll
          for (int j = 0; j < kPix; ++j) usum[j] = nset[j] = 0;
          for (int di = 0; di < m.k; ++di) {
            for (int dj = 0; dj < m.k; ++dj) {
              const int off = (di * m.wp + dj) * m.wc_in;
              const int32_t* wtap =
                  wrow + static_cast<size_t>((di * m.k + dj) * m.wc_in) *
                             BITS * 32;
              for (int q = 0; q < m.wc_in; ++q) {
                // this lane's 32 codes for spike word q, as 8 words of
                // four unsigned fields, one per byte; reused by kPix pixels
                unsigned pk[BITS];
#pragma unroll
                for (int j = 0; j < BITS; ++j) {
                  pk[j] = static_cast<unsigned>(
                      __ldg(wtap + (q * BITS + j) * 32));
                }
                unsigned code[8];
#pragma unroll
                for (int n = 0; n < 8; ++n) {
                  code[n] = spread_fields<BITS>(
                      (pk[(n * 4 * BITS) / 32] >> ((n * 4 * BITS) % 32)) &
                      kFieldMask);
                }
#pragma unroll
                for (int j = 0; j < kPix; ++j) {
                  const unsigned s =
                      static_cast<unsigned>(src[base[j] + off + q]);
                  nset[j] += __popc(s);
#pragma unroll
                  for (int n = 0; n < 8; ++n) {
                    // spike nibble n -> four 0/1 bytes (shifted copies of
                    // the nibble do not overlap: no carries)
                    const unsigned ones =
                        (((s >> (4 * n)) & 0xFu) * 0x00204081u) &
                        0x01010101u;
                    usum[j] = __dp4a(ones, code[n], usum[j]);
                  }
                }
              }
            }
          }
          const int th = thp[ch];
#pragma unroll
          for (int j = 0; j < kPix; ++j) {
            const int p = tile * kPix + j;
            if (p >= npix) break;                // uniform across the warp
            const int acc = static_cast<int>(usum[j]) - kBias * nset[j];
            const size_t vi = static_cast<size_t>(p) * m.n_pad + ch;
            int v = t == 0 ? 0 : vp[vi];
            v = v - (v >> leak_shift) + acc;     // arithmetic shift: floor
            const bool fire = ch < m.n_out && v >= th;
            const unsigned word = __ballot_sync(0xFFFFFFFFu, fire);
            if (fire) v = soft_reset ? v - th : v_reset;
            vp[vi] = v;
            if (last) {
              if (lane == 0) {
                s_out[((static_cast<size_t>(t) * B + b) * npix + p) *
                          groups + g] = static_cast<int32_t>(word);
              }
            } else if (lane < kClusterCTAs) {
              const int y = p / m.w;
              peer[cur ^ 1][((y + nx.lo) * nx.wp + p - y * m.w + nx.lo) *
                                owc + g] = static_cast<int32_t>(word);
            }
          }
        }
      } else {
        // max pool of {0,1} spikes: the OR of the window's words
        const int total = oh * ow * owc;
        const int start = last ? rank * blockDim.x + threadIdx.x
                               : threadIdx.x;
        const int step = last ? kClusterCTAs * blockDim.x : blockDim.x;
        for (int i = start; i < total; i += step) {
          const int q = i % owc;
          const int px = i / owc;
          const int py = px / ow;
          const int pxx = px - py * ow;
          int32_t word = 0;
          for (int a = 0; a < m.k; ++a) {
            for (int c = 0; c < m.k; ++c) {
              word |= src[((py * m.k + a) * m.wp + pxx * m.k + c) * m.wc_in +
                          q];
            }
          }
          if (last) {
            s_out[(static_cast<size_t>(t) * B + b) * total + i] = word;
          } else {
            dst[((py + nx.lo) * nx.wp + pxx + nx.lo) * owc + q] = word;
          }
        }
      }
      // the member's plane is complete in every block before the next
      // member reads it, and every block is done reading before its
      // buffer is written again
      cluster.sync();
      cur ^= 1;
    }
  }
}

// geom rows -> member table; returns false on a malformed chain
bool build_chain(const int* geom, int n, Chain* chain, int* bits,
                 size_t* buf_words) {
  if (n < 1 || n > kMaxMembers) return false;
  chain->n = n;
  long long w_off = 0, th_off = 0, v_off = 0;
  *bits = 0;
  *buf_words = 0;
  for (int i = 0; i < n; ++i) {
    const int* g = geom + i * kGeomInts;
    Member& m = chain->m[i];
    m.conv = g[0] == 0;
    if (m.conv) {
      if (*bits != 0 && g[1] != *bits) return false;
      *bits = g[1];
      m.k = g[2];
      m.wc_in = g[3] / 32;
      m.h = g[4];
      m.w = g[5];
      m.n_pad = g[6];
      m.n_out = g[7];
      m.lo = (m.k - 1) / 2;
      m.hp = m.h + m.k - 1;
      m.wp = m.w + m.k - 1;
      m.w_off = w_off;
      m.th_off = th_off;
      m.v_off = v_off;
      w_off += static_cast<long long>(m.n_pad) * m.k * m.k * m.wc_in * g[1];
      th_off += m.n_pad;
      v_off += static_cast<long long>(m.h) * m.w * m.n_pad;  // per batch
      if (g[3] % 32 || m.n_pad % 32 || m.k < 1) return false;
    } else {
      if (i == 0 || g[1] < 1) return false;
      m.k = g[1];
      m.h = g[2];
      m.w = g[3];
      m.wc_in = g[4] / 32;
      m.n_pad = m.n_out = 0;
      m.lo = 0;
      m.hp = m.h;
      m.wp = m.w;
      m.w_off = m.th_off = m.v_off = 0;
    }
    const size_t words = static_cast<size_t>(m.hp) * m.wp * m.wc_in;
    if (words > *buf_words) *buf_words = words;
  }
  return *bits == 2 || *bits == 4 || *bits == 8;
}

template <int BITS>
cudaError_t launch(const void* planes, const void* w, const void* theta,
                   void* vmem, void* s_out, const Chain& chain,
                   size_t buf_words, int T, int B, int leak_shift,
                   int v_reset, int soft_reset, cudaStream_t stream) {
  const size_t smem = 2 * 4 * buf_words;
  cudaError_t err = cudaFuncSetAttribute(
      fused_group_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_group_kernel<BITS><<<dim3(kClusterCTAs, B), kWarps * 32, smem,
                             stream>>>(
      static_cast<const int32_t*>(planes), static_cast<const int32_t*>(w),
      static_cast<const int32_t*>(theta), static_cast<int32_t*>(vmem),
      static_cast<int32_t*>(s_out), chain, static_cast<int>(buf_words), T, B,
      leak_shift, v_reset, soft_reset);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block for the chain (two plane buffers);
// kernels/smem.py group_rollout_smem_bytes must give the same number.
extern "C" size_t fused_group_smem_bytes(const int* geom, int n) {
  Chain chain;
  int bits;
  size_t buf_words;
  if (!build_chain(geom, n, &chain, &bits, &buf_words)) return 0;
  return 2 * 4 * buf_words;
}

// The membrane scratch holds one (B, h*w, n_pad) int32 block per conv
// member, in chain order; the weights and thresholds are concatenated in
// the same order.
extern "C" int fused_group_launch(const void* planes, const void* w,
                                  const void* theta, void* vmem, void* s_out,
                                  const int* geom, int n, int T, int B,
                                  int leak_shift, int v_reset, int soft_reset,
                                  void* stream) {
  Chain chain;
  int bits;
  size_t buf_words;
  if (!build_chain(geom, n, &chain, &bits, &buf_words) || B < 1 ||
      B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < n; ++i) chain.m[i].v_off *= B;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bits == 2 ? launch<2>(planes, w, theta, vmem, s_out, chain, buf_words,
                            T, B, leak_shift, v_reset, soft_reset, st)
      : bits == 4 ? launch<4>(planes, w, theta, vmem, s_out, chain,
                              buf_words, T, B, leak_shift, v_reset,
                              soft_reset, st)
                  : launch<8>(planes, w, theta, vmem, s_out, chain,
                              buf_words, T, B, leak_shift, v_reset,
                              soft_reset, st);
  return static_cast<int>(err);
}

extern "C" const char* fused_group_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
