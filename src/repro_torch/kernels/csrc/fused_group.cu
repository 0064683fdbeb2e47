// Fused multi-layer spiking rollout (a fusion group) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/fused_group/kernel.py
// (fused_group_rollout_pallas / _fused_group_kernel): all T timesteps of a
// chain of stride-1 SAME spiking convs with interleaved max pools in one
// launch.  Each conv member convolves its 1-bit channel-packed input plane
// with 2/4/8-bit integer weight codes into int32 currents, applies the
// shift-add LIF update on its own membrane with a per-channel threshold
// (soft or hard reset), masks channels >= n_out and hands the packed spike
// words to the next member; a pool member ORs the words of each window.
// Only the chain's input planes are read from, and its final planes and
// last conv member's membrane written to, device memory.
//
// What bounds it on the H100: the function moves ~1-3 MB (full-width vgg9
// or a resnet18 body at B=8, T=4) and needs ~0.3-1 G adds, so its bound is
// a few microseconds at most.  What held the first design back was
// latency: T x members cluster barriers, membranes through global memory
// every step, weights re-read from L2 and re-decoded for every 4 pixels,
// __dp4a on CUDA cores, and 8 blocks per batch element.  The design:
//   * member-major: member l at step t needs member l-1 at step t and its
//     own membrane at t-1 only, so each member runs all the steps of a
//     T chunk before the next one starts.  A warp task owns 16 pixels x
//     32 channels for the whole chunk, its membranes in registers; one
//     cluster barrier per member and chunk (7 for the vgg9 chain at T=4);
//   * one thread-block cluster of `cl` = 8-16 blocks per batch element
//     (above 8 a non-portable size; ops.py `_cluster_size` takes the size
//     that runs the batch in the fewest waves, then the largest: the
//     H100 runs 7 clusters of 16 at once, so B=8 at 16 takes two waves);
//     grid (cl, B);
//   * every block holds all the chunk's steps of the current member's
//     input plane in shared memory as packed 1-bit words, word-major
//     ([step][word][pixel], so 8 pixels of one word sit in 8 banks), with
//     the zero halo its consumer needs, in a ping-pong pair of buffers;
//     when T x plane does not fit beside the weights the wrapper takes T
//     in chunks (`tc` steps), and each conv member's membranes cross a
//     chunk boundary through a global scratch, once per chunk;
//   * a conv member is an implicit GEMM on int8 tensor cores (mma.sync
//     m16n8k32, int8_mma.cuh): rows are 16 pixels at one step, columns 8
//     output channels, depth one 32-channel spike word of one tap.  A warp
//     decodes a k-step's B fragments (4 x 8 channels) once and uses them
//     for up to kTr = 4 steps (rows (pixel, step)), 16 accumulators;
//   * a block owns the 32-channel groups r, r + GL, ... of a member (GL =
//     min(groups, cl)); blocks that share a group split its pixel tiles.
//     Where a block holds fewer units than warps (the narrow late members:
//     one unit a block for resnet18's blocks.7), a team of 2-8 warps
//     shares each unit's k-steps and the partial sums meet in the
//     leader's registers through a shared-memory tile (red.shared), so
//     every warp of the block works;
//     The packed codes of the owned groups are staged in shared memory by
//     cp.async once per member (when the wrapper's plan fits them, else
//     they are read from L2), straight from the (c_out, wpr) words of the
//     QuantizedConvTensor, so no re-layout is needed on the host;
//   * the m16n8 accumulator maps a lane to channels 2q, 2q+1 of pixels g
//     and g+8, so a lane ORs its fire bits (n_out mask before the reset)
//     into two partial words and two shuffles across the quad complete
//     each pixel's 32-channel word (int8_mma.cuh `lif_words`, shared with
//     fused_conv.cu); the quad's lanes store it into the
//     next plane of every block of the cluster (distributed shared memory)
//     or, after the last member, to device memory;
//   * a pool member is computed by every block on its own copy (a bitwise
//     OR of the window's words); a pool that ends the chain is split over
//     the cluster's blocks.
//
// Geometry contract (enforced by kernels/fused_group/ops.py): geom rows are
// ints, 8 per member, ("conv" = 0, bits, k, cin_pad, h, w, n_pad, n_out) or
// ("pool" = 1, window, h, w, c_pad, 0, 0, 0), with h/w the member's input
// dims; channels chain 32-padded; the planes are (T, B, H, W, cin_pad/32)
// int32; per conv member the weights are (n_out, k*k*cin_pad*bits/32)
// int32 words and theta (n_out,) int32.

#include <cooperative_groups.h>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"
#include "smem_cap.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;         // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxCluster = 16;   // blocks per batch element
constexpr int kTr = 4;            // steps a warp's accumulators hold
constexpr int kMaxMembers = 16;
constexpr int kGeomInts = 8;
// the K-split tiles: at most 4 teams (of 2 warps) hold a unit's kTr x 4 x
// 4 accumulators of 32 lanes each
constexpr int kRedWords = 4 * kTr * 16 * 32;

struct Member {
  int conv;          // 1 conv, 0 pool
  int k;             // conv kernel size | pool window
  int h, w;          // input plane dims (a conv's output dims too)
  int wc_in;         // input words per pixel
  int n_pad, n_out;  // conv: padded and real output channels
  int lo;            // zero halo before row/column 0 of the stored input
  int hp, wp;        // stored input plane dims, halo included
  int wpr;           // conv: packed words per output channel
  int w_stride;      // conv: staged words per channel, 0 = read from L2
  int vec;           // conv: rows can be staged by 16-byte copies
  int last_conv;     // conv: the chain's last conv (membrane returned)
  const int32_t* wq;     // conv: (n_out, wpr) codes
  const int32_t* theta;  // conv: (n_out,)
  int32_t* vscr;         // conv: (B, h*w, n_pad) membranes across chunks
};

struct Chain {
  int n;
  int tc;           // steps per chunk
  int buf_words;    // words of one step of a plane buffer
  int red_offset;   // words before the K-split tiles, 0 = no K split
  Member m[kMaxMembers];
};

// where the staged codes start: after the two plane buffers, 16-byte
// aligned for cp.async
__host__ __device__ inline int weights_offset(int tc, int buf_words) {
  return (2 * tc * buf_words + 3) / 4 * 4;
}

// words of one stored input plane (one step), halo included
__host__ __device__ inline int plane_words(const Member& m) {
  return m.hp * m.wp * m.wc_in;
}

// how many warps share one unit of a conv member (a K split), from the
// units a block holds: 8 / units rounded down to a power of two
__host__ __device__ inline int team_size(int units) {
  return units <= 1 ? 8 : units == 2 ? 4 : units <= 4 ? 2 : 1;
}

__device__ __forceinline__ void team_barrier(int team, int warps) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "r"(warps * 32)
               : "memory");
}

// The currents of NS <= kTr steps of one unit over the k-steps [k0, k1)
// (tap, spike word q pairs): per k-step the B fragments of the 4
// 8-channel tiles are decoded once and used for all NS steps.  NS is a
// template argument so the step loop has no branches: per-step guards
// kept the compiler from issuing a k-step's loads together (the vgg9
// chain took 1.8x as long with them, tools/kernel_probe.py snn).
template <int BITS, int NS>
__device__ __forceinline__ void mma_ksteps(
    int (&acc)[kTr][4][4], const uint32_t* const (&rows)[4],
    const int32_t* __restrict__ src, int buf_words, int k0, int k1,
    const Member& m, int ps, int off_lo, int off_hi, int tq) {
  const int wc = m.wc_in;
  int tap = k0 / wc;
  int q = k0 - tap * wc;
  int toff = (tap / m.k) * m.wp + tap % m.k;
#pragma unroll 2
  for (int kk = k0; kk < k1; ++kk) {
    const int kb = kk * BITS;   // the k-step's first code word
    unsigned bf[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      bf[j][0] = int8mma::codes_s8<BITS>(rows[j] + kb, 0, tq);
      bf[j][1] = int8mma::codes_s8<BITS>(rows[j] + kb, 1, tq);
    }
    const int32_t* sw = src + q * ps + toff;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int32_t* s = sw + i * buf_words;
      const unsigned lo = static_cast<unsigned>(s[off_lo]);
      const unsigned hi = static_cast<unsigned>(s[off_hi]);
      const unsigned a0 = int8mma::spikes_s8(lo, tq);
      const unsigned a1 = int8mma::spikes_s8(hi, tq);
      const unsigned a2 = int8mma::spikes_s8(lo, tq + 4);
      const unsigned a3 = int8mma::spikes_s8(hi, tq + 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int8mma::mma_s8(acc[i][j], a0, a1, a2, a3, bf[j][0], bf[j][1]);
      }
    }
    if (++q == wc) {
      q = 0;
      ++tap;
      toff = (tap / m.k) * m.wp + tap % m.k;
    }
  }
}

template <int BITS, bool STAGED>
__device__ __forceinline__ void conv_member(
    const Member& m, const Member& nx, bool last,
    const int32_t* __restrict__ src, int32_t* dst,
    const uint32_t* __restrict__ wsm, int32_t* red,
    int32_t* __restrict__ s_out, int buf_words, int t0, int nt,
    bool more_chunks, int B, int b, cg::cluster_group& cluster, int rank,
    int cl, int leak_shift, int v_reset, int soft_reset) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int groups = m.n_pad / 32;
  const int npix = m.h * m.w;
  const int tiles = (npix + 15) / 16;
  const int gl_n = min(groups, cl);          // group lanes
  const int gl = rank % gl_n;                // this block's group lane
  const int nb = (cl - 1 - gl) / gl_n + 1;   // blocks on this group lane
  const int bi = rank / gl_n;                // this block's index there
  const int owned = (groups - 1 - gl) / gl_n + 1;
  const int my_tiles = bi < tiles ? (tiles - 1 - bi) / nb + 1 : 0;
  const int units = owned * my_tiles;
  // warps of a team split a unit's k-steps and meet in shared memory
  const int ks = red != nullptr ? team_size(units) : 1;
  const int team = warp / ks;
  const int trank = warp - team * ks;
  const int ps = m.hp * m.wp;                // pixel stride of a word
  const int wc = m.wc_in;                    // k-steps per tap
  const int nk = m.k * m.k * wc;
  const int k0 = trank * nk / ks;
  const int k1 = (trank + 1) * nk / ks;
  const int nx_ps = nx.hp * nx.wp;
  const bool leader = trank == 0;

  for (int u = team; u < units; u += kWarps / ks) {
    const int oi = u / my_tiles;
    const int tile = bi + (u - oi * my_tiles) * nb;
    const int gr = gl + oi * gl_n;
    // this lane's channel rows (one per 8-channel tile) of the codes
    const uint32_t* rows[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = j * 8 + gq;
      if (STAGED) {
        rows[j] = wsm + (oi * 32 + c) * m.w_stride;
      } else {
        const int ch = min(gr * 32 + c, m.n_out - 1);
        rows[j] = reinterpret_cast<const uint32_t*>(m.wq) +
                  static_cast<size_t>(ch) * m.wpr;
      }
    }
    // this lane's pixels g and g+8 of the tile (clamped for loads)
    const int p_lo = tile * 16 + gq;
    const int p_hi = p_lo + 8;
    const int pl = min(p_lo, npix - 1);
    const int ph = min(p_hi, npix - 1);
    const int off_lo = (pl / m.w) * m.wp + pl % m.w;
    const int off_hi = (ph / m.w) * m.wp + ph % m.w;
    // thresholds and membranes of channels 2q, 2q+1 of each 8-tile (the
    // team leader's)
    int th[4][2];
    bool live[4][2];
    int mem[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ch = gr * 32 + j * 8 + tq * 2 + e;
        live[j][e] = ch < m.n_out;
        th[j][e] = live[j][e] && leader ? m.theta[ch] : 0;
      }
      if (t0 > 0 && leader) {
        const int ch = gr * 32 + j * 8 + tq * 2;
        const int2 vl = *reinterpret_cast<const int2*>(
            m.vscr + (static_cast<size_t>(b) * npix + pl) * m.n_pad + ch);
        const int2 vh = *reinterpret_cast<const int2*>(
            m.vscr + (static_cast<size_t>(b) * npix + ph) * m.n_pad + ch);
        mem[j][0] = vl.x;
        mem[j][1] = vl.y;
        mem[j][2] = vh.x;
        mem[j][3] = vh.y;
      } else {
        mem[j][0] = mem[j][1] = mem[j][2] = mem[j][3] = 0;
      }
    }

    for (int tg = 0; tg < nt; tg += kTr) {
      int acc[kTr][4][4];
#pragma unroll
      for (int i = 0; i < kTr; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;
        }
      }
      // this warp's k-steps [k0, k1), for the min(kTr, nt - tg) steps
      // of this group: a loop without per-step branches for each count
      const int ns = min(kTr, nt - tg);
      const int32_t* st = src + tg * buf_words;
      if (ns == 4) {
        mma_ksteps<BITS, 4>(acc, rows, st, buf_words, k0, k1, m, ps, off_lo,
                            off_hi, tq);
      } else if (ns == 3) {
        mma_ksteps<BITS, 3>(acc, rows, st, buf_words, k0, k1, m, ps, off_lo,
                            off_hi, tq);
      } else if (ns == 2) {
        mma_ksteps<BITS, 2>(acc, rows, st, buf_words, k0, k1, m, ps, off_lo,
                            off_hi, tq);
      } else {
        mma_ksteps<BITS, 1>(acc, rows, st, buf_words, k0, k1, m, ps, off_lo,
                            off_hi, tq);
      }
      if (ks > 1) {
        // the team's partial sums meet in the leader's registers: the
        // leader stores its own, the others add theirs (red.shared)
        int32_t* tile = red + team * (kTr * 16 * 32);
        if (leader) {
#pragma unroll
          for (int i = 0; i < kTr; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                tile[((i * 4 + j) * 4 + e) * 32 + lane] = acc[i][j][e];
        }
        team_barrier(team, ks);
        if (!leader) {
#pragma unroll
          for (int i = 0; i < kTr; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                atomicAdd(&tile[((i * 4 + j) * 4 + e) * 32 + lane],
                          acc[i][j][e]);
        }
        team_barrier(team, ks);
        if (leader) {
#pragma unroll
          for (int i = 0; i < kTr; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc[i][j][e] = tile[((i * 4 + j) * 4 + e) * 32 + lane];
        }
      }
      if (!leader) continue;
      // the LIF scan over the steps, in registers; pack, store
#pragma unroll
      for (int i = 0; i < kTr; ++i) {
        if (tg + i >= nt) break;   // uniform across the warp
        unsigned w_lo, w_hi;
        int8mma::lif_words(mem, acc[i], th, live, tq, leak_shift, v_reset,
                           soft_reset, w_lo, w_hi);
        const int t_loc = tg + i;
        if (last) {
          const size_t base = (static_cast<size_t>(t0 + t_loc) * B + b) *
                              npix;
          if (tq == 0 && p_lo < npix) {
            s_out[(base + p_lo) * groups + gr] = static_cast<int32_t>(w_lo);
          }
          if (tq == 1 && p_hi < npix) {
            s_out[(base + p_hi) * groups + gr] = static_cast<int32_t>(w_hi);
          }
        } else {
          // the next member's stored plane, in every block of the cluster
          const int dbase = t_loc * buf_words + gr * nx_ps;
          const int d_lo = dbase + (p_lo / m.w + nx.lo) * nx.wp +
                           p_lo % m.w + nx.lo;
          const int d_hi = dbase + (p_hi / m.w + nx.lo) * nx.wp +
                           p_hi % m.w + nx.lo;
          for (int r = tq; r < cl; r += 4) {
            int32_t* peer = cluster.map_shared_rank(dst, r);
            if (p_lo < npix) peer[d_lo] = static_cast<int32_t>(w_lo);
            if (p_hi < npix) peer[d_hi] = static_cast<int32_t>(w_hi);
          }
        }
      }
    }
    // membranes: to the scratch for the next chunk, or the final one
    if (leader && (more_chunks || m.last_conv)) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ch = gr * 32 + j * 8 + tq * 2;
        if (p_lo < npix) {
          *reinterpret_cast<int2*>(
              m.vscr + (static_cast<size_t>(b) * npix + p_lo) * m.n_pad +
              ch) = make_int2(mem[j][0], mem[j][1]);
        }
        if (p_hi < npix) {
          *reinterpret_cast<int2*>(
              m.vscr + (static_cast<size_t>(b) * npix + p_hi) * m.n_pad +
              ch) = make_int2(mem[j][2], mem[j][3]);
        }
      }
    }
  }
}

// stage the owned groups' codes of a conv member into shared memory;
// channels past n_out stage as zero
__device__ void stage_weights(const Member& m, uint32_t* wsm, int rank,
                              int cl) {
  const int groups = m.n_pad / 32;
  const int gl_n = min(groups, cl);
  const int gl = rank % gl_n;
  const int owned = (groups - 1 - gl) / gl_n + 1;
  const uint32_t* wq = reinterpret_cast<const uint32_t*>(m.wq);
  if (m.vec) {
    const int v4 = m.wpr / 4;   // 16-byte chunks per channel row
    for (int i = threadIdx.x; i < owned * 32 * v4; i += kThreads) {
      const int row = i / v4;   // owned group * 32 + channel
      const int x = (i - row * v4) * 4;
      const int ch = (gl + (row >> 5) * gl_n) * 32 + (row & 31);
      uint32_t* d = wsm + row * m.w_stride + x;
      if (ch < m.n_out) {
        int8mma::cp_async16(d, wq + static_cast<size_t>(ch) * m.wpr + x);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      }
    }
  } else {
    for (int i = threadIdx.x; i < owned * 32 * m.wpr; i += kThreads) {
      const int row = i / m.wpr;
      const int x = i - row * m.wpr;
      const int ch = (gl + (row >> 5) * gl_n) * 32 + (row & 31);
      uint32_t* d = wsm + row * m.w_stride + x;
      if (ch < m.n_out) {
        int8mma::cp_async4(d, wq + static_cast<size_t>(ch) * m.wpr + x);
      } else {
        *d = 0;
      }
    }
  }
}

template <int BITS>
__global__ void __launch_bounds__(kThreads, 1)
fused_group_kernel(const int32_t* __restrict__ planes,  // (T,B,H0,W0,wc0)
                   int32_t* __restrict__ s_out,         // (T,B,Hf*Wf,wcf)
                   const __grid_constant__ Chain chain, int T, int B,
                   int leak_shift, int v_reset, int soft_reset) {
  extern __shared__ __align__(16) int32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int tc = chain.tc;
  const int bw = chain.buf_words;
  uint32_t* const wsm =
      reinterpret_cast<uint32_t*>(smem + weights_offset(tc, bw));
  int32_t* const red = chain.red_offset ? smem + chain.red_offset : nullptr;
  // the member table is read in place from the kernel's parameters
  const Member* const ms = chain.m;
  cluster.sync();   // every block runs before any remote store

  const int n = chain.n;
  const Member& first = ms[0];
  const int h0w0 = first.h * first.w;
  const int ps0 = first.hp * first.wp;
  const int n_chunks = (T + tc - 1) / tc;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * tc;
    const int nt = min(tc, T - t0);
    __syncthreads();   // this block is done with the previous chunk
    // the chunk's input planes, with member 0's zero halo, into buf[0]
    // (no peer writes buf[0] before the next cluster barrier)
    for (int i = threadIdx.x; i < nt * first.wc_in * ps0; i += kThreads) {
      const int tl = i / (first.wc_in * ps0);
      const int rem = i - tl * first.wc_in * ps0;
      const int q = rem / ps0;
      const int px = rem - q * ps0;
      const int y = px / first.wp - first.lo;
      const int x = px % first.wp - first.lo;
      smem[tl * bw + rem] =
          (y >= 0 && y < first.h && x >= 0 && x < first.w)
              ? planes[((static_cast<size_t>(t0 + tl) * B + b) * h0w0 +
                        y * first.w + x) * first.wc_in + q]
              : 0;
    }
    int cur = 0;
    for (int mi = 0; mi < n; ++mi) {
      const Member& m = ms[mi];
      const bool last = mi == n - 1;
      const Member& nx = ms[last ? mi : mi + 1];
      const int oh = m.conv ? m.h : m.h / m.k;
      const int ow = m.conv ? m.w : m.w / m.k;
      const int owc = m.conv ? m.n_pad / 32 : m.wc_in;
      const int32_t* src = smem + (cur ? tc * bw : 0);
      int32_t* dst = smem + (cur ? 0 : tc * bw);
      __syncthreads();   // this block is done with the previous member
      if (!last && nx.lo > 0) {
        // zero the next plane's halo; its interior is written in full by
        // this member (by this block or its peers: disjoint words)
        const int nps = nx.hp * nx.wp;
        for (int i = threadIdx.x; i < nt * owc * nps; i += kThreads) {
          const int tl = i / (owc * nps);
          const int px = (i - tl * owc * nps) % nps;
          const int y = px / nx.wp - nx.lo;
          const int x = px % nx.wp - nx.lo;
          if (y < 0 || y >= oh || x < 0 || x >= ow) {
            dst[tl * bw + (i - tl * owc * nps)] = 0;
          }
        }
      }
      if (m.conv && m.w_stride) stage_weights(m, wsm, rank, cl);
      int8mma::cp_async_wait_all();
      // peers are done with the previous member: its plane is complete
      // here, and the buffer this member writes is free everywhere
      cluster.sync();
      if (m.conv && m.w_stride) {
        conv_member<BITS, true>(m, nx, last, src, dst, wsm, red, s_out, bw,
                                t0, nt, c + 1 < n_chunks, B, b, cluster,
                                rank, cl, leak_shift, v_reset, soft_reset);
      } else if (m.conv) {
        conv_member<BITS, false>(m, nx, last, src, dst, wsm, red, s_out, bw,
                                 t0, nt, c + 1 < n_chunks, B, b, cluster,
                                 rank, cl, leak_shift, v_reset, soft_reset);
      } else {
        // max pool of {0,1} spikes: the OR of the window's words
        const int ps = m.hp * m.wp;
        const int nps = nx.hp * nx.wp;
        const int total = nt * owc * oh * ow;
        const int start = last ? rank * kThreads + threadIdx.x : threadIdx.x;
        const int step = last ? cl * kThreads : kThreads;
        for (int i = start; i < total; i += step) {
          const int tl = i / (owc * oh * ow);
          const int rem = i - tl * owc * oh * ow;
          const int q = rem / (oh * ow);
          const int px = rem - q * oh * ow;
          const int py = px / ow;
          const int pxx = px - py * ow;
          const int32_t* s = src + tl * bw + q * ps;
          int32_t word = 0;
          for (int a = 0; a < m.k; ++a) {
            for (int cc = 0; cc < m.k; ++cc) {
              word |= s[(py * m.k + a) * m.wp + pxx * m.k + cc];
            }
          }
          if (last) {
            s_out[((static_cast<size_t>(t0 + tl) * B + b) * oh * ow + px) *
                      owc + q] = word;
          } else {
            dst[tl * bw + q * nps + (py + nx.lo) * nx.wp + pxx + nx.lo] =
                word;
          }
        }
      }
      cur ^= 1;
    }
  }
}

// geom rows -> member table (weights, thresholds and scratch are set by
// the caller); returns false on a malformed chain
bool build_chain(const int* geom, int n, Chain* chain, int* bits) {
  if (n < 1 || n > kMaxMembers) return false;
  chain->n = n;
  chain->tc = 1;
  chain->buf_words = 0;
  chain->red_offset = 0;
  *bits = 0;
  int last_conv = -1;
  for (int i = 0; i < n; ++i) {
    const int* g = geom + i * kGeomInts;
    Member& m = chain->m[i];
    m = Member{};
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
      m.wpr = m.k * m.k * m.wc_in * g[1];
      if (g[3] % 32 || m.n_pad % 32 || m.k < 1 || m.n_out < 1 ||
          m.n_out > m.n_pad || m.n_pad - m.n_out >= 32) {
        return false;
      }
      last_conv = i;
    } else {
      if (i == 0 || g[1] < 1) return false;
      m.k = g[1];
      m.h = g[2];
      m.w = g[3];
      m.wc_in = g[4] / 32;
      m.lo = 0;
      m.hp = m.h;
      m.wp = m.w;
    }
    if (plane_words(m) > chain->buf_words) chain->buf_words = plane_words(m);
  }
  if (last_conv < 0) return false;
  chain->m[last_conv].last_conv = 1;
  return *bits == 2 || *bits == 4 || *bits == 8;
}

// the staged words of conv member m per block (0 unless staged)
size_t stage_words(const Member& m, int cl, int w_stride) {
  const int groups = m.n_pad / 32;
  const int owned = (groups + cl - 1) / cl;   // the most a block owns
  return static_cast<size_t>(owned) * 32 * w_stride;
}

// the largest staged code slab of the members in `stage_mask` (words)
size_t slab_words(const Chain& chain, int cl, int stage_mask) {
  size_t w = 0;
  for (int i = 0; i < chain.n; ++i) {
    const Member& m = chain.m[i];
    if (m.conv && (stage_mask >> i & 1)) {
      const size_t s = stage_words(m, cl, int8mma::staged_stride(m.wpr));
      if (s > w) w = s;
    }
  }
  return w;
}

// words before the K-split tiles (after the staged codes); 0 without
size_t red_offset(const Chain& chain, int tc, int cl, int stage_mask,
                  int ksplit) {
  return ksplit ? weights_offset(tc, chain.buf_words) +
                      slab_words(chain, cl, stage_mask)
                : 0;
}

// dynamic shared memory of a launch: the plane buffers, then (16-byte
// aligned) the staged codes, then the K-split tiles
size_t smem_bytes(const Chain& chain, int tc, int cl, int stage_mask,
                  int ksplit) {
  if (ksplit) return 4 * (red_offset(chain, tc, cl, stage_mask, 1) +
                          kRedWords);
  const size_t w = slab_words(chain, cl, stage_mask);
  return 4 * (w ? weights_offset(tc, chain.buf_words) + w
                : 2 * static_cast<size_t>(tc) * chain.buf_words);
}

// the kernel's shared-memory cap, raised once per device (smem_cap.cuh)
template <int BITS>
cudaError_t set_attrs() {
  static std::atomic<bool> cap_raised[smemcap::kDevices] = {};
  return smemcap::raise(fused_group_kernel<BITS>, true, cap_raised);
}

template <int BITS>
cudaError_t launch(const void* planes, void* s_out, const Chain& chain,
                   size_t smem, int cl, int T, int B, int leak_shift,
                   int v_reset, int soft_reset, cudaStream_t stream) {
  cudaError_t err = set_attrs<BITS>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_group_kernel<BITS>,
                           static_cast<const int32_t*>(planes),
                           static_cast<int32_t*>(s_out), chain, T, B,
                           leak_shift, v_reset, soft_reset);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int BITS>
int max_clusters(int cl, size_t smem) {
  if (set_attrs<BITS>() != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int count = 0;
  if (cudaOccupancyMaxActiveClusters(&count, fused_group_kernel<BITS>,
                                     &cfg) != cudaSuccess) {
    cudaGetLastError();
    return -1;
  }
  return count;
}

}  // namespace

// Dynamic shared memory of one block for the chain at a T chunk of `tc`
// steps, a cluster of `cl` blocks, the conv members whose bit is set in
// `stage_mask` staging their codes, and (`ksplit`) the K-split tiles: two
// plane buffers of tc steps, the largest staged code slab, the tiles.  At
// tc = 1 with nothing staged and no K split it is kernels/smem.py
// group_rollout_smem_bytes, the planner's formula; kernels/fused_group/
// ops.py `_group_smem_bytes` must give the same number.
extern "C" size_t fused_group_smem_bytes(const int* geom, int n, int tc,
                                         int cl, int stage_mask,
                                         int ksplit) {
  Chain chain;
  int bits;
  if (!build_chain(geom, n, &chain, &bits) || tc < 1 || cl < 1) return 0;
  return smem_bytes(chain, tc, cl, stage_mask, ksplit);
}

// How many clusters of `cl` blocks of `smem` bytes the card runs at once
// (cudaOccupancyMaxActiveClusters), or -1 if the query fails.
extern "C" int fused_group_max_clusters(int bits, int cl, size_t smem) {
  switch (bits) {
    case 2: return max_clusters<2>(cl, smem);
    case 4: return max_clusters<4>(cl, smem);
    case 8: return max_clusters<8>(cl, smem);
    default: return -1;
  }
}

// ksplit: give the K-split tiles, so warps share the units of a member
// whose blocks hold fewer units than warps.
// w/theta/vscr: one pointer per member (null for pools): the conv's
// (n_out, wpr) codes, its (n_out,) thresholds, and its (B, h*w, n_pad)
// int32 membrane scratch (the last conv member's is the returned
// membrane; the others' are read only when T spans several chunks).
// vec_mask: bit i set when member i's code rows may be copied in 16-byte
// pieces (wpr % 4 == 0 and a 16-byte aligned base).
extern "C" int fused_group_launch(const void* planes, const void* const* w,
                                  const void* const* theta,
                                  void* const* vscr, void* s_out,
                                  const int* geom, int n, int T, int B,
                                  int tc, int cl, int stage_mask,
                                  int ksplit, int vec_mask, int leak_shift,
                                  int v_reset, int soft_reset,
                                  void* stream) {
  Chain chain;
  int bits;
  if (!build_chain(geom, n, &chain, &bits) || B < 1 || B > 65535 ||
      tc < 1 || T < 1 || cl < 1 || cl > kMaxCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  chain.tc = tc;
  for (int i = 0; i < n; ++i) {
    Member& m = chain.m[i];
    if (!m.conv) continue;
    m.wq = static_cast<const int32_t*>(w[i]);
    m.theta = static_cast<const int32_t*>(theta[i]);
    m.vscr = static_cast<int32_t*>(vscr[i]);
    m.w_stride = (stage_mask >> i & 1) ? int8mma::staged_stride(m.wpr) : 0;
    m.vec = (vec_mask >> i & 1) && m.wpr % 4 == 0;
  }
  chain.red_offset =
      static_cast<int>(red_offset(chain, tc, cl, stage_mask, ksplit));
  const size_t smem = smem_bytes(chain, tc, cl, stage_mask, ksplit);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bits == 2 ? launch<2>(planes, s_out, chain, smem, cl, T, B, leak_shift,
                            v_reset, soft_reset, st)
      : bits == 4 ? launch<4>(planes, s_out, chain, smem, cl, T, B,
                              leak_shift, v_reset, soft_reset, st)
                  : launch<8>(planes, s_out, chain, smem, cl, T, B,
                              leak_shift, v_reset, soft_reset, st);
  return static_cast<int>(err);
}

extern "C" const char* fused_group_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
