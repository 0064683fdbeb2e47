// int8 tensor-core helpers shared by the spiking kernels (sm_90a).
//
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32: a warp multiplies a
// 16 x 32 s8 tile A by a 32 x 8 s8 tile B into a 16 x 8 s32 tile.  With
// g = lane / 4 and q = lane % 4, the fragments are:
//   A  a0: row g,   k 4q..4q+3      a1: row g+8, k 4q..4q+3
//      a2: row g,   k 16+4q..+3     a3: row g+8, k 16+4q..+3
//   B  b0: k 4q..4q+3, column g     b1: k 16+4q..+3, column g
//   C  c0, c1: row g,   columns 2q, 2q+1
//      c2, c3: row g+8, columns 2q, 2q+1
// (four s8 values per 32-bit register, the lowest k in the lowest byte).
//
// A spiking layer's A operand is a 1-bit spike word per row: k is the
// word's bit index, so a0/a1 take nibble q and a2/a3 nibble q+4 of the
// row's word, each expanded to four 0/1 bytes.  Its B operand is packed
// 2/4/8-bit codes in offset binary (code + 2^(bits-1)), LSB first: the
// 32 codes of one k-step are `bits` consecutive words of a neuron's row,
// and b0/b1 take four consecutive fields of them, spread to bytes and
// re-centred to signed s8 without a borrow between bytes.  Integer sums
// are exact in any order, so the product is bit-exact with the plain
// versions whatever the tiling.

#pragma once

#include <cstdint>

namespace int8mma {

__device__ __forceinline__ void mma_s8(int (&c)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// nibble `nib` (bits 4*nib..4*nib+3) of a spike word -> four 0/1 bytes
// (the shifted copies of the nibble do not overlap: no carries)
__device__ __forceinline__ unsigned spikes_s8(unsigned word, int nib) {
  return (((word >> (4 * nib)) & 0xFu) * 0x00204081u) & 0x01010101u;
}

// The B register `half` (0: k 4q..4q+3, 1: k 16+4q..+3) of one k-step
// for lane quad index q, from the BITS words `wk` of the neuron's row
// that hold the k-step's 32 codes.
template <int BITS>
__device__ __forceinline__ unsigned codes_s8(const uint32_t* wk, int half,
                                             int q) {
  const int off = (half * 16 + q * 4) * BITS;
  unsigned e = wk[off >> 5] >> (off & 31);
  if (BITS == 4) {
    e &= 0xFFFFu;
    e = (e | (e << 8)) & 0x00FF00FFu;
    e = (e | (e << 4)) & 0x0F0F0F0Fu;
  } else if (BITS == 2) {
    e &= 0xFFu;
    e = (e | (e << 12)) & 0x000F000Fu;
    e = (e | (e << 6)) & 0x03030303u;
  }
  // byte c -> c - 2^(BITS-1) as s8: c + 128 - 2^(BITS-1) stays below 256
  // (no carry into the next byte), and flipping bit 7 subtracts 128
  constexpr unsigned kAdd = (128u - (1u << (BITS - 1))) * 0x01010101u;
  return (e + kAdd) ^ 0x80808080u;
}

// Staged words per neuron or channel row in shared memory: `words`
// padded to 4 mod 32, so the 8 rows of a B fragment load (lanes g = 0..7,
// one row each, at most four consecutive words) sit in distinct banks.
__host__ __device__ inline int staged_stride(int words) {
  return words + ((4 - words) & 31);
}

// One shift-add LIF step on a lane's positions of a 16-row x 32-channel
// accumulator tile (four m16n8 tiles j: channels 8j + 2q + (e & 1) of row
// g for e < 2, of row g + 8 for e >= 2), the n_out mask (`live`) before
// the reset.  Returns in w_lo / w_hi the rows' 32-channel spike words
// (LSB = channel 0, pack_bool's layout): each lane ORs its fire bits in,
// and two xor-shuffles complete the words over the quad, so every lane of
// quad g holds the words of rows g and g + 8.
__device__ __forceinline__ void lif_words(int (&mem)[4][4],
                                          const int (&cur)[4][4],
                                          const int (&th)[4][2],
                                          const bool (&live)[4][2], int tq,
                                          int leak_shift, int v_reset,
                                          int soft_reset, unsigned& w_lo,
                                          unsigned& w_hi) {
  w_lo = 0;
  w_hi = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = e & 1;
      int v = mem[j][e];
      v = v - (v >> leak_shift) + cur[j][e];   // arithmetic shift: floor
      const bool fire = live[j][c] && v >= th[j][c];
      if (fire) v = soft_reset ? v - th[j][c] : v_reset;
      mem[j][e] = v;
      const unsigned bit = static_cast<unsigned>(fire)
                           << (j * 8 + tq * 2 + c);
      if (e < 2) {
        w_lo |= bit;
      } else {
        w_hi |= bit;
      }
    }
  }
  w_lo |= __shfl_xor_sync(0xFFFFFFFFu, w_lo, 1);
  w_lo |= __shfl_xor_sync(0xFFFFFFFFu, w_lo, 2);
  w_hi |= __shfl_xor_sync(0xFFFFFFFFu, w_hi, 1);
  w_hi |= __shfl_xor_sync(0xFFFFFFFFu, w_hi, 2);
}

// 4-byte asynchronous copy global -> shared (cp.async.ca), and the wait
// for every copy this thread issued
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace int8mma
