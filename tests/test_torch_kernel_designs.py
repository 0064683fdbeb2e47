"""The arithmetic the port's CUDA kernel designs rely on, held on the CPU.

``csrc/packed_qmatmul.cu`` and ``csrc/kv_attention.cu`` run only on a
card; these tests emulate, in plain PyTorch and numpy, the orders and bit
tricks their designs use, and hold them against the plain versions at
the CUDA tests' tolerances:

* the wrapper's shape choices (``_variant``, ``_mma_tile``, ``_split``);
* the tensor-core order of ``packed_qmatmul``: the integer codes times
  bf16 x summed in float32, the scale applied afterwards (per row, or per
  group by fused multiply-add flushes of 64-wide K-tile partials);
* the 16-bit code decode (a byte permute of the word's nibbles, offset by
  a base and re-centred by one subtraction), the 2^23 float trick for a
  field's code, and bfloat16 rounding in integer ops;
* the split softmax of ``kv_attention``: the live keys cut into
  contiguous shares (the kernel's plan), per-split (m, l, acc) merged
  across the cluster's blocks, empty splits included;
* the int8 tensor-core fragments of ``fused_group`` and ``fused_nce``
  (``csrc/int8_mma.cuh``): spike nibbles expanded to 0/1 bytes, codes
  decoded to signed bytes, the m16n8k32 lane maps, and the quad-shuffle
  assembly of a pixel's packed word with the ``n_out`` mask, bit for bit
  against ``pack_bool``;
* ``fused_group``'s member-major walk (each member over a T chunk, the
  kernel's task assignment over the cluster, membranes carried per task
  and across chunks) and ``fused_nce``'s K split over a cluster with the
  T-scan epilogue, both bit-exact with the plain versions;
* ``fused_conv``'s unit walk (the block/team/unit assignment, the K
  split over a team, T in chunks of up to 4 steps, the in-kernel halo at
  SAME/VALID and stride 1/2, staged or L2 codes), through the m16n8k32
  lane maps and the quad-shuffle words, and ``spike_matmul`` as
  ``fused_nce``'s product at T=1 over every split, bit-exact;
* the wrappers' launch plans (cluster size, T chunk, weight staging,
  contraction split, conv teams) within ``SMEM_LIMIT``;
* ``lif_step``'s packed entry: its warp-stride walk over (row, word)
  pairs, each lane's unsigned-add LIF and the warp's ``__ballot_sync``,
  bit for bit against ``lif_step_ref`` then ``pack_bool``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import packing
from repro_torch.core.lif import lif_step_int
from repro_torch.kernels import smem
from repro_torch.kernels.fused_conv import ops as conv_ops
from repro_torch.kernels.fused_conv.ref import (
    conv_out_shape, conv_pads, fused_conv_rollout_torch)
from repro_torch.kernels.fused_group import ops as group_ops
from repro_torch.kernels.fused_group.ref import (
    fused_group_rollout_torch, maxpool_packed)
from repro_torch.kernels.fused_nce import ops as nce_ops
from repro_torch.kernels.fused_nce.ref import fused_nce_rollout_torch
from repro_torch.kernels.kv_attention import ops as kv_ops
from repro_torch.kernels.kv_attention import ref as kv_ref
from repro_torch.kernels.packed_qmatmul import ops as qmm_ops
from repro_torch.kernels.packed_qmatmul import ref as qmm_ref
from repro_torch.kernels.lif_step.ref import lif_step_ref
from repro_torch.kernels.spike_matmul.ref import spike_matmul_ref
from repro_torch.quant.formats import PrecisionConfig
from repro_torch.quant.ptq import quantize, quantize_conv


# --- shape choices ----------------------------------------------------------


@pytest.mark.parametrize("m,dtype,gs,want", [
    (63, torch.bfloat16, -1, "gemv"),
    (64, torch.bfloat16, -1, "mma"),
    (64, torch.float16, 128, "mma"),
    (4096, torch.bfloat16, 64, "mma"),
    (64, torch.bfloat16, 32, "gemv"),     # groups narrower than a K tile
    (256, torch.bfloat16, 96, "gemv"),    # groups across K tiles
    (4096, torch.float32, -1, "gemv"),    # float32 x keeps CUDA cores
    (8, torch.bfloat16, -1, "gemv"),      # a decode step
    (1, torch.float16, -1, "gemv"),
])
def test_variant_choice_at_its_edges(m, dtype, gs, want):
    assert qmm_ops._variant(m, dtype, gs) == want


@pytest.mark.parametrize("m,n,grouped,want", [
    (4096, 2048, False, (128, 256)),      # olmo-1b q/k/v/o, INT4-KV prefill
    (4096, 8192, False, (128, 256)),
    (4096, 2048, True, (128, 64)),        # 256-wide tiles are per-row only
    (256, 8192, False, (128, 64)),
    (256, 2048, False, (64, 64)),         # too few 128-row tiles anywhere
    (64, 64, True, (64, 64)),
    (1056, 2048, False, (128, 64)),       # 9 x 8 = 72 < 132 <= 9 x 32
])
def test_mma_tile_fills_the_card(m, n, grouped, want):
    bm, bn = qmm_ops._mma_tile(m, n, grouped)
    assert (bm, bn) == want
    blocks = -(-m // bm) * -(-n // bn)
    assert blocks >= qmm_ops.N_SMS or (bm, bn) == (64, 64)


@pytest.mark.parametrize("pairs,want", [
    (1, 8), (16, 8), (33, 8), (34, 4), (66, 4), (67, 2), (128, 2),
    (100000, 2),
])
def test_split_keeps_one_wave(pairs, want):
    split = kv_ops._split(pairs)
    assert split == want
    assert pairs * split <= 2 * kv_ops.N_SMS or split == 2


# --- packed_qmatmul: the tensor-core order ---------------------------------


def _qt_and_x(m, k, n, bits, gs, seed):
    g = np.random.default_rng(seed)
    x = torch.from_numpy(g.standard_normal((m, k)).astype(np.float32))
    wf = torch.from_numpy((g.standard_normal((n, k)) * 0.05)
                          .astype(np.float32))
    qt = quantize(wf, PrecisionConfig(bits=bits, group_size=gs))
    return x.to(torch.bfloat16), qt


def _mma_order(x, qt, k_tile=64):
    """The mma variant's arithmetic: codes as exact 16-bit values times x,
    float32 partials over 64-wide K tiles; per row the scale multiplies
    the sum, per group total = fmaf(scale, partial, total) at each group
    boundary (float64 then one rounding stands in for the fused
    multiply-add)."""
    n, k = qt.shape
    codes = packing.unpack(qt.data, qt.bits, k).to(torch.float32)
    xf = x.to(torch.float32)
    grouped = qt.n_groups > 1
    gs = k // qt.n_groups
    acc = torch.zeros((x.shape[0], n), dtype=torch.float32)
    tot = torch.zeros_like(acc)
    for k0 in range(0, k, k_tile):
        acc = acc + xf[:, k0:k0 + k_tile] @ codes[:, k0:k0 + k_tile].T
        end = k0 + k_tile
        if grouped and (end % gs == 0 or end >= k):
            sc = qt.scale[:, (end - 1) // gs].to(torch.float64)
            tot = (sc[None, :] * acc.to(torch.float64)
                   + tot.to(torch.float64)).to(torch.float32)
            acc = torch.zeros_like(acc)
    if grouped:
        return tot
    return acc * qt.scale[:, 0][None, :]


@pytest.mark.parametrize("bits,gs", [(4, -1), (4, 128), (8, -1), (2, 128)])
def test_tensor_core_order_matches_plain(bits, gs):
    """At olmo-1b's 2048 x 2048 (the q/k/v/o linears), within the CUDA
    test's tolerance: a bf16 ulp of the output plus 1e-4 of its scale."""
    x, qt = _qt_and_x(16, 2048, 2048, bits, gs, seed=bits * 100 + gs)
    got = _mma_order(x, qt).to(torch.bfloat16).float()
    ref = qmm_ref.qmatmul_ref(x, qt).float()
    err = (got - ref).abs()
    assert float((err - 2.0 ** -7 * ref.abs()).max()) <= 1e-4 * float(
        ref.abs().max())


def test_codes_times_bf16_x_are_exact_in_float32():
    """Why the order is exact: a bf16 value (8 significant bits) times a
    code of at most 8 bits has at most 16, inside float32's 24."""
    g = np.random.default_rng(0)
    x = torch.from_numpy(g.standard_normal(4096).astype(np.float32))
    xb = x.to(torch.bfloat16).to(torch.float64)
    for code in (-128, -77, -8, -1, 1, 7, 127):
        prod64 = xb * code
        assert torch.equal(prod64.to(torch.float32).to(torch.float64),
                           prod64)


# --- the 16-bit code decode and the float tricks ---------------------------


def _byte_perm(a, b, sel):
    """CUDA's __byte_perm: result byte k is byte sel[k] of the 8 bytes
    (a's bytes 0-3, then b's)."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + \
          [(b >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * k)) & 0x7] << (8 * k) for k in range(4))


def _bits_to(dtype, half):
    return torch.tensor([half], dtype=torch.int16).view(dtype).float().item()


@pytest.mark.parametrize("dtype,base", [(torch.bfloat16, 0x4300),
                                        (torch.float16, 0x6400)])
def test_word4_decode_by_byte_permute(dtype, base):
    """decode_word4: even and odd nibbles split into bytes, pair i
    gathered by one byte permute, masked, offset by the base (bf16 128.0,
    fp16 1024.0, both with a unit step) and re-centred by base + 8: the
    pair (2i, 2i + 1) of signed codes, low half first."""
    words = np.random.default_rng(1).integers(0, 2 ** 32, 200,
                                              dtype=np.uint64)
    sub = _bits_to(dtype, base + 8)
    for v in [int(w) for w in words] + [0, 0xFFFFFFFF, 0x89ABCDEF]:
        ev = v & 0x0F0F0F0F
        od = (v >> 4) & 0x0F0F0F0F
        want = [((v >> (4 * f)) & 0xF) - 8 for f in range(8)]
        for i in range(4):
            sel = i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12)
            p = (_byte_perm(ev, od, sel) & 0x000F000F) | (base | base << 16)
            lo, hi = p & 0xFFFF, p >> 16
            for half, code in ((lo, want[2 * i]), (hi, want[2 * i + 1])):
                s16 = half - (1 << 16) if half >= 1 << 15 else half
                assert _bits_to(dtype, s16) - sub == code


def test_field_code_float_trick():
    """2^23 + u is a float whose low mantissa bits are u; subtracting
    2^23 + 2^(bits - 1) leaves the signed code exactly."""
    for bits in (2, 4, 8):
        u = np.arange(1 << bits, dtype=np.uint32)
        f = (u | np.uint32(0x4B000000)).view(np.float32)
        code = f - np.float32(8388608.0 + (1 << (bits - 1)))
        assert np.array_equal(code, u.astype(np.float32) - (1 << (bits - 1)))


def test_bf16_round_in_integer_ops():
    """kv_attention rounds dequantized K and V to bfloat16 with
    u += 0x7FFF + ((u >> 16) & 1); u &= 0xFFFF0000: the same as the
    conversion PyTorch does (ties to even)."""
    g = np.random.default_rng(2)
    v = np.concatenate([g.standard_normal(20000).astype(np.float32) * 3,
                        np.float32([0.0, -0.0, 1.0, 1.00390625, 1.01171875,
                                    -2.5e-3, 7e-39])])
    u = v.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    got = u.astype(np.uint32).view(np.float32)
    want = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
    assert np.array_equal(got, want)


# --- kv_attention: the split softmax ---------------------------------------


def _key_shares(length, s_len, window, split):
    """The kernel's plan (j_lo, j_hi in csrc/kv_attention.cu): block r of
    ``split`` takes the r-th contiguous share of ceil(live / split) of the
    live keys [max(0, len - window), min(len, S)); the shares past them
    are empty.  Asserts that they tile the live keys exactly."""
    hi = min(length, s_len)
    lo = max(0, length - window) if window > 0 else 0
    live = max(0, hi - lo)
    per = -(-live // split)
    plan = [(lo + min(live, r * per), lo + min(live, (r + 1) * per))
            for r in range(split)]
    for (a, b), (c, _) in zip(plan, plan[1:]):
        assert a <= b == c
    assert sum(b - a for a, b in plan) == live
    if live < split:
        assert sum(b == a for a, b in plan) >= split - live
    return plan


def _split_softmax(q, kp, ks, vp, vs, *, bits, scale, lens, window, split):
    """The kernel's arithmetic: per (b, kv head) the live keys split by
    the kernel's plan; each split's running max m (-inf when empty), sum
    l and unnormalised acc; merged by weights exp(m_r - max m) (0 for an
    empty split) and divided by max(l, 1e-20)."""
    b, _, h, hd = q.shape
    s_len, kh = kp.shape[1], kp.shape[2]
    g = h // kh
    k = kv_ref.dequantize_kv(kp, ks, bits, hd).float()
    v = kv_ref.dequantize_kv(vp, vs, bits, hd).float()
    qg = q.reshape(b, kh, g, hd).to(torch.bfloat16).float()
    out = torch.zeros((b, kh, g, hd))
    for bi in range(b):
        for hi in range(kh):
            parts = []
            for lo, up in _key_shares(int(lens[bi]), s_len, window, split):
                if up <= lo:
                    parts.append((float("-inf"), torch.zeros(g),
                                  torch.zeros(g, hd)))
                    continue
                s = qg[bi, hi] @ k[bi, lo:up, hi].T * scale       # (g, n)
                m = s.max(dim=1).values
                p = torch.exp(s - m[:, None])
                parts.append((m, p.sum(1), p @ v[bi, lo:up, hi]))
            ms = [pm for pm, _, _ in parts if not isinstance(pm, float)]
            if not ms:
                continue                              # every split empty
            mx = torch.stack(ms).max(dim=0).values
            num, den = torch.zeros(g, hd), torch.zeros(g)
            for m, l_, acc in parts:
                if isinstance(m, float):
                    continue
                wgt = torch.exp(m - mx)
                num += wgt[:, None] * acc
                den += wgt * l_
            out[bi, hi] = num / torch.clamp(den, min=1e-20)[:, None]
    return out.reshape(b, 1, h, hd)


@pytest.mark.parametrize("lens,window,split", [
    ((1, 7, 544, 1024), 0, 8),
    ((1, 7, 544, 1024), 0, 2),
    ((544, 100, 3, 1024), 5, 8),      # 5 live keys: 3 of 8 splits empty
    ((2, 1024, 600, 9), 256, 4),
])
def test_split_softmax_matches_plain(lens, window, split):
    """The CUDA test's tolerance (atol 1e-2, rtol 2e-2): the plain version
    normalises and rounds each probability to bf16 first."""
    gen = torch.Generator().manual_seed(sum(lens) + split)
    b, s_len, kh, g, hd, bits = len(lens), 1024, 2, 2, 64, 4
    q = torch.randn((b, 1, kh * g, hd), generator=gen)
    kp, ks = kv_ref.quantize_kv(torch.randn((b, s_len, kh, hd),
                                            generator=gen), bits)
    vp, vs = kv_ref.quantize_kv(torch.randn((b, s_len, kh, hd),
                                            generator=gen), bits)
    cl = torch.tensor(lens, dtype=torch.int32)
    got = _split_softmax(q, kp, ks, vp, vs, bits=bits, scale=hd ** -0.5,
                         lens=cl, window=window, split=split)
    ref = kv_ref.quant_kv_decode_attention_ref(
        q, kp, ks, vp, vs, bits=bits, scale=hd ** -0.5, cache_len=cl,
        window=window)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref.float(), atol=1e-2, rtol=2e-2)


@pytest.mark.parametrize("split", [2, 4, 8])
@pytest.mark.parametrize("window", [0, 5, 256])
def test_split_softmax_over_lens_and_windows(split, window):
    """Every length from 1 key to past S, under no window, one narrower
    than the splits (empty shares) and a wide one, at the CUDA test's
    tolerance."""
    lens = (1, 7, 9, 544, 1023, 1024)
    gen = torch.Generator().manual_seed(split * 1000 + window)
    b, s_len, kh, g, hd, bits = len(lens), 1024, 1, 2, 64, 4
    q = torch.randn((b, 1, kh * g, hd), generator=gen)
    kp, ks = kv_ref.quantize_kv(torch.randn((b, s_len, kh, hd),
                                            generator=gen), bits)
    vp, vs = kv_ref.quantize_kv(torch.randn((b, s_len, kh, hd),
                                            generator=gen), bits)
    cl = torch.tensor(lens, dtype=torch.int32)
    got = _split_softmax(q, kp, ks, vp, vs, bits=bits, scale=hd ** -0.5,
                         lens=cl, window=window, split=split)
    ref = kv_ref.quant_kv_decode_attention_ref(
        q, kp, ks, vp, vs, bits=bits, scale=hd ** -0.5, cache_len=cl,
        window=window)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref.float(), atol=1e-2, rtol=2e-2)


def test_split_softmax_empty_cache_is_zeros():
    """cache_len 0 empties every split: the merge weighs them all 0 and
    writes zeros (the kernel's documented output)."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((2, 1, 2, 64), generator=gen)
    kp, ks = kv_ref.quantize_kv(torch.randn((2, 32, 1, 64), generator=gen), 4)
    got = _split_softmax(q, kp, ks, kp, ks, bits=4, scale=0.125,
                         lens=torch.zeros(2, dtype=torch.int32), window=0,
                         split=8)
    assert torch.equal(got, torch.zeros_like(got))


# --- int8 tensor-core fragments (csrc/int8_mma.cuh) -------------------------

_M32 = 0xFFFFFFFF


def _spikes_s8(word, nib):
    """``spikes_s8``: nibble ``nib`` of a spike word -> four 0/1 bytes."""
    nv = (int(word) & _M32) >> (4 * nib) & 0xF
    return (nv * 0x00204081) & 0x01010101


def _codes_s8(wk, half, q, bits):
    """``codes_s8``: B register ``half`` of lane quad index ``q`` from the
    ``bits`` words of a k-step, fields spread to bytes and re-centred."""
    off = (half * 16 + q * 4) * bits
    e = (int(wk[off >> 5]) & _M32) >> (off & 31)
    if bits == 4:
        e &= 0xFFFF
        e = (e | (e << 8)) & 0x00FF00FF
        e = (e | (e << 4)) & 0x0F0F0F0F
    elif bits == 2:
        e &= 0xFF
        e = (e | (e << 12)) & 0x000F000F
        e = (e | (e << 6)) & 0x03030303
    add = (128 - (1 << (bits - 1))) * 0x01010101
    return ((e + add) & _M32) ^ 0x80808080


def _s8(reg):
    """The four signed bytes of a register, lowest first."""
    return [((reg >> (8 * i) & 0xFF) ^ 0x80) - 0x80 for i in range(4)]


def _mma_m16n8k32(a, b):
    """mma.sync m16n8k32 s8: per-lane A (4 regs) and B (2 regs) fragments
    -> per-lane C (4 s32), through the PTX fragment maps."""
    am = np.zeros((16, 32), np.int64)
    bm = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, q = lane >> 2, lane & 3
        am[g, 4 * q:4 * q + 4] = _s8(a[lane][0])
        am[g + 8, 4 * q:4 * q + 4] = _s8(a[lane][1])
        am[g, 16 + 4 * q:20 + 4 * q] = _s8(a[lane][2])
        am[g + 8, 16 + 4 * q:20 + 4 * q] = _s8(a[lane][3])
        bm[4 * q:4 * q + 4, g] = _s8(b[lane][0])
        bm[16 + 4 * q:20 + 4 * q, g] = _s8(b[lane][1])
    d = am @ bm
    return [(d[l >> 2, 2 * (l & 3)], d[l >> 2, 2 * (l & 3) + 1],
             d[(l >> 2) + 8, 2 * (l & 3)], d[(l >> 2) + 8, 2 * (l & 3) + 1])
            for l in range(32)]


def _tile_product(words16, wrows, bits):
    """One 16-row x 32-channel tile over a run of k-steps, the kernels'
    way: ``words16`` (16, ksteps) spike words, ``wrows`` (32, ksteps *
    bits) code words; 4 accumulators of 8 channels per lane.  Returns
    acc[lane][j][e]."""
    acc = [[[0] * 4 for _ in range(4)] for _ in range(32)]
    for kq in range(words16.shape[1]):
        a = []
        for lane in range(32):
            g, q = lane >> 2, lane & 3
            lo, hi = words16[g, kq], words16[g + 8, kq]
            a.append((_spikes_s8(lo, q), _spikes_s8(hi, q),
                      _spikes_s8(lo, q + 4), _spikes_s8(hi, q + 4)))
        for j in range(4):
            b = []
            for lane in range(32):
                row = wrows[j * 8 + (lane >> 2), kq * bits:(kq + 1) * bits]
                b.append((_codes_s8(row, 0, lane & 3, bits),
                          _codes_s8(row, 1, lane & 3, bits)))
            c = _mma_m16n8k32(a, b)
            for lane in range(32):
                for e in range(4):
                    acc[lane][j][e] += int(c[lane][e])
    return acc


def _quad_words(fire, q_of_lane):
    """Each lane's partial words for pixels g and g+8 from its fire bits
    fire[lane][j][e], then the two xor-shuffles over the quad."""
    lo = [0] * 32
    hi = [0] * 32
    for lane in range(32):
        q = q_of_lane(lane)
        for j in range(4):
            for e in range(4):
                bit = int(fire[lane][j][e]) << (j * 8 + 2 * q + (e & 1))
                if e < 2:
                    lo[lane] |= bit
                else:
                    hi[lane] |= bit
    for mask in (1, 2):          # __shfl_xor_sync(w, 1), then (w, 2)
        lo = [lo[l] | lo[l ^ mask] for l in range(32)]
        hi = [hi[l] | hi[l ^ mask] for l in range(32)]
    return lo, hi


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_code_decode_is_signed_bytes(bits):
    """Every code of every field position decodes to code - 2^(bits-1)."""
    vpw = 32 // bits
    vals = np.arange(32) % (1 << bits) - (1 << (bits - 1))
    for shift in range(1 << bits):
        codes = np.roll(vals, shift)
        wk = packing.pack_np(codes[None], bits)[0]
        for half in (0, 1):
            for q in range(4):
                k0 = half * 16 + q * 4
                assert _s8(_codes_s8(wk, half, q, bits)) == list(
                    codes[k0:k0 + 4])
    assert len(wk) == bits and vpw * bits == 32


@pytest.mark.parametrize("n_out", [36, 100, 512])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_fragment_lane_map_and_quad_words_match_pack_bool(n_out, bits):
    """A 16-pixel x 32-channel tile of every 32-channel group of a layer
    with ``n_out`` channels: the m16n8k32 product through the lane maps
    equals the plain product, and LIF on the accumulator positions with
    the n_out mask before the reset, then the quad's shuffles, gives
    pack_bool's words bit for bit (pixel g from lane 4g's lo word, pixel
    g+8 from its hi word)."""
    rng = np.random.default_rng(n_out * 10 + bits)
    ksteps = 3
    n_pad = -(-n_out // 32) * 32
    spikes = rng.random((16, 32 * ksteps)) < 0.3
    words16 = packing.pack_np(spikes.astype(np.int32), 1)
    qmax = (1 << (bits - 1)) - 1
    codes = rng.integers(-qmax - 1, qmax + 1, (n_out, 32 * ksteps))
    wq = packing.pack_np(codes, bits)
    theta = rng.integers(1, 4 * qmax + 2, n_out)
    v0 = rng.integers(-3 * qmax, 3 * qmax, (16, n_pad))
    cur = spikes.astype(np.int64) @ codes.T.astype(np.int64)
    v_ref, s_ref = lif_step_int(
        torch.from_numpy(v0[:, :n_out].astype(np.int32)),
        torch.from_numpy(cur.astype(np.int32)), leak_shift=2,
        threshold_q=torch.from_numpy(theta.astype(np.int32)), v_reset_q=-1,
        soft_reset=True)
    want = packing.pack_bool(s_ref)                     # (16, n_pad / 32)
    for gr in range(n_pad // 32):
        rows = np.zeros((32, ksteps * bits), np.int64)
        live = min(32, n_out - gr * 32)
        rows[:live] = wq[gr * 32:gr * 32 + live]
        acc = _tile_product(words16, rows, bits)
        fire = [[[False] * 4 for _ in range(4)] for _ in range(32)]
        for lane in range(32):
            g, q = lane >> 2, lane & 3
            for j in range(4):
                for e in range(4):
                    p = g + 8 * (e >> 1)
                    ch = gr * 32 + j * 8 + 2 * q + (e & 1)
                    if ch < n_out:
                        assert acc[lane][j][e] == cur[p, ch]
                    v = int(v0[p, ch])
                    v = v - (v >> 2) + acc[lane][j][e]
                    fire[lane][j][e] = ch < n_out and v >= theta[ch]
                    if fire[lane][j][e]:
                        v -= int(theta[ch])
                    if ch < n_out:
                        assert v == int(v_ref[p, ch])
        lo, hi = _quad_words(fire, lambda lane: lane & 3)
        for g in range(8):
            for lane in range(4 * g, 4 * g + 4):   # every lane of the quad
                assert (lo[lane] ^ int(want[g, gr])) & _M32 == 0
                assert (hi[lane] ^ int(want[g + 8, gr])) & _M32 == 0


# --- fused_group: the member-major walk -------------------------------------


def _chain(spec, c_in, bits, seed):
    g = np.random.default_rng(seed)
    members, c = [], c_in
    for item in spec:
        if item == "P":
            members.append(("pool", 2))
            continue
        wf = torch.from_numpy((g.standard_normal((3, 3, c, item)) * 0.2)
                              .astype(np.float32))
        qct = quantize_conv(wf, PrecisionConfig(bits=bits))
        qmax = (1 << (bits - 1)) - 1
        theta = torch.from_numpy(
            g.integers(1, 18 * qmax + 2, item).astype(np.int32))
        members.append(("conv", qct, theta))
        c = item
    return tuple(members)


def _assignment(groups, tiles, cl):
    """The kernel's task assignment of a conv member (``conv_member``):
    every block's (group, pixel tile) units."""
    out = {}
    for rank in range(cl):
        gl_n = min(groups, cl)
        gl = rank % gl_n
        nb = (cl - 1 - gl) // gl_n + 1
        bi = rank // gl_n
        owned = (groups - 1 - gl) // gl_n + 1
        my_tiles = (tiles - 1 - bi) // nb + 1 if bi < tiles else 0
        out[rank] = [(gl + (u // my_tiles) * gl_n,
                      bi + (u % my_tiles) * nb)
                     for u in range(owned * my_tiles)]
    return out


def _member_major(planes, members, *, tc, cl, leak_shift, v_reset_q,
                  soft_reset):
    """The fused_group kernel's walk: per chunk of ``tc`` steps, each
    member over the whole chunk; a conv member's units (16 pixels x 32
    channels) dealt over the cluster as the kernel deals them, each
    carrying its membrane over the chunk's steps and through a scratch
    across chunks; planes stay packed words between members."""
    t_all, b = planes.shape[:2]
    x_all = planes
    scratch = {}
    outs, v_last = [], None
    for t0 in range(0, t_all, tc):
        x = x_all[t0:t0 + tc]
        nt = x.shape[0]
        for mi, m in enumerate(members):
            if m[0] == "pool":
                ch = members[mi - 1][1].c_out
                x = maxpool_packed(x, ch, m[1])
                continue
            _, qct, theta = m
            h, w = x.shape[2:4]
            npix = h * w
            groups = -(-qct.c_out // 32)
            tiles = -(-npix // 16)
            codes = packing.unpack(qct.data, qct.bits, qct.k_flat).to(
                torch.int64)                       # (c_out, k*k*cin_pad)
            s = packing.unpack_bool(x, qct.c_in_pad).to(torch.int64)
            s = torch.nn.functional.pad(s, (0, 0, 1, 1, 1, 1))
            # (nt, b, npix, 9*cin_pad) receptive fields, tap-major
            cols = torch.stack([s[:, :, di:di + h, dj:dj + w]
                                for di in range(3) for dj in range(3)],
                               dim=4).reshape(nt, b, npix, -1)
            fire = torch.zeros((nt, b, npix, groups * 32), dtype=torch.int32)
            seen = []
            for rank, units in _assignment(groups, tiles, cl).items():
                for gr, tile in units:
                    seen.append((gr, tile))
                    px = torch.arange(tile * 16, min(tile * 16 + 16, npix))
                    chs = torch.arange(gr * 32, min(gr * 32 + 32,
                                                    qct.c_out))
                    key = (mi, gr, tile)
                    v = scratch.get(key, torch.zeros(
                        (b, len(px), len(chs)), dtype=torch.int64))
                    th = theta[chs].to(torch.int64)
                    for t in range(nt):
                        cur = cols[t][:, px] @ codes[chs].T
                        v = v - (v >> leak_shift) + cur
                        f = v >= th
                        v = torch.where(f, v - th if soft_reset
                                        else torch.full_like(v, v_reset_q),
                                        v)
                        fire[t][:, px[:, None], chs[None, :]] = \
                            f.to(torch.int32)
                    scratch[key] = v
                    if mi == max(i for i, mm in enumerate(members)
                                 if mm[0] == "conv"):
                        if v_last is None:
                            v_last = torch.zeros((b, npix, qct.c_out),
                                                 dtype=torch.int64)
                        v_last[:, px[:, None], chs[None, :]] = v
            assert sorted(seen) == [(g, t) for g in range(groups)
                                    for t in range(tiles)]
            x = packing.pack_bool(fire.reshape(nt, b, h, w, -1))
        outs.append(x)
    return v_last, torch.cat(outs)


@pytest.mark.parametrize("spec,hw,c_in", [
    ([40, "P", 36, "P"], 12, 20),          # chip_smoke's ragged chain
    ([32, "P", 64, 64, "P"], 8, 32),       # a narrow vgg9-like chain
])
@pytest.mark.parametrize("tc", [1, 3, 5])
@pytest.mark.parametrize("cl", [16, 8])
def test_member_major_walk_matches_plain(spec, hw, c_in, tc, cl):
    bits = 4
    members = _chain(spec, c_in, bits, seed=hw + tc)
    s = np.random.default_rng(hw * 3 + tc).random((5, 2, hw, hw, c_in))
    planes = torch.from_numpy(packing.pack_np((s < 0.3).astype(np.int32),
                                              1))
    kw = dict(leak_shift=3, v_reset_q=-2, soft_reset=tc != 3)
    pv, ps = fused_group_rollout_torch(planes, members, **kw)
    v, out = _member_major(planes, members, tc=tc, cl=cl, **kw)
    assert torch.equal(out, ps)
    assert torch.equal(v.reshape(pv.shape).to(torch.int32), pv)
    assert ps.any()


# --- fused_nce: the K split and the T-scan epilogue -------------------------


def _nce_partials(spikes, qt, d_in, *, rb, split):
    """The product stage the fused_nce and spike_matmul kernels share
    (``csrc/nce_product.cuh``) for one (rb, split) launch: per (group, row
    chunk) cluster, block s takes spike words [s*ks, s*ks+ks), its warps
    the two halves of them; bits past d_in masked, code words past the
    row's end zero.  Returns {r0: partials (split, 2, T*rb, n_pad)}, local
    row t*rb + r."""
    t_steps, m, kwords = spikes.shape
    n = qt.shape[0]
    n_pad = -(-n // 32) * 32
    wpr = qt.data.shape[1]
    sp = spikes.numpy().astype(np.int64) & _M32
    if d_in % 32:
        sp[..., -1] &= (1 << (d_in % 32)) - 1
    ks = -(-kwords // split)
    wpad = np.zeros((n_pad, ks * split * qt.bits), np.int64)
    wpad[:n, :wpr] = qt.data.numpy().astype(np.int64) & _M32
    bits = qt.bits
    # signed codes of every k, from the padded words (zeros decode -bias)
    codes = packing.unpack_np(wpad.astype(np.uint32).astype(np.int32),
                              bits, ks * split * 32).astype(np.int64)
    ones = packing.unpack_np(sp.astype(np.uint32).astype(np.int32), 1,
                             kwords * 32).astype(np.int64)
    out = {}
    for r0 in range(0, m, rb):
        rows = [(t, r) for t in range(t_steps) for r in range(rb)]
        part = np.zeros((split, 2, len(rows), n_pad), np.int64)
        for s in range(split):
            kw = max(0, min(ks, kwords - s * ks))
            halves = ((0, (kw + 1) // 2), ((kw + 1) // 2, kw))
            for hf, (lo, hi) in enumerate(halves):
                k0, k1 = (s * ks + lo) * 32, (s * ks + hi) * 32
                for j, (t, r) in enumerate(rows):
                    if r0 + r < m:
                        part[s, hf, j] = ones[t, r0 + r, k0:k1] @ \
                            codes[:, k0:k1].T
        out[r0] = part
    return out


def _nce_emulated(spikes, qt, d_in, theta, *, rb, split, leak_shift,
                  v_reset_q, soft_reset):
    """The fused_nce kernel's arithmetic for one (rb, split) launch: the
    shared product (:func:`_nce_partials`), then the epilogue sums the
    2*split partials of each row and scans T."""
    t_steps, m, _ = spikes.shape
    n = qt.shape[0]
    n_pad = -(-n // 32) * 32
    v_out = np.zeros((m, n_pad), np.int64)
    s_out = np.zeros((t_steps, m, n_pad), bool)
    th = np.zeros(n_pad, np.int64)
    th[:n] = theta
    for r0, part in _nce_partials(spikes, qt, d_in, rb=rb,
                                  split=split).items():
        for r in range(rb):
            if r0 + r >= m:
                break
            v = np.zeros(n_pad, np.int64)
            for t in range(t_steps):
                i_syn = part[:, :, t * rb + r].sum(axis=(0, 1))
                v = v - (v >> leak_shift) + i_syn
                f = (v >= th) & (np.arange(n_pad) < n)
                v = np.where(f, v - th if soft_reset else v_reset_q, v)
                s_out[t, r0 + r] = f
            v_out[r0 + r] = v
    return (torch.from_numpy(v_out[:, :n].astype(np.int32)),
            packing.pack_bool(torch.from_numpy(s_out)))


@pytest.mark.parametrize("m,d_in,d_out", [(8, 4096, 96), (3, 1000, 100),
                                          (13, 1000, 36)])
@pytest.mark.parametrize("split", nce_ops._SPLITS)
def test_nce_k_split_and_t_scan_match_plain(m, d_in, d_out, split):
    bits = {4096: 4, 1000: 8}[d_in] if d_out != 36 else 2
    g = np.random.default_rng(d_in + m + split)
    s = g.random((4, m, d_in)) < 0.2
    spikes = torch.from_numpy(packing.pack_np(s.astype(np.int32), 1))
    if d_in % 32:                        # stray bits past d_in are inert
        spikes[..., -1] |= np.int32(-(1 << (d_in % 32)))
    wf = torch.from_numpy((g.standard_normal((d_out, d_in)) * 0.05)
                          .astype(np.float32))
    qt = quantize(wf, PrecisionConfig(bits=bits))
    qmax = (1 << (bits - 1)) - 1
    theta = g.integers(1, 8 * qmax + 2, d_out).astype(np.int32)
    kw = dict(leak_shift=3, v_reset_q=-2, soft_reset=split != 4)
    pv, ps = fused_nce_rollout_torch(spikes, qt, d_in=d_in,
                                     threshold_q=torch.from_numpy(theta),
                                     **kw)
    rb, _ = nce_ops._nce_plan(4, m, spikes.shape[-1], bits, 128)
    for rows in sorted({rb, 1}):
        v, out = _nce_emulated(spikes, qt, d_in, theta, rb=rows,
                               split=split, **kw)
        assert torch.equal(v, pv) and torch.equal(out, ps)
    assert ps.any()


# --- spike_matmul: fused_nce's product at T=1 ------------------------------


def _spike_matmul_emulated(spikes, qt, d_in, *, rb, split):
    """The spike_matmul kernel: the shared product at T=1, then one warp a
    row sums the row's 2*split partials and stores int32 currents."""
    m = spikes.shape[0]
    n = qt.shape[0]
    out = np.zeros((m, n), np.int64)
    for r0, part in _nce_partials(spikes[None], qt, d_in, rb=rb,
                                  split=split).items():
        for r in range(min(rb, m - r0)):
            out[r0 + r] = part[:, :, r].sum(axis=(0, 1))[:n]
    return torch.from_numpy(out.astype(np.int32))


@pytest.mark.parametrize("m,d_in,d_out,bits", [
    (1, 4096, 512, 4), (8, 4096, 512, 4), (13, 1000, 100, 8),
    (64, 2048, 200, 2)])
@pytest.mark.parametrize("split", nce_ops._SPLITS)
def test_spike_matmul_k_split_matches_plain(m, d_in, d_out, bits, split):
    """Every split the cluster can take, at the plan's rows per block and
    at one row a block, with stray bits past d_in set."""
    g = np.random.default_rng(m * 31 + d_in + split)
    s = g.random((m, d_in)) < 0.2
    spikes = torch.from_numpy(packing.pack_np(s.astype(np.int32), 1))
    if d_in % 32:                        # stray bits past d_in are inert
        spikes[..., -1] |= np.int32(-(1 << (d_in % 32)))
    wf = torch.from_numpy((g.standard_normal((d_out, d_in)) * 0.05)
                          .astype(np.float32))
    qt = quantize(wf, PrecisionConfig(bits=bits))
    want = spike_matmul_ref(spikes, qt, d_in=d_in)
    rb, _ = nce_ops._nce_plan(1, m, spikes.shape[-1], bits,
                              -(-d_out // 32) * 32)
    assert rb == min(m, 64)
    for rows in sorted({rb, 1}):
        got = _spike_matmul_emulated(spikes, qt, d_in, rb=rows, split=split)
        assert torch.equal(got, want)
    assert want.abs().sum() > 0


@pytest.mark.parametrize("m,d_in,d_out,bits,want", [
    (8, 4096, 512, 4, (8, 8)),       # vgg9 fc1: 16 groups x 8 blocks
    (64, 2048, 2048, 8, (64, 2)),    # kernel_bench's NCE step: 64 x 2
    (1, 4096, 512, 4, (1, 8)),
    (200, 1000, 100, 8, (64, 8)),    # 4 row chunks x 4 groups x 8
    (13, 75, 45, 2, (13, 2)),        # 3 spike words: no split past them
])
def test_spike_matmul_plan(m, d_in, d_out, bits, want):
    kwords = -(-d_in // 32)
    n_pad = -(-d_out // 32) * 32
    rb, split = nce_ops._nce_plan(1, m, kwords, bits, n_pad)
    assert (rb, split) == want
    assert (n_pad // 32) * -(-m // rb) * split <= max(
        smem.N_SMS, (n_pad // 32) * -(-m // rb))
    assert nce_ops._nce_smem_bytes(1, rb, kwords, split,
                                   bits) <= smem.SMEM_LIMIT


# --- fused_conv: the unit walk ----------------------------------------------


def _conv_walk(planes, qct, theta, *, stride, padding, leak_shift,
               v_reset_q, soft_reset, ks, staged):
    """The fused_conv kernel's walk: blocks of one 32-channel group, each
    running 8 // ks units (16 output pixels x 32 channels of one batch
    element) with a team of ks warps splitting each unit's k-steps
    [r*nk/ks, (r+1)*nk/ks); per chunk of up to 4 steps a k-step's B
    fragments decoded once (staged rows: channels past c_out zero; L2
    rows: clamped to c_out - 1), every step's A fragments loaded at
    (oy*stride + di - pad_top, ox*stride + dj - pad_left), zero outside
    the plane; the team's partials summed, LIF on the lane map, the
    quad's words stored by lanes q = 0 (pixel g) and q = 1 (pixel g+8)."""
    t_steps, b, h, w, wc = planes.shape
    (pt, _), (pleft, _) = conv_pads(h, w, qct.kh, qct.kw, stride, padding)
    ho, wo = conv_out_shape(h, w, qct, stride, padding)
    npix = ho * wo
    tiles = -(-npix // 16)
    n_out, bits = qct.c_out, qct.bits
    groups = -(-n_out // 32)
    nk = qct.kh * qct.kw * wc
    teams = 8 // ks
    bpg = -(-(tiles * b) // teams)
    x = planes.numpy().astype(np.int64) & _M32
    wq = qct.data.numpy().astype(np.int64) & _M32
    th = theta.numpy().astype(np.int64)
    v_out = np.zeros((b, npix, n_out), np.int64)
    s_out = np.zeros((t_steps, b, npix, groups), np.int64)

    def code_row(gr, c):
        ch = gr * 32 + c
        if staged:
            return wq[ch] if ch < n_out else np.zeros(wq.shape[1], np.int64)
        return wq[min(ch, n_out - 1)]

    frags = {}

    def b_frags(gr, kk):            # [j] -> per-lane (b0, b1)
        if (gr, kk) not in frags:
            frags[gr, kk] = [[(_codes_s8(row, 0, lane & 3, bits),
                               _codes_s8(row, 1, lane & 3, bits))
                              for lane in range(32)
                              for row in [code_row(gr, j * 8 + (lane >> 2))[
                                  kk * bits:(kk + 1) * bits]]]
                             for j in range(4)]
        return frags[gr, kk]

    def word(bb, t, p, tap, q):
        di, dj = divmod(tap, qct.kw)
        y = (p // wo) * stride - pt + di
        xx = (p % wo) * stride - pleft + dj
        if 0 <= y < h and 0 <= xx < w:
            return int(x[t, bb, y, xx, q])
        return 0

    seen = []
    for blk in range(groups * bpg):
        gr, bi = divmod(blk, bpg)
        for team in range(teams):
            u = bi * teams + team
            if u >= tiles * b:
                continue
            bb, tile = divmod(u, tiles)
            seen.append((gr, bb, tile))
            px = [(min(tile * 16 + (lane >> 2), npix - 1),
                   min(tile * 16 + (lane >> 2) + 8, npix - 1))
                  for lane in range(32)]
            mem = np.zeros((32, 4, 4), np.int64)
            for tg in range(0, t_steps, 4):
                ns = min(4, t_steps - tg)
                acc = np.zeros((32, ns, 4, 4), np.int64)
                for trank in range(ks):
                    for kk in range(trank * nk // ks,
                                    (trank + 1) * nk // ks):
                        tap, q = divmod(kk, wc)
                        bf = b_frags(gr, kk)
                        for i in range(ns):
                            a = []
                            for lane in range(32):
                                lo = word(bb, tg + i, px[lane][0], tap, q)
                                hi = word(bb, tg + i, px[lane][1], tap, q)
                                nib = lane & 3
                                a.append((_spikes_s8(lo, nib),
                                          _spikes_s8(hi, nib),
                                          _spikes_s8(lo, nib + 4),
                                          _spikes_s8(hi, nib + 4)))
                            for j in range(4):
                                acc[:, i, j] += np.array(
                                    _mma_m16n8k32(a, bf[j]), np.int64)
                for i in range(ns):
                    fire = [[[False] * 4 for _ in range(4)]
                            for _ in range(32)]
                    for lane in range(32):
                        for j in range(4):
                            for e in range(4):
                                ch = gr * 32 + j * 8 + 2 * (lane & 3) + \
                                    (e & 1)
                                live = ch < n_out
                                theta_c = th[ch] if live else 0
                                v = int(mem[lane, j, e])
                                v = v - (v >> leak_shift) + int(
                                    acc[lane, i, j, e])
                                f = live and v >= theta_c
                                if f:
                                    v = v - theta_c if soft_reset \
                                        else v_reset_q
                                mem[lane, j, e] = v
                                fire[lane][j][e] = f
                    lo, hi = _quad_words(fire, lambda lane: lane & 3)
                    for lane in range(32):
                        p_lo = tile * 16 + (lane >> 2)
                        if lane & 3 == 0 and p_lo < npix:
                            s_out[tg + i, bb, p_lo, gr] = lo[lane]
                        if lane & 3 == 1 and p_lo + 8 < npix:
                            s_out[tg + i, bb, p_lo + 8, gr] = hi[lane]
            for lane in range(32):
                for j in range(4):
                    for e in range(4):
                        p = tile * 16 + (lane >> 2) + 8 * (e >> 1)
                        ch = gr * 32 + j * 8 + 2 * (lane & 3) + (e & 1)
                        if ch < n_out and p < npix:
                            v_out[bb, p, ch] = mem[lane, j, e]
    assert sorted(seen) == [(gr, bb, tl) for gr in range(groups)
                            for bb in range(b) for tl in range(tiles)]
    s_out = (s_out & _M32).astype(np.uint32).astype(np.int32)
    return (torch.from_numpy(v_out.astype(np.int32)).reshape(
                b, ho, wo, n_out),
            torch.from_numpy(s_out).reshape(t_steps, b, ho, wo, groups))


# (h, w, c_in, c_out, k, stride, padding, bits, b)
_WALK_GEOMS = {
    "ragged s1": (9, 7, 40, 36, 3, 1, "SAME", 4, 1),
    "s2 asym": (8, 6, 40, 36, 3, 2, "SAME", 8, 2),   # SAME pads (0, 1)
    "1x1 s2": (9, 9, 33, 70, 1, 2, "SAME", 2, 1),
    "valid": (7, 6, 20, 40, 3, 1, "VALID", 4, 1),
}


def _walk_case(name, t_steps, seed):
    h, w, c_in, c_out, k, stride, padding, bits, b = _WALK_GEOMS[name]
    g = np.random.default_rng(seed)
    s = g.random((t_steps, b, h, w, c_in)) < 0.3
    planes = torch.from_numpy(packing.pack_np(s.astype(np.int32), 1))
    wf = torch.from_numpy((g.standard_normal((k, k, c_in, c_out)) * 0.2)
                          .astype(np.float32))
    qct = quantize_conv(wf, PrecisionConfig(bits=bits))
    qmax = (1 << (bits - 1)) - 1
    theta = torch.from_numpy(
        g.integers(1, 3 * k * qmax + 2, c_out).astype(np.int32))
    return planes, qct, theta, dict(stride=stride, padding=padding)


@pytest.mark.parametrize("name", sorted(_WALK_GEOMS))
@pytest.mark.parametrize("t_steps", [1, 3, 5])
def test_conv_unit_walk_matches_plain(name, t_steps):
    """The walk under the wrapper's own plan: T chunks of 4 with a tail,
    the in-kernel halo at SAME (asymmetric at stride 2) and VALID, 1x1
    and 3x3 taps, ragged c_in / c_out."""
    planes, qct, theta, geo = _walk_case(name, t_steps, t_steps * 7)
    kw = dict(leak_shift=3, v_reset_q=-2, soft_reset=t_steps != 3)
    pv, ps = fused_conv_rollout_torch(planes, qct, threshold_q=theta,
                                      **geo, **kw)
    ho, wo = pv.shape[1:3]
    wc = planes.shape[-1]
    ks, _, staged = conv_ops._conv_plan(
        planes.shape[1], ho * wo, -(-qct.c_out // 32),
        qct.kh * qct.kw * wc, qct.data.shape[1])
    v, out = _conv_walk(planes, qct, theta, ks=ks, staged=staged, **geo,
                        **kw)
    assert torch.equal(out, ps) and torch.equal(v, pv)
    assert ps.any()


@pytest.mark.parametrize("ks", [1, 2, 4, 8])
@pytest.mark.parametrize("staged", [True, False])
def test_conv_teams_and_l2_codes_match_plain(ks, staged):
    """Every team size the kernel takes, with codes staged (zero rows past
    c_out) or read from L2 (rows clamped to c_out - 1, masked)."""
    planes, qct, theta, geo = _walk_case("s2 asym", 5, ks + 10 * staged)
    kw = dict(leak_shift=2, v_reset_q=1, soft_reset=staged)
    pv, ps = fused_conv_rollout_torch(planes, qct, threshold_q=theta,
                                      **geo, **kw)
    v, out = _conv_walk(planes, qct, theta, ks=ks, staged=staged, **geo,
                        **kw)
    assert torch.equal(out, ps) and torch.equal(v, pv)
    assert ps.any()


# --- the launch plans -------------------------------------------------------

# chip_smoke.py's group_chains (hw, c_in, spec), resnet18 blocks.7 included
_SMOKE_CHAINS = {
    "vgg9": (32, 64, [64, "P", 128, 128, "P", 256, "P"]),
    "blocks.0": (32, 64, [64, 64]),
    "blocks.3": (16, 128, [128, 128]),
    "blocks.5": (8, 256, [256, 256]),
    "blocks.7": (4, 512, [512, 512]),
    "ragged": (12, 20, [40, "P", 36, "P"]),
}


def _geoms(hw, c_in, spec, bits):
    out, c, h = [], c_in, hw
    for item in spec:
        if item == "P":
            out.append(("pool", 2, h, h, -(-c // 32) * 32))
            h //= 2
        else:
            out.append(("conv", bits, 3, -(-c // 32) * 32, h, h,
                        -(-item // 32) * 32, item))
            c = item
    return tuple(out)


@pytest.mark.parametrize("name", sorted(_SMOKE_CHAINS))
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_group_plans_stay_within_smem(name, bits):
    geoms = _geoms(*_SMOKE_CHAINS[name], bits)
    need = smem.group_rollout_smem_bytes(group_ops.geom_smem_dicts(geoms))
    for cl in group_ops._CLUSTERS:
        # the kernel's least size is the planner's formula
        assert group_ops._group_smem_bytes(
            geoms, 1, cl, [False] * len(geoms), False) == need
        for t_steps in (1, 4, 12, 40):
            tc, stage, ksplit = group_ops._plan(geoms, t_steps, cl)
            assert 1 <= tc <= t_steps
            assert group_ops._group_smem_bytes(
                geoms, tc, cl, stage, ksplit) <= smem.SMEM_LIMIT
            assert not any(st and g[0] == "pool"
                           for g, st in zip(geoms, stage))
    # at T=4 every chain of the served paths runs whole, codes staged and
    # warps sharing units, on a 16-block cluster (blocks.7 at 4 bits: 74
    # KB of codes a block)
    tc, stage, ksplit = group_ops._plan(geoms, 4, 16)
    assert tc == 4 and ksplit and all(st for g, st in zip(geoms, stage)
                                      if g[0] == "conv")
    if name == "blocks.7" and bits == 4:
        # 4608 codes = 576 words a channel, padded to 580
        assert group_ops._stage_words(geoms[0], 16) * 4 == 32 * 580 * 4


def test_group_plan_chunks_t_and_drops_staging_only_when_forced():
    vgg9 = _geoms(*_SMOKE_CHAINS["vgg9"], 4)
    tc, _, ksplit = group_ops._plan(vgg9, 12, 16)
    assert ksplit and tc < 12                       # two chunks at T=12
    # blocks.7 at 8 bits on an 8-block cluster: two groups of codes a
    # block (295 KB) do not fit beside even one step: read from L2
    b7 = _geoms(*_SMOKE_CHAINS["blocks.7"], 8)
    assert group_ops._plan(b7, 4, 8) == (1, (False, False), False)
    # the planner's largest admissible chain still launches
    big = (("conv", 4, 3, 64, 118, 118, 64, 64), ("conv", 4, 3, 64, 118,
                                                 118, 64, 64))
    need = smem.group_rollout_smem_bytes(group_ops.geom_smem_dicts(big))
    assert need <= smem.SMEM_LIMIT
    tc, stage, ksplit = group_ops._plan(big, 4, 16)
    assert tc == 1 and group_ops._group_smem_bytes(
        big, tc, 16, stage, ksplit) <= smem.SMEM_LIMIT


@pytest.mark.parametrize("b,active,want", [
    # the H100 runs 7 clusters of 16 at once, so B=8 at 16 takes two
    # waves; the largest cluster that takes one wins
    (8, {16: 7, 15: 8, 8: 15}, 15),
    (8, {16: 7, 8: 15}, 8),
    (8, {16: 8, 8: 16}, 16),      # one wave either way: the largest
    (8, {16: 0, 8: 16}, 8),       # no 16-block cluster fits
    (1, {16: 7, 8: 15}, 16),
    (64, {16: 8, 8: 16}, 8),      # 8 waves of 16, 4 of 8
])
def test_cluster_size_takes_the_fewest_waves(b, active, want):
    assert group_ops._cluster_size(b, active) == want


@pytest.mark.parametrize("units,ks", [(1, 8), (2, 4), (3, 2), (4, 2),
                                      (5, 1), (8, 1), (9, 1)])
def test_k_split_teams_fill_the_block_and_cover_every_k_step(units, ks):
    """The kernel's ``team_size``: teams of ks warps, at most 4 teams
    when ks > 1 (the tiles the plan reserves), every warp busy when the
    units allow; each team's k-step ranges [r*nk/ks, (r+1)*nk/ks) cover
    every k-step once (vgg9 convs.4: 9 taps x 4 words)."""
    got = 8 if units <= 1 else 4 if units == 2 else 2 if units <= 4 else 1
    assert got == ks
    teams = 8 // ks                       # 8 warps a block
    assert ks == 1 or teams <= 4
    busy = min(units, teams) * ks
    assert busy >= min(units, 8) and (units > 4 or busy >= 6)
    for nk in (18, 36, 144):
        spans = [range(r * nk // ks, (r + 1) * nk // ks) for r in range(ks)]
        assert sorted(k for sp in spans for k in sp) == list(range(nk))
    assert group_ops._RED_WORDS == 4 * 4 * 16 * 32


# chip_smoke.py's conv geometries: (h, w, c_in, c_out, k, stride)
_SMOKE_CONVS = {
    "convs.1": (32, 32, 64, 64, 3, 1),
    "convs.2": (16, 16, 64, 128, 3, 1),
    "convs.3": (16, 16, 128, 128, 3, 1),
    "convs.4": (8, 8, 128, 256, 3, 1),
    "blocks.2.conv1": (32, 32, 64, 128, 3, 2),
    "blocks.2.proj": (32, 32, 64, 128, 1, 2),
    "blocks.4.conv1": (16, 16, 128, 256, 3, 2),
    "blocks.4.conv2": (8, 8, 256, 256, 3, 1),
    "blocks.4.proj": (16, 16, 128, 256, 1, 2),
    "blocks.6.conv1": (8, 8, 256, 512, 3, 2),
    "blocks.6.conv2": (4, 4, 512, 512, 3, 1),
    "blocks.6.proj": (8, 8, 256, 512, 1, 2),
    "s2_3x3": (16, 16, 64, 128, 3, 2),
    "s2_1x1": (16, 16, 64, 128, 1, 2),
    "ragged": (9, 7, 40, 36, 3, 1),
}


@pytest.mark.parametrize("name", sorted(_SMOKE_CONVS))
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_conv_plan_fills_the_card_within_smem(name, bits):
    """At B=8: the block fits in SMEM_LIMIT (codes staged at every served
    geometry), the teams cover every k-step once, and the launch puts no
    more than one wave of warps beyond the units."""
    h, w, c_in, c_out, k, stride = _SMOKE_CONVS[name]
    b = 8
    ho, wo = -(-h // stride), -(-w // stride)
    npix, groups = ho * wo, -(-c_out // 32)
    nk = k * k * -(-c_in // 32)
    wpr = nk * bits
    ks, bpg, staged = conv_ops._conv_plan(b, npix, groups, nk, wpr)
    assert ks in (1, 2, 4, 8) and 1 <= ks <= nk
    assert staged
    assert conv_ops._conv_smem_bytes(wpr, ks, staged) <= smem.SMEM_LIMIT
    spans = [range(r * nk // ks, (r + 1) * nk // ks) for r in range(ks)]
    assert sorted(kk for sp in spans for kk in sp) == list(range(nk))
    units = -(-npix // 16) * b * groups
    warps = groups * bpg * 8
    assert bpg * (8 // ks) >= -(-npix // 16) * b     # every unit placed
    assert warps - units <= smem.N_SMS * 8
    if units <= smem.N_SMS * 8 // 8:
        assert ks == min(8, nk)                       # narrow: teams of 8


def test_conv_plan_reads_l2_codes_past_the_budget():
    """A 3x3 x 1024 tile at w8 is 288 KB of packed codes a group: the plan
    reads them from L2 instead of raising; the served resnet18 layers get
    one wave of 128 blocks."""
    nk = 9 * 32
    ks, bpg, staged = conv_ops._conv_plan(8, 16, 2, nk, nk * 8)
    assert not staged and ks == 8
    assert conv_ops._conv_smem_bytes(nk * 8, ks, True) > smem.SMEM_LIMIT
    assert conv_ops._conv_smem_bytes(nk * 8, ks, False) <= smem.SMEM_LIMIT
    for npix, groups, nk, want in ((1024, 2, 18, (1, 64)),
                                   (16, 16, 144, (8, 8)),
                                   (64, 8, 36, (4, 16))):
        ks, bpg, staged = conv_ops._conv_plan(8, npix, groups, nk, nk * 4)
        assert (ks, bpg) == want and staged and groups * bpg == 128


# ---------------------------------------------------------------------------
# lif_step's packed entry (csrc/lif_step.cu, lif_step_packed_kernel)
# ---------------------------------------------------------------------------

def _lif_lanes(v, i, *, k, theta, v_reset, soft):
    """``lif1`` for the 32 lanes of a warp: unsigned adds that wrap, the
    arithmetic shift, the reset."""
    u = (v.astype(np.uint32) - (v >> k).astype(np.uint32)
         + i.astype(np.uint32))
    vn = u.view(np.int32)
    fire = vn >= theta
    if soft:
        vn = np.where(fire, (u - np.uint32(theta & 0xFFFFFFFF)).view(
            np.int32), vn)
    else:
        vn = np.where(fire, np.int32(v_reset), vn)
    return vn, fire


def _lif_packed_emulated(v, i, *, k, theta, v_reset, soft, max_blocks=4096):
    """The packed kernel lane by lane: 256-thread blocks (8 warps), the
    launch's block count, each warp walking g = its global warp index,
    then + every warp of the grid, over rows * words pairs; lanes past
    the row's end take part in the ballot with a 0 bit."""
    rows, n = v.shape
    nw = -(-n // 32)
    total = rows * nw
    blocks = min(max_blocks, -(-total // 8))
    flat_v, flat_i = v.reshape(-1), i.reshape(-1)
    v_out = np.full(rows * n, 0x5A5A5A5A, np.int32)   # poison: all written
    words = np.full(total, 0x5A5A5A5A, np.int32)
    visits = np.zeros(total, np.int64)
    lanes = np.arange(32)
    for warp in range(blocks * 8):
        for g in range(warp, total, blocks * 8):
            r, w = divmod(g, nw)
            col = w * 32 + lanes
            live = col < n
            e = r * n + col[live]
            vn, fire = _lif_lanes(flat_v[e], flat_i[e], k=k, theta=theta,
                                  v_reset=v_reset, soft=soft)
            v_out[e] = vn
            bits = np.zeros(32, np.uint64)
            bits[live] = fire
            ballot = int((bits << lanes.astype(np.uint64)).sum())
            words[g] = np.uint32(ballot).view(np.int32)
            visits[g] += 1
    assert (visits == 1).all()               # every word once
    return v_out.reshape(rows, n), words.reshape(rows, nw)


@pytest.mark.parametrize("soft", [True, False])
@pytest.mark.parametrize("rows,n,max_blocks", [
    (8, 100, 4096), (8, 512, 4096), (64, 2048, 4096), (5, 100, 3),
    (3, 2048, 2), (1, 1, 4096)])
def test_lif_packed_ballot_walk_matches_pack_bool(rows, n, max_blocks, soft):
    g = np.random.default_rng(rows * n + soft)
    v = g.integers(-400, 400, (rows, n)).astype(np.int32)
    i = g.integers(-150, 250, (rows, n)).astype(np.int32)
    v[0, :4] = (2**31 - 1, -2**31, 2**31 - 8, -2**31 + 3)[:n]  # wraparound
    i[0, :4] = (1, -1, 100, -100)[:n]
    kw = dict(leak_shift=3, threshold_q=64, v_reset_q=-7, soft_reset=soft)
    got_v, got_w = _lif_packed_emulated(
        v, i, k=3, theta=64, v_reset=-7, soft=soft, max_blocks=max_blocks)
    pv, ps = lif_step_ref(torch.from_numpy(v), torch.from_numpy(i), **kw)
    np.testing.assert_array_equal(got_v, pv.numpy())
    np.testing.assert_array_equal(got_w, packing.pack_bool(ps).numpy())
    if n % 32 == 0 and rows * n >= 512:
        assert (got_w < 0).any()             # a spike at bit 31 wraps
