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
  across the cluster's blocks, empty splits included.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import packing
from repro_torch.kernels.kv_attention import ops as kv_ops
from repro_torch.kernels.kv_attention import ref as kv_ref
from repro_torch.kernels.packed_qmatmul import ops as qmm_ops
from repro_torch.kernels.packed_qmatmul import ref as qmm_ref
from repro_torch.quant.formats import PrecisionConfig
from repro_torch.quant.ptq import quantize


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
