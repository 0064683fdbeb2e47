"""Plain PyTorch version of the fused packed-conv rollout.

Port of ``repro.kernels.fused_conv.ref``.  Per timestep:

    s[t]     = unpack_bool(spikes_packed[t])             (1-bit spike plane)
    i_syn[t] = conv_int(s[t], Wq)                        (AC unit, NHWC/HWIO)
    v, o[t]  = lif_step_int(v, i_syn[t])                 (LIF update)
    out[t]   = pack_bool(o[t])                           (spike re-pack, C axis)

The CUDA kernel (csrc/fused_conv.cu) must reproduce this bit for bit.

Exact integer convolution: PyTorch's convolutions do not take int32, and
cuDNN may pick Winograd or FFT algorithms whose transforms round.  So the
plain version builds the im2col matrix explicitly (``F.pad`` with the
exact SAME/VALID pads, then ``F.unfold``) and multiplies it with the
integer codes in float64.  Every operand is a small integer (spikes in
{0, 1}, codes in [-128, 127]) and every partial sum is bounded by
``kh*kw*c_in*128``, far below 2**53, so each float64 product and sum is
an exact integer whatever order the matmul sums in; TF32 never applies
to float64.  The result is cast back to int32 exactly.

This module also owns the conv geometry helpers (output size, explicit
pads), which ops.py and the tests share.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core import packing
from repro_torch.core.lif import as_theta_vector, lif_step_int
from repro_torch.quant.formats import QuantizedConvTensor
from repro_torch.quant.ptq import unpack_conv_codes

Padding = Union[str, Tuple[Tuple[int, int], Tuple[int, int]]]


def conv_out_size(size: int, k: int, stride: int, pad_lo: int,
                  pad_hi: int) -> int:
    return (size + pad_lo + pad_hi - k) // stride + 1


def conv_pads(h: int, w: int, kh: int, kw: int, stride: int,
              padding: Padding) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Explicit ((lo, hi), (lo, hi)) spatial pads, with XLA's string
    padding semantics ('SAME': out = ceil(in / stride), extra pad at the
    high edge; 'VALID': no pad)."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return ((0, 0), (0, 0))
        if padding.upper() != "SAME":
            raise ValueError(f"unsupported padding {padding!r}")
        pads = []
        for size, k in ((h, kh), (w, kw)):
            out = -(-size // stride)
            total = max((out - 1) * stride + k - size, 0)
            pads.append((total // 2, total - total // 2))
        return (pads[0], pads[1])
    (plo_h, phi_h), (plo_w, phi_w) = padding
    return ((int(plo_h), int(phi_h)), (int(plo_w), int(phi_w)))


def conv_out_shape(h: int, w: int, qct: QuantizedConvTensor, stride: int,
                   padding: Padding) -> Tuple[int, int]:
    (plh, phh), (plw, phw) = conv_pads(h, w, qct.kh, qct.kw, stride, padding)
    return (conv_out_size(h, qct.kh, stride, plh, phh),
            conv_out_size(w, qct.kw, stride, plw, phw))


def fused_conv_rollout_torch(
    spikes_packed_t: torch.Tensor,  # (T, B, H, W, ceil(c_in/32)) int32
    qct: QuantizedConvTensor,       # packed HWIO integer codes
    *,
    stride: int = 1,
    padding: Padding = "SAME",
    leak_shift: int,
    threshold_q,
    v_reset_q: int = 0,
    soft_reset: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """T-step integer spiking-conv rollout.

    Returns (v_T: (B, Ho, Wo, c_out) int32,
             out_spikes_packed: (T, B, Ho, Wo, ceil(c_out/32)) int32).
    """
    t_steps, b, h, w, _ = spikes_packed_t.shape
    dev = spikes_packed_t.device
    (plh, phh), (plw, phw) = conv_pads(h, w, qct.kh, qct.kw, stride,
                                       padding)
    ho, wo = conv_out_shape(h, w, qct, stride, padding)
    theta = as_theta_vector(threshold_q, qct.c_out, device=dev)
    v = torch.zeros((b, ho, wo, qct.c_out), dtype=torch.int32, device=dev)
    words_out = packing.packed_last_dim(qct.c_out, 1)
    if t_steps == 0:
        return v, torch.zeros((0, b, ho, wo, words_out), dtype=torch.int32,
                              device=dev)

    # (c_out, c_in*kh*kw) in unfold's (channel, kh, kw) row order
    codes = unpack_conv_codes(qct).permute(3, 2, 0, 1).reshape(
        qct.c_out, -1).to(torch.float64)
    s = packing.unpack_bool(spikes_packed_t, qct.c_in)   # (T,B,H,W,c_in)
    x = s.reshape(t_steps * b, h, w, qct.c_in).permute(0, 3, 1, 2)
    x = F.pad(x.to(torch.float64), (plw, phw, plh, phh))
    cols = F.unfold(x, (qct.kh, qct.kw), stride=stride)  # (N, c_in*kh*kw, L)
    i_syn = torch.matmul(codes, cols)                    # (N, c_out, L)
    i_syn = i_syn.to(torch.int32).reshape(t_steps, b, qct.c_out, ho, wo)
    i_syn = i_syn.permute(0, 1, 3, 4, 2)

    out = []
    for t in range(t_steps):
        v, o = lif_step_int(v, i_syn[t], leak_shift=leak_shift,
                            threshold_q=theta, v_reset_q=v_reset_q,
                            soft_reset=soft_reset)
        out.append(packing.pack_bool(o))
    return v, torch.stack(out)
