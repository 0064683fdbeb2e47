"""Public entry point of the fused packed-conv rollout, dispatched by device.

* a CPU tensor runs the plain PyTorch version (ref.py);
* a CUDA tensor launches the hand-written kernel ``csrc/fused_conv.cu``,
  or raises.  There is no fallback from one to the other.

Around the kernel, this wrapper zero-pads the packed spike planes to the
gather footprint (explicit SAME/VALID pads from ``ref.conv_pads``, the
amounts the plain version pads by), pads ``c_out`` to a multiple of 32
(zero weight rows, masked by ``n_out`` inside the kernel), and reshapes
the outputs back.  Zero spike words and zero codes are inert in the
accumulate, so the padding never changes a visible bit.

``fused_conv_rollout.launches`` counts kernel launches (and nothing else).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import packing
from repro_torch.core.lif import as_theta_vector
from repro_torch.kernels import build as _build
from repro_torch.kernels.fused_conv import ref as _ref
from repro_torch.kernels.smem import SMEM_LIMIT
from repro_torch.quant.formats import QuantizedConvTensor


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_conv")
    lib.fused_conv_launch.argtypes = ([ctypes.c_void_p] * 5 +
                                      [ctypes.c_int] * 16 + [ctypes.c_void_p])
    lib.fused_conv_launch.restype = ctypes.c_int
    lib.fused_conv_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.fused_conv_smem_bytes.restype = ctypes.c_size_t
    lib.fused_conv_error_string.argtypes = [ctypes.c_int]
    lib.fused_conv_error_string.restype = ctypes.c_char_p
    return lib


def fused_conv_rollout(
    spikes_packed_t: torch.Tensor,  # (T, B, H, W, ceil(c_in/32)) int32
    qct: QuantizedConvTensor,       # packed HWIO integer codes
    *,
    stride: int = 1,
    padding: _ref.Padding = "SAME",
    leak_shift: int,
    threshold_q,
    v_reset_q: int = 0,
    soft_reset: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All T timesteps of one spiking conv layer in a single fused pass.

    ``threshold_q`` is a scalar or a per-output-channel int32 vector of
    length ``c_out``.  Returns (v_T: (B, Ho, Wo, c_out) int32,
    out_spikes_packed: (T, B, Ho, Wo, ceil(c_out/32)) int32), bit-exact
    with the plain version.
    """
    t_steps, b, h, w, win = spikes_packed_t.shape
    if win != packing.packed_last_dim(qct.c_in, 1):
        raise ValueError(
            f"spike plane carries {win} channel words, weights expect "
            f"{packing.packed_last_dim(qct.c_in, 1)} (c_in={qct.c_in})")
    if qct.c_in_pad != win * 32:
        raise ValueError("quantize_conv cin_pad drifted from the spike "
                         "word layout; requantize the weights")
    words = (qct.c_out, qct.k_flat * qct.bits // 32)
    if tuple(qct.data.shape) != words:
        raise ValueError(f"conv weights carry {tuple(qct.data.shape)} "
                         f"words, the geometry needs {words}")
    dev = spikes_packed_t.device
    theta = as_theta_vector(threshold_q, qct.c_out, device=dev)
    if dev.type == "cpu":
        return _ref.fused_conv_rollout_torch(
            spikes_packed_t, qct, stride=stride, padding=padding,
            leak_shift=leak_shift, threshold_q=theta, v_reset_q=v_reset_q,
            soft_reset=soft_reset)
    if dev.type != "cuda":
        raise ValueError(f"fused_conv_rollout: unsupported device {dev}")
    for name, tns in (("weights", qct.data), ("threshold_q", theta)):
        if tns.device != dev:
            raise ValueError(f"fused_conv_rollout: {name} on {tns.device}, "
                             f"spikes on {dev}")

    (plh, phh), (plw, phw) = _ref.conv_pads(h, w, qct.kh, qct.kw, stride,
                                            padding)
    ho = _ref.conv_out_size(h, qct.kh, stride, plh, phh)
    wo = _ref.conv_out_size(w, qct.kw, stride, plw, phw)
    n_pad = _round_up(qct.c_out, 32)
    if t_steps == 0:   # an empty rollout launches nothing
        return (torch.zeros((b, ho, wo, qct.c_out), dtype=torch.int32,
                            device=dev),
                torch.zeros((0, b, ho, wo, n_pad // 32), dtype=torch.int32,
                            device=dev))
    if b > 65535 or -(-ho * wo // 32) > 65535:
        raise ValueError(f"fused_conv: grid too large for batch {b}, "
                         f"{ho}x{wo} output")
    lib = _lib()
    smem = lib.fused_conv_smem_bytes(qct.kh, qct.kw, win)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"fused_conv: a {qct.kh}x{qct.kw}x{qct.c_in_pad} weight tile "
            f"needs {smem} bytes of shared memory > {SMEM_LIMIT}")

    # pre-pad the planes: the gather footprint may run one short of the
    # padded extent at the high edge (stride > 1), so extend to it
    hp = max(h + plh + phh, (ho - 1) * stride + qct.kh)
    wp = max(w + plw + phw, (wo - 1) * stride + qct.kw)
    sp = F.pad(spikes_packed_t.to(torch.int32),
               (0, 0, plw, wp - w - plw, plh, hp - h - plh)).contiguous()
    wpk = F.pad(qct.data.to(torch.int32),
                (0, 0, 0, n_pad - qct.c_out)).contiguous()
    thp = F.pad(theta, (0, n_pad - qct.c_out)).contiguous()
    v = torch.empty((b, ho * wo, n_pad), dtype=torch.int32, device=dev)
    out = torch.empty((t_steps, b, ho * wo, n_pad // 32), dtype=torch.int32,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_conv_launch(
            sp.data_ptr(), wpk.data_ptr(), thp.data_ptr(), v.data_ptr(),
            out.data_ptr(), t_steps, b, hp, wp, win, ho, wo, qct.kh, qct.kw,
            stride, qct.bits, n_pad, qct.c_out, leak_shift, int(v_reset_q),
            int(bool(soft_reset)), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_conv kernel launch failed: CUDA error {err} "
            f"({lib.fused_conv_error_string(err).decode()})")
    fused_conv_rollout.launches += 1
    v = v.reshape(b, ho, wo, n_pad)[..., :qct.c_out]
    return v, out.reshape(t_steps, b, ho, wo, n_pad // 32)


fused_conv_rollout.launches = 0
