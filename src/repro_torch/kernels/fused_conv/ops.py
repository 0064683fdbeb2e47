"""Public entry point of the fused packed-conv rollout, dispatched by device.

* a CPU tensor runs the plain PyTorch version (ref.py);
* a CUDA tensor launches the hand-written kernel ``csrc/fused_conv.cu``,
  or raises.  There is no fallback from one to the other.

The kernel reads the caller's tensors as they are: the packed spike
planes (the SAME/VALID zero halo, from ``ref.conv_pads``, is read as zero
inside the kernel), the ``(c_out, wpr)`` code words of the
``QuantizedConvTensor`` and the ``(c_out,)`` thresholds (channels past
``c_out`` up to the next multiple of 32 read as zero and are masked
inside the kernel).  The wrapper plans the launch (:func:`_conv_plan`:
warps per unit and whether the codes are staged in shared memory),
allocates the two outputs and launches one kernel.

``fused_conv_rollout.launches`` counts kernel launches (and nothing else).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.core import packing
from repro_torch.core.lif import as_theta_vector
from repro_torch.kernels import build as _build
from repro_torch.kernels.fused_conv import ref as _ref
from repro_torch.kernels.smem import N_SMS, SMEM_LIMIT, staged_stride
from repro_torch.quant.formats import QuantizedConvTensor

_WARPS = 8                   # warps per block (kWarps)
_TILE_WORDS = 4 * 16 * 32    # one team's K-split tile (kTileWords)
_TEAMS = (8, 4, 2, 1)        # warps per unit the kernel takes
_WAVE = N_SMS * _WARPS       # one block of 8 warps on every SM


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_conv")
    lib.fused_conv_launch.argtypes = ([ctypes.c_void_p] * 5 +
                                      [ctypes.c_int] * 20 + [ctypes.c_void_p])
    lib.fused_conv_launch.restype = ctypes.c_int
    lib.fused_conv_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.fused_conv_smem_bytes.restype = ctypes.c_size_t
    lib.fused_conv_error_string.argtypes = [ctypes.c_int]
    lib.fused_conv_error_string.restype = ctypes.c_char_p
    return lib


# --- the launch plan (csrc/fused_conv.cu must agree) ------------------------


def _conv_smem_bytes(wpr: int, ks: int, staged: bool) -> int:
    """Dynamic shared memory of one block (``smem_words`` in the kernel):
    the staged codes of one 32-channel group, then the K-split tiles of
    the block's ``8 // ks`` teams when ``ks > 1``."""
    words = (32 * staged_stride(wpr) if staged else 0) + \
        ((_WARPS // ks) * _TILE_WORDS if ks > 1 else 0)
    return 4 * words


def _conv_plan(b: int, npix: int, groups: int, nk: int,
               wpr: int) -> Tuple[int, int, bool]:
    """(ks, blocks_per_group, staged) for ``b`` batch elements, ``npix``
    output pixels, ``groups`` 32-channel groups, ``nk`` k-steps (taps x
    spike words) and ``wpr`` code words a channel.  A unit is 16 pixels x
    32 channels of one batch element; ``ks`` warps share its k-steps: the
    largest team (at most ``nk`` warps) that keeps the launch within one
    wave of warps, or 1 when the units alone fill more.  A block runs
    ``8 // ks`` units of one group and stages the group's codes when they
    fit in ``SMEM_LIMIT`` beside the K-split tiles, else reads them from
    L2."""
    group_units = -(-npix // 16) * b
    ks = next((k for k in _TEAMS
               if k <= nk and group_units * groups * k <= _WAVE), 1)
    blocks_per_group = -(-group_units // (_WARPS // ks))
    staged = _conv_smem_bytes(wpr, ks, True) <= SMEM_LIMIT
    return ks, blocks_per_group, staged


@functools.cache
def _launch_plan(b: int, npix: int, groups: int, nk: int,
                 wpr: int) -> Tuple[int, int, bool, int]:
    """:func:`_conv_plan` with its shared memory, cached per geometry and
    held against the kernel's own size function and ``SMEM_LIMIT``."""
    ks, bpg, staged = _conv_plan(b, npix, groups, nk, wpr)
    smem = _conv_smem_bytes(wpr, ks, staged)
    kernel = _lib().fused_conv_smem_bytes(wpr, ks, int(staged))
    if kernel != smem or smem > SMEM_LIMIT:
        raise ValueError(f"fused_conv: the kernel holds {kernel} bytes of "
                         f"shared memory at ks={ks}, staged={staged}, the "
                         f"wrapper planned {smem} (limit {SMEM_LIMIT})")
    if groups * bpg > 0x7FFFFFFF:
        raise ValueError(f"fused_conv: grid too large ({groups * bpg} "
                         f"blocks) for batch {b}, {npix} output pixels")
    return ks, bpg, staged, smem


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
    groups = -(-qct.c_out // 32)
    v = torch.empty((b, ho, wo, qct.c_out), dtype=torch.int32, device=dev)
    out = torch.empty((t_steps, b, ho, wo, groups), dtype=torch.int32,
                      device=dev)
    if t_steps == 0 or v.numel() == 0:   # nothing to compute: no launch
        return v.zero_(), out
    wpr = qct.data.shape[1]
    ks, bpg, staged, _ = _launch_plan(b, ho * wo, groups,
                                      qct.kh * qct.kw * win, wpr)
    sp = spikes_packed_t.to(torch.int32).contiguous()
    wq = qct.data.to(torch.int32).contiguous()
    theta = theta.contiguous()
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_conv_launch(
            sp.data_ptr(), wq.data_ptr(), theta.data_ptr(), v.data_ptr(),
            out.data_ptr(), t_steps, b, h, w, win, ho, wo, qct.kh, qct.kw,
            stride, plh, plw, qct.bits, qct.c_out, ks, bpg, int(staged),
            leak_shift, int(v_reset_q), int(bool(soft_reset)), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_conv kernel launch failed: CUDA error {err} "
            f"({lib.fused_conv_error_string(err).decode()})")
    _build.count_launch(fused_conv_rollout)
    return v, out


fused_conv_rollout.launches = 0
