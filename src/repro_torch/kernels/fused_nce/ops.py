"""Public entry point of the fused NCE rollout, dispatched by device.

* a CPU tensor runs the plain PyTorch version (ref.py);
* a CUDA tensor launches the hand-written kernel ``csrc/fused_nce.cu``,
  or raises.  There is no fallback from one to the other.

The kernel reads the packed weights as they are, ``(d_out, wpr)`` words
(neurons past ``d_out`` up to the next multiple of 32 stage as zero and
are masked by ``n_out`` inside the kernel), and masks spike bits past
``d_in``, so they stay inert as in the plain version.  The wrapper
chooses the launch (:func:`_nce_plan`): batch rows per block ``rb`` (all
T steps of a row stay in one block, whose LIF scan runs over them) and
the cluster's contraction split.

``fused_nce_rollout.launches`` counts kernel launches (and nothing else).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.core import packing
from repro_torch.core.lif import as_theta_vector
from repro_torch.kernels import build as _build
from repro_torch.kernels.fused_nce import ref as _ref
from repro_torch.kernels.smem import N_SMS, SMEM_LIMIT, staged_stride
from repro_torch.quant.formats import QuantizedTensor

_SPLITS = (16, 8, 4, 2, 1)   # blocks per cluster the kernel takes


def _nce_smem_bytes(t_steps: int, rb: int, kwords: int, split: int,
                    bits: int) -> int:
    """Shared memory of one block (``csrc/fused_nce.cu`` ``smem_words``):
    the chunk's spike words (rows t*rb + r padded to 16, an odd stride),
    the group's codes for the block's k-steps (a stride of 4 mod 32
    words per neuron) and two int32 partial tiles."""
    rows_pad = -(-t_steps * rb // 16) * 16
    ks = -(-kwords // split)
    sp_stride = ks | 1
    return 4 * (rows_pad * sp_stride + 32 * staged_stride(ks * bits) +
                2 * rows_pad * 32)


def _nce_plan(t_steps: int, m: int, kwords: int, bits: int,
              n_pad: int) -> Tuple[int, int]:
    """(rb, split): batch rows per block, at most 64 // T (and at least
    one), so a block's T*rb rows fill 1-4 tensor-core row tiles; then the
    largest contraction split that keeps the grid within one wave of
    the card's SMs (no more blocks than spike words), raised until the
    block fits in shared memory.  Raises when even 16 blocks do not."""
    rb = max(1, min(m, 64 // t_steps))
    base = (n_pad // 32) * -(-m // rb)
    split = next((s for s in _SPLITS
                  if base * s <= N_SMS and s <= kwords), 1)
    while (_nce_smem_bytes(t_steps, rb, kwords, split, bits) > SMEM_LIMIT
           and split < _SPLITS[0]):
        split *= 2
    need = _nce_smem_bytes(t_steps, rb, kwords, split, bits)
    if need > SMEM_LIMIT:
        raise ValueError(f"fused_nce: T={t_steps}, {kwords} spike words at "
                         f"w{bits} need {need} bytes of shared memory per "
                         f"block > {SMEM_LIMIT} even split over "
                         f"{split} blocks")
    return rb, split


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_nce")
    lib.fused_nce_launch.argtypes = ([ctypes.c_void_p] * 5 +
                                     [ctypes.c_int] * 13 + [ctypes.c_void_p])
    lib.fused_nce_launch.restype = ctypes.c_int
    lib.fused_nce_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.fused_nce_smem_bytes.restype = ctypes.c_size_t
    lib.fused_nce_error_string.argtypes = [ctypes.c_int]
    lib.fused_nce_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _launch_plan(t_steps: int, m: int, kwords: int, bits: int,
                 n_pad: int) -> Tuple[int, int]:
    """:func:`_nce_plan`, cached per shape, held against the grid's limit
    and the kernel's own shared-memory size."""
    rb, split = _nce_plan(t_steps, m, kwords, bits, n_pad)
    if -(-m // rb) > 65535:
        raise ValueError(f"fused_nce: grid too large for {m} rows")
    smem = _lib().fused_nce_smem_bytes(t_steps, rb, kwords, split, bits)
    planned = _nce_smem_bytes(t_steps, rb, kwords, split, bits)
    if smem != planned:
        raise ValueError(f"fused_nce: the kernel holds {smem} bytes of "
                         f"shared memory, the wrapper planned {planned}")
    return rb, split


def fused_nce_rollout(
    spikes_packed_t: torch.Tensor,  # (T, B, ceil(d_in/32)) int32
    qt: QuantizedTensor,            # packed (d_out, d_in) integer codes
    *,
    d_in: int,
    leak_shift: int,
    threshold_q,
    v_reset_q: int = 0,
    soft_reset: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All T timesteps of one NCE layer in a single fused pass.

    ``threshold_q`` is a scalar or a per-output-channel int32 vector of
    length ``d_out``.  Returns (v_T: (B, d_out) int32,
    out_spikes_packed: (T, B, ceil(d_out/32)) int32), bit-exact with the
    plain version.
    """
    t_steps, b, kwords = spikes_packed_t.shape
    n = qt.shape[0]
    if qt.shape[1] != d_in:
        raise ValueError(f"weights have d_in={qt.shape[1]}, caller says "
                         f"{d_in}")
    if kwords != packing.packed_last_dim(d_in, 1):
        raise ValueError(f"spikes carry {kwords} words per row, d_in={d_in} "
                         f"needs {packing.packed_last_dim(d_in, 1)}")
    wpr = packing.packed_last_dim(d_in, qt.bits)
    if tuple(qt.data.shape) != (n, wpr):
        raise ValueError(f"weights carry {tuple(qt.data.shape)} words, "
                         f"{n} x {d_in} at {qt.bits} bits needs ({n}, {wpr})")
    dev = spikes_packed_t.device
    theta = as_theta_vector(threshold_q, n, device=dev)
    if dev.type == "cpu":
        return _ref.fused_nce_rollout_torch(
            spikes_packed_t, qt, d_in=d_in, leak_shift=leak_shift,
            threshold_q=theta, v_reset_q=v_reset_q, soft_reset=soft_reset)
    if dev.type != "cuda":
        raise ValueError(f"fused_nce_rollout: unsupported device {dev}")
    for name, tns in (("weights", qt.data), ("threshold_q", theta)):
        if tns.device != dev:
            raise ValueError(f"fused_nce_rollout: {name} on {tns.device}, "
                             f"spikes on {dev}")

    n_pad = -(-n // 32) * 32
    if t_steps == 0:   # an empty rollout launches nothing
        return (torch.zeros((b, n), dtype=torch.int32, device=dev),
                torch.zeros((0, b, n_pad // 32), dtype=torch.int32,
                            device=dev))
    rb, split = _launch_plan(t_steps, b, kwords, qt.bits, n_pad)
    lib = _lib()
    sp = spikes_packed_t.to(torch.int32).contiguous()
    wpk = qt.data.to(torch.int32).contiguous()
    theta = theta.contiguous()
    v = torch.empty((b, n_pad), dtype=torch.int32, device=dev)
    out = torch.empty((t_steps, b, n_pad // 32), dtype=torch.int32,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_nce_launch(
            sp.data_ptr(), wpk.data_ptr(), theta.data_ptr(), v.data_ptr(),
            out.data_ptr(), t_steps, b, kwords, d_in, wpr, qt.bits, n, n_pad,
            rb, split, leak_shift, int(v_reset_q), int(bool(soft_reset)),
            stream)
    if err != 0:
        raise RuntimeError(
            f"fused_nce kernel launch failed: CUDA error {err} "
            f"({lib.fused_nce_error_string(err).decode()})")
    _build.count_launch(fused_nce_rollout)
    return v[:, :n], out


fused_nce_rollout.launches = 0
