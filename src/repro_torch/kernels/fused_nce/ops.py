"""Public entry point of the fused NCE rollout, dispatched by device.

* a CPU tensor runs the plain PyTorch version (ref.py);
* a CUDA tensor launches the hand-written kernel ``csrc/fused_nce.cu``,
  or raises.  There is no fallback from one to the other.

Around the kernel, this wrapper pads the output neurons to a multiple of
32 (zero weight rows, masked by ``n_out`` inside the kernel) and slices
the membrane back.  The kernel reads ``ceil(d_in/32)`` spike words per
row and treats codes past ``d_in`` as zero, so stray bits past ``d_in``
are inert, as in the plain version.

``fused_nce_rollout.launches`` counts kernel launches (and nothing else).
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
from repro_torch.kernels.fused_nce import ref as _ref
from repro_torch.kernels.smem import SMEM_LIMIT
from repro_torch.quant.formats import QuantizedTensor


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_nce")
    lib.fused_nce_launch.argtypes = ([ctypes.c_void_p] * 5 +
                                     [ctypes.c_int] * 11 + [ctypes.c_void_p])
    lib.fused_nce_launch.restype = ctypes.c_int
    lib.fused_nce_smem_bytes.argtypes = [ctypes.c_int]
    lib.fused_nce_smem_bytes.restype = ctypes.c_size_t
    lib.fused_nce_error_string.argtypes = [ctypes.c_int]
    lib.fused_nce_error_string.restype = ctypes.c_char_p
    return lib


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
    if -(-b // 8) > 65535:
        raise ValueError(f"fused_nce: grid too large for {b} rows")
    lib = _lib()
    smem = lib.fused_nce_smem_bytes(kwords)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fused_nce: d_in={d_in} needs {smem} bytes of "
                         f"shared memory > {SMEM_LIMIT}")
    sp = spikes_packed_t.to(torch.int32).contiguous()
    wpk = F.pad(qt.data.to(torch.int32), (0, 0, 0, n_pad - n)).contiguous()
    thp = F.pad(theta, (0, n_pad - n)).contiguous()
    v = torch.empty((b, n_pad), dtype=torch.int32, device=dev)
    out = torch.empty((t_steps, b, n_pad // 32), dtype=torch.int32,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_nce_launch(
            sp.data_ptr(), wpk.data_ptr(), thp.data_ptr(), v.data_ptr(),
            out.data_ptr(), t_steps, b, kwords, d_in, wpr, qt.bits, n_pad, n,
            leak_shift, int(v_reset_q), int(bool(soft_reset)), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_nce kernel launch failed: CUDA error {err} "
            f"({lib.fused_nce_error_string(err).decode()})")
    fused_nce_rollout.launches += 1
    return v[:, :n], out


fused_nce_rollout.launches = 0
