"""Public entry point of the fused LIF step, dispatched by device.

* a CPU tensor runs the plain PyTorch version (ref.py);
* a CUDA tensor launches the hand-written kernel ``csrc/lif_step.cu``,
  or raises.  There is no fallback from one to the other.

``v`` and ``i_syn`` have any shape ``(..., n)``; ``threshold_q`` is one
integer for every neuron.  ``lif_step.launches`` counts kernel launches
(and nothing else).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels.lif_step import ref as _ref


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("lif_step")
    lib.lif_step_launch.argtypes = ([ctypes.c_void_p] * 4 +
                                    [ctypes.c_longlong] +
                                    [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.lif_step_launch.restype = ctypes.c_int
    lib.lif_step_error_string.argtypes = [ctypes.c_int]
    lib.lif_step_error_string.restype = ctypes.c_char_p
    return lib


def lif_step(
    v: torch.Tensor,
    i_syn: torch.Tensor,
    *,
    leak_shift: int,
    threshold_q: int,
    v_reset_q: int = 0,
    soft_reset: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused integer LIF update.  Returns (v', spikes int32 {0, 1}) of
    ``v``'s shape, bit-exact with the plain version."""
    if v.shape != i_syn.shape:
        raise ValueError(f"lif_step: v {tuple(v.shape)} and i_syn "
                         f"{tuple(i_syn.shape)} differ")
    theta = int(threshold_q)
    dev = v.device
    if dev.type == "cpu":
        return _ref.lif_step_ref(v, i_syn, leak_shift=leak_shift,
                                 threshold_q=theta, v_reset_q=v_reset_q,
                                 soft_reset=soft_reset)
    if dev.type != "cuda":
        raise ValueError(f"lif_step: unsupported device {dev}")
    if i_syn.device != dev:
        raise ValueError(f"lif_step: i_syn on {i_syn.device}, v on {dev}")
    vi = v.to(torch.int32).contiguous()
    ii = i_syn.to(torch.int32).contiguous()
    # the kernel moves 16 bytes at a time: hand it aligned buffers
    vi = vi.clone() if vi.data_ptr() % 16 else vi
    ii = ii.clone() if ii.data_ptr() % 16 else ii
    v_out = torch.empty_like(vi)
    s_out = torch.empty_like(vi)
    if vi.numel() == 0:
        return v_out, s_out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lif_step_launch(
            vi.data_ptr(), ii.data_ptr(), v_out.data_ptr(), s_out.data_ptr(),
            vi.numel(), leak_shift, theta, int(v_reset_q),
            int(bool(soft_reset)), stream)
    if err != 0:
        raise RuntimeError(
            f"lif_step kernel launch failed: CUDA error {err} "
            f"({lib.lif_step_error_string(err).decode()})")
    lif_step.launches += 1
    return v_out, s_out


lif_step.launches = 0
