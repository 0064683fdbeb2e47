"""Public entry point of the fused LIF step, dispatched by device.

* a CPU tensor runs the plain PyTorch version (ref.py);
* a CUDA tensor launches the hand-written kernel ``csrc/lif_step.cu``,
  or raises.  There is no fallback from one to the other.

``v`` and ``i_syn`` have any shape ``(..., n)``; ``threshold_q`` is one
integer for every neuron.

Two entries of the one kernel source:

* :func:`lif_step` returns the spikes as an int32 {0, 1} plane, the JAX
  kernel's contract;
* :func:`lif_step_packed` returns them packed, 32 a word along the last
  axis, exactly ``pack_bool`` of that plane (what the NCE step hands to
  the next layer); its plain version is ``lif_step_ref`` then
  ``pack_bool``.

``lif_step.launches`` counts kernel launches of either entry (and
nothing else).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.core import packing
from repro_torch.kernels import build as _build
from repro_torch.kernels.lif_step import ref as _ref


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("lif_step")
    lib.lif_step_launch.argtypes = ([ctypes.c_void_p] * 4 +
                                    [ctypes.c_longlong] +
                                    [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.lif_step_launch.restype = ctypes.c_int
    lib.lif_step_packed_launch.argtypes = ([ctypes.c_void_p] * 4 +
                                           [ctypes.c_int] * 6 +
                                           [ctypes.c_void_p])
    lib.lif_step_packed_launch.restype = ctypes.c_int
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
    _build.count_launch(lif_step)
    return v_out, s_out


lif_step.launches = 0


def lif_step_packed(
    v: torch.Tensor,
    i_syn: torch.Tensor,
    *,
    leak_shift: int,
    threshold_q: int,
    v_reset_q: int = 0,
    soft_reset: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused integer LIF update with the spikes packed in the kernel.
    Returns (v' of ``v``'s shape, words ``(..., ceil(n/32))`` int32),
    bit-exact with ``lif_step_ref`` followed by ``pack_bool``."""
    if v.shape != i_syn.shape:
        raise ValueError(f"lif_step_packed: v {tuple(v.shape)} and i_syn "
                         f"{tuple(i_syn.shape)} differ")
    if v.dim() == 0:
        raise ValueError("lif_step_packed: needs a last (neuron) axis")
    theta = int(threshold_q)
    dev = v.device
    if dev.type == "cpu":
        v2, s = _ref.lif_step_ref(v, i_syn, leak_shift=leak_shift,
                                  threshold_q=theta, v_reset_q=v_reset_q,
                                  soft_reset=soft_reset)
        return v2, packing.pack_bool(s)
    if dev.type != "cuda":
        raise ValueError(f"lif_step_packed: unsupported device {dev}")
    if i_syn.device != dev:
        raise ValueError(f"lif_step_packed: i_syn on {i_syn.device}, v on "
                         f"{dev}")
    n = v.shape[-1]
    rows = v.numel() // n if n else 0
    v_out = torch.empty(v.shape, dtype=torch.int32, device=dev)
    words = torch.empty((*v.shape[:-1], packing.packed_last_dim(n, 1)),
                        dtype=torch.int32, device=dev)
    if rows == 0:
        return v_out, words
    if rows > 2**31 - 1:
        raise ValueError(f"lif_step_packed: {rows} rows exceed the kernel's "
                         f"int32 row count")
    vi = v.to(torch.int32).contiguous()
    ii = i_syn.to(torch.int32).contiguous()
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lif_step_packed_launch(
            vi.data_ptr(), ii.data_ptr(), v_out.data_ptr(), words.data_ptr(),
            rows, n, leak_shift, theta, int(v_reset_q),
            int(bool(soft_reset)), stream)
    if err != 0:
        raise RuntimeError(
            f"lif_step_packed kernel launch failed: CUDA error {err} "
            f"({lib.lif_step_error_string(err).decode()})")
    _build.count_launch(lif_step)
    return v_out, words
