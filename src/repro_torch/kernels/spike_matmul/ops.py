"""Public entry point of spike-driven accumulation, dispatched by device.

* a CPU tensor runs the plain PyTorch version (ref.py);
* a CUDA tensor launches the hand-written kernel ``csrc/spike_matmul.cu``,
  or raises.  There is no fallback from one to the other.

The kernel is ``fused_nce``'s K-split cluster product at T=1 (their
shared ``csrc/nce_product.cuh``), launched by ``fused_nce``'s plan
``_nce_plan(1, m, kwords, bits, n_pad)``: rows per block and the
cluster's contraction split.  It reads the packed weights as ``quantize``
leaves them, ``(n, ceil(d_in*bits/32))`` words (words past a row's end
stage as zero), and masks the spike bits past ``d_in``, so both stay
inert as in the plain version.  The wrapper flattens the leading dims to
rows, allocates the output and launches one kernel.

``spike_matmul.launches`` counts kernel launches (and nothing else).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.core import packing
from repro_torch.kernels import build as _build
from repro_torch.kernels.fused_nce.ops import _nce_plan, _nce_smem_bytes
from repro_torch.kernels.spike_matmul import ref as _ref
from repro_torch.quant.formats import QuantizedTensor


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("spike_matmul")
    lib.spike_matmul_launch.argtypes = ([ctypes.c_void_p] * 3 +
                                        [ctypes.c_int] * 8 +
                                        [ctypes.c_void_p])
    lib.spike_matmul_launch.restype = ctypes.c_int
    lib.spike_matmul_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.spike_matmul_smem_bytes.restype = ctypes.c_size_t
    lib.spike_matmul_error_string.argtypes = [ctypes.c_int]
    lib.spike_matmul_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _launch_plan(m: int, kwords: int, bits: int,
                 n_pad: int) -> Tuple[int, int]:
    """(rb, split) from ``_nce_plan`` at T=1, cached per shape, held
    against the grid's limit and the kernel's own shared-memory size."""
    rb, split = _nce_plan(1, m, kwords, bits, n_pad)
    if -(-m // rb) > 65535 or n_pad // 32 > 65535:
        raise ValueError(f"spike_matmul: grid too large for {m} rows, "
                         f"{n_pad} outputs")
    smem = _lib().spike_matmul_smem_bytes(rb, kwords, split, bits)
    planned = _nce_smem_bytes(1, rb, kwords, split, bits)
    if smem != planned:
        raise ValueError(f"spike_matmul: the kernel holds {smem} bytes of "
                         f"shared memory, the wrapper planned {planned}")
    return rb, split


def spike_matmul(
    spikes_packed: torch.Tensor,  # (..., ceil(d_in/32)) int32
    qt: QuantizedTensor,          # packed (n, d_in) integer codes
    *,
    d_in: int,
) -> torch.Tensor:
    """Integer synaptic currents from packed spikes and packed weights.

    Returns (..., n) int32, bit-exact with the plain version.
    """
    n = qt.shape[0]
    kwords = spikes_packed.shape[-1]
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
    dev = spikes_packed.device
    if dev.type == "cpu":
        return _ref.spike_matmul_ref(spikes_packed, qt, d_in=d_in)
    if dev.type != "cuda":
        raise ValueError(f"spike_matmul: unsupported device {dev}")
    if qt.data.device != dev:
        raise ValueError(f"spike_matmul: weights on {qt.data.device}, spikes "
                         f"on {dev}")

    lead = spikes_packed.shape[:-1]
    s2 = spikes_packed.reshape(-1, kwords).to(torch.int32).contiguous()
    m = s2.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    if m == 0 or n == 0:
        return out.reshape(*lead, n)
    rb, split = _launch_plan(m, kwords, qt.bits, -(-n // 32) * 32)
    w = qt.data.to(torch.int32).contiguous()
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.spike_matmul_launch(
            s2.data_ptr(), w.data_ptr(), out.data_ptr(), m, kwords, d_in,
            wpr, qt.bits, n, rb, split, stream)
    if err != 0:
        raise RuntimeError(
            f"spike_matmul kernel launch failed: CUDA error {err} "
            f"({lib.spike_matmul_error_string(err).decode()})")
    _build.count_launch(spike_matmul)
    return out.reshape(*lead, n)


spike_matmul.launches = 0
