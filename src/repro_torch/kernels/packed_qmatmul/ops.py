"""Public entry point of the packed-weight matmul, dispatched by device.

* a CPU tensor runs the plain PyTorch version (ref.py);
* a CUDA tensor launches the hand-written kernel
  ``csrc/packed_qmatmul.cu``, or raises.  There is no fallback from one
  to the other.

The kernel reads ``x`` in its own dtype (float32, bfloat16 or float16)
and writes the result in that dtype (float32 accumulation, one rounding
at the end, as the JAX package's ``qmatmul`` casts its float32 product).
It takes symmetric tensors only: a zero-point tensor on a CUDA tensor
raises (JAX sends it to the reference; nothing on the served path makes
one).  Group sizes are -1 (one scale per output row) or a multiple of 4.
When ``k`` is not a multiple of the codes per word, this wrapper pads
``x`` with zero columns to the packed width.

``qmatmul.launches`` counts kernel launches (and nothing else).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.core import packing
from repro_torch.kernels import build as _build
from repro_torch.kernels.packed_qmatmul import ref as _ref
from repro_torch.quant.formats import QuantizedTensor

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("packed_qmatmul")
    lib.packed_qmatmul_launch.argtypes = ([ctypes.c_void_p] * 4 +
                                          [ctypes.c_int] * 7 +
                                          [ctypes.c_void_p])
    lib.packed_qmatmul_launch.restype = ctypes.c_int
    lib.packed_qmatmul_error_string.argtypes = [ctypes.c_int]
    lib.packed_qmatmul_error_string.restype = ctypes.c_char_p
    return lib


def qmatmul(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """``x @ dequant(qt).T``: x (..., k); qt packed (n, k); out (..., n)
    in ``x``'s dtype."""
    n, k = qt.shape
    if x.shape[-1] != k:
        raise ValueError(f"qmatmul: x has k={x.shape[-1]}, weights {k}")
    dev = x.device
    if dev.type == "cpu":
        return _ref.qmatmul_ref(x, qt)
    if qt.zero is not None:
        raise ValueError("qmatmul: zero-point (asymmetric) tensors have no "
                         "CUDA kernel; quantize symmetric for serving")
    if dev.type != "cuda":
        raise ValueError(f"qmatmul: unsupported device {dev}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"qmatmul: x dtype {x.dtype} (float32, bfloat16 "
                         f"or float16)")
    gs = qt.group_size
    if gs != -1 and gs % 4:
        raise ValueError(f"qmatmul: group_size {gs} is not -1 or a "
                         f"multiple of 4")
    for name, t in (("weights", qt.data), ("scale", qt.scale)):
        if t.device != dev:
            raise ValueError(f"qmatmul: {name} on {t.device}, x on {dev}")
    wpr = packing.packed_last_dim(k, qt.bits)
    k_pad = wpr * packing.values_per_word(qt.bits)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if k_pad != k:
        x2 = F.pad(x2, (0, k_pad - k))
    x2 = x2.contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0 or n == 0:
        return out.reshape(*lead, n)
    if -(-m // 8) > 65535:
        raise ValueError(f"qmatmul: grid too large for {m} rows")
    x2 = x2.clone() if x2.data_ptr() % 16 else x2   # vector loads of x
    w = qt.data.to(torch.int32).contiguous()
    sc = qt.scale.to(torch.float32).contiguous()
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.packed_qmatmul_launch(
            x2.data_ptr(), w.data_ptr(), sc.data_ptr(), out.data_ptr(), m, n,
            k_pad, qt.bits, k if gs == -1 else gs, sc.shape[1],
            _DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"packed_qmatmul kernel launch failed: CUDA error {err} "
            f"({lib.packed_qmatmul_error_string(err).decode()})")
    qmatmul.launches += 1
    return out.reshape(*lead, n)


qmatmul.launches = 0
