"""Public entry point of the packed-weight matmul, dispatched by device.

* a CPU tensor runs the plain PyTorch version (ref.py);
* a CUDA tensor launches the hand-written kernel
  ``csrc/packed_qmatmul.cu``, or raises.  There is no fallback from one
  to the other.

The kernel has two variants, chosen by :func:`_variant` from the shape
alone:

* ``"mma"`` (tensor cores, wgmma) for ``m >= 64`` rows of bfloat16 or
  float16 ``x`` with one scale per row or groups that are a multiple of
  the 64-wide K tile: every olmo-1b prefill of 64 tokens or more.  The
  codes enter the tensor cores exactly and the scales are applied in
  float32 after the sum; :func:`_mma_tile` picks its output tile;
* ``"gemv"`` (CUDA cores, float32 ``fmaf`` on dequantized codes) for
  everything else: the decode steps (``m`` = slots), short prompts,
  float32 ``x`` and other group sizes.

Both read ``x`` in its own dtype (float32, bfloat16 or float16) and write
the result in that dtype (float32 accumulation, one rounding at the end,
as the JAX package's ``qmatmul`` casts its float32 product).  They take
symmetric tensors only: a zero-point tensor on a CUDA tensor raises (JAX
sends it to the reference; nothing on the served path makes one).  Group
sizes are -1 (one scale per output row) or a multiple of 4.  When ``k``
is not a multiple of the codes per word, this wrapper pads ``x`` with
zero columns to the packed width.

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
from repro_torch.kernels.smem import N_SMS
from repro_torch.quant.formats import QuantizedTensor

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("packed_qmatmul")
    lib.packed_qmatmul_launch.argtypes = ([ctypes.c_void_p] * 4 +
                                          [ctypes.c_int] * 12 +
                                          [ctypes.c_void_p])
    lib.packed_qmatmul_launch.restype = ctypes.c_int
    lib.packed_qmatmul_error_string.argtypes = [ctypes.c_int]
    lib.packed_qmatmul_error_string.restype = ctypes.c_char_p
    return lib


MMA_MIN_M = 64      # rows of x from which the tensor-core variant runs
MMA_K_TILE = 64     # its K tile; grouped scales must align with it


def _variant(m: int, dtype: torch.dtype, group_size: int) -> str:
    """The kernel variant for ``m`` rows of ``x`` in ``dtype``: ``"mma"``
    (tensor cores) or ``"gemv"`` (CUDA cores)."""
    if (m >= MMA_MIN_M and dtype in (torch.bfloat16, torch.float16)
            and (group_size == -1 or group_size % MMA_K_TILE == 0)):
        return "mma"
    return "gemv"


def _mma_tile(m: int, n: int, grouped: bool = False) -> tuple:
    """Rows x columns of x's output per block of the mma variant: the
    largest of 128 x 256 (one scale per row only) and 128 x 64 whose
    tiles give every SM of the card a block, else 64 x 64.  These are
    the kernel's only tile instances."""
    tiles = ((128, 64),) if grouped else ((128, 256), (128, 64))
    for bm, bn in tiles:
        if -(-m // bm) * -(-n // bn) >= N_SMS:
            return bm, bn
    return 64, 64


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
    variant = _variant(m, x.dtype, gs)
    w = qt.data.to(torch.int32).contiguous()
    sc = qt.scale.to(torch.float32).contiguous()
    vec = int(wpr % 4 == 0 and w.data_ptr() % 16 == 0)
    if variant == "mma":
        ldx = -(-k_pad // 8) * 8        # 16-byte rows for cp.async
        if ldx != k_pad:
            x2 = F.pad(x2, (0, ldx - k_pad))
        tile_m, tile_n = _mma_tile(m, n, sc.shape[1] > 1)
    else:
        if -(-m // 8) > 65535:
            raise ValueError(f"qmatmul: grid too large for {m} rows")
        ldx, tile_m, tile_n = k_pad, 0, 0
    x2 = x2.clone() if x2.data_ptr() % 16 else x2   # vector loads of x
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.packed_qmatmul_launch(
            x2.data_ptr(), w.data_ptr(), sc.data_ptr(), out.data_ptr(), m, n,
            k_pad, qt.bits, k if gs == -1 else gs, sc.shape[1],
            _DTYPES[x.dtype], int(variant == "mma"), tile_m, tile_n, ldx,
            vec, stream)
    if err != 0:
        raise RuntimeError(
            f"packed_qmatmul kernel launch failed: CUDA error {err} "
            f"({lib.packed_qmatmul_error_string(err).decode()})")
    _build.count_launch(qmatmul)
    return out.reshape(*lead, n)


qmatmul.launches = 0
