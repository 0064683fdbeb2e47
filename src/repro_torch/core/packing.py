"""Sub-word SIMD packing: the storage format behind L-SPINE's datapath.

Port of ``repro.core.packing``; the word layout is identical bit for bit:

* values are packed along the LAST axis, ``32 // bits`` fields per int32
  word, lowest field in the lowest bits (LSB-first);
* signed fields are stored biased by ``2**(bits-1)`` and re-centred on
  unpack, so pack/unpack are pure shift and mask;
* ``bits=1`` is the spike-train format (``pack_bool``).

``torch.sum`` over int32 promotes to int64, so :func:`pack` sums the
shifted fields in int64 and wraps the result back to int32 explicitly;
the field at bit 31 then lands in the sign bit exactly as the JAX
package's int32 sum leaves it.
"""

from __future__ import annotations

import numpy as np
import torch

SUPPORTED_BITS = (1, 2, 4, 8)
WORD_BITS = 32


def values_per_word(bits: int) -> int:
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits must be one of {SUPPORTED_BITS}, got {bits}")
    return WORD_BITS // bits


def packed_last_dim(n: int, bits: int) -> int:
    """Number of int32 words needed to hold ``n`` values of width ``bits``."""
    vpw = values_per_word(bits)
    return (n + vpw - 1) // vpw


def _field_offsets(bits: int, device, dtype=torch.int64) -> torch.Tensor:
    """Bit offsets of each field inside one word, lowest field first."""
    return torch.arange(values_per_word(bits), dtype=dtype,
                        device=device) * bits


def pack(values: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack signed integers of width ``bits`` along the last axis.

    values: integer tensor, each element in [-2^(bits-1), 2^(bits-1) - 1]
            (or {0, 1} for bits=1).
    Returns an int32 tensor whose last dim is ``packed_last_dim(n, bits)``.
    """
    vpw = values_per_word(bits)
    n = values.shape[-1]
    pad = (-n) % vpw
    v = values.to(torch.int64)
    if bits > 1:
        v = v + (1 << (bits - 1))  # bias to unsigned field
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
    v = v.reshape(*v.shape[:-1], (n + pad) // vpw, vpw)
    offs = _field_offsets(bits, v.device)
    # fields are disjoint, so summing the shifted fields == bitwise-or
    words = torch.sum((v & ((1 << bits) - 1)) << offs, dim=-1)
    # wrap the unsigned 32-bit word into int32 (the bit-31 field)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32)


def unpack(words: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack`; returns int32 values, last dim = n."""
    vpw = values_per_word(bits)
    offs = _field_offsets(bits, words.device, torch.int32)
    fields = (words.to(torch.int32)[..., None] >> offs) & ((1 << bits) - 1)
    flat = fields.reshape(*words.shape[:-1], words.shape[-1] * vpw)
    flat = flat[..., :n]
    if bits > 1:
        flat = flat - (1 << (bits - 1))
    return flat.contiguous()


def pack_bool(values: torch.Tensor) -> torch.Tensor:
    """Pack a boolean/{0,1} tensor along the last axis, 32 per int32 word."""
    return pack(values.to(torch.int32), bits=1)


def unpack_bool(words: torch.Tensor, n: int) -> torch.Tensor:
    return unpack(words, bits=1, n=n)


# ---------------------------------------------------------------------------
# numpy twins (checkpoint tooling off-device)
# ---------------------------------------------------------------------------

def pack_np(values: np.ndarray, bits: int) -> np.ndarray:
    vpw = values_per_word(bits)
    n = values.shape[-1]
    pad = (-n) % vpw
    v = values.astype(np.int64)
    if bits > 1:
        v = v + (1 << (bits - 1))
    if pad:
        v = np.pad(v, [(0, 0)] * (v.ndim - 1) + [(0, pad)])
    v = v.reshape(*v.shape[:-1], (n + pad) // vpw, vpw)
    offs = (np.arange(vpw) * bits).astype(np.int64)
    words = np.sum((v & ((1 << bits) - 1)) << offs, axis=-1)
    # int32 wrap for the top field is intentional (bit-identical to device)
    return words.astype(np.uint32).astype(np.int32)


def unpack_np(words: np.ndarray, bits: int, n: int) -> np.ndarray:
    vpw = values_per_word(bits)
    offs = (np.arange(vpw) * bits).astype(np.int64)
    fields = (words.astype(np.uint32)[..., None] >> offs) & ((1 << bits) - 1)
    flat = fields.reshape(*words.shape[:-1], words.shape[-1] * vpw)
    flat = flat[..., :n].astype(np.int64)
    if bits > 1:
        flat = flat - (1 << (bits - 1))
    return flat.astype(np.int32)
