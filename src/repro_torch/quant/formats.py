"""Quantized tensor containers: the unified multi-precision datapath's type.

Port of ``repro.quant.formats``.  The containers are plain dataclasses of
tensors (no pytree registration is needed in eager PyTorch); ``to()``
moves the tensors to another device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    """The PC (precision control) word of the engine.

    bits:        2, 4 or 8 (16 means "no quantization").
    group_size:  contraction-dim group for scales; -1 = per-(out-)channel.
    symmetric:   symmetric (no zero point) vs asymmetric quantization.
    accum_dtype: integer accumulator width (int32, as on the FPGA).
    clip_search: MSE-optimal clip search over a 16-point grid (bits <= 4).
    """

    bits: int = 8
    group_size: int = -1
    symmetric: bool = True
    accum_dtype: str = "int32"
    clip_search: bool = True

    def __post_init__(self):
        if self.bits not in (2, 4, 8, 16):
            raise ValueError(f"unsupported bits={self.bits}")
        if self.bits != 16 and self.group_size != -1 and self.group_size <= 0:
            raise ValueError(f"bad group_size={self.group_size}")

    @property
    def quantized(self) -> bool:
        return self.bits != 16

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1

    @property
    def qmin(self) -> int:
        return -(1 << (self.bits - 1))


@dataclasses.dataclass
class QuantizedTensor:
    """Packed low-precision tensor.

    data:   int32 words, shape = shape[:-1] + (packed_last_dim,).
    scale:  float32, shape = shape[:-1] + (n_groups,).
    zero:   optional float32 zero points (asymmetric), same shape as scale.
    shape:  logical (unpacked) shape.
    bits:   field width.
    group_size: contraction group (-1 = one group).
    """

    data: torch.Tensor
    scale: torch.Tensor
    zero: Optional[torch.Tensor]
    shape: Tuple[int, ...]
    bits: int
    group_size: int

    @property
    def n(self) -> int:
        """Logical length of the packed axis."""
        return self.shape[-1]

    def to(self, device) -> "QuantizedTensor":
        return dataclasses.replace(
            self, data=self.data.to(device), scale=self.scale.to(device),
            zero=None if self.zero is None else self.zero.to(device))

    def nbytes_packed(self) -> int:
        """Device bytes of the packed representation (data + scales)."""
        z = 0 if self.zero is None else self.zero.numel() * 4
        return self.data.numel() * 4 + self.scale.numel() * 4 + z

    def nbytes_dense_fp32(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n * 4

    def compression_ratio(self) -> float:
        return self.nbytes_dense_fp32() / self.nbytes_packed()


@dataclasses.dataclass
class QuantizedConvTensor:
    """Packed low-precision conv weights for the fused conv datapath.

    The logical tensor is HWIO ``(kh, kw, c_in, c_out)``.  Per output
    channel the taps are flattened ``(kh, kw, c_in_pad)`` with ``c_in``
    zero-padded to a spike-word multiple, so the contraction layout
    matches a 1-bit unpack of a packed spike plane tap for tap.

    data:     int32 words, (c_out, kh*kw*c_in_pad * bits / 32).
    scale:    float32 per-output-channel scales, (c_out, 1).
    shape:    logical HWIO shape.
    bits:     field width (2/4/8).
    c_in_pad: padded input-channel count baked into the flattened layout.
    """

    data: torch.Tensor
    scale: torch.Tensor
    shape: Tuple[int, ...]
    bits: int
    c_in_pad: int

    @property
    def kh(self) -> int:
        return self.shape[0]

    @property
    def kw(self) -> int:
        return self.shape[1]

    @property
    def c_in(self) -> int:
        return self.shape[2]

    @property
    def c_out(self) -> int:
        return self.shape[3]

    @property
    def k_flat(self) -> int:
        """Flattened contraction length seen by the im2col product."""
        return self.kh * self.kw * self.c_in_pad

    def to(self, device) -> "QuantizedConvTensor":
        return dataclasses.replace(self, data=self.data.to(device),
                                   scale=self.scale.to(device))

    def nbytes_packed(self) -> int:
        return (self.data.numel() + self.scale.numel()) * 4

    def nbytes_dense_fp32(self) -> int:
        kh, kw, ci, co = self.shape
        return kh * kw * ci * co * 4

    def compression_ratio(self) -> float:
        return self.nbytes_dense_fp32() / self.nbytes_packed()
