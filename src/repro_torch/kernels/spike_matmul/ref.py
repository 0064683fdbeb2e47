"""Plain PyTorch version of spike-driven synaptic accumulation (the AC unit).

Port of ``repro.kernels.spike_matmul.ref``.  Semantics:
``i_syn[..., n] = sum_k spikes[..., k] * Wq[n, k]`` with binary spikes
unpacked from 1-bit words and signed integer codes unpacked from the
sub-word packed format.  Integer-exact: the product runs in float64 on
integer operands ({0, 1} spikes, codes in [-128, 127], sums bounded by
``d_in*128``), so it is exact in any summation order and untouched by
TF32, and is cast back to int32.  No scales are applied; the engine folds
the weight scale into the integer threshold (core/nce.py).
"""

from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.quant.formats import QuantizedTensor


def spike_matmul_ref(
    spikes_packed: torch.Tensor,  # (..., ceil(k/32)) int32, 1-bit fields
    qt: QuantizedTensor,          # packed (n, k) integer codes
    *,
    d_in: int,
) -> torch.Tensor:
    s = packing.unpack_bool(spikes_packed, d_in).to(torch.float64)
    wq = packing.unpack(qt.data, qt.bits, qt.n).to(torch.float64)
    return torch.matmul(s, wq.T).to(torch.int32)
