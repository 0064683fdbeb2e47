"""Plain PyTorch version of the packed-weight matmul.

Port of ``repro.kernels.packed_qmatmul.ref``.  Semantics:
``y[m, n] = sum_k x[m, k] * (scale[n, g(k)] * Wq[n, k])`` with ``Wq``
the signed integer codes unpacked from the packed int32 words, the
dequantized weight rounded to float32 first, float32 accumulation, and
the result cast to ``x``'s dtype.  On a card the float32 product runs in
full float32 only with ``torch.backends.cuda.matmul.allow_tf32 = False``
(PyTorch's default); callers that compare against it set that.
"""

from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.quant.formats import QuantizedTensor


def dequant_w(qt: QuantizedTensor) -> torch.Tensor:
    """Unpack packed (out, in) weights to dense float32 (out, in)."""
    q = packing.unpack(qt.data, qt.bits, qt.n).to(torch.float32)
    n_out, k = qt.shape
    g = qt.n_groups
    w = q.reshape(n_out, g, k // g) * qt.scale[:, :, None]
    if qt.zero is not None:
        w = w + qt.zero[:, :, None]
    return w.reshape(n_out, k)


def qmatmul_ref(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """x: (..., k) activations; qt: packed (out, k).  Returns (..., out)."""
    w = dequant_w(qt)
    return torch.matmul(x.to(torch.float32), w.T).to(x.dtype)
