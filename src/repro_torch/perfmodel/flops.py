"""FLOPs of a PyTorch callable, counted op by op.

Port of ``repro.perfmodel.flops``.  ``repro`` walks a jaxpr; the port
runs the callable under a ``TorchDispatchMode`` and charges every ATen
op that reaches the dispatcher, with ``repro``'s rules:

  mm / addmm / bmm / baddbmm   2 * batch * M * N * K
  convolution                  2 * out_elems * (kh * kw * C_in / groups)
  convolution_backward         the same product once for each of
                               grad_input and grad_weight it computes,
                               plus the bias gradient's elements
  every other op               1 flop per output element

Views (``reshape``, ``t``, ``expand``, ``detach``, ...) alias their input
and do no work, so they are not charged.  The callable runs for real,
so a Python loop is charged once per trip (``repro`` multiplies a scan
body by its length) and a ``torch.utils.checkpoint`` body once in a
forward (its recompute happens only in a backward, as ``repro`` counts
remat bodies once).  Arguments may be ``meta`` tensors, which carry
shapes and no data: a count then costs no compute.
"""

from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

_aten = torch.ops.aten
_MATMULS = {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm}


def _matmul_flops(packet, args) -> int:
    a, b = (args[1], args[2]) if packet in (_aten.addmm, _aten.baddbmm) \
        else (args[0], args[1])
    batch = a.shape[0] if a.dim() == 3 else 1
    m, k = a.shape[-2], a.shape[-1]
    n = b.shape[-1]
    return 2 * batch * m * n * k


def _conv_window(weight) -> int:
    """kh * kw * C_in / groups: ``weight`` is (C_out, C_in/groups, *k)."""
    return math.prod(weight.shape[1:])


def _op_flops(func, args, out) -> int:
    """FLOPs one ATen op call costs under the rules above."""
    packet = func.overloadpacket
    if packet in _MATMULS:
        return _matmul_flops(packet, args)
    if packet is _aten.convolution:
        return 2 * out.numel() * _conv_window(args[1])
    if packet is _aten.convolution_backward:
        grad_out, weight, mask = args[0], args[2], args[-1]
        per = 2 * grad_out.numel() * _conv_window(weight)
        bias = out[2].numel() if mask[2] else 0
        return per * (int(mask[0]) + int(mask[1])) + bias
    if func.is_view:
        return 0
    return sum(t.numel() for t in tree_leaves(out)
               if isinstance(t, torch.Tensor))


class _FlopCounter(TorchDispatchMode):
    """Dispatch mode that adds every op's :func:`_op_flops` to ``total``."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.total += _op_flops(func, args, out)
        return out


def count_fn_flops(fn, *args, **kwargs) -> int:
    """Global FLOPs of ``fn(*args, **kwargs)``, run once under
    :class:`_FlopCounter`."""
    with _FlopCounter() as counter:
        fn(*args, **kwargs)
    return counter.total


def model_flops_6nd(n_params: int, n_tokens: int) -> int:
    """The 6·N·D reference (dense training: fwd 2ND + bwd 4ND)."""
    return 6 * n_params * n_tokens


def model_flops_2nd(n_params: int, n_tokens: int) -> int:
    """Inference reference: 2·N per token."""
    return 2 * n_params * n_tokens
