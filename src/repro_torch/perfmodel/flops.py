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
and do no work, so they are not charged, and neither are collectives
(``_c10d_functional.*``, ``c10d.*``), which move data and compute
nothing.  The callable runs for real,
so a Python loop is charged once per trip (``repro`` multiplies a scan
body by its length) and a ``torch.utils.checkpoint`` body once in a
forward (its recompute happens only in a backward, as ``repro`` counts
remat bodies once).  Arguments may be ``meta`` tensors, which carry
shapes and no data: a count then costs no compute.

On DTensors (``distributed.sharding``) the count is the rank's: a mode
meets a DTensor op first, at its global shape, so the counter hands it
on to DTensor (``NotImplemented``, as ``CommDebugMode`` does), whose
local ops and collectives then come back to the mode and are charged
(``launch/dryrun.py`` counts the collectives' bytes).  DTensor's sharding
propagation also runs each new op once on global-shape fake tensors to
learn its output's shape; those ops compute nothing of the step and
are not charged (:class:`LocalOpMode`).
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
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


def is_comm(func) -> bool:
    """A collective or point-to-point op (or its wait)."""
    return func.namespace in ("_c10d_functional", "c10d")


def _op_flops(func, args, out) -> int:
    """FLOPs one ATen op call costs under the rules above."""
    if is_comm(func):
        return 0
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


class LocalOpMode(TorchDispatchMode):
    """A dispatch mode that meets every op a rank runs, at the rank's
    shapes, and calls :meth:`charge` on it: DTensor ops are handed on to
    DTensor, which runs them as local ops and collectives that come back
    here; the ops of DTensor's sharding propagation are run and not
    charged (while the mode is entered, ``ShardingPropagator``'s
    propagation method counts how deep it is in ``_propagating``)."""

    def __enter__(self):
        self._propagating = 0
        self._orig = orig = \
            ShardingPropagator._propagate_tensor_meta_non_cached

        def marked(prop, op_schema):
            self._propagating += 1
            try:
                return orig(prop, op_schema)
            finally:
                self._propagating -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = marked
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            ShardingPropagator._propagate_tensor_meta_non_cached = \
                self._orig

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not self._propagating:
            self.charge(func, args, out)
        return out

    def charge(self, func, args, out) -> None:
        raise NotImplementedError


class _FlopCounter(LocalOpMode):
    """Dispatch mode that adds every op's :func:`_op_flops` to ``total``."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def charge(self, func, args, out) -> None:
        self.total += _op_flops(func, args, out)


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
