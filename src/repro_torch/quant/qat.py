"""Quantization-aware fake-quant with a straight-through estimator.

Port of ``repro.quant.qat.fake_quant``: forward quantize-dequantize
(symmetric absmax per channel/group), backward straight-through (identity
inside the clip range, zero outside).
"""

from __future__ import annotations

import torch

from repro_torch.quant.formats import PrecisionConfig


class _ClipRoundSTE(torch.autograd.Function):
    """``round(clip(x, lo, hi))`` forward.  Backward is the gradient
    ``jnp.clip`` gives followed by an identity round: 1 strictly inside
    (lo, hi), 1/2 exactly at a bound (the min/max tie split), 0 outside."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.lo, ctx.hi = lo, hi
        return torch.round(torch.clamp(x, lo, hi))

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        inside = ((x > ctx.lo) & (x < ctx.hi)).to(g.dtype)
        at_bound = ((x == ctx.lo) | (x == ctx.hi)).to(g.dtype)
        return g * (inside + 0.5 * at_bound), None, None


def fake_quant(w: torch.Tensor, cfg: PrecisionConfig) -> torch.Tensor:
    """Differentiable fake-quantization along the last axis."""
    if not cfg.quantized:
        return w
    n = w.shape[-1]
    gs = n if cfg.group_size == -1 else cfg.group_size
    if n % gs:
        gs = n     # group doesn't divide (e.g. a 27-wide conv): per-channel
    g = w.reshape(*w.shape[:-1], n // gs, gs)
    absmax = torch.amax(torch.abs(g), dim=-1, keepdim=True).detach()
    scale = torch.clamp_min(absmax / cfg.qmax, 1e-8)
    q = _ClipRoundSTE.apply(g / scale, cfg.qmin, cfg.qmax)
    return (q * scale).reshape(w.shape)
