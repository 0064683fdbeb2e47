"""Post-training quantization to the packed L-SPINE format.

Port of ``repro.quant.ptq``: symmetric per-channel / per-group absmax
quantization with an MSE-optimal clip search for bits <= 4, plus
asymmetric min/max.  The packed axis is the LAST axis of the logical
tensor.  Every float operation is the one the JAX package performs, in
the same order, so words and scales come out identical.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import packing
from repro_torch.quant.formats import (
    PrecisionConfig,
    QuantizedConvTensor,
    QuantizedTensor,
)

# The 16 float32 clip fractions of the MSE search: the exact values
# jnp.linspace(0.25, 1.0, 16, dtype=float32) yields (its float32 lerp
# differs from torch.linspace in the last bit of a few entries, and a
# different fraction would change the chosen scale).
_CLIP_FRACS = (
    0.25, 0.30000001192092896, 0.3500000238418579, 0.4000000059604645,
    0.45000001788139343, 0.5, 0.550000011920929, 0.6000000238418579,
    0.6500000357627869, 0.7000000476837158, 0.75, 0.800000011920929,
    0.8500000238418579, 0.9000000357627869, 0.9500000476837158, 1.0,
)


def _group_reshape(x: torch.Tensor, group_size: int) -> torch.Tensor:
    """(..., n) -> (..., n_groups, group_size)."""
    n = x.shape[-1]
    if group_size == -1:
        return x.reshape(*x.shape[:-1], 1, n)
    if n % group_size:
        raise ValueError(f"n={n} not divisible by group_size={group_size}")
    return x.reshape(*x.shape[:-1], n // group_size, group_size)


def _mse_optimal_scale(g: torch.Tensor, absmax: torch.Tensor,
                       cfg: PrecisionConfig) -> torch.Tensor:
    """Per-group scale minimizing quantization MSE over the clip grid.

    Runs the grid sequentially so peak memory stays ~1x the tensor; ties
    keep the first (smallest) fraction, as ``jnp.argmin`` does.
    """
    best_mse = None
    best_frac = None
    for frac in _CLIP_FRACS:
        frac_t = torch.tensor(frac, dtype=torch.float32, device=g.device)
        scale = torch.clamp_min(absmax * frac_t / cfg.qmax, 1e-8)
        q = torch.clamp(torch.round(g / scale[..., None]), cfg.qmin,
                        cfg.qmax)
        mse = torch.mean((q * scale[..., None] - g) ** 2, dim=-1)
        if best_mse is None:
            best_mse = mse
            best_frac = torch.full_like(mse, frac)
        else:
            better = mse < best_mse       # strict: first minimum wins
            best_mse = torch.where(better, mse, best_mse)
            best_frac = torch.where(better, frac_t, best_frac)
    return torch.clamp_min(absmax * best_frac / cfg.qmax, 1e-8)


def quantize(w: torch.Tensor, cfg: PrecisionConfig) -> QuantizedTensor:
    """Quantize ``w`` (float, packed along last axis) to packed form."""
    if not cfg.quantized:
        raise ValueError("bits=16 tensors are not packed; keep them dense")
    w = w.to(torch.float32)
    g = _group_reshape(w, cfg.group_size)
    if cfg.symmetric:
        absmax = torch.amax(torch.abs(g), dim=-1)
        if cfg.clip_search and cfg.bits <= 4:
            scale = _mse_optimal_scale(g, absmax, cfg)
        else:
            scale = torch.clamp_min(absmax / cfg.qmax, 1e-8)
        zero = None
        q = torch.round(g / scale[..., None])
    else:
        lo = torch.amin(g, dim=-1)
        hi = torch.amax(g, dim=-1)
        scale = torch.clamp_min((hi - lo) / (cfg.qmax - cfg.qmin), 1e-8)
        zero = lo - cfg.qmin * scale
        q = torch.round((g - zero[..., None]) / scale[..., None])
    q = torch.clamp(q, cfg.qmin, cfg.qmax).to(torch.int32)
    q = q.reshape(w.shape)
    return QuantizedTensor(
        data=packing.pack(q, cfg.bits),
        scale=scale.to(torch.float32),
        zero=None if zero is None else zero.to(torch.float32),
        shape=tuple(w.shape),
        bits=cfg.bits,
        group_size=cfg.group_size,
    )


def quantize_int(w: torch.Tensor, cfg: PrecisionConfig
                 ) -> tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor]]:
    """Return (int values, scale, zero) without packing."""
    qt = quantize(w, cfg)
    return packing.unpack(qt.data, qt.bits, qt.n), qt.scale, qt.zero


def quantize_conv(w: torch.Tensor, cfg: PrecisionConfig
                  ) -> QuantizedConvTensor:
    """Quantize HWIO conv weights ``(kh, kw, c_in, c_out)`` to the packed
    im2col layout of the fused conv kernel.

    Per-output-channel symmetric quantization over the whole tap, then
    the codes are rearranged ``(c_out, kh, kw, c_in)``, the channel axis
    zero-padded to ``c_in_pad = 32 * ceil(c_in / 32)``, flattened and
    packed.  The zero codes line up with the zero bits a packed spike
    plane carries beyond ``c_in``, so padding never changes a sum.
    """
    if not cfg.quantized:
        raise ValueError("bits=16 conv weights are not packed; keep dense")
    if not cfg.symmetric or cfg.group_size != -1:
        raise ValueError(
            "quantize_conv: the fused conv datapath folds one scale per "
            "output channel into the integer threshold; only symmetric "
            "per-channel (group_size=-1) quantization is supported")
    kh, kw, c_in, c_out = w.shape
    wt = w.to(torch.float32).permute(3, 0, 1, 2).reshape(c_out, -1)
    q, scale, _ = quantize_int(wt, cfg)            # (c_out, kh*kw*c_in)
    c_in_pad = 32 * packing.packed_last_dim(c_in, 1)
    q = q.reshape(c_out, kh, kw, c_in)
    q = torch.nn.functional.pad(q, (0, c_in_pad - c_in))
    data = packing.pack(q.reshape(c_out, kh * kw * c_in_pad), cfg.bits)
    return QuantizedConvTensor(
        data=data,
        scale=scale.to(torch.float32),
        shape=(kh, kw, c_in, c_out),
        bits=cfg.bits,
        c_in_pad=c_in_pad,
    )


def unpack_conv_codes(qct: QuantizedConvTensor) -> torch.Tensor:
    """Integer codes in HWIO layout ``(kh, kw, c_in, c_out)`` (no scales)."""
    q = packing.unpack(qct.data, qct.bits, qct.k_flat)
    q = q.reshape(qct.c_out, qct.kh, qct.kw, qct.c_in_pad)[..., :qct.c_in]
    return q.permute(1, 2, 3, 0).contiguous()
