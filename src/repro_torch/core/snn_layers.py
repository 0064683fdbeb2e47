"""Spiking layers: the per-layer primitives the graph executors lower onto.

Port of ``repro.core.snn_layers``.  The float/BPTT twins
(:func:`spiking_conv_apply`, :func:`spiking_dense_apply`, with QAT
fake-quant when the precision quantizes, the average pool
:func:`avgpool_t`) train the model and run the integer path's stem; the
integer twins run every post-stem layer through the fused kernels
(:func:`spiking_conv_int_apply`, :func:`spiking_dense_int_apply`, and
:func:`spiking_conv_group_int_apply` for a fusion group) between binary
max pools; the float readout ends both.  The weight packing and
threshold fold are shared by ``deploy()`` and the per-call path.

The float convolution runs in full float32 forward and backward (cuDNN
with TF32 off, deterministic algorithms), so a spike at threshold does
not flip with the card's arithmetic.

Layout convention: time axis first, activations (T, B, ...) NHWC.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import packing
from repro_torch.core.lif import LIFConfig, lif_rollout_float
from repro_torch.kernels.fused_conv import ops as fused_conv_ops
from repro_torch.kernels.fused_conv.ref import conv_pads
from repro_torch.kernels.fused_group import ops as fused_group_ops
from repro_torch.kernels.fused_nce import ops as fused_nce_ops
from repro_torch.quant.formats import PrecisionConfig
from repro_torch.quant.ptq import quantize, quantize_conv
from repro_torch.quant.qat import fake_quant


def _fold_threshold_q(scale: torch.Tensor, lif: LIFConfig) -> torch.Tensor:
    """Fold the float threshold into the integer domain per output channel
    (theta_q[c] ~ theta / scale[c]).  ``scale`` is ``(n_out, n_groups)``;
    grouped scales average across groups.  Returns an int32 vector."""
    s = scale.to(torch.float32)
    if s.ndim > 1:
        s = torch.mean(s, dim=-1)
    s = s.reshape(-1)
    theta = torch.round(lif.threshold / torch.clamp_min(s, 1e-12))
    return torch.clamp_min(theta, 1.0).to(torch.int32)


def pack_dense_weights(params, pc: PrecisionConfig):
    """Quantize + pack a dense layer's float params (gain ``g`` folded in)
    to a ``QuantizedTensor`` in (d_out, d_in) layout."""
    w = params["w"]                       # (d_in, d_out) float
    if "g" in params:
        w = w * params["g"]
    return quantize(w.T, pc)


def pack_conv_weights(params, pc: PrecisionConfig):
    """Conv twin of :func:`pack_dense_weights`: HWIO float params ->
    packed ``QuantizedConvTensor`` (gain folded in)."""
    w = params["w"]                       # (kh, kw, c_in, c_out) float
    if "g" in params:
        w = w * params["g"]
    return quantize_conv(w, pc)


def _maybe_fq(w: torch.Tensor, pc: Optional[PrecisionConfig]
              ) -> torch.Tensor:
    """QAT fake-quant of a dense (in, out) weight when ``pc`` quantizes:
    its groups run along the last axis, so the contraction goes last."""
    if pc is not None and pc.quantized:
        return fake_quant(w.transpose(-1, -2), pc).transpose(-1, -2)
    return w


# ---------------------------------------------------------------------------
# init (shapes and scales of repro's conv_init / dense_init)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, device=None):
    scale = (2.0 / d_in) ** 0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32)
    return {"w": (w * scale).to(device),
            "g": torch.ones((d_out,), dtype=torch.float32, device=device)}


def conv_init(gen: torch.Generator, c_in: int, c_out: int, k: int = 3,
              device=None):
    scale = (2.0 / (c_in * k * k)) ** 0.5
    w = torch.randn((k, k, c_in, c_out), generator=gen, dtype=torch.float32)
    return {"w": (w * scale).to(device),
            "g": torch.ones((c_out,), dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# float/BPTT twins
# ---------------------------------------------------------------------------

def _exact_cudnn():
    """cuDNN in full float32 (no TF32, on by default for convolutions)
    with deterministic algorithms, the same for every batch size."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


class _ExactConv2d(torch.autograd.Function):
    """``F.conv2d`` (NCHW, no padding) whose backward runs under the same
    cuDNN flags as its forward.  Autograd runs a backward after the
    forward's context has closed, so a plain ``F.conv2d`` under
    :func:`_exact_cudnn` would take its input and weight gradients in
    PyTorch's defaults (TF32 on)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, stride: int):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        with _exact_cudnn():
            return F.conv2d(x, w, stride=stride)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        gx = gw = None
        with _exact_cudnn():
            if ctx.needs_input_grad[0]:
                gx = torch.nn.grad.conv2d_input(x.shape, w, g,
                                                stride=ctx.stride)
            if ctx.needs_input_grad[1]:
                gw = torch.nn.grad.conv2d_weight(x, w.shape, g,
                                                 stride=ctx.stride)
        return gx, gw, None


def _conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
            padding="SAME") -> torch.Tensor:
    """NHWC x HWIO float convolution with XLA's SAME/VALID pads, in full
    float32 forward and backward (:class:`_ExactConv2d`), or spikes
    would flip at threshold."""
    kh, kw = w.shape[0], w.shape[1]
    (plh, phh), (plw, phw) = conv_pads(x.shape[1], x.shape[2], kh, kw,
                                       stride, padding)
    xn = F.pad(x.permute(0, 3, 1, 2), (plw, phw, plh, phh))
    y = _ExactConv2d.apply(xn, w.permute(3, 2, 0, 1), stride)
    return y.permute(0, 2, 3, 1)


def spiking_conv_apply(
    params,
    spikes_t: torch.Tensor,     # (T, B, H, W, C) analog currents or spikes
    lif: LIFConfig,
    pc: Optional[PrecisionConfig] = None,
    stride: int = 1,
) -> torch.Tensor:
    """Float spiking conv (fake-quantized weights when ``pc`` quantizes)
    + float LIF rollout.  Returns (T, B, Ho, Wo, c_out) {0,1} float."""
    w = params["w"]
    if pc is not None and pc.quantized:
        # per-output-channel groups: (k,k,ci,co) -> (co, k*k*ci)
        k1, k2, ci, co = w.shape
        wt = w.permute(3, 0, 1, 2).reshape(co, k1 * k2 * ci)
        wt = fake_quant(wt, pc)
        w = wt.reshape(co, k1, k2, ci).permute(1, 2, 3, 0)
    t_steps, b = spikes_t.shape[:2]
    x = spikes_t.reshape(t_steps * b, *spikes_t.shape[2:]).to(w.dtype)
    i_syn = _conv2d(x, w, stride=stride)
    i_syn_t = i_syn.reshape(t_steps, b, *i_syn.shape[1:])
    if "g" in params:  # threshold-balancing gain
        i_syn_t = i_syn_t * params["g"]
    v0 = torch.zeros(i_syn_t.shape[1:], dtype=i_syn_t.dtype,
                     device=i_syn_t.device)
    _, s_t = lif_rollout_float(v0, i_syn_t, lif)
    return s_t


def spiking_dense_apply(
    params,
    spikes_t: torch.Tensor,     # (T, B, d_in) {0,1} spikes or currents
    lif: LIFConfig,
    pc: Optional[PrecisionConfig] = None,
) -> torch.Tensor:
    """Synaptic accumulation (fake-quantized weights when ``pc``
    quantizes) + float LIF rollout.  Returns (T, B, d_out) {0,1} float."""
    w = _maybe_fq(params["w"], pc)
    i_syn_t = torch.einsum("tbi,io->tbo", spikes_t.to(w.dtype), w)
    if "g" in params:  # threshold-balancing gain
        i_syn_t = i_syn_t * params["g"]
    v0 = torch.zeros(i_syn_t.shape[1:], dtype=i_syn_t.dtype,
                     device=i_syn_t.device)
    _, s_t = lif_rollout_float(v0, i_syn_t, lif)
    return s_t


def avgpool_t(spikes_t: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Non-overlapping VALID average pool per timestep (keeps spike
    statistics), in float32 as ``repro`` computes it."""
    t, b, h, w, c = spikes_t.shape
    ho, wo = h // window, w // window
    x = spikes_t[:, :, :ho * window, :wo * window].to(torch.float32)
    x = x.reshape(t, b, ho, window, wo, window, c)
    return torch.sum(x, dim=(3, 5)) / (window * window)


# ---------------------------------------------------------------------------
# integer twins: every post-stem layer through the fused kernels
# ---------------------------------------------------------------------------

def spiking_conv_int_apply(
    params,
    spikes_t: torch.Tensor,     # (T, B, H, W, C) {0,1} binary spikes
    lif: LIFConfig,
    pc: PrecisionConfig,
    stride: int = 1,
    threshold_q=None,
    qct=None,
) -> torch.Tensor:
    """Integer spiking conv: pack the spike planes along channels, run all
    T steps through the fused conv rollout, unpack the output spikes.
    With ``qct`` (and ``threshold_q``) from a deploy package, ``params``
    is ignored and nothing is quantized.  Returns (T, B, Ho, Wo, c_out)
    {0,1} int32 spikes (SAME padding)."""
    if qct is None:
        qct = pack_conv_weights(params, pc)
    if qct.bits != pc.bits:
        raise ValueError(f"packed weights are {qct.bits}-bit, "
                         f"precision asks for {pc.bits}-bit")
    if threshold_q is None:
        threshold_q = _fold_threshold_q(qct.scale, lif)
    packed_in = packing.pack_bool(spikes_t)
    _, packed_out = fused_conv_ops.fused_conv_rollout(
        packed_in, qct, stride=stride, padding="SAME",
        leak_shift=lif.leak_shift, threshold_q=threshold_q,
        soft_reset=lif.soft_reset)
    return packing.unpack_bool(packed_out, qct.c_out)


def spiking_conv_group_int_apply(
    members,
    spikes_t: torch.Tensor,     # (T, B, H, W, C) {0,1} binary spikes
    lif: LIFConfig,
    pc: PrecisionConfig,
) -> torch.Tensor:
    """Fusion-group twin of :func:`spiking_conv_int_apply`: a chain of 2+
    stride-1 convs (with optional interleaved max pools) runs its whole
    T-step rollout in ONE ``fused_group`` launch.

    ``members`` is the executor-shaped chain: ``("conv", operands)``
    entries carry the operands dict the single-layer twin takes (float
    ``params`` to quantize per call, or a packed ``qct`` + ``threshold_q``
    from a deploy package), ``("pool", window)`` entries the window.
    Bit-exact with composing :func:`spiking_conv_int_apply` and
    :func:`maxpool_t` member by member.  Returns (T, B, HoF, WoF, c_outF)
    {0,1} int32 spikes."""
    chain = []
    last_c_out = None
    for m in members:
        if m[0] == "conv":
            _, operands = m
            qct = operands.get("qct")
            if qct is None:
                qct = pack_conv_weights(operands["params"], pc)
            if qct.bits != pc.bits:
                raise ValueError(f"packed weights are {qct.bits}-bit, "
                                 f"precision asks for {pc.bits}-bit")
            theta = operands.get("threshold_q")
            if theta is None:
                theta = _fold_threshold_q(qct.scale, lif)
            chain.append(("conv", qct, theta))
            last_c_out = qct.c_out
        else:
            chain.append(("pool", m[1]))
    packed_in = packing.pack_bool(spikes_t)
    _, packed_out = fused_group_ops.fused_group_rollout(
        packed_in, tuple(chain), leak_shift=lif.leak_shift,
        soft_reset=lif.soft_reset)
    return packing.unpack_bool(packed_out, last_c_out)


def spiking_dense_int_apply(
    params,
    spikes_t: torch.Tensor,     # (T, B, d_in) {0,1} binary spikes
    lif: LIFConfig,
    pc: PrecisionConfig,
    threshold_q=None,
    qt=None,
) -> torch.Tensor:
    """Integer spiking dense layer through the fused NCE rollout.
    Returns (T, B, d_out) {0,1} int32 spikes."""
    if qt is None:
        qt = pack_dense_weights(params, pc)
    if qt.bits != pc.bits:
        raise ValueError(f"packed weights are {qt.bits}-bit, "
                         f"precision asks for {pc.bits}-bit")
    if threshold_q is None:
        threshold_q = _fold_threshold_q(qt.scale, lif)
    d_out, d_in = qt.shape
    packed_in = packing.pack_bool(spikes_t)
    _, packed_out = fused_nce_ops.fused_nce_rollout(
        packed_in, qt, d_in=d_in, leak_shift=lif.leak_shift,
        threshold_q=threshold_q, soft_reset=lif.soft_reset)
    return packing.unpack_bool(packed_out, d_out)


def maxpool_t(spikes_t: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Non-overlapping VALID max pool per timestep (an OR for {0,1}
    spikes, so the pooled plane stays 1-bit packable)."""
    t, b, h, w, c = spikes_t.shape
    ho, wo = h // window, w // window
    x = spikes_t[:, :, :ho * window, :wo * window]
    x = x.reshape(t, b, ho, window, wo, window, c)
    return torch.amax(x, dim=(3, 5))


def readout_apply(params, spikes_t: torch.Tensor) -> torch.Tensor:
    """Non-spiking readout: (B, n_classes) logits = mean_t (spikes_t @ W)."""
    w = params["w"]
    i_syn_t = torch.einsum("tbi,io->tbo", spikes_t.to(w.dtype), w)
    return torch.mean(i_syn_t, dim=0)
