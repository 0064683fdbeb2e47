"""Shift-add LIF neuron dynamics: L-SPINE's multiplier-less neuron model.

Port of ``repro.core.lif``.  Per timestep, with shifts and adds only:

    v[t]   = v[t-1] - (v[t-1] >> k)  + sum_j s_j[t] * w_j      (integer)
    s[t]   = v[t] >= theta
    v[t]   = v_reset            if s[t] and hard reset
           = v[t] - theta       if s[t] and soft  reset

:func:`lif_step_int` is the exact integer semantics the fused kernels
reproduce; :func:`lif_step_float` is the float twin with a fast-sigmoid
surrogate gradient (:class:`SpikeFn`), which drives the float stem.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LIFConfig:
    leak_shift: int = 3          # k: beta = 1 - 2^-k  (k=3 -> beta=0.875)
    threshold: float = 1.0       # firing threshold (integer domain: theta_q)
    v_reset: float = 0.0
    soft_reset: bool = True      # subtract-threshold reset
    surrogate_beta: float = 4.0  # sharpness of the surrogate gradient
    timesteps: int = 4           # T: inference window

    @property
    def beta(self) -> float:
        return 1.0 - 2.0 ** (-self.leak_shift)


# ---------------------------------------------------------------------------
# Integer (deployment) semantics
# ---------------------------------------------------------------------------

def as_theta_vector(threshold_q, n: int, device=None) -> torch.Tensor:
    """Normalize an integer threshold to a per-channel ``(n,)`` int32 vector.

    A Python/0-d threshold broadcasts to a constant vector; a vector must
    have one entry per output channel.
    """
    t = torch.as_tensor(threshold_q, device=device).to(torch.int32)
    if t.ndim == 0:
        return t.expand(n).contiguous()
    t = t.reshape(-1)
    if t.shape[0] != n:
        raise ValueError(
            f"threshold_q vector has {t.shape[0]} channels, layer has {n}")
    return t


def lif_step_int(
    v: torch.Tensor,          # int32 membrane potential
    i_syn: torch.Tensor,      # int32 synaptic current (already accumulated)
    *,
    leak_shift: int,
    threshold_q,
    v_reset_q: int = 0,
    soft_reset: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One multiplier-less integer LIF update.  Returns (v', spikes).

    ``threshold_q`` is a scalar or a per-output-channel int32 vector that
    broadcasts along the last (channel) axis.
    """
    v = v.to(torch.int32)
    # torch's >> on signed ints is arithmetic (floor division by 2^k)
    v = v - (v >> leak_shift) + i_syn.to(torch.int32)
    spikes = (v >= threshold_q).to(torch.int32)
    if soft_reset:
        v = v - spikes * threshold_q
    else:
        v = torch.where(spikes == 1,
                        torch.full_like(v, int(v_reset_q)), v)
    return v, spikes


def lif_rollout_int(
    v0: torch.Tensor,
    i_syn_t: torch.Tensor,    # (T, ...) int32 currents per timestep
    *,
    leak_shift: int,
    threshold_q,
    v_reset_q: int = 0,
    soft_reset: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """T integer LIF steps.  Returns (v_T, spikes_t: (T, ...))."""
    v = v0.to(torch.int32)
    out = []
    for i_syn in i_syn_t:
        v, s = lif_step_int(v, i_syn, leak_shift=leak_shift,
                            threshold_q=threshold_q, v_reset_q=v_reset_q,
                            soft_reset=soft_reset)
        out.append(s)
    if not out:
        return v, torch.zeros((0, *v.shape), dtype=torch.int32,
                              device=v.device)
    return v, torch.stack(out)


# ---------------------------------------------------------------------------
# Float twin with surrogate gradient
# ---------------------------------------------------------------------------

class SpikeFn(torch.autograd.Function):
    """Heaviside spike with the fast-sigmoid surrogate gradient
    ``d/dx [x / (1 + beta|x|)] = 1 / (1 + beta|x|)^2``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, beta: float) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.beta = beta
        return (x >= 0).to(x.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        surr = 1.0 / (1.0 + ctx.beta * torch.abs(x)) ** 2
        return g * surr, None


def spike_fn(v_minus_thresh: torch.Tensor, beta: float) -> torch.Tensor:
    return SpikeFn.apply(v_minus_thresh, beta)


def lif_step_float(
    v: torch.Tensor,
    i_syn: torch.Tensor,
    cfg: LIFConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float LIF step, forward-identical to the shift-add dynamics."""
    v = v * cfg.beta + i_syn
    s = spike_fn(v - cfg.threshold, cfg.surrogate_beta)
    if cfg.soft_reset:
        v = v - s * cfg.threshold
    else:
        v = torch.where(s > 0, torch.full_like(v, cfg.v_reset), v)
    return v, s


def lif_rollout_float(
    v0: torch.Tensor, i_syn_t: torch.Tensor, cfg: LIFConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    v = v0
    out = []
    for i in i_syn_t:
        v, s = lif_step_float(v, i, cfg)
        out.append(s)
    if not out:
        return v, i_syn_t.new_zeros((0, *v.shape))
    return v, torch.stack(out)
