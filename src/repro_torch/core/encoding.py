"""Spike encoders: the front of the L-SPINE pipeline (Fig. 1 'Encoder').

Port of ``repro.core.encoding``.  Input activations become binary spike
trains over T timesteps, stored bit-packed (the spike buffer):

* rate (Bernoulli): P(spike at t) = clamp(x, 0, 1); draws come from a
  ``torch.Generator``, so they match JAX's only in distribution;
* direct: the analog value is injected as constant current every step;
* latency (time-to-first-spike): one spike at t = round((1-x)(T-1)).
"""

from __future__ import annotations

import torch

from repro_torch.core import packing


def rate_encode(generator: torch.Generator, x: torch.Tensor,
                timesteps: int) -> torch.Tensor:
    """Bernoulli rate coding.  x in [0,1].  Returns (T, *x.shape) {0,1}
    int8.  ``generator`` must live on ``x``'s device."""
    p = torch.clamp(x.to(torch.float32), 0.0, 1.0)
    u = torch.rand((timesteps, *x.shape), generator=generator,
                   dtype=torch.float32, device=x.device)
    return (u < p).to(torch.int8)


def direct_encode(x: torch.Tensor, timesteps: int) -> torch.Tensor:
    """Constant-current injection: replicate x across T (float currents)."""
    return x.expand(timesteps, *x.shape)


def latency_encode(x: torch.Tensor, timesteps: int) -> torch.Tensor:
    """Time-to-first-spike: brighter = earlier.  Returns (T, ...) {0,1}
    int8."""
    x = torch.clamp(x.to(torch.float32), 0.0, 1.0)
    t_fire = torch.round((1.0 - x) * (timesteps - 1)).to(torch.int32)
    t_idx = torch.arange(timesteps, dtype=torch.int32,
                         device=x.device).reshape((timesteps,) +
                                                  (1,) * x.ndim)
    return (t_idx == t_fire[None]).to(torch.int8)


def pack_spike_train(spikes: torch.Tensor) -> torch.Tensor:
    """Bit-pack a (T, ..., n) {0,1} spike train along its last axis:
    32 spikes per int32 word, the on-device spike-buffer format."""
    return packing.pack_bool(spikes)


def unpack_spike_train(words: torch.Tensor, n: int) -> torch.Tensor:
    return packing.unpack_bool(words, n).to(torch.int8)


def spike_rate(spikes: torch.Tensor) -> torch.Tensor:
    """Mean firing rate over the time axis (axis 0), a readout helper."""
    return torch.mean(spikes.to(torch.float32), dim=0)
