"""Plain PyTorch version of the multi-layer fused-group rollout.

Port of ``repro.kernels.fused_group.ref``.  A fusion group is a chain of
stride-1 SAME spiking convs with optional interleaved max pools; its
plain version is the per-layer composition the fused kernel replaces,
each member through the single-layer plain version, planes re-packed to
1-bit words between members:

    for each member:
      conv:  (v, packed) = fused_conv_rollout_torch(packed, qct, stride=1)
      pool:  packed -> unpack -> per-timestep window max -> pack

The CUDA kernel (csrc/fused_group.cu) must reproduce this bit for bit.
Returns the LAST conv member's final membrane and the chain's packed
output spikes.

Member encoding (shared with ops.py):

    ("conv", qct: QuantizedConvTensor, theta_q: (c_out,) int32)
    ("pool", window: int)
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.core import packing
from repro_torch.kernels.fused_conv.ref import fused_conv_rollout_torch


def maxpool_packed(packed_t: torch.Tensor, c: int,
                   window: int) -> torch.Tensor:
    """Per-timestep VALID window max pool of a packed (T, B, H, W, words)
    spike train (an OR over the window for {0, 1} spikes)."""
    s = packing.unpack_bool(packed_t, c)
    t, b, h, w, _ = s.shape
    ho, wo = h // window, w // window
    s = s[:, :, :ho * window, :wo * window]
    s = s.reshape(t, b, ho, window, wo, window, c)
    return packing.pack_bool(torch.amax(s, dim=(3, 5)))


def fused_group_rollout_torch(
    spikes_packed_t: torch.Tensor,  # (T, B, H, W, ceil(c_in/32)) int32
    members: Sequence[Tuple],
    *,
    leak_shift: int,
    v_reset_q: int = 0,
    soft_reset: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-layer composition of the group chain.

    Returns (v_last: (B, Ho, Wo, c_out) int32, the LAST conv member's
    final membrane, pre-pool if a pool follows it, and
    out_spikes_packed: (T, B, HoF, WoF, ceil(c_outF/32)) int32, the
    chain's final packed planes).
    """
    x = spikes_packed_t
    v_last = None
    ch = None
    for m in members:
        if m[0] == "conv":
            _, qct, theta = m
            v_last, x = fused_conv_rollout_torch(
                x, qct, stride=1, padding="SAME", leak_shift=leak_shift,
                threshold_q=theta, v_reset_q=v_reset_q,
                soft_reset=soft_reset)
            ch = qct.c_out
        elif m[0] == "pool":
            x = maxpool_packed(x, ch, m[1])
        else:
            raise ValueError(f"unknown group member kind {m[0]!r}")
    if v_last is None:
        raise ValueError("a fusion group needs at least one conv member")
    return v_last, x
