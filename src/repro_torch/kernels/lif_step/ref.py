"""Plain PyTorch version of the fused integer LIF step (shift-add dynamics).

Port of ``repro.kernels.lif_step.ref``.  Returns (v', spikes int32 {0,1}),
bit-exact integer semantics:

    v' = v - (v >> k) + i_syn        (arithmetic shift = RTL barrel shift)
    s  = v' >= theta
    v' = v' - s * theta              (soft reset)  |  v_reset (hard)

int32 adds wrap, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch


def lif_step_ref(
    v: torch.Tensor,        # (..., n) int32 membrane
    i_syn: torch.Tensor,    # (..., n) int32 synaptic current
    *,
    leak_shift: int,
    threshold_q: int,
    v_reset_q: int = 0,
    soft_reset: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    v = v.to(torch.int32)
    # torch's >> on signed ints is arithmetic (floor division by 2^k)
    v = v - (v >> leak_shift) + i_syn.to(torch.int32)
    s = (v >= threshold_q).to(torch.int32)
    if soft_reset:
        v = v - s * threshold_q
    else:
        v = torch.where(s == 1, torch.full_like(v, int(v_reset_q)), v)
    return v, s
