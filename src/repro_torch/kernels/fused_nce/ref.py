"""Plain PyTorch version of the fused NCE rollout.

Port of ``repro.kernels.fused_nce.ref`` with ``spike_matmul_ref``
inlined.  Per timestep:

    i_syn[t] = unpack_bool(spikes[t]) @ unpack(Wq).T      (AC unit)
    v, s[t]  = lif_step_int(v, i_syn[t])                  (LIF update)
    out[t]   = pack_bool(s[t])                            (spike re-pack)

The CUDA kernel (csrc/fused_nce.cu) must reproduce this bit for bit.
The product runs in float64 on integer operands ({0, 1} spikes, codes in
[-128, 127], sums bounded by ``d_in*128``), so it is exact in any
summation order and untouched by TF32; it is cast back to int32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import packing
from repro_torch.core.lif import as_theta_vector, lif_step_int
from repro_torch.quant.formats import QuantizedTensor


def fused_nce_rollout_torch(
    spikes_packed_t: torch.Tensor,  # (T, B, ceil(d_in/32)) int32
    qt: QuantizedTensor,            # packed (d_out, d_in) integer codes
    *,
    d_in: int,
    leak_shift: int,
    threshold_q,
    v_reset_q: int = 0,
    soft_reset: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """T-step integer NCE rollout.

    Returns (v_T: (B, d_out) int32,
             out_spikes_packed: (T, B, ceil(d_out/32)) int32).
    """
    t_steps, b, _ = spikes_packed_t.shape
    dev = spikes_packed_t.device
    d_out = qt.shape[0]
    theta = as_theta_vector(threshold_q, d_out, device=dev)
    v = torch.zeros((b, d_out), dtype=torch.int32, device=dev)
    if t_steps == 0:
        return v, torch.zeros((0, b, packing.packed_last_dim(d_out, 1)),
                              dtype=torch.int32, device=dev)
    wq = packing.unpack(qt.data, qt.bits, d_in).to(torch.float64)
    s = packing.unpack_bool(spikes_packed_t, d_in).to(torch.float64)
    i_syn = torch.matmul(s, wq.T).to(torch.int32)        # (T, B, d_out)
    out = []
    for t in range(t_steps):
        v, o = lif_step_int(v, i_syn[t], leak_shift=leak_shift,
                            threshold_q=theta, v_reset_q=v_reset_q,
                            soft_reset=soft_reset)
        out.append(packing.pack_bool(o))
    return v, torch.stack(out)
