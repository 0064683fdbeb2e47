"""Neuron Compute Engine: the deployment-path integer pipeline.

Port of ``repro.core.nce``, the software twin of L-SPINE's NCE: per
timestep,

    packed spikes --unpack--> binary operands
    packed weights --unpack--> INTb operands     (b = 2/4/8, PC signal)
    AC unit:   i_syn = spikes @ W_q              (multiplier-less: binary x int)
    LIF:       v -= v>>k; v += i_syn; s = v>=theta; reset

All arithmetic is int32.  A single step runs the ``spike_matmul`` kernel
and the ``lif_step`` kernel's packed entry, which writes the output
spikes already packed (kernels/csrc/spike_matmul.cu, lif_step.cu on a
CUDA tensor, their plain versions on a CPU tensor): two device kernels a
step.  The T-step ``rollout`` runs the ``fused_nce`` kernel, one launch
for the whole rollout.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core import packing
from repro_torch.kernels.fused_nce import ops as fused_nce_ops
from repro_torch.kernels.lif_step import ops as lif_step_ops
from repro_torch.kernels.spike_matmul import ops as spike_matmul_ops
from repro_torch.quant.formats import PrecisionConfig, QuantizedTensor
from repro_torch.quant.ptq import quantize


@dataclasses.dataclass(frozen=True)
class NCEConfig:
    precision: PrecisionConfig = PrecisionConfig(bits=8)
    leak_shift: int = 3
    threshold_q: int = 64         # integer-domain threshold
    soft_reset: bool = True

    @property
    def simd_lanes(self) -> int:
        return self.precision.simd_lanes


class NeuronComputeEngine:
    """Stateless compute engine; state (v, packed spikes) is carried by the
    caller.

    Weights are held packed (QuantizedTensor, logical (out, in)).  ``step``
    consumes one timestep of bit-packed input spikes and returns the
    updated membrane and bit-packed output spikes, the dataflow of one NCE
    column pass.
    """

    def __init__(self, cfg: NCEConfig, weights: QuantizedTensor):
        if weights.bits != cfg.precision.bits:
            raise ValueError("weight bits != engine precision")
        self.cfg = cfg
        self.weights = weights

    @classmethod
    def from_float(cls, cfg: NCEConfig, w: torch.Tensor
                   ) -> "NeuronComputeEngine":
        """w: (in, out) float weights -> packed (out, in) int."""
        return cls(cfg, quantize(w.T, cfg.precision))

    @property
    def d_in(self) -> int:
        return self.weights.shape[1]

    @property
    def d_out(self) -> int:
        return self.weights.shape[0]

    def accumulate(self, spikes_packed: torch.Tensor) -> torch.Tensor:
        """AC unit: packed spikes (B, ceil(d_in/32)) -> int32 currents
        (B, d_out).  Dequant-free: the scale is folded into the integer
        threshold (theta_q = theta / scale)."""
        return spike_matmul_ops.spike_matmul(spikes_packed, self.weights,
                                             d_in=self.d_in)

    def step(self, v: torch.Tensor, spikes_packed: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One NCE timestep.  Returns (v', out_spikes_packed
        (B, ceil(d_out/32)))."""
        i_syn = self.accumulate(spikes_packed)
        return lif_step_ops.lif_step_packed(
            v, i_syn, leak_shift=self.cfg.leak_shift,
            threshold_q=self.cfg.threshold_q, soft_reset=self.cfg.soft_reset)

    def rollout(self, spikes_packed_t: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """All T timesteps of packed input spikes (T, B, words_in) in one
        ``fused_nce`` launch (unpack, accumulate, LIF and spike re-pack, the
        membrane kept on chip).  Bit-exact with looping :meth:`step`."""
        return fused_nce_ops.fused_nce_rollout(
            spikes_packed_t, self.weights, d_in=self.d_in,
            leak_shift=self.cfg.leak_shift, threshold_q=self.cfg.threshold_q,
            soft_reset=self.cfg.soft_reset)

    def rollout_unfused(self, spikes_packed_t: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pre-fusion rollout: :meth:`step` (accumulate -> lif_step with
        the spikes packed) for each timestep, the fusion baseline."""
        t_steps, b = spikes_packed_t.shape[:2]
        dev = spikes_packed_t.device
        v = torch.zeros((b, self.d_out), dtype=torch.int32, device=dev)
        outs = []
        for t in range(t_steps):
            v, out = self.step(v, spikes_packed_t[t])
            outs.append(out)
        if not outs:
            return v, torch.zeros(
                (0, b, packing.packed_last_dim(self.d_out, 1)),
                dtype=torch.int32, device=dev)
        return v, torch.stack(outs)


def throughput_model(cfg: NCEConfig, n_macs: int) -> dict:
    """Cycle/energy model of one NCE (the paper's FPGA, Table I).

    The FPGA executes ``simd_lanes`` low-bit MACs per cycle per NCE;
    energy per MAC scales ~ bits.  Constants are the paper's INT8 row
    (0.39 ns, 4.2 mW); they describe the FPGA, not any GPU.
    """
    lanes = cfg.simd_lanes
    cycles = (n_macs + lanes - 1) // lanes
    t_cycle_ns = 0.39
    p_mw = 4.2 * (cfg.precision.bits / 8.0) ** 0.5
    return {
        "bits": cfg.precision.bits,
        "simd_lanes": lanes,
        "cycles": cycles,
        "latency_ns": cycles * t_cycle_ns,
        "power_mw": p_mw,
        "energy_nj": cycles * t_cycle_ns * p_mw * 1e-3,
    }
