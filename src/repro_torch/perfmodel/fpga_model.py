"""Analytical FPGA resource / latency / energy model of L-SPINE.

Port of ``repro.perfmodel.fpga_model``: pure Python, the same functions,
tables and calibration constants.

The LUT/FF/delay/power numbers in the paper's Tables I & II are Virtex-7
synthesis results — not reproducible in software.  This model rebuilds
them from first principles (adder/shifter bit counts, SIMD lane math,
cycle accounting) with two calibration constants taken from the paper's
own INT8 row, then PREDICTS the rest of the rows/columns so the trends
can be checked against the published values (benchmarks/run.py prints
model vs paper side by side).

Model:
  * NCE datapath = adder tree over `lanes` sub-word operands + barrel
    shifter (leak) + comparator (threshold) + reset mux.
    LUT cost ~ k_lut * total adder bits;  FF cost ~ registers held.
  * SIMD lanes = 32 / bits  (16x INT2, 8x INT4, 4x INT8 per 32-bit word;
    the paper's headline counts pairs of 16-bit words as 16/4/1 MACs).
  * system latency = cycles(workload MACs / (PEs * lanes)) / f_clk.
  * dynamic power ~ activity * bits-switched; calibrated at INT8.
"""

from __future__ import annotations

import dataclasses

# --- calibration against the paper's "Proposed" rows -----------------------
PAPER_NEURON = {"luts": 459, "ffs": 408, "delay_ns": 0.39, "power_mw": 4.2}
PAPER_SYSTEM = {"luts_k": 46.37, "ffs_k": 30.4, "latency_ms": 2.38,
                "power_w": 0.54}

# Table I competitor rows (for the printed comparison)
PAPER_TABLE1 = {
    "TVLSI'26 ReLANCE": (1770, 862, 1.41, 8.9),
    "TCAS-II'24": (8054, 1718, 4.62, 22.5),
    "MP-RPE": (8065, 1072, 5.56, 21.8),
    "Iterative CORDIC H&H": (2344, 460, 5.00, 11.6),
    "PWL H&H": (29130, 25430, 39.06, 85.0),
    "Parallel CORDIC H&H": (86032, 50228, 15.78, 140.0),
    "Multiplier-less H&H": (5660, 2840, 11.77, 18.5),
    "RAM H&H": (4735, 1552, 10.00, 15.2),
    "CORDIC Izhikevich": (986, 264, 2.16, 10.7),
    "TCAS-I'19": (818, 211, 3.2, 14.9),
    "TCAS-I'22": (617, 493, 0.43, 4.7),
    "Proposed (paper)": (459, 408, 0.39, 4.2),
}

PAPER_TABLE2 = {
    "TVLSI'26": (118.6, 57.8, 5.04, 1.85),
    "TRETS'23": (115.0, 115.0, 21.46, 2.10),
    "TCAD'23 (large)": (170.4, 113.2, 7.38, 2.40),
    "Iterative CORDIC H&H": (157.0, 30.8, 20.50, 1.95),
    "Multiplier-less H&H": (359.2, 190.0, 31.54, 4.20),
    "RAM H&H": (317.3, 104.0, 35.60, 3.85),
    "TCAD'23 (small)": (18.94, 24.35, 6.0, 1.18),
    "CORDIC Izhikevich": (66.0, 17.68, 9.29, 1.05),
    "TCAS-I'22": (213.0, 352.0, 6.68, 2.95),
    "NC'20": (140.5, 81.5, 56.8, 4.6),
    "Access'22": (43.2, 36.8, 32.2, 6.95),
    "Proposed (paper)": (46.37, 30.4, 2.38, 0.54),
}


@dataclasses.dataclass(frozen=True)
class EngineGeometry:
    """Geometry chosen to be consistent with the paper's own numbers:
    64 NCEs @ 100 MHz with 0.4 effective spike rate reproduces the
    published VGG-16/ResNet-18 INT2 latencies within ~10% (see
    benchmarks/latency_energy.py)."""
    n_pe: int = 64                # 2D NCE array (8x8)
    f_clk_mhz: int = 100
    word_bits: int = 32
    acc_bits: int = 24            # accumulator width
    v_bits: int = 16              # membrane register


def neuron_resources(bits: int, geo: EngineGeometry = EngineGeometry()):
    """LUT/FF/delay/power of ONE multi-precision NCE."""
    lanes = geo.word_bits // bits
    # adder tree: lanes leaves of `bits`-wide adders folding into acc_bits;
    # total full-adder bits ~ sum over tree levels
    adder_bits = 0
    width, n = bits, lanes
    while n > 1:
        adder_bits += (n // 2) * (width + 1)
        width += 1
        n //= 2
    adder_bits += geo.acc_bits          # final accumulate
    shifter = geo.v_bits                # leak barrel shift (fixed k: wires+mux)
    compare = geo.v_bits                # threshold comparator
    mux = geo.v_bits                    # reset mux
    lut_units = adder_bits + shifter + compare + mux
    ff_units = geo.v_bits + geo.acc_bits + lanes * bits  # v, acc, operand regs

    # calibrate to the paper's INT8 NCE
    ref = _raw_neuron_units(8, geo)
    k_lut = PAPER_NEURON["luts"] / ref[0]
    k_ff = PAPER_NEURON["ffs"] / ref[1]
    # critical path ~ log2(lanes)+adder depth; power ~ switched bits
    depth = (width - bits) + 3
    ref_depth = _raw_neuron_depth(8)
    k_delay = PAPER_NEURON["delay_ns"] / ref_depth
    switched = lanes * bits + geo.acc_bits
    ref_sw = 4 * 8 + geo.acc_bits
    k_pow = PAPER_NEURON["power_mw"] / ref_sw
    return {
        "bits": bits,
        "lanes": lanes,
        "luts": int(round(lut_units * k_lut)),
        "ffs": int(round(ff_units * k_ff)),
        "delay_ns": round(depth * k_delay, 2),
        "power_mw": round(switched * k_pow, 2),
    }


def _raw_neuron_units(bits, geo):
    lanes = geo.word_bits // bits
    adder_bits = 0
    width, n = bits, lanes
    while n > 1:
        adder_bits += (n // 2) * (width + 1)
        width += 1
        n //= 2
    adder_bits += geo.acc_bits
    lut = adder_bits + 3 * geo.v_bits
    ff = geo.v_bits + geo.acc_bits + lanes * bits
    return lut, ff


def _raw_neuron_depth(bits, geo: EngineGeometry = EngineGeometry()):
    lanes = geo.word_bits // bits
    width, n = bits, lanes
    while n > 1:
        width += 1
        n //= 2
    return (width - bits) + 3


def system_resources(bits: int = 8, geo: EngineGeometry = EngineGeometry()):
    """Whole-accelerator resources: NCE array + buffers + RISC-V + FIFO."""
    n = neuron_resources(bits, geo)
    # fixed infrastructure calibrated so the INT8 system hits the paper row
    array_luts = n["luts"] * geo.n_pe
    array_ffs = n["ffs"] * geo.n_pe
    infra_luts = PAPER_SYSTEM["luts_k"] * 1e3 - neuron_resources(8, geo)[
        "luts"] * geo.n_pe
    infra_ffs = PAPER_SYSTEM["ffs_k"] * 1e3 - neuron_resources(8, geo)[
        "ffs"] * geo.n_pe
    return {
        "bits": bits,
        "luts_k": round((array_luts + infra_luts) / 1e3, 2),
        "ffs_k": round((array_ffs + infra_ffs) / 1e3, 2),
    }


# Table II's 2.38 ms row corresponds to a reference workload of ~152 MMAC
# (MNIST-scale CNN at T=4) under this geometry — derived by inversion.
TABLE2_REF_MACS = int(2.38e-3 * 100e6 * 256 / 0.4)


def system_latency_ms(macs: int, bits: int,
                      geo: EngineGeometry = EngineGeometry(),
                      spike_rate: float = 0.4) -> float:
    """Event-driven cycle model: only spiking synapses accumulate."""
    lanes = geo.word_bits // bits
    eff_macs = macs * spike_rate          # event-driven sparsity
    cycles = eff_macs / (geo.n_pe * lanes)
    return cycles / (geo.f_clk_mhz * 1e6) * 1e3


def system_power_w(bits: int, geo: EngineGeometry = EngineGeometry()):
    n = neuron_resources(bits, geo)
    ref = neuron_resources(8, geo)
    scale = n["power_mw"] / ref["power_mw"]
    return round(PAPER_SYSTEM["power_w"] * scale, 3)


def system_energy_mj(macs: int, bits: int,
                     geo: EngineGeometry = EngineGeometry()) -> float:
    t_ms = system_latency_ms(macs, bits, geo)
    return system_power_w(bits, geo) * t_ms


# --- CPU/GPU comparison (paper §III-D) --------------------------------------

# Efficiency factors CALIBRATED on the paper's published VGG-16 rows
# (spiking inference utilizes a vanishing fraction of peak on commodity
# platforms — event-driven ops neither vectorize nor batch); the
# ResNet-18 rows are then PREDICTIONS checked against the paper.
PLATFORMS = {
    # name: (peak GOPS at that precision, power W, calibrated efficiency)
    "CPU i7 (INT8)": (500, 125, 2.09e-4),
    "GPU 1050Ti (INT8)": (4000, 75, 6.17e-5),
    "GPU 1050Ti (FP32)": (2100, 75, 2.95e-5),
    "GPU 1050Ti (FP16)": (2100, 75, 2.99e-5),
}

PAPER_LATENCIES = {
    # (model, platform): seconds reported in §III-D
    ("vgg16", "CPU i7 (INT8)"): 23.97,
    ("vgg16", "GPU 1050Ti (INT8)"): 10.15,
    ("vgg16", "GPU 1050Ti (FP32)"): 40.4,
    ("vgg16", "GPU 1050Ti (FP16)"): 39.9,
    ("resnet18", "CPU i7 (INT8)"): 34.43,
    ("resnet18", "GPU 1050Ti (INT8)"): 10.26,
    ("vgg16", "L-SPINE INT2"): 4.83e-3,
    ("vgg16", "L-SPINE INT8"): 16.94e-3,
    ("resnet18", "L-SPINE INT2"): 7.84e-3,
    ("resnet18", "L-SPINE INT8"): 16.84e-3,
}


def platform_latency_s(macs: int, platform: str) -> float:
    peak_gops, _, eff = PLATFORMS[platform]
    return macs * 2 / (peak_gops * 1e9 * eff)


def platform_energy_j(macs: int, platform: str) -> float:
    _, watts, _ = PLATFORMS[platform]
    return platform_latency_s(macs, platform) * watts
