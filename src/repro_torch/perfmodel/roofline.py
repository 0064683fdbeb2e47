"""Roofline constants of the NVIDIA H100 SXM and the term tie-break.

Every time prediction of the port divides by these numbers: the
per-node predictions of ``obs.attribution`` and the kernel bounds that
``chip_smoke.py`` records.  They are the data sheet's dense rates (no
sparsity) at the card's full 700 W power limit; a card set below it runs
slower under load, so a measurement is read beside the card's
``nvidia-smi`` power limit.

``repro``'s cell-level roofline (``exact_flops``, ``depth_differential``,
``roofline_cell``) compiles each cell through its TPU-mesh tooling
(``launch/dryrun.py``, ``launch/specs.py``); those functions wait for
that tooling's port.
"""

from __future__ import annotations

import dataclasses

#: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
#: dense bf16/fp16 tensor-core peak, FLOP/s
PEAK_FLOPS = 989e12
#: dense int8 tensor-core peak, OP/s (the packed SNN kernels' mma.sync s8)
PEAK_INT8_OPS = 1979e12
#: float32 outside the tensor cores, FLOP/s (the float stem, TF32 off)
PEAK_FP32_FLOPS = 67e12
#: NVLink 4, per direction per GPU (900 GB/s both ways), bytes/s
LINK_BW = 450e9

# Tie-break priority for the dominant roofline term.  ``max()`` returns
# the FIRST maximal element, so equal times resolve compute > memory >
# collective, deterministically.
_BOTTLENECK_PRIORITY = ("compute", "memory", "collective")


def pick_bottleneck(t_comp: float, t_mem: float, t_coll: float) -> str:
    """Name of the dominant term, ties broken by _BOTTLENECK_PRIORITY."""
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    return max(_BOTTLENECK_PRIORITY, key=lambda k: terms[k])


def override_depth(cfg, n_layers: int):
    """Clone an LM config at a reduced depth (layer-pattern safe)."""
    kw = {"n_layers": n_layers}
    if cfg.global_attn_layers:
        kw["global_attn_layers"] = tuple(
            i for i in cfg.global_attn_layers if i < n_layers
        ) or (0,)
    if cfg.encdec is not None:
        kw["encdec"] = dataclasses.replace(cfg.encdec, n_layers=n_layers)
    return dataclasses.replace(cfg, **kw)
