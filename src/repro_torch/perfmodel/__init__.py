"""Performance models of the port: the H100 roofline, a FLOP counter and
the paper's analytic FPGA model.

Port of ``repro.perfmodel``:

``roofline``    the H100 SXM data-sheet peaks and bandwidths every time
                prediction divides by (``obs.attribution``,
                ``chip_smoke.py``), the bottleneck tie-break and
                ``override_depth``;
``flops``       FLOPs of any PyTorch callable, counted op by op under a
                ``TorchDispatchMode`` (``meta`` tensors make a count
                free);
``fpga_model``  the L-SPINE Tables I/II resource / latency / energy
                model, pure Python.

``roofline`` also holds each dry-run cell's roofline (``exact_flops``,
``depth_differential``, ``roofline_cell``), whose memory and collective
terms come from ``launch/dryrun.py``'s walk on a fake 256/512-rank mesh.
"""

from repro_torch.perfmodel.roofline import (  # noqa: F401
    HBM_BW,
    LINK_BW,
    PEAK_FLOPS,
    PEAK_FP32_FLOPS,
    PEAK_INT8_OPS,
    depth_differential,
    exact_flops,
    override_depth,
    pick_bottleneck,
    roofline_cell,
)
