# snn_layers imports the quant and kernel packages, so only the leaf
# modules are imported here; import snn_layers directly.
from repro_torch.core import lif, packing  # noqa: F401

__all__ = ["lif", "packing"]
