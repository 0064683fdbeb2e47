"""Non-forward graph traversals: parameter init.

``graph_init`` gives every parameter the shape and init scale of
``repro.graph.passes.graph_init`` (He-normal conv/dense weights, unit
gains), drawn from one ``torch.Generator`` in graph order.  The numbers
differ from the JAX package's: ``jax.random``'s key schedule cannot be
reproduced in PyTorch, so parity tests carry JAX-made params across with
``repro_torch.convert.params_from_numpy`` instead.
"""

from __future__ import annotations

import torch

from repro_torch.core.snn_layers import conv_init, dense_init
from repro_torch.device import resolve_device
from repro_torch.graph.spec import (
    Conv,
    Dense,
    ModelGraph,
    Readout,
    Residual,
    set_path,
)


def graph_init(seed: int, graph: ModelGraph, device="cuda"):
    """A params tree for ``graph`` (nested dicts/lists addressed by the
    specs' dotted paths, each ResNet block's ``stride`` recorded beside
    its conv params, as ``repro`` does), drawn on the CPU from ``seed``
    in execution order and moved to ``device``, so the weights do not
    depend on the device."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params: dict = {}
    for node in graph.iter_flat():
        if isinstance(node, Conv):
            set_path(params, node.name,
                     conv_init(gen, node.c_in, node.c_out, node.k, device))
        elif isinstance(node, (Dense, Readout)):
            set_path(params, node.name,
                     dense_init(gen, node.d_in, node.d_out, device))
        elif isinstance(node, Residual):
            set_path(params, f"{node.name}.stride", node.stride)
    return params
