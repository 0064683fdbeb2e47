"""Non-forward graph traversals: parameter init and threshold calibration.

``graph_init`` gives every parameter the shape and init scale of
``repro.graph.passes.graph_init`` (He-normal conv/dense weights, unit
gains), drawn from one ``torch.Generator`` in graph order.  The numbers
differ from the JAX package's: ``jax.random``'s key schedule cannot be
reproduced in PyTorch, so parity tests carry JAX-made params across with
``repro_torch.convert.params_from_numpy`` instead.

``graph_calibrate`` is ``repro``'s threshold balancing, a float forward
under :class:`CalibratingExecutor`.
"""

from __future__ import annotations

import torch

from repro_torch.core.snn_layers import _conv2d, conv_init, dense_init
from repro_torch.device import resolve_device
from repro_torch.graph.executors import FloatExecutor, run_graph
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


# ---------------------------------------------------------------------------
# threshold balancing (Diehl-style): deep direct-encoded SNNs suffer
# activity collapse (firing rates decay ~4x per thresholded layer).  Each
# layer's per-channel current gain "g" is calibrated on one batch so the
# pre-threshold current std sits at ~threshold.  g stays a learnable
# parameter afterwards.
# ---------------------------------------------------------------------------

def _balance(i_syn_t: torch.Tensor, threshold: float, target=1.1):
    red = tuple(range(i_syn_t.ndim - 1))
    # population std (ddof 0), as jnp.std
    std = torch.std(i_syn_t, dim=red, correction=0) + 1e-6
    return torch.clamp(target * threshold / std, 0.05, 100.0)


class CalibratingExecutor(FloatExecutor):
    """Float traversal with a pre-layer gain hook: before each conv or
    dense layer fires, its pre-gain synaptic current on the calibration
    batch sets the per-channel gain ``g`` (written back into the params),
    then the layer runs with it, so downstream layers calibrate against
    realistic activity.

    Calibration runs the pure float twin (no fake-quant: the gains feed
    both QAT training and the integer deployment fold), skips the dense
    layer's rollout (nothing downstream of it spikes) and the readout.
    """

    kind = "calibrate"

    def __init__(self, graph: ModelGraph, params):
        super().__init__(graph, params)
        self.pc = None   # calibrate on the un-quantized forward

    def _conv(self, spec, x):
        p = self.param(spec)
        w = p["w"]
        t_steps, b = x.shape[:2]
        i_syn = _conv2d(x.reshape(t_steps * b, *x.shape[2:]).to(w.dtype),
                        w, stride=spec.stride)
        i_syn = i_syn.reshape(t_steps, b, *i_syn.shape[1:])
        set_path(self.params, spec.name,
                 dict(p, g=_balance(i_syn, self.lif.threshold)))
        return super()._conv(spec, x)

    def _dense(self, spec, x):
        p = self.param(spec)
        i_syn = torch.einsum("tbi,io->tbo", x.to(p["w"].dtype), p["w"])
        set_path(self.params, spec.name,
                 dict(p, g=_balance(i_syn, self.lif.threshold)))
        return x   # nothing downstream of fc1 consumes spikes

    def readout(self, spec, x):
        self.trace.append(("readout", spec.name, 1))
        return x   # the head is not calibrated; skip its compute


def _structural_copy(tree):
    """Copy the dict/list spine of a params tree (leaves shared), so
    calibration never mutates the caller's tree."""
    if isinstance(tree, dict):
        return {k: _structural_copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_structural_copy(v) for v in tree]
    return tree


@torch.no_grad()
def graph_calibrate(params, graph: ModelGraph, images: torch.Tensor):
    """Params with balanced per-layer gains, from one forward pass of the
    calibration batch (``images`` on the params' device).  Runs without
    autograd: the new gains are plain tensors, the other leaves the
    caller's own.  The input tree is not mutated."""
    ex = CalibratingExecutor(graph, _structural_copy(params))
    run_graph(graph, ex, images)
    return ex.params
