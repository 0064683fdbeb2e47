"""Pluggable executors: lower one :class:`ModelGraph` to a forward pass.

Port of ``repro.graph.executors`` for the integer serving path:

``FloatExecutor``     the float twin; in this port only its conv is used,
                      as the direct-encoded stem of the integer path (the
                      float/BPTT pools and dense layers are not ported).
``IntExecutor``       per-call integer path: every post-stem layer runs
                      the fused kernels, quantizing the float params on
                      each call; binary max pools.
``PackagedExecutor``  the same lowering fed from a ``DeployedModel``:
                      pre-packed weights and folded thresholds.

Every executor records a ``trace`` of ``(kind, name, stride)`` rows in
execution order, the same rows ``repro``'s executors record.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.core.snn_layers import (
    maxpool_t,
    readout_apply,
    spiking_conv_apply,
    spiking_conv_int_apply,
    spiking_dense_int_apply,
)
from repro_torch.graph.spec import (
    Conv,
    Dense,
    Encode,
    ModelGraph,
    Pool,
    Readout,
    get_path,
)


def _record_rate(rates, x) -> None:
    if rates is not None:
        rates.append(float(torch.mean(x.to(torch.float32))))


class Executor:
    """Node-kind contract shared by every lowering: the public methods own
    the trace, subclasses implement ``_conv``/``_pool``/``_dense``."""

    kind = "base"

    def __init__(self, graph: ModelGraph, params):
        self.graph = graph
        self.cfg = graph.cfg
        self.lif = graph.cfg.lif
        self.params = params
        self.trace: List[Tuple] = []

    def param(self, spec):
        """The spec's float params, resolved by its dotted path."""
        return get_path(self.params, spec.name)

    def encode(self, spec: Encode, images: torch.Tensor) -> torch.Tensor:
        self.trace.append(("encode", spec.name, 1))
        return images.expand(spec.timesteps, *images.shape)

    def conv(self, spec: Conv, x: torch.Tensor) -> torch.Tensor:
        self.trace.append(("conv", spec.name, spec.stride))
        return self._conv(spec, x)

    def pool(self, spec: Pool, x: torch.Tensor) -> torch.Tensor:
        self.trace.append(("pool", spec.name, 1))
        return self._pool(spec, x)

    def dense(self, spec: Dense, x: torch.Tensor) -> torch.Tensor:
        self.trace.append(("dense", spec.name, 1))
        return self._dense(spec, x)

    def readout(self, spec: Readout, x: torch.Tensor) -> torch.Tensor:
        self.trace.append(("readout", spec.name, 1))
        if spec.spatial_mean:
            x = torch.mean(x, dim=(2, 3))   # (T, B, H, W, C) -> (T, B, C)
        return readout_apply(self.param(spec), x)

    def _conv(self, spec: Conv, x):
        raise NotImplementedError

    def _pool(self, spec: Pool, x):
        raise NotImplementedError

    def _dense(self, spec: Dense, x):
        raise NotImplementedError


class FloatExecutor(Executor):
    """Float lowering.  Only the conv is ported: the integer path's stem
    runs it (fake-quant included when the precision is quantized)."""

    kind = "float"

    def __init__(self, graph: ModelGraph, params):
        super().__init__(graph, params)
        pc = graph.cfg.precision
        self.pc = pc if pc.quantized else None

    def _conv(self, spec, x):
        return spiking_conv_apply(self.param(spec), x, self.lif, self.pc,
                                  stride=spec.stride)


class IntExecutor(FloatExecutor):
    """Per-call integer lowering: the stem stays float (its input is
    analog) and casts its spikes to int32; every other conv and the dense
    layer run the fused kernels; pools are binary max (OR) pools."""

    kind = "int"

    def _operands(self, spec, key: str) -> dict:
        """Where a packed layer's weights come from: the one hook the
        packaged lowering overrides (``key`` is ``qct`` or ``qt``)."""
        return {"params": self.param(spec)}

    def _conv(self, spec, x):
        if spec.stem:
            return super()._conv(spec, x).to(torch.int32)
        kw = self._operands(spec, "qct")
        return spiking_conv_int_apply(kw.pop("params"), x, self.lif,
                                      self.cfg.precision,
                                      stride=spec.stride, **kw)

    def _pool(self, spec, x):
        return maxpool_t(x, spec.window)

    def _dense(self, spec, x):
        kw = self._operands(spec, "qt")
        return spiking_dense_int_apply(kw.pop("params"), x, self.lif,
                                       self.cfg.precision, **kw)


class PackagedExecutor(IntExecutor):
    """Integer lowering fed from a deploy package: every packed layer's
    weights and folded thresholds come from the ``DeployedModel``;
    ``params`` only needs the float stem and head."""

    kind = "packaged"

    def __init__(self, graph: ModelGraph, params, package):
        super().__init__(graph, params)
        self.package = package
        want = {s.name for s in graph.packable_specs()}
        have = set(package.layers)
        if want != have:
            raise ValueError(
                f"deploy package layers desync the model graph: "
                f"missing={sorted(want - have)} extra={sorted(have - want)}")

    def _operands(self, spec, key: str) -> dict:
        lp = self.package.layers[spec.name]
        return {"params": None, key: lp.qt, "threshold_q": lp.theta_q}


def run_graph(graph: ModelGraph, executor: Executor, images: torch.Tensor,
              rates: Optional[list] = None) -> torch.Tensor:
    """Drive one forward pass: (B, H, W, C) images -> (B, n_classes)
    logits.  ``rates`` (a list) collects each spiking layer's mean firing
    rate after every Conv and Dense, as ``repro``'s run_graph does."""
    x = images
    for node in graph.nodes:
        if isinstance(node, Encode):
            x = executor.encode(node, x)
        elif isinstance(node, Conv):
            x = executor.conv(node, x)
            _record_rate(rates, x)
        elif isinstance(node, Pool):
            x = executor.pool(node, x)
        elif isinstance(node, Dense):
            x = x.reshape(x.shape[0], x.shape[1], -1)   # (T, B, feat)
            x = executor.dense(node, x)
            _record_rate(rates, x)
        elif isinstance(node, Readout):
            return executor.readout(node, x)
        else:  # pragma: no cover: new spec kinds must be wired here
            raise TypeError(f"no lowering for node {type(node).__name__}")
    raise ValueError("graph has no Readout node")


def executor_for(graph: ModelGraph, params, package=None) -> Executor:
    """Packaged when a deploy package is supplied, per-call integer when
    ``cfg.int_path``; the float/BPTT forward is not ported yet."""
    if package is not None:
        if not graph.cfg.int_path:
            raise ValueError("a deploy package drives the integer path "
                             "only (cfg needs int_deploy + quantized)")
        return PackagedExecutor(graph, params, package)
    if graph.cfg.int_path:
        return IntExecutor(graph, params)
    raise NotImplementedError("the float/BPTT forward is not yet ported to "
                              "repro_torch; use an int_deploy config")
