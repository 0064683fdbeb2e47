"""Pluggable executors: lower one :class:`ModelGraph` to a forward pass.

Port of ``repro.graph.executors``:

``FloatExecutor``     float/BPTT twin: fake-quant (QAT) conv/dense when
                      the precision quantizes, average pools, the
                      rate-preserving residual merge ``(h + sc) / 2``.
                      The training path; it lowers layer by layer, so
                      fusion groups leave it unchanged.
``IntExecutor``       per-call integer path: the float stem, then every
                      post-stem layer through the fused kernels,
                      quantizing the float params on each call; binary
                      max pools, spike-OR residual merge, and each fusion
                      group in one ``fused_group`` launch.
``PackagedExecutor``  the same lowering fed from a ``DeployedModel``:
                      pre-packed weights and folded thresholds.

``CalibratingExecutor`` (graph/passes.py) is a fourth traversal: the
float forward with a per-layer gain hook.  ``WrappedExecutor`` is the
delegating base of the observability wrappers (``obs.telemetry``,
``obs.attribution``), which run over any of the three.

Every executor records a ``trace`` of ``(kind, name, stride)`` rows in
execution order, the same rows ``repro``'s executors record, grouped or
not: fusion changes where planes live, not which layers exist.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.snn_layers import (
    avgpool_t,
    maxpool_t,
    readout_apply,
    spiking_conv_apply,
    spiking_conv_group_int_apply,
    spiking_conv_int_apply,
    spiking_dense_apply,
    spiking_dense_int_apply,
)
from repro_torch.graph import fusion as _fusion
from repro_torch.graph.spec import (
    Conv,
    Dense,
    Encode,
    ModelGraph,
    Pool,
    Readout,
    Residual,
    get_path,
)


def mean_f32(x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """The float32 mean of ``x`` (over ``dim``, or all of it) as
    ``repro``'s jitted ``jnp.mean`` computes it: XLA folds ``sum / n``
    into ``sum * (1 / n)``, the reciprocal rounded to float32, so a
    telemetry rate equals ``repro``'s to the bit.  ``torch.mean``
    divides, as ``jnp.mean`` run op by op does (``_record_rate`` below,
    held against ``repro`` under ``disable_jit``); the two sit one ulp
    apart now and then."""
    x = x.to(torch.float32)
    n = x.numel() if dim is None else x.shape[dim]
    total = torch.sum(x) if dim is None else torch.sum(x, dim=dim)
    return total * float(np.float32(1.0) / np.float32(n))


def _record_rate(rates, x) -> None:
    if rates is not None:
        rates.append(float(torch.mean(x.to(torch.float32))))


class Executor:
    """Node-kind contract shared by every lowering: the public methods own
    the trace and the residual-block wiring, subclasses implement
    ``_conv``/``_pool``/``_merge``/``_dense``."""

    kind = "base"

    #: whether this lowering runs :class:`FusionGroup` annotations as one
    #: launch; the float lowerings run every group member by member
    supports_groups = False

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

    def residual(self, spec: Residual, x: torch.Tensor) -> torch.Tensor:
        self.trace.append(("residual", spec.name, spec.stride))
        group = _fusion.body_group(self.graph, spec) \
            if (self.graph.groups and self.supports_groups) else None
        if group is not None:
            # the body chain in one fused launch; the shortcut still reads
            # the pre-body plane, so only the body joins the group
            h = self.fused_group(group, spec.body, x)
        else:
            h = x
            for body_conv in spec.body:
                h = self.conv(body_conv, h)
        sc = self.conv(spec.proj, x) if spec.proj is not None else x
        return self._merge(h, sc)

    def fused_group(self, group, specs, x: torch.Tensor) -> torch.Tensor:
        """Lower a fusion group's whole member chain in one kernel launch.
        Only lowerings that ``supports_groups`` implement it; ``run_graph``
        and ``residual`` route nothing here otherwise."""
        raise NotImplementedError(
            f"{type(self).__name__} does not lower fusion groups")

    def dense(self, spec: Dense, x: torch.Tensor) -> torch.Tensor:
        self.trace.append(("dense", spec.name, 1))
        return self._dense(spec, x)

    def readout(self, spec: Readout, x: torch.Tensor) -> torch.Tensor:
        self.trace.append(("readout", spec.name, 1))
        if spec.spatial_mean:               # (T, B, H, W, C) -> (T, B, C)
            if not x.is_floating_point():   # an int32 spike plane
                x = x.to(torch.float32)
            x = torch.mean(x, dim=(2, 3))
        return readout_apply(self.param(spec), x)

    def _conv(self, spec: Conv, x):
        raise NotImplementedError

    def _pool(self, spec: Pool, x):
        raise NotImplementedError

    def _merge(self, h, sc):
        raise NotImplementedError

    def _dense(self, spec: Dense, x):
        raise NotImplementedError


class FloatExecutor(Executor):
    """Float/BPTT lowering: the surrogate-gradient training path.  With a
    quantized precision the conv and dense weights go through QAT
    fake-quant (the forward the paper trains with)."""

    kind = "float"

    def __init__(self, graph: ModelGraph, params):
        super().__init__(graph, params)
        pc = graph.cfg.precision
        self.pc = pc if pc.quantized else None

    def _conv(self, spec, x):
        return spiking_conv_apply(self.param(spec), x, self.lif, self.pc,
                                  stride=spec.stride)

    def _pool(self, spec, x):
        return avgpool_t(x, spec.window)

    def _merge(self, h, sc):
        return (h + sc) * 0.5   # spike-rate-preserving residual merge

    def _dense(self, spec, x):
        return spiking_dense_apply(self.param(spec), x, self.lif, self.pc)


class IntExecutor(FloatExecutor):
    """Per-call integer lowering: the stem stays float (its input is
    analog) and casts its spikes to int32; every other conv and the dense
    layer run the fused kernels; pools are binary max (OR) pools and the
    residual merge a spike OR, so inter-layer planes stay 1-bit."""

    kind = "int"
    supports_groups = True

    def fused_group(self, group, specs, x: torch.Tensor) -> torch.Tensor:
        """One ``fused_group`` launch for the whole member chain.  Trace
        rows are the per-member rows the ungrouped lowering records."""
        members = []
        for spec in specs:
            if isinstance(spec, Conv):
                self.trace.append(("conv", spec.name, spec.stride))
                members.append(("conv", self._operands(spec, "qct")))
            else:
                self.trace.append(("pool", spec.name, 1))
                members.append(("pool", spec.window))
        return spiking_conv_group_int_apply(members, x, self.lif,
                                            self.cfg.precision)

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

    def _merge(self, h, sc):
        return torch.maximum(h, sc)     # spike OR: binary-preserving

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


class WrappedExecutor:
    """Delegating base for instrumenting wrappers (obs telemetry, obs
    time attribution): forwards every node method plus ``trace`` and
    ``supports_groups`` to ``inner``, so :func:`run_graph` sees a normal
    executor and fuses the same groups it would fuse unwrapped.
    Subclasses override exactly the node methods they observe; the trace
    stays on the inner executor, so executor-parity checks hold through
    any wrapper stack."""

    kind = "wrapped"

    def __init__(self, inner):
        self.inner = inner

    @property
    def trace(self):
        return self.inner.trace

    @property
    def supports_groups(self):
        return getattr(self.inner, "supports_groups", False)

    def encode(self, spec, images):
        return self.inner.encode(spec, images)

    def conv(self, spec, x):
        return self.inner.conv(spec, x)

    def pool(self, spec, x):
        return self.inner.pool(spec, x)

    def residual(self, spec, x):
        return self.inner.residual(spec, x)

    def fused_group(self, group, specs, x):
        return self.inner.fused_group(group, specs, x)

    def dense(self, spec, x):
        return self.inner.dense(spec, x)

    def readout(self, spec, x):
        return self.inner.readout(spec, x)


def run_graph(graph: ModelGraph, executor: Executor, images: torch.Tensor,
              rates: Optional[list] = None) -> torch.Tensor:
    """Drive one forward pass: (B, H, W, C) images -> (B, n_classes)
    logits.  ``rates`` (a list) collects each spiking layer's mean firing
    rate after every top-level Conv, Residual merge and Dense, as
    ``repro``'s run_graph does.

    Fusion groups: when the executor ``supports_groups``, each top-level
    group's member chain lowers through ``executor.fused_group`` in one
    launch (residual-body groups inside ``Executor.residual``).
    ``rates`` needs every member's output plane, so rate-instrumented
    runs lower top-level groups member by member, bit-exact with the
    fused chain.
    """
    fused_at = {}
    if graph.groups and executor.supports_groups and rates is None:
        top_index = {node.name: i for i, node in enumerate(graph.nodes)}
        for g in graph.groups:
            if g.members[0] in top_index:       # not a residual body
                fused_at[top_index[g.members[0]]] = g

    x = images
    i = 0
    while i < len(graph.nodes):
        node = graph.nodes[i]
        group = fused_at.get(i)
        if group is not None:
            specs = graph.nodes[i:i + len(group.members)]
            x = executor.fused_group(group, specs, x)
            i += len(group.members)
            continue
        if isinstance(node, Encode):
            x = executor.encode(node, x)
        elif isinstance(node, Conv):
            x = executor.conv(node, x)
            _record_rate(rates, x)
        elif isinstance(node, Pool):
            x = executor.pool(node, x)
        elif isinstance(node, Residual):
            x = executor.residual(node, x)
            _record_rate(rates, x)
        elif isinstance(node, Dense):
            x = x.reshape(x.shape[0], x.shape[1], -1)   # (T, B, feat)
            x = executor.dense(node, x)
            _record_rate(rates, x)
        elif isinstance(node, Readout):
            return executor.readout(node, x)
        else:  # pragma: no cover: new spec kinds must be wired here
            raise TypeError(f"no lowering for node {type(node).__name__}")
        i += 1
    raise ValueError("graph has no Readout node")


def executor_for(graph: ModelGraph, params, package=None) -> Executor:
    """Packaged when a deploy package is supplied, per-call integer when
    ``cfg.int_path``, float/BPTT otherwise."""
    if package is not None:
        if not graph.cfg.int_path:
            raise ValueError("a deploy package drives the integer path "
                             "only (cfg needs int_deploy + quantized)")
        return PackagedExecutor(graph, params, package)
    if graph.cfg.int_path:
        return IntExecutor(graph, params)
    return FloatExecutor(graph, params)
