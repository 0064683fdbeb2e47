"""Typed layer-graph specs: the single source of truth for SNN topology.

The port's own copy of the parts of ``repro.graph.spec`` the vgg family
needs (importing ``repro.graph`` would pull in JAX through its package
``__init__``).  A :class:`ModelGraph` is a tuple of frozen
:class:`LayerSpec` nodes; every consumer (init, the integer forwards,
``deploy()``'s packing walk) is a traversal of the same nodes.  Each
parameter-bearing spec's ``name`` is its flat dotted param path
(``convs.1``, ``fc1``), which is also the deploy package's layer key.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Base node; ``name`` is the layer's flat dotted param path."""

    name: str


@dataclasses.dataclass(frozen=True)
class Encode(LayerSpec):
    """Direct (constant-current) coding: (B,H,W,C) -> (T,B,H,W,C)."""

    timesteps: int = 4


@dataclasses.dataclass(frozen=True)
class Conv(LayerSpec):
    """Spiking conv + LIF rollout; ``stem`` marks the float first conv."""

    c_in: int = 0
    c_out: int = 0
    k: int = 3
    stride: int = 1
    stem: bool = False
    out_hw: int = 0

    @property
    def macs(self) -> int:
        """Synaptic ops for one timestep of this conv."""
        return self.out_hw * self.out_hw * self.k * self.k \
            * self.c_in * self.c_out


@dataclasses.dataclass(frozen=True)
class Pool(LayerSpec):
    """2x2 spatial pool; the integer path lowers it to a max (OR) pool."""

    window: int = 2


@dataclasses.dataclass(frozen=True)
class Dense(LayerSpec):
    """Spiking fully-connected layer; input is flattened to (T,B,d_in)."""

    d_in: int = 0
    d_out: int = 0

    @property
    def macs(self) -> int:
        return self.d_in * self.d_out


@dataclasses.dataclass(frozen=True)
class Readout(LayerSpec):
    """Non-spiking readout: mean-over-T of accumulated currents."""

    d_in: int = 0
    d_out: int = 0
    spatial_mean: bool = False

    @property
    def macs(self) -> int:
        return self.d_in * self.d_out


@dataclasses.dataclass(frozen=True)
class ModelGraph:
    """One SNN architecture: an ordered node tuple + the cfg it was built
    for."""

    cfg: object                       # SNNConfig (duck-typed, no cycle)
    nodes: Tuple[LayerSpec, ...]

    def param_specs(self) -> Iterator[LayerSpec]:
        """Parameter-bearing specs (Conv/Dense/Readout) in init order."""
        for node in self.nodes:
            if isinstance(node, (Conv, Dense, Readout)):
                yield node

    def packable_specs(self) -> Iterator[LayerSpec]:
        """What ``deploy()`` packs: every non-stem Conv and every Dense."""
        for spec in self.param_specs():
            if isinstance(spec, Conv) and not spec.stem:
                yield spec
            elif isinstance(spec, Dense):
                yield spec

    def count_macs(self) -> int:
        """Synaptic-op count per inference: per-node MACs times T."""
        return sum(s.macs for s in self.param_specs()) * self.cfg.timesteps

    @staticmethod
    def _row(spec: LayerSpec) -> Tuple:
        if isinstance(spec, Encode):
            return ("encode", spec.timesteps)
        if isinstance(spec, Conv):
            return ("conv", spec.name, spec.c_in, spec.c_out,
                    spec.k, spec.stride, spec.out_hw, spec.stem)
        if isinstance(spec, Pool):
            return ("pool", spec.window)
        if isinstance(spec, Dense):
            return ("dense", spec.name, spec.d_in, spec.d_out)
        if isinstance(spec, Readout):
            return ("readout", spec.name, spec.d_in, spec.d_out,
                    spec.spatial_mean)
        raise TypeError(f"no topology row for {type(spec).__name__}")

    def topology(self) -> Tuple[Tuple, ...]:
        """Hashable geometry fingerprint, one row per node (the same rows
        as ``repro``'s ``ModelGraph.topology`` for an unfused graph)."""
        return tuple(self._row(spec) for spec in self.nodes)


# ---------------------------------------------------------------------------
# dotted-path access into dict/list params trees
# ---------------------------------------------------------------------------

def get_path(tree, path: str):
    """Resolve a flat dotted path (``convs.2``) in a nested dict/list."""
    node = tree
    for part in path.split("."):
        node = node[int(part)] if part.isdigit() else node[part]
    return node


def set_path(tree: dict, path: str, value) -> None:
    """Insert ``value`` at a dotted path, materializing dicts for string
    components and lists for numeric ones (list indices arrive in append
    order, as every ordered traversal produces them)."""
    parts = path.split(".")
    node = tree
    for part, nxt in zip(parts[:-1], parts[1:]):
        container = [] if nxt.isdigit() else {}
        if part.isdigit():
            i = int(part)
            if i == len(node):
                node.append(container)
            node = node[i]
        else:
            node = node.setdefault(part, container)
    last = parts[-1]
    if last.isdigit():
        i = int(last)
        if i == len(node):
            node.append(value)
        else:
            node[i] = value
    else:
        node[last] = value
