"""Typed layer-graph specs: the single source of truth for SNN topology.

The port's own copy of ``repro.graph.spec`` (importing ``repro.graph``
would pull in JAX through its package ``__init__``).  A
:class:`ModelGraph` is a tuple of frozen :class:`LayerSpec` nodes; every
consumer (init, the integer forwards, ``deploy()``'s packing walk) is a
traversal of the same nodes.  Each parameter-bearing spec's ``name`` is
its flat dotted param path (``convs.1``, ``blocks.2.proj``, ``fc1``),
which is also the deploy package's layer key.  ``groups`` annotates
multi-layer fusion (:class:`FusionGroup`, lowered by the ``fused_group``
kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple


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
class Residual(LayerSpec):
    """ResNet basic block: body convs chained, optional 1x1 projection
    shortcut, executor-chosen merge.  ``name`` is the block path
    (``blocks.3``); the nested convs carry their own full paths."""

    body: Tuple[Conv, ...] = ()
    proj: Optional[Conv] = None
    stride: int = 1


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
class FusionGroup:
    """A multi-layer fusion annotation: the named member layers' full
    T-step rollouts run in ONE ``fused_group`` kernel launch, so the 1-bit
    inter-member spike planes stay in shared memory.

    ``members`` are flat dotted layer names in execution order: a
    contiguous chain of stride-1 post-stem Convs (optionally interleaved
    with / ended by Pools) inside one region, all top-level nodes or
    exactly one Residual block's body.  ``repro_torch.graph.fusion``
    checks legality; build groups with ``plan_fusion_groups`` /
    ``apply_fusion``.  ``bits`` optionally pins the precision, which must
    match the cfg's.
    """

    name: str
    members: Tuple[str, ...]
    bits: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ModelGraph:
    """One SNN architecture: an ordered node tuple + the cfg it was built
    for.  ``groups`` annotates multi-layer fusion; an empty tuple lowers
    layer by layer."""

    cfg: object                       # SNNConfig (duck-typed, no cycle)
    nodes: Tuple[LayerSpec, ...]
    groups: Tuple[FusionGroup, ...] = ()

    def iter_flat(self) -> Iterator[LayerSpec]:
        """Every node in execution order, Residual bodies and projections
        flattened after their block (conv1, conv2, proj)."""
        for node in self.nodes:
            yield node
            if isinstance(node, Residual):
                yield from node.body
                if node.proj is not None:
                    yield node.proj

    def param_specs(self) -> Iterator[LayerSpec]:
        """Parameter-bearing specs (Conv/Dense/Readout) in init order."""
        for node in self.iter_flat():
            if isinstance(node, (Conv, Dense, Readout)):
                yield node

    def packable_specs(self) -> Iterator[LayerSpec]:
        """What ``deploy()`` packs: every non-stem Conv (residual bodies
        and projections included) and every Dense."""
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
        if isinstance(spec, Residual):
            return ("residual", spec.name, spec.stride,
                    spec.proj is not None)
        if isinstance(spec, Dense):
            return ("dense", spec.name, spec.d_in, spec.d_out)
        if isinstance(spec, Readout):
            return ("readout", spec.name, spec.d_in, spec.d_out,
                    spec.spatial_mean)
        raise TypeError(f"no topology row for {type(spec).__name__}")

    def topology(self) -> Tuple[Tuple, ...]:
        """Hashable geometry fingerprint, one row per flattened node, then
        one row per fusion group (the rows of ``repro``'s
        ``ModelGraph.topology``), so grouped and ungrouped graphs never
        alias."""
        rows = [self._row(spec) for spec in self.iter_flat()]
        for g in self.groups:
            rows.append(("fusion", g.name) + tuple(g.members))
        return tuple(rows)

    def summary(self) -> str:
        """One line per flattened node, with fusion-group membership, then
        each group's members and the shared memory its ``fused_group``
        launch holds."""
        lines = [f"ModelGraph({self.cfg.model}, T={self.cfg.timesteps}, "
                 f"img={self.cfg.img_size})"]
        grouped = {m: g.name for g in self.groups for m in g.members}
        for spec in self.iter_flat():
            tag = f"   [{grouped[spec.name]}]" if spec.name in grouped \
                else ""
            lines.append(
                "  " + " ".join(str(c) for c in self._row(spec)) + tag)
        if self.groups:
            from repro_torch.graph import fusion as _fusion  # no cycle
            from repro_torch.kernels import smem as _smem
            for g in self.groups:
                est = _fusion.group_smem_bytes(self, g)
                lines.append(
                    f"  fusion {g.name}: {' + '.join(g.members)} "
                    f"({_smem.format_bytes(est)} shared memory of "
                    f"{_smem.format_bytes(_smem.SMEM_LIMIT)} per block; "
                    f"inter-member spikes stay on chip)")
        return "\n".join(lines)


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
