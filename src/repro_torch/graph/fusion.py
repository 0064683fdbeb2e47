"""Fusion-group planning: propose and validate multi-layer rollout chains.

Port of ``repro.graph.fusion``.  A :class:`FusionGroup` chains 2+
layers' full T-step rollouts into ONE ``fused_group`` kernel launch, so
the inter-member 1-bit planes stay in shared memory:

  * :func:`plan_fusion_groups`: greedy legal proposal, the maximal chains
    of contiguous stride-1 post-stem Convs (with interleaved Pools) at the
    top level, plus each stride-1 Residual body (conv1 -> conv2), each
    chain capped by the shared-memory budget;
  * :func:`validate_group`: the legality rules, with the same errors as
    ``repro``: 2+ contiguous conv/pool members, post-stem, stride 1,
    inside one region (all top-level, or exactly one residual block's
    body), single precision, pool-divisible, and within the budget of
    ``kernels/smem.py``, the formula the kernel's wrapper checks too, so
    the planner never admits a group the kernel refuses;
  * :func:`apply_fusion`: attach a request (``"auto"`` or explicit member
    tuples, e.g. ``cfg.fusion``) to a graph; ``()`` is a no-op.

The budget is the ``budget=`` argument, ``SMEM_LIMIT`` by default.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.graph.spec import (
    Conv,
    FusionGroup,
    ModelGraph,
    Pool,
    Residual,
)
from repro_torch.kernels import smem as _smem

FusionRequest = Union[str, Sequence[Sequence[str]], None]


def _round32(c: int) -> int:
    return -(-c // 32) * 32


class _Located:
    """A resolved member: its spec plus where it lives (top-level node
    index, or the Residual block whose body holds it)."""

    def __init__(self, spec, top_index=None, block=None):
        self.spec = spec
        self.top_index = top_index
        self.block = block


def _locate(graph: ModelGraph, name: str) -> _Located:
    for i, node in enumerate(graph.nodes):
        if node.name == name:
            return _Located(node, top_index=i)
        if isinstance(node, Residual):
            for bc in node.body:
                if bc.name == name:
                    return _Located(bc, block=node.name)
            if node.proj is not None and node.proj.name == name:
                raise ValueError(
                    f"fusion group member {name!r} is a projection "
                    f"shortcut: it runs in PARALLEL with the block body "
                    f"(both read the pre-body plane), so it cannot join "
                    f"a sequential fusion chain")
    raise ValueError(f"fusion group member {name!r} is not a layer of "
                     f"this graph (known layers: "
                     f"{[s.name for s in graph.iter_flat()]})")


def _member_geometry(graph: ModelGraph, group: FusionGroup) -> List[Dict]:
    """Per-member geometry dicts for ``smem.group_rollout_smem_bytes``,
    walking the spatial and channel chain.  Assumes the structural rules
    already hold (validate_group calls this last)."""
    specs = [_locate(graph, m).spec for m in group.members]
    hw = specs[0].out_hw        # stride-1 SAME: input dims == output dims
    ch = specs[0].c_in
    geoms: List[Dict] = []
    for spec in specs:
        if isinstance(spec, Conv):
            geoms.append({"kind": "conv", "h": hw, "w": hw,
                          "cin_pad": _round32(spec.c_in),
                          "kh": spec.k, "kw": spec.k})
            ch = spec.c_out
        else:                   # Pool
            geoms.append({"kind": "pool", "h": hw, "w": hw,
                          "c": _round32(ch)})
            hw //= spec.window
    return geoms


def group_smem_bytes(graph: ModelGraph, group: FusionGroup) -> int:
    """Shared memory of the group's ``fused_group`` launch per block: the
    number ``ModelGraph.summary()`` prints and :func:`validate_group`
    budgets."""
    return _smem.group_rollout_smem_bytes(_member_geometry(graph, group))


def validate_group(graph: ModelGraph, group: FusionGroup,
                   budget: int = _smem.SMEM_LIMIT) -> FusionGroup:
    """Check one fusion group against the legality rules; returns the
    group, or raises ``ValueError`` naming the rule and the fix."""
    if len(group.members) < 2:
        raise ValueError(
            f"fusion group {group.name!r} has {len(group.members)} "
            f"member(s); a group fuses 2+ layers (a single layer is "
            f"already fused by kernels/fused_conv; drop the annotation)")
    if len(set(group.members)) != len(group.members):
        raise ValueError(f"fusion group {group.name!r} repeats a member: "
                         f"{group.members}")

    located = [_locate(graph, m) for m in group.members]

    # precision: one packed datapath width per chain
    pc = getattr(graph.cfg, "precision", None)
    if group.bits is not None:
        cfg_bits = pc.bits if (pc is not None
                               and getattr(pc, "quantized", False)) else None
        if group.bits != cfg_bits:
            raise ValueError(
                f"fusion group {group.name!r} is precision-mixed: group "
                f"pins W{group.bits} but the graph lowers its packed "
                f"layers at W{cfg_bits} (cfg.precision); a fused chain's "
                f"inter-member planes ride one datapath width; re-deploy "
                f"the whole graph at W{group.bits} or drop the pin")

    # member kinds + stem + stride
    for loc in located:
        spec = loc.spec
        if not isinstance(spec, (Conv, Pool)):
            raise ValueError(
                f"fusion group {group.name!r} member {spec.name!r} is a "
                f"{type(spec).__name__}: only conv/pool chains fuse (the "
                f"dense head and readout have their own kernels)")
        if isinstance(spec, Conv) and spec.stem:
            raise ValueError(
                f"fusion group {group.name!r} starts at the stem "
                f"{spec.name!r}: the stem consumes analog encoded "
                f"currents (not 1-bit spikes), so it stays on the float "
                f"twin and cannot join a packed fusion chain")
        if isinstance(spec, Conv) and spec.stride != 1:
            raise ValueError(
                f"fusion group {group.name!r} member {spec.name!r} has "
                f"stride {spec.stride}: a stride change re-shapes the "
                f"plane mid-chain; fuse up to the stride boundary and "
                f"let the strided layer run its own fused_conv call")
    if not isinstance(located[0].spec, Conv):
        raise ValueError(
            f"fusion group {group.name!r} starts at pool "
            f"{located[0].spec.name!r}: a chain starts at a conv (fold a "
            f"leading pool into the previous group instead)")

    # region: all top-level, or exactly one residual body
    blocks = {loc.block for loc in located}
    if len(blocks) > 1:
        inside = sorted(b for b in blocks if b is not None)
        raise ValueError(
            f"fusion group {group.name!r} crosses a residual boundary "
            f"(members span "
            f"{inside + (['top-level'] if None in blocks else [])}): "
            f"the shortcut of each block reads the PRE-body plane, which "
            f"a fused chain would keep on chip; fuse within one block "
            f"body or between blocks, never across")
    if blocks == {None}:
        idxs = [loc.top_index for loc in located]
        if idxs != list(range(idxs[0], idxs[0] + len(idxs))):
            raise ValueError(
                f"fusion group {group.name!r} members are not contiguous "
                f"in execution order (node indices {idxs}): inter-member "
                f"planes chain through shared memory, so the members must "
                f"be adjacent layers")
    else:
        (block,) = blocks
        body = next(n.body for n in graph.nodes
                    if isinstance(n, Residual) and n.name == block)
        if tuple(group.members) != tuple(c.name for c in body):
            raise ValueError(
                f"fusion group {group.name!r} must cover block "
                f"{block!r}'s full body in order "
                f"({[c.name for c in body]}), got {list(group.members)}: "
                f"the merge consumes the body's final plane")

    # pool divisibility along the spatial chain
    hw = located[0].spec.out_hw
    for loc in located:
        if isinstance(loc.spec, Pool):
            if hw % loc.spec.window or hw < loc.spec.window:
                raise ValueError(
                    f"fusion group {group.name!r} pools a {hw}x{hw} "
                    f"plane by {loc.spec.window}: not divisible; end the "
                    f"group before {loc.spec.name!r}")
            hw //= loc.spec.window

    # shared-memory budget: the formula the kernel's wrapper checks
    need = group_smem_bytes(graph, group)
    if need > budget:
        raise ValueError(
            f"fusion group {group.name!r} ({' + '.join(group.members)}) "
            f"needs {_smem.format_bytes(need)} of shared memory > budget "
            f"{_smem.format_bytes(budget)}: the inter-member planes must "
            f"be resident at once; split the chain")
    return group


def plan_fusion_groups(graph: ModelGraph, budget: int = _smem.SMEM_LIMIT
                       ) -> Tuple[FusionGroup, ...]:
    """Propose legal fusion groups for ``graph``: maximal contiguous
    chains of stride-1 post-stem Convs/Pools at the top level, plus each
    all-stride-1 Residual body, every chain capped by ``budget``.  Every
    returned group passes :func:`validate_group`."""
    proposals: List[Tuple[str, ...]] = []

    def _fits(members: Sequence[str]) -> bool:
        probe = FusionGroup("probe", tuple(members))
        return group_smem_bytes(graph, probe) <= budget

    # top-level chains
    i, nodes = 0, graph.nodes
    while i < len(nodes):
        node = nodes[i]
        if not (isinstance(node, Conv) and not node.stem
                and node.stride == 1):
            i += 1
            continue
        members = [node.name]
        hw = node.out_hw
        j = i + 1
        while j < len(nodes):
            nxt = nodes[j]
            if isinstance(nxt, Conv) and not nxt.stem and nxt.stride == 1:
                cand = members + [nxt.name]
            elif isinstance(nxt, Pool) and hw % nxt.window == 0 \
                    and hw >= nxt.window:
                cand = members + [nxt.name]
            else:
                break
            if not _fits(cand):
                break
            members = cand
            if isinstance(nxt, Pool):
                hw //= nxt.window
            j += 1
        if len(members) >= 2:
            proposals.append(tuple(members))
            i = j
        else:
            i += 1

    # residual bodies: conv1 -> conv2 when the block entry is stride 1
    # (a strided conv1 re-shapes the plane, which the chain excludes)
    for node in nodes:
        if isinstance(node, Residual) \
                and all(c.stride == 1 for c in node.body):
            members = tuple(c.name for c in node.body)
            if len(members) >= 2 and _fits(members):
                proposals.append(members)

    return tuple(
        validate_group(graph, FusionGroup(f"fuse.{k}", m), budget=budget)
        for k, m in enumerate(proposals))


def apply_fusion(graph: ModelGraph, fusion: FusionRequest) -> ModelGraph:
    """Attach fusion groups per a request (``cfg.fusion``):

      ``()`` / ``None``      no-op, the graph lowers layer by layer
      ``"auto"``             :func:`plan_fusion_groups`
      ``((name, ...), ...)`` explicit member chains, each validated

    Returns a new graph; the node tuple is untouched, so params and init
    are unaffected.
    """
    if not fusion:
        return graph
    if fusion == "auto":
        groups = plan_fusion_groups(graph)
    elif isinstance(fusion, str):
        raise ValueError(f"unknown fusion request {fusion!r} "
                         f"(expected 'auto' or explicit member tuples)")
    else:
        groups = tuple(
            validate_group(graph, FusionGroup(f"fuse.{k}", tuple(m)))
            for k, m in enumerate(fusion))
        seen: Dict[str, str] = {}
        for g in groups:
            for m in g.members:
                if m in seen:
                    raise ValueError(
                        f"layer {m!r} is a member of both {seen[m]!r} "
                        f"and {g.name!r}; fusion groups must be disjoint")
                seen[m] = g.name
    if not groups:
        return graph
    return dataclasses.replace(graph, groups=groups)


def body_group(graph: ModelGraph, block: Residual
               ) -> Optional[FusionGroup]:
    """The fusion group covering ``block``'s body, if annotated."""
    body_names = tuple(c.name for c in block.body)
    for g in graph.groups:
        if g.members == body_names:
            return g
    return None
