"""Graph builders: ``SNNConfig`` -> :class:`ModelGraph`.

Port of ``repro.graph.build`` for the VGG family.  ``resnet18`` and
multi-layer fusion (``cfg.fusion``, lowered by the ``fused_group``
kernel) are not ported yet; ``build_graph`` raises for them instead of
lowering them some other way.
"""

from __future__ import annotations

import functools

from repro_torch.graph.spec import (
    Conv,
    Dense,
    Encode,
    ModelGraph,
    Pool,
    Readout,
)

VGG16_PLAN = [64, 64, "P", 128, 128, "P", 256, 256, 256, "P",
              512, 512, 512, "P", 512, 512, 512, "P"]
VGG9_PLAN = [64, 64, "P", 128, 128, "P", 256, "P"]


def effective_plan(img_size: int, base_plan=None):
    """VGG plan with pools dropped once the spatial dim reaches 2."""
    plan, hw = [], img_size
    for item in (base_plan if base_plan is not None else VGG16_PLAN):
        if item == "P":
            if hw <= 2:
                continue
            hw //= 2
        plan.append(item)
    return plan


def vgg_graph(cfg) -> ModelGraph:
    """VGG-family graph: plan-driven conv/pool stack, one spiking FC
    (``fc1``), non-spiking readout head."""
    base = VGG9_PLAN if cfg.model == "vgg9" else VGG16_PLAN
    plan = effective_plan(cfg.img_size, base)
    nodes = [Encode("encode", timesteps=cfg.timesteps)]
    hw, c_in, ci, pi = cfg.img_size, cfg.in_channels, 0, 0
    for item in plan:
        if item == "P":
            nodes.append(Pool(f"pool.{pi}"))
            hw //= 2
            pi += 1
        else:
            c_out = cfg.ch(item)
            nodes.append(Conv(f"convs.{ci}", c_in, c_out, k=3, stride=1,
                              stem=(ci == 0), out_hw=hw))
            c_in = c_out
            ci += 1
    d_hidden = cfg.ch(512)
    nodes.append(Dense("fc1", d_in=hw * hw * c_in, d_out=d_hidden))
    nodes.append(Readout("head", d_in=d_hidden, d_out=cfg.n_classes))
    return ModelGraph(cfg=cfg, nodes=tuple(nodes))


@functools.lru_cache(maxsize=64)
def build_graph(cfg) -> ModelGraph:
    """Family dispatch (memoized: configs are frozen, graphs immutable)."""
    if getattr(cfg, "fusion", ()):
        raise NotImplementedError(
            "fusion groups are not yet ported to repro_torch (they lower "
            "through the fused_group kernel); use fusion=()")
    if cfg.model in ("vgg9", "vgg16"):
        return vgg_graph(cfg)
    if cfg.model == "resnet18":
        raise NotImplementedError("resnet18 is not yet ported to "
                                  "repro_torch")
    raise ValueError(f"unknown model family {cfg.model!r} "
                     "(known: vgg9, vgg16, resnet18)")
