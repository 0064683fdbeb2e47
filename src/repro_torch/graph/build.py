"""Graph builders: ``SNNConfig`` -> :class:`ModelGraph`.

Port of ``repro.graph.build``: ``vgg_graph`` / ``resnet_graph`` turn an
``SNNConfig`` into the one :class:`ModelGraph` every lowering shares, and
``build_graph`` dispatches on ``cfg.model`` and attaches the fusion
groups ``cfg.fusion`` asks for (``repro_torch.graph.fusion``).
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
    Residual,
)

VGG16_PLAN = [64, 64, "P", 128, 128, "P", 256, 256, 256, "P",
              512, 512, 512, "P", 512, 512, 512, "P"]
VGG9_PLAN = [64, 64, "P", 128, 128, "P", 256, "P"]
RESNET18_STAGES = [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)]


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


def resnet_graph(cfg) -> ModelGraph:
    """ResNet-18-family graph: stem conv, four stages of basic blocks
    (stride + 1x1 projection on stage entry), global-avg-pool readout."""
    nodes = [Encode("encode", timesteps=cfg.timesteps)]
    hw, c = cfg.img_size, cfg.ch(64)
    nodes.append(Conv("stem", cfg.in_channels, c, k=3, stride=1, stem=True,
                      out_hw=hw))
    c_in, bi = c, 0
    for c_base, n_blocks, stride in RESNET18_STAGES:
        c_out = cfg.ch(c_base)
        for b in range(n_blocks):
            s = stride if b == 0 else 1
            hw //= s
            conv1 = Conv(f"blocks.{bi}.conv1", c_in, c_out, k=3, stride=s,
                         out_hw=hw)
            conv2 = Conv(f"blocks.{bi}.conv2", c_out, c_out, k=3, stride=1,
                         out_hw=hw)
            proj = None
            if s != 1 or c_in != c_out:
                proj = Conv(f"blocks.{bi}.proj", c_in, c_out, k=1, stride=s,
                            out_hw=hw)
            nodes.append(Residual(f"blocks.{bi}", body=(conv1, conv2),
                                  proj=proj, stride=s))
            c_in = c_out
            bi += 1
    nodes.append(Readout("head", d_in=c_in, d_out=cfg.n_classes,
                         spatial_mean=True))
    return ModelGraph(cfg=cfg, nodes=tuple(nodes))


@functools.lru_cache(maxsize=64)
def build_graph(cfg) -> ModelGraph:
    """Family dispatch (memoized: configs are frozen, graphs immutable).
    A ``cfg.fusion`` request (``"auto"`` or explicit member tuples) gets
    its groups planned and validated here, so every consumer of the graph
    sees the same annotation."""
    if cfg.model == "resnet18":
        g = resnet_graph(cfg)
    elif cfg.model in ("vgg9", "vgg16"):
        g = vgg_graph(cfg)
    else:
        raise ValueError(f"unknown model family {cfg.model!r} "
                         "(known: vgg9, vgg16, resnet18)")
    fusion = getattr(cfg, "fusion", ())
    if fusion:
        from repro_torch.graph.fusion import apply_fusion  # no cycle
        g = apply_fusion(g, fusion)
    return g
