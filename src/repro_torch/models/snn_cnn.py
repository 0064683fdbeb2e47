"""The paper's SNN benchmark models, as traversals of the model graph.

Port of ``repro.models.snn_cnn`` for the integer path of the vgg and
resnet18 families, with or without fusion groups.
``scale`` shrinks every channel count (scale=1 is the paper-size model).
Input: (B, H, W, C) analog images, direct-encoded over T timesteps.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.lif import LIFConfig
from repro_torch.graph import build_graph, executor_for, graph_init, run_graph
from repro_torch.quant.formats import PrecisionConfig


@dataclasses.dataclass(frozen=True)
class SNNConfig:
    model: str = "vgg16"          # vgg16 | vgg9 | resnet18
    n_classes: int = 10
    in_channels: int = 3
    img_size: int = 32
    timesteps: int = 4
    scale: float = 1.0
    lif: LIFConfig = LIFConfig(leak_shift=3, threshold=1.0)
    precision: PrecisionConfig = PrecisionConfig(bits=16)
    # route every spiking layer after the stem through the fused kernels;
    # requires a quantized ``precision``
    int_deploy: bool = False
    # multi-layer fusion request (repro_torch.graph.fusion.apply_fusion):
    # () lowers layer by layer, "auto" plans the legal groups, or
    # explicit member-name tuples; groups run the fused_group kernel
    fusion: object = ()

    def ch(self, c: int) -> int:
        return max(8, int(c * self.scale))

    @property
    def int_path(self) -> bool:
        return self.int_deploy and self.precision.quantized


def init(seed: int, cfg: SNNConfig, device="cuda"):
    """Float params tree for ``cfg`` (see graph/passes.py)."""
    return graph_init(seed, build_graph(cfg), device=device)


def _graph_apply(params, cfg: SNNConfig, images, rates=None, package=None):
    graph = build_graph(cfg)
    ex = executor_for(graph, params, package=package)
    return run_graph(graph, ex, images, rates=rates)


def apply(params, cfg: SNNConfig, images, package=None):
    """Forward: (B, H, W, C) images in [0,1] -> (B, n_classes) logits.
    With ``package`` (a ``DeployedModel``) the integer layers use its
    packed weights and thresholds; ``params`` then only needs the float
    stem and head (``package.float_params``)."""
    return _graph_apply(params, cfg, images, package=package)


def apply_with_rates(params, cfg: SNNConfig, images, package=None):
    """Forward that also returns each spiking layer's mean firing rate."""
    rates: list = []
    logits = _graph_apply(params, cfg, images, rates=rates, package=package)
    return logits, rates


def count_macs(cfg: SNNConfig) -> int:
    """Synaptic-op count per inference (one timestep x T)."""
    return build_graph(cfg).count_macs()
