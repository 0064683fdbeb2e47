"""The paper's SNN benchmark models, as traversals of the model graph.

Port of ``repro.models.snn_cnn``: VGG and ResNet-18 spiking stacks with
shift-add LIF dynamics, trainable by BPTT with surrogate gradients (and
QAT fake-quant at a quantized precision), deployable to the packed
integer datapath.  Every entry point here (``init``, ``calibrate``,
``apply``, ``apply_with_rates``, ``count_macs``) is a traversal of the
one graph ``repro_torch.graph.build_graph`` makes of a config, under the
executor the config and operands ask for:

  * the float/BPTT twin (``FloatExecutor``) by default;
  * the per-call integer path (``IntExecutor``: every post-stem layer
    through the fused kernels, quantizing per call) with
    ``cfg.int_deploy`` and a quantized precision;
  * packaged serving (``PackagedExecutor``) with ``package=`` a
    ``DeployedModel``, bit-exact with the per-call path.

``scale`` shrinks every channel count (scale=1 is the paper-size model).
Input: (B, H, W, C) analog images, direct-encoded over T timesteps.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.lif import LIFConfig
from repro_torch.graph import (
    build_graph,
    executor_for,
    graph_calibrate,
    graph_init,
    run_graph,
)
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


def calibrate(params, cfg: SNNConfig, images):
    """Params with balanced per-layer gains from one float forward of
    ``images`` (Diehl-style threshold balancing, see graph/passes.py);
    the input tree is not mutated."""
    return graph_calibrate(params, build_graph(cfg), images)


def _graph_apply(params, cfg: SNNConfig, images, rates=None, package=None):
    graph = build_graph(cfg)
    ex = executor_for(graph, params, package=package)
    return run_graph(graph, ex, images, rates=rates)


def apply(params, cfg: SNNConfig, images, package=None):
    """Forward: (B, H, W, C) images in [0,1] -> (B, n_classes) logits.
    The float/BPTT forward unless ``cfg.int_path``.  With ``package`` (a ``DeployedModel``) the integer layers use its
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


# -- legacy per-family aliases (the graph dispatches internally) ------------

def vgg_apply(params, cfg: SNNConfig, images, _rates=None, package=None):
    return _graph_apply(params, cfg, images, rates=_rates, package=package)


def resnet_apply(params, cfg: SNNConfig, images, _rates=None, package=None):
    return _graph_apply(params, cfg, images, rates=_rates, package=package)


def vgg_init(seed: int, cfg: SNNConfig, device="cuda"):
    return graph_init(seed, build_graph(cfg), device=device)


def resnet_init(seed: int, cfg: SNNConfig, device="cuda"):
    return graph_init(seed, build_graph(cfg), device=device)
