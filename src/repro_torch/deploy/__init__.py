"""SNN serving runtime: one-shot model packing + batched serving."""

from repro_torch.deploy.engine import (  # noqa: F401
    InflightStep,
    SNNEngineConfig,
    SNNRequest,
    SNNServeEngine,
)
from repro_torch.deploy.package import (  # noqa: F401
    PACKAGE_FORMAT_VERSION,
    DeployedModel,
    PackedLayer,
    deploy,
    deploy_config,
    load,
)
