"""Declarative model graph: define the SNN once, lower it with executors.

Port of ``repro.graph`` for the integer serving path (vgg and resnet18
families, fusion groups).
"""

from repro_torch.graph.build import (  # noqa: F401
    RESNET18_STAGES,
    VGG9_PLAN,
    VGG16_PLAN,
    build_graph,
    effective_plan,
    resnet_graph,
    vgg_graph,
)
from repro_torch.graph.executors import (  # noqa: F401
    Executor,
    FloatExecutor,
    IntExecutor,
    PackagedExecutor,
    executor_for,
    run_graph,
)
from repro_torch.graph.fusion import (  # noqa: F401
    apply_fusion,
    body_group,
    group_smem_bytes,
    plan_fusion_groups,
    validate_group,
)
from repro_torch.graph.passes import graph_init  # noqa: F401
from repro_torch.graph.spec import (  # noqa: F401
    Conv,
    Dense,
    Encode,
    FusionGroup,
    LayerSpec,
    ModelGraph,
    Pool,
    Readout,
    Residual,
    get_path,
    set_path,
)
