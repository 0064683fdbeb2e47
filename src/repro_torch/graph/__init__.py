"""Declarative model graph: define the SNN once, lower it with executors.

Port of ``repro.graph``: one :class:`ModelGraph` per model family (vgg
and resnet18), lowered to the float/BPTT training forward
(:class:`FloatExecutor`), the per-call integer path
(:class:`IntExecutor`) and packaged serving (:class:`PackagedExecutor`);
parameter init, threshold calibration, fusion groups and MAC counting
are traversals of the same graph.
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
from repro_torch.graph.passes import (  # noqa: F401
    CalibratingExecutor,
    graph_calibrate,
    graph_init,
)
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
