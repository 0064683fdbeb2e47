"""Declarative model graph: define the SNN once, lower it with executors.

Port of ``repro.graph`` for the VGG family's integer serving path.
"""

from repro_torch.graph.build import (  # noqa: F401
    VGG9_PLAN,
    VGG16_PLAN,
    build_graph,
    effective_plan,
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
from repro_torch.graph.passes import graph_init  # noqa: F401
from repro_torch.graph.spec import (  # noqa: F401
    Conv,
    Dense,
    Encode,
    LayerSpec,
    ModelGraph,
    Pool,
    Readout,
    get_path,
    set_path,
)
