"""repro_torch.core — the ultrasound pipelines in PyTorch.

Module map, as in the reference package: config -> stages (via the
lowering registry) -> plan -> pipeline / executor.
"""

from repro_torch.core.config import (  # noqa: F401
    LOWERING_NAMES,
    Modality,
    PIPELINE_NAMES,
    PRECISION_TOLERANCES,
    STAGE_NAMES,
    UltrasoundConfig,
    Variant,
    config_hash,
    paper_config,
    tiny_config,
)
from repro_torch.core.pipeline import (  # noqa: F401
    UltrasoundPipeline,
    consts_from_numpy,
    init_pipeline,
    monolithic_pipeline_fn,
    pipeline_fn,
    resolve_device,
)
from repro_torch.core.plan import PipelinePlan, plan_pipeline  # noqa: F401
from repro_torch.core.stages import (  # noqa: F401
    build_graph,
    graph_fn,
    init_graph_consts,
    stage_fns,
)
from repro_torch.core.executor import BatchedExecutor  # noqa: F401
