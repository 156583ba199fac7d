"""repro_torch.core — the ultrasound pipelines in PyTorch.

Module map, as in the reference package: config -> stages (via the
lowering registry) -> plan (fixed / heuristic / autotune) -> pipeline
(two-tier constants cache) / executors (`BatchedExecutor` on one
device, `ShardedExecutor` over several); staging rings and warm pools
(CUDA-graph capture) feed the serving schedulers. The reference's
persistent compilation cache (``compile_cache_dir`` and its setters)
has no counterpart: see `repro_torch.core.aot`.
"""

from repro_torch.core.config import (  # noqa: F401
    EXEC_MAPS,
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
from repro_torch.core.aot import (  # noqa: F401
    AotProgram,
    WarmPool,
    aot_warm,
    warm_pool,
)
from repro_torch.core.lowering import (  # noqa: F401
    Lowering,
    apply_stage,
    available_lowerings,
    register_lowering,
    registered_lowerings,
)
from repro_torch.core.pipeline import (  # noqa: F401
    CONSTS_CACHE_STATS,
    UltrasoundPipeline,
    clear_consts_cache,
    consts_cache_dir,
    consts_from_numpy,
    init_pipeline,
    monolithic_pipeline_fn,
    pipeline_fn,
    resolve_device,
    set_consts_cache_dir,
)
from repro_torch.core.plan import (  # noqa: F401
    PipelinePlan,
    clear_autotune_memo,
    plan_pipeline,
    register_backend_preference,
    register_lowering_preference,
)
from repro_torch.core.stages import (  # noqa: F401
    Stage,
    build_graph,
    graph_fn,
    init_graph_consts,
    stage_fns,
)
from repro_torch.core.executor import (  # noqa: F401
    BatchedExecutor,
    ShardedExecutor,
)
from repro_torch.core.staging import StagingRing  # noqa: F401
