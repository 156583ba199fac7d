from repro_torch.kernels.fused_pipeline.ops import (  # noqa: F401
    fused_rf_to_envelope,
    fused_rf_to_power,
)
from repro_torch.kernels.fused_pipeline.ref import fused_ref  # noqa: F401
