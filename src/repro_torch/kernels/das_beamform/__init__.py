from repro_torch.kernels.das_beamform.ops import das_beamform  # noqa: F401
from repro_torch.kernels.das_beamform.ref import das_beamform_ref  # noqa: F401
