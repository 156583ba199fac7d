from repro_torch.kernels.bsr_spmm.ops import (  # noqa: F401
    block_sample_axis,
    bsr_beamform,
    bsr_spmm,
)
from repro_torch.kernels.bsr_spmm.ref import (  # noqa: F401
    bsr_beamform_ref,
    bsr_spmm_ref,
    kept_slots,
    real_form,
)
