"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

One per TPU kernel of the ported paths: ``das_beamform`` (dynamic
beamform), ``fused_rf_to_envelope`` / ``fused_rf_to_power`` (the fused
dynamic spans), ``bsr_spmm`` / ``bsr_beamform`` (the sparse
beamform; the served path launches ``bsr_beamform``), and for the LM
half ``flash_attention`` (zamba2's prefill) and ``ssd_scan`` (its
forward).

Each wrapper counts its launches in a plain int attribute
(``das_beamform.launches``), so a run can show that the main path went
through the kernel. `launch_counts` / `reset_launch_counts` read and
zero them all.
"""

from repro_torch.kernels.bsr_spmm import bsr_beamform, bsr_spmm  # noqa: F401
from repro_torch.kernels.das_beamform import das_beamform  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.fused_pipeline import (  # noqa: F401
    fused_rf_to_envelope,
    fused_rf_to_power,
)
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: F401

WRAPPERS = (das_beamform, fused_rf_to_envelope, fused_rf_to_power,
            bsr_spmm, bsr_beamform, flash_attention, ssd_scan)


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
