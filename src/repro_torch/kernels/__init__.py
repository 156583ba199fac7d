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

A CUDA graph replay (`repro_torch.core.aot`) runs the kernels it
captured without calling their wrappers, so it adds to no wrapper's
count: it adds the launches it captured to `replayed_launch_counts`
instead, which `reset_launch_counts` zeroes as well.
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


_REPLAYED = {w.__name__: 0 for w in WRAPPERS}


def launch_counts() -> dict:
    return {w.__name__: w.launches for w in WRAPPERS}


def replayed_launch_counts() -> dict:
    """Wrapper calls run by CUDA graph replays since the last reset."""
    return dict(_REPLAYED)


def count_replay(captured: dict) -> None:
    """One replay of a graph that captured ``captured`` wrapper calls."""
    for name, n in captured.items():
        _REPLAYED[name] += n


def reset_launch_counts() -> None:
    for w in WRAPPERS:
        w.launches = 0
    for name in _REPLAYED:
        _REPLAYED[name] = 0
