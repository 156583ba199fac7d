"""Roofline terms of a step, per card: the counterpart of the
reference's ``launch/hlo_analysis.py``.

The card is one NVIDIA H100 80GB HBM3 (SXM). Its figures here are the
data sheet's, dense rates without sparsity at the full 700 W: bounds
that no run measured, and the only place the port writes them. A card
whose power limit is lower runs slower under load. The collective term
reads NVLink 4's rate a direction a GPU, which holds inside one NVLink
domain (a host of 8 cards); a mesh wider than that crosses the network,
which this term does not model. The reference's TPU v5e figures are not
carried over.

`roofline_terms` and `dominant_term` keep the reference's signatures
and keys. Like the reference's, the collective term takes each
collective's result bytes as the bytes it moves (`op_cost`): a ring
all-reduce moves about twice that, which is noted and not modelled.
"""

from __future__ import annotations

from typing import Dict

PEAK_FLOPS = 989e12            # bf16 / fp16, tensor cores, FLOP/s
PEAK_TF32_FLOPS = 495e12       # TF32, tensor cores
PEAK_F32_FLOPS = 67e12         # f32 outside the tensor cores
HBM_BW = 3.35e12               # bytes/s of HBM3
HBM_BYTES = 80e9               # bytes of HBM
LINK_BW = 450e9                # NVLink 4, bytes/s a direction a GPU


def roofline_terms(flops: float, bytes_accessed: float,
                   coll_bytes: int, n_chips: int) -> Dict[str, float]:
    """Three roofline terms in seconds, from per-card values (the step
    of one rank)."""
    return {
        "t_compute": flops / PEAK_FLOPS,
        "t_memory": bytes_accessed / HBM_BW,
        "t_collective": coll_bytes / LINK_BW,
    }


def dominant_term(terms: Dict[str, float]) -> str:
    return max(("t_compute", "t_memory", "t_collective"),
               key=lambda k: terms[k])
