"""Delay-and-sum beamforming, dynamic variant (PyTorch).

    y[b, p, f] = sum_c apod[p,c] * rot[p,c] * lerp(IQ[b, :, c, f], s[p,c])

``beamform_dynamic`` is the port's ``"xla"`` lowering of the beamform
stage: the plain gather formulation, the same function the CUDA kernel
(``repro_torch.kernels.das_beamform``) is held to. The cnn and sparse
variants are not ported yet.

Input : IQ (B, n_s, n_c, n_f, 2)
Output: beamformed (B, n_pix, n_f, 2)
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.config import UltrasoundConfig
from repro_torch.kernels.das_beamform.ref import das_beamform_ref


def beamform_dynamic(cfg: UltrasoundConfig, consts: Dict[str, torch.Tensor],
                     iq: torch.Tensor) -> torch.Tensor:
    return das_beamform_ref(consts["idx_long"], consts["frac"],
                            consts["apod"], consts["rot"], iq)
