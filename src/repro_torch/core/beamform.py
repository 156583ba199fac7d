"""Delay-and-sum beamforming, the three variants (PyTorch).

All compute the same function:

    y[b, p, f] = sum_c apod[p,c] * rot[p,c] * lerp(IQ[b, :, c, f], s[p,c])

DYNAMIC — the gather formulation (``das_beamform_ref``).
CNN     — the dense one-hot operator ``interp_matrix`` (c, p, s, 2): per
          channel a complex (n_pix x n_s) @ (n_s x B*n_f) product,
          accumulated over channels.
SPARSE  — the same operator in banded BSR form (``bsr_blocks``,
          ``bsr_col_idx``) through ``bsr_beamform_ref``.

Each is the port's ``"xla"`` lowering of its variant's beamform stage,
the plain function its CUDA kernel (where there is one) is held to;
`beamform` dispatches on ``cfg.variant`` for the monolithic oracle.

Input : IQ (B, n_s, n_c, n_f, 2)
Output: beamformed (B, n_pix, n_f, 2)
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.config import UltrasoundConfig, Variant
from repro_torch.kernels.bsr_spmm.ops import block_sample_axis
from repro_torch.kernels.bsr_spmm.ref import bsr_beamform_ref
from repro_torch.kernels.das_beamform.ref import das_beamform_ref


def beamform_dynamic(cfg: UltrasoundConfig, consts: Dict[str, torch.Tensor],
                     iq: torch.Tensor) -> torch.Tensor:
    return das_beamform_ref(consts["idx_long"], consts["frac"],
                            consts["apod"], consts["rot"], iq)


def beamform_cnn(cfg: UltrasoundConfig, consts: Dict[str, torch.Tensor],
                 iq: torch.Tensor) -> torch.Tensor:
    """Per channel c, M[c] viewed as a real (n_pix, 2 n_s) matrix (re, im
    interleaved along s, no copy) times the real form of the complex IQ,
    [[re, im], [-im, re]] per sample: (2 n_s, 2 B n_f). Accumulated in
    place over channels, so nothing larger than the output is made."""
    m = consts["interp_matrix"]                      # (n_c, n_pix, n_s, 2)
    n_c, n_pix, n_s, _ = m.shape
    b, _, _, n_f, _ = iq.shape
    x = iq.permute(2, 1, 4, 0, 3)                    # (n_c, n_s, r, B, n_f)
    re, im = x[:, :, 0], x[:, :, 1]
    # (n_c, n_s, [M re, M im], [out re, out im], B * n_f)
    xr = torch.stack([torch.stack([re, im], 2), torch.stack([-im, re], 2)],
                     2).reshape(n_c, 2 * n_s, 2 * b * n_f)
    y = iq.new_zeros((n_pix, 2 * b * n_f))
    for c in range(n_c):
        y.addmm_(m[c].view(n_pix, 2 * n_s), xr[c])
    return y.view(n_pix, 2, b, n_f).permute(2, 0, 3, 1)


def beamform_sparse(cfg: UltrasoundConfig, consts: Dict[str, torch.Tensor],
                    iq: torch.Tensor) -> torch.Tensor:
    blocks = consts["bsr_blocks"]                # (n_c, n_pb, K, bp, bs, 2)
    iq_b = block_sample_axis(iq, blocks.shape[4])
    return bsr_beamform_ref(consts["bsr_col_idx"], blocks,
                            iq_b)[:, :cfg.n_pix]


BEAMFORMERS = {
    Variant.DYNAMIC: beamform_dynamic,
    Variant.CNN: beamform_cnn,
    Variant.SPARSE: beamform_sparse,
}


def beamform(cfg: UltrasoundConfig, consts: Dict[str, torch.Tensor],
             iq: torch.Tensor) -> torch.Tensor:
    """The plain beamform of ``cfg.variant`` (the monolithic oracle's
    path; lowering-aware execution goes through the stage graph)."""
    return BEAMFORMERS[cfg.variant](cfg, consts, iq)
