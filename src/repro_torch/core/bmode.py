"""B-mode head: envelope detection + dynamic-range compression (PyTorch).

Every function takes a leading batch axis. ``compress_envelope``
normalizes over the pixels of each acquisition, never across the batch.
"""

from __future__ import annotations

import torch

from repro_torch.core import cnn_ops
from repro_torch.core.config import UltrasoundConfig


def envelope(bf: torch.Tensor) -> torch.Tensor:
    """(B, n_pix, n_f, 2) beamformed IQ -> (B, n_pix, n_f) envelope."""
    return cnn_ops.magnitude(bf[..., 0], bf[..., 1])


def compress_envelope(cfg: UltrasoundConfig,
                      env: torch.Tensor) -> torch.Tensor:
    """(B, n_pix, n_f) envelope -> (B, nz, nx, n_f) image in [0, 1].

    The global half of the head: the max runs over every pixel of one
    acquisition, so it stays outside the fused kernel.
    """
    env = cnn_ops.normalize_by_max(env, dim=1)
    if cfg.cnn_transcendentals:
        db = cnn_ops.db20_approx(env)
    else:
        db = 20.0 * torch.log10(torch.clamp(env, min=1e-30))
    dr = cfg.dynamic_range_db
    img = (cnn_ops.clip(db, -dr, 0.0) + dr) / dr
    return img.reshape(env.shape[0], cfg.nz, cfg.nx, -1)


def bmode_image(cfg: UltrasoundConfig, bf: torch.Tensor) -> torch.Tensor:
    """(B, n_pix, n_f, 2) beamformed IQ -> (B, nz, nx, n_f) image."""
    return compress_envelope(cfg, envelope(bf))
