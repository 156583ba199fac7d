"""Probe geometry and image grid (numpy; init-time constants)."""

from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.config import UltrasoundConfig


def element_positions(cfg: UltrasoundConfig) -> np.ndarray:
    """Lateral x-positions [m] of the n_c array elements, centered at 0."""
    idx = np.arange(cfg.n_c, dtype=np.float64)
    return (idx - (cfg.n_c - 1) / 2.0) * cfg.pitch


def image_grid(cfg: UltrasoundConfig) -> Tuple[np.ndarray, np.ndarray]:
    """(Z, X) pixel coordinates [m], each of shape (nz, nx)."""
    half_ap = (cfg.n_c - 1) / 2.0 * cfg.pitch
    z = np.linspace(cfg.z_min, cfg.z_max, cfg.nz, dtype=np.float64)
    x = np.linspace(-half_ap, half_ap, cfg.nx, dtype=np.float64)
    Z, X = np.meshgrid(z, x, indexing="ij")
    return Z, X


def flat_grid(cfg: UltrasoundConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Flattened (n_pix,) pixel coordinates, row-major over (nz, nx)."""
    Z, X = image_grid(cfg)
    return Z.reshape(-1), X.reshape(-1)
