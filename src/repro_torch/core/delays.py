"""Delay-and-sum geometry tables (numpy; precomputed, excluded from timing).

Plane-wave (0 deg) transmit, dynamic-aperture receive:

  tau(p, c) = ( z_p + sqrt(z_p^2 + (x_p - x_c)^2) ) / c_sound

The IQ-domain DAS interpolates the decimated IQ signal at s = tau * fs_iq
and applies the phase rotation exp(+j 2 pi f0 tau).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import geometry
from repro_torch.core.config import UltrasoundConfig


@dataclasses.dataclass(frozen=True)
class DelayTables:
    """Per (pixel, channel) gather/interp/apodization/rotation constants.

    idx   : (n_pix, n_c) int32 — floor sample index into IQ axis (clamped)
    frac  : (n_pix, n_c) f32   — linear interpolation fraction in [0, 1)
    valid : (n_pix, n_c) f32   — 1.0 where the delay lands inside the trace
    apod  : (n_pix, n_c) f32   — dynamic-aperture Hann apodization (masked)
    rot   : (n_pix, n_c, 2) f32 — unit phasor exp(+j 2 pi f0 tau) as (re, im)
    """

    idx: np.ndarray
    frac: np.ndarray
    valid: np.ndarray
    apod: np.ndarray
    rot: np.ndarray


def compute_delay_tables(cfg: UltrasoundConfig) -> DelayTables:
    zp, xp = geometry.flat_grid(cfg)                       # (n_pix,)
    xc = geometry.element_positions(cfg)                   # (n_c,)

    dz = zp[:, None]                                       # (n_pix, 1)
    dx = xp[:, None] - xc[None, :]                         # (n_pix, n_c)
    tau = (dz + np.sqrt(dz * dz + dx * dx)) / cfg.c_sound  # (n_pix, n_c)

    s = tau * cfg.fs_iq
    idx = np.floor(s).astype(np.int64)
    frac = (s - idx).astype(np.float32)
    valid = ((idx >= 0) & (idx < cfg.n_s - 1)).astype(np.float32)
    idx = np.clip(idx, 0, cfg.n_s - 2).astype(np.int32)

    half_aperture = dz / (2.0 * cfg.f_number)              # (n_pix, 1)
    rel = np.clip(np.abs(dx) / np.maximum(half_aperture, 1e-9), 0.0, 1.0)
    apod = (0.5 + 0.5 * np.cos(np.pi * rel)).astype(np.float32)
    apod *= (np.abs(dx) <= half_aperture).astype(np.float32)
    apod *= valid
    norm = apod.sum(axis=1, keepdims=True)
    apod = (apod / np.maximum(norm, 1e-9)).astype(np.float32)

    phase = 2.0 * np.pi * cfg.f0 * tau
    rot = np.stack([np.cos(phase), np.sin(phase)], axis=-1).astype(np.float32)

    return DelayTables(idx=idx, frac=frac, valid=valid, apod=apod, rot=rot)
