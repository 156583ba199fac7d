"""Doppler heads: colour (lag-1 autocorrelation) and power (PyTorch).

Colour: wall filter along frames -> R1 = sum_f z[f+1] conj(z[f]) ->
atan2 -> spatial smooth. Power: wall filter -> R0 = sum_f |z[f]|^2 ->
10 log10 -> dynamic-range scale -> spatial smooth. Every function takes a
leading batch axis; normalization is per acquisition.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import cnn_ops
from repro_torch.core.config import UltrasoundConfig


def wall_filter_taps(cfg: UltrasoundConfig) -> np.ndarray:
    """Binomial high-pass FIR: (n-1)-fold convolution of [1, -1]."""
    taps = np.array([1.0], dtype=np.float64)
    for _ in range(max(cfg.wall_filter_taps - 1, 1)):
        taps = np.convolve(taps, [1.0, -1.0])
    taps /= np.sqrt((taps ** 2).sum())
    return taps.astype(np.float32)


def smoothing_kernel(cfg: UltrasoundConfig) -> np.ndarray:
    k = cfg.smooth_kernel
    return np.full((k, k), 1.0 / (k * k), dtype=np.float32)


def apply_wall_filter(consts, bf: torch.Tensor) -> torch.Tensor:
    """(B, n_pix, n_f, 2) -> (B, n_pix, n_f', 2) FIR high-pass along frames.

    VALID along frames; explicitly ordered shift-and-add with ascending
    taps — the order the fused kernel reproduces.
    """
    taps = consts["wall_taps"]
    k = taps.shape[0]
    n_fp = bf.shape[2] - k + 1
    acc = torch.zeros(bf.shape[:2] + (n_fp, 2), dtype=torch.float32,
                      device=bf.device)
    for t in range(k):
        acc = acc + taps[t] * bf[:, :, t:t + n_fp, :]
    return acc


def _smooth(cfg: UltrasoundConfig, consts, img: torch.Tensor) -> torch.Tensor:
    """(B, nz, nx) -> (B, nz, nx) box smoothing, SAME padding (2-D conv).

    TF32 must be off for this conv on the card (repro_torch sets it).
    """
    k = consts["smooth"]                              # (k, k)
    lo_h, hi_h = _same(k.shape[0])
    lo_w, hi_w = _same(k.shape[1])
    x = F.pad(img[:, None], (lo_w, hi_w, lo_h, hi_h))
    return F.conv2d(x, k[None, None])[:, 0]


def _same(k: int):
    lo = (k - 1) // 2
    return lo, k - 1 - lo


def color_doppler_image(cfg: UltrasoundConfig, consts,
                        bf: torch.Tensor) -> torch.Tensor:
    """(B, n_pix, n_f, 2) -> (B, nz, nx) velocity map in [-1, 1]."""
    z = apply_wall_filter(consts, bf)
    z0, z1 = z[:, :, :-1], z[:, :, 1:]
    re = (z1[..., 0] * z0[..., 0] + z1[..., 1] * z0[..., 1]).sum(dim=2)
    im = (z1[..., 1] * z0[..., 0] - z1[..., 0] * z0[..., 1]).sum(dim=2)
    if cfg.cnn_transcendentals:
        phase = cnn_ops.atan2_approx(im, re)
    else:
        phase = torch.atan2(im, re)
    v = phase / np.pi
    return _smooth(cfg, consts, v.reshape(-1, cfg.nz, cfg.nx))


def power_from_ensemble(consts, bf: torch.Tensor) -> torch.Tensor:
    """(B, n_pix, n_f, 2) -> (B, n_pix) wall-filtered power R0."""
    z = apply_wall_filter(consts, bf)
    return cnn_ops.cabs2(z).sum(dim=2)


def power_compress(cfg: UltrasoundConfig, consts,
                   r0: torch.Tensor) -> torch.Tensor:
    """(B, n_pix) R0 -> (B, nz, nx) power map in [0, 1]."""
    r0 = cnn_ops.normalize_by_max(r0, dim=1)
    if cfg.cnn_transcendentals:
        db = 10.0 * cnn_ops.log10_approx(r0)
    else:
        db = 10.0 * torch.log10(torch.clamp(r0, min=1e-30))
    dr = cfg.dynamic_range_db
    img = (cnn_ops.clip(db, -dr, 0.0) + dr) / dr
    return _smooth(cfg, consts, img.reshape(-1, cfg.nz, cfg.nx))


def power_doppler_image(cfg: UltrasoundConfig, consts,
                        bf: torch.Tensor) -> torch.Tensor:
    """(B, n_pix, n_f, 2) -> (B, nz, nx) power map in [0, 1]."""
    return power_compress(cfg, consts, power_from_ensemble(consts, bf))
