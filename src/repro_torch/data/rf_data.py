"""Synthetic RF data generator (numpy; byte-identical to the reference's).

Point scatterers insonified by a 0-degree plane wave, sampled with the
pipeline geometry, plus slow-time motion so Doppler estimates are
non-trivial. Deterministic given the seed.
"""

from __future__ import annotations

import functools

import numpy as np

from repro_torch.core import geometry
from repro_torch.core.config import UltrasoundConfig


def synth_rf(cfg: UltrasoundConfig, seed: int = 0, n_scatter: int = 24,
             flow_fraction: float = 0.5, flow_speed: float = 0.1,
             ) -> np.ndarray:
    """Return RF of shape (n_l, n_c, n_f), dtype cfg.rf_dtype.

    flow_speed is an axial displacement per frame in wavelengths; a
    fraction of scatterers move (blood), the rest are static (tissue).
    """
    rng = np.random.default_rng(seed)
    xc = geometry.element_positions(cfg)                    # (n_c,)
    lam = cfg.c_sound / cfg.f0

    half_ap = (cfg.n_c - 1) / 2.0 * cfg.pitch
    zs = rng.uniform(cfg.z_min, cfg.z_max, n_scatter)
    xs = rng.uniform(-half_ap, half_ap, n_scatter)
    amp = rng.uniform(0.3, 1.0, n_scatter)
    moving = (np.arange(n_scatter) < int(flow_fraction * n_scatter))

    t = np.arange(cfg.n_l) / cfg.fs                         # (n_l,)
    sigma = 1.0 / cfg.f0                                    # 2-cycle pulse

    rf = np.zeros((cfg.n_l, cfg.n_c, cfg.n_f), dtype=np.float64)
    for f in range(cfg.n_f):
        dz = np.where(moving, flow_speed * lam * f, 0.0)
        z_f = zs + dz
        d_rx = np.sqrt(z_f[None, :] ** 2 +
                       (xs[None, :] - xc[:, None]) ** 2)    # (n_c, ns)
        tof = (z_f[None, :] + d_rx) / cfg.c_sound           # (n_c, ns)
        arg = t[:, None, None] - tof[None, :, :]            # (n_l, n_c, ns)
        pulse = np.exp(-0.5 * (arg / sigma) ** 2) * np.cos(
            2 * np.pi * cfg.f0 * arg)
        rf[:, :, f] = (pulse * amp[None, None, :]).sum(axis=-1)

    rf += 1e-3 * rng.standard_normal(rf.shape)
    if cfg.rf_dtype == "int16":
        scale = 30000.0 / max(np.abs(rf).max(), 1e-9)
        return (rf * scale).astype(np.int16)
    return rf.astype(np.float32)


# Config fields that choose the program, not the acquisition: `synth_rf`
# reads none of them.
_PROGRAM_AXES = ("variant", "modality", "exec_map", "stage_lowerings",
                 "fusion", "precision", "fusion_block")


@functools.lru_cache(maxsize=32)
def _shared_rf(cfg: UltrasoundConfig, seed: int) -> np.ndarray:
    rf = synth_rf(cfg, seed=seed)
    rf.flags.writeable = False
    return rf


def shared_rf(cfg: UltrasoundConfig, seed: int = 0) -> np.ndarray:
    """``synth_rf(cfg, seed=seed)``, made once per process for each
    acquisition geometry and seed (a paper-geometry acquisition takes
    seconds): the scheduler's tenants and the planner's probes of one
    geometry share it, whatever their variant, modality or lowerings.
    Read-only, since every caller gets the same array."""
    base = UltrasoundConfig()
    return _shared_rf(cfg.with_(**{f: getattr(base, f)
                                   for f in _PROGRAM_AXES}), seed)
