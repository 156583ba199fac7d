"""RF -> IQ quadrature demodulation (PyTorch, leading batch axis).

1. pointwise mix with the precomputed carrier (2cos / -2sin at f0),
2. FIR low-pass + decimation as an explicitly ordered shift-and-add with
   SAME padding. The taps are added in ascending order: that order is
   the contract every lowering (and the CUDA demod) reproduces, so no
   ``conv1d`` here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.config import UltrasoundConfig


def design_lowpass(cfg: UltrasoundConfig) -> np.ndarray:
    """Hamming-windowed sinc FIR, cutoff = lpf_cutoff * f0 (one-sided)."""
    n = cfg.lpf_taps
    assert n % 2 == 1, "FIR length must be odd for linear phase"
    fc = cfg.lpf_cutoff * cfg.f0 / cfg.fs
    m = np.arange(n) - (n - 1) / 2.0
    h = 2 * fc * np.sinc(2 * fc * m)
    h *= np.hamming(n)
    h /= h.sum()
    return h.astype(np.float32)


def demod_consts(cfg: UltrasoundConfig) -> Dict[str, np.ndarray]:
    t = np.arange(cfg.n_l, dtype=np.float64) / cfg.fs
    ph = 2.0 * np.pi * cfg.f0 * t
    carrier = np.stack([2.0 * np.cos(ph), -2.0 * np.sin(ph)], axis=-1)
    return {
        "carrier": carrier.astype(np.float32),      # (n_l, 2)
        "lpf": design_lowpass(cfg),                 # (taps,)
    }


def same_pad(length: int, k: int, stride: int):
    """TF-style SAME padding for output length ceil(length / stride)."""
    out = -(-length // stride)
    total = max((out - 1) * stride + k - length, 0)
    lo = total // 2
    return (lo, total - lo)


def rf_to_iq(consts: Dict[str, torch.Tensor], rf: torch.Tensor,
             decim: int) -> torch.Tensor:
    """(B, n_l, n_c, n_f) RF -> (B, n_s, n_c, n_f, 2) IQ, n_s = ceil(n_l/decim)."""
    n_l = rf.shape[1]
    x = rf.to(torch.float32)
    mixed = x[..., None] * consts["carrier"][:, None, None, :]

    lpf = consts["lpf"]
    k = lpf.shape[0]
    pad_lo, pad_hi = same_pad(n_l, k, decim)
    m = F.pad(mixed, (0, 0, 0, 0, 0, 0, pad_lo, pad_hi))
    n_s = -(-n_l // decim)
    acc = torch.zeros(mixed.shape[:1] + (n_s,) + mixed.shape[2:],
                      dtype=torch.float32, device=rf.device)
    for t in range(k):  # ascending tap order is the contract
        acc = acc + lpf[t] * m[:, t:t + (n_s - 1) * decim + 1:decim]
    return acc
