"""Plain PyTorch version of the fused RF -> envelope / R0 kernel.

Demod (mix + decimating SAME FIR, taps ascending) + dynamic DAS + the
head's tile-local half, with a leading batch axis. ``precision`` rounds
the FIR and interpolation operands (taps, mixed RF, IQ samples, lerp
weights) as the CUDA kernel does; at f32 every cast is the identity and
this is the composition of the port's per-stage plain functions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.cnn_ops import sqrt_rn
from repro_torch.core.demod import same_pad
from repro_torch.kernels.das_beamform.ref import das_beamform_ref, round_to


def demod_ref(carrier, lpf, rf, decim, *, precision: str = "f32"):
    """(B, n_l, n_c, n_f) RF -> (B, n_s, n_c, n_f, 2) IQ."""
    n_l = rf.shape[1]
    mixed = rf.to(torch.float32)[..., None] * carrier[:, None, None, :]
    mixed = round_to(mixed, precision)
    k = lpf.shape[0]
    lo, hi = same_pad(n_l, k, decim)
    m = F.pad(mixed, (0, 0, 0, 0, 0, 0, lo, hi))
    n_s = -(-n_l // decim)
    taps = round_to(lpf, precision)
    acc = torch.zeros(mixed.shape[:1] + (n_s,) + mixed.shape[2:],
                      dtype=torch.float32, device=rf.device)
    for t in range(k):  # ascending tap order — the demod contract
        acc = acc + taps[t] * m[:, t:t + (n_s - 1) * decim + 1:decim]
    return acc


def fused_ref(carrier, lpf, idx, frac, apod, rot, rf, *, decim,
              head: str = "bmode", wall=None, precision: str = "f32"):
    """RF -> (B, n_pix, n_f) envelope or (B, n_pix) R0."""
    iq = demod_ref(carrier, lpf, rf, decim, precision=precision)
    bf = das_beamform_ref(idx, frac, apod, rot, iq, precision=precision)
    if head == "bmode":
        return sqrt_rn(bf[..., 0] ** 2 + bf[..., 1] ** 2)
    if head != "power_doppler":
        raise ValueError(f"unsupported fused head: {head!r}")
    k = wall.shape[0]
    n_fp = bf.shape[2] - k + 1
    z = torch.zeros(bf.shape[:2] + (n_fp, 2), dtype=torch.float32,
                    device=bf.device)
    for t in range(k):  # ascending tap order — the wall-filter contract
        z = z + wall[t] * bf[:, :, t:t + n_fp, :]
    return (z[..., 0] ** 2 + z[..., 1] ** 2).sum(dim=2)
