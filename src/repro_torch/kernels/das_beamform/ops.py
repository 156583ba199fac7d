"""Public wrapper for the DAS beamform CUDA kernel (csrc/das_beamform.cu)."""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.das_beamform.ref import das_beamform_ref

PRECISION_CODES = {"f32": 0, "bf16": 1, "f16": 2}

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 7 + [_P]


def tile_plan() -> dict:
    """The tile the kernel library is built for (it builds the library,
    so it needs nvcc): ``bp`` pixels per tile, ``block_acqs``
    acquisitions per thread block and ``stage_rows`` IQ rows (one
    channel's frames of one sample) per stage buffer; a channel whose
    window x acquisitions exceeds ``stage_rows`` is read from global
    memory instead."""
    fn = cuda_lib.kernel_fn("das_beamform", "das_tile_plan",
                            [ctypes.POINTER(_I)] * 3, restype=None)
    vals = [_I() for _ in range(3)]
    fn(*map(ctypes.byref, vals))
    return dict(zip(("bp", "block_acqs", "stage_rows"),
                    (v.value for v in vals)))


def das_beamform(idx, frac, apod, rot, iq, *, precision: str = "f32"):
    """Delay-and-sum beamform of a batch of acquisitions.

    Args:
      idx:  (n_pix, n_c) int32 floor sample indices (clamped to n_s - 2).
      frac: (n_pix, n_c) f32 interpolation fractions.
      apod: (n_pix, n_c) f32 apodization.
      rot:  (n_pix, n_c, 2) f32 unit phasors.
      iq:   (B, n_s, n_c, n_f, 2) f32.
      precision: "f32" | "bf16" | "f16" — the IQ samples and lerp weights
        are rounded to it; accumulation is f32.
    Returns:
      (B, n_pix, n_f, 2) f32. A CPU ``iq`` runs the plain version
      (``das_beamform_ref``); a CUDA ``iq`` launches the kernel or raises.

    Precondition of the kernel: ``iq``, ``frac`` and ``rot`` are finite.
    It leaves out the terms whose ``apod`` is exactly 0 (skipped, or
    multiplied by 0 from a sample of another pixel's window), which is
    exact only then (the plain version adds 0 * inf = nan there); IQ
    demodulated from int16 RF is always finite.
    """
    if precision not in PRECISION_CODES:
        raise ValueError(f"unknown precision {precision!r}")
    if iq.device.type == "cpu":
        return das_beamform_ref(idx, frac, apod, rot, iq,
                                precision=precision)
    if iq.device.type != "cuda":
        raise ValueError(f"das_beamform runs on cuda or cpu, not "
                         f"{iq.device.type}")
    dev = iq.device
    if iq.dim() != 5 or iq.shape[-1] != 2:
        raise ValueError(f"iq must be (B, n_s, n_c, n_f, 2), got "
                         f"{tuple(iq.shape)}")
    b, n_s, n_c, n_f, _ = iq.shape
    n_pix = idx.shape[0]
    cuda_lib.require(iq, "iq", torch.float32, (b, n_s, n_c, n_f, 2), dev)
    cuda_lib.require(idx, "idx", torch.int32, (n_pix, n_c), dev)
    cuda_lib.require(frac, "frac", torch.float32, (n_pix, n_c), dev)
    cuda_lib.require(apod, "apod", torch.float32, (n_pix, n_c), dev)
    cuda_lib.require(rot, "rot", torch.float32, (n_pix, n_c, 2), dev)
    out = torch.empty((b, n_pix, n_f, 2), dtype=torch.float32, device=dev)
    fn = cuda_lib.kernel_fn("das_beamform", "das_beamform_launch",
                            _ARGTYPES)
    rc = fn(idx.data_ptr(), frac.data_ptr(), apod.data_ptr(),
            rot.data_ptr(), iq.data_ptr(), out.data_ptr(), b, n_pix, n_c,
            n_s, n_f, PRECISION_CODES[precision], dev.index,
            cuda_lib.stream_of(dev))
    cuda_lib.check_launch(rc, "das_beamform")
    das_beamform.launches += 1
    return out


das_beamform.launches = 0   # kernel launches since the last reset
