"""Public wrappers for the fused RF -> head CUDA kernels
(csrc/fused_pipeline.cu).

Each wrapper call makes two launches on the current stream: the demod
kernel into an IQ scratch buffer allocated here, then the DAS + head
kernel. The head's global epilogue (normalize, dB, smooth) is not part
of them; the fused lowering in ``repro_torch.core.lowering`` runs it.
A CPU ``rf`` runs the plain version (``fused_ref``); a CUDA ``rf``
launches the kernels or raises.

``bp`` is the DAS loop's pixel tile, the reference's ``fusion_block``:
one of ``PIXEL_TILES`` (None: ``DEFAULT_BP``); any other value raises,
on either device. The plain version does not tile, so on the CPU the
result does not depend on it.

Precondition of the kernels, as for ``das_beamform``: finite ``frac``
and ``rot`` (IQ demodulated from int16 is finite), since the terms of
zero ``apod`` are left out.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.demod import same_pad
from repro_torch.kernels import cuda_lib
from repro_torch.kernels.das_beamform.ops import PRECISION_CODES
from repro_torch.kernels.fused_pipeline.ref import fused_ref

HEAD_CODES = {"bmode": 0, "power_doppler": 1}
# Pixel tiles the DAS loop (csrc/das_common.cuh) is built for in this
# library, and the one it runs unless told otherwise.
PIXEL_TILES = (64, 128, 256)
DEFAULT_BP = 64

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 11 + [_I] * 14 + [_P]


def pixel_tile(bp) -> int:
    """The kernel's pixel tile for ``bp`` (None: the default); raises
    ValueError for a tile it is not built for."""
    if bp is None:
        return DEFAULT_BP
    if isinstance(bp, bool) or bp not in PIXEL_TILES:
        raise ValueError(f"the fused kernel's pixel tile bp must be one of "
                         f"{PIXEL_TILES} (or None), got {bp!r}")
    return bp


def _launch(carrier, lpf, idx, frac, apod, rot, wall, rf, *, decim, head,
            bp, precision):
    if precision not in PRECISION_CODES:
        raise ValueError(f"unknown precision {precision!r}")
    if rf.device.type != "cuda":
        raise ValueError(f"fused kernels run on cuda or cpu, not "
                         f"{rf.device.type}")
    dev = rf.device
    if rf.dim() != 4:
        raise ValueError(f"rf must be (B, n_l, n_c, n_f), got "
                         f"{tuple(rf.shape)}")
    b, n_l, n_c, n_f = rf.shape
    n_pix = idx.shape[0]
    k = lpf.shape[0]
    n_s = -(-n_l // decim)
    pad_lo = same_pad(n_l, k, decim)[0]
    cuda_lib.require(rf, "rf", torch.int16, (b, n_l, n_c, n_f), dev)
    cuda_lib.require(carrier, "carrier", torch.float32, (n_l, 2), dev)
    cuda_lib.require(lpf, "lpf", torch.float32, (k,), dev)
    cuda_lib.require(idx, "idx", torch.int32, (n_pix, n_c), dev)
    cuda_lib.require(frac, "frac", torch.float32, (n_pix, n_c), dev)
    cuda_lib.require(apod, "apod", torch.float32, (n_pix, n_c), dev)
    cuda_lib.require(rot, "rot", torch.float32, (n_pix, n_c, 2), dev)
    bf = None
    if head == "power_doppler":
        n_wall = wall.shape[0]
        cuda_lib.require(wall, "wall", torch.float32, (n_wall,), dev)
        if not 1 <= n_wall <= n_f:
            raise ValueError(f"power head needs 1 <= wall taps ({n_wall}) "
                             f"<= n_f ({n_f})")
        out = torch.empty((b, n_pix), dtype=torch.float32, device=dev)
        wall_ptr = wall.data_ptr()
        # the beamformed samples, where n_f is past the one-pass head's
        scratch = cuda_lib.kernel_fn(
            "fused_pipeline", "fused_power_scratch_floats", [_I] * 3,
            restype=ctypes.c_longlong)(b, n_pix, n_f)
        if scratch:
            bf = torch.empty(scratch, dtype=torch.float32, device=dev)
    else:
        n_wall = 1
        out = torch.empty((b, n_pix, n_f), dtype=torch.float32, device=dev)
        wall_ptr = None
    iq = torch.empty((b, n_s, n_c, n_f, 2), dtype=torch.float32, device=dev)
    fn = cuda_lib.kernel_fn("fused_pipeline", "fused_pipeline_launch",
                            _ARGTYPES)
    rc = fn(rf.data_ptr(), carrier.data_ptr(), lpf.data_ptr(),
            idx.data_ptr(), frac.data_ptr(), apod.data_ptr(), rot.data_ptr(),
            wall_ptr, iq.data_ptr(), None if bf is None else bf.data_ptr(),
            out.data_ptr(), b, n_l, n_c, n_f, n_s, k, decim, pad_lo, n_pix,
            n_wall, HEAD_CODES[head], bp, PRECISION_CODES[precision],
            dev.index, cuda_lib.stream_of(dev))
    cuda_lib.check_launch(rc, f"fused_pipeline[{head}]")
    return out


def fused_rf_to_envelope(carrier, lpf, idx, frac, apod, rot, rf, *,
                         decim: int, bp=None, precision: str = "f32"):
    """Fused RF -> B-mode envelope (demod + DAS beamform + |z|).

    Args:
      carrier: (n_l, 2) f32 demod carrier (2cos / -2sin).
      lpf:  (taps,) f32 decimating FIR.
      idx / frac / apod / rot: the (n_pix, n_c[, 2]) delay tables.
      rf:   (B, n_l, n_c, n_f) int16 RF (the plain version takes any
        real dtype).
      bp:   pixel tile of the DAS loop, in PIXEL_TILES (None: DEFAULT_BP).
      precision: "f32" | "bf16" | "f16" operand rounding, f32 accumulate.
    Returns:
      (B, n_pix, n_f) f32 envelope — feed core.bmode.compress_envelope.
    """
    bp = pixel_tile(bp)
    if rf.device.type == "cpu":
        return fused_ref(carrier, lpf, idx, frac, apod, rot, rf,
                         decim=decim, head="bmode", precision=precision)
    out = _launch(carrier, lpf, idx, frac, apod, rot, None, rf, decim=decim,
                  head="bmode", bp=bp, precision=precision)
    fused_rf_to_envelope.launches += 1
    return out


def fused_rf_to_power(carrier, lpf, idx, frac, apod, rot, wall, rf, *,
                      decim: int, bp=None, precision: str = "f32"):
    """Fused RF -> power-Doppler R0 (demod + DAS + wall filter + power).

    Same arguments as `fused_rf_to_envelope`, plus ``wall``: the (kw,)
    f32 wall-filter taps. Returns (B, n_pix) f32 R0 — feed
    core.doppler.power_compress.
    """
    bp = pixel_tile(bp)
    if rf.device.type == "cpu":
        return fused_ref(carrier, lpf, idx, frac, apod, rot, rf,
                         decim=decim, head="power_doppler", wall=wall,
                         precision=precision)
    out = _launch(carrier, lpf, idx, frac, apod, rot, wall, rf, decim=decim,
                  head="power_doppler", bp=bp, precision=precision)
    fused_rf_to_power.launches += 1
    return out


# Wrapper calls that launched the kernels since the last reset (each is
# two CUDA launches: demod, then DAS + head).
fused_rf_to_envelope.launches = 0
fused_rf_to_power.launches = 0
