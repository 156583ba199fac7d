"""Deterministic CNN-expressible primitive operations (PyTorch).

The same catalogue as the reference package: every function is a fixed
composition of pointwise arithmetic, sqrt and reductions, with the
reference's expression order, so each op rounds like its counterpart.
Complex values stay in a trailing (re, im) axis; no complex dtypes.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Arithmetic control flow
# ---------------------------------------------------------------------------


def select(mask, a, b):
    """mask ? a : b as pure arithmetic. mask must be 0/1 valued (float)."""
    return mask * a + (1.0 - mask) * b


def ge_mask(x, y):
    """(x >= y) as a {0,1} float32 tensor. Either side may be a scalar."""
    x = torch.as_tensor(x)
    return (x >= y).to(torch.float32)


def clip(x, lo, hi):
    """Pointwise clamp via min/max (CNN-compatible saturation)."""
    return torch.clamp(x, min=lo, max=hi)


# ---------------------------------------------------------------------------
# atan / atan2
# ---------------------------------------------------------------------------

# Hastings minimax polynomial for atan(z), |z| <= 1. Max abs error ~1.2e-5.
_ATAN_C1 = 0.9998660
_ATAN_C3 = -0.3302995
_ATAN_C5 = 0.1801410
_ATAN_C7 = -0.0851330
_ATAN_C9 = 0.0208351


def atan_poly(z):
    """atan(z) for |z| <= 1 via odd 9th-order minimax polynomial."""
    z2 = z * z
    return z * (_ATAN_C1 + z2 * (_ATAN_C3 + z2 * (
        _ATAN_C5 + z2 * (_ATAN_C7 + z2 * _ATAN_C9))))


def atan2_approx(y, x, eps: float = 1e-30):
    """Four-quadrant atan2 with bounded error (~1e-4 rad in float32)."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    z = lo / (hi + eps)
    base = atan_poly(z)
    swap = ge_mask(ay, ax)
    ang = select(swap, (np.pi / 2) - base, base)
    xneg = ge_mask(0.0, x) * ge_mask(torch.abs(x), eps)
    ang = select(xneg, np.pi - ang, ang)
    yneg = ge_mask(0.0, y) * ge_mask(torch.abs(y), eps)
    return select(yneg, -ang, ang)


# ---------------------------------------------------------------------------
# Square root
# ---------------------------------------------------------------------------


def sqrt_rn(x):
    """Correctly rounded float32 square root, on every device.

    torch's vectorized CPU sqrt is not correctly rounded (about 0.7 % of
    float32 inputs come out one ulp off), while XLA's and CUDA's are. On
    the CPU the root is therefore taken in float64 and rounded once,
    which is exact for float32 inputs (53 >= 2 * 24 + 2 bits).
    """
    if x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(x.dtype)
    return torch.sqrt(x)


# ---------------------------------------------------------------------------
# Logarithms
# ---------------------------------------------------------------------------


def ln_approx(x, n_sqrt: int = 16, eps: float = 1e-30):
    """ln(x) via k repeated square roots and a Pade-improved remainder.

    The 2^k scale turns one float32 ulp of the last root into a step of
    2^-24 * 2^16 in ln(x), so every root must be correctly rounded.
    """
    y = torch.clamp(x, min=eps)
    for _ in range(n_sqrt):
        y = sqrt_rn(y)
    scale = float(2 ** n_sqrt)
    return scale * (y - 1.0) * 2.0 / (1.0 + y)


_LN10 = float(np.log(10.0))


def log10_approx(x, n_sqrt: int = 16, eps: float = 1e-30):
    return ln_approx(x, n_sqrt=n_sqrt, eps=eps) / _LN10


def db20_approx(x, eps: float = 1e-30):
    """20*log10(x) with CNN-expressible log."""
    return 20.0 * log10_approx(x, eps=eps)


# ---------------------------------------------------------------------------
# Magnitude / normalization
# ---------------------------------------------------------------------------


def magnitude(re, im):
    """|z| = sqrt(re^2 + im^2)."""
    return sqrt_rn(re * re + im * im)


def normalize_by_max(x, dim=None, eps: float = 1e-30):
    """x / max(x) over ``dim`` (an int or tuple; None = every axis)."""
    if dim is None:
        m = torch.amax(x)
    else:
        m = torch.amax(x, dim=dim, keepdim=True)
    return x / (m + eps)


# ---------------------------------------------------------------------------
# Complex arithmetic on (..., 2) real tensors
# ---------------------------------------------------------------------------


def cpack(re, im):
    return torch.stack([re, im], dim=-1)


def creal(z):
    return z[..., 0]


def cimag(z):
    return z[..., 1]


def cmul(a, b):
    """(a_re + i a_im) * (b_re + i b_im) — four pointwise multiplies."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return cpack(ar * br - ai * bi, ar * bi + ai * br)


def cconj(z):
    return cpack(z[..., 0], -z[..., 1])


def cabs2(z):
    return z[..., 0] ** 2 + z[..., 1] ** 2
