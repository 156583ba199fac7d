"""Plain PyTorch version of the DAS beamform kernel (leading batch axis).

Gather at ``idx`` and ``idx + 1``, lerp by ``frac``, rotate by ``rot``,
scale by ``apod`` — in the reference's expression order — then one sum
over channels. ``precision`` rounds the two IQ samples and the two lerp
weights to bf16/f16 before the f32 arithmetic, which is what the CUDA
kernel does with its operands.
"""

from __future__ import annotations

import torch

_CAST = {"f32": None, "bf16": torch.bfloat16, "f16": torch.float16}


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """Round f32 values to ``precision`` and back to f32 (identity at f32)."""
    dtype = _CAST[precision]
    return x if dtype is None else x.to(dtype).to(torch.float32)


def das_beamform_ref(idx, frac, apod, rot, iq, *, precision: str = "f32"):
    """(n_pix, n_c) tables + (B, n_s, n_c, n_f, 2) IQ -> (B, n_pix, n_f, 2)."""
    b, n_s, n_c, n_f, _ = iq.shape
    n_pix = idx.shape[0]
    chan = torch.arange(n_c, device=iq.device)
    flat = (idx.to(torch.int64) * n_c + chan).reshape(-1)   # (n_pix*n_c,)
    rows = iq.reshape(b, n_s * n_c, n_f, 2)
    s0 = rows.index_select(1, flat).reshape(b, n_pix, n_c, n_f, 2)
    s1 = rows.index_select(1, flat + n_c).reshape(b, n_pix, n_c, n_f, 2)
    f = frac[:, :, None, None]
    w0 = round_to(1.0 - f, precision)
    w1 = round_to(f, precision)
    v = round_to(s0, precision) * w0 + round_to(s1, precision) * w1
    r = rot[:, :, None, :]
    re = v[..., 0] * r[..., 0] - v[..., 1] * r[..., 1]
    im = v[..., 0] * r[..., 1] + v[..., 1] * r[..., 0]
    per_c = torch.stack([re, im], dim=-1) * apod[:, :, None, None]
    return per_c.sum(dim=2)
