"""Plain PyTorch version of the SSD scan: the step-by-step recurrence of
the reference's ``ssd_scan_ref``,

    h_t = exp(la_t) h_{t-1} + B_t x_t^T        h in R^{N x P}
    y_t = C_t^T h_t

with a leading batch axis and the heads side by side."""

from __future__ import annotations

import torch


def ssd_scan_ref(log_a, x, b, c):
    """log_a (B, L, H); x (B, L, H, P); b, c (B, L, N), shared by every
    head. Returns y (B, L, H, P) f32."""
    bsz, L, H, P = x.shape
    la, x = log_a.float(), x.float()
    b, c = b.float(), c.float()
    h = x.new_zeros((bsz, H, b.shape[-1], P))
    y = x.new_empty((bsz, L, H, P))
    for t in range(L):
        h = (torch.exp(la[:, t])[..., None, None] * h
             + b[:, t, None, :, None] * x[:, t, :, None, :])
        y[:, t] = torch.einsum("bn,bhnp->bhp", c[:, t], h)
    return y
