"""Plain PyTorch versions of the BSR SpMM kernels.

``bsr_spmm_ref`` is the real primitive: gather the sample blocks named by
``cols``, one dense (bp x bs) product per stored block, sum over K.
``bsr_beamform_ref`` is the complex multi-channel beamform (the
reference's channel ``vmap`` of four real SpMMs) with a leading
acquisition axis; it walks the channels and accumulates, so it holds one
channel's gathered IQ at a time. ``precision`` rounds both operands to
bf16/f16 before the f32 arithmetic, which is what the CUDA kernel does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.das_beamform.ref import round_to


def bsr_spmm_ref(cols, blocks, x, *, precision: str = "f32"):
    """y[i] = sum_k blocks[i,k] @ x[cols[i,k]].

    cols (n_pb, K) int; blocks (n_pb, K, bp, bs); x (n_sb, bs, nf).
    Returns (n_pb, bp, nf) f32.
    """
    g = round_to(x, precision)[cols.long()]              # (n_pb, K, bs, nf)
    return torch.einsum("ikps,iksf->ipf", round_to(blocks, precision), g)


def bsr_beamform_ref(cols, blocks, iq_b, *, precision: str = "f32"):
    """Complex beamform summed over channels.

    cols (n_c, n_pb, K) int; blocks (n_c, n_pb, K, bp, bs, 2);
    iq_b (B, n_sb, bs, n_c, n_f, 2) blocked IQ.
    Returns (B, n_pb * bp, n_f, 2) f32.
    """
    n_c, n_pb, _, bp, _, _ = blocks.shape
    b, _, _, _, n_f, _ = iq_b.shape
    y = iq_b.new_zeros((b, n_pb, bp, n_f, 2))
    for c in range(n_c):
        x = round_to(iq_b[:, :, :, c], precision)   # (B, n_sb, bs, n_f, 2)
        g = x[:, cols[c].long()]                    # (B, n_pb, K, bs, n_f, 2)
        blk = round_to(blocks[c], precision)        # (n_pb, K, bp, bs, 2)
        a = torch.einsum("ikps,biksfr->bipfr", blk[..., 0], g)
        d = torch.einsum("ikps,biksfr->bipfr", blk[..., 1], g)
        y += torch.stack([a[..., 0] - d[..., 1], a[..., 1] + d[..., 0]], -1)
    return y.reshape(b, n_pb * bp, n_f, 2)
