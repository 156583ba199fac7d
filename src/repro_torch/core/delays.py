"""Delay-and-sum geometry tables (numpy; precomputed, excluded from timing).

Plane-wave (0 deg) transmit, dynamic-aperture receive:

  tau(p, c) = ( z_p + sqrt(z_p^2 + (x_p - x_c)^2) ) / c_sound

The IQ-domain DAS interpolates the decimated IQ signal at s = tau * fs_iq
and applies the phase rotation exp(+j 2 pi f0 tau).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.core import geometry
from repro_torch.core.config import UltrasoundConfig


@dataclasses.dataclass(frozen=True)
class DelayTables:
    """Per (pixel, channel) gather/interp/apodization/rotation constants.

    idx   : (n_pix, n_c) int32 — floor sample index into IQ axis (clamped)
    frac  : (n_pix, n_c) f32   — linear interpolation fraction in [0, 1)
    valid : (n_pix, n_c) f32   — 1.0 where the delay lands inside the trace
    apod  : (n_pix, n_c) f32   — dynamic-aperture Hann apodization (masked)
    rot   : (n_pix, n_c, 2) f32 — unit phasor exp(+j 2 pi f0 tau) as (re, im)
    """

    idx: np.ndarray
    frac: np.ndarray
    valid: np.ndarray
    apod: np.ndarray
    rot: np.ndarray


def compute_delay_tables(cfg: UltrasoundConfig) -> DelayTables:
    zp, xp = geometry.flat_grid(cfg)                       # (n_pix,)
    xc = geometry.element_positions(cfg)                   # (n_c,)

    dz = zp[:, None]                                       # (n_pix, 1)
    dx = xp[:, None] - xc[None, :]                         # (n_pix, n_c)
    tau = (dz + np.sqrt(dz * dz + dx * dx)) / cfg.c_sound  # (n_pix, n_c)

    s = tau * cfg.fs_iq
    idx = np.floor(s).astype(np.int64)
    frac = (s - idx).astype(np.float32)
    valid = ((idx >= 0) & (idx < cfg.n_s - 1)).astype(np.float32)
    idx = np.clip(idx, 0, cfg.n_s - 2).astype(np.int32)

    half_aperture = dz / (2.0 * cfg.f_number)              # (n_pix, 1)
    rel = np.clip(np.abs(dx) / np.maximum(half_aperture, 1e-9), 0.0, 1.0)
    apod = (0.5 + 0.5 * np.cos(np.pi * rel)).astype(np.float32)
    apod *= (np.abs(dx) <= half_aperture).astype(np.float32)
    apod *= valid
    norm = apod.sum(axis=1, keepdims=True)
    apod = (apod / np.maximum(norm, 1e-9)).astype(np.float32)

    phase = 2.0 * np.pi * cfg.f0 * tau
    rot = np.stack([np.cos(phase), np.sin(phase)], axis=-1).astype(np.float32)

    return DelayTables(idx=idx, frac=frac, valid=valid, apod=apod, rot=rot)


def _taps(tables: DelayTables, c: int):
    """Channel ``c``'s two interpolation taps per pixel, in the reference's
    float32 arithmetic: rows at samples ``idx`` and ``idx + 1``, values
    (n_pix, 2) complex as (re, im)."""
    w = tables.apod[:, c]
    re = tables.rot[:, c, 0] * w
    im = tables.rot[:, c, 1] * w
    i0 = tables.idx[:, c]
    f = tables.frac[:, c]
    return ((i0, np.stack([re * (1.0 - f), im * (1.0 - f)], axis=-1)),
            (i0 + 1, np.stack([re * f, im * f], axis=-1)))


def interp_matrix(cfg: UltrasoundConfig, tables: DelayTables) -> np.ndarray:
    """The DAS operator as a dense complex (n_c, n_pix, n_s, 2) tensor
    (the cnn variant's one-hot interpolation operator):

        M[c, p, s] = apod * rot * ((1-frac) [s == idx] + frac [s == idx+1])
    """
    M = np.zeros((cfg.n_c, cfg.n_pix, cfg.n_s, 2), dtype=np.float32)
    rows = np.arange(cfg.n_pix)
    for c in range(cfg.n_c):
        for s, v in _taps(tables, c):
            # 0 + v, as the reference's scatter-add: -0.0 lands as +0.0
            np.add.at(M[c], (rows, s), v)
    return M


@dataclasses.dataclass(frozen=True)
class BsrOperator:
    """Banded block-sparse row (BSR) form of the DAS operator, per channel
    (the sparse variant).

    blocks  : (n_c, n_pb, K, bp, bs, 2) f32 — the occupied (bp x bs)
              blocks of each pixel block, complex as (re, im)
    col_idx : (n_c, n_pb, K) int32 — sample-block column of each block,
              ascending; unused K slots are all-zero blocks at column 0
    nnz_ratio: stored / dense block count
    """

    blocks: np.ndarray
    col_idx: np.ndarray
    bp: int
    bs: int
    nnz_ratio: float


def bsr_operator(cfg: UltrasoundConfig, tables: DelayTables) -> BsrOperator:
    """The reference's BSR operator, bit for bit, built from the taps.

    The reference pads the dense operator (2.8 GB at the paper's
    geometry) and scans its blocks; a block is occupied when any tap in
    it is non-zero. This places the two taps of every (channel, pixel)
    straight into their blocks, so the host holds only the result.
    """
    bp, bs = cfg.sparse_block_p, cfg.sparse_block_s
    n_c, n_pix = cfg.n_c, cfg.n_pix
    n_pb = -(-n_pix // bp)
    n_sb = -(-cfg.n_s // bs)
    pb = np.arange(n_pix) // bp
    taps = []                                   # (c, pixel, sample, value)
    for c in range(n_c):
        for s, v in _taps(tables, c):
            nz = (v != 0).any(axis=-1)
            taps.append((c, np.nonzero(nz)[0], s[nz], v[nz]))
    occupied = np.zeros((n_c, n_pb, n_sb), dtype=bool)
    for c, p, s, _ in taps:
        occupied[c, pb[p], s // bs] = True
    K = max(int(occupied.sum(axis=2).max()), 1)
    slot = np.cumsum(occupied, axis=2) - 1      # K slot of an occupied column
    col_idx = np.zeros((n_c, n_pb, K), dtype=np.int32)
    ci, pi, si = np.nonzero(occupied)
    col_idx[ci, pi, slot[ci, pi, si]] = si
    blocks = np.zeros((n_c, n_pb, K, bp, bs, 2), dtype=np.float32)
    for c, p, s, v in taps:
        blocks[c, pb[p], slot[c, pb[p], s // bs], p % bp, s % bs] = v + 0.0
    nnz_ratio = float(occupied.sum()) / float(n_c * n_pb * n_sb)
    check_skipped_slots(col_idx, blocks)
    return BsrOperator(blocks=blocks, col_idx=col_idx, bp=bp, bs=bs,
                       nnz_ratio=nnz_ratio)


def check_skipped_slots(col_idx, blocks) -> None:
    """Raise ValueError unless every K slot that ``bsr_beamform``'s kernel
    skips holds an all-zero block.

    The kernel keeps slot 0 and each slot k > 0 whose column is above
    slot k - 1's (``kernels.bsr_spmm.kept_slots``); the plain version,
    which CPU tensors run, sums every slot. The two agree exactly when
    the skipped blocks are zero, as ``bsr_operator``'s format makes them.
    Takes numpy arrays or tensors on any device: the counts are taken
    where the operator lies, a channel at a time, and read back once.
    """
    with warnings.catch_warnings():   # read only: a read-only array is fine
        warnings.filterwarnings("ignore", message=".*not writable")
        cols = torch.as_tensor(col_idx)
        blocks = torch.as_tensor(blocks)
    if cols.shape[0] == 0:
        return
    skipped = torch.zeros_like(cols, dtype=torch.bool)
    skipped[..., 1:] = cols[..., 1:] <= cols[..., :-1]
    counts = torch.stack([torch.count_nonzero(blocks[c][skipped[c]])
                          for c in range(cols.shape[0])]).tolist()
    for c, bad in enumerate(counts):
        if bad:
            raise ValueError(
                f"BSR operator: channel {c} holds {bad} non-zero values in "
                "K slots that bsr_beamform's kernel skips (a column not "
                "above the slot before it); the kernel would drop them")
