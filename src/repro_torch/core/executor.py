"""Batched stage-graph executor (PyTorch port).

`BatchedExecutor` plans once, builds the constants on its device once,
and runs (B, n_l, n_c, n_f) RF batches through the stage graph with the
batch as a leading tensor axis. ``cfg.exec_map == "map"`` runs the rows
one at a time instead (constant memory, serial latency). Work is queued
on the device's current stream; results are tensors on the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.config import UltrasoundConfig
from repro_torch.core.pipeline import (_plan, consts_from_numpy,
                                       init_pipeline, pipeline_fn,
                                       resolve_device)


def _pad_rows(rf_batch, pad_to: int) -> tuple:
    """Zero-pad a ragged batch up to ``pad_to`` rows; returns (batch, b).

    Pad rows are zeros; every head normalizes per acquisition, so they
    never influence the valid rows, which callers slice back out.
    """
    b = rf_batch.shape[0]
    if b < 1:
        raise ValueError("empty RF batch")
    if b > pad_to:
        raise ValueError(f"batch of {b} exceeds pad_to={pad_to}")
    if b == pad_to:
        return rf_batch, b
    if isinstance(rf_batch, np.ndarray):
        fill = np.zeros((pad_to - b,) + rf_batch.shape[1:], rf_batch.dtype)
        return np.concatenate([rf_batch, fill]), b
    fill = rf_batch.new_zeros((pad_to - b,) + tuple(rf_batch.shape[1:]))
    return torch.cat([rf_batch, fill]), b


class BatchedExecutor:
    """Init once, run (B, n_l, n_c, n_f) batches many times."""

    def __init__(self, cfg: UltrasoundConfig, *,
                 policy: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.plan = _plan(cfg, policy, self.device.type)
        self.cfg = self.plan.concretize(cfg)
        self.consts = consts_from_numpy(init_pipeline(self.cfg), self.device)
        self._fn = pipeline_fn(self.cfg, self.device.type)

    def __call__(self, rf_batch) -> torch.Tensor:
        """(B, n_l, n_c, n_f) RF batch (numpy or tensor) -> (B, *image)."""
        x = torch.as_tensor(rf_batch).to(self.device)
        if self.cfg.exec_map == "map":
            return torch.cat([self._fn(self.consts, x[i:i + 1])
                              for i in range(x.shape[0])])
        return self._fn(self.consts, x)

    def call_padded(self, rf_batch, pad_to: int) -> torch.Tensor:
        """Fixed-shape dispatch of a ragged batch (B <= pad_to rows): pads
        to ``pad_to`` rows and slices the valid rows off the result."""
        rf_batch, b = _pad_rows(rf_batch, pad_to)
        out = self(rf_batch)
        return out[:b] if b != pad_to else out
