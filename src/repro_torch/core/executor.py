"""Batched stage-graph executor (PyTorch port).

`BatchedExecutor` plans once, builds the constants on its device once,
and runs (B, n_l, n_c, n_f) RF batches through the stage graph with the
batch as a leading tensor axis. ``cfg.exec_map == "map"`` runs the rows
one at a time instead (constant memory, serial latency).

Dispatch granularities, as the reference's executor has them:

  * ``place`` — the host-to-device commit of an already padded batch.
    On the card the copy runs on the executor's own copy stream, from
    pinned memory when the caller staged into it
    (`repro_torch.core.staging.StagingRing`), and an event is recorded
    after it; the call returns at once, with a fresh device tensor.
  * ``dispatch_staged`` — launch only: the compute stream waits on that
    event, then runs the engine — through the CUDA graph that
    `install_aot` pinned for this padded shape, where there is one
    (`repro_torch.core.aot.aot_warm`). Returns the padded output, not
    synchronised.
  * ``dispatch_padded`` = ``dispatch_staged(place(_pad_rows(...)))``;
    ``call_padded`` slices the valid rows off it; ``__call__`` is
    ``dispatch_staged(place(batch))`` at the batch's own size. No path
    copies host memory on the compute stream, so batch i+1's copy
    overlaps batch i's compute.

Cross-stream memory: `place` allocates the device batch on the copy
stream and marks it used by the compute stream (``record_stream``), so
the caching allocator reuses the block only after the compute that read
it is done.

On the CPU there are no streams: `place` copies (the caller's buffer
stays the caller's) and the engine runs when it is called.
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
        self.donate = self.plan.donate
        self.consts = consts_from_numpy(init_pipeline(self.cfg), self.device)
        self._fn = pipeline_fn(self.cfg, self.device.type)
        self._aot: dict = {}        # pad_to -> captured graph (core.aot)
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == "cuda" else None)

    def run(self, x: torch.Tensor) -> torch.Tensor:
        """The engine on a device-resident batch, on the current stream."""
        if self.cfg.exec_map == "map":
            return torch.cat([self._fn(self.consts, x[i:i + 1])
                              for i in range(x.shape[0])])
        return self._fn(self.consts, x)

    def install_aot(self, pad_to: int, program) -> None:
        """Pin a captured program for the ``pad_to`` dispatch shape (built
        by `repro_torch.core.aot.aot_warm`); `dispatch_staged` replays
        it instead of launching the engine op by op."""
        self._aot[pad_to] = program

    def place(self, rf_batch) -> torch.Tensor:
        """H2D: commit an already padded host batch to the device.

        Always a fresh device tensor, so the caller may rewrite its host
        buffer once the dispatch that read it has settled (on the card:
        once the compute that waits on this copy has completed). A
        tensor already on the executor's device is returned as it is.
        """
        if self.copy_stream is None:
            return torch.as_tensor(rf_batch, device=self.device).clone()
        host = torch.as_tensor(rf_batch)
        if host.device == self.device:
            return host
        with torch.cuda.stream(self.copy_stream):
            dev = torch.empty(host.shape, dtype=host.dtype,
                              device=self.device)
            dev.copy_(host, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.copy_stream)
        dev.record_stream(torch.cuda.current_stream(self.device))
        dev.h2d_event = event
        return dev

    def dispatch_staged(self, dev_batch: torch.Tensor,
                        pad_to: int) -> torch.Tensor:
        """Launch an already placed ``(pad_to, ...)`` batch; the padded
        output, not synchronised. On the card the compute stream first
        waits on the batch's copy event."""
        if dev_batch.shape[0] != pad_to:
            raise ValueError(f"staged batch has {dev_batch.shape[0]} rows, "
                             f"dispatch shape is {pad_to}")
        event = getattr(dev_batch, "h2d_event", None)
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
        program = self._aot.get(pad_to)
        if program is not None:
            return program(dev_batch)
        return self.run(dev_batch)

    def dispatch_padded(self, rf_batch, pad_to: int) -> torch.Tensor:
        """Pad to ``pad_to`` rows, place and launch: the padded output,
        not synchronised; the caller slices the valid rows."""
        rf_batch, _ = _pad_rows(rf_batch, pad_to)
        return self.dispatch_staged(self.place(rf_batch), pad_to)

    def call_padded(self, rf_batch, pad_to: int) -> torch.Tensor:
        """Fixed-shape dispatch of a ragged batch (B <= pad_to rows): pads
        to ``pad_to`` rows and slices the valid rows off the result."""
        b = rf_batch.shape[0]
        out = self.dispatch_padded(rf_batch, pad_to)
        return out[:b] if b != pad_to else out

    def __call__(self, rf_batch) -> torch.Tensor:
        """(B, n_l, n_c, n_f) RF batch (numpy or tensor) -> (B, *image)."""
        return self.dispatch_staged(self.place(rf_batch), rf_batch.shape[0])

    @property
    def input_bytes_per_acq(self) -> int:
        """B_in of one acquisition (paper eq. 2 normalization)."""
        return self.cfg.input_bytes

    @property
    def name(self) -> str:
        return (f"{self.cfg.name}:{self.cfg.variant.value}"
                f":{self.cfg.exec_map}")
