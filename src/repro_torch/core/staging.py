"""Preallocated host staging rings for the serving dispatch path (the
port's copy of the reference's `StagingRing`).

A ring of ``(pad_to, *frame_shape)`` host buffers, zeroed once at
construction. Coalescing writes each admitted frame's RF straight into
the next slot (one row copy per frame), and the pad rows are re-zeroed
only where a fuller earlier occupant left stale rows. The slot goes to
the executor's ``place`` / ``dispatch_staged`` pair as it is.

Pinned memory: a ring that serves a CUDA device (``pin_memory=True``)
keeps its slots in page-locked host memory — numpy views of pinned
tensors — so `place` runs a true asynchronous DMA on the executor's copy
stream. A ring that serves the CPU keeps plain numpy buffers.

Ring sizing: a slot may be rewritten only once the H2D copy that read it
has completed, not merely been queued. The scheduler launches a batch
only while fewer than ``in_flight`` are pending and counts a batch as no
longer pending once its compute has completed; that compute waited on
the batch's copy event, so the copy completed too. With ``slots >=
depth + 1`` the batch that last used a slot is at least ``slots``
launches back when the slot comes round again, hence no longer pending.
A smaller ring is refused at construction.

`stage` adds its own wall time to ``stage_copy_s`` for the transfer
telemetry.
"""

from __future__ import annotations

import time
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["StagingRing"]


class StagingRing:
    """Ring of preallocated padded host batch buffers for one group.

    ``depth`` is the scheduler's ``in_flight`` bound; ``slots`` defaults
    to ``depth + 1`` (the least safe size) and may only be larger.
    ``pin_memory`` puts the slots in page-locked memory (needs CUDA).
    """

    def __init__(self, pad_to: int, frame_shape: Sequence[int], dtype, *,
                 depth: int, slots: int = None, pin_memory: bool = False):
        if pad_to < 1:
            raise ValueError(f"pad_to must be >= 1 (got {pad_to})")
        if depth < 1:
            raise ValueError(f"depth must be >= 1 (got {depth})")
        if slots is None:
            slots = depth + 1
        if slots < depth + 1:
            raise ValueError(
                f"staging ring of {slots} slots cannot back in_flight="
                f"{depth} pending dispatches — a slot could be rewritten "
                f"while the device still reads it; need >= {depth + 1}")
        self.pad_to = pad_to
        self.depth = depth
        self.slots = slots
        self.frame_shape = tuple(frame_shape)
        self.dtype = np.dtype(dtype)
        shape = (pad_to,) + self.frame_shape
        if pin_memory:
            tdtype = torch.from_numpy(np.zeros(0, self.dtype)).dtype
            # the tensors own the page-locked memory; the numpy views
            # are what callers write
            self._tensors = [torch.zeros(shape, dtype=tdtype,
                                         pin_memory=True)
                             for _ in range(slots)]
            self._bufs = [t.numpy() for t in self._tensors]
        else:
            self._tensors = None
            self._bufs = [np.zeros(shape, self.dtype) for _ in range(slots)]
        self._fill = [0] * slots       # dirtied rows per slot
        self._next = 0
        self.stage_copy_s = 0.0        # accumulated host-copy wall time
        self.batches_staged = 0

    def stage(self, frames_rf: Sequence[np.ndarray]
              ) -> Tuple[np.ndarray, int]:
        """Write a coalesced batch into the next slot; (buffer, b).

        Returns the full ``(pad_to, *frame_shape)`` padded buffer — rows
        past ``b`` are zero — owned by the ring: valid until ``slots``
        further `stage` calls, which the scheduler's in-flight bound
        guarantees (module docstring).
        """
        b = len(frames_rf)
        if b < 1:
            raise ValueError("empty RF batch")
        if b > self.pad_to:
            raise ValueError(
                f"batch of {b} exceeds pad_to={self.pad_to} — the "
                "scheduler must never coalesce past its policy's "
                "max_batch")
        t0 = time.perf_counter()
        i = self._next
        self._next = (i + 1) % self.slots
        buf = self._bufs[i]
        for r, rf in enumerate(frames_rf):
            buf[r] = rf
        if self._fill[i] > b:          # stale rows from a fuller occupant
            buf[b:self._fill[i]] = 0
        self._fill[i] = b
        self.stage_copy_s += time.perf_counter() - t0
        self.batches_staged += 1
        return buf, b
