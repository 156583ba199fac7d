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

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.config import UltrasoundConfig
from repro_torch.core.pipeline import (_resolve_plan, consts_from_numpy,
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
    """Init once, run (B, n_l, n_c, n_f) batches many times.

    ``plan`` (a `PipelinePlan`) or ``policy`` resolves the config as in
    the reference. ``consts``: the plan-resolved config's constants
    already on ``device`` (`ShardedExecutor` shares one copy among the
    shards of one device); built here when None.
    """

    def __init__(self, cfg: UltrasoundConfig, *, plan=None,
                 policy: Optional[str] = None, device=None,
                 consts: Optional[Dict[str, torch.Tensor]] = None):
        self.device = resolve_device(device)
        self.plan = _resolve_plan(cfg, plan, policy, self.device.type)
        self.cfg = self.plan.concretize(cfg)
        self.donate = self.plan.donate
        self.consts = (consts if consts is not None else
                       consts_from_numpy(init_pipeline(self.cfg),
                                         self.device))
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


def resolve_devices(devices, device=None) -> List[torch.device]:
    """The devices a serving window or a `ShardedExecutor` runs on:
    ``devices`` resolved, one type throughout, or without it the one
    ``device`` (the card unless ``"cpu"``); a ``device`` given beside
    ``devices`` must be their first."""
    if devices is None:
        return [resolve_device(device)]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("devices must name at least one device")
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"devices of one type only, got {devs}")
    if device is not None and resolve_device(device) != devs[0]:
        raise ValueError(f"devices={list(devices)} and device={device}")
    return devs


def serve_engine(cfg: UltrasoundConfig, devices: list, plan):
    """The executor a serving group runs: a `BatchedExecutor` on one
    device, a `ShardedExecutor` over two or more."""
    if len(devices) > 1:
        return ShardedExecutor(cfg, devices=devices, plan=plan)
    return BatchedExecutor(cfg, plan=plan, device=devices[0])


def check_shards(max_batch: int, devices: list) -> int:
    """The window's device count; ``max_batch`` must split evenly over
    two or more devices."""
    n = len(devices)
    if n > 1 and max_batch % n:
        raise ValueError(f"max_batch={max_batch} must be a multiple of "
                         f"n_devices={n} for sharded dispatch")
    return n


class ShardedExecutor:
    """Data-parallel `BatchedExecutor` over a sequence of torch devices.

    The batch is zero-padded to a multiple of ``n_devices`` and split into
    contiguous shards, shard i onto ``devices[i]`` through that shard's
    own `BatchedExecutor`: its copy stream and H2D event, and on the card
    its own compute stream, so the shards overlap and each can replay its
    own CUDA graph (`repro_torch.core.aot.aot_warm` captures one a
    shard). The constants are built once and copied once per distinct
    device. The pad rows are sliced off. ``devices=None`` takes every
    CUDA device and raises when there is none; it never picks the CPU.

    A device may appear more than once: two shards on the one card, or on
    the CPU, is how the split is exercised on a one-device machine; over
    several cards each shard runs on its own card.

    ``__call__`` / ``call_padded`` gather the images onto the first
    device; ``dispatch`` / ``dispatch_staged`` / ``dispatch_padded``
    return the per-device shards, each with a ``done_event`` recorded on
    its shard's compute stream (None on the CPU), so per-device
    completion can be observed; `gather` joins them.
    """

    def __init__(self, cfg: UltrasoundConfig, *, devices: Optional[
            Sequence] = None, plan=None, policy: Optional[str] = None):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device available: ShardedExecutor runs on the "
                    "card by default — pass devices=['cpu', ...] to run "
                    "its shards on the CPU")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        self.devices = tuple(resolve_devices(devices))
        self.n_devices = len(self.devices)
        self.device = self.devices[0]
        base = _resolve_plan(cfg, plan, policy, self.device.type)
        self.plan = base.with_devices(self.n_devices,
                                      (("data", self.n_devices),))
        self.cfg = self.plan.concretize(cfg)
        self.donate = self.plan.donate
        host = init_pipeline(self.cfg)
        on_device: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        for d in self.devices:
            if d not in on_device:
                on_device[d] = consts_from_numpy(host, d)
        self.shards = [BatchedExecutor(cfg, plan=base, device=d,
                                       consts=on_device[d])
                       for d in self.devices]
        self.streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                        for d in self.devices]

    @property
    def copy_stream(self):
        """The first shard's copy stream (where the gathered images leave
        the card)."""
        return self.shards[0].copy_stream

    def _rows(self, pad_to: int, what: str) -> int:
        if pad_to < 1 or pad_to % self.n_devices:
            raise ValueError(
                f"{what} needs a batch that is a positive multiple of "
                f"n_devices={self.n_devices} (got {pad_to})")
        return pad_to // self.n_devices

    def place(self, rf_batch) -> list:
        """H2D: each contiguous shard of an already padded batch onto its
        device, through its shard's copy stream."""
        k = self._rows(rf_batch.shape[0], "place")
        placed = []
        for i, (shard, stream) in enumerate(zip(self.shards, self.streams)):
            part = rf_batch[i * k:(i + 1) * k]
            if stream is None:
                placed.append(shard.place(part))
                continue
            with torch.cuda.stream(stream):
                placed.append(shard.place(part))
        return placed

    def dispatch_staged(self, staged: list, pad_to: int) -> list:
        """Launch each placed shard on its compute stream (through its
        CUDA graph, where one is installed); the per-device outputs, not
        synchronised, each with its ``done_event``."""
        k = self._rows(pad_to, "dispatch_staged")
        outs = []
        for shard, stream, x in zip(self.shards, self.streams, staged):
            if stream is None:
                out = shard.dispatch_staged(x, k)
                out.done_event = None
                outs.append(out)
                continue
            stream.wait_stream(torch.cuda.current_stream(shard.device))
            with torch.cuda.stream(stream):
                out = shard.dispatch_staged(x, k)
                out.done_event = torch.cuda.Event()
                out.done_event.record(stream)
            outs.append(out)
        return outs

    def dispatch_padded(self, rf_batch, pad_to: int) -> list:
        """Pad to ``pad_to`` rows (a multiple of ``n_devices``), place and
        launch: the per-device padded shards."""
        self._rows(pad_to, "dispatch_padded")
        rf_batch, _ = _pad_rows(rf_batch, pad_to)
        return self.dispatch_staged(self.place(rf_batch), pad_to)

    def dispatch(self, rf_batch) -> list:
        """The per-device shards of a batch whose size is already a
        multiple of ``n_devices`` (the streaming entry)."""
        b = rf_batch.shape[0]
        self._rows(b, "dispatch()")
        return self.dispatch_staged(self.place(rf_batch), b)

    def gather(self, shards: list) -> torch.Tensor:
        """The shards joined on the first device, on its current stream
        after each shard's ``done_event``; not synchronised."""
        if self.device.type != "cuda":
            return torch.cat(shards)
        current = torch.cuda.current_stream(self.device)
        parts = []
        for out in shards:
            current.wait_event(out.done_event)
            out.record_stream(current)
            parts.append(out.to(self.device, non_blocking=True))
        return torch.cat(parts)

    def call_padded(self, rf_batch, pad_to: int) -> torch.Tensor:
        """Fixed-shape dispatch of a ragged batch (B <= pad_to rows), the
        valid rows gathered on the first device."""
        b = rf_batch.shape[0]
        out = self.gather(self.dispatch_padded(rf_batch, pad_to))
        return out[:b] if b != pad_to else out

    def __call__(self, rf_batch) -> torch.Tensor:
        """(B, n_l, n_c, n_f) RF batch -> (B, *image), any B >= 1."""
        b = rf_batch.shape[0]
        if b < 1:
            raise ValueError("empty RF batch")
        return self.call_padded(rf_batch, -(-b // self.n_devices)
                                * self.n_devices)

    @property
    def input_bytes_per_acq(self) -> int:
        """B_in of one acquisition (paper eq. 2 normalization)."""
        return self.cfg.input_bytes

    @property
    def name(self) -> str:
        return (f"{self.cfg.name}:{self.cfg.variant.value}"
                f":{self.cfg.exec_map}:d{self.n_devices}")
