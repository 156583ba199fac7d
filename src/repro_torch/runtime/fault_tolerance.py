"""Fault tolerance: preemption handling, hang watchdog, restart loop.

The port's copy of the reference's ``repro.runtime.fault_tolerance``
(pure Python, unchanged).

Synchronous SPMD has no per-step straggler recourse — the mitigation stack
at 1000+ nodes is:
  1. static shapes everywhere (no recompile stalls — every step is the
     same program; this repo's configs guarantee it),
  2. async checkpointing (no save stalls on the critical path),
  3. preemption-aware exit: SIGTERM triggers checkpoint-and-exit at the
     next step boundary,
  4. hang watchdog: if no step completes within `hang_timeout_s` (dead
     host, wedged collective), the process aborts so the scheduler
     restarts it; restart resumes from the latest atomic checkpoint,
  5. elastic restart: the checkpoint is mesh-shape-agnostic (see
     checkpoint.py), so the job can resume on a resized slice; the data
     pipeline is step-addressable so no batches are lost or repeated.

`run_resilient` packages 3-5 for the training loop and is exercised
in-process by tests (simulated preemption/crash).
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Callable, Optional


class PreemptionHandler:
    """Converts SIGTERM/SIGINT into a graceful 'save and exit' flag."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = threading.Event()
        self._prev = {}
        self._signals = signals

    def __enter__(self):
        for s in self._signals:
            try:
                self._prev[s] = signal.signal(s, self._handle)
            except ValueError:  # non-main thread (tests)
                pass
        return self

    def _handle(self, signum, frame):
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def trigger(self):  # test hook
        self._flag.set()

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        return False


class HangWatchdog:
    """Aborts (or calls on_hang) if heartbeat() isn't called in time."""

    def __init__(self, timeout_s: float, on_hang: Optional[Callable] = None,
                 poll_s: float = 1.0):
        self.timeout_s = timeout_s
        self.on_hang = on_hang or self._default_abort
        self._poll_s = poll_s
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def _default_abort():
        os._exit(42)  # scheduler restarts us; checkpoint is atomic

    def start(self):
        self._thread.start()
        return self

    def heartbeat(self):
        self._last = time.monotonic()

    def _run(self):
        while not self._stop.wait(self._poll_s):
            if time.monotonic() - self._last > self.timeout_s:
                self.on_hang()
                return

    def stop(self):
        self._stop.set()


class TransientError(RuntimeError):
    """A step failure worth restarting from checkpoint (injected in tests)."""


def run_resilient(train_once: Callable[[], None], *, max_restarts: int = 3,
                  on_restart: Optional[Callable[[int], None]] = None) -> int:
    """Run train_once; on TransientError restart (from checkpoint) up to
    max_restarts times. Returns the number of restarts used."""
    restarts = 0
    while True:
        try:
            train_once()
            return restarts
        except TransientError:
            restarts += 1
            if restarts > max_restarts:
                raise
            if on_restart is not None:
                on_restart(restarts)
