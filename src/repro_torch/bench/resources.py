"""Resource metering: measured peak device memory and incremental energy.

The paper reports "incremental energy per run and peak memory usage,
where available". The port measures both on the card:

  * **Peak memory** — the caching allocator's high-water mark over the
    metering window: `ResourceMeter.start` resets the device's peak
    statistics (``torch.cuda.reset_peak_memory_stats``), so
    ``torch.cuda.max_memory_allocated`` at the end is this window's peak
    and no earlier window's (source ``"torch.cuda.max_memory_allocated"``).
    On the CPU there is no allocator telemetry: the meter samples the
    process's resident set at its sample points (source
    ``"process_rss_sampled"``, a window-scoped lower bound that counts
    the whole process, not tensors alone).
  * **Incremental energy** — board power read through NVML on a
    background thread every ``poll_s`` and trapezoid-integrated over the
    window, minus the idle baseline sampled when the meter is built —
    before warm-up has heated the board — as the paper's eq. 3,
    ``(P_active - P_idle) * T``, measured. NVML is bound with ctypes from
    NVIDIA's ``libnvidia-ml.so.1`` (``nvmlInit_v2``,
    ``nvmlDeviceGetHandleByIndex_v2``, ``nvmlDeviceGetPowerUsage``); the
    board's cumulative energy counter
    (``nvmlDeviceGetTotalEnergyConsumption``) is read at start and stop
    as a check beside the integral. The meter's handle is the NVML board
    of the metered device, mapped through ``CUDA_VISIBLE_DEVICES``.
    Without NVML or a CUDA device, energy is ``None``.

The power sampler and the clock are injectable (`NvmlEnergyMeter`'s
``power_w`` and ``clock``), so the integration is testable without a
card.

Invariants: meters never raise out of start/sample/stop (metering must
not take down the run it observes); unmeasured metrics are ``None``,
never 0.0.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

__all__ = ["NvmlEnergyMeter", "ResourceMeter", "ResourceStats",
           "devices_of", "integrate_power", "nvml_indices_for_local_gpus"]


@dataclasses.dataclass(frozen=True)
class ResourceStats:
    """Measured resource usage over one metering window.

    ``None`` fields mean "not measurable here", never zero. The last
    three are the port's additions: the number of power samples the
    integral rests on, the idle baseline subtracted, and the board's
    own energy counter over the window (absolute, not incremental).
    """

    peak_memory_bytes: Optional[int] = None
    memory_source: Optional[str] = None
    energy_joules: Optional[float] = None
    energy_source: Optional[str] = None   # "nvml"
    devices: int = 1
    duration_s: Optional[float] = None
    energy_samples: Optional[int] = None
    idle_power_w: Optional[float] = None
    energy_counter_joules: Optional[float] = None

    def json_dict(self) -> dict:
        return dataclasses.asdict(self)


def devices_of(*trees) -> Optional[tuple]:
    """The distinct devices of the tensors in ``trees`` (nested dicts,
    lists and tuples), or None when there is none."""
    devs: dict = {}

    def walk(t):
        if isinstance(t, torch.Tensor):
            devs[t.device] = None
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    for t in trees:
        walk(t)
    return tuple(devs) if devs else None


def nvml_indices_for_local_gpus(local_ids, *,
                                visible=None) -> Optional[list]:
    """Map CUDA device ordinals to NVML board indices.

    NVML numbers every board on the host and ignores
    ``CUDA_VISIBLE_DEVICES``, while CUDA's ordinals are positions in the
    visible set. Returns None when the visible list uses UUID or MIG
    selectors, which cannot be mapped numerically.
    """
    if visible is None:
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is None:
        return list(local_ids)
    entries = [e.strip() for e in visible.split(",") if e.strip()]
    try:
        globals_ = [int(e) for e in entries]
    except ValueError:
        return None
    try:
        return [globals_[i] for i in local_ids]
    except IndexError:
        return None


def integrate_power(samples: Sequence[Tuple[float, float]],
                    idle_w: float) -> Optional[float]:
    """Trapezoid integral of ``(t_s, watts)`` samples above ``idle_w``,
    in joules (floored at 0); None for fewer than two samples."""
    if len(samples) < 2:
        return None
    joules = 0.0
    for (t0, p0), (t1, p1) in zip(samples, samples[1:]):
        joules += (0.5 * (p0 + p1) - idle_w) * (t1 - t0)
    return max(joules, 0.0)


class _Nvml:
    """The few NVML calls the meter needs, bound with ctypes."""

    def __init__(self):
        self.lib = ctypes.CDLL("libnvidia-ml.so.1")
        self._check(self.lib.nvmlInit_v2(), "nvmlInit_v2")

    @staticmethod
    def _check(rc: int, what: str) -> None:
        if rc != 0:
            raise OSError(f"{what} returned NVML error {rc}")

    def count(self) -> int:
        n = ctypes.c_uint()
        self._check(self.lib.nvmlDeviceGetCount_v2(ctypes.byref(n)),
                    "nvmlDeviceGetCount_v2")
        return n.value

    def handle(self, index: int) -> ctypes.c_void_p:
        h = ctypes.c_void_p()
        self._check(self.lib.nvmlDeviceGetHandleByIndex_v2(
            ctypes.c_uint(index), ctypes.byref(h)),
            "nvmlDeviceGetHandleByIndex_v2")
        return h

    def power_w(self, handle) -> float:
        mw = ctypes.c_uint()
        self._check(self.lib.nvmlDeviceGetPowerUsage(handle,
                                                     ctypes.byref(mw)),
                    "nvmlDeviceGetPowerUsage")
        return mw.value / 1e3

    def energy_j(self, handle) -> float:
        mj = ctypes.c_ulonglong()
        self._check(self.lib.nvmlDeviceGetTotalEnergyConsumption(
            handle, ctypes.byref(mj)), "nvmlDeviceGetTotalEnergyConsumption")
        return mj.value / 1e3


_NVML_UNSET = object()
_nvml_cache = _NVML_UNSET


def _load_nvml() -> Optional[_Nvml]:
    # one attempt per process: a host without NVML fails the same
    # way every time
    global _nvml_cache
    if _nvml_cache is _NVML_UNSET:
        try:
            _nvml_cache = _Nvml()
        except (OSError, AttributeError):
            _nvml_cache = None
    return _nvml_cache


# First idle-power reading per NVML board set (the coldest this process
# saw): a meter built right after another window would read the board
# still hot.
_IDLE_W_CACHE: dict = {}


class NvmlEnergyMeter:
    """Incremental board energy over a window, by polled power.

    A daemon thread samples board power every ``poll_s`` seconds between
    `start` and `stop`; `stop` returns the joules above the idle baseline
    sampled at construction (`integrate_power`). ``device_indices`` are
    NVML board indices (None: every board). ``power_w`` (a callable
    returning watts) and ``clock`` replace NVML and ``time.perf_counter``
    for tests; with ``power_w`` there is no energy counter.
    """

    def __init__(self, poll_s: float = 0.05,
                 device_indices: Optional[Sequence[int]] = None, *,
                 power_w: Optional[Callable[[], float]] = None,
                 clock: Callable[[], float] = time.perf_counter):
        self.poll_s = poll_s
        self._clock = clock
        self._handles: list = []
        self._nvml = None
        if power_w is not None:
            self._read_power = power_w
            self._board_key = None
        else:
            self._nvml = _load_nvml()
            if self._nvml is not None:
                try:
                    count = self._nvml.count()
                    indices = (list(range(count)) if device_indices is None
                               else [i for i in device_indices
                                     if 0 <= i < count])
                    self._handles = [self._nvml.handle(i) for i in indices]
                except OSError:
                    self._handles = []
            self._board_key = tuple(sorted(
                device_indices if device_indices is not None else ()))
            self._read_power = self._nvml_power
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self.samples: List[Tuple[float, float]] = []
        self.energy_counter_joules: Optional[float] = None
        self._counter0 = None
        self.idle_w: Optional[float] = None
        if self.available():
            if self._board_key is None:
                self.idle_w = self._power()
            else:
                if self._board_key not in _IDLE_W_CACHE:
                    idle = self._power()
                    if idle is not None:
                        _IDLE_W_CACHE[self._board_key] = idle
                self.idle_w = _IDLE_W_CACHE.get(self._board_key)

    def available(self) -> bool:
        return self._board_key is None or bool(self._handles)

    def _nvml_power(self) -> float:
        return sum(self._nvml.power_w(h) for h in self._handles)

    def _power(self) -> Optional[float]:
        try:
            return float(self._read_power())
        except (OSError, ValueError, TypeError):
            return None

    def _counter(self) -> Optional[float]:
        if not self._handles:
            return None
        try:
            return sum(self._nvml.energy_j(h) for h in self._handles)
        except OSError:
            return None

    def _poll(self) -> None:
        while True:
            # sample on the stop tick too: the tail after the last poll
            # (the whole window, when it is shorter than poll_s) counts
            stopped = self._stop_evt.wait(self.poll_s)
            p = self._power()
            if p is not None:
                self.samples.append((self._clock(), p))
            if stopped:
                return

    def start(self) -> None:
        if not self.available() or self.idle_w is None:
            return
        self.samples = []
        self._counter0 = self._counter()
        p = self._power()
        if p is not None:
            self.samples.append((self._clock(), p))
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    def stop(self) -> Optional[float]:
        """Joules above idle since `start`, or None if unmeasured."""
        if self._thread is None:
            return None
        self._stop_evt.set()
        self._thread.join(timeout=5.0)
        self._thread = None
        end = self._counter()
        self.energy_counter_joules = (
            end - self._counter0 if end is not None
            and self._counter0 is not None else None)
        return integrate_power(self.samples, self.idle_w)


def _rss_bytes() -> Optional[int]:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


class ResourceMeter:
    """Meters one window: ``start() -> sample()* -> stop()``.

    ``device`` is the torch device the window runs on (the card unless
    ``"cpu"``). ``sample()`` is cheap; call it where interesting buffers
    are live. ``stop()`` always returns a `ResourceStats`. Build the
    meter before warm-up, so that the idle baseline sees the board cold.
    """

    def __init__(self, device=None, *, energy_meter=None):
        from repro_torch.core.pipeline import resolve_device

        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        if energy_meter is not None:
            self._energy = energy_meter
        elif self._cuda:
            ids = nvml_indices_for_local_gpus([self.device.index])
            self._energy = NvmlEnergyMeter(
                device_indices=ids if ids is not None else [])
        else:
            self._energy = None
        self._peak: Optional[int] = None
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._peak = None
        self._t0 = time.perf_counter()
        if self._cuda:
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        if self._energy is not None:
            try:
                self._energy.start()
            except Exception:   # noqa: BLE001 — a failing NVML is not our crash
                pass
        self.sample()

    def sample(self) -> None:
        try:
            peak = (int(torch.cuda.max_memory_allocated(self.device))
                    if self._cuda else _rss_bytes())
        except RuntimeError:
            return
        if peak is not None and (self._peak is None or peak > self._peak):
            self._peak = peak

    def stop(self) -> ResourceStats:
        if self._cuda:
            torch.cuda.synchronize(self.device)
        self.sample()
        duration = (time.perf_counter() - self._t0
                    if self._t0 is not None else None)
        joules = None
        if self._energy is not None:
            try:
                joules = self._energy.stop()
            except Exception:   # noqa: BLE001
                joules = None
        measured = joules is not None
        return ResourceStats(
            peak_memory_bytes=self._peak,
            memory_source=(None if self._peak is None else
                           "torch.cuda.max_memory_allocated" if self._cuda
                           else "process_rss_sampled"),
            energy_joules=joules,
            energy_source="nvml" if measured else None,
            devices=1,
            duration_s=duration,
            energy_samples=(len(self._energy.samples) if measured
                            else None),
            idle_power_w=self._energy.idle_w if measured else None,
            energy_counter_joules=(self._energy.energy_counter_joules
                                   if measured else None))
