"""Warm start of the serving engines: CUDA-graph capture and warm pools.

The port's counterpart of the reference's AOT module. Where the
reference lowers and compiles each group's one padded program ahead of
the serving window (``jax.jit(...).lower().compile()``), the port
captures the group's padded engine as one CUDA graph, so a dispatch is
one graph launch instead of some thirty kernel and op launches that the
host enqueues one by one:

  * `aot_warm(engine, pad_to)` — one warm-up run of the engine on a side
    stream outside capture (it builds the kernel libraries and reads
    their tile plans, as ``torch.cuda.graphs`` requires), then the
    capture of one ``torch.cuda.CUDAGraph`` of the engine reading a
    static ``(pad_to, *rf_shape)`` device input, then one replay. The
    graph is installed on the executor, whose ``dispatch_staged``
    replays it. ``compile_s`` is the capture time; ``warmup_s`` adds the
    warm-up run and the replay. Both are stamped, never excluded. On the
    CPU there is no graph: `aot_warm` runs the warm-up batch and
    captures nothing (``compile_s`` 0).
  * `WarmPool` / `warm_pool(specs, ...)` — one warm executor per config
    group of a stream set, keyed as the scheduler groups:
    ``(canonical config hash, pad_to, n_devices, donate)``. Over two or
    more devices a group's executor is a `ShardedExecutor`, warmed with
    one graph per device shard.

A replay writes the graph's one static output; each dispatch copies it
out on the compute stream right after the replay, so a batch still in
flight is never overwritten by the next one. The input is copied into
the static buffer on the compute stream, after the batch's H2D event.

The reference's persistent compilation cache has no counterpart: a CUDA
graph lives in its process, and what a fresh process reuses is the
kernel libraries' build cache (``build/kernels/``, keyed by source hash),
which ``cache_dir`` names.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["AotProgram", "GraphProgram", "WarmEntry", "PoolKey",
           "WarmPool", "aot_warm", "warm_pool"]


class GraphProgram:
    """One CUDA graph of an executor's engine at one padded shape."""

    def __init__(self, engine, shape: Tuple[int, ...], dtype):
        from repro_torch import kernels

        dev = engine.device
        # capture on a stream of the shard's own device, under that
        # device (torch.cuda.graph's default capture stream is one stream
        # of whichever device made it first)
        with torch.cuda.device(dev):
            compute = torch.cuda.current_stream(dev)
            self.x = torch.zeros(shape, dtype=dtype, device=dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(compute)
            with torch.cuda.stream(side):
                engine.run(self.x)
            compute.wait_stream(side)
            torch.cuda.synchronize(dev)
            self.graph = torch.cuda.CUDAGraph()
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            with torch.cuda.graph(self.graph, stream=side):
                self.y = engine.run(self.x)
            self.capture_s = time.perf_counter() - t0
        after = kernels.launch_counts()
        # wrapper calls inside the graph: what one replay launches
        self.captured = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}

    def __call__(self, dev_batch: torch.Tensor) -> torch.Tensor:
        """Replay on the current stream of the graph's device; a fresh
        copy of the output."""
        from repro_torch import kernels

        with torch.cuda.device(self.x.device):
            self.x.copy_(dev_batch)
            self.graph.replay()
            out = self.y.clone()
        kernels.count_replay(self.captured)
        return out


@dataclasses.dataclass(frozen=True)
class AotProgram:
    """One warmed padded serve program, with its cost."""

    key: str                 # canonical hash of the concretized config
    pad_to: int              # padded dispatch shape (rows)
    devices: int             # device count the program was built for
    compile_s: float         # graph capture wall time (0 on the CPU)
    warmup_s: float          # compile_s + warm-up run + one replay
    cache_dir: Optional[str]     # kernel build cache in effect, if any
    launches: Optional[Dict[str, int]] = None   # wrapper calls a replay runs


def aot_warm(engine, pad_to: int) -> AotProgram:
    """Capture ``engine``'s ``(pad_to, *rf_shape)`` program as CUDA graphs,
    install them and replay once on a zero batch, so the window's first
    dispatch pays no first-launch cost either (on the CPU: run the zero
    batch, capture nothing).

    A `ShardedExecutor` gets one graph per device shard, each of its
    shard's ``pad_to / n_devices`` rows, captured from that shard's
    executor and replayed on the shard's own compute stream.
    """
    from repro_torch.core.config import config_hash
    from repro_torch.kernels import cuda_lib

    shards = getattr(engine, "shards", None) or [engine]
    if pad_to < 1 or pad_to % len(shards):
        raise ValueError(f"pad_to must be a positive multiple of the "
                         f"{len(shards)} device shard(s) (got {pad_to})")
    rows = pad_to // len(shards)
    shape = (pad_to,) + tuple(engine.cfg.rf_shape)
    zeros = np.zeros(shape, np.dtype(engine.cfg.rf_dtype))
    cuda = engine.device.type == "cuda"
    t0 = time.perf_counter()
    compile_s, launches, cache_dir = 0.0, None, None
    if cuda:
        launches = {}
        dtype = torch.from_numpy(zeros[:0]).dtype
        for shard in shards:
            program = GraphProgram(shard, (rows,) + shape[1:], dtype)
            shard.install_aot(rows, program)
            compile_s += program.capture_s
            for k, n in program.captured.items():
                launches[k] = launches.get(k, 0) + n
        cache_dir = str(cuda_lib.BUILD_DIR)
    engine.dispatch_padded(zeros, pad_to)
    if cuda:
        for d in set(getattr(engine, "devices", (engine.device,))):
            torch.cuda.synchronize(d)
    return AotProgram(key=config_hash(engine.cfg), pad_to=pad_to,
                      devices=len(shards), compile_s=compile_s,
                      warmup_s=time.perf_counter() - t0,
                      cache_dir=cache_dir, launches=launches)


@dataclasses.dataclass
class WarmEntry:
    """One warm executor + the measured cost of making it warm."""

    engine: object           # BatchedExecutor, graph installed
    program: AotProgram


# (config hash, pad_to, n_devices, donate), as the reference keys it.
PoolKey = Tuple[str, int, int, bool]


class WarmPool:
    """Plan-geometry-keyed pool of warmed serve executors.

    Keys are ``(canonical config hash of the plan-concretized config,
    pad_to, n_devices, donate)`` — the scheduler's grouping plus the
    padded shape and donation signature — so a pool built once serves
    every window that would have built the same executors.
    """

    def __init__(self):
        self._entries: Dict[PoolKey, WarmEntry] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: PoolKey) -> bool:
        return key in self._entries

    def keys(self) -> Tuple[PoolKey, ...]:
        return tuple(self._entries)

    def get(self, key: PoolKey) -> Optional[WarmEntry]:
        return self._entries.get(key)

    def put(self, key: PoolKey, entry: WarmEntry) -> None:
        self._entries[key] = entry

    @property
    def warmup_s(self) -> float:
        """Total measured warm-up cost across every pooled program."""
        return sum(e.program.warmup_s for e in self._entries.values())


def pool_key(cfg, max_batch: int, plan, donate: Optional[bool],
             n_devices: int = 1) -> PoolKey:
    """The pool key of ``cfg`` under ``plan``; the port never donates."""
    from repro_torch.core.config import config_hash

    if donate:
        raise ValueError("the port does not donate input buffers")
    return (config_hash(plan.concretize(cfg)), max_batch, n_devices,
            plan.donate)


def warm_pool(specs: Sequence, *, max_batch: int, devices=None,
              plan_policy: Optional[str] = None,
              pool: Optional[WarmPool] = None,
              donate: Optional[bool] = None, device=None) -> WarmPool:
    """One warmed executor per distinct config group of ``specs``.

    ``specs`` are `repro_torch.launch.scheduler.StreamSpec`s (anything
    with a ``.cfg``); grouping matches `serve_multitenant`: the
    plan-resolved canonical hash, at the padded shape ``max_batch``, on
    ``devices`` (two or more: a `ShardedExecutor`, one graph a shard;
    ``max_batch`` must divide evenly) or the one ``device`` (the card
    unless ``"cpu"``). Pass an existing ``pool`` to extend it; groups
    already in it are not warmed again.
    """
    from repro_torch.core.executor import (check_shards, resolve_devices,
                                           serve_engine)
    from repro_torch.core.pipeline import _resolve_plan

    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1 (got {max_batch})")
    devs = resolve_devices(devices, device)
    n = check_shards(max_batch, devs)
    pool = pool if pool is not None else WarmPool()
    for spec in specs:
        plan = _resolve_plan(spec.cfg, None, plan_policy, devs[0].type,
                             batch=max_batch // n)
        key = pool_key(spec.cfg, max_batch, plan, donate, n)
        if key in pool:
            continue
        engine = serve_engine(spec.cfg, devs, plan)
        pool.put(key, WarmEntry(engine=engine,
                                program=aot_warm(engine, max_batch)))
    return pool
