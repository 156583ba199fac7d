"""Multi-tenant dynamic-batching serve scheduler (PyTorch port).

N independent probes — mixed modalities, mixed frame rates — each
producing acquisitions on its own clock, all sharing one card. The
port's counterpart of the reference's scheduler, with its contract:

  * `StreamSpec` — one client: an `UltrasoundConfig`, an arrival process
    (uniform open-loop ``phase_s + k / fps`` by default, or a
    `TraceArrival` replaying recorded timestamps), a frame count, a
    seed, an optional connect window (``start_s`` / ``stop_s``: frames
    arriving outside it are dropped at admission) and an optional
    per-frame completion deadline.
  * `BatchPolicy` — ``max_batch`` (the coalescing ceiling and the padded
    dispatch shape) and ``max_queue_delay_ms`` (how long the oldest
    queued frame may wait for companions).
  * `serve_multitenant` — frames are grouped by the plan-resolved
    canonical config hash (only identical pipelines share an engine),
    coalesced under the policy, and dispatched at one fixed padded shape
    per group. Among queues eligible to flush (full, or oldest frame
    past the delay bound) the oldest head goes first; ties go to the
    first group in construction order.

Dispatch is pipelined: up to ``in_flight`` launched batches ride a
bounded ring while the host keeps admitting, coalescing and launching.
A batch's compute is settled when the CUDA event recorded after its
dispatch on the compute stream has completed (`_ready`: the event's
``query()``). Completions retire oldest-first per group, and outputs
are keyed by (stream, seq), so drain order leaves no trace in the
pixels.

Host transfer path: each group coalesces into a slot of a pinned
`repro_torch.core.staging.StagingRing`; the executor's ``place`` issues
the H2D on its copy stream and records an event, and ``dispatch_staged``
makes the compute stream wait on that event and replays the group's
CUDA graph (`repro_torch.core.aot`, warmed before the window and
stamped as ``warmup_s``). With ``drain="async"`` the D2H of a settled
batch starts at once, into pinned host memory on the copy stream, and
the images are harvested on a later pass; ``drain="block"`` waits for
that copy at once. Per window: ``stage_copy_s`` (host copies into
the ring), ``h2d_s`` (host time to issue the H2D copies), ``d2h_s``
(host time waiting for images to land), ``transfer_frac``.

Telemetry per window: per-frame queue delay (dispatch - arrival) and
completion latency (done - arrival), aggregate and per stream; batch
occupancy; ``device_busy_frac`` / ``overlap_frac`` and the ring's depth
distribution; per-group plan stamps; warm-up seconds; the window's
`ResourceStats` (peak memory, NVML energy). The stats dict has the
reference's keys.

On the CPU (``device="cpu"``) the same loop runs the plain versions:
there are no events, a dispatch is settled when it returns, and no
graph is captured.

Invariants (tests/test_torch_scheduler.py): every served frame equals
the same frame run alone through `monolithic_pipeline_fn`, bit for bit
on the CPU, at every in-flight depth and drain order; occupancy never
exceeds ``max_batch``; the ring never exceeds ``in_flight``.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.config import UltrasoundConfig
from repro_torch.core.staging import StagingRing
from repro_torch.data.rf_data import shared_rf
from repro_torch.data.traces import (ArrivalProcess, StreamTrace, Trace,
                                     TraceArrival, mixed_phase, mixed_rate,
                                     seed_space)

__all__ = ["BatchPolicy", "StreamSpec", "make_mixed_streams",
           "make_trace_streams", "trace_of_streams",
           "serve_multitenant"]


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """Dynamic-batching policy: coalescing ceiling + queue-delay bound.

    ``max_batch`` is both the coalescing limit and the padded dispatch
    shape (one compiled program per config group). ``max_queue_delay_ms``
    bounds how long the OLDEST queued frame may wait for companions
    before the batch is flushed partial; 0 means dispatch whatever is
    queued the moment the device is free (greedy, lowest latency,
    worst occupancy).
    """

    max_batch: int = 4
    max_queue_delay_ms: float = 5.0

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1 "
                             f"(got {self.max_batch})")
        if self.max_queue_delay_ms < 0:
            raise ValueError(f"max_queue_delay_ms must be >= 0 "
                             f"(got {self.max_queue_delay_ms})")

    def json_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """One tenant: a probe configuration plus its arrival process.

    Arrivals: with the default ``arrival=None`` the stream is uniform
    open-loop — frame k arrives at ``phase_s + k / fps`` on the window
    clock (``phase_s`` staggers tenants so their bursts de-synchronize).
    Any `repro_torch.data.traces.ArrivalProcess` plugs in instead: a
    `TraceArrival` replays recorded timestamps bit-identically.

    Connect window (churn): frames whose arrival timestamp falls before
    ``start_s`` or at/after ``stop_s`` are DROPPED deterministically at
    admission — the probe is not connected — and counted in the
    ``dropped`` telemetry. The decision uses only arrival timestamps,
    never wall clock, so a replay drops the same frames.

    RF content: ``pool`` pre-generated acquisitions cycle like
    `SyntheticAcquisitionSource` so host-side synthesis stays out of
    the serving window. The cycle period is ``min(pool, n_frames)``
    (never more pools than frames are synthesized); frame k carries RF
    ``synth_rf(cfg, seed=self.frame_seed(k))``, where `frame_seed`
    derives a per-(stream_id, seed) disjoint seed space via
    `repro_torch.data.traces.seed_space` — two tenants never share a
    byte-identical frame just because their base seeds sit close.
    """

    stream_id: str
    cfg: UltrasoundConfig
    fps: float = 100.0
    n_frames: int = 16
    seed: int = 0
    pool: int = 4
    phase_s: float = 0.0
    deadline_ms: Optional[float] = None   # per-frame completion budget
    arrival: Optional[ArrivalProcess] = None
    start_s: float = 0.0                  # connect instant
    stop_s: Optional[float] = None        # disconnect instant (churn)

    def __post_init__(self):
        if self.fps <= 0:
            raise ValueError(f"fps must be > 0 (got {self.fps})")
        if self.n_frames < 1:
            raise ValueError(f"n_frames must be >= 1 "
                             f"(got {self.n_frames})")
        if self.pool < 1:
            raise ValueError(f"pool must be >= 1 (got {self.pool})")
        if self.start_s < 0:
            raise ValueError(f"start_s must be >= 0 "
                             f"(got {self.start_s})")
        if self.stop_s is not None and self.stop_s <= self.start_s:
            raise ValueError(f"stop_s={self.stop_s} must be > "
                             f"start_s={self.start_s}")
        if self.arrival is not None:
            try:
                n = len(self.arrival)          # type: ignore[arg-type]
            except TypeError:
                n = None
            if n is not None and self.n_frames > n:
                raise ValueError(
                    f"n_frames={self.n_frames} exceeds the arrival "
                    f"process's {n} recorded timestamps")

    def arrival_s(self, k: int) -> float:
        if self.arrival is not None:
            return self.arrival.arrival_s(k)
        return self.phase_s + k / self.fps

    def frame_seed(self, k: int) -> int:
        """The `synth_rf` seed of frame k: the pool cycles with period
        ``min(pool, n_frames)``, each slot in a seed space disjoint
        per (seed, stream_id)."""
        return seed_space("stream", self.seed, self.stream_id,
                          k % min(self.pool, self.n_frames))

    def frame_rf(self, k: int) -> np.ndarray:
        """The RF of frame k (read-only; see
        `repro_torch.data.shared_rf`)."""
        return shared_rf(self.cfg, self.frame_seed(k))

    def in_window(self, t: float) -> bool:
        """Is the probe connected at window-clock time t?"""
        return t >= self.start_s and (self.stop_s is None
                                      or t < self.stop_s)


def make_mixed_streams(n_clients: int, cfg_bmode: UltrasoundConfig,
                       cfg_doppler: UltrasoundConfig, *,
                       base_fps: float = 120.0, n_frames: int = 24,
                       deadline_ms: Optional[float] = 100.0
                       ) -> List[StreamSpec]:
    """Mixed-tenant traffic: alternating modalities, staggered rates.

    Client i runs B-mode (even) or Color Doppler (odd) at
    ``base_fps / (1 + i/2)`` — tenants never share a clock, so the
    scheduler's coalescing has to earn its occupancy from genuinely
    unaligned arrivals. Phases stagger by 1/4 of the fastest period.
    Rates/phases come from `repro_torch.data.traces.mixed_rate` /
    `mixed_phase` — the SAME helpers the ``steady`` trace generator
    uses, so a generated steady trace replays this schedule
    bit-identically (equal floats, equal trace_sha256).
    Used by ``--multitenant`` serving and ``chip_smoke.py``.
    """
    if n_clients < 1:
        raise ValueError(f"n_clients must be >= 1 (got {n_clients})")
    return [
        StreamSpec(
            stream_id=f"probe{i}",
            cfg=cfg_bmode if i % 2 == 0 else cfg_doppler,
            fps=mixed_rate(i, base_fps), n_frames=n_frames,
            seed=17 * i, phase_s=mixed_phase(i, base_fps),
            deadline_ms=deadline_ms)
        for i in range(n_clients)]


def make_trace_streams(trace: Trace, cfg_bmode: UltrasoundConfig,
                       cfg_doppler: UltrasoundConfig, *,
                       deadline_ms: Optional[float] = 100.0,
                       pool: int = 4) -> List[StreamSpec]:
    """Bind a recorded/generated `Trace` to the mixed-tenant configs.

    Stream i of the trace gets the same modality assignment (B-mode
    even, Doppler odd) and the same RF seed (``17 * i``) as
    `make_mixed_streams` client i, but its arrivals come from a
    `TraceArrival` — replayed bit-identically — and its connect window
    from the trace's ``start_s`` / ``stop_s``. Replaying a ``steady``
    trace therefore serves the exact frames `make_mixed_streams` would.
    """
    return [
        StreamSpec(
            stream_id=st.stream_id,
            cfg=cfg_bmode if i % 2 == 0 else cfg_doppler,
            fps=st.fps, n_frames=len(st.arrivals),
            seed=17 * i, pool=pool, deadline_ms=deadline_ms,
            arrival=TraceArrival(st.arrivals),
            start_s=st.start_s, stop_s=st.stop_s)
        for i, st in enumerate(trace.streams)]


def trace_of_streams(specs: Sequence[StreamSpec], *,
                     profile: Optional[str] = None,
                     seed: Optional[int] = None) -> Trace:
    """The `Trace` a set of specs will replay — uniform or recorded.

    Materializes every spec's arrival process into timestamps, so the
    uniform open-loop default and a `TraceArrival` replay of its saved
    copy produce the same trace — and therefore the same ``sha256``
    provenance stamp in the telemetry.
    """
    return Trace(
        streams=tuple(StreamTrace(
            stream_id=s.stream_id,
            arrivals=tuple(s.arrival_s(k) for k in range(s.n_frames)),
            fps=s.fps, start_s=s.start_s, stop_s=s.stop_s)
            for s in specs),
        profile=profile, seed=seed)


@dataclasses.dataclass
class _Frame:
    """One enqueued acquisition, tracked from arrival to completion."""

    stream: int            # index into the spec list
    seq: int               # per-stream sequence number
    rf: np.ndarray
    t_arrival: float       # window clock (s)
    t_dispatch: float = -1.0
    t_done: float = -1.0


class _Group:
    """All streams sharing one canonical config hash -> one executor."""

    def __init__(self, key: str, cfg: UltrasoundConfig, engine):
        self.key = key
        self.cfg = cfg
        self.engine = engine
        self.queue: collections.deque = collections.deque()
        self.stream_ids: List[str] = []
        self.occupancies: List[int] = []
        self.depths: List[int] = []       # ring depth at each launch
        self.warm_source = "aot"          # "aot" | "pool"
        self.warmup_s = 0.0               # warm cost paid by THIS window
        self.ring: Optional[StagingRing] = None   # built per window


@dataclasses.dataclass
class _Pending:
    """One launched batch riding the in-flight ring until it settles."""

    group: _Group
    batch: List[_Frame]
    out: torch.Tensor          # padded output, possibly still computing
    done: Optional[torch.cuda.Event]   # recorded after the dispatch
    t_dispatch: float
    host: Optional[torch.Tensor] = None     # pinned D2H target (async)
    landed: Optional[torch.cuda.Event] = None   # after the D2H


def _ready(p: _Pending) -> bool:
    """Non-blocking: has this dispatched batch's compute settled?

    The query of the CUDA event recorded after the dispatch (on the CPU
    there is none: a dispatch is settled when it returns). Module-level
    so the out-of-order-drain test can monkeypatch it with a gate that
    holds chosen batches back.
    """
    return p.done is None or p.done.query()


def _build_groups(specs: Sequence[StreamSpec], policy: BatchPolicy, *,
                  devices: list, plan_policy, pool=None, donate=None
                  ) -> Tuple[List["_Group"], List["_Group"]]:
    """Group specs by plan-resolved config hash, one executor each.

    Returns (groups, group_of_stream). `Variant.AUTO` tenants resolve
    through ``plan_policy`` first (``"autotune"``: the memoized search),
    so an AUTO probe and an explicit one share a group when the planner
    agrees. Two or more ``devices`` make each group's executor a
    `ShardedExecutor` (``max_batch`` must divide evenly). A `WarmPool`
    hit (same key: hash, padded shape, device count, donation) reuses
    the pooled engine, graphs installed, and the group is
    ``warm_source="pool"`` with no warm cost charged to this window.
    """
    from repro_torch.core.aot import pool_key
    from repro_torch.core.executor import check_shards, serve_engine
    from repro_torch.core.pipeline import _resolve_plan

    n_devices = check_shards(policy.max_batch, devices)
    groups: Dict[str, _Group] = {}
    group_of_stream: List[_Group] = []
    for spec in specs:
        plan = _resolve_plan(spec.cfg, None, plan_policy, devices[0].type,
                             batch=policy.max_batch // n_devices)
        key = pool_key(spec.cfg, policy.max_batch, plan, donate, n_devices)
        if key[0] not in groups:
            entry = pool.get(key) if pool is not None else None
            if entry is not None:
                g = _Group(key[0], entry.engine.cfg, entry.engine)
                g.warm_source = "pool"
            else:
                engine = serve_engine(spec.cfg, devices, plan)
                g = _Group(key[0], engine.cfg, engine)
            groups[key[0]] = g
        groups[key[0]].stream_ids.append(spec.stream_id)
        group_of_stream.append(groups[key[0]])
    return list(groups.values()), group_of_stream


def _make_frames(specs: Sequence[StreamSpec]
                 ) -> Tuple[List[_Frame], List[int]]:
    """Pre-generate every in-window frame (arrival-sorted) + drops.

    Synthesis is untimed (and shared across windows: `shared_rf`).
    Frames arriving outside the stream's connect
    window are dropped here, by timestamp alone. The sort key
    ``(t_arrival, stream, seq)`` admits simultaneous arrivals in spec
    order.
    """
    pools = []
    for spec in specs:
        n = min(spec.pool, spec.n_frames)
        pools.append([spec.frame_rf(i) for i in range(n)])
    frames: List[_Frame] = []
    dropped = [0] * len(specs)
    for si, spec in enumerate(specs):
        for k in range(spec.n_frames):
            t = spec.arrival_s(k)
            if not spec.in_window(t):
                dropped[si] += 1
                continue
            frames.append(_Frame(stream=si, seq=k,
                                 rf=pools[si][k % len(pools[si])],
                                 t_arrival=t))
    frames.sort(key=lambda f: (f.t_arrival, f.stream, f.seq))
    return frames, dropped


def _pick_group(groups: List[_Group], now: float,
                policy: BatchPolicy) -> Optional[_Group]:
    """The group to flush now, or None if every queue may keep waiting.

    A queue is eligible when it is full or its oldest frame has waited
    max_queue_delay. Among eligible queues the oldest head wins, so a
    saturated tenant cannot starve a sparse tenant's expired frame.
    """
    delay_s = policy.max_queue_delay_ms / 1e3
    best, best_head = None, None
    for g in groups:
        if not g.queue:
            continue
        head = g.queue[0].t_arrival
        if len(g.queue) >= policy.max_batch or now - head >= delay_s:
            # strict < : equal heads go to the first group in
            # construction order, so reruns dispatch identically
            if best is None or head < best_head:
                best, best_head = g, head
    return best


_POLL_S = 2e-4       # base readiness-poll grain (REPRO_POLL_S overrides)
_POLL_CAP_S = 5e-3   # adaptive-grain ceiling: completion-detection bound


def _poll_base() -> float:
    """The busy-poll base grain: ``REPRO_POLL_S`` or the default; an
    invalid or non-positive value falls back to the default."""
    env = os.environ.get("REPRO_POLL_S")
    if env:
        try:
            v = float(env)
            if v > 0:
                return v
        except ValueError:
            pass
    return _POLL_S


def _poll_grain(now: float, horizon: Optional[float], *,
                base: float, cap: float = _POLL_CAP_S) -> float:
    """Busy-poll sleep while dispatches are in flight: stretches toward
    the idle horizon (nothing to admit or flush before it), never past
    ``cap`` (the completion-detection bound), never below ``base``."""
    if horizon is None:
        return base
    return min(max(base, horizon - now), cap)


def _idle_horizon(frames: List[_Frame], ai: int, groups: List[_Group],
                  delay_s: float) -> Optional[float]:
    """Next window-clock instant at which the idle loop can act: the next
    arrival or the earliest queue-delay expiry; None when neither exists.
    A horizon <= now means an admission or a flush is already due."""
    horizon = []
    if ai < len(frames):
        horizon.append(frames[ai].t_arrival)
    horizon.extend(g.queue[0].t_arrival + delay_s
                   for g in groups if g.queue)
    return min(horizon) if horizon else None


def serve_multitenant(streams: Sequence[StreamSpec], *,
                      policy: BatchPolicy = BatchPolicy(),
                      in_flight: int = 2,
                      devices=None, plan_policy: Optional[str] = None,
                      collect_outputs: bool = False,
                      pool=None, load_profile: str = "steady",
                      drain: str = "async",
                      donate: Optional[bool] = None, device=None) -> dict:
    """Serve N open-loop tenants through coalescing dynamic batching.

    One serving window: every frame of every stream is admitted at its
    arrival time, queued per config group, coalesced under ``policy``,
    run at the group's padded shape and timed from arrival to
    completion. Up to ``in_flight`` launched batches ride the ring;
    ``in_flight=1`` is the synchronous launch-block-retire loop.

    Every group is warmed before the window (`repro_torch.core.aot`:
    one CUDA graph of its padded engine on the card) and the cost is
    stamped (``warmup_s``). A `WarmPool` (`warm_pool`) starts the window
    warm: pool hits reuse the pooled executor at no warm cost, and
    groups warmed here are published back into it.

    ``drain``: a batch whose compute has settled leaves the ring and its
    D2H into pinned memory starts on the copy stream; ``"async"``
    harvests the images on a later pass, ``"block"`` waits for them at
    once.

    ``device`` is the card unless ``"cpu"``. ``devices``: two or more
    route every group through a `ShardedExecutor` (each batch split over
    the devices, one CUDA graph a shard; ``max_batch`` must divide
    evenly), the images gathered on the first, which the window meters.
    ``donate`` must be None or False: the port donates no buffer.
    ``plan_policy`` resolves `Variant.AUTO` tenants (``"autotune"``
    probes each group at its rows per device). ``collect_outputs=True``
    adds every served image (``outputs[stream_id][seq]``, numpy) to the
    stats, for the determinism oracle.

    Returns the reference's stats dict (schema: `repro_torch.bench.schema`,
    kind "multitenant" once stamped).
    """
    from repro_torch.bench.harness import (in_flight_stats, latency_stats,
                                           occupancy_stats)
    from repro_torch.bench.resources import ResourceMeter
    from repro_torch.bench.stats import bootstrap_ci
    from repro_torch.core.aot import WarmEntry, aot_warm
    from repro_torch.core.executor import resolve_devices

    if not streams:
        raise ValueError("serve_multitenant needs at least one stream")
    if in_flight < 1:
        raise ValueError(f"in_flight must be >= 1 (got {in_flight})")
    if drain not in ("async", "block"):
        raise ValueError(f"drain must be 'async' or 'block' "
                         f"(got {drain!r})")
    ids = [s.stream_id for s in streams]
    if len(set(ids)) != len(ids):
        raise ValueError(f"duplicate stream_id in {ids}")

    devs = resolve_devices(devices, device)
    dev = devs[0]
    cuda = dev.type == "cuda"
    sharded = len(devs) > 1
    specs = list(streams)
    groups, group_of_stream = _build_groups(
        specs, policy, devices=devs, plan_policy=plan_policy, pool=pool,
        donate=donate)
    frames, dropped_per_stream = _make_frames(specs)
    if not frames:
        raise ValueError(
            "every frame falls outside its stream's connect window — "
            "nothing to serve (check the trace's start_s/stop_s)")
    trace_sha256 = trace_of_streams(specs).sha256()

    # Meter before warm-up: the NVML idle baseline must see the board cold.
    meter = ResourceMeter(dev)

    for g in groups:
        if g.warm_source == "pool":
            continue
        prog = aot_warm(g.engine, policy.max_batch)
        g.warmup_s = prog.warmup_s
        if pool is not None:
            pool.put((g.key, policy.max_batch, len(devs), g.engine.donate),
                     WarmEntry(engine=g.engine, program=prog))
    warmup_s = sum(g.warmup_s for g in groups)

    # Per group, in_flight + 1 padded host slots (pinned on the card):
    # the least that never rewrites a slot whose copy may still run.
    for g in groups:
        g.ring = StagingRing(policy.max_batch, g.cfg.rf_shape,
                             g.cfg.rf_dtype, depth=in_flight,
                             pin_memory=cuda)

    outputs: Dict[str, dict] = {s.stream_id: {} for s in specs}
    delay_s = policy.max_queue_delay_ms / 1e3

    # ``pending``: launched, compute not known settled (the ring).
    # ``landing``: compute settled, images crossing D2H (async drain).
    pending: collections.deque = collections.deque()
    landing: collections.deque = collections.deque()
    dispatch_order: List[List[List[object]]] = []   # [[stream_id, seq]]
    depth_samples: List[int] = []
    busy_since: Optional[float] = None
    device_busy_s = 0.0
    sleep_while_busy_s = 0.0
    h2d_s = 0.0               # host time to issue the H2D commits (place)
    d2h_s = 0.0               # host time waiting for images to land
    poll_base = _poll_base()

    meter.start()
    t0 = time.perf_counter()

    def clk() -> float:
        return time.perf_counter() - t0

    def harvest(p: _Pending) -> int:
        """Bring a settled batch's images to the host; retire its frames.
        ``t_done`` is stamped once the images are on the host."""
        nonlocal d2h_s
        t = time.perf_counter()
        if p.landed is not None:
            p.landed.synchronize()
            out = p.host.numpy()
        else:
            out = p.out.numpy()
        d2h_s += time.perf_counter() - t
        t_done = clk()
        p.group.occupancies.append(len(p.batch))
        for i, f in enumerate(p.batch):
            f.t_dispatch, f.t_done = p.t_dispatch, t_done
            if collect_outputs:
                outputs[specs[f.stream].stream_id][f.seq] = out[i].copy()
        return len(p.batch)

    def start_d2h(p: _Pending) -> None:
        """Copy the images to pinned host memory on the group's copy
        stream, after the batch's compute event (and nothing else)."""
        copy = p.group.engine.copy_stream
        with torch.cuda.stream(copy):
            copy.wait_event(p.done)
            p.host = torch.empty(p.out.shape, dtype=p.out.dtype,
                                 pin_memory=True)
            p.host.copy_(p.out, non_blocking=True)
            p.landed = torch.cuda.Event()
            p.landed.record(copy)
        p.out.record_stream(copy)

    def drain_pending() -> int:
        """Retire settled pendings, oldest-first per group: scanning in
        launch order and skipping a group whose older batch is still
        pending, so a group's later batch never retires first."""
        nonlocal busy_since, device_busy_s
        retired = 0
        while landing:
            retired += harvest(landing.popleft())
        seen: set = set()
        for p in list(pending):
            if id(p.group) in seen:
                continue
            seen.add(id(p.group))
            if not _ready(p):
                continue
            meter.sample()     # detection: overlapped batches are live
            pending.remove(p)
            if cuda:
                start_d2h(p)
            if drain == "block" or not cuda:
                retired += harvest(p)      # waits for this batch's D2H
            else:
                landing.append(p)
        if not pending and busy_since is not None:
            device_busy_s += clk() - busy_since
            busy_since = None
        return retired

    ai, done = 0, 0
    while done < len(frames):
        now = clk()
        while ai < len(frames) and frames[ai].t_arrival <= now:
            f = frames[ai]
            ai += 1
            group_of_stream[f.stream].queue.append(f)

        done += drain_pending()

        if len(pending) < in_flight:
            g = _pick_group(groups, clk(), policy)
            if g is not None:
                batch = [g.queue.popleft()
                         for _ in range(min(len(g.queue),
                                            policy.max_batch))]
                # coalesce into the group's ring slot, issue the H2D on
                # the copy stream, launch after its event
                t_dispatch = clk()
                buf, _ = g.ring.stage([f.rf for f in batch])
                t = time.perf_counter()
                staged = g.engine.place(buf)
                h2d_s += time.perf_counter() - t
                out = g.engine.dispatch_staged(staged, policy.max_batch)
                if sharded:
                    out = g.engine.gather(out)
                ev = None
                if cuda:
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(dev))
                if busy_since is None:
                    busy_since = t_dispatch
                pending.append(_Pending(group=g, batch=batch, out=out,
                                        done=ev, t_dispatch=t_dispatch))
                dispatch_order.append(
                    [[specs[f.stream].stream_id, f.seq] for f in batch])
                g.depths.append(len(pending))
                depth_samples.append(len(pending))
                continue          # keep launching while the ring has room

        if landing:
            # images in flight D2H: finish them rather than sleep
            done += drain_pending()
            continue

        if pending:
            # device busy: poll readiness, the grain stretching toward
            # the idle horizon (capped); sleeps here count against the
            # overlap fraction
            dt = _poll_grain(clk(),
                             _idle_horizon(frames, ai, groups, delay_s),
                             base=poll_base)
            time.sleep(dt)
            sleep_while_busy_s += dt
            continue

        # fully idle: sleep to the next arrival or queue-delay expiry
        hz = _idle_horizon(frames, ai, groups, delay_s)
        if hz is not None:
            dt = hz - clk()
            if dt > 0:
                time.sleep(min(dt, 0.05))

    wall = clk()
    resources = meter.stop()
    stage_copy_s = sum(g.ring.stage_copy_s for g in groups)

    def budget(spec):
        return (spec.deadline_ms / 1e3
                if spec.deadline_ms is not None else None)

    per_stream = {}
    misses, with_budget = 0, 0
    for si, spec in enumerate(specs):
        fs = [f for f in frames if f.stream == si]
        lat = (latency_stats([f.t_done - f.t_arrival for f in fs],
                             budget_s=budget(spec)) if fs else None)
        qd = (latency_stats([f.t_dispatch - f.t_arrival for f in fs])
              if fs else None)
        if budget(spec) is not None:
            misses += sum(1 for f in fs
                          if f.t_done - f.t_arrival > budget(spec))
            with_budget += len(fs)
        per_stream[spec.stream_id] = {
            "pipeline": spec.cfg.name,
            "variant": group_of_stream[si].cfg.variant.value,
            "arrival_fps": spec.fps,
            "acquisitions": len(fs),           # served (admitted) frames
            "frames": len(fs) * spec.cfg.n_f,
            "dropped": dropped_per_stream[si],  # out-of-window arrivals
            "deadline_ms": spec.deadline_ms,
            "latency": lat.json_dict() if lat else None,
            "queue_delay": qd.json_dict() if qd else None,
            "deadline_miss_rate": lat.miss_rate if lat else 0.0,
        }

    # throughput counts what was served: dropped frames never reached
    # the device
    acqs = len(frames)
    total_frames = sum(per_stream[s.stream_id]["frames"] for s in specs)
    total_bytes = sum(
        per_stream[s.stream_id]["acquisitions"] * s.cfg.input_bytes
        for s in specs)
    all_occ = [n for g in groups for n in g.occupancies]
    overlap = max(0.0, (device_busy_s - sleep_while_busy_s) / wall)
    stats = {
        "name": (f"multitenant/{len(specs)}streams/{len(groups)}groups"
                 f"/b{policy.max_batch}q{policy.max_queue_delay_ms:g}"
                 f"if{in_flight}/{drain}/{load_profile}"),
        "clients": len(specs),
        "policy": policy.json_dict(),
        "in_flight": in_flight,
        "drain": drain,
        "load_profile": load_profile,
        "trace_sha256": trace_sha256,
        "dropped": sum(dropped_per_stream),
        "dispatch_order": dispatch_order,
        "wall_s": wall,
        "warmup_s": warmup_s,
        "acquisitions": acqs,
        "frames": total_frames,
        "sustained_mbps": total_bytes / (wall * 1e6),
        "fps": total_frames / wall,
        "acq_per_s": acqs / wall,
        # one window = one run: degenerate (zero-width) intervals
        "acq_per_s_ci": bootstrap_ci([acqs / wall]).json_dict(),
        "deadline_miss_rate": (misses / with_budget if with_budget
                               else 0.0),
        "device_busy_s": device_busy_s,
        "device_busy_frac": device_busy_s / wall,
        "overlap_frac": overlap,
        "device_busy_frac_ci": bootstrap_ci(
            [device_busy_s / wall]).json_dict(),
        "overlap_frac_ci": bootstrap_ci([overlap]).json_dict(),
        # host-thread-sequential slices of the wall: a true fraction
        "stage_copy_s": stage_copy_s,
        "h2d_s": h2d_s,
        "d2h_s": d2h_s,
        "transfer_frac": min(1.0, (stage_copy_s + h2d_s + d2h_s)
                             / wall) if wall > 0 else 0.0,
        "latency": latency_stats(
            [f.t_done - f.t_arrival for f in frames]).json_dict(),
        "queue_delay": latency_stats(
            [f.t_dispatch - f.t_arrival for f in frames]).json_dict(),
        "occupancy": occupancy_stats(all_occ,
                                     policy.max_batch).json_dict(),
        "in_flight_occupancy": in_flight_stats(
            depth_samples, in_flight).json_dict(),
        "per_stream": per_stream,
        "groups": {
            g.key: {
                "plan": g.engine.plan.with_serving(
                    warm_start=g.warm_source,
                    in_flight=in_flight).json_dict(),
                "streams": list(g.stream_ids),
                "batches": len(g.occupancies),
                "warmup_s": g.warmup_s,
                "warm_source": g.warm_source,
                "occupancy": (occupancy_stats(
                    g.occupancies, policy.max_batch).json_dict()
                    if g.occupancies else None),
                "in_flight": (in_flight_stats(
                    g.depths, in_flight).json_dict()
                    if g.depths else None),
            } for g in groups},
        "resources": resources.json_dict(),
    }
    if collect_outputs:
        stats["outputs"] = {
            sid: [seqs[k] for k in sorted(seqs)]
            for sid, seqs in outputs.items()}
    return stats
