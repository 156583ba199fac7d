"""Arrival processes and the versioned trace format (`repro-trace-v1`).

The port's copy of the reference's trace layer, so that both packages
replay the same load: the same generators give the same arrival floats
and the same ``trace_sha256`` for the same (profile, n_streams,
n_frames, base_fps, seed).

  * `ArrivalProcess` — when frame k of a stream arrives.
    `UniformArrival` is the open-loop default (``phase_s + k / fps``);
    `TraceArrival` replays recorded timestamps verbatim.
  * `StreamTrace` / `Trace` — per-stream arrival timestamps, nominal
    rate and a connect/disconnect window (``start_s`` / ``stop_s``).
    `Trace.sha256()` hashes the canonical JSON of the load identity
    (schema + streams, not the generator metadata).
  * `generate_trace` — seeded generators for the five load profiles:
    ``steady`` (the uniform schedule), ``burst`` (clusters at ~10x rate
    between seeded quiet gaps), ``diurnal_ramp`` (slow-fast-slow),
    ``churn`` (staggered connects, odd probes disconnect mid-stream)
    and ``adversarial`` (one saturating tenant, many sparse ones).

Churn: frames whose arrival timestamp is at/after ``stop_s`` (or before
``start_s``) are dropped at admission; frames that arrived before it
always drain. Both depend on timestamps only, never on the wall clock.

Errors are named: `EmptyTraceError` for a trace with no streams or a
stream with no arrivals, `TraceError` for schema or monotonicity
violations.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Optional, Sequence, Tuple

import numpy as np

TRACE_SCHEMA = "repro-trace-v1"

PROFILES = ("steady", "burst", "diurnal_ramp", "churn", "adversarial")

__all__ = ["TRACE_SCHEMA", "PROFILES", "TraceError", "EmptyTraceError",
           "ArrivalProcess", "UniformArrival", "TraceArrival",
           "StreamTrace", "Trace", "generate_trace", "load_trace",
           "mixed_phase", "mixed_rate", "seed_space"]


class TraceError(ValueError):
    """A trace violates the repro-trace-v1 contract."""


class EmptyTraceError(TraceError):
    """A trace with no streams, or a stream with no arrivals — there is
    nothing to replay, and silently serving zero frames would stamp a
    vacuous throughput record."""


def seed_space(*parts) -> int:
    """Disjoint deterministic seed spaces via SHA-256.

    Hashing the full identity tuple spreads every (namespace, base seed,
    index) into its own 63-bit region, stable across processes (unlike
    ``hash()``), so two sources with nearby base seeds never stream the
    same RF.
    """
    text = "/".join(str(p) for p in parts)
    digest = hashlib.sha256(text.encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big") >> 1   # fit a non-neg int64


def mixed_rate(i: int, base_fps: float) -> float:
    """Nominal rate of mixed-traffic tenant i: ``base_fps / (1 + i/2)``.

    Shared by `repro_torch.launch.scheduler.make_mixed_streams` and the
    ``steady`` generator so the uniform serving path and the steady
    trace replay compute the SAME floats — bit-identical arrivals, one
    trace_sha256.
    """
    return base_fps / (1 + i / 2)


def mixed_phase(i: int, base_fps: float) -> float:
    """Phase stagger of mixed-traffic tenant i (1/4 of the fastest
    period per tenant) — same sharing contract as `mixed_rate`."""
    return i * 0.25 / base_fps


# ---------------------------------------------------------------------------
# Arrival processes
# ---------------------------------------------------------------------------


class ArrivalProcess:
    """When does frame k of a stream arrive? (window-clock seconds)"""

    def arrival_s(self, k: int) -> float:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class UniformArrival(ArrivalProcess):
    """The historical open-loop default: frame k at ``phase_s + k/fps``."""

    fps: float
    phase_s: float = 0.0

    def __post_init__(self):
        if self.fps <= 0:
            raise TraceError(f"fps must be > 0 (got {self.fps})")

    def arrival_s(self, k: int) -> float:
        return self.phase_s + k / self.fps


@dataclasses.dataclass(frozen=True)
class TraceArrival(ArrivalProcess):
    """Replays recorded timestamps bit-identically: frame k arrives at
    exactly ``arrivals[k]`` — no re-derivation, no float drift."""

    arrivals: Tuple[float, ...]

    def __post_init__(self):
        object.__setattr__(self, "arrivals", tuple(self.arrivals))
        if not self.arrivals:
            raise EmptyTraceError("TraceArrival needs >= 1 timestamp")

    def arrival_s(self, k: int) -> float:
        return self.arrivals[k]

    def __len__(self) -> int:
        return len(self.arrivals)


# ---------------------------------------------------------------------------
# Versioned trace format
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamTrace:
    """One tenant's recorded load: arrivals + connect/disconnect window.

    ``fps`` is the nominal offered rate (telemetry stamp — arrivals are
    authoritative). Arrivals outside ``[start_s, stop_s)`` are legal in
    the format and deterministically dropped at admission (churn: the
    probe disconnected while its clock kept producing).
    """

    stream_id: str
    arrivals: Tuple[float, ...]
    fps: float
    start_s: float = 0.0
    stop_s: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "arrivals", tuple(
            float(t) for t in self.arrivals))
        if not self.stream_id:
            raise TraceError("stream_id must be non-empty")
        if not self.arrivals:
            raise EmptyTraceError(
                f"stream {self.stream_id!r} has no arrivals")
        if self.fps <= 0:
            raise TraceError(f"stream {self.stream_id!r}: fps must be "
                             f"> 0 (got {self.fps})")
        a = np.asarray(self.arrivals)
        if a.min() < 0.0:
            raise TraceError(f"stream {self.stream_id!r}: negative "
                             f"arrival timestamp {a.min()}")
        if np.any(np.diff(a) < 0):
            raise TraceError(f"stream {self.stream_id!r}: arrivals are "
                             f"not non-decreasing")
        if self.start_s < 0.0:
            raise TraceError(f"stream {self.stream_id!r}: start_s must "
                             f"be >= 0 (got {self.start_s})")
        if self.stop_s is not None and self.stop_s <= self.start_s:
            raise TraceError(
                f"stream {self.stream_id!r}: stop_s={self.stop_s} must "
                f"be > start_s={self.start_s}")

    def json_dict(self) -> dict:
        return {"stream_id": self.stream_id, "fps": self.fps,
                "start_s": self.start_s, "stop_s": self.stop_s,
                "arrivals": list(self.arrivals)}


@dataclasses.dataclass(frozen=True)
class Trace:
    """A replayable multi-tenant load: N streams of arrival timestamps.

    ``profile`` / ``seed`` are generator metadata — they travel with a
    saved trace but are EXCLUDED from `sha256()`, so provenance
    identifies the load itself: a recorded trace and a generated one
    with identical timestamps hash the same.
    """

    streams: Tuple[StreamTrace, ...]
    profile: Optional[str] = None
    seed: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "streams", tuple(self.streams))
        if not self.streams:
            raise EmptyTraceError("trace has no streams")
        ids = [s.stream_id for s in self.streams]
        if len(set(ids)) != len(ids):
            raise TraceError(f"duplicate stream_id in {ids}")

    @property
    def n_frames(self) -> int:
        return sum(len(s.arrivals) for s in self.streams)

    def identity_dict(self) -> dict:
        """The hashed load identity: schema + streams, no metadata."""
        return {"schema": TRACE_SCHEMA,
                "streams": [s.json_dict() for s in self.streams]}

    def json_dict(self) -> dict:
        return {**self.identity_dict(), "profile": self.profile,
                "seed": self.seed}

    def sha256(self) -> str:
        """Provenance hash over the canonical load-identity JSON.

        `json.dumps` emits ``repr(float)`` which round-trips exactly,
        so save -> load -> sha256 is a fixed point: the stamp in a
        benchmark record names the byte-identical arrival schedule.
        """
        canonical = json.dumps(self.identity_dict(), sort_keys=True,
                               separators=(",", ":"))
        return hashlib.sha256(canonical.encode("utf-8")).hexdigest()

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.json_dict(), f, indent=1, sort_keys=True)
            f.write("\n")


def load_trace(path: str) -> Trace:
    """Load and validate a saved trace; raises the named errors."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("schema") != TRACE_SCHEMA:
        raise TraceError(
            f"{path}: not a {TRACE_SCHEMA} trace "
            f"(schema={doc.get('schema') if isinstance(doc, dict) else None!r})")
    streams = doc.get("streams")
    if not isinstance(streams, list):
        raise TraceError(f"{path}: 'streams' must be a list")
    return Trace(
        streams=tuple(StreamTrace(
            stream_id=s["stream_id"], arrivals=tuple(s["arrivals"]),
            fps=s["fps"], start_s=s.get("start_s", 0.0),
            stop_s=s.get("stop_s")) for s in streams),
        profile=doc.get("profile"), seed=doc.get("seed"))


# ---------------------------------------------------------------------------
# Seeded profile generators
# ---------------------------------------------------------------------------


def _rng(seed: int, profile: str, i: int) -> np.random.Generator:
    return np.random.default_rng(seed_space("trace", seed, profile, i))


def _steady(i, n_frames, base_fps, rng):
    fps = mixed_rate(i, base_fps)
    phase = mixed_phase(i, base_fps)
    # Same expression tree as UniformArrival.arrival_s under
    # make_mixed_streams' parameters -> bit-identical floats.
    return [phase + k / fps for k in range(n_frames)], fps, 0.0, None


def _burst(i, n_frames, base_fps, rng):
    """Clusters of up to 4 arrivals at 10x rate, seeded quiet gaps."""
    fps = mixed_rate(i, base_fps)
    burst_len = max(1, min(4, n_frames))
    t = mixed_phase(i, base_fps)
    arrivals = []
    for k in range(n_frames):
        arrivals.append(t)
        if (k + 1) % burst_len == 0:
            t += (burst_len / fps) * (0.5 + float(rng.uniform()))
        else:
            t += 0.1 / fps
    return arrivals, fps, 0.0, None


def _diurnal_ramp(i, n_frames, base_fps, rng):
    """Rate swings 0.25x -> 1x -> 0.25x of nominal over the stream —
    the diurnal load curve compressed into one window."""
    fps = mixed_rate(i, base_fps)
    t = mixed_phase(i, base_fps)
    arrivals = []
    for k in range(n_frames):
        arrivals.append(t)
        mod = 0.25 + 0.75 * 0.5 * (1.0 - math.cos(
            2.0 * math.pi * (k + 1) / n_frames))
        t += 1.0 / (fps * mod)
    return arrivals, fps, 0.0, None


def _churn(i, n_frames, base_fps, rng):
    """Staggered connects; odd probes disconnect at 60% of their run —
    their tail arrivals land past ``stop_s`` and are dropped at
    admission, exercising the retire path deterministically."""
    fps = mixed_rate(i, base_fps)
    start = i * 0.25 * n_frames / base_fps
    arrivals = [start + k / fps for k in range(n_frames)]
    stop = None
    if i % 2 == 1:
        keep = max(1, int(math.ceil(0.6 * n_frames)))
        # Disconnect half a period after the last kept arrival: frames
        # 0..keep-1 are in the window, keep.. are dropped.
        stop = start + (keep - 0.5) / fps if keep < n_frames else None
    return arrivals, fps, start, stop


def _adversarial(i, n_frames, base_fps, rng):
    """Tenant 0 saturates (50x nominal, one long burst); everyone else
    trickles at base_fps/8 — the starvation scenario `_pick_group`'s
    oldest-eligible-head rule exists for."""
    if i == 0:
        fps = 50.0 * base_fps
        return [k / fps for k in range(n_frames)], fps, 0.0, None
    fps = base_fps / 8.0
    phase = mixed_phase(i, base_fps)
    return [phase + k / fps for k in range(n_frames)], fps, 0.0, None


_GENERATORS = {"steady": _steady, "burst": _burst,
               "diurnal_ramp": _diurnal_ramp, "churn": _churn,
               "adversarial": _adversarial}
assert tuple(_GENERATORS) == PROFILES


def generate_trace(profile: str, *, n_streams: int = 4,
                   n_frames: int = 16, base_fps: float = 120.0,
                   seed: int = 0) -> Trace:
    """Deterministic seeded trace for one of the named load profiles.

    Stream i is named ``probe{i}`` and carries ``n_frames`` arrival
    timestamps — the same tenant naming and count contract as
    `make_mixed_streams`, so `make_trace_streams` replays a generated
    trace onto the same config/seed assignment the uniform path uses.
    Identical (profile, n_streams, n_frames, base_fps, seed) always
    yields a byte-identical trace (PRNG seeded via `seed_space`).
    """
    if profile not in PROFILES:
        raise TraceError(f"unknown profile {profile!r} "
                         f"(expected one of {PROFILES})")
    if n_streams < 1:
        raise TraceError(f"n_streams must be >= 1 (got {n_streams})")
    if n_frames < 1:
        raise EmptyTraceError(f"n_frames must be >= 1 (got {n_frames})")
    if base_fps <= 0:
        raise TraceError(f"base_fps must be > 0 (got {base_fps})")

    gen = _GENERATORS[profile]
    streams = []
    for i in range(n_streams):
        arrivals, fps, start, stop = gen(i, n_frames, base_fps,
                                         _rng(seed, profile, i))
        streams.append(StreamTrace(
            stream_id=f"probe{i}", arrivals=tuple(arrivals), fps=fps,
            start_s=start, stop_s=stop))
    return Trace(streams=tuple(streams), profile=profile, seed=seed)
