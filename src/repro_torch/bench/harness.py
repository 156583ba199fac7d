"""The paper's benchmarking methodology (§II-E..I), as a harness (the
port's copy of the reference's, timed on the card).

`latency_stats`  — per-run samples -> `LatencyStats` (p50/p95/p99,
                   jitter = p95 - p50, deadline-miss rate); also used
                   for queue-delay distributions.
`occupancy_stats`— per-dispatch batch sizes -> `OccupancyStats`.
`in_flight_stats`— per-launch ring depth -> `InFlightStats`.
`bench_callable` — time a callable per the paper's execution model: a
                   `BenchResult` with the full sample distribution, the
                   plan stamp, measured `ResourceStats`, and, with
                   ``repeats`` > 1, the two-level bootstrap CI over the
                   per-repeat means (Kalibera & Jones).
`bench_stages`   — per-stage timing breakdown of the stage graph.
`write_json` / `write_ndjson` — telemetry serialization (the NDJSON
                   passes `repro_torch.bench.schema`).

Timing: on the card every sample is the device time of one call between
two CUDA events recorded on the current stream, synchronised after the
call; on the CPU it is the host clock around the call. Warm-up runs
never count. Metering never raises, and reports ``None`` — never zero —
for what it cannot measure.

  T_avg = mean(samples);  FPS = 1 / T_avg (eq. 1);
  MB/s = B_in / (T_avg * 1e6) (eq. 2);
  E_run modeled as utilization * (TDP - idle) * T_avg (eq. 3) with the
  H100 SXM's 700 W board limit and no idle term: an upper estimate,
  flagged as a model. The measured incremental energy is
  ``resources.energy_joules`` (NVML, None elsewhere).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

# Energy model constants (eq. 3 shape): NVIDIA H100 SXM board power limit.
CHIP_TDP_W = 700.0
CHIP_IDLE_W = 0.0


@dataclasses.dataclass
class LatencyStats:
    """Distribution summary of per-run wall-clock samples (seconds)."""

    n: int
    mean_s: float
    std_s: float
    p50_s: float
    p95_s: float
    p99_s: float
    jitter_s: float                       # p95 - p50
    budget_s: Optional[float] = None      # deadline per run, if configured
    miss_rate: float = 0.0                # fraction of samples > budget_s

    def json_dict(self) -> dict:
        return dataclasses.asdict(self)


def latency_stats(samples_s: List[float],
                  budget_s: Optional[float] = None) -> LatencyStats:
    """Summarize per-run samples into the distribution the tables report."""
    a = np.asarray(samples_s, dtype=np.float64)
    if a.size == 0:
        raise ValueError("latency_stats needs at least one sample")
    p50, p95, p99 = np.percentile(a, [50.0, 95.0, 99.0])
    miss = float((a > budget_s).mean()) if budget_s is not None else 0.0
    return LatencyStats(
        n=int(a.size), mean_s=float(a.mean()), std_s=float(a.std()),
        p50_s=float(p50), p95_s=float(p95), p99_s=float(p99),
        jitter_s=float(p95 - p50), budget_s=budget_s, miss_rate=miss)


# ---------------------------------------------------------------------------
# Batch occupancy (dynamic-batching scheduler telemetry)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OccupancyStats:
    """Distribution of per-dispatch batch occupancy under coalescing.

    One sample per dispatched batch: how many *valid* frames it carried
    against the policy's ``max_batch`` padding target. ``mean_fill``
    (mean occupancy / max_batch) is the fraction of dispatched compute
    that served real frames — the padding waste is ``1 - mean_fill`` —
    and ``full_rate`` is the fraction of dispatches at exactly
    ``max_batch`` (coalescing filled the batch before the queue-delay
    bound forced a partial flush).
    """

    batches: int
    frames: int
    max_batch: int
    mean_occupancy: float
    p50_occupancy: float
    min_occupancy: int
    max_occupancy: int
    mean_fill: float                      # mean_occupancy / max_batch
    full_rate: float                      # fraction dispatched at max_batch

    def json_dict(self) -> dict:
        return dataclasses.asdict(self)


def occupancy_stats(batch_sizes: List[int],
                    max_batch: int) -> OccupancyStats:
    """Summarize per-dispatch occupancy samples (scheduler invariant:
    no sample may exceed ``max_batch`` — checked here so a policy bug
    shows up in telemetry generation, not in silently wrong ratios)."""
    a = np.asarray(batch_sizes, dtype=np.int64)
    if a.size == 0:
        raise ValueError("occupancy_stats needs at least one batch")
    if max_batch < 1 or a.min() < 1 or a.max() > max_batch:
        raise ValueError(f"occupancy outside 1..{max_batch}: "
                         f"{a.min()}..{a.max()}")
    return OccupancyStats(
        batches=int(a.size), frames=int(a.sum()), max_batch=int(max_batch),
        mean_occupancy=float(a.mean()),
        p50_occupancy=float(np.percentile(a, 50.0)),
        min_occupancy=int(a.min()), max_occupancy=int(a.max()),
        mean_fill=float(a.mean() / max_batch),
        full_rate=float((a == max_batch).mean()))


@dataclasses.dataclass
class InFlightStats:
    """Distribution of in-flight dispatch depth at launch time.

    One sample per dispatched batch: how many dispatches (including the
    new one) were in flight the moment it launched, against the
    scheduler's ``in_flight`` ring bound. ``mean_depth`` near 1.0 means
    the window behaved synchronously (no overlap to win); ``full_rate``
    is the fraction of launches that filled the ring — sustained
    full-ring launches mean the device, not the host, is the
    bottleneck.
    """

    dispatches: int
    in_flight: int                        # the ring bound (the knob)
    mean_depth: float
    p50_depth: float
    max_depth: int
    full_rate: float                      # fraction launched at the bound

    def json_dict(self) -> dict:
        return dataclasses.asdict(self)


def in_flight_stats(depths: List[int], in_flight: int) -> InFlightStats:
    """Summarize per-launch in-flight depth samples (scheduler
    invariant: the bounded ring can never exceed ``in_flight`` —
    checked here, like `occupancy_stats`, so a ring bug surfaces in
    telemetry generation)."""
    a = np.asarray(depths, dtype=np.int64)
    if a.size == 0:
        raise ValueError("in_flight_stats needs at least one dispatch")
    if in_flight < 1 or a.min() < 1 or a.max() > in_flight:
        raise ValueError(f"in-flight depth outside 1..{in_flight}: "
                         f"{a.min()}..{a.max()}")
    return InFlightStats(
        dispatches=int(a.size), in_flight=int(in_flight),
        mean_depth=float(a.mean()),
        p50_depth=float(np.percentile(a, 50.0)),
        max_depth=int(a.max()),
        full_rate=float((a == in_flight).mean()))


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BenchResult:
    name: str
    t_avg_s: float
    fps: float
    mbps: float
    joules_per_run_model: float
    peak_mem_gb: float
    runs: int
    samples_s: List[float] = dataclasses.field(default_factory=list)
    stats: Optional[LatencyStats] = None
    # Two-level bootstrap CI over per-repeat means (bench.stats
    # CIStats.json_dict): {mean, ci_lo, ci_hi, n_runs, run_means, ...}.
    # n_runs == 1 (no --repeats) is the documented degenerate interval.
    ci: Optional[dict] = None
    # Per-repeat sample lists (level-two data behind `ci`); flattened
    # into samples_s for the legacy distribution columns.
    run_samples_s: List[List[float]] = dataclasses.field(
        default_factory=list)
    stage_breakdown: Dict[str, LatencyStats] = dataclasses.field(
        default_factory=dict)
    # Resolved execution plan (PipelinePlan.json_dict()): the exact
    # (backend, variant, exec_map, policy, devices) decision behind this
    # number.
    plan: Optional[dict] = None
    # Measured resource usage over the timed window
    # (ResourceStats.json_dict()): peak_memory_bytes + energy_joules,
    # None where the backend cannot measure them.
    resources: Optional[dict] = None
    # Stage-graph roofline stamp: per-stage {flops, bytes, t_roof_s,
    # pct_roofline, bound}; no producer of the port stamps it yet.
    roofline: Optional[dict] = None
    # Variance decomposition over the per-repeat sample lists
    # (bench.stats VarianceDecomposition.json_dict): within- vs
    # between-run share of the run-mean variance — the diagnostic that
    # sizes --repeats per backend. Stamped when repeats > 1.
    variance: Optional[dict] = None
    # Host-transfer telemetry stamp ({stage_copy_s, h2d_s, d2h_s,
    # transfer_frac}; schema TRANSFER_KEYS) for rows whose producer
    # measured the host edge — serving rows carry the keys flat, a
    # summary producer may attach this block.
    transfer: Optional[dict] = None

    def csv(self) -> str:
        """Legacy one-line CSV — format frozen (paper-table parsers)."""
        return (f"{self.name},{self.t_avg_s * 1e6:.1f},"
                f"fps={self.fps:.2f};mbps={self.mbps:.2f};"
                f"J_run_model={self.joules_per_run_model:.4f};"
                f"peak_gb={self.peak_mem_gb:.3f}")

    def json_dict(self) -> dict:
        d = {
            "name": self.name,
            "t_avg_s": self.t_avg_s,
            "fps": self.fps,
            "mbps": self.mbps,
            "joules_per_run_model": self.joules_per_run_model,
            "peak_mem_gb": self.peak_mem_gb,
            "runs": self.runs,
        }
        if self.plan is not None:
            d["plan"] = self.plan
        if self.resources is not None:
            d["resources"] = self.resources
        if self.ci is not None:
            d["ci"] = self.ci
        if self.roofline is not None:
            d["roofline"] = self.roofline
        if self.variance is not None:
            d["variance"] = self.variance
        if self.transfer is not None:
            d["transfer"] = self.transfer
        if self.stats is not None:
            d["latency"] = self.stats.json_dict()
        if self.stage_breakdown:
            d["stages"] = {k: v.json_dict()
                           for k, v in self.stage_breakdown.items()}
        return d

    def ndjson_lines(self) -> List[str]:
        """Telemetry records: summary, per-sample, per-stage lines.

        Every record carries the resolved plan (when one was stamped) so
        each row is independently attributable to an exact
        (backend, variant, exec_map) decision.
        """
        lines = [json.dumps({"kind": "summary", **self.json_dict()})]
        budget = self.stats.budget_s if self.stats else None
        for i, t in enumerate(self.samples_s):
            rec = {"kind": "sample", "name": self.name, "run": i, "t_s": t}
            if budget is not None:
                rec["deadline_missed"] = bool(t > budget)
            if self.plan is not None:
                rec["plan"] = self.plan
            if self.resources is not None:
                rec["resources"] = self.resources
            lines.append(json.dumps(rec))
        for stage, st in self.stage_breakdown.items():
            rec = {"kind": "stage", "name": self.name, "stage": stage,
                   **st.json_dict()}
            if self.plan is not None:
                rec["plan"] = self.plan
            lines.append(json.dumps(rec))
        return lines


def write_ndjson(path: str, results: List["BenchResult"],
                 extra_records: Optional[List[dict]] = None) -> None:
    with open(path, "w") as f:
        for r in results:
            for line in r.ndjson_lines():
                f.write(line + "\n")
        for rec in (extra_records or []):
            f.write(json.dumps(rec) + "\n")


def write_json(path: str, results: List["BenchResult"],
               extra: Optional[dict] = None) -> None:
    doc = {"schema": "repro-bench-v1",
           "results": [r.json_dict() for r in results]}
    if extra:
        doc.update(extra)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def _timed_samples(fn: Callable, args: tuple, *, device: torch.device,
                   warmup: int, runs: int, meter=None,
                   start_meter: bool = True) -> List[float]:
    """The paper's §II-E protocol: warm-up excluded, then one sample per
    run — CUDA events around the call on the card, the host clock on the
    CPU. ``meter`` starts after the warm-up and samples after each run,
    outside the timed bracket; ``start_meter=False`` keeps an open
    window running (repeats share one window)."""
    cuda = device.type == "cuda"
    for _ in range(warmup):
        fn(*args)
    if cuda:
        torch.cuda.synchronize(device)
    if meter is not None and start_meter:
        meter.start()
    samples: List[float] = []
    for _ in range(runs):
        if cuda:
            s, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            s.record()
            fn(*args)
            e.record()
            e.synchronize()
            samples.append(s.elapsed_time(e) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            samples.append(time.perf_counter() - t0)
        if meter is not None:
            meter.sample()
    return samples


def bench_callable(name: str, fn: Callable, args: tuple, *,
                   input_bytes: int, warmup: int = 2, runs: int = 5,
                   repeats: int = 1, utilization: float = 0.5,
                   deadline_s: Optional[float] = None,
                   plan=None, device=None) -> BenchResult:
    """Time ``fn(*args)`` per the paper's execution model.

    ``device`` is where ``fn`` runs (default: the device of the first
    tensor in ``args``, else the card). ``repeats`` repeats the timed
    window (warm-up paid once); the ``ci`` stamp is the two-level
    bootstrap CI over the per-repeat means (zero-width at one repeat).
    ``plan`` (a PipelinePlan or its json_dict) and the window's measured
    `ResourceStats` are stamped into the result.
    """
    from repro_torch.bench.resources import ResourceMeter, devices_of
    from repro_torch.bench.stats import bootstrap_ci, variance_decomposition
    from repro_torch.core.pipeline import resolve_device

    if repeats < 1:
        raise ValueError(f"repeats must be >= 1 (got {repeats})")
    if device is None:
        devs = devices_of(args)
        device = devs[0] if devs else None
    dev = resolve_device(device)
    if plan is not None and not isinstance(plan, dict):
        plan = plan.json_dict()

    meter = ResourceMeter(dev)
    run_samples = [_timed_samples(fn, args, device=dev, warmup=warmup,
                                  runs=runs, meter=meter)]
    for _ in range(repeats - 1):
        run_samples.append(_timed_samples(fn, args, device=dev, warmup=0,
                                          runs=runs, meter=meter,
                                          start_meter=False))
    resources = meter.stop()
    samples = [t for rs in run_samples for t in rs]
    t_avg = sum(samples) / len(samples)
    e_run = (CHIP_TDP_W - CHIP_IDLE_W) * utilization * t_avg
    peak = resources.peak_memory_bytes
    variance = (variance_decomposition(run_samples).json_dict()
                if repeats > 1 else None)
    return BenchResult(
        name=name, t_avg_s=t_avg, fps=1.0 / t_avg,
        mbps=input_bytes / (t_avg * 1e6),
        joules_per_run_model=e_run,
        peak_mem_gb=peak / 1e9 if peak is not None else 0.0, runs=runs,
        samples_s=samples, stats=latency_stats(samples, deadline_s),
        ci=bootstrap_ci(run_samples).json_dict(), run_samples_s=run_samples,
        plan=plan, resources=resources.json_dict(), variance=variance)


def bench_stages(cfg, rf, *, warmup: int = 1, runs: int = 3,
                 device=None) -> Dict[str, LatencyStats]:
    """Per-stage timing of the stage graph on ``device`` (the card unless
    ``"cpu"``): each stage timed on the real intermediate its
    predecessor produced, so the breakdown attributes end-to-end time to
    demod / beamform / head. Stage times need not sum to the end-to-end
    time of a fused plan."""
    from repro_torch.core import stages as stages_lib
    from repro_torch.core.pipeline import (consts_from_numpy, init_pipeline,
                                           resolve_device)

    dev = resolve_device(device)
    consts = consts_from_numpy(init_pipeline(cfg), dev)
    out: Dict[str, LatencyStats] = {}
    x = torch.as_tensor(rf).to(dev)
    for name, fn in stages_lib.stage_fns(cfg, dev.type).items():
        samples = _timed_samples(fn, (consts, x), device=dev,
                                 warmup=warmup, runs=runs)
        out[name] = latency_stats(samples)
        x = fn(consts, x)
    return out
