"""Latency distributions (the port's copy of the reference harness's)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


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
