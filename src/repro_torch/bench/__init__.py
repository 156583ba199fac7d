"""repro_torch.bench — the benchmarking harness, resource meters and
statistics of the port (the reference's `repro.bench` surface)."""

from repro_torch.bench.harness import (  # noqa: F401
    BenchResult,
    InFlightStats,
    LatencyStats,
    OccupancyStats,
    bench_callable,
    bench_stages,
    in_flight_stats,
    latency_stats,
    occupancy_stats,
    write_json,
    write_ndjson,
)
from repro_torch.bench.resources import (  # noqa: F401
    NvmlEnergyMeter,
    ResourceMeter,
    ResourceStats,
)
from repro_torch.bench.stats import (  # noqa: F401
    CIStats,
    GateDecision,
    RatioCI,
    bootstrap_ci,
    ci_ratio,
    gate_ratio,
)
# NDJSON schema validation lives in repro_torch.bench.schema, imported
# directly so `python -m repro_torch.bench.schema` runs it once.

__all__ = [
    "BenchResult",
    "CIStats",
    "GateDecision",
    "InFlightStats",
    "LatencyStats",
    "NvmlEnergyMeter",
    "OccupancyStats",
    "RatioCI",
    "ResourceMeter",
    "ResourceStats",
    "bench_callable",
    "bench_stages",
    "bootstrap_ci",
    "ci_ratio",
    "gate_ratio",
    "in_flight_stats",
    "latency_stats",
    "occupancy_stats",
    "write_json",
    "write_ndjson",
]
