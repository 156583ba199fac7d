"""NDJSON telemetry schema validation (`repro-bench-v1`), the port's
copy, so that the records the port writes are held to the same schema
as the reference's:

  PYTHONPATH=src python -m repro_torch.bench.schema OUT.ndjson \
      --require-kind multitenant

Validation is structural: required keys and JSON types per record
``kind``, plus the nested `plan`, `resources`, `latency`, `occupancy`,
`ci` / `acq_per_s_ci` and `roofline` blocks. ``None`` is legal exactly
where a producer means "not measurable on this backend" (energy without
NVML, budget_s without a deadline); a missing key is always an error.
"""

from __future__ import annotations

import argparse
import json
import numbers
import sys
from typing import Dict, Iterable, Optional, Tuple

SCHEMA = "repro-bench-v1"

# Type tokens: "str" / "int" / "real" / "bool" / "dict" / "list".
# A "?" suffix additionally admits None (nullable column, never absent).
_CHECKS = {
    "str": lambda v: isinstance(v, str),
    "int": lambda v: isinstance(v, numbers.Integral)
    and not isinstance(v, bool),
    "real": lambda v: isinstance(v, numbers.Real)
    and not isinstance(v, bool),
    "bool": lambda v: isinstance(v, bool),
    "dict": lambda v: isinstance(v, dict),
    "list": lambda v: isinstance(v, (list, tuple)),
}

LATENCY_KEYS: Dict[str, str] = {
    "n": "int", "mean_s": "real", "std_s": "real", "p50_s": "real",
    "p95_s": "real", "p99_s": "real", "jitter_s": "real",
    "budget_s": "real?", "miss_rate": "real",
}

# CIStats.json_dict (repro_torch.bench.stats): the two-level bootstrap
# confidence interval the statistical regression gate compares.
# `run_means` is the level-one data — committed baselines must carry it
# so a later gate can bootstrap a ratio CI against fresh runs.
CI_KEYS: Dict[str, str] = {
    "mean": "real", "ci_lo": "real", "ci_hi": "real", "n_runs": "int",
    "confidence": "real", "n_boot": "int", "seed": "int",
    "method": "str", "run_means": "list",
}

# Per-stage roofline stamp (the reference's roofline report): analytic
# bytes/FLOPs from the compiled HLO vs calibrated machine peaks.
ROOFLINE_STAGE_KEYS: Dict[str, str] = {
    "flops": "real", "bytes": "real", "t_measured_s": "real",
    "t_roof_s": "real", "pct_roofline": "real", "bound": "str",
}

PLAN_KEYS: Dict[str, str] = {
    "policy": "str", "backend": "str", "variant": "str",
    "exec_map": "str", "donate": "bool?", "jit_stages": "dict",
    "stage_lowerings": "dict",
    # Fusion/precision contract stamp: both are required (never absent)
    # so a fused/bf16 row can never masquerade as an unfused/f32 one;
    # group/block are null exactly when fusion == "none".
    "fusion": "str", "precision": "str",
    "fusion_group": "str?", "fusion_block": "int?",
    "config_key": "str", "geometry_key": "str", "provenance": "str",
    "devices": "int", "mesh_shape": "list?",
    # Serving-context stamp: how the program reached the device. Null
    # outside a serving window; `warm_start` is "aot" (compiled this
    # process) or "pool" (reused a WarmPool entry), `in_flight` is the
    # scheduler's dispatch-ring bound the row ran under.
    "warm_start": "str?", "in_flight": "int?",
}

RESOURCE_KEYS: Dict[str, str] = {
    "peak_memory_bytes": "int?", "memory_source": "str?",
    "energy_joules": "real?", "energy_source": "str?",
    "devices": "int", "duration_s": "real?",
}

OCCUPANCY_KEYS: Dict[str, str] = {
    "batches": "int", "frames": "int", "max_batch": "int",
    "mean_occupancy": "real", "p50_occupancy": "real",
    "min_occupancy": "int", "max_occupancy": "int",
    "mean_fill": "real", "full_rate": "real",
}

# InFlightStats.json_dict — the dispatch ring's depth distribution.
INFLIGHT_KEYS: Dict[str, str] = {
    "dispatches": "int", "in_flight": "int", "mean_depth": "real",
    "p50_depth": "real", "max_depth": "int", "full_rate": "real",
}

# Host-transfer telemetry block (optional on summary records; the
# multitenant keys are required flat — see RECORD_KEYS). All three
# components are host-thread-sequential slices of the wall, so
# transfer_frac is a true fraction.
TRANSFER_KEYS: Dict[str, str] = {
    "stage_copy_s": "real", "h2d_s": "real", "d2h_s": "real",
    "transfer_frac": "real",
}

# VarianceDecomposition.json_dict (repro_torch.bench.stats): within- vs
# between-run share of the run-mean variance — sizes --repeats.
VARIANCE_KEYS: Dict[str, str] = {
    "n_runs": "int", "mean_iters": "real", "within_var": "real",
    "between_var": "real", "within_share": "real",
    "between_share": "real",
}

# Per-stream block inside a multitenant record (one per client).
# `latency` / `queue_delay` are null exactly when the stream served
# zero frames (fully dropped by a churn disconnect); `dropped` counts
# the out-of-window arrivals that never reached the scheduler.
MT_STREAM_KEYS: Dict[str, str] = {
    "pipeline": "str", "variant": "str", "arrival_fps": "real",
    "frames": "int", "acquisitions": "int", "dropped": "int",
    "latency": "dict?", "queue_delay": "dict?",
    "deadline_miss_rate": "real",
}

# kind -> required top-level keys. Stamps (plan/resources/latency/
# occupancy) listed here are REQUIRED for that kind; extra keys are
# always permitted (schema grows forward-compatibly).
RECORD_KEYS: Dict[str, Dict[str, str]] = {
    "summary": {
        "name": "str", "t_avg_s": "real", "fps": "real", "mbps": "real",
        "joules_per_run_model": "real", "peak_mem_gb": "real",
        "runs": "int", "latency": "dict", "ci": "dict",
    },
    "sample": {"name": "str", "run": "int", "t_s": "real"},
    "stage": {"name": "str", "stage": "str", **LATENCY_KEYS},
    "stream": {
        "name": "str", "batch": "int", "n_batches": "int", "depth": "int",
        "plan": "dict", "wall_s": "real", "acquisitions": "int",
        "frames": "int", "sustained_mbps": "real", "fps": "real",
        "acq_per_s": "real", "latency": "dict", "resources": "dict",
    },
    "scaling": {
        "name": "str", "plan": "dict", "devices": "int",
        "batch_per_device": "int", "batch": "int", "n_batches": "int",
        "wall_s": "real", "fps": "real", "sustained_mbps": "real",
        "peak_memory_bytes": "int?", "memory_source": "str?",
        "energy_joules": "real?", "joules_per_frame": "real?",
        "speedup_vs_single": "real?", "scale_efficiency": "real?",
        "latency": "dict",
    },
    "multitenant": {
        "name": "str", "clients": "int", "policy": "dict",
        "in_flight": "int", "wall_s": "real", "warmup_s": "real",
        "acquisitions": "int", "frames": "int",
        "sustained_mbps": "real", "fps": "real", "acq_per_s": "real",
        "acq_per_s_ci": "dict", "deadline_miss_rate": "real",
        "device_busy_s": "real", "device_busy_frac": "real",
        "overlap_frac": "real",
        # Overlap-column intervals (degenerate without --repeats) so
        # the gate can apply CI-exclusion beyond acq_per_s.
        "device_busy_frac_ci": "dict", "overlap_frac_ci": "dict",
        # Host-transfer telemetry + the drain mode that produced it
        # ("async" = copy_to_host_async at retirement detection,
        # "block" = synchronous D2H — part of the gate cell identity).
        "drain": "str", **TRANSFER_KEYS,
        "latency": "dict",
        "queue_delay": "dict", "occupancy": "dict",
        "in_flight_occupancy": "dict",
        "per_stream": "dict", "groups": "dict", "resources": "dict",
        # Load provenance (repro_torch.launch.scheduler): the scenario name
        # (gate cell identity) and the repro-trace-v1 hash of the exact
        # arrival schedule served; `dropped` counts out-of-window
        # (churn-disconnected) frames across all streams.
        "load_profile": "str", "trace_sha256": "str", "dropped": "int",
    },
}

MT_POLICY_KEYS: Dict[str, str] = {
    "max_batch": "int", "max_queue_delay_ms": "real",
}


class SchemaError(AssertionError):
    """A telemetry record violates the repro-bench-v1 schema."""


def _check(rec: dict, keys: Dict[str, str], path: str) -> None:
    for key, token in keys.items():
        if key not in rec:
            raise SchemaError(f"{path}: missing required key {key!r}")
        nullable = token.endswith("?")
        v = rec[key]
        if v is None:
            if not nullable:
                raise SchemaError(f"{path}.{key}: null not allowed")
            continue
        if not _CHECKS[token.rstrip("?")](v):
            raise SchemaError(
                f"{path}.{key}: expected {token}, got "
                f"{type(v).__name__} ({v!r})")


def _check_latency(lat: dict, path: str) -> None:
    _check(lat, LATENCY_KEYS, path)
    if not (lat["p50_s"] <= lat["p95_s"] <= lat["p99_s"]):
        raise SchemaError(f"{path}: percentiles not monotone "
                          f"(p50={lat['p50_s']}, p95={lat['p95_s']}, "
                          f"p99={lat['p99_s']})")


def _check_ci(ci: dict, path: str) -> None:
    _check(ci, CI_KEYS, path)
    if not (ci["ci_lo"] <= ci["mean"] <= ci["ci_hi"]):
        raise SchemaError(
            f"{path}: interval does not contain its point estimate "
            f"(ci_lo={ci['ci_lo']}, mean={ci['mean']}, "
            f"ci_hi={ci['ci_hi']})")
    if ci["n_runs"] < 1:
        raise SchemaError(f"{path}.n_runs: expected >= 1, "
                          f"got {ci['n_runs']}")
    if len(ci["run_means"]) != ci["n_runs"]:
        raise SchemaError(
            f"{path}.run_means: {len(ci['run_means'])} entries but "
            f"n_runs={ci['n_runs']} — a baseline without its level-one "
            f"data cannot be re-bootstrapped")


def _check_roofline(roof: dict, path: str) -> None:
    if not roof:
        raise SchemaError(f"{path}: empty")
    for stage, row in roof.items():
        if not isinstance(row, dict):
            raise SchemaError(f"{path}[{stage}]: expected dict, got "
                              f"{type(row).__name__}")
        _check(row, ROOFLINE_STAGE_KEYS, f"{path}[{stage}]")
        if row["pct_roofline"] < 0.0:
            raise SchemaError(f"{path}[{stage}].pct_roofline: negative")


def validate_record(rec: dict, path: str = "record") -> str:
    """Validate one NDJSON record; returns its kind, raises SchemaError.

    The `plan` / `resources` stamps are validated structurally wherever
    they appear (and are *required* where RECORD_KEYS says so); latency
    blocks additionally assert percentile monotonicity.
    """
    if not isinstance(rec, dict):
        raise SchemaError(f"{path}: not a JSON object")
    kind = rec.get("kind")
    if kind not in RECORD_KEYS:
        raise SchemaError(
            f"{path}: unknown kind {kind!r} "
            f"(expected one of {sorted(RECORD_KEYS)})")
    _check(rec, RECORD_KEYS[kind], path)

    if "plan" in rec and rec["plan"] is not None:
        _check(rec["plan"], PLAN_KEYS, f"{path}.plan")
        for stage, name in rec["plan"]["stage_lowerings"].items():
            if not isinstance(name, str):
                raise SchemaError(
                    f"{path}.plan.stage_lowerings[{stage}]: expected a "
                    f"lowering name string, got {type(name).__name__} "
                    f"({name!r})")
    if "resources" in rec and rec["resources"] is not None:
        _check(rec["resources"], RESOURCE_KEYS, f"{path}.resources")
    if "ci" in rec and rec["ci"] is not None:
        _check_ci(rec["ci"], f"{path}.ci")
    if "roofline" in rec and rec["roofline"] is not None:
        _check_roofline(rec["roofline"], f"{path}.roofline")
    if "transfer" in rec and rec["transfer"] is not None:
        _check(rec["transfer"], TRANSFER_KEYS, f"{path}.transfer")
        tf = rec["transfer"]["transfer_frac"]
        if not 0.0 <= tf <= 1.0:
            raise SchemaError(
                f"{path}.transfer.transfer_frac: expected a fraction "
                f"in [0, 1], got {tf!r}")
    if "variance" in rec and rec["variance"] is not None:
        _check(rec["variance"], VARIANCE_KEYS, f"{path}.variance")
        for share in ("within_share", "between_share"):
            v = rec["variance"][share]
            if not 0.0 <= v <= 1.0:
                raise SchemaError(
                    f"{path}.variance.{share}: expected a fraction in "
                    f"[0, 1], got {v!r}")
    if kind == "stage":
        _check_latency(rec, path)
    elif "latency" in rec and rec["latency"] is not None:
        _check_latency(rec["latency"], f"{path}.latency")
    if "queue_delay" in rec and rec["queue_delay"] is not None:
        _check_latency(rec["queue_delay"], f"{path}.queue_delay")
    if "occupancy" in rec and rec["occupancy"] is not None:
        _check(rec["occupancy"], OCCUPANCY_KEYS, f"{path}.occupancy")

    if kind == "multitenant":
        _check(rec["policy"], MT_POLICY_KEYS, f"{path}.policy")
        _check_ci(rec["acq_per_s_ci"], f"{path}.acq_per_s_ci")
        _check_ci(rec["device_busy_frac_ci"],
                  f"{path}.device_busy_frac_ci")
        _check_ci(rec["overlap_frac_ci"], f"{path}.overlap_frac_ci")
        _check(rec["in_flight_occupancy"], INFLIGHT_KEYS,
               f"{path}.in_flight_occupancy")
        if rec["drain"] not in ("async", "block"):
            raise SchemaError(
                f"{path}.drain: expected 'async' or 'block', "
                f"got {rec['drain']!r}")
        sha = rec["trace_sha256"]
        if len(sha) != 64 or any(c not in "0123456789abcdef"
                                 for c in sha):
            raise SchemaError(
                f"{path}.trace_sha256: expected 64 lowercase hex chars "
                f"(a repro-trace-v1 provenance hash), got {sha!r}")
        for frac in ("device_busy_frac", "overlap_frac",
                     "transfer_frac"):
            if not 0.0 <= rec[frac] <= 1.0:
                raise SchemaError(
                    f"{path}.{frac}: expected a fraction in [0, 1], "
                    f"got {rec[frac]!r}")
        if not rec["per_stream"]:
            raise SchemaError(f"{path}.per_stream: empty")
        for sid, s in rec["per_stream"].items():
            spath = f"{path}.per_stream[{sid}]"
            _check(s, MT_STREAM_KEYS, spath)
            # Null latency blocks are legal only for a stream that
            # served nothing (every arrival dropped out-of-window).
            if s["latency"] is not None:
                _check_latency(s["latency"], f"{spath}.latency")
            if s["queue_delay"] is not None:
                _check_latency(s["queue_delay"], f"{spath}.queue_delay")
            if s["latency"] is None and s["acquisitions"] > 0:
                raise SchemaError(
                    f"{spath}.latency: null but the stream served "
                    f"{s['acquisitions']} acquisitions")
        if not rec["groups"]:
            raise SchemaError(f"{path}.groups: empty")
        for gid, g in rec["groups"].items():
            gpath = f"{path}.groups[{gid}]"
            _check(g, {"plan": "dict", "streams": "list",
                       "batches": "int", "occupancy": "dict?",
                       "warmup_s": "real", "warm_source": "str",
                       "in_flight": "dict?"}, gpath)
            _check(g["plan"], PLAN_KEYS, f"{gpath}.plan")
            # Null distributions are legal only for a group that
            # launched zero batches (all streams fully dropped).
            if g["occupancy"] is not None:
                _check(g["occupancy"], OCCUPANCY_KEYS,
                       f"{gpath}.occupancy")
            elif g["batches"] > 0:
                raise SchemaError(
                    f"{gpath}.occupancy: null but the group launched "
                    f"{g['batches']} batches")
            if g["in_flight"] is not None:
                _check(g["in_flight"], INFLIGHT_KEYS,
                       f"{gpath}.in_flight")
    return kind


def validate_lines(lines: Iterable[str], *,
                   source: str = "<ndjson>") -> Dict[str, int]:
    """Validate NDJSON lines; returns {kind: count}, raises SchemaError."""
    counts: Dict[str, int] = {}
    n = 0
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            raise SchemaError(f"{source}:{i + 1}: invalid JSON: {e}")
        kind = validate_record(rec, f"{source}:{i + 1}")
        counts[kind] = counts.get(kind, 0) + 1
        n += 1
    if n == 0:
        raise SchemaError(f"{source}: no NDJSON records")
    return counts


def validate_ndjson(path: str) -> Dict[str, int]:
    """Validate a telemetry file; returns {kind: count}."""
    with open(path) as f:
        return validate_lines(f, source=path)


def main(argv: Optional[Tuple[str, ...]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Validate repro-bench-v1 NDJSON telemetry files.")
    ap.add_argument("paths", nargs="+", help="NDJSON files to validate")
    ap.add_argument("--require-kind", action="append", default=[],
                    metavar="KIND",
                    help="fail unless at least one record of KIND exists "
                         "across the given files (repeatable)")
    ap.add_argument("--require-multidevice", action="store_true",
                    help="fail unless some record ran on >= 2 devices")
    args = ap.parse_args(argv)

    totals: Dict[str, int] = {}
    multidevice = False
    try:
        for path in args.paths:
            counts = validate_ndjson(path)
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
            if args.require_multidevice and not multidevice:
                with open(path) as f:
                    multidevice = any(
                        json.loads(line).get("devices", 1) >= 2
                        for line in f if line.strip())
            print(f"{path}: " + ", ".join(
                f"{v} {k}" for k, v in sorted(counts.items())) + " ok")
        for kind in args.require_kind:
            if totals.get(kind, 0) == 0:
                raise SchemaError(f"no {kind!r} records in {args.paths}")
        if args.require_multidevice and not multidevice:
            raise SchemaError(
                f"no multi-device (devices >= 2) record in {args.paths}")
    except SchemaError as e:
        print(f"schema violation: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
