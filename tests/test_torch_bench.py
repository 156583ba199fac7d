"""The port's benchmark surface against the reference's (repro.bench).

  * stats — `bootstrap_ci`, `ci_ratio`, `gate_ratio` and
    `variance_decomposition` return exactly the reference's numbers on
    the same runs and seed;
  * harness — `occupancy_stats` / `in_flight_stats` equal the
    reference's; `bench_callable` results and the serving stats dicts
    the port writes pass both packages' `schema.validate_record`, as
    NDJSON files too;
  * resources — `NvmlEnergyMeter` integrates an injected power trace to
    the expected joules; on the CPU `ResourceMeter` reports no energy
    and names its memory source; the NVML index mapping equals the
    reference's.
"""

import dataclasses
import json
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro.bench import harness as jharness  # noqa: E402
from repro.bench import resources as jres  # noqa: E402
from repro.bench import schema as jschema  # noqa: E402
from repro.bench import stats as jstats  # noqa: E402

from repro_torch.bench import harness as tharness  # noqa: E402
from repro_torch.bench import resources as tres  # noqa: E402
from repro_torch.bench import schema as tschema  # noqa: E402
from repro_torch.bench import stats as tstats  # noqa: E402
from repro_torch.core import Modality, tiny_config  # noqa: E402

SMALL = dict(n_c=16, n_f=8, nz=32, nx=32)


def _runs(seed, n_runs, iters):
    rng = np.random.default_rng(seed)
    return [list(1e-3 * (1 + 0.1 * rng.standard_normal(iters))
                 + 1e-4 * rng.standard_normal())
            for _ in range(n_runs)]


@pytest.mark.parametrize("seed,n_runs,iters", [(0, 1, 5), (1, 3, 4),
                                               (2, 8, 10), (3, 20, 1)])
def test_stats_equal_reference(seed, n_runs, iters):
    runs = _runs(seed, n_runs, iters)
    base = _runs(seed + 100, max(n_runs, 2), iters)
    for kw in (dict(), dict(confidence=0.9, seed=7, statistic="median")):
        assert dataclasses.asdict(tstats.bootstrap_ci(runs, **kw)) == \
            dataclasses.asdict(jstats.bootstrap_ci(runs, **kw))
    assert tstats.ci_ratio(base, runs).json_dict() == \
        jstats.ci_ratio(base, runs).json_dict()
    for hib in (True, False):
        got = tstats.gate_ratio(base, runs, factor=1.05,
                                higher_is_better=hib)
        want = jstats.gate_ratio(base, runs, factor=1.05,
                                 higher_is_better=hib)
        assert (got.ok, got.reason, got.ratio.json_dict()) == \
            (want.ok, want.reason, want.ratio.json_dict())
    assert tstats.variance_decomposition(runs).json_dict() == \
        jstats.variance_decomposition(runs).json_dict()
    assert tstats.ci_json(None) is None


@pytest.mark.parametrize("sizes,cap", [([1, 4, 4, 2], 4), ([3], 3),
                                       ([1, 1, 2, 1, 2], 2)])
def test_occupancy_and_in_flight_stats_equal_reference(sizes, cap):
    assert tharness.occupancy_stats(sizes, cap).json_dict() == \
        jharness.occupancy_stats(sizes, cap).json_dict()
    assert tharness.in_flight_stats(sizes, cap).json_dict() == \
        jharness.in_flight_stats(sizes, cap).json_dict()
    samples = [1e-3 * s for s in sizes]
    assert tharness.latency_stats(samples, 2e-3).json_dict() == \
        jharness.latency_stats(samples, 2e-3).json_dict()
    with pytest.raises(ValueError):
        tharness.occupancy_stats(sizes, cap - 1)
    with pytest.raises(ValueError):
        tharness.in_flight_stats([], cap)


def _validate_both(rec):
    assert tschema.validate_record(rec) == jschema.validate_record(rec)


def test_bench_callable_records_pass_both_schemas(tmp_path):
    x = torch.arange(64, dtype=torch.float32)
    res = tharness.bench_callable("unit/square", lambda t: t * t, (x,),
                                  input_bytes=256, warmup=1, runs=4,
                                  repeats=3, device="cpu",
                                  deadline_s=1.0)
    assert res.resources["energy_joules"] is None
    assert res.resources["memory_source"] == "process_rss_sampled"
    assert res.ci["n_runs"] == 3 and len(res.samples_s) == 12
    assert res.variance is not None
    for line in res.ndjson_lines():
        _validate_both(json.loads(line))
    path = tmp_path / "bench.ndjson"
    tharness.write_ndjson(str(path), [res], extra_records=[
        {"kind": "sample", "name": "extra", "run": 0, "t_s": 1.0}])
    assert tschema.validate_ndjson(str(path)) == \
        jschema.validate_ndjson(str(path))
    doc = tmp_path / "bench.json"
    tharness.write_json(str(doc), [res], extra={"device": "cpu"})
    loaded = json.loads(doc.read_text())
    assert loaded["schema"] == tschema.SCHEMA == jschema.SCHEMA
    assert tschema.main((str(path), "--require-kind", "summary")) == 0
    assert res.csv().startswith("unit/square,")


def test_bench_stages_times_every_stage():
    from repro_torch.core import stage_fns
    from repro_torch.data import synth_rf

    cfg = tiny_config(**SMALL)
    rf = np.stack([synth_rf(cfg, seed=0)])
    out = tharness.bench_stages(cfg, rf, runs=2, device="cpu")
    assert list(out) == list(stage_fns(cfg, "cpu"))
    assert all(s.n == 2 for s in out.values())


def test_serving_records_pass_both_schemas(tmp_path):
    from repro_torch.launch.scheduler import (BatchPolicy,
                                              make_mixed_streams,
                                              serve_multitenant)
    from repro_torch.launch.serve import serve_ultrasound_stream

    cfg = tiny_config(**SMALL)
    st = serve_ultrasound_stream(cfg, batch=2, n_batches=2, depth=2,
                                 device="cpu")
    rec = dict(st, kind="stream", latency=st["latency"].json_dict())
    _validate_both(rec)
    mt = serve_multitenant(
        make_mixed_streams(2, cfg, cfg.with_(modality=Modality.DOPPLER),
                           n_frames=3, base_fps=400.0),
        policy=BatchPolicy(2, 1.0), device="cpu")
    rec = dict(mt, kind="multitenant")
    _validate_both(rec)
    path = tmp_path / "mt.ndjson"
    path.write_text(json.dumps(rec) + "\n")
    assert tschema.validate_ndjson(str(path)) == {"multitenant": 1}
    bad = dict(rec, overlap_frac=1.5)
    with pytest.raises(tschema.SchemaError):
        tschema.validate_record(bad)


def _wait_for(cond, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, "the power thread stalled"
        time.sleep(1e-3)


class _Clock:
    def __init__(self, step):
        self.t, self.step = 0.0, step

    def __call__(self):
        self.t += self.step
        return self.t


def test_integrate_power_is_the_trapezoid_above_idle():
    samples = [(0.0, 100.0), (1.0, 200.0), (3.0, 200.0)]
    # (150 - 80) * 1 + (200 - 80) * 2
    assert tres.integrate_power(samples, 80.0) == pytest.approx(310.0)
    assert tres.integrate_power(samples[:1], 80.0) is None
    assert tres.integrate_power([(0.0, 10.0), (1.0, 10.0)], 50.0) == 0.0


def test_nvml_meter_integrates_an_injected_power_trace():
    """A board at 60 W when the meter is built (the idle baseline), then
    ramping 100, 110, 120, ... W, one sample per 0.25 s tick of the
    injected clock: the joules are the trapezoid sum above 60 W."""
    watts = iter([60.0] + [100.0 + 10.0 * i for i in range(1000)])
    meter = tres.NvmlEnergyMeter(poll_s=0.001, power_w=lambda: next(watts),
                                 clock=_Clock(0.25))
    assert meter.available() and meter.idle_w == 60.0
    meter.start()
    _wait_for(lambda: len(meter.samples) >= 6)
    joules = meter.stop()
    pw = [p for _, p in meter.samples]
    n = len(pw)
    assert pw == [100.0 + 10.0 * i for i in range(n)]
    want = sum(0.25 * (0.5 * (a + b) - 60.0) for a, b in zip(pw, pw[1:]))
    assert joules == pytest.approx(want, rel=1e-12)
    assert meter.energy_counter_joules is None


def test_resource_meter_reports_an_injected_energy_meter():
    watts = iter([50.0] + [150.0] * 10000)
    energy = tres.NvmlEnergyMeter(poll_s=0.001, power_w=lambda: next(watts),
                                  clock=_Clock(0.5))
    meter = tres.ResourceMeter("cpu", energy_meter=energy)
    meter.start()
    _wait_for(lambda: len(energy.samples) >= 3)
    stats = meter.stop()
    n = stats.energy_samples
    assert stats.energy_source == "nvml" and n >= 3
    assert stats.energy_joules == pytest.approx(100.0 * 0.5 * (n - 1))
    assert stats.idle_power_w == 50.0
    from repro_torch.core import plan_pipeline
    plan = plan_pipeline(tiny_config(**SMALL), backend="cpu").json_dict()
    _validate_both({"kind": "stream", "name": "x", "batch": 1,
                    "n_batches": 1, "depth": 1, "plan": plan,
                    "wall_s": 1.0, "acquisitions": 1, "frames": 1,
                    "sustained_mbps": 1.0, "fps": 1.0, "acq_per_s": 1.0,
                    "latency": tharness.latency_stats([1.0]).json_dict(),
                    "resources": stats.json_dict()})


def test_resource_meter_on_cpu():
    meter = tres.ResourceMeter("cpu")
    meter.start()
    keep = torch.ones(1 << 20)
    meter.sample()
    stats = meter.stop()
    assert stats.energy_joules is None and stats.energy_source is None
    assert stats.energy_samples is None
    assert stats.memory_source == "process_rss_sampled"
    assert stats.peak_memory_bytes > keep.numel()
    assert stats.duration_s >= 0.0
    assert set(jres.ResourceStats().json_dict()) <= set(stats.json_dict())


def test_energy_meter_unavailable_reports_none():
    meter = tres.NvmlEnergyMeter(device_indices=[])
    assert not meter.available()
    meter.start()
    assert meter.stop() is None
    broken = tres.NvmlEnergyMeter(power_w=lambda: float("x"))
    broken.start()
    assert broken.stop() is None


@pytest.mark.parametrize("ids,visible", [([0, 1], None), ([0], "3"),
                                         ([1], "2,5"), ([0], "GPU-abc"),
                                         ([2], "0,1")])
def test_nvml_indices_equal_reference(ids, visible):
    assert tres.nvml_indices_for_local_gpus(ids, visible=visible) == \
        jres.nvml_indices_for_local_gpus(ids, visible=visible)


def test_devices_of_finds_tensor_devices():
    tree = {"a": torch.zeros(1), "b": [torch.ones(2), (torch.zeros(3),)]}
    assert tres.devices_of(tree) == (torch.device("cpu"),)
    assert tres.devices_of({"x": 1}) is None
