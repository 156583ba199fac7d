"""The port's planner (fixed / heuristic / autotune) against the reference.

Real timings on a shared CPU are unsteady, so the two packages' picks
are compared only under injected, identical probes (``measure`` /
``measure_stage``): the same variant, stage lowerings, pixel tile,
provenance and timing keys, for every policy, unfused and fused, with
and without an explicit pin. The memo behaves like the reference's
(tests/test_plan.py). A real autotune on the CPU picks the argmin of
its own timings. Planning for ``cuda`` never offers the plain ``xla``
version of a stage whose op has a kernel (the port's one deliberate
difference), and the autotuned pipeline's image matches the reference's
``monolithic_pipeline_fn`` within the ROADMAP's parity tolerances
(B-mode atol 1.2e-3 with at most 1 % of pixels above 1e-5; Doppler
1e-4).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.bench import schema as jschema  # noqa: E402
from repro.core import config as jcfg  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.data import synth_rf  # noqa: E402

from repro_torch.bench import schema as tschema  # noqa: E402
from repro_torch.core import (BatchedExecutor, UltrasoundPipeline,  # noqa: E402
                              Variant, tiny_config)
from repro_torch.core import lowering as tlowering  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core.pipeline import _resolve_plan  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_planner_state():
    tplan.clear_autotune_memo()
    jplan.clear_autotune_memo()
    yield
    tplan.clear_autotune_memo()
    jplan.clear_autotune_memo()


VARIANT_T = {"dynamic": 3.0, "cnn": 1.0, "sparse": 2.0}


def _measure(cfg, variant, *, runs, warmup):
    return VARIANT_T[variant.value]


def _measure_stage(cfg, stage, *, runs, warmup):
    """Deterministic for both packages' configs: pallas beats xla, and
    the fused tile closest to 128 wins."""
    low = dict(cfg.stage_lowerings).get(stage, "xla")
    bp = cfg.fusion_block or 0
    return {"pallas": 1.0, "xla": 2.0}[low] + abs(bp - 128) * 1e-3


def _pair(policy, fusion, pin):
    kw = {"fusion": fusion}
    if pin:
        kw["stage_lowerings"] = {"beamform": "pallas"}
    variant = "dynamic" if policy == "fixed" else "auto"
    j = jcfg.tiny_config(variant=jcfg.Variant(variant), **kw)
    t = tiny_config(variant=variant, **kw)
    return j, t


def _decisions(plan):
    d = plan.json_dict()
    return (d["variant"], d["stage_lowerings"], d["fusion"],
            d["fusion_group"], d["fusion_block"], d["provenance"],
            d["geometry_key"], d["config_key"], sorted(d),
            d.get("autotune_t_s"), sorted(d.get("lowering_t_s") or {}))


@pytest.mark.parametrize("pin", [False, True])
@pytest.mark.parametrize("fusion", ["none", "fused"])
@pytest.mark.parametrize("policy", ["fixed", "heuristic", "autotune"])
def test_decisions_match_reference_under_injected_timings(policy, fusion,
                                                          pin):
    j, t = _pair(policy, fusion, pin)
    ref = jplan.plan_pipeline(j, policy=policy, measure=_measure,
                              measure_stage=_measure_stage)
    out = tplan.plan_pipeline(t, policy=policy, backend="cpu",
                              measure=_measure, measure_stage=_measure_stage)
    assert ref.backend == out.backend == "cpu"
    assert _decisions(out) == _decisions(ref)
    assert out.lowering_t_s == ref.lowering_t_s
    assert out.autotune_t_s == ref.autotune_t_s
    if policy == "autotune":
        assert out.autotune_t_s is not None
        if fusion == "fused":                 # the tile probes ran
            assert out.fusion_block == 128
    rec = {"kind": "sample", "name": "plan", "run": 0, "t_s": 1.0,
           "plan": out.json_dict()}
    assert tschema.validate_record(rec) == jschema.validate_record(rec)


def test_heuristic_falls_back_to_a_variant_that_honors_the_pin():
    """A preference (cnn) that cannot honor a pallas pin falls to the
    first candidate that can, in both packages."""
    j, t = _pair("heuristic", "none", True)
    jprev = jplan.BACKEND_VARIANT_PREFERENCE["cpu"]
    tprev = tplan.BACKEND_VARIANT_PREFERENCE["cpu"]
    try:
        jplan.register_backend_preference("cpu", jcfg.Variant.CNN)
        tplan.register_backend_preference("cpu", Variant.CNN)
        ref = jplan.plan_pipeline(j, policy="heuristic")
        out = tplan.plan_pipeline(t, policy="heuristic", backend="cpu")
    finally:
        jplan.BACKEND_VARIANT_PREFERENCE["cpu"] = jprev
        tplan.BACKEND_VARIANT_PREFERENCE["cpu"] = tprev
    assert out.variant.value == ref.variant.value == "dynamic"
    assert out.provenance == ref.provenance
    assert "cannot honor" in out.provenance


def test_autotune_memoizes_like_the_reference():
    calls = []

    def fake(cfg, variant, *, runs, warmup):
        calls.append(variant)
        return VARIANT_T[variant.value]

    cfg = tiny_config(variant="auto")
    plan = tplan.plan_pipeline(cfg, policy="autotune", backend="cpu",
                               measure=fake)
    assert plan.variant == Variant.CNN and len(calls) == 3
    assert dict(plan.autotune_t_s) == VARIANT_T
    assert "autotune:cpu->cnn" in plan.provenance
    # memoized: same config modulo variant, same backend
    plan2 = tplan.plan_pipeline(cfg, policy="autotune", backend="cpu",
                                measure=fake)
    assert plan2 == plan and len(calls) == 3
    # a geometry change, other probe settings or another backend miss
    tplan.plan_pipeline(cfg.with_(nx=8), policy="autotune", backend="cpu",
                        measure=fake)
    assert len(calls) == 6
    tplan.plan_pipeline(cfg, policy="autotune", backend="cpu",
                        measure=fake, autotune_runs=5)
    assert len(calls) == 9
    tplan.plan_pipeline(cfg, policy="autotune", backend="cuda",
                        measure=fake)
    assert len(calls) == 12
    tplan.clear_autotune_memo()
    tplan.plan_pipeline(cfg, policy="autotune", backend="cpu", measure=fake)
    assert len(calls) == 15


def test_card_probes_time_the_served_batch(monkeypatch):
    """On ``cuda`` the default probes dispatch the serving batch through
    the served engine (`_time_served`), and the batch keys the memo; the
    CPU probes time one acquisition, so there it keys nothing."""
    seen = []

    def served(cfg, *, batch, runs, warmup):
        seen.append((cfg.variant.value, batch))
        return VARIANT_T[cfg.variant.value]

    monkeypatch.setattr(tplan, "_time_served", served)
    cfg = tiny_config(variant="auto")
    plan = tplan.plan_pipeline(cfg, policy="autotune", backend="cuda",
                               autotune_batch=3)
    assert sorted(seen) == [("cnn", 3), ("dynamic", 3), ("sparse", 3)]
    assert plan.variant == Variant.CNN
    tplan.plan_pipeline(cfg, policy="autotune", backend="cuda",
                        autotune_batch=3)
    assert len(seen) == 3
    tplan.plan_pipeline(cfg, policy="autotune", backend="cuda",
                        autotune_batch=8)
    assert len(seen) == 6 and seen[-1][1] == 8
    calls = []

    def fake(cfg, variant, *, runs, warmup):
        calls.append(variant)
        return VARIANT_T[variant.value]

    for batch in (3, 8):
        tplan.plan_pipeline(cfg, policy="autotune", backend="cpu",
                            autotune_batch=batch, measure=fake)
    assert len(calls) == 3


def test_real_autotune_on_cpu_picks_its_own_argmin():
    cfg = tiny_config(variant="auto")
    plan = tplan.plan_pipeline(cfg, policy="autotune", backend="cpu",
                               autotune_runs=2, autotune_warmup=1)
    timings = dict(plan.autotune_t_s)
    assert set(timings) == {"dynamic", "cnn", "sparse"}
    assert all(t > 0 for t in timings.values())
    assert plan.variant.value == min(timings, key=timings.get)
    for key, t in plan.lowering_t_s or ():
        stage, name = key.split(":")
        assert t > 0
        assert dict(plan.stage_lowerings)[stage] == min(
            (n for n in plan.lowering_t_s if n[0].startswith(stage + ":")),
            key=lambda kv: kv[1])[0].split(":")[1]


@pytest.mark.parametrize("winner", ["dynamic", "cnn", "sparse"])
def test_cuda_planning_never_offers_plain_where_a_kernel_exists(winner):
    """On ``cuda`` autotune times no ``xla`` candidate of a stage op that
    has a kernel: the dynamic and sparse beamforms resolve to their
    kernels with nothing left to time, where the same plan for ``cpu``
    (the reference's candidate sets) times xla against pallas."""
    offered = []

    def measure_stage(cfg, stage, *, runs, warmup):
        offered.append((stage, dict(cfg.stage_lowerings)[stage]))
        return _measure_stage(cfg, stage, runs=runs, warmup=warmup)

    times = {v: (0.5 if v == winner else 1.0) for v in VARIANT_T}
    cfg = tiny_config(variant="auto", modality="power_doppler")
    plan = tplan.plan_pipeline(
        cfg, policy="autotune", backend="cuda",
        measure=lambda c, v, *, runs, warmup: times[v.value],
        measure_stage=measure_stage)
    assert plan.variant.value == winner
    assert plan.backend == "cuda" and plan.lowering_t_s is None
    assert offered == []
    c = plan.concretize(cfg)
    for stage, name in plan.stage_lowerings:
        has_kernel = set(tlowering.available_lowerings(c, stage, "cuda")) \
            - {"xla"}
        assert name != "xla" or not has_kernel, (stage, name)
    assert dict(plan.stage_lowerings)["beamform"] == (
        "xla" if winner == "cnn" else "pallas")
    cpu = tplan.plan_pipeline(
        cfg, policy="autotune", backend="cpu",
        measure=lambda c, v, *, runs, warmup: times[v.value],
        measure_stage=measure_stage)
    if winner != "cnn":
        assert {k for k, _ in cpu.lowering_t_s} == {"beamform:pallas",
                                                    "beamform:xla"}
    # an explicit xla pin is honored on the card too
    pinned = tplan.plan_pipeline(
        tiny_config(variant="auto", stage_lowerings={"beamform": "xla"}),
        policy="autotune", backend="cuda",
        measure=lambda c, v, *, runs, warmup: times[v.value])
    assert dict(pinned.stage_lowerings)["beamform"] == "xla"


def test_fused_tiles_the_kernel_is_not_built_for_are_skipped():
    """At a geometry so small that every candidate clamps below 64, the
    clamped tile is unavailable: nothing is probed and the plan keeps
    the kernel's default tile."""
    cfg = tiny_config(variant="auto", fusion="fused", nz=6, nx=8)
    plan = tplan.plan_pipeline(cfg, policy="autotune", backend="cuda",
                               measure=_measure,
                               measure_stage=_measure_stage)
    assert plan.fusion_block is None and plan.lowering_t_s is None
    full = tplan.plan_pipeline(cfg.with_(nz=24, nx=16), policy="autotune",
                               backend="cuda", measure=_measure,
                               measure_stage=_measure_stage)
    assert [k for k, _ in full.lowering_t_s] == [
        f"demod+beamform+bmode:pallas@bp{bp}" for bp in (64, 128, 256)]
    assert full.fusion_block == 128


@pytest.mark.parametrize("modality", ["bmode", "doppler", "power_doppler"])
@pytest.mark.parametrize("winner", ["dynamic", "cnn", "sparse"])
def test_autotuned_pipeline_matches_reference_image(winner, modality):
    times = {v: (0.5 if v == winner else 1.0) for v in VARIANT_T}
    cfg = tiny_config(variant="auto", modality=modality, n_f=8)
    plan = tplan.plan_pipeline(
        cfg, policy="autotune", backend="cpu",
        measure=lambda c, v, *, runs, warmup: times[v.value],
        measure_stage=_measure_stage)
    pipe = UltrasoundPipeline(cfg, plan=plan, device="cpu")
    assert pipe.cfg.variant.value == winner and pipe.plan is plan
    jc = jcfg.tiny_config(variant=jcfg.Variant(winner),
                          modality=jcfg.Modality(modality), n_f=8)
    rf = synth_rf(jc, seed=3)
    consts = {k: jnp.asarray(v) for k, v in jpipe.init_pipeline(jc).items()}
    ref = np.asarray(jax.jit(jpipe.monolithic_pipeline_fn(jc))(
        consts, jnp.asarray(rf)))
    out = pipe(rf).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    d = np.abs(out - ref)
    if modality == "bmode":
        assert d.max() <= 1.2e-3 and (d > 1e-5).mean() <= 0.01
    else:
        assert d.max() <= 1e-4, d.max()


def test_plan_mismatches_are_refused_as_in_the_reference():
    """The reference's five refusals of a plan that does not fit the
    config (and the port's sixth: a plan made for another backend)."""
    t = tplan.plan_pipeline(tiny_config(variant="auto", fusion="fused"),
                            policy="heuristic", backend="cpu")
    j = jplan.plan_pipeline(jcfg.tiny_config(variant=jcfg.Variant.AUTO,
                                             fusion="fused"),
                            policy="heuristic")
    cases = [({"variant": "auto", "fusion": "fused"}, "fixed", "policy"),
             ({"variant": "auto", "fusion": "fused", "nx": 8}, None,
              "geometry"),
             ({"variant": "sparse", "fusion": "fused"}, None, "explicit"),
             ({"variant": "auto", "fusion": "fused", "fusion_block": 128},
              None, "fusion_block")]
    for kw, policy, match in cases:
        with pytest.raises(ValueError, match=match):
            _resolve_plan(tiny_config(**kw), t, policy, "cpu")
        jkw = dict(kw, variant=jcfg.Variant(kw["variant"]))
        with pytest.raises(ValueError, match=match):
            jpipe._resolve_plan(jcfg.tiny_config(**jkw), j, policy)
    un = tplan.plan_pipeline(tiny_config(variant="auto"),
                             policy="heuristic", backend="cpu")
    jun = jplan.plan_pipeline(jcfg.tiny_config(variant=jcfg.Variant.AUTO),
                              policy="heuristic")
    pin = {"beamform": "pallas"}      # the plan resolved xla
    with pytest.raises(ValueError, match="explicit lowering"):
        _resolve_plan(tiny_config(variant="auto", stage_lowerings=pin),
                      un, None, "cpu")
    with pytest.raises(ValueError, match="explicit lowering"):
        jpipe._resolve_plan(jcfg.tiny_config(variant=jcfg.Variant.AUTO,
                                             stage_lowerings=pin),
                            jun, None)
    cuda_plan = tplan.plan_pipeline(tiny_config(), backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        BatchedExecutor(tiny_config(), plan=cuda_plan, device="cpu")
    # an explicit exec_map wins over the plan's and is restamped
    cfg = tiny_config(variant="auto", fusion="fused")
    eng = BatchedExecutor(cfg.with_(exec_map="map"), plan=t, device="cpu")
    assert eng.plan.exec_map == "map" and eng.cfg.exec_map == "map"
    assert eng.plan.variant == t.variant


def test_plan_stamps_devices_and_serving_like_the_reference():
    t = tplan.plan_pipeline(tiny_config(), backend="cpu")
    j = jplan.plan_pipeline(jcfg.tiny_config())
    assert sorted(t.json_dict()) == sorted(j.json_dict())
    for plan in (t, j):
        d = plan.with_devices(2).json_dict()
        assert d["devices"] == 2 and d["mesh_shape"] == [["data", 2]]
    assert t.json_dict()["devices"] == 1
    assert t.json_dict()["mesh_shape"] is None
    with pytest.raises(AssertionError):
        t.with_devices(2, (("data", 3),))
    assert t.matches(tiny_config()) and not t.matches(tiny_config(nx=8))
