"""Backend-aware pipeline planning (PyTorch port).

    plan = plan_pipeline(cfg, policy="autotune", backend="cuda")

produces a frozen `PipelinePlan`: the resolved variant, one lowering per
stage, the fusion stamp, the device topology and provenance.
``json_dict()`` has the reference's keys, so the port's telemetry passes
the same schema. ``backend`` is ``"cuda"`` or ``"cpu"``: the device the
pipeline runs on.

Three policies, as in the reference:

  * ``fixed``     — honor ``cfg.variant`` verbatim; refuses
    ``Variant.AUTO``.
  * ``heuristic`` — resolve AUTO from the per-backend preference table
    (gather-friendly backends run the dynamic variant); when the
    preferred variant cannot honor an explicit lowering pin, the first
    candidate that can.
  * ``autotune``  — time every candidate variant end to end and pick the
    fastest; open stages with more than one candidate lowering are timed
    one by one, and a fused plan's pixel tile among
    `FUSION_BLOCK_CANDIDATES`. Memoized per (geometry, explicit
    lowerings, candidates, backend, runs, warm-up, and on the card the
    probe's batch), so a sweep pays each search once; injected probes are
    not part of the keys (tests that swap them call
    `clear_autotune_memo`).

Lowerings the config leaves open come, outside autotune, from the
per-backend lowering preference table: on ``cuda`` the dynamic and
sparse beamforms resolve to their ``pallas`` lowerings — the
hand-written Hopper kernels — as the ``tpu`` row does in the reference;
the cnn beamform stays ``xla``.

One deliberate difference from the reference: on ``cuda``, autotune does
not put a stage's plain version (``xla``) among the candidates it times
when the stage's op has a kernel lowering. The plain version is the
tests' yardstick and runs on no main path when a card is present. An
explicit ``stage_lowerings`` pin to ``xla`` is still honored, as every
pin is. On ``cpu`` the candidate sets are the reference's.

The probes. On ``cpu`` they are the reference's: one acquisition a call
through the port's bench harness (`bench_callable`; `bench_stages` for a
stage), on the host clock. On ``cuda`` every probe times the engine that
would be served: a `BatchedExecutor` of ``autotune_batch`` rows (the
serving batch; the scheduler passes its rows per device) with its CUDA
graph captured, dispatches timed by CUDA events. One eager acquisition
a call would time mostly the host enqueuing the engine's ops, which a
served graph replay does not pay, and would rank variants whose device
times are within about 2x of each other by host noise. A stage or pixel
tile probe times the whole dispatch under that choice. Each variant
probe builds that variant's constants (the cnn operator is 2.8 GB at
the paper's geometry) and frees them, with the allocator's cache and
the probe's graph, before the next probe, so a later window's peak
memory is its engine's. The graph's warm-up run (which may build the
kernel libraries with nvcc) is never timed. A fused pixel tile that the
kernel is not built for (a geometry so small that a candidate clamps
below 64) is unavailable and skipped, not padded.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core import lowering as lowering_lib
from repro_torch.core.config import UltrasoundConfig, Variant, config_hash
from repro_torch.core.stages import build_graph

POLICIES = ("fixed", "heuristic", "autotune")
BACKENDS = ("cuda", "cpu")

BACKEND_VARIANT_PREFERENCE: Dict[str, Variant] = {
    "cpu": Variant.DYNAMIC,
    "cuda": Variant.DYNAMIC,
}
BACKEND_LOWERING_PREFERENCE: Dict[str, Dict[Tuple[str, Optional[str]],
                                            str]] = {
    "cuda": {
        ("beamform", Variant.DYNAMIC.value): "pallas",
        ("beamform", Variant.SPARSE.value): "pallas",
    },
}

CONCRETE_VARIANTS = (Variant.DYNAMIC, Variant.CNN, Variant.SPARSE)

# (geometry key, explicit stage_lowerings, candidate variants, backend,
#  runs, warmup) -> tuple of (variant value, t_avg_s)
_AUTOTUNE_MEMO: Dict[Tuple, Tuple[Tuple[str, float], ...]] = {}

# (resolved-config key sans lowerings, explicit stage_lowerings, contested
#  set, backend, runs, warmup) -> tuple of ("stage:lowering", t_avg_s);
# the fused pixel-tile probes key in here too, as
# "<group>:<name>@bp<bp>".
_LOWERING_MEMO: Dict[Tuple, Tuple[Tuple[str, float], ...]] = {}

# Pixel tiles autotune probes for the fused kernel (cfg.fusion_block
# left open): the tiles the CUDA library is built for.
FUSION_BLOCK_CANDIDATES = (64, 128, 256)

# Rows of the served dispatch a card probe times when the caller does
# not name its serving batch (the scheduler's default max_batch).
AUTOTUNE_BATCH = 4


def register_backend_preference(backend: str, variant: Variant) -> None:
    """Extend/override the heuristic registry (measured, not assumed)."""
    if not variant.concrete:
        raise ValueError("preference must be a concrete variant")
    BACKEND_VARIANT_PREFERENCE[backend] = variant


def register_lowering_preference(backend: str, stage: str,
                                 variant: Optional[Variant],
                                 lowering_name: str) -> None:
    """Extend/override the per-backend lowering preference table."""
    BACKEND_LOWERING_PREFERENCE.setdefault(backend, {})[
        (stage, variant.value if variant is not None else None)] = \
        lowering_name


def clear_autotune_memo() -> None:
    _AUTOTUNE_MEMO.clear()
    _LOWERING_MEMO.clear()


@dataclasses.dataclass(frozen=True)
class PipelinePlan:
    """A fully resolved execution plan for one pipeline config."""

    variant: Variant
    exec_map: str
    backend: str
    policy: str
    config_key: str                     # hash of the REQUESTED cfg
    geometry_key: str                   # hash sans planned axes
    provenance: str
    stage_lowerings: Tuple[Tuple[str, str], ...]
    fusion: str = "none"
    precision: str = "f32"
    fusion_group: Optional[str] = None
    # the fused kernel's pixel tile (None: its default)
    fusion_block: Optional[int] = None
    # autotune's measured variant timings, (variant value, t_avg_s)
    autotune_t_s: Optional[Tuple[Tuple[str, float], ...]] = None
    # per-stage lowering and pixel-tile timings when autotune measured,
    # ("stage:lowering" or "<group>:<name>@bp<bp>", t_avg_s)
    lowering_t_s: Optional[Tuple[Tuple[str, float], ...]] = None
    # device topology (`with_devices`): 1 / None for one device; the
    # ShardedExecutor stamps its shards
    devices: int = 1
    mesh_shape: Optional[Tuple[Tuple[str, int], ...]] = None
    # serving context (`with_serving`): how the program was warmed
    # ("aot" / "pool") and the scheduler's in-flight bound; None outside
    # a serving window
    warm_start: Optional[str] = None
    in_flight: Optional[int] = None

    def __post_init__(self):
        assert self.variant.concrete, "plan must carry a concrete variant"
        assert self.devices >= 1, "plan needs at least one device"
        if self.fusion == "fused":
            assert self.fusion_group, "a fused plan must name its group"
        else:
            assert self.fusion_group is None and self.fusion_block is None, \
                "an unfused plan cannot carry fusion_group/fusion_block"
        if self.mesh_shape is not None:
            n = 1
            for _, extent in self.mesh_shape:
                n *= extent
            assert n == self.devices, \
                f"mesh_shape {self.mesh_shape} != devices {self.devices}"

    @property
    def donate(self) -> bool:
        """The port never donates an input buffer to the engine."""
        return False

    def with_devices(self, devices: int,
                     mesh_shape: Optional[Tuple[Tuple[str, int], ...]] = None
                     ) -> "PipelinePlan":
        """This plan, stamped with the executing device topology (the
        decision axes are unchanged: sharding scales a plan out, it
        never re-plans)."""
        if mesh_shape is None:
            mesh_shape = (("data", devices),)
        return dataclasses.replace(self, devices=devices,
                                   mesh_shape=mesh_shape)

    def with_serving(self, *, warm_start: Optional[str],
                     in_flight: Optional[int]) -> "PipelinePlan":
        """This plan, stamped with its serving context (a telemetry stamp;
        the decision axes are unchanged)."""
        if in_flight is not None and in_flight < 1:
            raise ValueError(f"in_flight must be >= 1 (got {in_flight})")
        return dataclasses.replace(self, warm_start=warm_start,
                                   in_flight=in_flight)

    def matches(self, cfg: UltrasoundConfig) -> bool:
        """True iff this plan was built for ``cfg``'s geometry (the axes
        the plan decides — variant, exec_map, lowerings, pixel tile — are
        left out, so a plan built on an AUTO config matches the resolved
        config and vice versa)."""
        return self.geometry_key == _geometry_key(cfg)

    def concretize(self, cfg: UltrasoundConfig) -> UltrasoundConfig:
        """The requested config with every planned decision applied."""
        return cfg.with_(variant=self.variant, exec_map=self.exec_map,
                         stage_lowerings=self.stage_lowerings,
                         fusion_block=self.fusion_block)

    def json_dict(self) -> dict:
        """The reference's plan stamp. The port compiles no stage
        (``jit_stages`` all False) and donates no buffer."""
        d = {
            "policy": self.policy,
            "backend": self.backend,
            "variant": self.variant.value,
            "exec_map": self.exec_map,
            "donate": self.donate,
            "jit_stages": {k: False for k, _ in self.stage_lowerings},
            "stage_lowerings": {k: v for k, v in self.stage_lowerings},
            "fusion": self.fusion,
            "precision": self.precision,
            "fusion_group": self.fusion_group,
            "fusion_block": self.fusion_block,
            "config_key": self.config_key,
            "geometry_key": self.geometry_key,
            "provenance": self.provenance,
            "devices": self.devices,
            "mesh_shape": ([[name, extent] for name, extent
                            in self.mesh_shape]
                           if self.mesh_shape is not None else None),
            "warm_start": self.warm_start,
            "in_flight": self.in_flight,
        }
        if self.autotune_t_s is not None:
            d["autotune_t_s"] = {k: v for k, v in self.autotune_t_s}
        if self.lowering_t_s is not None:
            d["lowering_t_s"] = {k: v for k, v in self.lowering_t_s}
        return d


def _geometry_key(cfg: UltrasoundConfig) -> str:
    return config_hash(cfg,
                       exclude=("variant", "exec_map", "stage_lowerings",
                                "fusion_block"))


# ---------------------------------------------------------------------------
# Autotune probes
# ---------------------------------------------------------------------------


def _release(backend: str) -> None:
    """Hand a finished probe's device memory back to the card: its
    tensors and graph, and the cuBLAS workspaces its warm-up and capture
    streams made (32 MiB each, kept per stream; a graph's own workspace
    lives in its private pool, as ``torch.cuda.graph`` clears the
    workspaces when a capture begins)."""
    import torch
    if backend == "cuda" and torch.cuda.is_initialized():
        import gc

        gc.collect()
        torch.cuda.synchronize()
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
        torch.cuda.empty_cache()


def _time_served(cfg: UltrasoundConfig, *, batch: int, runs: int,
                 warmup: int) -> float:
    """Seconds per dispatch of the engine that serves ``cfg`` on the card:
    a `BatchedExecutor` of ``batch`` rows with its CUDA graph captured
    (`repro_torch.core.aot.aot_warm`, whose warm-up run builds the
    kernel libraries untimed), ``warmup`` untimed dispatches, then
    ``runs`` dispatches of one placed batch (input copy, graph replay,
    output copy) between two CUDA events on the compute stream."""
    import numpy as np
    import torch

    from repro_torch.core.aot import aot_warm
    from repro_torch.core.executor import BatchedExecutor
    from repro_torch.data import shared_rf

    eng = BatchedExecutor(cfg)                     # constants: untimed
    aot_warm(eng, batch)
    x = eng.place(np.ascontiguousarray(np.broadcast_to(
        shared_rf(cfg), (batch,) + tuple(cfg.rf_shape))))
    for _ in range(warmup):
        eng.dispatch_staged(x, batch)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        eng.dispatch_staged(x, batch)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / runs


def _time_variant(cfg: UltrasoundConfig, *, runs: int, warmup: int,
                  backend: str) -> float:
    import torch

    from repro_torch.bench.harness import bench_callable
    from repro_torch.core.pipeline import UltrasoundPipeline
    from repro_torch.data import shared_rf

    pipe = UltrasoundPipeline(cfg, device=backend)     # constants: untimed
    rf = torch.tensor(shared_rf(cfg), device=pipe.device)  # a copy
    res = bench_callable(
        f"autotune/{cfg.name}/{cfg.variant.value}", pipe, (rf,),
        input_bytes=cfg.input_bytes, runs=runs, warmup=warmup,
        device=pipe.device)
    return res.t_avg_s


def _default_measure(cfg: UltrasoundConfig, variant: Variant, *,
                     runs: int, warmup: int, backend: str,
                     batch: int) -> float:
    """T_avg of one concrete variant; the probe's constants are freed
    before it returns. On the CPU, as the reference: one acquisition a
    call through the bench harness. On the card: one served dispatch of
    ``batch`` rows (`_time_served`)."""
    c = cfg.with_(variant=variant)
    # Explicit entries the probed variant does not register (a pallas
    # beamform while probing cnn) must not crash the probe; the final
    # plan still validates them against the winner.
    c = c.with_(stage_lowerings=lowering_lib.supported_subset(c, backend))
    if backend == "cuda":
        t = _time_served(c, batch=batch, runs=runs, warmup=warmup)
    else:
        t = _time_variant(c, runs=runs, warmup=warmup, backend=backend)
    _release(backend)
    return t


def _default_stage_measure(cfg: UltrasoundConfig, stage: str, *,
                           runs: int, warmup: int, backend: str,
                           batch: int) -> float:
    """Mean time of ``stage`` (or a fusion group) under ``cfg``'s
    lowerings. On the CPU, as the reference: its entry of the bench
    harness's per-stage breakdown. On the card: the whole served
    dispatch of ``batch`` rows (`_time_served`); the candidates of one
    stage or pixel tile differ in that choice alone, so the argmin is
    the same."""
    if backend == "cuda":
        t = _time_served(cfg, batch=batch, runs=runs, warmup=warmup)
        _release(backend)
        return t
    from repro_torch.bench.harness import bench_stages
    from repro_torch.data import shared_rf

    rf = shared_rf(cfg)[None].copy()        # the shared array is read-only
    breakdown = bench_stages(cfg, rf, runs=runs, warmup=warmup,
                             device=backend)
    return breakdown[stage].mean_s


def _probe_rows(batch: int, backend: str) -> Optional[int]:
    """The memo keys' batch entry: the rows a card probe dispatches (the
    CPU probes time one acquisition, whatever the serving batch)."""
    return batch if backend == "cuda" else None


def _variant_candidates(cfg: UltrasoundConfig,
                        backend: str) -> Tuple[Variant, ...]:
    """Concrete variants able to honor every explicit lowering entry (and,
    under ``fusion='fused'``, with a runnable fused registration)."""
    candidates = tuple(
        v for v in CONCRETE_VARIANTS
        if lowering_lib.supports_explicit(cfg.with_(variant=v), backend)
        and (cfg.fusion != "fused"
             or lowering_lib.fused_supported(cfg.with_(variant=v),
                                             backend)))
    if not candidates:
        raise ValueError(
            f"no concrete variant supports the explicit stage_lowerings "
            f"{dict(cfg.stage_lowerings)}"
            + (" with fusion='fused'" if cfg.fusion == "fused" else "")
            + f" on backend {backend!r} — drop an override or register "
            "the missing lowering")
    return candidates


def _autotune_timings(cfg: UltrasoundConfig, backend: str, *,
                      variants: Tuple[Variant, ...], runs: int, warmup: int,
                      batch: int, measure: Optional[Callable]
                      ) -> Tuple[Tuple[str, float], ...]:
    memo_key = (_geometry_key(cfg), cfg.stage_lowerings,
                tuple(v.value for v in variants), backend, runs, warmup,
                _probe_rows(batch, backend))
    if memo_key in _AUTOTUNE_MEMO:
        return _AUTOTUNE_MEMO[memo_key]
    measure = measure or functools.partial(_default_measure,
                                           backend=backend, batch=batch)
    timings = tuple(
        (v.value, float(measure(cfg, v, runs=runs, warmup=warmup)))
        for v in variants)
    _AUTOTUNE_MEMO[memo_key] = timings
    return timings


def _lowering_timings(cfg: UltrasoundConfig, backend: str, *,
                      base: Tuple[Tuple[str, str], ...],
                      to_tune: Tuple[Tuple[str, Tuple[str, ...]], ...],
                      runs: int, warmup: int, batch: int,
                      measure_stage: Optional[Callable]
                      ) -> Tuple[Tuple[str, float], ...]:
    """Measured ("stage:lowering", t_avg_s) pairs, memoized; the key
    carries the contested (stage, candidates) set, which a registration
    can grow without touching the config."""
    memo_key = (config_hash(cfg, exclude=("exec_map", "stage_lowerings")),
                cfg.stage_lowerings, to_tune, backend, runs, warmup,
                _probe_rows(batch, backend))
    if memo_key in _LOWERING_MEMO:
        return _LOWERING_MEMO[memo_key]
    measure_stage = measure_stage or functools.partial(
        _default_stage_measure, backend=backend, batch=batch)
    explicit = dict(cfg.stage_lowerings)
    timings = []
    for stage_name, candidates in to_tune:
        for name in candidates:
            assignment = dict(base)
            assignment.update(explicit)
            assignment[stage_name] = name
            probe_cfg = cfg.with_(
                stage_lowerings=tuple(sorted(assignment.items())))
            t = float(measure_stage(probe_cfg, stage_name,
                                    runs=runs, warmup=warmup))
            timings.append((f"{stage_name}:{name}", t))
    result = tuple(timings)
    _LOWERING_MEMO[memo_key] = result
    return result


def _fusion_block_timings(cfg: UltrasoundConfig, backend: str, fused, *,
                          stage_lowerings: Tuple[Tuple[str, str], ...],
                          runs: int, warmup: int, batch: int,
                          measure_stage: Optional[Callable]
                          ) -> Tuple[Tuple[str, float], ...]:
    """Measured ("<group>:<name>@bp<bp>", t_avg_s) pairs for the fused
    kernel's pixel-tile candidates (clamped to the pixel count, as the
    reference clamps them; a clamped tile the kernel is not built for is
    skipped), timed by ``measure_stage`` for the fusion group and
    memoized per geometry."""
    cap = -(-cfg.n_pix // 8) * 8
    bps = tuple(bp for bp in sorted({min(bp, cap)
                                     for bp in FUSION_BLOCK_CANDIDATES})
                if fused.available(cfg.with_(fusion_block=bp), backend))
    memo_key = (config_hash(cfg, exclude=("exec_map", "stage_lowerings",
                                          "fusion_block")),
                cfg.stage_lowerings, fused.group, bps, backend, runs,
                warmup, _probe_rows(batch, backend))
    if memo_key in _LOWERING_MEMO:
        return _LOWERING_MEMO[memo_key]
    measure_stage = measure_stage or functools.partial(
        _default_stage_measure, backend=backend, batch=batch)
    timings = []
    for bp in bps:
        probe_cfg = cfg.with_(stage_lowerings=stage_lowerings,
                              fusion_block=bp)
        t = float(measure_stage(probe_cfg, fused.group,
                                runs=runs, warmup=warmup))
        timings.append((f"{fused.group}:{fused.name}@bp{bp}", t))
    result = tuple(timings)
    _LOWERING_MEMO[memo_key] = result
    return result


# ---------------------------------------------------------------------------
# Resolution
# ---------------------------------------------------------------------------


def _preferred_lowering(cfg: UltrasoundConfig, stage: str, backend: str,
                        candidates: Dict) -> str:
    table = BACKEND_LOWERING_PREFERENCE.get(backend, {})
    for op_key in ((stage, cfg.variant.value), (stage, None)):
        want = table.get(op_key)
        if want is not None and want in candidates:
            return want
    return (lowering_lib.DEFAULT_LOWERING
            if lowering_lib.DEFAULT_LOWERING in candidates
            else sorted(candidates)[0])


def _tuning_candidates(candidates: Dict, backend: str) -> Dict:
    """The lowerings autotune times: on the card, a stage op's kernels
    without its plain version (module docstring)."""
    if backend != "cuda":
        return candidates
    kernels = {n: low for n, low in candidates.items()
               if n != lowering_lib.DEFAULT_LOWERING}
    return kernels or candidates


def _resolve_stage_lowerings(cfg: UltrasoundConfig, backend: str, *,
                             policy: str, runs: int, warmup: int,
                             batch: int,
                             measure_stage: Optional[Callable]
                             ) -> Tuple[Tuple[Tuple[str, str], ...],
                                        Optional[Tuple[Tuple[str, float],
                                                       ...]]]:
    """One lowering per stage: explicit entries honored or refused, a
    fused span claims its stages, open stages from the preference table
    (fixed / heuristic) or measured among their candidates (autotune).
    Returns the pairs and the ("stage:lowering", t) timings when autotune
    measured (None otherwise)."""
    fused = (lowering_lib.resolve_fused(cfg, backend)
             if cfg.fusion == "fused" else None)
    explicit = dict(cfg.stage_lowerings)
    graph = build_graph(cfg)
    stray = sorted(set(explicit) - {s.name for s in graph})
    if stray:
        raise ValueError(
            f"stage_lowerings pins stage(s) {stray} that are not in "
            f"this pipeline's graph (modality {cfg.modality.value!r})")
    resolved = []
    to_tune = []
    for stage in graph:
        if fused is not None and stage.name in fused.stages:
            pin = explicit.get(stage.name)
            if pin is not None and pin != fused.name:
                raise ValueError(
                    f"stage_lowerings pins {stage.name!r} to {pin!r}, "
                    f"but fusion='fused' claims the {fused.group!r} span "
                    f"with the {fused.name!r} lowering — drop the pin or "
                    "set fusion='none'")
            resolved.append((stage.name, fused.name))
            continue
        if stage.name in explicit:
            name = explicit[stage.name]
            registered = lowering_lib.registered_lowerings(cfg, stage.name)
            if name not in registered:
                raise ValueError(
                    f"config requests lowering {name!r} for stage "
                    f"{stage.name!r}, but the registry has no such "
                    f"lowering for variant {cfg.variant.value!r}")
            if not registered[name].available(cfg, backend):
                raise ValueError(
                    f"lowering {name!r} for stage {stage.name!r} is not "
                    f"available on backend {backend!r} for this geometry")
            resolved.append((stage.name, name))
            continue
        candidates = lowering_lib.available_lowerings(cfg, stage.name,
                                                      backend)
        if not candidates:
            raise ValueError(
                f"no available lowering for stage {stage.name!r} on "
                f"backend {backend!r} at precision {cfg.precision!r} — "
                "reduced precision needs a kernel that declares it (set "
                "fusion='fused' for the megakernel, or precision='f32')")
        if policy == "autotune":
            candidates = _tuning_candidates(candidates, backend)
        if policy == "autotune" and len(candidates) > 1:
            to_tune.append((stage.name, sorted(candidates)))
            resolved.append((stage.name, None))      # filled below
        else:
            resolved.append((stage.name, _preferred_lowering(
                cfg, stage.name, backend, candidates)))

    timings: Optional[Tuple[Tuple[str, float], ...]] = None
    if to_tune:
        timings = _lowering_timings(
            cfg, backend,
            base=tuple((s, n) for s, n in resolved if n is not None),
            to_tune=tuple((s, tuple(c)) for s, c in to_tune),
            runs=runs, warmup=warmup, batch=batch,
            measure_stage=measure_stage)
        winners = {}
        for key, t in timings:
            stage_name, low_name = key.split(":", 1)
            if stage_name not in winners or t < winners[stage_name][1]:
                winners[stage_name] = (low_name, t)
        resolved = [(s, n if n is not None else winners[s][0])
                    for s, n in resolved]
    return tuple(resolved), timings


def plan_pipeline(cfg: UltrasoundConfig, policy: str = "fixed", *,
                  backend: str, autotune_runs: int = 3,
                  autotune_warmup: int = 1,
                  autotune_batch: int = AUTOTUNE_BATCH,
                  measure: Optional[Callable] = None,
                  measure_stage: Optional[Callable] = None) -> PipelinePlan:
    """Resolve a config (possibly ``Variant.AUTO``) into a PipelinePlan.

    ``measure(cfg, variant, runs=, warmup=)`` overrides the autotune
    variant probe and ``measure_stage(cfg, stage, runs=, warmup=)`` the
    per-stage and pixel-tile probe (tests inject deterministic timings
    through both). ``autotune_batch`` is the serving batch the card's
    default probes dispatch (module docstring). An explicitly concrete ``cfg.variant`` — and any
    explicit ``cfg.stage_lowerings`` entry or ``cfg.fusion_block`` — is
    honored under every policy; the planner decides only what the config
    leaves open.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown plan policy: {policy!r} "
                         f"(expected one of {POLICIES})")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend: {backend!r} "
                         f"(expected one of {BACKENDS})")
    autotune_t_s = None
    if cfg.variant.concrete:
        variant = cfg.variant
        provenance = f"explicit:{variant.value}"
    elif policy == "fixed":
        raise ValueError(
            "policy 'fixed' cannot resolve Variant.AUTO — pass a concrete "
            "variant or use policy='heuristic' / 'autotune'")
    elif policy == "heuristic":
        candidates = _variant_candidates(cfg, backend)
        variant = BACKEND_VARIANT_PREFERENCE[backend]
        provenance = f"heuristic:{backend}->{variant.value}"
        if variant not in candidates:
            # the preferred variant cannot honor an explicit lowering pin:
            # the first candidate that can, and say so
            variant = candidates[0]
            provenance += (f" -> {variant.value} (preference cannot honor "
                           "explicit stage_lowerings)")
    else:
        autotune_t_s = _autotune_timings(
            cfg, backend, variants=_variant_candidates(cfg, backend),
            runs=autotune_runs, warmup=autotune_warmup,
            batch=autotune_batch, measure=measure)
        winner = min(autotune_t_s, key=lambda kv: kv[1])
        variant = Variant(winner[0])
        provenance = (f"autotune:{backend}->{variant.value} "
                      f"(t_avg={winner[1]:.3e}s over "
                      f"{len(autotune_t_s)} variants)")

    resolved = cfg.with_(variant=variant)
    stage_lowerings, lowering_t_s = _resolve_stage_lowerings(
        resolved, backend, policy=policy, runs=autotune_runs,
        warmup=autotune_warmup, batch=autotune_batch,
        measure_stage=measure_stage)

    fusion_group = None
    fusion_block = None
    if cfg.fusion == "fused":
        fused = lowering_lib.resolve_fused(resolved, backend)
        fusion_group = fused.group
        fusion_block = cfg.fusion_block
        if fusion_block is None and policy == "autotune":
            bp_t = _fusion_block_timings(
                resolved, backend, fused, stage_lowerings=stage_lowerings,
                runs=autotune_runs, warmup=autotune_warmup,
                batch=autotune_batch, measure_stage=measure_stage)
            if bp_t:
                best = min(bp_t, key=lambda kv: kv[1])
                fusion_block = int(best[0].rsplit("@bp", 1)[1])
                lowering_t_s = (lowering_t_s or ()) + bp_t

    return PipelinePlan(
        variant=variant, exec_map=cfg.exec_map, backend=backend,
        policy=policy, config_key=config_hash(cfg),
        geometry_key=_geometry_key(cfg), provenance=provenance,
        stage_lowerings=stage_lowerings, fusion=cfg.fusion,
        precision=cfg.precision, fusion_group=fusion_group,
        fusion_block=fusion_block, autotune_t_s=autotune_t_s,
        lowering_t_s=lowering_t_s)
