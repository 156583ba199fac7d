"""Backend-aware pipeline planning (PyTorch port).

    plan = plan_pipeline(cfg, policy="heuristic", backend="cuda")

produces a frozen `PipelinePlan`: the resolved variant, one lowering per
stage, the fusion stamp and provenance. ``json_dict()`` has the
reference's keys, so the port's telemetry passes the same schema.

Two policies, as in the reference: ``fixed`` honors ``cfg.variant``
verbatim; ``heuristic`` resolves ``Variant.AUTO`` from the per-backend
preference table (gather-friendly backends run the dynamic variant).
The reference's ``autotune`` policy is not ported yet. ``backend`` is
``"cuda"`` or ``"cpu"``: the device the pipeline runs on.

Lowerings the config leaves open come from the per-backend lowering
preference table: on ``cuda`` the dynamic and sparse beamforms resolve
to their ``pallas`` lowerings — the hand-written Hopper kernels — as the
``tpu`` row does in the reference; the cnn beamform stays ``xla``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core import lowering as lowering_lib
from repro_torch.core.config import UltrasoundConfig, Variant, config_hash
from repro_torch.core.stages import build_graph

POLICIES = ("fixed", "heuristic")
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
    # the fused kernel's pixel tile: cfg.fusion_block (None: its default)
    fusion_block: Optional[int] = None
    # serving context (`with_serving`): how the program was warmed
    # ("aot" / "pool") and the scheduler's in-flight bound; None outside
    # a serving window
    warm_start: Optional[str] = None
    in_flight: Optional[int] = None

    def __post_init__(self):
        assert self.variant.concrete, "plan must carry a concrete variant"
        if self.fusion == "fused":
            assert self.fusion_group, "a fused plan must name its group"
        else:
            assert self.fusion_group is None and self.fusion_block is None, \
                "an unfused plan cannot carry fusion_group/fusion_block"

    @property
    def donate(self) -> bool:
        """The port never donates an input buffer to the engine."""
        return False

    def with_serving(self, *, warm_start: Optional[str],
                     in_flight: Optional[int]) -> "PipelinePlan":
        """This plan, stamped with its serving context (a telemetry stamp;
        the decision axes are unchanged)."""
        if in_flight is not None and in_flight < 1:
            raise ValueError(f"in_flight must be >= 1 (got {in_flight})")
        return dataclasses.replace(self, warm_start=warm_start,
                                   in_flight=in_flight)

    def concretize(self, cfg: UltrasoundConfig) -> UltrasoundConfig:
        """The requested config with every planned decision applied."""
        return cfg.with_(variant=self.variant, exec_map=self.exec_map,
                         stage_lowerings=self.stage_lowerings)

    def json_dict(self) -> dict:
        """The reference's plan stamp. The port compiles no stage
        (``jit_stages`` all False), donates no buffer and runs on one
        device."""
        return {
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
            "devices": 1,
            "mesh_shape": None,
            "warm_start": self.warm_start,
            "in_flight": self.in_flight,
        }


def _geometry_key(cfg: UltrasoundConfig) -> str:
    return config_hash(cfg,
                       exclude=("variant", "exec_map", "stage_lowerings",
                                "fusion_block"))


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


def _resolve_stage_lowerings(cfg: UltrasoundConfig, backend: str
                             ) -> Tuple[Tuple[str, str], ...]:
    """One lowering per stage: explicit entries honored or refused, a
    fused span claims its stages, open stages from the preference table."""
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
        resolved.append((stage.name, _preferred_lowering(
            cfg, stage.name, backend, candidates)))
    return tuple(resolved)


def plan_pipeline(cfg: UltrasoundConfig, policy: str = "fixed", *,
                  backend: str) -> PipelinePlan:
    """Resolve a config (possibly ``Variant.AUTO``) into a PipelinePlan."""
    if policy not in POLICIES:
        raise ValueError(f"unknown plan policy: {policy!r} "
                         f"(expected one of {POLICIES})")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend: {backend!r} "
                         f"(expected one of {BACKENDS})")
    if cfg.variant.concrete:
        variant = cfg.variant
        provenance = f"explicit:{variant.value}"
    elif policy == "fixed":
        raise ValueError(
            "policy 'fixed' cannot resolve Variant.AUTO — pass a concrete "
            "variant or use policy='heuristic'")
    else:
        variant = BACKEND_VARIANT_PREFERENCE[backend]
        provenance = f"heuristic:{backend}->{variant.value}"
    resolved = cfg.with_(variant=variant)
    stage_lowerings = _resolve_stage_lowerings(resolved, backend)
    fusion_group = (lowering_lib.resolve_fused(resolved, backend).group
                    if cfg.fusion == "fused" else None)
    return PipelinePlan(
        variant=variant, exec_map=cfg.exec_map, backend=backend,
        policy=policy, config_key=config_hash(cfg),
        geometry_key=_geometry_key(cfg), provenance=provenance,
        stage_lowerings=stage_lowerings, fusion=cfg.fusion,
        precision=cfg.precision, fusion_group=fusion_group,
        fusion_block=cfg.fusion_block)
