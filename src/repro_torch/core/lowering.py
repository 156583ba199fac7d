"""Per-stage and fused-span lowering registries (PyTorch port).

The variant picks the math formulation; this module picks, per stage, the
lowering that executes it. The names are the reference's:

  * ``xla``    — the plain PyTorch formulation (every stage op has one).
  * ``pallas`` — the hand-written CUDA kernel for Hopper
    (repro_torch.kernels). The kernel wrappers run their plain version
    on CPU tensors and the kernel on CUDA tensors, so a ``pallas``
    lowering is available on both backends.

A fused lowering claims a contiguous span of stages (demod -> beamform ->
head) and maps the span's input straight to its output; the planner
resolves it through `resolve_fused`, which fails loudly on a missing
registration, an unimplemented precision or a failed capability
predicate — a fused request runs or fails, never falls back.

Every variant has its ``xla`` beamform. The dynamic and sparse beamforms
also have a ``pallas`` one (``das_beamform``, ``bsr_beamform``); the cnn
beamform is a plain matrix product, as the reference leaves it to XLA.
Fused spans are registered for the dynamic variant only, as in the
reference.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from repro_torch.core import beamform, bmode, demod, doppler
from repro_torch.core.config import (LOWERING_NAMES, Modality,
                                     PRECISION_NAMES, STAGE_NAMES,
                                     UltrasoundConfig, Variant)

DEFAULT_LOWERING = "xla"


@dataclasses.dataclass(frozen=True)
class Lowering:
    """One way to execute a stage op: ``apply(cfg, consts, x) -> y``,
    gated by ``available(cfg, backend)`` and the ``precisions`` it
    implements."""

    stage: str
    name: str
    apply: Callable
    available: Callable[[UltrasoundConfig, str], bool]
    variant: Optional[Variant] = None
    precisions: Tuple[str, ...] = ("f32",)


_REGISTRY: Dict[Tuple[str, Optional[str]], Dict[str, Lowering]] = {}


def _always(cfg: UltrasoundConfig, backend: str) -> bool:
    return True


def _check_precisions(precisions) -> None:
    bad = sorted(set(precisions) - set(PRECISION_NAMES))
    if bad or not precisions:
        raise ValueError(f"invalid precisions {tuple(precisions)!r} "
                         f"(expected a non-empty subset of "
                         f"{PRECISION_NAMES})")


def register_lowering(stage: str, name: str, apply: Callable, *,
                      variant: Optional[Variant] = None,
                      available: Optional[Callable] = None,
                      precisions: Tuple[str, ...] = ("f32",)) -> Lowering:
    """Register (or replace) one lowering of a stage op."""
    if stage not in STAGE_NAMES:
        raise ValueError(f"unknown stage: {stage!r} "
                         f"(expected one of {STAGE_NAMES})")
    if name not in LOWERING_NAMES:
        raise ValueError(f"unknown lowering name: {name!r} "
                         f"(expected one of {LOWERING_NAMES})")
    _check_precisions(precisions)
    low = Lowering(stage=stage, name=name, apply=apply,
                   available=available or _always, variant=variant,
                   precisions=tuple(precisions))
    key = (stage, variant.value if variant is not None else None)
    _REGISTRY.setdefault(key, {})[name] = low
    return low


def _op_key(cfg: UltrasoundConfig, stage: str) -> Tuple[str, Optional[str]]:
    """Variant-scoped registrations (the beamformers) win over
    variant-independent ones (demod, heads)."""
    if cfg.variant.concrete and (stage, cfg.variant.value) in _REGISTRY:
        return (stage, cfg.variant.value)
    return (stage, None)


def registered_lowerings(cfg: UltrasoundConfig,
                         stage: str) -> Dict[str, Lowering]:
    """Every lowering registered for this (stage, cfg.variant) op."""
    return dict(_REGISTRY.get(_op_key(cfg, stage), {}))


def available_lowerings(cfg: UltrasoundConfig, stage: str,
                        backend: str) -> Dict[str, Lowering]:
    """Registered lowerings that implement ``cfg.precision`` and whose
    capability predicate passes on ``backend``."""
    return {n: low for n, low in registered_lowerings(cfg, stage).items()
            if cfg.precision in low.precisions
            and low.available(cfg, backend)}


def resolve_apply(cfg: UltrasoundConfig, stage: str) -> Callable:
    """The apply callable for ``cfg``'s chosen lowering of ``stage``."""
    name = cfg.stage_lowering(stage, DEFAULT_LOWERING)
    lows = registered_lowerings(cfg, stage)
    if name not in lows:
        have = sorted(lows) or ["<none>"]
        op = (f"{stage}/{cfg.variant.value}"
              if _op_key(cfg, stage)[1] is not None or stage == "beamform"
              else stage)
        raise ValueError(
            f"no {name!r} lowering registered for stage op {op!r} "
            f"(registered: {have})")
    if cfg.precision not in lows[name].precisions:
        raise ValueError(
            f"lowering {name!r} for stage {stage!r} computes in "
            f"{lows[name].precisions} only, but the config requests "
            f"precision={cfg.precision!r} — reduced precision needs a "
            "kernel that declares it (set fusion='fused' for the "
            "megakernel, or precision='f32')")
    return lows[name].apply


def apply_stage(cfg: UltrasoundConfig, stage: str, consts: Dict, x):
    """Dispatch one stage through its configured lowering."""
    return resolve_apply(cfg, stage)(cfg, consts, x)


def supported_subset(cfg: UltrasoundConfig,
                     backend: str) -> Tuple[Tuple[str, str], ...]:
    """``cfg.stage_lowerings`` pruned to the entries this variant
    registers and that are available on ``backend``: an explicit pallas
    beamform must not crash the cnn probe of an AUTO config (the final
    plan still validates every entry against the resolved variant)."""
    return tuple((stage, name) for stage, name in cfg.stage_lowerings
                 if name in available_lowerings(cfg, stage, backend))


def supports_explicit(cfg: UltrasoundConfig, backend: str) -> bool:
    """True iff every explicit ``cfg.stage_lowerings`` entry is registered
    for this variant and available on ``backend`` (the planner's variant
    filter: AUTO never resolves to a variant that would refuse a pin)."""
    return supported_subset(cfg, backend) == cfg.stage_lowerings


# ---------------------------------------------------------------------------
# Fused (stage-span) lowerings
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FusedLowering:
    """One lowering claiming a contiguous span of one (variant, modality)
    graph, e.g. ``("demod", "beamform", "bmode")``."""

    stages: Tuple[str, ...]
    name: str
    variant: Variant
    modality: Modality
    apply: Callable
    available: Callable[[UltrasoundConfig, str], bool]
    precisions: Tuple[str, ...] = ("f32",)

    @property
    def group(self) -> str:
        """Fusion-group label, e.g. ``demod+beamform+bmode``."""
        return "+".join(self.stages)


_FUSED_REGISTRY: Dict[Tuple[str, str], Dict[str, FusedLowering]] = {}


def _graph_order(modality: Modality) -> Tuple[str, ...]:
    return ("demod", "beamform", modality.value)


def register_fused_lowering(stages: Tuple[str, ...], name: str,
                            apply: Callable, *, variant: Variant,
                            modality: Modality,
                            available: Optional[Callable] = None,
                            precisions: Tuple[str, ...] = ("f32",)
                            ) -> FusedLowering:
    """Register (or replace) a fused lowering for one (variant, modality)."""
    if name not in LOWERING_NAMES:
        raise ValueError(f"unknown lowering name: {name!r} "
                         f"(expected one of {LOWERING_NAMES})")
    if not variant.concrete:
        raise ValueError("fused lowerings are scoped to concrete variants")
    _check_precisions(precisions)
    order = _graph_order(modality)
    stages = tuple(stages)
    runs = [tuple(order[i:i + len(stages)])
            for i in range(len(order) - len(stages) + 1)]
    if len(stages) < 2 or stages not in runs:
        raise ValueError(
            f"fused span {stages!r} is not a contiguous run (length >= 2) "
            f"of the {modality.value!r} graph {order!r}")
    fused = FusedLowering(stages=stages, name=name, apply=apply,
                          variant=variant, modality=modality,
                          available=available or _always,
                          precisions=tuple(precisions))
    _FUSED_REGISTRY.setdefault((variant.value, modality.value),
                               {})[name] = fused
    return fused


def registered_fused_lowerings(cfg: UltrasoundConfig
                               ) -> Dict[str, FusedLowering]:
    if not cfg.variant.concrete:
        return {}
    return dict(_FUSED_REGISTRY.get(
        (cfg.variant.value, cfg.modality.value), {}))


def resolve_fused(cfg: UltrasoundConfig, backend: str) -> FusedLowering:
    """THE fused lowering a ``fusion='fused'`` config executes, or a loud
    error naming the gate that failed (registration, precision,
    capability)."""
    cell = f"({cfg.variant.value}, {cfg.modality.value})"
    registered = registered_fused_lowerings(cfg)
    if not registered:
        raise ValueError(
            f"fusion='fused' but no fused lowering is registered for "
            f"{cell} — set fusion='none' or register one "
            "(repro_torch.core.lowering.register_fused_lowering)")
    usable = {n: f for n, f in registered.items()
              if cfg.precision in f.precisions}
    if not usable:
        raise ValueError(
            f"no fused lowering for {cell} implements "
            f"precision={cfg.precision!r} "
            f"(registered: { {n: f.precisions for n, f in registered.items()} })")
    live = {n: f for n, f in usable.items() if f.available(cfg, backend)}
    if not live:
        raise ValueError(
            f"fused lowering(s) {sorted(usable)} for {cell} are "
            f"registered but not available on backend {backend!r} for "
            "this geometry (capability predicate failed: the CUDA fused "
            "kernel reads int16 RF and takes fusion_block in (64, 128, 256))")
    return live[sorted(live)[0]]


def fused_supported(cfg: UltrasoundConfig, backend: str) -> bool:
    """True iff `resolve_fused` would succeed (the planner's filter: AUTO
    never resolves to a variant whose fused cell cannot run)."""
    try:
        resolve_fused(cfg, backend)
        return True
    except ValueError:
        return False


# ---------------------------------------------------------------------------
# Default registrations
# ---------------------------------------------------------------------------


def _beamform_dynamic_kernel(cfg, consts, iq):
    from repro_torch.kernels.das_beamform import das_beamform
    return das_beamform(consts["idx"], consts["frac"], consts["apod"],
                        consts["rot"], iq, precision=cfg.precision)


def _beamform_sparse_kernel(cfg, consts, iq):
    from repro_torch.kernels.bsr_spmm import bsr_beamform, block_sample_axis
    blocks = consts["bsr_blocks"]                # (n_c, n_pb, K, bp, bs, 2)
    iq_b = block_sample_axis(iq, blocks.shape[4])
    return bsr_beamform(consts["bsr_col_idx"], blocks, iq_b,
                        precision=cfg.precision)[:, :cfg.n_pix]


def _fused_dynamic_bmode_kernel(cfg, consts, rf):
    from repro_torch.kernels.fused_pipeline import fused_rf_to_envelope
    env = fused_rf_to_envelope(
        consts["carrier"], consts["lpf"], consts["idx"], consts["frac"],
        consts["apod"], consts["rot"], rf, decim=cfg.decim,
        bp=cfg.fusion_block, precision=cfg.precision)
    return bmode.compress_envelope(cfg, env)


def _fused_dynamic_power_kernel(cfg, consts, rf):
    from repro_torch.kernels.fused_pipeline import fused_rf_to_power
    r0 = fused_rf_to_power(
        consts["carrier"], consts["lpf"], consts["idx"], consts["frac"],
        consts["apod"], consts["rot"], consts["wall_taps"], rf,
        decim=cfg.decim, bp=cfg.fusion_block, precision=cfg.precision)
    return doppler.power_compress(cfg, consts, r0)


def _fused_available(cfg: UltrasoundConfig, backend: str) -> bool:
    # The CUDA demod reads int16 RF; fusion_block is the DAS loop's pixel
    # tile, which the kernel is built for in PIXEL_TILES only.
    from repro_torch.kernels.fused_pipeline.ops import PIXEL_TILES
    if cfg.fusion_block is not None and cfg.fusion_block not in PIXEL_TILES:
        return False
    return backend == "cpu" or cfg.rf_dtype == "int16"


def _register_defaults() -> None:
    register_lowering(
        "demod", "xla",
        lambda cfg, consts, rf: demod.rf_to_iq(consts, rf, cfg.decim))
    for variant, fn in beamform.BEAMFORMERS.items():
        register_lowering("beamform", "xla", fn, variant=variant)
    register_lowering("beamform", "pallas", _beamform_dynamic_kernel,
                      variant=Variant.DYNAMIC,
                      precisions=("f32", "bf16", "f16"))
    register_lowering("beamform", "pallas", _beamform_sparse_kernel,
                      variant=Variant.SPARSE,
                      precisions=("f32", "bf16", "f16"))
    register_lowering(
        "bmode", "xla", lambda cfg, consts, bf: bmode.bmode_image(cfg, bf))
    register_lowering(
        "doppler", "xla",
        lambda cfg, consts, bf: doppler.color_doppler_image(cfg, consts, bf))
    register_lowering(
        "power_doppler", "xla",
        lambda cfg, consts, bf: doppler.power_doppler_image(cfg, consts, bf))
    register_fused_lowering(
        ("demod", "beamform", "bmode"), "pallas",
        _fused_dynamic_bmode_kernel,
        variant=Variant.DYNAMIC, modality=Modality.BMODE,
        available=_fused_available, precisions=("f32", "bf16", "f16"))
    register_fused_lowering(
        ("demod", "beamform", "power_doppler"), "pallas",
        _fused_dynamic_power_kernel,
        variant=Variant.DYNAMIC, modality=Modality.POWER_DOPPLER,
        available=_fused_available, precisions=("f32", "bf16", "f16"))


_register_defaults()
