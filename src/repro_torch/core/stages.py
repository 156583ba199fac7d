"""Stage graph for the RF-to-image pipelines (PyTorch port).

    demod -> beamform -> {bmode | doppler | power_doppler}

Each stage has ``init_consts(cfg)`` (numpy, untimed; equal to the
reference's arrays) and ``apply(cfg, consts, x)`` on batched tensors,
dispatched through the lowering registry. Under ``fusion='fused'`` the
registered fused lowering's span runs as one apply and ``stage_fns``
exposes it under its fusion-group key.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np

from repro_torch.core import delays, demod, doppler, lowering
from repro_torch.core.config import Modality, UltrasoundConfig, Variant


@dataclasses.dataclass(frozen=True)
class Stage:
    """One named node of the pipeline graph."""

    name: str
    init_consts: Callable[[UltrasoundConfig], Dict[str, np.ndarray]]
    apply: Callable


def _dispatch(stage_name):
    return (lambda cfg, consts, x:
            lowering.apply_stage(cfg, stage_name, consts, x))


def _beamform_consts(cfg: UltrasoundConfig) -> Dict[str, np.ndarray]:
    if not cfg.variant.concrete:
        raise ValueError(
            "Variant.AUTO has no constants — resolve it with "
            "repro_torch.core.plan.plan_pipeline before building the graph")
    tables = delays.compute_delay_tables(cfg)
    if cfg.variant == Variant.DYNAMIC:
        return dict(idx=tables.idx, frac=tables.frac, apod=tables.apod,
                    rot=tables.rot)
    if cfg.variant == Variant.CNN:
        return {"interp_matrix": delays.interp_matrix(cfg, tables)}
    op = delays.bsr_operator(cfg, tables)
    return {"bsr_blocks": op.blocks, "bsr_col_idx": op.col_idx}


def _doppler_consts(cfg: UltrasoundConfig) -> Dict[str, np.ndarray]:
    return {"wall_taps": doppler.wall_filter_taps(cfg),
            "smooth": doppler.smoothing_kernel(cfg)}


DEMOD = Stage("demod", lambda cfg: dict(demod.demod_consts(cfg)),
              _dispatch("demod"))

BEAMFORM = Stage("beamform", _beamform_consts, _dispatch("beamform"))

HEADS: Dict[Modality, Stage] = {
    Modality.BMODE: Stage("bmode", lambda cfg: {}, _dispatch("bmode")),
    Modality.DOPPLER: Stage("doppler", _doppler_consts,
                            _dispatch("doppler")),
    Modality.POWER_DOPPLER: Stage("power_doppler", _doppler_consts,
                                  _dispatch("power_doppler")),
}


def build_graph(cfg: UltrasoundConfig) -> Tuple[Stage, ...]:
    """Ordered stage graph for the configured modality."""
    return (DEMOD, BEAMFORM, HEADS[cfg.modality])


def init_graph_consts(cfg: UltrasoundConfig) -> Dict[str, np.ndarray]:
    """Merged constants of every stage (untimed, deterministic)."""
    consts: Dict[str, np.ndarray] = {}
    for stage in build_graph(cfg):
        news = stage.init_consts(cfg)
        dup = set(news) & set(consts)
        assert not dup, f"stage {stage.name} redefines consts {dup}"
        consts.update(news)
    return consts


def _fused_span(cfg: UltrasoundConfig, backend: str):
    if cfg.fusion != "fused":
        return None
    return lowering.resolve_fused(cfg, backend)


def _split_span(stages: Tuple[Stage, ...], fused):
    names = [stage.name for stage in stages]
    i0 = names.index(fused.stages[0])
    return stages[:i0], stages[i0 + len(fused.stages):]


def stage_fns(cfg: UltrasoundConfig, backend: str) -> Dict[str, Callable]:
    """Each schedulable unit as its own (consts, x) -> y callable, in
    execution order; a fused span is one entry keyed by its group."""
    def bind(stage):
        return lambda consts, x: stage.apply(cfg, consts, x)

    stages = build_graph(cfg)
    fused = _fused_span(cfg, backend)
    if fused is None:
        return {stage.name: bind(stage) for stage in stages}
    prefix, suffix = _split_span(stages, fused)
    fns: Dict[str, Callable] = {stage.name: bind(stage) for stage in prefix}
    fns[fused.group] = lambda consts, x: fused.apply(cfg, consts, x)
    fns.update({stage.name: bind(stage) for stage in suffix})
    return fns


def graph_fn(cfg: UltrasoundConfig, backend: str) -> Callable:
    """(consts, rf_batch) -> images composition of the stage graph."""
    fns = tuple(stage_fns(cfg, backend).values())

    def run(consts, rf):
        x = rf
        for fn in fns:
            x = fn(consts, x)
        return x
    return run
