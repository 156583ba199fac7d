"""End-to-end RF-to-image pipelines (PyTorch port).

`init_pipeline(cfg)` merges every stage's precomputed numpy constants
(served from an in-process cache keyed by the config hash);
`consts_from_numpy` turns them into tensors on a device; `pipeline_fn`
is the stage-graph composition over a leading batch axis.
`monolithic_pipeline_fn` keeps the single-function plain form as the
port's own oracle. `UltrasoundPipeline` is the one-acquisition wrapper.

The card is the default device. With ``device=None`` the entry points
run on CUDA and raise when there is none; ``device="cpu"`` runs the
plain PyTorch versions on the CPU. Nothing falls back on its own.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core import beamform, bmode, demod, doppler, stages
from repro_torch.core.config import Modality, UltrasoundConfig, config_hash

# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', not {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: the PyTorch port runs on the card "
            "by default — pass device='cpu' (CLI: --device cpu) to run "
            "its plain PyTorch versions on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# ---------------------------------------------------------------------------
# Constants
# ---------------------------------------------------------------------------

# In-process LRU of numpy constants, keyed like the reference's cache and
# bounded in bytes as it is: a paper-scale variant sweep must not pin the
# multi-GB cnn operator. An entry larger than the budget is served
# uncached.
MEM_CACHE_MAX_BYTES = 1024 * 1024 * 1024
_MEM_CACHE: "collections.OrderedDict[str, Dict[str, np.ndarray]]" = \
    collections.OrderedDict()


def _consts_nbytes(consts: Dict[str, np.ndarray]) -> int:
    return sum(a.nbytes for a in consts.values())


def _mem_put(key: str, consts: Dict[str, np.ndarray]) -> None:
    if _consts_nbytes(consts) > MEM_CACHE_MAX_BYTES:
        return
    _MEM_CACHE[key] = consts
    _MEM_CACHE.move_to_end(key)
    while (len(_MEM_CACHE) > 1 and
           sum(map(_consts_nbytes, _MEM_CACHE.values()))
           > MEM_CACHE_MAX_BYTES):
        _MEM_CACHE.popitem(last=False)         # evict least-recently used


def init_pipeline(cfg: UltrasoundConfig) -> Dict[str, np.ndarray]:
    """Precompute all pipeline constants (numpy; untimed, cached).

    The returned dict is a fresh shallow copy; its arrays are read-only
    (the cached buffers). Lowering, fusion and precision axes are
    excluded from the key: they never change the constants.
    """
    if not cfg.variant.concrete:
        raise ValueError(
            "cannot build constants for Variant.AUTO — resolve it first "
            "via repro_torch.core.plan.plan_pipeline")
    key = config_hash(cfg, exclude=("exec_map", "stage_lowerings", "fusion",
                                    "precision", "fusion_block"))
    if key in _MEM_CACHE:
        _MEM_CACHE.move_to_end(key)
        return dict(_MEM_CACHE[key])
    consts = stages.init_graph_consts(cfg)
    for a in consts.values():
        a.flags.writeable = False
    _mem_put(key, consts)
    return dict(consts)


def consts_from_numpy(consts: Dict[str, np.ndarray],
                      device) -> Dict[str, torch.Tensor]:
    """Tensors on ``device`` from a numpy constants dict (this package's
    or the reference package's ``init_pipeline``).

    Every array is copied (cached arrays are read-only). ``idx`` stays
    int32 for the kernels; ``idx_long`` is its int64 copy for the plain
    gather.
    """
    out = {k: torch.from_numpy(np.array(v, copy=True, order="C")).to(device)
           for k, v in consts.items()}
    if "idx" in out:
        out["idx_long"] = out["idx"].to(torch.int64)
    return out


# ---------------------------------------------------------------------------
# Pipeline functions
# ---------------------------------------------------------------------------


def pipeline_fn(cfg: UltrasoundConfig, backend: str) -> Callable:
    """(consts, rf_batch) -> images through the configured lowerings."""
    return stages.graph_fn(cfg, backend)


def monolithic_pipeline_fn(cfg: UltrasoundConfig) -> Callable:
    """Plain single-function pipeline over a batch: the port's oracle."""

    def run(consts, rf):
        iq = demod.rf_to_iq(consts, rf, cfg.decim)
        bf = beamform.beamform(cfg, consts, iq)
        if cfg.modality == Modality.BMODE:
            return bmode.bmode_image(cfg, bf)
        if cfg.modality == Modality.DOPPLER:
            return doppler.color_doppler_image(cfg, consts, bf)
        return doppler.power_doppler_image(cfg, consts, bf)

    return run


def _plan(cfg: UltrasoundConfig, policy: Optional[str], backend: str):
    """The plan the pipeline and executor constructors run: ``fixed`` for
    a concrete variant, ``heuristic`` for AUTO, unless ``policy`` says."""
    from repro_torch.core import plan as plan_lib
    if policy is None:
        policy = "fixed" if cfg.variant.concrete else "heuristic"
    return plan_lib.plan_pipeline(cfg, policy=policy, backend=backend)


class UltrasoundPipeline:
    """Plan once, build constants once, call many times (one acquisition).

    ``__call__`` takes (n_l, n_c, n_f) RF (numpy or tensor) and returns
    the image tensor on the pipeline's device.
    """

    def __init__(self, cfg: UltrasoundConfig, *,
                 policy: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.plan = _plan(cfg, policy, self.device.type)
        self.cfg = self.plan.concretize(cfg)
        self.consts = consts_from_numpy(init_pipeline(self.cfg), self.device)
        self._fn = pipeline_fn(self.cfg, self.device.type)

    def __call__(self, rf) -> torch.Tensor:
        x = torch.as_tensor(rf).to(self.device)
        return self._fn(self.consts, x[None])[0]
