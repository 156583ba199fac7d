"""End-to-end RF-to-image pipelines (PyTorch port).

`init_pipeline(cfg)` merges every stage's precomputed numpy constants,
served from a two-tier cache: an in-process LRU and an on-disk ``.npz``
store (``REPRO_CONSTS_CACHE_DIR``; files tagged with the port's own
schema, ``consts-torch-v1-<sources digest>-<config hash>``);
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
import dataclasses
import functools
import hashlib
import os
import tempfile
import zipfile
import zlib
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
# Two-tier constants cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ConstsCacheStats:
    """Hit/miss counters of the constants cache (reset per process);
    ``misses`` counts real recomputations."""

    mem_hits: int = 0
    disk_hits: int = 0
    misses: int = 0

    def reset(self) -> None:
        self.mem_hits = self.disk_hits = self.misses = 0


CONSTS_CACHE_STATS = ConstsCacheStats()

# The port's own schema tag: the config hash is the reference's, so the
# tag is what keeps either package from reading a file the other wrote in
# a shared directory. The config hash cannot see code, so each key also
# carries a digest of the sources that build the constants
# (`_sources_digest`): a tree that builds them differently never reads
# another tree's files.
CONSTS_SCHEMA = "consts-torch-v1"

# The modules whose code decides the constants (`stages.init_graph_consts`
# and what it calls).
_CONSTS_SOURCES = ("config", "geometry", "delays", "demod", "doppler",
                   "stages")


@functools.lru_cache(maxsize=1)
def _sources_digest() -> str:
    """12 hex digits of the SHA-256 of the `_CONSTS_SOURCES` files."""
    h = hashlib.sha256()
    here = os.path.dirname(os.path.abspath(__file__))
    for name in _CONSTS_SOURCES:
        with open(os.path.join(here, f"{name}.py"), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:12]

# In-process LRU, bounded in bytes: a paper-scale variant sweep must not
# pin the multi-GB cnn operator. An entry larger than the budget is
# served uncached.
MEM_CACHE_MAX_BYTES = int(os.environ.get(
    "REPRO_CONSTS_CACHE_MEM_MAX_BYTES", 1024 * 1024 * 1024))
_MEM_CACHE: "collections.OrderedDict[str, Dict[str, np.ndarray]]" = \
    collections.OrderedDict()

# Per-entry disk cap: the paper's cnn (2.8 GB) and sparse (1.07 GB)
# operators are cheaper to rebuild than to read back. Entries are never
# evicted (clear_consts_cache(disk=True) wipes the port's).
DISK_CACHE_MAX_BYTES = int(os.environ.get(
    "REPRO_CONSTS_CACHE_MAX_BYTES", 256 * 1024 * 1024))


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


_UNSET = object()
_disk_cache_dir: Optional[str] = None
_disk_cache_resolved = False


def _default_disk_dir() -> Optional[str]:
    env = os.environ.get("REPRO_CONSTS_CACHE_DIR", _UNSET)
    if env is _UNSET:
        return os.path.join(os.path.expanduser("~"), ".cache", "repro",
                            "consts")
    return env if env and env != "0" else None


def consts_cache_dir() -> Optional[str]:
    """The disk tier's directory (None: the disk tier is off).
    ``REPRO_CONSTS_CACHE_DIR`` names it ("" or "0": off); the default is
    the reference's, ``~/.cache/repro/consts``."""
    global _disk_cache_dir, _disk_cache_resolved
    if not _disk_cache_resolved:
        _disk_cache_dir = _default_disk_dir()
        _disk_cache_resolved = True
    return _disk_cache_dir


def set_consts_cache_dir(path: Optional[str]) -> None:
    """Point the disk tier somewhere else, or turn it off (None)."""
    global _disk_cache_dir, _disk_cache_resolved
    _disk_cache_dir = path
    _disk_cache_resolved = True


def clear_consts_cache(*, memory: bool = True, disk: bool = False) -> None:
    """Empty the memory tier and, with ``disk``, delete this package's
    files from the disk tier (the reference's files stay)."""
    if memory:
        _MEM_CACHE.clear()
    d = consts_cache_dir()
    if disk and d and os.path.isdir(d):
        for name in os.listdir(d):
            if name.startswith(CONSTS_SCHEMA + "-") and name.endswith(".npz"):
                os.remove(os.path.join(d, name))


def _disk_path(key: str) -> Optional[str]:
    d = consts_cache_dir()
    return os.path.join(d, f"{key}.npz") if d else None


def _disk_load(key: str) -> Optional[Dict[str, np.ndarray]]:
    """The entry's arrays, or None when it is absent or unreadable (a
    corrupt entry is recomputed and rewritten)."""
    path = _disk_path(key)
    if path is None or not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except (OSError, ValueError, EOFError, zipfile.BadZipFile, zlib.error):
        return None


def _disk_store(key: str, consts: Dict[str, np.ndarray]) -> None:
    """Publish an entry atomically (a temp file, then ``os.replace``), so
    a reader never sees a partial file. Best effort: an entry over
    ``DISK_CACHE_MAX_BYTES`` or a failing write is skipped."""
    path = _disk_path(key)
    if path is None or _consts_nbytes(consts) > DISK_CACHE_MAX_BYTES:
        return
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **consts)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    except OSError:
        pass


def _freeze(consts: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Make cached arrays read-only: every consumer of the key shares
    them."""
    for a in consts.values():
        a.flags.writeable = False
    return consts


def init_pipeline(cfg: UltrasoundConfig, *,
                  cache: bool = True) -> Dict[str, np.ndarray]:
    """Precompute all pipeline constants (numpy; untimed, cached).

    Memory tier, then disk, then compute (which fills both). The returned
    dict is a fresh shallow copy; its arrays are the cached read-only
    buffers (`consts_from_numpy` copies them). Lowering, fusion and
    precision axes are excluded from the key: they never change the
    constants. ``cache=False`` computes and counts nothing.
    """
    if not cfg.variant.concrete:
        raise ValueError(
            "cannot build constants for Variant.AUTO — resolve it first "
            "via repro_torch.core.plan.plan_pipeline")
    if not cache:
        return stages.init_graph_consts(cfg)
    key = f"{CONSTS_SCHEMA}-{_sources_digest()}-" + config_hash(
        cfg, exclude=("exec_map", "stage_lowerings", "fusion", "precision",
                      "fusion_block"))
    if key in _MEM_CACHE:
        CONSTS_CACHE_STATS.mem_hits += 1
        _MEM_CACHE.move_to_end(key)
        return dict(_MEM_CACHE[key])
    consts = _disk_load(key)
    if consts is not None:
        CONSTS_CACHE_STATS.disk_hits += 1
        _mem_put(key, _freeze(consts))
        return dict(consts)
    CONSTS_CACHE_STATS.misses += 1
    consts = _freeze(stages.init_graph_consts(cfg))
    _mem_put(key, consts)
    _disk_store(key, consts)
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


def _resolve_plan(cfg: UltrasoundConfig, plan, policy: Optional[str],
                  backend: str, *, batch: Optional[int] = None):
    """The plan the pipeline and executor constructors run.

    A given ``plan`` must agree with ``cfg`` (its geometry, any explicit
    variant, lowering or pixel tile) and with the device's backend; an
    explicit ``cfg.exec_map`` wins over the plan's and is restamped.
    Without one: ``fixed`` for a concrete variant, ``heuristic`` for
    AUTO, unless ``policy`` says; ``batch`` is the serving batch that
    autotune's card probes dispatch (None: `plan.AUTOTUNE_BATCH`).
    """
    from repro_torch.core import plan as plan_lib
    if plan is None:
        if policy is None:
            policy = "fixed" if cfg.variant.concrete else "heuristic"
        return plan_lib.plan_pipeline(
            cfg, policy=policy, backend=backend,
            autotune_batch=batch or plan_lib.AUTOTUNE_BATCH)
    if policy is not None and policy != plan.policy:
        raise ValueError(f"both plan (policy={plan.policy!r}) and policy="
                         f"{policy!r} given — pass one")
    if not plan.matches(cfg):
        raise ValueError(
            "plan was built for a different config geometry (plan "
            f"geometry_key={plan.geometry_key}) — its telemetry stamp would "
            "misattribute this pipeline; re-plan with plan_pipeline(cfg)")
    if cfg.variant.concrete and cfg.variant != plan.variant:
        raise ValueError(
            f"cfg explicitly requests variant={cfg.variant.value!r} but the "
            f"plan resolved {plan.variant.value!r} — an explicit variant is "
            "always honored, so pass a matching plan (or an AUTO config)")
    planned = dict(plan.stage_lowerings)
    for stage, name in cfg.stage_lowerings:
        if planned.get(stage, name) != name:
            raise ValueError(
                f"cfg explicitly requests lowering {name!r} for stage "
                f"{stage!r} but the plan resolved {planned[stage]!r} — an "
                "explicit lowering is always honored, so pass a matching "
                "plan (or drop the override)")
    if cfg.fusion_block is not None and cfg.fusion_block != plan.fusion_block:
        raise ValueError(
            f"cfg explicitly requests fusion_block={cfg.fusion_block} but "
            f"the plan resolved {plan.fusion_block} — an explicit block size "
            "is always honored, so pass a matching plan (or drop the "
            "override)")
    if plan.backend != backend:
        raise ValueError(f"the plan was made for backend {plan.backend!r}, "
                         f"the pipeline runs on {backend!r}")
    if plan.exec_map != cfg.exec_map:
        plan = dataclasses.replace(plan, exec_map=cfg.exec_map)
    return plan


class UltrasoundPipeline:
    """Plan once, build constants once, call many times (one acquisition).

    ``__call__`` takes (n_l, n_c, n_f) RF (numpy or tensor) and returns
    the image tensor on the pipeline's device.
    """

    def __init__(self, cfg: UltrasoundConfig, *, plan=None,
                 policy: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.plan = _resolve_plan(cfg, plan, policy, self.device.type,
                                  batch=1)
        self.cfg = self.plan.concretize(cfg)
        self.consts = consts_from_numpy(init_pipeline(self.cfg), self.device)
        self._fn = pipeline_fn(self.cfg, self.device.type)

    def __call__(self, rf) -> torch.Tensor:
        x = torch.as_tensor(rf).to(self.device)
        return self._fn(self.consts, x[None])[0]
