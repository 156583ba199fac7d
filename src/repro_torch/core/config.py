"""Configuration for the deterministic ultrasound pipelines (PyTorch port).

The port's own copy of the reference package's config: every field, every
validation rule and the same ``CONFIG_HASH_SCHEMA``, so a config built in
either package hashes to the same string. Geometry-dependent constants
are precomputed at construction time and excluded from timing.

The paper's input size is 5.472 MB per forward pass: int16 RF of shape
(n_l=1336, n_c=64, n_f=32) = 1336*64*32*2 bytes = 5,472,256 bytes.

Lowering names keep the reference's spelling: ``"xla"`` is read by the
port as its plain PyTorch formulation of a stage, ``"pallas"`` as its
hand-written CUDA kernel for Hopper. One config hash therefore names one
kernel set in both packages.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
import warnings
from typing import Collection, Mapping, Optional, Tuple


class Variant(str, enum.Enum):
    """Implementation variants (paper §II-B).

    DYNAMIC - V1: explicit gather / dynamic indexing.
    CNN     - V2: convolutions, pointwise ops, matmuls, reductions.
    SPARSE  - V3: structured (block-) sparse matrices.
    AUTO    - planner placeholder, resolved by ``plan_pipeline``.
    """

    DYNAMIC = "dynamic"
    CNN = "cnn"
    SPARSE = "sparse"
    AUTO = "auto"

    @property
    def concrete(self) -> bool:
        return self is not Variant.AUTO


class Modality(str, enum.Enum):
    """Pipeline modalities (paper §II-A)."""

    BMODE = "bmode"
    DOPPLER = "doppler"
    POWER_DOPPLER = "power_doppler"


# Batch-mapping strategies (config.exec_map): "vmap" runs the whole batch
# through each stage at once, "map" runs one acquisition at a time.
EXEC_MAPS = ("vmap", "map")

STAGE_NAMES = ("demod", "beamform", "bmode", "doppler", "power_doppler")
LOWERING_NAMES = ("xla", "pallas")
FUSION_NAMES = ("none", "fused")
PRECISION_NAMES = ("f32", "bf16", "f16")

# (rtol, atol) bounds on the final image per (precision, modality), as in
# the reference. Reduced precision casts the interpolation and FIR
# operands only; accumulation and pointwise math stay f32.
PRECISION_TOLERANCES = {
    ("f32", Modality.BMODE): (0.0, 0.0),
    ("f32", Modality.POWER_DOPPLER): (0.0, 0.0),
    ("bf16", Modality.BMODE): (7.5e-2, 7.5e-2),
    ("bf16", Modality.POWER_DOPPLER): (1.5e-1, 1.5e-1),
    ("f16", Modality.BMODE): (5e-3, 5e-3),
    ("f16", Modality.POWER_DOPPLER): (2.5e-2, 2.5e-2),
}


PIPELINE_NAMES = {
    Modality.BMODE: "RF2IQ_DAS_BMODE",
    Modality.DOPPLER: "RF2IQ_DAS_DOPPLER",
    Modality.POWER_DOPPLER: "RF2IQ_DAS_POWERDOPPLER",
}


@dataclasses.dataclass(frozen=True)
class UltrasoundConfig:
    """Full configuration of an RF-to-image pipeline."""

    # --- acquisition ----------------------------------------------------
    n_l: int = 1336          # axial RF samples per channel
    n_c: int = 64            # receive channels (array elements)
    n_f: int = 32            # temporal frames per forward pass
    fs: float = 20e6         # RF sampling frequency [Hz]
    f0: float = 5e6          # probe center frequency [Hz]
    c_sound: float = 1540.0  # speed of sound [m/s]
    prf: float = 4000.0      # pulse repetition frequency [Hz]
    pitch: float = 3.08e-4   # element pitch [m]
    rf_dtype: str = "int16"  # raw RF on the wire

    # --- demodulation (RF -> IQ) ----------------------------------------
    decim: int = 4           # decimation factor; fs_iq = fs / decim
    lpf_taps: int = 31       # FIR low-pass length (odd)
    lpf_cutoff: float = 0.5  # cutoff as a fraction of f0

    # --- image grid ------------------------------------------------------
    nz: int = 128            # axial pixels
    nx: int = 128            # lateral pixels
    z_min: float = 5e-3      # [m]
    z_max: float = 45e-3     # [m]
    f_number: float = 1.5    # dynamic receive aperture

    # --- processing ------------------------------------------------------
    modality: Modality = Modality.BMODE
    variant: Variant = Variant.CNN
    dynamic_range_db: float = 60.0  # B-mode compression range
    wall_filter_taps: int = 4       # Doppler clutter filter length
    smooth_kernel: int = 3          # Doppler spatial smoothing (square)

    # --- sparse (V3) block structure -------------------------------------
    sparse_block_p: int = 64
    sparse_block_s: int = 64

    # --- numerics ---------------------------------------------------------
    # True: atan2 / log10 use the CNN-expressible approximations of
    # core.cnn_ops; False: the framework's native functions.
    cnn_transcendentals: bool = True

    # --- operator lowerings ------------------------------------------------
    # stage name -> lowering name; normalized to a sorted tuple of pairs.
    stage_lowerings: Tuple[Tuple[str, str], ...] = ()

    # --- fusion + precision ------------------------------------------------
    fusion: str = "none"
    precision: str = "f32"
    fusion_block: Optional[int] = None

    # Deprecated alias for stage_lowerings={"beamform": "pallas"};
    # normalized away at construction, so it never reaches the hash.
    use_das_kernel: bool = False

    exec_map: str = "vmap"

    def __post_init__(self):
        # Accept the enums' string values ("dynamic", "bmode"); the hash
        # serializes both forms alike.
        object.__setattr__(self, "variant", Variant(self.variant))
        object.__setattr__(self, "modality", Modality(self.modality))
        if self.exec_map not in EXEC_MAPS:
            raise ValueError(
                f"unknown exec_map: {self.exec_map!r} "
                f"(expected one of {EXEC_MAPS})")
        if self.fusion not in FUSION_NAMES:
            raise ValueError(
                f"unknown fusion: {self.fusion!r} "
                f"(expected one of {FUSION_NAMES})")
        if self.precision not in PRECISION_NAMES:
            raise ValueError(
                f"unknown precision: {self.precision!r} "
                f"(expected one of {PRECISION_NAMES})")
        if self.fusion_block is not None:
            if self.fusion == "none":
                raise ValueError(
                    "fusion_block is a fused-kernel tile size — set "
                    "fusion='fused' or leave fusion_block=None")
            if not (isinstance(self.fusion_block, int)
                    and self.fusion_block > 0):
                raise ValueError(
                    f"fusion_block must be a positive int, got "
                    f"{self.fusion_block!r}")
        lowerings = self.stage_lowerings
        if isinstance(lowerings, Mapping):
            lowerings = tuple(lowerings.items())
        lowerings = {stage: name for stage, name in lowerings}
        if self.use_das_kernel:
            if self.variant in (Variant.DYNAMIC, Variant.AUTO):
                warnings.warn(
                    "UltrasoundConfig.use_das_kernel is deprecated; use "
                    "stage_lowerings={'beamform': 'pallas'}",
                    DeprecationWarning, stacklevel=3)
                lowerings.setdefault("beamform", "pallas")
            else:
                warnings.warn(
                    "UltrasoundConfig.use_das_kernel is deprecated and "
                    f"ignored for variant={self.variant.value!r} (the "
                    "fused DAS kernel lowers only the dynamic beamform); "
                    "use stage_lowerings={'beamform': 'pallas'} on a "
                    "dynamic config", DeprecationWarning, stacklevel=3)
            object.__setattr__(self, "use_das_kernel", False)
        for stage, name in lowerings.items():
            if stage not in STAGE_NAMES:
                raise ValueError(
                    f"unknown stage in stage_lowerings: {stage!r} "
                    f"(expected one of {STAGE_NAMES})")
            if name not in LOWERING_NAMES:
                raise ValueError(
                    f"unknown lowering for stage {stage!r}: {name!r} "
                    f"(expected one of {LOWERING_NAMES})")
        object.__setattr__(self, "stage_lowerings",
                           tuple(sorted(lowerings.items())))

    def stage_lowering(self, stage: str, default: str = "xla") -> str:
        """The lowering this config requests for ``stage`` (or default)."""
        return dict(self.stage_lowerings).get(stage, default)

    @property
    def fs_iq(self) -> float:
        return self.fs / self.decim

    @property
    def n_s(self) -> int:
        """IQ samples per channel after decimation."""
        return self.n_l // self.decim

    @property
    def n_pix(self) -> int:
        return self.nz * self.nx

    @property
    def rf_shape(self) -> Tuple[int, int, int]:
        return (self.n_l, self.n_c, self.n_f)

    @property
    def input_bytes(self) -> int:
        """B_in for the throughput metric (paper eq. 2)."""
        itemsize = 2 if self.rf_dtype == "int16" else 4
        return self.n_l * self.n_c * self.n_f * itemsize

    @property
    def name(self) -> str:
        return PIPELINE_NAMES[self.modality]

    def with_(self, **kwargs) -> "UltrasoundConfig":
        return dataclasses.replace(self, **kwargs)


# Must equal the reference package's schema string: equal hashes across
# the two packages are what lets one hash name one pipeline in both.
CONFIG_HASH_SCHEMA = "ultrasound-cfg-v3"


def config_hash(cfg: UltrasoundConfig, *,
                exclude: Collection[str] = ()) -> str:
    """Canonical content hash of a config (hex, 16 chars)."""
    d = dataclasses.asdict(cfg)
    for name in exclude:
        if name not in d:
            raise KeyError(f"unknown config field: {name!r}")
        del d[name]
    payload = json.dumps([CONFIG_HASH_SCHEMA, d], sort_keys=True,
                         default=lambda o: o.value)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def paper_config(**overrides) -> UltrasoundConfig:
    """The paper's benchmark geometry: 5.472 MB int16 RF per forward pass."""
    cfg = UltrasoundConfig()
    assert cfg.input_bytes == 5_472_256
    return cfg.with_(**overrides) if overrides else cfg


def tiny_config(**overrides) -> UltrasoundConfig:
    """Reduced geometry for unit tests: same structure, ~1000x smaller."""
    cfg = UltrasoundConfig(
        n_l=512, n_c=8, n_f=4, nz=24, nx=16,
        z_min=4e-3, z_max=16e-3, lpf_taps=15,
        sparse_block_p=16, sparse_block_s=16,
    )
    return cfg.with_(**overrides) if overrides else cfg
