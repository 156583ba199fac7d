"""Kernel modules of the PyTorch port on the CPU.

The plain versions (``das_beamform_ref``, ``fused_ref``) are held to the
reference's Pallas kernels run in interpret mode, on the same seeded
numpy inputs: rtol 1e-5, atol 1e-5 * max|ref| (the channel sum runs in
another order). The wrappers hand CPU tensors to the plain version and
count no launch. The CUDA kernels themselves are held to these plain
versions on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import config as jcfg  # noqa: E402
from repro.core.pipeline import init_pipeline  # noqa: E402
from repro.data import synth_rf  # noqa: E402
from repro.kernels.das_beamform import das_beamform as j_das  # noqa: E402
from repro.kernels.fused_pipeline import (  # noqa: E402
    fused_rf_to_envelope as j_env, fused_rf_to_power as j_pow)

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.das_beamform import (das_beamform,  # noqa: E402
                                              das_beamform_ref)
from repro_torch.kernels.fused_pipeline import (  # noqa: E402
    fused_ref, fused_rf_to_envelope, fused_rf_to_power)


def _close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def _tables(rng, n_pix, n_c, n_s):
    idx = rng.integers(0, n_s - 1, (n_pix, n_c)).astype(np.int32)
    frac = rng.uniform(0, 1, (n_pix, n_c)).astype(np.float32)
    apod = rng.uniform(0, 1, (n_pix, n_c)).astype(np.float32)
    ph = rng.uniform(-np.pi, np.pi, (n_pix, n_c))
    rot = np.stack([np.cos(ph), np.sin(ph)], -1).astype(np.float32)
    return idx, frac, apod, rot


@pytest.mark.parametrize("n_pix,n_c,n_s,n_f", [
    (64, 4, 32, 2),
    (96, 8, 64, 4),
    (100, 3, 40, 1),     # ragged n_pix: the reference pads, the port masks
    (40, 5, 24, 33),     # more frames than a warp's lanes
])
def test_das_ref_matches_reference_kernel(n_pix, n_c, n_s, n_f):
    rng = np.random.default_rng(n_pix)
    tables = _tables(rng, n_pix, n_c, n_s)
    iq = rng.standard_normal((2, n_s, n_c, n_f, 2)).astype(np.float32)
    out = das_beamform_ref(*map(torch.as_tensor, tables),
                           torch.as_tensor(iq))
    for b in range(2):
        ref = j_das(*map(jnp.asarray, tables), jnp.asarray(iq[b]), bp=32)
        _close(out[b], ref)


@pytest.mark.parametrize("precision", ["bf16", "f16"])
def test_das_ref_reduced_precision_matches_reference_kernel(precision):
    """Operand rounding (IQ samples and lerp weights) is the reference
    kernel's: its one-hot weights and IQ are cast, products summed in
    f32 — so the two agree to float32 reduction order, not just to
    PRECISION_TOLERANCES."""
    rng = np.random.default_rng(2)
    tables = _tables(rng, 96, 8, 64)
    iq = rng.standard_normal((1, 64, 8, 4, 2)).astype(np.float32)
    out = das_beamform_ref(*map(torch.as_tensor, tables),
                           torch.as_tensor(iq), precision=precision)
    ref = j_das(*map(jnp.asarray, tables), jnp.asarray(iq[0]), bp=32,
                precision=precision)
    _close(out[0], ref)
    f32 = das_beamform_ref(*map(torch.as_tensor, tables),
                           torch.as_tensor(iq))
    assert not torch.equal(out, f32)        # the rounding really happened


@pytest.fixture(scope="module")
def real():
    jc = jcfg.tiny_config(variant=jcfg.Variant.DYNAMIC,
                          modality=jcfg.Modality.POWER_DOPPLER,
                          n_c=16, n_f=8, nz=32, nx=32)
    consts = init_pipeline(jc)
    rf = np.stack([synth_rf(jc, seed=s) for s in (4, 5)])
    return jc, consts, rf


def _args(consts, names, conv):
    return [conv(np.array(consts[k])) for k in names]


TABLES = ("carrier", "lpf", "idx", "frac", "apod", "rot")


def test_fused_ref_envelope_matches_reference_kernel(real):
    jc, consts, rf = real
    out = fused_ref(*_args(consts, TABLES, torch.as_tensor),
                    torch.as_tensor(rf), decim=jc.decim, head="bmode")
    for b in range(rf.shape[0]):
        ref = j_env(*_args(consts, TABLES, jnp.asarray), jnp.asarray(rf[b]),
                    decim=jc.decim)
        _close(out[b], ref)


def test_fused_ref_power_matches_reference_kernel(real):
    jc, consts, rf = real
    out = fused_ref(*_args(consts, TABLES, torch.as_tensor),
                    torch.as_tensor(rf), decim=jc.decim,
                    head="power_doppler",
                    wall=torch.as_tensor(np.array(consts["wall_taps"])))
    for b in range(rf.shape[0]):
        ref = j_pow(*_args(consts, TABLES, jnp.asarray),
                    jnp.asarray(consts["wall_taps"]), jnp.asarray(rf[b]),
                    decim=jc.decim)
        _close(out[b], ref)


@pytest.mark.parametrize("precision", ["bf16", "f16"])
def test_fused_ref_reduced_precision_matches_reference_kernel(real,
                                                              precision):
    """The reference's fused kernel at reduced precision casts its banded
    FIR matrix, the mixed RF, the one-hot weights and the IQ; the plain
    version rounds the same operands, so the two agree to float32
    reduction order."""
    jc, consts, rf = real
    out = fused_ref(*_args(consts, TABLES, torch.as_tensor),
                    torch.as_tensor(rf[:1]), decim=jc.decim,
                    precision=precision)
    ref = j_env(*_args(consts, TABLES, jnp.asarray), jnp.asarray(rf[0]),
                decim=jc.decim, precision=precision)
    _close(out[0], ref)


@pytest.mark.parametrize("head", ["bmode", "power_doppler"])
@pytest.mark.parametrize("bp", [64, 128, 256])
def test_fused_wrappers_match_reference_kernel_at_each_tile(real, bp, head):
    """The wrappers take the reference's pixel tiles: on CPU tensors the
    port's result (the plain version, which ignores ``bp``) matches the
    reference kernel run with the same ``bp``. This pins the reference's
    tiling, not the port's: the CUDA kernel's tiles are held to the plain
    version by the card tests (test_torch_gpu.py)."""
    jc, consts, rf = real
    t = _args(consts, TABLES, torch.as_tensor)
    wall = np.array(consts["wall_taps"])
    if head == "bmode":
        out = fused_rf_to_envelope(*t, torch.as_tensor(rf[:1]),
                                   decim=jc.decim, bp=bp)
        ref = j_env(*_args(consts, TABLES, jnp.asarray), jnp.asarray(rf[0]),
                    decim=jc.decim, bp=bp)
    else:
        out = fused_rf_to_power(*t, torch.as_tensor(wall),
                                torch.as_tensor(rf[:1]), decim=jc.decim,
                                bp=bp)
        ref = j_pow(*_args(consts, TABLES, jnp.asarray), jnp.asarray(wall),
                    jnp.asarray(rf[0]), decim=jc.decim, bp=bp)
    _close(out[0], ref)


@pytest.mark.parametrize("bp", [32, 100, 512, True])
def test_fused_wrappers_refuse_a_tile_the_kernel_lacks(real, bp):
    """A ``bp`` outside (64, 128, 256) raises on either device: the tile
    is never changed quietly."""
    jc, consts, rf = real
    t = _args(consts, TABLES, torch.as_tensor)
    x = torch.as_tensor(rf[:1])
    with pytest.raises(ValueError, match="pixel tile"):
        fused_rf_to_envelope(*t, x, decim=jc.decim, bp=bp)
    with pytest.raises(ValueError, match="pixel tile"):
        fused_rf_to_power(*t, torch.as_tensor(np.array(consts["wall_taps"])),
                          x, decim=jc.decim, bp=bp)


def test_wrappers_route_cpu_tensors_to_plain_version(real):
    jc, consts, rf = real
    t = {k: torch.as_tensor(np.array(v)) for k, v in consts.items()}
    x = torch.as_tensor(rf)
    kernels.reset_launch_counts()
    env = fused_rf_to_envelope(*(t[k] for k in TABLES), x, decim=jc.decim)
    assert torch.equal(env, fused_ref(*(t[k] for k in TABLES), x,
                                      decim=jc.decim))
    r0 = fused_rf_to_power(*(t[k] for k in TABLES), t["wall_taps"], x,
                           decim=jc.decim)
    assert torch.equal(r0, fused_ref(*(t[k] for k in TABLES), x,
                                     decim=jc.decim, head="power_doppler",
                                     wall=t["wall_taps"]))
    iq = torch.randn(2, jc.n_s, jc.n_c, jc.n_f, 2)
    tabs = [t[k] for k in ("idx", "frac", "apod", "rot")]
    for p in ("f32", "bf16"):
        assert torch.equal(das_beamform(*tabs, iq, precision=p),
                           das_beamform_ref(*tabs, iq, precision=p))
    assert kernels.launch_counts() == {
        "das_beamform": 0, "fused_rf_to_envelope": 0,
        "fused_rf_to_power": 0, "bsr_spmm": 0, "bsr_beamform": 0,
        "flash_attention": 0, "ssd_scan": 0}


def test_wrappers_refuse_bad_arguments():
    iq = torch.zeros(1, 8, 2, 4, 2)
    tabs = (torch.zeros(4, 2, dtype=torch.int32), torch.zeros(4, 2),
            torch.zeros(4, 2), torch.zeros(4, 2, 2))
    with pytest.raises(ValueError, match="precision"):
        das_beamform(*tabs, iq, precision="fp8")
    with pytest.raises(ValueError, match="cuda or cpu"):
        das_beamform(*tabs, iq.to("meta"))
