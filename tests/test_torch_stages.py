"""PyTorch port vs JAX reference: the stages of the dynamic pipeline.

Same seeded numpy RF and the reference's own constants go through each
JAX stage function and its port (batch axis added). Tolerance for the
quantities before the log: rtol 1e-5, atol 1e-5 * max|ref| (float32
reduction order differs between XLA:CPU and torch).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import beamform as jbf  # noqa: E402
from repro.core import bmode as jbm  # noqa: E402
from repro.core import config as jcfg  # noqa: E402
from repro.core import demod as jdm  # noqa: E402
from repro.core import doppler as jdp  # noqa: E402
from repro.core.pipeline import init_pipeline  # noqa: E402
from repro.data import synth_rf  # noqa: E402

from repro_torch.core import beamform as tbf  # noqa: E402
from repro_torch.core import bmode as tbm  # noqa: E402
from repro_torch.core import config as tcfg  # noqa: E402
from repro_torch.core import demod as tdm  # noqa: E402
from repro_torch.core import doppler as tdp  # noqa: E402
from repro_torch.core.pipeline import consts_from_numpy  # noqa: E402

GEOMS = {"tiny": {}, "wide": dict(n_c=16, n_f=8, nz=32, nx=32)}


def _close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.fixture(scope="module", params=sorted(GEOMS))
def case(request):
    kw = GEOMS[request.param]
    jc = jcfg.tiny_config(variant=jcfg.Variant.DYNAMIC,
                          modality=jcfg.Modality.POWER_DOPPLER, **kw)
    tc = tcfg.tiny_config(variant="dynamic", modality="power_doppler", **kw)
    consts = init_pipeline(jc)
    rf = synth_rf(jc, seed=3)
    jconsts = {k: jnp.asarray(v) for k, v in consts.items()}
    iq = jdm.rf_to_iq(jconsts, jnp.asarray(rf), jc.decim)
    bf = jbf.beamform_dynamic(jc, jconsts, iq)
    return dict(jc=jc, tc=tc, jconsts=jconsts,
                tconsts=consts_from_numpy(consts, "cpu"), rf=rf,
                iq=np.array(iq), bf=np.array(bf))


def test_demod(case):
    out = tdm.rf_to_iq(case["tconsts"], torch.as_tensor(case["rf"])[None],
                       case["tc"].decim)[0]
    _close(out, case["iq"])


def test_same_pad_matches_reference():
    for n, k, s in ((1336, 31, 4), (512, 15, 4), (101, 7, 3), (5, 9, 2)):
        assert tdm.same_pad(n, k, s) == jdm._same_pad(n, k, s)


def test_design_lowpass_and_carrier_equal(case):
    for k, v in jdm.demod_consts(case["jc"]).items():
        assert np.array_equal(tdm.demod_consts(case["tc"])[k], v), k


def test_beamform_dynamic(case):
    out = tbf.beamform_dynamic(case["tc"], case["tconsts"],
                               torch.as_tensor(case["iq"])[None])[0]
    _close(out, case["bf"])


@pytest.mark.parametrize("variant", ["cnn", "sparse"])
def test_beamform_cnn_and_sparse(case, variant):
    """Each operator variant on the reference's own operator constants
    equals the reference's formulation, and the dynamic beamform."""
    jc = case["jc"].with_(variant=jcfg.Variant(variant))
    consts = init_pipeline(jc)
    iq = torch.as_tensor(case["iq"])
    out = tbf.BEAMFORMERS[tcfg.Variant(variant)](
        case["tc"].with_(variant=variant), consts_from_numpy(consts, "cpu"),
        torch.stack([iq, 2 * iq]))
    ref = jbf.BEAMFORMERS[jc.variant](
        jc, {k: jnp.asarray(v) for k, v in consts.items()},
        jnp.asarray(case["iq"]))
    _close(out[0], ref)
    _close(out[1], 2 * np.asarray(ref))
    _close(out[0], case["bf"])


def test_envelope(case):
    out = tbm.envelope(torch.as_tensor(case["bf"])[None])[0]
    _close(out, jbm.envelope(jnp.asarray(case["bf"])))


def test_wall_filter_and_r0(case):
    bf = torch.as_tensor(case["bf"])[None]
    _close(tdp.apply_wall_filter(case["tconsts"], bf)[0],
           jdp.apply_wall_filter(case["jconsts"], jnp.asarray(case["bf"])))
    _close(tdp.power_from_ensemble(case["tconsts"], bf)[0],
           jdp.power_from_ensemble(case["jconsts"], jnp.asarray(case["bf"])))


def test_heads_on_identical_input(case):
    """Each head on the same beamformed IQ: the log-domain outputs agree
    to float32 rounding once sqrt is correctly rounded (cnn_ops.sqrt_rn)."""
    bf_t = torch.as_tensor(case["bf"])[None]
    bf_j = jnp.asarray(case["bf"])
    np.testing.assert_allclose(
        tbm.bmode_image(case["tc"], bf_t)[0],
        np.asarray(jbm.bmode_image(case["jc"], bf_j)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tdp.power_doppler_image(case["tc"], case["tconsts"], bf_t)[0],
        np.asarray(jdp.power_doppler_image(case["jc"], case["jconsts"],
                                           bf_j)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tdp.color_doppler_image(case["tc"], case["tconsts"], bf_t)[0],
        np.asarray(jdp.color_doppler_image(case["jc"], case["jconsts"],
                                           bf_j)), rtol=0, atol=1e-6)
