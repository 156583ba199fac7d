"""PyTorch port vs JAX reference: the CNN-expressible primitive ops.

Every op of ``core.cnn_ops`` on the same seeded numpy inputs, including
the eps edges (zeros, values below eps, signed zeros). Both are float32
pointwise compositions in the same expression order; the tolerance
(rtol 1e-6, atol 1e-7) allows a last-bit difference in a library sqrt or
division, nothing more.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import cnn_ops as jops  # noqa: E402
from repro_torch.core import cnn_ops as tops  # noqa: E402

RTOL, ATOL = 1e-6, 1e-7


def _close(out, ref):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    y = rng.standard_normal((64, 8)).astype(np.float32)
    # eps edges: exact zeros (both signs), values at / below eps, huge.
    # No subnormals: XLA:CPU flushes them to zero and torch does not.
    x[0, :4] = [0.0, -0.0, 1e-30, -1e-35]
    y[0, :4] = [0.0, 0.0, -0.0, 1e-36]
    x[1, :3] = [2e-38, 3e4, -3e4]
    pos = np.abs(x) * 10.0 ** rng.uniform(-8, 4, x.shape).astype(np.float32)
    pos[0, :3] = [0.0, 1e-30, 1e-40]
    z = rng.standard_normal((64, 8, 2)).astype(np.float32)
    w = rng.standard_normal((64, 8, 2)).astype(np.float32)
    mask = (rng.uniform(size=x.shape) > 0.5).astype(np.float32)
    return dict(x=x, y=y, pos=pos.astype(np.float32), z=z, w=w, mask=mask)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", ["atan2_approx", "ge_mask"])
def test_binary(data, name):
    _close(getattr(tops, name)(_t(data["y"]), _t(data["x"])),
           getattr(jops, name)(jnp.asarray(data["y"]), jnp.asarray(data["x"])))


def test_ge_mask_scalar_sides(data):
    _close(tops.ge_mask(0.0, _t(data["x"])),
           jops.ge_mask(0.0, jnp.asarray(data["x"])))
    _close(tops.ge_mask(_t(data["x"]), 1e-30),
           jops.ge_mask(jnp.asarray(data["x"]), 1e-30))


def test_select_and_clip(data):
    m, x, y = data["mask"], data["x"], data["y"]
    _close(tops.select(_t(m), _t(x), _t(y)),
           jops.select(jnp.asarray(m), jnp.asarray(x), jnp.asarray(y)))
    _close(tops.clip(_t(x), -0.5, 0.25), jops.clip(jnp.asarray(x), -0.5, 0.25))


def test_atan_poly(data):
    zz = np.clip(data["x"], -1.0, 1.0)
    _close(tops.atan_poly(_t(zz)), jops.atan_poly(jnp.asarray(zz)))


@pytest.mark.parametrize("name", ["ln_approx", "log10_approx",
                                  "db20_approx"])
def test_logs_including_eps_clamp(data, name):
    out = getattr(tops, name)(_t(data["pos"]))
    ref = getattr(jops, name)(jnp.asarray(data["pos"]))
    _close(out, ref)
    assert np.isfinite(np.asarray(out)).all()
    assert np.array_equal(np.asarray(out)[0, :3], np.asarray(ref)[0, :3])


def test_sqrt_rn_is_correctly_rounded():
    """ln_approx's 2^16 scale makes one ulp of any of its 16 roots a
    visible image step, so the port's sqrt must round exactly as XLA's
    does (torch's own CPU sqrt does not)."""
    rng = np.random.default_rng(5)
    x = (rng.uniform(0, 1, 200_000)
         * 10.0 ** rng.uniform(-30, 30, 200_000)).astype(np.float32)
    exact = np.sqrt(x.astype(np.float64)).astype(np.float32)
    assert np.array_equal(tops.sqrt_rn(_t(x)).numpy(), exact)
    assert np.array_equal(np.asarray(jnp.sqrt(jnp.asarray(x))), exact)


def test_magnitude_and_complex(data):
    z, w = data["z"], data["w"]
    _close(tops.magnitude(_t(z[..., 0]), _t(z[..., 1])),
           jops.magnitude(jnp.asarray(z[..., 0]), jnp.asarray(z[..., 1])))
    _close(tops.cmul(_t(z), _t(w)), jops.cmul(jnp.asarray(z), jnp.asarray(w)))
    _close(tops.cconj(_t(z)), jops.cconj(jnp.asarray(z)))
    _close(tops.cabs2(_t(z)), jops.cabs2(jnp.asarray(z)))
    _close(tops.cpack(_t(z[..., 0]), _t(z[..., 1])), z)
    _close(tops.creal(_t(z)), jops.creal(jnp.asarray(z)))
    _close(tops.cimag(_t(z)), jops.cimag(jnp.asarray(z)))


def test_normalize_by_max(data):
    p = data["pos"]
    _close(tops.normalize_by_max(_t(p)), jops.normalize_by_max(jnp.asarray(p)))
    _close(tops.normalize_by_max(_t(p), dim=0),
           jops.normalize_by_max(jnp.asarray(p), axis=0))
    zero = np.zeros((4, 3), np.float32)          # eps keeps 0 / 0 finite
    _close(tops.normalize_by_max(_t(zero), dim=0),
           jops.normalize_by_max(jnp.asarray(zero), axis=0))
