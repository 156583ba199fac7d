"""The port's int8 compressed mean (`repro_torch.optim.compress`) against
the reference's.

On n = 2 and 4 CPU ranks (gloo, one spawn each), each rank's tree of
gradients (f32 leaves, one with a dominant entry and one of zeros) and
of residuals, from numpy's generator; the reference's
``compressed_psum_mean`` under ``jax.vmap(..., axis_name="data")`` over
the same per-rank inputs. Without and with the residual, the mean on
every rank and each rank's new residual equal the reference's bit for
bit. The reference's own check (its tests/test_sharding_spmd.py): the
mean of standard normal rows is within max|exact mean| / 64 of the exact
mean.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim.compress import compressed_psum_mean as j_compressed  # noqa: E402,E501

from torch_dist_ranks import compress_rank, run_ranks  # noqa: E402

WORLDS = (2, 4)


def _inputs(n):
    rng = np.random.default_rng(n)
    per_rank = []
    for r in range(n):
        big = rng.standard_normal((8, 16)).astype(np.float32)
        big[3, 5] = 40.0 * (r + 1)
        grads = {"w": rng.standard_normal((64, 32)).astype(np.float32),
                 "layers": {"big": big,
                            "zero": np.zeros((5,), np.float32)},
                 "normal": rng.standard_normal((8, 64)).astype(np.float32)}
        residual = {"w": 1e-3 * rng.standard_normal((64, 32)).astype(
                        np.float32),
                    "layers": {"big": 1e-2 * rng.standard_normal(
                        (8, 16)).astype(np.float32),
                        "zero": np.zeros((5,), np.float32)},
                    "normal": np.zeros((8, 64), np.float32)}
        per_rank.append((grads, residual))
    return per_rank


def _reference(per_rank):
    stack = lambda i: jax.tree.map(lambda *x: jnp.stack(x),  # noqa: E731
                                   *[p[i] for p in per_rank])
    g, r = stack(0), stack(1)
    mean = jax.vmap(lambda g: j_compressed(g, "data")[0],
                    axis_name="data")(g)
    mean_r, new_r = jax.vmap(lambda g, r: j_compressed(g, "data", r),
                             axis_name="data")(g, r)
    return jax.tree.map(np.asarray, (mean, mean_r, new_r))


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"n{n}")
def world(request, tmp_path_factory):
    n = request.param
    per_rank = _inputs(n)
    got = run_ranks(compress_rank, n, tmp_path_factory.mktemp(f"c{n}"),
                    per_rank)
    return n, per_rank, got, _reference(per_rank)


def _flat(t):
    flat, _ = jax.tree_util.tree_flatten_with_path(t)
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}


def test_mean_bit_for_bit(world):
    n, _, got, (mean, _, _) = world
    for r in range(n):
        want = _flat(jax.tree.map(lambda x: x[r], mean))
        have = _flat(got[r]["mean"])
        assert set(have) == set(want)
        for k in want:
            assert have[k].dtype == np.float32, k
            assert np.array_equal(have[k], want[k]), (r, k)


def test_mean_and_residual_bit_for_bit(world):
    n, _, got, (_, mean_r, new_r) = world
    for r in range(n):
        for name, ref in (("mean_r", mean_r), ("residual", new_r)):
            want = _flat(jax.tree.map(lambda x: x[r], ref))
            have = _flat(got[r][name])
            assert set(have) == set(want)
            for k in want:
                assert np.array_equal(have[k], want[k]), (name, r, k)


def test_error_bound_of_the_reference(world):
    """Within max|exact mean| / 64 on the standard normal rows; within
    half a quantization step everywhere."""
    n, per_rank, got, _ = world
    exact = np.mean([p[0]["normal"] for p in per_rank], axis=0)
    err = np.abs(got[0]["mean"]["normal"] - exact).max()
    assert err <= np.abs(exact).max() / 64, (err, np.abs(exact).max())
    for key in ("w", "normal"):
        g = np.stack([p[0][key] for p in per_rank])
        scale = np.abs(g).max() / 127.0
        err = np.abs(got[0]["mean"][key] - g.mean(0)).max()
        assert err <= scale / 2 * (1 + 1e-5), (key, err, scale)
