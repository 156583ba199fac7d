"""The MoE block (`repro_torch.models.moe`) against the JAX reference.

The smoke configs of granite-moe-3b-a800m (8 experts padded to 48, top
2, no shared expert) and deepseek-v2-236b (8 experts, top 2, one shared
expert) in f32; the reference's ``moe_params`` from ``PRNGKey(0)``,
inputs from numpy seeds. Routing is compared exactly: each test first
asserts that every token's k-th and (k+1)-th router probabilities are
more than 1e-5 apart (``lax.top_k`` and ``torch.topk`` may break a near
tie apart, and the f32 router products sum in another order), then that
``idx``, ``rank`` and ``keep`` are equal. Outputs agree within rtol
1e-5, atol 1e-5 * max|ref|, each variant with the reference's same
variant; the aux losses within rtol 1e-6.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models.common import KeyGen  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.config import Variant  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCHS = ["granite-moe-3b-a800m", "deepseek-v2-236b"]
VARIANTS = ["dynamic", "cnn", "sparse"]
B, S = 2, 32
MARGIN = 1e-5


def _close(out, ref, rtol=1e-5):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict)
            else torch.as_tensor(np.array(v)) for k, v in tree.items()}


def _setup(arch, seed=0, **kw):
    """(port cfg, reference cfg, port params, reference params, x)."""
    jcfg = j_get_smoke(arch, **kw)
    jparams = j_moe.moe_params(KeyGen(jax.random.PRNGKey(0)), jcfg,
                               jnp.float32)
    x = (0.5 * np.random.default_rng(seed).standard_normal(
        (B, S, jcfg.d_model))).astype(np.float32)
    return get_smoke(arch, **kw), jcfg, _torch(jparams), jparams, x


def _assert_margin(cfg, router, x):
    """The precondition of an exact top-k comparison: no near tie at the
    k-th choice of any token (in f64 from the f32 inputs)."""
    logits = x.reshape(-1, cfg.d_model).astype(np.float64) @ np.asarray(
        router, np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.sort(p / p.sum(-1, keepdims=True), axis=-1)[:, ::-1]
    k = cfg.n_experts_per_tok
    gap = (p[:, k - 1] - p[:, k]).min()
    assert gap > MARGIN, f"a near tie at the k-th choice: gap {gap:.3e}"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_route_and_capacity_rank_equal_reference(arch, capacity_factor):
    cfg, jcfg, params, jparams, x = _setup(arch,
                                           capacity_factor=capacity_factor)
    _assert_margin(cfg, jparams["router"], x)
    x_flat = x.reshape(-1, cfg.d_model)
    jw, jidx, jaux = j_moe.route(jcfg, jparams["router"],
                                 jnp.asarray(x_flat))
    w, idx, aux = moe.route(cfg, params["router"], torch.as_tensor(x_flat))
    assert params["router"].dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(w, jw)
    for name in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(aux[name].item(), float(jaux[name]),
                                   rtol=1e-6)
    jcap, jrank, jkeep = j_moe.capacity_and_rank(jcfg, jidx, B * S)
    cap, rank, keep = moe.capacity_and_rank(cfg, idx, B * S)
    assert cap == jcap
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    if capacity_factor < 1:
        assert not keep.all()          # the tight case drops assignments


@pytest.mark.parametrize("n_tokens", [256, 768, 1000, 8192])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_capacity_rank_at_long_batches_equals_reference(n_tokens,
                                                        capacity_factor):
    """Past 256 tokens the ranks come from a blocked scan (256 tokens a
    block plus the earlier blocks' totals; 1000 tokens take the plain
    scan): the reference's integers, at granite-moe's 40 experts, top 8."""
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config
    kw = dict(capacity_factor=capacity_factor)
    cfg = get_config(ARCHS[0], **kw)
    jcfg = j_get_config(ARCHS[0], **kw)
    rng = np.random.default_rng(n_tokens)
    # distinct experts per token, skewed so that the tight capacity drops
    p = 1.0 / np.arange(1, cfg.n_experts + 1)
    idx = np.stack([rng.choice(cfg.n_experts, cfg.n_experts_per_tok,
                               replace=False, p=p / p.sum())
                    for _ in range(n_tokens)]).astype(np.int32)
    jcap, jrank, jkeep = j_moe.capacity_and_rank(jcfg, jnp.asarray(idx),
                                                 n_tokens)
    cap, rank, keep = moe.capacity_and_rank(
        cfg, torch.as_tensor(idx).long(), n_tokens)
    assert cap == jcap
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert not keep.all()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("variant", VARIANTS)
def test_moe_apply_matches_reference_variant(arch, variant,
                                             capacity_factor):
    """Each variant against the reference's same variant, at the default
    capacity and at a tight one (V2's capacity is per group of
    `group_size` tokens, V1's and V3's over the whole batch)."""
    cfg, jcfg, params, jparams, x = _setup(
        arch, capacity_factor=capacity_factor, moe_variant=variant)
    _assert_margin(cfg, jparams["router"], x)
    want, jaux = j_moe.moe_apply(jparams, jcfg, jnp.asarray(x))
    got, aux = moe.moe_apply(params, cfg, torch.as_tensor(x))
    _close(got, want)
    for name in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(aux[name].item(), float(jaux[name]),
                                   rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_variants_agree_with_ample_capacity(arch):
    """capacity_factor 8: nothing is dropped, so V1, V2 and V3 compute the
    same function and agree with each other."""
    cfg, _, params, _, x = _setup(arch, seed=1, capacity_factor=8.0)
    outs = {v: moe.moe_apply(params, cfg.with_(moe_variant=Variant(v)),
                             torch.as_tensor(x))[0] for v in VARIANTS}
    assert all(bool(torch.isfinite(y).all()) for y in outs.values())
    _close(outs["cnn"], outs["dynamic"])
    _close(outs["sparse"], outs["dynamic"])


@pytest.mark.parametrize("variant", ["dynamic", "sparse"])
def test_tight_capacity_drops_the_reference_set_and_discards_the_dump(
        variant):
    """capacity_factor 0.25: the dropped assignments are the reference's;
    every dropped assignment was written to the dump row, which held a
    real token's row, and yet a token whose every assignment was dropped
    comes out exactly 0 (no shared expert): the dump row is never read."""
    arch = "granite-moe-3b-a800m"
    cfg, jcfg, params, jparams, x = _setup(arch, capacity_factor=0.25,
                                           moe_variant=variant)
    _assert_margin(cfg, jparams["router"], x)
    x_flat = torch.as_tensor(x.reshape(-1, cfg.d_model))
    _, idx, _ = moe.route(cfg, params["router"], x_flat)
    cap, rank, keep = moe.capacity_and_rank(cfg, idx, B * S)
    _, jidx, _ = j_moe.route(jcfg, jparams["router"], jnp.asarray(x_flat))
    np.testing.assert_array_equal(
        keep.numpy(), np.asarray(j_moe.capacity_and_rank(jcfg, jidx,
                                                         B * S)[2]))
    dest, slotted = moe._slots(cfg, x_flat, idx, cap, rank, keep)
    assert slotted.shape == (cfg.n_experts_eff * cap, cfg.d_model)
    assert (dest == cfg.n_experts_eff * cap).sum() == (~keep).sum() > 1
    y, _ = moe.moe_apply(params, cfg, torch.as_tensor(x))
    want, _ = j_moe.moe_apply(jparams, jcfg, jnp.asarray(x))
    _close(y, want)
    dropped = ~keep.any(dim=1)
    assert dropped.any() and not dropped.all()
    assert (y.reshape(-1, cfg.d_model)[dropped] == 0).all()


def test_shared_experts_are_applied():
    """deepseek's shared expert runs on every token: with capacity 0.01
    (nearly everything dropped) no row is zero, and a token whose routed
    assignments were all dropped gets the shared expert's output alone."""
    arch = "deepseek-v2-236b"
    cfg, jcfg, params, jparams, x = _setup(arch, capacity_factor=0.01,
                                           moe_variant="dynamic")
    y, _ = moe.moe_apply(params, cfg, torch.as_tensor(x))
    want, _ = j_moe.moe_apply(jparams, jcfg, jnp.asarray(x))
    _close(y, want)
    y = y.reshape(-1, cfg.d_model)
    assert (y.norm(dim=-1) > 1e-7).all()
    x_flat = torch.as_tensor(x.reshape(-1, cfg.d_model))
    _, idx, _ = moe.route(cfg, params["router"], x_flat)
    _, _, keep = moe.capacity_and_rank(cfg, idx, B * S)
    dropped = ~keep.any(dim=1)
    assert dropped.any()
    from repro_torch.models.common import mlp_apply
    torch.testing.assert_close(y[dropped],
                               mlp_apply(params["shared"], x_flat,
                                         cfg.moe_d_ff * cfg.n_shared_experts
                                         )[dropped],
                               rtol=0, atol=0)


@pytest.mark.parametrize("n_tokens", [1, 4, 24, 40, 512, 8192])
def test_group_size_is_the_reference(n_tokens):
    cfg = get_smoke(ARCHS[0])
    assert moe.group_size(cfg, n_tokens) == j_moe.group_size(
        j_get_smoke(ARCHS[0]), n_tokens)


def test_moe_apply_refuses_auto():
    cfg, _, params, _, x = _setup(ARCHS[0], moe_variant="auto")
    with pytest.raises(ValueError, match="concrete"):
        moe.moe_apply(params, cfg, torch.as_tensor(x))
