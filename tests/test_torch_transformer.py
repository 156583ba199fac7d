"""The dense transformer (`repro_torch.models.transformer`) against the JAX
reference.

gemma3-1b's smoke config in f32 with the flash flag on: 6 layers in the
5:1 local:global pattern, qk-norm, a local rope base and a sliding
window of 8 under a sequence of 32, so the local mask matters. The
reference's scanned layers pass a traced window, so neither package
takes the flash kernel (ROADMAP C); the port's window is a 0-d tensor on
the device. Parameters are the reference's ``init_params(PRNGKey(0))``,
carried over by ``params_from_numpy``; tokens come from a numpy seed.
Hidden states, the loss, the prefill logits and cache and every decode
step (both KV-cache variants) agree within rtol 1e-5, atol 1e-5 *
max|ref|; the greedy tokens of ``serve_session`` are equal. The other
dense smokes (qwen3-8b, granite-3-8b, llama3-405b) run a forward and
one decode step each.
"""

import importlib

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.core.config import Variant as JVariant  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import transformer as j_transformer  # noqa: E402
from repro.models.common import logits_from_hidden as j_logits  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.config import Variant  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402
from repro_torch.models import get_model, params_from_numpy  # noqa: E402
from repro_torch.models.common import logits_from_hidden  # noqa: E402

ARCH = "gemma3-1b"
FLAGS = dict(use_flash_kernel=True)
B, S, EXTRA = 2, 32, 4


def _close(out, ref, rtol=1e-5):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _reference(arch, n_tokens, prefill_len):
    cfg = j_get_smoke(arch, **FLAGS)
    model = j_get_model(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, n_tokens)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, n_tokens)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    h, _ = model.forward(params, batch)
    logits_p, cache = jax.jit(model.prefill)(
        params, {"tokens": batch["tokens"][:, :prefill_len]})
    return dict(cfg=cfg, model=model, params=params, batch=batch,
                tree=jax.tree.map(np.asarray, params), tokens=tokens,
                labels=labels, hidden=np.asarray(h),
                logits=np.asarray(j_logits(params["embed"], cfg, h)),
                logits_p=np.asarray(logits_p), cache=cache)


@pytest.fixture(scope="module")
def ref():
    """gemma3's reference outputs: forward on S + EXTRA tokens, prefill
    on the first S, and the loss."""
    r = _reference(ARCH, S + EXTRA, S)
    loss, _ = r["model"].loss_fn(r["params"], r["batch"])
    r["loss"] = float(loss)
    return r


@pytest.fixture(scope="module")
def port(ref):
    cfg = get_smoke(ARCH, **FLAGS)
    return dict(cfg=cfg, model=get_model(cfg, device="cpu"),
                params=params_from_numpy(cfg, ref["tree"], device="cpu"))


@pytest.fixture
def flash_calls(monkeypatch):
    """Calls of the ``flash_attention`` wrapper (on the CPU it runs its
    plain version and counts no launch, so the calls show the path)."""
    calls = []
    pkg = importlib.import_module("repro_torch.kernels.flash_attention")
    real = pkg.flash_attention

    def spy(q, *args, **kwargs):
        calls.append(tuple(q.shape))
        return real(q, *args, **kwargs)

    monkeypatch.setattr(pkg, "flash_attention", spy)
    return calls


def _batch(ref, n=None):
    n = n or ref["tokens"].shape[1]
    return {"tokens": torch.as_tensor(ref["tokens"][:, :n]),
            "labels": torch.as_tensor(ref["labels"][:, :n])}


def test_smoke_runs_past_the_window():
    cfg = get_smoke(ARCH)
    assert S > cfg.sliding_window > 0 and cfg.qk_norm
    np.testing.assert_array_equal(transformer.layer_kinds(cfg),
                                  j_transformer.layer_kinds(j_get_smoke(ARCH)))
    is_local, window = transformer._kinds(cfg, torch.device("cpu"))
    np.testing.assert_array_equal(is_local.numpy(),
                                  transformer.layer_kinds(cfg) > 0)
    np.testing.assert_array_equal(
        window.numpy(), np.where(is_local.numpy(), cfg.sliding_window, 0))


def test_forward_matches_reference_without_flash(ref, port, flash_calls):
    h, aux = port["model"].forward(port["params"], _batch(ref))
    # a dense model's MoE losses are zeros, as the reference's
    assert {k: v.item() for k, v in aux.items()} == {"moe_lb_loss": 0.0,
                                                     "moe_z_loss": 0.0}
    assert h.dtype == torch.float32
    _close(h, ref["hidden"])
    _close(logits_from_hidden(port["params"]["embed"], port["cfg"], h),
           ref["logits"])
    # the reference's condition, held: a tensor window never takes flash
    assert port["cfg"].use_flash_kernel and flash_calls == []


def test_loss_matches_reference(ref, port):
    loss, metrics = port["model"].loss_fn(port["params"], _batch(ref))
    assert torch.equal(metrics["xent"], loss)    # no MoE terms
    _close(loss.item(), ref["loss"])


def test_prefill_matches_reference(ref, port):
    logits, cache = port["model"].prefill(port["params"], _batch(ref, S))
    _close(logits, ref["logits_p"])
    cfg = port["cfg"]
    assert cache["k"].shape == (cfg.n_layers, B, S, cfg.n_kv_heads,
                                cfg.head_dim)
    _close(cache["k"], ref["cache"]["k"])
    _close(cache["v"], ref["cache"]["v"])


def _decode_both(ref, cfg, jcfg, params, n_steps, prefill_len):
    """Decode ``n_steps`` tokens after a prefill of ``prefill_len`` in
    both packages; returns each step's logits and the last caches."""
    jmodel = j_get_model(jcfg)
    model = get_model(cfg, device="cpu")
    _, cache = model.prefill(params, _batch(ref, prefill_len))
    total = prefill_len + n_steps + 1
    cache = serve._grow_cache(model, cache, total)
    jcache = j_serve._grow_cache(jmodel, ref["cache"], total)
    decode = jax.jit(jmodel.decode_step)
    lengths = np.full((B,), prefill_len, np.int32)
    steps, given = [], dict(cache)
    for t in range(n_steps):
        tok = ref["tokens"][:, prefill_len + t:prefill_len + t + 1]
        jl, jcache = decode(ref["params"], jnp.asarray(tok), jcache,
                            jnp.asarray(lengths))
        logits, cache = model.decode_step(params, torch.as_tensor(tok),
                                          cache, torch.as_tensor(lengths))
        steps.append((logits, jl))
        lengths = lengths + 1
    assert all(cache[k] is given[k] for k in given)     # written in place
    return steps, cache, jcache


@pytest.mark.parametrize("kv_variant", ["dynamic", "cnn"])
def test_decode_steps_match_reference(ref, port, kv_variant):
    """From the same prefill, each decode step's logits and the cache it
    leaves agree with the reference's; the step writes into the cache it
    was given."""
    steps, cache, jcache = _decode_both(
        ref, port["cfg"].with_(kv_variant=Variant(kv_variant)),
        ref["cfg"].with_(kv_variant=kv_variant), port["params"], EXTRA, S)
    for logits, jl in steps:
        _close(logits, jl)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-3-8b",
                                  "llama3-405b"])
def test_dense_smokes_forward_and_decode_match_reference(arch):
    r = _reference(arch, 17, 16)
    cfg = get_smoke(arch, **FLAGS)
    params = params_from_numpy(cfg, r["tree"], device="cpu")
    h, _ = get_model(cfg, device="cpu").forward(params, _batch(r))
    _close(h, r["hidden"])
    [(logits, jl)], cache, jcache = _decode_both(r, cfg, r["cfg"], params,
                                                 1, 16)
    _close(logits, jl)
    _close(cache["k"], jcache["k"])


def test_serve_session_tokens_equal_reference(ref):
    """Prompts of 12 and 5 new tokens: the last steps attend past the
    local window of 8."""
    kw = dict(requests=4, batch=2, prompt_len=12, max_new=5, seed=0)
    want, jstats = j_serve.serve_session(ref["cfg"], **kw)
    cfg = get_smoke(ARCH, **FLAGS)
    got, stats = serve.serve_session(
        cfg, params=params_from_numpy(cfg, ref["tree"], device="cpu"),
        device="cpu", **kw)
    assert got.shape == (4, 6)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats["tokens"] == jstats["tokens"]


@pytest.mark.parametrize("variant", ["dynamic", "cnn"])
@pytest.mark.parametrize("pos", [[3, 7], [0, 8]])
def test_stacked_cache_update_matches_reference(variant, pos):
    """One token written at (layer 1, b, lengths[b]) of an (L, B, S, H, dh)
    cache; a position past the cache (8) writes nothing, as the
    reference's ``mode="drop"`` and one-hot blend."""
    rng = np.random.default_rng(4)
    cache = rng.standard_normal((3, 2, 8, 2, 4)).astype(np.float32)
    new = rng.standard_normal((2, 1, 2, 4)).astype(np.float32)
    lengths = np.asarray(pos, np.int32)
    want = j_attn.stacked_cache_update(
        jnp.asarray(cache), jnp.asarray(new), jnp.asarray(lengths), 1,
        JVariant(variant))
    got = attention.stacked_cache_update(
        torch.as_tensor(cache.copy()), torch.as_tensor(new),
        torch.as_tensor(lengths), 1, Variant(variant))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("window", [0, 3, 8])
def test_tensor_window_masks_equal_the_int_ones(window):
    """A 0-d tensor window gives the reference's masks, in chunked and in
    decode attention."""
    rng = np.random.default_rng(window)
    q, k, v = (rng.standard_normal((2, 10, h, 8)).astype(np.float32)
               for h in (4, 2, 2))
    want = j_attn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), window=window, chunk=4)
    got = attention.chunked_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        window=torch.tensor(window, dtype=torch.int32), chunk=4)
    _close(got, want)
    lengths = np.asarray([9, 5], np.int32)
    want = j_attn.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(lengths),
                                   window=window)
    got = attention.decode_attention(
        torch.as_tensor(q[:, :1]), torch.as_tensor(k), torch.as_tensor(v),
        torch.as_tensor(lengths),
        window=torch.tensor(window, dtype=torch.int32))
    _close(got, want)
