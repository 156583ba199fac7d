"""mamba2-130m (`repro_torch.models.mamba_lm`) against the JAX reference.

The mamba2-130m smoke config in f32 with the SSD kernel flag on: the
reference runs its Pallas kernel in interpret mode, the port (on the
CPU) the plain version of its CUDA kernel. Parameters are the
reference's ``init_params(PRNGKey(0))``, carried over by
``params_from_numpy``; tokens come from a numpy seed. Hidden states, the
loss, the prefill logits and states and every decode step agree within
rtol 1e-5, atol 1e-5 * max|ref| (the SSD sums run in another order); the
greedy tokens of ``serve_session`` are equal. The kernel runs where the
reference runs it: in forward and loss, never in prefill.
"""

import importlib

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models.common import logits_from_hidden as j_logits  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.config import Variant  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_model, params_from_numpy  # noqa: E402
from repro_torch.models.common import logits_from_hidden  # noqa: E402

ARCH = "mamba2-130m"
FLAGS = dict(use_ssd_kernel=True)
B, S, EXTRA = 2, 32, 4


def _close(out, ref, rtol=1e-5):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module")
def ref():
    """The reference model, its parameters and its outputs on one token
    batch (forward with the kernel, prefill on the first S tokens)."""
    cfg = j_get_smoke(ARCH, **FLAGS)
    model = j_get_model(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (B, S + EXTRA)).astype(
        np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S + EXTRA)).astype(
        np.int32)
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    h, _ = model.forward(params, batch)
    loss, _ = model.loss_fn(params, batch)
    logits_p, cache = jax.jit(model.prefill)(
        params, {"tokens": batch["tokens"][:, :S]})
    return dict(cfg=cfg, params=params,
                tree=jax.tree.map(np.asarray, params), tokens=tokens,
                labels=labels, hidden=np.asarray(h),
                logits=np.asarray(j_logits(params["embed"], cfg, h)),
                loss=float(loss), logits_p=np.asarray(logits_p),
                cache=cache)


@pytest.fixture(scope="module")
def port(ref):
    cfg = get_smoke(ARCH, **FLAGS)
    return dict(cfg=cfg, model=get_model(cfg, device="cpu"),
                params=params_from_numpy(cfg, ref["tree"], device="cpu"))


@pytest.fixture
def ssd_calls(monkeypatch):
    """Calls of the ``ssd_scan`` wrapper (on the CPU it runs its plain
    version and counts no launch, so the calls are what shows the path)."""
    calls = []
    ssd_pkg = importlib.import_module("repro_torch.kernels.ssd_scan")
    real = ssd_pkg.ssd_scan

    def spy(*args, **kwargs):
        calls.append(args[1].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(ssd_pkg, "ssd_scan", spy)
    return calls


def _batch(ref, n=None):
    n = n or ref["tokens"].shape[1]
    return {"tokens": torch.as_tensor(ref["tokens"][:, :n]),
            "labels": torch.as_tensor(ref["labels"][:, :n])}


def test_forward_matches_reference(ref, port, ssd_calls):
    h, aux = port["model"].forward(port["params"], _batch(ref))
    assert aux == {} and h.dtype == torch.float32
    _close(h, ref["hidden"])
    _close(logits_from_hidden(port["params"]["embed"], port["cfg"], h),
           ref["logits"])
    assert len(ssd_calls) == port["cfg"].n_layers


def test_loss_matches_reference(ref, port):
    loss, metrics = port["model"].loss_fn(port["params"], _batch(ref))
    assert metrics["xent"] is loss
    _close(loss.item(), ref["loss"])


def test_prefill_matches_reference_without_the_kernel(ref, port, ssd_calls):
    logits, cache = port["model"].prefill(port["params"], _batch(ref, S))
    assert ssd_calls == []          # prefill asks every layer for its state
    _close(logits, ref["logits_p"])
    assert set(cache) == {"conv", "ssm"}
    _close(cache["conv"], ref["cache"]["conv"])
    _close(cache["ssm"], ref["cache"]["ssm"])


@pytest.mark.parametrize("kv_variant", ["dynamic", "cnn"])
def test_decode_steps_match_reference(ref, port, kv_variant):
    """From the same prefill, each decode step's logits and the states it
    leaves agree with the reference's (the variant changes nothing here:
    the model has no KV cache)."""
    jcfg = ref["cfg"].with_(kv_variant=kv_variant)
    jmodel = j_get_model(jcfg)
    model = get_model(port["cfg"].with_(kv_variant=Variant(kv_variant)),
                      device="cpu")
    _, cache = model.prefill(port["params"], _batch(ref, S))
    cache = serve._grow_cache(model, cache, S + EXTRA + 1)
    jcache = j_serve._grow_cache(jmodel, ref["cache"], S + EXTRA + 1)
    decode = jax.jit(jmodel.decode_step)
    lengths = np.full((B,), S, np.int32)
    for t in range(EXTRA):
        tok = ref["tokens"][:, S + t:S + t + 1]
        jl, jcache = decode(ref["params"], jnp.asarray(tok), jcache,
                            jnp.asarray(lengths))
        logits, cache = model.decode_step(port["params"],
                                          torch.as_tensor(tok), cache,
                                          torch.as_tensor(lengths))
        _close(logits, jl)
        lengths = lengths + 1
    _close(cache["ssm"], jcache["ssm"])
    _close(cache["conv"], jcache["conv"])


def test_serve_session_tokens_equal_reference(ref):
    kw = dict(requests=4, batch=2, prompt_len=12, max_new=5, seed=0)
    want, jstats = j_serve.serve_session(ref["cfg"], **kw)
    cfg = get_smoke(ARCH, **FLAGS)
    got, stats = serve.serve_session(
        cfg, params=params_from_numpy(cfg, ref["tree"], device="cpu"),
        device="cpu", **kw)
    assert got.shape == (4, 6)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats["tokens"] == jstats["tokens"]
    assert stats["decode_steps"] == jstats["decode_steps"]


def test_init_cache_and_grow_cache_keep_the_states(port):
    model = port["model"]
    cache = model.init_cache(3, 99)
    cfg = port["cfg"]
    d_inner = cfg.ssm_expand * cfg.d_model
    assert cache["conv"].shape == (cfg.n_layers, 3, cfg.ssm_conv - 1,
                                   d_inner + 2 * cfg.ssm_state)
    assert cache["ssm"].shape == (cfg.n_layers, 3,
                                  d_inner // cfg.ssm_head_dim,
                                  cfg.ssm_state, cfg.ssm_head_dim)
    grown = serve._grow_cache(model, cache, 500)
    assert all(grown[k] is cache[k] for k in cache)   # no sequence axis
