"""seamless-m4t-large-v2 (`repro_torch.models.encdec`) against the JAX
reference.

The seamless smoke config in f32 with the flash flag on: the reference
runs its Pallas kernel in interpret mode in the decoder's causal
self-attention, the port (on the CPU) the plain version of its CUDA
kernel; the encoder (non-causal) and the cross-attention run chunked in
both. Parameters are the reference's ``init_params(PRNGKey(0))``,
carried over by ``params_from_numpy``; frame embeddings and tokens come
from ``synth_train_batch``'s numpy generator. Hidden states, the loss,
the prefill (encode, cross K/V, a BOS step) and every decode step (both
KV-cache variants) agree within rtol 1e-5, atol 1e-5 * max|ref|; the
greedy tokens of ``serve_session`` are equal.
"""

import importlib

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.data.batches import synth_train_batch as j_synth  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models.common import logits_from_hidden as j_logits  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.config import Variant  # noqa: E402
from repro_torch.data import synth_train_batch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_model, params_from_numpy  # noqa: E402
from repro_torch.models.common import logits_from_hidden  # noqa: E402

ARCH = "seamless-m4t-large-v2"
FLAGS = dict(use_flash_kernel=True)
B, S, EXTRA = 2, 24, 4


def _close(out, ref, rtol=1e-5):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module")
def ref():
    """The reference model, its parameters and its outputs on one batch
    of S frames and S tokens (forward with the kernel; prefill of the
    frames)."""
    cfg = j_get_smoke(ARCH, **FLAGS)
    model = j_get_model(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    batch = j_synth(cfg, B, S, seed=3)
    h, _ = model.forward(params, batch)
    loss, _ = model.loss_fn(params, batch)
    logits_p, cache = jax.jit(model.prefill)(
        params, {"enc_embeds": batch["enc_embeds"]})
    return dict(cfg=cfg, params=params, batch=batch,
                tree=jax.tree.map(np.asarray, params),
                hidden=np.asarray(h),
                logits=np.asarray(j_logits(params["embed"], cfg, h)),
                loss=float(loss), logits_p=np.asarray(logits_p),
                cache=cache)


@pytest.fixture(scope="module")
def port(ref):
    cfg = get_smoke(ARCH, **FLAGS)
    return dict(cfg=cfg, model=get_model(cfg, device="cpu"),
                params=params_from_numpy(cfg, ref["tree"], device="cpu"),
                batch=synth_train_batch(cfg, B, S, seed=3))


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


def test_audio_batch_is_the_references(ref, port):
    for key in ("tokens", "labels", "enc_embeds"):
        np.testing.assert_array_equal(port["batch"][key].numpy(),
                                      np.asarray(ref["batch"][key]))
    assert port["batch"]["enc_embeds"].dtype == torch.float32


def test_forward_matches_reference(ref, port, flash_calls):
    h, aux = port["model"].forward(port["params"], port["batch"])
    assert aux == {} and h.dtype == torch.float32
    _close(h, ref["hidden"])
    _close(logits_from_hidden(port["params"]["embed"], port["cfg"], h),
           ref["logits"])
    # the decoder's causal self-attention only: not the encoder, not the
    # cross-attention
    cfg = port["cfg"]
    assert flash_calls == [(B, S, cfg.n_heads, cfg.head_dim)] * cfg.n_layers


def test_loss_matches_reference(ref, port):
    loss, metrics = port["model"].loss_fn(port["params"], port["batch"])
    assert metrics["xent"] is loss
    _close(loss.item(), ref["loss"])


def test_prefill_matches_reference(ref, port, flash_calls):
    logits, cache = port["model"].prefill(
        port["params"], {"enc_embeds": port["batch"]["enc_embeds"]})
    assert flash_calls == []
    _close(logits, ref["logits_p"])
    cfg = port["cfg"]
    assert cache["k"].shape == (cfg.n_layers, B, 256, cfg.n_kv_heads,
                                cfg.head_dim)
    for key in ("k", "v", "xk", "xv"):
        _close(cache[key], ref["cache"][key])


@pytest.mark.parametrize("kv_variant", ["dynamic", "cnn"])
def test_decode_steps_match_reference(ref, port, kv_variant):
    """From the prefill's cache (BOS at position 0), each decode step's
    logits and the self-attention cache it leaves agree with the
    reference's."""
    jmodel = j_get_model(ref["cfg"].with_(kv_variant=kv_variant))
    model = get_model(port["cfg"].with_(kv_variant=Variant(kv_variant)),
                      device="cpu")
    _, cache = model.prefill(port["params"],
                             {"enc_embeds": port["batch"]["enc_embeds"]})
    jcache = ref["cache"]
    decode = jax.jit(jmodel.decode_step)
    tokens = np.array(ref["batch"]["tokens"])
    lengths = np.ones((B,), np.int32)
    for t in range(EXTRA):
        tok = tokens[:, t:t + 1]
        jl, jcache = decode(ref["params"], jnp.asarray(tok), jcache,
                            jnp.asarray(lengths))
        logits, cache = model.decode_step(port["params"],
                                          torch.as_tensor(tok), cache,
                                          torch.as_tensor(lengths))
        _close(logits, jl)
        lengths = lengths + 1
    for key in ("k", "v", "xk", "xv"):
        _close(cache[key], jcache[key])


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


def test_init_cache_takes_the_encoder_length(port):
    cfg = port["cfg"]
    cache = port["model"].init_cache(3, 40, 17)
    tail = (cfg.n_kv_heads, cfg.head_dim)
    assert cache["k"].shape == (cfg.n_layers, 3, 40) + tail
    assert cache["xv"].shape == (cfg.n_layers, 3, 17) + tail
