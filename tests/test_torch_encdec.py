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


def test_bf16_encoder_promotes_f32_frames_as_the_reference():
    """bf16 seamless smoke fed ``TokenDataset``'s f32 frames: jnp
    promotion makes the reference's encoder states f32; the port's are
    f32 too and agree within rtol 1e-5, atol 1e-5 * max|ref| (a port
    that casts the frames to bf16 is 0.047 off at a max|ref| of 3.3).

    The decoder runs in bf16 in both, and its rounding differs between
    the two packages whatever the frames: on paths this repair leaves
    alone (``synth_train_batch``'s bf16 frames; the gemma3 and mamba2
    smokes in bf16) one train step's loss differs by 2.8e-5 to 8.7e-5
    relative and its grad norm (of bf16 gradients) by 2.8e-4 to 2.1e-3.
    So the loss and the xent are held to rtol 1e-4, the grad norm to
    5e-3, the lr exactly."""
    from repro.configs import TrainConfig as JTrainConfig
    from repro.data.tokens import TokenDataset as JTokenDataset
    from repro.train import steps as j_steps

    from repro_torch.configs import TrainConfig
    from repro_torch.data import TokenDataset
    from repro_torch.models import encdec
    from repro_torch.optim import adamw_init
    from repro_torch.train.steps import make_train_step

    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    train = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    cfg_j = j_get_smoke(ARCH, **bf16)
    model_j = j_get_model(cfg_j)
    state_j = j_steps.init_train_state(model_j, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, state_j["params"])
    batch_np = JTokenDataset(cfg_j, B, S, seed=0).batch_for_step(1)
    batch_j = jax.tree.map(jnp.asarray, batch_np)
    from repro.models import encdec as j_encdec
    enc_j = j_encdec.encode(state_j["params"], cfg_j, batch_j["enc_embeds"])
    loss_j, _ = model_j.loss_fn(state_j["params"], batch_j)
    _, metrics_j = jax.jit(j_steps.make_train_step(
        model_j, JTrainConfig(**train)))(state_j, batch_j)

    cfg = get_smoke(ARCH, **bf16)
    model = get_model(cfg, device="cpu")
    params = params_from_numpy(cfg, tree, device="cpu")
    batch_p = TokenDataset(cfg, B, S, seed=0).batch_for_step(1)
    for k in batch_np:
        assert np.array_equal(batch_p[k], batch_np[k]), k
    batch = {k: torch.from_numpy(v) for k, v in batch_p.items()}
    with torch.no_grad():
        enc = encdec.encode(params, cfg, batch["enc_embeds"])
        loss, _ = model.loss_fn(params, batch)
    assert enc_j.dtype == jnp.float32 and enc.dtype == torch.float32
    _close(enc.numpy(), np.asarray(enc_j))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4)
    _, metrics = make_train_step(model, TrainConfig(**train))(
        {"params": params, "opt": adamw_init(params)}, batch)
    assert set(metrics) == set(metrics_j)
    rtol = dict(loss=1e-4, xent=1e-4, grad_norm=5e-3, lr=0.0)
    for k in metrics_j:
        np.testing.assert_allclose(float(metrics[k]), float(metrics_j[k]),
                                   rtol=rtol[k], err_msg=k)
