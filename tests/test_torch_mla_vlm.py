"""The transformer's MoE, MLA and VLM branches against the JAX reference.

The smoke configs of granite-moe-3b-a800m (MoE, V2 dispatch), deepseek-
v2-236b (MLA + MoE with a shared expert) and qwen2-vl-2b (M-RoPE, the
vision-embedding stub) in f32. Parameters are the reference's
``init_params(PRNGKey(0))``, carried over by ``params_from_numpy``;
tokens come from a numpy seed. Hidden states, the MoE losses, the loss,
the prefill logits and cache and every decode step (both KV-cache
variants) agree within rtol 1e-5, atol 1e-5 * max|ref|; the greedy
tokens of ``serve_session`` are equal. Both packages see the same
batches, so an MoE's capacity (which depends on the batch) drops the
same assignments in both. qwen2-vl is also run on its ``embeds`` /
``embed_mask`` / ``positions`` batch from ``synth_train_batch``.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.data.batches import synth_train_batch as j_batch  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import common as j_common  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models.common import logits_from_hidden as j_logits  # noqa: E402

from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.core.config import Variant  # noqa: E402
from repro_torch.data import synth_train_batch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, common  # noqa: E402
from repro_torch.models import get_model, params_from_numpy  # noqa: E402
from repro_torch.models.common import logits_from_hidden  # noqa: E402

ARCHS = ["granite-moe-3b-a800m", "deepseek-v2-236b", "qwen2-vl-2b"]
B, S, EXTRA = 2, 16, 4


def _close(out, ref, rtol=1e-5):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


def _tokens_batch(tokens, labels, n=None):
    n = n or tokens.shape[1]
    return {"tokens": tokens[:, :n], "labels": labels[:, :n]}


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """One architecture's reference outputs: forward and loss on S +
    EXTRA tokens, prefill on the first S."""
    arch = request.param
    cfg = j_get_smoke(arch)
    model = j_get_model(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens, labels = (rng.integers(0, cfg.vocab_size, (B, S + EXTRA)
                                   ).astype(np.int32) for _ in range(2))
    batch = {k: jnp.asarray(v)
             for k, v in _tokens_batch(tokens, labels).items()}
    h, aux = model.forward(params, batch)
    loss, metrics = model.loss_fn(params, batch)
    logits_p, cache = jax.jit(model.prefill)(
        params, {"tokens": batch["tokens"][:, :S]})
    port_cfg = get_smoke(arch)
    return dict(arch=arch, cfg=cfg, model=model, params=params,
                tokens=tokens, labels=labels, hidden=np.asarray(h),
                aux={k: float(v) for k, v in aux.items()},
                logits=np.asarray(j_logits(params["embed"], cfg, h)),
                loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                logits_p=np.asarray(logits_p), cache=cache,
                port_cfg=port_cfg,
                port=get_model(port_cfg, device="cpu"),
                port_params=params_from_numpy(
                    port_cfg, jax.tree.map(np.asarray, params),
                    device="cpu"))


def _port_batch(ref, n=None):
    return {k: torch.as_tensor(v) for k, v in
            _tokens_batch(ref["tokens"], ref["labels"], n).items()}


def test_smoke_configs_take_their_branches():
    granite, deepseek, qwen = (get_smoke(a) for a in ARCHS)
    assert granite.n_experts_eff == 48 > granite.n_experts
    assert deepseek.use_mla and deepseek.n_shared_experts == 1
    assert qwen.mrope_sections and qwen.frontend == "vision"
    assert get_config("deepseek-v2-236b").n_layers == 60


def test_forward_and_moe_losses_match_reference(ref):
    h, aux = ref["port"].forward(ref["port_params"], _port_batch(ref))
    assert h.dtype == torch.float32
    _close(h, ref["hidden"])
    _close(logits_from_hidden(ref["port_params"]["embed"], ref["port_cfg"],
                              h), ref["logits"])
    assert set(aux) == set(ref["aux"])
    for name, want in ref["aux"].items():
        if ref["port_cfg"].n_experts:
            assert want > 0
        np.testing.assert_allclose(aux[name].item(), want, rtol=1e-5)


def test_loss_matches_reference(ref):
    loss, metrics = ref["port"].loss_fn(ref["port_params"],
                                        _port_batch(ref))
    _close(loss.item(), ref["loss"])
    assert set(metrics) == set(ref["metrics"])
    for name, want in ref["metrics"].items():
        np.testing.assert_allclose(metrics[name].item(), want, rtol=1e-5)
    want = (metrics["xent"] + 0.01 * metrics["moe_lb_loss"]
            + metrics["moe_z_loss"])
    assert loss.item() == want.item()


def test_prefill_matches_reference(ref):
    logits, cache = ref["port"].prefill(ref["port_params"],
                                        _port_batch(ref, S))
    _close(logits, ref["logits_p"])
    assert set(cache) == set(ref["cache"])
    for name, want in ref["cache"].items():
        _close(cache[name], want)
    assert set(cache) == set(ref["port"].init_cache(B, S))
    for name, t in ref["port"].init_cache(B, S).items():
        assert t.shape == cache[name].shape and t.dtype == cache[name].dtype


@pytest.mark.parametrize("kv_variant", ["dynamic", "cnn"])
def test_decode_steps_match_reference(ref, kv_variant):
    """From the same prefill, each decode step's logits and the cache it
    leaves agree with the reference's; the step writes into the cache it
    was given (MLA: c_kv and the shared rope key)."""
    cfg = ref["port_cfg"].with_(kv_variant=Variant(kv_variant))
    jcfg = ref["cfg"].with_(kv_variant=kv_variant)
    jmodel, model = j_get_model(jcfg), get_model(cfg, device="cpu")
    params = ref["port_params"]
    _, cache = model.prefill(params, _port_batch(ref, S))
    total = S + EXTRA + 1
    cache = serve._grow_cache(model, cache, total)
    jcache = j_serve._grow_cache(jmodel, ref["cache"], total)
    decode = jax.jit(jmodel.decode_step)
    lengths = np.full((B,), S, np.int32)
    given = dict(cache)
    for t in range(EXTRA):
        tok = ref["tokens"][:, S + t:S + t + 1]
        jl, jcache = decode(ref["params"], jnp.asarray(tok), jcache,
                            jnp.asarray(lengths))
        logits, cache = model.decode_step(params, torch.as_tensor(tok),
                                          cache, torch.as_tensor(lengths))
        _close(logits, jl)
        lengths = lengths + 1
    assert all(cache[k] is given[k] for k in given)     # written in place
    for name in jcache:
        _close(cache[name], jcache[name])


def test_serve_session_tokens_equal_reference(ref):
    """The same slot batches in both packages (an MoE's drops depend on
    the batch); qwen2-vl's prompts carry their embeds and M-RoPE
    positions, and decode continues from the prompt length."""
    kw = dict(requests=4, batch=2, prompt_len=12, max_new=5, seed=0)
    want, jstats = j_serve.serve_session(ref["cfg"], **kw)
    cfg = ref["port_cfg"]
    got, stats = serve.serve_session(cfg, params=ref["port_params"],
                                     device="cpu", **kw)
    assert got.shape == (4, 6)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats["tokens"] == jstats["tokens"]


@pytest.mark.parametrize("seq", [16, 40])
def test_vlm_batch_is_the_reference_batch(seq):
    cfg, jcfg = get_smoke("qwen2-vl-2b"), j_get_smoke("qwen2-vl-2b")
    got = synth_train_batch(cfg, 3, seq, seed=5)
    want = j_batch(jcfg, 3, seq, seed=5)
    assert set(got) == set(want) == {"tokens", "labels", "embeds",
                                     "embed_mask", "positions"}
    for name, t in got.items():
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]))
    assert got["positions"].shape == (3, 3, seq)


def test_vlm_embeds_and_positions_match_reference():
    """qwen2-vl on a batch with image-patch embeddings (the first quarter)
    and (t, h, w) position triplets: forward, loss and prefill."""
    arch = "qwen2-vl-2b"
    jcfg = j_get_smoke(arch)
    jmodel = j_get_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = get_smoke(arch)
    model = get_model(cfg, device="cpu")
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu")
    jb = j_batch(jcfg, B, 24, seed=3)
    batch = synth_train_batch(cfg, B, 24, seed=3)
    assert (batch["positions"][:, 0, :6] == 0).all()      # t of patches
    jh, _ = jmodel.forward(jparams, jb)
    h, _ = model.forward(params, batch)
    _close(h, jh)
    tok_only, _ = model.forward(params, {"tokens": batch["tokens"]})
    assert not torch.allclose(tok_only, h)        # the stub is applied
    jloss, _ = jmodel.loss_fn(jparams, jb)
    loss, _ = model.loss_fn(params, batch)
    _close(loss.item(), float(jloss))
    jl, jcache = jax.jit(jmodel.prefill)(jparams, jb)
    logits, cache = model.prefill(params, batch)
    _close(logits, jl)
    _close(cache["k"], jcache["k"])


@pytest.mark.parametrize("sections,d", [((2, 3, 3), 16),
                                        ((16, 24, 24), 128)])
def test_mrope_matches_reference(sections, d):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 7, 3, d)).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 3, 7)).astype(np.int32)
    want = j_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                               sections)
    got = common.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 1e6,
                            sections)
    _close(got, want)
    # equal triplets are plain RoPE at that position
    same = np.repeat(pos[:, :1], 3, axis=1)
    _close(common.apply_rope(torch.as_tensor(x), torch.as_tensor(same), 1e6,
                             sections),
           common.apply_rope(torch.as_tensor(x),
                             torch.as_tensor(same[:, 0]), 1e6))


@pytest.mark.parametrize("variant", ["dynamic", "cnn"])
def test_mla_decode_per_layer_cache_matches_reference(variant):
    """`mla_decode` on one layer's cache (no layer index): the output and
    both cache leaves, at per-slot positions 3 and 9."""
    jcfg = j_get_smoke("deepseek-v2-236b").with_(kv_variant=variant)
    cfg = get_smoke("deepseek-v2-236b", kv_variant=Variant(variant))
    from repro.models.common import KeyGen
    jp = j_attn.mla_params(KeyGen(jax.random.PRNGKey(1)), jcfg, jnp.float32)
    p = {k: torch.as_tensor(np.array(v)) if not isinstance(v, dict)
         else {"scale": torch.as_tensor(np.array(v["scale"]))}
         for k, v in jp.items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.standard_normal((2, 12, cfg.kv_lora_rank)).astype(np.float32)
    rope = rng.standard_normal((2, 12, 1, cfg.qk_rope_head_dim)).astype(
        np.float32)
    lengths = np.asarray([3, 9], np.int32)
    jy, jc = j_attn.mla_decode(jp, jcfg, jnp.asarray(x),
                               {"c_kv": jnp.asarray(ckv),
                                "k_rope": jnp.asarray(rope)},
                               jnp.asarray(lengths))
    cache = {"c_kv": torch.as_tensor(ckv.copy()),
             "k_rope": torch.as_tensor(rope.copy())}
    y, c = attention.mla_decode(p, cfg, torch.as_tensor(x), cache,
                                torch.as_tensor(lengths))
    _close(y, jy)
    for name in ("c_kv", "k_rope"):
        _close(c[name], jc[name])
        assert (c[name] is cache[name]) == (variant == "dynamic")


def test_decode_positions_follow_mrope():
    lengths = torch.tensor([5, 7], dtype=torch.int32)
    pos = attention.decode_positions(get_smoke("qwen2-vl-2b"), lengths)
    assert pos.shape == (2, 3, 1) and (pos[:, :, 0].T == lengths).all()
    pos = attention.decode_positions(get_smoke("granite-moe-3b-a800m"),
                                     lengths)
    assert pos.shape == (2, 1)


def test_mla_cache_specs_name_the_sequence_axis():
    model = get_model(get_smoke("deepseek-v2-236b"), device="cpu")
    assert model.cache_specs(seq_sharded=True) == {
        "c_kv": (None, "batch", "seq", None),
        "k_rope": (None, "batch", "seq", None, None)}
    cache = serve._grow_cache(model, model.init_cache(2, 5), 9)
    assert cache["c_kv"].shape[2] == 9 == cache["k_rope"].shape[2]


def test_serve_cli_serves_the_new_archs_on_cpu(monkeypatch, capsys):
    for arch in ARCHS:
        monkeypatch.setattr("sys.argv", [
            "serve", "--arch", arch, "--smoke", "--device", "cpu",
            "--requests", "2", "--batch", "2", "--prompt-len", "8",
            "--max-new", "2"])
        serve.main()
        out = capsys.readouterr().out
        assert "served 2 requests on cpu: 6 tokens" in out, out
