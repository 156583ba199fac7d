"""The LM half of the PyTorch port (zamba2) against the JAX reference.

The zamba2 smoke config in f32 with both kernel flags on: the reference
runs its Pallas kernels in interpret mode, the port (on the CPU) the
plain versions of its CUDA kernels. Parameters are the reference's
``init_params(PRNGKey(0))``, carried over by ``params_from_numpy``;
tokens come from a numpy seed. Hidden states, logits, the prefill cache
and every decode step agree within rtol 1e-5, atol 1e-5 * max|ref| (the
SSD and attention sums run in another order); the greedy tokens of
``serve_session`` are equal.

The port's own prefill-then-decode is held to its forward as the
reference's tests/test_decode_consistency.py holds the reference (rtol =
atol = 2e-3), for both KV-cache variants.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.data.batches import synth_train_batch as j_synth  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models.common import logits_from_hidden as j_logits  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import _ALIASES as ARCH_IDS  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.core.config import Variant  # noqa: E402
from repro_torch.data import synth_train_batch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_model, params_from_numpy  # noqa: E402
from repro_torch.models.common import logits_from_hidden  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "zamba2-1.2b"
FLAGS = dict(use_flash_kernel=True, use_ssd_kernel=True)
B, S, EXTRA = 2, 32, 4


def _close(out, ref, rtol=1e-5):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module")
def ref():
    """The reference model, its parameters and its outputs on one token
    batch (forward with the kernels, prefill on the first S tokens)."""
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
    return dict(cfg=cfg, model=model, params=params,
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


def _batch(ref, n=None):
    n = n or ref["tokens"].shape[1]
    return {"tokens": torch.as_tensor(ref["tokens"][:, :n]),
            "labels": torch.as_tensor(ref["labels"][:, :n])}


def test_forward_matches_reference(ref, port):
    kernels.reset_launch_counts()
    h, aux = port["model"].forward(port["params"], _batch(ref))
    assert aux == {} and h.dtype == torch.float32
    _close(h, ref["hidden"])
    _close(logits_from_hidden(port["params"]["embed"], port["cfg"], h),
           ref["logits"])
    assert set(kernels.launch_counts().values()) == {0}   # CPU: plain


def test_loss_matches_reference(ref, port):
    loss, metrics = port["model"].loss_fn(port["params"], _batch(ref))
    assert metrics["xent"] is loss
    _close(loss.item(), ref["loss"])


def test_prefill_matches_reference(ref, port):
    logits, cache = port["model"].prefill(port["params"], _batch(ref, S))
    _close(logits, ref["logits_p"])
    jc = ref["cache"]
    _close(cache["attn_k"], jc["attn_k"])
    _close(cache["attn_v"], jc["attn_v"])
    _close(cache["mamba"]["conv"], jc["mamba"]["conv"])
    _close(cache["mamba"]["ssm"], jc["mamba"]["ssm"])


@pytest.mark.parametrize("kv_variant", ["dynamic", "cnn"])
def test_decode_steps_match_reference(ref, port, kv_variant):
    """From the same prefill, each decode step's logits and the cache it
    leaves agree with the reference's."""
    jcfg = ref["cfg"].with_(kv_variant=kv_variant)
    jmodel = j_get_model(jcfg)
    cfg = port["cfg"].with_(kv_variant=Variant(kv_variant))
    model = get_model(cfg, device="cpu")
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
    for key in ("attn_k", "attn_v"):
        _close(cache[key], jcache[key])
    _close(cache["mamba"]["ssm"], jcache["mamba"]["ssm"])
    _close(cache["mamba"]["conv"], jcache["mamba"]["conv"])


def test_serve_session_tokens_equal_reference(ref):
    kw = dict(requests=4, batch=2, prompt_len=12, max_new=5, seed=0)
    want, jstats = j_serve.serve_session(ref["cfg"], **kw)
    cfg = get_smoke(ARCH, **FLAGS)
    got, stats = serve.serve_session(
        cfg, params=params_from_numpy(cfg, ref["tree"], device="cpu"),
        device="cpu", **kw)
    assert got.dtype == np.int32 and got.shape == (4, 6)
    np.testing.assert_array_equal(got, np.asarray(want))
    for key in ("tokens", "decode_steps"):
        assert stats[key] == jstats[key]
    assert len(stats["prefill_s"]) == 2 and len(stats["decode_s"]) == 10
    assert stats["peak_memory_bytes"] is None       # not measured on CPU


@pytest.mark.parametrize("flags", [{}, FLAGS])
@pytest.mark.parametrize("kv_variant", ["dynamic", "cnn"])
def test_prefill_then_decode_matches_forward(kv_variant, flags):
    cfg = get_smoke(ARCH, kv_variant=Variant(kv_variant), **flags)
    model = get_model(cfg, device="cpu")
    params = model.init_params(0)
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (B, 16 + EXTRA)).astype(np.int32))
    h, _ = model.forward(params, {"tokens": tokens, "labels": tokens})
    full = logits_from_hidden(params["embed"], cfg, h)
    logits, cache = model.prefill(params, {"tokens": tokens[:, :16]})
    _close(logits[:, 0], full[:, 15], rtol=2e-3)
    cache = serve._grow_cache(model, cache, 16 + EXTRA + 1)
    lengths = torch.full((B,), 16, dtype=torch.int32)
    for t in range(EXTRA):
        logits, cache = model.decode_step(
            params, tokens[:, 16 + t:17 + t], cache, lengths)
        _close(logits[:, 0], full[:, 16 + t], rtol=2e-3)
        lengths = lengths + 1


@pytest.mark.parametrize("arch", [ARCH, "seamless-m4t-large-v2"])
def test_synth_train_batch_is_the_references(arch):
    """Tokens and labels, and the audio schema's frame embeddings (drawn
    after them, rounded to the compute dtype: bf16 in the full config)."""
    for get in (get_smoke, get_config):
        cfg = get(arch)
        got = synth_train_batch(cfg, 3, 17, seed=5)
        want = j_synth((j_get_smoke if get is get_smoke
                        else j_get_config)(arch), 3, 17, seed=5)
        assert set(got) == set(want)
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
        if "enc_embeds" in want:
            e = got["enc_embeds"]
            assert e.shape == (3, 17, cfg.d_model)
            assert str(e.dtype) == f"torch.{cfg.compute_dtype}"
            np.testing.assert_array_equal(
                e.float().numpy(), np.asarray(want["enc_embeds"], np.float32))


def test_params_from_numpy_checks_layout(ref):
    cfg = get_smoke(ARCH)
    tree = jax.tree.map(lambda a: a, ref["tree"])
    tree["shared_attn"] = dict(tree["shared_attn"])
    del tree["shared_attn"]["ln2"]
    with pytest.raises(ValueError, match="shared_attn"):
        params_from_numpy(cfg, tree, device="cpu")
    tree = dict(ref["tree"], final_norm={"scale": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="final_norm/scale"):
        params_from_numpy(cfg, tree, device="cpu")


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_full_config_is_the_references(arch):
    """Every field of the port's config equals the reference's, in the
    full config and the smoke; the kernels stay opt-in."""
    for get, j_get in ((get_config, j_get_config), (get_smoke, j_get_smoke)):
        got, want = get(arch), j_get(arch)
        for field in dataclasses.fields(got):
            value = getattr(got, field.name)
            if field.name == "kv_variant":
                assert value.value == want.kv_variant.value
            else:
                assert value == getattr(want, field.name), field.name
        if got.n_heads:                 # mamba2 has no attention heads
            assert got.head_dim == want.head_dim
        assert not got.use_flash_kernel and not got.use_ssd_kernel


def test_unported_families_raise_and_name_the_roadmap():
    """Every family of the reference is ported now (MoE and the VLM were
    the last, ROADMAP A.1): their configs, models and batches build, and
    only a family the reference does not have raises, naming the ported
    ones."""
    for arch in ("granite-moe-3b-a800m", "qwen2-vl-2b"):
        get_config(arch)
        cfg = get_smoke(arch)
        get_model(cfg, device="cpu")
        assert synth_train_batch(cfg, 1, 4)["tokens"].shape == (1, 4)
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("granite-moe-3b")
    with pytest.raises(NotImplementedError, match="ported: "):
        get_model(get_smoke(ARCH).with_(family="diffusion"), device="cpu")


def test_serve_session_needs_cuda_unless_cpu_requested(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke(ARCH, **FLAGS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve_session(cfg, requests=1, batch=1, prompt_len=4,
                            max_new=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(cfg)


def test_serve_cli_lm_smoke_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "serve", "--arch", ARCH, "--smoke", "--device", "cpu",
        "--requests", "2", "--batch", "2", "--prompt-len", "8",
        "--max-new", "3"])
    serve.main()
    out = capsys.readouterr().out
    assert "served 2 requests on cpu: 8 tokens" in out
    assert "peak_mem=not measured" in out


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 40
    # the training slices' modules are among them
    names = {str(f.relative_to(ROOT / "src")) for f in files}
    files += [ROOT / "chip_smoke.py", ROOT / "tools" / "dist_train_scaling.py"]
    assert {"repro_torch/data/tokens.py", "repro_torch/optim/adamw.py",
            "repro_torch/train/steps.py", "repro_torch/tree.py",
            "repro_torch/checkpoint/checkpoint.py",
            "repro_torch/runtime/fault_tolerance.py",
            "repro_torch/launch/train.py",
            "repro_torch/runtime/sharding.py",
            "repro_torch/runtime/param_sharding.py",
            "repro_torch/runtime/collectives.py",
            "repro_torch/optim/compress.py",
            "repro_torch/launch/mesh.py"} <= names
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
