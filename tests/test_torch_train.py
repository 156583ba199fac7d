"""The port's training pieces against the JAX reference: data, optimizer,
checkpoints, fault tolerance, the CLI and the kernels' refusal of grads.

``TokenDataset`` is compared bit for bit; the schedule, the clip and
AdamW (1 and 5 steps on a random tree with a layer-stacked (L, D) norm
leaf, which the reference decays because ``_decay_mask`` tests the stored
leaf's ndim, and a 1-D leaf, which it does not) within rtol 1e-6, atol
1e-6 * max|ref| (f32 elementwise math; the sums of the global norm run in
another order). A checkpoint written by either package restores in the
other, bf16 leaves included, bit for bit. The fault-tolerance units
mirror tests/test_checkpoint_ft.py on the port.
"""

import os
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import checkpoint as j_ckpt  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.data.tokens import TokenDataset as JTokenDataset  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.train import steps as j_steps  # noqa: E402

from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import _ALIASES as ARCH_IDS  # noqa: E402
from repro_torch.configs import TrainConfig, get_smoke  # noqa: E402
from repro_torch.data import TokenDataset  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.api import family_module  # noqa: E402
from repro_torch.optim import (adamw_init, adamw_update,  # noqa: E402
                               cosine_schedule, global_norm_clip)
from repro_torch.optim.adamw import _decay_mask  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    HangWatchdog, PreemptionHandler, TransientError, run_resilient)
from repro_torch.train.steps import init_train_state  # noqa: E402


def _close(out, ref, rtol=1e-6):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=rtol,
                               atol=rtol * np.abs(ref).max())


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_token_dataset_is_the_references(arch):
    """Every family (the VLM's embeds / embed_mask / (b, 3, s) positions
    and the audio enc_embeds included), several seeds and steps."""
    for seed, step, b, s in ((0, 0, 2, 16), (0, 7, 3, 33), (5, 123456, 1, 8)):
        got = TokenDataset(get_smoke(arch), b, s, seed=seed).batch_for_step(
            step)
        want = JTokenDataset(j_get_smoke(arch), b, s,
                             seed=seed).batch_for_step(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
    it = TokenDataset(get_smoke(arch), 2, 8, seed=1).iter_from(4)
    assert np.array_equal(next(it)["tokens"], next(JTokenDataset(
        j_get_smoke(arch), 2, 8, seed=1).iter_from(4))["tokens"])


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def test_cosine_schedule_is_the_references():
    """Step 0, mid-warm-up, the peak, mid-decay and past the end."""
    kw = dict(learning_rate=3e-4, warmup_steps=10, total_steps=110)
    lr, j_lr = cosine_schedule(TrainConfig(**kw)), j_adamw.cosine_schedule(
        JTrainConfig(**kw))
    for step in (0, 5, 10, 60, 200):
        got = lr(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        _close(got, j_lr(step))
        _close(lr(step), j_lr(step))
    assert float(lr(0)) == 0.0 and float(lr(200)) == 0.0
    _close(lr(10), 3e-4)


def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": (3 * rng.standard_normal((5, 7))).astype(np.float32),
            "nested": {"b": rng.standard_normal((11,)).astype(np.float32)}}


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_global_norm_clip_is_the_references(max_norm):
    g = _grad_tree(0)
    out, norm = global_norm_clip(tree.map_(torch.from_numpy, g), max_norm)
    j_out, j_norm = j_adamw.global_norm_clip(jax.tree.map(jnp.asarray, g),
                                             max_norm)
    _close(norm, j_norm)
    for path, leaf in tree.items(out):
        assert leaf.dtype == torch.float32
        _close(leaf, dict(tree.items(j_out))[path])
    if max_norm == 1.0:
        total = np.sqrt(sum(float((x.double() ** 2).sum())
                            for x in tree.leaves(out)))
        assert abs(total - 1.0) < 1e-5


def _param_tree(rng):
    """A matrix, a layer-stacked (L, D) norm scale and a 1-D bias."""
    return {"layers": {"ln": {"scale": (1.0 + 0.1 * rng.standard_normal(
        (3, 8))).astype(np.float32)},
        "w": rng.standard_normal((3, 8, 4)).astype(np.float32)},
        "bias": rng.standard_normal((6,)).astype(np.float32)}


@pytest.mark.parametrize("n_steps", [1, 5])
def test_adamw_update_is_the_references(n_steps):
    rng = np.random.default_rng(n_steps)
    init = _param_tree(rng)
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=8,
              weight_decay=0.5)
    params = tree.map_(lambda a: torch.from_numpy(a.copy()), init)
    state = adamw_init(params)
    j_params = jax.tree.map(jnp.asarray, init)
    j_state = j_adamw.adamw_init(j_params)
    for _ in range(n_steps):
        g = tree.map_(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), init)
        params, state, met = adamw_update(
            TrainConfig(**kw), params, tree.map_(torch.from_numpy, g), state)
        j_params, j_state, j_met = j_adamw.adamw_update(
            JTrainConfig(**kw), j_params, jax.tree.map(jnp.asarray, g),
            j_state)
        _close(met["lr"], j_met["lr"])
    assert int(state["step"]) == n_steps and state["step"].dtype == \
        torch.int32
    got = dict(tree.items({"p": params, "m": state["m"], "v": state["v"]}))
    want = dict(tree.items({"p": j_params, "m": j_state["m"],
                            "v": j_state["v"]}))
    for path in want:
        _close(got[path], want[path])
    # the stacked (L, D) norm scale is decayed and the 1-D bias is not
    assert _decay_mask(params["layers"]["ln"]["scale"])
    assert not _decay_mask(params["bias"])


def test_adamw_pieces_change_nothing(monkeypatch):
    """A leaf updated in pieces of whole rows (as the large ones are)
    ends bit-equal to the leaf updated whole, bf16 and f32 alike; the
    decay still follows the stored leaf's ndim."""
    from repro_torch.optim import adamw
    rng = np.random.default_rng(3)
    init = _param_tree(rng)
    grads = [tree.map_(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), init) for _ in range(3)]
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=8)
    for dtype in (torch.float32, torch.bfloat16):
        out = []
        for piece in (adamw._PIECE, 5):
            monkeypatch.setattr(adamw, "_PIECE", piece)
            params = tree.map_(lambda a: torch.from_numpy(a).to(dtype), init)
            state = adamw_init(params)
            for g in grads:
                params, state, _ = adamw_update(
                    tcfg, params, tree.map_(torch.from_numpy, g), state)
            out.append(dict(tree.items({"p": params, "o": state})))
        for k in out[0]:
            assert torch.equal(out[0][k], out[1][k]), (dtype, k)


def test_weight_decay_follows_the_stored_ndim():
    """Zero gradients: only the decay moves a leaf, and only a leaf of 2
    or more dims moves (the (L, D) norm stack does)."""
    init = _param_tree(np.random.default_rng(0))
    params = tree.map_(lambda a: torch.from_numpy(a.copy()), init)
    zeros = tree.map_(torch.zeros_like, params)
    tcfg = TrainConfig(learning_rate=0.1, warmup_steps=0, total_steps=10,
                       weight_decay=1.0)
    params, _, _ = adamw_update(tcfg, params, zeros, adamw_init(params))
    assert not np.array_equal(params["layers"]["ln"]["scale"].numpy(),
                              init["layers"]["ln"]["scale"])
    assert not np.array_equal(params["layers"]["w"].numpy(),
                              init["layers"]["w"])
    assert np.array_equal(params["bias"].numpy(), init["bias"])


# ---------------------------------------------------------------------------
# Checkpoints, both directions
# ---------------------------------------------------------------------------


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The port's bf16 train state of gemma3's smoke, saved, restores
    into the reference's template bit for bit, under the same keys."""
    cfg = get_smoke("gemma3-1b", param_dtype="bfloat16",
                    compute_dtype="bfloat16")
    state = init_train_state(get_model(cfg, device="cpu"), 0)
    path = ckpt.save(str(tmp_path), 3, state)
    assert path.endswith("step_00000003.npz")
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))

    j_model = j_get_model(j_get_smoke("gemma3-1b", param_dtype="bfloat16",
                                      compute_dtype="bfloat16"))
    template = jax.eval_shape(lambda k: j_steps.init_train_state(j_model, k),
                              jax.random.PRNGKey(0))
    assert j_ckpt.latest_step(str(tmp_path)) == 3
    back = j_ckpt.restore(str(tmp_path), 3, template)
    got = dict(tree.items(jax.tree.map(np.asarray, back)))
    want = dict(tree.items(state))
    assert sorted(got) == sorted(want)
    assert "params/layers/attn/wq" in got and "opt/step" in got
    for k, t in want.items():
        assert str(got[k].dtype) == str(t.dtype).replace("torch.", ""), k
        assert np.array_equal(got[k].astype(np.float32), t.float().numpy()), k


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """The reference's bf16 train state after one step, saved by it,
    restores into the port's template (on the meta device) bit for bit."""
    j_cfg = j_get_smoke("mamba2-130m", param_dtype="bfloat16",
                        compute_dtype="bfloat16")
    j_model = j_get_model(j_cfg)
    state = j_steps.init_train_state(j_model, jax.random.PRNGKey(1))
    batch = JTokenDataset(j_cfg, 2, 16).batch_for_step(1)
    state, _ = jax.jit(j_steps.make_train_step(j_model, JTrainConfig()))(
        state, jax.tree.map(jnp.asarray, batch))
    j_ckpt.save(str(tmp_path), 1, state)

    cfg = get_smoke("mamba2-130m", param_dtype="bfloat16",
                    compute_dtype="bfloat16")
    spec = family_module(cfg).init_params(cfg, None, torch.device("meta"))
    template = {"params": spec, "opt": adamw_init(spec)}
    assert ckpt.latest_step(str(tmp_path)) == 1
    back = ckpt.restore(str(tmp_path), 1, template, device="cpu")
    want = dict(tree.items(jax.tree.map(np.asarray, state)))
    got = dict(tree.items(back))
    assert sorted(got) == sorted(want)
    assert got["params/embed/embedding"].dtype == torch.bfloat16
    assert got["opt/step"].dtype == torch.int32 and int(got["opt/step"]) == 1
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape, k
        assert np.array_equal(t.float().numpy(),
                              want[k].astype(np.float32)), k


def test_roundtrip(tmp_path):
    tree_in = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
               "nested": {"b": torch.ones(4, dtype=torch.bfloat16)},
               "step": torch.tensor(7, dtype=torch.int32)}
    ckpt.save(str(tmp_path), 7, tree_in)
    assert ckpt.latest_step(str(tmp_path)) == 7
    template = tree.map_(lambda t: t.to("meta"), tree_in)
    back = ckpt.restore(str(tmp_path), 7, template, device="cpu")
    assert torch.equal(back["a"], tree_in["a"])
    assert back["nested"]["b"].dtype == torch.bfloat16
    assert back["step"].shape == () and int(back["step"]) == 7
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), 7, dict(template, a=torch.empty(
            3, 2, device="meta")), device="cpu")
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))


def test_async_checkpointer_snapshots_on_call(tmp_path):
    """The snapshot is taken on the call: an in-place update right after
    it does not reach the file."""
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    w = torch.ones(128, 128)
    saver.save(3, {"w": w})
    w.add_(1.0)
    saver.wait()
    assert ckpt.latest_step(str(tmp_path)) == 3
    back = ckpt.restore(str(tmp_path), 3, {"w": torch.empty(128, 128)})
    assert float(back["w"].max()) == 1.0


# ---------------------------------------------------------------------------
# Fault tolerance (tests/test_checkpoint_ft.py on the port)
# ---------------------------------------------------------------------------


def test_restart_bitwise_equals_uninterrupted(tmp_path):
    """Crash at step 7, restart from the step-5 checkpoint, finish at 10:
    the final loss equals a clean 10-step run's exactly."""
    cfg = get_smoke("mamba2-130m")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                       checkpoint_every=5, seed=42)
    clean = []
    train_loop(cfg, tcfg, batch=2, seq=32, steps=10, metrics_out=clean,
               log_every=100, device="cpu")
    ckpt_dir = str(tmp_path / "ckpt")
    attempts = {"n": 0}
    interrupted = []

    def attempt():
        attempts["n"] += 1
        fail = 7 if attempts["n"] == 1 else None
        train_loop(cfg, tcfg, batch=2, seq=32, steps=10, ckpt_dir=ckpt_dir,
                   fail_at_step=fail, metrics_out=interrupted,
                   log_every=100, device="cpu")

    assert run_resilient(attempt, max_restarts=2) == 1
    assert interrupted[-1]["loss"] == clean[-1]["loss"]


def test_preemption_checkpoints_and_exits(tmp_path):
    cfg = get_smoke("mamba2-130m")
    tcfg = TrainConfig(total_steps=100, checkpoint_every=1000, seed=1)
    with PreemptionHandler(signals=()) as pre:
        pre.trigger()   # simulate SIGTERM before the loop starts
        last = train_loop(cfg, tcfg, batch=2, seq=16, steps=100,
                          ckpt_dir=str(tmp_path), preemption=pre,
                          log_every=1000, device="cpu")
    assert last == 1   # exited at the first step boundary
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_hang_watchdog_fires():
    fired = threading.Event()
    wd = HangWatchdog(timeout_s=0.2, on_hang=fired.set, poll_s=0.05)
    wd.start()
    assert fired.wait(timeout=2.0)
    wd.stop()


def test_run_resilient_gives_up():
    def always_fail():
        raise TransientError("boom")
    with pytest.raises(TransientError):
        run_resilient(always_fail, max_restarts=2)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def test_train_cli_smoke_on_cpu(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", "mamba2-130m", "--smoke", "--device", "cpu",
        "--steps", "4", "--batch", "2", "--seq", "16", "--ckpt-every", "2",
        "--ckpt-dir", str(tmp_path)])
    train_cli.main()
    out = capsys.readouterr().out
    assert "step      4 loss=" in out
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_train_loop_needs_cuda_unless_cpu_requested(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("mamba2-130m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_loop(cfg, TrainConfig(), batch=1, seq=4, steps=1)
    monkeypatch.setattr("sys.argv", ["train", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main()


def test_train_loop_restores_the_deterministic_setting():
    before = torch.are_deterministic_algorithms_enabled()
    train_loop(get_smoke("mamba2-130m"), TrainConfig(), batch=1, seq=8,
               steps=1, log_every=100, device="cpu")
    assert torch.are_deterministic_algorithms_enabled() == before


# ---------------------------------------------------------------------------
# The kernels refuse a gradient (the reference has no backward for them)
# ---------------------------------------------------------------------------


def _kernel_inputs():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 16, 2, 16, generator=g) for _ in range(3))
    log_a = -torch.rand(1, 16, 2, generator=g)
    x = torch.randn(1, 16, 2, 8, generator=g)
    b, c = (torch.randn(1, 16, 4, generator=g) for _ in range(2))
    return (q, k, v), (log_a, x, b, c)


@pytest.mark.parametrize("kernel", ["flash_attention", "ssd_scan"])
def test_kernels_raise_under_grad_on_cpu(kernel):
    (q, k, v), (log_a, x, b, c) = _kernel_inputs()
    fn, args = ((lambda *a: flash_attention(*a, causal=True), [q, k, v])
                if kernel == "flash_attention" else (ssd_scan,
                                                     [log_a, x, b, c]))
    with torch.no_grad():
        fn(*args)
    fn(*args)                              # no input requires grad
    args[1].requires_grad_()
    with pytest.raises(ValueError, match="ROADMAP queue C"):
        fn(*args)
    with torch.no_grad():
        fn(*args)


def test_train_step_refuses_a_kernel_flag():
    """A train step with a kernel flag set raises (no silent zero grads):
    zamba2's smoke with the SSD flag reaches ``ssd_scan`` in every
    Mamba2 layer."""
    from repro_torch.train.steps import make_train_step
    cfg = get_smoke("zamba2-1.2b", use_ssd_kernel=True)
    model = get_model(cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             TokenDataset(cfg, 1, 16).batch_for_step(1).items()}
    step = make_train_step(model, TrainConfig())
    with pytest.raises(ValueError, match="no backward"):
        step(init_train_state(model, 0), batch)
    with torch.no_grad():
        model.loss_fn(model.init_params(0), batch)
