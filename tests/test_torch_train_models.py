"""The port's train step against the JAX reference's, one model per family.

Each family's smoke config in f32: the reference's ``init_train_state``
parameters (``PRNGKey(0)``) carried over by ``params_from_numpy``, the
batches of ``TokenDataset`` (bit-equal in both packages), then the
reference's jitted ``make_train_step`` and the port's for 3 steps. The
loss, the grad norm, the lr and the model's metrics (the MoE losses
included) agree within rtol 1e-5 at every step; the parameters and the
moments m and v after step 1 within rtol 1e-5, atol 1e-5 * max|ref|, and
after step 3 within 1e-4.

Adam's sign trap: step 1 moves every parameter by about lr times the
sign of its gradient, so an entry whose reference gradient is at rounding
level (|g_ref| < 1e-6 * max|g_ref| of its leaf, at any step so far) may
move either way. So may an entry at Adam's knee: where the update's
denominator sqrt(v_hat) (|clipped g| at step 1) lies within 10 eps of
zero (eps 1e-8) after any step so far, m_hat / (sqrt(v_hat) + eps) is
no longer about sign(m_hat), and a rounding-level error in g moves the
parameter by more than the tolerance. The smoke runs show where that
starts: every entry past 10 eps agrees within 1.2e-7, while single
entries at 2.2, 3.7 and 4.9 eps (mamba2, granite-moe, seamless) differ
by 5e-6 to 1e-5, their clipped gradients 4-6 % apart. Those entries are
left out of the parameter comparison, counted, and held under 1 % of
each leaf; an exact zero gradient (an unrouted expert, the row of a
token the batch lacks) is zero in both and stays in. The reference's
gradients come from ``jax.grad`` of its loss in the same jitted call as
its step; its v gives v_hat.

An MoE's routing is compared only where it is decided the same way:
every router input the port sees has its k-th and (k+1)-th probabilities
more than 1e-5 apart (as tests/test_torch_moe.py asserts).

Also: ``microbatches=2`` against the reference's; remat on (both
policies) equal to remat off, bit for bit; and a ``train_loop`` cut by a
failure and resumed from its checkpoint equal to the uncut run, bit for
bit.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.data.tokens import TokenDataset as JTokenDataset  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.train import steps as j_steps  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.configs import TrainConfig, get_smoke  # noqa: E402
from repro_torch.data import TokenDataset  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import get_model, moe, params_from_numpy  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.runtime.fault_tolerance import run_resilient  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402

# one architecture per family; deepseek-v2 adds MLA to the MoE family
ARCHS = ["mamba2-130m", "zamba2-1.2b", "gemma3-1b", "granite-moe-3b-a800m",
         "deepseek-v2-236b", "qwen2-vl-2b", "seamless-m4t-large-v2"]
TRAIN = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
B, S, STEPS = 2, 16, 3
MARGIN = 1e-5
SIGN_TRAP = 1e-6
KNEE = 10 * 1e-8          # 10 eps of TrainConfig


def _ref_run(arch, microbatches=1, steps=STEPS):
    """The reference's states after each step, with its metrics and its
    gradients at the parameters each step started from."""
    cfg = j_get_smoke(arch)
    model = j_get_model(cfg)
    state = j_steps.init_train_state(model, jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, state["params"])
    train_step = j_steps.make_train_step(
        model, JTrainConfig(microbatches=microbatches, **TRAIN))

    def grads_of(params, batch):
        return jax.grad(lambda p: model.loss_fn(p, batch)[0])(params)

    @jax.jit
    def step_and_grads(state, batch):
        # the gradient the step sees: with microbatches, the mean of the
        # microbatches' (an MoE's capacity depends on the batch)
        mbs = [jax.tree.map(lambda x: jnp.split(x, microbatches)[i], batch)
               for i in range(microbatches)]
        grads = jax.tree.map(lambda *g: sum(g) / microbatches,
                             *[grads_of(state["params"], mb) for mb in mbs])
        return train_step(state, batch), grads

    data = JTokenDataset(cfg, B, S, seed=0)
    out = []
    for i in range(1, steps + 1):
        batch = jax.tree.map(jnp.asarray, data.batch_for_step(i))
        (state, metrics), grads = step_and_grads(state, batch)
        out.append(dict(state=jax.tree.map(np.asarray, state),
                        metrics={k: float(v) for k, v in metrics.items()},
                        grads=jax.tree.map(np.asarray, grads)))
    return init, out


def _port_run(arch, init, microbatches=1, steps=STEPS, **overrides):
    """The port's state and metrics after each step, from the reference's
    initial parameters; each state a numpy copy (the step updates in
    place)."""
    cfg = get_smoke(arch, **overrides)
    model = get_model(cfg, device="cpu")
    params = params_from_numpy(cfg, init, device="cpu")
    state = {"params": params, "opt": adamw_init(params)}
    train_step = make_train_step(
        model, TrainConfig(microbatches=microbatches, **TRAIN))
    data = TokenDataset(cfg, B, S, seed=0)
    out = []
    for i in range(1, steps + 1):
        batch = {k: torch.from_numpy(v)
                 for k, v in data.batch_for_step(i).items()}
        state, metrics = train_step(state, batch)
        out.append(dict(state=tree.map_(lambda t: t.numpy().copy(), state),
                        metrics={k: float(v) for k, v in metrics.items()}))
    return out


def _record_router_inputs(monkeypatch):
    """Each (router, x) that the port's MoE routes, as float64 numpy."""
    seen = []
    apply = moe.moe_apply

    def recording(params, cfg, x):
        seen.append((cfg, params["router"].detach().double().numpy(),
                     x.detach().double().reshape(-1, cfg.d_model).numpy()))
        return apply(params, cfg, x)

    monkeypatch.setattr(moe, "moe_apply", recording)
    return seen


def _assert_margins(seen):
    for cfg, router, x in seen:
        logits = x @ router
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p = np.sort(p / p.sum(-1, keepdims=True), axis=-1)[:, ::-1]
        k = cfg.n_experts_per_tok
        gap = (p[:, k - 1] - p[:, k]).min()
        assert gap > MARGIN, f"a near tie at the k-th choice: gap {gap:.3e}"


@pytest.fixture(scope="module", params=ARCHS)
def runs(request):
    arch = request.param
    init, ref = _ref_run(arch)
    with pytest.MonkeyPatch.context() as mp:
        seen = _record_router_inputs(mp)
        port = _port_run(arch, init)
    return dict(arch=arch, init=init, ref=ref, port=port, seen=seen)


def _metrics_close(port, ref):
    assert set(port) == set(ref), (sorted(port), sorted(ref))
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def _states_close(port, ref, ref_steps, tol):
    """m and v within ``tol`` everywhere; parameters within ``tol`` off
    the sign-trap entries of ``ref_steps`` (module doc), which stay under
    1 % a leaf."""
    port = dict(tree.items(port))
    ref = dict(tree.items(ref))
    assert set(port) == set(ref)
    b2 = TrainConfig().b2
    trap = {}
    for t, r in enumerate(ref_steps, start=1):
        v = dict(tree.items(r["state"]["opt"]["v"]))
        for path, g in tree.items(r["grads"]):
            g = np.abs(np.asarray(g, np.float64))
            root = np.sqrt(np.asarray(v[path], np.float64)
                           / (1.0 - b2 ** t))          # sqrt(v_hat)
            # an exact 0 (an unrouted expert, an unseen token's row) is
            # 0 in both: compared, not counted
            small = (((g > 0) & (g < SIGN_TRAP * g.max()))
                     | ((root > 0) & (root < KNEE)))
            trap[path] = trap.get(path, False) | small
    for path, r in ref.items():
        r = np.asarray(r, np.float64)
        out = np.asarray(port[path], np.float64)
        assert out.shape == r.shape, path
        if path.startswith("params/"):
            skip = trap[path[len("params/"):]]
            assert skip.mean() < 0.01, (path, skip.mean())
            out, r = out[~skip], r[~skip]
        if r.size:
            np.testing.assert_allclose(out, r, rtol=tol,
                                       atol=tol * np.abs(r).max(),
                                       err_msg=path)


def test_one_step_matches_reference(runs):
    _assert_margins(runs["seen"])
    ref, port = runs["ref"][0], runs["port"][0]
    _metrics_close(port["metrics"], ref["metrics"])
    _states_close(port["state"], ref["state"], [ref], 1e-5)
    assert int(port["state"]["opt"]["step"]) == 1


def test_three_steps_match_reference(runs):
    _assert_margins(runs["seen"])
    for ref, port in zip(runs["ref"], runs["port"]):
        _metrics_close(port["metrics"], ref["metrics"])
    _states_close(runs["port"][-1]["state"], runs["ref"][-1]["state"],
                  runs["ref"], 1e-4)
    assert int(runs["port"][-1]["state"]["opt"]["step"]) == STEPS


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2-vl-2b"])
def test_microbatches_match_reference(arch, monkeypatch):
    """Two microbatches (f32 accumulation of g / 2, the loss / 2, the
    metrics averaged): the MoE's per-microbatch capacity and the VLM's
    (b, 3, s) positions split as the reference splits them."""
    init, ref = _ref_run(arch, microbatches=2, steps=1)
    seen = _record_router_inputs(monkeypatch)
    port = _port_run(arch, init, microbatches=2, steps=1)
    _assert_margins(seen)
    _metrics_close(port[0]["metrics"], ref[0]["metrics"])
    _states_close(port[0]["state"], ref[0]["state"], ref, 1e-5)


def _equal_trees(a, b):
    a, b = dict(tree.items(a)), dict(tree.items(b))
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat(arch):
    """Recomputing the layer bodies in the backward (both policies)
    changes no number: two steps bit-equal to the run without remat."""
    cfg = get_smoke(arch)
    init = tree.map_(lambda t: t.numpy(),
                     get_model(cfg, device="cpu").init_params(0))
    for leaf in tree.leaves(init):     # each run updates its own copy
        leaf.flags.writeable = False
    plain = _port_run(arch, init, steps=2)
    for policy in ("nothing", "dots"):
        remat = _port_run(arch, init, steps=2, remat=True,
                          remat_policy=policy)
        for a, b in zip(plain, remat):
            assert a["metrics"] == b["metrics"], policy
            _equal_trees(a["state"], b["state"])


def test_cut_and_resumed_run_equals_uncut(tmp_path):
    """A run that fails at step 3, restarts from its step-2 checkpoint and
    finishes at 4 ends bit-equal to a clean 4-step run: the metrics of
    every step and the final checkpoint."""
    cfg = get_smoke("gemma3-1b")
    tcfg = TrainConfig(checkpoint_every=2, seed=3, **TRAIN)
    clean = []
    train_loop(cfg, tcfg, batch=B, seq=S, steps=4, log_every=100,
               ckpt_dir=str(tmp_path / "clean"), metrics_out=clean,
               device="cpu")
    attempts, cut = [], []

    def attempt():
        attempts.append(1)
        train_loop(cfg, tcfg, batch=B, seq=S, steps=4, log_every=100,
                   ckpt_dir=str(tmp_path / "cut"), metrics_out=cut,
                   fail_at_step=3 if len(attempts) == 1 else None,
                   device="cpu")

    assert run_resilient(attempt, max_restarts=2) == 1
    assert latest_step(str(tmp_path / "cut")) == 4
    # steps 1, 2, then 3 (failed, not recorded), then 3 and 4 again
    assert cut == clean
    files = [np.load(tmp_path / d / "step_00000004.npz")
             for d in ("clean", "cut")]
    assert files[0].files == files[1].files
    for k in files[0].files:
        assert np.array_equal(files[0][k], files[1][k]), k
