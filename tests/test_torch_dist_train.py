"""The port's data-parallel train step over 2 and 4 CPU ranks (gloo).

For qwen3-8b's smoke config (the model of the reference's
tests/test_sharding_spmd.py) and one smoke config per family (mamba2,
zamba2, gemma3, granite-moe with V2 dispatch, and with V1 and V3 at one
step, deepseek-v2, qwen2-vl, seamless), in f32 with remat on: the
reference's initial parameters (``PRNGKey(0)``, carried over by
``params_from_numpy``), TokenDataset batches of a global (4, 16), each
rank holding its contiguous rows. The V2 models (granite-moe,
deepseek-v2) dispatch in groups of up to 256 tokens, which must not
straddle two ranks: 512 tokens at world 2, (4, 128), and 1,024 at world
4, (4, 256).

- The data-parallel step (ZeRO-1 on) against the port's single-process
  step on the global batch and against the reference's jitted
  single-device step: the metrics at every step within rtol 1e-5; the
  parameters and moments after step 1 within rtol 1e-5, atol 1e-5 *
  max|ref|, and after step 3 within 1e-4, leaving out the sign-trap and
  knee entries of tests/test_torch_train_models.py (under 1 % a leaf),
  found from the single-process step's gradients and moments.
  Unlike there, router near ties are not ruled out first: at 512 tokens
  a gap of 4.8e-6 between the k-th and (k+1)-th probabilities occurs. A
  token routed otherwise in one package moves its embedding row, its
  experts' weights and the loss by far more than these tolerances, so
  the comparisons passing shows the routes agreed.
  Not against the reference: the V2 models at world 4. At 1,024 tokens
  the port's single-process step itself leaves that rule (deepseek-v2:
  an embedding entry whose gradient is 7e-6 of its leaf's largest, 4 %
  off after step 1; granite-moe: router near ties of 6.8e-6 and
  1.5e-5), so there the data-parallel step is held to the
  single-process step, and to the reference at world 2.
- ZeRO-1 on against off: every step's metrics and whole state bit for
  bit.
- qwen3-8b with 2 microbatches at world 2 against the single-process
  step on the batch whose microbatch i is each rank's i-th half.
- granite-moe V1 and V2 at world 2: the loss's gradients with the
  backward on another thread, where remat recomputes each layer, bit
  for bit with the backward on the forward's thread.
- ``train_loop`` at world 2 cut by a failure at step 3 and resumed from
  its step-2 checkpoint: bit for bit with the uncut run. That step-2
  checkpoint restored at world 4 (split, gathered again) and at world 1
  is bit for bit the saved state; the runs resumed from it to step 4
  agree with the uncut run within rtol 1e-5 (metrics) and 1e-4 (state).
- `make_mesh` refuses an axis that no rule binds wider than 1, builds
  a "pod" of 2 (a pipeline "pod" too, bound as data), and builds a
  "model" axis of 2 (tests/test_torch_tp.py runs it) and a "data" axis
  of 2 under fsdp (tests/test_torch_fsdp.py runs it);
  `make_production_mesh` wants 256 ranks.

Each world size runs in one spawn of gloo ranks (tests/torch_dist_ranks.py).
"""

import functools

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
from repro_torch.configs import TrainConfig, get_smoke  # noqa: E402
from repro_torch.data import TokenDataset  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import get_model, params_from_numpy  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402

from test_torch_train_models import (  # noqa: E402
    _metrics_close, _states_close)
from torch_dist_ranks import (  # noqa: E402
    LOOP_ARCH, LOOP_SHAPE, TRAIN, dp_rank, join_ranks, loop_rank_2,
    loop_rank_resume, run_ranks, start_ranks)

STEPS = 3
SMALL = {2: (4, 16), 4: (4, 16)}
V2 = {2: (4, 128), 4: (4, 256)}
CASES = {
    "qwen3-8b": ("qwen3-8b", {}, SMALL, STEPS),
    "mamba2": ("mamba2-130m", {}, SMALL, STEPS),
    "zamba2": ("zamba2-1.2b", {}, SMALL, STEPS),
    "gemma3": ("gemma3-1b", {}, SMALL, STEPS),
    "granite-moe-v2": ("granite-moe-3b-a800m", {}, V2, STEPS),
    "granite-moe-v1": ("granite-moe-3b-a800m", {"moe_variant": "dynamic"},
                       SMALL, 1),
    "granite-moe-v3": ("granite-moe-3b-a800m", {"moe_variant": "sparse"},
                       SMALL, 1),
    "deepseek-v2": ("deepseek-v2-236b", {}, V2, STEPS),
    "qwen2-vl": ("qwen2-vl-2b", {}, SMALL, STEPS),
    "seamless": ("seamless-m4t-large-v2", {}, SMALL, STEPS),
}
MICRO = "qwen3-8b"
# MoE cases whose backward also runs on another thread (module doc)
THREAD = ("granite-moe-v1", "granite-moe-v2")
# (case, world) held to the reference (module doc)
REF_PAIRS = [(c, w) for c in sorted(CASES) for w in (2, 4)
             if not (CASES[c][2] is V2 and w == 4)]


@functools.lru_cache(maxsize=None)
def _ref_init_cached(arch, overrides):
    model = j_get_model(j_get_smoke(arch, **dict(overrides)))
    state = j_steps.init_train_state(model, jax.random.PRNGKey(0))
    return state, jax.tree.map(np.asarray, state["params"])


def _ref_init(arch, overrides):
    """The reference's initial train state and its parameters as numpy
    (made once a config)."""
    return _ref_init_cached(arch, tuple(sorted(overrides.items())))


def _ref_run(arch, overrides, shape, steps):
    """The reference's initial parameters, and its states and metrics
    after each step on the global batch (its jitted step)."""
    cfg = j_get_smoke(arch, **overrides)
    model = j_get_model(cfg)
    state, init = _ref_init(arch, overrides)
    train_step = jax.jit(j_steps.make_train_step(model,
                                                 JTrainConfig(**TRAIN)))
    data = JTokenDataset(cfg, *shape, seed=0)
    out = []
    for i in range(1, steps + 1):
        batch = jax.tree.map(jnp.asarray, data.batch_for_step(i))
        state, metrics = train_step(state, batch)
        out.append(dict(state=jax.tree.map(np.asarray, state),
                        metrics={k: float(v) for k, v in metrics.items()}))
    return init, out


def _port_run(arch, overrides, init, shape, steps, microbatches=1,
              rows=None):
    """The port's single-process step on the global batch (its rows in
    the order ``rows``): per step its metrics, its state and the
    gradient at the parameters the step started from (numpy trees; the
    gradients and moments give the sign-trap and knee entries)."""
    cfg = get_smoke(arch, **overrides)
    model = get_model(cfg, device="cpu")
    params = params_from_numpy(cfg, tree.map_(lambda a: a.copy(), init),
                               device="cpu")
    state = {"params": params, "opt": adamw_init(params)}
    train_step = make_train_step(
        model, TrainConfig(microbatches=microbatches, **TRAIN))
    data = TokenDataset(cfg, *shape, seed=0)
    out = []
    for i in range(1, steps + 1):
        batch = {k: torch.from_numpy(v[rows] if rows is not None else v)
                 for k, v in data.batch_for_step(i).items()}
        live = tree.map_(lambda p: p.detach().requires_grad_(),
                         state["params"])
        grads = torch.autograd.grad(model.loss_fn(live, batch)[0],
                                    tree.leaves(live),
                                    materialize_grads=True)
        state, metrics = train_step(state, batch)
        out.append(dict(
            metrics={k: float(v) for k, v in metrics.items()},
            state=tree.map_(lambda t: t.numpy().copy(), state),
            grads=tree.unflatten(state["params"],
                                 [g.numpy() for g in grads])))
    return out


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The data-parallel runs of worlds 2 and 4 and the world-2 loops,
    started before the single-device runs so that all proceed
    together."""
    inits = {name: _ref_init(arch, over)[1]
             for name, (arch, over, _, _) in CASES.items()}
    cases = {n: {name: dict(arch=arch, overrides=over, shape=shapes[n],
                            steps=steps, init=inits[name], zero1_off=True,
                            microbatches=name == MICRO and n == 2,
                            remat_thread=name in THREAD and n == 2)
                 for name, (arch, over, shapes, steps) in CASES.items()}
             for n in (2, 4)}
    root = tmp_path_factory.mktemp("loops")
    out = {n: start_ranks(dp_rank, n, tmp_path_factory.mktemp(f"dp{n}"),
                          cases[n], n == 2) for n in (2, 4)}
    out["loops"] = (root, start_ranks(loop_rank_2, 2, root / "pg2", root))
    return out


@pytest.fixture(scope="module")
def single(started):
    """Per case and global shape: the reference's runs (where held to
    them) and the port's single-process runs."""
    out = {}
    for name, (arch, over, shapes, steps) in CASES.items():
        for shape in sorted(set(shapes.values())):
            held = any(c == name and shapes[w] == shape
                       for c, w in REF_PAIRS)
            init, ref = (_ref_run(arch, over, shape, steps) if held
                         else (_ref_init(arch, over)[1], None))
            port = _port_run(arch, over, init, shape, steps)
            out[name, shape] = dict(init=init, ref=ref, port=port)
    arch, over, shapes, _ = CASES[MICRO]
    # microbatch i of the data-parallel step: each rank's i-th half
    out["micro"] = _port_run(arch, over, out[MICRO, shapes[2]]["init"],
                             shapes[2], 1, microbatches=2,
                             rows=[0, 2, 1, 3])
    return out


@pytest.fixture(scope="module")
def dist(started, single):
    """{world: rank 0's `dp_rank` results} for worlds 2 and 4."""
    return {n: join_ranks(started[n])[0] for n in (2, 4)}


def _single(single, case, world):
    return single[case, CASES[case][2][world]]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dp_step_matches_single_process(single, dist, world, case):
    port = _single(single, case, world)["port"]
    dp = dist[world][case]["on"]
    assert len(dp) == len(port) == CASES[case][3]
    for (m_dp, _), p in zip(dp, port):
        _metrics_close(m_dp, p["metrics"])
    _states_close(dp[0][1], port[0]["state"], port[:1], 1e-5)
    _states_close(dp[-1][1], port[-1]["state"], port, 1e-4)


@pytest.mark.parametrize("case,world", REF_PAIRS)
def test_dp_step_matches_reference(single, dist, world, case):
    one = _single(single, case, world)
    ref, traps, dp = one["ref"], one["port"], dist[world][case]["on"]
    for (m_dp, _), r in zip(dp, ref):
        _metrics_close(m_dp, r["metrics"])
    _states_close(dp[0][1], ref[0]["state"], traps[:1], 1e-5)
    _states_close(dp[-1][1], ref[-1]["state"], traps, 1e-4)
    assert int(dp[-1][1]["opt/step"]) == len(ref)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_zero1_on_equals_off(dist, world, case):
    on, off = dist[world][case]["on"], dist[world][case]["off"]
    assert len(on) == len(off)
    for (m_on, s_on), (m_off, s_off) in zip(on, off):
        assert m_on == m_off
        assert set(s_on) == set(s_off)
        for k in s_on:
            assert np.array_equal(s_on[k], s_off[k]), k


@pytest.mark.parametrize("case", THREAD)
def test_moe_remat_recompute_on_another_thread(dist, case):
    """Under a binding of 2 ranks, MoE's layers recomputed by a backward
    on another thread (autograd's device thread on the card) give the
    gradients of a backward on the forward's thread, bit for bit: the
    recompute takes the capacity, ranks and group size over the global
    batch, as its forward did."""
    here, elsewhere = dist[2][case]["thread"]
    assert len(here) == len(elsewhere) > 10
    for a, b in zip(here, elsewhere):
        assert np.array_equal(a, b)


def test_dp_microbatches_split_each_ranks_rows(single, dist):
    (m_dp, s_dp), = dist[2][MICRO]["mb"]
    port, = single["micro"]
    _metrics_close(m_dp, port["metrics"])
    _states_close(s_dp, port["state"], single["micro"], 1e-5)


# ---------------------------------------------------------------------------
# The loop: cut and resumed, elastic restore
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def loops(started):
    root, handle = started["loops"]
    two = join_ranks(handle)[0]
    four = run_ranks(loop_rank_resume, 4, root / "pg4", root)[0]
    return dict(root=root, two=two, four=four)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_loop_cut_and_resumed_equals_uncut(loops):
    two, root = loops["two"], loops["root"]
    assert two["uncut"]["restarts"] == 0 and two["cut"]["restarts"] == 1
    assert two["cut"]["metrics"] == two["uncut"]["metrics"]
    assert len(two["uncut"]["metrics"]) == 4
    for step in (2, 4):
        a = _npz(root / "uncut" / f"step_{step:08d}.npz")
        b = _npz(root / "cut" / f"step_{step:08d}.npz")
        assert set(a) == set(b)
        for k in a:
            assert np.array_equal(a[k], b[k]), (step, k)


def _close_trees(got, want, tol):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k], np.float64)
        np.testing.assert_allclose(np.asarray(got[k], np.float64), w,
                                   rtol=tol, atol=tol * np.abs(w).max(),
                                   err_msg=k)


def test_restore_at_world_4_and_continue(loops):
    root, four = loops["root"], loops["four"]
    saved = _npz(root / "uncut" / "step_00000002.npz")
    restored, n_split = four["restored"]
    assert n_split > 0                       # ZeRO-1 moments split 4 ways
    assert set(restored) == set(saved)
    for k in saved:
        assert np.array_equal(restored[k], saved[k]), k
    uncut = loops["two"]["uncut"]["metrics"]
    resumed = four["resumed"]["metrics"]
    assert len(resumed) == 2
    for got, want in zip(resumed, uncut[2:]):
        _metrics_close(got, want)
    _close_trees(_npz(root / "resumed4" / "step_00000004.npz"),
                 _npz(root / "uncut" / "step_00000004.npz"), 1e-4)


def test_restore_at_world_1_and_continue(loops, tmp_path):
    import shutil

    from repro_torch import checkpoint
    from repro_torch.models.api import family_module

    root = loops["root"]
    cfg = get_smoke(LOOP_ARCH, remat=True)
    spec = family_module(cfg).init_params(cfg, None, torch.device("meta"))
    state = checkpoint.restore(str(root / "uncut"), 2,
                               {"params": spec, "opt": adamw_init(spec)},
                               device="cpu")
    saved = _npz(root / "uncut" / "step_00000002.npz")
    got = {k: v.numpy() for k, v in tree.items(state)}
    assert set(got) == set(saved)
    for k in saved:
        assert np.array_equal(got[k], saved[k]), k
    ckpt = tmp_path / "one"
    ckpt.mkdir()
    shutil.copy(root / "uncut" / "step_00000002.npz", ckpt)
    (ckpt / "MANIFEST.json").write_text('{"latest_step": 2}')
    metrics = []
    train_loop(cfg, TrainConfig(checkpoint_every=2, seed=3, **TRAIN),
               batch=LOOP_SHAPE[0], seq=LOOP_SHAPE[1], steps=4,
               log_every=100, ckpt_dir=str(ckpt), metrics_out=metrics,
               device="cpu")
    for got_m, want in zip(metrics, loops["two"]["uncut"]["metrics"][2:]):
        _metrics_close(got_m, want)
    _close_trees(_npz(ckpt / "step_00000004.npz"),
                 _npz(root / "uncut" / "step_00000004.npz"), 1e-4)


# ---------------------------------------------------------------------------
# Layouts this slice does not run
# ---------------------------------------------------------------------------


def test_make_mesh_refuses_what_it_does_not_run(dist):
    """An axis that no rule binds wider than 1 raises, and so does the
    production mesh on two ranks; a "pod" of 2 is built with the
    reference's multi-pod rules (the batch and FSDP's blocks over
    ("pod", "data")), a pipeline "pod" too, bound as data as the
    reference binds it; a "model" axis of 2 is built, and so is a
    "data" axis of 2 (tests/test_torch_fsdp.py runs FSDP on it)."""
    got = dist[2]["refusals"]
    assert "no sharding rule" in got[0], got
    pod = ((("pod", 2), ("data", 1), ("model", 1)), ("pod", "data"),
           ("pod", "data"))
    assert got[1] == pod, got
    assert got[2] == pod, got
    assert "256 ranks" in got[3]
    assert got[4] == (("data", 1), ("model", 2))
    assert got[5] == (("data", 2), ("model", 1))


def test_cli_data_parallel_needs_its_ranks(monkeypatch):
    """``--data 2`` outside a world of 2 ranks (no torchrun) raises
    before any group starts."""
    from repro_torch.launch import train as train_cli
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr("sys.argv", ["train", "--arch", "gemma3-1b",
                                     "--smoke", "--device", "cpu",
                                     "--data", "2"])
    with pytest.raises(ValueError, match="torchrun"):
        train_cli.main()


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "seamless-m4t-large-v2"])
def test_rows_for_step_split_the_global_batch(arch):
    """Each rank's contiguous rows, concatenated in rank order, are the
    global batch (VLM positions and audio frames included); a batch the
    ranks do not divide raises."""
    data = TokenDataset(get_smoke(arch), 4, 16, seed=1)
    whole = data.batch_for_step(7)
    for n in (1, 2, 4):
        parts = [data.rows_for_step(7, r, n) for r in range(n)]
        for k, v in whole.items():
            assert np.array_equal(np.concatenate([p[k] for p in parts]), v)
    with pytest.raises(ValueError, match="does not split"):
        data.rows_for_step(7, 0, 3)
