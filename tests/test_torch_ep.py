"""The port's experts over "model" (expert parallelism) over CPU ranks
(gloo).

On meshes (data 1, model 2), (data 2, model 2) and (data 1, model 4),
with remat on, from the reference's initial parameters (``PRNGKey(0)``,
each rank's pieces taken by ``params_from_numpy(..., shards=)``), on
TokenDataset batches, each rank holding the rows of its "data"
coordinate:

- granite-moe's smoke config without its dead experts
  (``n_experts_padded=0``: 8 experts, so at "model" 2 and 4 every rank
  holds live ones; with the smoke's padding to 48 all 8 would lie on
  rank 0), under V1, V2 and V3: 4 or 2 experts a rank;
- the padded smoke as it is, V2 at (1, 4), where ranks 1-3 hold only
  dead experts;
- the ffn-split fallback at (1, 4): 6 experts, which 4 does not divide,
  so every rank holds every expert on a quarter of its width;
- deepseek-v2's smoke: MLA on 4 heads (1 a rank at (1, 4)), its q_norm
  and kv_norm whole, 8 experts and one shared expert split column / row.

V2 dispatches in groups of up to 256 tokens, which may not straddle two
"data" ranks: its cases run at a global (4, 128) (512 tokens), V1 and V3
at (4, 16); the fallback at (4, 64), the shape of those tried ((4, 16),
(4, 128), (4, 64)) whose routing keeps the near-tie rule.

- Before comparing: the single-device routing of every step compared
  shows a gap above 1e-5 between the k-th and (k+1)-th probabilities
  (ROADMAP C's near-tie rule, tests/test_torch_train_models.py).
- Steps 1 and 2 held to the port's single-process step and to the
  reference's jitted single-device step, each taken from the state the
  step started from (step 2 from the mesh's own step-1 state, as in
  tests/test_torch_tp.py): metrics within rtol 1e-5, states within
  1e-5 off the sign-trap and knee entries.
- Every rank of "model" routed every token to the same experts (the
  tool's `routes_agree`: each MoE layer's idx gathered over "model").
- Faults the comparison must catch (one step of granite-moe V1 at
  (1, 4)): the experts' input without its backward "model" sum, and the
  combine weights without theirs (the router's gradient left partial);
  the unbroken step passes it.
- Checkpoints: a `train_loop` of granite-moe V1 (unpadded) at (1, 4)
  saves at step 2; restored at (2, 2) (split and gathered again) it is
  the saved state bit for bit, and the runs resumed from it at (2, 2)
  and at one process agree with the uncut run (1e-5 metrics, 1e-4
  state); the reference's ``checkpoint.restore`` reads that save.

World 2 and world 4 (both of its meshes) each run in one spawn of gloo
ranks (tests/torch_dist_ranks.py), the checkpoint loop in one more of
world 4; the reference's jitted steps are made once a config.
"""

import functools
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as j_checkpoint  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.data.tokens import TokenDataset as JTokenDataset  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.train import steps as j_steps  # noqa: E402

import torch  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.configs import TrainConfig, get_smoke  # noqa: E402
from repro_torch.data import TokenDataset  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.api import family_module  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402

from test_torch_dist_train import (  # noqa: E402
    _close_trees, _npz, _port_run, _ref_init)
from test_torch_train_models import (  # noqa: E402
    _assert_margins, _metrics_close, _record_router_inputs, _states_close)
from torch_dist_ranks import (  # noqa: E402
    EP_FAULTS, EP_LOOP, LOOP_SHAPE, TRAIN, ep_loop_rank, ep_rank,
    join_ranks, start_ranks)

STEPS = 2
MESHES = [(1, 2), (2, 2), (1, 4)]
UNPADDED = {"n_experts_padded": 0}
GRANITE = "granite-moe-3b-a800m"
# name: (arch, overrides, global batch, meshes)
CASES = {
    "granite-v1": (GRANITE, {**UNPADDED, "moe_variant": "dynamic"},
                   (4, 16), MESHES),
    "granite-v2": (GRANITE, UNPADDED, (4, 128), MESHES),
    "granite-v3": (GRANITE, {**UNPADDED, "moe_variant": "sparse"},
                   (4, 16), MESHES),
    "granite-padded": (GRANITE, {}, (4, 16), [(1, 4)]),
    "granite-fsplit": (GRANITE, {"n_experts": 6, "n_experts_padded": 0},
                       (4, 64), [(1, 4)]),
    "deepseek": ("deepseek-v2-236b", {}, (4, 128), MESHES),
}
PAIRS = [(c, m) for c in sorted(CASES) for m in CASES[c][3]]
IDS = [f"{c}-{m[0]}x{m[1]}" for c, m in PAIRS]
FAULTS = ((1, 4), "granite-v1")
LOOP = (GRANITE, {**UNPADDED, "moe_variant": "dynamic"})


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The spawns of worlds 2 and 4 and the checkpoint loop, started
    before the single-device runs so that all proceed together (the
    loop, which needs no reference parameters, before those are
    made)."""
    root = tmp_path_factory.mktemp("ep_loops")
    loop = start_ranks(ep_loop_rank, 4, root / "pg", root, *LOOP,
                       shape=(1, 4))
    cases = {name: dict(arch=arch, overrides=over, shape=shape,
                        steps=STEPS, meshes=meshes,
                        init=_ref_init(arch, over)[1])
             for name, (arch, over, shape, meshes) in CASES.items()}
    return dict(
        root=root, loop=loop,
        w2=start_ranks(ep_rank, 2, tmp_path_factory.mktemp("ep2"),
                       [(1, 2)], cases, shape=(1, 2)),
        w4=start_ranks(ep_rank, 4, tmp_path_factory.mktemp("ep4"),
                       [(2, 2), (1, 4)], cases, FAULTS, shape=(2, 2)))


@functools.lru_cache(maxsize=None)
def _ref_step_fn(arch, overrides):
    return jax.jit(j_steps.make_train_step(
        j_get_model(j_get_smoke(arch, **dict(overrides))),
        JTrainConfig(**TRAIN)))


def _ref_step(case, flat, step):
    """The reference's jitted step ``step`` on the global batch from the
    whole state ``flat`` ({path: numpy}): its metrics and state."""
    arch, over, shape, _ = CASES[case]
    template = _ref_init(arch, over)[0]
    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    state = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(flat["/".join(str(getattr(k, "key", k)) for k in path)],
                    dtype=leaf.dtype) for path, leaf in paths])
    data = JTokenDataset(j_get_smoke(arch, **over), *shape, seed=0)
    state, metrics = _ref_step_fn(arch, tuple(sorted(over.items())))(
        state, jax.tree.map(jnp.asarray, data.batch_for_step(step)))
    return dict(state=jax.tree.map(np.asarray, state),
                metrics={k: float(v) for k, v in metrics.items()})


def _port_step(case, flat, step):
    """The port's single-process step ``step`` on the global batch from
    the whole state ``flat``: its metrics, its state, the gradient at
    the parameters it started from (numpy trees), and the (router, x)
    pairs it routed (`_record_router_inputs`)."""
    arch, over, shape, _ = CASES[case]
    cfg = get_smoke(arch, **over)
    model = get_model(cfg, device="cpu")
    spec = family_module(cfg).init_params(cfg, None, torch.device("meta"))
    like = {"params": spec, "opt": {"m": spec, "v": spec, "step": None}}
    state = tree.unflatten(like, [torch.from_numpy(np.array(flat[k]))
                                  for k, _ in tree.items(like)])
    batch = {k: torch.from_numpy(v) for k, v in TokenDataset(
        cfg, *shape, seed=0).batch_for_step(step).items()}
    with pytest.MonkeyPatch.context() as mp:
        seen = _record_router_inputs(mp)
        live = tree.map_(lambda p: p.detach().requires_grad_(),
                         state["params"])
        grads = torch.autograd.grad(model.loss_fn(live, batch)[0],
                                    tree.leaves(live),
                                    materialize_grads=True)
    state, metrics = make_train_step(model, TrainConfig(**TRAIN))(state,
                                                                 batch)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                state=tree.map_(lambda t: t.numpy().copy(), state),
                grads=tree.unflatten(state["params"],
                                     [g.numpy() for g in grads]),
                seen=seen)


@pytest.fixture(scope="module")
def single(started):
    """Per case: the port's single-process step 1 on the global batch
    with the routes it took, and the reference's step 1."""
    out = {}
    for name, (arch, over, shape, _) in CASES.items():
        init = _ref_init(arch, over)[1]
        flat = {f"params/{k}": v for k, v in tree.items(init)}
        flat.update({f"opt/{m}/{k}": np.zeros_like(v)
                     for m in "mv" for k, v in tree.items(init)})
        flat["opt/step"] = np.zeros((), np.int32)
        with pytest.MonkeyPatch.context() as mp:
            seen = _record_router_inputs(mp)
            port = _port_run(arch, over, init, shape, 1)
        out[name] = dict(port=port, seen=seen, ref=_ref_step(name, flat, 1))
    return out


@pytest.fixture(scope="module")
def ep(started, single):
    """{mesh shape: rank 0's `ep_rank` results}."""
    out = {}
    for key in ("w2", "w4"):
        out.update(join_ranks(started[key])[0])
    return out


@pytest.fixture(scope="module")
def second(ep):
    """Per (case, mesh): the port's single-process step 2 and the
    reference's, each from the mesh's own step-1 state."""
    return {(case, mesh): (_port_step(case, ep[mesh][case][0][0][1], 2),
                           _ref_step(case, ep[mesh][case][0][0][1], 2))
            for case, mesh in PAIRS}


@pytest.mark.parametrize("case,mesh", PAIRS, ids=IDS)
def test_ep_step_matches_single_process(single, ep, second, case, mesh):
    first = single[case]["port"][0]
    _assert_margins(single[case]["seen"])
    got = ep[mesh][case][0]
    assert len(got) == STEPS
    _metrics_close(got[0][0], first["metrics"])
    _states_close(got[0][1], first["state"], [first], 1e-5)
    port = second[case, mesh][0]
    _assert_margins(port["seen"])
    _metrics_close(got[1][0], port["metrics"])
    _states_close(got[1][1], port["state"], [first, port], 1e-5)


@pytest.mark.parametrize("case,mesh", PAIRS, ids=IDS)
def test_ep_step_matches_reference(single, ep, second, case, mesh):
    first, ref = single[case]["port"][0], single[case]["ref"]
    _assert_margins(single[case]["seen"])
    got = ep[mesh][case][0]
    _metrics_close(got[0][0], ref["metrics"])
    _states_close(got[0][1], ref["state"], [first], 1e-5)
    port, ref = second[case, mesh]
    _assert_margins(port["seen"])
    _metrics_close(got[1][0], ref["metrics"])
    _states_close(got[1][1], ref["state"], [first, port], 1e-5)
    assert int(got[-1][1]["opt/step"]) == STEPS


@pytest.mark.parametrize("case,mesh", PAIRS, ids=IDS)
def test_routes_equal_over_model(ep, case, mesh):
    """Every rank of "model" routed every token of both steps (each
    layer, forward and remat's recompute) to the same experts."""
    assert ep[mesh][case][1] is True


@pytest.mark.parametrize("fault", EP_FAULTS)
def test_ep_faults_fail_the_comparison(single, ep, fault):
    """The comparisons above catch an expert-parallel step with the
    experts' input or the combine weights entering without their
    backward "model" sum; the unbroken step at the same mesh passes
    them."""
    mesh, case = FAULTS
    port = single[case]["port"]
    (m_ok, s_ok) = ep[mesh][case][0][0]
    _metrics_close(m_ok, port[0]["metrics"])
    _states_close(s_ok, port[0]["state"], port[:1], 1e-5)
    (m_bad, s_bad), = ep[mesh][fault]
    with pytest.raises(AssertionError):
        _metrics_close(m_bad, port[0]["metrics"])
    with pytest.raises(AssertionError):
        _states_close(s_bad, port[0]["state"], port[:1], 1e-5)


# ---------------------------------------------------------------------------
# Checkpoints across meshes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def loop(started):
    return dict(root=started["root"], **join_ranks(started["loop"])[0])


def test_ep_save_restores_at_2x2_and_continues(loop):
    root = loop["root"]
    saved = _npz(root / EP_LOOP / "step_00000002.npz")
    restored, n_split = loop["restored"]
    assert n_split > 0                     # ZeRO-1 moments split 2 ways
    assert set(restored) == set(saved)
    for k in saved:
        assert np.array_equal(restored[k], saved[k]), k
    uncut = loop["uncut"]["metrics"]
    resumed = loop["resumed"]["metrics"]
    assert len(resumed) == 2
    for got, want in zip(resumed, uncut[2:]):
        _metrics_close(got, want)
    _close_trees(_npz(root / "ep_resumed22" / "step_00000004.npz"),
                 _npz(root / EP_LOOP / "step_00000004.npz"), 1e-4)


def test_ep_save_restores_at_one_process_and_continues(loop, tmp_path):
    root = loop["root"]
    arch, over = LOOP
    cfg = get_smoke(arch, remat=True, **over)
    ckpt = tmp_path / "one"
    ckpt.mkdir()
    shutil.copy(root / EP_LOOP / "step_00000002.npz", ckpt)
    (ckpt / "MANIFEST.json").write_text('{"latest_step": 2}')
    metrics = []
    train_loop(cfg, TrainConfig(checkpoint_every=2, seed=3, **TRAIN),
               batch=LOOP_SHAPE[0], seq=LOOP_SHAPE[1], steps=4,
               log_every=100, ckpt_dir=str(ckpt), metrics_out=metrics,
               device="cpu")
    assert len(metrics) == 2
    for got, want in zip(metrics, loop["uncut"]["metrics"][2:]):
        _metrics_close(got, want)
    _close_trees(_npz(ckpt / "step_00000004.npz"),
                 _npz(root / EP_LOOP / "step_00000004.npz"), 1e-4)


def test_reference_restores_an_ep_save(loop):
    """The reference's ``checkpoint.restore`` reads the (1, 4) run's
    step-2 save into its own train state's structure: every leaf's
    shape and values."""
    arch, over = LOOP
    cfg = j_get_smoke(arch, **over)
    template = jax.eval_shape(
        lambda k: j_steps.init_train_state(j_get_model(cfg), k),
        jax.random.PRNGKey(0))
    got = j_checkpoint.restore(str(loop["root"] / EP_LOOP), 2, template)
    saved = _npz(loop["root"] / EP_LOOP / "step_00000002.npz")
    flat, _ = jax.tree_util.tree_flatten_with_path(got)
    keys = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in flat}
    assert set(keys) == set(saved)
    for k, v in saved.items():
        assert keys[k].shape == v.shape, k
        np.testing.assert_array_equal(keys[k].astype(v.dtype), v, err_msg=k)
