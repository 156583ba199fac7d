"""The port's tensor-parallel train step over CPU ranks (gloo).

On meshes (data 1, model 2), (data 2, model 2) and (data 1, model 4),
for the f32 smoke config of every non-MoE family (gemma3: 4 heads and
one KV head, shared by every rank, q/k norms, tied embeddings; qwen2-vl
with M-RoPE; llama3: 8 heads, 2 KV, each shared by two ranks at model
4, an untied lm_head; mamba2: 8 SSM heads; zamba2; seamless with a
vocabulary of 258, which "model" splits at 2 and leaves whole on every
rank at 4, as seamless's 256,206), with remat on: the reference's initial
parameters (``PRNGKey(0)``), each rank's pieces taken by
``params_from_numpy(..., shards=)``, TokenDataset batches of a global
(4, 16), each rank holding the rows of its "data" coordinate.

- The step (ZeRO-1 on) for 2 steps, held to the port's single-process
  step on the global batch and to the reference's jitted single-device
  step, by the helpers of tests/test_torch_dist_train.py: the metrics
  at every step within rtol 1e-5; the gathered parameters and moments
  after each step within 1e-5, leaving out the sign-trap and knee
  entries (under 1 % a leaf). Each step is one step, held to the
  single-device steps taken from the state it started from: step 1
  from the common initial state, step 2 from the tensor-parallel run's
  own step-1 state (gathered whole). A 2-step comparison from the
  common start alone cannot tell a fault from a step-1 sign-trap entry
  that moved the other way: such a parameter (left out of the step-1
  comparison) changes the step-2 gradients of the leaves it meets by
  more than 1e-4 (llama3: a wo entry at 6e-7 of its leaf's largest
  gradient, then its row of wi_up, whose moment m went 1.25e-4 of its
  leaf's largest from the reference's).
- zamba2 (`STEP2_TOL`, `APART`). Every row-parallel product is a sum
  of m partial products, so the forward rounds otherwise than one
  device's, and a gradient that cancels to 3e-4 of its leaf's largest
  carries a relative error of 1e-3 there. Its step 2 is held within
  1e-4: a conv_b entry reads 3.82e-5 from the single-process step and
  3.02e-5 from the reference, and the two single-device steps, from the
  same step-1 state, read 1.44e-5 apart themselves (at (1, 4)). One
  a_log entry, 1.55e-5 after step 1, is held apart at its own limit.
- At (1, 1) the step is the step without a mesh, bit for bit.
- Forward only, on the rank's pieces against one device: the column /
  row-parallel MLP, the vocab-parallel embedding and loss (with and
  without a mask), gemma3's attention on local heads with one KV head
  for all, and mamba2's SSM block with its gated norm over the whole
  width; within rtol 1e-5.
- Faults the comparison must catch (one step at (1, 4)): gemma3 with
  the "model" sum of its shared wk / wv gradients left out, and mamba2
  with its gated norm over the rank's width only.
- Checkpoints: a `train_loop` at (1, 2) cut at step 3 and resumed
  equals the uncut run bit for bit; its step-2 checkpoint restored at
  (2, 1), split and gathered again, is the saved state bit for bit, and
  the runs resumed from it at (2, 1) and at one process agree with the
  uncut run (1e-5 metrics, 1e-4 state); the reference's
  ``checkpoint.restore`` reads that save.
- Without ranks: the MoE configs accepted over "model" with their
  expert and MLA pieces (their steps across ranks are
  tests/test_torch_ep.py's); the configs with heads or widths "model"
  does not divide, once refused (A.4.6), experts' widths included,
  now accepted with those blocks' leaves whole (their steps across
  ranks are tests/test_torch_attn_fallback.py's); the pieces' layout
  (head-aligned, tiling every leaf); and the CLI's ``--model``.

The cases of each world size run in one spawn of gloo ranks
(tests/torch_dist_ranks.py), world 4 over both of its meshes; the
checkpoint runs in one more spawn of world 2.
"""

import functools
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import checkpoint as j_checkpoint  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.data.tokens import TokenDataset as JTokenDataset  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.train import steps as j_steps  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.configs import TrainConfig  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.data import TokenDataset  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.api import family_module  # noqa: E402
from repro_torch.runtime import param_sharding as psh  # noqa: E402
from repro_torch.runtime import sharding as shlib  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402

from test_torch_dist_train import (  # noqa: E402
    _close_trees, _npz, _port_run, _ref_init)
from test_torch_train_models import (  # noqa: E402
    _metrics_close, _states_close)
from torch_dist_ranks import (  # noqa: E402
    LOOP_ARCH, LOOP_SHAPE, TP_LOOP, TRAIN, join_ranks, start_ranks,
    tp_forward, tp_loop_rank, tp_rank)

STEPS = 2
SHAPE = (4, 16)
CASES = {
    "gemma3": ("gemma3-1b", {}),
    "qwen2-vl": ("qwen2-vl-2b", {}),
    "llama3": ("llama3-405b", {}),
    "mamba2": ("mamba2-130m", {}),
    "zamba2": ("zamba2-1.2b", {}),
    # a vocabulary 2 divides and 4 does not, as seamless's 256,206:
    # split at (1, 2) and (2, 2), whole on every rank at (1, 4)
    "seamless-v258": ("seamless-m4t-large-v2", {"vocab_size": 258}),
}
MESHES = [(1, 2), (2, 2), (1, 4)]
FORWARD = ("mlp", "embed", "xent", "xent_masked", "attn", "ssm")
# every (case, mesh), held to both single-device steps
PAIRS = [(c, m) for c in sorted(CASES) for m in MESHES]
# the tolerance after step 2, where not 1e-5: the first of 2e-5, 5e-5,
# 1e-4 at least twice the largest reading (zamba2: conv_b[302], 3.82e-5
# from the single-process step at (2, 2), 3.70e-5 at (1, 2); the two
# single-device steps from the same state read 1.44e-5 apart)
STEP2_TOL = {"zamba2": 1e-4}
# entries checked at their own limit and then left out of a case's
# comparisons ({(case, path, flat index): limit}). zamba2's a_log[29]:
# zero at the start, its step-1 gradient 3.1e-4 of its leaf's largest,
# sqrt(v_hat) 36 eps (above the 10-eps knee), so its update carries the
# gradient's relative error / 37; after step 1 it reads 1.55e-5 from the
# single-process step at (1, 2) and 1.53e-5 at (2, 2), 0.63e-5 from the
# reference, and the single-process step reads 0.92e-5 from the
# reference there
APART = {("zamba2", "params/layers/ssm/a_log", 29): 2e-5}


def _cases():
    return {name: dict(arch=arch, overrides=over,
                       init=_ref_init(arch, over)[1], shape=SHAPE,
                       steps=STEPS)
            for name, (arch, over) in CASES.items()}


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The spawns of worlds 1, 2 and 4, started before the single-device
    runs so that all proceed together (the checkpoint loops, which need
    no reference parameters, before those are made)."""
    root = tmp_path_factory.mktemp("tp_loops")
    loop = start_ranks(tp_loop_rank, 2, root / "pg", root, shape=(1, 2))
    cases = _cases()
    return dict(
        root=root, loop=loop,
        w1=start_ranks(tp_rank, 1, tmp_path_factory.mktemp("tp1"),
                       [(1, 1)], cases, shape=(1, 1)),
        w2=start_ranks(tp_rank, 2, tmp_path_factory.mktemp("tp2"),
                       [(1, 2)], cases, ("forward",), shape=(1, 2)),
        w4=start_ranks(tp_rank, 4, tmp_path_factory.mktemp("tp4"),
                       [(2, 2), (1, 4)], cases, ("forward", "faults"),
                       shape=(2, 2)))


@functools.lru_cache(maxsize=None)
def _ref_step_fn(arch, overrides):
    return jax.jit(j_steps.make_train_step(
        j_get_model(j_get_smoke(arch, **dict(overrides))),
        JTrainConfig(**TRAIN)))


def _ref_step(case, flat, step):
    """The reference's jitted step ``step`` on the global batch from the
    whole state ``flat`` ({path: numpy}, the reference's key paths): its
    metrics and state."""
    arch, over = CASES[case]
    template = _ref_init(arch, over)[0]
    paths, treedef = jax.tree_util.tree_flatten_with_path(template)
    state = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(flat["/".join(str(getattr(k, "key", k)) for k in path)],
                    dtype=leaf.dtype) for path, leaf in paths])
    data = JTokenDataset(j_get_smoke(arch, **over), *SHAPE, seed=0)
    state, metrics = _ref_step_fn(arch, tuple(sorted(over.items())))(
        state, jax.tree.map(jnp.asarray, data.batch_for_step(step)))
    return dict(state=jax.tree.map(np.asarray, state),
                metrics={k: float(v) for k, v in metrics.items()})


def _port_step(case, flat, step):
    """The port's single-process step ``step`` on the global batch from
    the whole state ``flat``: its metrics, its state and the gradient at
    the parameters it started from (numpy trees)."""
    arch, over = CASES[case]
    cfg = get_smoke(arch, **over)
    model = get_model(cfg, device="cpu")
    spec = family_module(cfg).init_params(cfg, None, torch.device("meta"))
    like = {"params": spec, "opt": {"m": spec, "v": spec, "step": None}}
    state = tree.unflatten(like, [torch.from_numpy(np.array(flat[k]))
                                  for k, _ in tree.items(like)])
    batch = {k: torch.from_numpy(v) for k, v in TokenDataset(
        cfg, *SHAPE, seed=0).batch_for_step(step).items()}
    live = tree.map_(lambda p: p.detach().requires_grad_(), state["params"])
    grads = torch.autograd.grad(model.loss_fn(live, batch)[0],
                                tree.leaves(live), materialize_grads=True)
    state, metrics = make_train_step(model, TrainConfig(**TRAIN))(state,
                                                                 batch)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                state=tree.map_(lambda t: t.numpy().copy(), state),
                grads=tree.unflatten(state["params"],
                                     [g.numpy() for g in grads]))


@pytest.fixture(scope="module")
def single(started):
    """Per case: the port's single-process run of STEPS steps on the
    global batch (step 1 of which every mesh is held to, and the whole
    of which (1, 1) is) and the reference's step 1; and the forward
    cases on one device."""
    out = {}
    for name, (arch, over) in CASES.items():
        init = _ref_init(arch, over)[1]
        flat = {f"params/{k}": v for k, v in tree.items(init)}
        flat.update({f"opt/{m}/{k}": np.zeros_like(v)
                     for m in "mv" for k, v in tree.items(init)})
        flat["opt/step"] = np.zeros((), np.int32)
        out[name] = dict(port=_port_run(arch, over, init, SHAPE, STEPS),
                         ref=_ref_step(name, flat, 1))
    out["forward"] = tp_forward(None)
    return out


@pytest.fixture(scope="module")
def tp(started, single):
    """{mesh shape: rank 0's `tp_rank` results}."""
    out = {}
    for key in ("w1", "w2", "w4"):
        out.update(join_ranks(started[key])[0])
    return out


@pytest.fixture(scope="module")
def second(tp):
    """Per (case, mesh): the port's single-process step 2 and the
    reference's, each from the tensor-parallel run's own step-1 state."""
    return {(case, mesh): (_port_step(case, tp[mesh][case][0][1], 2),
                           _ref_step(case, tp[mesh][case][0][1], 2))
            for case in CASES for mesh in MESHES}


def _held(case, got, want, ref_steps, tol, apart=None):
    """`_states_close` of the flat state ``got`` against the state
    ``want``, with the entries of ``case`` in ``apart`` (default APART)
    each checked at its own limit (as `_states_close` checks an entry)
    and then left out."""
    got = dict(got)
    flat = dict(tree.items(want))
    for (c, path, i), limit in (APART if apart is None else apart).items():
        if c != case:
            continue
        w = np.asarray(flat[path], np.float64)
        g = np.asarray(got[path], np.float64).copy()
        gap = abs(g.flat[i] - w.flat[i])
        assert gap <= limit * (np.abs(w).max() + abs(w.flat[i])), (
            path, i, g.flat[i], w.flat[i])
        g.flat[i] = w.flat[i]
        got[path] = g
    _states_close(got, want, ref_steps, tol)


@pytest.mark.parametrize("case,mesh", PAIRS,
                         ids=[f"{c}-{m[0]}x{m[1]}" for c, m in PAIRS])
def test_tp_step_matches_single_process(single, tp, second, mesh, case):
    first = single[case]["port"][0]
    got = tp[mesh][case]
    assert len(got) == STEPS
    _metrics_close(got[0][0], first["metrics"])
    _held(case, got[0][1], first["state"], [first], 1e-5)
    port = second[case, mesh][0]
    _metrics_close(got[1][0], port["metrics"])
    _held(case, got[1][1], port["state"], [first, port],
          STEP2_TOL.get(case, 1e-5))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("case", sorted(CASES))
def test_tp_step_matches_reference(single, tp, second, mesh, case):
    first, got = single[case]["port"][0], tp[mesh][case]
    ref = single[case]["ref"]
    _metrics_close(got[0][0], ref["metrics"])
    _held(case, got[0][1], ref["state"], [first], 1e-5)
    port, ref = second[case, mesh]
    _metrics_close(got[1][0], ref["metrics"])
    _held(case, got[1][1], ref["state"], [first, port],
          STEP2_TOL.get(case, 1e-5))
    assert int(got[-1][1]["opt/step"]) == STEPS


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_1x1_is_the_step_without_a_mesh(single, tp, case):
    """At (1, 1) there is no "model" axis (`runtime.sharding.model_axis`
    is None at an extent of 1): every piece is the whole leaf, no
    collective over "model" runs, and the mesh's step gives the metrics
    and state of the step without a mesh, bit for bit."""
    port, got = single[case]["port"], tp[1, 1][case]
    for (m_tp, s_tp), p in zip(got, port):
        assert m_tp == p["metrics"]
        want = dict(tree.items(p["state"]))
        assert set(s_tp) == set(want)
        for k in want:
            assert np.array_equal(s_tp[k], want[k]), k


@pytest.mark.parametrize("mesh", [(1, 2), (1, 4)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("name", FORWARD)
def test_tp_forward_matches_one_device(single, tp, mesh, name):
    want = single["forward"][name]
    got = tp[mesh]["forward"][name]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("fault,case", [("kv_unsummed", "gemma3"),
                                        ("local_norm", "mamba2")])
def test_routing_faults_fail_the_comparison(single, tp, fault, case):
    """The comparisons above catch a tensor-parallel step with the
    "model" sum of a shared KV head's gradient left out, or with the
    gated norm taken over the rank's width only; the unbroken step at
    the same mesh passes them."""
    port = single[case]["port"]
    (m_ok, s_ok), = tp[1, 4][case][:1]
    _metrics_close(m_ok, port[0]["metrics"])
    _states_close(s_ok, port[0]["state"], port[:1], 1e-5)
    (m_bad, s_bad), = tp[1, 4][fault]
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


def test_tp_loop_cut_and_resumed_equals_uncut(loop):
    assert loop["uncut"]["restarts"] == 0 and loop["cut"]["restarts"] == 1
    assert loop["cut"]["metrics"] == loop["uncut"]["metrics"]
    for step in (2, 4):
        a = _npz(loop["root"] / TP_LOOP / f"step_{step:08d}.npz")
        b = _npz(loop["root"] / "tp_cut" / f"step_{step:08d}.npz")
        assert set(a) == set(b)
        for k in a:
            assert np.array_equal(a[k], b[k]), (step, k)


def test_tp_save_restores_at_2x1_and_continues(loop):
    root = loop["root"]
    saved = _npz(root / TP_LOOP / "step_00000002.npz")
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
    _close_trees(_npz(root / "tp_resumed21" / "step_00000004.npz"),
                 _npz(root / TP_LOOP / "step_00000004.npz"), 1e-4)


def test_tp_save_restores_at_one_process_and_continues(loop, tmp_path):
    root = loop["root"]
    cfg = get_smoke(LOOP_ARCH, remat=True)
    ckpt = tmp_path / "one"
    ckpt.mkdir()
    shutil.copy(root / TP_LOOP / "step_00000002.npz", ckpt)
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
                 _npz(root / TP_LOOP / "step_00000004.npz"), 1e-4)


def test_reference_restores_a_tp_save(loop):
    """The reference's ``checkpoint.restore`` reads the (1, 2) run's
    step-2 save into its own train state's structure: every leaf's
    shape and values."""
    cfg = j_get_smoke(LOOP_ARCH)
    template = jax.eval_shape(
        lambda k: j_steps.init_train_state(j_get_model(cfg), k),
        jax.random.PRNGKey(0))
    path = str(loop["root"] / TP_LOOP)
    got = j_checkpoint.restore(path, 2, template)
    saved = _npz(loop["root"] / TP_LOOP / "step_00000002.npz")
    flat, _ = jax.tree_util.tree_flatten_with_path(got)
    keys = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in flat}
    assert set(keys) == set(saved)
    for k, v in saved.items():
        assert keys[k].shape == v.shape, k
        np.testing.assert_array_equal(keys[k].astype(v.dtype), v, err_msg=k)


# ---------------------------------------------------------------------------
# Refusals and the pieces' layout (no ranks)
# ---------------------------------------------------------------------------


class _FakeMesh:
    """What `launch.mesh.binding_for` and `make_train_step`'s refusal
    read of a mesh, and a group per axis (None: no collective runs)."""

    def __init__(self, shape, index=0):
        self.mesh_dim_names = ("data", "model")
        self.mesh = torch.zeros(shape)
        self.index = index

    def get_group(self, name):
        return None

    def get_local_rank(self, name):
        return self.index if name == "model" else 0


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v2-236b"])
def test_experts_over_model_refused(arch):
    """Once refused (ROADMAP A.4.3), the experts now split over "model":
    `make_train_step` takes the MoE smoke configs at "model" 2 and 4, and
    each rank's pieces are E_eff / m experts (deepseek-v2: also its
    shared expert column / row, its MLA heads, the norms before the
    split whole). At "model" 8, which divides neither smoke's 4 heads
    (once refused, A.4.6), the step is built too and the attention's
    leaves are whole on every rank (granite-moe's under its
    ``attn_batch`` fallback: whole, their gradients partial where the
    rows split)."""
    from repro_torch.models import get_model
    cfg = get_smoke(arch)
    model = get_model(cfg, device="cpu")
    for m in (2, 4):
        make_train_step(model, TrainConfig(), _FakeMesh((1, m)))
        spec, pieces = _pieces(cfg, m, m - 1)
        got = {path: (None if p is None else p.shape(leaf.shape))
               for (path, leaf), p in zip(tree.items(spec),
                                          tree.leaves(pieces))}
        e = cfg.n_experts_eff
        assert got["layers/moe/wi_gate"] == (2, e // m, 64, 64)
        assert got["layers/moe/wo"] == (2, e // m, 64, 64)
        assert got["layers/moe/router"] is None
        if cfg.use_mla:
            assert got["layers/moe/shared/wi_gate"] == (2, 64, 64 // m)
            assert got["layers/moe/shared/wo"] == (2, 64 // m, 64)
            assert got["layers/attn/wq_b"] == (2, 32, 4 // m * 24)
            assert got["layers/attn/wk_b"] == (2, 16, 4 // m * 16)
            assert got["layers/attn/wo"] == (2, 4 // m * 16, 64)
            assert got["layers/attn/q_norm/scale"] is None
            assert got["layers/attn/kv_norm/scale"] is None
    make_train_step(model, TrainConfig(), _FakeMesh((1, 8)))
    spec, pieces = _pieces(cfg, 8, 7)
    _assert_whole(spec, pieces, ("layers/attn/",), rows=not cfg.use_mla)


# the seven configs once refused (A.4.6), each with the leaves of its
# block that "model" does not divide (path prefixes)
INDIVISIBLE = [
    ("qwen3-8b", {}, 8, ("layers/attn/",)),               # 4 heads
    # 6 heads over 3, their 2 KV heads whole on every rank
    ("qwen3-8b", dict(n_heads=6, n_kv_heads=2, d_head=16, d_ff=129), 3,
     ("layers/attn/wk", "layers/attn/wv")),
    ("mamba2-130m", {}, 16, ("layers/ssm/",)),            # 8 SSM heads
    ("gemma3-1b", dict(d_ff=130), 4, ("layers/mlp/",)),   # the MLP
    # granite-moe's 24 heads at full width (its attn_batch fallback)
    ("granite-moe-3b-a800m", dict(n_heads=24, n_kv_heads=8), 16,
     ("layers/attn/",)),
    # 6 experts, which 4 does not divide, on a width it does not either
    ("granite-moe-3b-a800m", dict(n_experts=6, n_experts_padded=0,
                                  moe_d_ff=66), 4,
     ("layers/moe/wi_", "layers/moe/wo")),
    ("deepseek-v2-236b", dict(moe_d_ff=66), 4,            # shared width
     ("layers/moe/shared/",)),
]


def _assert_whole(spec, pieces, prefixes, rows=False):
    """Every leaf under ``prefixes`` is whole on the rank: no piece, or
    (KV heads under split query heads, an ``attn_batch`` fallback
    block's leaves) a piece of the whole leaf, marked ``rows`` where
    ``rows``."""
    hit = 0
    for (path, leaf), piece in zip(tree.items(spec), tree.leaves(pieces)):
        if not path.startswith(prefixes):
            continue
        hit += 1
        if piece is not None:
            assert piece.shape(leaf.shape) == tuple(leaf.shape), path
            assert piece.rows == rows, path
    assert hit, prefixes


@pytest.mark.parametrize("arch,overrides,m,whole", INDIVISIBLE, ids=[
    f"{a}-overrides{i}-{m}" for i, (a, _, m, _) in enumerate(INDIVISIBLE)])
def test_heads_model_does_not_divide_refused(arch, overrides, m, whole):
    """Once refused (A.4.6): `make_train_step` takes each config at a
    "model" extent that does not divide one of its blocks, and the
    leaves of that block are whole on every rank."""
    from repro_torch.models import get_model
    cfg = get_smoke(arch, **overrides)
    model = get_model(cfg, device="cpu")
    make_train_step(model, TrainConfig(), _FakeMesh((1, m)))
    spec, pieces = _pieces(cfg, m, m - 1)
    rows = cfg.attn_batch_fallback and whole == ("layers/attn/",)
    _assert_whole(spec, pieces, whole, rows=rows)


def _pieces(cfg, m, index):
    spec = family_module(cfg).init_params(cfg, None, torch.device("meta"))
    binding = shlib.Binding(shlib.SINGLE_POD_RULES, {"data": 1, "model": m},
                            mesh=_FakeMesh((1, m), index))
    with shlib.use_binding(binding):
        return spec, psh.tp_pieces(spec, cfg)


@pytest.mark.parametrize("arch,leaf,want", [
    # [z | x | B | C | dt] of 4 ranks: 384 + 384 + 128 + 128 + 6
    ("mamba2-130m", "layers/ssm/in_proj", (24, 768, 1030)),
    ("zamba2-1.2b", "layers/ssm/in_proj", (38, 2048, 2192)),
    # [x | B | C]: 384 + 128 + 128
    ("mamba2-130m", "layers/ssm/conv_w", (24, 4, 640)),
    # gemma3's one KV head (256 columns), whole on every rank
    ("gemma3-1b", "layers/attn/wk", (26, 1152, 256)),
    ("gemma3-1b", "layers/attn/wq", (26, 1152, 256)),
    ("gemma3-1b", "embed/embedding", (65536, 1152)),
    # qwen2-vl: 12 heads, 2 KV at 4 ranks: each rank's KV head
    ("qwen2-vl-2b", "layers/attn/wk", (28, 1536, 128)),
    ("qwen3-8b", "layers/mlp/wo", (36, 3072, 4096)),
    # 256,206 does not split 4 ways: whole
    ("seamless-m4t-large-v2", "embed/embedding", (256206, 1024)),
    # 48 experts (8 of them dead) over 4 ranks
    ("granite-moe-3b-a800m", "layers/moe/wi_gate", (32, 12, 1536, 512)),
    ("granite-moe-3b-a800m", "layers/moe/wo", (32, 12, 512, 1536)),
    ("granite-moe-3b-a800m", "layers/moe/router", (32, 1536, 40)),
    ("deepseek-v2-236b", "layers/moe/wi_up", (60, 40, 5120, 1536)),
    ("deepseek-v2-236b", "layers/moe/wo", (60, 40, 1536, 5120)),
    # its two shared experts' SwiGLU (width 3072), column / row
    ("deepseek-v2-236b", "layers/moe/shared/wi_gate", (60, 5120, 768)),
    ("deepseek-v2-236b", "layers/moe/shared/wo", (60, 768, 5120)),
    # MLA: 32 of 128 heads, (128 + 64) query columns each
    ("deepseek-v2-236b", "layers/attn/wq_b", (60, 1536, 6144)),
    ("deepseek-v2-236b", "layers/attn/wv_b", (60, 512, 4096)),
    ("deepseek-v2-236b", "layers/attn/wo", (60, 4096, 5120)),
    ("deepseek-v2-236b", "layers/attn/wq_a", (60, 5120, 1536)),
    ("deepseek-v2-236b", "layers/attn/q_norm/scale", (60, 1536)),
])
def test_piece_shapes_at_full_width(arch, leaf, want):
    spec, pieces = _pieces(get_config(arch), 4, 1)
    piece = dict(tree.items(pieces))[leaf]
    full = dict(tree.items(spec))[leaf].shape
    got = tuple(full) if piece is None else piece.shape(full)
    assert got == want


@pytest.mark.parametrize("arch,m", [("mamba2-130m", 4), ("zamba2-1.2b", 2),
                                    ("llama3-405b", 4), ("gemma3-1b", 4),
                                    ("seamless-m4t-large-v2", 2),
                                    ("granite-moe-3b-a800m", 4),
                                    ("deepseek-v2-236b", 4)])
def test_pieces_tile_every_leaf(arch, m):
    """Every rank's piece laid back in its place rebuilds the whole leaf;
    a part that several ranks hold is the same entries on each of them,
    and is counted once over the ranks (`Piece.counted`)."""
    cfg = get_smoke(arch)
    per_rank = [_pieces(cfg, m, r)[1] for r in range(m)]
    spec = _pieces(cfg, m, 0)[0]
    for path, leaf in tree.items(spec):
        full = torch.arange(float(np.prod(leaf.shape))).reshape(leaf.shape)
        pieces = [dict(tree.items(p))[path] for p in per_rank]
        if pieces[0] is None:
            assert all(p is None for p in pieces), path
            continue
        rebuilt = torch.full_like(full, -1.0)
        counted = torch.zeros_like(full)
        for r, piece in enumerate(pieces):
            local = piece.take(full)
            piece.place(rebuilt, local, r)
            marks = torch.zeros_like(local)
            for off, n in piece.counted():
                marks.narrow(piece.dim, off, n).fill_(1.0)
            seen = torch.zeros_like(full)
            piece.place(seen, marks, r)
            counted += seen
        assert torch.equal(rebuilt, full), path
        assert torch.equal(counted, torch.ones_like(full)), path


@pytest.mark.parametrize("argv,match", [
    (["--model", "2"], "needs --data"),
    (["--data", "4", "--model", "3"], "does not divide"),
])
def test_cli_model_needs_its_ranks(monkeypatch, argv, match):
    """``--model m`` splits m of the ``--data`` ranks: alone, or with a
    rank count m does not divide, it raises before any group starts."""
    from repro_torch.launch import train as train_cli
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setattr("sys.argv", ["train", "--arch", "gemma3-1b",
                                     "--smoke", "--device", "cpu", *argv])
    with pytest.raises(ValueError, match=match):
        train_cli.main()
