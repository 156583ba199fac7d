"""The port's FSDP (``ParallelConfig.fsdp``) over CPU ranks (gloo).

Each rank holds its block over "data" of every parameter whose rule
marks "fsdp" (of its piece over "model"), gathers a layer's blocks in
the layer's body (inside remat, so the recompute gathers again) and gets
their gradients back reduce-scattered in f32.

- Layout, on the meta device, no process group: for every full-width
  config of the registry at (data 2, model 2), (4, 1), (16, 16) and the
  multi-pod (pod 2, data 16, model 16) (the reference's
  ``MULTI_POD_RULES``: "fsdp" over ("pod", "data")), each parameter's
  FSDP block lies on the dim where the reference's ``param_pspecs``
  under a binding with ``fsdp=True`` names "data", with the extent of
  its axes and the rank's pod-major index over them (none where the
  spec names none), its piece on
  the dim where the spec names "model" (but for the port's own layouts,
  `runtime.param_sharding`), and each moment's block where the
  reference's ``specs_from_logical(zero1_moment_axes(...),
  keep_fsdp=True)`` names "data". At (16, 16), where "model" does not
  divide a config's heads or widths (once refused, ROADMAP A.4.6), the
  blocks of the whole leaves of those blocks.
- Steps 1 and 2, with remat on, from the reference's initial parameters
  (``PRNGKey(0)``, each rank's blocks taken by ``params_from_numpy(...,
  shards=)``), on TokenDataset batches, each rank holding the rows of
  its "data" coordinate: gemma3-1b, mamba2-130m, zamba2-1.2b (its shared
  block gathered at each use), seamless-m4t-large-v2 (encoder, decoder
  and the cross K/V), granite-moe without its dead experts (V2) and
  deepseek-v2 (MLA, a shared expert) at (2, 1); gemma3-1b and
  granite-moe at (2, 2) and (4, 1). Held to the port's single-process
  step and to the reference's jitted single-device step, each taken
  from the state the step started from (step 2 from the mesh's own
  step-1 state, as in tests/test_torch_ep.py): metrics within rtol
  1e-5, states within 1e-5 off the sign-trap and knee entries; before
  each MoE comparison, the single-device routing shows a gap above 1e-5
  between the k-th and (k+1)-th probabilities (ROADMAP C). V2
  dispatches in groups of up to 256 tokens, which may not straddle two
  "data" ranks: granite-moe runs at a global (8, 128) (256 tokens a
  rank at (4, 1); at (4, 256) its routing has a near tie of 6.8e-6),
  deepseek-v2 at (4, 128).
- gemma3-1b with 2 microbatches at (2, 1), two steps, against the
  single-process step on the batch whose microbatch i is each rank's
  i-th half.
- At a "data" extent of 1 ((1, 2)) FSDP on is the step with it off, bit
  for bit.
- Two faults the comparison must catch (gemma3-1b at (2, 1), step 2 held
  as the rest): each gathered weight's gradient left unsummed over
  "data", and each gathered layer cached across steps (step 2 runs on
  step 1's weights; step 1 still agrees). The unbroken step passes.
- Checkpoints: a `train_loop` of gemma3-1b with FSDP at (2, 2) saves at
  step 2; restored at (4, 1) with FSDP (split, gathered again) and at
  one process without it, it is the saved state bit for bit, and the
  runs resumed from it agree with the uncut run (1e-5 metrics, 1e-4
  state); the reference's ``checkpoint.restore`` reads that save.

World 2 and world 4 (both of its meshes and the checkpoint loop) each
run in one spawn of gloo ranks (tests/torch_dist_ranks.py); the
reference's jitted steps are made once a config, its initial states
and first steps on threads of their own (the ranks do not wait for the
JAX work they do not need).
"""

import functools
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import checkpoint as j_checkpoint  # noqa: E402
from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.data.tokens import TokenDataset as JTokenDataset  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.runtime import param_sharding as j_psh  # noqa: E402
from repro.runtime import sharding as j_shlib  # noqa: E402
from repro.train import steps as j_steps  # noqa: E402

import torch  # noqa: E402

from repro_torch import checkpoint, tree  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    _ALIASES, ParallelConfig, TrainConfig, get_config, get_smoke)
from repro_torch.data import TokenDataset  # noqa: E402
from repro_torch.launch.dryrun import MeshShape  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.api import family_module  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.runtime import param_sharding as psh  # noqa: E402
from repro_torch.runtime import sharding as shlib  # noqa: E402
from repro_torch.train.steps import (  # noqa: E402
    make_train_step, state_blocks)

from test_torch_dist_train import (  # noqa: E402
    _close_trees, _npz, _port_run, _ref_init)
from test_torch_train_models import (  # noqa: E402
    _assert_margins, _metrics_close, _record_router_inputs, _states_close)
from torch_dist_ranks import (  # noqa: E402
    FSDP_FAULTS, FSDP_LOOP, LOOP_SHAPE, TRAIN, _tool, fsdp_rank,
    join_ranks, start_ranks)

STEPS = 2
SMALL = (4, 16)
GRANITE = ("granite-moe-3b-a800m", {"n_experts_padded": 0})
# name: (arch, overrides, {mesh: global batch})
CASES = {
    "gemma3": ("gemma3-1b", {}, {(2, 1): SMALL, (2, 2): SMALL,
                                 (4, 1): SMALL}),
    "mamba2": ("mamba2-130m", {}, {(2, 1): SMALL}),
    "zamba2": ("zamba2-1.2b", {}, {(2, 1): SMALL}),
    "seamless": ("seamless-m4t-large-v2", {}, {(2, 1): SMALL}),
    "granite-v2": GRANITE + ({(2, 1): (8, 128), (2, 2): (8, 128),
                              (4, 1): (8, 128)},),
    "deepseek": ("deepseek-v2-236b", {}, {(2, 1): (4, 128)}),
}
PAIRS = [(c, m) for c in sorted(CASES) for m in sorted(CASES[c][2])]
IDS = [f"{c}-{m[0]}x{m[1]}" for c, m in PAIRS]
# world 2's extras at (2, 1), and on the same ranks at (1, 2)
EXTRAS2 = {(2, 1): {"mb": ("gemma3", SMALL), "faults": ("gemma3", SMALL)},
           (1, 2): {"plain": ("gemma3", SMALL)}}
FULL = sorted(_ALIASES)
LAYOUT_MESHES = [(2, 2), (4, 1), (16, 16), (2, 16, 16)]


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The spawns of worlds 2 and 4, started before the single-device
    runs so that all proceed together."""
    root = tmp_path_factory.mktemp("fsdp_loops")
    with ThreadPoolExecutor(len(CASES)) as pool:
        inits = dict(zip(CASES, pool.map(lambda c: _ref_init(*c[:2])[1],
                                         CASES.values())))
    cases = {name: dict(arch=arch, overrides=over, shapes=shapes,
                        steps=STEPS, init=inits[name])
             for name, (arch, over, shapes) in CASES.items()}
    extras4 = {(2, 2): {"save": ("gemma3", root)},
               (4, 1): {"resume": ("gemma3", root)}}
    return dict(
        root=root,
        w2=start_ranks(fsdp_rank, 2, tmp_path_factory.mktemp("fsdp2"),
                       [(2, 1), (1, 2)], cases, EXTRAS2, shape=(2, 1)),
        w4=start_ranks(fsdp_rank, 4, tmp_path_factory.mktemp("fsdp4"),
                       [(2, 2), (4, 1)], cases, extras4, shape=(2, 2)))


@functools.lru_cache(maxsize=None)
def _ref_step_fn(arch, overrides):
    return jax.jit(j_steps.make_train_step(
        j_get_model(j_get_smoke(arch, **dict(overrides))),
        JTrainConfig(**TRAIN)))


def _ref_step(arch, over, shape, flat, step):
    """The reference's jitted step ``step`` on the global batch from the
    whole state ``flat`` ({path: numpy}): its metrics and state."""
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


def _port_step(arch, over, shape, flat, step):
    """The port's single-process step ``step`` on the global batch from
    the whole state ``flat``: its metrics, its state, the gradient at
    the parameters it started from (numpy trees), and the (router, x)
    pairs it routed (`_record_router_inputs`)."""
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


def _init_flat(init):
    flat = {f"params/{k}": v for k, v in tree.items(init)}
    flat.update({f"opt/{m}/{k}": np.zeros_like(v)
                 for m in "mv" for k, v in tree.items(init)})
    flat["opt/step"] = np.zeros((), np.int32)
    return flat


@pytest.fixture(scope="module")
def single(started):
    """Per (case, global batch): the port's single-process step 1 from
    the reference's initial parameters, with the routes it took, and the
    reference's step 1."""
    keys = [(name, shape) for name, (_, _, shapes) in CASES.items()
            for shape in sorted(set(shapes.values()))]

    def ref(key):
        arch, over, _ = CASES[key[0]]
        return _ref_step(arch, over, key[1],
                         _init_flat(_ref_init(arch, over)[1]), 1)
    with ThreadPoolExecutor(len(keys)) as pool:
        refs = pool.map(ref, keys)
        # the port's on this thread (its router records patch a module)
        ports = [_port_step(*CASES[name][:2], shape,
                            _init_flat(_ref_init(*CASES[name][:2])[1]), 1)
                 for name, shape in keys]
        return {key: dict(port=port, ref=r)
                for key, port, r in zip(keys, ports, refs)}


@pytest.fixture(scope="module")
def fsdp(started, single):
    """{mesh shape: rank 0's `fsdp_rank` results}."""
    out = {}
    for key in ("w2", "w4"):
        out.update(join_ranks(started[key])[0])
    return out


@pytest.fixture(scope="module")
def second(fsdp):
    """Per (case, mesh): the port's single-process step 2 and the
    reference's, each from the mesh's own step-1 state."""
    out = {}
    for case, mesh in PAIRS:
        arch, over, shapes = CASES[case]
        flat = fsdp[mesh][case][0][1]
        out[case, mesh] = (_port_step(arch, over, shapes[mesh], flat, 2),
                           _ref_step(arch, over, shapes[mesh], flat, 2))
    return out


def _held(runs, first, port, ref=None):
    """Steps 1 and 2 of ``runs`` against the single-process steps
    ``first`` (step 1 from the initial state) and ``port`` (step 2 from
    the run's step-1 state), or against the reference's ``ref`` (its two
    steps the same way)."""
    assert len(runs) == STEPS
    _assert_margins(first["seen"])
    _assert_margins(port["seen"])
    want1, want2 = (first, port) if ref is None else ref
    _metrics_close(runs[0][0], want1["metrics"])
    _states_close(runs[0][1], want1["state"], [first], 1e-5)
    _metrics_close(runs[1][0], want2["metrics"])
    _states_close(runs[1][1], want2["state"], [first, port], 1e-5)


@pytest.mark.parametrize("case,mesh", PAIRS, ids=IDS)
def test_fsdp_step_matches_single_process(single, fsdp, second, case,
                                          mesh):
    one = single[case, CASES[case][2][mesh]]
    _held(fsdp[mesh][case], one["port"], second[case, mesh][0])


@pytest.mark.parametrize("case,mesh", PAIRS, ids=IDS)
def test_fsdp_step_matches_reference(single, fsdp, second, case, mesh):
    one = single[case, CASES[case][2][mesh]]
    port, ref = second[case, mesh]
    runs = fsdp[mesh][case]
    _held(runs, one["port"], port, (one["ref"], ref))
    assert int(runs[-1][1]["opt/step"]) == STEPS


def test_fsdp_microbatches_split_each_ranks_rows(fsdp):
    """Two microbatches a step at (2, 1): each FSDP leaf's accumulator is
    its block, each microbatch's gradients reduce-scattered; against the
    single-process step whose microbatch i is each rank's i-th half,
    both steps."""
    arch, over, _ = CASES["gemma3"]
    want = _port_run(arch, over, _ref_init(arch, over)[1], SMALL, STEPS,
                     microbatches=2, rows=[0, 2, 1, 3])
    got = fsdp[(2, 1)]["mb"]
    assert len(got) == STEPS
    for (m, _), w in zip(got, want):
        _metrics_close(m, w["metrics"])
    _states_close(got[0][1], want[0]["state"], want[:1], 1e-5)
    _states_close(got[1][1], want[1]["state"], want, 1e-5)


def test_fsdp_at_data_extent_1_is_the_step_without_it(fsdp):
    """At (1, 2) no parameter splits over "data": FSDP on is the step
    with it off, both steps, metrics and whole states bit for bit."""
    on, off = fsdp[(1, 2)]["fsdp_on"], fsdp[(1, 2)]["fsdp_off"]
    assert len(on) == len(off) == STEPS
    for (m_on, s_on), (m_off, s_off) in zip(on, off):
        assert m_on == m_off
        assert set(s_on) == set(s_off)
        for k in s_on:
            assert np.array_equal(s_on[k], s_off[k]), k


@pytest.mark.parametrize("fault", FSDP_FAULTS)
def test_fsdp_faults_fail_the_comparison(single, fsdp, second, fault):
    """The comparison above catches an FSDP step whose gathered weights'
    gradients are left unsummed over "data", and one whose gathered
    layers are cached across steps (step 2 on step 1's weights); the
    unbroken step at the same mesh passes it."""
    mesh, case = (2, 1), "gemma3"
    first = single[case, SMALL]["port"]
    port = second[case, mesh][0]
    _held(fsdp[mesh][case], first, port)
    bad = fsdp[mesh][fault]
    # each fault's step 2 from its own step-1 state
    arch, over, _ = CASES[case]
    port_bad = _port_step(arch, over, SMALL, bad[0][1], 2)
    with pytest.raises(AssertionError):
        _held(bad, first, port_bad)
    if fault == "fsdp_cached":
        # step 1 agrees: only step 2 shows a stale gather
        _metrics_close(bad[0][0], first["metrics"])
        _states_close(bad[0][1], first["state"], [first], 1e-5)
        with pytest.raises(AssertionError):
            _metrics_close(bad[1][0], port_bad["metrics"])


# ---------------------------------------------------------------------------
# Layout against the reference's specs
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _trees(arch):
    cfg = get_config(arch)
    ref = jax.eval_shape(j_get_model(j_get_config(arch)).init_params,
                         jax.random.PRNGKey(0))
    port = family_module(cfg).init_params(cfg, None, torch.device("meta"))
    return cfg, ref, port


def _flat_specs(t):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        t, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in flat}


def _dim_of(spec, axis):
    dims = [i for i, e in enumerate(spec)
            if e == axis or (isinstance(e, tuple) and axis in e)]
    return dims[0] if dims else None


# leaves where the port's piece follows a layout of its own
# (`runtime.param_sharding`): per-head SSM leaves and the gated norm,
# split where the reference's spec names no "model"; q_norm / k_norm,
# one part on every rank; the shared experts, split column / row where
# the reference's rule names their layer dim
def _own_piece(path):
    names = path.split("/")
    return (("ssm" in names and names[-1] in ("a_log", "dt_bias", "d_skip",
                                              "scale"))
            or names[-2:-1] in (["q_norm"], ["k_norm"])
            or "shared" in names)


@pytest.mark.parametrize("mesh", LAYOUT_MESHES,
                         ids=["x".join(map(str, m)) for m in LAYOUT_MESHES])
@pytest.mark.parametrize("arch", FULL)
def test_fsdp_layout_matches_reference_specs(arch, mesh):
    cfg, ref, port = _trees(arch)
    names = ("pod", "data", "model")[3 - len(mesh):]
    rules = (j_shlib.MULTI_POD_RULES if len(mesh) == 3
             else j_shlib.SINGLE_POD_RULES)
    d, m = int(np.prod(mesh[:-1])), mesh[-1]     # the "fsdp" ranks, model
    with j_shlib.use_binding(j_shlib.Binding(
            rules, dict(zip(names, mesh)), fsdp=True)):
        pspecs = _flat_specs(j_psh.param_pspecs(ref))
        moments = _flat_specs(j_psh.specs_from_logical(
            j_psh.zero1_moment_axes(j_psh.logical_param_axes(ref), ref),
            ref, keep_fsdp=True))
    rank = tuple(n - 1 for n in mesh)       # the last rank: d - 1 pod-major
    fake = MeshShape(mesh, rank)
    layout = state_blocks(cfg, TrainConfig(), fake,
                          ParallelConfig(fsdp=True))
    params = dict(tree.items(layout["params"]))
    moment_shards = dict(tree.items(layout["opt"]["m"]))
    shapes = {p: tuple(leaf.shape) for p, leaf in tree.items(port)}
    assert set(params) == set(pspecs)
    n_split = 0
    for path, spec in pspecs.items():
        shard = params[path]
        block = None if shard is None else shard.block
        piece = None if shard is None else shard.piece
        data_dim = _dim_of(spec, "data")
        if data_dim is None:
            assert block is None, path
        else:
            n_split += 1
            assert (block.dim, block.axis.extent, block.axis.index) == (
                data_dim, d, d - 1), path
        # a block "model" does not divide is whole: no piece, or (KV heads
        # under split query heads, the attn_batch fallback's leaves) a
        # piece of the whole leaf
        if piece is not None and not _own_piece(path) and \
                piece.shape(shapes[path]) != shapes[path]:
            assert (piece.dim, piece.axis.extent) == (
                _dim_of(spec, "model"), m), path
        mo = moment_shards[path]
        mo_dim = _dim_of(moments[path], "data")
        got = None if mo is None or mo.block is None else mo.block.dim
        if got is None and mo_dim is not None and _own_piece(path):
            # the moment's block is of the port's own piece, which
            # "data" does not divide there (zamba2's 4 heads a rank
            # at "model" 16): whole, as before FSDP
            assert piece.size() % d, path
        else:
            assert got == mo_dim, path
        if block is not None:
            assert mo.block == block, path
    # the projections in and out of every layer split (mamba2: 2)
    assert n_split >= 2


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def loop(started, fsdp):
    return dict(root=started["root"], uncut=fsdp[(2, 2)]["uncut"],
                restored=fsdp[(4, 1)]["restored"],
                resumed=fsdp[(4, 1)]["resumed"])


def test_fsdp_save_restores_at_4x1_and_continues(loop):
    root = loop["root"]
    saved = _npz(root / FSDP_LOOP / "step_00000002.npz")
    restored, n_split = loop["restored"]
    assert n_split > 0
    assert set(restored) == set(saved)
    for k in saved:
        assert np.array_equal(restored[k], saved[k]), k
    resumed = loop["resumed"]["metrics"]
    assert len(resumed) == 2
    for got, want in zip(resumed, loop["uncut"]["metrics"][2:]):
        _metrics_close(got, want)
    _close_trees(_npz(root / "fsdp_resumed" / "step_00000004.npz"),
                 _npz(root / FSDP_LOOP / "step_00000004.npz"), 1e-4)


def test_fsdp_save_restores_at_one_process_and_continues(loop, tmp_path):
    root = loop["root"]
    arch, over, _ = CASES["gemma3"]
    cfg = get_smoke(arch, remat=True, **over)
    spec = family_module(cfg).init_params(cfg, None, torch.device("meta"))
    state = checkpoint.restore(str(root / FSDP_LOOP), 2,
                               {"params": spec, "opt": adamw_init(spec)},
                               device="cpu")
    saved = _npz(root / FSDP_LOOP / "step_00000002.npz")
    got = {k: v.numpy() for k, v in tree.items(state)}
    assert set(got) == set(saved)
    for k in saved:
        assert np.array_equal(got[k], saved[k]), k
    ckpt = tmp_path / "one"
    ckpt.mkdir()
    shutil.copy(root / FSDP_LOOP / "step_00000002.npz", ckpt)
    (ckpt / "MANIFEST.json").write_text('{"latest_step": 2}')
    metrics = []
    train_loop(cfg, TrainConfig(checkpoint_every=2, seed=3, **TRAIN),
               batch=LOOP_SHAPE[0], seq=LOOP_SHAPE[1], steps=4,
               log_every=100, ckpt_dir=str(ckpt), metrics_out=metrics,
               device="cpu")
    assert len(metrics) == 2
    for got_m, want in zip(metrics, loop["uncut"]["metrics"][2:]):
        _metrics_close(got_m, want)
    _close_trees(_npz(ckpt / "step_00000004.npz"),
                 _npz(root / FSDP_LOOP / "step_00000004.npz"), 1e-4)


def test_reference_restores_an_fsdp_save(loop):
    """The reference's ``checkpoint.restore`` reads the (2, 2) FSDP run's
    step-2 save into its own train state's structure: every leaf's shape
    and values."""
    arch, over, _ = CASES["gemma3"]
    cfg = j_get_smoke(arch, **over)
    template = jax.eval_shape(
        lambda k: j_steps.init_train_state(j_get_model(cfg), k),
        jax.random.PRNGKey(0))
    got = j_checkpoint.restore(str(loop["root"] / FSDP_LOOP), 2, template)
    saved = _npz(loop["root"] / FSDP_LOOP / "step_00000002.npz")
    flat, _ = jax.tree_util.tree_flatten_with_path(got)
    keys = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in flat}
    assert set(keys) == set(saved)
    for k, v in saved.items():
        assert keys[k].shape == v.shape, k
        np.testing.assert_array_equal(keys[k].astype(v.dtype), v, err_msg=k)


def test_cli_fsdp_needs_its_ranks(monkeypatch):
    """``--fsdp`` without ``--data`` of two or more ranks raises before
    any group starts."""
    from repro_torch.launch import train as train_cli
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr("sys.argv", ["train", "--arch", "gemma3-1b",
                                     "--smoke", "--device", "cpu",
                                     "--fsdp"])
    with pytest.raises(ValueError, match="--fsdp needs --data"):
        train_cli.main()
