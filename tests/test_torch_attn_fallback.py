"""Blocks that "model" does not divide, and MoE V2's dispatch groups
across ranks, over CPU ranks (gloo).

A block whose heads or width "model" does not divide is whole on every
rank (`runtime.param_sharding.tp_layout`): the attention (or, under a
split of the query heads, only KV heads that neither divide nor are
divided by "model"), the SSM, the MLP, the experts, the shared experts.
Under ``attn_batch_fallback`` the attention instead splits each "data"
rank's rows again over "model" where they divide (`models.attention.
rows_axis`). From the port's smoke parameters of seed 0 (carried leaf by
leaf into the reference's tree), each rank's pieces taken by
``params_from_numpy(..., shards=)``, f32, remat on, TokenDataset
batches of a global (12, 16), each rank holding the rows of its "data"
coordinate:

- the seven configs once refused (ROADMAP A.4.6,
  tests/test_torch_tp.py::test_heads_model_does_not_divide_refused) at
  (1, 3) and (1, 4): the qwen3 smoke (4 heads over 2 KV heads: whole
  at 3), qwen3 with 6 heads over 2 KV heads (at 3, 2 query heads a
  rank and every KV head on each: rank 1 reads KV heads 0 and 1), the
  mamba2 smoke (8 SSM heads: whole at 3), gemma3 with a d_ff of 130,
  granite-moe's 24 heads over 8 KV heads, 6 experts on a width of 66,
  deepseek-v2's shared width of 66;
- at (1, 3): the gemma3 smoke (4 heads, one KV head, d_ff 128: all
  whole) with the fallback off and on (4 rows a rank), the qwen3 smoke
  with it on;
- at (2, 2): qwen3 with 3 heads and one KV head, with the fallback off
  and on ("model" 2 divides every smoke's 4 heads);
- at (2, 1), a global (2, 64): granite-moe's V2 smoke, 64 tokens a rank
  in dispatch groups of 128 that straddle the two ranks' rows (once
  refused, ROADMAP A.4.8).

Steps 1 and 2 are held to the port's single-process step and to the
reference's jitted single-device step, each from the state the step
started from (step 2 from the mesh's own step-1 state, as in
tests/test_torch_tp.py): metrics within rtol 1e-5, states within 1e-5
off the sign-trap and knee entries (and one entry at its own limit,
`APART`). The fallback
changes nothing on one device, so a case with it on is held to the
steps of its config without it. Before an MoE comparison the
single-device routing shows a gap above 1e-5 between the k-th and
(k+1)-th probabilities (ROADMAP C).

- Faults the comparison must catch (one step at (1, 3)): gemma3 with a
  whole leaf's gradient summed over "model", and gemma3 under the
  fallback with its "model" sum left out.
- Serving at (1, 3), a global batch of 6, through
  tools/dist_serve_cells.py's `f32_case`: the gemma3, qwen3 and mamba2
  smokes, the first two with the fallback off and on: prefill cell and
  4 decode steps against one card (tokens equal, logits and caches
  within the tool's limits) and against the reference's logits within
  1e-5 of the largest (`LOGITS_TOL`); the decode cache's 32 positions
  do not split 3 ways, so it is whole along them (the reference's
  resolve drops the axis). Granite-moe's V2 decode at (2, 2), its
  groups across ranks, is tests/test_torch_serve_mesh.py's.
- Without ranks: V2's ranks across ranks (`models.moe.groups_across`)
  equal the reference's `_dispatch_onehot` ranks, on routes with ties
  at the capacity edge, and each rank's dispatch of its own tokens is
  the reference's output on them; `make_train_step` and every serving
  cell build for every full config at "model" 2, 3, 4, 8 and 16.

Worlds 2, 3 and 4 run in one spawn each (tests/torch_dist_ranks.py),
started before the reference's runs in the parent.
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
from repro.models import moe as j_moe  # noqa: E402
from repro.train import steps as j_steps  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES, TrainConfig,  # noqa: E402
                                 get_config, get_smoke)
from repro_torch.data import TokenDataset  # noqa: E402
from repro_torch.launch import cells  # noqa: E402
from repro_torch.models import get_model, moe  # noqa: E402
from repro_torch.models.api import family_module  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402

from test_torch_dist_train import _port_run  # noqa: E402
from test_torch_serve_mesh import reference_run  # noqa: E402
from test_torch_tp import INDIVISIBLE, _FakeMesh, _held  # noqa: E402
from test_torch_train_models import (  # noqa: E402
    _assert_margins, _metrics_close, _record_router_inputs, _states_close)
from torch_dist_ranks import (  # noqa: E402
    FALLBACK_FAULTS, TRAIN, fallback_rank, join_ranks, serve_tool,
    start_ranks)

TOOL = serve_tool()
STEPS = 2
FB = {"attn_batch_fallback": True}
QWEN_3H = dict(n_heads=3, n_kv_heads=1, d_head=16)
# one global batch for every dense mesh: its 12 rows split over "data" x
# "model" at (1, 3), (1, 4) and (2, 2), and each config's reference step
# is compiled once
SHAPE = (12, 16)
# name: (arch, overrides, global batch, meshes)
CASES = {
    "gemma3": ("gemma3-1b", {}, SHAPE, [(1, 3)]),
    "gemma3-fallback": ("gemma3-1b", FB, SHAPE, [(1, 3)]),
    "qwen3-fallback": ("qwen3-8b", FB, SHAPE, [(1, 3)]),
    "qwen3-3h": ("qwen3-8b", QWEN_3H, SHAPE, [(2, 2)]),
    "qwen3-3h-fallback": ("qwen3-8b", {**QWEN_3H, **FB}, SHAPE, [(2, 2)]),
    "granite-v2": ("granite-moe-3b-a800m", {}, (2, 64), [(2, 1)]),
}
# the seven once refused, at "model" 3 and 4 (among them the qwen3 and
# mamba2 smokes as they are)
for _i, (_a, _o, _m, _) in enumerate(INDIVISIBLE):
    CASES[f"{_a}-overrides{_i}"] = (_a, _o, SHAPE, [(1, 3), (1, 4)])
PAIRS = [(c, m) for c in sorted(CASES) for m in CASES[c][3]]
IDS = [f"{c}-{m[0]}x{m[1]}" for c, m in PAIRS]
FAULTS = {"whole_summed": ((1, 3), "gemma3"),
          "rows_unsummed": ((1, 3), "gemma3-fallback")}
SERVE = {(1, 3): [(n, a, o, 6) for n, a, o in (
    ("gemma3", "gemma3-1b", {}), ("gemma3-fallback", "gemma3-1b", FB),
    ("qwen3", "qwen3-8b", {}), ("qwen3-fallback", "qwen3-8b", FB),
    ("mamba2", "mamba2-130m", {}))]}
WORLDS = {2: [(2, 1)], 3: [(1, 3)], 4: [(2, 2), (1, 4)]}
# entries checked at their own limit and then left out of a case's
# comparisons after step 1 ({(case, path, flat index): limit}; the
# first of 2e-5, 5e-5, 1e-4, 2e-4 at least twice the largest reading,
# as tests/test_torch_tp.py's APART). granite-moe's 24 heads, the
# embedding's [68, 1]: its step-1 gradient 1.9e-6 of its leaf's largest
# (just above the sign trap of 1e-6), sqrt(v_hat) 1.2e-7 (just above
# the knee of 1e-7), the tied logits' gradient summing 192 tokens' terms
# that cancel to it, so the update carries an error of 9 %: it reads
# 9.2e-5 at (1, 3) and 7.2e-5 at (1, 4) from the single-process step
APART = {("granite-moe-3b-a800m-overrides4", "params/embed/embedding",
          68 * 64 + 1): 2e-4}


def _plain(over):
    """``over`` without the fallback's flag, which changes nothing on
    one device: the single-device steps a case is held to."""
    return {k: v for k, v in over.items() if k != "attn_batch_fallback"}


def _key(case):
    arch, over, shape, _ = CASES[case]
    return arch, tuple(sorted(_plain(over).items())), shape


@functools.lru_cache(maxsize=None)
def _init(arch, over):
    """The port's smoke parameters of seed 0 for ``arch`` (``over``, a
    sorted tuple of items, on its config) as numpy, the initial state of
    every run here (the reference's too, carried leaf by leaf): made
    without the reference, so the ranks start at once."""
    cfg = get_smoke(arch, **dict(over))
    return tree.map_(lambda t: t.numpy(),
                     get_model(cfg, device="cpu").init_params(0))


@functools.lru_cache(maxsize=None)
def _template(arch, over):
    """The reference's train state's structure (shapes only)."""
    model = j_get_model(j_get_smoke(arch, **dict(over)))
    return jax.eval_shape(lambda k: j_steps.init_train_state(model, k),
                          jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The spawns of worlds 2, 3 and 4, started before the reference's
    runs in the parent."""
    cases = {name: dict(arch=arch, overrides=over, shape=shape,
                        steps=STEPS, meshes=meshes,
                        init=_init(*_key(name)[:2]))
             for name, (arch, over, shape, meshes) in CASES.items()}
    return {w: start_ranks(fallback_rank, w,
                           tmp_path_factory.mktemp(f"fallback{w}"), shapes,
                           cases, FAULTS, SERVE, shape=shapes[0])
            for w, shapes in WORLDS.items()}


@functools.lru_cache(maxsize=None)
def _ref_step_fn(arch, overrides):
    return jax.jit(j_steps.make_train_step(
        j_get_model(j_get_smoke(arch, **dict(overrides))),
        JTrainConfig(**TRAIN)))


def _ref_step(key, flat, step):
    """The reference's jitted step ``step`` on the global batch from the
    whole state ``flat`` ({path: numpy}): its metrics and state."""
    arch, over, shape = key
    paths, treedef = jax.tree_util.tree_flatten_with_path(
        _template(arch, over))
    state = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(flat["/".join(str(getattr(k, "key", k)) for k in path)],
                    dtype=leaf.dtype) for path, leaf in paths])
    data = JTokenDataset(j_get_smoke(arch, **dict(over)), *shape, seed=0)
    state, metrics = _ref_step_fn(arch, over)(
        state, jax.tree.map(jnp.asarray, data.batch_for_step(step)))
    return dict(state=jax.tree.map(np.asarray, state),
                metrics={k: float(v) for k, v in metrics.items()})


def _port_step(key, flat, step):
    """The port's single-process step ``step`` on the global batch from
    the whole state ``flat``: its metrics and state, the gradient at the
    parameters it started from (numpy trees), and the (router, x) pairs
    it routed (`_record_router_inputs`)."""
    arch, over, shape = key
    cfg = get_smoke(arch, **dict(over))
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
    """Per single-device config and batch: the port's step 1 from the
    initial state with the routes it took, and the reference's step 1;
    and per serving case the reference's prefill and decode."""
    out = {}
    for key in sorted({_key(c) for c in CASES}):
        arch, over, shape = key
        init = _init(arch, over)
        flat = {f"params/{k}": v for k, v in tree.items(init)}
        flat.update({f"opt/{m}/{k}": np.zeros_like(v)
                     for m in "mv" for k, v in tree.items(init)})
        flat["opt/step"] = np.zeros((), np.int32)
        with pytest.MonkeyPatch.context() as mp:
            seen = _record_router_inputs(mp)
            port = _port_run(arch, dict(over), init, shape, 1)
        out[key] = dict(port=port, seen=seen, ref=_ref_step(key, flat, 1))
    for jobs in SERVE.values():
        for name, arch, over, batch in jobs:
            out["serve", name] = reference_run(arch, _plain(over), batch)
    return out


@pytest.fixture(scope="module")
def ranks(started, single):
    """{mesh shape: rank 0's `fallback_rank` results}."""
    out = {}
    for handle in started.values():
        out.update(join_ranks(handle)[0])
    return out


@pytest.fixture(scope="module")
def second(ranks):
    """Per (case, mesh): the port's single-process step 2 and the
    reference's, each from the mesh's own step-1 state."""
    return {(case, mesh): (_port_step(_key(case),
                                      ranks[mesh][case][0][1], 2),
                           _ref_step(_key(case), ranks[mesh][case][0][1],
                                     2))
            for case, mesh in PAIRS}


@pytest.mark.parametrize("case,mesh", PAIRS, ids=IDS)
def test_step_matches_single_process(single, ranks, second, case, mesh):
    one = single[_key(case)]
    first = one["port"][0]
    _assert_margins(one["seen"])
    got = ranks[mesh][case]
    assert len(got) == STEPS
    _metrics_close(got[0][0], first["metrics"])
    _held(case, got[0][1], first["state"], [first], 1e-5, APART)
    port = second[case, mesh][0]
    _assert_margins(port["seen"])
    _metrics_close(got[1][0], port["metrics"])
    _states_close(got[1][1], port["state"], [first, port], 1e-5)


@pytest.mark.parametrize("case,mesh", PAIRS, ids=IDS)
def test_step_matches_reference(single, ranks, second, case, mesh):
    one = single[_key(case)]
    first, ref = one["port"][0], one["ref"]
    got = ranks[mesh][case]
    _metrics_close(got[0][0], ref["metrics"])
    _held(case, got[0][1], ref["state"], [first], 1e-5, APART)
    port, ref = second[case, mesh]
    _metrics_close(got[1][0], ref["metrics"])
    _states_close(got[1][1], ref["state"], [first, port], 1e-5)
    assert int(got[-1][1]["opt/step"]) == STEPS


@pytest.mark.parametrize("fault", FALLBACK_FAULTS)
def test_faults_fail_the_comparison(single, ranks, fault):
    """The comparisons above catch a step with a whole leaf's gradient
    summed over "model" (each rank already holds all of it), and a
    fallback step with its "model" sum left out (each rank's gradient
    is of its own rows); the unbroken step at the same mesh passes
    them."""
    mesh, case = FAULTS[fault]
    port = single[_key(case)]["port"]
    (m_ok, s_ok) = ranks[mesh][case][0]
    _metrics_close(m_ok, port[0]["metrics"])
    _states_close(s_ok, port[0]["state"], port[:1], 1e-5)
    (m_bad, s_bad), = ranks[mesh][fault]
    with pytest.raises(AssertionError):
        _metrics_close(m_bad, port[0]["metrics"])
    with pytest.raises(AssertionError):
        _states_close(s_bad, port[0]["state"], port[:1], 1e-5)


SERVED = [(mesh, job[0]) for mesh, jobs in SERVE.items() for job in jobs]


@pytest.mark.parametrize("mesh,name", SERVED,
                         ids=[f"{n}-{m[0]}x{m[1]}" for m, n in SERVED])
def test_cells_match_one_card_and_reference(single, ranks, mesh, name):
    r = ranks[mesh]["serve", name]
    assert "refused" not in r, r.get("refused")
    assert r["ok"], r
    got, want = r["logits"], single["serve", name]
    rows = got["rows"]
    for g, w in zip(got["tokens"], want["tokens"]):
        np.testing.assert_array_equal(g, w[rows])
    for g, w in zip([got["prefill"]] + got["decode"],
                    [want["prefill"]] + want["decode"]):
        w = w[rows]
        np.testing.assert_allclose(
            g, w, rtol=0, atol=TOOL.LOGITS_TOL * np.abs(w).max())


# ---------------------------------------------------------------------------
# Without ranks
# ---------------------------------------------------------------------------


def _routes_with_ties(cfg, t, seed=0):
    """(T, k) distinct routes per token, half of the tokens' first choice
    on expert 0 (its queue overflows a group's capacity, the ties at its
    edge broken by token order)."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.permutation(cfg.n_experts)[:cfg.n_experts_per_tok]
                    for _ in range(t)])
    hot = rng.random(t) < 0.5
    for i in np.nonzero(hot)[0]:
        row = [0] + [e for e in idx[i] if e != 0]
        idx[i] = row[:cfg.n_experts_per_tok]
    return idx.astype(np.int32)


@pytest.mark.parametrize("n_ranks,t_all", [(2, 128), (4, 128), (2, 192)])
def test_v2_ranks_across_ranks_are_the_references(monkeypatch, n_ranks,
                                                  t_all):
    """Each rank's share of a global route list, ranked in the groups its
    tokens touch (`models.moe.groups_across`), gives the reference's
    `_dispatch_onehot` ranks and keeps for its tokens, and its dispatch
    of its own tokens (`_onehot_groups`) the reference's output rows."""
    cfg = get_smoke("granite-moe-3b-a800m", n_experts_padded=0)
    model = get_model(cfg, device="cpu")
    params = {k: v for k, v in model.init_params(0)["layers"]["moe"].items()}
    params = {k: v[0] for k, v in params.items() if k != "shared"}
    t = t_all // n_ranks
    tg = moe.group_size(cfg, t_all)
    assert t % tg, "the groups must straddle ranks"
    cap_g = moe._capacity(tg, cfg.n_experts_per_tok, cfg.capacity_factor,
                          cfg.n_experts)
    idx = _routes_with_ties(cfg, t_all)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((t_all, cfg.d_model)).astype(np.float32)
    w = rng.random((t_all, cfg.n_experts_per_tok)).astype(np.float32)
    # the reference's: its per-group ranking recorded at its first vmap
    seen = []
    vmap = jax.vmap

    def recording(fn, *a, **k):
        mapped = vmap(fn, *a, **k)

        def call(*args):
            out = mapped(*args)
            seen.append(out)
            return out
        return call
    monkeypatch.setattr(jax, "vmap", recording)
    j_params = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    want = np.asarray(j_moe._dispatch_onehot(
        j_get_smoke("granite-moe-3b-a800m", n_experts_padded=0,
                    param_dtype="float32", compute_dtype="float32"),
        j_params, jnp.asarray(x), jnp.asarray(w), jnp.asarray(idx),
        None, None, None))
    monkeypatch.setattr(jax, "vmap", vmap)
    ref_rank, ref_keep = (np.asarray(a).reshape(t_all, -1)
                          for a in seen[0])
    assert not ref_keep.all()               # the capacity edge is met
    every = torch.from_numpy(idx).long()
    for r in range(n_ranks):
        idx_g, rank_g, keep_g, lo = moe.groups_across(
            cfg, every, r * t, t, tg, cap_g)
        rank_l = rank_g.reshape(-1, idx.shape[1])[lo:lo + t]
        keep_l = keep_g.reshape(-1, idx.shape[1])[lo:lo + t]
        np.testing.assert_array_equal(rank_l.numpy(),
                                      ref_rank[r * t:(r + 1) * t])
        np.testing.assert_array_equal(keep_l.numpy(),
                                      ref_keep[r * t:(r + 1) * t])
        g = idx_g.shape[0]
        hi = g * tg - lo - t
        pad = torch.nn.functional.pad
        y = moe._onehot_groups(
            cfg, params,
            pad(torch.from_numpy(x[r * t:(r + 1) * t]),
                (0, 0, lo, hi)).reshape(g, tg, -1),
            pad(torch.from_numpy(w[r * t:(r + 1) * t]),
                (0, 0, lo, hi)).reshape(g, tg, -1),
            idx_g, rank_g, keep_g, cap_g)
        np.testing.assert_allclose(
            y.reshape(g * tg, -1)[lo:lo + t].detach().numpy(),
            want[r * t:(r + 1) * t], rtol=1e-5, atol=1e-6)


EXTENTS = (2, 3, 4, 8, 16)


@pytest.mark.parametrize("m", EXTENTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_every_full_config_builds_at_every_model_extent(arch, m):
    """`make_train_step` and every serving cell the reference runs
    (`launch.cells.cell_supported`) build for the full config at a
    "model" extent of ``m`` on each rank's coordinate: no refusal of a
    block "model" does not divide, nor of a V2 group across ranks."""
    cfg = get_config(arch)
    model = get_model(cfg, device="cpu")
    for index in (0, m - 1):
        make_train_step(model, TrainConfig(), _FakeMesh((1, m), index))
    for shape in SHAPES.values():
        if shape.kind == "train" or not cells.cell_supported(cfg,
                                                             shape)[0]:
            continue
        for mesh in ((1, m), (2, m)):
            cell = cells.make_cell(cfg, shape, _FakeMesh(mesh, m - 1),
                                   device="cpu")
            assert cell.step is not None
