"""The port on a (pod, data, model) mesh over CPU ranks (gloo): the
"pod" axis as data, under the reference's ``MULTI_POD_RULES``.

One spawn of world 4 (tests/torch_dist_ranks.py::pod_rank) runs, in
order, the meshes (2, 2, 1), (2, 1, 2), (4, 1) and (2, 2) on the same
ranks; the reference's initial states and jitted steps are made once a
config, on threads of their own, while the ranks run.

- Train steps 1 and 2 with FSDP (its blocks over ("pod", "data")) of
  gemma3-1b, granite-moe without its dead experts (V2, its dispatch
  groups across the ranks of ("pod", "data")) and deepseek-v2 (MLA, a
  shared expert), from the reference's initial parameters on
  TokenDataset batches, each rank holding the rows of its pod-major
  coordinate over ("pod", "data"). At (2, 2, 1) and (2, 1, 2) each is
  held to the port's single-process step and to the reference's jitted
  single-device step, each from the state its step started from (step
  2 from the mesh's own step-1 state): metrics within rtol 1e-5, states
  within 1e-5 off the sign-trap and knee entries, with the MoE near-tie
  guard (ROADMAP C), as tests/test_torch_fsdp.py holds them; and to the
  same world's step on the 2-D mesh of the same math ((4, 1) for
  (2, 2, 1), (2, 2) for (2, 1, 2)): metrics and every leaf within
  relative 1e-6 (of the leaf's largest entry).
- A fault the comparison must catch: at (2, 2, 1) the gradients summed
  over "data" alone, not over ("pod", "data").
- The int8 mean (`optim.compress`) over ("pod", "data") at (2, 2, 1):
  bit for bit the reference's over "data" on the world-4 inputs of
  tests/test_torch_compress.py.
- The serving cells through tools/dist_serve_cells.py's `f32_rank` at
  (2, 2, 1) and (2, 1, 2): qwen3 and zamba2 at batch 4 (rows over
  ("pod", "data")) and at batch 1 ("seq" over ("data", "model"),
  replicated over "pod"); the decode cells without ``seq_shard_decode``
  of qwen3 (2 KV heads, one a rank at "model" 2), gemma3 (one KV head,
  whole on every rank) and seamless (its cross-attention cache): the
  prefill cell, relayout and four decode steps held to one card's
  (tokens equal; logits and caches within 1e-5 of the largest entry).
  At (2, 1, 2) the fault that writes head block 0's new K/V (rank 0's)
  into every rank's cache fails the check.
- A `train_loop` with FSDP saved at (2, 2, 1): restored at (4, 1) with
  FSDP (split, gathered again) and at one process, it is the saved
  state bit for bit; the reference's ``checkpoint.restore`` reads it.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import checkpoint as j_checkpoint  # noqa: E402
from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.train import steps as j_steps  # noqa: E402

from repro_torch import checkpoint, tree  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models.api import family_module  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

from test_torch_compress import _flat, _inputs  # noqa: E402
from test_torch_compress import _reference as _compress_reference  # noqa: E402,E501
from test_torch_dist_train import _npz, _ref_init  # noqa: E402
from test_torch_fsdp import (  # noqa: E402
    STEPS, _held, _init_flat, _port_step, _ref_step)
from test_torch_train_models import _states_close  # noqa: E402
from torch_dist_ranks import (  # noqa: E402
    LOOP_ARCH, POD_LOOP, POD_MESHES, join_ranks, pod_rank, serve_tool,
    start_ranks)

SMALL = (4, 16)
# name: (arch, overrides, global batch)
CASES = {
    "gemma3": ("gemma3-1b", {}, SMALL),
    "granite-v2": ("granite-moe-3b-a800m", {"n_experts_padded": 0},
                   (8, 128)),
    "deepseek": ("deepseek-v2-236b", {}, (4, 128)),
}
PODS = [s for s in POD_MESHES if len(s) == 3]
FLAT = {(2, 2, 1): (4, 1), (2, 1, 2): (2, 2)}
PAIRS = [(c, m) for c in sorted(CASES) for m in PODS]
IDS = [f"{c}-{'x'.join(map(str, m))}" for c, m in PAIRS]
TOOL = serve_tool()
SERVE = [(m, job) for m in PODS for job in TOOL.f32_jobs(m)]


def _serve_id(mesh, job):
    name, _, _, batch, fault = job
    return ("x".join(map(str, mesh)) + f"-{name}"
            + ("-batch1" if batch == 1 else "")
            + (f"-{fault}" if fault else ""))


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The world-4 spawn, started before the single-device runs so that
    all proceed together."""
    from concurrent.futures import ThreadPoolExecutor
    root = tmp_path_factory.mktemp("pod_loop")
    with ThreadPoolExecutor(len(CASES)) as pool:
        inits = dict(zip(CASES, pool.map(lambda c: _ref_init(*c[:2])[1],
                                         CASES.values())))
    cases = {name: dict(arch=arch, overrides=over, shape=shape,
                        steps=STEPS, init=inits[name])
             for name, (arch, over, shape) in CASES.items()}
    per_rank = _inputs(4)
    return dict(root=root, per_rank=per_rank,
                handle=start_ranks(pod_rank, 4,
                                   tmp_path_factory.mktemp("pod4"), cases,
                                   root, per_rank, shape=(2, 2, 1)))


@pytest.fixture(scope="module")
def single(started):
    """Per case: the port's single-process step 1 from the reference's
    initial parameters, with the routes it took, and the reference's
    step 1 (on threads while the ranks run)."""
    from concurrent.futures import ThreadPoolExecutor

    def ref(name):
        arch, over, shape = CASES[name]
        return _ref_step(arch, over, shape,
                         _init_flat(_ref_init(arch, over)[1]), 1)
    with ThreadPoolExecutor(len(CASES)) as pool:
        refs = pool.map(ref, CASES)
        ports = [_port_step(arch, over, shape,
                            _init_flat(_ref_init(arch, over)[1]), 1)
                 for arch, over, shape in CASES.values()]
        return {name: dict(port=port, ref=r)
                for name, port, r in zip(CASES, ports, refs)}


@pytest.fixture(scope="module")
def ranks(started, single):
    """Rank 0's {mesh shape: results}, and every rank's int8 means."""
    got = join_ranks(started["handle"])
    return dict(meshes=got[0]["meshes"],
                compress=[g["compress"] for g in got])


@pytest.fixture(scope="module")
def second(ranks):
    """Per (case, pod mesh): the port's single-process step 2 and the
    reference's, each from the mesh's own step-1 state."""
    out = {}
    for case, mesh in PAIRS:
        arch, over, shape = CASES[case]
        flat = ranks["meshes"][mesh][case][0][1]
        out[case, mesh] = (_port_step(arch, over, shape, flat, 2),
                           _ref_step(arch, over, shape, flat, 2))
    return out


@pytest.mark.parametrize("case,mesh", PAIRS, ids=IDS)
def test_pod_step_matches_single_process(single, ranks, second, case,
                                         mesh):
    _held(ranks["meshes"][mesh][case], single[case]["port"],
          second[case, mesh][0])


@pytest.mark.parametrize("case,mesh", PAIRS, ids=IDS)
def test_pod_step_matches_reference(single, ranks, second, case, mesh):
    one = single[case]
    port, ref = second[case, mesh]
    runs = ranks["meshes"][mesh][case]
    _held(runs, one["port"], port, (one["ref"], ref))
    assert int(runs[-1][1]["opt/step"]) == STEPS


@pytest.mark.parametrize("case,mesh", PAIRS, ids=IDS)
def test_pod_step_matches_the_flat_mesh(ranks, case, mesh):
    """(2, 2, 1) is (4, 1) and (2, 1, 2) is (2, 2) with the rows over
    ("pod", "data") in the same pod-major order: both steps' metrics and
    whole states within relative 1e-6 of the 2-D mesh's run."""
    got = ranks["meshes"][mesh][case]
    want = ranks["meshes"][FLAT[mesh]][case]
    assert len(got) == len(want) == STEPS
    for (m_got, s_got), (m_want, s_want) in zip(got, want):
        for k, w in m_want.items():
            assert abs(m_got[k] - w) <= 1e-6 * max(abs(w), 1e-30), k
        assert set(s_got) == set(s_want)
        for k, w in s_want.items():
            w = np.asarray(w, np.float64)
            np.testing.assert_allclose(
                np.asarray(s_got[k], np.float64), w, rtol=0,
                atol=1e-6 * max(np.abs(w).max(), 1e-30), err_msg=k)


def test_pod_unsummed_fails_the_comparison(single, ranks, second):
    """The gradients summed over "data" alone at (2, 2, 1) (each pod's
    half of the batch) fail the comparison that the unbroken step
    passes."""
    mesh = (2, 2, 1)
    first = single["gemma3"]["port"]
    _held(ranks["meshes"][mesh]["gemma3"], first,
          second["gemma3", mesh][0])
    bad = ranks["meshes"][mesh]["pod_unsummed"]
    assert len(bad) == 1
    with pytest.raises(AssertionError):
        _states_close(bad[0][1], first["state"], [first], 1e-5)


def test_int8_mean_over_pod_and_data(started, ranks):
    """Every rank's mean and residual over ("pod", "data") at (2, 2, 1)
    equal the reference's over "data" on the same world-4 inputs, bit
    for bit."""
    mean, mean_r, new_r = _compress_reference(started["per_rank"])
    got = ranks["compress"]
    assert len(got) == 4
    for r, have in enumerate(got):
        for name, ref in (("mean", mean), ("mean_r", mean_r),
                          ("residual", new_r)):
            want = _flat(jax.tree.map(lambda x: x[r], ref))
            mine = _flat(have[name])
            assert set(mine) == set(want)
            for k in want:
                assert np.array_equal(mine[k], want[k]), (name, r, k)


@pytest.mark.parametrize("mesh,job", SERVE,
                         ids=[_serve_id(m, j) for m, j in SERVE])
def test_pod_serving_cells(ranks, mesh, job):
    """Each serving case at the mesh against one card (worst over the
    ranks); the fault fails the check, by over 100 times the logits'
    limit."""
    r = ranks["meshes"][mesh]["serve"][TOOL.f32_jobs(mesh).index(job)]
    assert (r["name"], r["batch"], r["fault"]) == (job[0], job[3], job[4])
    assert "refused" not in r, r["refused"]
    assert r["kv_heads"] == job[0].endswith("-kv")
    if job[4] is not None:
        assert not r["ok"]
        assert r["decode"]["logits_err"] > 100 * TOOL.LOGITS_TOL
        return
    if not r["kv_heads"]:
        assert r["seq_axes"] == (["data", "model"] if job[3] == 1
                                 else ["model"])
    assert r["relayout_exact"]
    for phase in ("prefill", "decode"):
        got = r[phase]
        assert got["tokens_equal"], (phase, got)
        assert got["logits_err"] <= TOOL.LOGITS_TOL, (phase, got)
        assert got["cache_err"] <= TOOL.CACHE_TOL, (phase, got)
    assert r["ok"]


def _saved(started):
    return _npz(started["root"] / POD_LOOP / "step_00000002.npz")


def test_pod_save_restores_at_4x1(started, ranks):
    restored, n_split = ranks["meshes"][(4, 1)]["restored"]
    saved = _saved(started)
    assert n_split > 0
    assert set(restored) == set(saved)
    for k in saved:
        assert np.array_equal(restored[k], saved[k]), k
    assert len(ranks["meshes"][(2, 2, 1)]["uncut"]["metrics"]) == 4


def test_pod_save_restores_at_one_process(started, ranks):
    cfg = get_smoke(LOOP_ARCH, remat=True)
    spec = family_module(cfg).init_params(cfg, None, torch.device("meta"))
    state = checkpoint.restore(str(started["root"] / POD_LOOP), 2,
                               {"params": spec, "opt": adamw_init(spec)},
                               device="cpu")
    saved = _saved(started)
    got = {k: v.numpy() for k, v in tree.items(state)}
    assert set(got) == set(saved)
    for k in saved:
        assert np.array_equal(got[k], saved[k]), k


def test_reference_restores_a_pod_save(started, ranks):
    cfg = j_get_smoke(LOOP_ARCH)
    template = jax.eval_shape(
        lambda k: j_steps.init_train_state(j_get_model(cfg), k),
        jax.random.PRNGKey(0))
    got = j_checkpoint.restore(str(started["root"] / POD_LOOP), 2,
                               template)
    saved = _saved(started)
    flat, _ = jax.tree_util.tree_flatten_with_path(got)
    keys = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in flat}
    assert set(keys) == set(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(keys[k].astype(v.dtype), v, err_msg=k)


def test_cli_pod_needs_its_ranks(monkeypatch):
    """``--pod 2`` without ``--data`` of two or more ranks raises before
    any group starts."""
    from repro_torch.launch import train as train_cli
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr("sys.argv", ["train", "--arch", "gemma3-1b",
                                     "--smoke", "--device", "cpu",
                                     "--pod", "2"])
    with pytest.raises(ValueError, match="--pod 2 needs --data"):
        train_cli.main()
