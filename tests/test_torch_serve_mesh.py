"""The port's serving cells on a (data, model) mesh over CPU ranks (gloo).

On meshes (1, 2), (2, 1), (2, 2) and (1, 4), for the f32 smoke config
of every family (gemma3-1b: one KV head for all, a sliding window of 8;
qwen3-8b: 2 KV heads, shared by two ranks at "model" 4; mamba2-130m;
zamba2-1.2b; granite-moe V2 with its dead experts; deepseek-v2 with MLA
under FSDP, its experts V2 and V1; seamless with its cross-attention cache;
qwen2-vl with M-RoPE), through tools/dist_serve_cells.py's `f32_case`:
the smoke parameters of seed 0 and a prompt of (4, 16), the same on
every rank, which computes the one-card run itself
(`make_prefill_step` and `make_serve_step` without a mesh, which
tests/test_torch_lm.py and the other model tests hold to the live JAX
reference):

- the prefill cell (`launch.cells.make_cell`) against one card's
  prefill: tokens equal, logits within 1e-5 of the largest, each rank's
  part of the cache (the prefill cell's layout) within 1e-5 of each
  leaf's largest entry (the tensor-parallel products round otherwise:
  2.8e-6 read at worst);
- `runtime.param_sharding.relayout` of that cache, grown to 32
  positions, into the decode cell's layout: exact, against the decode
  layout's parts of the whole cache;
- four decode steps of the decode cell, its cache split along its
  sequence over "model", from the one card's grown cache: tokens equal
  at every step, logits and the final cache as above (gemma3's local
  layers meet blocks of positions that their window masks whole);
- at (2, 2), batch 1 with "seq" over ("data", "model"): zamba2 and
  gemma3;
- granite-moe V2 and deepseek-v2 V2 on a "data" extent of 2, their
  dispatch groups straddling the "data" ranks' rows (once refused,
  ROADMAP A.4.8), held as every other case;
- where "model" does not divide their heads, qwen3 with 3 heads and one
  KV head, with and without ``attn_batch_fallback``, at a global batch
  of 2 d m rows (the attention whole on every rank, or its rows split
  over "model");
- at (1, 4), three faults that the check must catch: the partial
  softmaxes combined without their max rescale, the new K/V written on
  every rank rather than the owner of its position, and the greedy
  token taken over the rank's vocabulary slice.

Each reading is the worst over the ranks. The meshes of each world size
run in one spawn of gloo ranks (tests/torch_dist_ranks.py).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch_dist_ranks import (  # noqa: E402
    join_ranks, serve_rank, serve_tool, start_ranks)

from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.data.batches import synth_train_batch  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

TOOL = serve_tool()
WORLDS = {2: [(1, 2), (2, 1)], 4: [(2, 2), (1, 4)]}
FAULTS_AT = (1, 4)
JOBS = [(shape, job) for shapes in WORLDS.values() for shape in shapes
        for job in TOOL.f32_jobs(shape, faults=shape == FAULTS_AT)]


def _id(shape, job):
    name, _, _, batch, fault = job
    return (f"{name}-{shape[0]}x{shape[1]}"
            + ("-batch1" if batch == 1 else "") + (f"-{fault}" if fault
                                                   else ""))


def _reference(name, batch):
    """The reference's f32 run of the tool's case ``name`` at ``batch``
    (`reference_run`)."""
    return reference_run(*TOOL.case_of(name), batch)


def reference_run(arch, over, batch):
    """The reference's f32 run of ``arch`` (``over`` on its smoke
    config) at ``batch``, as the tool's `f32_case` runs it (the port's
    smoke parameters of seed 0, carried leaf by leaf into the
    reference's tree, and its prompt of seed 1): the prefill's last
    logits, then STEPS greedy decode steps (jitted), each step's logits;
    and the greedy tokens (numpy)."""
    cfg = TOOL._cfg(arch, over)
    flat = dict(tree.items(get_model(cfg, device="cpu").init_params(0)))
    prompt = synth_train_batch(cfg, batch, TOOL.PROMPT, seed=1)
    jmodel = j_get_model(j_get_smoke(arch, param_dtype="float32",
                                     compute_dtype="float32", **over))
    paths, treedef = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0)))
    keys = ["/".join(str(getattr(k, "key", k)) for k in path)
            for path, _ in paths]
    assert sorted(keys) == sorted(flat)
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(flat[key].numpy(), dtype=leaf.dtype)
        for key, (_, leaf) in zip(keys, paths)])
    logits, cache = jax.jit(jmodel.prefill)(
        params, {k: jnp.asarray(v.numpy()) for k, v in prompt.items()})
    audio = cfg.family == "audio"
    if not audio:
        cache = j_serve._grow_cache(jmodel, cache, TOOL.MAX_LEN)
    lengths = jnp.full((batch,), 1 if audio else TOOL.PROMPT, jnp.int32)
    step = jax.jit(jmodel.decode_step)
    out = dict(prefill=np.asarray(logits[:, -1]), decode=[])
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    out["tokens"] = [np.asarray(tok)]
    for _ in range(TOOL.STEPS):
        logits, cache = step(params, tok[:, None], cache, lengths)
        out["decode"].append(np.asarray(logits[:, -1]))
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        out["tokens"].append(np.asarray(tok))
        lengths = lengths + 1
    return out


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """{"readings": {job id: reading}, "references": {(case, batch):
    `_reference`}}: the worlds spawned together, the references made
    while their ranks run."""
    handles = {w: start_ranks(serve_rank, w,
                              tmp_path_factory.mktemp(f"serve{w}"),
                              shapes, FAULTS_AT, shape=shapes[0])
               for w, shapes in WORLDS.items()}
    refs = {(j[0], j[3]): None for _, j in JOBS if j[4] is None}
    refs = {key: _reference(*key) for key in refs}
    out = {}
    for w, handle in handles.items():
        for shape, got in join_ranks(handle)[0].items():
            for job, r in zip(TOOL.f32_jobs(shape, shape == FAULTS_AT),
                              got):
                out[_id(shape, job)] = r
    return dict(readings=out, references=refs)


@pytest.fixture(scope="module")
def readings(started):
    """{job id: rank 0's reading (the worst over the ranks)}."""
    return started["readings"]


CELLS = [(s, j) for s, j in JOBS if j[4] is None]
SERVED = CELLS
FAULTY = [(s, j) for s, j in JOBS if j[4] is not None]


@pytest.mark.parametrize("shape,job", CELLS,
                         ids=[_id(s, j) for s, j in CELLS])
def test_cells_match_one_card(readings, shape, job):
    r = readings[_id(shape, job)]
    assert "refused" not in r, r["refused"]
    assert r["seq_axes"] == (["data", "model"] if job[3] == 1
                             else ["model"])
    assert r["relayout_exact"]
    for phase in ("prefill", "decode"):
        got = r[phase]
        assert got["tokens_equal"], (phase, got)
        assert got["logits_err"] <= TOOL.LOGITS_TOL, (phase, got)
        assert got["cache_err"] <= TOOL.CACHE_TOL, (phase, got)
    assert r["ok"]


@pytest.mark.parametrize("shape,job", FAULTY,
                         ids=[_id(s, j) for s, j in FAULTY])
def test_faults_fail_the_check(readings, shape, job):
    """Each fault breaks the comparison that the unbroken cells pass at
    the same mesh (test_cells_match_one_card)."""
    r = readings[_id(shape, job)]
    assert "refused" not in r
    assert not r["ok"]
    assert not r["decode"]["tokens_equal"]
    assert r["decode"]["logits_err"] > 100 * TOOL.LOGITS_TOL


@pytest.mark.parametrize("shape,job", SERVED,
                         ids=[_id(s, j) for s, j in SERVED])
def test_cells_match_reference(started, shape, job):
    """Rank 0's cells against the reference's jitted prefill and decode
    on the same parameters and prompt: the greedy tokens equal, the
    logits (gathered over the vocabulary) within 1e-5 of the largest,
    on the batch rows the rank holds."""
    got = started["readings"][_id(shape, job)]["logits"]
    want = started["references"][job[0], job[3]]
    rows = got["rows"]
    for g, w in zip(got["tokens"], want["tokens"]):
        np.testing.assert_array_equal(g, w[rows])
    assert len(got["decode"]) == len(want["decode"]) == TOOL.STEPS
    for g, w in zip([got["prefill"]] + got["decode"],
                    [want["prefill"]] + want["decode"]):
        w = w[rows]
        np.testing.assert_allclose(
            g, w, rtol=0, atol=TOOL.LOGITS_TOL * np.abs(w).max())
