"""The port's cells (`launch.cells`) against the reference's, on the CPU
without ranks.

For every architecture of `configs` and every shape of `SHAPES`:
`parallel_for`, `cell_supported`, `count_params` and `model_flops`
equal the reference's; `input_specs` gives the reference's shapes and
dtypes leaf by leaf (``meta`` tensors against ShapeDtypeStructs); and on
meshes (16, 16), (2, 2), (1, 4) and the multi-pod (2, 16, 16) (the
reference's ``MULTI_POD_RULES``), the cache layouts of the prefill and
decode cells (`make_cell` over a mesh of no ranks: a group per axis of
None) name, dim by dim, the mesh axes that the reference's ``resolve``
gives each cache leaf under its own ``_mesh_binding`` (the reference's
``_cache_shardings`` without devices), every config built at every
mesh (those whose heads or widths "model" does not divide, once
refused, ROADMAP A.4.6, too: the SSM's states of such a block whole);
and at (2, 2) and (1, 16) the decode cells without
``seq_shard_decode`` (the cache's KV heads over "model") against the
reference's specs without ``seq_shard``.
Besides: `common.greedy_token` under a vocabulary split over two ranks
picks the lowest global id on a tie between their slices; decode
attention over a sequence split in two blocks, one of them masked
whole, combines to the attention over the whole cache; a group over
("data", "model") is the mesh's world in row-major order, and on a
(2, 2, 2) mesh the groups over ("pod", "data") and ("data", "model")
index the rank by its row-major coordinate over them (the groups made
once a mesh: one a pair of axes and coordinate on the third); the "seq"
rule follows ``ParallelConfig.seq_axes``; and without a mesh the
prefill and serve steps compute what they computed before the mesh
path (the model's prefill or decode step, then the argmax), bit for
bit.
"""

import functools

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import cells as j_cells  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.runtime import sharding as j_shlib  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES, ParallelConfig,  # noqa: E402
                                 get_config, get_smoke)
from repro_torch.configs import _ALIASES  # noqa: E402
from repro_torch.launch import cells  # noqa: E402
from repro_torch.launch.mesh import binding_for  # noqa: E402
from repro_torch.models import attention, common, get_model  # noqa: E402
from repro_torch.runtime import collectives  # noqa: E402
from repro_torch.runtime import sharding as shlib  # noqa: E402
from repro_torch.train.steps import (make_prefill_step,  # noqa: E402
                                     make_serve_step, serve_binding)

NAMES = [next(k for k, v in _ALIASES.items() if v == m) for m in ARCHS]
CELLS = [(a, s) for a in NAMES for s in SHAPES]
MESHES = [(16, 16), (2, 2), (1, 4), (2, 16, 16)]
_AXES = ("pod", "data", "model")


def _mesh_id(m):
    return "x".join(str(n) for n in m)


class _FakeMesh:
    """What the port's bindings read of a mesh of (data, model), or of
    (pod, data, model) for a shape of three, with no ranks: a group per
    axis of None and this rank's coordinates."""

    def __init__(self, shape, index=None):
        self.mesh_dim_names = _AXES[3 - len(shape):]
        self.mesh = torch.zeros(shape)
        self.index = dict(zip(self.mesh_dim_names, index or (0,) * 3))

    def get_group(self, name):
        return None

    def get_local_rank(self, name):
        return self.index[name]


class _FakeJMesh:
    """What the reference's ``_mesh_binding`` reads of a mesh."""

    def __init__(self, shape):
        self.axis_names = _AXES[3 - len(shape):]
        self.devices = np.empty(shape)


_J_COUNT_PARAMS = j_cells.count_params


@functools.lru_cache(maxsize=None)
def _j_count(arch):
    """The reference's `count_params` of ``arch``, once (its
    `model_flops` counts again at every call: it reads this, below)."""
    return _J_COUNT_PARAMS(j_get_config(arch))


def _j_flat(t, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(t, is_leaf=is_leaf)
    return {"/".join(str(getattr(k, "key", k)) for k in p): v
            for p, v in flat}


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_choices_and_counts_equal_the_reference(monkeypatch, arch, shape):
    cfg, j_cfg = get_config(arch), j_get_config(arch)
    got, want = (cells.parallel_for(cfg, SHAPES[shape]),
                 j_cells.parallel_for(j_cfg, J_SHAPES[shape]))
    assert (got.fsdp, got.pod_axis_role, got.seq_shard_decode,
            got.seq_axes) == (want.fsdp, want.pod_axis_role,
                              want.seq_shard_decode, want.seq_axes)
    assert cells.cell_supported(cfg, SHAPES[shape]) == \
        j_cells.cell_supported(j_cfg, J_SHAPES[shape])
    monkeypatch.setattr(j_cells, "count_params",
                        lambda c: _j_count(c.name))
    assert cells.count_params(cfg) == _j_count(arch)
    assert cells.model_flops(cfg, SHAPES[shape]) == \
        j_cells.model_flops(j_cfg, J_SHAPES[shape])


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32}


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_input_specs_equal_the_reference(arch, shape):
    got = dict(tree.items(cells.input_specs(get_config(arch),
                                            SHAPES[shape])))
    want = _j_flat(j_cells.input_specs(j_get_config(arch),
                                       J_SHAPES[shape]))
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].device.type == "meta", k
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert got[k].dtype == _DTYPES[str(w.dtype)], k


def _want_cache(arch, shape, mesh, seq_sharded):
    """The reference's resolved spec of each cache leaf of the cell (with
    ``seq_sharded`` False for a decode cell: the cache without
    ``seq_shard``)."""
    cfg, sh = j_get_config(arch), J_SHAPES[shape]
    model = j_get_model(cfg)
    parallel = j_cells.parallel_for(cfg, sh)
    abstract = j_cells._abstract_cache(model, cfg, sh.global_batch,
                                       sh.seq_len)
    logical = model.cache_specs(seq_sharded=seq_sharded)
    with j_shlib.use_binding(j_cells._mesh_binding(_FakeJMesh(mesh),
                                                   parallel)):
        specs = jax.tree.map(
            lambda ax, leaf: tuple(j_shlib.resolve(leaf.shape, *ax)),
            logical, abstract, is_leaf=lambda x: isinstance(x, tuple) and
            all(a is None or isinstance(a, (str, tuple)) for a in x))
    return _j_flat(specs, is_leaf=lambda x: isinstance(x, tuple))


# the serving cells the reference runs (`cell_supported`)
SERVING = [(a, s) for a, s in CELLS if SHAPES[s].kind != "train"
           and cells.cell_supported(get_config(a), SHAPES[s])[0]]


def _held_to(layout, want, cfg, mesh):
    """``layout`` (a tree of `Parts`) names the axes of ``want``, the
    reference's specs (the SSM's states of a block whose heads "model"
    does not divide whole, as the port runs such a block), and splits
    exactly the dims whose axes are wider than one."""
    from repro_torch.runtime.param_sharding import tp_layout
    got = {k: v.spec for k, v in tree.items(layout)}
    if tp_layout(cfg, mesh[-1]).get("ssm") == "whole":
        want = {k: tuple(None if e == "model" else e for e in v)
                if k.endswith(("conv", "ssm")) else v
                for k, v in want.items()}
    assert got == want
    sizes = dict(zip(_AXES[3 - len(mesh):], mesh))
    for k, parts in tree.items(layout):
        wide = [i for i, e in enumerate(parts.spec) if e is not None and
                np.prod([sizes[a] for a in ((e,) if isinstance(e, str)
                                             else e)]) > 1]
        assert [p.dim for p in parts.parts] == wide, k


@pytest.mark.parametrize("mesh", MESHES, ids=_mesh_id)
@pytest.mark.parametrize("arch,shape", SERVING,
                         ids=[f"{a}-{s}" for a, s in SERVING])
def test_cache_layouts_name_the_reference_axes(arch, shape, mesh):
    """Every cell is built, those whose heads or widths "model" does not
    divide too (once refused, ROADMAP A.4.6): the SSM's states of a
    block whose heads it does not divide are whole on every rank (the
    port runs such a block whole), where the reference's resolve may
    still split their flat width."""
    cfg = get_config(arch)
    cell = cells.make_cell(cfg, SHAPES[shape], _FakeMesh(mesh),
                           device="cpu")
    decode = SHAPES[shape].kind == "decode"
    layout = cell.in_layouts[2] if decode else cell.out_layouts[1]
    _held_to(layout, _want_cache(arch, shape, mesh, decode), cfg, mesh)


DECODING = [(a, s) for a, s in SERVING if SHAPES[s].kind == "decode"]
KV_MESHES = [(2, 2), (1, 16)]


@pytest.mark.parametrize("mesh", KV_MESHES, ids=_mesh_id)
@pytest.mark.parametrize("arch,shape", DECODING,
                         ids=[f"{a}-{s}" for a, s in DECODING])
def test_kv_heads_cache_layouts_name_the_reference_axes(arch, shape, mesh):
    """A decode cell without ``seq_shard_decode`` (`make_cell` given
    that ``parallel``) keeps the prefill cell's cache: its KV heads over
    "model" where "model" divides them, every position; the reference's
    ``cache_specs`` without ``seq_shard`` under its ``_mesh_binding``."""
    import dataclasses
    cfg = get_config(arch)
    parallel = dataclasses.replace(cells.parallel_for(cfg, SHAPES[shape]),
                                   seq_shard_decode=False)
    cell = cells.make_cell(cfg, SHAPES[shape], _FakeMesh(mesh),
                           device="cpu", parallel=parallel)
    assert not cell.step.binding.seq_sharded
    _held_to(cell.in_layouts[2], _want_cache(arch, shape, mesh, False),
             cfg, mesh)


def test_long_context_cells_skip_as_the_reference():
    """The cells the layout test leaves out are those `cell_supported`
    and the reference's refuse: long_500k of a pure full-attention
    arch."""
    skipped = [a for a in NAMES
               if not cells.cell_supported(get_config(a),
                                           SHAPES["long_500k"])[0]]
    assert sorted(skipped) == sorted(
        a for a in NAMES if not j_cells.cell_supported(
            j_get_config(a), J_SHAPES["long_500k"])[0])
    assert "zamba2-1.2b" not in skipped and "gemma3-1b" not in skipped


def _ranks_of(monkeypatch, fn, n):
    """``fn(rank)`` on each of ``n`` ranks of a mesh (1, n) without
    processes: `collectives.gathered` hands each the stack of what every
    rank passed it, from a first pass that recorded them."""
    sent = {}
    out = []
    for stage in ("record", "run"):
        out = []
        for r in range(n):
            def gathered(t, axis, r=r):
                sent.setdefault(stage, {})[r] = t
                if stage == "record":
                    return torch.stack([t] * axis.extent)
                return torch.stack([sent["record"][i]
                                    for i in range(axis.extent)])
            monkeypatch.setattr(collectives, "gathered", gathered)
            binding = binding_for(_FakeMesh((1, n), (0, r)))
            with shlib.use_binding(binding):
                out.append(fn(r))
    return out


def test_greedy_token_lowest_id_on_a_tie_across_ranks(monkeypatch):
    cfg = get_smoke("qwen3-8b")                 # vocabulary 256
    v = cfg.vocab_size
    logits = torch.randn(3, v)
    logits[0, 7] = logits[0, v // 2 + 3] = 10.0      # a tie across slices
    logits[1, v // 2 + 5] = logits[1, v // 2 + 9] = 10.0  # within one
    logits[2, v - 1] = 10.0
    embed = {"embedding": torch.zeros(v // 2, 8)}    # a vocabulary slice

    def pick(r):
        part = logits[:, r * (v // 2):(r + 1) * (v // 2)]
        return common.greedy_token(part, embed, cfg)
    got = _ranks_of(monkeypatch, pick, 2)
    want = torch.argmax(logits, dim=-1).to(torch.int32)
    assert want.tolist() == [7, v // 2 + 5, v - 1]
    for g in got:
        assert torch.equal(g, want)


def test_flash_decode_masked_block_adds_nothing(monkeypatch):
    """Decode attention over a cache split in two blocks of positions
    (rank r holds [8r, 8r + 8)), every slot's positions within the first
    block (the second masked whole), and a window of 5 that masks part
    of the first: each rank's partial combined over both
    (`attention.combine_partials`, one all-gather) is the attention over
    the whole cache."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 1, 4, 16, generator=gen)
    k = torch.randn(2, 16, 2, 16, generator=gen)
    v = torch.randn(2, 16, 2, 16, generator=gen)
    lengths = torch.tensor([3, 7], dtype=torch.int32)
    want = attention.decode_attention(q, k, v, lengths, window=5)
    sent = {}

    def run(stage):
        outs = []
        for r in range(2):
            axis = shlib.AxisGroup("g", 2, r, ("model",))

            def gathered(t, axis, r=r):
                sent.setdefault(stage, {})[r] = t
                if stage == "record":
                    return torch.stack([t] * axis.extent)
                return torch.stack([sent["record"][i]
                                    for i in range(axis.extent)])
            monkeypatch.setattr(collectives, "gathered", gathered)
            outs.append(attention.decode_attention(
                q, k[:, 8 * r:8 * r + 8], v[:, 8 * r:8 * r + 8], lengths,
                window=5, seq=axis))
        return outs
    run("record")
    got = run("run")
    # the second block is masked whole: its max, the last entry of its
    # partial, is near NEG_INF, so its weight is exactly 0
    assert float(sent["record"][1][..., -1].max()) < -1e29
    for g in got:
        torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-6)


def test_group_over_data_and_model_is_the_world_in_row_major():
    for d, m in ((0, 0), (0, 1), (1, 0), (1, 1)):
        b = binding_for(_FakeMesh((2, 2), (d, m)))
        axis = b.axis_group(("data", "model"))
        assert (axis.extent, axis.index, axis.axes) == (
            4, 2 * d + m, ("data", "model"))
    # on a (2, 2, 2) mesh: the row-major coordinate over the group's
    # axes (pod-major over ("pod", "data"), as the reference lays a dim)
    for p in (0, 1):
        for d in (0, 1):
            for m in (0, 1):
                b = binding_for(_FakeMesh((2, 2, 2), (p, d, m)))
                assert b.rules["batch"] == ("pod", "data")
                batch = b.axis_group(b.rules["batch"])
                assert (batch.extent, batch.index, batch.axes) == (
                    4, 2 * p + d, ("pod", "data"))
                seq = b.axis_group(("data", "model"))
                assert (seq.extent, seq.index, seq.axes) == (
                    4, 2 * d + m, ("data", "model"))
                every = b.axis_group(("pod", "data", "model"))
                assert (every.extent, every.index) == (8, 4 * p + 2 * d + m)
    with pytest.raises(NotImplementedError, match="another order"):
        binding_for(_FakeMesh((2, 2))).axis_group(("model", "data"))


def test_axis_groups_of_a_2x2x2_mesh(monkeypatch):
    """`runtime.sharding.make_axis_groups` on a (2, 2, 2) mesh (every
    rank making every group, `dist.new_group` recorded): one group for
    each pair of axes and each coordinate on the third, its ranks in
    row-major order over the pair; rank 5 (pod 1, data 0, model 1) keeps
    the groups it belongs to, and `Binding.axis_group` takes them with
    the rank's index among their ranks."""
    import torch.distributed as dist
    made = []
    monkeypatch.setattr(dist, "new_group",
                        lambda ranks: made.append(tuple(ranks)) or made[-1])
    monkeypatch.setattr(dist, "get_rank", lambda: 5)
    mesh = _FakeMesh((2, 2, 2), (1, 0, 1))
    mesh.mesh = torch.arange(8).view(2, 2, 2)
    groups = shlib.make_axis_groups(mesh)
    assert made == [(0, 2, 4, 6), (1, 3, 5, 7),      # ("pod", "data")
                    (0, 1, 4, 5), (2, 3, 6, 7),      # ("pod", "model")
                    (0, 1, 2, 3), (4, 5, 6, 7)]      # ("data", "model")
    assert groups == {("pod", "data"): (1, 3, 5, 7),
                      ("pod", "model"): (0, 1, 4, 5),
                      ("data", "model"): (4, 5, 6, 7)}
    mesh.axis_groups = groups
    b = binding_for(mesh)
    for axes in groups:
        axis = b.axis_group(axes)
        assert axis.group == groups[axes]
        assert axis.group[axis.index] == 5


def test_seq_rule_follows_seq_axes():
    """`launch.mesh.binding_for` keeps the reference's "seq" rule; the
    serving steps' binding (`train.steps.serve_binding`) binds it as the
    reference's cells do (``_mesh_binding``): to the ``seq_axes`` that
    the mesh has and the batch leaves it."""
    model = get_model(get_smoke("qwen3-8b"), device="cpu")
    mesh = _FakeMesh((2, 2))
    assert binding_for(mesh).rules["seq"] == ("data",)

    def seq(seq_axes, batch):
        parallel = ParallelConfig(seq_shard_decode=True, seq_axes=seq_axes)
        return serve_binding(model, mesh, parallel, batch,
                             decode=True).rules["seq"]
    assert seq(("model",), 4) == ("model",)
    assert seq(("data", "model"), 1) == ("data", "model")
    assert seq(("data", "model"), 4) == ("model",)   # "data" holds rows
    assert seq(("pod", "model"), 4) == ("model",)


def test_serving_steps_on_a_mesh_take_the_cells_choices():
    """On a mesh the serving steps take the cell's ``parallel`` and
    global batch (`launch.cells.make_cell`); a decode step whose
    ``parallel`` does not split the cache's sequence is built, its cache
    the prefill cell's (its KV heads over "model"): no flash-decode."""
    model = get_model(get_smoke("qwen3-8b"), device="cpu")
    mesh = _FakeMesh((1, 2))
    decode = ParallelConfig(seq_shard_decode=True)
    with pytest.raises(TypeError, match="make_cell"):
        make_prefill_step(model, mesh)
    with pytest.raises(TypeError, match="make_cell"):
        make_serve_step(model, mesh, decode)
    kv = make_serve_step(model, mesh, ParallelConfig(), 4).binding
    assert not kv.seq_sharded
    with shlib.use_binding(kv):
        assert shlib.seq_axis() is None
        assert shlib.model_axis().extent == 2
    assert make_serve_step(model, mesh, decode, 4).binding.seq_sharded
    assert not make_prefill_step(model, mesh, decode,
                                 4).binding.seq_sharded


@pytest.mark.parametrize("arch", ["gemma3-1b", "zamba2-1.2b",
                                  "deepseek-v2-236b",
                                  "seamless-m4t-large-v2"])
def test_steps_without_a_mesh_are_unchanged(arch):
    """`make_prefill_step` / `make_serve_step` without a mesh: the
    model's prefill or decode step, then ``torch.argmax`` over the
    last position's logits (as they were before the mesh path), bit for
    bit."""
    from repro_torch.data.batches import synth_train_batch
    from repro_torch.launch.serve import _grow_cache
    cfg = get_smoke(arch)
    model = get_model(cfg, device="cpu")
    params = model.init_params(0)
    batch = synth_train_batch(cfg, 2, 16, seed=3)
    tok, cache = make_prefill_step(model)(params, batch)
    with torch.no_grad():
        logits, want_cache = model.prefill(params, batch)
    assert torch.equal(tok, torch.argmax(logits[:, -1], -1).to(torch.int32))
    for a, b in zip(tree.leaves(cache), tree.leaves(want_cache)):
        assert torch.equal(a, b)
    if cfg.family != "audio":
        cache = _grow_cache(model, cache, 24)
    lengths = torch.full((2,), 1 if cfg.family == "audio" else 16,
                         dtype=torch.int32)
    mine = tree.map_(lambda t: t.clone(), cache)
    got, got_cache, got_len = make_serve_step(model)(
        params, tok[:, None], cache, lengths)
    with torch.no_grad():
        logits, want_cache = model.decode_step(params, tok[:, None], mine,
                                               lengths)
    assert torch.equal(got, torch.argmax(logits[:, -1], -1).to(
        torch.int32)[:, None])
    assert torch.equal(got_len, lengths + 1)
    for a, b in zip(tree.leaves(got_cache), tree.leaves(want_cache)):
        assert torch.equal(a, b)
