"""The port's dry run (`launch.op_cost`, `launch.roofline`,
`launch.dryrun`) against the reference's ``hlo_cost``, ``hlo_analysis``
and ``dryrun``, on the CPU.

- Op costs: single-op programs (a dot, a batched einsum, an elementwise
  add, a sum over an axis, a slice, a gather) cost the FLOPs that
  ``hlo_cost.analyze`` gives the same op ``jax.jit``-compiled on the
  CPU, its ``bytes_min`` and ``gather_elems``, and its ``bytes`` where
  XLA leaves the op unfused (or its fusion's boundary is the op's).
- Dot FLOPs of whole steps: each family's smoke ``forward`` on one
  device (dense, MoE, MLA, the VLM, hybrid, SSM, enc-dec), one train
  step (dense, hybrid), one prefill and one decode step (dense): the
  port's ``matmul_flops`` against the dots of the reference's compiled
  module, each dot times the trip counts of its loops (its
  ``parse_module`` and ``_dot_flops``), within 1 %.
- `roofline.roofline_terms` and `dominant_term` against the reference's,
  scaled by the ratio of the constants.
- The peak of live bytes on ``meta`` tensors, by hand.
- In one subprocess (the fake process group is never started in a
  pytest worker's own process): a dense smoke cell's collective bytes
  by kind at (1, 2) and (2, 1) against a hand reckoning; under FSDP at
  (2, 1) the reduce-scattered gradients' bytes against the FSDP blocks;
  the prefill cache's relayout into the decode layout at (1, 2) (one
  all-to-all a layer for K and V, the decode layout's shapes); `dry_run` of a
  smoke cell at (2, 2) with every reference key, its argument bytes
  those of the rank parts taken rank by rank; ``run_cell`` of
  mamba2-130m's decode_32k at full size over 256 ranks; a full-attention
  arch at long_500k skipped with `cells.cell_supported`'s reason.
- The device rule: without CUDA and without a device the entry points
  raise; ``meta`` runs only where a caller names it.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.launch import cells as j_cells  # noqa: E402
from repro.launch import hlo_analysis, hlo_cost  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.train import steps as j_steps  # noqa: E402

from repro_torch.configs import TrainConfig, get_smoke  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.pipeline import resolve_device  # noqa: E402
from repro_torch.launch import cells, op_cost, roofline  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.train import steps  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L = 2, 64                      # the smoke steps' batch and length
DECODE_LEN = 256


# ---------------------------------------------------------------------------
# single ops
# ---------------------------------------------------------------------------


def _jit_cost(fn, *args):
    return hlo_cost.analyze(jax.jit(fn).lower(*args).compile().as_text())


def _port_cost(fn, *args):
    with op_cost.counting() as cost:
        fn(*args)
    return cost


_X = np.zeros((64, 32), np.float32)
_Y = np.zeros((32, 48), np.float32)
_A3 = np.zeros((4, 8, 16), np.float32)
_B3 = np.zeros((4, 16, 8), np.float32)
_IDX = np.zeros((16,), np.uint32)

# name, jax program, torch program, inputs, bytes compared (XLA leaves
# the op unfused, or its fusion's boundary is the op's operands and
# result); XLA:CPU wraps the slice and the gather in fusions that read
# the whole operand, so their bytes differ by design
SINGLE_OPS = [
    ("dot", lambda a, b: a @ b, lambda a, b: a @ b, (_X, _Y), True),
    ("batched einsum",
     lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
     lambda a, b: torch.einsum("bij,bjk->bik", a, b), (_A3, _B3), True),
    ("add", lambda a, b: a + b, lambda a, b: a + b, (_X, _X), True),
    ("sum over an axis", lambda a: a.sum(1), lambda a: a.sum(1), (_X,),
     True),
    ("slice", lambda a: a[:, 2:5], lambda a: a[:, 2:5].clone(), (_X,),
     False),
    ("gather", lambda a, i: jnp.take(a, i, axis=0, mode="clip"),
     lambda a, i: a[i.long()], (_X, _IDX), False),
]


@pytest.mark.parametrize("name,jfn,tfn,args,same_bytes", SINGLE_OPS,
                         ids=[s[0] for s in SINGLE_OPS])
def test_single_op_costs_match_hlo_cost(name, jfn, tfn, args, same_bytes):
    ref = _jit_cost(jfn, *(jnp.asarray(a) for a in args))
    got = _port_cost(tfn, *(torch.from_numpy(a.astype(np.int64)
                                             if a.dtype == np.uint32 else a)
                            for a in args))
    want_flops, want_bytes = ref.flops, ref.bytes
    if name == "sum over an axis":
        # XLA's reduce also takes its init value (one f32 scalar) as an
        # operand, and the reference costs its reducer's body (one
        # scalar add) once at the call site
        want_flops, want_bytes = want_flops - 1, want_bytes - 4
    assert got.flops == want_flops
    assert got.bytes_min == ref.bytes_min
    assert got.gather_elems == ref.gather_elems
    if same_bytes:
        assert got.bytes == want_bytes
    is_dot = name in ("dot", "batched einsum")
    assert got.matmul_flops == (got.flops if is_dot else 0.0)
    assert got.coll_bytes == 0 and got.coll_calls == 0


def test_peak_live_bytes_on_meta():
    """Views and in-place ops allocate nothing; a freed temporary leaves
    the live sum; the peak is the largest sum alive."""
    x = torch.empty(1000, device="meta")               # an argument
    with op_cost.counting() as cost:
        y = x * 2                                      # +4000
        y.add_(1)                                      # in place
        v = y.view(10, 100)                            # a view
        z = v + 1                                      # +4000: 8000
        del y, v                                       # 4000
        w = z.sum()                                    # +4: 4004
        u = x.clone()                                  # +4000: 8004
        s = u.view(10, 100) + z                        # +4000: 12004
    assert cost.temp_bytes == 12004                    # 16004 if y lived
    del w, s


# ---------------------------------------------------------------------------
# dot FLOPs of whole steps
# ---------------------------------------------------------------------------


def _ref_dot_flops(text: str) -> float:
    """The FLOPs of the dots of a compiled module, each dot times the
    trip counts of the loops around it (the reference's parse and its
    ``_dot_flops``; a conditional's largest branch)."""
    comps = hlo_cost.parse_module(text)
    entry = next(c for c in comps.values() if c.is_entry)
    memo = {}

    def cost(name):
        if name in memo:
            return memo[name]
        comp = comps.get(name)
        total = 0.0
        memo[name] = total
        if comp is None:
            return total
        for inst in comp.insts:
            if inst.op == "dot":
                total += hlo_cost._dot_flops(inst, comp)
            if not inst.called:
                continue
            if inst.is_cond:
                total += max(cost(b) for b in inst.called)
            else:
                trips = float(inst.trip) if inst.op == "while" else 1.0
                total += trips * sum(cost(c) for c in inst.called)
        memo[name] = total
        return total
    return cost(entry.name)


def _compiled(fn, *args) -> str:
    return jax.jit(fn).lower(*args).compile().as_text()


def _specs(arch, kind, seq):
    jspec = j_cells.input_specs(j_get_smoke(arch),
                                JShapeConfig("s", kind, seq, B))
    spec = cells.input_specs(get_smoke(arch), ShapeConfig("s", kind, seq, B))
    return jspec, spec


def _dead_cross_kv(cfg) -> float:
    """The decoder cross-attention's products of its own input by wk and
    wv, which both packages' attention computes and drops (the encoder's
    K/V replace them): XLA removes them as dead code, eager PyTorch
    runs them."""
    return (2 * 2.0 * B * L * cfg.d_model * cfg.n_kv_heads * cfg.head_dim
            * cfg.n_layers)


FORWARD_ARCHS = ["qwen3-8b", "granite-moe-3b-a800m", "deepseek-v2-236b",
                 "qwen2-vl-2b", "zamba2-1.2b", "mamba2-130m",
                 "seamless-m4t-large-v2"]


@pytest.mark.parametrize("arch", FORWARD_ARCHS)
def test_forward_dot_flops_match_reference(arch):
    jspec, spec = _specs(arch, "prefill", L)
    want = _ref_dot_flops(_compiled(j_get_model(j_get_smoke(arch)).forward,
                                    jspec["params"], jspec["batch"]))
    model = get_model(get_smoke(arch), device="meta")
    with torch.no_grad(), op_cost.counting() as cost:
        model.forward(spec["params"], spec["batch"])
    got = cost.matmul_flops
    if model.cfg.is_encoder_decoder:
        # outside 1 %: the dead cross-attention K/V products (6.7 % of
        # the smoke forward's); counted exactly
        got -= _dead_cross_kv(model.cfg)
    assert abs(got / want - 1) < 0.01, (got, want)


@pytest.mark.parametrize("arch", ["qwen3-8b", "zamba2-1.2b"])
def test_train_step_dot_flops_match_reference(arch):
    jspec, spec = _specs(arch, "train", L)
    jstep = j_steps.make_train_step(j_get_model(j_get_smoke(arch)),
                                    JTrainConfig())
    want = _ref_dot_flops(_compiled(jstep, jspec["state"], jspec["batch"]))
    model = get_model(get_smoke(arch), device="meta")
    with op_cost.counting() as cost:
        steps.make_train_step(model, TrainConfig())(spec["state"],
                                                    spec["batch"])
    assert abs(cost.matmul_flops / want - 1) < 0.01, (cost.matmul_flops,
                                                      want)


def test_prefill_and_decode_dot_flops_match_reference():
    arch = "qwen3-8b"
    jmodel = j_get_model(j_get_smoke(arch))
    model = get_model(get_smoke(arch), device="meta")
    jspec, spec = _specs(arch, "prefill", L)
    want = _ref_dot_flops(_compiled(j_steps.make_prefill_step(jmodel),
                                    jspec["params"], jspec["batch"]))
    with op_cost.counting() as cost:
        steps.make_prefill_step(model)(spec["params"], spec["batch"])
    assert abs(cost.matmul_flops / want - 1) < 0.01
    jspec, spec = _specs(arch, "decode", DECODE_LEN)
    names = ("params", "tokens", "cache", "lengths")
    want = _ref_dot_flops(_compiled(j_steps.make_serve_step(jmodel),
                                    *(jspec[n] for n in names)))
    with op_cost.counting() as cost:
        steps.make_serve_step(model)(*(spec[n] for n in names))
    assert abs(cost.matmul_flops / want - 1) < 0.01


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flops,nbytes,coll", [
    (2.8e14, 2.5e12, 1.0e11), (1.9e10, 7.0e9, 8.6e7), (1e9, 1e6, 1e12)])
def test_roofline_terms_match_reference(flops, nbytes, coll):
    got = roofline.roofline_terms(flops, nbytes, coll, 256)
    ref = hlo_analysis.roofline_terms(flops, nbytes, coll, 256)
    scale = {"t_compute": hlo_analysis.PEAK_FLOPS / roofline.PEAK_FLOPS,
             "t_memory": hlo_analysis.HBM_BW / roofline.HBM_BW,
             "t_collective": hlo_analysis.ICI_BW / roofline.LINK_BW}
    assert set(got) == set(ref)
    for k in ref:
        assert got[k] == pytest.approx(ref[k] * scale[k], rel=1e-12)
    assert roofline.dominant_term(got) == hlo_analysis.dominant_term(got)


# ---------------------------------------------------------------------------
# on the fake process group (one subprocess)
# ---------------------------------------------------------------------------

_CHILD = r"""
import itertools, json, math
import torch
from repro_torch import tree
from repro_torch.configs import ParallelConfig, TrainConfig, get_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import cells, dryrun, op_cost
from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime.param_sharding import relayout
from repro_torch.train.steps import state_blocks

out = {}
cfg = get_smoke("qwen3-8b")
for mesh in ((1, 2), (2, 1)):
    for kind in ("train", "prefill"):
        r = dryrun.dry_run(cfg, ShapeConfig("s", kind, 32, 4), mesh)
        out[f"{kind} {mesh}"] = r["collective_bytes"]

shape = ShapeConfig("s", "train", 32, 8)
r = dryrun.dry_run(cfg, shape, (2, 2))
held = []
for index in itertools.product(range(2), range(2)):
    cell = cells.make_cell(cfg, shape, dryrun.MeshShape((2, 2), index),
                           device="meta")
    parts = [dryrun._take(cell.specs[n], lay) for n, lay in
             zip(("state", "batch"), cell.in_layouts)]
    held.append(sum(t.numel() * t.element_size() for p in parts
                    for t in dryrun.op_cost.tensors_of(p)))
out["smoke (2, 2)"] = r
out["held by rank"] = held

# FSDP at (2, 1): each FSDP leaf's gradient comes back reduce-scattered
# in f32, its block once a step (no microbatches)
fsdp = ParallelConfig(fsdp=True)
r = dryrun.dry_run(cfg, ShapeConfig("s", "train", 32, 4), (2, 1),
                   parallel=fsdp)
layout = state_blocks(cfg, TrainConfig(), dryrun.MeshShape((2, 1)), fsdp)
spec = cells.input_specs(cfg, ShapeConfig("s", "prefill", 32, 4))["params"]
out["fsdp"] = [r["collective_bytes"]["reduce-scatter"], 4 * sum(
    math.prod(sh.block.shape(leaf.shape)) for leaf, sh in
    zip(tree.leaves(spec), tree.leaves(layout["params"]))
    if sh is not None and sh.block is not None)]

# the prefill cell's cache into the decode cell's layout at (1, 2): one
# all-to-all a layer over "model" for K and V
dryrun.fake_world(2)
mesh = make_mesh((1, 2), ("data", "model"))
pcell = cells.make_cell(cfg, ShapeConfig("s", "prefill", 32, 4), mesh,
                        device="meta")
dcell = cells.make_cell(cfg, ShapeConfig("s", "decode", 32, 4), mesh,
                        device="meta")
_, cache = pcell.step(dryrun._take(pcell.specs["params"],
                                   pcell.in_layouts[0]),
                      dryrun._take(pcell.specs["batch"],
                                   pcell.in_layouts[1]))
with op_cost.tallied() as moved:
    got = relayout(cache, pcell.out_layouts[1], dcell.in_layouts[2])
want = dryrun._take(dcell.specs["cache"], dcell.in_layouts[2])
out["relayout"] = dict(
    shapes=[tuple(a.shape) == tuple(b.shape)
            for a, b in zip(tree.leaves(got), tree.leaves(want))],
    all_to_all=moved.coll["all-to-all"], calls=moved.calls["all-to-all"],
    kv=sum(t.numel() * t.element_size() for k, t in tree.items(want)
           if k.split("/")[-1] in ("k", "v")))
out["decode_32k"] = dryrun.run_cell("mamba2-130m", "decode_32k", "single")
out["long_500k"] = dryrun.run_cell("qwen3-8b", "long_500k", "single")
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_group_runs():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    done = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=ROOT)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def _smoke_reckoning():
    """The collective bytes a qwen3-8b smoke cell (2 layers, d 64, 4
    query heads and 2 KV heads of 16, d_ff 128, vocabulary 256, f32,
    untied, q/k norms) makes at (4, 32), by hand."""
    n_layers, d, dh, d_ff, vocab = 2, 64, 16, 128, 256
    rows, f32 = 4 * 32, 4
    act = rows * d * f32                   # one (4, 32, 64) activation
    layer = (d * 4 * dh + 2 * d * 2 * dh + 4 * dh * d    # wq wk wv wo
             + 2 * dh + 2 * d + 3 * d * d_ff)          # norms, MLP
    whole = 2 * vocab * d + n_layers * layer + d
    # at "model" 2: wq, wk, wv, wo, the MLP and both vocab leaves halved
    piece = (vocab * d + n_layers * (d * 2 * dh + 2 * d * dh + 2 * dh * d
                                     + 2 * dh + 2 * d + 3 * d * d_ff // 2)
             + d)
    metrics = 4                            # the loss and three metrics
    model2_train = {
        # forward: the Megatron pair's two all-reduces a layer and the
        # vocab-parallel embedding's; backward: copy_in's two a layer
        # and the logits' input's; the loss's max, sum of exponentials
        # and gold logit; the q/k norms' shared gradients; the rank's
        # gradients summed over "data" (a group of one); the loss and
        # metrics over "data"; the global norm's sum over "model"
        "all-reduce": (2 * (2 * n_layers + 1) * act + 3 * rows * f32
                       + n_layers * 2 * dh * f32 + piece * f32
                       + metrics * f32 + f32)}
    model2_prefill = {
        "all-reduce": (2 * n_layers + 1) * act,
        # the greedy token's (max, id) over "model", float64
        "all-gather": 2 * 4 * 2 * 8}
    data2_train = {
        # every gradient summed over "data" in f32 buckets, with the
        # loss and metrics; ZeRO-1's blocks gathered whole after AdamW
        "all-reduce": whole * f32 + metrics * f32,
        "all-gather": whole * f32}
    return {"train (1, 2)": model2_train, "prefill (1, 2)": model2_prefill,
            "train (2, 1)": data2_train, "prefill (2, 1)": {}}


def test_collective_bytes_match_hand_reckoning(fake_group_runs):
    for case, want in _smoke_reckoning().items():
        got = fake_group_runs[case]
        assert set(got) == set(op_cost.KINDS)
        full = {k: float(want.get(k, 0)) for k in op_cost.KINDS}
        assert got == full, case


def test_fsdp_gradients_reduce_scattered(fake_group_runs):
    got, want = fake_group_runs["fsdp"]
    assert got == want > 0


def test_relayout_all_to_all_on_the_fake_group(fake_group_runs):
    r = fake_group_runs["relayout"]
    assert r["shapes"] and all(r["shapes"])
    # K and V, one all-to-all a layer each, received as the decode
    # layout's parts
    assert r["calls"] == 2 * get_smoke("qwen3-8b").n_layers
    assert r["all_to_all"] == r["kv"] > 0


REFERENCE_KEYS = {
    "arch", "shape", "mesh", "n_chips", "status", "memory",
    "flops_per_device", "bytes_per_device", "bytes_per_device_max",
    "collective_bytes", "collective_total", "roofline", "dominant",
    "model_flops_global", "model_flops_per_device", "useful_ratio",
    "params_total", "params_active"}


def test_dry_run_record_and_argument_bytes(fake_group_runs):
    r = fake_group_runs["smoke (2, 2)"]
    assert REFERENCE_KEYS <= set(r)
    assert {"run_s", "peak_bytes", "fits", "rank"} <= set(r)
    assert set(r["memory"]) == {"argument_bytes", "output_bytes",
                                "temp_bytes"}
    assert set(r["roofline"]) >= {"t_compute", "t_memory", "t_collective"}
    assert r["status"] == "ok" and r["n_chips"] == 4 and r["rank"] == 0
    assert r["memory"]["argument_bytes"] == max(
        fake_group_runs["held by rank"])
    assert r["peak_bytes"] == (r["memory"]["argument_bytes"]
                               + r["memory"]["temp_bytes"])
    assert r["flops_per_device"] > r["matmul_flops_per_device"] > 0


def test_full_size_cell_over_256_ranks(fake_group_runs):
    r = fake_group_runs["decode_32k"]
    assert r["status"] == "ok", r.get("error")
    assert (r["arch"], r["shape"], r["mesh"], r["n_chips"]) == (
        "mamba2-130m", "decode_32k", "single", 256)
    assert r["fits"] and r["flops_per_device"] > 0
    assert np.isfinite(r["roofline"]["t_memory"])


def test_full_attention_long_context_skipped(fake_group_runs):
    r = fake_group_runs["long_500k"]
    ok, why = cells.cell_supported(cells.get_config("qwen3-8b"),
                                   cells.SHAPES["long_500k"])
    assert not ok
    assert r["status"] == "skipped" and r["reason"] == why


# ---------------------------------------------------------------------------
# the device rule
# ---------------------------------------------------------------------------


def test_meta_only_where_named(monkeypatch):
    """The model API runs on meta where a caller names it; with no
    device and no CUDA it raises, and the ultrasound entry points'
    device rule refuses meta."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke("mamba2-130m")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model(cfg)
    assert get_model(cfg, device="meta").device.type == "meta"
    assert get_model(cfg, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
