"""The dry run: every (arch x shape x mesh) cell costed as one rank of a
production mesh, on ``meta`` tensors, with no card.

The counterpart of the reference's ``launch/dryrun.py``, which lowers
and compiles each cell over 256 or 512 forced host devices and never
runs it. The port has no compiled program, so it runs the cell's step
(`launch.cells.build_cell`) once, as rank 0 of a fake process group of
256 ranks, mesh (data 16, model 16), or 512, mesh (pod 2, data 16,
model 16), on rank 0's parts of the cell's inputs (``meta`` tensors:
shapes and dtypes, nothing allocated), under `launch.op_cost.counting`.
The fake group (torch's ``fake`` backend) runs every collective as a
no-op that keeps its shapes. The reference's static shapes make this
sound: no shape depends on data, so one meta run gives every shape a
rank allocates, and the step's layouts, collectives and shapes meet at
full width, where sharding mismatches surface as failures.

Per cell it records, under the reference's keys where they mean the same
thing: ``memory`` (``argument_bytes``: of the rank that holds the most,
reckoned from the cell's layouts rank by rank without a step, as
`rank_bytes` does; ``output_bytes``: the step's outputs, which alias its
arguments where the step updates them in place; ``temp_bytes``: the
peak of the bytes the step's new storages hold alive), FLOPs and bytes
a card (`op_cost.Cost`: ``bytes_min`` as ``bytes_per_device``,
``bytes`` as ``bytes_per_device_max``), collective result bytes by
kind, the roofline terms and the dominant one (`launch.roofline`), the
model FLOPs (6 N D or 2 N D), the useful ratio and the parameter
counts. It adds ``run_s`` (in the place of ``compile_s``),
``peak_bytes`` (arguments plus temp), ``fits`` (``peak_bytes`` within
the card's 80 GB: the counterpart of a compile-time OOM), ``rank`` (the
rank the step ran as), ``matmul_flops_per_device``,
``collective_calls`` by kind, ``arguments`` (each input's bytes on the
rank that holds the most of it) and, of a train cell, ``state_bytes``
(the parameters, their gradients and the moments as the largest rank
holds them: the tools' "state a card"). The reference's
``unknown_trip_loops``, ``xla_flops_body_once`` and
``generated_code_bytes`` have no counterpart: Python runs every loop,
and nothing is compiled.

A cell that `cells.cell_supported` refuses is recorded as ``skipped``
with the reference's reason; an exception as ``error`` with its
traceback, and `main` then exits 1. Results go to ``build/dryrun.json``
(one record a cell, replaced on a rerun).

`dry_run` costs any config and shape on any mesh ((1, 1), (4, 1),
(2, 2), ...), or without a mesh on one device (``mesh_shape`` None).

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import time
import traceback
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.configs.base import (ModelConfig, ParallelConfig, SHAPES,
                                      ShapeConfig, TrainConfig)
from repro_torch.launch import cells as cells_lib
from repro_torch.launch import op_cost
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_mesh
from repro_torch.runtime import param_sharding as psh

ARCH_IDS = [
    "granite-moe-3b-a800m", "deepseek-v2-236b", "zamba2-1.2b",
    "qwen2-vl-2b", "qwen3-8b", "gemma3-1b", "granite-3-8b",
    "llama3-405b", "mamba2-130m", "seamless-m4t-large-v2",
]

MESHES = {"single": (16, 16), "multi": (2, 16, 16)}

RESULTS_PATH = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "build", "dryrun.json")

_AXES = ("pod", "data", "model")

# the step's inputs, in the order it takes them (`cells.Cell.in_layouts`)
_INPUTS = {"train": ("state", "batch"), "prefill": ("params", "batch"),
           "decode": ("params", "tokens", "cache", "lengths")}


def axes_of(shape: Sequence[int]) -> tuple:
    """(data, model), or (pod, data, model) for a shape of three."""
    return _AXES[3 - len(shape):]


def fake_world(world: int) -> None:
    """This process as rank 0 of a default process group of ``world``
    ranks on torch's ``fake`` backend (every collective a no-op that
    keeps its shapes); a fake group of another size is destroyed first.
    Raises where another group runs, or where torch lacks the backend."""
    import torch.distributed as dist
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as exc:
        raise RuntimeError(
            "the dry run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this "
            f"torch {torch.__version__} lacks") from exc
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a process group other than the dry run's "
                               "fake one is running")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


class MeshShape:
    """What `launch.mesh.binding_for` and `runtime.sharding.Binding.
    axis_group` read of a mesh, for one rank of a mesh never built: its
    axes and this rank's coordinate ``index``, with no process group
    (layouts reckoned on the meta device)."""

    def __init__(self, shape: Sequence[int], index: Sequence[int] = None):
        self.mesh_dim_names = axes_of(shape)
        self.mesh = torch.zeros(tuple(shape))
        self.index = dict(zip(self.mesh_dim_names,
                              index or (0,) * len(shape)))

    def get_group(self, name):
        return None

    def get_local_rank(self, name):
        return self.index[name]


def _pairs(spec, layout):
    """(whole leaf, its layout) of an input: a tree or one tensor."""
    if isinstance(spec, dict):
        return zip(tree.leaves(spec), tree.leaves(layout))
    return [(spec, layout)]


def _take(spec, layout):
    """This rank's part of an input (`runtime.param_sharding.
    take_parts`), each leaf in storage of its own."""
    if isinstance(spec, dict):
        return psh.take_parts(spec, layout)
    return psh.take_parts({"x": spec}, {"x": layout})["x"]


def _held(shape, layout, where) -> int:
    """Entries of a whole leaf of ``shape`` that the rank ``where``
    (axis group -> its index there) holds by ``layout``: a `Shard`, a
    `Parts` or None (the whole)."""
    if layout is None:
        parts = ()
    elif isinstance(layout, psh.Parts):
        parts = layout.parts
    else:
        parts = [p for p in (layout.piece, layout.block) if p is not None]
    shape = list(shape)
    for p in parts:
        if isinstance(p, psh.Piece):
            shape[p.dim] = sum(n for _, n in p.spans(where(p.axis)))
        else:
            shape[p.dim] = p.size(shape[p.dim])
    return math.prod(shape)


def rank_bytes(specs: Sequence, layouts: Sequence,
               mesh_shape: Optional[Sequence[int]]) -> List[int]:
    """Bytes that each rank of a mesh of ``mesh_shape`` holds of the
    inputs ``specs`` (whole leaves, meta tensors: trees or tensors) laid
    out by ``layouts`` (theirs, as any one rank's layouts give them:
    `train.steps.state_blocks`, `cells.Cell.in_layouts`), rank by rank
    in row-major order. A rank's part differs from another's only where
    a `runtime.param_sharding.Piece`'s spans do: each is taken at the
    rank's index over its axes."""
    if mesh_shape is None:
        mesh_shape = (1,)
    sizes = dict(zip(axes_of(mesh_shape), mesh_shape))
    leaves = [(leaf.shape, leaf.element_size(), lay)
              for spec, layout in zip(specs, layouts)
              for leaf, lay in _pairs(spec, layout)]
    out = []
    for coord in itertools.product(*(range(n) for n in mesh_shape)):
        at = dict(zip(sizes, coord))

        def where(axis):
            i = 0
            for a in axis.axes:
                i = i * sizes[a] + at[a]
            return i
        out.append(sum(size * _held(shape, lay, where)
                       for shape, size, lay in leaves))
    return out


def _storage_bytes(out) -> int:
    seen, n = set(), 0
    for t in op_cost.tensors_of(out):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            n += st.nbytes()
    return n


def dry_run(cfg: ModelConfig, shape: ShapeConfig,
            mesh_shape: Optional[Sequence[int]] = None,
            tcfg: Optional[TrainConfig] = None,
            parallel: Optional[ParallelConfig] = None) -> Dict:
    """The record (module doc) of one step of ``cfg`` at ``shape`` as
    rank 0 of a mesh of ``mesh_shape`` ((data, model) or (pod, data,
    model)) over a fake group of as many ranks (`fake_world`), or
    without a mesh on one device (None), under ``tcfg`` and
    ``parallel`` (default: the cell's, `cells.parallel_for`)."""
    t0 = time.perf_counter()
    mesh = None
    if mesh_shape is not None:
        mesh_shape = tuple(int(n) for n in mesh_shape)
        fake_world(math.prod(mesh_shape))
        mesh = make_mesh(mesh_shape, axes_of(mesh_shape))
    n_chips = math.prod(mesh_shape or (1,))
    cell = cells_lib.make_cell(cfg, shape, mesh, tcfg, device="meta",
                               parallel=parallel)
    specs = [cell.specs[n] for n in _INPUTS[shape.kind]]
    by_input = {n: rank_bytes([s], [lay], mesh_shape) for n, s, lay in
                zip(_INPUTS[shape.kind], specs, cell.in_layouts)}
    extra = {}
    if shape.kind == "train":
        state, lay = cell.specs["state"], cell.in_layouts[0]
        extra["state_bytes"] = max(rank_bytes(
            [state["params"], state["params"], state["opt"]["m"],
             state["opt"]["v"]],
            [lay["params"], lay["params"], lay["opt"]["m"],
             lay["opt"]["v"]], mesh_shape))
    args = [_take(s, lay) for s, lay in zip(specs, cell.in_layouts)]
    with op_cost.counting() as cost:
        out = cell.step(*args)
    out_bytes = _storage_bytes(out)
    del out, args
    if not all(map(math.isfinite, (cost.flops, cost.bytes, cost.bytes_min,
                                   cost.coll_bytes))):
        raise ValueError(f"{cfg.name} {shape.name}: a count is not "
                         "finite")

    flops, bytes_min = cost.flops, cost.bytes_min
    terms = rl.roofline_terms(flops, bytes_min, cost.coll_bytes, n_chips)
    terms["t_memory_max"] = cost.bytes / rl.HBM_BW
    mflops = cells_lib.model_flops(cfg, shape)
    total_p, active_p = cells_lib.count_params(cfg)
    argument = max(map(sum, zip(*by_input.values())))
    peak = argument + cost.temp_bytes
    return dict(
        arch=cfg.name, shape=shape.name,
        mesh="x".join(map(str, mesh_shape)) if mesh_shape else "none",
        n_chips=n_chips, rank=0, status="ok",
        run_s=round(time.perf_counter() - t0, 1),
        memory=dict(argument_bytes=argument, output_bytes=out_bytes,
                    temp_bytes=cost.temp_bytes),
        arguments={n: max(b) for n, b in by_input.items()}, **extra,
        peak_bytes=peak, fits=peak <= rl.HBM_BYTES,
        flops_per_device=flops,
        matmul_flops_per_device=cost.matmul_flops,
        bytes_per_device=bytes_min,
        bytes_per_device_max=cost.bytes,
        collective_bytes=dict(cost.coll),
        collective_calls=dict(cost.calls),
        collective_total=cost.coll_bytes,
        roofline=terms,
        dominant=rl.dominant_term(terms),
        model_flops_global=mflops,
        model_flops_per_device=mflops / n_chips,
        useful_ratio=(mflops / n_chips) / flops if flops else 0.0,
        params_total=total_p,
        params_active=active_p,
    )


def run_cell(arch: str, shape_name: str, mesh_kind: str) -> Dict:
    """The record of one cell of the reference's sweep: ``mesh_kind``
    "single" (16, 16) over 256 ranks or "multi" (2, 16, 16) over 512."""
    mesh_shape = MESHES[mesh_kind]
    record: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                    "n_chips": math.prod(mesh_shape)}
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cells_lib.cell_supported(cfg, shape)
    if not ok:
        record.update(status="skipped", reason=why)
        return record
    try:
        record.update(dry_run(cfg, shape, mesh_shape), arch=arch,
                      mesh=mesh_kind)
    except Exception as e:  # noqa: BLE001 - a failed cell is a bug report
        record.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:])
    return record


def append_result(record: Dict, path: str = RESULTS_PATH) -> None:
    """``record`` into the JSON list at ``path``, replacing the record of
    the same cell."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    data = []
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    key = (record["arch"], record["shape"], record["mesh"])
    data = [r for r in data if (r["arch"], r["shape"], r["mesh"]) != key]
    data.append(record)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--out", default=RESULTS_PATH)
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_fail = 0
    t0 = time.perf_counter()
    for mesh_kind in meshes:
        for arch in archs:
            for shape_name in shapes:
                rec = run_cell(arch, shape_name, mesh_kind)
                append_result(rec, args.out)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    terms = {k: f"{v:.4g}" for k, v in rec["roofline"].items()}
                    extra = (f" dom={rec['dominant']} t={terms}"
                             f" peak={rec['peak_bytes'] / 1e9:.2f}GB"
                             f" fits={rec['fits']} run={rec['run_s']}s")
                elif status == "error":
                    n_fail += 1
                    extra = " " + rec["error"][:200]
                print(f"[{mesh_kind}] {arch} x {shape_name}: "
                      f"{status}{extra}", flush=True)
    print(f"[dryrun] {len(meshes) * len(archs) * len(shapes)} cells in "
          f"{time.perf_counter() - t0:.1f}s, {n_fail} errors", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
