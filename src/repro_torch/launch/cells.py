"""Cell construction: (arch x shape x mesh) -> a step and the layout of
each of its inputs and outputs.

The port of the reference's ``repro.launch.cells``, with its names and
meaning: `parallel_for` (each cell's distribution choices: FSDP for
`FSDP_ARCHS`, the decode KV cache split along its sequence over "model",
or over ("data", "model") at batch 1), `cell_supported`, `input_specs`
(every input of the cell's step as ``meta`` tensors: shapes and dtypes,
nothing allocated), `build_cell`, `count_params` and `model_flops`.

A `Cell` holds the step under the cell's binding (the train step, or
the prefill and decode steps of `train.steps` on the mesh) and, for
every input and output, the layout of each leaf that a rank holds: the
counterpart of the reference's ``in_shardings`` / ``out_shardings``. A
parameter's is its `runtime.param_sharding.Shard` (`train.steps.
state_blocks`: the piece over "model", the FSDP block over "data"); a
batch's, token's, length's or cache's leaf's is its `Parts`
(`runtime.param_sharding.layout_of`, `cache_layout`: the reference's
``resolve`` of the leaf's logical axes). Each rank calls the step on its
parts of the inputs and gets its parts of the outputs. A decode cell
reads the prefill cell's cache after `runtime.param_sharding.relayout`
(the decode cache grown to its length first, `launch.serve._grow_cache`).

On a mesh with a "pod" axis the cells take the reference's
``MULTI_POD_RULES`` (`launch.mesh.binding_for`): the batch, and under
FSDP the parameters, over ("pod", "data"), "seq" as on the mesh without
it (replicated over "pod"). `make_cell` also takes a ``parallel`` of
the caller's: a decode cell without ``seq_shard_decode`` keeps the
prefill cell's cache, its KV heads over "model" (`train.steps.
serve_binding`).

The reference lowers and compiles each cell on forced host devices
(``lower_cell``, ``launch/dryrun.py``) and never runs it. The port's
counterpart of ``lower_cell`` is its dry run (`launch.dryrun`): a cell's
step run once on ``meta`` tensors as one rank of a fake process group
of the production mesh's size, costed by `launch.op_cost`. Otherwise a
cell is run on the ranks of a real mesh. ``mesh`` None gives the cell
of one device: its step without a mesh, every input whole.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.configs.base import (ModelConfig, ParallelConfig, SHAPES,
                                      ShapeConfig, TrainConfig)
from repro_torch.data import batches
from repro_torch.launch.mesh import binding_for
from repro_torch.models.api import family_module, get_model
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime import param_sharding as psh
from repro_torch.runtime import sharding as shlib
from repro_torch.train import steps as steps_lib

# Archs that must shard params over data too (too big otherwise).
FSDP_ARCHS = {"llama3-405b", "deepseek-v2-236b"}

_META = torch.device("meta")


def parallel_for(cfg: ModelConfig, shape: ShapeConfig) -> ParallelConfig:
    """Per-cell distribution choices, the reference's.

    Decode cells shard the KV cache along the *sequence* axis: KV heads
    rarely divide the 16-way model axis (gemma3 has 1), and replicating
    a multi-GB cache makes decode collective-bound. The softmax and the
    contraction over the split axis become partial sums over the ranks
    (flash-decode, `models.attention`). batch=1 long-context also folds
    the idle data axis into "seq".
    """
    seq_axes: tuple = ("model",)
    if shape.kind == "decode" and shape.global_batch == 1:
        seq_axes = ("data", "model")
    return ParallelConfig(
        fsdp=cfg.name in FSDP_ARCHS,
        seq_shard_decode=(shape.kind == "decode"),
        seq_axes=seq_axes,
    )


def cell_supported(cfg: ModelConfig, shape: ShapeConfig
                   ) -> Tuple[bool, str]:
    """The assignment's skip rules (recorded, not silently dropped)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: long_500k needs "
                       "sub-quadratic attention (DESIGN.md §5)")
    return True, ""


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------


def _abstract_params(cfg: ModelConfig) -> Dict:
    return family_module(cfg).init_params(cfg, None, _META)


def _abstract_cache(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    mod = family_module(cfg)
    if cfg.family == "audio":
        return mod.init_cache(cfg, batch, 256, seq, device=_META)
    return mod.init_cache(cfg, batch, seq, device=_META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``meta`` tensors of every input of the cell's step (the
    reference's ShapeDtypeStruct stand-ins)."""
    params = _abstract_params(cfg)
    if shape.kind == "train":
        return {"state": {"params": params, "opt": adamw_init(params)},
                "batch": batches.train_batch_spec(
                    cfg, shape.global_batch, shape.seq_len)}
    if shape.kind == "prefill":
        return {"params": params,
                "batch": batches.train_batch_spec(
                    cfg, shape.global_batch, shape.seq_len)}
    dec = batches.decode_inputs_spec(cfg, shape.global_batch)
    return {"params": params, "tokens": dec["tokens"],
            "cache": _abstract_cache(cfg, shape.global_batch,
                                     shape.seq_len),
            "lengths": dec["lengths"]}


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


def _batch_layout(spec: Dict) -> Dict:
    """Each leaf's `Parts` under the active binding: its rows over
    "batch", the rest whole (the reference's ``_batch_shardings``)."""
    return tree.map_(lambda t: psh.layout_of(
        ("batch",) + (None,) * (t.dim() - 1), t.shape), spec)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    cfg: ModelConfig
    parallel: ParallelConfig
    step: Callable
    specs: Dict[str, Any]
    in_layouts: Any
    out_layouts: Any


def build_cell(arch: str, shape_name: str, mesh,
               overrides: Optional[Dict] = None,
               tcfg: Optional[TrainConfig] = None, device=None) -> Cell:
    """The cell of ``arch`` (``overrides`` on its config) at the shape
    ``shape_name`` of `SHAPES` on ``mesh`` (`launch.mesh.make_mesh`),
    its model on ``device`` (CUDA unless "cpu")."""
    return make_cell(get_config(arch, **(overrides or {})),
                     SHAPES[shape_name], mesh, tcfg, device)


def make_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
              tcfg: Optional[TrainConfig] = None, device=None,
              parallel: Optional[ParallelConfig] = None) -> Cell:
    """`build_cell` of a config and a shape given as they are (a smoke
    config, a shape cut to size), under ``parallel`` (default:
    `parallel_for`'s)."""
    parallel = parallel or parallel_for(cfg, shape)
    model = get_model(cfg, device=device)
    tcfg = tcfg or TrainConfig()
    specs = input_specs(cfg, shape)
    params = steps_lib.state_blocks(cfg, tcfg, mesh, parallel)
    if shape.kind == "train":
        step = steps_lib.make_train_step(model, tcfg, mesh, parallel)
        with shlib.use_binding(None if mesh is None
                               else binding_for(mesh, parallel)):
            batch = _batch_layout(specs["batch"])
        in_l = (params, batch)
        out_l = (params, None)               # metrics: whole on every rank
    elif shape.kind == "prefill":
        step = steps_lib.make_prefill_step(model, mesh, parallel,
                                           shape.global_batch)
        with shlib.use_binding(step.binding):
            in_l = (params["params"], _batch_layout(specs["batch"]))
            tok = psh.layout_of(("batch",), (shape.global_batch,))
            # the prompt's cache (the enc-dec's: 256 decoder positions)
            out_l = (tok, psh.cache_layout(model, _abstract_cache(
                cfg, shape.global_batch, shape.seq_len)))
    else:
        step = steps_lib.make_serve_step(model, mesh, parallel,
                                         shape.global_batch, shape.seq_len)
        with shlib.use_binding(step.binding):
            tok = psh.layout_of(("batch", None), specs["tokens"].shape)
            cache = psh.cache_layout(model, specs["cache"],
                                     parallel.seq_shard_decode)
            lengths = psh.layout_of(("batch",), specs["lengths"].shape)
        in_l = (params["params"], tok, cache, lengths)
        out_l = (tok, cache, lengths)
    return Cell(arch=cfg.name, shape=shape, cfg=cfg, parallel=parallel,
                step=step, specs=specs, in_layouts=in_l, out_layouts=out_l)


# ---------------------------------------------------------------------------
# model-level FLOP accounting (roofline's "useful compute")
# ---------------------------------------------------------------------------


def count_params(cfg: ModelConfig) -> Tuple[int, int]:
    """(total, active) parameter counts from the ``meta`` tree."""
    total = 0
    expert = 0
    for path, leaf in tree.items(_abstract_params(cfg)):
        names = path.split("/")
        n = int(np.prod(leaf.shape))
        total += n
        if "moe" in names and names[-1] in ("wi_gate", "wi_up", "wo"):
            expert += n
    if cfg.n_experts:
        active = total - expert + expert * (
            cfg.n_experts_per_tok / cfg.n_experts)
    else:
        active = total
    return int(total), int(active)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6*N_active*D for train; 2*N_active*D for inference."""
    _, active = count_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens
    return 2.0 * active * shape.global_batch  # one token per slot
