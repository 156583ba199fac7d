"""The steps: train (gradient accumulation, clipping, AdamW), prefill and
serve (greedy decode).

The port of the reference's ``repro.train.steps``. The loss and its
gradients come from ``torch.autograd``; the layer bodies are recomputed
in the backward where the config asks for remat (`models.common.remat`).
A kernel flag set under autograd raises (the reference has no backward
for its kernels either: ROADMAP queue C). Prefill and serve run without
autograd.

Data parallel (``make_train_step(..., mesh=)``): each rank holds its
contiguous rows of the global batch (`data.tokens.TokenDataset.
rows_for_step`) and runs the loss under the mesh's binding, where every
statistic over the batch is the global batch's and the loss is the
rank's share of the global loss (`models.common.softmax_xent`,
`models.moe`). The shares' gradients are summed over "data" in f32
buckets (`runtime.collectives.sum_in_f32_buckets`), written back in the
gradients' dtype; the global-norm clip is taken from that sum on every
rank alike; then AdamW, with ZeRO-1 (``TrainConfig.zero1``) on each
rank's block of the moments, and the parameters' blocks gathered. The
loss, grad norm, metrics and new state are those of the single-device
step on the global batch, up to the order of the sums. With
``microbatches`` m, each rank splits its own rows into m: microbatch i
of the step is then rows i of every rank's split.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.launch.mesh import binding_for
from repro_torch.models.api import Model, family_module
from repro_torch.optim.adamw import (adamw_init, adamw_update, clip_scale,
                                     global_norm)
from repro_torch.runtime import collectives
from repro_torch.runtime import sharding as shlib
from repro_torch.runtime.param_sharding import zero1_blocks


def state_blocks(params: Dict, tcfg: TrainConfig, mesh=None,
                 parallel: Optional[ParallelConfig] = None) -> Dict:
    """The `Block` of each leaf of a train state that this rank holds
    (None: the whole leaf), for the state of the parameters ``params``
    (a tree of their shapes serves, e.g. on the ``meta`` device): the
    parameters whole, the moments split by ZeRO-1 where ``tcfg.zero1``;
    all None without a mesh. `checkpoint` reads and writes states by it."""
    if mesh is None:
        mb = tree.map_(lambda _: None, params)
    else:
        with shlib.use_binding(binding_for(mesh, parallel)):
            mb = zero1_blocks(params, tcfg.zero1)
    return {"params": tree.map_(lambda _: None, params),
            "opt": {"m": mb, "v": mb, "step": None}}


def init_train_state(model: Model, seed: int = 0,
                     blocks: Optional[Dict] = None) -> Dict:
    """Parameters from ``seed`` (the same on every rank) and zero
    moments, of their blocks where ``blocks`` (`state_blocks`) gives
    them."""
    params = model.init_params(seed)
    return {"params": params, "opt": adamw_init(
        params, None if blocks is None else blocks["opt"]["m"])}


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` for the block, then
    the caller's setting again. On the card the backward of the
    embedding lookup and of the loss's gather, and MoE V1's index ops,
    add with atomics by default; this mode takes their deterministic
    kernels, so a run repeats bit for bit. cuBLAS asks for
    ``CUBLAS_WORKSPACE_CONFIG`` in this mode: ":4096:8" unless it is
    set."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def make_train_step(model: Model, tcfg: TrainConfig, mesh=None,
                    parallel: Optional[ParallelConfig] = None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``, the reference's:
    with ``microbatches`` m > 1 the batch's leading axis splits into m
    microbatches whose f32 gradients accumulate as g / m (the loss as
    loss / m, the model's metrics averaged over them); then the global
    norm clip and AdamW. Metrics are 0-d tensors {"loss", "grad_norm",
    the model's, "lr"}.

    With a ``mesh`` (`launch.mesh.make_mesh`), the data-parallel step of
    the module doc: ``batch`` is this rank's rows, ``state`` has the
    moments of `state_blocks`, and the metrics are the global batch's on
    every rank. At a "data" extent of 1 it computes what the step
    without a mesh computes, bit for bit.

    The new state reuses the old state's storage: parameters and moments
    are updated in place (`optim.adamw.adamw_update`), so the state
    passed in is the state returned."""
    binding = binding_for(mesh, parallel) if mesh is not None else None
    # the moments' blocks, from the parameters' shapes: the same
    # `state_blocks` gives the caller for the state it passes in
    blocks = None if mesh is None else state_blocks(
        family_module(model.cfg).init_params(model.cfg, None,
                                             torch.device("meta")),
        tcfg, mesh, parallel)["opt"]["m"]

    def grads_of(params: Dict, batch: Dict):
        live = tree.map_(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss, metrics = model.loss_fn(live, batch)
            grads = torch.autograd.grad(loss, tree.leaves(live),
                                        materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree.unflatten(params, list(grads)))

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        with shlib.use_binding(binding):
            return step(state, batch)

    def step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        # the ranks that split the batch (one rank: a group of one)
        axis = (binding.axis_group(binding.rules["batch"])
                if binding is not None else None)
        m = tcfg.microbatches
        rows = next(iter(batch.values())).shape[0]
        if rows % m:
            raise ValueError(f"{rows} rows do not split into {m} "
                             "microbatches")
        if m > 1:
            grads = tree.map_(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=tree.leaves(params)[0].device)
            per_mb = []
            for i in range(m):
                mb = {k: x.reshape((m, x.shape[0] // m) + x.shape[1:])[i]
                      for k, x in batch.items()}
                loss_i, metrics_i, grads_i = grads_of(params, mb)
                tree.map_(lambda a, g: a.add_(g.float() / m), grads, grads_i)
                loss = loss + loss_i / m
                per_mb.append(metrics_i)
                del grads_i
            metrics = {k: torch.stack([mm[k] for mm in per_mb]).mean()
                       for k in per_mb[0]}
        else:
            loss, metrics, grads = grads_of(params, batch)

        if axis is not None:
            # the shares of the loss and metrics, and their gradients,
            # summed over the ranks
            names = sorted(metrics)
            summed = collectives.sum_over(torch.stack(
                [loss] + [metrics[k] for k in names]), axis)
            loss, metrics = summed[0], dict(zip(names, summed[1:]))
            grads = tree.map_(lambda g: g.contiguous(), grads)
            collectives.sum_in_f32_buckets(tree.leaves(grads), axis)
        gnorm = global_norm(grads)
        scale = clip_scale(gnorm, tcfg.grad_clip)
        new_params, new_opt, opt_metrics = adamw_update(
            tcfg, params, grads, state["opt"], scale=scale, blocks=blocks)
        del grads
        if blocks is not None:
            for p, blk in zip(tree.leaves(new_params), tree.leaves(blocks)):
                if blk is not None:
                    collectives.gather_block(p, blk.take(p), blk)
        return {"params": new_params, "opt": new_opt}, {
            "loss": loss, "grad_norm": gnorm, **metrics, **opt_metrics}

    return train_step


def make_prefill_step(model: Model) -> Callable:
    @torch.no_grad()
    def prefill_step(params: Dict, batch: Dict):
        logits, cache = model.prefill(params, batch)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, cache

    return prefill_step


def make_serve_step(model: Model) -> Callable:
    """One decode iteration: write KV, attend, next token (greedy:
    deterministic, per the paper's execution model). The cache is
    updated in place (``hybrid.decode_step``)."""

    @torch.no_grad()
    def serve_step(params: Dict, tokens: torch.Tensor, cache: Dict,
                   lengths: torch.Tensor):
        logits, new_cache = model.decode_step(params, tokens, cache, lengths)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], new_cache, lengths + 1

    return serve_step
