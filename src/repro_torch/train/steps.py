"""The steps: train (gradient accumulation, clipping, AdamW), prefill and
serve (greedy decode).

The port of the reference's ``repro.train.steps``. The loss and its
gradients come from ``torch.autograd``; the layer bodies are recomputed
in the backward where the config asks for remat (`models.common.remat`).
A kernel flag set under autograd raises (the reference has no backward
for its kernels either: ROADMAP queue C). Prefill and serve run without
autograd.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import TrainConfig
from repro_torch.models.api import Model
from repro_torch.optim.adamw import adamw_init, adamw_update, global_norm_clip


def init_train_state(model: Model, seed: int = 0) -> Dict:
    params = model.init_params(seed)
    return {"params": params, "opt": adamw_init(params)}


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


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``, the reference's:
    with ``microbatches`` m > 1 the batch's leading axis splits into m
    microbatches whose f32 gradients accumulate as g / m (the loss as
    loss / m, the model's metrics averaged over them); then the global
    norm clip and AdamW. Metrics are 0-d tensors {"loss", "grad_norm",
    the model's, "lr"}.

    The new state reuses the old state's storage: parameters and moments
    are updated in place (`optim.adamw.adamw_update`), so the state
    passed in is the state returned."""

    def grads_of(params: Dict, batch: Dict):
        live = tree.map_(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss, metrics = model.loss_fn(live, batch)
            grads = torch.autograd.grad(loss, tree.leaves(live),
                                        materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree.unflatten(params, list(grads)))

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        m = tcfg.microbatches
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

        grads, gnorm = global_norm_clip(grads, tcfg.grad_clip)
        new_params, new_opt, opt_metrics = adamw_update(
            tcfg, params, grads, state["opt"])
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
