"""Step builders: prefill and serve (greedy decode).

The port of the reference's ``make_prefill_step`` / ``make_serve_step``.
Training (``make_train_step``, AdamW, backward) is not ported yet
(ROADMAP A). Steps run without autograd.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.models.api import Model


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
