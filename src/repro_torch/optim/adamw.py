"""AdamW on the port's nested dicts, with the schedule and clipping.

The port of the reference's ``repro.optim.adamw``. State layout mirrors
the parameter tree:
  {"m": tree(f32), "v": tree(f32), "step": 0-d int32}

m and v are f32 whatever the parameters' dtype (bf16 parameters, f32
moments); the learning rate and the bias corrections are computed in
f32, in the reference's order of operations. `adamw_update` writes the
new moments and parameters into the old tensors (in place) and returns
trees of those same tensors: one copy of each lives on the card, beside
f32 temporaries of at most one piece of a leaf (`_PIECE`).

The clip can be applied piece by piece (``adamw_update(..., scale=)``,
the same products as `global_norm_clip`'s), so no f32 copy of the whole
gradient tree is made. ZeRO-1 (``blocks``): a rank holds only its block
of each moment (`runtime.param_sharding.zero1_blocks`) and updates only
that block of the parameter, with the decay mask of the whole leaf; the
train step then gathers the parameters' blocks. Under FSDP a rank holds
the parameter itself as its block, so the update runs on the blocks it
is given (``blocks`` None there) and nothing is gathered. Under tensor
parallelism the parameters, gradients and moments given are the rank's
pieces (`runtime.param_sharding.tp_pieces`), and ``blocks`` are blocks
of those pieces.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs.base import TrainConfig


def cosine_schedule(tcfg: TrainConfig) -> Callable:
    """step (an int or an int tensor) -> f32 lr: linear warm-up, then a
    cosine decay to 0 at ``total_steps``."""
    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = tcfg.learning_rate * step / max(tcfg.warmup_steps, 1)
        t = (step - tcfg.warmup_steps) / max(
            tcfg.total_steps - tcfg.warmup_steps, 1)
        t = torch.clamp(t, 0.0, 1.0)
        cos = 0.5 * tcfg.learning_rate * (1.0 + torch.cos(np.pi * t))
        return torch.where(step < tcfg.warmup_steps, warm, cos)
    return lr


def _f32_copy(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32, copy=True)


def global_norm(grads: Dict, pieces: Optional[Dict] = None, axis=None,
                blocks: Optional[Dict] = None, data_axis=None
                ) -> torch.Tensor:
    """The f32 global norm of a gradient tree, one f32 temporary a leaf
    at a time (the squares run in place on a copy).

    Under tensor parallelism (``pieces``, a tree of
    `runtime.param_sharding.Piece` or None, and ``axis``, the "model"
    ranks) the norm of the whole leaves: the squares of the parts each
    rank counts (`Piece.counted`: its own, and a shared part once) are
    summed over ``axis``, and a leaf whole on every rank (piece None: a
    block "model" does not divide too) is counted once, on every rank
    alike; a whole leaf held as a piece of one shared segment (KV heads
    under split query heads, an ``attn_batch`` fallback block) is
    counted on the first rank only. Under FSDP (``blocks``, a tree of the
    parameters' `Block` over "data" or None, and ``data_axis``, the
    "data" ranks) the squares of a gradient held as its block are summed
    over ``data_axis`` too, before those over ``axis``."""
    from repro_torch.runtime import collectives
    leaves = tree.leaves(grads)
    split = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    whole = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    # the blocks' squares over "data": of pieces (then over "model"), of
    # leaves whole over "model"
    both = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    data = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    none = itertools.repeat(None)
    split_over_data = False
    for g, piece, blk in zip(
            leaves, none if pieces is None else tree.leaves(pieces),
            none if blocks is None else tree.leaves(blocks)):
        split_over_data |= blk is not None
        if piece is None:
            sq = torch.sum(_f32_copy(g).square_())
            if blk is None:
                whole = whole + sq
            else:
                data = data + sq
            continue
        for off, n in piece.counted():
            sq = torch.sum(_f32_copy(g.narrow(piece.dim, off, n)).square_())
            if blk is None:
                split = split + sq
            else:
                both = both + sq
    if split_over_data:
        summed = collectives.sum_over(torch.stack([both, data]), data_axis)
        split = split + summed[0]
        whole = whole + summed[1]
    return torch.sqrt(collectives.sum_over(split, axis) + whole)


def clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def global_norm_clip(grads: Dict, max_norm: float) -> Tuple[Dict, torch.Tensor]:
    """(grads in f32 scaled to a global norm of at most ``max_norm``, the
    global norm before the scaling)."""
    gnorm = global_norm(grads)
    scale = clip_scale(gnorm, max_norm)
    return tree.map_(lambda g: _f32_copy(g).mul_(scale), grads), gnorm


def adamw_init(params: Dict, blocks: Optional[Dict] = None) -> Dict:
    """Zero moments, f32; of each leaf's `Block` where ``blocks`` (a tree
    of the parameters' structure, None leaves: whole) gives one."""
    def zeros(p, blk):
        shape = p.shape if blk is None else blk.shape(p.shape)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    if blocks is None:
        blocks = tree.map_(lambda _: None, params)
    device = tree.leaves(params)[0].device
    return {"m": tree.map_(zeros, params, blocks),
            "v": tree.map_(zeros, params, blocks),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


# a leaf updates in pieces of whole rows of its leading axis, each of at
# most this many entries (or one row), so the f32 temporaries stay small
# (granite-moe's stacked experts: 1.2 G entries a leaf, 32 pieces;
# gemma3's embedding: 0.3 G, 5 pieces)
_PIECE = 2 ** 26


def _decay_mask(leaf: torch.Tensor) -> bool:
    """Weight decay only on leaves of 2 or more dims, as stored: matrices,
    and also the layer-stacked (L, D) norm scales (as the reference's).
    A rank's piece of a leaf (tensor parallelism) or block of it (ZeRO-1)
    has the whole leaf's number of dims, so the mask is the whole
    leaf's."""
    return leaf.ndim >= 2


@torch.no_grad()
def adamw_update(tcfg: TrainConfig, params: Dict, grads: Dict, state: Dict,
                 *, scale: Optional[torch.Tensor] = None,
                 blocks: Optional[Dict] = None) -> Tuple[Dict, Dict, Dict]:
    """-> (new_params, new_state, {"lr"}); grads f32 after clipping, or,
    with ``scale``, before it: each piece is then clipped as it is read
    (``f32(g) * scale``). With ``blocks`` (a tree of `Block` or None),
    only this rank's block of a split leaf is updated, against moments of
    that block. The parameters and moments are updated in place (module
    doc)."""
    step = state["step"] + 1
    lr = cosine_schedule(tcfg)(step)
    b1, b2, eps = tcfg.b1, tcfg.b2, tcfg.eps
    c1 = 1.0 - b1 ** step.to(torch.float32)
    c2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(p, g, m, v, decay):
        # the reference's expression, one operation at a time in place
        # (the same roundings), so at most two f32 temporaries live
        g = g.float() if scale is None else _f32_copy(g).mul_(scale)
        m.mul_(b1).add_(g * (1.0 - b1))
        v.mul_(b2).add_((g * (1.0 - b2)).mul_(g))
        delta = torch.div(m, c1).div_(torch.div(v, c2).sqrt_().add_(eps))
        if decay:
            delta.add_(_f32_copy(p).mul_(tcfg.weight_decay))
        p.copy_(_f32_copy(p).sub_(delta.mul_(lr)))

    def upd_leaf(p, g, m, v, blk):
        decay = _decay_mask(p)            # of the stored leaf, not a piece
        if blk is not None:
            p, g = blk.take(p), blk.take(g)
        if p.ndim == 0:
            return upd(p, g, m, v, decay)
        # elementwise, so pieces along the leading axis change nothing
        rows = max(1, _PIECE * p.shape[0] // max(p.numel(), 1))
        for piece in zip(*(t.split(rows) for t in (p, g, m, v))):
            upd(*piece, decay)

    if blocks is None:
        blocks = tree.map_(lambda _: None, params)
    tree.map_(upd_leaf, params, grads, state["m"], state["v"], blocks)
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"lr": lr}
