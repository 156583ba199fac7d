"""Mixture-of-Experts with the paper's three dispatch variants (PyTorch port
of ``repro.models.moe``).

Token -> expert dispatch is the LM-scale instance of the paper's taxonomy;
one routing decision runs as

  V1 DYNAMIC — scatter/gather: each (token, k) assignment goes to the flat
      slot expert * capacity + rank (``index_copy_``); results come back
      with a gather. A dropped assignment goes to one extra dump row, which
      several may write; that row is never read (the gather reads zeros
      for it).
  V2 CNN     — GShard-style one-hot dispatch/combine einsums per group of
      `group_size` tokens: routing is a {0,1} (groups, tokens, experts,
      capacity) tensor and token movement is a product.
  V3 SPARSE  — block-structured: tokens are slotted as in V1, in blocks of
      8 rows, each block owned by one expert. The reference gathers each
      block's expert weights (an (NB, d, f) copy per weight: 58 GB in bf16
      at granite-moe's (4, 2048) scoring shape). An expert's blocks are
      contiguous, so here the block products of one expert run as one
      ``bmm`` over the (E, capacity, d) view of its blocks: the same
      products row by row, with no weight copy. In this port V3 therefore
      computes what V1 computes; the variants differ in the reference's
      weight gather only.

With the same capacity all three give the same output up to rounding.
Routing (f32 softmax, top-k, capacity ranking by cumsum) is shared. These
are plain PyTorch ops: the reference computes them outside any kernel.

Where the batch is split over n > 1 ranks (`runtime.sharding.batch_axis`)
the statistics that span it are the global batch's, as the reference's
partitioned program computes them: the load-balance fractions and the
z-loss over all tokens (each rank returns its share of the losses; the
shares add up to the global values), V1/V3's capacity and ranking over
all b*s tokens (the lower ranks' tokens first), and V2's group size from
the global token count. Where that group size does not divide a rank's
tokens, a group straddles ranks' rows: the routes (idx, a few KB) are
gathered over the "batch" ranks, each group the rank's tokens touch is
ranked as the reference ranks it (k-major, then token order, the count
carried over kept choices only), and the rank dispatches and combines
its own tokens' slots of those groups (the expert FFN is row-wise, so
no other collective runs); groups within a rank's rows take the local
path. No collective over "data" is differentiated.

Under a "model" axis (`runtime.sharding.model_axis`, m ranks) the
experts are split as `runtime.param_sharding.tp_pieces` gives them:
each rank holds E_eff / m of them (`local_experts`) where m divides the
padded count, else every expert on 1 / m of its width (the reference's
"TP over the ffn dim"). Tokens are replicated over "model", so no
all-to-all runs: every rank routes every token of its rows (routing,
capacity, ranks and the aux losses whole, on every rank alike), runs
only its own experts' slots (an assignment to another rank's expert
goes to the dump row, or under V2 has no column), and the partial
combines are summed by `collectives.reduce_out`. The experts' input and
the combine weights enter through `collectives.copy_in`
(`expert_inputs`), so each replicated tensor ends with its whole
gradient on every rank and nothing is counted m times: routing reads
``x`` as it is, and the router's gradient (from the combine weights,
summed over "model", and from the aux losses, whole on every rank)
needs no sum of its own. Where "model" divides neither the padded
expert count nor the width, every rank holds every expert whole and
runs them as one device does, with no collective over "model". The shared experts run column / row parallel
(`common.mlp_apply`), or whole where "model" does not divide their
width.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.config import Variant
from repro_torch.models import common
from repro_torch.models.common import dense_init
from repro_torch.runtime import collectives
from repro_torch.runtime import sharding as shlib

def moe_params(cfg: ModelConfig, dtype, gen, device, lead=()) -> Dict:
    """Router (f32 in every dtype), experts (E_eff, d, f) incl. the dead
    padding, and the shared experts' SwiGLU; ``lead`` stacks layers."""
    d, f = cfg.d_model, cfg.moe_d_ff
    e = cfg.n_experts_eff
    lead = tuple(lead)
    p = {
        "router": dense_init(lead + (d, cfg.n_experts), torch.float32, gen,
                             device),
        "wi_gate": dense_init(lead + (e, d, f), dtype, gen, device),
        "wi_up": dense_init(lead + (e, d, f), dtype, gen, device),
        "wo": dense_init(lead + (e, f, d), dtype, gen, device),
    }
    if cfg.n_shared_experts:
        p["shared"] = common.mlp_params(
            d, cfg.moe_d_ff * cfg.n_shared_experts, dtype, gen, device, lead)
    return p


# ---------------------------------------------------------------------------
# Routing (shared by all variants)
# ---------------------------------------------------------------------------


def route(cfg: ModelConfig, router_w: torch.Tensor, x_flat: torch.Tensor):
    """x_flat (T, d) -> (weights (T, k) f32, idx (T, k), aux losses)."""
    logits = x_flat.float() @ router_w                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, cfg.n_experts_per_tok, dim=-1)
    w = w / w.sum(dim=-1, keepdim=True).clamp(min=1e-9)

    # Aux: load balance (Switch) + router z-loss.
    e = cfg.n_experts
    onehot_any = F.one_hot(idx, e).float().sum(dim=1)
    axis = shlib.batch_axis()
    if axis is None:
        frac_tokens = onehot_any.mean(dim=0)                # (E,)
        frac_probs = probs.mean(dim=0)
        z_loss = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    else:
        # the global fractions of tokens; this rank's share of the
        # probabilities' mean and of the z-loss
        t_all = x_flat.shape[0] * axis.extent
        frac_tokens = collectives.sum_over(onehot_any.sum(dim=0),
                                           axis) / t_all
        frac_probs = probs.sum(dim=0) / t_all
        z_loss = (torch.logsumexp(logits, dim=-1) ** 2).sum() / t_all
    lb_loss = e * (frac_tokens * frac_probs).sum()
    return w, idx, {"moe_lb_loss": lb_loss,
                    "moe_z_loss": cfg.router_z_loss * z_loss}


def _capacity(n_tokens: int, k: int, factor: float, n_experts: int) -> int:
    return int(max(8, ((n_tokens * k * factor / n_experts) // 8 + 1) * 8))


def _cumsum_tokens(oh: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Inclusive cumsum of oh (..., T, n) over its tokens, in blocks of
    ``block`` tokens plus the earlier blocks' totals: the same integers.
    On the card one scan along 8,192 tokens of 40 columns runs a thread
    a column, nearly serially (tools/moe_rank_scan.py times both)."""
    t, n = oh.shape[-2:]
    if t <= block or t % block:
        return oh.cumsum(dim=-2)
    blocks = oh.reshape(oh.shape[:-2] + (t // block, block, n)).cumsum(-2)
    totals = blocks[..., -1:, :]
    earlier = totals.cumsum(dim=-3) - totals
    return (blocks + earlier).reshape(oh.shape)


def _rank(idx: torch.Tensor, n: int, cap: int, across=None):
    """Ranks of idx (..., T, k) in their experts' queues, k-major (all
    first choices before second ones), then by token: (rank, keep) of
    idx's shape, keep = rank < cap; the queues count kept ones only.

    ``across`` (T being this rank's share of a batch split over ranks):
    (earlier, total), each (k, n), the tokens of each choice and expert
    on the lower ranks and on all ranks. The queues then run over the
    global batch, the lower ranks' tokens first: a choice's ranks here
    start after the lower ranks' and its kept count is its total clipped
    to the room left, the same integers one device computes."""
    count = torch.zeros(idx.shape[:-2] + (1, n), dtype=torch.int64,
                        device=idx.device)
    ranks, keeps = [], []
    for kk in range(idx.shape[-1]):
        oh = F.one_hot(idx[..., kk], n)                    # (..., T, n)
        r = _cumsum_tokens(oh) - oh + count
        if across is not None:
            r = r + across[0][kk]
        rank_k = (r * oh).sum(dim=-1)
        keep_k = rank_k < cap
        ranks.append(rank_k)
        keeps.append(keep_k)
        if across is None:
            count = count + (oh * keep_k[..., None]).sum(dim=-2,
                                                         keepdim=True)
        else:
            count = count + torch.minimum((cap - count).clamp(min=0),
                                          across[1][kk])
    return torch.stack(ranks, dim=-1), torch.stack(keeps, dim=-1)


def _counts_across(idx: torch.Tensor, n: int, axis):
    """(earlier, total) of `_rank` for idx (T, k) on each rank of
    ``axis``: one all-gather of the (k, n) counts."""
    counts = F.one_hot(idx, n).sum(dim=0)                  # (k, n)
    every = collectives.gathered(counts, axis)             # (ranks, k, n)
    return every[:axis.index].sum(dim=0), every.sum(dim=0)


def capacity_and_rank(cfg: ModelConfig, idx: torch.Tensor, n_tokens: int,
                      ) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """(capacity, rank (T, k), keep (T, k) bool): a fixed, data-independent
    priority, k-major then token order; over the global batch where it
    is split over ranks (module doc)."""
    e, k = cfg.n_experts, cfg.n_experts_per_tok
    axis = shlib.batch_axis()
    across = None
    if axis is not None:
        n_tokens *= axis.extent
        across = _counts_across(idx, e, axis)
    cap = _capacity(n_tokens, k, cfg.capacity_factor, e)
    rank, keep = _rank(idx, e, cap, across)
    return cap, rank, keep


# ---------------------------------------------------------------------------
# Expert FFN (shared) and this rank's experts
# ---------------------------------------------------------------------------


def local_experts(cfg: ModelConfig, params: Dict) -> Tuple[int, int]:
    """(first, count) of the experts whose weights this rank holds: all
    of them on one device, under the f-split and where they are whole,
    else its E_eff / m contiguous ones (module doc)."""
    n = params["wi_gate"].shape[0]
    axis = shlib.model_axis()
    if axis is None or n == cfg.n_experts_eff:
        return 0, n
    return axis.index * n, n


def expert_inputs(x_flat: torch.Tensor, w: torch.Tensor, axis):
    """The tokens and the combine weights (T, k) as they enter this
    rank's experts: each through `collectives.copy_in`, whose backward
    sums their partial gradients over "model" (module doc)."""
    return collectives.copy_in(x_flat, axis), collectives.copy_in(w, axis)


def _expert_ffn(params: Dict, xe: torch.Tensor) -> torch.Tensor:
    """xe (E, C, d) -> (E, C, d), per-expert SwiGLU as batched products."""
    gate = F.silu(torch.bmm(xe, params["wi_gate"]))
    up = torch.bmm(xe, params["wi_up"])
    return torch.bmm(gate * up, params["wo"])


# ---------------------------------------------------------------------------
# V1 — dynamic scatter/gather; V3 — the same slots in blocks of 8 rows
# ---------------------------------------------------------------------------


def _slots(cfg, x_flat, idx, cap, rank, keep, first=0, n=None):
    """(dest (T*k,), the (n*cap, d) slotted tokens of the experts
    [first, first + n) (default: all E_eff)): each kept assignment to
    one of them at (idx - first) * cap + rank; dropped ones and those of
    other ranks' experts at the dump row n*cap, which is cut off
    (several may write it)."""
    k = cfg.n_experts_per_tok
    n = cfg.n_experts_eff if n is None else n
    dump = n * cap
    if n != cfg.n_experts_eff:
        idx = idx - first
        keep = keep & (idx >= 0) & (idx < n)
    dest = torch.where(keep, idx * cap + rank, dump).reshape(-1)
    buf = x_flat.new_zeros((dump + 1, x_flat.shape[1]))
    buf.index_copy_(0, dest, x_flat.repeat_interleave(k, dim=0))
    return dest, buf[:-1]


def _combine(ye, dest, w, t):
    """Gather each assignment's expert output (zeros for the dump row)
    and sum them weighted: (T, d)."""
    ye = torch.cat([ye, ye.new_zeros((1, ye.shape[1]))])
    gathered = ye[dest].reshape(t, w.shape[1], -1)
    return (gathered * w[..., None].to(gathered.dtype)).sum(dim=1)


def _dispatch_dynamic(cfg, params, x_flat, w, idx, cap, rank, keep):
    t, d = x_flat.shape
    first, n = local_experts(cfg, params)
    dest, slotted = _slots(cfg, x_flat, idx, cap, rank, keep, first, n)
    ye = _expert_ffn(params, slotted.reshape(n, cap, d))
    return _combine(ye.reshape(n * cap, d), dest, w, t)


def _dispatch_blocked(cfg, params, x_flat, w, idx, cap, rank, keep):
    """V3: the slotted rows in blocks of 8 (cap is a multiple of 8),
    block i owned by expert i // (cap // 8). One expert's blocks
    share its weights, so their products run as one bmm over the
    (E, cap, d) view of its blocks, not on a gathered (NB, d, f) copy of
    the weights (module doc): here the same products as V1's."""
    return _dispatch_dynamic(cfg, params, x_flat, w, idx, cap, rank, keep)


# ---------------------------------------------------------------------------
# V2 — one-hot einsum dispatch (GShard / full-CNN)
# ---------------------------------------------------------------------------


def group_size(cfg: ModelConfig, n_tokens: int) -> int:
    """Dispatch groups bound the O(T_g * E * C) one-hot overhead."""
    g = 256
    while n_tokens % g:
        g //= 2
    return max(g, 1)


def groups_across(cfg: ModelConfig, every: torch.Tensor, start: int,
                  t: int, tg: int, cap_g: int):
    """(idx_g, rank_g, keep_g, lo) of the groups of ``tg`` tokens that
    this rank's ``t`` tokens touch, its tokens being ``[start, start +
    t)`` of the global route list ``every`` (T_all, k): each group
    ranked on the global routes as the reference ranks it (`_rank`:
    k-major, then token order, the count carried over kept choices),
    keep cleared for the other ranks' tokens; ``lo``, the place of this
    rank's first token in the groups' flat (G * Tg) order."""
    g0, g1 = start // tg, -(-(start + t) // tg)
    idx_g = every[g0 * tg:g1 * tg].reshape(g1 - g0, tg, every.shape[1])
    rank_g, keep_g = _rank(idx_g, cfg.n_experts_eff, cap_g)
    lo = start - g0 * tg
    mine = torch.zeros(idx_g.shape[:2], dtype=torch.bool,
                       device=idx_g.device)
    mine.view(-1)[lo:lo + t] = True
    return idx_g, rank_g, keep_g & mine[..., None], lo


def _dispatch_onehot(cfg, params, x_flat, w, idx):
    t, d = x_flat.shape
    k = cfg.n_experts_per_tok
    axis = shlib.batch_axis()
    n_ranks = axis.extent if axis is not None else 1
    tg = group_size(cfg, t * n_ranks)
    # capacity per group and per real expert (dead padding gets empty
    # slots)
    cap_g = _capacity(tg, k, cfg.capacity_factor, cfg.n_experts)
    if t % tg == 0:
        # the groups lie within this rank's tokens: ranks recomputed
        # within each group, over every expert
        g = t // tg
        idx_g = idx.reshape(g, tg, k)
        rank_g, keep_g = _rank(idx_g, cfg.n_experts_eff, cap_g)
        return _onehot_groups(cfg, params, x_flat.reshape(g, tg, d),
                              w.reshape(g, tg, k), idx_g, rank_g, keep_g,
                              cap_g).reshape(t, d)
    # a group straddles ranks' rows (module doc)
    every = collectives.gathered(idx.contiguous(), axis).reshape(-1, k)
    idx_g, rank_g, keep_g, lo = groups_across(cfg, every, axis.index * t,
                                              t, tg, cap_g)
    g = idx_g.shape[0]
    hi = g * tg - lo - t
    y = _onehot_groups(cfg, params,
                       F.pad(x_flat, (0, 0, lo, hi)).reshape(g, tg, d),
                       F.pad(w, (0, 0, lo, hi)).reshape(g, tg, k),
                       idx_g, rank_g, keep_g, cap_g)
    return y.reshape(g * tg, d)[lo:lo + t]


def _onehot_groups(cfg, params, x_g, w_g, idx_g, rank_g, keep_g, cap_g):
    """The one-hot dispatch, expert FFN and combine of the groups: x_g
    (G, Tg, d), w_g, idx_g, rank_g, keep_g (G, Tg, k) -> (G, Tg, d)."""
    g, tg, d = x_g.shape
    e = cfg.n_experts_eff
    act = x_g.dtype
    # this rank's experts' columns only (module doc)
    first, n = local_experts(cfg, params)
    if n == e:
        oh_e = F.one_hot(idx_g, e).to(act)               # (G, Tg, k, E)
    else:
        local = idx_g - first
        oh_e = (F.one_hot(local.clamp(0, n - 1), n).to(act)
                * ((local >= 0) & (local < n))[..., None].to(act))
    # a dropped rank is >= cap_g: its row is zeroed by keep
    oh_c = (F.one_hot(rank_g.clamp(max=cap_g - 1), cap_g).to(act)
            * keep_g[..., None].to(act))                 # (G, Tg, k, C)
    disp = torch.einsum("gtke,gtkc->gtec", oh_e, oh_c)   # 0/1
    wsum = torch.einsum("gtke,gtk->gte", oh_e, w_g.to(act))
    comb = disp * wsum[..., None]

    xe = torch.einsum("gtec,gtd->gecd", disp, x_g)
    # every group's slots of one expert in one bmm: (E, G*C, d)
    ye = _expert_ffn(params, xe.transpose(0, 1).reshape(n, g * cap_g, d))
    ye = ye.reshape(n, g, cap_g, d).transpose(0, 1)      # (G, E, C, d)
    return torch.einsum("gtec,gecd->gtd", comb, ye)


# ---------------------------------------------------------------------------


def moe_apply(params: Dict, cfg: ModelConfig, x: torch.Tensor,
              ) -> Tuple[torch.Tensor, Dict]:
    """x (B, S, d) -> (B, S, d), aux losses. Variant from cfg.moe_variant
    (V1, V2 or V3; AUTO is the ultrasound planner's and raises)."""
    variant = Variant(cfg.moe_variant)
    if not variant.concrete:
        raise ValueError(
            f"moe_variant must be concrete (got {cfg.moe_variant!r}); "
            "Variant.AUTO is resolved by the ultrasound planner only")
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    w, idx, aux = route(cfg, params["router"], x_flat)
    # the ranks that split the experts (along the padded expert dim, or
    # their width); None where they are whole on every rank
    axis = (shlib.model_axis_over(cfg.n_experts_eff)
            or shlib.model_axis_over(cfg.moe_d_ff))
    x_in, w = expert_inputs(x_flat, w, axis)

    if variant == Variant.CNN:
        y = _dispatch_onehot(cfg, params, x_in, w, idx)
    else:
        cap, rank, keep = capacity_and_rank(cfg, idx, b * s)
        dispatch = (_dispatch_dynamic if variant == Variant.DYNAMIC
                    else _dispatch_blocked)
        y = dispatch(cfg, params, x_in, w, idx, cap, rank, keep)
    y = collectives.reduce_out(y, axis)

    if cfg.n_shared_experts:
        y = y + common.mlp_apply(params["shared"], x_flat,
                                 cfg.moe_d_ff * cfg.n_shared_experts)
    return y.reshape(b, s, d), aux
