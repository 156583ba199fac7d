"""Shared building blocks of the LM half: init, norm, RoPE, MLP, embedding,
storage-dtype products with f32 sums, and remat.

Parameters are plain nested dicts of tensors, laid out as the reference's
pytrees (per-layer leaves stacked on a leading layer axis), so a JAX
parameter tree carries over leaf by leaf (`models.params`). The
reference's sharding constraints have no counterpart here: on one device
without a mesh they do nothing in the reference either. Its
``jax.checkpoint`` of a layer body is `remat`.

Numerics follow the reference: `rmsnorm` and `apply_rope` compute in
float32 and return the input's dtype; logits are float32.

Tensor parallelism (a binding whose "model" axis is wider than 1,
`runtime.sharding.model_axis`): each rank holds its piece of the
parameters (`runtime.param_sharding.tp_pieces`), and the layers read
their local widths from the pieces' shapes. A replicated activation
enters a column-parallel product through `collectives.copy_in`, and a
row-parallel product leaves through `collectives.reduce_out`: `mlp_apply`
here, attention and the SSM block in their modules. A block whose heads
or width "model" does not divide is whole on every rank and runs as on
one device, with no collective over "model"
(`runtime.sharding.model_axis_over`). Where "model"
divides the vocabulary, `embed_tokens`, `logits_from_hidden` and
`softmax_xent` run vocab-parallel; elsewhere the vocabulary is whole on
every rank, as the reference's divisibility-safe ``resolve`` leaves it.
Without a wide "model" axis every function here runs as on one device.

FSDP (``ParallelConfig.fsdp``): each rank holds its block over "data" of
the parameters whose rule marks "fsdp" (`runtime.param_sharding.
fsdp_blocks`); each layer body gathers its layer's blocks first
(`fsdp_gather`), inside the body that `remat` wraps, so no whole layer
outlives its forward and the recompute gathers again.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.runtime import collectives
from repro_torch.runtime import sharding as shlib

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def dense_init(shape, dtype, gen: torch.Generator, device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init (+-3 std), drawn in f32, then cast.

    ``fan_in`` is ``shape[-2]``, as in the reference, so a layer-stacked
    (L, d_in, d_out) leaf is initialised like L separate (d_in, d_out)
    ones. The draws come from ``gen``; they are not the reference's.
    """
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, std=std, a=-3.0 * std, b=3.0 * std,
                                generator=gen)
    return w.to(dtype)


def layer(layers: Dict, i: int) -> Dict:
    """Layer ``i`` of parameters (or a cache) stacked on a leading layer
    axis: views, so a write into a leaf writes the stacked tensor."""
    return {k: (layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in layers.items()}


def unstacked(layers: Dict, n: int) -> List[Dict]:
    """The ``n`` layers of a stacked parameter tree, each leaf unbound
    once: views, whose backward stacks the layer gradients once (a
    select per layer would allocate a zero stack per layer and leaf)."""
    per_leaf = {k: (unstacked(v, n) if isinstance(v, dict)
                    else torch.unbind(v)) for k, v in layers.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


def fsdp_gather(params: Dict, prefix: str) -> Dict:
    """``params`` (the leaves of the parameter tree under ``prefix``,
    e.g. "layers" for one layer of the stacked layers, or
    "shared_attn") with each leaf that this rank holds as its FSDP block
    gathered whole over "data" (`collectives.gather_in`: its gradient
    comes back reduce-scattered); the others as they are. The identity
    without FSDP (`runtime.sharding.fsdp_layout` empty): no binding,
    fsdp off, a "data" extent of 1."""
    layout = shlib.fsdp_layout()
    if not layout:
        return params

    def walk(node: Dict, path: str) -> Dict:
        out = {}
        for k, v in node.items():
            p = f"{path}/{k}"
            if isinstance(v, dict):
                out[k] = walk(v, p)
            elif p in layout:
                out[k] = collectives.gather_in(v, *layout[p])
            else:
                out[k] = v
        return out
    return walk(params, prefix)


def remat(cfg: ModelConfig, body: Callable) -> Callable:
    """``body`` recomputed in the backward (the reference's
    ``jax.checkpoint``) when ``cfg.remat`` and autograd is on; else
    ``body`` itself. "nothing" saves only the body's inputs; "dots" also
    the outputs of the products without batch dims (``x @ W``: ``mm``),
    as ``dots_with_no_batch_dims_saveable``."""
    if not cfg.remat:
        return body
    context_fn = (functools.partial(
        torch_checkpoint.create_selective_checkpoint_contexts,
        _save_products) if cfg.remat_policy == "dots"
        else torch_checkpoint.noop_context_fn)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        return torch_checkpoint.checkpoint(body, *args, use_reentrant=False,
                                           context_fn=context_fn)
    return wrapped


def _save_products(ctx, op, *args, **kwargs):
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


# ---------------------------------------------------------------------------
# Products: storage-dtype operands, f32 sums
# ---------------------------------------------------------------------------


def f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (N, m, k) @ b (N, k, n) -> f32 (N, m, n), the reference's
    storage-dtype operands with ``preferred_element_type=f32``.

    bf16 or f16 operands on CUDA with autograd off: ``torch.bmm(...,
    out_dtype=torch.float32)``, which reads the operands as they are (a
    strided view is read in place where cuBLAS can). Otherwise the
    operands are cast to f32 first: ``aten::bmm.dtype`` has no derivative
    and no CPU kernel. Both give the same products, since a bf16 or f16
    product is exact in f32; only the order of the sums differs. On
    ``meta`` tensors (`launch.dryrun`) the card's path is taken, so the
    dry run costs what the card runs.
    """
    if (a.device.type in ("cuda", "meta") and a.dtype == b.dtype
            and a.dtype in (torch.bfloat16, torch.float16)
            and not (torch.is_grad_enabled()
                     and (a.requires_grad or b.requires_grad))):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def grouped_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (B, G, m, k) @ b (B, G, k, n) -> f32 (B, G, m, n) by
    `f32_product`, one product per index of the shorter of the two
    leading axes. Each (B or G)-slice of a view keeps one batch stride,
    so a strided view of a cache (B, S, G, d) is read in place: folding
    (B, G) into one batch axis would copy it."""
    if a.shape[1] <= a.shape[0]:
        return torch.stack([f32_product(a[:, g], b[:, g])
                            for g in range(a.shape[1])], dim=1)
    return torch.stack([f32_product(a[i], b[i])
                        for i in range(a.shape[0])], dim=0)


def positions_of(tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) int32 positions 0..S-1 of each row."""
    b, s = tokens.shape[:2]
    return torch.arange(s, dtype=torch.int32,
                        device=tokens.device)[None].expand(b, s)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_params(d: int, dtype, device, lead=()) -> Dict:
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype,
                                device=device)}


def rmsnorm(params: Dict, x: torch.Tensor, eps: float = 1e-6,
            axis=None) -> torch.Tensor:
    """RMS norm over the last dim; with ``axis`` (the "model" ranks)
    that dim is split over its ranks, and the mean of squares is the
    whole dim's: the local sums added over ``axis`` (the Mamba2 gated
    norm on local heads). Its gradient is summed over ``axis`` too,
    since every rank's piece uses it."""
    xf = x.float()
    if axis is None:
        var = (xf * xf).mean(-1, keepdim=True)
    else:
        ss = collectives.reduce_out((xf * xf).sum(-1, keepdim=True), axis)
        var = collectives.copy_in(ss, axis) / (xf.shape[-1] * axis.extent)
    out = xf * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Sequence[int] = ()) -> torch.Tensor:
    """Rotary embedding on the fly. x (B, S, H, D); positions (B, S), or
    (B, 3, S) for M-RoPE (qwen2-vl's temporal / height / width triplets),
    where ``mrope_sections`` splits the D/2 frequency slots over the three
    axes: each slot takes its position from its section's axis."""
    d = x.shape[-1]
    half = d // 2
    inv = torch.as_tensor(rope_freqs(d, theta), dtype=torch.float32,
                          device=x.device)
    if mrope_sections:
        if positions.dim() != 3 or sum(mrope_sections) != half:
            raise ValueError(
                f"M-RoPE needs (B, 3, S) positions and sections summing to "
                f"{half}: got {tuple(positions.shape)}, {mrope_sections}")
        sect = torch.as_tensor(np.repeat(np.arange(len(mrope_sections)),
                                         mrope_sections), device=x.device)
        pos = positions.float()[:, sect, :]               # (B, half, S)
        ang = pos.transpose(1, 2) * inv                   # (B, S, half)
    else:
        ang = positions.float()[..., None] * inv          # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------


def mlp_params(d: int, ff: int, dtype, gen, device, lead=()) -> Dict:
    lead = tuple(lead)
    return {
        "wi_gate": dense_init(lead + (d, ff), dtype, gen, device),
        "wi_up": dense_init(lead + (d, ff), dtype, gen, device),
        "wo": dense_init(lead + (ff, d), dtype, gen, device),
    }


def mlp_apply(params: Dict, x: torch.Tensor, width: int) -> torch.Tensor:
    """SwiGLU; under a "model" axis on the rank's columns of wi_* and
    rows of wo (column- then row-parallel). ``width``: the whole MLP's
    (d_ff); where "model" does not divide it the MLP is whole on every
    rank and runs as on one device (`runtime.sharding.model_axis_over`)."""
    axis = shlib.model_axis_over(width)
    x = collectives.copy_in(x, axis)
    gate = F.silu(matmul(x, params["wi_gate"]))
    up = matmul(x, params["wi_up"])
    return collectives.reduce_out(matmul(gate * up, params["wo"]), axis)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the wider of the two dtypes, as jnp promotes: an f32
    activation meets a bf16 weight in f32 (the weight cast up for the
    product); equal dtypes, as everywhere but the encoder of an
    enc-dec model fed f32 frames, are multiplied as they are."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_params(cfg: ModelConfig, dtype, gen, device) -> Dict:
    p = {"embedding": dense_init((cfg.vocab_size, cfg.d_model), dtype, gen,
                                 device, scale=0.02)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init((cfg.d_model, cfg.vocab_size), dtype, gen,
                                  device)
    return p


def vocab_split(params: Dict, cfg: ModelConfig) -> bool:
    """Whether the rank holds a slice of the vocabulary (a wide "model"
    axis that divides it: `runtime.param_sharding.tp_pieces`)."""
    return params["embedding"].shape[0] != cfg.vocab_size


def _vocab_start(n_local: int):
    """(the first id of this rank's vocabulary slice of ``n_local``,
    the "model" ranks)."""
    axis = shlib.model_axis()
    return axis.index * n_local, axis


def embed_tokens(params: Dict, tokens: torch.Tensor,
                 cfg: Optional[ModelConfig] = None) -> torch.Tensor:
    """The embedding rows of ``tokens``. Vocab-parallel (``cfg`` given
    and `vocab_split`): the rank looks up the ids in its slice, zeros
    the rest, and the rows are summed over "model"."""
    table = params["embedding"]
    if cfg is None or not vocab_split(params, cfg):
        return table[tokens.long()]
    start, axis = _vocab_start(table.shape[0])
    local = tokens.long() - start
    mine = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    return collectives.reduce_out(
        torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                       device=rows.device)),
        axis)


def logits_from_hidden(params: Dict, cfg: ModelConfig,
                       h: torch.Tensor) -> torch.Tensor:
    """f32 logits (..., V) for a stable softmax and loss; under
    `vocab_split`, this rank's slice of them (column-parallel)."""
    w = params["embedding"].T if cfg.tie_embeddings else params["lm_head"]
    if vocab_split(params, cfg):
        h = collectives.copy_in(h, shlib.model_axis())
    return h.float() @ w.float()


def greedy_token(logits: torch.Tensor, params: Dict, cfg: ModelConfig
                 ) -> torch.Tensor:
    """The greedy next token of each row of ``logits`` (B, V), int32:
    the argmax over the whole vocabulary, the lowest id among equal
    maxima (as ``jnp.argmax``). Under `vocab_split` (``params`` the
    embedding's) the logits are this rank's slice: each rank finds its
    slice's (max, global id) and the ranks of "model" exchange them (one
    all-gather), so every rank picks the same token."""
    if not vocab_split(params, cfg):
        return torch.argmax(logits, dim=-1).to(torch.int32)
    start, axis = _vocab_start(logits.shape[-1])
    idx = torch.argmax(logits, dim=-1)
    best = logits.gather(-1, idx[..., None])[..., 0]
    mine = torch.stack([best.double(), (idx + start).double()], dim=-1)
    every = collectives.gathered(mine, axis)             # (m, B, 2)
    top = every[..., 0] == every[..., 0].amax(dim=0)
    ids = torch.where(top, every[..., 1], float(cfg.vocab_size))
    return ids.amin(dim=0).to(torch.int32)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None, *,
                 split: bool = False) -> torch.Tensor:
    """Mean next-token cross entropy; logits (..., V) f32, labels (...).

    Where the batch is split over n > 1 ranks (`runtime.sharding.
    batch_axis`), the mean is the global batch's, as the reference's
    partitioned mean: this rank's sum over the global token count (the
    mask's sum added over the ranks, without gradient). That is the
    rank's share; the shares add up to the global mean over the ranks,
    and so do their gradients (`train.steps`). The count and the shares
    run over the "batch" ranks only ("data", or ("pod", "data")): the
    ranks of "model" hold the same rows.

    With ``split`` (`vocab_split`) the logits are this rank's slice of
    the vocabulary: the max is taken over "model" without gradient, the
    sum of exponentials is summed over "model", and the gold logit comes
    from the rank whose slice holds the label."""
    if split:
        start, axis = _vocab_start(logits.shape[-1])
        mx = collectives.max_over(logits.max(-1).values, axis)
        sumexp = collectives.reduce_out(
            torch.exp(logits - mx[..., None]).sum(-1), axis)
        logz = torch.log(sumexp) + mx
        local = labels.long() - start
        mine = (local >= 0) & (local < logits.shape[-1])
        gold = torch.gather(logits, -1, local.clamp(
            0, logits.shape[-1] - 1)[..., None])[..., 0]
        gold = collectives.reduce_out(torch.where(mine, gold, 0.0), axis)
    else:
        logz = torch.logsumexp(logits, -1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    axis = shlib.batch_axis()
    if mask is not None:
        mask = mask.to(nll.dtype)
        count = collectives.sum_over(mask.sum().detach(), axis)
        return (nll * mask).sum() / count.clamp(min=1.0)
    if axis is not None:
        return nll.sum() / (nll.numel() * axis.extent)
    return nll.mean()


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)).

    Not ``F.softplus``, which switches to the identity above a threshold.
    """
    return x.clamp(min=0) + torch.log1p(torch.exp(-x.abs()))
