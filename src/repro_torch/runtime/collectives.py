"""The collectives of training across ranks, on ``torch.distributed``.

The reference leaves them to the partitioner; the port calls them
explicitly (NCCL on the card, gloo on the CPU). Over "data" none of them
is differentiated: a statistic over the global batch is summed without
gradient, and the gradients are summed after the backward.

Over "model" (tensor parallelism) the two conjugate operators of the
Megatron pattern are differentiated (`copy_in`, `reduce_out`): a
replicated activation enters a column-parallel product through
`copy_in` (identity forward, all-reduce of its gradient backward), and
a row-parallel product's partial sums leave through `reduce_out`
(all-reduce forward, identity backward). Both run inside the layer
bodies that `models.common.remat` recomputes, so a recompute on
autograd's device thread issues them again, on every rank in the same
order (the binding is the process's: `runtime.sharding`). The
``attn_batch`` fallback's pair is one more (`split_rows`, `gather_rows`,
one differentiated operator in its two directions): a replicated
activation's rows split over "model" (each rank keeps its block of
rows; backward, the blocks' gradients gathered), and a block of rows
gathered whole (backward, each rank keeps its block of the gradient).

Over "data" under FSDP one more operator is differentiated (`gather_in`):
a parameter held as its block enters a layer body gathered whole (an
all-gather), and its gradient leaves reduce-scattered: summed over the
ranks in f32 (`sum_scatter`), each rank keeping its block, written back
in the parameter's dtype. It too runs inside the remat bodies, so the
recompute gathers again.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

# f32 entries a gradient bucket holds (256 MB)
BUCKET = 2 ** 26


def all_gather_into(out: torch.Tensor, t: torch.Tensor, group) -> None:
    """``out`` (extent * t.shape[0], ...) <- every rank's ``t`` in rank
    order along dim 0: ``all_gather_single``, which replaces the
    deprecated ``all_gather_into_tensor`` from torch 2.13 on, where torch
    has it (the card's torch 2.11 has only the latter)."""
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, t, group=group)


def reduce_scatter_into(out: torch.Tensor, t: torch.Tensor, group
                        ) -> None:
    """``out`` <- the sum over the ranks of ``t`` (extent *
    out.shape[0], ...), this rank's rows of it along dim 0 (gloo wants
    both flat):
    ``reduce_scatter_single`` where torch has it (from 2.13), else
    ``reduce_scatter_tensor`` (as `all_gather_into`)."""
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, t, group=group)


def gathered(t: torch.Tensor, axis) -> torch.Tensor:
    """(extent, *t.shape): ``t`` of every rank of ``axis``."""
    out = t.new_empty((axis.extent,) + tuple(t.shape))
    all_gather_into(out, t.reshape((1,) + tuple(t.shape)).contiguous(),
                    axis.group)
    return out


def sum_over(t: torch.Tensor, axis) -> torch.Tensor:
    """``t`` summed over the ranks of ``axis``, in place; returned."""
    if axis is not None and axis.group is not None:
        dist.all_reduce(t, group=axis.group)
    return t


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_in(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` (the same on every rank of ``axis``) into a rank-local
    branch: the identity, whose backward sums the branches' partial
    gradients over ``axis``. ``axis`` None: ``x`` itself."""
    return x if axis is None else _CopyIn.apply(x, axis.group)


def reduce_out(x: torch.Tensor, axis) -> torch.Tensor:
    """The rank-local partial sums ``x`` summed over ``axis`` (an
    all-reduce), whose backward hands each rank the gradient of the sum
    as it is. ``axis`` None: ``x`` itself."""
    return x if axis is None else _ReduceOut.apply(x, axis.group)


class _Rows(torch.autograd.Function):
    """The rows (dim 0) of a tensor split over ``axis`` (``gather``
    False: this rank's block of a tensor whole on every rank) or
    gathered whole from every rank's block (``gather`` True); the
    backward runs the other direction on the gradient."""

    @staticmethod
    def forward(ctx, x, axis, gather):
        ctx.axis, ctx.gather = axis, gather
        return _rows(x, axis, gather)

    @staticmethod
    def backward(ctx, g):
        return _rows(g, ctx.axis, not ctx.gather), None, None


def _rows(x: torch.Tensor, axis, gather: bool) -> torch.Tensor:
    if gather:
        return gathered(x.contiguous(), axis).flatten(0, 1)
    n = x.shape[0] // axis.extent
    return x.narrow(0, axis.index * n, n).contiguous()


def split_rows(x: torch.Tensor, axis) -> torch.Tensor:
    """This rank's block of the rows (dim 0) of ``x``, the same on every
    rank of ``axis`` (a replicated activation), in rank order; its
    backward gathers every rank's block of the gradient, so each rank
    ends with the whole gradient of ``x``, the same on all."""
    return _Rows.apply(x, axis, False)


def gather_rows(x: torch.Tensor, axis) -> torch.Tensor:
    """Every rank's block of rows ``x`` along dim 0, in rank order: an
    all-gather over ``axis``, whose backward hands each rank its block
    of the (replicated) gradient."""
    return _Rows.apply(x, axis, True)


def sum_scatter(g: torch.Tensor, dim: int, axis) -> torch.Tensor:
    """The block along ``dim`` that this rank of ``axis`` holds of ``g``
    summed over the ranks (``g`` whole on each): one reduce-scatter in
    f32, the sum returned in ``g``'s dtype."""
    dim %= g.ndim
    k = g.shape[dim] // axis.extent
    parts = g.float().unflatten(dim, (axis.extent, k)).movedim(dim, 0)
    parts = parts.contiguous()
    out = parts.new_empty(parts.shape[1:])
    reduce_scatter_into(out.view(-1), parts.view(-1), axis.group)
    return out.to(g.dtype)


class _GatherIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        dim %= block.ndim
        parts = gathered(block.contiguous(), axis)     # (n, *block)
        return parts.movedim(0, dim).flatten(dim, dim + 1)

    @staticmethod
    def backward(ctx, g):
        return sum_scatter(g, ctx.dim, ctx.axis), None, None


def gather_in(block: torch.Tensor, dim: int, axis) -> torch.Tensor:
    """The whole tensor of which each rank of ``axis`` holds its block
    along ``dim`` (``block`` here, the rank's of ``axis.extent`` equal
    contiguous parts, in rank order): an all-gather, whose backward
    sums the whole gradient over ``axis`` and hands each rank its block
    (`sum_scatter`)."""
    return _GatherIn.apply(block, dim, axis)


def max_over(t: torch.Tensor, axis) -> torch.Tensor:
    """``t`` (no gradient) maxed over the ranks of ``axis``: a copy."""
    t = t.detach().clone(memory_format=torch.contiguous_format)
    if axis is not None and axis.group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=axis.group)
    return t


def sum_in_f32_buckets(tensors: Sequence[torch.Tensor], axis,
                       bucket: int = BUCKET) -> None:
    """Each tensor summed over the ranks of ``axis`` in place: packed in
    order into f32 buckets of at most ``bucket`` entries, each bucket one
    all-reduce, the sums written back in each tensor's dtype. No f32 copy
    of the whole set lives at once."""
    if axis is None or axis.group is None:
        return
    flat: List[torch.Tensor] = []
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("sum_in_f32_buckets takes contiguous tensors")
        flat.extend(t.view(-1).split(bucket))
    total = sum(p.numel() for p in flat)
    if not total:
        return
    buf = torch.empty(min(bucket, total), dtype=torch.float32,
                      device=flat[0].device)
    pending: List[torch.Tensor] = []
    used = 0

    def flush():
        dist.all_reduce(buf[:used], group=axis.group)
        off = 0
        for piece in pending:
            piece.copy_(buf[off:off + piece.numel()])
            off += piece.numel()

    for piece in flat:
        if used + piece.numel() > buf.numel():
            flush()
            pending, used = [], 0
        buf[used:used + piece.numel()].copy_(piece)
        pending.append(piece)
        used += piece.numel()
    flush()


def gather_block(full: torch.Tensor, local: torch.Tensor, block,
                 piece: int = BUCKET) -> None:
    """``full`` <- every rank's ``local`` block (`Block` ``block``) in its
    place along ``block.dim`` (``full`` contiguous). Along dim 0 the
    blocks are gathered straight into ``full``; along a later dim, in
    pieces of whole rows of dim 0 of at most ``piece`` entries, through a
    buffer."""
    axis = block.axis
    if block.dim == 0:
        # a copy: ``local`` may be a view of ``full``
        all_gather_into(full, local.clone(
            memory_format=torch.contiguous_format), axis.group)
        return
    k = block.size(full.shape[block.dim])
    rows = max(1, piece * full.shape[0] // max(full.numel(), 1))
    for r0 in range(0, full.shape[0], rows):
        dst = full[r0:r0 + rows]
        parts = gathered(local[r0:r0 + rows], axis)
        for r in range(axis.extent):
            dst.narrow(block.dim, r * k, k).copy_(parts[r])


def gather_piece(local: torch.Tensor, piece) -> torch.Tensor:
    """The whole leaf of which every "model" rank holds its
    `runtime.param_sharding.Piece` ``piece`` (``local`` here): the
    pieces gathered over the piece's axis and each laid in its place."""
    parts = gathered(local.contiguous(), piece.axis)
    full = local.new_empty(piece.full_shape(local.shape))
    for r in range(piece.axis.extent):
        piece.place(full, parts[r], r)
    return full
