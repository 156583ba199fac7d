"""The steps: train (gradient accumulation, clipping, AdamW), prefill and
serve (greedy decode).

The port of the reference's ``repro.train.steps``. The loss and its
gradients come from ``torch.autograd``; the layer bodies are recomputed
in the backward where the config asks for remat (`models.common.remat`).
A kernel flag set under autograd raises (the reference has no backward
for its kernels either: ROADMAP queue C). Prefill and serve run without
autograd.

Across ranks (``make_train_step(..., mesh=)``, a mesh of (data = d,
model = m), or of (pod = p, data = d, model = m), where "data" below
means the "batch" rule's axes ("pod", "data"), pod-major, and FSDP's
blocks lie over the "fsdp" rule's, the same two): each rank holds the
contiguous rows of its "data" coordinate of the global batch (`data.tokens.TokenDataset.
rows_for_step`) and, under tensor parallelism (m > 1), its pieces of the
parameters (`runtime.param_sharding.tp_pieces`), and runs the loss under
the mesh's binding, where every statistic over the batch is the global
batch's, the loss is the rank's share of the global loss
(`models.common.softmax_xent`, `models.moe`), and the layers run on
local heads (`models.common`) and local experts (`models.moe`); a
block whose heads or width "model" does not divide runs whole on every
rank, or under the ``attn_batch`` fallback on the rank's block of the
rows (`models.attention`). Then, in order: the loss and metrics
summed over "data"; the gradients of the parts that several "model"
ranks use in part summed over "model" (`sum_shared_grads`); the
gradients summed over "data" in f32 buckets
(`runtime.collectives.sum_in_f32_buckets`), written back in their
dtype; the global-norm clip from the whole leaves' norm
(`optim.adamw.global_norm`), on every rank alike; AdamW on the pieces,
with ZeRO-1 (``TrainConfig.zero1``) on each rank's block of the moments;
and the parameters' blocks gathered over "data". The loss, grad norm,
metrics and new state are those of the single-device step on the global
batch, up to the order of the sums. With ``microbatches`` k, each rank
splits its own rows into k: microbatch i of the step is then rows i of
every rank's split.

FSDP (``ParallelConfig.fsdp``, the reference's ZeRO-3): each rank holds,
of every parameter whose rule marks "fsdp", its block over "data" of its
piece (`runtime.param_sharding.fsdp_blocks`), and so do its moments. The
binding carries that layout (`runtime.sharding.fsdp_layout`); each layer
body gathers its layer's blocks inside `models.common.remat`
(`models.common.fsdp_gather`), and their gradients come back
reduce-scattered over "data" in f32 (`runtime.collectives.gather_in`),
once a microbatch. So those leaves skip the "data" sum and the
parameters' gather after AdamW, AdamW runs on the blocks, and the
global norm adds the blocks' squares over "data"; the leaves whole over
"data" (embeddings, norms, the router, the SSM's conv and per-head
leaves) take the path above. With ``microbatches`` k an FSDP leaf's f32
accumulator is its block.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.launch.mesh import binding_for
from repro_torch.models import attention, common
from repro_torch.models.api import Model, family_module
from repro_torch.optim.adamw import (adamw_init, adamw_update, clip_scale,
                                     global_norm)
from repro_torch.runtime import collectives
from repro_torch.runtime import sharding as shlib
from repro_torch.runtime.param_sharding import (Shard, fsdp_blocks,
                                                tp_pieces, zero1_blocks)


def state_blocks(cfg, tcfg: TrainConfig, mesh=None,
                 parallel: Optional[ParallelConfig] = None) -> Dict:
    """The `Shard` of each leaf of a train state of ``cfg`` that this
    rank holds (None: the whole leaf): the parameters' pieces over
    "model" (`runtime.param_sharding.tp_pieces`), split further over
    "data" under ``parallel.fsdp`` (`runtime.param_sharding.fsdp_blocks`),
    and the moments' pieces split over "data" as their parameters are
    under FSDP, else by ZeRO-1 where ``tcfg.zero1``; all None without a
    mesh. A block whose heads or width "model" does not divide is whole
    on every rank (`runtime.param_sharding.tp_layout`), and so are its
    leaves' blocks over "data" of the whole leaf. `checkpoint` reads and
    writes states by it."""
    spec = family_module(cfg).init_params(cfg, None, torch.device("meta"))
    if mesh is None:
        none = tree.map_(lambda _: None, spec)
        return {"params": none, "opt": {"m": none, "v": none, "step": None}}
    with shlib.use_binding(binding_for(mesh, parallel)):
        pieces = tp_pieces(spec, cfg)
        fsdp = fsdp_blocks(spec, pieces)
        blocks = tree.map_(lambda f, z: z if f is None else f, fsdp,
                           zero1_blocks(spec, tcfg.zero1, pieces))

    def shard(piece, block):
        return None if piece is None and block is None else \
            Shard(piece, block)
    params = tree.map_(shard, pieces, fsdp)
    moments = tree.map_(shard, pieces, blocks)
    return {"params": params, "opt": {"m": moments, "v": moments,
                                      "step": None}}


def moment_blocks(layout: Dict) -> Dict:
    """The `Block` of each moment of a `state_blocks` layout within the
    parameter the rank holds, as `optim.adamw` takes them: the ZeRO-1
    block of the rank's piece; None where the moment is the whole piece,
    or where the parameter is held as the same block (FSDP)."""
    return tree.map_(
        lambda m, p: None if m is None or (
            p is not None and p.block is not None) else m.block,
        layout["opt"]["m"], layout["params"])



def init_train_state(model: Model, seed: int = 0,
                     blocks: Optional[Dict] = None) -> Dict:
    """Parameters from ``seed`` (the whole leaves, the same on every
    rank, so one seed gives one model at any layout) and zero moments;
    where ``blocks`` (`state_blocks`) gives them, the rank's pieces (and
    FSDP blocks) of the parameters and the blocks of its moments."""
    params = model.init_params(seed)
    if blocks is None:
        return {"params": params, "opt": adamw_init(params)}
    params = tree.map_(
        lambda p, s: p if s is None else s.take(p).clone(
            memory_format=torch.contiguous_format),
        params, blocks["params"])
    return {"params": params,
            "opt": adamw_init(params, moment_blocks(blocks))}


def sum_shared_grads(grads: Dict, pieces: Dict, axis,
                     rows: bool = False) -> None:
    """The gradients of the parts of pieces that several "model" ranks
    hold (`runtime.param_sharding.Piece.shared`: a shared KV head, KV
    heads whole under split query heads, the SSM's B and C columns, the
    q_norm / k_norm scales), each rank's partial, summed over ``axis``
    in place: each part is laid in a buffer of its whole segment, at its
    place (zeros elsewhere), and the buffers are summed in f32 buckets
    (`collectives.sum_in_f32_buckets`); a part then reads its sum back.
    The leaves of an ``attn_batch`` fallback block (`Piece.rows`) are
    summed only with ``rows`` (the fallback split the step's rows: each
    rank's gradient is of its own); a leaf whole on every rank (piece
    None: a block "model" does not divide, a norm of the residual
    stream) is never summed, since each rank holds its whole gradient."""
    work = []
    for g, piece in zip(tree.leaves(grads), tree.leaves(pieces)):
        if piece is None or (piece.rows and not rows):
            continue
        for seg, off, n in piece.shared():
            mine = g.narrow(piece.dim, off, n)
            at = (piece.axis.index * seg.parts // piece.axis.extent) * n
            shape = list(mine.shape)
            shape[piece.dim] = seg.length
            buf = g.new_zeros(shape)
            buf.narrow(piece.dim, at, n).copy_(mine)
            work.append((mine, buf, piece.dim, at, n))
    collectives.sum_in_f32_buckets([w[1] for w in work], axis)
    for mine, buf, dim, at, n in work:
        mine.copy_(buf.narrow(dim, at, n))


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

    With a ``mesh`` (`launch.mesh.make_mesh`), the step of the module
    doc: ``batch`` is the rows of this rank's "data" coordinate,
    ``state`` holds the pieces and blocks of `state_blocks`, and the
    metrics are the global batch's on every rank. At a mesh of (1, 1)
    it takes the step without a mesh's path (no "model" axis: every
    piece whole, no collective over "model") and computes what that step
    computes, bit for bit. A block whose heads or width "model" does not
    divide runs whole on every rank (`runtime.param_sharding.
    tp_layout`), its gradients whole on each and not summed over
    "model"; an ``attn_batch`` fallback block's are summed over "model"
    where its rows split (`models.attention.rows_axis` of a
    microbatch's rows).

    The new state reuses the old state's storage: parameters and moments
    are updated in place (`optim.adamw.adamw_update`), so the state
    passed in is the state returned."""
    binding = blocks = pieces = fsdp = None
    if mesh is not None:
        binding = binding_for(mesh, parallel)
        # the layout `state_blocks` gives the caller for the state it
        # passes in
        layout = state_blocks(model.cfg, tcfg, mesh, parallel)
        blocks = moment_blocks(layout)
        pieces = tree.map_(lambda s: None if s is None else s.piece,
                           layout["params"])
        fsdp = tree.map_(lambda s: None if s is None else s.block,
                         layout["params"])
        binding.fsdp_layout = _fsdp_layout(model.cfg, fsdp)

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
        # the ranks that split the batch (one rank: a group of one), and
        # those that split the model (None at one)
        axis = (binding.axis_group(binding.rules["batch"])
                if binding is not None else None)
        model_axis = shlib.model_axis()
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
            # the shares of the loss and metrics summed over the ranks
            # of "data" (those of "model" computed the same ones)
            names = sorted(metrics)
            summed = collectives.sum_over(torch.stack(
                [loss] + [metrics[k] for k in names]), axis)
            loss, metrics = summed[0], dict(zip(names, summed[1:]))
            grads = tree.map_(lambda g: g.contiguous(), grads)
            if model_axis is not None:
                split = attention.rows_axis(model.cfg, rows // m)
                sum_shared_grads(grads, pieces, model_axis,
                                 rows=split is not None)
            # the shares' gradients summed over "data" (an FSDP block's
            # came back summed)
            collectives.sum_in_f32_buckets(
                [g for g, blk in zip(tree.leaves(grads), tree.leaves(fsdp))
                 if blk is None], axis)
        gnorm = global_norm(grads, pieces, model_axis, fsdp, axis)
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


def _fsdp_layout(cfg, fsdp: Dict) -> Dict:
    """{leaf path: (dim counted from the end, AxisGroup)} of the FSDP
    blocks ``fsdp`` (a tree of `Block` or None), what the layer bodies
    gather (`models.common.fsdp_gather`)."""
    spec = family_module(cfg).init_params(cfg, None, torch.device("meta"))
    return {path: (blk.dim - len(leaf.shape), blk.axis)
            for (path, leaf), blk in zip(tree.items(spec),
                                         tree.leaves(fsdp))
            if blk is not None}


def serve_binding(model: Model, mesh, parallel: ParallelConfig,
                  global_batch: int, decode: bool = False,
                  seq_len: Optional[int] = None) -> shlib.Binding:
    """The binding of a prefill (or, with ``decode``, a decode) step of a
    ``global_batch`` on ``mesh`` under ``parallel``, as the reference's
    cells bind it (``_mesh_binding``): `launch.mesh.binding_for`'s, with
    the batch over the "batch" rule's axes ("data", or ("pod", "data")
    on a mesh with a "pod" axis) where their extent divides
    ``global_batch`` and else whole on every rank ("batch" bound to no
    axis), and "seq" bound to ``parallel.seq_axes`` that the mesh has
    and the batch leaves it, as `runtime.sharding.resolve` gives them
    to the cache's dims (replicated over "pod"); under
    ``parallel.fsdp`` the parameters' FSDP layout (`state_blocks`).
    A decode step under ``parallel.seq_shard_decode`` is marked
    ``seq_sharded``: its cache is the decode cell's, split along its
    sequence, where the "seq" ranks divide its ``seq_len`` positions;
    where they do not, the reference's resolve drops the axis, and so
    does this binding: the cache is whole along its sequence on every
    rank and decode attends it whole. A decode step without
    ``seq_shard_decode`` keeps the prefill cell's cache: its KV heads
    over "model" where "model" divides them (else every KV head on every
    rank, the queries' heads split as in prefill), every position, the
    new K/V written into the rank's own heads
    (`runtime.param_sharding.cache_layout`)."""
    binding = binding_for(mesh, parallel)
    batch = binding.rules["batch"]
    if global_batch % binding.extent(batch):
        batch = binding.rules["batch"] = ()
    seq = tuple(a for a in parallel.seq_axes
                if a in binding.axis_sizes and a not in batch)
    if seq_len is not None and seq_len % binding.extent(seq):
        seq = ()
    binding.rules["seq"] = seq
    if parallel.fsdp:
        layout = state_blocks(model.cfg, TrainConfig(), mesh, parallel)
        binding.fsdp_layout = _fsdp_layout(model.cfg, tree.map_(
            lambda sh: None if sh is None else sh.block, layout["params"]))
    binding.seq_sharded = decode and parallel.seq_shard_decode
    return binding


def _cell_binding(model: Model, mesh, parallel, global_batch,
                  decode: bool = False, seq_len: Optional[int] = None):
    """`serve_binding` where a ``mesh`` is given (then ``parallel``,
    ``global_batch`` and a decode cell's ``seq_len`` are the cell's,
    `launch.cells.make_cell`), else None."""
    if mesh is None:
        return None
    if parallel is None or global_batch is None:
        raise TypeError("a serving step on a mesh takes the cell's "
                        "parallel and global_batch (launch.cells."
                        "make_cell)")
    return serve_binding(model, mesh, parallel, global_batch, decode,
                         seq_len)


def _bound(binding):
    """``binding`` active in the block; None: the caller's, as a step
    without a mesh always ran."""
    return (contextlib.nullcontext() if binding is None
            else shlib.use_binding(binding))


def _prefill_heads(model: Model, cache: Dict) -> Dict:
    """``cache`` (a prefill's, under a "model" axis) in the prefill
    cell's layout (`runtime.param_sharding.cache_layout`): each KV leaf
    holds the rank's block of the heads where "model" divides their
    count, else every head. A rank's attention leaves it its piece's KV
    heads (one shared by several ranks where they are fewer than the
    ranks: gathered) or, for the enc-dec's self-attention cache that
    its BOS step writes, every head (cut to the block)."""
    axis = shlib.model_axis()
    n = model.cfg.n_kv_heads
    if axis is None:
        return cache
    want = n // axis.extent if n % axis.extent == 0 else n

    def fix(spec, t):
        if isinstance(spec, dict):
            return {k: fix(spec[k], t[k]) for k in t}
        if "kv_heads" not in spec:
            return t
        dim = spec.index("kv_heads")
        if t.shape[dim] == want:
            return t
        if t.shape[dim] == n:
            return t.narrow(dim, axis.index * want, want).contiguous()
        return attention.heads_of_ranks(
            collectives.gathered(t.contiguous(), axis), n, dim)
    return fix(model.cache_specs(), cache)


def make_prefill_step(model: Model, mesh=None,
                      parallel: Optional[ParallelConfig] = None,
                      global_batch: Optional[int] = None) -> Callable:
    """``prefill_step(params, batch) -> (next token (B,) int32, cache)``:
    the prompt's cache and its greedy next token. With a ``mesh``
    (`launch.mesh.make_mesh`), the cell's ``parallel`` and
    ``global_batch`` too (`launch.cells.make_cell` passes all three),
    under `serve_binding`: ``params`` the
    rank's pieces (and FSDP blocks) of `state_blocks`, ``batch`` the
    rank's rows, the layers on local heads, the next token the argmax
    over the whole vocabulary (`models.common.greedy_token`, the same on
    every rank of "model"), and the cache in the prefill cell's layout
    (`runtime.param_sharding.cache_layout`). Without a mesh it computes
    what it always has, bit for bit."""
    binding = _cell_binding(model, mesh, parallel, global_batch)
    cfg = model.cfg

    @torch.no_grad()
    def prefill_step(params: Dict, batch: Dict):
        with _bound(binding):
            logits, cache = model.prefill(params, batch)
            next_tok = common.greedy_token(logits[:, -1], params["embed"],
                                           cfg)
            return next_tok, _prefill_heads(model, cache)

    prefill_step.binding = binding
    return prefill_step


def make_serve_step(model: Model, mesh=None,
                    parallel: Optional[ParallelConfig] = None,
                    global_batch: Optional[int] = None,
                    seq_len: Optional[int] = None) -> Callable:
    """One decode iteration: write KV, attend, next token (greedy:
    deterministic, per the paper's execution model). The cache is
    updated in place (``hybrid.decode_step``). With a ``mesh``, as
    `make_prefill_step`'s, on the cache in the decode cell's layout:
    under ``parallel.seq_shard_decode`` split along its sequence over
    the "seq" ranks (flash-decode, `models.attention`) where they divide
    the cache's ``seq_len`` positions, else the prefill cell's, its KV
    heads over "model" (`serve_binding`). Without a mesh
    it computes what it always has, bit for bit."""
    binding = _cell_binding(model, mesh, parallel, global_batch,
                            decode=True, seq_len=seq_len)
    cfg = model.cfg

    @torch.no_grad()
    def serve_step(params: Dict, tokens: torch.Tensor, cache: Dict,
                   lengths: torch.Tensor):
        with _bound(binding):
            logits, new_cache = model.decode_step(params, tokens, cache,
                                                  lengths)
            next_tok = common.greedy_token(logits[:, -1], params["embed"],
                                           cfg)
        return next_tok[:, None], new_cache, lengths + 1

    serve_step.binding = binding
    return serve_step
