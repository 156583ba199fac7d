#!/usr/bin/env python3
"""Training over the cards of one host: data-parallel scaling, ZeRO-1's
memory, tensor parallelism on 2-D meshes, the experts over "model", f32
checks against one card, and qwen3-8b at full size.

Run from the repository root on a machine with CUDA cards:

    python3 tools/dist_train_scaling.py                 # every card
    python3 tools/dist_train_scaling.py --worlds 1 2 4 --qwen
    python3 tools/dist_train_scaling.py --worlds 2 4 --f32-only
    python3 tools/dist_train_scaling.py --meshes 4x1 2x2 1x4 --qwen
    python3 tools/dist_train_scaling.py --meshes 1x4 2x2 --steps 2
    python3 tools/dist_train_scaling.py --moe --meshes 4x1 2x2 1x4
    python3 tools/dist_train_scaling.py --attn-batch --meshes 1x3 4x1
    python3 tools/dist_train_scaling.py --fsdp --meshes 4x1 2x2 2x2x1 2x1x2

Each world size runs in its own spawn of one process a card (NCCL for
CUDA tensors, gloo for CPU ones, over tcp://localhost on a free port),
through the port's entry points (`launch.mesh.make_mesh`,
`train.steps.make_train_step(..., mesh)`), under
`train.steps.deterministic_algorithms`. ``--worlds n``: the mesh (n, 1),
every card on "data"; ``--meshes DxM``: the mesh (data D, model M),
tensor parallelism over M cards, or ``PxDxM``: the mesh (pod P, data
D, model M) under the reference's multi-pod rules, the batch (and
FSDP's blocks) over ("pod", "data"), its jobs those of the mesh
(P D, M), each timed line also against that mesh's where the call ran
it (each mesh of one world in that world's spawn, in the order given).

  - gemma3-1b, bf16, full width and depth, random weights from seed 0,
    TokenDataset batches: one warm step and ``--steps`` timed steps
    (CUDA events on rank 0; the collectives keep the ranks in step):
    step ms, tok/s over every card, peak MB a card (the largest over
    the ranks), loss and grad norm finite. ``--worlds``: (4, 2048) a
    card, ZeRO-1 on, then off, and scale efficiency against world 1
    (same call); ``--meshes``: a global (16, 2048), ZeRO-1 on (the --worlds
    4-card batch, so the meshes of 4 cards compare with (4, 1));
  - f32 checks (`f32_check`): at a "data" extent >= 2, gemma3-1b in f32
    at full width with remat, a global batch of (2n, 256), one step
    against the single-card step on the global batch (rank 0's card):
    the metrics, the moments in each leaf's relative L2 norm, and the
    parameters against AdamW's step from the run's own moments; then
    the same step with each fault of `controls`, which the check must
    fail: the gradients left unsummed over "data", the ZeRO-1 blocks of
    the parameters left ungathered, and at a "model" extent >= 2 the
    "model" sum of a shared KV head's gradient left out (gemma3-1b, one
    KV head for all) or the SSM's gated norm over the rank's width
    (mamba2-130m, which is checked too on meshes with "model" >= 2), and
    on a mesh with a "pod" axis the gradients summed over "data" alone;
  - with ``--qwen``: qwen3-8b, bf16, full width and depth, ZeRO-1, a
    warm step and ``--steps`` timed ones: tok/s, peak MB a card, loss
    and grad norm of each step. ``--worlds``: (1, 2048) a card at the
    largest world; ``--meshes``: a global (4, 2048) on every mesh. And
    its state on one card reckoned by bytes (parameters and gradients
    in bf16, two f32 moments: 12 B a parameter);
  - with ``--moe`` (with ``--meshes``, in place of the jobs above): the
    f32 checks on granite-moe-3b-a800m's smoke config without its dead
    experts (V1, V2, V3: 8 experts, so every rank of "model" holds some
    live ones) and on deepseek-v2-236b's smoke (MLA, a shared expert),
    at a "model" extent >= 2, each with the two faults of the experts'
    collectives (`controls`), which must read at least 10 times over
    MOMENT_LIMIT; granite-moe-3b-a800m bf16 at full width and depth
    (V2) at a global MOE_SHAPE on every mesh, V1 and V3 too where
    "data" is 1; deepseek-v2-236b bf16 at full width, DEEPSEEK_LAYERS
    of its 60 layers, at a global DEEPSEEK_SHAPE where "data" is 1 and
    "model" at least 4. Every job records the
    experts each MoE layer routed each token to and asserts them equal
    over "model" (`routes_agree`). Each timed line gives the state a
    card by bytes (its pieces of the parameters and gradients, its
    blocks of the moments).
  - with ``--attn-batch`` (with ``--meshes``, in place of the jobs
    above; lines tagged ``[fallback]``): where "model" does not divide
    a block (at "model" 3: gemma3-1b's 4 heads, qwen2-vl-2b's 2 KV heads
    and d_ff 8960, granite-moe's 8 KV heads under 24 split query
    heads), the f32 checks of gemma3-1b at full width with
    ``attn_batch_fallback`` off (attention whole on every rank) and on
    (its rows split over "model"), each with the faults of its layout
    (`controls`: a whole leaf's gradient summed over "model", the
    fallback's "model" sum left out); bf16 at full width at
    FALLBACK_SHAPE: gemma3-1b off and on, qwen2-vl-2b and
    granite-moe-3b-a800m as configured, each against the mesh (1, 1)
    at the same global batch (run first, in a world of one), and
    gemma3-1b's attention block of one layer alone, forward and
    backward, off and on (`attn_timed`). At a
    "data" extent >= 2 with "model" 1, MoE V2's dispatch groups
    straddling ranks' rows: the f32 check of granite-moe's smoke
    without its dead experts at V2_F32_SEQ tokens a row, and
    granite-moe V2 bf16 at full width at V2_ACROSS_SHAPE (128 tokens a
    rank at 4 ranks, groups of 256), against the mesh (1, 1).

Prints the card's name and power limit (``nvidia-smi``) and each result
line; writes the results as JSON to ``--out`` (default
build/dist_train_scaling.json). Exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

BF16_SHAPE = (4, 2048)          # a card ("data" rank) of --worlds
QWEN_SHAPE = (1, 2048)          # a card of --worlds
TP_GEMMA = (16, 2048)           # global, --meshes
TP_QWEN = (4, 2048)             # global, --meshes
MOE_SHAPE = (4, 2048)           # global, --moe
DEEPSEEK_SHAPE = (1, 2048)      # global, --moe
DEEPSEEK_LAYERS = 4             # of 60: the depth it is served at
FALLBACK_SHAPE = (3, 2048)      # global, --attn-batch at "model" 3
V2_ACROSS_SHAPE = (4, 128)      # global, --attn-batch at "data" >= 2
V2_F32_SEQ = 16                 # the f32 check's V2 groups straddle ranks
F32_SEQ = 256
# --moe's f32 checks: smoke configs (name, arch, overrides); granite-moe
# without the dead experts (with them, its 8 live experts lie on rank 0
# at "model" 2 and 4)
MOE_F32 = (("granite-moe-3b-a800m", {"n_experts_padded": 0,
                                     "moe_variant": "dynamic"}),
           ("granite-moe-3b-a800m", {"n_experts_padded": 0}),
           ("granite-moe-3b-a800m", {"n_experts_padded": 0,
                                     "moe_variant": "sparse"}),
           ("deepseek-v2-236b", {}))


def say(msg: str) -> None:
    print(msg, flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


# ---------------------------------------------------------------------------
# One rank
# ---------------------------------------------------------------------------


def _start(rank: int, world: int, port: int, device: str) -> None:
    """The process group of one rank; its card set first."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch.distributed as dist
    if device == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        "cpu:gloo,cuda:nccl" if device == "cuda" else "gloo",
        init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)


def _axes(shape) -> tuple:
    """The axis names of a mesh shape: (data, model), or (pod, data,
    model)."""
    return ("pod", "data", "model")[3 - len(shape):]


def _mesh(shape, device: str):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(tuple(shape), _axes(shape), device_type=device)


def _dm(shape) -> tuple:
    """(data, model) of a mesh shape: the ranks that split the batch
    (pod x data) and those that split the model."""
    return int(np.prod(shape[:-1])), shape[-1]


def _extents(mesh) -> tuple:
    """(data, model) extents of a mesh (`_dm`)."""
    return _dm(tuple(int(n) for n in mesh.mesh.shape))


def _batch_axis(mesh):
    """The ranks that split the batch: the "batch" rule's group
    ("data", or ("pod", "data"))."""
    from repro_torch.launch.mesh import binding_for
    binding = binding_for(mesh)
    return binding.axis_group(binding.rules["batch"])


def _dev():
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _config(arch: str, dtype: str, smoke: bool, **overrides):
    from repro_torch.configs import get_config, get_smoke
    return (get_smoke if smoke else get_config)(
        arch, param_dtype=dtype, compute_dtype=dtype, **overrides)


@contextlib.contextmanager
def routes_recorded(on: bool = True):
    """The experts that each call of `models.moe.route` in the block
    picked for each token (its idx), in call order, into the list
    yielded; ``on`` False: nothing recorded."""
    from repro_torch.models import moe
    kept, seen = moe.route, []

    def recording(cfg, router_w, x_flat):
        out = kept(cfg, router_w, x_flat)
        seen.append(out[1].detach().clone())
        return out
    if on:
        moe.route = recording
    try:
        yield seen
    finally:
        moe.route = kept


def routes_agree(seen: list, mesh) -> bool:
    """Whether every rank of the mesh's "model" axis routed each token
    of ``seen`` (`routes_recorded`) alike: one all-gather of them all."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import binding_for
    from repro_torch.runtime import collectives
    axis = binding_for(mesh).axis_group(("model",))
    if axis.extent == 1 or not seen:      # one rank, or no MoE layer
        return True
    mine = torch.cat([i.reshape(-1) for i in seen]).to(_dev())
    every = collectives.gathered(mine, axis)
    agree = torch.tensor([float(bool((every == every[0]).all()))],
                         device=_dev())
    dist.all_reduce(agree, op=dist.ReduceOp.MIN)
    return bool(agree.item())


def state_bytes(state: dict) -> float:
    """Bytes of this rank's train state as held (its pieces of the
    parameters and, as many, of their gradients; its blocks of the
    moments)."""
    from repro_torch import tree
    size = lambda ts: sum(t.numel() * t.element_size()   # noqa: E731
                          for t in tree.leaves(ts))
    return (2 * size(state["params"]) + size(state["opt"]["m"])
            + size(state["opt"]["v"]))


class _Timer:
    """CUDA events on the card, the host clock on the CPU (a debug run)."""

    def __init__(self, dev):
        self.cuda = dev.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def start(self):
        self.sync()
        if self.cuda:
            self.s, self.e = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
            self.s.record()
        self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.e.record()
            self.sync()
            return self.s.elapsed_time(self.e)
        return (time.perf_counter() - self.t0) * 1e3


def timed_run(mesh, arch: str, shape, steps: int, zero1: bool,
              overrides: dict = None, dtype: str = "bfloat16",
              smoke: bool = False, fsdp: bool = False) -> dict:
    """Warm step + ``steps`` timed steps of ``arch`` (``overrides`` on
    its config) on the mesh at the global batch ``shape``, each rank on
    the rows of its "data" coordinate, with ``fsdp`` under
    ``ParallelConfig(fsdp=True)``; rank 0's CUDA-event times, every
    rank's peak memory (of the whole run, and of `init_train_state`
    alone) and state bytes (the largest), and whether the warm step
    routed alike over "model" (`routes_agree`)."""
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.configs import ParallelConfig, TrainConfig
    from repro_torch.data import TokenDataset
    from repro_torch.models import get_model
    from repro_torch.models.api import family_module
    from repro_torch.train.steps import (deterministic_algorithms,
                                         init_train_state, make_train_step,
                                         state_blocks)

    cfg = _config(arch, dtype, smoke, **(overrides or {}))
    world = mesh.size()
    axis = _batch_axis(mesh)
    dev = _dev()
    timer = _Timer(dev)
    if timer.cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg, device=dev)
    tcfg = TrainConfig(zero1=zero1)
    parallel = ParallelConfig(fsdp=fsdp)
    state = init_train_state(model, 0, state_blocks(cfg, tcfg, mesh,
                                                    parallel))
    init_peak = (torch.cuda.max_memory_allocated() / 1e6 if timer.cuda
                 else float("nan"))
    step_fn = make_train_step(model, tcfg, mesh, parallel)
    data = TokenDataset(cfg, shape[0], shape[1], seed=0)
    ms, losses, norms = [], [], []
    with deterministic_algorithms():
        for i in range(steps + 1):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in
                     data.rows_for_step(i + 1, axis.index,
                                        axis.extent).items()}
            dist.barrier()
            # the warm step's routes, held equal over "model" below
            with routes_recorded(i == 0 and bool(cfg.n_experts)) as seen:
                timer.start()
                state, metrics = step_fn(state, batch)
                ms.append(timer.stop())
            if i == 0:
                routes = seen
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
    agree = routes_agree(routes, mesh)
    del routes
    peak = torch.tensor([torch.cuda.max_memory_allocated() / 1e6
                         if timer.cuda else float("nan"),
                         state_bytes(state) / 1e9, init_peak], device=dev)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    n_params = sum(p.numel() for p in tree.leaves(
        family_module(cfg).init_params(cfg, None, torch.device("meta"))))
    del state, step_fn, model
    if timer.cuda:
        torch.cuda.empty_cache()
    timed = ms[1:]
    toks = shape[0] * shape[1]
    return dict(arch=arch, dtype=dtype, world=world,
                overrides=overrides or {},
                mesh=list(mesh.mesh.shape), zero1=zero1, fsdp=fsdp,
                variant=cfg.moe_variant if cfg.n_experts else None,
                layers=cfg.n_layers,
                rows_a_card=shape[0] // axis.extent, global_rows=shape[0],
                seq=shape[1], params=n_params,
                warm_ms=ms[0], step_ms=timed,
                tok_s=toks / np.mean(timed) * 1e3,
                peak_mb_a_card=float(peak[0].item()),
                state_gb=float(peak[1].item()),
                init_peak_mb=float(peak[2].item()), loss=losses,
                grad_norm=norms, routes_agree=agree,
                finite=bool(np.all(np.isfinite(losses + norms))))


def attn_timed(mesh, arch: str, shape, overrides: dict = None,
               smoke: bool = False, reps: int = 10) -> dict:
    """The attention block of ``arch``'s layer 0 (bf16, full width;
    `models.attention.gqa_attention` with that layer's window, as
    `models.transformer` calls it) on this rank's rows of a global batch
    of ``shape`` drawn from seed 0 (the same on every rank), its pieces
    of the layer's parameters under the mesh's binding: forward and
    backward, ``reps`` calls after a warm one, CUDA events on rank 0:
    ms a call. Where "model" does not divide the heads this is the whole
    block on every rank, or under ``attn_batch_fallback`` its share of
    the rows."""
    from repro_torch import tree
    from repro_torch.configs import TrainConfig
    from repro_torch.launch.mesh import binding_for
    from repro_torch.models import attention, common, get_model
    from repro_torch.models.transformer import _kinds
    from repro_torch.runtime.sharding import use_binding
    from repro_torch.train.steps import state_blocks
    import torch.distributed as dist

    cfg = _config(arch, "bfloat16", smoke, **(overrides or {}))
    dev = _dev()
    timer = _Timer(dev)
    binding = binding_for(mesh)
    data = _batch_axis(mesh)
    whole = get_model(cfg, device=dev).init_params(0)["layers"]["attn"]
    shards = state_blocks(cfg, TrainConfig(), mesh)["params"]["layers"][
        "attn"]
    params = tree.map_(lambda p, s: (p if s is None else s.take(p))[0]
                       .contiguous().requires_grad_(), whole, shards)
    del whole
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = shape[0] // data.extent
    x = torch.randn((shape[0], shape[1], cfg.d_model), generator=gen,
                    device=dev, dtype=torch.bfloat16)
    x = x[data.index * rows:(data.index + 1) * rows].contiguous()
    x.requires_grad_()
    pos = common.positions_of(x[..., 0])
    is_local, window = _kinds(cfg, dev)

    def call():
        y = attention.gqa_attention(params, cfg, x, pos, window=window[0],
                                    is_local=is_local[0])
        torch.autograd.grad(y, [x] + tree.leaves(params),
                            grad_outputs=torch.ones_like(y))
    with use_binding(binding):
        call()
        dist.barrier()
        timer.start()
        for _ in range(reps):
            call()
        ms = timer.stop() / reps
    return dict(kind="attn", arch=arch, overrides=overrides or {},
                mesh=list(mesh.mesh.shape), world=mesh.size(),
                global_rows=shape[0], seq=shape[1], reps=reps, ms=ms)


F32_LIMIT = 1e-5                # rtol of the metrics and the parameters
# each leaf's moments, relative L2: four times the worst reading at
# gemma3-1b's full width on H100s (6.85e-6 at 2 cards, 6.99e-6 at 4),
# rounded up; the unsummed fault reads 0.997-1.69 there
MOMENT_LIMIT = 5e-5
# faults the f32 check must catch (`controls`): the gradients left
# unsummed over "data", the parameters' ZeRO-1 blocks left ungathered,
# the "model" sum of a shared KV head's gradient left out, the SSM's
# gated norm over the rank's width only, the experts' input without its
# backward "model" sum, and the combine weights without theirs (the
# router's gradient left partial); under FSDP, the gathered weights'
# gradients left unsummed over "data" (each rank keeps its block of its
# own), and each gathered layer cached across steps (step 2 runs on
# step 1's weights); a block "model" does not divide: the gradients of
# its whole leaves summed over "model" as if each rank's were partial,
# and the attn_batch fallback's "model" sum of its leaves left out; on a
# mesh with a "pod" axis, the gradients summed over "data" alone
FAULTS = ("unsummed", "ungathered", "kv_unsummed", "local_norm",
          "experts_input_uncopied", "combine_weights_uncopied",
          "fsdp_unsummed", "fsdp_cached", "whole_summed", "rows_unsummed",
          "pod_unsummed")
# the experts' and FSDP's faults must read at least this many times
# MOMENT_LIMIT
MOE_FAULT_FACTOR = 10
# FSDP's f32 check runs this many steps (the cached fault shows at 2)
FSDP_STEPS = 2


def controls(cfg, mesh, fsdp: bool = False) -> tuple:
    """The faults of FAULTS that break the step of ``cfg`` on ``mesh``
    (a fault the mesh does not reach would pass the check); with
    ``fsdp`` FSDP's two in place of the data axis's."""
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.runtime.param_sharding import tp_layout
    data, model = _extents(mesh)
    out = (() if data == 1 else ("fsdp_unsummed", "fsdp_cached") if fsdp
           else ("unsummed", "ungathered"))
    if dict(mesh_axes(mesh)).get("pod", 1) > 1:
        out += ("pod_unsummed",)
    layout = tp_layout(cfg, model) if model > 1 else {}
    if (layout.get("attn") == "split" and not cfg.use_mla
            and layout["kv"] != "split"):
        out += ("kv_unsummed",)
    if layout.get("ssm") == "split":
        out += ("local_norm",)
    if layout.get("experts", "whole") != "whole":
        out += ("experts_input_uncopied", "combine_weights_uncopied")
    if "whole" in layout.values():
        out += ("whole_summed",)
    if layout.get("attn") == "rows":
        out += ("rows_unsummed",)
    return out


@contextlib.contextmanager
def fault_in(fault):
    """The step broken by ``fault`` (one of FAULTS, or None) inside the
    block."""
    from repro_torch.models import common, moe
    from repro_torch.runtime import collectives
    from repro_torch.train import steps
    kept = (collectives.sum_in_f32_buckets, collectives.gather_block,
            steps.sum_shared_grads, common.rmsnorm, moe.expert_inputs,
            collectives.sum_scatter, collectives.gather_in)

    def skip_kv(grads, pieces, axis, rows=False):
        from repro_torch import tree
        names = [k.split("/")[-1] for k, _ in tree.items(pieces)]
        pieces = tree.unflatten(pieces, [
            None if n in ("wk", "wv") else p
            for n, p in zip(names, tree.leaves(pieces))])
        return kept[2](grads, pieces, axis, rows)

    def whole_summed(grads, pieces, axis, rows=False):
        # each whole leaf of a layer block taken for a part every rank
        # holds, its gradient summed over "model"
        from repro_torch import tree
        from repro_torch.runtime.param_sharding import Piece, Segment
        blocks = ("attn", "mlp", "ssm", "moe")
        pieces = tree.unflatten(pieces, [
            Piece(g.ndim - 1, (Segment(0, g.shape[-1], 1),), axis)
            if p is None and any(b in path.split("/") for b in blocks)
            else p for (path, p), g in zip(tree.items(pieces),
                                           tree.leaves(grads))])
        return kept[2](grads, pieces, axis, rows)

    def rows_unsummed(grads, pieces, axis, rows=False):
        return kept[2](grads, pieces, axis, False)

    def data_only(tensors, axis, *args, **kwargs):
        # the sum over ("pod", "data") taken over "data" alone
        from repro_torch.runtime import sharding
        if axis is not None and "pod" in axis.axes:
            axis = sharding.current_binding().axis_group(("data",))
        return kept[0](tensors, axis, *args, **kwargs)

    def local_norm(params, x, eps=1e-6, axis=None):
        return kept[3](params, x, eps)

    def uncopied(which):
        def inputs(x_flat, w, axis):
            x_in, w_in = kept[4](x_flat, w, axis)
            return (x_flat, w_in) if which == "x" else (x_in, w)
        return inputs

    def own_block(g, dim, axis):
        dim %= g.ndim
        k = g.shape[dim] // axis.extent
        return g.narrow(dim, axis.index * k, k).contiguous()

    cache = {}

    def cached(block, dim, axis):
        # the values of the first gather of this block (its storage is
        # updated in place each step), the gradient of this one
        out = kept[6](block, dim, axis)
        key = (block.data_ptr(), tuple(block.shape), dim)
        stale = cache.setdefault(key, out.detach().clone())
        return stale + (out - out.detach())

    try:
        if fault == "unsummed":
            collectives.sum_in_f32_buckets = lambda *a, **k: None
        elif fault == "ungathered":
            collectives.gather_block = lambda *a, **k: None
        elif fault == "kv_unsummed":
            steps.sum_shared_grads = skip_kv
        elif fault == "local_norm":
            common.rmsnorm = local_norm
        elif fault == "experts_input_uncopied":
            moe.expert_inputs = uncopied("x")
        elif fault == "combine_weights_uncopied":
            moe.expert_inputs = uncopied("w")
        elif fault == "fsdp_unsummed":
            collectives.sum_scatter = own_block
        elif fault == "fsdp_cached":
            collectives.gather_in = cached
        elif fault == "whole_summed":
            steps.sum_shared_grads = whole_summed
        elif fault == "rows_unsummed":
            steps.sum_shared_grads = rows_unsummed
        elif fault == "pod_unsummed":
            collectives.sum_in_f32_buckets = data_only
        elif fault is not None:
            raise ValueError(fault)
        yield
    finally:
        (collectives.sum_in_f32_buckets, collectives.gather_block,
         steps.sum_shared_grads, common.rmsnorm, moe.expert_inputs,
         collectives.sum_scatter, collectives.gather_in) = kept


def _dp_step(mesh, model, tcfg, data, fault=None, fsdp: bool = False,
             steps: int = 1):
    """``steps`` steps on the mesh from ``model.init_params(0)`` (this
    rank's pieces of it) on the rows of this rank's "data" coordinate
    of the global batch, with ``fsdp`` under ``ParallelConfig(fsdp=
    True)``; ``fault`` (one of FAULTS) breaks them. The whole state on
    rank 0's host after each step (gathered inside the fault's block
    where ``steps`` > 1, so that its state carries from step to step:
    FSDP's faults leave the gathers of a save alone), each step's
    metrics, and whether the steps routed alike over "model"
    (`routes_agree`)."""
    from repro_torch import checkpoint
    from repro_torch.configs import ParallelConfig
    from repro_torch.train.steps import (deterministic_algorithms,
                                         init_train_state, make_train_step,
                                         state_blocks)
    axis = _batch_axis(mesh)
    dev = _dev()
    parallel = ParallelConfig(fsdp=fsdp)
    blocks = state_blocks(model.cfg, tcfg, mesh, parallel)
    state = init_train_state(model, 0, blocks)
    step_fn = make_train_step(model, tcfg, mesh, parallel)
    wholes, metrics = [], []
    with fault_in(fault), deterministic_algorithms(), \
            routes_recorded(bool(model.cfg.n_experts)) as seen:
        for i in range(1, steps + 1):
            rows = data.rows_for_step(i, axis.index, axis.extent)
            state, m = step_fn(
                state, {k: torch.from_numpy(v).to(dev)
                        for k, v in rows.items()})
            metrics.append({k: float(v) for k, v in m.items()})
            if i < steps:
                wholes.append(checkpoint.host_tree(state, blocks))
    wholes.append(checkpoint.host_tree(state, blocks))
    return wholes, metrics, routes_agree(seen, mesh)


def _held(dp, dp_metrics, one, one_metrics, init, tcfg, lr, step=1
          ) -> dict:
    """`f32_check`'s criterion: the data-parallel state ``dp`` after
    step ``step`` against the single card's ``one`` (whole states by
    path; ``init`` the parameters the data-parallel step started
    from)."""
    dev = _dev()
    worst_metric = max(abs(dp_metrics[k] - one_metrics[k])
                       / max(abs(one_metrics[k]), 1e-30) for k in one_metrics)
    worst_moment, worst_param, apart = 0.0, 0.0, 0
    bad = []
    for leaf, p0 in init.items():
        for name in ("m", "v"):
            ref = one[f"opt/{name}/{leaf}"].double()
            got = dp[f"opt/{name}/{leaf}"].to(dev).double()
            rel = float((got - ref).norm() / ref.norm().clamp(min=1e-300))
            worst_moment = max(worst_moment, rel)
            if rel > MOMENT_LIMIT:
                bad.append(f"opt/{name}/{leaf}")
        m = dp[f"opt/m/{leaf}"].to(dev).double() / (1 - tcfg.b1 ** step)
        v = dp[f"opt/v/{leaf}"].to(dev).double() / (1 - tcfg.b2 ** step)
        p0 = p0.to(dev).double()
        delta = m / (v.sqrt() + tcfg.eps)
        if p0.ndim >= 2:
            delta = delta + tcfg.weight_decay * p0
        want = p0 - lr * delta
        got = dp[f"params/{leaf}"].to(dev).double()
        # the error over its tolerance: within it at most 1
        over = float(((got - want).abs() / (
            F32_LIMIT * (want.abs() + want.abs().max()))).max())
        worst_param = max(worst_param, over)
        if over > 1:
            bad.append(f"params/{leaf}")
        ref = one[f"params/{leaf}"].double()
        apart += int(((got - ref).abs() > F32_LIMIT * ref.abs()
                      + F32_LIMIT * ref.abs().max()).sum())
    n = sum(p.numel() for p in init.values())
    return dict(loss=[dp_metrics["loss"], one_metrics["loss"]],
                grad_norm=[dp_metrics["grad_norm"],
                           one_metrics["grad_norm"]],
                worst_metric_rel=worst_metric,
                worst_moment_rel_l2=worst_moment,
                param_err_over_tol=worst_param, params_apart=apart / n,
                leaves_off=bad, ok=worst_metric <= F32_LIMIT and not bad)


def _worst(held: list) -> dict:
    """`_held`'s readings of several steps as one: the worst of each, the
    leaves off in any, every step's loss and grad norm pairs, ok where
    every step is."""
    out = dict(held[-1])
    for k in ("worst_metric_rel", "worst_moment_rel_l2",
              "param_err_over_tol", "params_apart"):
        out[k] = max(h[k] for h in held)
    out["leaves_off"] = sorted({x for h in held for x in h["leaves_off"]})
    out["loss"] = [x for h in held for x in h["loss"]]
    out["grad_norm"] = [x for h in held for x in h["grad_norm"]]
    out["ok"] = all(h["ok"] for h in held)
    return out


def f32_check(mesh, smoke: bool = False, arch: str = "gemma3-1b",
              overrides: dict = None, fsdp: bool = False,
              seq: int = F32_SEQ) -> dict:
    """``arch`` in f32 with remat (``overrides`` on its config), global
    batch (2n, ``seq``), n the mesh's ranks: one step on the mesh against
    the single-card step on the global batch (rank 0), with ``fsdp``
    FSDP_STEPS steps under ``ParallelConfig(fsdp=True)``, each against
    the single card's step from the state the mesh's step started from
    (step 1 from the initial one, step 2 from the mesh's own step-1
    state: a router near tie at rounding level then moves neither), by
    `_held`: the metrics within
    rtol F32_LIMIT; each leaf's moments m and v (the clipped gradient and
    its square) within MOMENT_LIMIT of the single card's in the relative
    L2 norm; and every parameter equal, within rtol F32_LIMIT and atol
    F32_LIMIT * max|p|, to its initial value moved by AdamW's step-1
    update computed in float64 from the data-parallel run's own moments
    (which catches a block the ZeRO-1 gather left stale; at step 2,
    from its own parameters after step 1). Parameters are
    not held to the single card's entry by entry: step 1 moves each by
    about lr * g / (|g| + eps), so a gradient at rounding level, common
    at full width, moves it by up to lr either way. The step is then run
    with each fault of `controls`, and each must fail the criterion
    (``controls_caught``; the experts' and FSDP's faults by at least
    MOE_FAULT_FACTOR times MOMENT_LIMIT in the moments). With experts,
    the unbroken step must route alike over "model"
    (``routes_agree``)."""
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.configs import TrainConfig
    from repro_torch.data import TokenDataset
    from repro_torch.models import get_model
    from repro_torch.models.api import family_module
    from repro_torch.optim import adamw_init, cosine_schedule
    from repro_torch.train.steps import (deterministic_algorithms,
                                         make_train_step)

    world = mesh.size()
    cfg = _config(arch, "float32", smoke, remat=True, **(overrides or {}))
    dev = _dev()
    model = get_model(cfg, device=dev)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    data = TokenDataset(cfg, 2 * world, seq, seed=0)
    lead = dist.get_rank() == 0
    steps = FSDP_STEPS if fsdp else 1
    one_step = make_train_step(model, tcfg)
    spec = family_module(cfg).init_params(cfg, None, torch.device("meta"))
    like = {"params": spec, "opt": {"m": spec, "v": spec, "step": None}}

    def on_one_card(flat: dict, i: int) -> tuple:
        """The single card's step ``i`` on the global batch from the
        whole state ``flat`` ({path: tensor}): its state and metrics."""
        state = tree.unflatten(like, [flat[k].to(dev, copy=True)
                                      for k, _ in tree.items(like)])
        with deterministic_algorithms():
            state, m = one_step(state, {
                k: torch.from_numpy(v).to(dev)
                for k, v in data.batch_for_step(i).items()})
        return (dict(tree.items(state)),
                {k: float(v) for k, v in m.items()})

    first = init = None
    if lead:
        init = dict(tree.items(model.init_params(0)))
        params = model.init_params(0)
        first = on_one_card(dict(tree.items(
            {"params": params, "opt": adamw_init(params)})), 1)
    dist.barrier()
    out = None
    for fault in (None,) + controls(cfg, mesh, fsdp):
        dps, dp_metrics, agree = _dp_step(mesh, model, tcfg, data, fault,
                                          fsdp, steps)
        if lead:
            held = [_held(dps[0], dp_metrics[0], *first, init, tcfg,
                          float(cosine_schedule(tcfg)(1)))]
            for i in range(2, steps + 1):
                # from the run's own state after step i - 1
                before = dps[i - 2]
                held.append(_held(
                    dps[i - 1], dp_metrics[i - 1],
                    *on_one_card(before, i),
                    {k[len("params/"):]: v for k, v in before.items()
                     if k.startswith("params/")},
                    tcfg, float(cosine_schedule(tcfg)(i)), i))
            held = _worst(held)
            if fault is None:
                out = dict(arch=cfg.name, world=world,
                           variant=cfg.moe_variant if cfg.n_experts
                           else None, overrides=overrides or {},
                           mesh=list(mesh.mesh.shape), fsdp=fsdp,
                           steps=steps,
                           global_batch=[2 * world, seq], **held,
                           routes_agree=agree, controls={})
            else:
                out["controls"][fault] = {
                    k: held[k] for k in ("worst_metric_rel",
                                         "worst_moment_rel_l2",
                                         "param_err_over_tol", "ok")}
        del dps
        dist.barrier()
    if lead:
        out["controls_caught"] = not any(
            c["ok"] or (k.startswith(("experts_", "combine_", "fsdp_")) and
                        c["worst_moment_rel_l2"]
                        < MOE_FAULT_FACTOR * MOMENT_LIMIT)
            for k, c in out["controls"].items())
        out["ok"] = (out["ok"] and out["controls_caught"]
                     and out["routes_agree"])
    del first, init
    return out


def rank_main(rank: int, world: int, port: int, jobs: list,
              out_path: str, device: str, smoke: bool) -> None:
    """``jobs`` on this rank, each ``(kind, mesh shape, *args)`` with
    kind "timed" (`timed_run`: arch, shape, steps, zero1[, overrides])
    or "f32" (`f32_check`: arch[, overrides[, smoke[, seq]]], a smoke
    config where ``smoke`` or the job says so), either with "+fsdp" (under
    ``ParallelConfig(fsdp=True)``); each result with the job's kernel
    launch counts."""
    import torch.distributed as dist
    from repro_torch import kernels
    _start(rank, world, port, device)
    results = []
    try:
        for kind, shape, *args in jobs:
            mesh = _mesh(shape, device)
            kernels.reset_launch_counts()
            kind, _, flag = kind.partition("+")
            if kind == "timed":
                r = timed_run(mesh, *args, smoke=smoke, fsdp=flag == "fsdp")
            elif kind == "attn":
                r = attn_timed(mesh, *args, smoke=smoke)
            else:
                arch, overrides, job_smoke, seq = (
                    list(args) + [None, False, F32_SEQ][len(args) - 1:])[:4]
                r = f32_check(mesh, smoke or job_smoke, arch, overrides,
                              fsdp=flag == "fsdp", seq=seq)
            # no kernel lies on the training path: each kernel's launches
            # in this job, summed over the ranks
            counts = kernels.launch_counts()
            names = sorted(counts)
            total = torch.tensor([float(counts[k]) for k in names])
            dist.all_reduce(total)
            if r is not None:
                r["launches"] = dict(zip(names, (int(x) for x in total)))
            results.append(r)
            if device == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(results, f)


def run_world(world: int, jobs: list, tmp: str, device: str = "cuda",
              smoke: bool = False) -> list:
    """``jobs`` (`rank_main`) on ``world`` cards, one process a card;
    rank 0's results."""
    path = os.path.join(tmp, f"world{world}.json")
    mp.start_processes(rank_main, args=(world, free_port(), jobs, path,
                                        device, smoke),
                       nprocs=world, join=True, start_method="spawn")
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------


def world_jobs(world: int, steps: int, f32_only: bool, qwen: bool) -> list:
    """``--worlds``: the mesh (world, 1)."""
    mesh = (world, 1)
    jobs = [("f32", mesh, "gemma3-1b")] if world >= 2 else []
    if not f32_only:
        jobs += [("timed", mesh, "gemma3-1b",
                  (BF16_SHAPE[0] * world, BF16_SHAPE[1]), steps, zero1)
                 for zero1 in (True, False)]
    if qwen:
        jobs.append(("timed", mesh, "qwen3-8b",
                     (QWEN_SHAPE[0] * world, QWEN_SHAPE[1]), steps, True))
    return jobs


def mesh_jobs(mesh, steps: int, f32_only: bool, qwen: bool) -> list:
    """``--meshes``: the f32 checks (gemma3-1b at a "data" or "model"
    extent >= 2, mamba2-130m at "model" >= 2), gemma3-1b bf16 at
    TP_GEMMA, and qwen3-8b at TP_QWEN."""
    data, model = _dm(mesh)
    jobs = []
    if data > 1 or model > 1:
        jobs.append(("f32", mesh, "gemma3-1b"))
    if model > 1:
        jobs.append(("f32", mesh, "mamba2-130m"))
    if not f32_only:
        jobs.append(("timed", mesh, "gemma3-1b", TP_GEMMA, steps, True))
    if qwen:
        jobs.append(("timed", mesh, "qwen3-8b", TP_QWEN, steps, True))
    return jobs


def moe_jobs(mesh, steps: int, f32_only: bool, timed: str = "all"
             ) -> list:
    """``--moe``: the f32 checks of MOE_F32 at a "model" extent >= 2;
    granite-moe (V2) bf16 at MOE_SHAPE on every mesh; with ``timed``
    "all", V1 and V3 too where "data" is 1, and deepseek-v2 at
    DEEPSEEK_LAYERS layers and DEEPSEEK_SHAPE where "data" is 1 and
    "model" at least 4 (its state fits no fewer cards)."""
    data, model = _dm(mesh)
    jobs = ([("f32", mesh, arch, over, True) for arch, over in MOE_F32]
            if model > 1 else [])
    if f32_only:
        return jobs
    granite = ("granite-moe-3b-a800m", MOE_SHAPE, steps, True)
    jobs.append(("timed", mesh) + granite)
    if data == 1 and timed == "all":
        jobs += [("timed", mesh) + granite + ({"moe_variant": v},)
                 for v in ("dynamic", "sparse")]
        if model >= 4:
            jobs.append(("timed", mesh, "deepseek-v2-236b", DEEPSEEK_SHAPE,
                         steps, True, {"n_layers": DEEPSEEK_LAYERS}))
    return jobs


# FSDP's f32 checks: smoke configs (arch, overrides), one of each rule
# ("fsdp" on the input or output dim of the dense and SSM matrices, on
# the experts' d, on MLA's projections)
FSDP_F32 = (("gemma3-1b", {}), ("mamba2-130m", {}),
            ("granite-moe-3b-a800m", {"n_experts_padded": 0}),
            ("deepseek-v2-236b", {}))


def fsdp_jobs(mesh, steps: int, f32_only: bool) -> list:
    """``--fsdp``: the f32 checks of FSDP_F32 under FSDP where "data" is
    2 or more; qwen3-8b at TP_QWEN with FSDP on and off; granite-moe
    (V2) at MOE_SHAPE with FSDP where "model" is 1."""
    data, model = _dm(mesh)
    jobs = ([("f32+fsdp", mesh, arch, over, True) for arch, over in FSDP_F32]
            if data > 1 else [])
    if f32_only:
        return jobs
    jobs += [("timed+fsdp", mesh, "qwen3-8b", TP_QWEN, steps, True),
             ("timed", mesh, "qwen3-8b", TP_QWEN, steps, True)]
    if model == 1:
        jobs.append(("timed+fsdp", mesh, "granite-moe-3b-a800m", MOE_SHAPE,
                     steps, True))
    return jobs


# --attn-batch's timed runs at "model" 3: (arch, overrides), each also
# at the mesh (1, 1)
FALLBACK_TIMED = (("gemma3-1b", {}), ("gemma3-1b",
                                     {"attn_batch_fallback": True}),
                  ("qwen2-vl-2b", {}), ("granite-moe-3b-a800m", {}))
FALLBACK_ON = {"attn_batch_fallback": True}


def fallback_jobs(mesh, steps: int, f32_only: bool, meshes=()) -> list:
    """``--attn-batch`` (module doc): at a "model" extent that does not
    divide them, gemma3-1b's f32 checks with the fallback off and on
    and FALLBACK_TIMED at FALLBACK_SHAPE; at a "data" extent >= 2 and
    "model" 1, granite-moe's V2 groups across ranks (its smoke's f32
    check, then bf16 at V2_ACROSS_SHAPE). The mesh (1, 1) runs the
    timed jobs of the other ``meshes`` at their global batches (each
    config once: the fallback changes nothing on one card)."""
    data, model = _dm(mesh)
    granite = ("granite-moe-3b-a800m", V2_ACROSS_SHAPE, steps, True)
    if mesh == (1, 1):
        if f32_only:
            return []
        jobs = []
        if any(m > 1 for _, m in map(_dm, meshes)):
            jobs += [("timed", mesh, a, FALLBACK_SHAPE, steps, True, o)
                     for a, o in FALLBACK_TIMED if not o]
            jobs.append(("attn", mesh, "gemma3-1b", FALLBACK_SHAPE, {}))
        if any(d > 1 and m == 1 for d, m in map(_dm, meshes)):
            jobs.append(("timed", mesh) + granite)
        return jobs
    jobs = []
    if model > 1:
        jobs += [("f32", mesh, "gemma3-1b", o) for o in ({}, FALLBACK_ON)]
        if not f32_only:
            jobs += [("timed", mesh, a, FALLBACK_SHAPE, steps, True, o)
                     for a, o in FALLBACK_TIMED]
            jobs += [("attn", mesh, "gemma3-1b", FALLBACK_SHAPE, o)
                     for o in ({}, FALLBACK_ON)]
    if data > 1 and model == 1:
        jobs.append(("f32", mesh, "granite-moe-3b-a800m",
                     {"n_experts_padded": 0}, True, V2_F32_SEQ))
        if not f32_only:
            jobs.append(("timed", mesh) + granite)
    return jobs


def _where(r: dict) -> str:
    shape = r["mesh"]
    if len(shape) == 3:
        return "mesh (pod {}, data {}, model {})".format(*shape)
    d, m = shape
    return f"world {r['world']}" if m == 1 else f"mesh (data {d}, model {m})"


def report_timed(r: dict, tag: str, base: dict = None,
                 against: str = "world 1") -> str:
    eff = ""
    if base is not None and base["world"] == 1 and against == "world 1":
        e = r["tok_s"] / (base["tok_s"] * r["world"])
        eff = f"; scale efficiency {e:.3f} against {against}"
    elif base is not None:
        ratio = r["tok_s"] / base["tok_s"]
        eff = f"; {ratio:.3f} times the tok/s of {against}"
    moe = (f" ({r['variant']}, {r['layers']} layers; routes "
           f"{'agree' if r['routes_agree'] else 'DIFFER'} over \"model\")"
           if r.get("variant") else "")
    if r.get("overrides"):
        moe += f" {r['overrides']}"
    return (f"{tag} {r['arch']}{moe} {r['dtype']} {_where(r)} zero1 "
            f"{'on' if r['zero1'] else 'off'}, fsdp "
            f"{'on' if r.get('fsdp') else 'off'}, global ({r['global_rows']}, "
            f"{r['seq']}), ({r['rows_a_card']}, {r['seq']}) a data rank, "
            f"{r['params'] / 1e9:.3f} B parameters: "
            f"warm {r['warm_ms']:.1f} ms; steps "
            + ", ".join(f"{t:.1f}" for t in r["step_ms"])
            + f" ms = {r['tok_s']:.0f} tok/s{eff}; peak "
            f"{r['peak_mb_a_card']:.1f} MB a card (init "
            f"{r['init_peak_mb']:.1f}); state "
            f"{r['state_gb']:.2f} GB a card by bytes; loss "
            + ", ".join(f"{x:.4f}" for x in r["loss"]) + "; grad_norm "
            + ", ".join(f"{x:.4f}" for x in r["grad_norm"]))


def report_f32(r: dict, tag: str) -> str:
    lim = f"{F32_LIMIT:.0e}"
    controls = "; ".join(
        f"{k}: metric {c['worst_metric_rel']:.2e}, moments "
        f"{c['worst_moment_rel_l2']:.2e}, parameters' error over tolerance "
        f"{c['param_err_over_tol']:.2e}, {'passed' if c['ok'] else 'failed'}"
        for k, c in r["controls"].items())
    moe = (f" ({r['variant']}, {r['overrides']}; routes "
           f"{'agree' if r['routes_agree'] else 'DIFFER'} over \"model\")"
           if r.get("variant") else "")
    steps = r.get("steps", 1)
    what = (f"FSDP, {steps} steps, each against one card's from the same "
            "state" if r.get("fsdp") else "one step against one card")
    pairs = lambda xs: ", ".join(           # noqa: E731
        f"{a:.7f} / {b:.7f}" for a, b in zip(xs[::2], xs[1::2]))
    return (f"{tag} {r['arch']}{moe} f32 {_where(r)}, global batch "
            f"{tuple(r['global_batch'])}, {what}: loss "
            f"{pairs(r['loss'])}, grad_norm {pairs(r['grad_norm'])} (worst "
            f"metric rel {r['worst_metric_rel']:.2e}, rtol {lim}); moments "
            f"m, v: worst relative L2 {r['worst_moment_rel_l2']:.2e} "
            f"({MOMENT_LIMIT:.0e})"
            f"; parameters against AdamW's step from the run's own "
            f"moments: worst error over its tolerance (rtol {lim}, atol "
            f"{lim} max|p|) {r['param_err_over_tol']:.2e} (1); {100 * r['params_apart']:.4f} % of the "
            f"parameters apart from one card's by more than that (gradients"
            f" at rounding level); leaves off: {r['leaves_off'] or 'none'}"
            + (f"; controls (each must fail): {controls}" if controls
               else ""))


def qwen_reckoning() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models.api import family_module
    from repro_torch.tree import leaves
    cfg = get_config("qwen3-8b")
    n = sum(p.numel() for p in leaves(family_module(cfg).init_params(
        cfg, None, torch.device("meta"))))
    card_bytes = (torch.cuda.get_device_properties(0).total_memory
                  if torch.cuda.is_available() else float("nan"))
    return dict(params=n, one_card_gb=n * 12 / 1e9,
                zero1_4_gb=n * (2 + 2 + 8 / 4) / 1e9,
                card_gb=card_bytes / 1e9)


def reckoned_state_gb(arch: str, shape, fsdp: bool,
                      dtype: str = "bfloat16") -> float:
    """GB of the train state of the largest rank on the mesh ``shape``
    ((data, model) or (pod, data, model)), by bytes, from `train.steps.
    state_blocks` on the meta device, rank by rank
    (`launch.dryrun.rank_bytes`): its parameters and their gradients as
    it holds them (pieces, FSDP blocks) in ``dtype``, and its two f32
    moments (ZeRO-1 or FSDP blocks)."""
    from repro_torch.configs import ParallelConfig, TrainConfig
    from repro_torch.launch.dryrun import MeshShape, rank_bytes
    from repro_torch.models.api import family_module
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.steps import state_blocks
    cfg = _config(arch, dtype, False)
    spec = family_module(cfg).init_params(cfg, None, torch.device("meta"))
    layout = state_blocks(cfg, TrainConfig(), MeshShape(shape),
                          ParallelConfig(fsdp=fsdp))
    opt = adamw_init(spec)
    params = rank_bytes([spec], [layout["params"]], shape)
    moments = rank_bytes([opt["m"], opt["v"]],
                         [layout["opt"]["m"], layout["opt"]["v"]], shape)
    return max(2 * p + m for p, m in zip(params, moments)) / 1e9


def _mesh_arg(text: str):
    """``DxM`` or ``PxDxM``: the mesh shape."""
    shape = tuple(int(x) for x in text.lower().split("x"))
    if len(shape) not in (2, 3):
        raise argparse.ArgumentTypeError(f"{text}: DxM or PxDxM")
    return shape


def _name(shape) -> str:
    return "x".join(str(n) for n in shape)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, nargs="*", default=None,
                    help="world sizes (default 1, 2, 4 up to the cards)")
    ap.add_argument("--meshes", type=_mesh_arg, nargs="*", default=None,
                    help="meshes DxM (data D, model M) or PxDxM (pod P, "
                    "data D, model M) in place of --worlds, e.g. 4x1 2x2 "
                    "1x4 2x2x1")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--qwen", action="store_true",
                    help="qwen3-8b at full size over the largest world "
                    "(with --meshes: on every mesh)")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "dist_train_scaling.json"))
    ap.add_argument("--moe", action="store_true",
                    help="with --meshes: the experts over \"model\" "
                    "(granite-moe, deepseek-v2) in place of the dense jobs")
    ap.add_argument("--fsdp", action="store_true",
                    help="with --meshes: FSDP (ParallelConfig.fsdp): its "
                    "f32 checks, qwen3-8b with FSDP on and off, "
                    "granite-moe with FSDP, in place of the dense jobs")
    ap.add_argument("--attn-batch", action="store_true",
                    help="with --meshes: blocks \"model\" does not divide "
                    "(whole, or the attn_batch fallback) and V2 groups "
                    "across ranks, in place of the dense jobs; the mesh "
                    "(1, 1) first for the timed runs")
    ap.add_argument("--moe-timed", default="all", choices=["all", "v2"],
                    help="--moe's timed runs: all of them, or granite-moe "
                    "V2 alone")
    ap.add_argument("--f32-only", action="store_true",
                    help="only the f32 checks")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke configs (a check of the script itself)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cpu: gloo ranks on the CPU, host-clock times, "
                    "with --smoke")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("FAILED: no CUDA device")
    tp = args.meshes is not None
    if (args.moe or args.fsdp or args.attn_batch) and not tp:
        raise SystemExit("FAILED: --moe, --fsdp and --attn-batch run on "
                         "--meshes")
    pod = tp and all(len(shape) == 3 for shape in args.meshes)
    tag = ("[fsdp]" if args.fsdp else "[ep]" if args.moe else "[fallback]"
           if args.attn_batch else "[pod]" if pod else "[tp]" if tp
           else "[dist]")
    if tp:
        # one spawn a world, its meshes in order
        plan = {}
        meshes = list(args.meshes)
        if args.attn_batch and (1, 1) not in meshes:
            meshes.insert(0, (1, 1))
        for shape in meshes:
            plan.setdefault(int(np.prod(shape)), []).extend(
                fallback_jobs(shape, args.steps, args.f32_only, meshes)
                if args.attn_batch else
                fsdp_jobs(shape, args.steps, args.f32_only) if args.fsdp
                else moe_jobs(shape, args.steps, args.f32_only,
                              args.moe_timed) if args.moe else
                mesh_jobs(shape, args.steps, args.f32_only, args.qwen))
        plan = {w: jobs for w, jobs in plan.items() if jobs}
    else:
        plan = None
    asked = (list(plan) if tp else args.worlds) or [1]
    n_cards = (torch.cuda.device_count() if args.device == "cuda"
               else max(asked))
    if not tp:
        worlds = args.worlds or [w for w in (1, 2, 4, 8) if w <= n_cards]
        plan = {w: world_jobs(w, args.steps, args.f32_only,
                              args.qwen and w == max(worlds))
                for w in worlds}
    if max(plan) > n_cards:
        raise SystemExit(f"FAILED: {max(plan)} ranks, {n_cards} cards")
    say(f"{tag} {card()} x {n_cards}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    tmp = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(tmp, exist_ok=True)
    out = {"card": card(), "cards": n_cards, "timed": [], "f32": [],
           "qwen": None}
    base = {}
    ok = True
    t_all = time.perf_counter()
    for world, jobs in plan.items():
        t0 = time.perf_counter()
        results = run_world(world, jobs, tmp, args.device, args.smoke)
        for r in results:
            if r.get("kind") == "attn":
                over = f" {r['overrides']}" if r["overrides"] else ""
                say(f"{tag} {r['arch']}{over} layer 0's "
                    f"attention block bf16 {_where(r)}, global "
                    f"({r['global_rows']}, {r['seq']}), forward and "
                    f"backward: {r['ms']:.3f} ms a call (mean of "
                    f"{r['reps']})")
                out["timed"].append(r)
            elif "tok_s" in r:
                # against world 1 (--worlds), or against the mesh of
                # every card on "data" at the same global batch
                # (--meshes), where the call ran it first
                key = ((r["arch"], r["zero1"], r["global_rows"],
                        r.get("variant"), r["fsdp"]) if tp
                       else (r["arch"], r["zero1"]))
                pod = len(r["mesh"]) == 3
                one = (r["mesh"] == [1, 1] if args.attn_batch
                       else r["mesh"][1] == 1 if tp else r["world"] == 1)
                if one and not pod:
                    base[key] = r
                if tp and not pod:
                    base[key + tuple(r["mesh"])] = r
                ref = None if one and not pod else base.get(key)
                against = ("the mesh (1, 1)" if args.attn_batch else
                           f"the mesh (data {r['world']}, model 1)" if tp
                           else "world 1")
                if pod:
                    # against the 2-D mesh of the same math, where the
                    # call ran it
                    flat = _dm(r["mesh"])
                    ref = base.get(key + flat, ref)
                    if key + flat in base:
                        against = "the mesh (data {}, model {})".format(
                            *flat)
                say(report_timed(r, tag, ref, against))
                ok &= r["finite"] and r["routes_agree"]
                out["timed"].append(r)
            else:
                say(report_f32(r, tag))
                ok &= r["ok"]
                out["f32"].append(r)
        say(f"{tag} world {world} took {time.perf_counter() - t0:.1f}s")
    if args.qwen:
        rk = qwen_reckoning()
        out["qwen"] = rk
        say(f"{tag} qwen3-8b: {rk['params'] / 1e9:.3f} B parameters; "
            f"state on one card {rk['one_card_gb']:.1f} GB (bf16 "
            f"parameters and gradients, f32 m and v: 12 B a parameter) "
            f"against {rk['card_gb']:.1f} GB a card: does not fit; with "
            f"ZeRO-1 over 4 cards {rk['zero1_4_gb']:.1f} GB a card before "
            "activations"
            + ("; " + ", ".join(
                f"{tuple(s)} {reckoned_state_gb('qwen3-8b', s, False):.1f}"
                " GB a card"
                for s in args.meshes) if tp else ""))
    if args.fsdp and not args.f32_only:
        out["reckoned"] = {
            _name(s): {"fsdp": reckoned_state_gb("qwen3-8b", s, True),
                       "plain": reckoned_state_gb("qwen3-8b", s, False)}
            for s in args.meshes}
        say(f"{tag} qwen3-8b state a card reckoned on the meta device "
            "(bf16 parameters and gradients as held, f32 m and v), FSDP "
            "on / off: " + ", ".join(
                f"({k.replace('x', ', ')}) {v['fsdp']:.2f} / "
                f"{v['plain']:.2f} GB" for k, v in out["reckoned"].items()))
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    say(f"{tag} done in {time.perf_counter() - t_all:.1f}s; results in "
        f"{args.out}")
    if not ok:
        say("FAILED: a check did not hold")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
