#!/usr/bin/env python3
"""The serving cells across the cards of one host: prefill and decode on
a (data, model) or (pod, data, model) mesh, the decode KV cache split
along its sequence, or with ``--kv-heads`` its KV heads over "model".

Run from the repository root on a machine with CUDA cards:

    python3 tools/dist_serve_cells.py                  # 1xn and n/2x2
    python3 tools/dist_serve_cells.py --meshes 1x4 2x2 --f32-only
    python3 tools/dist_serve_cells.py --smoke --device cpu --meshes 1x2
    python3 tools/dist_serve_cells.py --meshes 1x3 --fallback
    python3 tools/dist_serve_cells.py --meshes 2x1x2 2x2x1
    python3 tools/dist_serve_cells.py --meshes 1x4 --kv-heads

Each world size runs in its own spawn of one process a card (NCCL for
CUDA tensors, gloo for CPU ones, over tcp://localhost on a free port),
through the port's entry points (`launch.cells.make_cell`: the prefill
and decode steps of `train.steps` on the mesh, and the layouts of their
inputs and outputs; `runtime.param_sharding.relayout`).

  - f32 checks (`f32_case`), on every mesh: the smoke config of every
    family (gemma3-1b, qwen3-8b, mamba2-130m, zamba2-1.2b, granite-moe
    V2, deepseek-v2 with MLA and FSDP, V2 and V1, seamless, qwen2-vl) in
    f32, the
    prefill cell against one card's `make_prefill_step` and four decode
    steps of the decode cell against `make_serve_step`, each from the
    same whole cache (every rank computes the one-card run itself):
    tokens equal, logits within LOGITS_TOL of the largest, each rank's
    cache part within CACHE_TOL of the one-card cache's, and `relayout`
    of the prefill cell's own cache exact; at a mesh whose "data" is 2,
    batch 1 with "seq" over ("data", "model") (zamba2, gemma3); where
    "model" >= 2 divides the decode cache's MAX_LEN positions, three
    faults that the check must catch (`fault_in`): the partial
    softmaxes combined without their max rescale, the new K/V written on
    every rank of "seq" rather than the owner of its position, and the
    greedy token taken over the rank's vocabulary slice. V2's dispatch
    groups straddle the "data" ranks' rows wherever "data" is 2 or more
    (64 prompt tokens, 4 decode tokens). Where "model" >= 2 does not
    divide their heads, the cases of FALLBACK_CASES at a global batch
    of 2 d m rows (gemma3 with ``attn_batch_fallback``, qwen3 with 3
    heads and one KV head, with and without it).
  - on a mesh (pod P, data D, model M) (``--meshes PxDxM``, the
    reference's multi-pod rules: the batch over ("pod", "data"), "seq"
    over ("model",), or ("data", "model") at batch 1, replicated over
    "pod"), the f32 checks of POD_CASES at batch 4 and at batch 1 and of
    KV_CASES; with ``--kv-heads`` (or on such a mesh) the decode cells
    of KV_CASES without ``seq_shard_decode``: the cache in the prefill
    cell's layout, its KV heads over "model" where "model" divides them
    (qwen3's 2 at "model" 2), else whole on every rank (gemma3's one),
    seamless's cross-attention cache too; at "model" >= 2 the fault
    ``kv_block0`` (every rank writes the new K/V of head block 0, rank
    0's heads, into its cache), which the check must catch.
  - bf16 runs (`--timed`, default on CUDA): qwen3-8b at full width and
    depth, a 4,096-token prompt at a global batch of 16 (QWEN_PROMPT),
    the cache grown to decode_32k's 32,768 positions, relayout, DECODE
    timed decode steps; zamba2-1.2b at long_500k (batch 1, 524,288
    positions, "seq" over ("data", "model")) from a ZAMBA_PROMPT-token
    prompt, DECODE teacher-forced decode steps (fed one card's tokens)
    held to one card's first: logits within BF16_LOGITS_TOL of the
    largest, and a pick may differ only at a near tie (`timed_decode`);
    zamba2-1.2b's prefill cell at prefill_32k's length with the flash
    kernel, at the largest global batch the cards hold (reckoned from a
    batch of 1's peak). With ``--fallback``, in place of those: at a
    "model" extent that does not divide zamba2's 32 heads (3), its
    prefill cell at prefill_32k's length, batch 1, attention and SSM
    whole on every rank, its tokens against one card's
    (`timed_prefill` with ``compare``); at (2, 2), granite-moe V2
    (its dispatch groups over both "data" ranks' rows) decoding a
    QWEN_PROMPT prompt grown to QWEN_LEN positions, DECODE steps fed
    one card's tokens and held to one card's under the near-tie rule,
    then DECODE timed ones. On a mesh (P, 1, M), M >= 2: the qwen3-8b
    decode and zamba2's prefill cell as at (1, 4); on (P, D, 1), D >= 2:
    zamba2 long_500k as at (2, 2). With ``--kv-heads`` on a 2-D mesh of
    "model" >= 2: after the qwen3-8b decode, the same decode with the
    cache's KV heads over "model" (8 KV heads, 2 a card at (1, 4), no
    all-to-all), in place of zamba2's prefill cell. With
    ``--prefill-only``, in place of all of these: on each mesh of
    "model" >= 2, zamba2's prefill cell at prefill_32k's length, batch
    1, its next token against one card's. Each: ms a step, tok/s,
    peak GB a card (the largest over the ranks), the cache a card
    reckoned by bytes, NCCL calls a step (counted at the
    ``torch.distributed`` calls), and each kernel's launches summed over
    the ranks.

Prints the card's name and power limit and each result line (tagged
``[cells]``); writes the results as JSON to ``--out`` (default
build/dist_serve_cells.json). Exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from dist_train_scaling import (_Timer, _axes, _dev, _dm,  # noqa: E402
                                _mesh_arg, _start, card, free_port, say)
from repro_torch.launch.op_cost import tallied  # noqa: E402
from repro_torch.runtime.param_sharding import take_parts  # noqa: E402

# the f32 checks: (name, arch, overrides, global batch); prompt PROMPT,
# decoder cache MAX_LEN, STEPS decode steps
F32_CASES = (
    ("gemma3", "gemma3-1b", {}, 4),
    ("qwen3", "qwen3-8b", {}, 4),
    ("mamba2", "mamba2-130m", {}, 4),
    ("zamba2", "zamba2-1.2b", {}, 4),
    ("granite-moe-v2", "granite-moe-3b-a800m", {}, 4),
    # deepseek-v2 is the FSDP arch (`launch.cells.FSDP_ARCHS`): its own
    # V2, and V1
    ("deepseek-v2", "deepseek-v2-236b", {}, 4),
    ("deepseek-v2-v1", "deepseek-v2-236b", {"moe_variant": "dynamic"}, 4),
    ("seamless", "seamless-m4t-large-v2", {}, 4),
    ("qwen2-vl", "qwen2-vl-2b", {}, 4),
)
BATCH1 = ("zamba2", "gemma3")   # batch 1, "seq" over ("data", "model")
# on a mesh with a "pod" axis, at batch 4 and at batch 1
POD_CASES = ("qwen3", "zamba2")
# decode cells without seq_shard_decode: the KV heads over "model"
KV_CASES = (
    ("qwen3-kv", "qwen3-8b", {}),
    ("gemma3-kv", "gemma3-1b", {}),
    ("seamless-kv", "seamless-m4t-large-v2", {}),
)
KV_FAULT = ("qwen3-kv", "kv_block0")
# blocks "model" does not divide (name, arch, overrides), at a global
# batch of 2 d m rows, which the attn_batch fallback splits over
# ("data", "model")
FALLBACK_CASES = (
    ("gemma3-fallback", "gemma3-1b", {"attn_batch_fallback": True}),
    ("qwen3-3h", "qwen3-8b", {"n_heads": 3, "n_kv_heads": 1, "d_head": 16}),
    ("qwen3-3h-fallback", "qwen3-8b", {"n_heads": 3, "n_kv_heads": 1,
                                       "d_head": 16,
                                       "attn_batch_fallback": True}),
)
FAULT_CASE = "qwen3"
FAULTS = ("unrescaled", "every_rank_writes", "local_argmax")
PROMPT = 16
MAX_LEN = 32
STEPS = 4
LOGITS_TOL = 1e-5               # of the largest |logit| of the one card
# each rank's part of a cache leaf, of its largest |entry| on one card:
# the tensor-parallel products sum their partials in another order, and
# in f32 the prefill's KV rows read up to 2.8e-6 of their largest apart
# (zamba2's smoke at (1, 4) on gloo ranks)
CACHE_TOL = 1e-5
QWEN_PROMPT = (16, 4096)        # global (batch, prompt)
QWEN_LEN = 32768                # decode_32k
ZAMBA_PROMPT = 4096
ZAMBA_PREFILL = 32768           # prefill_32k
DECODE = 16                     # timed decode steps
WARM = 128                      # the warm prefill's prompt length
# a teacher-forced bf16 decode step's logits, of one card's largest
# |logit| (bf16 rounds otherwise on the mesh: 3.1e-2 read on CPU ranks at
# zamba2's smoke; a faulty combine reads above 1 in f32)
BF16_LOGITS_TOL = 0.1


def _cfg(arch, overrides, smoke=True, dtype="float32", **extra):
    from repro_torch.configs import get_config, get_smoke
    return (get_smoke if smoke else get_config)(
        arch, param_dtype=dtype, compute_dtype=dtype,
        **{**(overrides or {}), **extra})


@contextlib.contextmanager
def fault_in(fault):
    """The serving path broken by ``fault`` (one of FAULTS, or None)
    inside the block."""
    from repro_torch.models import attention, common
    from repro_torch.runtime import collectives
    kept = (attention.combine_partials, attention.seq_slot,
            common.greedy_token, attention._decode_qkv)

    def unrescaled(mx, denom, numer, seq):
        every = collectives.gathered(
            torch.cat([numer, denom[..., None]], -1).contiguous(), seq)
        both = every.sum(dim=0)
        return both[..., :-1] / both[..., -1:]

    def every_rank(lengths, s_loc, seq, clamp):
        pos, mine = kept[1](lengths, s_loc, seq, clamp)
        return pos, torch.ones_like(mine)

    def local_argmax(logits, params, cfg):
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def kv_block0(params, cfg, *args, **kwargs):
        # each rank's new K/V replaced by head block 0's (rank 0's)
        q, k, v, keep = kept[3](params, cfg, *args, **kwargs)
        axis = attention.heads_axis(cfg)
        if keep is None and axis is not None:
            every = collectives.gathered(torch.cat([k, v], 2).contiguous(),
                                         axis)[0]
            k, v = every.split(k.shape[2], dim=2)
        return q, k, v, keep

    try:
        if fault == "unrescaled":
            attention.combine_partials = unrescaled
        elif fault == "every_rank_writes":
            attention.seq_slot = every_rank
        elif fault == "local_argmax":
            common.greedy_token = local_argmax
        elif fault == "kv_block0":
            attention._decode_qkv = kv_block0
        elif fault is not None:
            raise ValueError(fault)
        yield
    finally:
        (attention.combine_partials, attention.seq_slot,
         common.greedy_token, attention._decode_qkv) = kept


@contextlib.contextmanager
def logits_recorded():
    """The logits of each greedy pick in the block (`common.
    greedy_token`, as the steps call it), whole over the vocabulary
    (gathered over "model" where it is split), into the list yielded."""
    from repro_torch.models import common
    from repro_torch.runtime import collectives
    from repro_torch.runtime import sharding as shlib
    kept, seen = common.greedy_token, []

    def recording(logits, params, cfg):
        whole = logits
        if common.vocab_split(params, cfg):
            every = collectives.gathered(logits.contiguous(),
                                         shlib.model_axis())
            whole = torch.cat(list(every), dim=-1)
        seen.append(whole.detach().float().cpu())
        return kept(logits, params, cfg)
    common.greedy_token = recording
    try:
        yield seen
    finally:
        common.greedy_token = kept


def _clone(t):
    from repro_torch import tree
    return tree.map_(lambda x: x.clone(), t)


def _err(got, want) -> float:
    """The largest |got - want| of a tree's leaves, each over its leaf's
    largest |want| (inf where a shape differs)."""
    from repro_torch import tree
    worst = 0.0
    for g, w in zip(tree.leaves(got), tree.leaves(want)):
        if tuple(g.shape) != tuple(w.shape):
            return float("inf")
        if g.numel():
            top = float(w.double().abs().max())
            gap = float((g.double() - w.double()).abs().max())
            worst = max(worst, gap / top if top else gap)
    return worst


def f32_case(mesh, name, arch, overrides, batch, fault=None,
             device="cpu", keep_logits=False) -> dict:
    """The f32 check of one case on ``mesh`` (module doc), from the
    smoke parameters of seed 0 and a prompt of seed 1, the same on every
    rank; the decode cell's "seq" over `launch.cells.parallel_for`'s
    axes (at batch 1: ("data", "model")), or for a case of KV_CASES its
    cache's KV heads over "model" (no ``seq_shard_decode``). Returns
    this rank's readings:
    "refused" (the message, where the mesh refuses the config), else
    "prefill" and "decode" {"tokens_equal", "logits_err" (of the
    largest |logit|), "cache_err"}, "relayout_exact"; with
    ``keep_logits`` also "logits": the cells' greedy inputs on this
    rank, {"rows" (the batch rows it holds), "prefill" (rows, V),
    "decode" [(rows, V)] a step, "tokens" [the prefill's, then each
    step's]} as numpy."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.batches import synth_train_batch
    from repro_torch.launch import cells
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models import get_model
    from repro_torch.runtime import param_sharding as psh
    from repro_torch.runtime import sharding as shlib
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    cfg = _cfg(arch, overrides)
    dev = torch.device(device if device == "cpu" else _dev())
    model = get_model(cfg, device=dev)
    params = model.init_params(0)
    prompt = synth_train_batch(cfg, batch, PROMPT, seed=1, device=dev)
    audio = cfg.family == "audio"
    dec_len = PROMPT if audio else MAX_LEN

    # one card
    with logits_recorded() as rec:
        tok0, cache1 = make_prefill_step(model)(params, prompt)
    ref_pre = rec[0]
    start = cache1 if audio else _grow_cache(model, cache1, MAX_LEN)
    lengths0 = torch.full((batch,), 1 if audio else PROMPT,
                          dtype=torch.int32, device=dev)
    serve1 = make_serve_step(model)
    cache, tok, lengths = _clone(start), tok0[:, None], lengths0
    ref_tok, ref_logits = [], []
    with logits_recorded() as rec:
        for _ in range(STEPS):
            tok, cache, lengths = serve1(params, tok, cache, lengths)
            ref_tok.append(tok)
    ref_logits, ref_end = rec, cache

    # the cells
    out = {"name": name, "mesh": list(mesh.mesh.shape), "fault": fault,
           "batch": batch}
    pshape = ShapeConfig("prefill", "prefill", PROMPT, batch)
    dshape = ShapeConfig("decode", "decode", dec_len, batch)
    kv = name in {n for n, *_ in KV_CASES}
    out["kv_heads"] = kv
    try:
        with fault_in(fault):
            pcell = cells.make_cell(cfg, pshape, mesh, device=dev)
            dcell = cells.make_cell(cfg, dshape, mesh, device=dev,
                                    parallel=_decode_parallel(cfg, dshape,
                                                              kv))
            out["seq_axes"] = list(dcell.parallel.seq_axes)
            p_local = take_parts(params, pcell.in_layouts[0])
            with logits_recorded() as rec:
                tok_p, cache_p = pcell.step(
                    p_local, take_parts(prompt, pcell.in_layouts[1]))
            pre_logits = rec[0]
            tok_l, cache_l = pcell.out_layouts
            out["prefill"] = dict(
                tokens_equal=bool(torch.equal(tok_p, tok_l.take(tok0))),
                logits_err=_rel(pre_logits, tok_l.take(ref_pre)),
                cache_err=_err(cache_p, take_parts(cache1, cache_l)))
            # relayout of the prefill cell's own cache, exact
            grown = cache_p if audio else _grow_cache(model, cache_p,
                                                      MAX_LEN)
            d_layout = dcell.in_layouts[2]
            with shlib.use_binding(dcell.step.binding):
                moved = psh.relayout(grown, cache_l, d_layout)
                whole = psh.gather_parts(grown, cache_l)
            out["relayout_exact"] = _err(
                moved, take_parts(whole, d_layout)) == 0
            # four decode steps from the one card's whole cache
            c = take_parts(start, d_layout)
            t = dcell.in_layouts[1].take(tok0[:, None]).contiguous()
            ln = dcell.in_layouts[3].take(lengths0).contiguous()
            toks = []
            with logits_recorded() as rec:
                for _ in range(STEPS):
                    t, c, ln = dcell.step(p_local, t, c, ln)
                    toks.append(t)
            rows = dcell.in_layouts[1]
            if keep_logits:
                out["logits"] = dict(
                    rows=tok_l.take(torch.arange(batch)).tolist(),
                    prefill=pre_logits.numpy(), decode=[
                        g.numpy() for g in rec],
                    tokens=[tok_p.cpu().numpy()] + [
                        x[:, 0].cpu().numpy() for x in toks])
            out["decode"] = dict(
                tokens_equal=all(torch.equal(a, rows.take(b))
                                 for a, b in zip(toks, ref_tok)),
                logits_err=max(_rel(g, rows.take(w[:, None])[:, 0])
                               for g, w in zip(rec, ref_logits)),
                cache_err=_err(c, take_parts(ref_end, d_layout)))
    except NotImplementedError as exc:
        out["refused"] = str(exc)
    return out


def _rel(got, want) -> float:
    """max |got - want| over max |want| (inf where shapes differ)."""
    if tuple(got.shape) != tuple(want.shape):
        return float("inf")
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def case_ok(r: dict) -> bool:
    """Whether an f32 reading (`f32_case`) holds: tokens equal, logits
    and cache within their limits, relayout exact."""
    if "refused" in r:
        return False
    return (r["relayout_exact"] and all(
        r[k]["tokens_equal"] and r[k]["logits_err"] <= LOGITS_TOL
        and r[k]["cache_err"] <= CACHE_TOL for k in ("prefill", "decode")))


def _decode_parallel(cfg, shape, kv_heads: bool):
    """The decode cell's `ParallelConfig`: `launch.cells.parallel_for`'s,
    without ``seq_shard_decode`` where ``kv_heads``."""
    import dataclasses

    from repro_torch.launch import cells
    parallel = cells.parallel_for(cfg, shape)
    return (dataclasses.replace(parallel, seq_shard_decode=False)
            if kv_heads else parallel)


def f32_jobs(mesh_shape, faults: bool = True, kv_heads: bool = False
             ) -> list:
    """The f32 cases of a mesh (module doc): (name, arch, overrides,
    batch, fault); the faults where ``faults`` and "model" divides the
    decode cache's MAX_LEN positions (else the cache is whole along
    them, and nothing combines: `train.steps.serve_binding`). On a mesh
    with a "pod" axis: POD_CASES at batch 4 and 1, KV_CASES, and at
    "model" >= 2 with ``faults`` the fault KV_FAULT; KV_CASES (and
    their fault) on the others with ``kv_heads``."""
    data, model = _dm(mesh_shape)
    kv = [(n, a, o, 4, None) for n, a, o in KV_CASES]
    if faults and model >= 2:
        name, fault = KV_FAULT
        kv += [(n, a, o, 4, fault) for n, a, o in KV_CASES if n == name]
    if len(mesh_shape) == 3:
        pod = [c for c in F32_CASES if c[0] in POD_CASES]
        return ([(n, a, o, b, None) for n, a, o, b in pod]
                + [(n, a, o, 1, None) for n, a, o, _ in pod] + kv)
    jobs = [(n, a, o, b, None) for n, a, o, b in F32_CASES]
    if data == 2 and model >= 2:
        jobs += [(n, a, o, 1, None) for n, a, o, _ in F32_CASES
                 if n in BATCH1]
    if model >= 2:
        jobs += [(n, a, o, 2 * data * model, None)
                 for n, a, o in FALLBACK_CASES
                 if _cfg(a, o).n_heads % model]
    if faults and model >= 2 and MAX_LEN % model == 0:
        case = next(c for c in F32_CASES if c[0] == FAULT_CASE)
        jobs += [(*case, f) for f in FAULTS]
    return jobs + (kv if kv_heads else [])


def case_of(name) -> tuple:
    """(arch, overrides) of the f32 case ``name``."""
    return next((a, o) for n, a, o, *_ in F32_CASES + FALLBACK_CASES
                + KV_CASES if n == name)


def f32_rank(mesh, device, faults: bool = True,
             keep_logits: bool = False, kv_heads: bool = False) -> list:
    """Every f32 job of the mesh (`f32_jobs`) on this rank: each
    reading, the worst over the ranks, with "ok" (whether it holds);
    with ``keep_logits`` this rank's "logits" (`f32_case`)."""
    shape = tuple(mesh.mesh.shape)
    out = []
    for name, arch, over, batch, fault in f32_jobs(shape, faults,
                                                   kv_heads):
        r = _worst_over_ranks(f32_case(mesh, name, arch, over, batch,
                                       fault, device, keep_logits))
        r["ok"] = case_ok(r)
        out.append(r)
    return out


def _worst_over_ranks(r: dict) -> dict:
    """``r`` (this rank's `f32_case` reading) with every reading the
    worst over the ranks: errors their max, equalities their min."""
    import torch.distributed as dist
    if "refused" in r:
        return r
    keys = [(k, f) for k in ("prefill", "decode")
            for f in ("tokens_equal", "logits_err", "cache_err")]
    vals = torch.tensor(
        [-float(r[k][f]) if f == "tokens_equal" else r[k][f]
         for k, f in keys] + [-float(r["relayout_exact"])],
        dtype=torch.float64)
    dist.all_reduce(vals, op=dist.ReduceOp.MAX)
    for (k, f), v in zip(keys, vals.tolist()):
        r[k][f] = (v == -1.0) if f == "tokens_equal" else v
    r["relayout_exact"] = vals[-1].item() == -1.0
    return r


# ---------------------------------------------------------------------------
# bf16 runs at full width
# ---------------------------------------------------------------------------


def _peak_gb() -> float:
    import torch.distributed as dist
    peak = torch.tensor([torch.cuda.max_memory_allocated() / 1e9
                         if torch.cuda.is_available() else float("nan")],
                        device=_dev())
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    return float(peak.item())


def _cache_gb(cache) -> float:
    from repro_torch import tree
    return sum(t.numel() * t.element_size() for t in tree.leaves(cache)) / 1e9


def _launches() -> dict:
    """Each kernel's launches since the counts were zeroed, summed over
    the ranks."""
    import torch.distributed as dist
    from repro_torch import kernels
    counts = kernels.launch_counts()
    names = sorted(counts)
    total = torch.tensor([float(counts[k]) for k in names], device=_dev())
    dist.all_reduce(total)
    return dict(zip(names, (int(x) for x in total)))


def profiled_step(fn) -> dict:
    """One call of ``fn`` under torch.profiler on every rank (each takes
    part in the collectives), after a marker kernel; rank 0's reading:
    the call's wall ms (host clock, profiler on), its kernels' device ms,
    the NCCL kernels' share of it (their time includes waiting for the
    other ranks), the cuBLAS products' (by kernel name), and the kernels
    that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the kernels; "nccl:..." are the collectives' annotations on the
    # device's timeline, which span their kernels (counted once)
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "spin_kernel" not in e.key
            and not e.key.startswith("nccl:")]

    def ms(pick):
        return sum(e.self_device_time_total for e in kern
                   if pick(e.key.lower())) / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:5]
    return dict(wall_ms=wall, busy_ms=ms(lambda k: True),
                nccl_ms=ms(lambda k: "nccl" in k),
                matmul_ms=ms(lambda k: any(w in k for w in (
                    "gemm", "gemv", "cutlass", "xmma", "nvjet"))),
                launches=sum(e.count for e in kern),
                top=[(e.key[:60], e.self_device_time_total / 1e3, e.count)
                     for e in top])


def timed_decode(mesh, arch, prompt, max_len, smoke=False, compare=False,
                 steps=DECODE, dtype="bfloat16", flags=None,
                 kv_heads=False) -> dict:
    """bf16 ``arch`` at full width and depth (``smoke``: its smoke
    config): the prefill cell of a ``prompt`` (global batch, length),
    the cache grown to ``max_len``, `relayout` into the decode cell's
    layout (with ``kv_heads``, the decode cell without
    ``seq_shard_decode``: the prefill cell's layout, nothing moves),
    ``steps`` timed decode steps (CUDA events on rank 0). With
    ``compare``, rank 0 runs one card first (its logits recorded), and
    before the timed steps ``steps`` untimed ones are fed one card's
    tokens (teacher-forced) and recorded (`_against_one_card`); "ties"
    the bound of a near tie, twice the largest |logit - one card's| of
    the steps whose picks agree (a pick can turn only where the two
    logits' errors differ by one card's top-1 minus top-2 logit), and
    "ties_ok" where every step's logits are within BF16_LOGITS_TOL and
    every pick that differs is a near tie within that bound."""
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.batches import synth_train_batch
    from repro_torch.launch import cells
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.models import get_model
    from repro_torch.runtime import param_sharding as psh
    from repro_torch.runtime import sharding as shlib
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    dev = _dev()
    timer = _Timer(dev)
    cfg = _cfg(arch, {}, smoke, dtype, **(flags or {}))
    batch, plen = prompt
    model = get_model(cfg, device=dev)
    prompt_t = synth_train_batch(cfg, batch, plen, seed=1, device=dev)
    lengths0 = torch.full((batch,), plen, dtype=torch.int32, device=dev)
    one = None
    if compare:
        # one card's prefill and decode, on rank 0
        if dist.get_rank() == 0:
            params = model.init_params(0)
            tok0, cache = make_prefill_step(model)(params, prompt_t)
            cache = _grow_cache(model, cache, max_len)
            serve1 = make_serve_step(model)
            toks, tok, ln = [tok0[:, None]], tok0[:, None], lengths0
            with logits_recorded() as one_logits:
                for _ in range(steps):
                    tok, cache, ln = serve1(params, tok, cache, ln)
                    toks.append(tok)
            one = torch.cat(toks, dim=1)
            del params, cache
            torch.cuda.empty_cache()
        else:
            one = torch.empty((batch, steps + 1), dtype=torch.int32,
                              device=dev)
        dist.broadcast(one, 0)
    pcell = cells.make_cell(cfg, ShapeConfig("prefill", "prefill", plen,
                                             batch), mesh, device=dev)
    dshape = ShapeConfig("decode", "decode", max_len, batch)
    dcell = cells.make_cell(cfg, dshape, mesh, device=dev,
                            parallel=_decode_parallel(cfg, dshape,
                                                      kv_heads))
    params = take_parts(model.init_params(0), pcell.in_layouts[0])
    # warm (libraries, kernels built and loaded): a short prompt
    pcell.step(params, take_parts(synth_train_batch(
        cfg, batch, WARM, seed=2, device=dev), pcell.in_layouts[1]))
    if timer.cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    dist.barrier()
    timer.start()
    tok, cache = pcell.step(params, take_parts(prompt_t, pcell.in_layouts[1]))
    prefill_ms = timer.stop()
    prefill_launches = _launches()
    cache = _grow_cache(model, cache, max_len)
    relayout_ms = []
    with shlib.use_binding(dcell.step.binding):
        # twice, the first into a cold allocator: the second's time
        for _ in range(2):
            moved = None
            dist.barrier()
            timer.start()
            moved = psh.relayout(cache, pcell.out_layouts[1],
                                 dcell.in_layouts[2])
            relayout_ms.append(timer.stop())
    cache = moved
    del moved
    cache_gb = _cache_gb(cache)
    rows = dcell.in_layouts[1]
    t = (rows.take(one[:, :1]) if compare else tok[:, None]).contiguous()
    ln = dcell.in_layouts[3].take(lengths0).contiguous()
    kernels.reset_launch_counts()
    compared, ties = None, None
    if compare:
        with logits_recorded() as rec:
            for i in range(steps):
                t, cache, ln = dcell.step(params, t, cache, ln)
                t = rows.take(one[:, i + 1:i + 2]).contiguous()
        if dist.get_rank() == 0:
            mine = rows.take(torch.arange(batch)[:, None])[:, 0]
            compared = [_against_one_card(g, w[mine])
                        for g, w in zip(rec, one_logits)]
            ties = 2 * max((c["noise"] for c in compared if c["agree"]),
                           default=0.0)
    ms, calls = [], []
    for i in range(steps):
        dist.barrier()
        with tallied() as n:
            timer.start()
            t, cache, ln = dcell.step(params, t, cache, ln)
            ms.append(timer.stop())
        calls.append(n.coll_calls)
    decode_launches = _launches()
    peak = _peak_gb()
    prof = None
    if timer.cuda:
        box = {}

        def one():
            box["t"] = dcell.step(params, t, cache, ln)
        dist.barrier()
        prof = profiled_step(one)
    del cache, params
    if timer.cuda:
        torch.cuda.empty_cache()
    b_step = np.mean(ms[1:]) if len(ms) > 1 else ms[0]
    return dict(arch=arch, mesh=list(mesh.mesh.shape), batch=batch,
                prompt=plen, max_len=max_len, kv_heads=kv_heads,
                seq_axes=list(dcell.parallel.seq_axes),
                prefill_ms=prefill_ms, relayout_ms=relayout_ms,
                step_ms=ms, tok_s=batch / b_step * 1e3,
                peak_gb_a_card=peak, cache_gb_a_card=cache_gb,
                nccl_calls_a_step=calls[-1],
                prefill_launches=prefill_launches,
                decode_launches=decode_launches, profile=prof,
                compared=compared, ties=ties if compared else None,
                ties_ok=compared is None or all(
                    (c["agree"] or c["gap"] <= ties)
                    and c["logits_err"] <= BF16_LOGITS_TOL
                    for c in compared))


def _against_one_card(got: torch.Tensor, want: torch.Tensor) -> dict:
    """A teacher-forced step's logits ``got`` (rows, V) against one
    card's ``want`` on the same rows: whether the greedy picks agree;
    "noise", the largest |got - want|, and "logits_err", it over the
    largest |want|; "gap", one card's smallest top-1 minus top-2 logit
    over the rows whose picks differ (over every row where none does)."""
    want = want.double()
    agree = torch.argmax(got, -1) == torch.argmax(want, -1)
    top2 = want.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    at = agree if bool(agree.all()) else ~agree
    noise = float((got.double() - want).abs().max())
    return dict(agree=bool(agree.all()), gap=float(gap[at].min()),
                noise=noise,
                logits_err=noise / float(want.abs().max()))


def timed_prefill(mesh, arch, seq, smoke=False, cap=32,
                  dtype="bfloat16", flags=None, compare=False) -> dict:
    """bf16 ``arch``'s prefill cell at ``seq`` positions with the flash
    kernel: a global batch of 1 first (its peak a card), then the
    largest power of two up to ``cap`` that the batch-1 peak reckons
    within 70 GB a card, timed (CUDA events on rank 0). With
    ``compare``, rank 0 first runs one card's prefill step of the batch
    of 1 (`train.steps.make_prefill_step` without a mesh), and the
    cell's next token is held to it ("tokens_equal" on the batch-1
    run)."""
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.batches import synth_train_batch
    from repro_torch.launch import cells
    from repro_torch.models import get_model
    from repro_torch.train.steps import make_prefill_step

    dev = _dev()
    timer = _Timer(dev)
    cfg = _cfg(arch, {}, smoke, dtype, **(flags or {}))
    model = get_model(cfg, device=dev)
    runs = []
    one = None
    if compare:
        one = torch.zeros((1,), dtype=torch.int32, device=dev)
        if dist.get_rank() == 0:
            one = make_prefill_step(model)(model.init_params(0),
                                           synth_train_batch(
                                               cfg, 1, seq, seed=1,
                                               device=dev))[0]
            if timer.cuda:
                torch.cuda.empty_cache()
        dist.broadcast(one, 0)

    def run(batch):
        cell = cells.make_cell(cfg, ShapeConfig("prefill", "prefill", seq,
                                                batch), mesh, device=dev)
        if timer.cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        # the same on every rank: the batch chosen from it must be
        base = torch.tensor([torch.cuda.memory_allocated() / 1e9
                             if timer.cuda else 0.0], device=dev)
        dist.all_reduce(base, op=dist.ReduceOp.MAX)
        base = float(base.item())
        prompt = take_parts(synth_train_batch(
            cfg, batch, seq, seed=1, device=dev), cell.in_layouts[1])
        kernels.reset_launch_counts()
        dist.barrier()
        with tallied() as n:
            timer.start()
            tok, cache = cell.step(params, prompt)
            ms = timer.stop()
        r = dict(arch=arch, mesh=list(mesh.mesh.shape), batch=batch,
                 seq=seq, prefill_ms=ms, tok_s=batch * seq / ms * 1e3,
                 peak_gb_a_card=_peak_gb(), base_gb=base,
                 cache_gb_a_card=_cache_gb(cache),
                 nccl_calls=n.coll_calls, launches=_launches())
        if one is not None and batch == 1:
            same = torch.tensor([float(torch.equal(
                tok, cell.out_layouts[0].take(one)))], device=dev)
            dist.all_reduce(same, op=dist.ReduceOp.MIN)
            r["tokens_equal"] = bool(same.item())
        del cache, prompt
        runs.append(r)
        return r

    # warm (libraries, kernels built and loaded): a short prompt
    cell = cells.make_cell(cfg, ShapeConfig("prefill", "prefill", WARM, 1),
                           mesh, device=dev)
    params = take_parts(model.init_params(0), cell.in_layouts[0])
    cell.step(params, take_parts(synth_train_batch(
        cfg, 1, WARM, seed=2, device=dev), cell.in_layouts[1]))
    first = run(1)
    per = max(first["peak_gb_a_card"] - first["base_gb"], 1e-3)
    batch = 1
    while batch * 2 <= cap and first["base_gb"] + 2 * batch * per <= 70.0:
        batch *= 2
    if batch > 1:
        run(batch)
    return dict(runs=runs, cap=cap, chosen=batch)


# ---------------------------------------------------------------------------


def rank_main(rank, world, port, shapes, out_path, device, smoke, timed,
              f32, fallback=False, kv_heads=False, prefill_only=False):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    _start(rank, world, port, device)
    results = []
    try:
        for shape in shapes:
            shape = tuple(shape)
            mesh = make_mesh(shape, _axes(shape), device_type=device)
            if f32:
                for r in f32_rank(mesh, device, kv_heads=kv_heads):
                    results.append(dict(kind="f32", **r))
            if not timed:
                continue
            flags = dict(use_flash_kernel=True)
            if fallback:
                results += fallback_timed(mesh, shape, smoke, flags)
            elif prefill_only:
                if shape[-1] >= 2:
                    results.append(dict(kind="prefill", **timed_prefill(
                        mesh, "zamba2-1.2b", 64 if smoke else ZAMBA_PREFILL,
                        smoke, cap=1, flags=flags, compare=True)))
            else:
                results += timed_runs(mesh, shape, smoke, flags, kv_heads)
            if device == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(results, f)


def timed_runs(mesh, shape, smoke, flags, kv_heads) -> list:
    """The bf16 runs on the mesh ``shape`` (module doc): at (1, 4) (any
    "data" 1 with ``smoke``) and at (P, 1, M), M >= 2, the qwen3-8b
    decode, then with ``kv_heads`` on a 2-D mesh the same with the
    cache's KV heads over "model", else zamba2's prefill cell; at (2, 2)
    (any "data" 2 with ``smoke``) and at (P, D, 1), D >= 2, zamba2
    long_500k."""
    pod = len(shape) == 3
    data, model = _dm(shape)
    out = []
    if (shape == (1, 4) or (smoke and not pod and data == 1)
            or (pod and shape[1] == 1 and model >= 2)):
        for kv in (False, True) if kv_heads and not pod else (False,):
            out.append(dict(kind="decode", **timed_decode(
                mesh, "qwen3-8b", (4, 64) if smoke else QWEN_PROMPT,
                128 if smoke else QWEN_LEN, smoke, kv_heads=kv)))
        if not kv_heads or pod:
            out.append(dict(kind="prefill", **timed_prefill(
                mesh, "zamba2-1.2b", 64 if smoke else ZAMBA_PREFILL,
                smoke, cap=2 if smoke else 32, flags=flags)))
    if (shape == (2, 2) or (smoke and not pod and data == 2)
            or (pod and model == 1 and shape[1] >= 2)):
        out.append(dict(kind="decode", **timed_decode(
            mesh, "zamba2-1.2b", (1, 32 if smoke else ZAMBA_PROMPT),
            256 if smoke else 524288, smoke, compare=True, flags=flags)))
    return out


def fallback_timed(mesh, shape, smoke, flags) -> list:
    """``--fallback``'s bf16 runs on the mesh ``shape`` (module doc)."""
    data, model = _dm(shape)
    out = []
    if 32 % model:                  # zamba2's heads, whole on every rank
        out.append(dict(kind="prefill", **timed_prefill(
            mesh, "zamba2-1.2b", 64 if smoke else ZAMBA_PREFILL, smoke,
            cap=1, flags=flags, compare=True)))
    if data >= 2 and model >= 2:    # V2 groups over the "data" ranks
        out.append(dict(kind="decode", **timed_decode(
            mesh, "granite-moe-3b-a800m", (16, 64) if smoke else
            QWEN_PROMPT, 128 if smoke else QWEN_LEN, smoke,
            compare=True)))
    return out


def run_world(world, shapes, tmp, device, smoke, timed, f32,
              fallback=False, kv_heads=False, prefill_only=False) -> list:
    path = os.path.join(tmp, f"cells_world{world}.json")
    mp.start_processes(rank_main, args=(world, free_port(), shapes, path,
                                        device, smoke, timed, f32,
                                        fallback, kv_heads, prefill_only),
                       nprocs=world, join=True, start_method="spawn")
    with open(path) as f:
        return json.load(f)


def _nonzero(counts: dict):
    return {k: v for k, v in counts.items() if v} or "none"


def report(r: dict) -> str:
    if r["kind"] == "f32":
        if "refused" in r:
            what = f"refused: {r['refused'][-60:]}"
        else:
            eq = {k: "=" if r[k]["tokens_equal"] else "!="
                  for k in ("prefill", "decode")}
            what = (f"prefill tokens {eq['prefill']}"
                    f" logits {r['prefill']['logits_err']:.2e} cache "
                    f"{r['prefill']['cache_err']:.2e}; relayout "
                    f"{'exact' if r['relayout_exact'] else 'DIFFERS'}; "
                    f"decode tokens {eq['decode']} logits "
                    f"{r['decode']['logits_err']:.2e} cache "
                    f"{r['decode']['cache_err']:.2e}")
        tag = (f" fault {r['fault']}" if r["fault"] else "") + (
            f" batch 1 seq over {tuple(r['seq_axes'])}" if r["batch"] == 1
            else "") + (" KV heads over model" if r.get("kv_heads")
                        else "")
        verdict = ("caught" if not r["ok"] else "NOT CAUGHT") if \
            r["fault"] else ("ok" if r["ok"] else "FAILED")
        return (f"[cells] f32 {r['name']} at {tuple(r['mesh'])}{tag}: "
                f"{what} -> {verdict}")
    if r["kind"] == "prefill":
        return "\n".join(
            f"[cells] prefill {x['arch']} bf16 at {tuple(x['mesh'])}, "
            f"({x['batch']}, {x['seq']}): {x['prefill_ms']:.1f} ms, "
            f"{x['tok_s']:.0f} tok/s, peak {x['peak_gb_a_card']:.2f} GB a "
            f"card (weights {x['base_gb']:.2f}), cache "
            f"{x['cache_gb_a_card']:.2f} GB a card, {x['nccl_calls']} NCCL "
            f"calls, launches {_nonzero(x['launches'])}" + (
                "" if "tokens_equal" not in x else "; next tokens "
                + ("equal" if x["tokens_equal"] else "DIFFER from")
                + " one card's")
            for x in r["runs"]) + (f"\n[cells] prefill batch cut to "
                                   f"{r['chosen']} of the cell's 32")
    cmp = r["compared"]
    agree = ""
    if cmp is not None:
        differ = [(i + 1, c) for i, c in enumerate(cmp) if not c["agree"]]
        agree = (
            f"; fed one card's tokens, picks equal one card's in "
            f"{len(cmp) - len(differ)} of {len(cmp)} steps, logits within "
            f"{max(c['logits_err'] for c in cmp):.3e} of the largest "
            f"(|diff| up to {max(c['noise'] for c in cmp):.6g}); one "
            f"card's top-1 - top-2 logit where the picks differ: "
            + (", ".join(f"step {i} {c['gap']:.6g}" for i, c in differ)
               or "none")
            + f" (near-tie bound {r['ties']:.6g}), smallest at the "
            f"others {min(c['gap'] for c in cmp):.6g}"
            + ("" if r["ties_ok"] else " -> BEYOND A NEAR TIE"))
    steps = r["step_ms"]
    layout = ("the cache's KV heads over model" if r.get("kv_heads")
              else f"seq over {tuple(r['seq_axes'])}")
    return (f"[cells] decode {r['arch']} bf16 at {tuple(r['mesh'])}, batch "
            f"{r['batch']}, prompt {r['prompt']} -> {r['max_len']} "
            f"positions, {layout}: prefill "
            f"{r['prefill_ms']:.1f} ms, relayout {r['relayout_ms'][1]:.1f} "
            f"ms (cold {r['relayout_ms'][0]:.1f}), "
            f"decode {np.mean(steps[1:] or steps):.2f} ms a step (first "
            f"{steps[0]:.2f}), {r['tok_s']:.1f} tok/s, peak "
            f"{r['peak_gb_a_card']:.2f} GB a card, cache "
            f"{r['cache_gb_a_card']:.2f} GB a card, "
            f"{r['nccl_calls_a_step']} NCCL calls a step, prefill launches "
            f"{_nonzero(r['prefill_launches'])}, decode launches "
            f"{_nonzero(r['decode_launches'])}{agree}" + (
                "" if not r.get("profile") else
                "\n[cells] decode {} step under torch.profiler (rank 0): "
                "wall {:.2f} ms, kernels {:.2f} ms ({} launches), NCCL "
                "kernels {:.2f} ms, cuBLAS {:.2f} ms; top: {}".format(
                    r["arch"], r["profile"]["wall_ms"],
                    r["profile"]["busy_ms"], r["profile"]["launches"],
                    r["profile"]["nccl_ms"], r["profile"]["matmul_ms"],
                    "; ".join(f"{k} {v:.2f} ms x{n}"
                              for k, v, n in r["profile"]["top"]))))


def result_ok(r: dict) -> bool:
    if r["kind"] == "f32":
        return (not r["ok"]) if r["fault"] else r["ok"]
    if r["kind"] == "decode":
        return all(np.isfinite(r["step_ms"])) and r["ties_ok"]
    return all(x.get("tokens_equal", True) for x in r["runs"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--meshes", type=_mesh_arg, nargs="*", default=None,
                    help="meshes DxM or PxDxM (default 1xn and, from 4, "
                    "n/2x2)")
    ap.add_argument("--kv-heads", action="store_true",
                    help="the decode cells without seq_shard_decode too: "
                    "the f32 cases of KV_CASES, and the qwen3-8b decode "
                    "with the cache's KV heads over \"model\" (module "
                    "doc)")
    ap.add_argument("--prefill-only", action="store_true",
                    help="the bf16 runs: zamba2-1.2b's prefill cell alone, "
                    "batch 1, against one card, where \"model\" >= 2")
    ap.add_argument("--f32-only", action="store_true")
    ap.add_argument("--timed-only", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke configs for the timed runs")
    ap.add_argument("--fallback", action="store_true",
                    help="the timed runs of blocks \"model\" does not "
                    "divide and of V2 groups across ranks (module doc), "
                    "in place of the others; lines tagged [fallback]")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "dist_serve_cells.json"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("FAILED: no CUDA device")
    n = (torch.cuda.device_count() if args.device == "cuda" else
         max((int(np.prod(s)) for s in args.meshes or [(1, 2)]),
             default=2))
    meshes = args.meshes or ([(1, n)] + ([(n // 2, 2)] if n >= 4 else []))
    plan = {}
    for shape in meshes:
        plan.setdefault(int(np.prod(shape)), []).append(shape)
    # every mesh with a "pod" axis: lines tagged [pod]
    pod = all(len(shape) == 3 for shape in meshes)
    if max(plan) > n:
        raise SystemExit(f"FAILED: {max(plan)} ranks, {n} cards")
    say(f"[cells] {card()} x {n}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    tmp = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(tmp, exist_ok=True)
    out = {"card": card(), "cards": n, "results": []}
    ok = True
    t_all = time.perf_counter()
    for world, shapes in plan.items():
        t0 = time.perf_counter()
        results = run_world(world, shapes, tmp, args.device, args.smoke,
                            not args.f32_only, not args.timed_only,
                            args.fallback, args.kv_heads, args.prefill_only)
        for r in results:
            line = report(r)
            say(line.replace("[cells]", "[fallback]") if args.fallback
                else line.replace("[cells]", "[pod]") if pod else line)
            ok &= result_ok(r)
            out["results"].append(r)
        say(f"[cells] world {world} took {time.perf_counter() - t0:.1f}s")
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    say(f"[cells] done in {time.perf_counter() - t_all:.1f}s; results in "
        f"{args.out}")
    if not ok:
        say("FAILED: a check did not hold")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
