#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths on one CUDA card and check them.

Run from the repository root on a machine with a CUDA device:

    python3 chip_smoke.py

Phases (each prints its results; any failure exits non-zero before the
last line):
  1. device  — card name, count, `nvidia-smi` name and power limit;
  2. build   — nvcc builds every kernel library (one nvcc per source, in
               parallel) and prints ptxas' registers / shared memory;
  3. kernels — at the paper's geometry, batch 4, each kernel against its
               plain PyTorch version on the same inputs (seeded synthetic
               RF, the real delay tables and BSR operator) in f32, bf16
               and f16, then timed with CUDA events (L2 flushed before
               each launch) beside its bound and, where one PyTorch call
               computes the same function, that call's time; for
               `bsr_beamform` also its skip rule against the all-zero
               blocks, its operator check on the device, two runs
               bit-equal, f32 errors against float64, the 3xTF32 bound
               beside the SIMT one, and its bf16 time; `bsr_spmm` at (a)
               one channel's real product and (b) the beamform's real
               form (`real_form`, K 128, 128 x 128 blocks), each with
               two runs bit-equal, f32 errors against float64, the
               bounds over the stored slots and over the occupied
               blocks, and its bf16 time;
               for `das_beamform` and the fused spans the share of
               zero-apodization pairs they skip, the IQ bytes they stage
               into shared memory, the bound of the terms these tables
               need beside the all-terms bound and the no-FMA instruction
               floor, and two runs bit-equal;
  4. serve   — `serve_ultrasound_stream` at the paper's geometry for
               B-mode and power Doppler (pinned source, H2D on the
               executor's copy stream): the dynamic variant per stage
               and fused (power also with fusion_block 128), the cnn and
               sparse variants per stage, with the
               launch counters zeroed before and read after each run;
               then the split of one batch: the pinned host-to-device
               copy on the copy stream (CUDA events), and each stage of
               the engine on a device-resident batch;
  5. outputs — images from the card against the plain pipeline (paper
               geometry, on the card) and against the CPU (small input);
  5b. multitenant — `serve_multitenant` at the paper's geometry, B-mode
               and colour Doppler tenants, heuristic plan: a warm pool of
               the groups (one CUDA graph each; capture and warm-up
               times; replay against the eager engine on the same staged
               batch, bit for bit; replay and pinned H2D times), then
               windows at the reference CLI's defaults (async and block
               drain), one with arrivals faster than the card serves, a
               replay of a generated burst trace, and one of at least 2 s
               for energy; each prints rates, latencies, occupancy,
               overlap, transfer times, peak memory and NVML energy, and
               checks its bounds and sampled frames against the lone
               frame (bit for bit through the engine, within the image
               tolerance of the plain pipeline); last, one short window
               of B-mode tenants pinned to the cnn variant and
               colour-Doppler tenants pinned to sparse (one CUDA graph
               each), through the same oracle;
  5c. plan and shards — `plan_pipeline(policy="autotune")` at the
               paper's geometry, B-mode and power Doppler, unfused and
               fused: each variant's time and the fused probes at pixel
               tiles 64 / 128 / 256, each a served batch of 4 (graph
               replays, CUDA events), the pick (its own argmin, no
               kernel-bearing stage on its plain version), a second call
               from the memo, the device memory before and after; the
               constants' disk tier in a fresh directory under build/
               (a disk hit, bit-equal; the cnn and sparse operators past
               the per-file cap; outside this phase the disk tier is
               off); `serve_ultrasound_sharded` on the one card
               (per-device latency, speedup and scale efficiency; counts
               zeroed just before, read just after: das_beamform only);
               `ShardedExecutor` over [cuda:0, cuda:0] on a batch of 5
               against `BatchedExecutor`, bit for bit (dynamic, fused,
               cnn, sparse); one multitenant window of AUTO tenants
               planned by autotune, through the 5b oracle. The kernels
               line adds the counts of the sharded stream and of that
               window only, not the planner's probes or the comparisons;
  6. lm kernels — the ultrasound tensors freed, `flash_attention` at
               zamba2's prefill shape and `ssd_scan` at its scoring shape,
               f32, each against its plain version, timed as in 3, with
               bounds for their 3xTF32 tensor-core route beside the f32
               SIMT bound; then the same at the new models' shapes
               (`[lm]` lines): flash at seamless-m4t's decoder
               self-attention (4, 2048, 16 heads, d 64), the SSD at
               mamba2-130m's scoring forward (N 128, chunk 64);
  7. lm serve — zamba2-1.2b at full width and depth in bf16, random
               weights from a seed: `serve_session` with the flash kernel
               (8 requests, slot batch 4, prompt 1024, 32 new tokens),
               then scoring (`loss_fn`, forward at (4, 2048)) with the SSD
               kernel, each with the launch counters zeroed before and
               read after; then mamba2-130m, gemma3-1b and
               seamless-m4t-large-v2 the same way with both kernel flags
               set (seamless's prompt is 1024 encoder frames): serving
               launches no kernel; scoring launches `ssd_scan` once a
               layer (mamba2), `flash_attention` once a decoder layer
               (seamless), neither (gemma3: its window is a tensor, the
               reference's condition); then granite-moe-3b-a800m (V2
               dispatch), deepseek-v2-236b (full width, 4 of its 60
               layers: the cut is printed on each line) and qwen2-vl-2b
               (prompts with patch embeddings and M-RoPE positions), both
               flags set, launching neither kernel; peak memory of each;
     each model then `[lm split]`: torch.profiler over one prefill, one
               decode step and one scoring forward, for the device's busy
               share, the kernels that take the device time, and the
               "other" kernels' time by the ATen op that launched them;
  7b. moe variants — granite-moe at full width and depth in bf16, its
               scoring forward under the paper's V1, V2 and V3 dispatch
               (CUDA events, peak memory), then the three in f32 at
               (2, 256) with no drops, within 1e-4 of each other;
  8. lm outputs — full width in f32, each model: the kernel path's logits
               against the plain path's, and prefill and decode logits
               against forward's (gemma3 also at prompt 640, where its
               local window bites; the MoE models at a capacity with no
               drops, deepseek-v2 at depth 2; qwen2-vl on tokens only);
   8b. products — the attention products without autograd:
               `f32_product` of bf16 operands against the f32-cast
               product, and the device memory one decode attention
               (gemma3's and zamba2's served caches) and one MLA decode
               (deepseek-v2's widths) allocate, below the size of the
               cache or absorbed weights that a copy would take;
  8c. train  — `init_train_state` + `make_train_step` at full width and
               depth in bf16, remat as configured, TokenDataset batches
               at (4, 2048), in the training loop's deterministic mode:
               mamba2-130m, zamba2-1.2b and gemma3-1b (required), then
               qwen2-vl-2b, seamless-m4t-large-v2 and granite-moe-3b-
               a800m (V2) where they fit (out of memory: 2 microbatches,
               then (2, 2048); each line prints its cut): one warm and 3
               timed steps (CUDA events and host clock), tok/s, peak
               memory, loss and grad norm, no kernel launched; on
               mamba2-130m the loss falling on a repeated batch, and
               `train_loop` cut at step 3 and resumed (`run_resilient`)
               against the uncut run, the step-2 and step-4 checkpoints
               bit for bit; both kernels refusing a gradient on the
               card; one gemma3-1b train step under torch.profiler
               (`[lm split]`);
  8c2. dryrun — each step that 8c timed, costed by the dry run
               (`launch.dryrun.dry_run`) on the meta device on this
               machine's CPU: its counted FLOPs (all, and the matmuls'),
               the model FLOPs (6 N D), the step's ms from 8c, the
               achieved TFLOP/s, `mfu` (model FLOPs over the step's
               seconds times the data sheet's bf16 peak, with the card's
               name and power limit) and the reckoned peak beside the
               measured one; fails if the dry run raises or a count is
               zero or not finite;
  8d. dist   — every card a rank (NCCL): in this process, world 1:
               gemma3-1b bf16 at full width and depth, (4, 2048), three
               steps of the data-parallel step at one rank (ZeRO-1 on,
               which splits nothing there) against
               `make_train_step`, parameters, moments and metrics bit
               for bit (step ms, tok/s, peak memory); the int8
               compressed mean of the step's gradient tree with a
               residual on the card against the CPU, bit for bit; with
               two or more cards, tools/dist_train_scaling.py (its own
               process) over 1 and all of them: the same at (4, 2048) a
               card with ZeRO-1 on and off (tok/s, scale efficiency,
               peak MB a card) and gemma3-1b f32 at a global (2n, 256),
               one step against one card (its `f32_check`, with the
               faults it must catch);
  8e. tp     — tensor parallelism over "model": in this process, the
               step on a mesh of (1, 1), which takes the one-device
               path (at a "model" extent of 1 `model_axis` is None:
               every piece is whole and no "model" collective runs; the
               Megatron pair, the vocab-parallel loss and the shared
               gradients' sum run only from two cards), on mamba2-130m
               bf16 at full width and depth, (4, 2048), two steps
               against `make_train_step` bit for bit; with two or more
               cards,
               tools/dist_train_scaling.py --meshes (its own process) at
               (1, n) and, from 4 cards, (n / 2, 2): gemma3-1b bf16 at a
               global (16, 2048) (tok/s, peak MB a card) and the f32
               step against one card for gemma3-1b (one KV head shared
               by every rank) and mamba2-130m (in_proj's segments, the
               gated norm over the whole width), each with the faults it
               must catch (the shared KV head's "model" sum left out,
               the gated norm over the rank's width); no kernel launched
               (the counts zeroed before the phase, and the tool's own);
  8f. ep     — the experts over "model": in this process, granite-moe's
               smoke config (f32, V2, 48 padded experts) on a mesh of
               (1, 1), two steps against `make_train_step` bit for bit
               (at "model" 1 every expert is local and the experts'
               copy_in / reduce_out are the identity: no expert-parallel
               code runs); with two or more cards,
               tools/dist_train_scaling.py --moe --moe-timed v2 (its own
               process) at (1, n) and, from 4 cards, (n / 2, 2): the f32
               step against one card for granite-moe's unpadded smoke
               (V1, V2, V3) and deepseek-v2's smoke (MLA, a shared
               expert), each with the two faults it must catch (the
               experts' input and the combine weights without their
               backward "model" sum), and granite-moe (V2) bf16 at full
               width and depth, a global (4, 2048), 2 timed steps (tok/s,
               peak MB and state a card); routes equal over "model" in
               every job; no kernel launched;
  8g. fsdp   — the parameters split over "data" (ParallelConfig.fsdp):
               in this process gemma3-1b's smoke config (f32, remat) on
               a mesh of (1, 1) under fsdp, two steps against
               `make_train_step` bit for bit (at "data" 1 no parameter
               splits and nothing is gathered); with two or more cards,
               tools/dist_train_scaling.py --fsdp --f32-only (its own
               process) at (n, 1) and, from 4 cards, (n / 2, 2): two
               FSDP steps of four smoke configs (gemma3-1b, mamba2-130m,
               granite-moe unpadded V2, deepseek-v2) against two on one
               card, each with the two faults it must catch (the
               gathered weights' gradients unsummed over "data", the
               gathered layers cached across steps); no kernel launched;
  8h. cells  — the serving cells on a (data, model) mesh
               (`launch.cells`): in this process, zamba2-1.2b bf16 at
               full width and depth with its kernel flags on a mesh of
               (1, 1), the prefill cell of a (4, 1024) prompt, the cache
               grown and relayout into the decode cell's layout, and
               four decode steps, against `make_prefill_step` /
               `make_serve_step` without a mesh bit for bit (at "model"
               1 nothing splits); the flash kernel's launches of the
               prefill cell (6), none in decode, are added to the
               kernels line; with two or more cards,
               tools/dist_serve_cells.py (its own process) at (1, n)
               and, from 4 cards, (n / 2, 2): the f32 checks of every
               family's smoke config against one card with their three
               faults, and the bf16 runs (qwen3-8b's decode over a
               32,768-position cache, zamba2-1.2b's long_500k decode
               against one card, zamba2-1.2b's prefill cell at 32,768
               positions with the flash kernel);
  8i. fallback — blocks that "model" does not divide (whole on every
               rank, or the attention's rows split again over "model"
               under ``attn_batch_fallback``) and MoE V2's dispatch
               groups across ranks: with three or more cards, at (1, 3),
               tools/dist_train_scaling.py --attn-batch (its own
               process: gemma3-1b's f32 checks at full width with the
               fallback off and on, each with its faults, then gemma3-1b
               off and on, qwen2-vl-2b and granite-moe bf16 at (3, 2048)
               against one card; no kernel launched) and
               tools/dist_serve_cells.py --fallback (the f32 checks of
               every family's smoke at (1, 3), and zamba2-1.2b's prefill
               cell at 32,768 positions, batch 1, attention and SSM whole
               on every rank: the flash kernel's launches, 6 a rank, are
               added to the kernels line, and its next token equals one
               card's); with fewer cards it says that it needs three;
  8j. pod    — the "pod" axis as data (the reference's multi-pod rules:
               the batch and FSDP's blocks over ("pod", "data")) and
               decode with the cache's KV heads over "model": with four
               or more cards, at (2, 2, 1) and (2, 1, 2),
               tools/dist_train_scaling.py --f32-only (its own process:
               gemma3-1b's f32 check at full width, mamba2-130m's at
               "model" 2, each with its faults, among them the gradients
               summed over "data" alone; no kernel launched) and
               tools/dist_serve_cells.py --kv-heads --prefill-only (the
               f32 checks of qwen3 and zamba2 at batch 4 and 1 and of the
               decode cells without seq_shard_decode, with the fault
               that writes head block 0's K/V into every rank's cache;
               zamba2-1.2b's prefill cell at 32,768 positions, batch 1,
               at (2, 1, 2): the flash kernel's launches, 6 a rank, are
               added to the kernels line, and its next token equals one
               card's); with fewer cards it says that it needs four;
  9. launches — how many CUDA launches one call of each multi-launch
               kernel makes, and the device time of each (torch.profiler,
               after every timed phase): the fused spans at the paper's
               geometry, flash_attention and ssd_scan; then `[engine
               trace]`: each fused engine (B-mode, power) on a
               device-resident batch, its time a call (CUDA events) beside
               the host's time to enqueue a call, and its kernels' device
               times under torch.profiler, their share of the event time
               and the device's idle share;
 10. a JSON line {"kernels": [...]} and, last, the device line.

Needs only this checkout (it puts src/ on sys.path) and imports no JAX.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch  # noqa: E402,F401  (sets the TF32 switches)
from repro_torch import kernels  # noqa: E402
from repro_torch.core import (BatchedExecutor, CONSTS_CACHE_STATS,  # noqa: E402
                              PRECISION_TOLERANCES, Modality,
                              ShardedExecutor, clear_consts_cache,
                              consts_cache_dir, consts_from_numpy,
                              init_pipeline, monolithic_pipeline_fn,
                              paper_config, plan_pipeline,
                              set_consts_cache_dir, stage_fns, tiny_config)
from repro_torch.bench.resources import (NvmlEnergyMeter,  # noqa: E402
                                        nvml_indices_for_local_gpus)
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.core import demod, lowering  # noqa: E402
from repro_torch.core.config import Variant  # noqa: E402
from repro_torch.core.aot import warm_pool  # noqa: E402
from repro_torch.core.executor import _pad_rows  # noqa: E402
from repro_torch.core.staging import StagingRing  # noqa: E402
from repro_torch.core.delays import check_skipped_slots  # noqa: E402
from repro_torch.data import synth_train_batch  # noqa: E402
from repro_torch.data import synth_rf  # noqa: E402
from repro_torch.data.traces import generate_trace, mixed_rate  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels.bsr_spmm import (block_sample_axis,  # noqa: E402
                                          bsr_beamform, bsr_beamform_ref,
                                          bsr_spmm, bsr_spmm_ref, kept_slots,
                                          real_form)
from repro_torch.kernels.bsr_spmm.ops import require_checked  # noqa: E402
from repro_torch.kernels.das_beamform import (das_beamform,  # noqa: E402
                                              das_beamform_ref)
from repro_torch.kernels.das_beamform.ops import tile_plan  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_ref)
from repro_torch.kernels.fused_pipeline import (  # noqa: E402
    fused_ref, fused_rf_to_envelope, fused_rf_to_power)
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref  # noqa: E402
from repro_torch.launch.scheduler import (BatchPolicy,  # noqa: E402
                                          make_mixed_streams,
                                          make_trace_streams,
                                          serve_multitenant)
from repro_torch.launch.serve import (SyntheticAcquisitionSource,  # noqa: E402
                                      _grow_cache, serve_session,
                                      serve_ultrasound_sharded,
                                      serve_ultrasound_stream)
from repro_torch.checkpoint import latest_step  # noqa: E402
from repro_torch.configs import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.data.tokens import TokenDataset  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402
from repro_torch.models import attention, get_model  # noqa: E402
from repro_torch.models.common import (f32_product,  # noqa: E402
                                       logits_from_hidden)
from repro_torch.runtime.fault_tolerance import run_resilient  # noqa: E402
from repro_torch.train.steps import (deterministic_algorithms,  # noqa: E402
                                     init_train_state, make_train_step)
from repro_torch.models.hybrid import n_attn_invocations  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.checkpoint import host_tree  # noqa: E402
from repro_torch.launch.mesh import binding_for, make_mesh  # noqa: E402
from repro_torch.optim.compress import compressed_psum_mean  # noqa: E402
from repro_torch.runtime.sharding import use_binding  # noqa: E402
from repro_torch.train.steps import (make_prefill_step,  # noqa: E402
                                     make_serve_step, state_blocks)

from repro_torch.launch.dryrun import dry_run  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
# NVIDIA H100 SXM data sheet (launch/roofline.py): HBM rate, f32 rate
# outside the tensor cores, dense TF32 and bf16 rates of the tensor cores.
from repro_torch.launch.roofline import (  # noqa: E402
    HBM_BW as PEAK_BYTES_PER_S, PEAK_F32_FLOPS as PEAK_F32_FLOP_PER_S,
    PEAK_TF32_FLOPS as PEAK_TF32_FLOP_PER_S,
    PEAK_FLOPS as PEAK_BF16_FLOP_PER_S)
SPLIT_TF32 = 3          # 3xTF32: three TF32 products per f32 product
# f32 instructions per second outside the tensor cores (128 lanes x 132
# SMs x 1.98 GHz): half the FLOP rate, which counts an FMA as two. Built
# with -fmad=false, every f32 operation of the DAS kernels is one.
NO_FMA_INSTR_PER_S = PEAK_F32_FLOP_PER_S / 2

BATCH = 4
N_BATCHES = 16
F32_TOL = 1e-5          # max|kernel - plain| / max|plain|, see test_torch_gpu
IMAGE_TOL = {"bmode": 1.2e-3, "power_doppler": 1e-4,   # test_torch_slice
             "doppler": 1e-4}
TABLES = ("carrier", "lpf", "idx", "frac", "apod", "rot")
DAS_TABLES = ("idx", "frac", "apod", "rot")
# (variant, fusion) of each served path; the kernel each must launch
PATHS = (("dynamic", "none"), ("dynamic", "fused"), ("cnn", "none"),
         ("sparse", "none"))
FUSION_BLOCK = 128      # a fused run with the pixel tile set, not default
FUSED_KERNEL = {"bmode": "fused_rf_to_envelope",
                "power_doppler": "fused_rf_to_power"}

# Multi-tenant serving at the paper's geometry: the reference CLI's
# defaults (4 clients, 24 frames each at base 120 fps, max batch 4, 5 ms
# queue delay, 2 in flight)
MT_CLIENTS, MT_FRAMES, MT_BASE_FPS = 4, 24, 120.0
MT_POLICY = BatchPolicy(max_batch=4, max_queue_delay_ms=5.0)
MT_IN_FLIGHT = 2
MT_OVERLOAD = 2.0        # offered load over the measured service rate
MT_ENERGY_S = 2.5        # the energy window: its slowest client's span
MT_SAMPLE = (0, 1, -1)   # frames of each stream held to the lone frame

# LM half: zamba2-1.2b, served and scored at full width and depth, then
# the models of the dense, ssm, enc-dec, MoE (with MLA) and VLM families
# the same way
ARCH = "zamba2-1.2b"
LM_REQUESTS, LM_BATCH, PROMPT_LEN, MAX_NEW = 8, 4, 1024, 32
SCORE_SHAPE = (4, 2048)
LM_FLAGS = dict(use_flash_kernel=True, use_ssd_kernel=True)
# model: (serving flags, scoring flags, the kernels each run must launch,
# any other 0). zamba2: flash in its 6 shared-attention calls of each of
# 2 prefills, the SSD in its 38 layers. The new models serve with no
# kernel (prefill asks for states; seamless's prefill is encode + decode;
# gemma3's window is a tensor, so flash stays off, as the reference's)
# and score with one launch a layer; the MoE and VLM transformers launch
# neither kernel (their windows are tensors; MLA attends by chunks)
LM_MODELS = {
    ARCH: (dict(use_flash_kernel=True), dict(use_ssd_kernel=True),
           {"flash_attention": 12}, {"ssd_scan": 38}),
    "mamba2-130m": (LM_FLAGS, LM_FLAGS, {}, {"ssd_scan": 24}),
    "gemma3-1b": (LM_FLAGS, LM_FLAGS, {}, {}),
    "seamless-m4t-large-v2": (LM_FLAGS, LM_FLAGS, {},
                              {"flash_attention": 24}),
    "granite-moe-3b-a800m": (LM_FLAGS, LM_FLAGS, {}, {}),
    "deepseek-v2-236b": (LM_FLAGS, LM_FLAGS, {}, {}),
    "qwen2-vl-2b": (LM_FLAGS, LM_FLAGS, {}, {}),
}
# depth cuts: deepseek-v2's 60 layers (~475 GB of bf16 weights) do not
# fit one card; 4 layers at full width are ~34 GB
LM_DEPTH = {"deepseek-v2-236b": 4}
MOE_ARCH = "granite-moe-3b-a800m"    # the [moe variants] line
MOE_VARIANTS = ("dynamic", "cnn", "sparse")
MOE_F32_SHAPE = (2, 256)
MOE_F32_TOL = 1e-4                   # max|d| / max|ref| between variants


def no_drop(arch) -> float:
    """A capacity factor at which no assignment can be dropped, as in
    tests/test_decode_consistency.py (8 there, at 8 experts, top 2):
    E / k makes every expert's capacity exceed the tokens of a dispatch
    group; never below 8. Prefill and forward dispatch the same tokens in
    groups of other sizes, so only then do they compute the same thing
    (deepseek-v2: 8 gives 80 slots for 256 tokens)."""
    cfg = get_config(arch)
    return max(8.0, cfg.n_experts / cfg.n_experts_per_tok)


# phase 8's f32 checks: (model, prompt, config overrides); gemma3's local
# window (512) bites at 640; the MoE models at a capacity with no drops,
# deepseek-v2 at depth 2
OUTPUT_RUNS = ((ARCH, 256, {}), ("mamba2-130m", 256, {}),
               ("gemma3-1b", 256, {}), ("gemma3-1b", 640, {}),
               ("seamless-m4t-large-v2", 256, {}),
               ("granite-moe-3b-a800m", 256,
                dict(capacity_factor=no_drop("granite-moe-3b-a800m"))),
               ("deepseek-v2-236b", 256,
                dict(capacity_factor=no_drop("deepseek-v2-236b"),
                     n_layers=2)),
               ("qwen2-vl-2b", 256, {}))
# the [train] phase: full width and depth in bf16, remat as configured,
# TokenDataset batches at the scoring shape; the first three must fit,
# the rest run where they do. A model out of memory runs again with 2
# microbatches at the same global batch, then at (2, 2048).
TRAIN_REQUIRED = ("mamba2-130m", "zamba2-1.2b", "gemma3-1b")
TRAIN_OPTIONAL = ("qwen2-vl-2b", "seamless-m4t-large-v2",
                  "granite-moe-3b-a800m")
TRAIN_CUTS = ((1, SCORE_SHAPE), (2, SCORE_SHAPE), (1, (2, 2048)))
TRAIN_TIMED = 3            # timed steps after one warm step
TRAIN_CHECK_ARCH = "mamba2-130m"
FLASH_TOL = (2e-4, 2e-5)   # rtol, atol: test_torch_lm_kernels / _gpu
SSD_TOL = (2e-4, 2e-4)
LOGITS_TOL = 2e-3          # rtol = atol, tests/test_decode_consistency.py


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def max_err(out: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max|out - ref|, max|ref|)."""
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    return err, ref.abs().max().item()


def time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` per call, by CUDA events around each
    call, with the L2 cache flushed (a 512 MB write) before each."""
    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.mean([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def bound(nbytes: float, flops: float,
          flop_per_s: float = PEAK_F32_FLOP_PER_S) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the operations over ``flop_per_s``."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def split_tf32_bound(nbytes: float, flops: float) -> tuple:
    """The bound of an f32 product run as 3xTF32 on the tensor cores, and
    beside it the same work's bound on the f32 FMA units (SIMT)."""
    return (bound(nbytes, SPLIT_TF32 * flops, PEAK_TF32_FLOP_PER_S),
            bound(nbytes, flops))


def profiled(fn) -> tuple:
    """One call of ``fn`` under torch.profiler, after one warm call: the
    CUDA kernels' events (an empty list where the profiler sees no device
    activity), the call's wall time in ms (host clock; the profiler adds
    host overhead) and the profile's events."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a marker kernel first: the trace can miss the session's first
        # kernel, and this one is left out of the result by its name
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return ([e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "spin_kernel" not in e.key], wall, prof.events())


def check_precisions(name, kernel, plain) -> float:
    """``kernel(p)`` against ``plain(p)`` at f32 (1e-5 * max) and at bf16
    and f16 (PRECISION_TOLERANCES, and the same 1e-5 * max: both round
    the same operands). Returns the f32 max|d|."""
    errs = {}
    for prec in ("f32", "bf16", "f16"):
        out, ref = kernel(prec), plain(prec)
        err, scale = max_err(out, ref)
        if prec != "f32":
            rtol, atol = PRECISION_TOLERANCES[(prec, Modality.BMODE)]
            check(bool(((out - ref).abs() <= atol * scale
                        + rtol * ref.abs()).all()),
                  f"{name}[{prec}] outside PRECISION_TOLERANCES")
        say(f"[kernels] {name}[{prec}] max|d|={err:.3e} "
            f"tol={F32_TOL * scale:.3e} (max|plain|={scale:.3e})")
        check(err <= F32_TOL * scale, f"{name}[{prec}] disagrees with plain")
        errs[prec] = err
        del out, ref
    return errs["f32"]


def measure(rows: dict, flush: torch.Tensor, tag: str = "[kernels]") -> dict:
    """Time each row's kernel, plain version and library call, then drop
    the closures (and with them the tensors they hold)."""
    out = {}
    for name, row in rows.items():
        row["ms"] = time_ms(row.pop("fn"), 20, flush)
        row["plain_ms"] = time_ms(row.pop("plain"), 3, flush)
        library = row.pop("library", None)
        row["library_ms"] = (time_ms(library, 20, flush)
                             if library is not None else None)
        lib = (f"{row['library_ms']:.4f} ms ({row['library_name']})"
               if library is not None else row["library_name"])
        simt = row.get("simt_bound")
        simt = (f", SIMT bound {simt[0]:.4f} ms ({simt[1]})"
                if simt is not None else "")
        if "all_bound" in row:
            simt += (f", all-terms bound {row['all_bound'][0]:.4f} ms "
                     f"({row['all_bound'][1]}), no-FMA floor "
                     f"{row['floor_ms']:.4f} ms")
        say(f"{tag} {name}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound'][0]:.4f} ms "
            f"({row['bound'][1]}){simt}, library: {lib}")
        out[name] = row
    return out


def card_line() -> str:
    """What `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` prints, one card a line."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "\n".join(line.strip()
                     for line in smi.stdout.strip().splitlines())


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("FAILED: torch.cuda.is_available() is false — "
                         "chip_smoke.py needs a CUDA device")
    name = torch.cuda.get_device_name(0)
    say(f"[device] {name} x{torch.cuda.device_count()} "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    say(card_line())
    # the NVML idle baseline, before any work heats the board: every
    # energy meter of this process subtracts this first reading
    idle = NvmlEnergyMeter(
        device_indices=nvml_indices_for_local_gpus([0])).idle_w
    say(f"[device] idle board power {idle} W (NVML, before any work)")
    check(idle is not None, "NVML gives no board power: energy unmeasured")
    return name


def path_counts() -> dict:
    """Launches since the last reset: the wrappers' own and those of the
    CUDA graphs replayed (each replay runs the wrappers' kernels it
    captured)."""
    replayed = kernels.replayed_launch_counts()
    return {k: n + replayed[k] for k, n in kernels.launch_counts().items()}


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = cuda_lib.build()
    say(f"[build] {len(paths)} libraries in "
        f"{time.perf_counter() - t0:.1f}s (nvcc {cuda_lib.NVCC_FLAGS})")
    for name in paths:
        log = cuda_lib.build_log(name)
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", log))
        smem = sorted({int(m) for m in re.findall(r"(\d+) bytes smem", log)})
        say(f"[build] {name}: {len(regs)} kernels, {min(regs)}-{max(regs)} "
            f"registers, {spills} bytes spilled, static smem {smem} bytes")


def dynamic_rows(source, flush) -> dict:
    dev = torch.device("cuda")
    cfg = paper_config(variant="dynamic", modality="power_doppler")
    c = consts_from_numpy(init_pipeline(cfg), dev)
    rf = torch.as_tensor(source.next()).to(dev)
    b, n_l, n_c, n_f = rf.shape
    n_pix, n_s, k = cfg.n_pix, -(-n_l // cfg.decim), c["lpf"].shape[0]
    n_wall = c["wall_taps"].shape[0]
    iq = demod.rf_to_iq(c, rf, cfg.decim)
    tabs = [c[n] for n in DAS_TABLES]
    rows = {}

    # das_beamform: f32 against the f32 plain version, reduced precision
    # against the plain version at the same precision (PRECISION_TOLERANCES).
    das_err = check_precisions(
        "das_beamform", lambda p: das_beamform(*tabs, iq, precision=p),
        lambda p: das_beamform_ref(*tabs, iq, precision=p))
    tab_bytes = n_pix * n_c * (4 + 4 + 4 + 8)
    rf_bytes = rf.numel() * 2
    # the kernels skip (pixel, channel) pairs of zero apodization: the
    # operations bound counts the terms these tables need; the all-terms
    # bound is printed beside it
    n_needed = int((c["apod"] != 0).sum())
    das_flops, das_all = (16.0 * b * n * n_f for n in (n_needed,
                                                        n_pix * n_c))
    plan = tile_plan()
    staged, n_direct = staged_iq(c["idx"], c["apod"], b, n_f, plan)
    say(f"[kernels] DAS loop, bp {plan['bp']} ({plan['block_acqs']} "
        f"acquisitions a block, stages of {plan['stage_rows']} IQ rows): "
        f"{1 - n_needed / (n_pix * n_c):.2%} of (pixel, channel) pairs "
        f"have apod 0 and are skipped; IQ staged into shared memory "
        f"{staged / 1e6:.1f} MB per batch of {b} ({n_direct} (tile, "
        f"channel) windows read from global memory instead)")
    demod_flops = b * n_s * n_c * n_f * 4.0 * k + b * n_l * n_c * n_f * 2.0
    wall_flops = b * n_pix * (n_f - n_wall + 1) * (4.0 * n_wall + 4)
    none = "none: no single PyTorch call computes this function"
    das_bytes = tab_bytes + iq.numel() * 4 + b * n_pix * n_f * 8
    rows["das_beamform"] = dict(
        err=das_err,
        fn=lambda: das_beamform(*tabs, iq),
        plain=lambda: das_beamform_ref(*tabs, iq),
        bound=bound(das_bytes, das_flops),
        all_bound=bound(das_bytes, das_all),
        floor_ms=das_flops / NO_FMA_INSTR_PER_S * 1e3,
        library_name=none,
        source="src/repro_torch/kernels/csrc/das_beamform.cu",
        replaces="src/repro/kernels/das_beamform/kernel.py:93")

    ft = [c[n] for n in TABLES]
    heads = {
        "fused_rf_to_envelope": (
            lambda p="f32": fused_rf_to_envelope(*ft, rf, decim=cfg.decim,
                                                 precision=p),
            lambda p="f32": fused_ref(*ft, rf, decim=cfg.decim,
                                      precision=p),
            b * n_pix * n_f * 4, 3.0 * b * n_pix * n_f),
        "fused_rf_to_power": (
            lambda p="f32": fused_rf_to_power(*ft, c["wall_taps"], rf,
                                              decim=cfg.decim, precision=p),
            lambda p="f32": fused_ref(*ft, rf, decim=cfg.decim,
                                      head="power_doppler",
                                      wall=c["wall_taps"], precision=p),
            b * n_pix * 4, wall_flops),
    }
    for name, (fn, plain, out_bytes, head_flops) in heads.items():
        err = check_precisions(name, fn, plain)
        nbytes = rf_bytes + n_l * 8 + k * 4 + tab_bytes + out_bytes
        flops = demod_flops + das_flops + head_flops
        rows[name] = dict(
            err=err, fn=fn, plain=plain,
            bound=bound(nbytes, flops),
            all_bound=bound(nbytes, demod_flops + das_all + head_flops),
            floor_ms=flops / NO_FMA_INSTR_PER_S * 1e3,
            library_name=none,
            source="src/repro_torch/kernels/csrc/fused_pipeline.cu",
            replaces="src/repro/kernels/fused_pipeline/kernel.py:196")
    for name, row in rows.items():
        check(torch.equal(row["fn"](), row["fn"]()),
              f"{name}: two runs differ")
    say("[kernels] das_beamform, fused_rf_to_envelope, fused_rf_to_power: "
        "two runs bit-equal")
    return measure(rows, flush)


def staged_iq(idx, apod, batch, n_f, plan) -> tuple:
    """The IQ bytes the DAS loop stages into shared memory for one call
    with the built library's tile ``plan`` (``tile_plan``), and the (tile,
    channel) windows it reads from global memory instead: per tile and
    channel, the rows from the least to the largest sample index + 1 over
    the pixels of non-zero apodization, for each chunk of acquisitions
    that a block holds (csrc/das_common.cuh)."""
    bp, per_block = plan["bp"], plan["block_acqs"]
    n_pix, n_c = idx.shape
    pad = -n_pix % bp
    nz = torch.nn.functional.pad(apod, (0, 0, 0, pad)).view(-1, bp, n_c) != 0
    i = torch.nn.functional.pad(idx, (0, 0, 0, pad)).view(-1, bp, n_c)
    lo = torch.where(nz, i, torch.iinfo(torch.int32).max).amin(1)
    hi = torch.where(nz, i, -1).amax(1)
    length = torch.where(hi >= 0, hi - lo + 2, 0)
    staged = direct = 0
    for b0 in range(0, batch, per_block):
        rows = length * min(per_block, batch - b0)
        fits = rows <= plan["stage_rows"]
        staged += int(rows[fits].sum()) * n_f * 8
        direct += int((~fits).sum())
    return staged, direct


def library_check(name, fn, ref) -> bool:
    """Whether torch's block-sparse product ``fn`` computes what the plain
    version ``ref`` does (1e-5 * max). Prints the reason where not."""
    try:
        err, scale = max_err(fn(), ref)
    except (RuntimeError, NotImplementedError, ValueError) as exc:
        say(f"[kernels] {name} library: torch refused the BSR product: "
            f"{type(exc).__name__}: {str(exc).splitlines()[0][:200]}")
        return False
    say(f"[kernels] {name} library max|d|={err:.3e} (max|plain|="
        f"{scale:.3e})")
    if err > F32_TOL * scale:
        say(f"[kernels] {name} library: disagrees with the plain version")
        return False
    return True


def sorted_bsr(cols, values, n_rows, n_cols):
    """torch's BSR tensor of one row of blocks per pixel block, the slots
    of each row sorted by column (the padded slots repeat column 0)."""
    cols = cols.long()
    order = cols.argsort(dim=1, stable=True)
    n_pb, slots = cols.shape
    rows = torch.arange(n_pb, device=cols.device)[:, None]
    crow = torch.arange(0, n_pb * slots + 1, slots, device=cols.device)
    return torch.sparse_bsr_tensor(
        crow, cols[rows, order].reshape(-1),
        values[rows, order].reshape((-1,) + values.shape[2:]),
        size=(n_rows, n_cols))


def check_skip_rule(cols, occupied) -> None:
    """The slots bsr_beamform's kernel skips (``kept_slots`` False) are
    all-zero blocks, and the all-zero blocks it keeps are exactly slot 0
    of the rows with no occupied block (``cols`` cannot tell those from a
    block at column 0)."""
    kept = kept_slots(cols)
    empty = ~occupied.any(-1, keepdim=True)
    slot0 = torch.arange(cols.shape[-1], device=cols.device) == 0
    n_zero = int((~occupied).sum())
    n_skip = int((~kept).sum())
    n_kept_zero = int((kept & ~occupied).sum())
    per_pb = kept.sum(dim=(0, 2)).float()        # kept units per pixel block
    say(f"[kernels] bsr_beamform skip rule: {n_skip} slots skipped, "
        f"{int(kept.sum())} kept; {n_zero} all-zero blocks: {n_skip} "
        f"skipped, {n_kept_zero} kept (slot 0 of the {int(empty.sum())} "
        f"rows with no occupied block); kept per pixel block: min "
        f"{per_pb.min().item():.0f}, mean {per_pb.mean().item():.2f}, max "
        f"{per_pb.max().item():.0f}")
    check(not bool(occupied[~kept].any()), "a skipped slot is not zero")
    check(torch.equal(kept & ~occupied, empty & slot0),
          "kept all-zero blocks other than slot 0 of empty rows")


def spmm_shapes(cols, blocks, iq_b) -> tuple:
    """bsr_spmm's two timed shapes from the sparse operator and a batch of
    blocked IQ: (a) the real part of the middle channel's product; (b) the
    sparse beamform's real form (``real_form``: the reference's own
    formulation of the beamform, four real SpMMs a channel, as one real
    product). Returns ({"a": args, "b": args}, (b)'s view back to the
    beamform's output)."""
    n_c, n_pb, k, bp, bs, _ = blocks.shape
    b, n_sb, _, _, n_f, _ = iq_b.shape
    ch = n_c // 2
    a = (cols[ch].contiguous(), blocks[ch, ..., 0].contiguous(),
         iq_b[:, :, :, ch, :, 0].permute(1, 2, 0, 3)
         .reshape(n_sb, bs, b * n_f).contiguous())
    args_b, back = real_form(cols, blocks, iq_b)
    return {"a": a, "b": args_b}, back


def spmm_bounds(cols, blocks, x) -> dict:
    """bsr_spmm's bounds at one shape, each by ``split_tf32_bound`` (the
    3xTF32 route and the SIMT bound): over the stored slots, which the
    contract makes the kernel sum, and over the occupied blocks."""
    n_pb, k, bp, bs = blocks.shape
    nf = x.shape[-1]
    occ = int((blocks != 0).flatten(2).any(-1).sum())
    rest = cols.numel() * 4 + x.numel() * 4 + n_pb * bp * nf * 4
    per_block = 2.0 * bp * bs * nf
    return {"stored": split_tf32_bound(n_pb * k * bp * bs * 4 + rest,
                                       per_block * n_pb * k),
            "occupied": split_tf32_bound(occ * bp * bs * 4 + rest,
                                         per_block * occ),
            "occ": occ, "slots": n_pb * k, "gflop": per_block * n_pb * k
            / 1e9, "bytes": n_pb * k * bp * bs * 4 + rest}


def spmm_row(name, args, flush, library, library_name) -> dict:
    """bsr_spmm at one shape: against its plain version at f32 / bf16 /
    f16, two runs bit-equal, the f32 errors of kernel and plain version
    against float64, both bounds, the bf16 time; then the row that
    ``measure`` times (its bound the occupied blocks', as the table's)."""
    cols, blocks, x = args
    n_pb, k, bp, bs = blocks.shape
    bd = spmm_bounds(cols, blocks, x)
    say(f"[kernels] {name}: n_pb={n_pb} K={k} bp={bp} bs={bs} "
        f"x {tuple(x.shape)}; {bd['occ']} of {bd['slots']} stored blocks "
        f"occupied; stored {bd['gflop']:.2f} GFLOP, "
        f"{bd['bytes'] / 1e6:.2f} MB")
    err = check_precisions(
        name, lambda p: bsr_spmm(*args, precision=p),
        lambda p: bsr_spmm_ref(*args, precision=p))
    first = bsr_spmm(*args)
    check(torch.equal(first, bsr_spmm(*args)), f"{name}: two runs differ")
    exact = bsr_spmm_ref(cols, blocks.double(), x.double())
    err64, plain64 = ((t - exact).abs().max().item() for t in
                      (first.double(), bsr_spmm_ref(*args).double()))
    say(f"[kernels] {name}: two runs bit-equal; [f32] against float64: "
        f"kernel max|d|={err64:.3e}, plain max|d|={plain64:.3e} "
        f"(max|exact|={exact.abs().max().item():.3e})")
    del first, exact
    ms16 = time_ms(lambda: bsr_spmm(*args, precision="bf16"), 20, flush)
    say(f"[kernels] {name}[bf16]: kernel {ms16:.4f} ms")
    bounds = ", ".join(
        f"{kind} {bd[kind][0][0]:.4f} ms ({bd[kind][0][1]}; SIMT "
        f"{bd[kind][1][0]:.4f} ms, {bd[kind][1][1]})"
        for kind in ("stored", "occupied"))
    say(f"[kernels] {name} bounds, 3xTF32 route: {bounds}")
    return dict(
        err=err, kernel="bsr_spmm",
        fn=lambda: bsr_spmm(*args), plain=lambda: bsr_spmm_ref(*args),
        library=library, library_name=library_name,
        bound=bd["occupied"][0], simt_bound=bd["occupied"][1],
        source="src/repro_torch/kernels/csrc/bsr_spmm.cu",
        replaces="src/repro/kernels/bsr_spmm/kernel.py:51")


def sparse_rows(source, flush) -> dict:
    """bsr_beamform at the served shapes, and bsr_spmm at (a) one
    channel's real product and (b) the beamform's real form. The
    operations bound counts the occupied blocks: the padded K slots are
    zero and need no work (bsr_spmm's rows print the stored slots' bound
    beside it). For bsr_beamform also: the skip rule, the operator check
    on the device, two runs bit-equal, the f32 error of kernel and plain
    version against float64, and the bf16 time."""
    dev = torch.device("cuda")
    cfg = paper_config(variant="sparse")
    t0 = time.perf_counter()
    host = init_pipeline(cfg)
    say(f"[init] paper sparse constants in {time.perf_counter() - t0:.1f}s "
        f"(bsr_blocks {host['bsr_blocks'].shape}, "
        f"{host['bsr_blocks'].nbytes / 1e9:.3f} GB)")
    t0 = time.perf_counter()
    check_skipped_slots(host["bsr_col_idx"], host["bsr_blocks"])
    say(f"[init] the operator's skipped K slots hold only zeros: checked "
        f"on the host in {time.perf_counter() - t0:.3f}s")
    c = consts_from_numpy(host, dev)
    del host
    rf = torch.as_tensor(source.next()).to(dev)
    iq = demod.rf_to_iq(c, rf, cfg.decim)
    cols, blocks = c["bsr_col_idx"], c["bsr_blocks"]
    n_c, n_pb, k, bp, bs, _ = blocks.shape
    iq_b = block_sample_axis(iq, bs)
    b, n_sb, _, _, n_f, _ = iq_b.shape
    occupied = (blocks != 0).flatten(3).any(-1)          # (n_c, n_pb, K)
    n_occ = int(occupied.sum())
    gflop = 8.0 * b * bp * bs * n_f / 1e9          # per stored block
    say(f"[kernels] BSR operator: n_c={n_c} n_pb={n_pb} K={k} bp={bp} "
        f"bs={bs} n_sb={n_sb}; {n_occ} of {n_c * n_pb * k} stored blocks "
        f"occupied; all stored: {gflop * n_c * n_pb * k:.1f} GFLOP, "
        f"occupied: {gflop * n_occ:.1f} GFLOP")
    check_skip_rule(cols, occupied)
    t0 = time.perf_counter()
    require_checked(cols, blocks)
    torch.cuda.synchronize()
    say(f"[kernels] bsr_beamform operator check on the device (once per "
        f"operator): {1e3 * (time.perf_counter() - t0):.1f} ms")
    rows = {}

    bf_err = check_precisions(
        "bsr_beamform", lambda p: bsr_beamform(cols, blocks, iq_b,
                                               precision=p),
        lambda p: bsr_beamform_ref(cols, blocks, iq_b, precision=p))
    first = bsr_beamform(cols, blocks, iq_b)
    check(torch.equal(first, bsr_beamform(cols, blocks, iq_b)),
          "bsr_beamform: two runs differ")
    say("[kernels] bsr_beamform: two runs bit-equal")
    exact = bsr_beamform_ref(cols, blocks.double(), iq_b.double())
    plain = bsr_beamform_ref(cols, blocks, iq_b).double()
    err64, plain64 = ((t - exact).abs().max().item()
                      for t in (first.double(), plain))
    say(f"[kernels] bsr_beamform[f32] against float64: kernel "
        f"max|d|={err64:.3e}, plain max|d|={plain64:.3e} "
        f"(max|exact|={exact.abs().max().item():.3e})")
    del first, exact, plain
    shapes, back = spmm_shapes(cols, blocks, iq_b)
    # torch's BSR product over the real form: one row of (channel, slot)
    # blocks a pixel block, summing the channels
    cols_r, blocks_r, x_r = shapes["b"]
    a = sorted_bsr(cols_r, blocks_r, n_pb * 2 * bp, n_c * n_sb * 2 * bs)
    x = x_r.reshape(n_c * n_sb * 2 * bs, b * n_f)
    plain = bsr_beamform_ref(cols, blocks, iq_b)
    library = (lambda: a @ x)
    # the occupied blocks' work: the bound of the 3xTF32 route, and the
    # f32 FMA units' (SIMT) beside it
    bf_bytes = (n_occ * bp * bs * 8 + cols.numel() * 4 + iq_b.numel() * 4
                + b * n_pb * bp * n_f * 8)
    bf_flops = 8.0 * b * n_occ * bp * bs * n_f
    route, simt = split_tf32_bound(bf_bytes, bf_flops)
    ok = library_check(
        "bsr_beamform",
        lambda: back(library().view(n_pb, 2 * bp, b * n_f)), plain)
    library_name = ("torch.sparse_bsr_tensor @ dense, real "
                    "[[re, -im], [im, re]] blocks" if ok
                    else "none: torch's BSR product refused or disagreed")
    rows["bsr_beamform"] = dict(
        err=bf_err,
        fn=lambda: bsr_beamform(cols, blocks, iq_b),
        plain=lambda: bsr_beamform_ref(cols, blocks, iq_b),
        library=library if ok else None, library_name=library_name,
        bound=route, simt_bound=simt,
        source="src/repro_torch/kernels/csrc/bsr_spmm.cu",
        replaces="src/repro/kernels/bsr_spmm/kernel.py:51")
    del plain
    ms16 = time_ms(lambda: bsr_beamform(cols, blocks, iq_b,
                                        precision="bf16"), 20, flush)
    b16 = bound(bf_bytes, bf_flops, PEAK_BF16_FLOP_PER_S)
    say(f"[kernels] bsr_beamform[bf16]: kernel {ms16:.4f} ms, bound "
        f"{b16[0]:.4f} ms ({b16[1]}; bf16 tensor cores at 989 TFLOP/s)")

    # bsr_spmm (a): the real part of one (middle) channel's product
    cols1, blocks1, x1 = shapes["a"]
    a1 = sorted_bsr(cols1, blocks1, n_pb * bp, n_sb * bs)
    x1_flat = x1.reshape(n_sb * bs, b * n_f)
    library1 = (lambda: a1 @ x1_flat)
    ok1 = library_check("bsr_spmm",
                        lambda: library1().view(n_pb, bp, b * n_f),
                        bsr_spmm_ref(cols1, blocks1, x1))
    rows["bsr_spmm"] = spmm_row(
        "bsr_spmm", shapes["a"], flush, library1 if ok1 else None,
        "torch.sparse_bsr_tensor @ dense" if ok1
        else "none: torch's BSR product refused or disagreed")
    # bsr_spmm (b): the beamform's real form; its library call is the one
    # bsr_beamform's row times (the same product)
    rows["bsr_spmm (real form)"] = spmm_row(
        "bsr_spmm (real form)", shapes["b"], flush,
        library if ok else None, library_name)
    del shapes
    return measure(rows, flush)


def phase_kernels(source) -> dict:
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = dynamic_rows(source, flush)
    rows.update(sparse_rows(source, flush))
    del flush
    torch.cuda.empty_cache()
    say(f"[kernels] done; {torch.cuda.memory_allocated() / 1e6:.1f} MB "
        "still allocated before serving")
    return rows


def served_paths():
    """(modality, variant, fusion, fusion_block) of each served run: every
    path of PATHS for both modalities, then the fused power path once more
    with its pixel tile set."""
    for modality in ("bmode", "power_doppler"):
        for variant, fusion in PATHS:
            yield modality, variant, fusion, None
    yield "power_doppler", "dynamic", "fused", FUSION_BLOCK


def phase_serve(source) -> dict:
    launches = {name: 0 for name in kernels.launch_counts()}
    for modality, variant, fusion, block in served_paths():
        cfg = paper_config(variant=variant, modality=modality, fusion=fusion,
                           fusion_block=block)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        stats = serve_ultrasound_stream(
            cfg, batch=BATCH, n_batches=N_BATCHES, depth=2, pool=2,
            source=source)
        counts = path_counts()
        setup = time.perf_counter() - t0 - stats["wall_s"]
        plan = stats["plan"]
        lat = stats["latency"]
        peak = stats["resources"]["peak_memory_bytes"]
        say(f"[serve] {stats['name']} fusion={fusion}"
            + (f" fusion_block={block}" if block else "") + ": "
            f"{stats['sustained_mbps']:.1f} MB/s, {stats['fps']:.1f} "
            f"FPS, p50={lat.p50_s * 1e3:.3f} ms, "
            f"p99={lat.p99_s * 1e3:.3f} ms, peak_mem={peak / 1e6:.1f} MB,"
            f" lowerings={plan['stage_lowerings']}, launches={counts},"
            f" setup {setup:.1f}s (constants, upload, warm-up)")
        check(plan["backend"] == "cuda", f"plan backend {plan}")
        check(plan["fusion_block"] == block, f"plan fusion_block {plan}")
        want = "xla" if variant == "cnn" else "pallas"
        check(plan["stage_lowerings"]["beamform"] == want,
              f"beamform lowering {plan['stage_lowerings']}")
        key = {"dynamic": ("das_beamform" if fusion == "none"
                           else FUSED_KERNEL[modality]),
               "sparse": "bsr_beamform", "cnn": None}[variant]
        if key is None:
            check(set(counts.values()) == {0},
                  f"cnn launched a kernel: {counts}")
        else:
            check(counts[key] > 0,
                  f"{key} never launched in {stats['name']}")
        for name, n in counts.items():
            launches[name] += n
        split(cfg, source, stats)
    return launches


def h2d_ms(engine, host, n=5) -> tuple:
    """Device time of ``engine.place(host)``: CUDA events on the
    executor's copy stream around the copy, ``n`` copies after one
    untimed, with nothing else queued on the card; returns (mean ms, the
    last device batch)."""
    engine.place(host)
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record(engine.copy_stream)
        x = engine.place(host)
        e.record(engine.copy_stream)
        times.append((s, e))
    torch.cuda.synchronize()
    return float(np.mean([s.elapsed_time(e) for s, e in times])), x


def split(cfg, source, stats) -> None:
    """Where one batch's time goes: the host->device copy of the pinned
    RF batch on the executor's copy stream, then each schedulable unit of
    the engine on a device-resident batch, and the whole engine (CUDA
    events)."""
    engine = BatchedExecutor(cfg)
    host = source.next()
    check(torch.from_numpy(host).is_pinned(), "the source is not pinned")
    h2d, x = h2d_ms(engine, host)
    fns = stage_fns(engine.cfg, "cuda")
    engine(x)
    events = {name: [] for name in fns}
    for _ in range(5):
        y = x
        for name, fn in fns.items():
            s, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            s.record()
            y = fn(engine.consts, y)
            e.record()
            events[name].append((s, e))
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    s.record()
    for _ in range(5):
        engine(x)
    e.record()
    torch.cuda.synchronize()
    stages = ", ".join(
        f"{name} {np.mean([a.elapsed_time(z) for a, z in ev]):.3f} ms"
        for name, ev in events.items())
    say(f"[split] {stats['name']} fusion={cfg.fusion}: per batch of "
        f"{BATCH}: h2d {h2d:.3f} ms (pinned, copy stream, CUDA events; "
        f"{BATCH * cfg.input_bytes / h2d / 1e6:.1f} GB/s), engine on device "
        f"{s.elapsed_time(e) / 5:.3f} ms ({stages}), served "
        f"{stats['wall_s'] / N_BATCHES * 1e3:.3f} ms")


def phase_outputs(source) -> None:
    dev = torch.device("cuda")
    rf = source.next()
    for modality, variant, fusion, block in served_paths():
        cfg = paper_config(variant=variant, modality=modality, fusion=fusion,
                           fusion_block=block)
        engine = BatchedExecutor(cfg)
        out = engine(rf)
        ref = monolithic_pipeline_fn(engine.cfg)(
            engine.consts, torch.as_tensor(rf).to(dev))
        shape = (BATCH, cfg.nz, cfg.nx) + (
            (cfg.n_f,) if modality == "bmode" else ())
        check(tuple(out.shape) == shape, f"image shape {out.shape}")
        check(bool(torch.isfinite(out).all()), "non-finite image")
        check(out.min().item() >= 0.0 and out.max().item() <= 1.0,
              "image outside [0, 1]")
        d = (out - ref).abs()
        frac = (d > 1e-5).float().mean().item()
        what = f"{modality}/{variant}/{fusion}" + (f"/bp{block}" if block
                                                   else "")
        say(f"[outputs] paper {what} vs plain on card: "
            f"max|d|={d.max().item():.3e} (tol "
            f"{IMAGE_TOL[modality]:.1e}), >1e-5: {frac:.5f}")
        check(d.max().item() <= IMAGE_TOL[modality],
              f"{what} image disagrees with plain")
        del engine, out, ref, d
        small = tiny_config(variant=variant, modality=modality,
                            fusion=fusion, fusion_block=block, n_c=16,
                            n_f=8, nz=32, nx=32)
        x = np.stack([synth_rf(small, seed=s) for s in (1, 2)])
        got = BatchedExecutor(small)(x).cpu()
        want = BatchedExecutor(small, device="cpu")(x)
        err = (got - want).abs().max().item()
        say(f"[outputs] small {what} card vs cpu: max|d|={err:.3e}")
        check(err <= IMAGE_TOL[modality], "card disagrees with cpu")


def mt_frames(streams, modality, n=BATCH) -> list:
    """``n`` frames of the tenants of ``modality``, cycling their pools."""
    specs = [s for s in streams if s.cfg.modality.value == modality]
    return [specs[i % len(specs)].frame_rf(i // len(specs))
            for i in range(n)]


def mt_pool(streams, plan_policy="heuristic") -> tuple:
    """The warm pool of the tenants' groups: capture and warm-up times,
    replay against the eager engine on the same staged batch (bit for
    bit), and per group the replay's and the pinned H2D's device times.
    Returns (pool, mean of max(replay, H2D) ms over the groups)."""
    pool = warm_pool(streams, max_batch=MT_POLICY.max_batch,
                     plan_policy=plan_policy)
    check(len(pool) == 2, f"{len(pool)} groups, want 2")
    service = []
    for key in pool.keys():
        entry = pool.get(key)
        eng, prog = entry.engine, entry.program
        what = eng.cfg.modality.value
        check(eng.plan.backend == "cuda" and prog.compile_s > 0
              and (prog.launches or eng.cfg.variant.value == "cnn"),
              f"{what}: no graph captured ({prog})")
        ring = StagingRing(MT_POLICY.max_batch, eng.cfg.rf_shape,
                           eng.cfg.rf_dtype, depth=1, pin_memory=True)
        buf, _ = ring.stage(mt_frames(streams, what))
        staged = eng.place(buf)
        replay = eng.dispatch_staged(staged, MT_POLICY.max_batch)
        eager = eng.run(staged)
        check(torch.equal(replay, eager),
              f"{what}: graph replay differs from the eager engine")
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        for _ in range(20):
            eng.dispatch_staged(staged, MT_POLICY.max_batch)
        e.record()
        torch.cuda.synchronize()
        replay_ms = s.elapsed_time(e) / 20
        copy_ms, _ = h2d_ms(eng, buf, n=10)
        service.append(max(replay_ms, copy_ms))
        say(f"[multitenant] group {what} ({key[0]}): plan "
            f"{eng.plan.variant.value} {dict(eng.plan.stage_lowerings)}; "
            f"CUDA graph captured in compile_s={prog.compile_s:.4f}s, "
            f"warmup_s={prog.warmup_s:.4f}s (warm-up run, capture, one "
            f"replay); one replay runs {prog.launches}; replay == eager "
            f"on the same staged batch: bit-equal; replay "
            f"{replay_ms:.4f} ms, pinned H2D {copy_ms:.4f} ms a batch of "
            f"{MT_POLICY.max_batch} ({MT_POLICY.max_batch * eng.cfg.input_bytes / copy_ms / 1e6:.1f} GB/s; CUDA events)")
        del replay, eager, staged
    return pool, float(np.mean(service))


def group_kernel(plan: dict):
    """The kernel one replay of a served group's engine must launch (None:
    the cnn engine launches no kernel of ours)."""
    if plan["variant"] == "cnn":
        return None
    if plan["fusion"] == "fused":
        return FUSED_KERNEL[plan["fusion_group"].rsplit("+", 1)[1]]
    return {"dynamic": "das_beamform",
            "sparse": "bsr_beamform"}[plan["variant"]]


def mt_window(label, streams, pool, drain, profile,
              plan_policy="heuristic") -> dict:
    """One serving window, counts zeroed before and read after; prints
    its numbers and checks its bounds, energy and sampled frames."""
    kernels.reset_launch_counts()
    st = serve_multitenant(streams, policy=MT_POLICY, in_flight=MT_IN_FLIGHT,
                           drain=drain, pool=pool, plan_policy=plan_policy,
                           collect_outputs=True, load_profile=profile)
    counts = path_counts()
    lat, qd = st["latency"], st["queue_delay"]
    occ, ifo, res = st["occupancy"], st["in_flight_occupancy"], \
        st["resources"]
    say(f"[multitenant] {label} ({st['name']}): {st['acquisitions']} "
        f"acquisitions ({st['frames']} frames) in {st['wall_s']:.4f}s = "
        f"{st['sustained_mbps']:.1f} MB/s, {st['fps']:.1f} FPS; queue "
        f"delay p50 {qd['p50_s'] * 1e3:.3f} ms p99 "
        f"{qd['p99_s'] * 1e3:.3f} ms; latency p50 {lat['p50_s'] * 1e3:.3f}"
        f" ms p99 {lat['p99_s'] * 1e3:.3f} ms; occupancy mean "
        f"{occ['mean_occupancy']:.2f} max {occ['max_occupancy']} of "
        f"{occ['max_batch']} ({occ['batches']} batches); in flight mean "
        f"{ifo['mean_depth']:.2f} max {ifo['max_depth']}; device_busy_frac "
        f"{st['device_busy_frac']:.4f}, overlap_frac "
        f"{st['overlap_frac']:.4f}; stage_copy_s {st['stage_copy_s']:.4f},"
        f" h2d_s {st['h2d_s']:.4f}, d2h_s {st['d2h_s']:.4f}, "
        f"transfer_frac {st['transfer_frac']:.4f}; peak_mem "
        f"{res['peak_memory_bytes'] / 1e6:.1f} MB "
        f"({res['memory_source']}); energy {res['energy_joules']} J above "
        f"idle {res['idle_power_w']} W over {res['duration_s']:.3f}s, "
        f"{res['energy_samples']} NVML samples (board counter "
        f"{res['energy_counter_joules']} J, absolute); launches={counts}")
    check(occ["max_occupancy"] <= MT_POLICY.max_batch,
          f"{label}: occupancy past max_batch")
    check(ifo["max_depth"] <= MT_IN_FLIGHT, f"{label}: ring past in_flight")
    check(res["energy_joules"] is not None, f"{label}: energy not measured")
    want = {name: 0 for name in counts}
    for g in st["groups"].values():
        name = group_kernel(g["plan"])
        if name is not None:
            want[name] += g["batches"]
    check(counts == want and set(kernels.launch_counts().values()) == {0},
          f"{label}: not one graph replay of each group's kernel a batch: "
          f"{counts}, want {want}")
    dev = torch.device("cuda")
    entries = {pool.get(k).engine.cfg.modality: pool.get(k).engine
               for k in pool.keys()
               if k[0] in st["groups"]}
    worst = {}
    for spec in streams:
        eng = entries[spec.cfg.modality]
        outs = st["outputs"][spec.stream_id]
        what = spec.cfg.modality.value
        for k in sorted({k % len(outs) for k in MT_SAMPLE}):
            rf = spec.frame_rf(k)
            padded, _ = _pad_rows(rf[None], MT_POLICY.max_batch)
            x = torch.as_tensor(padded).to(dev)
            alone = eng.run(x)[0].cpu().numpy()
            check(np.array_equal(outs[k], alone),
                  f"{label}: {spec.stream_id}[{k}] differs from the lone "
                  "frame through the engine")
            plain = monolithic_pipeline_fn(eng.cfg)(eng.consts, x[:1])[0]
            d = float(np.abs(outs[k] - plain.cpu().numpy()).max())
            check(d <= IMAGE_TOL[what], f"{label}: {spec.stream_id}[{k}] "
                  f"{d:.3e} from the plain pipeline")
            worst[what] = max(worst.get(what, 0.0), d)
    variants = {g["plan"]["variant"] for g in st["groups"].values()}
    say(f"[multitenant] {label}: sampled frames {MT_SAMPLE} of each stream "
        f"({'/'.join(sorted(variants))} engines) "
        "equal the lone frame through the engine bit for bit; max|d| "
        "against the plain monolithic pipeline "
        + ", ".join(f"{m} {d:.3e} (tol {IMAGE_TOL[m]:.0e})"
                    for m, d in worst.items()))
    del st
    return counts


def phase_multitenant() -> dict:
    """Multi-tenant serving at the paper's geometry: B-mode and colour
    Doppler tenants, heuristic plan, through a warm pool of CUDA graphs."""
    cfg_b = paper_config(variant="auto")
    cfg_d = cfg_b.with_(modality=Modality.DOPPLER)

    def mixed(base_fps, n_frames):
        return make_mixed_streams(MT_CLIENTS, cfg_b, cfg_d,
                                  base_fps=base_fps, n_frames=n_frames,
                                  deadline_ms=None)

    streams = mixed(MT_BASE_FPS, MT_FRAMES)
    t0 = time.perf_counter()
    n = sum(len({s.frame_rf(k).ctypes.data for k in range(s.n_frames)})
            for s in streams)
    say(f"[multitenant] {n} distinct paper-geometry frames of "
        f"{MT_CLIENTS} tenants synthesized in {time.perf_counter() - t0:.1f}s"
        " (shared by every window)")
    pool, service_ms = mt_pool(streams)
    # offered load MT_OVERLOAD times what the card serves: batches of
    # max_batch, each taking the larger of its replay and its copy
    capacity = MT_POLICY.max_batch / service_ms * 1e3
    rate_sum = sum(mixed_rate(i, 1.0) for i in range(MT_CLIENTS))
    over_fps = MT_OVERLOAD * capacity / rate_sum
    say(f"[multitenant] measured service: {service_ms:.4f} ms a batch of "
        f"{MT_POLICY.max_batch} = {capacity:.0f} acquisitions/s; the "
        f"overload window's base rate {over_fps:.1f} fps offers "
        f"{MT_OVERLOAD:g}x that")
    n_energy = int(MT_ENERGY_S * mixed_rate(MT_CLIENTS - 1, MT_BASE_FPS)) + 1
    burst = generate_trace("burst", n_streams=MT_CLIENTS, n_frames=MT_FRAMES,
                           base_fps=MT_BASE_FPS)
    windows = (
        ("default", streams, "async", "steady"),
        ("default", streams, "block", "steady"),
        ("overload", mixed(over_fps, 4 * MT_FRAMES), "async", "overload"),
        ("burst trace", make_trace_streams(burst, cfg_b, cfg_d,
                                           deadline_ms=None),
         "async", "burst"),
        (f"energy ({n_energy} frames a client)",
         mixed(MT_BASE_FPS, n_energy), "async", "steady"),
    )
    launches = {name: 0 for name in kernels.launch_counts()}
    for label, ws, drain, profile in windows:
        for name, k in mt_window(label, ws, pool, drain, profile).items():
            launches[name] += k
    del pool
    torch.cuda.empty_cache()
    # the scheduler's oracle through the cnn and sparse engines: B-mode
    # tenants pinned to cnn, colour-Doppler tenants to sparse, one CUDA
    # graph a group, one short window at the default rates
    op_streams = make_mixed_streams(
        MT_CLIENTS, cfg_b.with_(variant="cnn"), cfg_d.with_(variant="sparse"),
        base_fps=MT_BASE_FPS, n_frames=MT_FRAMES, deadline_ms=None)
    pool, _ = mt_pool(op_streams)
    for name, k in mt_window("cnn + sparse", op_streams, pool, "async",
                             "steady").items():
        launches[name] += k
    del pool
    torch.cuda.empty_cache()
    return launches


def fail_probe(*args, **kwargs):
    raise AssertionError("probe called: the autotune memo missed")


def kernel_stages_on_xla(cfg, plan) -> list:
    """Stages of ``plan`` that resolved to the plain version though their
    op has a kernel lowering on the card."""
    c = plan.concretize(cfg)
    return [stage for stage, name in plan.stage_lowerings
            if name == "xla" and set(lowering.available_lowerings(
                c, stage, "cuda")) - {"xla"}]


def plan_autotune() -> None:
    """`plan_pipeline(policy="autotune", backend="cuda")` at the paper's
    geometry, B-mode and power Doppler, unfused and fused: each variant's
    time and the fused probes' pixel tiles (each a served dispatch of
    MT_POLICY.max_batch rows, CUDA graph replays between CUDA events),
    the pick and its provenance; the pick is its own argmin, no
    kernel-bearing stage is plain, a second call hits the memo, and the
    probes leave nothing allocated."""
    dev = torch.device("cuda")
    # cuBLAS keeps a 32 MiB workspace per stream once it has run (the cnn
    # probe's products); make it before reading the baseline
    torch.ones(8, 8, device=dev) @ torch.ones(8, 8, device=dev)
    torch.cuda.synchronize()
    before = (torch.cuda.memory_allocated(dev),
              torch.cuda.memory_reserved(dev))
    for modality in ("bmode", "power_doppler"):
        for fusion in ("none", "fused"):
            cfg = paper_config(variant="auto", modality=modality,
                               fusion=fusion)
            t0 = time.perf_counter()
            plan = plan_pipeline(cfg, policy="autotune", backend="cuda",
                                 autotune_batch=MT_POLICY.max_batch)
            took = time.perf_counter() - t0
            t = dict(plan.autotune_t_s)
            bp = {k.rsplit("@bp", 1)[1]: v
                  for k, v in dict(plan.lowering_t_s or {}).items()
                  if "@bp" in k}
            say(f"[plan] autotune {modality}/{fusion} in {took:.1f}s, a "
                f"served batch of {MT_POLICY.max_batch} (graph replay): "
                + ", ".join(f"{v} {ms * 1e3:.4f} ms" for v, ms in t.items())
                + (" | fused bp " + ", ".join(
                    f"{b} {ms * 1e3:.4f} ms" for b, ms in bp.items())
                   if bp else "")
                + f" -> {plan.variant.value}"
                + (f" bp {plan.fusion_block}" if fusion == "fused" else "")
                + f", lowerings {dict(plan.stage_lowerings)} "
                f"({plan.provenance})")
            check(plan.variant.value == min(t, key=t.get),
                  f"autotune pick {plan.variant.value} is not the argmin "
                  f"of {t}")
            if fusion == "fused":
                check(len(bp) == 3 and str(plan.fusion_block)
                      == min(bp, key=bp.get),
                      f"fused pick bp {plan.fusion_block} of {bp}")
            plain = kernel_stages_on_xla(cfg, plan)
            check(not plain, f"kernel stages resolved to xla: {plain}")
            again = plan_pipeline(cfg, policy="autotune", backend="cuda",
                                  autotune_batch=MT_POLICY.max_batch,
                                  measure=fail_probe,
                                  measure_stage=fail_probe)
            check(again == plan, "the memoized plan differs")
    torch.cuda.synchronize()
    after = (torch.cuda.memory_allocated(dev),
             torch.cuda.memory_reserved(dev))
    say(f"[plan] device memory allocated / reserved before planning "
        f"{before[0] / 1e6:.3f} / {before[1] / 1e6:.3f} MB, after "
        f"{after[0] / 1e6:.3f} / {after[1] / 1e6:.3f} MB; second calls hit "
        "the memo (no probe ran)")
    # the smallest probe's constants (dynamic) are 20 MB
    check(after[0] - before[0] < 1e6,
          "the probes left device memory allocated")


def disk_tier() -> None:
    """The constants' disk tier in a fresh directory: the dynamic
    constants at the paper's geometry built, the memory tier cleared,
    built again from disk, bit-equal; the cnn and sparse operators are
    past the per-file cap and not stored."""
    import shutil

    from repro_torch.core import pipeline as tpipe

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"consts_smoke_{os.getpid()}")
    shutil.rmtree(root, ignore_errors=True)
    prev = consts_cache_dir()
    set_consts_cache_dir(root)
    try:
        clear_consts_cache()
        CONSTS_CACHE_STATS.reset()
        cfg = paper_config(variant="dynamic")
        t0 = time.perf_counter()
        first = init_pipeline(cfg)
        t_build = time.perf_counter() - t0
        clear_consts_cache()
        t0 = time.perf_counter()
        second = init_pipeline(cfg)
        t_disk = time.perf_counter() - t0
        files = os.listdir(root)
        size = sum(os.path.getsize(os.path.join(root, f)) for f in files)
        check(CONSTS_CACHE_STATS.misses == 1
              and CONSTS_CACHE_STATS.disk_hits == 1,
              f"disk tier: {CONSTS_CACHE_STATS}")
        check(sorted(first) == sorted(second) and all(
            first[k].dtype == second[k].dtype
            and first[k].tobytes() == second[k].tobytes() for k in first),
            "constants read from disk differ from those built")
        say(f"[consts] dynamic paper constants: built in {t_build:.3f}s, "
            f"read back from the disk tier in {t_disk:.3f}s, bit-equal "
            f"({files}, {size / 1e6:.1f} MB; {CONSTS_CACHE_STATS})")
        for variant in ("cnn", "sparse"):
            nbytes = tpipe._consts_nbytes(
                init_pipeline(paper_config(variant=variant)))
            check(nbytes > tpipe.DISK_CACHE_MAX_BYTES
                  and len(os.listdir(root)) == 1,
                  f"{variant} constants written to the disk tier")
            say(f"[consts] {variant} paper constants {nbytes / 1e9:.3f} GB "
                f"> the {tpipe.DISK_CACHE_MAX_BYTES / 2 ** 20:.0f} MiB "
                "per-file cap: not stored (rebuilt by every engine)")
    finally:
        set_consts_cache_dir(prev)
        shutil.rmtree(root, ignore_errors=True)


def sharded(source) -> dict:
    """`serve_ultrasound_sharded` on the one card, counts zeroed just
    before and read just after (the main path: das_beamform and nothing
    else), then `ShardedExecutor` over [cuda:0, cuda:0] on an uneven
    batch of 5 against `BatchedExecutor`, bit for bit. Returns the
    sharded stream's counts."""
    cfg = paper_config(variant="dynamic")
    base = serve_ultrasound_stream(cfg, batch=BATCH, n_batches=N_BATCHES,
                                   depth=2, source=source)
    kernels.reset_launch_counts()
    st = serve_ultrasound_sharded(cfg, batch_per_device=BATCH,
                                  n_batches=N_BATCHES, depth=2,
                                  devices=["cuda:0"], source=source,
                                  baseline_fps=base["fps"])
    counts = path_counts()
    lat = st["latency"]
    per_dev = ", ".join(f"{d} p50 {v['p50_s'] * 1e3:.3f} ms p99 "
                        f"{v['p99_s'] * 1e3:.3f} ms"
                        for d, v in st["per_device_latency"].items())
    say(f"[sharded] {st['name']}: {st['sustained_mbps']:.1f} MB/s, "
        f"{st['fps']:.1f} FPS, p50={lat.p50_s * 1e3:.3f} ms, "
        f"p99={lat.p99_s * 1e3:.3f} ms; per device: {per_dev}; baseline "
        f"(serve_ultrasound_stream, same source) {st['baseline_fps']:.1f} "
        f"FPS, speedup_vs_single {st['speedup_vs_single']:.4f}, "
        f"scale_efficiency {st['scale_efficiency']:.4f}; plan devices "
        f"{st['plan']['devices']} mesh {st['plan']['mesh_shape']}; "
        f"launches={counts}")
    check(st["plan"]["devices"] == 1 and st["devices"] == 1,
          f"sharded plan on one card: {st['plan']}")
    check(counts["das_beamform"] > 0
          and all(n == 0 for k, n in counts.items() if k != "das_beamform"),
          f"sharded dynamic stream launched {counts}")
    rf = np.concatenate([source.next(), source.next()])[:5]
    for variant, fusion in PATHS:
        c = paper_config(variant=variant, fusion=fusion)
        eng = ShardedExecutor(c, devices=["cuda:0", "cuda:0"])
        got = eng(rf)
        want = BatchedExecutor(c)(rf)
        check(eng.plan.devices == 2 and tuple(got.shape) == tuple(
            want.shape), f"sharded {variant}/{fusion}: {got.shape}")
        same = torch.equal(got, want)
        say(f"[sharded] ShardedExecutor over [cuda:0, cuda:0], batch 5 "
            f"(shards of 3, padded to 6), {variant}/{fusion}: "
            + ("bit-equal to BatchedExecutor" if same else
               f"max|d| {(got - want).abs().max().item():.3e} from "
               "BatchedExecutor"))
        check(same, f"sharded {variant}/{fusion} differs from batched")
        del eng, got, want
        torch.cuda.empty_cache()
    return counts


def phase_plan_shards(source) -> dict:
    """Plan and shards: autotune at the paper's geometry, the disk tier,
    sharded serving on the card, and one multitenant window of AUTO
    tenants planned by autotune. The launches returned are those of the
    two served paths, the sharded stream and the autotuned window, each
    counted from zero; the planner's probes and the comparison calls
    are left out."""
    plan_autotune()
    disk_tier()
    launches = sharded(source)
    cfg_b = paper_config(variant="auto")
    streams = make_mixed_streams(
        MT_CLIENTS, cfg_b, cfg_b.with_(modality=Modality.DOPPLER),
        base_fps=MT_BASE_FPS, n_frames=MT_FRAMES, deadline_ms=None)
    pool, _ = mt_pool(streams, plan_policy="autotune")
    for name, k in mt_window("autotuned tenants", streams, pool, "async",
                             "steady", plan_policy="autotune").items():
        launches[name] += k
    del pool
    torch.cuda.empty_cache()
    return launches


def close_enough(name, out, ref, rtol, atol) -> float:
    """Fail unless |out - ref| <= atol + rtol |ref| everywhere; returns
    max|out - ref|."""
    err, scale = max_err(out, ref)
    ok = bool(((out - ref).abs() <= atol + rtol * ref.abs()).all())
    say(f"[lm] {name}: max|d|={err:.3e} (max|ref|={scale:.3e}, tolerance "
        f"{atol:g} + {rtol:g}|ref|)")
    check(ok, f"{name} outside its tolerance")
    return err


def ssd_dims(cfg) -> tuple:
    """(H, P, N, chunk) of a Mamba2 config's SSD scan."""
    return (cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim,
            cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_chunk)


def lm_kernel_inputs(flash_shape=None, ssd_shape=None) -> tuple:
    """f32 inputs from seed 0: q, k, v of flash shape (B, L, H, Hkv, d)
    and (log_a, x, b, c) of SSD shape (B, L, H, P, N), and zamba2's SSD
    chunk. The defaults are zamba2's served prefill and its scoring
    forward."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    cfg = get_config(ARCH)
    heads, p, n, chunk = ssd_dims(cfg)
    b, l, h, hkv, d = flash_shape or (LM_BATCH, PROMPT_LEN, cfg.n_heads,
                                      cfg.n_kv_heads, cfg.head_dim)
    bsz, length, heads, p, n = ssd_shape or SCORE_SHAPE + (heads, p, n)
    qkv = tuple(torch.randn(b, l, hh, d, generator=g, device=dev)
                for hh in (h, hkv, hkv))
    log_a = -torch.rand(bsz, length, heads, generator=g, device=dev) * 0.3
    x = torch.randn(bsz, length, heads, p, generator=g, device=dev)
    bm, cm = (torch.randn(bsz, length, n, generator=g, device=dev) * 0.3
              for _ in range(2))
    return qkv, (log_a, x, bm, cm), chunk


def flash_row(q, k, v) -> dict:
    """flash_attention (causal) against its plain version, and its row:
    the 3xTF32 route's bound, the SIMT bound beside it, SDPA where it
    agrees with the plain version."""
    b, l, h, d = q.shape
    err = close_enough(f"flash_attention vs plain at {tuple(q.shape)}, "
                       f"Hkv {k.shape[2]}", flash_attention(q, k, v),
                       flash_attention_ref(q, k, v), *FLASH_TOL)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library = (lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    ok = library_check("flash_attention", lambda: library().transpose(1, 2),
                       flash_attention_ref(q, k, v))
    route, simt = split_tf32_bound(
        4.0 * (2 * q.numel() + k.numel() + v.numel()),
        4.0 * b * h * d * l * (l + 1) / 2)
    return dict(
        err=err,
        fn=lambda: flash_attention(q, k, v),
        plain=lambda: flash_attention_ref(q, k, v),
        library=library if ok else None,
        library_name=("F.scaled_dot_product_attention(is_causal=True), "
                      "f32, (B, H, L, d)" if ok else
                      "none: SDPA disagreed with the plain version"),
        bound=route, simt_bound=simt,
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:77")


def ssd_row(log_a, x, bm, cm, chunk) -> dict:
    """ssd_scan against its plain version, and its row (3xTF32 route's
    bound, SIMT bound beside it; no single PyTorch call computes it)."""
    args = (log_a, x, bm, cm)
    bsz, length, heads, p = x.shape
    n = bm.shape[-1]
    err = close_enough(f"ssd_scan vs plain at {tuple(x.shape)}, N {n}, "
                       f"chunk {chunk}", ssd_scan(*args, chunk=chunk),
                       ssd_scan_ref(*args), *SSD_TOL)
    nc = -(-length // chunk)
    # C B^T once per (batch, chunk) (B and C are group-shared), the lower
    # triangles of C B^T and of M x, and the two state products per head
    route, simt = split_tf32_bound(
        4.0 * (log_a.numel() + 2 * x.numel() + bm.numel() + cm.numel()),
        1.0 * bsz * nc * (chunk * (chunk + 1) * n
                          + heads * (chunk * (chunk + 1) * p
                                     + 4 * chunk * n * p)))
    return dict(
        err=err,
        fn=lambda: ssd_scan(*args, chunk=chunk),
        plain=lambda: ssd_scan_ref(*args),
        library=None,
        library_name="none: no single PyTorch call computes the SSD scan",
        bound=route, simt_bound=simt,
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:71")


def phase_lm_kernels() -> dict:
    """flash_attention and ssd_scan, f32, against their plain versions,
    then timed: at zamba2's served prefill and scoring shapes (the rows of
    the kernels line), and at the new models' shapes (`[lm]` lines):
    flash at seamless-m4t's decoder self-attention, SSD at mamba2-130m's
    scoring forward (N 128, chunk 64). Both run their products as 3xTF32
    on the tensor cores: the bound is that route's (three TF32 products
    per f32 one at 495 TFLOP/s), the f32 FMA units' (SIMT) beside it."""
    dev = torch.device("cuda")
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=dev)
    (q, k, v), args, chunk = lm_kernel_inputs()
    say(f"[lm] shapes: flash (B, L, H, d) {tuple(q.shape)} causal; ssd "
        f"(B, L, H, P) {tuple(args[1].shape)}, N {args[2].shape[-1]}, Q "
        f"{chunk}, B and C group-shared")
    rows = measure({"flash_attention": flash_row(q, k, v),
                    "ssd_scan": ssd_row(*args, chunk)}, flush)
    del q, k, v, args

    seamless = get_config("seamless-m4t-large-v2")
    mamba = get_config("mamba2-130m")
    flash_shape = SCORE_SHAPE + (seamless.n_heads, seamless.n_kv_heads,
                                 seamless.head_dim)
    heads, p, n, chunk = ssd_dims(mamba)
    (q, k, v), args, _ = lm_kernel_inputs(flash_shape,
                                          SCORE_SHAPE + (heads, p, n))
    new = {f"flash_attention at {seamless.name}'s decoder {flash_shape}":
           flash_row(q, k, v),
           f"ssd_scan at {mamba.name}'s scoring {tuple(args[1].shape)} N "
           f"{n} chunk {chunk}": ssd_row(*args, chunk)}
    for name, row in measure(new, flush, tag="[lm]").items():
        t_bytes, t_ops = row["bound"], row["simt_bound"]
        say(f"[lm] {name}: bound {t_bytes[0]:.4f} ms by {t_bytes[1]} "
            f"(3xTF32), SIMT {t_ops[0]:.4f} ms by {t_ops[1]}; kernel / "
            f"bound {row['ms'] / t_bytes[0]:.2f}")
    del flush, q, k, v, args
    torch.cuda.empty_cache()
    return rows


def lm_config(arch, **overrides) -> tuple:
    """(the full config with ``overrides`` and, unless they set a depth,
    its LM_DEPTH cut; the name to print, which states any cut)."""
    cfg = get_config(arch, **overrides)
    if "n_layers" not in overrides and arch in LM_DEPTH:
        cfg = cfg.with_(n_layers=LM_DEPTH[arch])
    full = get_config(arch).n_layers
    if cfg.n_layers == full:
        return cfg, arch
    return cfg, f"{arch} (depth {cfg.n_layers} of {full}, full width)"


def lm_model(arch) -> dict:
    """One model at full width and depth in bf16, random weights from
    seed 0: serve_session with its serving flags, then scoring (loss_fn,
    then forward by CUDA events) at SCORE_SHAPE with its scoring flags,
    each from zeroed launch counters, checked against LM_MODELS; then
    `[lm split]` of a prefill, a decode step and the scoring forward.
    Returns the launches of both runs."""
    dev = torch.device("cuda")
    serve_flags, score_flags, serve_want, score_want = LM_MODELS[arch]
    cfg, name = lm_config(arch, **serve_flags)
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    say(f"[lm] {name} ({cfg.family}): {cfg.n_layers} layers"
        + (f" + {cfg.n_enc_layers} encoder layers" if cfg.n_enc_layers
           else "")
        + f", d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
        f"{n_params / 1e9:.3f} B parameters in {cfg.param_dtype}, random "
        f"from seed 0, made on the card in {time.perf_counter() - t0:.1f}s")

    def launched(what, want) -> dict:
        counts = kernels.launch_counts()
        want = {k: want.get(k, 0) for k in ("flash_attention", "ssd_scan")}
        check({k: counts[k] for k in want} == want,
              f"{arch} {what} launched {counts}, want {want}")
        return counts

    kernels.reset_launch_counts()
    out, stats = serve_session(cfg, requests=LM_REQUESTS, batch=LM_BATCH,
                               prompt_len=PROMPT_LEN, max_new=MAX_NEW,
                               params=params)
    counts = launched("serving", serve_want)
    pre = np.array(stats["prefill_s"]) * 1e3
    dec = np.array(stats["decode_s"]) * 1e3
    say(f"[lm] serve {name} bf16 {serve_flags}: {LM_REQUESTS} requests, "
        f"slot batch {LM_BATCH}, prompt {PROMPT_LEN}, {MAX_NEW} new "
        f"tokens: {stats['tokens']} tokens in {stats['wall_s']:.3f}s = "
        f"{stats['tok_per_s']:.1f} tok/s; prefill per slot batch "
        f"{', '.join(f'{t:.3f}' for t in pre)} ms; decode per step mean "
        f"{dec.mean():.3f} ms, p50 {np.median(dec):.3f} ms, max "
        f"{dec.max():.3f} ms; peak_mem="
        f"{stats['peak_memory_bytes'] / 1e6:.1f} MB; launches={counts}")
    check(out.shape == (LM_REQUESTS, MAX_NEW + 1), f"tokens {out.shape}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "generated tokens outside the vocabulary")

    prompt = synth_train_batch(cfg, LM_BATCH, PROMPT_LEN, seed=0,
                               device=dev)
    with torch.no_grad():
        device_split(f"{name} prefill",
                     lambda: model.prefill(params, prompt))
        _, cache = model.prefill(params, prompt)
        if cfg.family == "audio":       # the prefill consumed BOS
            lengths = torch.ones((LM_BATCH,), dtype=torch.int32, device=dev)
        else:
            cache = _grow_cache(model, cache, PROMPT_LEN + MAX_NEW + 1)
            lengths = torch.full((LM_BATCH,), PROMPT_LEN,
                                 dtype=torch.int32, device=dev)
        tok = prompt["tokens"][:, -1:]
        device_split(f"{name} decode step", lambda: model.decode_step(
            params, tok, cache, lengths))
    del cache, prompt

    model = get_model(lm_config(arch, **score_flags)[0])
    batch = synth_train_batch(cfg, *SCORE_SHAPE, seed=1, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        loss, _ = model.loss_fn(params, batch)
    loss = loss.item()
    wall = time.perf_counter() - t0
    score_counts = launched("scoring", score_want)
    peak = torch.cuda.max_memory_allocated()
    s, e = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    with torch.no_grad():
        s.record()
        h, _ = model.forward(params, batch)
        e.record()
    torch.cuda.synchronize()
    toks = SCORE_SHAPE[0] * SCORE_SHAPE[1]
    say(f"[lm] score {name} bf16 {score_flags}: loss_fn at {SCORE_SHAPE}: "
        f"loss {loss:.4f} (ln V = {np.log(cfg.vocab_size):.4f}), first "
        f"call {wall * 1e3:.1f} ms, forward {s.elapsed_time(e):.3f} ms "
        f"(CUDA events) = {toks / s.elapsed_time(e) * 1e3:.0f} tok/s; "
        f"peak_mem={peak / 1e6:.1f} MB (f32 logits alone "
        f"{toks * cfg.vocab_size * 4 / 1e6:.1f} MB); "
        f"launches={score_counts}")
    check(np.isfinite(loss), f"{arch}: non-finite loss")
    check(tuple(h.shape) == SCORE_SHAPE + (cfg.d_model,)
          and bool(torch.isfinite(h).all()), f"{arch}: forward hidden")
    del h
    with torch.no_grad():
        device_split(f"{name} scoring forward {score_flags}",
                     lambda: model.forward(params, batch))
    del params, batch
    torch.cuda.empty_cache()
    return {k: counts[k] + score_counts[k]
            for k in ("flash_attention", "ssd_scan")}


def phase_lm_models() -> dict:
    """Phase 7: each model of LM_MODELS; their launches, summed for the
    kernels line."""
    launches = {"flash_attention": 0, "ssd_scan": 0}
    for arch in LM_MODELS:
        for name, n in lm_model(arch).items():
            launches[name] += n
    return launches


def phase_moe_variants() -> None:
    """Phase 7b: the paper's three dispatch formulations at LM scale.
    MOE_ARCH at full width and depth in bf16, random weights from seed 0:
    its scoring forward at SCORE_SHAPE under V1, V2 and V3 (CUDA events,
    mean of 3 calls after a warm one), the peak device memory of those
    calls, no kernel launched; then in f32 at MOE_F32_SHAPE at a capacity
    with no drops (`no_drop`) the three hidden states agree within
    MOE_F32_TOL of max|V1|."""
    dev = torch.device("cuda")
    cfg = get_config(MOE_ARCH, **LM_FLAGS)
    params = get_model(cfg).init_params(0)
    batch = synth_train_batch(cfg, *SCORE_SHAPE, seed=1, device=dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    timed = []
    for i, v in enumerate(MOE_VARIANTS):
        model = get_model(cfg.with_(moe_variant=Variant(v)))
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with torch.no_grad():
            ms = time_ms(lambda: model.forward(params, batch), 3,
                         torch.empty(1, device=dev))
            h, _ = model.forward(params, batch)
        peak = torch.cuda.max_memory_allocated()
        counts = kernels.launch_counts()
        check(counts["flash_attention"] == 0 == counts["ssd_scan"],
              f"{MOE_ARCH} {v}: launched {counts}")
        check(tuple(h.shape) == SCORE_SHAPE + (cfg.d_model,)
              and bool(torch.isfinite(h).all()), f"{MOE_ARCH} {v}: hidden")
        del h
        timed.append(f"V{i + 1} {v} {ms:.3f} ms, peak {peak / 1e6:.1f} MB")
    say(f"[moe variants] {MOE_ARCH} bf16, full width and depth, scoring "
        f"forward at {SCORE_SHAPE} (CUDA events; weights and batch "
        f"{held / 1e6:.1f} MB of each peak): " + "; ".join(timed))
    del params, batch
    torch.cuda.empty_cache()

    cfg = get_config(MOE_ARCH, param_dtype="float32",
                     compute_dtype="float32",
                     capacity_factor=no_drop(MOE_ARCH))
    params = get_model(cfg).init_params(0)
    batch = synth_train_batch(cfg, *MOE_F32_SHAPE, seed=1, device=dev)
    with torch.no_grad():
        hs = {v: get_model(cfg.with_(moe_variant=Variant(v))).forward(
            params, batch)[0] for v in MOE_VARIANTS}
    ref = hs[MOE_VARIANTS[0]]
    errs = {v: max_err(hs[v], ref) for v in MOE_VARIANTS[1:]}
    say(f"[moe variants] {MOE_ARCH} f32 at {MOE_F32_SHAPE}, capacity "
        f"{cfg.capacity_factor:g}: "
        + ", ".join(f"max|{v} - {MOE_VARIANTS[0]}| {e:.3e}"
                    for v, (e, _) in errs.items())
        + f" (max|ref| {errs['cnn'][1]:.3e}, tolerance "
        f"{MOE_F32_TOL:g} of it)")
    for v, (err, scale) in errs.items():
        check(bool(torch.isfinite(hs[v]).all()) and
              err <= MOE_F32_TOL * scale,
              f"{MOE_ARCH} f32: {v} against {MOE_VARIANTS[0]}")
    del params, batch, hs, ref
    torch.cuda.empty_cache()


def phase_launches() -> None:
    """How many CUDA launches one call of each multi-launch kernel makes,
    and each launch's device time: the fused spans at the paper's geometry
    (batch 4) and the LM kernels. torch.profiler, after every timed phase,
    so that no profiler session precedes the host-clock times of serving."""
    dev = torch.device("cuda")
    cfg = paper_config(variant="dynamic", modality="power_doppler")
    c = consts_from_numpy(init_pipeline(cfg), dev)
    rf = torch.as_tensor(np.stack([synth_rf(cfg, seed=s)
                                   for s in range(BATCH)])).to(dev)
    ft = [c[n] for n in TABLES]
    (q, k, v), args, chunk = lm_kernel_inputs()
    for name, fn in (
            ("fused_rf_to_envelope",
             lambda: fused_rf_to_envelope(*ft, rf, decim=cfg.decim)),
            ("fused_rf_to_power",
             lambda: fused_rf_to_power(*ft, c["wall_taps"], rf,
                                       decim=cfg.decim)),
            ("flash_attention", lambda: flash_attention(q, k, v)),
            ("ssd_scan", lambda: ssd_scan(*args, chunk=chunk))):
        kern, _, _ = profiled(fn)
        say(f"[launches] {name}: one call makes "
            f"{sum(e.count for e in kern)} CUDA launches (torch.profiler), "
            "its launch counter counts the call: "
            + "; ".join(f"{e.key[:70]} x{e.count} "
                        f"{e.self_device_time_total / 1e3:.4f} ms"
                        for e in kern))
    for modality in ("bmode", "power_doppler"):
        engine_trace(modality, rf)
    del q, k, v, args, c, rf, ft
    torch.cuda.empty_cache()


def engine_trace(modality, rf) -> None:
    """Where the fused engine's time goes on a device-resident batch: its
    time a call by CUDA events around 20 calls in a row, the host's time
    to enqueue a call, and, for one call under torch.profiler, each
    kernel's device time, their sum and its share of the event time (the
    rest the device idles, waiting for the host)."""
    cfg = paper_config(variant="dynamic", modality=modality, fusion="fused")
    engine = BatchedExecutor(cfg)
    engine(rf)
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    t0 = time.perf_counter()
    s.record()
    for _ in range(20):
        engine(rf)
    e.record()
    host = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    ms = s.elapsed_time(e) / 20
    kern, _, _ = profiled(lambda: engine(rf))
    busy = sum(k.self_device_time_total for k in kern) / 1e3
    if busy == 0:
        say(f"[engine trace] {modality} fused: {ms:.4f} ms a call (CUDA "
            f"events), host {host:.4f} ms to enqueue a call; the profiler "
            "saw no device time: the idle share is not measured")
        return
    fused = sum(k.self_device_time_total for k in kern
                if any(n in k.key for n in ("demod_kernel",
                                            "das_head_kernel"))) / 1e3
    say(f"[engine trace] {modality} fused: {ms:.4f} ms a call (CUDA events, "
        f"20 calls), host {host:.4f} ms to enqueue a call; one call under "
        f"torch.profiler: {sum(k.count for k in kern)} launches, kernels "
        f"{busy:.4f} ms = {busy / ms:.1%} of the event time (device idle "
        f"{1 - busy / ms:.1%}); the span's two {fused:.4f} ms, the "
        f"epilogue's {busy - fused:.4f} ms: "
        + "; ".join(f"{k.key[:60]} x{k.count} "
                    f"{k.self_device_time_total / 1e3:.4f} ms"
                    for k in sorted(kern,
                                    key=lambda k: -k.self_device_time_total)))


OUR_KERNELS = ("flash_attention_kernel", "ssd_chunk_kernel",
               "ssd_chain_kernel", "ssd_offdiag_kernel")


def kernel_kind(name: str) -> str:
    """"ours" (our CUDA kernels), "matmul" (cuBLAS) or "other"."""
    if any(o in name for o in OUR_KERNELS):
        return "ours"
    if any(m in name.lower() for m in ("gemm", "nvjet", "xmma", "cutlass")):
        return "matmul"
    return "other"


def other_by_op(events) -> dict:
    """Device ms of the "other" kernels by the ATen op that launched each
    (the profiler's CPU-side op that holds the kernel), keyed "op < the
    outermost op of its call" where they differ."""
    by_op = {}
    for ev in events:
        if ev.device_type != torch.autograd.DeviceType.CPU or not ev.kernels:
            continue
        top = ev
        while top.cpu_parent is not None:
            top = top.cpu_parent
        key = ev.name if top is ev else f"{ev.name} < {top.name}"
        for k in ev.kernels:
            if kernel_kind(k.name) == "other" and "spin_kernel" not in k.name:
                by_op[key] = by_op.get(key, 0.0) + k.duration / 1e3
    return by_op


def device_split(name, fn, n_top=6, n_ops=8) -> None:
    """Profile one call of ``fn`` (``profiled``): its wall time to the
    last kernel's end, the summed time of its kernels, their busy share of
    the wall, the shares of our kernels, cuBLAS products and everything
    else, the kernels that take the most device time, and the "other"
    column by the ATen ops that launched its kernels."""
    kern, wall, events = profiled(fn)
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    if busy == 0:
        say(f"[lm split] {name}: the profiler saw no device time; device "
            f"busy share not measured (wall {wall:.3f} ms)")
        return
    cats = {"ours": 0.0, "matmul": 0.0, "other": 0.0}
    for e in kern:
        cats[kernel_kind(e.key)] += e.self_device_time_total / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:n_top]
    say(f"[lm split] {name}: wall {wall:.3f} ms (profiled), kernels "
        f"{busy:.3f} ms = {busy / wall:.1%} busy, "
        f"{sum(e.count for e in kern)} launches; "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in cats.items())
        + "; top: " + "; ".join(
            f"{e.key[:70]} {e.self_device_time_total / 1e3:.3f} ms "
            f"x{e.count}" for e in top))
    ops = other_by_op(events)
    said = sum(ops.values())
    say(f"[lm split] {name}: other {cats['other']:.3f} ms by op "
        f"({said:.3f} ms attributed), top {n_ops}: " + "; ".join(
            f"{op} {ms:.3f} ms" for op, ms in sorted(
                ops.items(), key=lambda kv: -kv[1])[:n_ops]))


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def lm_outputs(arch, prompt, overrides, extra=4) -> None:
    """Full width in f32, one model (with ``overrides``): the kernel
    path's logits (both flags set) against the plain path's, then prefill
    and ``extra`` decode steps against the kernel path's forward on the
    same tokens. For the enc-dec model the prompt is the encoder's frames
    and the decoder's tokens start with BOS (id 0), which its prefill
    consumes; the VLM runs on tokens only (its prefill and decode take
    sequential positions, as tests/test_decode_consistency.py); the
    kernel path's launches are checked against the model's scoring
    kernels."""
    cfg, name = lm_config(arch, param_dtype="float32",
                          compute_dtype="float32", **overrides)
    plain, kern = get_model(cfg), get_model(cfg.with_(**LM_FLAGS))
    params = plain.init_params(1)
    dev = plain.device
    batch = synth_train_batch(cfg, 2, prompt + extra, seed=2, device=dev)
    audio = cfg.family == "audio"
    if audio:
        batch["tokens"][:, 0] = 0
    if cfg.family == "vlm":
        batch = {k: batch[k] for k in ("tokens", "labels")}
    extras = "".join(f" {k} {v:g}" for k, v in overrides.items()
                     if k != "n_layers")
    tag = f"{name} f32{extras}, prompt {prompt}"
    kernels.reset_launch_counts()
    with torch.no_grad():
        full = {m: logits_from_hidden(params["embed"], cfg,
                                      model.forward(params, batch)[0])
                for m, model in (("plain", plain), ("kernel", kern))}
        check(all(bool(torch.isfinite(t).all()) for t in full.values()),
              f"{tag}: non-finite logits")
        close_enough(f"{tag}: forward logits, kernels vs plain",
                     full["kernel"], full["plain"], LOGITS_TOL, LOGITS_TOL)
        if audio:
            logits, cache = kern.prefill(
                params, {"enc_embeds": batch["enc_embeds"]})
            first = 1
        else:
            logits, cache = kern.prefill(
                params, {"tokens": batch["tokens"][:, :prompt]})
            cache = _grow_cache(kern, cache, prompt + extra + 1)
            first = prompt
        close_enough(f"{tag}: prefill logits vs forward", logits[:, 0],
                     full["kernel"][:, first - 1], LOGITS_TOL, LOGITS_TOL)
        lengths = torch.full((2,), first, dtype=torch.int32, device=dev)
        for t in range(extra):
            logits, cache = kern.decode_step(
                params, batch["tokens"][:, first + t:first + t + 1], cache,
                lengths)
            close_enough(f"{tag}: decode step {t} logits vs forward",
                         logits[:, 0], full["kernel"][:, first + t],
                         LOGITS_TOL, LOGITS_TOL)
            lengths = lengths + 1
    counts = kernels.launch_counts()
    # the scoring launches, and zamba2's prefill takes flash too
    want = {"flash_attention": 0, "ssd_scan": 0, **LM_MODELS[arch][3]}
    if cfg.family == "hybrid":
        want["flash_attention"] = 2 * n_attn_invocations(cfg)
    check({k: counts[k] for k in want} == want,
          f"{tag}: kernel path launched {counts}, want {want}")
    del params, cache, full, batch
    torch.cuda.empty_cache()


def phase_lm_outputs() -> None:
    for arch, prompt, overrides in OUTPUT_RUNS:
        lm_outputs(arch, prompt, overrides)


def phase_products() -> None:
    """Storage-dtype attention products (no grad): `f32_product` of bf16
    operands against the f32-cast product at gemma3's decode scores, and
    the device memory that one decode attention (gemma3's and zamba2's
    served caches) and one MLA decode (deepseek-v2's widths) allocate,
    against the size of the cache or the absorbed weights that an f32 or
    bf16 copy would take."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    gemma, zamba = get_config("gemma3-1b"), get_config(ARCH)
    length = PROMPT_LEN + MAX_NEW + 1
    for cfg in (gemma, zamba):
        hkv, dh = cfg.n_kv_heads, cfg.head_dim
        k, v = (torch.randn(LM_BATCH, length, hkv, dh, generator=g,
                            device=dev).to(torch.bfloat16) for _ in range(2))
        q = torch.randn(LM_BATCH, 1, cfg.n_heads, dh, generator=g,
                        device=dev).to(torch.bfloat16)
        if cfg is gemma:
            qg = q.reshape(LM_BATCH, cfg.n_heads, dh)    # one KV head
            kt = k[:, :, 0].transpose(1, 2)
            with torch.no_grad():
                got = f32_product(qg, kt)
            err, scale = max_err(got, torch.bmm(qg.float(), kt.float()))
            say(f"[products] f32_product, bf16 operands at {cfg.name}'s "
                f"decode scores {tuple(qg.shape)} x {tuple(kt.shape)}: "
                f"max|d| {err:.3e} against the f32-cast product (max "
                f"{scale:.3e})")
            check(got.dtype == torch.float32 and err <= 1e-5 * scale,
                  "f32_product disagrees with the f32-cast product")
        lengths = torch.full((LM_BATCH,), length - 1, dtype=torch.int32,
                             device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with torch.no_grad():
            attention.decode_attention(q, k, v, lengths)
        torch.cuda.synchronize()
        grown = torch.cuda.max_memory_allocated() - base
        size = k.numel() * k.element_size()
        say(f"[products] decode_attention at {cfg.name}'s served cache "
            f"{tuple(k.shape)} bf16: allocates {grown / 1e6:.3f} MB, one "
            f"cache {size / 1e6:.3f} MB")
        check(grown < size, f"decode_attention copies the cache ({grown} B)")
        del k, v, q

    cfg = get_config("deepseek-v2-236b", n_layers=1)
    params = attention.mla_params(cfg, torch.bfloat16, g, dev)
    cache = {"c_kv": torch.randn(LM_BATCH, length, cfg.kv_lora_rank,
                                 generator=g, device=dev).to(torch.bfloat16),
             "k_rope": torch.randn(LM_BATCH, length, 1, cfg.qk_rope_head_dim,
                                   generator=g, device=dev).to(
                                       torch.bfloat16)}
    x = torch.randn(LM_BATCH, 1, cfg.d_model, generator=g, device=dev).to(
        torch.bfloat16)
    lengths = torch.full((LM_BATCH,), length - 1, dtype=torch.int32,
                         device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        attention.mla_decode(params, cfg, x, cache, lengths)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    weights = sum(params[k].numel() * 2 for k in ("wk_b", "wv_b"))
    say(f"[products] mla_decode at {cfg.name}'s widths, cache "
        f"{tuple(cache['c_kv'].shape)} bf16: allocates {grown / 1e6:.3f} MB, "
        f"the absorbed weights {weights / 1e6:.3f} MB in bf16")
    check(grown < weights, f"mla_decode copies its weights ({grown} B)")
    del params, cache, x
    torch.cuda.empty_cache()


def _on_card(batch: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def train_timed(cfg, name, microbatches, shape) -> dict:
    """One warm step and TRAIN_TIMED timed steps of ``cfg`` (random
    weights from seed 0, TokenDataset batches at ``shape``), under the
    training loop's deterministic mode: each step's device time (CUDA
    events) and host time, tok/s, peak memory, loss and grad norm (all
    finite), and no kernel launched; returned: the run's figures (the
    timed steps' mean ms, the peak bytes) for `phase_dryrun`. Raises
    OutOfMemoryError where it does not fit."""
    dev = torch.device("cuda")
    model = get_model(cfg)
    tcfg = TrainConfig(microbatches=microbatches)
    data = TokenDataset(cfg, *shape, seed=0)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, 0)
    train_step = make_train_step(model, tcfg)
    kernels.reset_launch_counts()
    dev_ms, host_ms, losses, norms = [], [], [], []
    with deterministic_algorithms():
        for step in range(1, TRAIN_TIMED + 2):
            batch = _on_card(data.batch_for_step(step), dev)
            torch.cuda.synchronize()
            s, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            t0 = time.perf_counter()
            s.record()
            state, metrics = train_step(state, batch)
            e.record()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            dev_ms.append(s.elapsed_time(e))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    counts = kernels.launch_counts()
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    del state, batch
    toks = shape[0] * shape[1]
    timed = dev_ms[1:]
    cut = (f"batch {shape}" + (f", {microbatches} microbatches of "
                               f"{shape[0] // microbatches}"
                               if microbatches > 1 else ""))
    launched = {k: n for k, n in counts.items() if n}
    say(f"[train] {name} {cfg.param_dtype}, {n_params / 1e9:.3f} B "
        f"parameters, remat "
        f"{cfg.remat_policy if cfg.remat else 'off'}, {cut}: warm step "
        f"{dev_ms[0]:.3f} ms; steps " + ", ".join(f"{t:.3f}" for t in timed)
        + f" ms (CUDA events; host {', '.join(f'{t:.3f}' for t in host_ms[1:])}"
        f" ms) = {toks / np.mean(timed) * 1e3:.0f} tok/s; peak_mem="
        f"{peak / 1e6:.1f} MB; loss " + ", ".join(f"{x:.4f}" for x in losses)
        + "; grad_norm " + ", ".join(f"{x:.4f}" for x in norms)
        + f"; kernels launched: {launched or 'none'}")
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"{name}: non-finite loss or grad norm")
    check(not launched, f"{name}: training launched {launched}")
    return dict(cfg=cfg, name=name, microbatches=microbatches, shape=shape,
                step_ms=float(np.mean(timed)), peak=peak)


def train_model(arch, required: bool):
    """`train_timed` at the first cut of TRAIN_CUTS that fits: its
    figures, or None where none fits."""
    cfg, name = lm_config(arch)
    for microbatches, shape in TRAIN_CUTS:
        try:
            return train_timed(cfg, name, microbatches, shape)
        except torch.cuda.OutOfMemoryError:
            say(f"[train] {name}: out of memory at batch {shape} with "
                f"{microbatches} microbatch(es)")
        finally:
            torch.cuda.empty_cache()
    check(not required, f"{name} does not fit one card for training")
    say(f"[train] {name}: does not fit one card at any cut")


def train_checks(arch) -> None:
    """At full width and depth (bf16, remat): the loss on one repeated
    batch falls within 5 steps at warmup 1 (tests/test_arch_smoke.py's
    check); `train_loop` run 4 steps uncut, and again cut by a failure at
    step 3 and resumed from its step-2 checkpoint by `run_resilient`:
    both runs' step-2 checkpoints (two fresh 2-step runs) and step-4
    checkpoints (cut and resumed against uncut) are equal bit for bit,
    parameters and moments."""
    dev = torch.device("cuda")
    cfg, name = lm_config(arch)
    shape = (4, 512)
    model = get_model(cfg)
    state = init_train_state(model, 0)
    train_step = make_train_step(model, TrainConfig(
        learning_rate=1e-3, warmup_steps=1, total_steps=10))
    batch = _on_card(TokenDataset(cfg, *shape, seed=0).batch_for_step(0),
                     dev)
    losses = []
    with deterministic_algorithms():
        for _ in range(5):
            state, metrics = train_step(state, batch)
            losses.append(float(metrics["loss"]))
    say(f"[train] {name} at {shape}, one batch repeated, warmup 1, lr "
        f"1e-3: loss " + ", ".join(f"{x:.4f}" for x in losses))
    check(losses[-1] < losses[0], f"{name}: the loss does not fall")
    del state, batch, metrics

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"train_smoke_{os.getpid()}")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                       checkpoint_every=2, seed=5)
    t0 = time.perf_counter()
    try:
        uncut = []
        train_loop(cfg, tcfg, batch=shape[0], seq=shape[1], steps=4,
                   ckpt_dir=os.path.join(root, "uncut"), metrics_out=uncut,
                   log_every=100)
        attempts, cut = [], []

        def attempt():
            attempts.append(1)
            train_loop(cfg, tcfg, batch=shape[0], seq=shape[1], steps=4,
                       ckpt_dir=os.path.join(root, "cut"), metrics_out=cut,
                       fail_at_step=3 if len(attempts) == 1 else None,
                       log_every=100)

        restarts = run_resilient(attempt, max_restarts=1)
        check(restarts == 1 and latest_step(os.path.join(root, "cut")) == 4,
              f"{name}: the cut run did not resume to step 4")
        for step in (2, 4):
            files = [np.load(os.path.join(root, d, f"step_{step:08d}.npz"))
                     for d in ("uncut", "cut")]
            keys = files[0].files
            check(keys == files[1].files, f"{name}: checkpoint keys differ")
            differ = [k for k in keys
                      if not np.array_equal(files[0][k], files[1][k])]
            what = ("two fresh 2-step runs" if step == 2
                    else "cut at 3 and resumed from 2, against uncut")
            say(f"[train] {name} at {shape}, train_loop: {what}: "
                f"{len(keys)} arrays of the step-{step} checkpoints, "
                f"{len(differ)} differ")
            check(not differ, f"{name}: step {step} differs: {differ[:4]}")
        check(cut == uncut, f"{name}: the metrics of the resumed run differ")
        say(f"[train] {name}: loss " + ", ".join(
            f"{m['loss']:.4f}" for m in uncut) + " in both runs; "
            f"the loop checks took {time.perf_counter() - t0:.1f}s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


def phase_train() -> list:
    """The [train] phase (after phase 8): TRAIN_REQUIRED then
    TRAIN_OPTIONAL through `train_model`; the checks on TRAIN_CHECK_ARCH
    (`train_checks`); the kernels refusing a gradient on the card; and
    one gemma3-1b train step under torch.profiler (`[lm split]`).
    Returns the timed runs' figures."""
    trained = [train_model(arch, required=True) for arch in TRAIN_REQUIRED]
    trained += [train_model(arch, required=False)
                for arch in TRAIN_OPTIONAL]
    train_checks(TRAIN_CHECK_ARCH)

    (q, k, v), args, chunk = lm_kernel_inputs(
        (1, 128, 4, 4, 64), (1, 128, 4, 64, 64))
    for kname, fn, grad_arg in (
            ("flash_attention", lambda: flash_attention(q, k, v), q),
            ("ssd_scan", lambda: ssd_scan(*args, chunk=chunk), args[1])):
        grad_arg.requires_grad_()
        try:
            fn()
            check(False, f"{kname} ran under autograd on the card")
        except ValueError as exc:
            say(f"[train] {kname} under autograd on the card raises: {exc}")
        grad_arg.requires_grad_(False)
    del q, k, v, args

    dev = torch.device("cuda")
    cfg, name = lm_config("gemma3-1b")
    model = get_model(cfg)
    state = init_train_state(model, 0)
    train_step = make_train_step(model, TrainConfig())
    batch = _on_card(TokenDataset(cfg, *SCORE_SHAPE).batch_for_step(1), dev)
    with deterministic_algorithms():
        device_split(f"{name} train step at {SCORE_SHAPE} (remat "
                     f"{cfg.remat_policy})",
                     lambda: train_step(state, batch))
    del state, batch
    torch.cuda.empty_cache()
    return [t for t in trained if t is not None]


def phase_dryrun(trained: list) -> None:
    """The [dryrun] phase (after [train]): each step that [train] timed,
    costed by `launch.dryrun.dry_run` on the meta device (this machine's
    CPU; no mesh, the run's config, batch and microbatches): its counted
    FLOPs (all, and the matmuls'), the model FLOPs 6 N D (N active),
    the step's CUDA-event ms from [train], the achieved TFLOP/s of both
    counts, ``mfu`` = model FLOPs / (step s x the data sheet's bf16
    peak), and the reckoned peak beside the measured one. Fails if the
    dry run raises or a count is zero or not finite."""
    card = card_line()
    for t in trained:
        shape = ShapeConfig("train", "train", t["shape"][1], t["shape"][0])
        r = dry_run(t["cfg"], shape,
                    tcfg=TrainConfig(microbatches=t["microbatches"]))
        step_s = t["step_ms"] / 1e3
        counts = (r["flops_per_device"], r["matmul_flops_per_device"],
                  r["model_flops_global"], r["peak_bytes"],
                  r["memory"]["temp_bytes"])
        check(all(np.isfinite(c) and c > 0 for c in counts),
              f"{t['name']}: a dry-run count is zero or not finite: "
              f"{counts}")
        mfu = r["model_flops_global"] / (step_s * PEAK_BF16_FLOP_PER_S)
        say(f"[dryrun] {t['name']} at {t['shape']}, {t['microbatches']} "
            f"microbatch(es): counted {r['flops_per_device']:.4e} FLOP "
            f"({r['matmul_flops_per_device']:.4e} in matmuls), model_flops "
            f"{r['model_flops_global']:.4e} (6 N D, N active "
            f"{r['params_active']}); step {t['step_ms']:.3f} ms (CUDA "
            f"events, [train]) = {r['flops_per_device'] / step_s / 1e12:.1f}"
            f" TFLOP/s counted, {r['model_flops_global'] / step_s / 1e12:.1f}"
            f" TFLOP/s model; mfu {mfu:.5f} of {PEAK_BF16_FLOP_PER_S:.3g} "
            f"FLOP/s (data-sheet bf16 peak; card {card}); peak reckoned "
            f"{r['peak_bytes'] / 1e6:.1f} MB (arguments "
            f"{r['memory']['argument_bytes'] / 1e6:.1f}, temp "
            f"{r['memory']['temp_bytes'] / 1e6:.1f}) against "
            f"{t['peak'] / 1e6:.1f} MB measured "
            f"({r['peak_bytes'] / t['peak']:.3f}); dry run {r['run_s']} s "
            f"on the CPU")


DIST_ARCH = "gemma3-1b"
DIST_STEPS = 3             # the first one warm


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dist_world1() -> None:
    """World 1 of [dist], in this process (NCCL for CUDA tensors, gloo for
    CPU ones): DIST_STEPS steps (tok/s over all but the first) of the
    data-parallel step at one rank (ZeRO-1 on: at one rank it splits
    no moment) against `make_train_step` on DIST_ARCH at
    full width and depth (bf16, remat, TokenDataset at SCORE_SHAPE,
    deterministic mode): parameters,
    moments and metrics bit for bit; then the compressed mean of the
    step's gradient tree (with a residual) on the card against the same
    call on the CPU, bit for bit."""
    import torch.distributed as dist
    cfg, name = lm_config(DIST_ARCH)
    model = get_model(cfg)
    tcfg = TrainConfig()
    data = TokenDataset(cfg, *SCORE_SHAPE, seed=0)
    batches = [_on_card(data.batch_for_step(i), torch.device("cuda"))
               for i in range(1, DIST_STEPS + 1)]
    with deterministic_algorithms():
        state = init_train_state(model, 0)
        step = make_train_step(model, tcfg)
        plain = []
        for batch in batches:
            state, metrics = step(state, batch)
            plain.append({k: float(v) for k, v in metrics.items()})
    single = {k: v.to("cpu", copy=True)
              for k, v in tree_lib.items(state)}
    del state, step
    torch.cuda.empty_cache()

    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        blocks = state_blocks(cfg, tcfg, mesh)
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        ms, got = [], []
        with deterministic_algorithms():
            state = init_train_state(model, 0, blocks)
            step = make_train_step(model, tcfg, mesh)
            for batch in batches:
                torch.cuda.synchronize()
                s, e = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                s.record()
                state, metrics = step(state, batch)
                e.record()
                torch.cuda.synchronize()
                ms.append(s.elapsed_time(e))
                got.append({k: float(v) for k, v in metrics.items()})
        peak = torch.cuda.max_memory_allocated()
        launched = {k: n for k, n in kernels.launch_counts().items() if n}
        whole = host_tree(state, blocks)
        differ = [k for k in single if not torch.equal(whole[k], single[k])]
        tok_s = SCORE_SHAPE[0] * SCORE_SHAPE[1] / np.mean(ms[1:]) * 1e3
        say(f"[dist] world 1 (NCCL), {name} {cfg.param_dtype}, "
            f"{SCORE_SHAPE}, one rank (ZeRO-1 on, no moment split at one "
            f"rank): warm step {ms[0]:.3f} ms; "
            "steps " + ", ".join(f"{t:.3f}" for t in ms[1:])
            + " ms (CUDA events) = "
            f"{tok_s:.0f} tok/s; peak_mem={peak / 1e6:.1f} MB; against "
            f"make_train_step: {len(single)} arrays of parameters and "
            f"moments, {len(differ)} differ; metrics "
            f"{'equal' if got == plain else 'differ'} (loss "
            + ", ".join(f"{m['loss']:.6f}" for m in got) + "); kernels "
            f"launched: {launched or 'none'}")
        check(not launched, f"[dist] launched {launched}")
        check(not differ, f"[dist] world 1 differs from make_train_step: "
              f"{differ[:4]}")
        check(got == plain, f"[dist] world 1 metrics {got} != {plain}")
        del whole, single

        # the compressed mean of the step's gradient tree, card vs CPU
        params = state["params"]
        live = tree_lib.map_(lambda p: p.detach().requires_grad_(), params)
        with deterministic_algorithms():
            loss = model.loss_fn(live, batches[0])[0]
            grads = torch.autograd.grad(loss, tree_lib.leaves(live))
        del live, loss, state
        grads = tree_lib.unflatten(params, list(grads))
        residual = tree_lib.map_(lambda g: g.float().mul_(1e-2), grads)
        t0 = time.perf_counter()
        with use_binding(binding_for(mesh)):
            card = compressed_psum_mean(grads, "data", residual)
            torch.cuda.synchronize()
            t_card = time.perf_counter() - t0
            cpu = compressed_psum_mean(
                tree_lib.map_(lambda t: t.cpu(), grads), "data",
                tree_lib.map_(lambda t: t.cpu(), residual))
        differ = [(i, k) for i in range(2) for k, v in
                  tree_lib.items(card[i])
                  if not torch.equal(v.cpu(), dict(
                      tree_lib.items(cpu[i]))[k])]
        n_el = sum(g.numel() for g in tree_lib.leaves(grads))
        say(f"[dist] compressed mean (int8, world 1) of {name}'s gradient "
            f"tree ({n_el / 1e9:.3f} G entries, {len(tree_lib.leaves(grads))}"
            f" leaves) with a residual: card {t_card * 1e3:.1f} ms (host "
            f"clock); card against CPU: {len(differ)} of "
            f"{2 * len(tree_lib.leaves(grads))} mean and residual arrays "
            "differ")
        check(not differ, f"[dist] compressed mean card vs CPU: {differ[:4]}")
        del grads, residual, card, cpu, params
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()


def phase_dist() -> None:
    """8d [dist]: every card a rank. World 1 in this process
    (`dist_world1`); with two or more cards, tools/dist_train_scaling.py
    in a process of its own (one more a card) over 1 and all of them:
    DIST_ARCH bf16 at SCORE_SHAPE a card with ZeRO-1 on and off (tok/s,
    scale efficiency against its world 1, peak MB a card) and the f32
    step at full width against one card on the global batch."""
    t0 = time.perf_counter()
    dist_world1()
    n = torch.cuda.device_count()
    if n >= 2:
        root = os.path.dirname(os.path.abspath(__file__))
        out = os.path.join(root, "build", f"dist_{os.getpid()}.json")
        proc = subprocess.run(
            [sys.executable, os.path.join(root, "tools",
                                          "dist_train_scaling.py"),
             "--worlds", "1", str(n), "--steps", str(DIST_STEPS - 1),
             "--out", out], capture_output=True, text=True, timeout=900)
        for line in proc.stdout.splitlines():
            if line.startswith(("[dist]", "FAILED")):
                say(line)
        check(proc.returncode == 0, f"[dist] over {n} cards: exit "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
    say(f"[dist] took {time.perf_counter() - t0:.1f}s")


TP_ARCH = "mamba2-130m"    # the one-card check: the SSM's pieces at 1
TP_STEPS = 2


def tp_model1() -> None:
    """[tp] in this process, over one NCCL rank: the step on the mesh
    (1, 1) against `make_train_step` without a mesh, TP_STEPS steps of
    TP_ARCH at full width and depth (bf16, remat, TokenDataset at
    SCORE_SHAPE, deterministic mode): parameters, moments and metrics
    bit for bit. At a "model" extent of 1 `runtime.sharding.model_axis`
    is None, so `runtime.param_sharding.tp_pieces` gives every leaf
    whole and no "model" collective runs: this confirms that a mesh of
    (1, 1) takes the one-device path (the mesh binding, `state_blocks`,
    the state built and gathered by its blocks, the step's order), not
    the Megatron pair, which needs two cards."""
    cfg, name = lm_config(TP_ARCH)
    mesh_1x1("[tp]", cfg, name, SCORE_SHAPE, TP_STEPS)


def mesh_1x1(tag, cfg, name, shape, steps, parallel=None) -> None:
    """In this process, over one NCCL rank: ``steps`` steps of ``cfg``
    on the mesh (1, 1) under ``parallel`` against `make_train_step`
    without a mesh (remat as configured, TokenDataset at ``shape``,
    deterministic mode): parameters, moments and metrics bit for bit."""
    import torch.distributed as dist
    model = get_model(cfg)
    tcfg = TrainConfig()
    data = TokenDataset(cfg, *shape, seed=0)
    batches = [_on_card(data.batch_for_step(i), torch.device("cuda"))
               for i in range(1, steps + 1)]
    runs = []
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        for mesh in (None, make_mesh((1, 1), ("data", "model"))):
            blocks = state_blocks(cfg, tcfg, mesh, parallel)
            split = [s for s in tree_lib.leaves(blocks["params"])
                     if s is not None]
            check(not split, f"{tag} parameters split at (1, 1): "
                  f"{split[:2]}")
            with deterministic_algorithms():
                state = init_train_state(model, 0, blocks)
                step = make_train_step(model, tcfg, mesh, parallel)
                got = []
                for batch in batches:
                    state, metrics = step(state, batch)
                    got.append({k: float(v) for k, v in metrics.items()})
            whole = host_tree(state, blocks if mesh is not None else None)
            runs.append(({k: v.to("cpu") for k, v in whole.items()}, got))
            del state, step, whole
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    (plain, m_plain), (tp, m_tp) = runs
    differ = [k for k in plain if not torch.equal(plain[k], tp[k])]
    say(f"{tag} mesh (1, 1) in this process, {name} {cfg.param_dtype}, "
        f"{shape}, {steps} steps: against make_train_step "
        f"{len(plain)} arrays of parameters and moments, {len(differ)} "
        f"differ; metrics {'equal' if m_plain == m_tp else 'differ'} "
        "(loss " + ", ".join(f"{m['loss']:.6f}" for m in m_tp) + ")")
    check(not differ, f"{tag} mesh (1, 1) differs: {differ[:4]}")
    check(m_plain == m_tp,
          f"{tag} mesh (1, 1) metrics {m_tp} != {m_plain}")


def phase_tp() -> None:
    """8e [tp]: tensor parallelism over "model". The launch counts are
    zeroed first and must read 0 after: no kernel lies on the training
    path. In this process `tp_model1`; with two or more cards,
    tools/dist_train_scaling.py --meshes in a process of its own (one
    more a card) at (1, n) and, from 4 cards, (n / 2, 2), whose results
    (and each job's own launch counts) come back through its JSON."""
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    tp_model1()
    n = torch.cuda.device_count()
    if n >= 2:
        meshes = [f"1x{n}"] + ([f"{n // 2}x2"] if n >= 4 and n % 2 == 0
                               else [])
        root = os.path.dirname(os.path.abspath(__file__))
        out = os.path.join(root, "build", f"tp_{os.getpid()}.json")
        proc = subprocess.run(
            [sys.executable, os.path.join(root, "tools",
                                          "dist_train_scaling.py"),
             "--meshes", *meshes, "--steps", str(TP_STEPS), "--out", out],
            capture_output=True, text=True, timeout=600)
        for line in proc.stdout.splitlines():
            if line.startswith(("[tp]", "FAILED")):
                say(line)
        check(proc.returncode == 0, f"[tp] over {n} cards: exit "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        with open(out) as f:
            results = json.load(f)
        os.remove(out)
        jobs = results["timed"] + results["f32"]
        tool_launched = {k: v for r in jobs
                         for k, v in r["launches"].items() if v}
        check(not tool_launched, f"[tp] the tool launched {tool_launched}")
        check(all(r["controls_caught"] for r in results["f32"]),
              "[tp] a fault passed the f32 check")
    else:
        say("[tp] the tensor-parallel step across cards needs two or "
            "more cards; one here")
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    say(f"[tp] kernels launched: {launched or 'none'}; took "
        f"{time.perf_counter() - t0:.1f}s")
    check(not launched, f"[tp] launched {launched}")


EP_ARCH = "granite-moe-3b-a800m"
EP_SHAPE = (4, 256)        # the one-card check, on the smoke config


def phase_ep() -> None:
    """8f [ep]: the experts over "model". The launch counts are zeroed
    first and must read 0 after: no kernel lies on the training path.
    In this process `mesh_1x1` on EP_ARCH's smoke config (f32, V2, its
    48 padded experts) at EP_SHAPE: at a "model" extent of 1
    `models.moe.local_experts` gives every expert and
    `collectives.copy_in` / `reduce_out` are the identity, so this runs
    no expert-parallel code; it confirms the mesh's path keeps the
    one-device step. With two or more cards, tools/dist_train_scaling.py
    --moe --moe-timed v2 in a process of its own at (1, n) and, from 4
    cards, (n / 2, 2): the f32 step against one card for granite-moe's
    unpadded smoke (V1, V2, V3) and deepseek-v2's smoke, each with the
    two faults of the experts' collectives, which it must catch, and
    granite-moe (V2) bf16 at full width and depth, 2 timed steps; every
    job's routes equal over "model", and its launches 0."""
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    mesh_1x1("[ep]", get_smoke(EP_ARCH), f"{EP_ARCH} (smoke)", EP_SHAPE,
             TP_STEPS)
    n = torch.cuda.device_count()
    if n >= 2:
        meshes = [f"1x{n}"] + ([f"{n // 2}x2"] if n >= 4 and n % 2 == 0
                               else [])
        root = os.path.dirname(os.path.abspath(__file__))
        out = os.path.join(root, "build", f"ep_{os.getpid()}.json")
        proc = subprocess.run(
            [sys.executable, os.path.join(root, "tools",
                                          "dist_train_scaling.py"),
             "--moe", "--moe-timed", "v2", "--meshes", *meshes, "--steps",
             str(TP_STEPS), "--out", out],
            capture_output=True, text=True, timeout=600)
        for line in proc.stdout.splitlines():
            if line.startswith(("[ep]", "FAILED")):
                say(line)
        check(proc.returncode == 0, f"[ep] over {n} cards: exit "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        with open(out) as f:
            results = json.load(f)
        os.remove(out)
        jobs = results["timed"] + results["f32"]
        tool_launched = {k: v for r in jobs
                         for k, v in r["launches"].items() if v}
        check(not tool_launched, f"[ep] the tool launched {tool_launched}")
        check(all(r["controls_caught"] for r in results["f32"]),
              "[ep] a fault passed the f32 check")
        check(all(r["routes_agree"] for r in jobs),
              "[ep] routes differ over \"model\"")
    else:
        say("[ep] the experts over \"model\" across cards need two or "
            "more cards; one here")
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    say(f"[ep] kernels launched: {launched or 'none'}; took "
        f"{time.perf_counter() - t0:.1f}s")
    check(not launched, f"[ep] launched {launched}")


FSDP_ARCH = "gemma3-1b"   # the one-card check, on the smoke config


def phase_fsdp() -> None:
    """8g [fsdp]: the parameters split over "data" and gathered a layer
    at a time (``ParallelConfig.fsdp``). The launch counts are zeroed
    first and must read 0 after: no kernel lies on the training path. In
    this process `mesh_1x1` under ``ParallelConfig(fsdp=True)`` on
    FSDP_ARCH's smoke config (f32, remat) at EP_SHAPE: at a "data"
    extent of 1 no parameter splits (no FSDP block, no gather), so the
    step is the one without a mesh, bit for bit. With two or more
    cards, tools/dist_train_scaling.py --fsdp --f32-only in a process of
    its own at (n, 1) and, from 4 cards, (n / 2, 2): two FSDP steps of
    gemma3-1b's, mamba2-130m's, granite-moe's (unpadded, V2) and
    deepseek-v2's smoke configs against two on one card, each with the
    two faults it must catch (the gathered weights' gradients left
    unsummed over "data", the gathered layers cached across steps);
    their launches 0."""
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    mesh_1x1("[fsdp]", get_smoke(FSDP_ARCH, remat=True),
             f"{FSDP_ARCH} (smoke)", EP_SHAPE, TP_STEPS,
             ParallelConfig(fsdp=True))
    n = torch.cuda.device_count()
    if n >= 2:
        meshes = [f"{n}x1"] + ([f"{n // 2}x2"] if n >= 4 and n % 2 == 0
                               else [])
        root = os.path.dirname(os.path.abspath(__file__))
        out = os.path.join(root, "build", f"fsdp_{os.getpid()}.json")
        proc = subprocess.run(
            [sys.executable, os.path.join(root, "tools",
                                          "dist_train_scaling.py"),
             "--fsdp", "--f32-only", "--meshes", *meshes, "--out", out],
            capture_output=True, text=True, timeout=600)
        for line in proc.stdout.splitlines():
            if line.startswith(("[fsdp]", "FAILED")):
                say(line)
        check(proc.returncode == 0, f"[fsdp] over {n} cards: exit "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        with open(out) as f:
            results = json.load(f)
        os.remove(out)
        tool_launched = {k: v for r in results["f32"]
                         for k, v in r["launches"].items() if v}
        check(not tool_launched,
              f"[fsdp] the tool launched {tool_launched}")
        check(bool(results["f32"]) and all(
            r["controls_caught"] and r["fsdp"] for r in results["f32"]),
              "[fsdp] a fault passed the f32 check")
    else:
        say("[fsdp] FSDP across cards needs two or more cards; one here")
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    say(f"[fsdp] kernels launched: {launched or 'none'}; took "
        f"{time.perf_counter() - t0:.1f}s")
    check(not launched, f"[fsdp] launched {launched}")


CELLS_PROMPT = (4, 1024)   # the one-card check: zamba2's prefill cell
CELLS_STEPS = 4


def phase_cells() -> dict:
    """8h [cells]: the serving cells (`launch.cells.make_cell`). In this
    process, over one NCCL rank: ARCH bf16 at full width and depth with
    LM_FLAGS, the prefill cell of a CELLS_PROMPT prompt on the mesh
    (1, 1), its cache grown by CELLS_STEPS positions and relayout into
    the decode cell's layout, and CELLS_STEPS decode steps, against the
    steps without a mesh from the same parameters, bit for bit (at
    "model" 1 no piece, no collective: the one-device path). The launch
    counts are zeroed just before the cells run and read after: the
    prefill cell's flash launches, none in decode. With two or more
    cards, tools/dist_serve_cells.py in a process of its own at (1, n)
    and, from 4 cards, (n / 2, 2) (its module doc), whose faults must be
    caught and whose decode runs launch no kernel. Returns the cells'
    launches, each kernel's sum over this process and the tool's
    ranks."""
    import torch.distributed as dist
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import cells
    from repro_torch.launch.serve import _grow_cache
    from repro_torch.runtime import param_sharding as psh
    t0 = time.perf_counter()
    cfg, name = lm_config(ARCH, **LM_FLAGS)
    dev = torch.device("cuda")
    model = get_model(cfg)
    params = model.init_params(0)
    batch, plen = CELLS_PROMPT
    prompt = synth_train_batch(cfg, batch, plen, seed=0, device=dev)
    max_len = plen + CELLS_STEPS
    lengths = torch.full((batch,), plen, dtype=torch.int32, device=dev)

    def run(prefill, serve, relayout=None):
        tok, cache = prefill(params, prompt)
        after_prefill = kernels.launch_counts()
        cache = _grow_cache(model, cache, max_len)
        if relayout is not None:
            cache = relayout(cache)
        toks, t, ln = [tok[:, None]], tok[:, None], lengths
        for _ in range(CELLS_STEPS):
            t, cache, ln = serve(params, t, cache, ln)
            toks.append(t)
        return torch.cat(toks, dim=1), cache, after_prefill

    plain_toks, plain_cache, _ = run(make_prefill_step(model),
                                     make_serve_step(model))
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        pcell = cells.make_cell(cfg, ShapeConfig("prefill", "prefill", plen,
                                                 batch), mesh)
        dcell = cells.make_cell(cfg, ShapeConfig("decode", "decode",
                                                 max_len, batch), mesh)
        split = [s for s in tree_lib.leaves(pcell.in_layouts[0])
                 if s is not None]
        check(not split, f"[cells] parameters split at (1, 1): {split[:2]}")

        def relayout(cache):
            with use_binding(dcell.step.binding):
                return psh.relayout(cache, pcell.out_layouts[1],
                                    dcell.in_layouts[2])

        kernels.reset_launch_counts()
        mesh_toks, mesh_cache, prefill = run(pcell.step, dcell.step,
                                             relayout)
        launched = kernels.launch_counts()
    finally:
        dist.destroy_process_group()
    decode = {k: v - prefill[k] for k, v in launched.items() if v - prefill[k]}
    differ = [k for (k, a), b in zip(tree_lib.items(plain_cache),
                                     tree_lib.leaves(mesh_cache))
              if not torch.equal(a, b)]
    same = torch.equal(plain_toks, mesh_toks)
    say(f"[cells] mesh (1, 1) in this process, {name} bf16, prompt "
        f"{CELLS_PROMPT}, {CELLS_STEPS} decode steps: tokens "
        f"{'equal' if same else 'differ'}, {len(differ)} cache leaves "
        f"differ from the steps without a mesh; the prefill cell "
        f"launched { {k: v for k, v in prefill.items() if v} or 'none'}, "
        f"the decode cell {decode or 'none'}")
    check(same and not differ, f"[cells] mesh (1, 1) differs: {differ}")
    check(not decode, f"[cells] the decode cell launched {decode}")
    want = n_attn_invocations(cfg)
    check(launched.get("flash_attention", 0) == want,
          f"[cells] prefill cell flash launches "
          f"{launched.get('flash_attention')} != {want}")
    del params, plain_cache, mesh_cache, model
    torch.cuda.empty_cache()
    n = torch.cuda.device_count()
    if n >= 2:
        meshes = [f"1x{n}"] + ([f"{n // 2}x2"] if n >= 4 and n % 2 == 0
                               else [])
        root = os.path.dirname(os.path.abspath(__file__))
        out = os.path.join(root, "build", f"cells_{os.getpid()}.json")
        proc = subprocess.run(
            [sys.executable, os.path.join(root, "tools",
                                          "dist_serve_cells.py"),
             "--meshes", *meshes, "--out", out],
            capture_output=True, text=True, timeout=900)
        for line in proc.stdout.splitlines():
            if line.startswith(("[cells]", "FAILED")):
                say(line)
        check(proc.returncode == 0, f"[cells] over {n} cards: exit "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        with open(out) as f:
            results = json.load(f)["results"]
        os.remove(out)
        check(any(r["kind"] == "f32" and r["fault"] for r in results) and
              all(r["ok"] != bool(r["fault"]) for r in results
                  if r["kind"] == "f32"),
              "[cells] an f32 check failed or a fault passed")
        for r in results:
            if r["kind"] == "decode":
                used = {k: v for k, v in r["decode_launches"].items() if v}
                check(not used, f"[cells] decode launched {used}")
                for k, v in r["prefill_launches"].items():
                    launched[k] = launched.get(k, 0) + v
            elif r["kind"] == "prefill":
                for x in r["runs"]:
                    for k, v in x["launches"].items():
                        launched[k] = launched.get(k, 0) + v
    else:
        say("[cells] the cells across cards need two or more cards; one "
            "here")
    say(f"[cells] took {time.perf_counter() - t0:.1f}s")
    return launched


FALLBACK_MESH = "1x3"     # "model" 3 divides none of the configs' blocks


def _tool_run(tag, script, args, timeout) -> dict:
    """tools/``script`` with ``args`` and ``--out`` in a process of its
    own; its lines tagged ``tag`` (or FAILED) printed, its exit checked;
    its JSON results."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(root, "build", f"{script[:-3]}_{os.getpid()}.json")
    proc = subprocess.run([sys.executable, os.path.join(root, "tools",
                                                        script),
                           *args, "--out", out],
                          capture_output=True, text=True, timeout=timeout)
    for line in proc.stdout.splitlines():
        if line.startswith((tag, "FAILED")):
            say(line)
    check(proc.returncode == 0, f"{tag} {script}: exit "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    with open(out) as f:
        results = json.load(f)
    os.remove(out)
    return results


def phase_fallback() -> dict:
    """8i [fallback]: the blocks that "model" does not divide and MoE
    V2's groups across ranks (module doc). With three or more cards,
    both tools at FALLBACK_MESH in processes of their own: the train
    tool's f32 checks must hold and their faults fail, and it must
    launch no kernel; the serve tool's f32 checks must hold, and its
    zamba2-1.2b prefill cell must launch the flash kernel
    `n_attn_invocations` times a rank and give one card's next token.
    Returns those launches, summed over the ranks."""
    t0 = time.perf_counter()
    launched = {}
    n = torch.cuda.device_count()
    if n < 3:
        say(f"[fallback] blocks \"model\" does not divide need a \"model\" "
            f"extent of 3, three cards; {n} here")
        return launched
    train = _tool_run("[fallback]", "dist_train_scaling.py",
                      ["--attn-batch", "--meshes", FALLBACK_MESH,
                       "--steps", str(TP_STEPS)], 900)
    jobs = train["timed"] + train["f32"]
    tool_launched = {k: v for r in jobs for k, v in r["launches"].items()
                     if v}
    check(not tool_launched, f"[fallback] training launched "
          f"{tool_launched}")
    check(train["f32"] and all(r["ok"] and r["controls_caught"]
                               for r in train["f32"]),
          "[fallback] an f32 check failed or a fault passed")
    serve = _tool_run("[fallback]", "dist_serve_cells.py",
                      ["--meshes", FALLBACK_MESH, "--fallback"], 900)
    results = serve["results"]
    check(all(r["ok"] for r in results if r["kind"] == "f32"),
          "[fallback] a serving f32 check failed")
    prefills = [x for r in results if r["kind"] == "prefill"
                for x in r["runs"]]
    cfg, _ = lm_config(ARCH, **LM_FLAGS)
    ranks = int(FALLBACK_MESH.split("x")[1])
    for x in prefills:
        check(x.get("tokens_equal", False),
              "[fallback] the prefill cell's next token differs from one "
              "card's")
        got = x["launches"].get("flash_attention", 0)
        check(got == ranks * n_attn_invocations(cfg),
              f"[fallback] prefill flash launches {got} != "
              f"{ranks} x {n_attn_invocations(cfg)}")
        for k, v in x["launches"].items():
            launched[k] = launched.get(k, 0) + v
    check(bool(prefills), "[fallback] no prefill ran")
    say(f"[fallback] kernels launched: "
        f"{ {k: v for k, v in launched.items() if v} or 'none'}; took "
        f"{time.perf_counter() - t0:.1f}s")
    return launched


POD_MESHES = ("2x2x1", "2x1x2")


def phase_pod() -> dict:
    """8j [pod]: the "pod" axis as data and decode with the cache's KV
    heads over "model" (module doc). With four or more cards, both tools
    at POD_MESHES in processes of their own: the train tool's f32 checks
    must hold and their faults fail, and it must launch no kernel; the
    serve tool's f32 checks must hold (its fault fail), and zamba2-1.2b's
    prefill cell at (2, 1, 2) must launch the flash kernel
    `n_attn_invocations` times a rank and give one card's next token.
    Returns those launches, summed over the ranks."""
    t0 = time.perf_counter()
    launched = {}
    n = torch.cuda.device_count()
    if n < 4:
        say(f"[pod] a mesh (pod 2, data 2, model 1) or (2, 1, 2) needs "
            f"four cards; {n} here")
        return launched
    train = _tool_run("[pod]", "dist_train_scaling.py",
                      ["--meshes", *POD_MESHES, "--f32-only"], 900)
    tool_launched = {k: v for r in train["f32"]
                     for k, v in r["launches"].items() if v}
    check(not tool_launched, f"[pod] training launched {tool_launched}")
    check(train["f32"] and all(r["ok"] and r["controls_caught"]
                               and "pod_unsummed" in r["controls"]
                               for r in train["f32"]),
          "[pod] an f32 check failed or a fault passed")
    serve = _tool_run("[pod]", "dist_serve_cells.py",
                      ["--meshes", *POD_MESHES, "--kv-heads",
                       "--prefill-only"], 900)
    results = serve["results"]
    f32 = [r for r in results if r["kind"] == "f32"]
    check(f32 and all(r["ok"] != bool(r["fault"]) for r in f32),
          "[pod] a serving f32 check failed or its fault passed")
    check(any(r.get("kv_heads") and not r["fault"] for r in f32),
          "[pod] no decode cell with the KV heads over model ran")
    prefills = [x for r in results if r["kind"] == "prefill"
                for x in r["runs"]]
    cfg, _ = lm_config(ARCH, **LM_FLAGS)
    for x in prefills:
        check(x.get("tokens_equal", False),
              "[pod] the prefill cell's next token differs from one card's")
        ranks = int(np.prod(x["mesh"]))
        got = x["launches"].get("flash_attention", 0)
        check(got == ranks * n_attn_invocations(cfg),
              f"[pod] prefill flash launches {got} != "
              f"{ranks} x {n_attn_invocations(cfg)}")
        for k, v in x["launches"].items():
            launched[k] = launched.get(k, 0) + v
    check(bool(prefills), "[pod] no prefill ran")
    say(f"[pod] kernels launched: "
        f"{ {k: v for k, v in launched.items() if v} or 'none'}; took "
        f"{time.perf_counter() - t0:.1f}s")
    return launched


def main() -> None:
    t_start = time.perf_counter()
    # constants are built afresh: the disk tier is on only in its own
    # phase, in a directory of the checkout
    set_consts_cache_dir(None)
    name = phase_device()
    phase_build()
    t0 = time.perf_counter()
    source = SyntheticAcquisitionSource(
        paper_config(variant="dynamic"), BATCH, pool=2, seed=0,
        pin_memory=True)
    say(f"[source] {BATCH * 2} paper-geometry acquisitions in "
        f"{time.perf_counter() - t0:.1f}s")
    rows = phase_kernels(source)
    launches = phase_serve(source)
    phase_outputs(source)
    for kernel, n in phase_multitenant().items():
        launches[kernel] += n
    for kernel, n in phase_plan_shards(source).items():
        launches[kernel] += n
    del source
    torch.cuda.empty_cache()
    say(f"[lm] ultrasound phases freed; "
        f"{torch.cuda.memory_allocated() / 1e6:.1f} MB still allocated")
    rows.update(phase_lm_kernels())
    launches.update(phase_lm_models())
    phase_moe_variants()
    phase_lm_outputs()
    phase_products()
    phase_dryrun(phase_train())
    phase_dist()
    phase_tp()
    phase_ep()
    phase_fsdp()
    for kernel, n in phase_cells().items():
        launches[kernel] = launches.get(kernel, 0) + n
    for kernel, n in phase_fallback().items():
        launches[kernel] = launches.get(kernel, 0) + n
    for kernel, n in phase_pod().items():
        launches[kernel] = launches.get(kernel, 0) + n
    phase_launches()
    say(f"[done] in {time.perf_counter() - t_start:.1f}s")
    say(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": rows[n]["source"],
         "replaces": rows[n]["replaces"],
         "launches": launches[rows[n].get("kernel", n)],
         "max_abs_err": rows[n]["err"], "ms": rows[n]["ms"],
         "plain_ms": rows[n]["plain_ms"], "bound_ms": rows[n]["bound"][0],
         "bound_by": rows[n]["bound"][1],
         "library_ms": rows[n]["library_ms"]}
        for n in rows]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
