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
               blocks, two runs bit-equal, f32 errors against float64,
               the 3xTF32 bound beside the SIMT one, and its bf16 time;
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
               SIMT bound;
  7. lm serve — zamba2-1.2b at full width and depth in bf16, random
               weights from a seed: `serve_session` with the flash kernel
               (8 requests, slot batch 4, prompt 1024, 32 new tokens),
               then scoring (`loss_fn`, forward at (4, 2048)) with the SSD
               kernel, each with the launch counters zeroed before and
               read after;
     then `[lm split]`: torch.profiler over one prefill, one decode step
               and one scoring forward, for the device's busy share and
               the kernels that take the device time;
  8. lm outputs — full width in f32: the kernel path's logits against the
               plain path's, and prefill and decode logits against
               forward's;
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import demod, lowering  # noqa: E402
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
                                          bsr_spmm, bsr_spmm_ref, kept_slots)
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
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.common import logits_from_hidden  # noqa: E402
from repro_torch.models.hybrid import n_attn_invocations  # noqa: E402

# NVIDIA H100 SXM data sheet: HBM rate, f32 rate outside the tensor cores,
# dense TF32 rate of the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12
PEAK_BF16_FLOP_PER_S = 989e12
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

# LM half: zamba2-1.2b, served and scored at full width and depth
ARCH = "zamba2-1.2b"
LM_REQUESTS, LM_BATCH, PROMPT_LEN, MAX_NEW = 8, 4, 1024, 32
SCORE_SHAPE = (4, 2048)
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
    activity) and the call's wall time in ms (host clock; the profiler
    adds host overhead)."""
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
             and "spin_kernel" not in e.key], wall)


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


def measure(rows: dict, flush: torch.Tensor) -> dict:
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
        say(f"[kernels] {name}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound'][0]:.4f} ms "
            f"({row['bound'][1]}){simt}, library: {lib}")
        out[name] = row
    return out


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("FAILED: torch.cuda.is_available() is false — "
                         "chip_smoke.py needs a CUDA device")
    name = torch.cuda.get_device_name(0)
    say(f"[device] {name} x{torch.cuda.device_count()} "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        say(line.strip())
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


def sparse_rows(source, flush) -> dict:
    """bsr_beamform at the served shapes, and bsr_spmm on one channel's
    real product at the same shapes. The operations bound counts the
    occupied blocks: the padded K slots are zero and need no work. For
    bsr_beamform also: the skip rule, two runs bit-equal, the f32 error
    of kernel and plain version against float64, and the bf16 time."""
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
    # torch's BSR product over the real form [[re, -im], [im, re]] of each
    # block, columns (channel, sample block), summing the channels
    re, im = blocks[..., 0], blocks[..., 1]
    real = torch.cat([torch.cat([re, -im], -1), torch.cat([im, re], -1)], -2)
    a = sorted_bsr(
        (cols + torch.arange(n_c, device=dev)[:, None, None] * n_sb)
        .permute(1, 0, 2).reshape(n_pb, n_c * k),
        real.permute(1, 0, 2, 3, 4).reshape(n_pb, n_c * k, 2 * bp, 2 * bs),
        n_pb * 2 * bp, n_c * n_sb * 2 * bs)
    del real, re, im
    x = iq_b.permute(3, 1, 5, 2, 0, 4).reshape(n_c * n_sb * 2 * bs,
                                                 b * n_f)
    plain = bsr_beamform_ref(cols, blocks, iq_b)
    library = (lambda: a @ x)
    # the occupied blocks' work: the bound of the 3xTF32 route, and the
    # f32 FMA units' (SIMT) beside it
    bf_bytes = (n_occ * bp * bs * 8 + cols.numel() * 4 + iq_b.numel() * 4
                + b * n_pb * bp * n_f * 8)
    bf_flops = 8.0 * b * n_occ * bp * bs * n_f
    route, simt = split_tf32_bound(bf_bytes, bf_flops)
    as_out = (lambda y: y.view(n_pb, 2, bp, b, n_f).permute(3, 0, 2, 4, 1)
              .reshape(b, n_pb * bp, n_f, 2))
    ok = library_check("bsr_beamform", lambda: as_out(library()), plain)
    rows["bsr_beamform"] = dict(
        err=bf_err,
        fn=lambda: bsr_beamform(cols, blocks, iq_b),
        plain=lambda: bsr_beamform_ref(cols, blocks, iq_b),
        library=library if ok else None,
        library_name=("torch.sparse_bsr_tensor @ dense, real "
                      "[[re, -im], [im, re]] blocks" if ok
                      else "none: torch's BSR product refused or disagreed"),
        bound=route, simt_bound=simt,
        source="src/repro_torch/kernels/csrc/bsr_spmm.cu",
        replaces="src/repro/kernels/bsr_spmm/kernel.py:51")
    del plain
    ms16 = time_ms(lambda: bsr_beamform(cols, blocks, iq_b,
                                        precision="bf16"), 20, flush)
    b16 = bound(bf_bytes, bf_flops, PEAK_BF16_FLOP_PER_S)
    say(f"[kernels] bsr_beamform[bf16]: kernel {ms16:.4f} ms, bound "
        f"{b16[0]:.4f} ms ({b16[1]}; bf16 tensor cores at 989 TFLOP/s)")

    # bsr_spmm: the real part of one (middle) channel's product
    ch = n_c // 2
    cols1 = cols[ch].contiguous()
    blocks1 = blocks[ch, ..., 0].contiguous()
    x1 = (iq_b[:, :, :, ch, :, 0].permute(1, 2, 0, 3)
          .reshape(n_sb, bs, b * n_f).contiguous())
    occ1 = int((blocks1 != 0).flatten(2).any(-1).sum())
    spmm_err = check_precisions(
        "bsr_spmm", lambda p: bsr_spmm(cols1, blocks1, x1, precision=p),
        lambda p: bsr_spmm_ref(cols1, blocks1, x1, precision=p))
    a1 = sorted_bsr(cols1, blocks1, n_pb * bp, n_sb * bs)
    x1_flat = x1.reshape(n_sb * bs, b * n_f)
    library1 = (lambda: a1 @ x1_flat)
    ok1 = library_check("bsr_spmm",
                        lambda: library1().view(n_pb, bp, b * n_f),
                        bsr_spmm_ref(cols1, blocks1, x1))
    rows["bsr_spmm"] = dict(
        err=spmm_err,
        fn=lambda: bsr_spmm(cols1, blocks1, x1),
        plain=lambda: bsr_spmm_ref(cols1, blocks1, x1),
        library=library1 if ok1 else None,
        library_name=("torch.sparse_bsr_tensor @ dense" if ok1
                      else "none: torch's BSR product refused or disagreed"),
        bound=bound(occ1 * bp * bs * 4 + cols1.numel() * 4
                    + x1.numel() * 4 + n_pb * bp * b * n_f * 4,
                    2.0 * occ1 * bp * bs * b * n_f),
        source="src/repro_torch/kernels/csrc/bsr_spmm.cu",
        replaces="src/repro/kernels/bsr_spmm/kernel.py:51")
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


def lm_kernel_inputs() -> tuple:
    """f32 inputs from seed 0: q, k, v at zamba2's served prefill shape
    and (log_a, x, b, c) at its scoring shape, and the SSD chunk."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = tuple(torch.randn(LM_BATCH, PROMPT_LEN, 32, 64, generator=g,
                            device=dev) for _ in range(3))
    bsz, length = SCORE_SHAPE
    cfg = get_config(ARCH)
    heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    p, n = cfg.ssm_head_dim, cfg.ssm_state
    log_a = -torch.rand(bsz, length, heads, generator=g, device=dev) * 0.3
    x = torch.randn(bsz, length, heads, p, generator=g, device=dev)
    bm, cm = (torch.randn(bsz, length, n, generator=g, device=dev) * 0.3
              for _ in range(2))
    return qkv, (log_a, x, bm, cm), cfg.ssm_chunk


def phase_lm_kernels() -> dict:
    """flash_attention at zamba2's served prefill shape and ssd_scan at
    its scoring shape, f32, against their plain versions; then timed.
    Both run their products as 3xTF32 on the tensor cores: the bound is
    that route's (three TF32 products per f32 one at 495 TFLOP/s), with
    the f32 FMA units' (SIMT) bound printed beside it."""
    dev = torch.device("cuda")
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {}

    (q, k, v), args, chunk = lm_kernel_inputs()
    b, l, h, d = q.shape
    err = close_enough("flash_attention vs plain",
                       flash_attention(q, k, v), flash_attention_ref(q, k, v),
                       *FLASH_TOL)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library = (lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    ok = library_check("flash_attention", lambda: library().transpose(1, 2),
                       flash_attention_ref(q, k, v))
    route, simt = split_tf32_bound(4.0 * 4 * b * l * h * d,
                                   4.0 * b * h * d * l * (l + 1) / 2)
    rows["flash_attention"] = dict(
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

    log_a, x, bm, cm = args
    bsz, length, heads, p = x.shape
    n = bm.shape[-1]
    err = close_enough("ssd_scan vs plain", ssd_scan(*args, chunk=chunk),
                       ssd_scan_ref(*args), *SSD_TOL)
    nc = -(-length // chunk)
    # C B^T once per (batch, chunk) (B and C are group-shared), the lower
    # triangles of C B^T and of M x, and the two state products per head
    route, simt = split_tf32_bound(
        4.0 * (log_a.numel() + 2 * x.numel() + bm.numel() + cm.numel()),
        1.0 * bsz * nc * (chunk * (chunk + 1) * n
                          + heads * (chunk * (chunk + 1) * p
                                     + 4 * chunk * n * p)))
    rows["ssd_scan"] = dict(
        err=err,
        fn=lambda: ssd_scan(*args, chunk=chunk),
        plain=lambda: ssd_scan_ref(*args),
        library=None,
        library_name="none: no single PyTorch call computes the SSD scan",
        bound=route, simt_bound=simt,
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:71")
    say(f"[lm] shapes: flash (B {b}, L {l}, H {h}, d {d}) causal; ssd "
        f"(B {bsz}, L {length}, H {heads}, P {p}, N {n}, Q {chunk}), B and "
        "C group-shared")
    rows = measure(rows, flush)
    del flush, q, k, v, qt, kt, vt, x, log_a, bm, cm, args
    torch.cuda.empty_cache()
    return rows


def phase_lm_serve() -> dict:
    """zamba2-1.2b in bf16: serve_session with the flash kernel, then
    scoring with the SSD kernel, each read from its own launch counts."""
    dev = torch.device("cuda")
    cfg = get_config(ARCH, use_flash_kernel=True)
    t0 = time.perf_counter()
    params = get_model(cfg).init_params(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    say(f"[lm] {ARCH}: {cfg.n_layers} Mamba2 layers, d_model "
        f"{cfg.d_model}, {n_params / 1e9:.3f} B parameters in "
        f"{cfg.param_dtype}, random from seed 0, made on the card in "
        f"{time.perf_counter() - t0:.1f}s")

    kernels.reset_launch_counts()
    out, stats = serve_session(cfg, requests=LM_REQUESTS, batch=LM_BATCH,
                               prompt_len=PROMPT_LEN, max_new=MAX_NEW,
                               params=params)
    counts = kernels.launch_counts()
    n_prefill = -(-LM_REQUESTS // LM_BATCH)
    n_inv = n_attn_invocations(cfg)
    pre = np.array(stats["prefill_s"]) * 1e3
    dec = np.array(stats["decode_s"]) * 1e3
    say(f"[lm] serve {ARCH} bf16 flash: {LM_REQUESTS} requests, slot batch "
        f"{LM_BATCH}, prompt {PROMPT_LEN}, {MAX_NEW} new tokens: "
        f"{stats['tokens']} tokens in {stats['wall_s']:.3f}s = "
        f"{stats['tok_per_s']:.1f} tok/s; prefill per slot batch "
        f"{', '.join(f'{t:.3f}' for t in pre)} ms; decode per step mean "
        f"{dec.mean():.3f} ms, p50 {np.median(dec):.3f} ms, max "
        f"{dec.max():.3f} ms; peak_mem="
        f"{stats['peak_memory_bytes'] / 1e6:.1f} MB; launches={counts}")
    check(out.shape == (LM_REQUESTS, MAX_NEW + 1), f"tokens {out.shape}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "generated tokens outside the vocabulary")
    check(counts["flash_attention"] == n_inv * n_prefill,
          f"flash_attention launched {counts['flash_attention']} times, "
          f"want {n_inv} per prefill x {n_prefill}")
    check(counts["ssd_scan"] == 0, "ssd_scan on the serving path")
    launches = {"flash_attention": counts["flash_attention"]}

    model = get_model(cfg)
    prompt = synth_train_batch(cfg, LM_BATCH, PROMPT_LEN, seed=0, device=dev)
    with torch.no_grad():
        device_split("prefill (flash)", lambda: model.prefill(params, prompt))
        _, cache = model.prefill(params, prompt)
        cache = _grow_cache(cache, PROMPT_LEN + MAX_NEW + 1)
        tok = prompt["tokens"][:, -1:]
        lengths = torch.full((LM_BATCH,), PROMPT_LEN, dtype=torch.int32,
                             device=dev)
        device_split("decode step", lambda: model.decode_step(
            params, tok, cache, lengths))
    del cache, prompt

    cfg = get_config(ARCH, use_ssd_kernel=True)
    model = get_model(cfg)
    batch = synth_train_batch(cfg, *SCORE_SHAPE, seed=1, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        loss, _ = model.loss_fn(params, batch)
    loss = loss.item()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    s, e = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    with torch.no_grad():
        s.record()
        h, _ = model.forward(params, batch)
        e.record()
    torch.cuda.synchronize()
    toks = SCORE_SHAPE[0] * SCORE_SHAPE[1]
    say(f"[lm] score {ARCH} bf16 ssd: loss_fn at {SCORE_SHAPE}: loss "
        f"{loss:.4f} (ln V = {np.log(cfg.vocab_size):.4f}), first call "
        f"{wall * 1e3:.1f} ms, forward {s.elapsed_time(e):.3f} ms "
        f"(CUDA events) = {toks / s.elapsed_time(e) * 1e3:.0f} tok/s; "
        f"peak_mem={peak / 1e6:.1f} MB; launches={counts}")
    check(np.isfinite(loss), "non-finite loss")
    check(tuple(h.shape) == SCORE_SHAPE + (cfg.d_model,)
          and bool(torch.isfinite(h).all()), "forward hidden states")
    check(counts["ssd_scan"] == cfg.n_layers,
          f"ssd_scan launched {counts['ssd_scan']} times, want "
          f"{cfg.n_layers}")
    check(counts["flash_attention"] == 0, "flash on the scoring path")
    launches["ssd_scan"] = counts["ssd_scan"]
    with torch.no_grad():
        device_split("scoring forward (ssd)",
                     lambda: model.forward(params, batch))
    del params, batch, h
    torch.cuda.empty_cache()
    return launches


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
        kern, _ = profiled(fn)
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
    kern, _ = profiled(lambda: engine(rf))
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


def device_split(name, fn, n_top=6) -> None:
    """Profile one call of ``fn`` (``profiled``): its wall time to the
    last kernel's end, the summed time of its kernels, their busy share of
    the wall, the shares of our kernels, cuBLAS products and everything
    else, and the kernels that take the most device time."""
    kern, wall = profiled(fn)
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    if busy == 0:
        say(f"[lm split] {name}: the profiler saw no device time; device "
            f"busy share not measured (wall {wall:.3f} ms)")
        return
    ours = ("flash_attention_kernel", "ssd_chunk_kernel", "ssd_chain_kernel",
            "ssd_offdiag_kernel")
    cats = {"ours": 0.0, "matmul": 0.0, "other": 0.0}
    for e in kern:
        key = ("ours" if any(o in e.key for o in ours) else "matmul"
               if any(m in e.key.lower() for m in ("gemm", "nvjet", "xmma",
                                                   "cutlass"))
               else "other")
        cats[key] += e.self_device_time_total / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:n_top]
    say(f"[lm split] {name}: wall {wall:.3f} ms (profiled), kernels "
        f"{busy:.3f} ms = {busy / wall:.1%} busy, "
        f"{sum(e.count for e in kern)} launches; "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in cats.items())
        + "; top: " + "; ".join(
            f"{e.key[:70]} {e.self_device_time_total / 1e3:.3f} ms "
            f"x{e.count}" for e in top))


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def phase_lm_outputs() -> None:
    """Full width in f32: the kernel path against the plain path, and
    prefill then decode against forward, on the same tokens."""
    cfg = get_config(ARCH, param_dtype="float32", compute_dtype="float32")
    kcfg = cfg.with_(use_flash_kernel=True, use_ssd_kernel=True)
    plain, kern = get_model(cfg), get_model(kcfg)
    params = plain.init_params(1)
    prompt, extra = 256, 4
    batch = synth_train_batch(cfg, 2, prompt + extra, seed=2,
                              device=plain.device)
    kernels.reset_launch_counts()
    with torch.no_grad():
        full = {m: logits_from_hidden(params["embed"], cfg,
                                      model.forward(params, batch)[0])
                for m, model in (("plain", plain), ("kernel", kern))}
        check(all(bool(torch.isfinite(t).all()) for t in full.values()),
              "non-finite logits")
        close_enough("f32 forward logits, kernels vs plain", full["kernel"],
                     full["plain"], LOGITS_TOL, LOGITS_TOL)
        logits, cache = kern.prefill(params,
                                     {"tokens": batch["tokens"][:, :prompt]})
        close_enough("f32 prefill logits vs forward", logits[:, 0],
                     full["kernel"][:, prompt - 1], LOGITS_TOL, LOGITS_TOL)
        cache = _grow_cache(cache, prompt + extra + 1)
        lengths = torch.full((2,), prompt, dtype=torch.int32,
                             device=plain.device)
        for t in range(extra):
            logits, cache = kern.decode_step(
                params, batch["tokens"][:, prompt + t:prompt + t + 1],
                cache, lengths)
            close_enough(f"f32 decode step {t} logits vs forward",
                         logits[:, 0], full["kernel"][:, prompt + t],
                         LOGITS_TOL, LOGITS_TOL)
            lengths = lengths + 1
    counts = kernels.launch_counts()
    check(counts["flash_attention"] == 2 * n_attn_invocations(cfg)
          and counts["ssd_scan"] == cfg.n_layers,
          f"kernel path of the f32 check: {counts}")
    del params, cache, full
    torch.cuda.empty_cache()


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
    launches.update(phase_lm_serve())
    phase_lm_outputs()
    phase_launches()
    say(f"[done] in {time.perf_counter() - t_start:.1f}s")
    say(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": rows[n]["source"],
         "replaces": rows[n]["replaces"], "launches": launches[n],
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
