#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check it.

Run from the repository root on a machine with a CUDA device:

    python3 chip_smoke.py

Phases (each prints its results; any failure exits non-zero before the
last line):
  1. device  — card name, count, `nvidia-smi` name and power limit;
  2. build   — nvcc builds every kernel library (one nvcc per source, in
               parallel) and prints ptxas' registers / shared memory;
  3. kernels — at the paper's geometry, batch 4, each kernel against its
               plain PyTorch version on the same inputs (seeded synthetic
               RF, the real delay tables), then timed with CUDA events
               (L2 flushed before each launch) beside its bound;
  4. serve   — `serve_ultrasound_stream` at the paper's geometry for
               B-mode and power Doppler, per stage and fused, with the
               launch counters zeroed before and read after each run;
  5. outputs — images from the card against the plain pipeline (paper
               geometry, on the card) and against the CPU (small input);
  6. a JSON line {"kernels": [...]} and, last, the device line.

Needs only this checkout (it puts src/ on sys.path) and imports no JAX.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch  # noqa: E402,F401  (sets the TF32 switches)
from repro_torch import kernels  # noqa: E402
from repro_torch.core import (BatchedExecutor, PRECISION_TOLERANCES,  # noqa: E402
                              Modality, consts_from_numpy, init_pipeline,
                              monolithic_pipeline_fn, paper_config,
                              tiny_config)
from repro_torch.core import demod  # noqa: E402
from repro_torch.data import synth_rf  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels.das_beamform import (das_beamform,  # noqa: E402
                                              das_beamform_ref)
from repro_torch.kernels.fused_pipeline import (  # noqa: E402
    fused_ref, fused_rf_to_envelope, fused_rf_to_power)
from repro_torch.launch.serve import (SyntheticAcquisitionSource,  # noqa: E402
                                      serve_ultrasound_stream)

# NVIDIA H100 SXM data sheet: HBM rate, f32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

BATCH = 4
N_BATCHES = 16
F32_TOL = 1e-5          # max|kernel - plain| / max|plain|, see test_torch_gpu
IMAGE_TOL = {"bmode": 1.2e-3, "power_doppler": 1e-4}   # test_torch_slice
TABLES = ("carrier", "lpf", "idx", "frac", "apod", "rot")
DAS_TABLES = ("idx", "frac", "apod", "rot")


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


def bound(nbytes: float, flops: float) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    return name


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = cuda_lib.build()
    say(f"[build] {len(paths)} libraries in "
        f"{time.perf_counter() - t0:.1f}s (nvcc {cuda_lib.NVCC_FLAGS})")
    for name in paths:
        for line in cuda_lib.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                say(f"[build] {name}: {line.strip()}")


def phase_kernels(source) -> dict:
    dev = torch.device("cuda")
    cfg = paper_config(variant="dynamic", modality="power_doppler")
    c = consts_from_numpy(init_pipeline(cfg), dev)
    rf = torch.as_tensor(source.next()).to(dev)
    b, n_l, n_c, n_f = rf.shape
    n_pix, n_s, k = cfg.n_pix, -(-n_l // cfg.decim), c["lpf"].shape[0]
    n_wall = c["wall_taps"].shape[0]
    iq = demod.rf_to_iq(c, rf, cfg.decim)
    tabs = [c[n] for n in DAS_TABLES]
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows = {}

    # das_beamform: f32 against the f32 plain version, reduced precision
    # against the plain version at the same precision (PRECISION_TOLERANCES).
    for prec in ("f32", "bf16", "f16"):
        out = das_beamform(*tabs, iq, precision=prec)
        ref = das_beamform_ref(*tabs, iq, precision=prec)
        err, scale = max_err(out, ref)
        if prec == "f32":
            tol = F32_TOL * scale
        else:
            rtol, atol = PRECISION_TOLERANCES[(prec, Modality.BMODE)]
            tol = atol * scale
            check(bool(((out - ref).abs() <= tol + rtol * ref.abs()).all()),
                  f"das_beamform[{prec}] outside PRECISION_TOLERANCES")
        say(f"[kernels] das_beamform[{prec}] max|d|={err:.3e} "
            f"tol={tol:.3e} (max|plain|={scale:.3e})")
        check(err <= tol, f"das_beamform[{prec}] disagrees with plain")
        if prec == "f32":
            das_err = err
    tab_bytes = n_pix * n_c * (4 + 4 + 4 + 8)
    rf_bytes = rf.numel() * 2
    das_flops = 16.0 * b * n_pix * n_c * n_f
    demod_flops = b * n_s * n_c * n_f * 4.0 * k + b * n_l * n_c * n_f * 2.0
    wall_flops = b * n_pix * (n_f - n_wall + 1) * (4.0 * n_wall + 4)
    rows["das_beamform"] = dict(
        err=das_err,
        fn=lambda: das_beamform(*tabs, iq),
        plain=lambda: das_beamform_ref(*tabs, iq),
        bound=bound(tab_bytes + iq.numel() * 4 + b * n_pix * n_f * 8,
                    das_flops),
        source="src/repro_torch/kernels/csrc/das_beamform.cu",
        replaces="src/repro/kernels/das_beamform/kernel.py:93")

    ft = [c[n] for n in TABLES]
    heads = {
        "fused_rf_to_envelope": (
            lambda: fused_rf_to_envelope(*ft, rf, decim=cfg.decim),
            lambda: fused_ref(*ft, rf, decim=cfg.decim),
            b * n_pix * n_f * 4, 3.0 * b * n_pix * n_f),
        "fused_rf_to_power": (
            lambda: fused_rf_to_power(*ft, c["wall_taps"], rf,
                                      decim=cfg.decim),
            lambda: fused_ref(*ft, rf, decim=cfg.decim,
                              head="power_doppler", wall=c["wall_taps"]),
            b * n_pix * 4, wall_flops),
    }
    for name, (fn, plain, out_bytes, head_flops) in heads.items():
        err, scale = max_err(fn(), plain())
        say(f"[kernels] {name} max|d|={err:.3e} tol={F32_TOL * scale:.3e} "
            f"(max|plain|={scale:.3e})")
        check(err <= F32_TOL * scale, f"{name} disagrees with plain")
        rows[name] = dict(
            err=err, fn=fn, plain=plain,
            bound=bound(rf_bytes + n_l * 8 + k * 4 + tab_bytes + out_bytes,
                        demod_flops + das_flops + head_flops),
            source="src/repro_torch/kernels/csrc/fused_pipeline.cu",
            replaces="src/repro/kernels/fused_pipeline/kernel.py:196")

    for name, row in rows.items():
        row["ms"] = time_ms(row["fn"], 20, flush)
        row["plain_ms"] = time_ms(row["plain"], 3, flush)
        say(f"[kernels] {name}: kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound'][0]:.4f} ms "
            f"({row['bound'][1]}), library: none computes this function")
    return rows


def phase_serve(source) -> dict:
    launches = {name: 0 for name in kernels.launch_counts()}
    fused_kernel = {"bmode": "fused_rf_to_envelope",
                    "power_doppler": "fused_rf_to_power"}
    for modality in ("bmode", "power_doppler"):
        for fusion in ("none", "fused"):
            cfg = paper_config(variant="dynamic", modality=modality,
                               fusion=fusion)
            kernels.reset_launch_counts()
            stats = serve_ultrasound_stream(
                cfg, batch=BATCH, n_batches=N_BATCHES, depth=2, pool=2,
                source=source)
            counts = kernels.launch_counts()
            plan = stats["plan"]
            lat = stats["latency"]
            peak = stats["resources"]["peak_memory_bytes"]
            say(f"[serve] {stats['name']} fusion={fusion}: "
                f"{stats['sustained_mbps']:.1f} MB/s, {stats['fps']:.1f} "
                f"FPS, p50={lat.p50_s * 1e3:.3f} ms, "
                f"p99={lat.p99_s * 1e3:.3f} ms, peak_mem={peak / 1e6:.1f} MB,"
                f" lowerings={plan['stage_lowerings']}, launches={counts}")
            key = ("das_beamform" if fusion == "none"
                   else fused_kernel[modality])
            check(plan["backend"] == "cuda", f"plan backend {plan}")
            check(plan["stage_lowerings"]["beamform"] == "pallas",
                  f"beamform lowering {plan['stage_lowerings']}")
            check(counts[key] > 0, f"{key} never launched in {stats['name']}")
            for name, n in counts.items():
                launches[name] += n
            split(cfg, source, stats)
    return launches


def split(cfg, source, stats) -> None:
    """Where one batch's time goes: host->device copy of the pageable RF
    batch (host clock) vs the engine on a device-resident batch (events)."""
    dev = torch.device("cuda")
    engine = BatchedExecutor(cfg)
    host = source.next()
    t = []
    for _ in range(5):
        t0 = time.perf_counter()
        x = torch.as_tensor(host).to(dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter() - t0)
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    engine(x)
    s.record()
    for _ in range(5):
        engine(x)
    e.record()
    torch.cuda.synchronize()
    say(f"[split] {stats['name']} fusion={cfg.fusion}: per batch of "
        f"{BATCH}: h2d {np.mean(t) * 1e3:.3f} ms, engine on device "
        f"{s.elapsed_time(e) / 5:.3f} ms, served "
        f"{stats['wall_s'] / N_BATCHES * 1e3:.3f} ms")


def phase_outputs(source) -> None:
    dev = torch.device("cuda")
    rf = source.next()
    for modality in ("bmode", "power_doppler"):
        for fusion in ("none", "fused"):
            cfg = paper_config(variant="dynamic", modality=modality,
                               fusion=fusion)
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
            say(f"[outputs] paper {modality}/{fusion} vs plain on card: "
                f"max|d|={d.max().item():.3e} (tol "
                f"{IMAGE_TOL[modality]:.1e}), >1e-5: {frac:.5f}")
            check(d.max().item() <= IMAGE_TOL[modality],
                  f"{modality}/{fusion} image disagrees with plain")
            small = tiny_config(variant="dynamic", modality=modality,
                                fusion=fusion, n_c=16, n_f=8, nz=32, nx=32)
            x = np.stack([synth_rf(small, seed=s) for s in (1, 2)])
            got = BatchedExecutor(small)(x).cpu()
            want = BatchedExecutor(small, device="cpu")(x)
            err = (got - want).abs().max().item()
            say(f"[outputs] small {modality}/{fusion} card vs cpu: "
                f"max|d|={err:.3e}")
            check(err <= IMAGE_TOL[modality], "card disagrees with cpu")


def main() -> None:
    name = phase_device()
    phase_build()
    t0 = time.perf_counter()
    source = SyntheticAcquisitionSource(
        paper_config(variant="dynamic"), BATCH, pool=2, seed=0)
    say(f"[source] {BATCH * 2} paper-geometry acquisitions in "
        f"{time.perf_counter() - t0:.1f}s")
    rows = phase_kernels(source)
    launches = phase_serve(source)
    phase_outputs(source)
    say(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": r["source"],
         "replaces": r["replaces"], "launches": launches[n],
         "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
         "library_ms": None}
        for n, r in rows.items()]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
