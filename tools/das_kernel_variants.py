"""Time the tiled DAS loop at each pixel tile, and against builds of it
that differ in one respect.

At the paper's geometry (batch 4, the real delay tables, IQ demodulated
from seeded RF) it prints, twice in turn:

- the tree's build: ``das_beamform`` (f32 and bf16, its tile of 64
  pixels) and both fused spans (f32) at each of their pixel tiles, 64,
  128 and 256;
- ``das_beamform`` (f32 and bf16; both fused spans, f32, for the variants
  of ``fused_pipeline.cu``) from builds made from a copy of the sources
  (into ``build/variants_das/``), each swapping pieces of text of the CUDA
  sources:
  - ``tile 128``, ``tile 256``: ``das_beamform`` built for that pixel
    tile (the tree: 64);
  - ``all terms``: no (pixel, channel) of zero apodization skipped, and
    windows over every pixel of a tile;
  - ``skip per pixel``: runs of one pixel skipped where apod is 0 (the
    tree: runs of 2, all zero);
  - ``launch order``: tiles in block order (the tree pairs the tiles past
    the first SM-count blocks from the far end, heavy with light);
  - ``8-byte copies``: IQ rows staged 8 bytes a thread (the tree: 16);
  - ``two stages``, ``four stages``: a ring of two buffers of 136 IQ rows
    and 1024 table entries, or four of 64 and 512 (the tree: three of 88
    and 640);
  - ``one channel per group``: each stage holds one channel (the tree
    packs as many as fit);
  - ``half stage``: stage buffers of 44 IQ rows instead of 88;
  - ``no staging``: every window read from global memory (L2), as the
    loop does for a window wider than a stage;
  - ``two acquisitions per block``: half the sums per thread, so three
    blocks share an SM (stages of 56 rows and 512 table entries);
  - ``demod 64 columns``: demod blocks of 64 (channel, frame) columns,
    twice the shared memory, instead of 32;
  - ``power frame loop``: the power head's frame loop (a pass of the DAS
    loop per 32 frames into a scratch in global memory, then the filter
    from there), which the tree runs only past 32 frames, at every n_f
    (the tree: one pass, the filter across lanes);
  - ``power no filter`` (diagnostic, wrong result): the power head's wall
    filter and frame sum left out;
  - diagnostics (wrong results): ``plan only`` (windows and groups, then
    return), ``staging only`` (the ring of copies, no terms), ``loads
    only`` (each term's shared-memory loads, 6 of its 16 operations),
    ``arithmetic only`` (each term's operations on values in registers).

Each time is a mean of CUDA events around 20 launches with the L2 cache
flushed before each (as ``chip_smoke.py`` times), beside the f32 error
against the plain version. Needs a CUDA card and nvcc:

    python3 tools/das_kernel_variants.py
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on sys.path)
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (consts_from_numpy, init_pipeline,  # noqa: E402
                              paper_config)
from repro_torch.data import synth_rf  # noqa: E402
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels.das_beamform import (das_beamform,  # noqa: E402
                                              das_beamform_ref)
from repro_torch.kernels.fused_pipeline import (  # noqa: E402
    fused_rf_to_envelope, fused_rf_to_power)
from repro_torch.kernels.fused_pipeline.ops import PIXEL_TILES  # noqa: E402
from repro_torch.kernels.fused_pipeline.ref import (  # noqa: E402
    demod_ref, fused_ref)

NAME = "das_beamform"
FUSED = "fused_pipeline"
HEADER = "das_common.cuh"
# label -> (library, [(source file, text, replacement)])
TILE = "constexpr int kBp = 64;"
SWAPS = {
    "tile 128": (NAME, [("das_beamform.cu", TILE,
                         "constexpr int kBp = 128;")]),
    "tile 256": (NAME, [("das_beamform.cu", TILE,
                         "constexpr int kBp = 256;")]),
    "all terms": (NAME, [
        (HEADER, "if (__ldg(a.apod + base + e) != 0.0f) {", "{"),
        (HEADER, "if (!any) continue;", "(void)any;")]),
    "skip per pixel": (NAME, [
        (HEADER, "constexpr int kRun = 2;", "constexpr int kRun = 1;")]),
    "launch order": (NAME, [
        (HEADER, "if (b >= n_sm) b = n - 1 - (b - n_sm);", "(void)n;")]),
    "8-byte copies": (NAME, [
        (HEADER, "const bool wide = a.n_f % 2 == 0 &&",
         "const bool wide = false &&")]),
    "two stages": (NAME, [
        (HEADER, "constexpr int kStages = 3;", "constexpr int kStages = 2;"),
        (HEADER, "constexpr int kStageRows = 88;",
         "constexpr int kStageRows = 136;"),
        (HEADER, "constexpr int kTabEntries = 640;",
         "constexpr int kTabEntries = 1024;")]),
    "four stages": (NAME, [
        (HEADER, "constexpr int kStages = 3;", "constexpr int kStages = 4;"),
        (HEADER, "constexpr int kStageRows = 88;",
         "constexpr int kStageRows = 64;"),
        (HEADER, "constexpr int kTabEntries = 640;",
         "constexpr int kTabEntries = 512;")]),
    "plan only": (NAME, [
        ("das_beamform.cu", "  das::Acc<BP> acc;\n  das::accumulate",
         "  if (b0 >= 0) return;\n  das::Acc<BP> acc;\n  das::accumulate")]),
    "staging only": (NAME, [
        (HEADER, "channel_terms<P, BP, false>(a, s, c, c - first",
         "if (c < 0) channel_terms<P, BP, false>(a, s, c, c - first")]),
    "loads only": (NAME, [
        (HEADER, """        const float vr = s0.x * w0 + s1.x * w1;
        const float vi = s0.y * w0 + s1.y * w1;
        const float re = vr * e[k].x - vi * e[k].y;
        const float im = vr * e[k].y + vi * e[k].x;""",
         "        const float re = s0.x + s1.x, im = s0.y + s1.y;")]),
    "arithmetic only": (NAME, [
        (HEADER, """          s0 = q[acq[j]];
          s1 = q[acq[j] + step];""", """          s0 = make_float2(w0 + j, e[k].x);
          s1 = make_float2(w1, e[k].y + (float)(size_t)q);""")]),
    "one channel per group": (NAME, [
        (HEADER, "count == kTabEntries / BP ||", "count == 1 ||")]),
    "half stage": (NAME, [
        (HEADER, "constexpr int kStageRows = 88;",
         "constexpr int kStageRows = 44;")]),
    "no staging": (NAME, [
        (HEADER, "constexpr int kStageRows = 88;",
         "constexpr int kStageRows = 0;")]),
    "two acquisitions per block": (NAME, [
        (HEADER, "static constexpr int kBb = 32 / kPpw;",
         "static constexpr int kBb = kPpw < 16 ? 16 / kPpw : 1;"),
        (HEADER, "constexpr int kStageRows = 88;",
         "constexpr int kStageRows = 56;"),
        (HEADER, "constexpr int kTabEntries = 640;",
         "constexpr int kTabEntries = 512;"),
        ("das_beamform.cu", "__launch_bounds__(das::kThreads, 2)",
         "__launch_bounds__(das::kThreads, 3)")]),
    "power no filter": (FUSED, [
        ("fused_pipeline.cu",
         "wall_power_lanes(acc[pp], wall, n_wall, a.n_f - n_wall + 1, "
         "r0);",
         "for (int j = 0; j < kBb; ++j) r0[j] = acc[pp][j].x;")]),
    "demod 64 columns": (FUSED, [
        ("fused_pipeline.cu", "constexpr int kDemodCols = 32;",
         "constexpr int kDemodCols = 64;"),
        ("fused_pipeline.cu", "constexpr int kDemodMaxOut = 4;",
         "constexpr int kDemodMaxOut = 8;")]),
    "power frame loop": (FUSED, [
        ("fused_pipeline.cu", "constexpr int kOnePassFrames = das::kFrames;",
         "constexpr int kOnePassFrames = 0;")]),
}


def build_variants(out: Path) -> dict:
    shutil.rmtree(out, ignore_errors=True)
    procs = {}
    for label, (lib, swaps) in SWAPS.items():
        d = out / label.replace(" ", "_")
        (d / "csrc").mkdir(parents=True)
        for f in cuda_lib.CSRC.iterdir():
            shutil.copy(f, d / "csrc" / f.name)
        for fname, old, new in swaps:
            src = d / "csrc" / fname
            text = src.read_text()
            if old not in text:
                sys.exit(f"{label}: {old!r} not in {fname}")
            src.write_text(text.replace(old, new))
        procs[label] = (subprocess.Popen(
            [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-o",
             str(d / f"lib{lib}.so"), str(d / "csrc" / cuda_lib.SOURCES[lib])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            d, lib)
    libs = {}
    for label, (proc, d, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"nvcc failed for {label}:\n{log}")
        regs = sorted({int(ln.split("Used ")[1].split()[0])
                       for ln in log.splitlines() if "registers" in ln})
        print(f"[build] {label}: registers {regs}")
        libs[label] = (lib, ctypes.CDLL(str(d / f"lib{lib}.so")))
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    tree = {lib: ctypes.CDLL(str(path))
            for lib, path in cuda_lib.build((NAME, FUSED)).items()}
    libs = build_variants(ROOT / "build" / "variants_das")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    cfg = paper_config(variant="dynamic", modality="power_doppler")
    c = consts_from_numpy(init_pipeline(cfg), dev)
    rf = torch.as_tensor(np.stack([synth_rf(cfg, seed=s)
                                   for s in range(cs.BATCH)])).to(dev)
    iq = demod_ref(c["carrier"], c["lpf"], rf, cfg.decim)
    tabs = [c[n] for n in cs.DAS_TABLES]
    ft = [c[n] for n in cs.TABLES]
    plain = das_beamform_ref(*tabs, iq)
    scale = plain.abs().max().item()
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=dev)

    def err(out):
        return (out - plain).abs().max().item() / scale

    env_plain = fused_ref(*ft, rf, decim=cfg.decim)
    pow_plain = fused_ref(*ft, rf, decim=cfg.decim, head="power_doppler",
                          wall=c["wall_taps"])

    def rel(out, ref):
        return (out - ref).abs().max().item() / ref.abs().max().item()

    def das_times():
        return {p: cs.time_ms(lambda: das_beamform(*tabs, iq, precision=p),
                              20, flush) for p in ("f32", "bf16")}

    for rnd in range(2):
        cuda_lib._LIBS.update(tree)
        t = das_times()
        print(f"round {rnd} tree: das_beamform bp 64 f32 {t['f32']:.4f} ms "
              f"(max|d|/max {err(das_beamform(*tabs, iq)):.2e}), bf16 "
              f"{t['bf16']:.4f} ms")
        for bp in PIXEL_TILES:
            env = cs.time_ms(lambda: fused_rf_to_envelope(
                *ft, rf, decim=cfg.decim, bp=bp), 20, flush)
            pw = cs.time_ms(lambda: fused_rf_to_power(
                *ft, c["wall_taps"], rf, decim=cfg.decim, bp=bp), 20, flush)
            print(f"round {rnd} tree bp {bp}: fused envelope {env:.4f} ms, "
                  f"power {pw:.4f} ms")
        for label, (lib, handle) in libs.items():
            cuda_lib._LIBS.update(tree)
            cuda_lib._LIBS[lib] = handle
            if lib == NAME:
                t = das_times()
                what = (f"das_beamform f32 {t['f32']:.4f} ms (max|d|/max "
                        f"{err(das_beamform(*tabs, iq)):.2e}), bf16 "
                        f"{t['bf16']:.4f} ms")
            else:
                env = cs.time_ms(lambda: fused_rf_to_envelope(
                    *ft, rf, decim=cfg.decim), 20, flush)
                pw = cs.time_ms(lambda: fused_rf_to_power(
                    *ft, c["wall_taps"], rf, decim=cfg.decim), 20, flush)
                e_env = rel(fused_rf_to_envelope(*ft, rf, decim=cfg.decim),
                            env_plain)
                e_pow = rel(fused_rf_to_power(*ft, c["wall_taps"], rf,
                                              decim=cfg.decim), pow_plain)
                what = (f"fused bp 64 f32 envelope {env:.4f} ms (max|d|/max "
                        f"{e_env:.2e}), power {pw:.4f} ms ({e_pow:.2e})")
            print(f"round {rnd} {label}: {what}")
    cuda_lib._LIBS.update(tree)


if __name__ == "__main__":
    main()
