"""Time bsr_beamform against builds of it that differ in one respect.

Built from a copy of the sources (into ``build/variants_bsr/``), each
variant swaps one piece of text of ``csrc/bsr_spmm.cu``:

- ``one accumulator``: the products go straight into the f32 sums (the
  tensor cores truncate as they add), not each staged unit from zero;
- ``one channel group``: each output tile in one thread block, the
  channels not split over blocks; ``eight channel groups``: up to 8
  groups, for a grid of about 2048 blocks (the tree: 4 and 1024);
- ``groups from the grid``: the channel groups counted from every
  column tile of the batch (the tree counts them from one column tile,
  so an acquisition sums in the same order in any batch; the two differ
  from batch 5 on at 32 frames);
- ``loads only`` (diagnostic, wrong result): the ring is filled and
  waited on, no product is taken;
- ``products only`` (diagnostic, wrong result): the first unit is staged,
  every later unit multiplies whatever the ring holds.

At the paper's geometry (the real operator, seeded IQ; batch 4, or each
``--batch``) it prints, for the tree's build and each variant (or each
``--variant``), twice in turn: the f32 and
bf16 times (CUDA events, L2 flushed, as ``chip_smoke.py`` times) and the
f32 error against the plain version in float64, beside the plain f32
version's own, and the bf16 error against the plain bf16 version.

Needs a CUDA card and nvcc:

    python3 tools/bsr_kernel_variants.py
    python3 tools/bsr_kernel_variants.py --batch 4 --batch 5 --batch 8 \
        --variant "groups from the grid"
"""

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on sys.path)
import torch  # noqa: E402

from repro_torch.core import (consts_from_numpy, init_pipeline,  # noqa: E402
                              paper_config)
from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels.bsr_spmm import (block_sample_axis,  # noqa: E402
                                          bsr_beamform, bsr_beamform_ref)

NAME = "bsr_spmm"
NO_LOADS = [("if (lq < walk.n_q) stage(lq, lsc, st ^ 1);",
             "if (lq < 0) stage(lq, lsc, st ^ 1);")]
SWAPS = {
    "one accumulator": [("float part[kMT][kNT][4] = {};",
                         "auto& part = acc;"),
                        ("acc[mt][nt][e] += part[mt][nt][e];", "(void)e;")],
    "one channel group": [("constexpr int kMaxParts = 4;",
                           "constexpr int kMaxParts = 1;")],
    "eight channel groups": [("constexpr int kMaxParts = 4;",
                              "constexpr int kMaxParts = 8;"),
                             ("constexpr int kTargetBlocks = 1024;",
                              "constexpr int kTargetBlocks = 2048;")],
    "loads only": [("unit_product<P>(part,",
                    "if (sc < 0) unit_product<P>(part,")],
    "products only": NO_LOADS,
    "groups from the grid": [(
        "const long long base = (long long)g.row_tiles * n_pb;",
        "const long long base = g.tiles() * n_pb;")],
}


def build_variants(out: Path, labels) -> dict:
    shutil.rmtree(out, ignore_errors=True)
    procs = {}
    for label in labels:
        swaps = SWAPS[label]
        d = out / label.replace(" ", "_")
        (d / "csrc").mkdir(parents=True)
        for f in cuda_lib.CSRC.iterdir():
            shutil.copy(f, d / "csrc" / f.name)
        src = d / "csrc" / cuda_lib.SOURCES[NAME]
        text = src.read_text()
        for old, new in swaps:
            if old not in text:
                sys.exit(f"{label}: {old!r} not in the source")
            text = text.replace(old, new)
        src.write_text(text)
        procs[label] = (subprocess.Popen(
            [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-o",
             str(d / f"lib{NAME}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d)
    libs = {}
    for label, (proc, d) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"nvcc failed for {label}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"[build] {label}: {regs}")
        libs[label] = ctypes.CDLL(str(d / f"lib{NAME}.so"))
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, action="append",
                    help="acquisitions a call (repeatable; default "
                    f"{cs.BATCH})")
    ap.add_argument("--variant", action="append", choices=sorted(SWAPS),
                    help="variants to build (repeatable; default all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    libs = {"tree": ctypes.CDLL(str(cuda_lib.build((NAME,))[NAME]))}
    libs.update(build_variants(ROOT / "build" / "variants_bsr",
                               args.variant or list(SWAPS)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    cfg = paper_config(variant="sparse")
    c = consts_from_numpy(init_pipeline(cfg), dev)
    cols, blocks = c["bsr_col_idx"], c["bsr_blocks"]
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=dev)
    for batch in args.batch or [cs.BATCH]:
        g = torch.Generator(device=dev).manual_seed(0)
        iq = 1e3 * torch.randn(batch, cfg.n_s, cfg.n_c, cfg.n_f, 2,
                               generator=g, device=dev)
        iq_b = block_sample_axis(iq, cfg.sparse_block_s)
        exact = bsr_beamform_ref(cols, blocks.double(), iq_b.double())
        plain = (bsr_beamform_ref(cols, blocks, iq_b).double() - exact)
        print(f"batch {batch}: plain f32 vs float64: max|d|="
              f"{plain.abs().max().item():.3e} "
              f"(max|exact|={exact.abs().max().item():.3e})")
        plain16 = bsr_beamform_ref(cols, blocks, iq_b, precision="bf16")
        for rnd in range(2):
            for label, lib in libs.items():
                cuda_lib._LIBS[NAME] = lib
                err = (bsr_beamform(cols, blocks, iq_b).double()
                       - exact).abs().max().item()
                err16 = (bsr_beamform(cols, blocks, iq_b, precision="bf16")
                         - plain16).abs().max().item()
                times = {p: cs.time_ms(lambda: bsr_beamform(
                    cols, blocks, iq_b, precision=p), 20, flush)
                    for p in ("f32", "bf16")}
                print(f"batch {batch} round {rnd} {label}: f32 "
                      f"{times['f32']:.4f} ms, bf16 {times['bf16']:.4f} "
                      f"ms, f32 max|d| vs float64 {err:.3e}, bf16 max|d| "
                      f"vs plain bf16 {err16:.3e}")
        del iq, iq_b, exact, plain, plain16
    cuda_lib._LIBS[NAME] = libs["tree"]


if __name__ == "__main__":
    main()
