"""Time the real bsr_spmm kernel of this tree against another tree's.

Builds ``csrc/bsr_spmm.cu`` of this tree (as the wrapper does) and of the
tree at ``--other`` (a checkout, for example the parent commit unpacked
with ``git archive`` into ``build/``) into ``build/compare_bsr/``. Both
export ``bsr_spmm_launch`` with one signature, so the wrapper runs
either. At the two shapes ``chip_smoke.py`` times (``spmm_shapes``: (a)
the middle channel's real product at the paper's geometry, batch 4; (b)
the sparse beamform's real form, K 128, 128 x 128 blocks), on the real
operator and seeded IQ, it prints for each build, in turns (other, tree,
tree, other): the f32 and bf16 times (CUDA events, mean of 20, L2
flushed, as ``chip_smoke.py`` times), the f32 error against the plain
version in float64 beside the plain f32 version's own, and whether two
runs are bit-equal.

``--variant`` adds builds of this tree's source that differ in one
respect, timed in the same turns:

- ``raw hi, slot sums`` (a right result, less accurate): the f32 values
  go to the tensor cores raw as the hi parts (TF32 reads them
  truncated), lo = v - trunc(v), and a slot's units are summed in one
  accumulator before the f32 sums;
- ``no products``: every unit loaded and split, no wgmma issued;
- ``no split``: the operator tile is not split (f32) or rounded (bf16)
  after it lands.

Needs a CUDA card and nvcc:

    git archive HEAD | tar -x -C build/parent    # the other tree
    python3 tools/bsr_spmm_compare.py --other build/parent
    python3 tools/bsr_spmm_compare.py --shape a  # this tree alone
    python3 tools/bsr_spmm_compare.py --variant "no products"
"""

import argparse
import ctypes
import re
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
                                          bsr_spmm, bsr_spmm_ref)

NAME = "bsr_spmm"
OUT = ROOT / "build" / "compare_bsr"
SWAPS = {
    "no products": [("wgmma_tf32<N>(part,",
                     "if (n_units < 0) wgmma_tf32<N>(part,")],
    "raw hi, slot sums": [
        ("__device__ __forceinline__ void wgmma_fence() {",
         "__device__ __forceinline__ float trunc_lo(float v) {\n"
         "  return v - __uint_as_float(__float_as_uint(v) & 0xffffe000u);\n"
         "}\n__device__ __forceinline__ void wgmma_fence() {"),
        ("""          const tf32::Split a = tf32::split(v.x), b = tf32::split(v.y),
                            c = tf32::split(v.z), d = tf32::split(v.w);
          hi[e] = make_float4(__uint_as_float(a.hi), __uint_as_float(b.hi),
                              __uint_as_float(c.hi), __uint_as_float(d.hi));
          lo[e] = make_float4(__uint_as_float(a.lo), __uint_as_float(b.lo),
                              __uint_as_float(c.lo), __uint_as_float(d.lo));""",
         """          lo[e] = make_float4(trunc_lo(v.x), trunc_lo(v.y),
                              trunc_lo(v.z), trunc_lo(v.w));"""),
        ("""            const tf32::Split sp = tf32::split(v);
            ah[ks][q] = sp.hi;
            al[ks][q] = sp.lo;""",
         """            ah[ks][q] = __float_as_uint(v);
            al[ks][q] = __float_as_uint(trunc_lo(v));"""),
        ("const int fresh = kk == 0 ? 0 : 1;",
         "const int fresh = u % n_chunks == 0 && kk == 0 ? 0 : 1;"),
        ("""#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[e] += part[e];   // into the f32 sums""",
         """    if (u % n_chunks == n_chunks - 1) {
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[e] += part[e];
    }""")],
    "no split": [("for (int q = 0; q < N / 16; ++q) {\n        const int e = tid",
                  "for (int q = 0; q < 0; ++q) {\n        const int e = tid")],
}


def build_all(sources: dict) -> dict:
    """nvcc for each (label: source) at once; label -> loaded library."""
    procs = {}
    for label, src in sources.items():
        out = OUT / f"lib{NAME}_{re.sub(r'\W+', '_', label)}.so"
        procs[label] = (subprocess.Popen(
            [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-o", str(out),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), out)
    libs = {}
    for label, (proc, out) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"nvcc failed for {label}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"[build] {label} ({sources[label]}): {regs}")
        libs[label] = ctypes.CDLL(str(out))
    return libs


def variant_source(label: str) -> Path:
    d = OUT / re.sub(r"\W+", "_", label)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_lib.CSRC, d)
    src = d / cuda_lib.SOURCES[NAME]
    text = src.read_text()
    for old, new in SWAPS[label]:
        if old not in text:
            sys.exit(f"{label}: {old!r} not in the source")
        text = text.replace(old, new)
    src.write_text(text)
    return src


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path,
                    help="root of another checkout whose bsr_spmm to time")
    ap.add_argument("--shape", action="append", choices=("a", "b"),
                    help="shapes to time (repeatable; default both)")
    ap.add_argument("--variant", action="append", choices=sorted(SWAPS),
                    default=[], help="diagnostic builds (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    tree = ctypes.CDLL(str(cuda_lib.build((NAME,))[NAME]))
    log = cuda_lib.build_log(NAME)
    print("[build] tree: "
          f"{[ln.strip() for ln in log.splitlines() if 'registers' in ln]}")
    OUT.mkdir(parents=True, exist_ok=True)
    sources = {label: variant_source(label) for label in args.variant}
    if args.other is not None:
        sources["other"] = (args.other / "src" / "repro_torch" / "kernels"
                            / "csrc" / cuda_lib.SOURCES[NAME])
    built = build_all(sources)
    libs = {"tree": tree}
    if "other" in built:
        libs = {"other": built.pop("other"), "tree": tree}
    libs.update(built)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    cfg = paper_config(variant="sparse")
    c = consts_from_numpy(init_pipeline(cfg), dev)
    g = torch.Generator(device=dev).manual_seed(0)
    iq = 1e3 * torch.randn(cs.BATCH, cfg.n_s, cfg.n_c, cfg.n_f, 2,
                           generator=g, device=dev)
    iq_b = block_sample_axis(iq, cfg.sparse_block_s)
    shapes, _ = cs.spmm_shapes(c["bsr_col_idx"], c["bsr_blocks"], iq_b)
    del c, iq, iq_b
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device=dev)
    order = list(libs) + list(reversed(libs))
    for shape in args.shape or ["a", "b"]:
        spmm = shapes[shape]
        cols, blocks, x = spmm
        bd = cs.spmm_bounds(cols, blocks, x)
        exact = bsr_spmm_ref(cols, blocks.double(), x.double())
        plain = (bsr_spmm_ref(*spmm).double() - exact).abs().max().item()
        print(f"({shape}) blocks {tuple(blocks.shape)}, x {tuple(x.shape)}; "
              f"stored bound {bd['stored'][0][0]:.4f} ms "
              f"({bd['stored'][0][1]}), occupied {bd['occupied'][0][0]:.4f} "
              f"ms ({bd['occupied'][0][1]}); plain f32 vs float64 "
              f"max|d|={plain:.3e} (max|exact|="
              f"{exact.abs().max().item():.3e})", flush=True)
        for turn, label in enumerate(order):
            cuda_lib._LIBS[NAME] = libs[label]
            out = bsr_spmm(*spmm)
            same = torch.equal(out, bsr_spmm(*spmm))
            err = (out.double() - exact).abs().max().item()
            del out
            times = {p: cs.time_ms(lambda: bsr_spmm(*spmm, precision=p),
                                   20, flush) for p in ("f32", "bf16")}
            print(f"({shape}) turn {turn} {label}: f32 {times['f32']:.4f} "
                  f"ms, bf16 {times['bf16']:.4f} ms, f32 max|d| vs float64 "
                  f"{err:.3e}, two runs bit-equal {same}", flush=True)
        del exact
    cuda_lib._LIBS[NAME] = tree


if __name__ == "__main__":
    main()
