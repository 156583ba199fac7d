"""Time the LM kernels against builds that sum their products the other way.

The two tensor-core kernels add each 3xTF32 product into an f32 sum in one
of two ways: straight into the mma accumulator (which truncates as it
adds), or step by step, each 8-wide step from zero and then added in f32
(``tf32::mma3_add``). ``flash_attention.cu`` sums step by step (its sums
grow with the key axis); ``ssd_scan.cu`` keeps one accumulator (its sums
run over one chunk). This script builds, from a copy of the sources, each
kernel with the other choice (into ``build/variants/``), and prints for
both builds, twice in turn: the time at zamba2's served shapes (CUDA
events, L2 flushed, as ``chip_smoke.py`` times), the error against the
plain version there, and flash attention's error against exact (float64)
attention at L 8192 with q and k scaled by 4. Then SDPA's f32 time.

Needs a CUDA card and nvcc:

    python3 tools/lm_kernel_variants.py
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on sys.path)
import torch  # noqa: E402

from repro_torch.kernels import cuda_lib  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_ref)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref  # noqa: E402

NAMES = ("flash_attention", "ssd_scan")
# the other summation: flash's O += P V in one accumulator; SSD's every
# product step by step
SWAPS = {"flash_attention": ("tf32::mma3_add(acc[n], a, bf);",
                             "tf32::mma3(acc[n], a, bf);"),
         "ssd_scan": ("tf32::mma3(", "tf32::mma3_add(")}


def build_variants(out: Path) -> dict:
    shutil.rmtree(out, ignore_errors=True)
    (out / "csrc").mkdir(parents=True)
    for f in cuda_lib.CSRC.iterdir():
        shutil.copy(f, out / "csrc" / f.name)
    procs = {}
    for name in NAMES:
        src = out / "csrc" / cuda_lib.SOURCES[name]
        old, new = SWAPS[name]
        text = src.read_text()
        if old not in text:
            sys.exit(f"{name}: {old!r} not in the source")
        src.write_text(text.replace(old, new))
        procs[name] = subprocess.Popen(
            [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, "-o",
             str(out / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"nvcc failed for the {name} variant:\n{log}")
    return {n: ctypes.CDLL(str(out / f"lib{n}.so")) for n in NAMES}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    tree = {n: ctypes.CDLL(str(p)) for n, p in cuda_lib.build(NAMES).items()}
    other = build_variants(ROOT / "build" / "variants")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    flush = torch.empty(512 * 2 ** 20, dtype=torch.uint8, device="cuda")
    (q, k, v), args, chunk = cs.lm_kernel_inputs()
    g = torch.Generator().manual_seed(7)
    ql, kl, vl = (torch.randn(1, 8192, h, 64, generator=g).cuda()
                  for h in (2, 1, 1))
    ql, kl = 4 * ql, 4 * kl
    exact = attention_ref(*(t.expand(-1, -1, 2, -1).permute(0, 2, 1, 3)[0]
                            .double() for t in (ql, kl, vl)))
    exact = exact.permute(1, 0, 2)[None]
    plain_err = (flash_attention_ref(ql, kl, vl).double() - exact).abs().max()
    print(f"flash plain f32, L 8192 peaked, vs exact: {plain_err.item():.3e}")
    ref_f, ref_s = flash_attention_ref(q, k, v), ssd_scan_ref(*args)
    labels = {"tree": "flash step by step, ssd one accumulator",
              "other": "flash P V in one accumulator, ssd step by step"}
    for rnd in range(2):
        for label, libs in (("tree", tree), ("other", other)):
            cuda_lib._LIBS.update(libs)
            e_f = (flash_attention(q, k, v) - ref_f).abs().max().item()
            e_l = (flash_attention(ql, kl, vl).double()
                   - exact).abs().max().item()
            e_s = (ssd_scan(*args, chunk=chunk) - ref_s).abs().max().item()
            t_f = cs.time_ms(lambda: flash_attention(q, k, v), 20, flush)
            t_s = cs.time_ms(lambda: ssd_scan(*args, chunk=chunk), 20,
                             flush)
            print(f"round {rnd} {label} ({labels[label]}): flash "
                  f"{t_f:.4f} ms, max|d| vs plain {e_f:.3e}, L 8192 peaked "
                  f"vs exact {e_l:.3e}; ssd {t_s:.4f} ms, max|d| vs plain "
                  f"{e_s:.3e}")
    cuda_lib._LIBS.update(tree)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    t_sdpa = cs.time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 20, flush)
    print(f"SDPA f32 (is_causal=True): {t_sdpa:.4f} ms")


if __name__ == "__main__":
    main()
