"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles to its own shared library with a plain
C interface, for ``sm_90a``, into ``<repo>/build/kernels/`` at first use.
The library's file name carries a hash of its sources and flags, so an
edited source is never served by a stale build. ``build()`` starts one
nvcc per missing library, all at once, and waits for every one of them.

Flags: no ``--use_fast_math`` (sqrtf stays correctly rounded: the
envelope feeds ``ln_approx``'s 16 square roots) and ``-fmad=false`` (each
pointwise product rounds as in the plain PyTorch version).

Nothing here runs at import: modules import this on every platform, and
only a wrapper given a CUDA tensor reaches ``kernel_fn``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {"das_beamform": "das_beamform.cu",
           "fused_pipeline": "fused_pipeline.cu",
           "bsr_spmm": "bsr_spmm.cu",
           "flash_attention": "flash_attention.cu",
           "ssd_scan": "ssd_scan.cu"}
HEADERS = ("das_common.cuh", "tf32_mma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels are built from source at first use")
    return path


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<SOURCES[name]>`` lives once built."""
    h = hashlib.sha256()
    for fname in (SOURCES[name],) + HEADERS:
        h.update((CSRC / fname).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile every named library not built yet, in parallel."""
    names = tuple(names)
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode == 0:
            _log_path(target).write_text(log)
            os.replace(tmp, target)   # atomic: no reader sees a partial .so
        else:
            failed.append(f"--- {name} ---\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def _log_path(target: Path) -> Path:
    return target.with_name(target.name + ".log")


def build_log(name: str) -> str:
    """nvcc's output for a built library, with ptxas' registers, shared
    memory and spills per kernel."""
    return _log_path(library_path(name)).read_text()


def kernel_fn(name: str, symbol: str, argtypes: Sequence,
              restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of library ``name`` (built and loaded once)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build((name,))[name]))
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def check_launch(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (it returns cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error code {rc}")


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
            device: torch.device) -> None:
    """Validate one kernel operand: device, dtype, shape, contiguity."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def refuse_grad(what: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would need a gradient through a kernel.

    The kernels fill their outputs through ctypes, so a backward would
    drop those gradients without an error; the reference has no backward
    for its Pallas kernels either, and trains with both kernel flags off
    (ROADMAP queue C). Both devices refuse alike: on the CPU the plain
    version could differentiate, and the two would disagree."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"{what} has no backward (nor has the reference's Pallas "
            "kernel; ROADMAP queue C): train with use_flash_kernel and "
            "use_ssd_kernel off, or call it under torch.no_grad()")
