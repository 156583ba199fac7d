"""Public wrappers for the BSR SpMM CUDA kernels (csrc/bsr_spmm.cu).

`bsr_spmm` is the real primitive, `bsr_beamform` the complex
multi-channel beamform of the sparse variant in one launch.
`block_sample_axis` cuts the IQ sample axis into the operator's sample
blocks. The kernel itself refuses a block structure it cannot take (a
staged tile larger than shared memory, more than 65535 pixel blocks);
the wrapper then raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.bsr_spmm.ref import bsr_beamform_ref, bsr_spmm_ref
from repro_torch.kernels.das_beamform.ops import PRECISION_CODES

_P, _I = ctypes.c_void_p, ctypes.c_int


def next_multiple(x: int, m: int) -> int:
    """Smallest multiple of ``m`` >= ``x``."""
    return -(-x // m) * m


def block_sample_axis(iq: torch.Tensor, bs: int) -> torch.Tensor:
    """(..., n_s, n_c, n_f, 2) -> (..., n_sb, bs, n_c, n_f, 2).

    Zero-pads the sample axis to a multiple of ``bs``. The padding is
    exact: padded samples only meet all-zero operator blocks.
    """
    n_s = iq.shape[-4]
    pad = next_multiple(n_s, bs) - n_s
    if pad:
        iq = F.pad(iq, (0, 0, 0, 0, 0, 0, 0, pad))
    return iq.reshape(iq.shape[:-4] + (-1, bs) + iq.shape[-3:])


def _launch(symbol, cols, blocks, x, out, dims, precision):
    dev = x.device
    fn = cuda_lib.kernel_fn("bsr_spmm", symbol,
                            [_P] * 4 + [_I] * (len(dims) + 2) + [_P])
    rc = fn(cols.data_ptr(), blocks.data_ptr(), x.data_ptr(),
            out.data_ptr(), *dims, PRECISION_CODES[precision], dev.index,
            cuda_lib.stream_of(dev))
    cuda_lib.check_launch(rc, symbol)


def _check(precision, x):
    if precision not in PRECISION_CODES:
        raise ValueError(f"unknown precision {precision!r}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bsr_spmm runs on cuda or cpu, not "
                         f"{x.device.type}")


def bsr_spmm(cols, blocks, x, *, precision: str = "f32"):
    """y[i] = sum_k blocks[i,k] @ x[cols[i,k]] (real).

    Args:
      cols:   (n_pb, K) int32 block-column indices.
      blocks: (n_pb, K, bp, bs) f32.
      x:      (n_sb, bs, nf) f32.
      precision: "f32" | "bf16" | "f16" — both operands are rounded to
        it; accumulation is f32.
    Returns:
      (n_pb, bp, nf) f32. A CPU ``x`` runs the plain version
      (``bsr_spmm_ref``); a CUDA ``x`` launches the kernel or raises.
    """
    n_pb, k, bp, bs = blocks.shape
    _check(precision, x)
    if x.device.type == "cpu":
        return bsr_spmm_ref(cols, blocks, x, precision=precision)
    dev = x.device
    n_sb, _, nf = x.shape
    cuda_lib.require(x, "x", torch.float32, (n_sb, bs, nf), dev)
    cuda_lib.require(cols, "cols", torch.int32, (n_pb, k), dev)
    cuda_lib.require(blocks, "blocks", torch.float32, (n_pb, k, bp, bs), dev)
    out = torch.empty((n_pb, bp, nf), dtype=torch.float32, device=dev)
    _launch("bsr_spmm_launch", cols, blocks, x, out,
            (n_pb, k, bp, bs, n_sb, nf), precision)
    bsr_spmm.launches += 1
    return out


def bsr_beamform(cols, blocks, iq_b, *, precision: str = "f32"):
    """Complex beamform of a batch through the BSR operator, summed over
    channels, in one launch.

    Args:
      cols:   (n_c, n_pb, K) int32.
      blocks: (n_c, n_pb, K, bp, bs, 2) f32 (complex as trailing re/im).
      iq_b:   (B, n_sb, bs, n_c, n_f, 2) f32 blocked IQ.
      precision: "f32" | "bf16" | "f16" — both operands are rounded to
        it; accumulation is f32.
    Returns:
      (B, n_pb * bp, n_f, 2) f32. A CPU ``iq_b`` runs the plain version
      (``bsr_beamform_ref``); a CUDA ``iq_b`` launches the kernel or
      raises.
    """
    n_c, n_pb, k, bp, bs, _ = blocks.shape
    _check(precision, iq_b)
    if iq_b.device.type == "cpu":
        return bsr_beamform_ref(cols, blocks, iq_b, precision=precision)
    dev = iq_b.device
    b, n_sb, _, _, n_f, _ = iq_b.shape
    cuda_lib.require(iq_b, "iq_b", torch.float32, (b, n_sb, bs, n_c, n_f, 2),
                     dev)
    cuda_lib.require(cols, "cols", torch.int32, (n_c, n_pb, k), dev)
    cuda_lib.require(blocks, "blocks", torch.float32,
                     (n_c, n_pb, k, bp, bs, 2), dev)
    out = torch.empty((b, n_pb * bp, n_f, 2), dtype=torch.float32,
                      device=dev)
    _launch("bsr_beamform_launch", cols, blocks, iq_b, out,
            (b, n_c, n_pb, k, bp, bs, n_sb, n_f), precision)
    bsr_beamform.launches += 1
    return out


bsr_spmm.launches = 0       # kernel launches since the last reset
bsr_beamform.launches = 0
