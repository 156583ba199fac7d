"""Public wrappers for the BSR SpMM CUDA kernels (csrc/bsr_spmm.cu).

`bsr_spmm` is the real primitive (f32 SIMT, every stored slot summed),
`bsr_beamform` the complex multi-channel beamform of the sparse variant
in one launch, on the tensor cores, skipping the padded K slots.
`block_sample_axis` cuts the IQ sample axis into the operator's sample
blocks. The kernels refuse a block structure they cannot take (more than
65535 pixel blocks or 64-row tiles of a pixel block; for `bsr_spmm` also
a staged tile larger than shared memory); the wrapper then raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.bsr_spmm.ref import bsr_beamform_ref, bsr_spmm_ref
from repro_torch.kernels.das_beamform.ops import PRECISION_CODES

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# bsr_beamform's arrival counters, per (device, stream): zero between
# calls (each call leaves them so), zeroed once on the device when made
# (a memset, which a CUDA graph capture may record; a copy from pageable
# host memory it may not). A call under capture makes its own, in the
# graph's pool: graphs replayed on two streams at once never share them.
_ARRIVALS: dict = {}


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
    fn = cuda_lib.kernel_fn("bsr_spmm", "bsr_spmm_launch",
                            [_P] * 4 + [_I] * 8 + [_P])
    rc = fn(cols.data_ptr(), blocks.data_ptr(), x.data_ptr(),
            out.data_ptr(), n_pb, k, bp, bs, n_sb, nf,
            PRECISION_CODES[precision], dev.index, cuda_lib.stream_of(dev))
    cuda_lib.check_launch(rc, "bsr_spmm_launch")
    bsr_spmm.launches += 1
    return out


def bsr_beamform(cols, blocks, iq_b, *, precision: str = "f32"):
    """Complex beamform of a batch through the BSR operator, summed over
    channels, in one launch.

    The operator must be in ``bsr_operator``'s format: in each (channel,
    pixel block) row the occupied slots come first with strictly
    ascending columns, and unused slots are all-zero blocks at column 0.
    The kernel skips every slot that ``kept_slots`` marks False (a slot
    k > 0 whose column is not above slot k - 1's), which is exact for
    finite IQ in that format; the plain version sums every slot. For any
    other operator use ``bsr_spmm``.

    Args:
      cols:   (n_c, n_pb, K) int32.
      blocks: (n_c, n_pb, K, bp, bs, 2) f32 (complex as trailing re/im).
      iq_b:   (B, n_sb, bs, n_c, n_f, 2) f32 blocked IQ.
      precision: "f32" | "bf16" | "f16" — both operands are rounded to
        it; accumulation is f32 (at f32 the kernel's products run as
        3xTF32, at f32-level error).
    Returns:
      (B, n_pb * bp, n_f, 2) f32, bit-identical from run to run. A CPU
      ``iq_b`` runs the plain version (``bsr_beamform_ref``); a CUDA
      ``iq_b`` launches the kernel or raises.
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
    # the kernel splits the channels over thread blocks where the output
    # tiles alone would not fill the card; the .cu sizes the workspace
    sizes = (b, n_c, n_pb, bp, n_f)
    n_part = cuda_lib.kernel_fn("bsr_spmm", "bsr_beamform_partials",
                                [_I] * 5, restype=_L)(*sizes)
    n_arr = cuda_lib.kernel_fn("bsr_spmm", "bsr_beamform_arrivals",
                               [_I] * 5, restype=_L)(*sizes)
    partials = torch.empty(max(2 * n_part, 1), dtype=torch.float32,
                           device=dev)
    stream = cuda_lib.stream_of(dev)
    arrivals = _ARRIVALS.get((dev.index, stream))
    if torch.cuda.is_current_stream_capturing():
        arrivals = torch.zeros(max(n_arr, 1), dtype=torch.int32,
                               device=dev)
    elif arrivals is None or arrivals.numel() < n_arr:
        arrivals = torch.zeros(max(n_arr, 1), dtype=torch.int32,
                               device=dev)
        _ARRIVALS[(dev.index, stream)] = arrivals
    fn = cuda_lib.kernel_fn("bsr_spmm", "bsr_beamform_launch",
                            [_P] * 5 + [_L, _P, _L] + [_I] * 10 + [_P])
    rc = fn(cols.data_ptr(), blocks.data_ptr(), iq_b.data_ptr(),
            out.data_ptr(), partials.data_ptr(), partials.numel() // 2,
            arrivals.data_ptr(), arrivals.numel(), b, n_c, n_pb, k, bp, bs,
            n_sb, n_f, PRECISION_CODES[precision], dev.index, stream)
    cuda_lib.check_launch(rc, "bsr_beamform_launch")
    bsr_beamform.launches += 1
    return out


bsr_spmm.launches = 0       # kernel launches since the last reset
bsr_beamform.launches = 0
