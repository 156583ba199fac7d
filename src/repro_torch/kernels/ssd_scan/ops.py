"""Public wrapper for the SSD scan CUDA kernel (csrc/ssd_scan.cu): batch,
heads, a ragged last chunk, dtypes.

B and C are group-shared, (batch, L, N), as ``ssm_apply`` has them; the
kernel reads them for every head in place, where the reference's wrapper
takes them broadcast per head. The kernel treats the steps past L as the
reference's zero padding, so nothing is padded or broadcast here.

One call makes three CUDA launches (one when L fits in one chunk): the
chunk-parallel products, the pass that carries the state across chunks,
and the chunk-parallel product with the carried state. What passes
between them (the chunk states and their decays) lies in one f32 scratch
buffer, whose size the kernel's library gives and whose layout only it
knows; the wrapper allocates it and counts the call once.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

DEFAULT_CHUNK = 128

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 6 + [_LL] + [_I] * 7 + [_P]


def ssd_scan(log_a, x, b, c, *, chunk: int = DEFAULT_CHUNK):
    """Batched multi-head SSD scan in chunks of ``min(chunk, L)`` steps
    (on the card: at most the longest chunk the kernel's tiles fit at
    this N, which the library reports).

    Args:
      log_a: (batch, L, H) log decays (<= 0).
      x:     (batch, L, H, P).
      b, c:  (batch, L, N), shared by every head.
    Returns:
      y (batch, L, H, P), dtype of ``x``. A CPU ``x`` runs the plain step
      recurrence (``ssd_scan_ref``); a CUDA ``x`` launches the kernel or
      raises (a state width N at which no chunk fits, for one). Under
      autograd with an input that requires grad it raises on either
      device (`cuda_lib.refuse_grad`).
    """
    cuda_lib.refuse_grad("ssd_scan", log_a, x, b, c)
    bsz, length, heads, p = x.shape
    n = b.shape[-1]
    want = (bsz, length, n)
    if tuple(b.shape) != want or tuple(c.shape) != want \
            or tuple(log_a.shape) != (bsz, length, heads) or chunk < 1:
        raise ValueError(f"ssd_scan: log_a {tuple(log_a.shape)}, x "
                         f"{tuple(x.shape)}, b {tuple(b.shape)}, c "
                         f"{tuple(c.shape)}, chunk {chunk}")
    if x.device.type == "cpu":
        return ssd_scan_ref(log_a, x, b, c).to(x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not "
                         f"{x.device.type}")
    dev = x.device
    la, xf, bf, cf = (t.to(torch.float32).contiguous()
                      for t in (log_a, x, b, c))
    for t, name in ((la, "log_a"), (bf, "b"), (cf, "c")):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    # the longest chunk up to the one asked for whose tiles fit shared
    # memory at this N: past it the kernel runs shorter chunks, which
    # changes the result only through rounding
    q = cuda_lib.kernel_fn("ssd_scan", "ssd_scan_max_chunk", [_I] * 2,
                           restype=_I)(n, min(chunk, length))
    if q < 1:
        raise RuntimeError(f"ssd_scan: no chunk fits shared memory at "
                           f"state width N={n}")
    y = torch.empty((bsz, length, heads, p), dtype=torch.float32,
                    device=dev)
    sizes = (bsz, length, heads, p, n, q)
    scratch_floats = cuda_lib.kernel_fn("ssd_scan", "ssd_scan_scratch_floats",
                                        [_I] * 6, restype=_LL)
    scratch = torch.empty(scratch_floats(*sizes), dtype=torch.float32,
                          device=dev)
    fn = cuda_lib.kernel_fn("ssd_scan", "ssd_scan_launch", _ARGTYPES)
    rc = fn(la.data_ptr(), xf.data_ptr(), bf.data_ptr(), cf.data_ptr(),
            y.data_ptr(), scratch.data_ptr(), scratch.numel(), *sizes,
            dev.index, cuda_lib.stream_of(dev))
    cuda_lib.check_launch(rc, "ssd_scan")
    ssd_scan.launches += 1
    return y.to(x.dtype)


ssd_scan.launches = 0   # kernel launches since the last reset
