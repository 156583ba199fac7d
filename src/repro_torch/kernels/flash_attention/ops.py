"""Public wrapper for the flash attention CUDA kernel
(csrc/flash_attention.cu): batch, GQA, ragged lengths, dtypes.

As the reference's wrapper: inputs are cast to f32, the kernel computes
in f32 and the result comes back in the dtype of ``q``. GQA reads KV head
``h // rep`` in place; nothing is repeated. The kernel masks keys past
Lk and skips key tiles wholly above the diagonal, so no padding is
copied. The reference refuses a non-causal Lk that its key tile does not
divide (its padded keys would enter the softmax); the port keeps that
refusal, with the reference's tile rule.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

REFERENCE_BK = 128      # the reference wrapper's default key tile
MAX_HEAD_DIM = 256

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 4 + [_I] * 7 + [ctypes.c_float] + [_I, _P]


def flash_attention(q, k, v, *, causal: bool = True, scale=None):
    """Batched GQA attention.

    Args:
      q: (batch, Lq, n_q_heads, d).
      k, v: (batch, Lk, n_kv_heads, d); n_q_heads % n_kv_heads == 0.
      causal: mask ``rows >= cols`` (Lq == Lk, aligned at position 0).
      scale: score scale, default ``d ** -0.5``.
    Returns:
      (batch, Lq, n_q_heads, d), dtype of ``q``. A CPU ``q`` runs the
      plain version (``flash_attention_ref``); a CUDA ``q`` launches the
      kernel or raises. The kernel takes head dims that are multiples of
      16, up to 256. Under autograd with an input that requires grad it
      raises on either device (`cuda_lib.refuse_grad`).
    """
    cuda_lib.refuse_grad("flash_attention", q, k, v)
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    if hq % hkv or tuple(v.shape) != tuple(k.shape) or k.shape[0] != b \
            or k.shape[-1] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    bk_eff = min(REFERENCE_BK, -(-lk // 8) * 8)
    if not causal and lk % bk_eff:
        raise ValueError("non-causal flash requires Lk % bk == 0 "
                         f"(got Lk={lk}, bk={bk_eff})")
    if causal and lq != lk:
        raise ValueError(f"causal flash attention needs Lq == Lk (got "
                         f"{lq}, {lk}): the kernel aligns the mask at "
                         f"position 0")
    if scale is None:
        scale = d ** -0.5
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal,
                                   scale=scale).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device.type}")
    if d % 16 or not 16 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the flash kernel takes head dims that are "
                         f"multiples of 16 up to {MAX_HEAD_DIM}, got {d}")
    dev = q.device
    qf, kf, vf = (t.to(torch.float32).contiguous() for t in (q, k, v))
    cuda_lib.require(kf, "k", torch.float32, (b, lk, hkv, d), dev)
    cuda_lib.require(vf, "v", torch.float32, (b, lk, hkv, d), dev)
    out = torch.empty((b, lq, hq, d), dtype=torch.float32, device=dev)
    fn = cuda_lib.kernel_fn("flash_attention", "flash_attention_launch",
                            _ARGTYPES)
    rc = fn(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(),
            b, lq, lk, hq, hkv, d, int(causal), float(scale), dev.index,
            cuda_lib.stream_of(dev))
    cuda_lib.check_launch(rc, "flash_attention")
    flash_attention.launches += 1
    return out.to(q.dtype)


flash_attention.launches = 0   # kernel launches since the last reset
