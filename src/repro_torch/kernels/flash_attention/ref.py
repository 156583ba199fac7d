"""Plain PyTorch version of flash attention, after the reference's
``attention_ref``: the whole (Lq x Lk) score matrix, one softmax."""

from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, scale=None):
    """(h, Lq, d) x (h, Lk, d) x (h, Lk, d) -> (h, Lq, d), f32 math.

    A leading batch axis may be folded into ``h``. The causal mask is
    ``tril(k=Lk-Lq)``, as in the reference (aligned at the end; the same
    as the kernel's ``rows >= cols`` when Lq == Lk).
    """
    lq, d = q.shape[-2], q.shape[-1]
    lk = k.shape[-2]
    if scale is None:
        scale = d ** -0.5
    s = torch.einsum("hqd,hkd->hqk", q, k) * scale
    if causal:
        mask = torch.ones((lq, lk), dtype=torch.bool,
                          device=q.device).tril(lk - lq)
        s = torch.where(mask[None], s, torch.tensor(-1e30, dtype=s.dtype,
                                                    device=s.device))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("hqk,hkd->hqd", p, v)


def flash_attention_ref(q, k, v, *, causal: bool = True, scale=None):
    """Batched GQA attention, plain: (B, Lq, Hq, d), (B, Lk, Hkv, d) x2 ->
    (B, Lq, Hq, d) f32. KV heads are repeated to the query heads, as the
    reference's wrapper does before its kernel."""
    b, lq, hq, d = q.shape
    _, lk, hkv, _ = k.shape
    rep = hq // hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)

    def heads(t):                       # (B, L, H, d) -> (B*H, L, d)
        return t.float().permute(0, 2, 1, 3).reshape(-1, t.shape[1], d)

    out = attention_ref(heads(q), heads(k), heads(v), causal=causal,
                        scale=scale)
    return out.reshape(b, hq, lq, d).permute(0, 2, 1, 3)
