"""Mamba2 (SSD, state-space duality) block of the LM half.

The port of the reference's ``repro.models.ssm``. The recurrence

    h_t = exp(A dt_t) h_{t-1} + dt_t B_t x_t^T ;  y_t = C_t^T h_t + D x_t

runs in the chunked SSD form: intra-chunk masked products plus an
inter-chunk state scan. Train, scoring and prefill use `_ssd_chunked`
(plain PyTorch), or the CUDA ``ssd_scan`` kernel where the reference takes
its Pallas kernel: ``use_ssd_kernel`` set and no state asked for
(prefill always asks). Decode is the O(1)-state single-step update.

Layout: d_inner = ssm_expand * d_model, heads = d_inner / ssm_head_dim.
B and C are shared across heads (one group).

Under a "model" axis (`runtime.sharding.model_axis`) `ssm_apply` runs
on the rank's heads: its piece of in_proj is [z | x | B | C | dt] at the
local widths (z, x and dt of its heads, B and C whole), the causal conv
runs on [x_local | B | C], the SSD on the local heads, the gated norm
takes its mean of squares over the whole d_inner (`common.rmsnorm` with
the axis), and out_proj is row-parallel (`collectives.reduce_out`). The
local widths come from the pieces' shapes (`_local_dims`). Where "model"
does not divide the heads the block is whole on every rank and runs as
on one device: no copy_in, no "model" sum, the norm over its own width
(`_heads_axis`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import dense_init, softplus
from repro_torch.runtime import collectives
from repro_torch.runtime import sharding as shlib


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_head_dim, cfg.ssm_state


def ssm_params(cfg: ModelConfig, dtype, gen, device, lead=()) -> Dict:
    """One Mamba2 block; ``lead`` stacks ``lead`` copies on leading axes."""
    d = cfg.d_model
    d_inner, nh, hd, ns = _dims(cfg)
    conv_dim = d_inner + 2 * ns  # conv over x, B, C jointly (mamba2 layout)
    lead = tuple(lead)

    def f32(value):
        return torch.full(lead + (nh,), value, dtype=torch.float32,
                          device=device)

    return {
        # order: [z (gate), x, B, C, dt]
        "in_proj": dense_init(lead + (d, 2 * d_inner + 2 * ns + nh), dtype,
                              gen, device),
        "conv_w": dense_init(lead + (cfg.ssm_conv, conv_dim), dtype, gen,
                             device, scale=cfg.ssm_conv ** -0.5),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=dtype,
                              device=device),
        "a_log": f32(0.0),                  # A = -exp(a_log)
        "dt_bias": f32(-2.0),
        "d_skip": f32(1.0),
        "norm": common.rmsnorm_params(d_inner, dtype, device, lead),
        "out_proj": dense_init(lead + (d_inner, d), dtype, gen, device),
    }


def _local_dims(params: Dict, cfg: ModelConfig
                ) -> Tuple[int, int, int, int]:
    """`_dims` of the heads whose parameters ``params`` holds: all of
    them, or the rank's under a "model" axis."""
    nh = params["a_log"].shape[-1]
    return nh * cfg.ssm_head_dim, nh, cfg.ssm_head_dim, cfg.ssm_state


def _heads_axis(cfg: ModelConfig):
    """The "model" ranks that split the SSM's heads, or None (a whole
    block)."""
    return shlib.model_axis_over(_dims(cfg)[1])


def _split_proj(dims, proj: torch.Tensor):
    """in_proj's output -> (z, [x | B | C], dt) at ``dims``
    (`_local_dims`)."""
    d_inner, nh, hd, ns = dims
    return torch.split(proj, [d_inner, d_inner + 2 * ns, nh], dim=-1)


def _causal_conv(w, b, xbc, state=None):
    """Depthwise causal conv along time. xbc (B, S, C); w (K, C).

    Returns (out (B, S, C), new_state (B, K-1, C)): the state carries the
    last K-1 inputs for streaming decode. Taps are summed in ascending
    order, as the reference's unrolled sum.
    """
    k = w.shape[0]
    s = xbc.shape[1]
    if state is None:
        pad = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[2]))
    else:
        pad = state
    full = torch.cat([pad, xbc], dim=1)                  # (B, S+K-1, C)
    out = w[0][None, None, :] * full[:, 0:s]
    for i in range(1, k):
        out = out + w[i][None, None, :] * full[:, i:i + s]
    new_state = full[:, -(k - 1):] if k > 1 else None
    return out + b[None, None, :], new_state


def _ssd_chunked(log_a, x, bmat, cmat, chunk: int):
    """Chunked SSD in plain PyTorch (mirrors the reference's jnp version).

    log_a (B,S,H); x (B,S,H,P); bmat/cmat (B,S,N) group-shared.
    Returns (y (B,S,H,P) f32, final state (B,H,N,P) f32).
    """
    bsz, s, h = log_a.shape
    p = x.shape[-1]
    n = bmat.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        log_a = F.pad(log_a, (0, 0, 0, pad))
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    nc = log_a.shape[1] // q

    la = log_a.reshape(bsz, nc, q, h).float()
    xc = x.reshape(bsz, nc, q, h, p).float()
    bc = bmat.reshape(bsz, nc, q, n).float()
    cc = cmat.reshape(bsz, nc, q, n).float()

    lac = torch.cumsum(la, dim=2)                       # inclusive
    # --- intra-chunk (masked attention-like product) ---
    sqq = torch.einsum("bcin,bcjn->bcij", cc, bc)       # (B,NC,Q,Q)
    # clamp BEFORE exp: future positions (i < j) have positive log-decay
    dlog = torch.clamp(lac[:, :, :, None, :] - lac[:, :, None, :, :],
                       max=0.0)
    decay = torch.exp(dlog)
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    m = torch.where(mask[None, None, :, :, None], sqq[..., None] * decay,
                    0.0)
    y = torch.einsum("bcijh,bcjhp->bcihp", m, xc)

    # --- inter-chunk state scan ---
    ea_last = torch.exp(lac[:, :, -1, :])               # (B,NC,H)
    wdec = torch.exp(lac[:, :, -1:, :] - lac)           # (B,NC,Q,H)
    chunk_state = torch.einsum("bcqn,bcqh,bcqhp->bchnp", bc, wdec, xc)
    h_cur = x.new_zeros((bsz, h, n, p), dtype=torch.float32)
    h_before = []
    for c in range(nc):
        h_before.append(h_cur)
        h_cur = ea_last[:, c, :, None, None] * h_cur + chunk_state[:, c]
    h_before = torch.stack(h_before, dim=1)             # (B,NC,H,N,P)

    y = y + torch.einsum("bcqn,bcqh,bchnp->bcqhp", cc, torch.exp(lac),
                         h_before)
    y = y.reshape(bsz, nc * q, h, p)
    return y[:, :s], h_cur


def ssm_apply(params: Dict, cfg: ModelConfig, x: torch.Tensor,
              return_state: bool = False):
    """Train/prefill. x (B, S, d_model) -> (B, S, d_model).

    With return_state=True also returns the streaming cache (final SSM
    state + conv tail) so a prefill can hand off to decode.
    """
    dims = d_inner, nh, hd, ns = _local_dims(params, cfg)
    bsz, s, _ = x.shape
    axis = _heads_axis(cfg)

    proj = collectives.copy_in(x, axis) @ params["in_proj"]
    z, xbc_raw, dt = _split_proj(dims, proj)
    xbc, conv_state = _causal_conv(params["conv_w"], params["conv_b"],
                                   xbc_raw)
    xbc = F.silu(xbc)
    xs, bmat, cmat = torch.split(xbc, [d_inner, ns, ns], dim=-1)

    dt = softplus(dt.float() + params["dt_bias"][None, None, :])  # (B,S,H)
    a = -torch.exp(params["a_log"])[None, None, :]                # (1,1,H)
    log_a = a * dt                                                # <= 0
    xh = xs.reshape(bsz, s, nh, hd)
    xh_dt = xh.float() * dt[..., None]      # dt folded into x

    h_last = None
    if cfg.use_ssd_kernel and not return_state:
        from repro_torch.kernels.ssd_scan import ssd_scan
        # B and C stay group-shared: the kernel reads them for every head
        y = ssd_scan(log_a, xh_dt, bmat, cmat, chunk=cfg.ssm_chunk)
    else:
        y, h_last = _ssd_chunked(log_a, xh_dt, bmat, cmat, cfg.ssm_chunk)

    y = y + params["d_skip"][None, None, :, None] * xh.float()
    y = y.reshape(bsz, s, d_inner).to(x.dtype)
    y = common.rmsnorm(params["norm"], y * F.silu(z), axis=axis)
    out = collectives.reduce_out(y @ params["out_proj"], axis)
    if return_state:
        return out, {"conv": conv_state, "ssm": h_last}
    return out


# ---------------------------------------------------------------------------
# Streaming decode (O(1) state per layer)
# ---------------------------------------------------------------------------


def ssm_init_cache(cfg: ModelConfig, batch: int, dtype, device,
                   lead=()) -> Dict:
    d_inner, nh, hd, ns = _dims(cfg)
    conv_dim = d_inner + 2 * ns
    lead = tuple(lead)
    return {
        "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros(lead + (batch, nh, ns, hd), dtype=torch.float32,
                           device=device),
    }


def ssm_decode(params: Dict, cfg: ModelConfig, x: torch.Tensor,
               cache: Dict) -> Tuple[torch.Tensor, Dict]:
    """One-step decode. x (B, 1, d_model). No dynamic indexing anywhere.
    Under a "model" axis on the rank's heads, as `ssm_apply`: ``cache``
    holds the rank's part of the conv state ([x of its heads | B | C])
    and its heads' SSM states (`runtime.param_sharding.cache_layout`)."""
    dims = d_inner, nh, hd, ns = _local_dims(params, cfg)
    bsz = x.shape[0]
    axis = _heads_axis(cfg)

    proj = collectives.copy_in(x, axis) @ params["in_proj"]
    z, xbc, dt = _split_proj(dims, proj)
    xbc, conv_state = _causal_conv(params["conv_w"], params["conv_b"],
                                   xbc, state=cache["conv"])
    xbc = F.silu(xbc)
    xs, bmat, cmat = torch.split(xbc, [d_inner, ns, ns], dim=-1)

    dt = softplus(dt.float() + params["dt_bias"][None, None, :])  # (B,1,H)
    a = -torch.exp(params["a_log"])[None, None, :]
    ea = torch.exp(a * dt)[:, 0]                                  # (B,H)

    xh = xs.reshape(bsz, nh, hd).float()                          # (B,H,P)
    xh_dt = xh * dt[:, 0, :, None]
    b1 = bmat[:, 0].float()                                       # (B,N)
    c1 = cmat[:, 0].float()

    h_new = (ea[..., None, None] * cache["ssm"]
             + torch.einsum("bn,bhp->bhnp", b1, xh_dt))
    y = torch.einsum("bn,bhnp->bhp", c1, h_new)
    y = y + params["d_skip"][None, :, None] * xh
    y = y.reshape(bsz, 1, d_inner).to(x.dtype)
    y = common.rmsnorm(params["norm"], y * F.silu(z), axis=axis)
    return (collectives.reduce_out(y @ params["out_proj"], axis),
            {"conv": conv_state, "ssm": h_new})
