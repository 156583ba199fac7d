"""Attention of the LM half: GQA (+qk-norm, window, softcap, M-RoPE), MLA,
KV caches.

The port of the reference's ``repro.models.attention``:
  * train/prefill — `chunked_attention` over query blocks, or the CUDA
    flash kernel where the reference takes its Pallas kernel (the same
    condition, in `gqa_attention`);
  * decode — one query against the cache with per-slot lengths; the cache
    write in the paper's V1 (indexed write) and V2 (one-hot blend)
    variants, per layer (`cache_update`) or into a layer-stacked cache
    (`stacked_cache_update`, `gqa_decode_stacked`);
  * MLA (deepseek-v2) — `mla_attention` expands the low-rank keys and
    values for `chunked_attention`; `mla_decode` attends in the
    compressed space (absorbed weights) against a cache of c_kv and one
    shared rope key per position.

A window may be a Python int or a 0-d tensor (gemma3's per-layer window,
picked on the device as the reference's traced ``jnp.where``); a tensor
is never read back to the host. Only an int 0 takes the flash kernel.

Under a "model" axis (`runtime.sharding.model_axis`) `gqa_attention`
runs on the rank's query heads and the KV heads they read, their counts
taken from the pieces of wq and wk (`runtime.param_sharding.tp_pieces`):
the input enters through `collectives.copy_in`, wo is row-parallel and
its product leaves through `collectives.reduce_out`. q_norm and k_norm
are whole (one scale a head dim). Cross attention takes K and V that
its caller computed the same way (`encdec.cross_kv`). `mla_attention`
runs on the rank's heads too, their count taken from the piece of
wk_b: wq_a, wkv_a and both norms run whole on every rank, and the
normed query, c_kv and the one rope key that every head shares enter
the rank's head columns of wq_b, wk_b and wv_b through `copy_in`; wo is
row-parallel. The decode paths run on the rank's heads too, wo through
`reduce_out`. Where the cache holds KV heads other than the rank's
(every head, in the decode cell's layout, `launch.cells`) they gather
the new token's q, k and v over "model" (`_decode_qkv`: a few KB a
step, one all-gather), attend with every query head and keep their
own heads' rows.

Where "model" does not divide the query heads (`heads_axis` None) the
block is whole on every rank: every head, no ``copy_in`` and no
``reduce_out``, in train, prefill and decode alike, as one device runs
it. Under the config's ``attn_batch_fallback`` (the reference's) the
train / prefill attention instead splits each rank's rows again over
"model" where they divide (`rows_axis`): a rank projects and attends
its block of the rows with every head, and the blocks are gathered
(`collectives.split_rows`, `gather_rows`). Where "model" splits the
query heads but neither divides nor is divided by the KV heads, every
rank holds every KV head and reads those of its query heads, a map not
aligned with the ranks (`_kv_of_heads`); its decode gathers the query
heads as the decode cell does.

Flash-decode (`runtime.sharding.seq_axis`: the decode cache split along
its sequence over the "seq" ranks): each rank attends over its block of
positions at its global offset (the mask and gemma3's window read
global columns) and keeps an unnormalised partial in f32, the max, the
sum of exponentials and the numerator; `combine_partials` rescales them
to the ranks' common max and sums them (one all-gather of the partials
over the "seq" ranks, summed on each). A block whose columns are all
masked adds nothing: its max is near ``NEG_INF`` (finite), so its
weight exp(max - common max) is 0. The new token's K and V are written
by the rank that holds position ``lengths[b]`` only (`seq_slot`), in
both cache variants.

Storage-dtype operands with f32 accumulation, as the reference's
``preferred_element_type=f32``: every attention product goes through
`common.f32_product`, which on the card without autograd reads bf16
operands as they are, and otherwise casts them to f32 (exact for bf16
inputs: their products fit f32). Decode reads the caches through
strided views (`common.grouped_product`), so no copy of a cache is
made, in either dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.config import Variant
from repro_torch.models import common
from repro_torch.models.common import dense_init
from repro_torch.runtime import collectives
from repro_torch.runtime import sharding as shlib

NEG_INF = -1e30


def attn_params(cfg: ModelConfig, dtype, gen, device, lead=()) -> Dict:
    """One GQA block; ``lead`` stacks copies on leading axes."""
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lead = tuple(lead)
    p = {
        "wq": dense_init(lead + (d, h * dh), dtype, gen, device),
        "wk": dense_init(lead + (d, hkv * dh), dtype, gen, device),
        "wv": dense_init(lead + (d, hkv * dh), dtype, gen, device),
        "wo": dense_init(lead + (h * dh, d), dtype, gen, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = common.rmsnorm_params(dh, dtype, device, lead)
        p["k_norm"] = common.rmsnorm_params(dh, dtype, device, lead)
    return p


def mla_params(cfg: ModelConfig, dtype, gen, device, lead=()) -> Dict:
    """One MLA block (the reference's leaves); ``lead`` stacks copies."""
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    lead = tuple(lead)
    return {
        "wq_a": dense_init(lead + (d, rq), dtype, gen, device),
        "q_norm": common.rmsnorm_params(rq, dtype, device, lead),
        "wq_b": dense_init(lead + (rq, h * (dn + dr)), dtype, gen, device),
        "wkv_a": dense_init(lead + (d, rkv + dr), dtype, gen, device),
        "kv_norm": common.rmsnorm_params(rkv, dtype, device, lead),
        "wk_b": dense_init(lead + (rkv, h * dn), dtype, gen, device),
        "wv_b": dense_init(lead + (rkv, h * dv), dtype, gen, device),
        "wo": dense_init(lead + (h * dv, d), dtype, gen, device),
    }


def decode_positions(cfg: ModelConfig, lengths: torch.Tensor
                     ) -> torch.Tensor:
    """The new token's positions: (B, 1), or (B, 3, 1) under M-RoPE (a
    text continuation advances all three axes; the reference's)."""
    if cfg.mrope_sections:
        return lengths[:, None, None].expand(-1, 3, 1)
    return lengths[:, None]


def _window_mask(cols: torch.Tensor, rows: torch.Tensor, window
                 ) -> torch.Tensor:
    """``cols > rows - window``; ``window <= 0`` means unbounded. A tensor
    window stays on its device (``torch.where``, no host read)."""
    if isinstance(window, torch.Tensor):
        weff = torch.where(window > 0, window, 2 ** 30)
    else:
        weff = window if window > 0 else 2 ** 30
    return cols > rows - weff


# ---------------------------------------------------------------------------
# Masks (additive bias per query chunk, never (S x S) at once)
# ---------------------------------------------------------------------------


def _chunk_bias(q_start: int, bq: int, kv_len: int, *, causal: bool,
                window, device) -> torch.Tensor:
    """(bq, kv_len) additive bias for queries [q_start, q_start + bq).
    ``window <= 0`` means unbounded; an int or a 0-d tensor. (The
    reference's ``q_offset`` is left out: no caller passes one.)"""
    rows = (q_start
            + torch.arange(bq, device=device, dtype=torch.int32)[:, None])
    cols = torch.arange(kv_len, device=device, dtype=torch.int32)[None, :]
    ok = _window_mask(cols, rows, window)
    if causal:
        ok &= cols <= rows
    return torch.where(ok, 0.0, NEG_INF)


# ---------------------------------------------------------------------------
# Chunked attention (train / prefill)
# ---------------------------------------------------------------------------


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window=0, chunk: int = 512,
                      softcap: float = 0.0
                      ) -> torch.Tensor:
    """(B,S,H,dh) x (B,Sk,Hkv,dh)^2 -> (B,S,H,dh); scores per query block.

    GQA groups the query heads as (Hkv, rep); no KV is repeated. K and V
    are laid out once per call as (B*Hkv, Sk, dh) in their own dtype, so
    each block's scores and output are one `common.f32_product` each.
    """
    b, s, h, dh = q.shape
    _, sk, hkv, _ = k.shape
    rep = h // hkv
    scale = dh ** -0.5
    bq = min(chunk, s)
    kt = k.transpose(1, 2).reshape(b * hkv, sk, dh).transpose(1, 2)
    vt = v.transpose(1, 2).reshape(b * hkv, sk, dh)
    qg = q.reshape(b, s, hkv, rep, dh)
    out = q.new_empty((b, s, hkv, rep, dh), dtype=torch.float32)
    for q0 in range(0, s, bq):
        n = min(bq, s - q0)
        q_blk = qg[:, q0:q0 + n].permute(0, 2, 1, 3, 4).reshape(
            b * hkv, n * rep, dh)                      # rows (query, rep)
        s_blk = common.f32_product(q_blk, kt).reshape(
            b, hkv, n, rep, sk) * scale
        if softcap > 0.0:
            s_blk = torch.tanh(s_blk / softcap) * softcap
        bias = _chunk_bias(q0, n, sk, causal=causal, window=window,
                           device=q.device)
        p = torch.softmax(s_blk + bias[:, None, :], dim=-1)
        o_blk = common.f32_product(
            p.to(v.dtype).reshape(b * hkv, n * rep, sk), vt)
        out[:, q0:q0 + n] = o_blk.reshape(b, hkv, n, rep, dh).permute(
            0, 2, 1, 3, 4)
    return out.reshape(b, s, h, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# KV-cache update: the paper's V1 (dynamic) vs V2 (one-hot CNN) variants
# ---------------------------------------------------------------------------


def seq_slot(lengths: torch.Tensor, s_loc: int, seq, clamp: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the row of each slot's position ``lengths[b]`` in this rank's
    block of ``s_loc`` positions, clamped into it; whether this rank
    holds that position), the cache split along its sequence over the
    ranks ``seq``; with ``clamp`` the position is first clamped into the
    whole cache, as dynamic_update_slice clamps it."""
    pos = lengths.long()
    if clamp:
        pos = pos.clamp(0, s_loc * seq.extent - 1)
    local = pos - seq.index * s_loc
    return local.clamp(0, s_loc - 1), (local >= 0) & (local < s_loc)


def cache_update(cache: torch.Tensor, new: torch.Tensor,
                 lengths: torch.Tensor, variant: Variant, seq=None
                 ) -> torch.Tensor:
    """Write ``new`` (B, 1, H, dh) into ``cache`` (B, S, H, dh) at
    position ``lengths[b]`` of each slot.

    V1 DYNAMIC writes the row in place and returns ``cache`` itself (the
    reference's dynamic_update_slice returns a copy; serving never reads
    the old cache). Like dynamic_update_slice, it clamps the position
    into [0, S-1].
    V2 CNN: the one-hot blend ``cache*(1-m) + new*m``, a new tensor; a
    position outside the cache writes nothing.
    ``seq`` (`runtime.sharding.seq_axis`): ``cache`` is this rank's block
    of the sequence, written only where it holds the position.
    """
    b, s = cache.shape[0], cache.shape[1]
    if Variant(variant) == Variant.DYNAMIC:
        rows = torch.arange(b, device=cache.device)
        if seq is None:
            cache[rows, lengths.long().clamp(0, s - 1)] = new[:, 0].to(
                cache.dtype)
        else:
            pos, mine = seq_slot(lengths, s, seq, clamp=True)
            cache[rows, pos] = torch.where(
                mine[:, None, None], new[:, 0].to(cache.dtype),
                cache[rows, pos])
        return cache
    iota = torch.arange(s, device=cache.device)[None, :]
    if seq is not None:
        iota = iota + seq.index * s
    m = (iota == lengths.long()[:, None]).to(cache.dtype)[..., None, None]
    return cache * (1.0 - m) + new.to(cache.dtype) * m


def stacked_cache_update(cache: torch.Tensor, new: torch.Tensor,
                         lengths: torch.Tensor, layer_idx: int,
                         variant: Variant, seq=None) -> torch.Tensor:
    """Write ``new`` (B, 1, H, dh) into a layer-stacked cache (L, B, S, H,
    dh) at (layer_idx, b, lengths[b]).

    V1 DYNAMIC: the token rows written in place; ``cache`` itself comes
    back. A position past the end writes nothing (the reference's
    ``mode="drop"``): its row is clamped and written back unchanged.
    V2 CNN: the (L, S) one-hot blend over the whole buffer, a new tensor
    (the paper's portability-for-traffic trade at cache scale).
    ``seq`` (`runtime.sharding.seq_axis`): ``cache`` holds this rank's
    block of the sequence, written only where it holds the position.
    """
    _, b, s = cache.shape[:3]
    lens = lengths.long()
    if Variant(variant) == Variant.DYNAMIC:
        rows = torch.arange(b, device=cache.device)
        if seq is None:
            pos = lens.clamp(max=s - 1)
            keep = (lens < s)[:, None, None]
        else:
            pos, keep = seq_slot(lengths, s, seq, clamp=False)
            keep = keep[:, None, None]
        layer = cache[layer_idx]
        layer[rows, pos] = torch.where(keep, new[:, 0].to(cache.dtype),
                                       layer[rows, pos])
        return cache
    l = cache.shape[0]
    iota_l = torch.arange(l, device=cache.device)[:, None, None]
    iota_s = torch.arange(s, device=cache.device)[None, None, :]
    if seq is not None:
        iota_s = iota_s + seq.index * s
    m = ((iota_l == layer_idx) & (iota_s == lens[None, :, None])).to(
        cache.dtype)[..., None, None]
    return cache * (1.0 - m) + new[None].to(cache.dtype) * m


# ---------------------------------------------------------------------------
# Decode attention (single query vs cache, per-slot lengths)
# ---------------------------------------------------------------------------


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     window=0, softcap: float = 0.0, seq=None
                     ) -> torch.Tensor:
    """q (B,1,H,dh); caches (B,S,Hkv,dh); lengths (B,) current position.

    Attends to cols <= lengths[b] (the new token was just written there).
    The caches are read in their storage dtype through strided views
    (`common.grouped_product`): no copy of them is made. ``seq``
    (`runtime.sharding.seq_axis`): the caches are this rank's block of
    the sequence, and the partial softmaxes of the ranks' blocks are
    combined (module doc).
    """
    b, _, h, dh = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    rep = h // hkv
    scale = dh ** -0.5
    qg = q.reshape(b, hkv, rep, dh)
    scores = common.grouped_product(
        qg, k_cache.permute(0, 2, 3, 1)) * scale       # (B, Hkv, rep, S)
    if softcap > 0.0:
        scores = torch.tanh(scores / softcap) * softcap
    cols = torch.arange(s, device=q.device)[None, :]
    if seq is not None:
        cols = cols + seq.index * s
    lens = lengths.long()[:, None]
    ok = (cols <= lens) & _window_mask(cols, lens, window)
    scores = scores + torch.where(ok, 0.0, NEG_INF)[:, None, None, :]
    if seq is None:
        p = torch.softmax(scores, dim=-1)
        out = common.grouped_product(p.to(v_cache.dtype),
                                     v_cache.permute(0, 2, 1, 3))
    else:
        mx = scores.amax(dim=-1)
        p = torch.exp(scores - mx[..., None])
        part = common.grouped_product(p.to(v_cache.dtype),
                                      v_cache.permute(0, 2, 1, 3))
        out = combine_partials(mx, p.sum(dim=-1), part, seq)
    return out.reshape(b, 1, h, dh).to(q.dtype)


def combine_partials(mx: torch.Tensor, denom: torch.Tensor,
                     numer: torch.Tensor, seq) -> torch.Tensor:
    """The softmax-weighted sum over every rank's block of positions
    from each rank's f32 partial: ``mx`` (...) its blocks' max score,
    ``denom`` (...) the sum of exp(score - mx), ``numer`` (..., d) the
    sum of exp(score - mx) times the values. Every rank's [numer | denom
    | mx] is gathered over ``seq`` (one all-gather, a few KB at decode),
    each rescaled by exp(mx - the ranks' max) and summed in rank order,
    the same on every rank; their quotient."""
    every = collectives.gathered(torch.cat(
        [numer, denom[..., None], mx[..., None]], -1).contiguous(), seq)
    w = torch.exp(every[..., -1] - every[..., -1].amax(dim=0))
    den = (every[..., -2] * w).sum(dim=0)
    return (every[..., :-2] * w[..., None]).sum(dim=0) / den[..., None]


# ---------------------------------------------------------------------------
# Full GQA attention block (projections + rope + attention + out-proj)
# ---------------------------------------------------------------------------


def heads_axis(cfg: ModelConfig):
    """The "model" ranks that split the attention's query heads, or None
    where the block is whole on every rank (no "model" axis, or one
    that does not divide the heads: `runtime.param_sharding.
    tp_layout`)."""
    return shlib.model_axis_over(cfg.n_heads)


def rows_axis(cfg: ModelConfig, rows: int):
    """The "model" ranks over which the ``attn_batch`` fallback splits
    this rank's ``rows`` of the attention (each takes its block of them),
    or None where it does not: the config does not ask for it, "model"
    divides the query heads, or "model" does not divide ``rows`` (then
    the block runs whole on every rank). The reference's
    ``_attn_fallback_shard``: its row block ``i * m + j`` of the batch
    over ("data", "model") is the "model" block ``j`` of "data" rank
    ``i``'s rows, so only "model" takes part."""
    axis = shlib.model_axis()
    if (axis is None or not cfg.attn_batch_fallback or cfg.use_mla
            or cfg.n_heads % axis.extent == 0 or rows % axis.extent):
        return None
    return axis


def _kv_all(cfg: ModelConfig, axis) -> bool:
    """Whether every rank holds every KV head while "model" splits the
    query heads: KV heads that neither divide nor are divided by it
    (granite-moe's 8 at 3 ranks)."""
    hkv = cfg.n_kv_heads
    return axis is not None and bool(hkv % axis.extent and
                                     axis.extent % hkv)


def _kv_of_heads(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
                 axis, h: int):
    """k and v (B, S, every KV head, dh) cut to the KV heads that this
    rank's ``h`` query heads read, in their order: query head j (of the
    whole block) reads KV head j // (n_heads / n_kv_heads), a map that
    need not align with the ranks (rank 0 of 3 with 24 heads over 8 KV
    heads reads 0, 0, 0, 1, 1, 1, 2, 2): one KV head a query head where
    it does not, else the rank's whole groups."""
    rep = cfg.n_heads // cfg.n_kv_heads
    first = axis.index * h
    if first % rep == 0 and h % rep == 0:
        return (k.narrow(2, first // rep, h // rep),
                v.narrow(2, first // rep, h // rep))
    idx = torch.div(torch.arange(first, first + h, device=k.device), rep,
                    rounding_mode="floor")
    return k.index_select(2, idx), v.index_select(2, idx)


def gqa_project_qkv(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, is_local=None, axis=None,
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v of ``x``; q and k rms-normed per head under ``qk_norm``
    and rotated. Where the config has a local rope base (gemma3), a layer
    whose ``is_local`` (a 0-d bool tensor) is set takes it, picked on
    the device as the reference's traced ``jnp.where``. The head counts
    are those of the pieces of wq and wk (module doc); ``x`` enters
    through `collectives.copy_in` over ``axis`` (`heads_axis`)."""
    b, s, _ = x.shape
    dh = cfg.head_dim
    h, hkv = params["wq"].shape[-1] // dh, params["wk"].shape[-1] // dh
    x = collectives.copy_in(x, axis)
    q = common.matmul(x, params["wq"]).reshape(b, s, h, dh)
    k = common.matmul(x, params["wk"]).reshape(b, s, hkv, dh)
    v = common.matmul(x, params["wv"]).reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = common.rmsnorm(params["q_norm"], q)
        k = common.rmsnorm(params["k_norm"], k)

    def rope(t):
        out = common.apply_rope(t, positions, cfg.rope_theta,
                                cfg.mrope_sections)
        if cfg.rope_local_theta and is_local is not None:
            loc = common.apply_rope(t, positions, cfg.rope_local_theta,
                                    cfg.mrope_sections)
            out = torch.where(is_local, loc, out)
        return out

    return rope(q), rope(k), v


def gqa_attention(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, window=0, is_local=None,
                  cross_kv: Optional[Tuple[torch.Tensor,
                                           torch.Tensor]] = None,
                  causal: bool = True, return_kv: bool = False):
    """Train/prefill self- (or cross-) attention over full sequences.

    Takes the flash kernel under the reference's condition: the flag set,
    causal, a Python-int ``window`` equal to 0, no cross KV. A tensor
    window (the dense transformer's, ROADMAP C) never takes it.

    Under a "model" axis that splits the query heads, on the rank's
    heads (module doc), those KV heads that they read where every rank
    holds every KV head (`_kv_of_heads`). Where it does not split them,
    the block runs whole on every rank; or, under the ``attn_batch``
    fallback (`rows_axis`), each rank takes its block of the rows
    (`collectives.split_rows`), projects and attends them with every
    head, applies wo, and the rows are gathered over "model"
    (`collectives.gather_rows`; with ``return_kv``, k and v too). The
    K and V it returns are of every KV head the rank holds.
    """
    rows = rows_axis(cfg, x.shape[0])
    axis = heads_axis(cfg)
    if rows is not None:
        x = collectives.split_rows(x, rows)
        n = x.shape[0]
        positions = positions.narrow(0, rows.index * n, n)
        if cross_kv is not None:
            # partial gradients of the cross K/V: their rows enter
            # `encdec.cross_kv` through `copy_in` over "model"
            cross_kv = tuple(t.narrow(0, rows.index * n, n)
                             for t in cross_kv)
    q, k, v = gqa_project_qkv(params, cfg, x, positions, is_local, axis)
    if cross_kv is not None:
        k, v = cross_kv
        causal = False
    kv = (k, v)
    if _kv_all(cfg, axis):
        k, v = _kv_of_heads(k, v, cfg, axis, q.shape[2])
    static_window = isinstance(window, int) and window == 0
    if (cfg.use_flash_kernel and causal and static_window
            and cross_kv is None):
        from repro_torch.kernels.flash_attention import flash_attention
        out = flash_attention(q, k, v, causal=True)
    else:
        out = chunked_attention(q, k, v, causal=causal, window=window,
                                chunk=cfg.attn_chunk,
                                softcap=cfg.attn_logit_softcap)
    b, s = x.shape[:2]
    y = collectives.reduce_out(
        common.matmul(out.reshape(b, s, -1), params["wo"]), axis)
    if rows is not None:
        y = collectives.gather_rows(y, rows)
        if return_kv:
            kv = tuple(collectives.gather_rows(t, rows) for t in kv)
    if return_kv:
        return y, kv
    return y


def heads_of_ranks(every: torch.Tensor, n: int, dim: int = 2
                   ) -> torch.Tensor:
    """The ``n`` KV heads (along ``dim`` of a rank's piece) from
    ``every`` (extent, *piece), what each rank of an axis holds of them
    (`runtime.param_sharding.tp_pieces`): n / m a rank, or one shared by
    m / n ranks (rank r holds head r * n // m)."""
    if every.shape[0] * every.shape[dim + 1] != n:
        every = every[::every.shape[0] // n]
    return torch.cat(list(every), dim=dim)


def _decode_qkv(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                lengths: torch.Tensor, is_local, cache_heads: int,
                positions=None, with_kv: bool = True):
    """(q, k, v, keep) of the new token for a cache of ``cache_heads``
    KV heads: the rank's heads (`gqa_project_qkv`) and keep None where
    the cache holds the rank's KV heads of every position (the enc-dec
    prefill's cross K/V); else (the decode cell's cache, every KV head
    and the sequence split over "seq", or the enc-dec prefill's
    self-attention cache of every head) q of every head and k and v of
    every KV head, gathered over "model" in one all-gather (k and v
    left as they are without ``with_kv`` or where the rank's are the
    cache's), and ``keep`` the slice of the rank's own query heads."""
    if positions is None:
        positions = decode_positions(cfg, lengths)
    axis, seq = heads_axis(cfg), shlib.seq_axis()
    q, k, v = gqa_project_qkv(params, cfg, x, positions, is_local, axis)
    if axis is None or (k.shape[2] == cache_heads
                        and not _kv_all(cfg, axis)
                        and (seq is None or "model" not in seq.axes)):
        return q, k, v, None
    h, hk = q.shape[2], k.shape[2]
    kv = with_kv and hk != cache_heads
    every = collectives.gathered(
        (torch.cat([q, k, v], 2) if kv else q).contiguous(), axis)
    if kv:
        k = heads_of_ranks(every[:, :, :, h:h + hk], cache_heads)
        v = heads_of_ranks(every[:, :, :, h + hk:], cache_heads)
    q = torch.cat(list(every[:, :, :, :h]), dim=2)
    return q, k, v, slice(axis.index * h, (axis.index + 1) * h)


def _decode_out(params: Dict, cfg: ModelConfig, out: torch.Tensor, keep
                ) -> torch.Tensor:
    """The block's output of the attention ``out`` (B, 1, H, dh): the
    rank's own heads (``keep``) through wo, row-parallel where "model"
    splits the heads."""
    if keep is not None:
        out = out[:, :, keep]
    y = out.reshape(out.shape[0], 1, -1) @ params["wo"]
    return collectives.reduce_out(y, heads_axis(cfg))


def gqa_decode_stacked(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                       cache: Dict, lengths: torch.Tensor, layer_idx: int,
                       *, window=0, is_local=None
                       ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode against a layer-stacked cache {"k", "v"} of
    (L, B, S, hkv, dh): writes the token at (layer_idx, :, lengths[b]),
    then attends against the layer's slice."""
    seq = shlib.seq_axis()
    q, k, v, keep = _decode_qkv(params, cfg, x, lengths, is_local,
                                cache["k"].shape[-2])
    k_full = stacked_cache_update(cache["k"], k, lengths, layer_idx,
                                  cfg.kv_variant, seq)
    v_full = stacked_cache_update(cache["v"], v, lengths, layer_idx,
                                  cfg.kv_variant, seq)
    out = decode_attention(q, k_full[layer_idx], v_full[layer_idx], lengths,
                           window=window, softcap=cfg.attn_logit_softcap,
                           seq=seq)
    return _decode_out(params, cfg, out, keep), {"k": k_full, "v": v_full}


def gqa_decode(params: Dict, cfg: ModelConfig, x: torch.Tensor,
               cache: Dict, lengths: torch.Tensor, *, window=0,
               is_local=None) -> Tuple[torch.Tensor, Dict]:
    """One-token decode with cache update. x: (B, 1, D)."""
    seq = shlib.seq_axis()
    q, k, v, keep = _decode_qkv(params, cfg, x, lengths, is_local,
                                cache["k"].shape[-2])
    k_cache = cache_update(cache["k"], k, lengths, cfg.kv_variant, seq)
    v_cache = cache_update(cache["v"], v, lengths, cfg.kv_variant, seq)
    out = decode_attention(q, k_cache, v_cache, lengths, window=window,
                           softcap=cfg.attn_logit_softcap, seq=seq)
    return _decode_out(params, cfg, out, keep), {"k": k_cache, "v": v_cache}


def cross_decode(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """One query a slot (at position ``lengths``) against a static K/V
    (B, S, hkv, dh), every position valid: the enc-dec's cross
    attention in decode, on the rank's heads as `gqa_decode` runs."""
    seq = shlib.seq_axis()
    s = k_cache.shape[1] * (seq.extent if seq is not None else 1)
    q, _, _, keep = _decode_qkv(params, cfg, x, lengths, None,
                                k_cache.shape[-2], lengths[:, None],
                                with_kv=False)
    every = torch.full((x.shape[0],), s - 1, dtype=torch.int32,
                       device=x.device)
    out = decode_attention(q, k_cache, v_cache, every, seq=seq)
    return _decode_out(params, cfg, out, keep)


# ---------------------------------------------------------------------------
# MLA (deepseek-v2): low-rank compressed KV, absorbed decode
# ---------------------------------------------------------------------------


def _mla_qkv_expand(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, axis=None):
    """(q_nope (B,S,H,dn), q_rope (B,S,H,dr), c_kv (B,S,rank), k_rope
    (B,S,1,dr)): the rope key is one head shared by all. H: the heads
    of wq_b's piece, whose input enters through `copy_in` over
    ``axis``."""
    b, s, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    h = params["wq_b"].shape[-1] // (dn + dr)
    rank = cfg.kv_lora_rank
    ql = common.rmsnorm(params["q_norm"], x @ params["wq_a"])
    q = (collectives.copy_in(ql, axis) @ params["wq_b"]).reshape(
        b, s, h, dn + dr)
    q_nope = q[..., :dn]
    q_rope = common.apply_rope(q[..., dn:], positions, cfg.rope_theta)
    kv = x @ params["wkv_a"]                           # (B, S, rank + dr)
    c_kv = common.rmsnorm(params["kv_norm"], kv[..., :rank])
    k_rope = common.apply_rope(kv[..., None, rank:], positions,
                               cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def mla_attention(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, return_kv: bool = False):
    """Train/prefill MLA with expanded keys and values: rope and nope
    parts packed into one head dim (dn + dr) for `chunked_attention`, v
    zero-padded to it and the output sliced back to dv. Under a "model"
    axis on the rank's heads (module doc); the cache it returns is
    whole."""
    b, s, _ = x.shape
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    h = params["wk_b"].shape[-1] // dn
    axis = heads_axis(cfg)
    q_nope, q_rope, c_kv, k_rope = _mla_qkv_expand(params, cfg, x, positions,
                                                   axis)
    c_in = collectives.copy_in(c_kv, axis)
    k_nope = (c_in @ params["wk_b"]).reshape(b, s, h, dn)
    v = (c_in @ params["wv_b"]).reshape(b, s, h, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, collectives.copy_in(k_rope, axis).expand(
        b, s, h, dr)], dim=-1)
    v_pad = torch.nn.functional.pad(v, (0, dn + dr - dv))
    out = chunked_attention(q, k, v_pad, causal=True, chunk=cfg.attn_chunk)
    y = collectives.reduce_out(out[..., :dv].reshape(b, s, -1)
                               @ params["wo"], axis)
    if return_kv:
        return y, (c_kv, k_rope)
    return y


def mla_decode(params: Dict, cfg: ModelConfig, x: torch.Tensor,
               cache: Dict, lengths: torch.Tensor, layer_idx=None,
               ) -> Tuple[torch.Tensor, Dict]:
    """Absorbed-weight MLA decode: attention runs in the compressed space.

    The cache holds c_kv (.., B, S, rank) and k_rope (.., B, S, 1, dr)
    only. With ``layer_idx`` the cache is layer-stacked and takes the
    token at (layer_idx, b, lengths[b]) (`stacked_cache_update`), else it
    is one layer's (`cache_update`). Under V1 the write is in place and
    the given tensors come back; V2's blend returns new ones.

    Storage-dtype operands with f32 results, as the reference's
    (`common.f32_product`): neither the cache nor the absorbed weights
    are copied.

    Under a "model" axis on the rank's heads (the piece of wk_b, as
    `mla_attention`), wo row-parallel. The cache has no heads axis: the
    decode cell splits it along its sequence (`runtime.sharding.
    seq_axis`), and where the "seq" ranks include "model" the absorbed
    queries of every head are gathered over "model", each rank's block
    gives every head's partial, and the rank keeps its heads' combined
    context (module doc).
    """
    b = x.shape[0]
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    h = params["wk_b"].shape[-1] // dn
    rank = cfg.kv_lora_rank
    axis, seq = heads_axis(cfg), shlib.seq_axis()
    q_nope, q_rope, c_kv, k_rope = _mla_qkv_expand(
        params, cfg, x, lengths[:, None], axis)
    if layer_idx is not None:
        ckv_full = stacked_cache_update(
            cache["c_kv"][..., None, :], c_kv[..., None, :], lengths,
            layer_idx, cfg.kv_variant, seq)[..., 0, :]
        rope_full = stacked_cache_update(cache["k_rope"], k_rope, lengths,
                                         layer_idx, cfg.kv_variant, seq)
        ckv_cache, rope_cache = ckv_full[layer_idx], rope_full[layer_idx]
    else:
        ckv_full = ckv_cache = cache_update(
            cache["c_kv"][..., None, :], c_kv[..., None, :], lengths,
            cfg.kv_variant, seq)[..., 0, :]
        rope_full = rope_cache = cache_update(
            cache["k_rope"], k_rope, lengths, cfg.kv_variant, seq)
    if Variant(cfg.kv_variant) == Variant.DYNAMIC:    # written in place
        ckv_full = cache["c_kv"]

    # absorb wk_b into the query: q_eff (H, B, rank), rounded to the
    # cache's dtype as the reference's; one product per head on views of
    # the weights (no copy of them), one per slot on views of the cache
    wk_b = params["wk_b"].reshape(rank, h, dn)
    q_eff = common.f32_product(q_nope[:, 0].transpose(0, 1),
                               wk_b.permute(1, 2, 0))
    q_rope = q_rope[:, 0]                                      # (B, H, dr)
    keep = None
    if axis is not None and seq is not None and "model" in seq.axes:
        every = collectives.gathered(torch.cat(
            [q_eff.transpose(0, 1), q_rope], -1).contiguous(), axis)
        every = torch.cat(list(every), dim=1)          # (B, every H, .)
        q_eff = every[..., :rank].transpose(0, 1)
        q_rope = every[..., rank:].to(q_rope.dtype)
        keep = slice(axis.index * h, (axis.index + 1) * h)
    s_nope = common.f32_product(q_eff.transpose(0, 1).to(ckv_cache.dtype),
                                ckv_cache.transpose(1, 2))     # (B, H, S)
    s_rope = common.f32_product(q_rope,
                                rope_cache[:, :, 0].transpose(1, 2))
    scores = (s_nope + s_rope) * (dn + dr) ** -0.5
    cols = torch.arange(ckv_cache.shape[1], device=x.device)[None, :]
    if seq is not None:
        cols = cols + seq.index * ckv_cache.shape[1]
    ok = cols <= lengths.long()[:, None]
    scores = scores + torch.where(ok, 0.0, NEG_INF)[:, None, :]
    if seq is None:
        p = torch.softmax(scores, dim=-1)
        ctx = common.f32_product(p.to(ckv_cache.dtype), ckv_cache)
    else:
        mx = scores.amax(dim=-1)
        p = torch.exp(scores - mx[..., None])
        part = common.f32_product(p.to(ckv_cache.dtype), ckv_cache)
        ctx = combine_partials(mx, p.sum(dim=-1), part, seq)   # (B,H,r)
    if keep is not None:
        ctx = ctx[:, keep]
    wv_b = params["wv_b"].reshape(rank, h, dv)
    out = common.f32_product(ctx.to(wv_b.dtype).transpose(0, 1),
                             wv_b.transpose(0, 1))             # (H, B, dv)
    out = out.transpose(0, 1)
    y = out.reshape(b, 1, h * dv).to(x.dtype) @ params["wo"]
    return collectives.reduce_out(y, axis), {"c_kv": ckv_full,
                                             "k_rope": rope_full}
