"""seamless-m4t-large-v2 backbone: an encoder-decoder transformer.

The port of the reference's ``repro.models.encdec``. The audio frontend
is a stub, as in the reference: the encoder consumes precomputed frame
embeddings ``enc_embeds`` (B, S_enc, d_model). The encoder's attention
is non-causal, so it runs `chunked_attention`; the decoder's causal
self-attention takes the CUDA flash kernel where the config sets
``use_flash_kernel`` (the reference's condition: a Python-int window 0,
no cross KV); its cross-attention runs chunked against the encoder's
K/V. Under a "model" axis every attention and MLP runs on the rank's
heads and columns (`models.attention`, `common.mlp_apply`), and the
vocabulary is split where "model" divides it (256,206 at 2 ranks, not
at 4). Per-layer parameters are stacked on leading layer axes
(``enc_layers``, ``dec_layers``) and run as Python loops, each layer's
body under `common.remat` where the reference checkpoints it (under
FSDP gathering its layer's blocks first: `common.fsdp_gather`; the
decoder's body gathers its cross-attention wk / wv too, whose product
the reference computes and drops, beside `cross_kv`'s own gather).

Serving: `prefill` encodes, computes the cross K/V once and consumes a
BOS token through `decode_step`, so the cache it returns is ready to
decode at position 1. `decode_step` writes the self-attention K/V of
each layer in place (the V2 blend's new tensor is copied back) and
returns the cache.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common
from repro_torch.models.common import dtype_of
from repro_torch.runtime import collectives


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Dict:
    dtype = dtype_of(cfg.param_dtype)
    d = cfg.d_model

    def norm(lead):
        return common.rmsnorm_params(d, dtype, device, lead)

    enc, dec = (cfg.n_enc_layers,), (cfg.n_layers,)
    return {
        "embed": common.embed_params(cfg, dtype, gen, device),
        "enc_layers": {
            "ln1": norm(enc),
            "attn": attention.attn_params(cfg, dtype, gen, device, enc),
            "ln2": norm(enc),
            "mlp": common.mlp_params(d, cfg.d_ff, dtype, gen, device, enc)},
        "enc_norm": norm(()),
        "dec_layers": {
            "ln1": norm(dec),
            "self_attn": attention.attn_params(cfg, dtype, gen, device, dec),
            "ln_x": norm(dec),
            "cross_attn": attention.attn_params(cfg, dtype, gen, device,
                                                dec),
            "ln2": norm(dec),
            "mlp": common.mlp_params(d, cfg.d_ff, dtype, gen, device, dec)},
        "final_norm": norm(()),
    }


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encode(params: Dict, cfg: ModelConfig, enc_embeds: torch.Tensor
           ) -> torch.Tensor:
    """(B, S_enc, D) precomputed frame embeddings -> encoder states.

    Frames wider than the compute dtype stay so, and every product and
    norm they meet runs in their dtype, as the reference's jnp promotion
    runs them (`common.matmul`): ``TokenDataset``'s f32 frames give a
    bf16 model f32 encoder states, whose cross K/V are f32 too.
    ``synth_train_batch``'s frames are in the compute dtype."""
    h = enc_embeds.to(torch.promote_types(enc_embeds.dtype,
                                          dtype_of(cfg.compute_dtype)))
    positions = common.positions_of(h)

    def body(hcur, lp):
        lp = common.fsdp_gather(lp, "enc_layers")
        hcur = hcur + attention.gqa_attention(
            lp["attn"], cfg, common.rmsnorm(lp["ln1"], hcur), positions,
            causal=False)
        return hcur + common.mlp_apply(lp["mlp"],
                                       common.rmsnorm(lp["ln2"], hcur),
                                       cfg.d_ff)

    body = common.remat(cfg, body)
    for lp in common.unstacked(params["enc_layers"], cfg.n_enc_layers):
        h = body(h, lp)
    return common.rmsnorm(params["enc_norm"], h)


def cross_kv(params: Dict, cfg: ModelConfig, enc_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each decoder layer's cross K/V of the encoder states, computed
    once: two (L, B, S_enc, hkv, dh); under a "model" axis that splits
    the heads, of the rank's KV heads (the encoder states enter through
    `collectives.copy_in`), else of every KV head, the states entering
    through `copy_in` where the ``attn_batch`` fallback splits the rows
    (each rank's cross attention reads its rows of the K/V:
    `attention.rows_axis`); under FSDP each layer's wk and wv gathered
    first (`common.fsdp_gather`)."""
    b, s, _ = enc_out.shape
    xattn = params["dec_layers"]["cross_attn"]
    dh = cfg.head_dim
    hkv = xattn["wk"].shape[-1] // dh
    enc_out = collectives.copy_in(enc_out, attention.heads_axis(cfg)
                                  or attention.rows_axis(cfg, b))
    ks, vs = [], []
    for wk, wv in zip(torch.unbind(xattn["wk"]), torch.unbind(xattn["wv"])):
        w = common.fsdp_gather({"wk": wk, "wv": wv}, "dec_layers/cross_attn")
        ks.append(common.matmul(enc_out, w["wk"]).reshape(b, s, hkv, dh))
        vs.append(common.matmul(enc_out, w["wv"]).reshape(b, s, hkv, dh))
    return torch.stack(ks), torch.stack(vs)


# ---------------------------------------------------------------------------
# Decoder (teacher-forced scoring)
# ---------------------------------------------------------------------------


def _decoder(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
             xk: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    h = common.embed_tokens(params["embed"], tokens, cfg)
    positions = common.positions_of(tokens)

    def body(hcur, lp, xk_l, xv_l):
        lp = common.fsdp_gather(lp, "dec_layers")
        hcur = hcur + attention.gqa_attention(
            lp["self_attn"], cfg, common.rmsnorm(lp["ln1"], hcur), positions)
        hcur = hcur + attention.gqa_attention(
            lp["cross_attn"], cfg, common.rmsnorm(lp["ln_x"], hcur),
            positions, cross_kv=(xk_l, xv_l))
        return hcur + common.mlp_apply(lp["mlp"],
                                       common.rmsnorm(lp["ln2"], hcur),
                                       cfg.d_ff)

    body = common.remat(cfg, body)
    for lp, xk_l, xv_l in zip(
            common.unstacked(params["dec_layers"], cfg.n_layers),
            torch.unbind(xk), torch.unbind(xv)):
        h = body(h, lp, xk_l, xv_l)
    return common.rmsnorm(params["final_norm"], h)


def forward(params: Dict, cfg: ModelConfig, batch: Dict
            ) -> Tuple[torch.Tensor, Dict]:
    enc_out = encode(params, cfg, batch["enc_embeds"])
    xk, xv = cross_kv(params, cfg, enc_out)
    return _decoder(params, cfg, batch["tokens"], xk, xv), {}


def loss_fn(params: Dict, cfg: ModelConfig, batch: Dict):
    h, _ = forward(params, cfg, batch)
    logits = common.logits_from_hidden(params["embed"], cfg, h)
    xent = common.softmax_xent(
        logits, batch["labels"], batch.get("loss_mask"),
        split=common.vocab_split(params["embed"], cfg))
    return xent, {"xent": xent}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int,
               device) -> Dict:
    dtype = dtype_of(cfg.compute_dtype)
    lead = (cfg.n_layers, batch)
    tail = (cfg.n_kv_heads, cfg.head_dim)

    def zeros(n):
        return torch.zeros(lead + (n,) + tail, dtype=dtype, device=device)

    return {"k": zeros(max_len), "v": zeros(max_len),
            "xk": zeros(enc_len), "xv": zeros(enc_len)}


def cache_specs(cfg: ModelConfig, *, seq_sharded: bool = False) -> Dict:
    """Logical axes of the cache's leaves, as the reference's."""
    seq_ax = "seq" if seq_sharded else None
    spec = (None, "batch", seq_ax, "kv_heads", None)
    return {"k": spec, "v": spec, "xk": spec, "xv": spec}


def prefill(params: Dict, cfg: ModelConfig, batch: Dict):
    """Encode + cross K/V, the enc-dec analogue of prompt prefill, then a
    BOS token (id 0) at position 0 through `decode_step`. The
    self-attention cache holds ``batch.get("dec_len", 256)`` positions.
    -> (logits (B, 1, V) f32, decode-ready cache)."""
    enc_out = encode(params, cfg, batch["enc_embeds"])
    xk, xv = cross_kv(params, cfg, enc_out)
    b = enc_out.shape[0]
    dtype = dtype_of(cfg.compute_dtype)
    cache = init_cache(cfg, b, batch.get("dec_len", 256), 0,
                       enc_out.device)
    cache.update(xk=xk.to(dtype), xv=xv.to(dtype))
    bos = torch.zeros((b, 1), dtype=torch.int32, device=enc_out.device)
    lengths = torch.zeros((b,), dtype=torch.int32, device=enc_out.device)
    return decode_step(params, cfg, bos, cache, lengths)


def decode_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict, lengths: torch.Tensor):
    """One token per slot: self-attention against the per-layer cache
    (`attention.gqa_decode`), then cross-attention of the one query
    against the static encoder K/V (`attention.cross_decode`). Under a
    mesh on the rank's heads and vocabulary slice, each layer's FSDP
    blocks gathered first, both caches split along their sequence in
    the decode cell's layout."""
    h = common.embed_tokens(params["embed"], tokens, cfg)
    for i in range(cfg.n_layers):
        lp = common.fsdp_gather(common.layer(params["dec_layers"], i),
                                "dec_layers")
        k_i, v_i = cache["k"][i], cache["v"][i]
        a_out, kv = attention.gqa_decode(
            lp["self_attn"], cfg, common.rmsnorm(lp["ln1"], h),
            {"k": k_i, "v": v_i}, lengths)
        for dst, src in ((k_i, kv["k"]), (v_i, kv["v"])):
            if src is not dst:                # the CNN variant's new tensor
                dst.copy_(src)
        h = h + a_out
        h = h + attention.cross_decode(
            lp["cross_attn"], cfg, common.rmsnorm(lp["ln_x"], h),
            cache["xk"][i], cache["xv"][i], lengths)
        h = h + common.mlp_apply(lp["mlp"], common.rmsnorm(lp["ln2"], h),
                                 cfg.d_ff)
    h = common.rmsnorm(params["final_norm"], h)
    return common.logits_from_hidden(params["embed"], cfg, h), cache
