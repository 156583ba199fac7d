"""Decoder-only transformer LM, dense family: qwen3-8b, granite-3-8b,
llama3-405b, gemma3-1b (5:1 local:global).

The port of the reference's ``repro.models.transformer`` for dense
models. Per-layer parameters are stacked on a leading layer axis, as in
the reference; the trunk runs as a Python loop over the layers. The
layer's kind (gemma3's local or global) is a 0-d tensor on the device,
and so are its window (``torch.where(is_local, sliding_window, 0)``, the
reference's traced ``jnp.where``) and its rope base: nothing about a
layer is read back to the host.

Because the window is a tensor, `gqa_attention` never takes the flash
kernel here, even with ``use_flash_kernel`` set: the reference's
condition wants a Python int 0, and its scanned layers pass a traced
array (ROADMAP C). The port keeps that condition.

MoE, MLA and the VLM's M-RoPE frontend are not ported (ROADMAP A.2):
`models.api` refuses those families.
`decode_step` writes each layer's token into the stacked cache in place
(the V2 blend builds new tensors, copied back) and returns it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common
from repro_torch.models.common import dtype_of


def init_params(cfg: ModelConfig, gen: torch.Generator, device) -> Dict:
    dtype = dtype_of(cfg.param_dtype)
    lead = (cfg.n_layers,)
    layers = {
        "ln1": common.rmsnorm_params(cfg.d_model, dtype, device, lead),
        "ln2": common.rmsnorm_params(cfg.d_model, dtype, device, lead),
        "attn": attention.attn_params(cfg, dtype, gen, device, lead),
        "mlp": common.mlp_params(cfg.d_model, cfg.d_ff, dtype, gen, device,
                                 lead),
    }
    return {
        "embed": common.embed_params(cfg, dtype, gen, device),
        "layers": layers,
        "final_norm": common.rmsnorm_params(cfg.d_model, dtype, device),
    }


def layer_kinds(cfg: ModelConfig) -> np.ndarray:
    """Per-layer is_local flags (gemma3's N:1 pattern; all-global else)."""
    if cfg.local_global_pattern > 0:
        period = cfg.local_global_pattern + 1
        return (np.arange(cfg.n_layers) % period
                != cfg.local_global_pattern).astype(np.int32)
    return np.zeros((cfg.n_layers,), dtype=np.int32)


def _kinds(cfg: ModelConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(is_local (L,) bool, window (L,) int32), `layer_kinds` made on
    ``device`` (no host copy): row i is layer i's 0-d kind and window."""
    ids = torch.arange(cfg.n_layers, device=device)
    period = cfg.local_global_pattern + 1
    is_local = ((ids % period != cfg.local_global_pattern)
                if cfg.local_global_pattern > 0 else ids < 0)
    window = torch.where(is_local, cfg.sliding_window, 0).to(torch.int32)
    return is_local, window


def _embed_scale(cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """gemma-style sqrt(d) embedding scale (dense, vocab past 200k), in
    the embedding's dtype as the reference's."""
    if cfg.family == "dense" and cfg.vocab_size > 200_000:
        return h * torch.tensor(np.sqrt(cfg.d_model), dtype=h.dtype)
    return h


def embed_inputs(params: Dict, cfg: ModelConfig, batch: Dict
                 ) -> torch.Tensor:
    """Token embeddings (the VLM's modality override is not ported)."""
    return _embed_scale(cfg, common.embed_tokens(params["embed"],
                                                 batch["tokens"]))


def _block(lp: Dict, cfg: ModelConfig, h, positions, is_local, window,
           return_kv: bool = False):
    res = attention.gqa_attention(lp["attn"], cfg,
                                  common.rmsnorm(lp["ln1"], h), positions,
                                  window=window, is_local=is_local,
                                  return_kv=return_kv)
    a_out, kv = res if return_kv else (res, None)
    h = h + a_out
    h = h + common.mlp_apply(lp["mlp"], common.rmsnorm(lp["ln2"], h))
    return h, kv


def forward(params: Dict, cfg: ModelConfig, batch: Dict
            ) -> Tuple[torch.Tensor, Dict]:
    """-> (hidden (B, S, D), aux {}: a dense model has no MoE losses)."""
    h = embed_inputs(params, cfg, batch)
    positions = common.positions_of(batch["tokens"])
    is_local, window = _kinds(cfg, h.device)
    for i in range(cfg.n_layers):
        h, _ = _block(common.layer(params["layers"], i), cfg, h, positions,
                      is_local[i], window[i])
    return common.rmsnorm(params["final_norm"], h), {}


def loss_fn(params: Dict, cfg: ModelConfig, batch: Dict):
    h, _ = forward(params, cfg, batch)
    logits = common.logits_from_hidden(params["embed"], cfg, h)
    xent = common.softmax_xent(logits, batch["labels"],
                               batch.get("loss_mask"))
    return xent, {"xent": xent}


def prefill(params: Dict, cfg: ModelConfig, batch: Dict):
    """Fill the cache from a full prompt: (last-position logits (B, 1, V)
    f32, {"k", "v"} of (L, B, S, hkv, dh))."""
    h = embed_inputs(params, cfg, batch)
    positions = common.positions_of(batch["tokens"])
    is_local, window = _kinds(cfg, h.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        h, (k, v) = _block(common.layer(params["layers"], i), cfg, h,
                           positions, is_local[i], window[i],
                           return_kv=True)
        ks.append(k)
        vs.append(v)
    h = common.rmsnorm(params["final_norm"], h)
    logits = common.logits_from_hidden(params["embed"], cfg, h[:, -1:])
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Dict:
    dtype = dtype_of(cfg.compute_dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_specs(cfg: ModelConfig, *, seq_sharded: bool = False) -> Dict:
    """Logical axes of the cache's leaves, as the reference's; with
    ``seq_sharded`` the sequence axis is named "seq" (`_grow_cache`)."""
    seq_ax = "seq" if seq_sharded else None
    return {"k": (None, "batch", seq_ax, "kv_heads", None),
            "v": (None, "batch", seq_ax, "kv_heads", None)}


def decode_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Dict, lengths: torch.Tensor):
    """One decode step. tokens (B, 1); lengths (B,) write positions.
    Each layer writes its token into the stacked cache
    (`attention.gqa_decode_stacked`) and attends to its slice. Returns
    (logits (B, 1, V) f32, cache), the cache updated in place."""
    h = _embed_scale(cfg, common.embed_tokens(params["embed"], tokens))
    is_local, window = _kinds(cfg, h.device)
    kv = cache
    for i in range(cfg.n_layers):
        lp = common.layer(params["layers"], i)
        a_out, kv = attention.gqa_decode_stacked(
            lp["attn"], cfg, common.rmsnorm(lp["ln1"], h), kv, lengths, i,
            window=window[i], is_local=is_local[i])
        h = h + a_out
        h = h + common.mlp_apply(lp["mlp"], common.rmsnorm(lp["ln2"], h))
    for key in ("k", "v"):
        if kv[key] is not cache[key]:        # the CNN variant's new tensor
            cache[key].copy_(kv[key])
    h = common.rmsnorm(params["final_norm"], h)
    return common.logits_from_hidden(params["embed"], cfg, h), cache
