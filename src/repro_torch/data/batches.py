"""Synthetic LM batches (PyTorch port of ``repro.data.batches``), and
their shapes as ``meta`` tensors (`train_batch_spec`,
`decode_inputs_spec`: the reference's ShapeDtypeStruct specs).

Schema (train/prefill): tokens (B, S) int32, labels (B, S) int32; the
vlm family adds embeds (B, S, d_model) in the compute dtype, embed_mask
(B, S) int32 (the leading quarter of the sequence is image patches) and
M-RoPE positions (B, 3, S) int32; the audio (enc-dec) family adds
enc_embeds (B, S, d_model) in the compute dtype. The numpy generator is
the reference's, drawn in the same order, so a seed gives the same
arrays bit for bit in both packages.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dtype_of


def synth_train_batch(cfg: ModelConfig, batch: int, seq: int,
                      seed: int = 0, device="cpu") -> Dict:
    rng = np.random.default_rng(seed)
    out = {
        "tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
            np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
            np.int32),
    }
    out = {k: torch.as_tensor(v).to(device) for k, v in out.items()}
    if cfg.family == "vlm":
        n_img = seq // 4                      # leading image-patch region
        out["embeds"] = _embeds(cfg, rng, batch, seq, device)
        mask = np.zeros((batch, seq), np.int32)
        mask[:, :n_img] = 1
        # M-RoPE triplets: patches get (t=0, h, w) grid positions; text
        # gets sequential positions on all three axes, from ``side``
        side = max(int(np.sqrt(n_img)), 1)
        pos = np.zeros((batch, 3, seq), np.int32)
        img = np.arange(n_img)
        pos[:, 1, :n_img] = img // side
        pos[:, 2, :n_img] = img % side
        pos[:, :, n_img:] = side + np.arange(seq - n_img)
        out["embed_mask"] = torch.as_tensor(mask).to(device)
        out["positions"] = torch.as_tensor(pos).to(device)
    if cfg.family == "audio":
        out["enc_embeds"] = _embeds(cfg, rng, batch, seq, device)
    return out


def _embeds(cfg: ModelConfig, rng, batch: int, seq: int, device
            ) -> torch.Tensor:
    """(batch, seq, d_model) of 0.02 * normal: float64 draws rounded once
    to the compute dtype (as numpy's astype), then moved."""
    return torch.from_numpy(0.02 * rng.standard_normal(
        (batch, seq, cfg.d_model))).to(dtype_of(cfg.compute_dtype)).to(
            device)


def train_batch_spec(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    """The train / prefill batch's leaves as ``meta`` tensors (shapes and
    dtypes, nothing allocated), the schema of `synth_train_batch`."""
    def meta(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")
    act = dtype_of(cfg.compute_dtype)
    spec = {"tokens": meta((batch, seq)), "labels": meta((batch, seq))}
    if cfg.family == "vlm":
        spec["embeds"] = meta((batch, seq, cfg.d_model), act)
        spec["embed_mask"] = meta((batch, seq))
        spec["positions"] = meta((batch, 3, seq))
    if cfg.family == "audio":
        spec["enc_embeds"] = meta((batch, seq, cfg.d_model), act)
    return spec


def decode_inputs_spec(cfg: ModelConfig, batch: int) -> Dict:
    """A decode step's tokens (B, 1) and lengths (B,) as ``meta``
    tensors."""
    del cfg
    return {"tokens": torch.empty((batch, 1), dtype=torch.int32,
                                  device="meta"),
            "lengths": torch.empty((batch,), dtype=torch.int32,
                                   device="meta")}
