"""Synthetic LM batches (PyTorch port of ``repro.data.batches``).

Schema (train/prefill): tokens (B, S) int32, labels (B, S) int32. The
numpy generator is the reference's, so a seed gives the same tokens bit
for bit in both packages. Only the decoder-only text schema is ported;
the vlm and audio extras come with their families (ROADMAP A).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def synth_train_batch(cfg: ModelConfig, batch: int, seq: int,
                      seed: int = 0, device="cpu") -> Dict:
    if cfg.family in ("vlm", "audio"):
        raise NotImplementedError(
            f"{cfg.family} batches are not ported yet (ROADMAP A)")
    rng = np.random.default_rng(seed)
    out = {
        "tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
            np.int32),
        "labels": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(
            np.int32),
    }
    return {k: torch.as_tensor(v).to(device) for k, v in out.items()}
