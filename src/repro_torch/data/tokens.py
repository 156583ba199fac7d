"""Deterministic synthetic LM data pipeline (numpy only).

The port's copy of the reference's ``repro.data.tokens``: the same RNG
stream, so `TokenDataset.batch_for_step` returns arrays bit-equal to the
reference's. Batches are a pure function of (seed, step): a restart from
a checkpoint resumes the data exactly, with no loader state to save (the
step number is the state). The training loop moves them to the device.

The sequences follow an increment rule with rare random jumps
(x[t+1] = x[t] + stride, ~5% restarts), so next-token entropy is far below
uniform and a small model learns the rule within tens of steps, while the
jump floor keeps the loss from collapsing to zero.

Data parallel: every rank builds the global batch of a step from the seed
and keeps its own contiguous rows (`TokenDataset.rows_for_step`), so the
ranks together see the batch one device would.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


class TokenDataset:
    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed

    def batch_for_step(self, step: int) -> Dict[str, np.ndarray]:
        """Pure (seed, step) -> batch. int32 tokens/labels; the VLM adds
        f32 ``embeds``, an int32 ``embed_mask`` and (b, 3, s) int32
        ``positions``; audio adds f32 ``enc_embeds``."""
        v = self.cfg.vocab_size
        b, s = self.batch, self.seq
        rng = np.random.default_rng((self.seed * 1_000_003 + step) % 2**63)
        stride = rng.integers(1, 4, size=(b, 1))
        start = rng.integers(0, v, size=(b, 1))
        x = (start + stride * np.arange(s + 1)[None, :]) % v
        jumps = rng.random((b, s + 1)) < 0.05
        jump_to = rng.integers(0, v, size=(b, s + 1))
        offset = np.where(jumps, jump_to - x, 0).cumsum(axis=1)
        x = (x + offset) % v
        out = {"tokens": x[:, :s].astype(np.int32),
               "labels": x[:, 1:s + 1].astype(np.int32)}
        if self.cfg.family == "vlm":
            d = self.cfg.d_model
            out["embeds"] = (0.02 * rng.standard_normal(
                (b, s, d))).astype(np.float32)
            mask = np.zeros((b, s), np.int32)
            mask[:, : s // 4] = 1
            out["embed_mask"] = mask
            out["positions"] = np.broadcast_to(
                np.arange(s, dtype=np.int32), (b, 3, s)).copy()
        if self.cfg.family == "audio":
            d = self.cfg.d_model
            out["enc_embeds"] = (0.02 * rng.standard_normal(
                (b, s, d))).astype(np.float32)
        return out

    def rows_for_step(self, step: int, index: int, extent: int
                      ) -> Dict[str, np.ndarray]:
        """Rank ``index`` of ``extent``'s contiguous rows of
        `batch_for_step` (raises unless ``extent`` divides the batch)."""
        if self.batch % extent:
            raise ValueError(f"a global batch of {self.batch} rows does "
                             f"not split over {extent} ranks")
        k = self.batch // extent
        return {name: x[index * k:(index + 1) * k]
                for name, x in self.batch_for_step(step).items()}

    def iter_from(self, step: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_for_step(step)
            step += 1

