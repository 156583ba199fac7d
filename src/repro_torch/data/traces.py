"""Deterministic seed spaces for synthetic acquisition sources."""

from __future__ import annotations

import hashlib


def seed_space(*parts) -> int:
    """Disjoint deterministic seed spaces via SHA-256.

    Hashing the full identity tuple spreads every (namespace, base seed,
    index) into its own 63-bit region, stable across processes (unlike
    ``hash()``), so two sources with nearby base seeds never stream the
    same RF.
    """
    text = "/".join(str(p) for p in parts)
    digest = hashlib.sha256(text.encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big") >> 1   # fit a non-neg int64
