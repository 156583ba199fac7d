"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144; 5:1 local:global attention, 128k. [hf:google/gemma-3-1b-pt]

Local layers use a 512-token sliding window with rope base 10k; global
layers use full attention with rope base 1M. The same numbers as the
reference's ``repro/configs/gemma3_1b.py``.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        family="dense",
        n_layers=26,
        d_model=1152,
        n_heads=4,
        n_kv_heads=1,
        d_head=256,
        d_ff=6912,
        vocab_size=262144,
        qk_norm=True,
        local_global_pattern=5,
        sliding_window=512,
        rope_theta=1e6,          # global layers
        rope_local_theta=1e4,    # local layers
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().with_(
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=1, d_head=16,
        d_ff=128, vocab_size=512, sliding_window=8,
        param_dtype="float32", compute_dtype="float32",
        remat=False)
