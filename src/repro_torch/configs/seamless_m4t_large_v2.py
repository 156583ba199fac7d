"""seamless-m4t-large-v2 [audio]: enc-dec, 24L d_model=1024 16H (kv=16)
d_ff=8192 vocab=256206. [arXiv:2308.11596]

24 encoder layers + 24 decoder layers (the published speech-encoder /
text-decoder split). The audio frontend is a stub: the encoder consumes
precomputed frame embeddings (``enc_embeds``). The same numbers as the
reference's ``repro/configs/seamless_m4t_large_v2.py``.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        n_layers=24,           # decoder layers
        n_enc_layers=24,       # encoder layers
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab_size=256206,
        is_encoder_decoder=True,
        frontend="audio",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().with_(
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, param_dtype="float32",
        compute_dtype="float32",
        remat=False)
