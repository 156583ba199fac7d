"""qwen3-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288
vocab=151936; qk_norm. [hf:Qwen/Qwen3-8B]

The same numbers as the reference's ``repro/configs/qwen3_8b.py``.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=12288,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1e6,
    )


def smoke() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, param_dtype="float32",
        compute_dtype="float32",
        remat=False)
