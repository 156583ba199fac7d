"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256. [arXiv:2407.21783]

The scale outlier: its parameters alone take ~810 GB in bf16, more than
one card holds, so the port runs it at smoke size only. The same numbers
as the reference's ``repro/configs/llama3_405b.py``
(remat saves the matmul outputs, ``remat_policy="dots"``).
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b",
        family="dense",
        n_layers=126,
        d_model=16384,
        n_heads=128,
        n_kv_heads=8,
        d_head=128,
        d_ff=53248,
        vocab_size=128256,
        rope_theta=5e5,
        remat_policy="dots",
    )


def smoke() -> ModelConfig:
    return config().with_(
        n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
        d_ff=192, vocab_size=256, param_dtype="float32",
        compute_dtype="float32",
        remat=False)
