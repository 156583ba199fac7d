"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8. [hf:ibm-granite family; hf]

The MoE dispatch is the paper's taxonomy applied at LM scale: the default
variant is V2 (one-hot einsum); V1 and V3 are selectable
(``moe_variant``). The same numbers as the reference's
``repro/configs/granite_moe_3b_a800m.py``, ``attn_batch_fallback``
included (its 24 query heads do not divide a "model" of 16: the
attention's rows split over "model" there); the 8 dead experts
(40 -> 48) are kept, so the weights have the reference's shapes.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,            # per-expert FFN width
        vocab_size=49155,
        n_experts=40,
        n_experts_per_tok=8,
        moe_d_ff=512,
        n_experts_padded=48,
        attn_batch_fallback=True,
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=64, moe_d_ff=64, n_experts=8, n_experts_per_tok=2,
        vocab_size=256, param_dtype="float32", compute_dtype="float32",
        remat=False)
