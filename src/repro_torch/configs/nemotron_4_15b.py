"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000, squared-ReLU FFN [arXiv:2402.16819].

Pure full attention -> long_500k SKIPPED.

Copy of ``repro.configs.nemotron_4_15b``.
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b",
        d_model=6144, n_layers=32, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=24576, vocab_size=256000,
        stages=((("attn",), 32),),
        ffn_kind="squared_relu", rope_theta=10000.0, tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b-smoke",
        d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128,
        stages=((("attn",), 2),),
        ffn_kind="squared_relu", tie_embeddings=False,
    )
