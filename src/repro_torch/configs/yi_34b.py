"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
[arXiv:2403.04652].

56 q-heads do not divide the 16-way model axis: padded to 64 heads
(true_n_heads=56 is used for 6ND model-flops accounting; the +14% attention
projection flops show up honestly in the MODEL_FLOPS/HLO_FLOPS ratio).
Pure full attention -> long_500k SKIPPED.

Copy of ``repro.configs.yi_34b``.
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b",
        d_model=7168, n_layers=60, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=20480, vocab_size=64000,
        stages=((("attn",), 60),),
        rope_theta=5000000.0, true_n_heads=56, tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b-smoke",
        d_model=64, n_layers=2, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=128, vocab_size=128,
        stages=((("attn",), 2),),
        true_n_heads=7, tie_embeddings=False,
    )
