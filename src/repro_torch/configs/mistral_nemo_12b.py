"""mistral-nemo-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407].

Copy of ``repro.configs.mistral_nemo_12b``.
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b",
        d_model=5120, n_layers=40, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=131072,
        stages=((("attn",), 40),),
        rope_theta=1000000.0, tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b-smoke",
        d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128,
        stages=((("attn",), 2),),
        tie_embeddings=False,
    )
