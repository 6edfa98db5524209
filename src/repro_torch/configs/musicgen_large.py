"""musicgen-large [audio]: 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.

Decoder-only transformer over EnCodec tokens [arXiv:2306.05284; hf].
The EnCodec frontend is a STUB: input_specs provides token ids directly
(precomputed frame tokens). Full MHA (kv=32), GeLU FFN, absolute sinusoidal
positions (rope_theta=None).

Copy of ``repro.configs.musicgen_large``.
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        d_model=2048, n_layers=48, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab_size=2048,
        stages=((("attn",), 48),),
        ffn_kind="gelu", rope_theta=None, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large-smoke",
        d_model=64, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=128,
        stages=((("attn",), 2),),
        ffn_kind="gelu", rope_theta=None,
    )
