"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 [hf:meta-llama/Llama-3.2-11B-Vision].

Every 5th layer adds gated cross-attention to image patch embeddings.
The vision encoder is a STUB: input_specs provides precomputed patch
embeddings (B, 1601, d_model) — 1 tile of 40x40 patches + CLS.

Copy of ``repro.configs.llama_3_2_vision_11b``.
"""
from repro_torch.models import ModelConfig

CROSS_KV_LEN = 1601


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        d_model=4096, n_layers=40, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=128256,
        stages=((("attn", "attn", "attn", "attn", "xattn"), 8),),
        rope_theta=500000.0, cross_kv_len=CROSS_KV_LEN, tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b-smoke",
        d_model=64, n_layers=5, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128,
        stages=((("attn", "attn", "attn", "attn", "xattn"), 1),),
        cross_kv_len=6, tie_embeddings=False,
    )
