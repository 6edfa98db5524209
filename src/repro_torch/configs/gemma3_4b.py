"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144, 5:1 local:global sliding-window pattern, 128k context
[hf:google/gemma-3-4b-pt].

Stages: (win x5, attn) x 5 + (win x3, attn) tail = 34 layers. Window 1024.
8 q-heads padded to 16 for the 16-way model axis (true_n_heads=8).
long_500k RUNS: 28/34 layers have bounded-window KV; the 6 global layers'
524288-token KV is sequence-sharded with the distributed lean merge.

Copy of ``repro.configs.gemma3_4b``.
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        d_model=2560, n_layers=34, n_heads=16, n_kv_heads=4, head_dim=256,
        d_ff=10240, vocab_size=262144,
        stages=(
            (("win", "win", "win", "win", "win", "attn"), 5),
            (("win", "win", "win", "attn"), 1),
        ),
        window=1024, qk_norm=True, rope_theta=1000000.0, true_n_heads=8,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b-smoke",
        d_model=64, n_layers=6, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=128,
        stages=((("win", "win", "win", "win", "win", "attn"), 1),),
        window=8, qk_norm=True, true_n_heads=2,
    )
