"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (kv=16) vocab=151936,
MoE 60 routed experts top-4 (d_ff_expert=1408) + 4 shared experts
(d_ff_shared=5632) [hf:Qwen/Qwen1.5-MoE-A2.7B].

60 experts do not divide the 16-way model axis -> expert-TP sharding
(d_ff_expert over 'model'), see distributed/sharding.py.

Copy of ``repro.configs.qwen2_moe_a2_7b``.
"""
from repro_torch.models import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        d_model=2048, n_layers=24, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=0, vocab_size=151936,
        stages=((("attn",), 24),),
        moe=MoEConfig(num_experts=60, top_k=4, d_ff_expert=1408,
                      d_ff_shared=5632),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-smoke",
        d_model=64, n_layers=2, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=0, vocab_size=128,
        stages=((("attn",), 2),),
        moe=MoEConfig(num_experts=6, top_k=2, d_ff_expert=32, d_ff_shared=64,
                      capacity_factor=6.0),  # no drops: decode == forward
    )
