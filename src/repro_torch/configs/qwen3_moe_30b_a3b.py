"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) vocab=151936,
MoE 128 routed experts top-8 (d_ff_expert=768), no shared expert, qk-norm
[hf:Qwen/Qwen3-30B-A3B].

128 experts / 16-way model axis -> 8 experts per device (EP).

Copy of ``repro.configs.qwen3_moe_30b_a3b``.
"""
from repro_torch.models import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        d_model=2048, n_layers=48, n_heads=32, n_kv_heads=4, head_dim=128,
        d_ff=0, vocab_size=151936,
        stages=((("attn",), 48),),
        qk_norm=True, rope_theta=1000000.0,
        moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b-smoke",
        d_model=64, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=0, vocab_size=128,
        stages=((("attn",), 2),),
        qk_norm=True,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                      capacity_factor=8.0),  # no drops: decode == forward
    )
