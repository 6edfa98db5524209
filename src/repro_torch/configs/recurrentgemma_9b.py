"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 [arXiv:2402.19427].

Griffin pattern — RG-LRU : local-attention 2:1 per unit (the assignment's
"1:2" attn:rglru ratio): unit (rglru, rglru, win) x 12 + tail (rglru, rglru).
Sliding window 2048, head_dim 256, recurrence width = d_model.
long_500k RUNS (sub-quadratic: bounded-window KV + O(1) recurrent state).

Copy of ``repro.configs.recurrentgemma_9b``.
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        d_model=4096, n_layers=38, n_heads=16, n_kv_heads=1, head_dim=256,
        d_ff=12288, vocab_size=256000,
        stages=((("rglru", "rglru", "win"), 12), (("rglru", "rglru"), 1)),
        window=2048, d_rnn=4096,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b-smoke",
        d_model=64, n_layers=3, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=128,
        stages=((("rglru", "rglru", "win"), 1),),
        window=8, d_rnn=64,
    )
