"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304
[arXiv:2405.04517].

mLSTM:sLSTM 7:1 ratio -> unit (mlstm x7, slstm) x 3. Blocks are
self-contained (proj-factor-2 up/down inside the mLSTM block; no separate
FFN). Attention-free: LeanAttention inapplicable (DESIGN.md
§Arch-applicability); decode state is O(1) so long_500k RUNS.

Copy of ``repro.configs.xlstm_350m``.
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m",
        d_model=1024, n_layers=24, n_heads=4, n_kv_heads=4, head_dim=256,
        d_ff=0, vocab_size=50304,
        stages=(((("mlstm",) * 7 + ("slstm",)), 3),),
        mlstm_proj_factor=2.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-350m-smoke",
        d_model=64, n_layers=3, n_heads=2, n_kv_heads=2, head_dim=32,
        d_ff=0, vocab_size=128,
        stages=((("mlstm", "mlstm", "slstm"), 1),),
    )
