"""xlstm-125m — alternating sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

d_ff=0 per the card: blocks carry their own internal up/down projections
(mLSTM: 2x pre-up-projection; sLSTM: 4/3 gated FFN), no separate FFN sub-layer.
No positional embeddings (recurrence is positional).
"""
from repro_torch.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab=50304, head_dim=192,
        mlp="gelu", pos="none",
        ssm_state=0, ssm_head_dim=192, ssm_expand=2,
        tie_embeddings=True,
        source="arXiv:2405.04517; unverified",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="xlstm-125m-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=32, ssm_head_dim=32, vocab=256,
    )
