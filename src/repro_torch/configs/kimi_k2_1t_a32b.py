"""kimi-k2-1t-a32b — trillion-param 384-expert top-8 MoE [arXiv:2501.kimi2; unverified].

Built exactly per the assignment card (61L, d=7168, 64H GQA kv=8, 384e top-8,
d_expert=2048, vocab=163840). Card-level simplification: all layers MoE, no
shared expert (the card lists neither).
"""
from repro_torch.config import ModelConfig, MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
        d_ff=2048, vocab=163840, head_dim=112,
        mlp="swiglu", pos="rope", rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048),
        source="arXiv:2501.kimi2; unverified",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="kimi-k2-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        head_dim=8, d_ff=96, vocab=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=96),
    )
