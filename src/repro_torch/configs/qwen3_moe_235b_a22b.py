"""qwen3-moe-235b-a22b — 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B; hf].

This is the paper's ``qwen235b`` evaluation model (Qwen3-235B-A22B).
"""
from repro_torch.config import ModelConfig, MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
        d_ff=1536, vocab=151936, head_dim=128,
        qk_norm=True, mlp="swiglu", pos="rope", rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536),
        source="hf:Qwen/Qwen3-30B-A3B; hf",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        head_dim=8, d_ff=96, vocab=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=96),
    )
