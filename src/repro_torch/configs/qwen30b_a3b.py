"""qwen30b-a3b — Qwen3-30B-A3B, the paper's MoE evaluation model.

Public config [hf:Qwen/Qwen3-30B-A3B]: 48L, d=2048, 32H GQA kv=4,
128 experts top-8, d_expert=768. Used by the paper-table benchmarks.
"""
from repro_torch.config import ModelConfig, MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen30b-a3b", family="moe",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
        d_ff=768, vocab=151936, head_dim=128,
        qk_norm=True, mlp="swiglu", pos="rope", rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=128, top_k=8, d_expert=768),
        source="hf:Qwen/Qwen3-30B-A3B",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="qwen30b-a3b-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
        head_dim=8, d_ff=96, vocab=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=96),
    )
