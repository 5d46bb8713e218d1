"""zamba2-7b — Mamba2 backbone + shared attention block [arXiv:2411.15242; unverified].

81 Mamba2 layers (d_state=64); a single *shared* transformer block
(32H MHA kv=32, d_ff=14336) is applied after every 6th Mamba2 layer,
each application with its own KV cache.
"""
from repro_torch.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        d_ff=14336, vocab=32000, head_dim=112,
        mlp="swiglu", pos="rope", rope_theta=10_000.0,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
        shared_attn_every=6,
        source="arXiv:2411.15242; unverified",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="zamba2-7b-smoke", n_layers=7, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=256,
        ssm_state=16, ssm_head_dim=32, shared_attn_every=3,
    )
