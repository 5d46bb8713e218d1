"""qwen2-vl-7b — VLM backbone with M-RoPE [arXiv:2409.12191; hf].

The vision frontend is a STUB per the assignment card: ``input_specs()``
provides precomputed patch embeddings (B, n_vision_tokens, d_model).
"""
from repro_torch.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b", family="vlm",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
        d_ff=18944, vocab=152064, head_dim=128,
        qkv_bias=True, mlp="swiglu", pos="mrope", rope_theta=1_000_000.0,
        n_vision_tokens=1024,  # ~ one 1024-patch image after merger
        source="arXiv:2409.12191; hf",
    )


def smoke() -> ModelConfig:
    return full().replace(
        name="qwen2-vl-7b-smoke", n_layers=2, d_model=56, n_heads=7, n_kv_heads=1,
        head_dim=8, d_ff=112, vocab=256, n_vision_tokens=8,
    )
